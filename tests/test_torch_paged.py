"""The port's paged pieces: K1 (paged_decode_attention) and K2
(paged_chunk_attention) and the KVArena.

On the CPU: the plain versions against the JAX Pallas kernels in interpret
mode, on the same inputs made with numpy; the arena's bookkeeping and page
data against the JAX package's KVArena driven through one scripted
sequence; the wrappers' shape inference on meta tensors and input checks.
The kernels themselves are held against their plain versions on the card
by test_torch_kernels_cuda.py.
"""
import threading

import numpy as np
import pytest

# The JAX package memoizes FunctionSpec digests under a plain Lock that its
# own weakref finalizer also takes (src/repro/launch/compile_cache.py:185-208):
# a cyclic GC that runs while spec_digest holds the lock finalizes a dead spec
# on the same thread, and the test worker deadlocks. Every pytest worker
# imports this module while collecting, so the lock is made reentrant for the
# whole run; the reference's files stay as they are (ROADMAP, Queue 3).
from repro.launch import compile_cache as _jax_compile_cache  # noqa: E402

_jax_compile_cache._SPEC_LOCK = threading.RLock()

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # the suite runs several workers at once: leave them cores

import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import paged_chunk_attention as jax_paged_chunk  # noqa: E402
from repro.kernels.paged_attention import paged_decode_attention as jax_paged_decode  # noqa: E402
from repro.serving.kvpool import KVArena as JaxArena  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_attention as tpaged  # noqa: E402
from repro_torch.serving.kvpool import ArenaFull, KVArena  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    """tests/test_kernels.py's tolerances."""
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def both(x, name):
    jdt, tdt = DTYPES[name]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def paged_inputs(seed, b, n, page, p, kv, hd):
    """Pages from a numpy seed and a block table of distinct live pages per
    sequence (page 0 is the arena's scratch page)."""
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((p, page, kv, hd)).astype(np.float32)
    vp = rng.standard_normal((p, page, kv, hd)).astype(np.float32)
    bt = rng.permutation(np.arange(1, p))[: b * n].reshape(b, n).astype(np.int32)
    return rng, kp, vp, bt


# ------------------------------------------------------- K1 and K2, plain vs JAX


@pytest.mark.parametrize("b,n,page,p,h,kv,hd,lens", [
    (3, 3, 16, 12, 4, 2, 16, [37, 0, 16]),   # page 16, a masked slot (cur_len 0)
    (2, 2, 128, 6, 4, 2, 16, [200, 129]),    # page 128
    (2, 3, 16, 8, 4, 1, 16, [48, 3]),        # MQA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_plain_matches_jax_pallas(b, n, page, p, h, kv, hd, lens, dtype):
    rng, kpn, vpn, btn = paged_inputs(31, b, n, page, p, kv, hd)
    qn = rng.standard_normal((b, h, hd)).astype(np.float32)
    (jq, q), (jk, k), (jv, v) = both(qn, dtype), both(kpn, dtype), both(vpn, dtype)
    cur = np.asarray(lens, np.int32)
    got = tpaged.paged_decode_attention(q, k, v, torch.from_numpy(btn), torch.from_numpy(cur))
    want = jax_paged_decode(jq, jk, jv, jnp.asarray(btn), jnp.asarray(cur), interpret=True)
    np.testing.assert_allclose(as_np(got), as_np(want), **tol(dtype))
    for i, n_valid in enumerate(lens):
        if n_valid == 0:  # both give exact zeros for a masked slot
            assert torch.equal(got[i], torch.zeros_like(got[i]))
            assert not np.asarray(want[i].astype(jnp.float32)).any()


@pytest.mark.parametrize("c,start", [(8, 21), (5, 0), (5, 37)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_chunk_plain_matches_jax_pallas(c, start, dtype):
    h, kv, hd, page, n, p = 4, 2, 16, 16, 3, 8
    rng, kpn, vpn, btn = paged_inputs(37, 1, n, page, p, kv, hd)
    qn = rng.standard_normal((1, c, h, hd)).astype(np.float32)
    (jq, q), (jk, k), (jv, v) = both(qn, dtype), both(kpn, dtype), both(vpn, dtype)
    st = np.asarray([start], np.int32)
    got = tpaged.paged_chunk_attention(q, k, v, torch.from_numpy(btn), torch.from_numpy(st))
    want = jax_paged_chunk(jq, jk, jv, jnp.asarray(btn), jnp.asarray(st), interpret=True)
    np.testing.assert_allclose(as_np(got), as_np(want), **tol(dtype))


def test_paged_decode_plain_is_dense_decode_on_the_gathered_view():
    """K1's plain version is the gather, then the dense decode oracle: on a
    view as wide as a dense cache the two agree bit for bit."""
    rng, kpn, vpn, btn = paged_inputs(5, 2, 4, 16, 12, 2, 16)
    q = torch.from_numpy(rng.standard_normal((2, 4, 16)).astype(np.float32))
    kp, vp, bt = torch.from_numpy(kpn), torch.from_numpy(vpn), torch.from_numpy(btn)
    cur = torch.tensor([50, 7], dtype=torch.int32)
    k, v = ref.gather_pages(kp, bt), ref.gather_pages(vp, bt)
    assert k.shape == (2, 64, 2, 16)
    assert torch.equal(ref.paged_decode_attn_ref(q, kp, vp, bt, cur), ref.decode_attn_ref(q, k, v, cur))


def test_paged_ops_shape_inference_on_meta():
    ops.reset_counts()
    meta = dict(device="meta", dtype=torch.bfloat16)
    pages = torch.empty(321, 16, 8, 64, **meta)
    bt = torch.empty(8, 32, dtype=torch.int32, device="meta")
    q = torch.empty(8, 32, 64, **meta)
    out = ops.paged_decode_attention(q, pages, pages, bt, torch.empty(8, dtype=torch.int32, device="meta"))
    assert out.device.type == "meta" and out.shape == q.shape and out.dtype == q.dtype
    qc = torch.empty(1, 512, 32, 64, **meta)
    out = ops.paged_chunk_attention(qc, pages, pages, bt[:1], torch.empty(1, dtype=torch.int32, device="meta"))
    assert out.device.type == "meta" and out.shape == qc.shape
    assert set(ops.counts().values()) == {0}


def test_paged_cpu_tensors_take_the_plain_versions_and_are_counted():
    ops.reset_counts()
    rng, kpn, vpn, btn = paged_inputs(3, 1, 2, 16, 4, 2, 16)
    kp, vp, bt = torch.from_numpy(kpn), torch.from_numpy(vpn), torch.from_numpy(btn)
    ops.paged_decode_attention(torch.zeros(1, 4, 16), kp, vp, bt, torch.tensor([3], dtype=torch.int32))
    ops.paged_chunk_attention(torch.zeros(1, 4, 4, 16), kp, vp, bt, torch.tensor([2], dtype=torch.int32))
    counts = ops.counts()
    assert counts["paged_decode_attn_ref"] == 1 and counts["paged_chunk_attn_ref"] == 1
    assert counts["decode_attn_ref"] == 0  # the inner dense oracle is part of the paged call
    assert counts["paged_decode_attention"] == counts["paged_chunk_attention"] == 0


@pytest.mark.parametrize("case,exc", [
    ("float32", TypeError),
    ("head_dim_32", ValueError),
    ("int64_table", ValueError),
    ("gqa_mismatch", ValueError),
    ("lengths_shape", ValueError),
])
def test_paged_kernel_input_checks_raise(case, exc):
    """What the kernels do not take raises before any launch."""
    q = torch.zeros(2, 8, 64, dtype=torch.bfloat16)
    pages = torch.zeros(6, 16, 2, 64, dtype=torch.bfloat16)
    bt = torch.zeros(2, 3, dtype=torch.int32)
    lens = torch.zeros(2, dtype=torch.int32)
    if case == "float32":
        q, pages = q.float(), pages.float()
    elif case == "head_dim_32":
        q, pages = q[..., :32].contiguous(), pages[..., :32].contiguous()
    elif case == "int64_table":
        bt = bt.long()
    elif case == "gqa_mismatch":
        pages = torch.zeros(6, 16, 3, 64, dtype=torch.bfloat16)
    elif case == "lengths_shape":
        lens = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(exc):
        tpaged._check_pages(q, pages, pages, bt, lens, "paged_decode_attention", "cur_len")
    with pytest.raises(exc):
        tpaged._check_pages(q[:, None], pages, pages, bt, lens, "paged_chunk_attention", "start")


# ------------------------------------------------------------- KVArena vs JAX


def _arenas():
    kw = dict(num_pages=12, page_size=4, kv_heads=2, head_dim=8)
    stages = {"g0": 1, "g1": 2}
    return JaxArena(stages, dtype=jnp.float32, **kw), KVArena(stages, dtype=torch.float32,
                                                               device="cpu", **kw)


def _same_state(ja, ta, seqs):
    assert ta.stats() == ja.stats()
    assert ta._refs == ja._refs and ta._free == ja._free
    for s in seqs:
        np.testing.assert_array_equal(ta.block_row(s, 6), ja.block_row(s, 6))
        assert ta.peak_pages(s) == ja.peak_pages(s)
        assert ta.amortized_pages(s) == ja.amortized_pages(s)
        assert ta.shared_pages(s) == ja.shared_pages(s)
    ja.check_consistency()
    ta.check_consistency()


def _write(ja, ta, seq, length, seed):
    """The same dense prefill caches into both arenas' pages."""
    rng = np.random.default_rng(seed)
    caches = {g: {kv: rng.standard_normal((n, 1, 24, 2, 8)).astype(np.float32) for kv in ("k", "v")}
              for g, n in (("g0", 1), ("g1", 2))}
    ja.write_prefill(seq, {g: {kv: jnp.asarray(x) for kv, x in c.items()} for g, c in caches.items()}, length)
    ta.write_prefill(seq, {g: {kv: torch.from_numpy(x) for kv, x in c.items()} for g, c in caches.items()},
                     length)


def _same_data(ja, ta, seqs):
    for s in seqs:
        for g in ("g0", "g1"):
            jg, tg = ja.gather(s, g), ta.gather(s, g)
            for kv in ("k", "v"):
                np.testing.assert_array_equal(tg[kv].numpy(), np.asarray(jg[kv]))


def test_kvarena_bookkeeping_and_data_match_jax_on_a_scripted_sequence():
    ja, ta = _arenas()
    prompt = np.arange(1, 11, dtype=np.int32)  # 10 tokens: 2 full pages + a tail
    both_do = lambda fn, *a: (getattr(ja, fn)(*a), getattr(ta, fn)(*a))  # noqa: E731

    ra, rt = both_do("alloc_prefill", "a", prompt)
    assert ra == rt and ra[1] == 0
    _write(ja, ta, "a", 10, seed=1)
    both_do("commit_prefill", "a")
    _same_state(ja, ta, ["a"])

    ra, rt = both_do("alloc_prefill", "b", prompt)  # whole-prompt hit, tail included
    assert ra == rt and ra[1] == 10
    both_do("commit_prefill", "b")
    assert both_do("extend", "b", 11) == ([], [])
    ra, rt = both_do("make_private", "b", 10)  # copy-on-write of the shared tail page
    assert ra is rt is True
    _same_state(ja, ta, ["a", "b"])
    _same_data(ja, ta, ["a", "b"])

    assert both_do("alloc", "c", 5)[0] == ta.block_row("c", 6)[:2].tolist()
    both_do("extend", "a", 13)
    _same_state(ja, ta, ["a", "b", "c"])
    assert both_do("free", "a") == (4, 4)
    _same_state(ja, ta, ["b", "c"])

    # a partial prefix hit on free-but-cached pages (resurrected), a
    # private suffix written past them
    other = np.concatenate([prompt[:8], [99, 98, 97]]).astype(np.int32)
    ra, rt = both_do("alloc_prefill", "d", other)
    assert ra == rt and ra[1] == 8
    _write(ja, ta, "d", 11, seed=2)
    both_do("commit_prefill", "d")
    _same_state(ja, ta, ["b", "c", "d"])
    _same_data(ja, ta, ["b", "c", "d"])

    with pytest.raises(ArenaFull):
        ta.alloc("e", 4 * 12)
    for s in ("b", "c", "d"):
        both_do("free", s)
    _same_state(ja, ta, [])
    assert ta.used_pages() == ja.used_pages() == 0


def test_kvarena_writes_its_pages_in_place():
    """write_prefill, make_private and swap_data keep the arena's tensors:
    no step copies the pool."""
    _, ta = _arenas()
    before = {g: {kv: t.data_ptr() for kv, t in st.items()} for g, st in ta.data.items()}
    ta.alloc_prefill("a", np.arange(10, dtype=np.int32))
    ta.write_prefill("a", {g: {kv: torch.ones(n, 1, 12, 2, 8) for kv in ("k", "v")}
                           for g, n in (("g0", 1), ("g1", 2))}, 10)
    ta.commit_prefill("a")
    ta.alloc_prefill("b", np.arange(10, dtype=np.int32))
    ta.extend("b", 11)
    assert ta.make_private("b", 10)
    for g in ta.data:
        ta.swap_data(g, ta.data[g])
    assert {g: {kv: t.data_ptr() for kv, t in st.items()} for g, st in ta.data.items()} == before
    assert float(ta.gather("b", "g1")["k"][:, :10].min()) == 1.0
