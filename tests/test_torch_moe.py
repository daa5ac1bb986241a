"""The port's MoE family: K5's plain version, the MoE layer, the MoE chain.

On the CPU: the plain K5 (``gmm_ref``) against the JAX Pallas kernel in
interpret mode; the port's ``apply_moe`` against the JAX package's on the
same bridged weights and the same numpy input — routing, slot positions and
drops exactly, outputs and metrics at tolerance — at the reduced qwen3 width
and at qwen3's routing width with a capacity that drops tokens; the MoE
chain through the port's engine against the JAX engine, teacher-forced; the
reference's invariants inside the port (paged == dense, chunked == dense,
batcher == per-request generate); the two repairs the MoE family needed
(the bridge's per-leaf dtypes, the sliced parameter draw); and a rehearsal
of chip_smoke.py's MoE phases. K5 itself is held against its plain version
on the card by test_torch_kernels_cuda.py.
"""
import dataclasses
import importlib.util
import math
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # the suite runs several workers at once: leave them cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.moe_gmm import moe_gmm as jax_moe_gmm  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.core import FusionPolicy, TinyTorchBackend  # noqa: E402
from repro_torch.kernels import moe_gmm as tgmm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models import params as tparams_mod  # noqa: E402
from repro_torch.models.params import ParamDef, init_params  # noqa: E402
from repro_torch.serving.continuous import ContinuousBatcher  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

ARCH = "qwen3-moe-30b-a3b"
CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    """tests/test_kernels.py's tolerances."""
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def to_numpy_f32(params):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), params)


def no_drop(cfg):
    """``cfg`` with capacity factor E / k: every expert's capacity is at least
    the call's token count, so no call drops a token."""
    return dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)


# ------------------------------------------------------- K5, plain vs JAX


@pytest.mark.parametrize("e,c,d,f", [
    (4, 64, 128, 256), (2, 128, 64, 128), (1, 32, 32, 32),  # tests/test_kernels.py:141
    (4, 8, 64, 96), (3, 24, 96, 64),                          # the serve path's C = 8 and 24
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_gmm_matches_jax_pallas(e, c, d, f, dtype):
    rng = np.random.default_rng(5)
    xn = rng.standard_normal((e, c, d)).astype(np.float32)
    wn = (rng.standard_normal((e, d, f)) * 0.05).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    want = jax_moe_gmm(jnp.asarray(xn).astype(jdt), jnp.asarray(wn).astype(jdt),
                       block_c=32, block_f=32, block_d=32, interpret=True)
    got = tgmm.moe_gmm(torch.from_numpy(xn).to(tdt), torch.from_numpy(wn).to(tdt))
    assert got.dtype == tdt and got.shape == (e, c, f)
    np.testing.assert_allclose(as_np(got), as_np(want), **tol(dtype))
    np.testing.assert_allclose(as_np(got), as_np(jax_ref.gmm_ref(jnp.asarray(xn).astype(jdt),
                                                                jnp.asarray(wn).astype(jdt))),
                               **tol(dtype))


@pytest.mark.parametrize("e,c,d,f,rows", [
    (4, 16, 64, 96, [16, 3, 0, 9]),   # a full expert, partial ones, an empty one
    (3, 24, 96, 64, [1, 24, 7]),
    (4, 8, 64, 32, [0, 0, 0, 0]),     # no expert received a token
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_gmm_with_rows_matches_jax_pallas(e, c, d, f, rows, dtype):
    """K5's plain version with ``rows``: xe's rows past rows[e] are zero (as
    the MoE layer's scatter leaves them), so the JAX kernel on the same
    buffer computes the same function; skipped rows are exact zeros, and the
    result equals the plain version without ``rows`` bit for bit (each
    skipped product is 0 * w)."""
    rng = np.random.default_rng(6)
    keep = np.arange(c)[None, :] < np.asarray(rows)[:, None]
    xn = (rng.standard_normal((e, c, d)) * keep[..., None]).astype(np.float32)
    wn = (rng.standard_normal((e, d, f)) * 0.05).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    want = jax_moe_gmm(jnp.asarray(xn).astype(jdt), jnp.asarray(wn).astype(jdt),
                       block_c=8, block_f=32, block_d=32, interpret=True)
    xe, w = torch.from_numpy(xn).to(tdt), torch.from_numpy(wn).to(tdt)
    rt = torch.tensor(rows, dtype=torch.int32)
    got = tgmm.moe_gmm(xe, w, rt, active=2)
    assert got.dtype == tdt and got.shape == (e, c, f)
    np.testing.assert_allclose(as_np(got), as_np(want), **tol(dtype))
    assert not got[torch.from_numpy(~keep)].any()
    assert torch.equal(got, tgmm.moe_gmm(xe, w))
    # rows that are not zero past rows[e] are masked: the kept rows' products only
    noisy = xe + torch.from_numpy((~keep)[..., None] * np.ones(d, np.float32)).to(tdt)
    assert torch.equal(tgmm.moe_gmm(noisy, w, rt), got)


def test_gmm_cpu_tensors_take_the_plain_version_and_are_counted():
    ops.reset_counts()
    xe, w = torch.ones(2, 8, 16, dtype=torch.bfloat16), torch.ones(2, 16, 8, dtype=torch.bfloat16)
    out = ops.gmm(xe, w)
    assert torch.equal(out, torch.full((2, 8, 8), 16.0, dtype=torch.bfloat16))
    assert ops.counts()["gmm_ref"] == 1 and ops.counts()["moe_gmm"] == 0
    meta = ops.gmm(xe.to("meta"), w.to("meta"))
    assert meta.device.type == "meta" and meta.shape == (2, 8, 8) and meta.dtype == torch.bfloat16
    assert ops.counts()["moe_gmm"] == 0 and ops.counts()["gmm_ref"] == 1
    ops.reset_counts()


@pytest.mark.parametrize("case,exc", [
    ("float32", TypeError),
    ("d_not_multiple_of_8", ValueError),
    ("f_not_multiple_of_8", ValueError),
    ("expert_mismatch", ValueError),
    ("depth_mismatch", ValueError),
    ("device_mismatch", ValueError),
    ("not_contiguous", ValueError),
])
def test_gmm_kernel_input_checks_raise(case, exc):
    """What K5 does not take raises before any launch (the checks the
    wrapper runs for a CUDA tensor)."""
    xe = torch.zeros(2, 8, 64, dtype=torch.bfloat16)
    w = torch.zeros(2, 64, 32, dtype=torch.bfloat16)
    if case == "float32":
        xe, w = xe.float(), w.float()
    elif case == "d_not_multiple_of_8":
        xe, w = torch.zeros(2, 8, 60, dtype=torch.bfloat16), torch.zeros(2, 60, 32, dtype=torch.bfloat16)
    elif case == "f_not_multiple_of_8":
        w = torch.zeros(2, 64, 36, dtype=torch.bfloat16)
    elif case == "expert_mismatch":
        w = w[:1]
    elif case == "depth_mismatch":
        w = torch.zeros(2, 32, 32, dtype=torch.bfloat16)
    elif case == "device_mismatch":
        w = w.to("meta")
    elif case == "not_contiguous":
        w = torch.zeros(2, 32, 64, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(exc):
        tgmm._check(xe, w)


# ------------------------------------------------- the MoE layer vs JAX


def routing_width():
    """qwen3's routing width (128 experts, top 8) at a small model width,
    with a capacity factor that drops tokens: 192 tokens give each expert
    12 choices on average against a capacity of 8."""
    jcfg = dataclasses.replace(jax_reduced(jax_get_arch(ARCH)), num_experts=128, num_experts_per_tok=8,
                               capacity_factor=0.5)
    tcfg = dataclasses.replace(reduced_config(get_arch(ARCH)), num_experts=128, num_experts_per_tok=8,
                               capacity_factor=0.5)
    return jcfg, tcfg, (2, 96)


def reduced():
    return jax_reduced(jax_get_arch(ARCH)), reduced_config(get_arch(ARCH)), (2, 24)


class _DispatchSpy:
    """Stands in for ``jnp`` inside the JAX MoE module for one call and keeps
    the dispatch buffer the first expert product receives."""

    def __init__(self):
        self.xe = None

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *operands, **kwargs):
        if spec == "gecd,edf->gecf" and self.xe is None:
            self.xe = np.asarray(operands[0].astype(jnp.float32))
        return jnp.einsum(spec, *operands, **kwargs)


def jax_slots(xe, x, idx):
    """Each (token, choice)'s slot in the JAX dispatch buffer, found by its
    token vector in its expert's rows (-1: dropped). xe: (1, E, C, d);
    x: (N, d); idx: (N, k)."""
    pos = np.full(idx.shape, -1, np.int64)
    for i in range(idx.shape[0]):
        for j in range(idx.shape[1]):
            hits = np.nonzero((xe[0, idx[i, j]] == x[i]).all(axis=-1))[0]
            assert len(hits) <= 1
            if len(hits):
                pos[i, j] = hits[0]
    return pos


@pytest.mark.parametrize("width", ["reduced", "routing_width"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_moe_matches_jax(monkeypatch, width, dtype):
    jcfg, tcfg, (b, t) = reduced() if width == "reduced" else routing_width()
    jdt, tdt = DTYPES[dtype]
    jdefs = jax_moe.moe_defs(jcfg)
    jp = jax_init_params(jdefs, jax.random.PRNGKey(3))
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    assert jp["router"].dtype == jnp.float32
    tp = params_from_numpy(to_numpy_f32(jp), moe.moe_defs(tcfg), dtype=tdt, device=CPU)
    assert tp["router"].dtype == torch.float32 and tp["wi_gate"].dtype == tdt
    xn = np.random.default_rng(11).standard_normal((b, t, tcfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(xn).astype(jdt), torch.from_numpy(xn).to(tdt)
    k, n = tcfg.num_experts_per_tok, b * t

    # the inputs hold no top-k near-tie: the k-th and (k+1)-th largest router
    # probabilities of every token, and each adjacent pair above them, differ
    # by more than 1e-6 (so fp32 rounding cannot reorder the choices)
    probs = np.asarray(jax.nn.softmax(jnp.einsum("btd,de->bte", jx.astype(jnp.float32), jp["router"]), -1))
    top = -np.sort(-probs.reshape(n, -1), axis=-1)[:, : k + 1]
    assert (top[:, :-1] - top[:, 1:]).min() > 1e-6
    jidx = np.asarray(jax.lax.top_k(jnp.asarray(probs), k)[1]).reshape(n, k)

    spy = _DispatchSpy()
    monkeypatch.setattr(jax_moe, "jnp", spy)
    jy, jm = jax_moe.apply_moe(jp, jx, jcfg)
    monkeypatch.undo()
    jpos = jax_slots(spy.xe, np.asarray(jx.astype(jnp.float32)).reshape(n, -1), jidx)

    calls = []
    gmm = moe.kops.gmm
    monkeypatch.setattr(moe.kops, "gmm", lambda xe, w, rows=None, active=None: (
        calls.append((rows, active)), gmm(xe, w, rows, active))[1])
    with torch.no_grad():
        _, e_flat, _, pos = moe.route(tp, tx, tcfg)
        ty, tm = moe.apply_moe(tp, tx, tcfg)
    cap = moe.capacity(n, tcfg)
    assert cap == jax_moe.capacity(n, jcfg) == spy.xe.shape[2]
    tidx, tpos = e_flat.numpy().reshape(n, k), pos.numpy().reshape(n, k)
    np.testing.assert_array_equal(tidx, jidx)
    kept = tpos < cap
    np.testing.assert_array_equal(kept, jpos >= 0)
    np.testing.assert_array_equal(np.where(kept, tpos, -1), jpos)
    if width == "routing_width":
        assert 0.2 < 1 - kept.mean() < 0.8  # this config drops tokens
    # K5 got each expert's kept rows, the JAX dispatch's count, in all three products
    jrows = np.bincount(jidx[jpos >= 0], minlength=tcfg.num_experts)
    assert len(calls) == 3 and all(a == min(tcfg.num_experts, n * k) for _, a in calls)
    for rows, _ in calls:
        assert rows.dtype == torch.int32
        np.testing.assert_array_equal(rows.numpy(), jrows)
    assert ty.dtype == tdt and ty.shape == (b, t, tcfg.d_model)
    np.testing.assert_allclose(as_np(ty), as_np(jy), **tol(dtype))
    for name in ("moe_aux", "moe_dropped"):
        assert tm[name].dtype == torch.float32
        np.testing.assert_allclose(float(tm[name]), float(jm[name]), **tol("float32"))


def test_capacity_and_groups_match_jax():
    jcfg, tcfg, _ = routing_width()
    full_j, full_t = jax_get_arch(ARCH), get_arch(ARCH)
    for n in (1, 8, 37, 128, 192, 300, 512):
        assert moe.capacity(n, tcfg) == jax_moe.capacity(n, jcfg)
        assert moe.capacity(n, full_t) == jax_moe.capacity(n, full_j)
        assert moe.num_groups(n, 1, full_t) == jax_moe.num_groups(n, 1, full_j, None) == 1
    assert [moe.capacity(n, full_t) for n in (1, 8, 37, 128, 300, 512)] == [8, 8, 8, 16, 24, 40]
    # on a mesh, the reference's count: one group per data-parallel shard,
    # halved while a group would be too small
    from repro.sharding.specs import LogicalRules as JaxRules
    from repro_torch.sharding.specs import train_rules

    for sizes in ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}, {"data": 2, "model": 2}):
        for n, b in ((1, 1), (128, 128), (256 * 4096, 256), (512, 4), (96, 3)):
            got = moe.num_groups(n, b, full_t, train_rules(sizes))
            assert got == jax_moe.num_groups(n, b, full_j, JaxRules({}, sizes))


def test_apply_moe_on_meta_tensors(monkeypatch):
    """The shape-only run of a fused unit: no value is read and no shape
    depends on the data."""
    cfg = reduced_config(get_arch(ARCH))
    defs = moe.moe_defs(cfg)
    params = tree.map(lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"), defs)
    calls = []
    gmm = moe.kops.gmm
    monkeypatch.setattr(moe.kops, "gmm", lambda xe, w, rows=None, active=None: (
        calls.append((rows, active)), gmm(xe, w, rows, active))[1])
    y, m = moe.apply_moe(params, torch.empty(3, 7, cfg.d_model, dtype=torch.bfloat16, device="meta"), cfg)
    assert y.device.type == "meta" and y.shape == (3, 7, cfg.d_model) and y.dtype == torch.bfloat16
    assert m["moe_aux"].shape == () and m["moe_dropped"].dtype == torch.float32
    # the kept rows are a device tensor, the bound on active experts a shape
    assert len(calls) == 3
    for rows, active in calls:
        assert rows.device.type == "meta" and rows.shape == (cfg.num_experts,) and rows.dtype == torch.int32
        assert active == min(cfg.num_experts, 3 * 7 * cfg.num_experts_per_tok)


# ------------------------------------------------- the MoE chain vs the JAX engine


# The JAX chain's teacher-forced logits, in a process of its own with XLA's
# excess precision off (see tests/test_torch_serving.py): bf16 rounds where
# the code says in both packages. bf16 keeps the JAX init's dtypes (the
# router in fp32); fp32 casts every leaf.
JAX_CHAIN = """
import dataclasses, os, pickle, sys
os.nice(10)  # yield the CPU to the suite's timing-sensitive tests running beside it
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_arch, reduced_config
from repro.core import FusionPolicy, TinyJaxBackend
from repro.models.model import build_model
from repro.serving.engine import ServingEngine

max_len, t_in, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
seq = np.load(out + ".tokens.npy")
result = {}
for dtype in ("float32", "bfloat16"):
    cfg = dataclasses.replace(reduced_config(get_arch("qwen3-moe-30b-a3b")), kv_cache_dtype=dtype)
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    if dtype == "float32":
        params = jax.tree.map(lambda x: x.astype(jnp.float32), params)
    platform = TinyJaxBackend(FusionPolicy(enabled=False))
    try:
        engine = ServingEngine(model, platform, max_len=max_len, params=params)
        logits, caches, cur = engine.prefill({"tokens": jnp.asarray(seq[:, :t_in])})
        got = [np.asarray(logits)]
        for i in range(t_in, seq.shape[1]):  # teacher forcing: feed the true next token
            logits, caches = engine.decode_step(jnp.asarray(seq[:, i : i + 1]), cur, caches)
            cur = cur + 1
            got.append(np.asarray(logits))
    finally:
        platform.shutdown()
    result[dtype] = {"params": jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), params),
                     "logits": got}
with open(out, "wb") as f:
    pickle.dump(result, f)
"""
SEQ = np.random.default_rng(9).integers(0, 256, (1, 14)).astype(np.int32)
T_IN = 10
MAX_LEN = 32


@pytest.fixture(scope="module")
def jax_chain_logits(tmp_path_factory):
    """{dtype: {"params", "logits"}} from the JAX MoE chain on SEQ."""
    out = tmp_path_factory.mktemp("jax_moe_chain") / "logits.pkl"
    np.save(f"{out}.tokens.npy", SEQ)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false").strip())
    proc = subprocess.run([sys.executable, "-c", JAX_CHAIN, str(MAX_LEN), str(T_IN), str(out)],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_teacher_forced_logits_match_jax_engine(jax_chain_logits, dtype):
    """The same weights (JAX's, bridged with their dtypes) and the same
    tokens through both MoE chains: fp32 within 2e-5, bf16 within 2e-2 of
    max |logit|; meanwhile the port's chain fuses from 4 instances to 1."""
    ref_ = jax_chain_logits[dtype]
    tdt = getattr(torch, dtype)
    cfg = dataclasses.replace(reduced_config(get_arch(ARCH)), kv_cache_dtype=dtype)
    model = build_model(cfg)
    params = params_from_numpy(ref_["params"], model.param_defs, dtype=tdt, device=CPU)
    assert params["blocks"]["moe"]["router"].dtype == torch.float32
    platform = TinyTorchBackend(FusionPolicy(min_observations=2, merge_cost_s=0.0))
    try:
        engine = ServingEngine(model, platform, max_len=MAX_LEN, params=params, device=CPU)
        assert len(platform.registry.live_instances()) == len(engine.chain_names()) == 4
        logits, caches, cur = engine.prefill({"tokens": torch.from_numpy(SEQ[:, :T_IN])})
        got = [logits.numpy()]
        for i in range(T_IN, SEQ.shape[1]):
            logits, caches = engine.decode_step(torch.from_numpy(SEQ[:, i : i + 1]), cur, caches)
            cur = cur + 1
            got.append(logits.numpy())
        (unit,) = platform.registry.live_instances()
        assert set(unit.members) == set(engine.chain_names())
        assert not unit._eager_entries  # the fused MoE chain runs as one unit
    finally:
        platform.shutdown()
    assert len(got) == len(ref_["logits"]) == 5
    for t, j in zip(got, ref_["logits"]):
        assert np.isfinite(t).all()
        if dtype == "float32":
            np.testing.assert_allclose(t, j, **tol("float32"))
        else:
            assert np.abs(t - j).max() <= 2e-2 * np.abs(j).max()


# ------------------------------------------------- invariants inside the port


@pytest.fixture(scope="module")
def moe_engine():
    """Reduced qwen3 with a capacity factor that drops nothing, served from
    a KV arena by a fusing platform."""
    cfg = no_drop(reduced_config(get_arch(ARCH)))
    platform = TinyTorchBackend(FusionPolicy(min_observations=2, merge_cost_s=0.0))
    engine = ServingEngine(build_model(cfg), platform, max_len=64, device=CPU, kv_pages=64,
                           kv_page_size=16)
    yield engine
    platform.shutdown()


def dense(engine, p, steps):
    return engine.generate({"tokens": torch.from_numpy(p)}, steps=steps)[0].numpy()


def test_moe_paged_generate_matches_dense(moe_engine):
    p = np.random.default_rng(0).integers(0, 256, (2, 10)).astype(np.int32)
    got, _ = moe_engine.generate_paged({"tokens": torch.from_numpy(p)}, steps=8)
    np.testing.assert_array_equal(got.numpy(), dense(moe_engine, p, 8))
    moe_engine.arena.check_consistency()
    assert moe_engine.arena.used_pages() == 0


@pytest.mark.parametrize("chunk", [4, None])
def test_moe_chunked_prefill_matches_dense(moe_engine, chunk):
    """A prompt through many small padded chunks gives dense generate's
    tokens: with no drops, a token's MoE output does not depend on the rows
    beside it in the call (padding rows included)."""
    p = ((np.arange(1, 23) * 5) % 97).astype(np.int32)[None, :]
    ref_ = dense(moe_engine, p, 6)
    cb = ContinuousBatcher(moe_engine, capacity=2, prefill_chunk=chunk)
    try:
        np.testing.assert_array_equal(cb.submit({"tokens": p}, 6).result(timeout=120)["tokens"], ref_)
    finally:
        cb.shutdown()
    moe_engine.arena.check_consistency()
    assert moe_engine.arena.used_pages() == 0


def test_moe_batcher_matches_per_request_generate(moe_engine):
    """Ragged joins and leaves at capacity 4 give what solo dense generate
    gives. Decode never drops at a batch of B <= 8 rows: an expert receives
    at most B choices (top-k picks distinct experts), and the capacity is at
    least 8. A prefill with drops would break this equality — in the
    reference too, because a call's capacity follows its row count (a dense
    prefill and a padded chunk differ) — so the model here drops nothing."""
    prompts = [np.full((1, 4 + 3 * i), 3 + i, np.int32) for i in range(3)]
    gens = [6, 9, 5]
    refs = [dense(moe_engine, p, g) for p, g in zip(prompts, gens)]
    cb = ContinuousBatcher(moe_engine, capacity=4)
    try:
        futs = [cb.submit({"tokens": p}, g) for p, g in zip(prompts, gens)]
        for f, r in zip(futs, refs):
            np.testing.assert_array_equal(f.result(timeout=120)["tokens"], r)
    finally:
        cb.shutdown()
    moe_engine.arena.check_consistency()
    assert moe_engine.arena.used_pages() == 0


def test_moe_decode_step_never_drops_at_batch_8():
    cfg = get_arch(ARCH)
    assert moe.capacity(8, cfg) >= 8 >= cfg.num_experts_per_tok
    params = init_params(moe.moe_defs(reduced_config(cfg)), 0, device=CPU)
    x = torch.randn(8, 1, 64, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    _, m = moe.apply_moe(params, x, reduced_config(cfg))
    assert float(m["moe_dropped"]) == 0.0


def test_build_model_families():
    """The port builds the block families (dense, moe, vlm, ssm), the
    hybrid and the enc-dec (audio, its encoder and decoder stacks under
    ``encdec``); the vlm prefill takes frontend embeddings in place of
    tokens; a family the port does not know raises."""
    llama = reduced_config(get_arch("llama3.2-1b"))
    vlm = build_model(dataclasses.replace(llama, family="vlm"))
    params = vlm.init(0, device=CPU)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (1, 6)).astype(np.int32))
    with torch.no_grad():
        a, _ = vlm.prefill_fn(params, {"tokens": toks})
        b, _ = vlm.prefill_fn(params, {"embeds": params["embed"]["table"][toks.long()]})
    assert torch.equal(a, b)
    assert "moe" in build_model(reduced_config(get_arch(ARCH))).param_defs["blocks"]
    assert "ssm" in build_model(reduced_config(get_arch("mamba2-370m"))).param_defs["blocks"]
    hybrid = build_model(reduced_config(get_arch("zamba2-7b"))).param_defs["hybrid"]
    assert set(hybrid) == {"groups", "shared", "tail"} and "attn" in hybrid["shared"]
    encdec = build_model(reduced_config(get_arch("seamless-m4t-medium"))).param_defs["encdec"]
    assert set(encdec) == {"encoder", "decoder"} and {"cross", "ln_cross"} <= set(encdec["decoder"])
    with pytest.raises(NotImplementedError):
        build_model(dataclasses.replace(llama, family="no-such-family"))


# ------------------------------------------------- the repairs


def test_bridge_keeps_each_leaf_dtype():
    """The fp32 router stays fp32 beside bf16 weights; float32 asks for a
    float32 tree; the llama tree bridges leaf for leaf as a uniform cast."""
    model = build_model(reduced_config(get_arch(ARCH)))
    src = to_numpy_f32(jax_build_model(jax_reduced(jax_get_arch(ARCH))).init(jax.random.PRNGKey(0)))
    bf = params_from_numpy(src, model.param_defs, device=CPU)
    assert bf["blocks"]["moe"]["router"].dtype == torch.float32
    assert bf["blocks"]["moe"]["wi_gate"].dtype == torch.bfloat16
    np.testing.assert_array_equal(bf["blocks"]["moe"]["router"].numpy(), src["blocks"]["moe"]["router"])
    f32 = params_from_numpy(src, model.param_defs, dtype=torch.float32, device=CPU)
    assert all(x.dtype == torch.float32 for x in tree.leaves(f32))
    llama = build_model(reduced_config(get_arch("llama3.2-1b")))
    lsrc = tree.map(lambda d: np.random.default_rng(0).standard_normal(d.shape).astype(np.float32),
                    llama.param_defs)
    got = params_from_numpy(lsrc, llama.param_defs, device=CPU)
    for x, a in zip(tree.leaves(got), tree.leaves(lsrc)):
        assert torch.equal(x, torch.from_numpy(a).to(torch.bfloat16))
    with pytest.raises(ValueError):
        params_from_numpy({"w": np.zeros(3, np.float32)}, {"w": ParamDef((4,))}, device=CPU)


def test_init_params_draws_sliced_deterministic_and_in_each_def_dtype(monkeypatch):
    """Each leaf of two or more dimensions is drawn in leading-axis slices
    (here forced down to one slice per draw), seeded, in its def's dtype,
    with the JAX init rule's scale."""
    monkeypatch.setattr(tparams_mod, "DRAW_VALUES", 1)
    defs = build_model(reduced_config(get_arch(ARCH))).param_defs
    a, b = init_params(defs, 5, device=CPU), init_params(defs, 5, device=CPU)
    c = init_params(defs, 6, device=CPU)
    for x, y, z, d in zip(tree.leaves(a), tree.leaves(b), tree.leaves(c), tree.leaves(defs)):
        assert x.dtype == d.dtype and tuple(x.shape) == d.shape
        assert torch.equal(x, y)
        if d.init in ("normal", "embed"):
            assert not torch.equal(x, z)
    router = a["blocks"]["moe"]["router"]  # (L, d, E) fp32, fan-in d
    assert router.dtype == torch.float32
    assert abs(router.std().item() - 1 / math.sqrt(router.shape[-2])) < 0.03
    wo = a["blocks"]["moe"]["wo"].float()  # (L, E, f, d), fan-in f
    assert abs(wo.std().item() - 1 / math.sqrt(wo.shape[-2])) < 0.03
    # slices differ from one another (each slice its own draw)
    assert not torch.equal(a["blocks"]["moe"]["wi_gate"][0], a["blocks"]["moe"]["wi_gate"][1])


# ------------------------------------------------- chip_smoke rehearsal


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_moe_phases_rehearsal_on_cpu():
    """chip_smoke.py's MoE phases at a tiny size on the CPU: the same control
    flow and checks the card run makes; here the plain K5 counts stand in
    for the kernel's, three per MoE layer applied, canary replays counted."""
    smoke = _smoke()
    cfg = reduced_config(get_arch(ARCH))
    params = build_model(cfg).init(0, device=CPU)
    ops.reset_counts()
    out = smoke.serve_phase(torch, CPU, cfg, prompt_lens=(5, 9, 12), new_tokens=4, max_len=24,
                            params=params)
    assert out["live_instances"] == {"unfused": 4, "fused": 1}
    assert out["tokens_identical"]
    assert out["ram_bytes"]["fused"] < out["ram_bytes"]["unfused"]
    assert out["canary_replays"]["fused"] > 0
    assert out["plain_calls"]["gmm_ref"] == 3 * out["moe_layers_applied"]
    assert out["moe_layers_applied"] > 2 * 3 * 4 * cfg.num_layers  # client requests and replays
    assert out["launches"]["moe_gmm"] == 0

    small = dataclasses.replace(no_drop(cfg), d_model=128, d_head=32)
    paged = smoke.paged_serve_phase(torch, CPU, cfg, prompt_lens=(5, 16, 30), n_requests=8, steps=6,
                                    max_len=64, capacity=4, prefix_len=16, small_cfg=small, params=params)
    assert paged["live_instances"] == {"fused": 1, "unfused": 4}
    assert paged["fused_vs_unfused_identical_requests"] == 8
    assert paged["block_rel_err"] == [0.0] * cfg.num_layers
    assert paged["plain_calls"]["fused"]["gmm_ref"] > 0
    assert paged["launches"]["fused"] == {"paged_decode_attention": 0, "paged_chunk_attention": 0,
                                          "moe_gmm": 0}

    block = smoke.moe_block_phase(torch, CPU, cfg, params, prompt_len=9)  # both sides on the host here
    assert block["topk_sets_agree"] == 9 and block["rel_err_on_agreeing_tokens"] == 0.0
    assert smoke.moe_layer_runs(get_arch("llama3.2-1b"), None, 5, []) == 0
