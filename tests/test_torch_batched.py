"""The batched execute: each kernel op under ``torch.func.vmap`` against a
loop over lanes (the plain versions, bit for bit), the vmap repairs in the
models (the eager path's bits unchanged), a reduced llama's fused chain
through ``decode_step_async`` from 8 threads against the JAX engine's on
the same weights, and a rehearsal of chip_smoke's batched phase."""
import dataclasses
import importlib.util
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # the suite runs several workers at once: leave them cores

from repro_torch import tree  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.core import FusionPolicy, TinyTorchBackend  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

ARCH = "llama3.2-1b"
CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
FP32_OF_MAX = 2e-5  # fp32 (tests/test_kernels.py's tolerance), over the output's max |value|
LANES = 3


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def kernel_case(kernel, seed):
    """(call, args, mapped) at a small shape; the unmapped args are shared by
    the lanes (the paged arena, the expert weights, the SSM head params)."""
    g = _gen(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32)

    if kernel == "flash_attention":
        return (lambda q, k, v: ops.attention(q, k, v, causal=True),
                (r(2, 9, 4, 16), r(2, 9, 2, 16), r(2, 9, 2, 16)), (True, True, True))
    if kernel == "decode_attention":
        return ops.decode_attention, (r(2, 4, 16), r(2, 12, 2, 16), r(2, 12, 2, 16), ints(1, 13, 2)), \
            (True, True, True, True)
    if kernel == "paged_decode_attention":
        return ops.paged_decode_attention, (r(2, 4, 16), r(6, 4, 2, 16), r(6, 4, 2, 16), ints(1, 6, 2, 3),
                                            ints(1, 13, 2)), (True, False, False, True, True)
    if kernel == "paged_chunk_attention":
        return ops.paged_chunk_attention, (r(1, 5, 4, 16), r(6, 4, 2, 16), r(6, 4, 2, 16), ints(1, 6, 1, 3),
                                           ints(0, 7, 1)), (True, False, False, True, True)
    if kernel == "moe_gmm":
        return (lambda xe, w, rows: ops.gmm(xe, w, rows, 4),
                (r(4, 3, 16), r(4, 16, 8), ints(0, 4, 4)), (True, False, True))
    assert kernel == "ssd_scan"
    return (lambda x, bm, cm, dt, a, d: ops.ssd(x, bm, cm, dt, a, d, True),
            (r(1, 10, 2, 32), r(1, 10, 1, 16), r(1, 10, 1, 16), r(1, 10, 2).abs() * 0.1, r(2), r(2)),
            (True, True, True, True, False, False))


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("kernel", ["flash_attention", "decode_attention", "paged_decode_attention",
                                    "paged_chunk_attention", "moe_gmm", "ssd_scan"])
def test_kernel_op_under_vmap_equals_the_loop_over_lanes(kernel):
    """The vmap rule folds the lanes into the kernel's batch axis (K5: one
    call per lane); on the CPU the plain version gives every lane the bits
    of a call on that lane alone, in ONE call where the rule folds."""
    call, args, mapped = kernel_case(kernel, 0)
    cases = [kernel_case(kernel, s)[1] for s in range(LANES)]
    stacked = [torch.stack([c[i] for c in cases]) if m else a for i, (a, m) in enumerate(zip(args, mapped))]
    ops.reset_counts()
    got = as_tuple(torch.func.vmap(call, in_dims=tuple(0 if m else None for m in mapped))(*stacked))
    plain_calls = sum(v for k, v in ops.counts().items() if k.endswith("_ref"))
    assert plain_calls == (LANES if kernel == "moe_gmm" else 1)
    loop = [as_tuple(call(*[c[i] if m else a for i, (a, m) in enumerate(zip(args, mapped))])) for c in cases]
    for j, g in enumerate(got):
        assert torch.equal(g, torch.stack([out[j] for out in loop]))


# ------------------------------------------- the vmap repairs keep the bits


def old_stack_into(stacked, i, n, entry, like=None):
    """``stack_into`` before the repair (``new_empty``: unbatched under vmap)."""
    if isinstance(entry, tuple):
        entry = {"k": entry[0], "v": entry[1]}
    if stacked is None:
        stacked = tree.map(lambda x, d: x.new_empty((n, *x.shape), dtype=d.dtype), entry,
                           entry if like is None else like)
    tree.map(lambda o, x: o[i].copy_(x), stacked, entry)
    return stacked


def old_dispatch(x, e_flat, kept, slot, pos_in_row, order, run_start, e, cap, k):
    """The MoE dispatch's in-place writes before the repair."""
    n, d = x.shape[0] * x.shape[1], x.shape[2]
    pos = torch.empty_like(pos_in_row).scatter_(0, order, pos_in_row - run_start)
    buf = x.new_zeros(e * cap + 1, d)
    buf[torch.where(kept, slot, e * cap)] = x.reshape(n, d).repeat_interleave(k, dim=0)
    rows = torch.zeros(e, dtype=torch.int32).index_add_(0, e_flat, kept.int())
    return pos, buf, rows


def test_repaired_stack_into_and_decode_keep_the_eager_bits(monkeypatch):
    cfg = reduced_config(get_arch(ARCH))
    model = build_model(cfg)
    params = model.init(0, device=CPU)
    toks = torch.randint(0, cfg.vocab_size, (2, 7), generator=_gen(1), dtype=torch.int32)
    outs = []
    for fn in (tfm.stack_into, old_stack_into):
        monkeypatch.setattr(tfm, "stack_into", fn)
        with torch.no_grad():
            logits, cache = model.prefill_fn(params, {"tokens": toks})
            cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 3)) for k, v in cache.items()}
            step = model.decode_fn(params, {"tokens": toks[:, :1], "cur_len": torch.full((2,), 7, dtype=torch.int32)},
                                   cache)
        outs.append(tree.leaves((logits, cache, step)))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_repaired_moe_dispatch_keeps_the_eager_bits():
    cfg = reduced_config(get_arch("qwen3-moe-30b-a3b"))
    params = build_model(cfg).init(0, device=CPU)
    layer = tree.map(lambda a: a[0], params["blocks"])["moe"]
    x = torch.randn(2, 5, cfg.d_model, generator=_gen(2)).to(torch.bfloat16)
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    cap = moe_mod.capacity(10, cfg)
    probs, e_flat, w, pos = moe_mod.route(layer, x, cfg)
    # the old route's slot positions, from the same sort
    order = torch.argsort(e_flat, stable=True)
    sorted_e = e_flat[order]
    pos_in_row = torch.arange(e_flat.shape[0])
    is_start = torch.ones_like(sorted_e, dtype=torch.bool)
    is_start[1:] = sorted_e[1:] != sorted_e[:-1]
    run_start = torch.cummax(torch.where(is_start, pos_in_row, 0), dim=0).values
    kept = pos < cap
    slot = e_flat * cap + torch.where(kept, pos, 0)
    old_pos, old_buf, old_rows = old_dispatch(x, e_flat, kept, slot, pos_in_row, order, run_start, e, cap, k)
    assert torch.equal(pos, old_pos)
    new_buf = x.new_zeros(e * cap + 1, cfg.d_model).index_put(
        (torch.where(kept, slot, e * cap),), x.reshape(10, -1).repeat_interleave(k, dim=0))
    assert torch.equal(new_buf[: e * cap], old_buf[: e * cap])  # the spare last row is cut off
    assert torch.equal(torch.zeros(e, dtype=torch.int32).index_add(0, e_flat, kept.int()), old_rows)
    y, _ = moe_mod.apply_moe(layer, x, cfg)
    y_lanes = torch.func.vmap(lambda xx: moe_mod.apply_moe(layer, xx, cfg)[0])(x[:, None])
    assert torch.equal(y_lanes[:, 0], torch.cat([moe_mod.apply_moe(layer, x[i:i + 1], cfg)[0] for i in range(2)]))
    assert y.shape == x.shape


# ----------------------------------- the fused chain, batched, against JAX

CLIENTS = 8
PROMPT = 6
MAX_LEN = 16
JAX_POLICY = dict(min_observations=2, merge_cost_s=0.0)


def fp32_cfg():
    return dataclasses.replace(reduced_config(get_arch(ARCH)), kv_cache_dtype="float32")


def prompts(vocab):
    rng = np.random.default_rng(4)
    return [rng.integers(0, vocab, (1, PROMPT)).astype(np.int32) for _ in range(CLIENTS)]


def drive_batched(engine, clients, to_backend, from_backend):
    """One decode step per client, all submitted from their own threads at
    once through ``decode_step_async``; returns each client's logits."""
    out = [None] * len(clients)
    barrier = threading.Barrier(len(clients))

    def one(i):
        tok, cur, caches = clients[i]
        barrier.wait()
        out[i] = from_backend(engine.decode_step_async(tok, cur, caches).result()[0])

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(clients))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def test_batched_fused_decode_matches_the_jax_engine():
    """8 threads' decode_step_async on the fused reduced llama (fp32), the
    port against the JAX engine on the same weights and prompts (within
    2e-5 of max |logit|: the two frameworks' fp32 matmuls sum in different
    orders), with batches of more than one request and no per-request
    fallback."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import FusionPolicy as JaxPolicy
    from repro.core import TinyJaxBackend
    from repro.models.model import build_model as jax_build
    from repro.serving.engine import ServingEngine as JaxEngine

    cfg = fp32_cfg()
    jmodel = jax_build(cfg)
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32), jmodel.init(jax.random.PRNGKey(0)))
    ps = prompts(cfg.vocab_size)

    def run(engine, platform, to_backend, from_backend):
        engine.generate({"tokens": to_backend(ps[0])}, steps=5)  # observe and fuse
        platform.merger.wait_idle()
        assert len(platform.registry.live_instances()) == 1
        clients = []
        for p in ps:
            logits, caches, cur = engine.prefill({"tokens": to_backend(p)})
            tok = to_backend(np.argmax(from_backend(logits), -1)[:, None].astype(np.int32))
            clients.append((tok, cur, caches))
        return drive_batched(engine, clients, to_backend, from_backend)

    jplat = TinyJaxBackend(JaxPolicy(**JAX_POLICY), max_batch=8, max_delay_ms=20.0)
    try:
        want = run(JaxEngine(jmodel, jplat, max_len=MAX_LEN, params=jparams), jplat, jnp.asarray, np.asarray)
    finally:
        jplat.shutdown()
    tmodel = build_model(cfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tmodel.param_defs, dtype=torch.float32,
                                device=CPU)
    tplat = TinyTorchBackend(FusionPolicy(**JAX_POLICY), max_batch=8, max_delay_ms=20.0)
    try:
        got = run(ServingEngine(tmodel, tplat, max_len=MAX_LEN, params=tparams, device=CPU), tplat,
                  torch.from_numpy, lambda t: t.numpy())
        assert tplat.scheduler.stats()["max_batch_seen"] > 1
        assert all(not s["fallback_requests"] for s in tplat.batching_stats().values())
    finally:
        tplat.shutdown()
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= FP32_OF_MAX * np.abs(w).max()


def test_batched_prefill_and_decode_equal_serial_bit_for_bit():
    """On the CPU a batched program's lanes equal the serial runs' bits:
    prefill (``_fill_prefix`` under vmap) and decode (``stack_into``)."""
    cfg = reduced_config(get_arch(ARCH))
    model = build_model(cfg)
    params = model.init(0, device=CPU)
    platform = TinyTorchBackend(FusionPolicy(**JAX_POLICY), max_batch=4, max_delay_ms=20.0)
    try:
        engine = ServingEngine(model, platform, max_len=MAX_LEN, params=params, device=CPU)
        engine.generate({"tokens": torch.ones(1, PROMPT, dtype=torch.int32)}, steps=4)
        ps = [torch.from_numpy(p) for p in prompts(cfg.vocab_size)[:4]]
        serial = [engine.prefill({"tokens": p}) for p in ps]
        cur = torch.full((1,), PROMPT, dtype=torch.int32)
        futs = [platform.invoke_async(engine.entry, {"tokens": p}, cur, engine.empty_caches(1)) for p in ps]
        for (logits, caches, _), f in zip(serial, futs):
            got = f.result()
            assert all(torch.equal(a, b) for a, b in zip(tree.leaves(got), tree.leaves((logits, caches))))
        toks = [torch.argmax(s[0], -1)[:, None].to(torch.int32) for s in serial]
        serial_step = [engine.decode_step(t, cur, s[1]) for t, s in zip(toks, serial)]
        futs = [engine.decode_step_async(t, cur, s[1]) for t, s in zip(toks, serial)]
        for want, f in zip(serial_step, futs):
            assert all(torch.equal(a, b) for a, b in zip(tree.leaves(f.result()), tree.leaves(want)))
        assert platform.scheduler.stats()["max_batch_seen"] > 1
        assert all(not s["fallback_requests"] for s in platform.batching_stats().values())
    finally:
        platform.shutdown()


def test_chip_smoke_batched_phase_rehearsal_on_cpu():
    """chip_smoke.py's batched phase at a tiny size on the CPU: the same
    closed loop and checks the card run makes (the plain K4 counted)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = smoke.batched_phase(torch, CPU, reduced_config(get_arch(ARCH)), clients=4, prompt_len=5,
                              warmup=2, steps=3, max_len=MAX_LEN)
    assert out["max_batch_seen"] >= 2 and out["fused_batched"]["requests"] == 12
    assert out["decode_attention_launches"] == out["layers"] * out["decode_program_runs"]



def test_decode_attention_vmap_reads_stacked_caches_in_place_and_copies_shared_ones(monkeypatch):
    """K4's vmap rule hands the kernel one layer of the lanes' stacked
    layer-first caches as a view (sequences L * S rows apart, no copy), and
    K/V that the lanes share (no lane axis, which the kernel cannot read at
    stride 0) as a copy; both give the loop over lanes' bits. What the rule
    hands on is read where the CPU runs the plain version."""
    from repro_torch.kernels import decode_attention as k4

    plain, seen = k4.plain, []

    def recording(q, k, v, cur_len):
        seen.append((k4._batch_rows(k), k.is_contiguous()))
        return plain(q, k, v, cur_len)

    monkeypatch.setattr(k4, "plain", recording)
    lanes, layers, s, h, kv, hd = 3, 4, 40, 8, 2, 64
    gen = torch.Generator().manual_seed(3)
    k, v = (torch.randn(lanes, layers, 1, s, kv, hd, generator=gen) for _ in range(2))
    q = torch.randn(lanes, 1, h, hd, generator=gen)
    cur = torch.randint(1, s + 1, (lanes, 1), generator=gen, dtype=torch.int32)
    with torch.no_grad():
        got = torch.func.vmap(lambda q, k, v, c: k4.decode_attention(q, k[2], v[2], c))(q, k, v, cur)
        assert seen[-1] == (layers * s, False)
        loop = torch.stack([plain(q[i], k[i, 2], v[i, 2], cur[i]) for i in range(lanes)])
        assert torch.equal(got, loop)
        got = torch.func.vmap(k4.decode_attention, in_dims=(0, None, None, 0))(q, k[0, 2], v[0, 2], cur)
        assert seen[-1] == (s, True)
        loop = torch.stack([plain(q[i], k[0, 2], v[0, 2], cur[i]) for i in range(lanes)])
        assert torch.equal(got, loop)
