"""The port's hybrid family (zamba2): nested parameter stacks, the hybrid
forward and decode, the monolithic chain, and K3/K4 at head dim 112.

On the CPU: ``hybrid_defs`` against the JAX package's leaf for leaf (the
nested ``stack_defs`` keeps the fan-in axis); ``apply_hybrid_full`` and
``apply_hybrid_decode`` against the JAX package's on the reduced config (5
layers: 2 groups of 2 plus a tail of 1) on the same bridged weights; the
``embed -> core -> head`` chain against the JAX engine, teacher-forced;
fusion 3 -> 1; the paging refusal; the fp32 SSM leaves through the bridge;
K3's and K4's plain versions at zamba2's head dim 112 against JAX's; and a
rehearsal of chip_smoke.py's hybrid phases. The kernels themselves are held
against their plain versions on the card by test_torch_kernels_cuda.py.
"""
import dataclasses
import importlib.util
import math
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
from repro.models import hybrid as jax_hy  # noqa: E402
from repro.models import params as jax_params_mod  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.core import FusionPolicy, TinyTorchBackend  # noqa: E402
from repro_torch.kernels import decode_attention as tdec  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import hybrid as hy  # noqa: E402
from repro_torch.models import params as tparams_mod  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

from test_torch_ssm import (  # noqa: E402
    DTYPES, MAX_LEN, _CountChunked, _smoke, as_np, check_logits, jax_chain, teacher_forced,
    to_numpy_f32, tol,
)

ARCH = "zamba2-7b"
CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]


def leaves_with_paths(t, prefix=()):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from leaves_with_paths(t[k], prefix + (k,))
    else:
        yield prefix, t


# ------------------------------------------------- nested stacks


@pytest.mark.parametrize("full", [False, True])
def test_hybrid_defs_match_jax_leaf_for_leaf(full):
    """``stack_defs(stack_defs(block, every), n_groups)`` composes as in the
    JAX package: the same keys, shapes, dtypes, init rules and fan-in."""
    jcfg, tcfg = jax_get_arch(ARCH), get_arch(ARCH)
    if not full:
        jcfg, tcfg = jax_reduced(jcfg), reduced_config(tcfg)
    assert hy.split_layers(tcfg) == jax_hy.split_layers(jcfg) == ((13, 6, 3) if full else (2, 2, 1))
    jl = dict(leaves_with_paths(jax_hy.hybrid_defs(jcfg)))
    tl = dict(leaves_with_paths(hy.hybrid_defs(tcfg)))
    assert set(jl) == set(tl)
    for path, jd in jl.items():
        td = tl[path]
        assert td.shape == jd.shape and td.init == jd.init and td.scale_axis == jd.scale_axis, path
        assert str(td.dtype).split(".")[-1] == jnp.dtype(jd.dtype).name, path
        assert tparams_mod._fan_in(td) == jax_params_mod._fan_in(jd), path
    groups = tl[("groups", "ssm", "in_x")]
    assert groups.shape[:2] == ((13, 6) if full else (2, 2))


def test_nested_init_draws_with_the_jax_scale():
    """A leaf stacked twice draws with the fan-in of its own axis -2 (for
    ``in_x`` (d, di): d), as the JAX init rule does."""
    cfg = reduced_config(get_arch(ARCH))
    params = build_model(cfg).init(0, device=CPU)
    w = params["hybrid"]["groups"]["ssm"]["in_x"].float()  # (2, 2, d, di)
    assert w.shape == (2, 2, cfg.d_model, cfg.d_inner)
    assert abs(w.std().item() - 1 / math.sqrt(cfg.d_model)) < 0.01
    assert not torch.equal(w[0, 0], w[0, 1]) and not torch.equal(w[0, 0], w[1, 0])
    assert params["hybrid"]["groups"]["ssm"]["A_log"].dtype == torch.float32


# ------------------------------------------------- the hybrid forward vs JAX


def hybrid_params(dtype):
    jcfg, tcfg = jax_reduced(jax_get_arch(ARCH)), reduced_config(get_arch(ARCH))
    jp = jax_build_model(jcfg).init(jax.random.PRNGKey(4))
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tp = params_from_numpy(to_numpy_f32(jp), build_model(tcfg).param_defs, dtype=DTYPES[dtype][1], device=CPU)
    return jcfg, tcfg, jp, tp


def close(got, want, rel):
    """max |got - want| within ``rel`` of max |want|."""
    w = as_np(want)
    assert np.abs(as_np(got) - w).max() <= rel * np.abs(w).max()


def test_apply_hybrid_full_and_decode_match_jax():
    """The reduced zamba2 (2 groups of 2 Mamba layers with the shared block
    after each, a tail of 1) in fp32 on the JAX package's weights: the hidden
    state and every cache leaf after a 16-token prefill, then one decode
    step. Intermediates reach the hundreds (the SSD scores) and the shared
    attention is near-hard at this init scale, so fp32 roundoff in other
    summation orders shows at ~1e-5 of max: fp32 leaves within 1e-4 of max
    (as tests/test_torch_model.py's fp32 logits); the conv histories are bf16
    in both packages (one bf16 step of an input apart at most: 2e-2 of max);
    the decode step, which reads them, within 1e-3 of max. bf16 is held
    against the JAX engine in a subprocess with XLA's excess precision off
    (test_teacher_forced_logits_match_jax_engine)."""
    jcfg, tcfg, jp, tp = hybrid_params("float32")
    t = 16
    xn = np.random.default_rng(12).standard_normal((2, t + 1, tcfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(xn), torch.from_numpy(xn)
    jh, jc, _ = jax_hy.apply_hybrid_full(jp["hybrid"], jx[:, :t], jcfg, None, jnp.arange(t)[None],
                                         collect_cache=True)
    with torch.no_grad():
        th, tc = hy.apply_hybrid_full(tp["hybrid"], tx[:, :t], tcfg, torch.arange(t)[None], collect_cache=True)
    close(th, jh, 1e-4)
    assert set(tc) == set(jc) == {"groups", "attn", "tail"}
    jleaves, tleaves = dict(leaves_with_paths(jc)), dict(leaves_with_paths(tc))
    assert set(jleaves) == set(tleaves)
    for path, jv in jleaves.items():
        assert tuple(tleaves[path].shape) == jv.shape, path
        close(tleaves[path], jv, 2e-2 if tleaves[path].dtype == torch.bfloat16 else 1e-4)
    assert tc["attn"]["k"].shape == (2, 2, t, tcfg.num_kv_heads, tcfg.head_dim)
    assert tc["groups"]["ssd"].shape[:2] == (2, 2) and tc["tail"]["ssd"].shape[0] == 1

    # one more cache slot for the decode step's write at position t
    jcache = dict(jc, attn={k: jnp.pad(v, ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0))) for k, v in jc["attn"].items()})
    tcache = dict(tc, attn={k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 1)) for k, v in tc["attn"].items()})
    cur = np.full((2,), t, np.int32)
    jd, jnew, _ = jax_hy.apply_hybrid_decode(jp["hybrid"], jx[:, t:], jcache, jcfg, None, jnp.asarray(cur))
    with torch.no_grad():
        td, tnew = hy.apply_hybrid_decode(tp["hybrid"], tx[:, t:], tcache, tcfg, torch.from_numpy(cur))
    close(td, jd, 1e-3)
    jn, tn = dict(leaves_with_paths(jnew)), dict(leaves_with_paths(tnew))
    assert set(jn) == set(tn)
    for path, jv in jn.items():
        assert tuple(tn[path].shape) == jv.shape and tn[path].dtype == tcache_dtype(tcache, path), path
        close(tn[path], jv, 2e-2 if tn[path].dtype == torch.bfloat16 else 1e-3)


def tcache_dtype(cache, path):
    node = cache
    for k in path:
        node = node[k]
    return node.dtype


def test_hybrid_prefill_then_decode_matches_a_longer_prefill():
    """tests/test_models.py's serving check for the hybrid, in the port, with
    its tolerance (rtol 0.2, atol 0.5): the conv history is cached in bf16
    (see test_torch_ssm), and the shared attention at this init scale
    amplifies that rounding (the port with the JAX package's weights agrees
    with the JAX package's own mismatch to 1e-5; the port's own seed-0
    weights give a larger one)."""
    cfg = dataclasses.replace(reduced_config(get_arch(ARCH)), kv_cache_dtype="float32")
    model = build_model(cfg)
    params = tree.map(lambda x: x.float(), model.init(0, device=CPU))
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 17)).astype(np.int32))
    with torch.no_grad():
        _, cache = model.prefill_fn(params, {"tokens": toks[:, :16]})
        cache["attn"] = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 1)) for k, v in cache["attn"].items()}
        step, _ = model.decode_fn(params, {"tokens": toks[:, 16:], "cur_len": torch.full((2,), 16, dtype=torch.int32)},
                                  cache)
        full, _ = model.prefill_fn(params, {"tokens": toks})
    np.testing.assert_allclose(step.numpy(), full.numpy(), rtol=0.2, atol=0.5)


# ------------------------------------------------- the monolithic chain vs the JAX engine


@pytest.fixture(scope="module")
def jax_zamba2(tmp_path_factory):
    return jax_chain(ARCH, tmp_path_factory)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_teacher_forced_logits_match_jax_engine(jax_zamba2, dtype):
    """The same weights and tokens through both monolithic chains (tolerances
    in test_torch_ssm.check_logits); the port's chain fuses 3 -> 1 unit."""
    params, got = teacher_forced(ARCH, jax_zamba2[dtype], dtype, 3)
    for name in ("A_log", "D", "dt_bias"):
        assert params["hybrid"]["groups"]["ssm"][name].dtype == torch.float32
        assert params["hybrid"]["tail"]["ssm"][name].dtype == torch.float32
    assert params["hybrid"]["shared"]["attn"]["wq"].dtype == getattr(torch, dtype)
    check_logits(got, jax_zamba2[dtype]["logits"], dtype)


def test_monolithic_chain_fuses_three_to_one_with_identical_tokens():
    cfg = reduced_config(get_arch(ARCH))
    model = build_model(cfg)
    params = model.init(0, device=CPU)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 19)).astype(np.int32))
    out = {}
    for label, policy in (("unfused", FusionPolicy(enabled=False)),
                          ("fused", FusionPolicy(min_observations=2, merge_cost_s=0.0))):
        platform = TinyTorchBackend(policy)
        try:
            engine = ServingEngine(model, platform, max_len=MAX_LEN, params=params, device=CPU)
            assert engine.chain_names() == [f"{ARCH}/embed", f"{ARCH}/core", f"{ARCH}/head"]
            out[label] = [engine.generate({"tokens": toks}, steps=6)[0] for _ in range(2)]
            platform.merger.wait_idle()
            live = platform.registry.live_instances()
            out[label + "_live"] = len(live)
            if label == "fused":
                assert set(live[0].members) == set(engine.chain_names()) and not live[0]._eager_entries
                assert all(m.healthy for m in platform.merger.merge_log)
        finally:
            platform.shutdown()
    assert out["unfused_live"] == 3 and out["fused_live"] == 1
    assert all(torch.equal(a, b) for a, b in zip(out["unfused"], out["fused"]))


def test_prefill_writes_new_attention_caches_and_keeps_the_ssm_states():
    """The dense contract: the prefill lands the attention caches in their
    max_len slots as NEW tensors (the zeroed caches it was given are not
    written), and the SSM states are the built ones."""
    cfg = reduced_config(get_arch(ARCH))
    model = build_model(cfg)
    platform = TinyTorchBackend(FusionPolicy(enabled=False))
    try:
        engine = ServingEngine(model, platform, max_len=MAX_LEN, device=CPU)
        empty = engine.empty_caches(1)
        assert empty["attn"]["k"].shape == (2, 1, MAX_LEN, cfg.num_kv_heads, cfg.head_dim)
        before = tree.map(lambda x: x.clone(), empty)
        toks = torch.from_numpy(np.arange(1, 12, dtype=np.int32)[None])
        _, caches, _ = engine.prefill({"tokens": toks}, caches=empty)
        for a, b in zip(tree.leaves(empty), tree.leaves(before)):
            assert torch.equal(a, b)
        assert caches["attn"]["k"].shape == empty["attn"]["k"].shape
        assert caches["attn"]["k"][:, :, :11].abs().sum() > 0 and caches["attn"]["k"][:, :, 11:].abs().sum() == 0
        _, built = model.prefill_fn(engine.params, {"tokens": toks})
        assert torch.equal(caches["groups"]["ssd"], built["groups"]["ssd"])
        assert torch.equal(caches["attn"]["k"][:, :, :11], built["attn"]["k"])
    finally:
        platform.shutdown()


@pytest.mark.parametrize("how", ["enable_paging", "kv_pages"])
def test_enable_paging_raises_for_the_hybrid_family(how):
    model = build_model(reduced_config(get_arch(ARCH)))
    platform = TinyTorchBackend(FusionPolicy(enabled=False))
    try:
        with pytest.raises(ValueError, match="paged KV unsupported"):
            if how == "kv_pages":
                ServingEngine(model, platform, max_len=MAX_LEN, device=CPU, kv_pages=16)
            else:
                engine = ServingEngine(model, platform, max_len=MAX_LEN, device=CPU)
                assert not engine.paging_supported
                engine.enable_paging(16, 16)
    finally:
        platform.shutdown()


# ------------------------------------------------- K3 and K4 at head dim 112


def test_attention_kernels_take_head_dim_112():
    """zamba2's shared block (32 query heads over 32 kv heads of 112): the
    wrappers' checks pass it (and still refuse a head dim with no
    instantiation)."""
    q = torch.zeros(1, 7, 32, 112, dtype=torch.bfloat16)
    tflash._check(q, q, q)
    tdec._check(q[:, 0].contiguous(), q, q, torch.ones(1, dtype=torch.int32))
    bad = torch.zeros(1, 7, 32, 96, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tflash._check(bad, bad, bad)
    with pytest.raises(ValueError):
        tdec._check(bad[:, 0].contiguous(), bad, bad, torch.ones(1, dtype=torch.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_versions_match_jax_at_head_dim_112(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(21)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((1, 37, 8, 112), (1, 37, 8, 112), (1, 37, 8, 112)))
    got = tflash.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)))
    want = jax_ref.mha_ref(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
    np.testing.assert_allclose(as_np(got), as_np(want), **tol(dtype))
    cur = np.array([37], np.int32)
    got = tdec.decode_attention(torch.from_numpy(q[:, 0]).to(tdt), torch.from_numpy(k).to(tdt),
                                torch.from_numpy(v).to(tdt), torch.from_numpy(cur))
    want = jax_ref.decode_attn_ref(jnp.asarray(q[:, 0]).astype(jdt), jnp.asarray(k).astype(jdt),
                                   jnp.asarray(v).astype(jdt), jnp.asarray(cur))
    np.testing.assert_allclose(as_np(got), as_np(want), **tol(dtype))


# ------------------------------------------------- the small hybrid's conditioning


def test_small_hybrid_is_chaotic_under_the_jax_init_and_not_with_fan_in_d():
    """Why chip_smoke.py draws the small hybrid's attention with fan-in d
    (``attention_fan_in_d``) for its card-vs-host check: rounding K6's output
    once (the kernel) instead of twice (the CPU's chunked scan) is the only
    change here, on the host. Under the JAX init rule (fan-in H and KV for
    wq and wk) the shared attention is near-hard and some seed's prefill
    logits move by more than 10 % of max |logit|; with fan-in d no seed's
    move by more than 2 %."""
    smoke = _smoke()
    cfg = smoke.small_config(get_arch(ARCH))
    model = build_model(cfg)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 37)).astype(np.int32))

    def rounded_once(x, bm, cm, dt, a_log, d_skip, chunk, init_state=None):
        y, state = ref.ssd_ref(x, bm, cm, dt, a_log, d_skip)  # y and the final state, as K6 returns them
        return y.to(x.dtype), state

    moved = {False: [], True: []}
    for fan_in_d in (False, True):
        for seed in range(6):
            params = model.init(seed, device=CPU)
            if fan_in_d:
                smoke.attention_fan_in_d(params, cfg)
            with torch.no_grad():
                twice, _ = model.prefill_fn(params, {"tokens": toks})
                chunked, ssm.ssd_chunked = ssm.ssd_chunked, rounded_once
                try:
                    once, _ = model.prefill_fn(params, {"tokens": toks})
                finally:
                    ssm.ssd_chunked = chunked
            moved[fan_in_d].append(smoke.rel_err(once, twice))
    assert max(moved[False]) > 0.1, moved
    assert max(moved[True]) < 2e-2, moved


# ------------------------------------------------- chip_smoke rehearsal


def test_chip_smoke_hybrid_phases_rehearsal_on_cpu(monkeypatch):
    """chip_smoke.py's hybrid phases at a tiny size on the CPU: 3 -> 1
    instances with identical tokens, and the expected launch counts —
    K6 once per Mamba layer and K3 once per shared-block application of
    each prefill, K4 once per application of each decode step, canary
    replays counted — match what the model ran (the scans counted here, the
    attention kernels' plain versions standing in for K3 and K4)."""
    smoke = _smoke()
    counter = _CountChunked(ssm.ssd_chunked)
    monkeypatch.setattr(ssm, "ssd_chunked", counter)
    cfg = reduced_config(get_arch(ARCH))
    params = build_model(cfg).init(0, device=CPU)
    out = smoke.serve_phase(torch, CPU, cfg, prompt_lens=(5, 9, 12), new_tokens=4, max_len=24,
                            params=params)
    assert out["live_instances"] == {"unfused": 3, "fused": 1}
    assert out["tokens_identical"]
    exp = out["expected_launches"]
    # the check against the model without the platform prefills once more
    assert counter.calls == exp["ssd_scan"] + cfg.num_layers and exp["ssd_scan"] % cfg.num_layers == 0
    assert exp["flash_attention"] == out["plain_calls"]["mha_ref"] == 2 * exp["ssd_scan"] // cfg.num_layers
    assert exp["decode_attention"] == out["plain_calls"]["decode_attn_ref"] > 0

    block = smoke.ssm_block_phase(torch, CPU, cfg, params, smoke.small_config(cfg), prompt_len=9)
    assert block["card_vs_host_rel_err"] == {"ssm_block_0": 0.0, "shared_block": 0.0}  # both on the host
    assert [b[0] for b in smoke.model_blocks(cfg, params)] == [
        "ssm_0", "ssm_1", "shared_0", "ssm_2", "ssm_3", "shared_1", "ssm_4"]
    assert list(block["prefill_decode_rel_err"]) == [b[0] for b in smoke.model_blocks(cfg, params)]
    assert block["small"]["rel_err"] == [0.0, 0.0] and block["small"]["layers"] == 5
