"""The port's SSM family: K6's plain version, the Mamba-2 block, the mamba2 chain.

On the CPU: the plain K6 (``ssd_ref``, what the wrapper runs for CPU
tensors) against the JAX Pallas kernel in interpret mode and the JAX
oracle; the port's chunked SSD scan (what the CPU runs in the model)
against the JAX package's, at a T that is a multiple of the chunk and at
one that is not; ``apply_ssm`` with its cache and ``ssm_decode_step``
against the JAX package's on the same bridged weights; the mamba2 chain
through the port's engine against the JAX engine, teacher-forced; fusion,
the paging refusal, the fp32 leaves through the bridge, the shape-only run
on meta tensors; and a rehearsal of chip_smoke.py's SSM phases. K6 itself
is held against its plain version on the card by test_torch_kernels_cuda.py.
"""
import dataclasses
import importlib.util
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
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.core import FusionPolicy, TinyTorchBackend  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

ARCH = "mamba2-370m"
CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SSD_TOL = dict(rtol=5e-4, atol=5e-4)  # tests/test_kernels.py: the SSD tolerance


def tol(name):
    """tests/test_kernels.py's tolerances."""
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def to_numpy_f32(params):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), params)


def ssd_inputs(seed, b, t, h, grp, p, n):
    """tests/test_kernels.py's recipe (test_ssd_scan_vs_ref) from a numpy seed."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, p)).astype(np.float32)
    bm = (rng.standard_normal((b, t, grp, n)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, t, grp, n)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, t, h)))).astype(np.float32)
    a_log = (rng.standard_normal(h) * 0.3).astype(np.float32)
    d_skip = np.ones(h, np.float32)
    return x, bm, cm, dt, a_log, d_skip


# ------------------------------------------------------- K6, plain vs JAX


@pytest.mark.parametrize("b,t,h,grp,p,n,chunk", [
    (2, 128, 4, 1, 32, 16, 32),   # tests/test_kernels.py:105-109
    (1, 256, 2, 2, 64, 32, 64),
    (1, 64, 2, 1, 16, 8, 64),     # single chunk
])
def test_plain_ssd_matches_jax_pallas_and_oracle(b, t, h, grp, p, n, chunk):
    arrays = ssd_inputs(1, b, t, h, grp, p, n)
    want = jax_ssd_scan(*map(jnp.asarray, arrays), chunk=chunk, interpret=True)
    want_ref, want_state = jax_ref.ssd_ref(*map(jnp.asarray, arrays))
    ref.CALLS["ssd_ref"] = 0
    got = tssd.ssd_scan(*map(torch.from_numpy, arrays))
    assert ref.CALLS["ssd_ref"] == 1 and build.launches("ssd_scan") == 0
    assert got.dtype == torch.float32 and got.shape == (b, t, h, p)
    np.testing.assert_allclose(as_np(got), as_np(want), **SSD_TOL)
    np.testing.assert_allclose(as_np(got), as_np(want_ref), **SSD_TOL)
    _, state = ref.ssd_ref(*map(torch.from_numpy, arrays))
    np.testing.assert_allclose(as_np(state), as_np(want_state), **SSD_TOL)


@pytest.mark.parametrize("b,t,h,grp,p,n", [(1, 37, 4, 2, 32, 16), (2, 100, 4, 1, 16, 8), (1, 1, 2, 1, 8, 8)])
def test_plain_ssd_matches_jax_oracle_at_ragged_t(b, t, h, grp, p, n):
    """T that no chunk divides (the Pallas kernel refuses it; K6 takes it)."""
    arrays = ssd_inputs(2, b, t, h, grp, p, n)
    want, want_state = jax_ref.ssd_ref(*map(jnp.asarray, arrays))
    got, state = ref.ssd_ref(*map(torch.from_numpy, arrays))
    np.testing.assert_allclose(as_np(got), as_np(want), **SSD_TOL)
    np.testing.assert_allclose(as_np(state), as_np(want_state), **SSD_TOL)


def test_plain_ssd_is_finite_where_the_decay_overflows():
    """Over 256 steps cum reaches about -180 at unit dt: exp(cum_i - cum_j)
    overflows above the diagonal, which must be masked before exp."""
    x, bm, cm, dt, a_log, d_skip = ssd_inputs(3, 1, 256, 2, 1, 16, 8)
    dt = np.full_like(dt, 1.0)
    a_log = np.zeros_like(a_log)  # a = -1
    y, state = ref.ssd_ref(*map(torch.from_numpy, (x, bm, cm, dt, a_log, d_skip)))
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    want, _ = jax_ref.ssd_ref(*map(jnp.asarray, (x, bm, cm, dt, a_log, d_skip)))
    np.testing.assert_allclose(as_np(y), as_np(want), **SSD_TOL)


def test_ssd_cpu_tensors_take_the_plain_version_meta_gives_shapes():
    ops.reset_counts()
    arrays = [torch.from_numpy(a) for a in ssd_inputs(4, 1, 9, 2, 1, 8, 8)]
    arrays[0] = arrays[0].to(torch.bfloat16)
    y = ops.ssd(*arrays)
    assert y.dtype == torch.bfloat16 and y.shape == (1, 9, 2, 8)
    assert ops.counts()["ssd_ref"] == 1 and ops.counts()["ssd_scan"] == 0
    meta = ops.ssd(*[a.to("meta") for a in arrays])
    assert meta.device.type == "meta" and meta.shape == (1, 9, 2, 8) and meta.dtype == torch.bfloat16
    assert ops.counts()["ssd_scan"] == 0 and ops.counts()["ssd_ref"] == 1
    ops.reset_counts()
    assert ops.counts()["ssd_ref"] == 0


@pytest.mark.parametrize("case,exc", [
    ("x_float32", TypeError),
    ("dt_bfloat16", TypeError),
    ("state_dim_32", ValueError),
    ("head_dim_48", ValueError),
    ("groups_do_not_divide_heads", ValueError),
    ("dt_shape", ValueError),
    ("device_mismatch", ValueError),
    ("not_contiguous", ValueError),
])
def test_ssd_kernel_input_checks_raise(case, exc):
    """What K6 does not take raises before any launch (the checks the
    wrapper runs for a CUDA tensor)."""
    b, t, h, g, p, n = 1, 20, 4, 2, 64, 64
    x = torch.zeros(b, t, h, p, dtype=torch.bfloat16)
    bm = torch.zeros(b, t, g, n, dtype=torch.bfloat16)
    cm = torch.zeros(b, t, g, n, dtype=torch.bfloat16)
    dt = torch.zeros(b, t, h)
    a_log, d_skip = torch.zeros(h), torch.ones(h)
    tssd._check(x, bm, cm, dt, a_log, d_skip)  # the model's shapes pass
    if case == "x_float32":
        x = x.float()
    elif case == "dt_bfloat16":
        dt = dt.to(torch.bfloat16)
    elif case == "state_dim_32":
        bm = cm = torch.zeros(b, t, g, 32, dtype=torch.bfloat16)
    elif case == "head_dim_48":
        x = torch.zeros(b, t, h, 48, dtype=torch.bfloat16)
    elif case == "groups_do_not_divide_heads":
        bm = cm = torch.zeros(b, t, 3, n, dtype=torch.bfloat16)
    elif case == "dt_shape":
        dt = torch.zeros(b, t + 1, h)
    elif case == "device_mismatch":
        bm = bm.to("meta")
    elif case == "not_contiguous":
        x = torch.zeros(b, h, t, p, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(exc):
        tssd._check(x, bm, cm, dt, a_log, d_skip)


# ------------------------------------------------- the chunked scan vs JAX


@pytest.mark.parametrize("t,chunk", [(64, 16), (48, 16), (50, 16), (16, 64)])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_jax(t, chunk, with_state):
    """The CPU path of the model: T a multiple of the chunk (several chunks)
    and not (JAX's rule: one chunk of T), from zero or a given state."""
    x, bm, cm, dt, a_log, d_skip = ssd_inputs(5, 2, t, 4, 2, 16, 8)
    init = np.random.default_rng(6).standard_normal((2, 4, 16, 8)).astype(np.float32) if with_state else None
    want_y, want_s = jax_ssm.ssd_chunked(*map(jnp.asarray, (x, bm, cm, dt, a_log, d_skip)), chunk,
                                         None if init is None else jnp.asarray(init))
    got_y, got_s = ssm.ssd_chunked(*map(torch.from_numpy, (x, bm, cm, dt, a_log, d_skip)), chunk,
                                   None if init is None else torch.from_numpy(init))
    np.testing.assert_allclose(as_np(got_y), as_np(want_y), **tol("float32"))
    np.testing.assert_allclose(as_np(got_s), as_np(want_s), **tol("float32"))
    if init is None:  # the chunked form is the oracle's function
        oy, os_ = ref.ssd_ref(*map(torch.from_numpy, (x, bm, cm, dt, a_log, d_skip)))
        np.testing.assert_allclose(as_np(got_y), as_np(oy), **SSD_TOL)
        np.testing.assert_allclose(as_np(got_s), as_np(os_), **SSD_TOL)


def test_ssd_chunked_on_meta_tensors_takes_the_kernel_route():
    """The shape-only run of a fused unit reaches K6's wrapper (no launch,
    no plain call), which gives y and the final state."""
    ops.reset_counts()
    arrays = [torch.from_numpy(a).to("meta") for a in ssd_inputs(7, 1, 300, 4, 1, 64, 128)]
    arrays[:3] = [a.to(torch.bfloat16) for a in arrays[:3]]
    y, state = ssm.ssd_chunked(*arrays, chunk=256)
    assert y.device.type == "meta" and y.shape == (1, 300, 4, 64) and y.dtype == torch.bfloat16
    assert state.shape == (1, 4, 64, 128) and state.dtype == torch.float32
    assert ops.counts()["ssd_scan"] == 0 and ops.counts()["ssd_ref"] == 0


# ------------------------------------------------- the Mamba-2 block vs JAX


def ssm_params(dtype, seed=3):
    jcfg, tcfg = jax_reduced(jax_get_arch(ARCH)), reduced_config(get_arch(ARCH))
    jp = jax_init_params(jax_ssm.ssm_defs(jcfg), jax.random.PRNGKey(seed))
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tp = params_from_numpy(to_numpy_f32(jp), ssm.ssm_defs(tcfg), dtype=DTYPES[dtype][1], device=CPU)
    return jcfg, tcfg, jp, tp


def close(got, want, dtype):
    """fp32 elementwise at 2e-5; bf16 within 2e-2 of max |want| (values reach
    the hundreds at this width: bf16 rounds them by more than 2e-2 each)."""
    if dtype == "float32":
        np.testing.assert_allclose(as_np(got), as_np(want), **tol("float32"))
    else:
        w = as_np(want)
        assert np.abs(as_np(got) - w).max() <= 2e-2 * np.abs(w).max()


@pytest.mark.parametrize("t", [16, 20])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_ssm_with_cache_and_decode_step_match_jax(t, dtype):
    jcfg, tcfg, jp, tp = ssm_params(dtype)
    jdt, tdt = DTYPES[dtype]
    un = np.random.default_rng(11).standard_normal((2, t + 1, tcfg.d_model)).astype(np.float32)
    ju, tu = jnp.asarray(un).astype(jdt), torch.from_numpy(un).to(tdt)
    jy, jcache = jax_ssm.apply_ssm(jp, ju[:, :t], jcfg, return_cache=True)
    with torch.no_grad():
        ty, tcache = ssm.apply_ssm(tp, tu[:, :t], tcfg, return_cache=True)
    assert ty.dtype == tdt and ty.shape == (2, t, tcfg.d_model)
    close(ty, jy, dtype)
    shapes = ssm.ssm_cache_shapes(tcfg, 2)
    for name in ("ssd", "conv_x", "conv_B", "conv_C"):
        assert tuple(tcache[name].shape) == shapes[name][0] and tcache[name].dtype == shapes[name][1]
        close(tcache[name], jcache[name], dtype)
    jd, jnew = jax_ssm.ssm_decode_step(jp, ju[:, t:], jcache, jcfg)
    with torch.no_grad():
        td, tnew = ssm.ssm_decode_step(tp, tu[:, t:], tcache, tcfg)
    close(td, jd, dtype)
    for name in ("ssd", "conv_x", "conv_B", "conv_C"):
        assert tnew[name].dtype == torch.promote_types(tcache[name].dtype, tdt) or name == "ssd"
        close(tnew[name], jnew[name], dtype)


def test_ssm_block_kind_through_the_stacks_and_paged_refusal():
    """'ssm' blocks through apply_stack_full / apply_stack_decode: the stacked
    cache is the state dict with a leading layers axis, the decode step keeps
    each cache's dtype, and the paged steps refuse an SSM block."""
    cfg = reduced_config(get_arch(ARCH))
    params = build_model(cfg).init(0, device=CPU)["blocks"]
    x = torch.randn(1, 7, cfg.d_model, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    pos = torch.arange(7)[None]
    with torch.no_grad():
        h, cache, _ = tfm.apply_stack_full(params, x, cfg, "ssm", pos, collect_cache=True)
        assert set(cache) == {"ssd", "conv_x", "conv_B", "conv_C"}
        assert cache["ssd"].shape == (cfg.num_layers, 1, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state)
        h2, new = tfm.apply_stack_decode(params, h[:, -1:], cache, cfg, "ssm", torch.tensor([7], dtype=torch.int32))
    assert all(new[k].dtype == cache[k].dtype and new[k].shape == cache[k].shape for k in cache)
    layer = tree.map(lambda a: a[0], params)
    with pytest.raises(ValueError, match="attention caches only"):
        tfm.apply_block_decode_paged(layer, x[:, :1], None, None, None, cfg, "ssm", torch.tensor([0]))
    with pytest.raises(ValueError, match="attention caches only"):
        tfm.apply_block_prefill_chunk_paged(layer, x, None, None, None, cfg, "ssm", torch.tensor([0]),
                                            torch.tensor([7]))


def test_prefill_then_decode_matches_a_longer_prefill():
    """tests/test_models.py's serving check for the SSM family, in the port:
    the recurrent decode step continues the chunked prefill's state. The
    model is fp32, but the conv history is cached in bf16
    (``ssm_cache_shapes``, as in the JAX package), so the step sees its last
    K - 1 inputs rounded: within 1e-2 of max |logit| (tests/test_models.py
    allows rtol 0.2, atol 0.5)."""
    cfg = dataclasses.replace(reduced_config(get_arch(ARCH)), kv_cache_dtype="float32")
    model = build_model(cfg)
    params = tree.map(lambda x: x.float(), model.init(0, device=CPU))
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 17)).astype(np.int32))
    with torch.no_grad():
        _, cache = model.prefill_fn(params, {"tokens": toks[:, :16]})
        step, _ = model.decode_fn(params, {"tokens": toks[:, 16:], "cur_len": torch.full((2,), 16, dtype=torch.int32)},
                                  cache)
        full, _ = model.prefill_fn(params, {"tokens": toks})
    assert np.abs(step.numpy() - full.numpy()).max() <= 1e-2 * np.abs(full.numpy()).max()


# ------------------------------------------------- the mamba2 chain vs the JAX engine


# The JAX chain's teacher-forced logits, in a process of its own with XLA's
# excess precision off (see tests/test_torch_serving.py): bf16 rounds where
# the code says in both packages. bf16 keeps the JAX init's dtypes (A_log, D
# and dt_bias in fp32); fp32 casts every leaf.
JAX_CHAIN = """
import dataclasses, os, pickle, sys
os.nice(10)  # yield the CPU to the suite's timing-sensitive tests running beside it
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_arch, reduced_config
from repro.core import FusionPolicy, TinyJaxBackend
from repro.models.model import build_model
from repro.serving.engine import ServingEngine

arch, max_len, t_in, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
seq = np.load(out + ".tokens.npy")
result = {}
for dtype in ("float32", "bfloat16"):
    cfg = dataclasses.replace(reduced_config(get_arch(arch)), kv_cache_dtype=dtype)
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
SEQ = np.random.default_rng(9).integers(0, 256, (1, 20)).astype(np.int32)
T_IN = 16  # the reduced chunk (16): the prefill scans one full chunk
MAX_LEN = 32


def jax_chain(arch, tmp_path_factory):
    """{dtype: {"params", "logits"}} from the JAX engine serving ``arch``
    (reduced) on SEQ, teacher-forced."""
    out = tmp_path_factory.mktemp("jax_chain") / "logits.pkl"
    np.save(f"{out}.tokens.npy", SEQ)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false").strip())
    proc = subprocess.run([sys.executable, "-c", JAX_CHAIN, arch, str(MAX_LEN), str(T_IN), str(out)],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def teacher_forced(arch, ref_, dtype, n_functions):
    """The port's chain on the JAX weights (bridged with their dtypes) and
    SEQ, teacher-forced, on a fusing platform; returns the logits and checks
    that the chain fused from ``n_functions`` instances into one unit."""
    tdt = getattr(torch, dtype)
    cfg = dataclasses.replace(reduced_config(get_arch(arch)), kv_cache_dtype=dtype)
    model = build_model(cfg)
    params = params_from_numpy(ref_["params"], model.param_defs, dtype=tdt, device=CPU)
    platform = TinyTorchBackend(FusionPolicy(min_observations=2, merge_cost_s=0.0))
    try:
        engine = ServingEngine(model, platform, max_len=MAX_LEN, params=params, device=CPU)
        assert len(platform.registry.live_instances()) == len(engine.chain_names()) == n_functions
        logits, caches, cur = engine.prefill({"tokens": torch.from_numpy(SEQ[:, :T_IN])})
        got = [logits.numpy()]
        for i in range(T_IN, SEQ.shape[1]):
            logits, caches = engine.decode_step(torch.from_numpy(SEQ[:, i : i + 1]), cur, caches)
            cur = cur + 1
            got.append(logits.numpy())
        (unit,) = platform.registry.live_instances()
        assert set(unit.members) == set(engine.chain_names())
        assert not unit._eager_entries  # the fused chain runs as one unit (K6 reached on meta)
    finally:
        platform.shutdown()
    return params, got


def check_logits(got, want, dtype):
    """fp32: the prefill's logits within 2e-5; a decode step's within 1e-3 of
    max |logit|, because both packages cache the conv history in bf16
    (``ssm_cache_shapes``) even in an fp32 model, and an input one fp32 ulp
    apart (the two matmuls sum in other orders) can round to the other side
    of a bf16 step there (seen: 3.9e-5 of max |logit| at the first decode
    step). bf16: within 2e-2 of max |logit|."""
    assert len(got) == len(want) == SEQ.shape[1] - T_IN + 1
    for i, (t, j) in enumerate(zip(got, want)):
        assert np.isfinite(t).all()
        if dtype == "float32" and i == 0:
            np.testing.assert_allclose(t, j, **tol("float32"))
        else:
            assert np.abs(t - j).max() <= (1e-3 if dtype == "float32" else 2e-2) * np.abs(j).max()


@pytest.fixture(scope="module")
def jax_mamba2(tmp_path_factory):
    return jax_chain(ARCH, tmp_path_factory)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_teacher_forced_logits_match_jax_engine(jax_mamba2, dtype):
    """The same weights and tokens through both mamba2 chains (tolerances in
    :func:`check_logits`); the port's chain fuses from its 4
    functions (2 groups at the reduced depth) into one unit meanwhile. The
    fp32 SSM leaves keep their dtype through the bridge."""
    params, got = teacher_forced(ARCH, jax_mamba2[dtype], dtype, 4)
    for name in ("A_log", "D", "dt_bias"):
        assert params["blocks"]["ssm"][name].dtype == torch.float32
    assert params["blocks"]["ssm"]["in_x"].dtype == getattr(torch, dtype)
    check_logits(got, jax_mamba2[dtype]["logits"], dtype)


def test_bridge_keeps_the_fp32_ssm_leaves():
    defs = build_model(reduced_config(get_arch(ARCH))).param_defs
    src = tree.map(lambda d: np.random.default_rng(0).standard_normal(d.shape).astype(np.float32), defs)
    got = params_from_numpy(src, defs, device=CPU)
    for name in ("A_log", "D", "dt_bias"):
        assert got["blocks"]["ssm"][name].dtype == torch.float32
        np.testing.assert_array_equal(got["blocks"]["ssm"][name].numpy(), src["blocks"]["ssm"][name])
    assert got["blocks"]["ssm"]["in_B"].dtype == torch.bfloat16
    assert got["blocks"]["ln1"]["scale"].dtype == torch.bfloat16


# ------------------------------------------------- serving inside the port


def test_full_mamba2_chain_is_six_functions_and_fuses_to_one():
    """Full mamba2-370m deploys embed -> g0..g3 -> head (weights on the meta
    device: nothing is allocated); the reduced chain fuses to one instance
    with the unfused chain's tokens and those of the model without the
    platform."""
    cfg = get_arch(ARCH)
    model = build_model(cfg)
    meta = tree.map(lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"), model.param_defs)
    platform = TinyTorchBackend(FusionPolicy(enabled=False))
    try:
        engine = ServingEngine(model, platform, params=meta, device="meta")
        assert len(engine.chain_names()) == 6 and len(platform.registry.live_instances()) == 6
    finally:
        platform.shutdown()

    cfg = reduced_config(cfg)
    model = build_model(cfg)
    params = model.init(0, device=CPU)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 19)).astype(np.int32))
    out = {}
    for label, policy in (("unfused", FusionPolicy(enabled=False)),
                          ("fused", FusionPolicy(min_observations=2, merge_cost_s=0.0))):
        platform = TinyTorchBackend(policy)
        try:
            engine = ServingEngine(model, platform, max_len=MAX_LEN, params=params, device=CPU)
            out[label] = [engine.generate({"tokens": toks}, steps=6)[0] for _ in range(2)]
            platform.merger.wait_idle()
            out[label + "_live"] = len(platform.registry.live_instances())
        finally:
            platform.shutdown()
    assert out["unfused_live"] == 4 and out["fused_live"] == 1
    assert all(torch.equal(a, b) for a, b in zip(out["unfused"], out["fused"]))
    with torch.no_grad():
        logits, cache = model.prefill_fn(params, {"tokens": toks})
        expect = [torch.argmax(logits, -1)[:, None].to(torch.int32)]
        cur = torch.full((1,), 19, dtype=torch.int32)
        for _ in range(5):
            logits, cache = model.decode_fn(params, {"tokens": expect[-1], "cur_len": cur}, cache)
            cur = cur + 1
            expect.append(torch.argmax(logits, -1)[:, None].to(torch.int32))
    assert torch.equal(out["fused"][0], torch.cat(expect, dim=1))


@pytest.mark.parametrize("how", ["enable_paging", "kv_pages"])
def test_enable_paging_raises_for_the_ssm_family(how):
    """tests/test_serving.py:93-103 in the port: an SSM state is recurrent,
    not length-indexed, so it has no pages."""
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


# ------------------------------------------------- chip_smoke rehearsal


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


class _CountChunked:
    """Counts the model's SSD scans on real tensors (on the CPU they run the
    chunked form where the card launches K6; the shape-only runs of a fused
    unit, on meta tensors, launch nothing and are not counted)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, x, *args, **kwargs):
        self.calls += x.device.type != "meta"
        return self.fn(x, *args, **kwargs)


def test_chip_smoke_ssm_phases_rehearsal_on_cpu(monkeypatch):
    """chip_smoke.py's SSM phases at a tiny size on the CPU: the same control
    flow and checks the card run makes; the expected launch counts of K6
    (one per SSM layer of each prefill, canary replays counted, none in a
    decode step) match the scans the model ran."""
    smoke = _smoke()
    counter = _CountChunked(ssm.ssd_chunked)
    monkeypatch.setattr(ssm, "ssd_chunked", counter)
    cfg = reduced_config(get_arch(ARCH))
    params = build_model(cfg).init(0, device=CPU)
    out = smoke.serve_phase(torch, CPU, cfg, prompt_lens=(5, 9, 12), new_tokens=4, max_len=24,
                            params=params)
    assert out["live_instances"] == {"unfused": 4, "fused": 1}
    assert out["tokens_identical"]
    assert out["ram_bytes"]["fused"] < out["ram_bytes"]["unfused"]
    exp = out["expected_launches"]
    # the check against the model without the platform prefills once more
    assert counter.calls == exp["ssd_scan"] + cfg.num_layers
    assert exp["ssd_scan"] >= 6 * cfg.num_layers and exp["ssd_scan"] % (cfg.num_layers // 2) == 0
    assert exp["flash_attention"] == exp["decode_attention"] == exp["moe_gmm"] == 0
    assert out["plain_calls"]["mha_ref"] == out["plain_calls"]["decode_attn_ref"] == 0

    block = smoke.ssm_block_phase(torch, CPU, cfg, params, smoke.small_config(cfg), prompt_len=9)
    assert block["card_vs_host_rel_err"] == {"ssm_block_0": 0.0}  # both sides on the host here
    assert set(block["prefill_decode_rel_err"]) == {f"ssm_{i}" for i in range(cfg.num_layers)}
    assert block["small"]["rel_err"] == [0.0, 0.0] and block["small"]["d_model"] == 256
    assert [b[0] for b in smoke.model_blocks(cfg, params)] == ["ssm_0", "ssm_1"]
