"""The port's serving chain: chain == model, fusion to one instance, and
teacher-forced logits against the JAX ServingEngine on the same weights."""
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

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.core import FusionPolicy, TinyTorchBackend  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

ARCH = "llama3.2-1b"
CPU = torch.device("cpu")
MAX_LEN = 32
ROOT = Path(__file__).resolve().parents[1]


def tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def pad_cache(cache, max_len):
    t = cache["k"].shape[2]
    return {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, max_len - t)) for k, v in cache.items()}


def test_chain_matches_direct_model_bit_for_bit():
    cfg = reduced_config(get_arch(ARCH))
    model = build_model(cfg)
    params = model.init(0, device=CPU)
    platform = TinyTorchBackend(FusionPolicy(min_observations=2, merge_cost_s=0.0))
    try:
        engine = ServingEngine(model, platform, max_len=MAX_LEN, params=params, device=CPU)
        toks = torch.from_numpy(tokens(3, (2, 12), cfg.vocab_size))
        got, lat = engine.generate({"tokens": toks}, steps=8)
        assert len(lat) == 7
        # the model without the platform, step by step
        with torch.no_grad():
            logits, cache = model.prefill_fn(params, {"tokens": toks})
            chain_logits, _, _ = engine.prefill({"tokens": toks})
            assert torch.equal(chain_logits, logits)
            cache = pad_cache(cache, MAX_LEN)
            cur = torch.full((2,), 12, dtype=torch.int32)
            expect = [torch.argmax(logits, -1)[:, None].to(torch.int32)]
            for _ in range(7):
                logits, cache = model.decode_fn(params, {"tokens": expect[-1], "cur_len": cur}, cache)
                cur = cur + 1
                expect.append(torch.argmax(logits, -1)[:, None].to(torch.int32))
        assert torch.equal(got, torch.cat(expect, dim=1))
        assert any(m.healthy for m in platform.merger.merge_log)  # fusion happened mid-generation
    finally:
        platform.shutdown()


def test_chain_fuses_to_single_instance():
    cfg = reduced_config(get_arch(ARCH))
    model = build_model(cfg)
    platform = TinyTorchBackend(FusionPolicy(min_observations=2, merge_cost_s=0.0))
    try:
        engine = ServingEngine(model, platform, max_len=MAX_LEN, device=CPU)
        assert len(platform.registry.live_instances()) == len(engine.chain_names()) == 4
        ram_unfused = platform.ram_bytes()
        engine.generate({"tokens": torch.ones(1, 8, dtype=torch.int32)}, steps=6)
        live = platform.registry.live_instances()
        assert len(live) == 1, f"chain should fully fuse, got {live}"
        assert set(live[0].members) == set(engine.chain_names())
        assert platform.ram_bytes() < ram_unfused
        assert all(e.healthy for e in platform.merger.merge_log)
    finally:
        platform.shutdown()


# The JAX chain's teacher-forced logits, computed in a process of its own:
# XLA's CPU backend keeps excess precision inside its fusions by default, so
# in bfloat16 it rounds less often than eager torch and the two drift apart
# by up to ~2.3% of max |logit| over a few steps. With that excess precision
# off, both round where the code says, and the chains agree to 0.0.
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
    cfg = dataclasses.replace(reduced_config(get_arch("llama3.2-1b")), kv_cache_dtype=dtype)
    model = build_model(cfg)
    params = jax.tree.map(lambda x: x.astype(getattr(jnp, dtype)), model.init(jax.random.PRNGKey(0)))
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
SEQ = tokens(9, (1, 14), 256)
T_IN = 10


@pytest.fixture(scope="module")
def jax_chain_logits(tmp_path_factory):
    """{dtype: {"params", "logits"}} from the JAX chain on SEQ."""
    out = tmp_path_factory.mktemp("jax_chain") / "logits.pkl"
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
    """The same weights (JAX's, bridged) and the same tokens through both
    chains: fp32 within 1e-4, bf16 within 2e-2 of max |logit|."""
    seq, t_in = SEQ, T_IN
    ref = jax_chain_logits[dtype]
    tdt = getattr(torch, dtype)
    tcfg = dataclasses.replace(reduced_config(get_arch(ARCH)), kv_cache_dtype=dtype)
    tmodel = build_model(tcfg)
    tparams = params_from_numpy(ref["params"], tmodel.param_defs, dtype=tdt, device=CPU)
    tplat = TinyTorchBackend(FusionPolicy(min_observations=2, merge_cost_s=0.0))
    try:
        teng = ServingEngine(tmodel, tplat, max_len=MAX_LEN, params=tparams, device=CPU)
        tl, tc, tcur = teng.prefill({"tokens": torch.from_numpy(seq[:, :t_in])})
        got = [tl.numpy()]
        for i in range(t_in, seq.shape[1]):
            tl, tc = teng.decode_step(torch.from_numpy(seq[:, i : i + 1]), tcur, tc)
            tcur = tcur + 1
            got.append(tl.numpy())
        assert len(tplat.registry.live_instances()) == 1  # the port's chain fused meanwhile
    finally:
        tplat.shutdown()
    assert len(got) == len(ref["logits"]) == 5
    for t, j in zip(got, ref["logits"]):
        assert np.isfinite(t).all()
        if dtype == "float32":
            np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)
        else:
            assert np.abs(t - j).max() <= 2e-2 * np.abs(j).max()


def test_chip_smoke_serve_phase_rehearsal_on_cpu():
    """chip_smoke.py's serve phase at a tiny size on the CPU: the same
    control flow and checks the card run makes, minus the kernel counts."""
    path = ROOT / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = reduced_config(get_arch(ARCH))
    out = smoke.serve_phase(torch, CPU, cfg, prompt_lens=(5, 9, 12), new_tokens=4, max_len=24)
    assert out["live_instances"] == {"unfused": 4, "fused": 1}
    assert out["tokens_identical"]
    assert out["ram_bytes"]["fused"] < out["ram_bytes"]["unfused"]
    assert out["plain_calls"]["mha_ref"] > 0 and out["launches"]["flash_attention"] == 0
    ref = smoke.reference_phase(torch, CPU, cfg, prompt_len=9)  # both sides on the host here
    assert ref["small"]["rel_err"] == [0.0, 0.0]
    assert ref["full_width_blocks_rel_err"] == [0.0] * cfg.num_layers


@pytest.mark.parametrize("arch", [ARCH, "zamba2-7b"])
def test_serving_leaves_no_tensor_in_a_reference_cycle(arch):
    """Every step's caches are freed by reference counting, not only when
    the cyclic collector runs: a tensor held in a cycle (a recursive
    closure over a leaves list did this in every ``tree.flatten``) lingers
    for an unknown time, and a collection that frees it during an entry's
    first run on the card inflates the workspace measured there."""
    import gc

    cfg = reduced_config(get_arch(arch))
    for policy in (FusionPolicy(enabled=False),
                   FusionPolicy(min_observations=2, merge_cost_s=0.0, promote_wait_s=float("inf"))):
        platform = TinyTorchBackend(policy)
        try:
            engine = ServingEngine(build_model(cfg), platform, max_len=MAX_LEN, device=CPU)
            toks = torch.from_numpy(np.arange(1, 10, dtype=np.int32)[None, :])
            engine.generate({"tokens": toks}, steps=4)  # merges, first runs
            gc.collect()
            gc.set_debug(gc.DEBUG_SAVEALL)
            try:
                engine.generate({"tokens": toks}, steps=4)
                gc.collect()
                held = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
            finally:
                gc.set_debug(0)
                gc.garbage.clear()
            assert held == []
        finally:
            platform.shutdown()
