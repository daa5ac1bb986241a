"""The port's training path (``repro_torch.{optim,data,training}``, the
models' ``loss_fn``, ``launch/train.py``) against the JAX package.

The same inputs, made with numpy from a seed, go through both packages: the
schedule, one AdamW update, the synthetic batches (bit for bit), K3's
gradient on the CPU (autograd through the plain version against
``jax.grad`` through ``repro.kernels.ops.attention``), the loss and every
gradient leaf of the reduced llama3.2-1b and chameleon-34b (``embeds``), and
one train step from a state carried by ``bridge.train_state_from_numpy``.
Then the reference's ``tests/test_train_loop.py`` cases on the port, and the
launcher in a process of its own. Tolerances are the repo's
(``tests/test_kernels.py``): fp32 2e-5, bf16 2e-2."""
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # the suite runs several workers at once: leave them cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShape  # noqa: E402
from repro.data import SyntheticTokenPipeline as JaxPipeline  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw_update as jax_adamw_update  # noqa: E402
from repro.optim import cosine_schedule as jax_cosine  # noqa: E402
from repro.training.train_step import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.bridge import params_from_numpy, train_state_from_numpy  # noqa: E402
from repro_torch.checkpointing import CheckpointManager  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import SyntheticTokenPipeline, make_batch_specs  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule, global_norm  # noqa: E402
from repro_torch.training import FailureInjector, TrainLoop  # noqa: E402
from repro_torch.training.train_step import init_train_state, make_train_step, value_and_grad  # noqa: E402

FP32_TOL = 2e-5
CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
SHAPE = ShapeConfig("t", 32, 4, "train")  # tests/test_train_loop.py's
JSHAPE = JaxShape("t", 32, 4, "train")


def f32(tree_):
    return jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.float32)), tree_)


def within(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    scale = float(np.abs(want).max()) if want.size else 0.0
    assert err <= tol * scale + 1e-30, f"{what}: max |diff| {err} > {tol} x max |want| {scale}"


# ------------------------------------------------------------------ optim


def test_cosine_schedule_matches_jax():
    jsched, tsched = jax_cosine(1e-2, 5, 30), cosine_schedule(1e-2, 5, 30)
    for step in range(31):
        want = float(jsched(jnp.int32(step)))
        assert abs(tsched(step) - want) <= 1e-7
        got = tsched(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - want) <= 1e-7


def random_tree(rng, dtype):
    shapes = {"a": (16, 24), "b": {"c": (24,), "d": (3, 8, 5)}, "e": ()}
    return jax.tree.map(lambda s: np.array(rng.standard_normal(s), dtype=np.float32), shapes,
                        is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype):
    """One clipped update at step 4 from random moments: fp32 params,
    moments and grad_norm within 1e-6 relative; bf16 params within one bf16
    ulp (the fp32 update rounds once either way)."""
    rng = np.random.default_rng(3)
    p, g, m = random_tree(rng, dtype), random_tree(rng, dtype), random_tree(rng, dtype)
    v = jax.tree.map(lambda x: np.abs(x) * 0.1, random_tree(rng, dtype))
    g = jax.tree.map(lambda x: x * 10.0, g)  # a global norm far above clip_norm = 1
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = jax.tree.map(lambda x: jnp.asarray(x).astype(jdt), p)
    jg = jax.tree.map(lambda x: jnp.asarray(x).astype(jdt), g)
    jstate = {"step": jnp.int32(3), "m": jax.tree.map(jnp.asarray, m), "v": jax.tree.map(jnp.asarray, v)}
    sched = (jax_cosine(1e-2, 2, 10), cosine_schedule(1e-2, 2, 10))
    jnew, jopt, jmet = jax_adamw_update(jp, jg, jstate, JaxAdamWConfig(), sched[0])

    tdt = getattr(torch, dtype)
    as_t = lambda x: torch.from_numpy(np.array(jnp.asarray(x, jnp.float32), dtype=np.float32))  # noqa: E731
    tp = tree.map(lambda x: as_t(x).to(tdt), jp)
    tg = tree.map(lambda x: as_t(x).to(tdt), jg)
    tstate = {"step": torch.tensor(3, dtype=torch.int32), "m": tree.map(as_t, m), "v": tree.map(as_t, v)}
    before = tree.map(torch.clone, tp)
    tnew, topt, tmet = adamw_update(tp, tg, tstate, AdamWConfig(), sched[1])
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(before), tree.leaves(tp)))  # functional
    assert int(topt["step"]) == 4 and topt["step"].dtype == torch.int32
    assert float(tmet["grad_norm"]) > 10.0
    assert abs(float(tmet["grad_norm"]) - float(jmet["grad_norm"])) <= 1e-6 * float(jmet["grad_norm"])
    assert abs(float(tmet["lr"]) - float(jmet["lr"])) <= 1e-7
    for name in ("m", "v"):
        for a, b in zip(jax.tree.leaves(jopt[name]), tree.leaves(topt[name])):
            within(b.numpy(), np.asarray(a), 1e-6, name)
    for a, b in zip(jax.tree.leaves(jnew), tree.leaves(tnew)):
        assert b.dtype == tdt
        if dtype == "float32":
            within(b.numpy(), np.asarray(a), 1e-6, "params")
        else:  # bf16 bit patterns as integers: adjacent values differ by one
            ja = np.asarray(a).view(np.int16).astype(np.int32)
            tb = b.view(torch.int16).numpy().astype(np.int32)
            assert int(np.abs(ja - tb).max(initial=0)) <= 1


def test_global_norm_and_init():
    rng = np.random.default_rng(5)
    t = tree.map(torch.from_numpy, random_tree(rng, "float32"))
    want = math.sqrt(sum(float((x.double() ** 2).sum()) for x in tree.leaves(t)))
    assert abs(float(global_norm(t)) - want) <= 1e-6 * want
    state = adamw_init(t)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    assert all(x.dtype == torch.float32 and not x.any() for x in tree.leaves(state["m"]) + tree.leaves(state["v"]))


# ------------------------------------------------------------------ data


def pipelines(arch, mode, seed, start, shape=SHAPE, jshape=JSHAPE):
    jp = JaxPipeline(jax_reduced(jax_get_arch(arch)), jshape, seed=seed, mode=mode, start_batch=start)
    tp = SyntheticTokenPipeline(reduced_config(get_arch(arch)), shape, seed=seed, mode=mode, start_batch=start,
                                device=CPU)
    return jp, tp


@pytest.mark.parametrize("arch,mode,start", [("llama3.2-1b", "affine", 0), ("llama3.2-1b", "random", 0),
                                             ("llama3.2-1b", "affine", 3), ("chameleon-34b", "affine", 2)])
def test_pipeline_batches_equal_jax_bit_for_bit(arch, mode, start):
    jp, tp = pipelines(arch, mode, seed=7, start=start)
    try:
        for _ in range(3):
            jb, tb = next(jp), next(tp)
            assert sorted(jb) == sorted(tb) == sorted(make_batch_specs(tp.cfg, SHAPE))
            for name in jb:
                a, b = np.asarray(jb[name]), tb[name].numpy()
                assert a.dtype == b.dtype and a.shape == b.shape
                assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), name
    finally:
        jp.close()
        tp.close()
    assert not tp._thread.is_alive()


def test_pipeline_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SyntheticTokenPipeline(reduced_config(get_arch("llama3.2-1b")), SHAPE)


# ------------------------------------------------------------------ K3's gradient on the CPU


@pytest.mark.parametrize("b,t,s,h,kv,causal", [
    (1, 37, 37, 4, 4, True),   # group 1
    (2, 19, 19, 8, 2, True),   # group 4, odd T
    (1, 33, 33, 8, 1, True),   # group 8
    (1, 37, 37, 8, 2, False),
    (2, 21, 45, 8, 1, False),  # T != S
])
def test_flash_attention_gradient_matches_jax(b, t, s, h, kv, causal):
    """flash_attention on CPU tensors that require grad (autograd through
    the plain version) against jax.grad through the JAX package's
    ops.attention, in fp32 at 2e-5 of each gradient's max; the plain
    backward mha_ref_bwd equals autograd through mha_ref exactly."""
    rng = np.random.default_rng(11)
    qn, kn, vn, dn = (rng.standard_normal(sh).astype(np.float32)
                      for sh in ((b, t, h, 16), (b, s, kv, 16), (b, s, kv, 16), (b, t, h, 16)))

    def jloss(q, k, v):
        return jnp.sum(jax_ops.attention(q, k, v, causal=causal) * dn)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (qn, kn, vn)))
    x = [torch.from_numpy(a).requires_grad_() for a in (qn, kn, vn)]
    before = ref.CALLS["mha_ref"]
    out = tflash.flash_attention(*x, causal=causal)
    assert out.grad_fn is not None and ref.CALLS["mha_ref"] == before + 1
    do = torch.from_numpy(dn)
    got = torch.autograd.grad(out, x, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        within(g.numpy(), np.asarray(w), FP32_TOL, name)
    n = ref.CALLS["mha_ref_bwd"]
    plain = tflash.plain_bwd(*(a.detach() for a in x), do, causal=causal)
    assert ref.CALLS["mha_ref_bwd"] == n + 1
    for g, p in zip(got, plain):
        assert torch.equal(g, p)


def test_flash_attention_without_grad_keeps_the_serve_path():
    q = torch.randn(1, 5, 2, 16, requires_grad=True)
    with torch.no_grad():
        out = tflash.flash_attention(q, q[:, :, :1].contiguous(), q[:, :, :1].contiguous())
    assert out.grad_fn is None


# ------------------------------------------------------------------ loss and gradients


def fan_in_d(jparams, cfg):
    """wq and wk as if drawn with fan-in d_model, not the JAX init rule's H
    and KV: under that rule a random model's attention is near-hard (scores
    of std ~100), and fp32 rounding in another summation order moves its
    gradients by ~1e-4 of their max (chip_smoke.py: attention_fan_in_d)."""
    attn = dict(jparams["blocks"]["attn"])
    attn["wq"] = attn["wq"] * math.sqrt(cfg.num_heads / cfg.d_model)
    attn["wk"] = attn["wk"] * math.sqrt(cfg.num_kv_heads / cfg.d_model)
    out = dict(jparams)
    out["blocks"] = dict(jparams["blocks"])
    out["blocks"]["attn"] = attn
    return out


def jax_and_port(arch, remat=False, microbatches=1):
    jcfg = dataclasses.replace(jax_reduced(jax_get_arch(arch)), remat=remat, microbatches=microbatches)
    tcfg = dataclasses.replace(reduced_config(get_arch(arch)), remat=remat, microbatches=microbatches)
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    jparams = fan_in_d(jax.tree.map(lambda x: x.astype(jnp.float32), jmodel.init(jax.random.PRNGKey(0))), jcfg)
    return jcfg, tcfg, jmodel, tmodel, jparams


def make_batch(cfg, b, t, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, t + 1)).astype(np.int32)
    if cfg.family == "vlm":
        return {"embeds": (rng.standard_normal((b, t, cfg.d_model)) * 0.02).astype(np.float32),
                "targets": toks[:, 1:]}
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def port_value_and_grad(tmodel, tparams, batch):
    loss, metrics, grads = value_and_grad(tmodel, tparams, batch)
    return loss, metrics, tree.leaves(grads)


@pytest.mark.parametrize("arch,t,remat", [("llama3.2-1b", 1024, False), ("llama3.2-1b", 1024, True),
                                          ("chameleon-34b", 24, True)])
def test_loss_and_gradients_match_jax(arch, t, remat):
    """loss_fn and every gradient leaf against jax.value_and_grad of the JAX
    loss_fn on the params carried across, in fp32: the loss within 2e-5
    relative, each leaf within 2e-5 of its max. T = 1024 runs two CE chunks
    of 512 (recomputed under remat, as each block is)."""
    jcfg, tcfg, jmodel, tmodel, jparams = jax_and_port(arch, remat)
    batch = make_batch(tcfg, 2, t)
    (jl, jmet), jg = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = params_from_numpy(f32(jparams), tmodel.param_defs, dtype=torch.float32, device=CPU)
    tl, tmet, tg = port_value_and_grad(tmodel, tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(tmet) == sorted(jmet)
    assert abs(float(tl) - float(jl)) <= FP32_TOL * abs(float(jl))
    assert float(tmet["loss"]) == float(tl) and float(tmet["moe_aux"]) == 0.0
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(jg)[0], tg):
        within(g.numpy(), np.asarray(w), FP32_TOL, jax.tree_util.keystr(path))


def test_remat_runs_each_block_and_ce_chunk_under_checkpoint(monkeypatch):
    """With cfg.remat under autograd, each block and each CE chunk runs
    under torch.utils.checkpoint; without grad, neither does."""
    from repro_torch.models import model as model_mod
    from repro_torch.models import transformer as tfm

    calls = []

    def counting(fn, *args, **kw):
        calls.append(fn.__name__)
        return real(fn, *args, **kw)

    real = tfm.checkpoint
    monkeypatch.setattr(tfm, "checkpoint", counting)
    monkeypatch.setattr(model_mod, "checkpoint", counting)
    cfg = dataclasses.replace(reduced_config(get_arch("llama3.2-1b")), remat=True)
    model = build_model(cfg)
    params = model.init(0, device=CPU)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, 1, 1024).items()}
    with torch.no_grad():
        model.loss_fn(params, batch)
    assert calls == []
    port_value_and_grad(model, params, batch)
    assert calls == ["apply_block_full"] * cfg.num_layers + ["_ce_chunk"] * 2


# ------------------------------------------------------------------ one train step


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_from_a_bridged_state_matches_jax(microbatches):
    """The JAX step 1 from its init, its state carried across by
    train_state_from_numpy, then step 2 in both packages (fp32 params,
    nonzero moments): new params, moments and metrics against the JAX
    step's (params and moments within 2e-5 of each leaf's max)."""
    jcfg, tcfg, jmodel, tmodel, jparams = jax_and_port("llama3.2-1b", microbatches=microbatches)
    from repro.optim import adamw_init as jax_adamw_init

    jstep = jax_make_train_step(jmodel, JaxAdamWConfig(lr=1e-2), jax_cosine(1e-2, 2, 20))
    tstep = make_train_step(tmodel, AdamWConfig(lr=1e-2), cosine_schedule(1e-2, 2, 20))
    batches = [make_batch(tcfg, 4, 32, seed=s) for s in (1, 2)]
    jstate, _ = jax.jit(jstep)({"params": jparams, "opt": jax_adamw_init(jparams)},
                               {k: jnp.asarray(v) for k, v in batches[0].items()})
    carried = {"params": f32(jstate["params"]),
               "opt": {"step": np.asarray(jstate["opt"]["step"]), "m": f32(jstate["opt"]["m"]),
                       "v": f32(jstate["opt"]["v"])}}
    tstate = train_state_from_numpy(carried, tmodel.param_defs, dtype=torch.float32, device=CPU)
    assert int(tstate["opt"]["step"]) == 1 and tstate["opt"]["step"].dtype == torch.int32
    jnew, jmet = jax.jit(jstep)(jstate, {k: jnp.asarray(v) for k, v in batches[1].items()})
    tnew, tmet = tstep(tstate, {k: torch.from_numpy(v) for k, v in batches[1].items()})
    assert int(tnew["opt"]["step"]) == 2
    for key in ("loss", "ce", "grad_norm", "lr"):
        assert abs(float(tmet[key]) - float(jmet[key])) <= FP32_TOL * abs(float(jmet[key])), key
    for part in (("params",), ("opt", "m"), ("opt", "v")):
        jt, tt = jnew, tnew
        for k in part:
            jt, tt = jt[k], tt[k]
        for a, b in zip(jax.tree.leaves(jt), tree.leaves(tt)):
            within(b.numpy(), np.asarray(a), FP32_TOL, "/".join(part))


# ------------------------------------------------------------------ the loop (tests/test_train_loop.py)


def build(cfg, lr_total=20):
    model = build_model(cfg)
    step_fn = make_train_step(model, AdamWConfig(lr=1e-2), cosine_schedule(1e-2, 2, lr_total))
    state0 = init_train_state(model, 0, device=CPU)
    make_data = lambda start: SyntheticTokenPipeline(cfg, SHAPE, seed=7, mode="affine",  # noqa: E731
                                                     start_batch=start, device=CPU)
    return model, step_fn, state0, make_data


def test_restart_is_bit_exact(tmp_path):
    cfg = reduced_config(get_arch("llama3.2-1b"))
    _, step_fn, state0, make_data = build(cfg)
    keep = tree.map(torch.clone, state0)
    loop_a = TrainLoop(step_fn, make_data, CheckpointManager(str(tmp_path / "a")), ckpt_every=4)
    state_a, hist_a = loop_a.run(state0, 12)
    loop_b = TrainLoop(step_fn, make_data, CheckpointManager(str(tmp_path / "b")), ckpt_every=4)
    injector = FailureInjector([5, 9])
    state_b, hist_b = loop_b.run(state0, 12, injector)
    assert loop_b.restarts == 2
    assert injector.fired == [5, 9]
    for a, b in zip(tree.leaves(state_a["params"]), tree.leaves(state_b["params"])):
        assert torch.equal(a, b), "post-recovery params differ from failure-free run"
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(keep), tree.leaves(state0)))  # functional steps


def test_training_learns_affine_stream(tmp_path):
    cfg = reduced_config(get_arch("llama3.2-1b"))
    _, step_fn, state0, make_data = build(cfg)
    loop = TrainLoop(step_fn, make_data, CheckpointManager(str(tmp_path / "c")), ckpt_every=0)
    _, hist = loop.run(state0, 30)
    first = sum(h["loss"] for h in hist[:5]) / 5
    last = sum(h["loss"] for h in hist[-5:]) / 5
    assert last < first * 0.8, f"no learning: {first:.2f} -> {last:.2f}"
    assert sorted(hist[0]) == ["ce", "grad_norm", "loss", "lr", "moe_aux", "moe_dropped", "seconds", "step"]


def test_straggler_detection(tmp_path):
    calls = {"n": 0}

    def slow_step(state, batch):
        calls["n"] += 1
        if calls["n"] == 8:
            time.sleep(1.5)  # the straggler; provlint: ok
        return state, {"loss": torch.tensor(1.0)}

    cfg = reduced_config(get_arch("llama3.2-1b"))
    make_data = lambda start: SyntheticTokenPipeline(cfg, SHAPE, seed=7, start_batch=start,  # noqa: E731
                                                     device=CPU)
    loop = TrainLoop(slow_step, make_data, CheckpointManager(str(tmp_path)), ckpt_every=0, straggler_factor=3.0)
    loop.run({"x": torch.zeros(())}, 12)
    assert any(ev.step == 8 for ev in loop.straggler_events)


def test_data_pipeline_deterministic_resume():
    cfg = reduced_config(get_arch("llama3.2-1b"))
    p1 = SyntheticTokenPipeline(cfg, SHAPE, seed=3, device=CPU)
    batches = [next(p1) for _ in range(5)]
    p1.close()
    p2 = SyntheticTokenPipeline(cfg, SHAPE, seed=3, start_batch=3, device=CPU)
    resumed = next(p2)
    p2.close()
    assert torch.equal(batches[3]["tokens"], resumed["tokens"])
    assert torch.equal(batches[3]["targets"], resumed["targets"])


def test_affine_stream_is_next_token_predictable():
    cfg = reduced_config(get_arch("llama3.2-1b"))
    p = SyntheticTokenPipeline(cfg, SHAPE, seed=1, mode="affine", device=CPU)
    b = next(p)
    p.close()
    expect = (31 * b["tokens"].long() + 7) % cfg.vocab_size
    assert torch.equal(expect.to(torch.int32), b["targets"])


def test_microbatched_step_matches_full_batch():
    """Gradient accumulation must be loss-equivalent to the full batch (bf16
    grads accumulate in bf16, so the updates agree loosely, as in the
    reference's test)."""
    cfg = reduced_config(get_arch("llama3.2-1b"))
    model_full = build_model(cfg)
    model_micro = build_model(dataclasses.replace(cfg, microbatches=2))
    state = init_train_state(model_full, 0, device=CPU)
    p = SyntheticTokenPipeline(cfg, SHAPE, seed=7, device=CPU)
    batch = next(p)
    p.close()
    s1, m1 = make_train_step(model_full, AdamWConfig(lr=1e-2))(state, batch)
    s2, m2 = make_train_step(model_micro, AdamWConfig(lr=1e-2))(state, batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=2e-2)
    for a, b in zip(tree.leaves(s1["params"]), tree.leaves(s2["params"])):
        assert torch.allclose(a.float(), b.float(), rtol=8e-2, atol=2e-2), float((a.float() - b.float()).abs().max())


# ------------------------------------------------------------------ the launcher


def test_launch_train_on_cpu_in_a_process(tmp_path):
    """python -m repro_torch.launch.train --reduced --device cpu --steps 20:
    exit 0, one JSON line with the reference's keys and the device, and the
    loss falls."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT / "src"), os.environ.get("PYTHONPATH")])),
               OMP_NUM_THREADS="2")  # the suite runs several workers at once: leave them cores
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--reduced", "--device", "cpu",
                           "--steps", "20", "--ckpt-dir", str(tmp_path / "ckpt")],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 1
    rec = lines[0]
    assert {"arch", "steps", "wall_s", "tokens_per_s", "final_loss", "first_loss", "stragglers"} <= set(rec)
    assert rec["device"] == "cpu" and rec["steps"] == 20
    assert math.isfinite(rec["final_loss"]) and rec["final_loss"] < rec["first_loss"]
    assert os.listdir(tmp_path / "ckpt") == []  # --ckpt-every 50: no step of 20 saves


def test_launch_train_runs_on_the_card_unless_asked(monkeypatch):
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--reduced", "--steps", "1"])


# ------------------------------------------------------------------ chip_smoke.py's training phases


def _smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_training_phases_rehearsal_on_cpu(monkeypatch, capsys):
    """chip_smoke.py's training phases at a tiny size on the CPU, with the
    card run's control flow and checks: the train loop (the loss falls, the
    plain forward stands in for every K3 launch, remat's recompute counted),
    the small model's step and the two blocks card vs host (both sides on
    the host here: equal), the bit-exact restart under deterministic
    algorithms, and the launcher in a process of its own."""
    smoke = _smoke()
    cfg = dataclasses.replace(reduced_config(get_arch("llama3.2-1b")), remat=True)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the launcher's process: leave the other workers cores
    monkeypatch.setattr(smoke, "TRAIN_SEQ", 64)
    monkeypatch.setattr(smoke, "TRAIN_STEPS", 8)
    monkeypatch.setattr(smoke, "TRAIN_BLOCK_T", 40)
    monkeypatch.setattr(smoke, "LAUNCH_TRAIN", ("--arch", "llama3.2-1b", "--reduced", "--steps", "3", "--batch", "2",
                                                "--seq", "32", "--ckpt-every", "0", "--device", "cpu"))
    out = smoke.training_phases(torch, CPU, cfg)
    lines = {k: v for line in capsys.readouterr().out.splitlines() if line.startswith("{")
             for k, v in json.loads(line).items()}
    assert set(lines) == {"train", "train_card_vs_host", "train_restart", "launch_train"}
    train = lines["train"]
    assert train["expected_launches"] == {"flash_attention": 2 * 8 * 2 * cfg.num_layers,
                                          "flash_attention_bwd_prep": 8 * 2 * cfg.num_layers,
                                          "flash_attention_bwd": 8 * 2 * cfg.num_layers,
                                          "flash_attention_bwd_post": 8 * 2 * cfg.num_layers}
    assert train["plain_calls"]["mha_ref"] == train["expected_launches"]["flash_attention"]
    assert train["last4_mean_loss"] < train["first4_mean_loss"] and len(train["losses"]) == 8
    assert train["state_bytes"]["moments"] == 4 * train["state_bytes"]["params"]  # fp32 m and v beside bf16 params
    small = lines["train_card_vs_host"]["small"]
    assert small["loss"]["card"] == small["loss"]["host"] and max(small["grad_rel_err"].values()) == 0.0
    blocks = lines["train_card_vs_host"]["blocks"]["rel_err"]
    assert set(blocks) == {"block_0", f"block_{cfg.num_layers - 1}"} and len(blocks["block_0"]) == 1 + 9
    assert lines["train_restart"]["restarts"] == 2 and lines["train_restart"]["deterministic_algorithms"]
    assert lines["launch_train"]["device"] == "cpu" and lines["launch_train"]["steps"] == 3
    assert out["launches"] == {k: 0 for k in train["expected_launches"]}  # no kernel on the host
    assert not torch.are_deterministic_algorithms_enabled()
