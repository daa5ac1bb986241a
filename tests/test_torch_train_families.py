"""Training the MoE, SSM and hybrid families in the port against the JAX
package: the plain backward versions of K5 and K6 (``kernels/ref.py:
gmm_ref_bwd``, ``ssd_ref_bwd``) against ``jax.vjp`` of the reference's plain
kernels, the wrappers' autograd on the CPU, the models' ``loss_fn`` with its
metrics and every gradient leaf against ``jax.value_and_grad`` of the JAX
``loss_fn`` (reduced qwen3-moe-30b-a3b, mamba2-370m and zamba2-7b, with and
without remat), one train step from a bridged state against the JAX step,
the SSM pass's in-place serve path against its out-of-place autograd path,
and a rehearsal of chip_smoke.py's training phases for the three families.

The same inputs, made with numpy from a seed, go to both packages; fp32
tolerances are the repo's (``tests/test_kernels.py``): 2e-5 of the loss
(relative) and of each leaf's max. MoE routing is discontinuous: both
packages route the same fp32 logits, and the inputs are drawn so that no
top-k choice is a tie."""
import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # the suite runs several workers at once: leave them cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.optim import cosine_schedule as jax_cosine  # noqa: E402
from repro.training.train_step import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.bridge import params_from_numpy, train_state_from_numpy  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.kernels import moe_gmm as tgmm  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import AdamWConfig, cosine_schedule  # noqa: E402
from repro_torch.training.train_step import make_train_step, value_and_grad  # noqa: E402

FP32_TOL = 2e-5
CPU = torch.device("cpu")
FAMILIES = ("qwen3-moe-30b-a3b", "mamba2-370m", "zamba2-7b")


def within(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    scale = float(np.abs(want).max()) if want.size else 0.0
    assert err <= tol * scale + 1e-30, f"{what}: max |diff| {err} > {tol} x max |want| {scale}"


def f32(tree_):
    return jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.float32)), tree_)


# ------------------------------------------------------------------ K5's gradient, the plain version


@pytest.mark.parametrize("e,c,d,f,rows", [
    (4, 16, 8, 24, (0, 16, 5, 9)),  # an empty expert, a full one, two in between
    (6, 24, 32, 16, (3, 0, 24, 1, 0, 17)),
    (3, 8, 16, 8, None),  # every row kept
])
def test_gmm_ref_bwd_matches_jax_vjp(e, c, d, f, rows):
    """dxe and dw of the plain backward against jax.vjp of the reference's
    gmm_ref on xe masked to the kept rows (the layer's scatter leaves them
    zero): dxe is zero past rows[e], dw of an empty expert is zero."""
    rng = np.random.default_rng(e * 100 + c)
    xe = rng.standard_normal((e, c, d)).astype(np.float32)
    w = rng.standard_normal((e, d, f)).astype(np.float32)
    dy = rng.standard_normal((e, c, f)).astype(np.float32)
    keep = np.ones((e, c, 1), np.float32) if rows is None else \
        (np.arange(c)[None, :] < np.asarray(rows)[:, None]).astype(np.float32)[..., None]
    _, vjp = jax.vjp(lambda a, b: jax_ref.gmm_ref(a * keep, b), jnp.asarray(xe), jnp.asarray(w))
    want = vjp(jnp.asarray(dy))
    trows = None if rows is None else torch.tensor(rows, dtype=torch.int32)
    got = ref.gmm_ref_bwd(torch.from_numpy(xe), torch.from_numpy(w), trows, torch.from_numpy(dy))
    for name, g, wnt in zip(("dxe", "dw"), got, want):
        assert g.dtype == torch.float32
        within(g.numpy(), np.asarray(wnt), FP32_TOL, name)
    if rows is not None:
        assert bool((got[0].numpy()[np.broadcast_to(keep == 0, got[0].shape)] == 0).all())
        for i, r in enumerate(rows):
            if r == 0:
                assert not got[1][i].any()


def test_moe_gmm_under_grad_on_the_cpu_runs_the_plain_backward():
    """The wrapper's autograd on CPU tensors: one call of gmm_ref_bwd per
    backward, its gradients those of autograd through gmm_ref."""
    g = torch.Generator().manual_seed(0)
    rows = torch.tensor([0, 16, 5, 9], dtype=torch.int32)
    keep = (torch.arange(16)[None, :] < rows[:, None])[..., None]
    xe = torch.randn(4, 16, 8, generator=g) * keep
    w = torch.randn(4, 8, 24, generator=g)
    dy = torch.randn(4, 16, 24, generator=g)
    a = [xe.clone().requires_grad_(), w.clone().requires_grad_()]
    before = ref.CALLS["gmm_ref_bwd"]
    got = torch.autograd.grad(tgmm.moe_gmm(*a, rows, 4), a, dy)
    assert ref.CALLS["gmm_ref_bwd"] == before + 1
    b = [xe.clone().requires_grad_(), w.clone().requires_grad_()]
    want = torch.autograd.grad(tgmm.plain(*b, rows), b, dy)
    for x, y in zip(got, want):
        within(x.numpy(), y.numpy(), 1e-6)


# ------------------------------------------------------------------ K6's gradient, the plain version


def ssd_inputs(b, t, h, g, p, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, h, p)).astype(np.float32),
            (rng.standard_normal((b, t, g, n)) * 0.5).astype(np.float32),
            (rng.standard_normal((b, t, g, n)) * 0.5).astype(np.float32),
            (np.log1p(np.exp(rng.standard_normal((b, t, h)))) * 0.5).astype(np.float32),
            (rng.standard_normal(h) * 0.3).astype(np.float32),
            rng.standard_normal(h).astype(np.float32))


@pytest.mark.parametrize("b,t,h,g,p,n,with_state", [
    (2, 37, 4, 2, 8, 16, False),
    (2, 37, 4, 2, 8, 16, True),
    (1, 70, 4, 1, 16, 8, True),  # T not a multiple of 64
    (1, 64, 6, 3, 8, 8, False),
])
def test_ssd_ref_bwd_matches_jax_vjp(b, t, h, g, p, n, with_state):
    """Every cotangent of the plain backward (dx, dB, dC summed over each
    group's heads, ddt, dA_log, dD) against jax.vjp of the reference's
    ssd_ref, with and without a final-state cotangent."""
    ins = ssd_inputs(b, t, h, g, p, n, seed=t + h)
    rng = np.random.default_rng(1)
    dy = rng.standard_normal((b, t, h, p)).astype(np.float32)
    ds = rng.standard_normal((b, h, p, n)).astype(np.float32) if with_state else np.zeros((b, h, p, n), np.float32)
    _, vjp = jax.vjp(jax_ref.ssd_ref, *map(jnp.asarray, ins))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    got = ref.ssd_ref_bwd(*map(torch.from_numpy, ins), torch.from_numpy(dy),
                          torch.from_numpy(ds) if with_state else None)
    for name, x, y in zip(("dx", "dbm", "dcm", "ddt", "da_log", "dd_skip"), got, want):
        assert tuple(x.shape) == tuple(y.shape), name
        within(x.numpy(), np.asarray(y), FP32_TOL, name)


def test_ssd_scan_under_grad_on_the_cpu_runs_the_plain_backward():
    """The wrapper's autograd on CPU tensors, the final state's cotangent
    taken: one call of ssd_ref_bwd, the gradients autograd's through
    ssd_ref; y alone (no state cotangent) too."""
    ins = [torch.from_numpy(a) for a in ssd_inputs(1, 40, 4, 2, 8, 16, seed=3)]
    g = torch.Generator().manual_seed(1)
    dy, ds = torch.randn(1, 40, 4, 8, generator=g), torch.randn(1, 4, 8, 16, generator=g)
    for with_state in (True, False):
        a = [x.clone().requires_grad_() for x in ins]
        before = ref.CALLS["ssd_ref_bwd"]
        y, state = tssd.ssd_scan(*a, return_state=True)
        obj = (y * dy).sum() + ((state * ds).sum() if with_state else 0)
        got = torch.autograd.grad(obj, a)
        assert ref.CALLS["ssd_ref_bwd"] == before + 1
        b = [x.clone().requires_grad_() for x in ins]
        yb, sb = ref.ssd_ref(*b)
        want = torch.autograd.grad((yb * dy).sum() + ((sb * ds).sum() if with_state else 0), b)
        for x, w in zip(got, want):
            within(x.numpy(), w.numpy(), 1e-5)


# ------------------------------------------------------------------ loss and gradients


def fan_in_d(jparams, cfg):
    """Every attention block's wq and wk as if drawn with fan-in d_model
    (tests/test_torch_train.py: fan_in_d): the reduced models' attention is
    near-hard under the JAX init rule, where fp32 rounding in another order
    moves the gradients through the softmax by ~1e-4 of their max."""
    def scale(attn):
        attn = dict(attn)
        attn["wq"] = attn["wq"] * math.sqrt(cfg.num_heads / cfg.d_model)
        attn["wk"] = attn["wk"] * math.sqrt(cfg.num_kv_heads / cfg.d_model)
        return attn

    out = dict(jparams)
    if "blocks" in out and "attn" in out["blocks"]:
        out["blocks"] = {**out["blocks"], "attn": scale(out["blocks"]["attn"])}
    if "hybrid" in out:
        out["hybrid"] = {**out["hybrid"], "shared": {**out["hybrid"]["shared"],
                                                     "attn": scale(out["hybrid"]["shared"]["attn"])}}
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
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def router_margin(tparams, tcfg, batch) -> float:
    """The smallest gap between a token's k-th and (k+1)-th router
    probability over every MoE layer's input: the routing is the same in
    both packages when the fp32 gap is far above the rounding."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import apply_norm, embed_tokens

    k = tcfg.num_experts_per_tok
    gap = float("inf")
    with torch.no_grad():
        x = embed_tokens(tparams["embed"], batch["tokens"])
        pos = torch.arange(x.shape[1])[None]
        for i in range(tcfg.num_layers):
            lp = tree.map(lambda a: a[i], tparams["blocks"])
            h = x + tfm.attn_mod.attn_output(lp["attn"], tfm.attn_mod.full_attention(
                *tfm.attn_mod.qkv_project(lp["attn"], apply_norm(lp["ln1"], x, tcfg), tcfg, pos), causal=True))
            probs = moe_mod.route(lp["moe"], apply_norm(lp["ln2"], h, tcfg), tcfg)[0]
            top = torch.topk(probs, k + 1, dim=-1).values
            gap = min(gap, float((top[..., k - 1] - top[..., k]).min()))
            x, _, _ = tfm.apply_block_full(lp, x, tcfg, "moe", pos)
    return gap


@pytest.mark.parametrize("remat", [False, True])
# the hybrid at T = 32 (two chunks): at 48 the reference's gradients of its
# tail's conv_B and in_C differ from themselves by 6-7e-5 of their max between
# two of its own execution orders (eager, and jit with remat): the reduced
# hybrid's fp32 conditioning there, not a difference of the packages; at 32
# they agree with themselves within 5e-6
@pytest.mark.parametrize("arch,t", [("qwen3-moe-30b-a3b", 64), ("mamba2-370m", 48), ("zamba2-7b", 32)])
def test_loss_and_gradients_match_jax(arch, t, remat):
    """loss_fn, its metrics (ce, loss, moe_aux, moe_dropped) and every
    gradient leaf against jax.value_and_grad of the JAX loss_fn on the
    params carried across, in fp32: the loss and metrics within 2e-5
    relative, each leaf within 2e-5 of its max. The SSM model runs three
    chunks of 16 rows, the hybrid two; the hybrid applies its shared block
    twice, and its gradient adds up over both; the MoE model drops tokens at
    its capacity."""
    jcfg, tcfg, jmodel, tmodel, jparams = jax_and_port(arch, remat)
    batch = make_batch(tcfg, 2, t)
    (jl, jmet), jg = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = params_from_numpy(f32(jparams), tmodel.param_defs, dtype=torch.float32, device=CPU)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if tcfg.family == "moe":
        assert router_margin(tparams, tcfg, tbatch) > 1e-4
    tl, tmet, tg = value_and_grad(tmodel, tparams, tbatch)
    assert sorted(tmet) == sorted(jmet) == ["ce", "loss", "moe_aux", "moe_dropped"]
    assert abs(float(tl) - float(jl)) <= FP32_TOL * abs(float(jl))
    assert float(tmet["loss"]) == float(tl)
    for key in ("ce", "moe_aux", "moe_dropped"):
        assert abs(float(tmet[key]) - float(jmet[key])) <= FP32_TOL * abs(float(jmet[key])) + 1e-30, key
    if tcfg.family == "moe":
        assert float(tmet["moe_aux"]) > 0 and float(tmet["moe_dropped"]) > 0
        assert float(tl) == pytest.approx(float(tmet["ce"]) + tcfg.router_aux_weight * float(tmet["moe_aux"]),
                                          rel=1e-6)
    else:
        assert float(tmet["moe_aux"]) == 0.0
    leaves = tree.leaves(tg)
    jleaves = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(leaves) == len(jleaves)
    for (path, w), g in zip(jleaves, leaves):
        within(g.numpy(), np.asarray(w), FP32_TOL, jax.tree_util.keystr(path))
        assert np.abs(np.asarray(w)).max() > 0 or "router" in jax.tree_util.keystr(path), \
            jax.tree_util.keystr(path)


def test_hybrid_shared_block_gradient_sums_its_applications():
    """The shared block's gradient is the sum of its two applications'
    (reduced zamba2-7b: 2 groups): autograd through one pass equals the
    sum of the passes that let only one application see the parameters."""
    from repro_torch.models import hybrid as hy

    tcfg = reduced_config(get_arch("zamba2-7b"))
    model = build_model(tcfg)
    params = model.init(0, device=CPU)
    params = tree.map(lambda a: a.float(), params)
    x = torch.randn(1, 24, tcfg.d_model, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(24)[None]
    shared = params["hybrid"]["shared"]
    leaves, struct = tree.flatten(shared)

    def grads(live_at):
        calls = {"n": 0}
        live = [p.detach().requires_grad_() for p in leaves]
        frozen = tree.unflatten(struct, [p.detach() for p in leaves])
        real = hy.tfm.apply_block_full

        def block(p, *a, **k):
            if p is shared_marker:
                use = tree.unflatten(struct, live) if calls["n"] in live_at else frozen
                calls["n"] += 1
                return real(use, *a, **k)
            return real(p, *a, **k)

        hy.tfm.apply_block_full = block
        try:
            y, _ = hy.apply_hybrid_full({**params["hybrid"], "shared": shared_marker}, x, tcfg, pos)
        finally:
            hy.tfm.apply_block_full = real
        assert calls["n"] == 2
        return torch.autograd.grad(y.square().sum(), live)

    shared_marker = {"marker": torch.zeros(())}
    both = grads({0, 1})
    first, second = grads({0}), grads({1})
    for g, a, b in zip(both, first, second):
        within(g.numpy(), (a + b).numpy(), 1e-5)
        assert a.abs().max() > 0 and b.abs().max() > 0


def test_ssm_pass_without_grad_keeps_the_in_place_bits():
    """The SSM block's full-sequence pass without autograd (the serve
    paths: fp32 intermediates updated in place) and with it (out of place)
    give equal bits, in bf16 and fp32."""
    for dtype in (torch.float32, torch.bfloat16):
        cfg = reduced_config(get_arch("mamba2-370m"))
        model = build_model(cfg)
        params = tree.map(lambda a: a.to(dtype) if a.dtype != torch.float32 or dtype == torch.float32 else a,
                          model.init(0, device=CPU))
        lp = tree.map(lambda a: a[0], params["blocks"]["ssm"])
        u = (torch.randn(2, 40, cfg.d_model, generator=torch.Generator().manual_seed(2)) * 0.5).to(dtype)
        with torch.no_grad():
            served = ssm_mod.apply_ssm(lp, u, cfg)
        live = tree.map(lambda a: a.detach().requires_grad_(), lp)
        trained = ssm_mod.apply_ssm(live, u, cfg)
        assert trained.requires_grad and torch.equal(served, trained.detach())


# ------------------------------------------------------------------ one train step


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mamba2-370m"])
def test_train_step_from_a_bridged_state_matches_jax(arch):
    """The JAX step 1 from its init, its state carried across by
    train_state_from_numpy, then step 2 in both packages (fp32 params,
    nonzero moments, 2 microbatches): the step's metrics within 2e-5
    relative, new params and moments within 2e-5 of each leaf's max."""
    jcfg, tcfg, jmodel, tmodel, jparams = jax_and_port(arch, microbatches=2)
    jstep = jax_make_train_step(jmodel, JaxAdamWConfig(lr=1e-2), jax_cosine(1e-2, 2, 20))
    tstep = make_train_step(tmodel, AdamWConfig(lr=1e-2), cosine_schedule(1e-2, 2, 20))
    batches = [make_batch(tcfg, 4, 32, seed=s) for s in (1, 2)]
    jstate, _ = jax.jit(jstep)({"params": jparams, "opt": jax_adamw_init(jparams)},
                               {k: jnp.asarray(v) for k, v in batches[0].items()})
    carried = {"params": f32(jstate["params"]),
               "opt": {"step": np.asarray(jstate["opt"]["step"]), "m": f32(jstate["opt"]["m"]),
                       "v": f32(jstate["opt"]["v"])}}
    tstate = train_state_from_numpy(carried, tmodel.param_defs, dtype=torch.float32, device=CPU)
    jnew, jmet = jax.jit(jstep)(jstate, {k: jnp.asarray(v) for k, v in batches[1].items()})
    tnew, tmet = tstep(tstate, {k: torch.from_numpy(v) for k, v in batches[1].items()})
    assert sorted(tmet) == sorted(jmet)
    for key in ("loss", "ce", "moe_aux", "moe_dropped", "grad_norm", "lr"):
        assert abs(float(tmet[key]) - float(jmet[key])) <= FP32_TOL * abs(float(jmet[key])) + 1e-30, key
    for part in (("params",), ("opt", "m"), ("opt", "v")):
        jt, tt = jnew, tnew
        for k in part:
            jt, tt = jt[k], tt[k]
        for a, b in zip(jax.tree.leaves(jt), tree.leaves(tt)):
            within(b.numpy(), np.asarray(a), FP32_TOL, "/".join(part))


# ------------------------------------------------------------------ chip_smoke.py's family training phases


def _smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_family_training_phases_rehearsal_on_cpu(monkeypatch, capsys):
    """chip_smoke.py's MoE, SSM and hybrid training phases at a tiny size on
    the CPU (the reduced configs in place of the full-width ones), with the
    card run's control flow and checks: each family's train loop (the loss
    falls, the plain versions stand in for K5 and its gradient, remat's
    recompute counted), the small model's step and the full-width blocks
    card vs host (both sides on the host here: equal; the MoE host pass
    replaying the first pass's routing), the bit-exact restart of a small
    MoE and SSM model, and the
    launcher on mamba2-370m in a process of its own."""
    smoke = _smoke()
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the launcher's process: leave the other workers cores
    monkeypatch.setattr(smoke, "family_config",
                        lambda arch, layers: dataclasses.replace(reduced_config(get_arch(arch)), remat=True))
    monkeypatch.setattr(smoke, "TRAIN_SEQ", 64)
    monkeypatch.setattr(smoke, "FAMILY_TRAIN_STEPS", 6)
    # the tiny models learn the affine stream in 6 steps at 1e-2
    monkeypatch.setattr(smoke, "FAMILY_TRAIN", tuple((*f[:3], 1e-2) for f in smoke.FAMILY_TRAIN))
    monkeypatch.setattr(smoke, "TRAIN_BLOCK_T", 40)
    monkeypatch.setattr(smoke, "RESTART_STEPS", 6)
    monkeypatch.setattr(smoke, "RESTART_FAILS", (3,))
    monkeypatch.setattr(smoke, "LAUNCH_TRAIN_SSM", ("--arch", "mamba2-370m", "--reduced", "--steps", "3", "--batch",
                                                    "2", "--seq", "32", "--ckpt-every", "0", "--device", "cpu"))
    out = smoke.family_training_phases(torch, CPU)
    lines = {k: v for line in capsys.readouterr().out.splitlines() if line.startswith("{")
             for k, v in json.loads(line).items()}
    assert set(lines) == {"moe_train", "moe_train_card_vs_host", "moe_train_restart", "ssm_train",
                          "ssm_train_card_vs_host", "ssm_train_restart", "hybrid_train", "hybrid_train_card_vs_host",
                          "launch_train_ssm"}
    micro = 6 * smoke.FAMILY_TRAIN_MICRO
    moe_cfg = reduced_config(get_arch("qwen3-moe-30b-a3b"))
    assert lines["moe_train"]["expected_launches"] == {
        "moe_gmm": 2 * 3 * moe_cfg.num_layers * micro, "moe_gmm_bwd_dx": 3 * moe_cfg.num_layers * micro,
        "moe_gmm_bwd_dw": 3 * moe_cfg.num_layers * micro, "flash_attention": 2 * moe_cfg.num_layers * micro,
        **{k: moe_cfg.num_layers * micro for k in smoke.GRAD_KERNELS}}
    assert lines["moe_train"]["plain_calls"]["gmm_ref"] == lines["moe_train"]["expected_launches"]["moe_gmm"]
    hyb = reduced_config(get_arch("zamba2-7b"))
    assert lines["hybrid_train"]["expected_launches"]["flash_attention"] == 2 * 2 * micro  # 2 applications, remat
    assert lines["hybrid_train"]["expected_launches"]["ssd_scan_bwd_walk"] == hyb.num_layers * micro
    for key in ("moe", "ssm", "hybrid"):
        train = lines[f"{key}_train"]
        assert train["last3_mean_loss"] < train["first3_mean_loss"] and len(train["losses"]) == 6
        assert all(math.isfinite(v) for v in train["moe_aux"] + train["grad_norms"])
        small = lines[f"{key}_train_card_vs_host"]["small"]
        assert small["loss"]["card"] == small["loss"]["host"] and max(small["grad_rel_err"].values()) == 0.0
        assert lines[f"{key}_train_card_vs_host"]["blocks"]["worst"] == 0.0
    assert min(lines["moe_train"]["moe_aux"]) > 0
    moe_blocks = lines["moe_train_card_vs_host"]["blocks"]
    assert moe_blocks["routing_replayed"] and moe_blocks["tokens_routed_otherwise_on_the_host"] == {
        "block_0": [0], "block_1": [0]}  # the host replays its own routing here
    assert lines["moe_train_card_vs_host"]["small"]["tokens_routed_otherwise_on_the_host"] == [0] * 4
    assert set(lines["hybrid_train_card_vs_host"]["blocks"]["rel_err"]) == {"ssm_0", "ssm_4", "shared_0"}
    assert all(lines[f"{k}_train_restart"]["restarts"] == 1 for k in ("moe", "ssm"))
    assert lines["launch_train_ssm"]["device"] == "cpu" and lines["launch_train_ssm"]["arch"] == "mamba2-370m"
    assert out["launches"]["moe"] == {k: 0 for k in lines["moe_train"]["expected_launches"]}  # no kernel on the host
    assert not torch.are_deterministic_algorithms_enabled()


@pytest.mark.parametrize("kernel", ["moe_gmm", "ssd_scan"])
def test_wrapper_gradient_under_checkpoint_on_the_cpu(kernel):
    """Each wrapper's autograd under torch.utils.checkpoint (remat) unpacks
    its saved tensors once, and gives the gradients of the plain pass."""
    from torch.utils.checkpoint import checkpoint

    g = torch.Generator().manual_seed(4)
    if kernel == "moe_gmm":
        ins = [torch.randn(3, 8, 16, generator=g), torch.randn(3, 16, 8, generator=g)]
        rows = torch.tensor([8, 0, 5], dtype=torch.int32)

        def fn(*a):
            return tgmm.moe_gmm(*a, rows).square().sum()
    else:
        ins = [torch.from_numpy(a) for a in ssd_inputs(1, 20, 2, 1, 8, 8, seed=4)]

        def fn(*a):
            y, state = tssd.ssd_scan(*a, return_state=True)
            return y.square().sum() + state.sum()
    a = [x.clone().requires_grad_() for x in ins]
    got = torch.autograd.grad(checkpoint(fn, *a, use_reentrant=False), a)
    b = [x.clone().requires_grad_() for x in ins]
    want = torch.autograd.grad(fn(*b), b)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
