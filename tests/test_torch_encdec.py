"""The port's enc-dec family (seamless-m4t-medium) against the JAX package.

The reduced configuration (2 encoder and 2 decoder layers, d 64, 4/2 heads
of 16). The JAX model's parameters are carried across with
``bridge.params_from_numpy``; inputs are made with numpy from a seed. The
JAX side runs as the JAX package's own tests run it on the CPU (its
attention's plain path). Tolerances are those of ``tests/test_kernels.py``:
float32 2e-5, bfloat16 2e-2, each over the reference's max |value|. Every
attention's wq and wk are drawn at fan-in d_model (``fan_in_d``): under
the JAX init rule a random model's attention is near-hard, and rounding
alone then moves the reduced model's decoder output by up to 1.6e-3 in
float32 and 75 % in bfloat16 between any two correct implementations.

Covered: ``encode`` (non-causal K3), ``cross_kv_from_enc``,
``decoder_step`` (the BOS at cur_len 0, then decode steps: K4 on the self
cache and on the cross K/V at the source length), ``decode_train``, the
model's ``prefill_fn`` / ``decode_fn`` / ``loss_fn`` and its gradient
through a train step, and the served two-function app (encoder ->
decoder): it fuses 2 -> 1 and gives the unfused chain's, the model's and
the JAX engine's tokens; the decoder is entered at the fused unit's second
member on both port backends (captured, replayed, and coalesced by
``decode_step_async``); and a park of the chain. Source lengths 37 and 300
are multiples of no kernel block."""
import dataclasses
import math
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # the suite runs several workers at once: leave them cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.core import FusionPolicy as JaxFusionPolicy  # noqa: E402
from repro.core import TinyJaxBackend  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.optim import cosine_schedule as jax_cosine  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro.training.train_step import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.bridge import params_from_numpy, train_state_from_numpy  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.core import FusionPolicy, OrchestratedBackend, TinyTorchBackend  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models import encdec as ed  # noqa: E402
from repro_torch.models.model import ENCDEC_TGT_CACHE, build_model  # noqa: E402
from repro_torch.models.params import param_bytes  # noqa: E402
from repro_torch.optim import AdamWConfig, cosine_schedule  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.training.train_step import make_train_step, value_and_grad  # noqa: E402
from test_torch_capture import captured  # noqa: E402,F401  (the recording stand-in for a CUDA graph)

ARCH = "seamless-m4t-medium"
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
CPU = torch.device("cpu")
MAX_LEN = 32
STEPS = 6
JOIN_S = 30.0


def configs(**kw):
    return (dataclasses.replace(jax_reduced(jax_get_arch(ARCH)), **kw),
            dataclasses.replace(reduced_config(get_arch(ARCH)), **kw))


def f32(t):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), t)


def fan_in_d(jparams, cfg):
    """Every attention's wq and wk as if drawn with fan-in d_model, not the
    JAX init rule's H and KV: under that rule a random model's attention is
    near-hard, and fp32 rounding in another order moves its gradients by
    ~1e-4 of their max (chip_smoke.py: attention_fan_in_d)."""
    sq, sk = math.sqrt(cfg.num_heads / cfg.d_model), math.sqrt(cfg.num_kv_heads / cfg.d_model)
    out = jax.tree.map(lambda x: x, jparams)
    for stack, part in (("encoder", "attn"), ("decoder", "attn"), ("decoder", "cross")):
        w = dict(out["encdec"][stack][part])
        w["wq"], w["wk"] = w["wq"] * sq, w["wk"] * sk
        out["encdec"][stack] = {**out["encdec"][stack], part: w}
    return out


def both_params(dtype, *, scaled=True, **kw):
    """(JAX config, port config, JAX model, port model, JAX params in
    ``dtype``, the port's bridged copy)."""
    jcfg, tcfg = configs(**kw)
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32), jmodel.init(jax.random.PRNGKey(0)))
    if scaled:
        jparams = fan_in_d(jparams, jcfg)
    jparams = jax.tree.map(lambda x: x.astype(getattr(jnp, dtype)), jparams)
    tparams = params_from_numpy(f32(jparams), tmodel.param_defs, dtype=getattr(torch, dtype), device=CPU)
    return jcfg, tcfg, jmodel, tmodel, jparams, tparams


def frames(seed, b, s, d):
    """Stub frontend frames: 0.02 x N(0, 1), bf16-representable float32."""
    x = (np.random.default_rng(seed).standard_normal((b, s, d)) * 0.02).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def tokens_np(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def close(got, want, tol) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = float(np.abs(got - want).max() / np.abs(want).max())
    assert err <= tol, err
    return err


def as_np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.astype(jnp.float32))


# ------------------------------------------------------------------ configs and params


def test_config_and_param_tree_match_the_reference():
    """The full configuration (12 + 12 layers, d 1024, 16/16 heads of 64,
    vocab 256,206) and its reduced one are the JAX package's; the parameter
    tree holds the stacked ``encdec.encoder`` / ``encdec.decoder`` leaves
    (``cross.*`` and ``ln_cross`` included) in the JAX layout, shapes and
    init rules, leaf for leaf; ``param_bytes`` counts 1.754 GB in bf16."""
    full = get_arch(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(jax_get_arch(ARCH))
    assert (full.num_layers, full.num_decoder_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.head_dim, full.d_ff, full.vocab_size) == (12, 12, 1024, 16, 16, 64, 4096, 256206)
    assert param_bytes(build_model(full).param_defs) == 1_754_312_704
    jcfg, tcfg = configs()
    jleaves = jax.tree_util.tree_flatten_with_path(jax_build_model(jcfg).param_defs,
                                                   is_leaf=lambda x: hasattr(x, "logical"))[0]
    tleaves, _ = tree.flatten(build_model(tcfg).param_defs)
    jrows = [(d.shape, d.init, d.scale_axis, jnp.dtype(d.dtype).name) for _, d in jleaves]
    trows = [(d.shape, d.init, d.scale_axis, str(d.dtype).removeprefix("torch.")) for d in tleaves]
    assert jrows == trows
    paths = {tuple(str(getattr(k, "key", k)) for k in p) for p, _ in jleaves}
    assert ("encdec", "decoder", "cross", "wk") in paths and ("encdec", "decoder", "ln_cross", "scale") in paths


def test_bridge_carries_the_stacked_encdec_trees():
    """``params_from_numpy`` and ``train_state_from_numpy`` carry every leaf
    of the enc-dec tree (encoder, decoder, ``cross.*``, ``ln_cross``)
    exactly, in the def's dtype."""
    _, _, jmodel, tmodel, jparams, tparams = both_params("float32", scaled=False)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jparams)[0], tree.leaves(tparams)):
        assert np.array_equal(np.asarray(a), b.numpy()), jax.tree_util.keystr(path)
    carried = {"params": f32(jparams), "opt": {"step": np.asarray(3), "m": f32(jparams), "v": f32(jparams)}}
    state = train_state_from_numpy(carried, tmodel.param_defs, device=CPU)
    assert state["params"]["encdec"]["decoder"]["cross"]["wo"].dtype == torch.bfloat16
    assert torch.equal(state["opt"]["m"]["encdec"]["decoder"]["ln_cross"]["scale"],
                       torch.from_numpy(np.array(jparams["encdec"]["decoder"]["ln_cross"]["scale"])))
    assert int(state["opt"]["step"]) == 3


# ------------------------------------------------------------------ modules


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("src_len", [37, 300])
def test_encoder_cross_kv_and_decoder_steps_match_jax(dtype, src_len):
    """``encode`` over the frames (K3 non-causal), ``cross_kv_from_enc`` (at
    the source length, in the encoder's dtype), then ``decoder_step``: the
    BOS at cur_len 0 and three teacher-forced steps (K4 over the self cache
    and over the source rows, all valid)."""
    jcfg, tcfg, _, _, jparams, tparams = both_params(dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    src = frames(1, 2, src_len, tcfg.d_model)
    jenc = jax.jit(lambda p, s: jed.encode(p, s, jcfg, None)[0])(jparams["encdec"], jnp.asarray(src, jdt))
    jcross = jax.jit(jed.cross_kv_from_enc)(jparams["encdec"], jenc)
    with torch.no_grad():
        tenc = ed.encode(tparams["encdec"], torch.from_numpy(src).to(tdt), tcfg)
        tcross = ed.cross_kv_from_enc(tparams["encdec"], tenc)
    close(as_np(tenc), as_np(jenc), TOL[dtype])
    assert tenc.dtype == tdt and tcross["k"].dtype == tdt
    assert tuple(tcross["k"].shape) == (tcfg.num_decoder_layers, 2, src_len, tcfg.num_kv_heads, tcfg.head_dim)
    for kv in ("k", "v"):
        close(as_np(tcross[kv]), as_np(jcross[kv]), TOL[dtype])

    shape = (tcfg.num_decoder_layers, 2, MAX_LEN, tcfg.num_kv_heads, tcfg.head_dim)
    jself = {kv: jnp.zeros(shape, jdt) for kv in ("k", "v")}
    tself = {kv: torch.zeros(shape, dtype=tdt) for kv in ("k", "v")}
    src_lens = np.full((2,), src_len, np.int32)
    assert (src_lens >= 1).all()  # K4 at length 0 differs by design (ROADMAP Numerics); never here
    seq = tokens_np(2, (2, 4), tcfg.vocab_size)
    seq[:, 0] = 0  # the BOS
    jstep = jax.jit(lambda p, x, s, c, cur, sl: jed.decoder_step(p, x, s, c, jcfg, None, cur, sl)[:2])
    for i in range(seq.shape[1]):
        cur = np.full((2,), i, np.int32)
        tok = seq[:, i : i + 1]
        jx = jparams["embed"]["table"][jnp.asarray(tok)]
        jh, jself = jstep(jparams["encdec"], jx, jself, jcross, jnp.asarray(cur), jnp.asarray(src_lens))
        with torch.no_grad():
            tx = tparams["embed"]["table"][torch.from_numpy(tok).long()]
            th, tself = ed.decoder_step(tparams["encdec"], tx, tself, tcross, tcfg, torch.from_numpy(cur),
                                        torch.from_numpy(src_lens))
        close(as_np(th), as_np(jh), TOL[dtype])
        for kv in ("k", "v"):
            close(as_np(tself[kv][:, :, : i + 1]), as_np(jself[kv][:, :, : i + 1]), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_teacher_forced_decoder_matches_jax(dtype):
    """``decode_train`` over a 24-token target against 37 source frames:
    causal self-attention and non-causal cross-attention over the whole
    target (K3 both), in both packages."""
    jcfg, tcfg, _, _, jparams, tparams = both_params(dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    src = frames(3, 2, 37, tcfg.d_model)
    tgt = tokens_np(4, (2, 24), tcfg.vocab_size)
    jenc = jax.jit(lambda p, s: jed.encode(p, s, jcfg, None)[0])(jparams["encdec"], jnp.asarray(src, jdt))
    jh = jax.jit(lambda p, e, x: jed.decode_train(p, x, e, jcfg, None)[0])(
        jparams["encdec"], jenc, jparams["embed"]["table"][jnp.asarray(tgt)])
    with torch.no_grad():
        tenc = ed.encode(tparams["encdec"], torch.from_numpy(src).to(tdt), tcfg)
        th = ed.decode_train(tparams["encdec"], tparams["embed"]["table"][torch.from_numpy(tgt).long()], tenc, tcfg)
    close(as_np(th), as_np(jh), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_prefill_and_decode_match_jax(dtype):
    """``prefill_fn`` (encode, cross K/V, the BOS into a 4096-row bf16 self
    cache, as the reference's) and two ``decode_fn`` steps, in both
    packages; the cross K/V stays at the source length."""
    _, tcfg, jmodel, tmodel, jparams, tparams = both_params(dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    src = frames(5, 2, 37, tcfg.d_model)
    bos = np.zeros((2, 1), np.int32)
    jl, jcache = jax.jit(jmodel.prefill_fn)(jparams, {"src_embeds": jnp.asarray(src, jdt), "tokens": jnp.asarray(bos)})
    with torch.no_grad():
        tl, tcache = tmodel.prefill_fn(tparams, {"src_embeds": torch.from_numpy(src).to(tdt),
                                                 "tokens": torch.from_numpy(bos)})
    close(tl.numpy() if dtype == "float32" else tl.float().numpy(), as_np(jl), TOL[dtype])
    assert tcache["self"]["k"].shape[2] == ENCDEC_TGT_CACHE and tcache["self"]["k"].dtype == torch.bfloat16
    assert tcache["cross"]["k"].shape[2] == 37 and tcache["cross"]["k"].dtype == tdt
    for i in range(1, 3):
        tok = tokens_np(10 + i, (2, 1), tcfg.vocab_size)
        cur = np.full((2,), i, np.int32)
        jl, jcache = jax.jit(jmodel.decode_fn)(jparams, {"tokens": jnp.asarray(tok), "cur_len": jnp.asarray(cur)},
                                              jcache)
        with torch.no_grad():
            tl, tcache = tmodel.decode_fn(tparams, {"tokens": torch.from_numpy(tok), "cur_len": torch.from_numpy(cur)},
                                          tcache)
        close(as_np(tl), as_np(jl), TOL[dtype])


def test_input_defs_and_make_inputs_follow_the_reference():
    """The port's ``input_defs`` give the reference's names and shapes for
    every kind, and ``make_inputs`` draws them (a BOS-sized ``tokens``, the
    frames in bf16)."""
    from repro.configs.base import ShapeConfig as JaxShape
    from repro_torch.configs.base import ShapeConfig

    jcfg, tcfg = configs()
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    for kind in ("train", "prefill", "decode"):
        jd = jmodel.input_defs(JaxShape("s", 16, 2, kind))
        td = tmodel.input_defs(ShapeConfig("s", 16, 2, kind))
        assert {k: tuple(d.shape) for k, d in jd.items()} == {k: tuple(d.shape) for k, d in td.items()}
    got = tmodel.make_inputs(ShapeConfig("s", 16, 2, "prefill"), 0, device=CPU)
    assert got["src_embeds"].dtype == torch.bfloat16 and tuple(got["tokens"].shape) == (2, 1)


# ------------------------------------------------------------------ training


def make_batch(cfg, b, t, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, t + 1)).astype(np.int32)
    return {"src_embeds": frames(seed + 1, b, t, cfg.d_model), "tgt_tokens": toks[:, :-1], "targets": toks[:, 1:]}


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match_jax(remat):
    """``loss_fn`` and every gradient leaf (encoder, decoder, cross, the
    embedding and head) against ``jax.value_and_grad`` of the JAX loss on
    the params carried across, in fp32, attention at fan-in d: the loss
    within 2e-5 relative, each leaf within 2e-5 of its max."""
    _, tcfg, jmodel, tmodel, jparams, tparams = both_params("float32", remat=remat)
    batch = make_batch(tcfg, 2, 32)
    (jl, jmet), jg = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tmet, tg = value_and_grad(tmodel, tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(tmet) == sorted(jmet)
    assert abs(float(tl) - float(jl)) <= TOL["float32"] * abs(float(jl))
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(jg)[0], tree.leaves(tg)):
        close(g.numpy(), np.asarray(w), TOL["float32"]) if np.abs(np.asarray(w)).max() > 0 else None
        assert g.shape == w.shape, jax.tree_util.keystr(path)


def test_remat_checkpoints_each_encoder_and_decoder_layer(monkeypatch):
    """With ``cfg.remat`` under autograd each encoder block and each decoder
    layer (self-attention, MLP, cross K/V and cross-attention) runs under
    ``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``;
    without grad, none does."""
    from repro_torch.models import model as model_mod
    from repro_torch.models import transformer as tfm

    calls = []

    def counting(real):
        def run(fn, *args, **kw):
            calls.append(fn.__name__)
            return real(fn, *args, **kw)
        return run

    monkeypatch.setattr(tfm, "checkpoint", counting(tfm.checkpoint))
    monkeypatch.setattr(ed, "checkpoint", counting(ed.checkpoint))
    monkeypatch.setattr(model_mod, "checkpoint", counting(model_mod.checkpoint))
    cfg = dataclasses.replace(reduced_config(get_arch(ARCH)), remat=True)
    model = build_model(cfg)
    params = model.init(0, device=CPU)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, 1, 16).items()}
    with torch.no_grad():
        model.loss_fn(params, batch)
    assert calls == []
    value_and_grad(model, params, batch)
    assert calls == ["apply_block_full"] * cfg.num_layers + ["_decoder_block_train"] * cfg.num_decoder_layers + [
        "_ce_chunk"]


def test_train_step_from_a_bridged_state_matches_jax():
    """The JAX step 1 from its init, its state carried across by
    ``train_state_from_numpy``, then step 2 in both packages (fp32 params,
    nonzero moments): the metrics and both moments (the gradient carried
    through the step) within 2e-5. The new params are held at 2e-2 of each
    leaf's max: AdamW divides each entry by its own root second moment, so
    an entry whose gradient is ~1e-6 of its leaf's max moves by about lr
    whatever its rounding, and LayerNorm's biases (zero at init, ~lr after a
    step) and rarely drawn embedding rows then differ by 2-5e-5 of their
    leaf's max between two correct fp32 implementations."""
    _, tcfg, jmodel, tmodel, jparams, _ = both_params("float32")
    jstep = jax_make_train_step(jmodel, JaxAdamWConfig(lr=1e-2), jax_cosine(1e-2, 2, 20))
    tstep = make_train_step(tmodel, AdamWConfig(lr=1e-2), cosine_schedule(1e-2, 2, 20))
    batches = [make_batch(tcfg, 4, 32, seed=s) for s in (1, 2)]  # tests/test_torch_train.py's shape
    jstate, _ = jax.jit(jstep)({"params": jparams, "opt": jax_adamw_init(jparams)},
                               {k: jnp.asarray(v) for k, v in batches[0].items()})
    carried = {"params": f32(jstate["params"]),
               "opt": {"step": np.asarray(jstate["opt"]["step"]), "m": f32(jstate["opt"]["m"]),
                       "v": f32(jstate["opt"]["v"])}}
    tstate = train_state_from_numpy(carried, tmodel.param_defs, dtype=torch.float32, device=CPU)
    jnew, jmet = jax.jit(jstep)(jstate, {k: jnp.asarray(v) for k, v in batches[1].items()})
    tnew, tmet = tstep(tstate, {k: torch.from_numpy(v) for k, v in batches[1].items()})
    for key in ("loss", "ce", "grad_norm", "lr"):
        assert abs(float(tmet[key]) - float(jmet[key])) <= TOL["float32"] * abs(float(jmet[key])), key
    for part in ("params", "m", "v"):
        jt = jnew["params"] if part == "params" else jnew["opt"][part]
        tt = tnew["params"] if part == "params" else tnew["opt"][part]
        for a, b in zip(jax.tree.leaves(jt), tree.leaves(tt)):
            close(b.numpy(), np.asarray(a), TOL["bfloat16" if part == "params" else "float32"])


# ------------------------------------------------------------------ the served chain


def prompt(tcfg, seed=7, b=2, s=37, dtype=torch.float32):
    return {"src_embeds": torch.from_numpy(frames(seed, b, s, tcfg.d_model)).to(dtype),
            "tokens": torch.zeros((b, 1), dtype=torch.int32)}


def direct_tokens(model, params, inputs, steps):
    """The model without the platform: prefill_fn, then decode_fn."""
    with torch.no_grad():
        logits, cache = model.prefill_fn(params, inputs)
        cur = torch.ones((inputs["tokens"].shape[0],), dtype=torch.int32)
        out = [torch.argmax(logits, -1)[:, None].to(torch.int32)]
        for _ in range(steps - 1):
            logits, cache = model.decode_fn(params, {"tokens": out[-1], "cur_len": cur}, cache)
            cur = cur + 1
            out.append(torch.argmax(logits, -1)[:, None].to(torch.int32))
    return torch.cat(out, dim=1)


def jax_generate(jmodel, jparams, inputs, steps):
    platform = TinyJaxBackend(JaxFusionPolicy(enabled=False))
    try:
        engine = JaxServingEngine(jmodel, platform, max_len=MAX_LEN, params=jparams)
        logits, caches, cur = engine.prefill({k: jnp.asarray(v.numpy()) for k, v in inputs.items()})
        got, toks = [np.asarray(logits)], [np.asarray(jnp.argmax(logits, -1))[:, None]]
        for _ in range(steps - 1):
            logits, caches = engine.decode_step(jnp.asarray(toks[-1], jnp.int32), cur, caches)
            cur = cur + 1
            got.append(np.asarray(logits))
            toks.append(np.asarray(jnp.argmax(logits, -1))[:, None])
    finally:
        platform.shutdown()
    return np.concatenate(toks, axis=1), got


def test_two_function_app_fuses_and_keeps_the_tokens():
    """The reference's two-function app (``tests/test_serving.py:106``) in
    float32: 2 live instances unfused, 1 after one healthy merge of both; the
    greedy tokens of the fusing chain equal the unfused chain's, the model's
    own ``prefill_fn`` / ``decode_fn`` and the JAX engine's, and every
    step's logits are within 2e-5 of the JAX engine's; ``ram_bytes`` drops."""
    _, tcfg, jmodel, tmodel, jparams, tparams = both_params("float32")
    inputs = prompt(tcfg)
    want_toks, want_logits = jax_generate(jmodel, jparams, inputs, STEPS)
    direct = direct_tokens(tmodel, tparams, inputs, STEPS)
    assert np.array_equal(direct.numpy(), want_toks)
    for fused in (False, True):
        policy = FusionPolicy(min_observations=2, merge_cost_s=0.0) if fused else FusionPolicy(enabled=False)
        platform = TinyTorchBackend(policy)
        try:
            engine = ServingEngine(tmodel, platform, max_len=MAX_LEN, params=tparams, device=CPU)
            assert engine.chain_names() == [f"{ARCH}/embed", f"{ARCH}/decoder"]
            assert not engine.paging_supported
            with pytest.raises(ValueError, match="paged KV unsupported"):
                engine.enable_paging(8)
            ram = platform.ram_bytes()
            assert len(platform.registry.live_instances()) == 2
            for _ in range(3):
                got, _ = engine.generate(inputs, steps=STEPS)
                assert torch.equal(got, direct)
            logits, caches, cur = engine.prefill(inputs)
            assert int(cur[0]) == 1 and caches["cross"]["k"].shape[2] == 37
            close(logits.numpy(), want_logits[0], TOL["float32"])
            live = platform.registry.live_instances()
            if fused:
                assert len(live) == 1 and set(live[0].members) == set(engine.chain_names())
                assert [set(m.members) for m in platform.merger.merge_log if m.healthy] == [
                    set(engine.chain_names())]
                assert platform.ram_bytes() < ram
            else:
                assert len(live) == 2
        finally:
            platform.shutdown()


@pytest.mark.parametrize("backend", [TinyTorchBackend, OrchestratedBackend])
def test_decoder_entered_at_the_fused_units_second_member(captured, backend):
    """A decode step invokes ``<arch>/decoder`` directly. After the merge that
    name routes to the fused unit, entered at its second member: its decode
    form (3 arguments) and prefill form (4) are entries of their own; the
    shape-only run finds the decoder self-contained; the decode entry is
    captured at its second run and replayed with the chain's tokens; and
    concurrent ``decode_step_async`` calls coalesce into one batched program
    whose lanes equal each request's ``decode_step``."""
    cfg = reduced_config(get_arch(ARCH))
    model = build_model(cfg)
    platform = backend(FusionPolicy(min_observations=2, merge_cost_s=0.0), max_batch=4, max_delay_ms=50.0)
    try:
        engine = ServingEngine(model, platform, max_len=MAX_LEN, device=CPU)
        inputs = prompt(cfg, b=1, dtype=torch.bfloat16)
        want, _ = engine.generate(inputs, steps=STEPS)
        # the edge is observed once per prefill: the second one fuses it
        assert torch.equal(engine.generate(inputs, steps=STEPS)[0], want)
        platform.merger.wait_idle()
        assert len(platform.registry.live_instances()) == 1
        for _ in range(2):
            assert torch.equal(engine.generate(inputs, steps=STEPS)[0], want)
        unit = platform.registry.get(engine.dec_name)
        assert unit is platform.registry.get(engine.entry) and len(unit.members) == 2
        stats = unit.graph_stats()
        dec = [g for g in stats if g["entry"] == engine.dec_name and g["bucket"] is None]
        # the decode form's first leaf is the (B, 1) tokens, the prefill
        # form's (a merge canary replayed at the decoder) the (B, S, d) states
        assert {len(g["arg_shape"]) for g in dec} == {2, 3}
        assert any(g["captured"] and g["replays"] > 0 for g in dec if len(g["arg_shape"]) == 2)
        assert any(g["entry"] == engine.entry and g["captured"] for g in stats)  # the prefill, entered at the head

        # concurrent clients on the fused decoder coalesce
        _, caches, cur = engine.prefill(inputs)
        tok = want[:, 1:2]
        solo, _ = engine.decode_step(tok, cur, caches)
        barrier = threading.Barrier(3)
        outs = [None] * 3

        def client(i):
            barrier.wait(timeout=JOIN_S)
            outs[i] = engine.decode_step_async(tok, cur, caches).result(timeout=JOIN_S)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
            assert not t.is_alive(), "a decode_step_async client hung"
        for logits, new_caches in outs:
            close(logits.float().numpy(), solo.float().numpy(), TOL["bfloat16"])
            assert new_caches["cross"]["k"].shape == caches["cross"]["k"].shape
        batch = unit.batch_stats()
        assert batch["fallback_requests"].get(engine.dec_name, 0) == 0, batch
    finally:
        platform.shutdown()


def test_scale_to_zero_parks_and_resurrects_the_chain(tmp_path):
    """``chain_names`` holds both functions; a park of the fused chain parks
    both (``ram_bytes`` 0), the next request resurrects and re-fuses them,
    and the tokens are the same bit for bit."""
    cfg = reduced_config(get_arch(ARCH))
    model = build_model(cfg)
    params = model.init(0, device=CPU)
    platform = TinyTorchBackend(FusionPolicy(min_observations=2, merge_cost_s=0.0), snapshot_dir=str(tmp_path))
    try:
        engine = ServingEngine(model, platform, max_len=MAX_LEN, params=params, device=CPU)
        inputs = prompt(cfg, dtype=torch.bfloat16)
        want, _ = engine.generate(inputs, steps=STEPS)
        platform.merger.wait_idle()
        assert set(engine.scale_to_zero()) == set(engine.chain_names())
        assert platform.ram_bytes() == 0
        assert all(platform.registry.get(n) is None for n in engine.chain_names())
        for _ in range(2):
            assert torch.equal(engine.generate(inputs, steps=STEPS)[0], want)
        platform.merger.wait_idle()
        assert len(platform.registry.live_instances()) == 1
        resurrects = [r for r in platform.meter.provisioning if r.kind == "resurrect"]
        assert len(resurrects) == 2 and all(r.billed for r in resurrects)
    finally:
        platform.shutdown()


def test_the_chains_kernels_are_k3_non_causal_and_k4():
    """On the host the wrappers run their plain versions: a prefill runs K3
    once per encoder layer (non-causal) and K4 twice per decoder layer (self
    and cross); a decode step K4 twice per decoder layer; nothing else."""
    cfg = reduced_config(get_arch(ARCH))
    model = build_model(cfg)
    platform = TinyTorchBackend(FusionPolicy(enabled=False))
    try:
        engine = ServingEngine(model, platform, max_len=MAX_LEN, device=CPU)
        inputs = prompt(cfg, b=1, dtype=torch.bfloat16)
        kops.reset_counts()
        _, caches, cur = engine.prefill(inputs)
        after_prefill = {k: v for k, v in kops.counts().items() if v}
        engine.decode_step(torch.zeros((1, 1), dtype=torch.int32), cur, caches)
        total = {k: v for k, v in kops.counts().items() if v}
    finally:
        platform.shutdown()
    assert after_prefill == {"mha_ref": cfg.num_layers, "decode_attn_ref": 2 * cfg.num_decoder_layers}
    assert total == {"mha_ref": cfg.num_layers, "decode_attn_ref": 4 * cfg.num_decoder_layers}


def test_chip_smoke_encdec_phases_rehearsal_on_cpu(monkeypatch):
    """chip_smoke.py's enc-dec phases on the CPU at the reduced size (plain
    versions stand in for the kernels): the serve phase fuses 2 -> 1 with
    the same tokens and its plain calls are the launches
    ``expected_launches`` predicts for the chain; the small model's serve
    and train step agree card (here the host) vs host; the train phase's
    K3 count is 2 x (remat) per attention of each microbatch."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = reduced_config(get_arch(ARCH))
    params = build_model(cfg).init(0, device=CPU)
    kops.reset_counts()
    serve = smoke.encdec_serve_phase(torch, CPU, cfg, params, src_lens=(9, 12), new_tokens=4, max_len=32)
    assert serve["live_instances"] == {"unfused": 2, "fused": 1} and serve["tokens_identical"]
    exp = serve["expected_launches"]
    counts = kops.counts()  # the phase's, and its check of the model without the platform (4 tokens)
    assert exp["flash_attention"] + cfg.num_layers == counts["mha_ref"]
    assert exp["decode_attention"] + 2 * cfg.num_decoder_layers * 4 == counts["decode_attn_ref"]
    assert exp["flash_attention"] >= cfg.num_layers * serve["prefills"]
    assert exp["decode_attention"] >= 2 * cfg.num_decoder_layers * (serve["prefills"] + serve["decode_steps"])
    small = smoke.encdec_card_vs_host(torch, CPU, get_arch(ARCH), src_len=9)
    assert small["rel_err"] == [0.0] * (smoke.ENCDEC_DECODE_STEPS + 1)
    assert max(smoke.train_card_vs_host(torch, CPU, get_arch(ARCH), seq=16)["grad_rel_err"].values()) == 0.0
    monkeypatch.setattr(smoke, "TRAIN_SEQ", 32)
    monkeypatch.setattr(smoke, "ENCDEC_TRAIN_BATCH", 2)
    train = smoke.encdec_train_phase(torch, CPU, dataclasses.replace(cfg, microbatches=2, remat=True))
    per_step = 2 * (cfg.num_layers + 2 * cfg.num_decoder_layers)
    assert train["expected_launches"]["flash_attention"] == 2 * smoke.ENCDEC_TRAIN_STEPS * per_step
    assert all(math.isfinite(x) for x in train["losses"])
