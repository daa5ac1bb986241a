"""The port's four further decoder architectures against the JAX package:
stablelm-1.6b (LayerNorm, 32/32 heads of 64), starcoder2-3b (LayerNorm, the
tanh GELU MLP, 24/2 heads of 128), granite-34b (LayerNorm, GELU, a tied head,
48/1 heads) and chameleon-34b (the vlm family: QK-norm over 64/8 heads and a
prompt of precomputed ``embeds``), each at its reduced configuration.

The JAX model's parameters are carried across with
``bridge.params_from_numpy``, so both packages compute the same function on
the same weights and the same inputs (made with numpy). Tolerances are those
of ``tests/test_kernels.py``: float32 2e-5, bfloat16 2e-2, each over the
reference's max |logit|."""
import dataclasses
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

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import ARCHS, get_arch, reduced_config  # noqa: E402
from repro_torch.core import FusionPolicy, TinyTorchBackend  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.continuous import ContinuousBatcher  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from test_torch_capture import captured  # noqa: E402,F401  (the recording stand-in for a CUDA graph)

NEW_ARCHS = ["stablelm-1.6b", "starcoder2-3b", "granite-34b", "chameleon-34b"]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
CPU = torch.device("cpu")
MAX_LEN = 32
ROOT = Path(__file__).resolve().parents[1]


def configs(arch, kv_cache_dtype="bfloat16"):
    jcfg = dataclasses.replace(jax_reduced(jax_get_arch(arch)), kv_cache_dtype=kv_cache_dtype)
    tcfg = dataclasses.replace(reduced_config(get_arch(arch)), kv_cache_dtype=kv_cache_dtype)
    return jcfg, tcfg


def to_numpy_f32(params):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), params)


def tokens_np(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def embeds_np(seed, shape):
    """A vlm prompt: 0.02 x N(0, 1) frontend embeddings, bf16-representable
    float32 values (so that every dtype sees the same numbers)."""
    x = (np.random.default_rng(seed).standard_normal(shape) * 0.02).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def close(got, want, dtype) -> float:
    """max |got - want| over max |want|, checked against the dtype's tolerance."""
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max() / np.abs(want).max())
    assert err <= TOL[dtype], err
    return err


def grow_torch(cache, extra):
    return {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, extra)) for k, v in cache.items()}


def grow_jax(cache, extra):
    return jax.tree.map(lambda x: jnp.pad(x, [(0, 0), (0, 0), (0, extra), (0, 0), (0, 0)]), cache)


# ------------------------------------------------------------------ configs


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_config_fields_equal_the_reference(arch):
    """Every field of every architecture the port registers, full size and
    reduced, is the JAX package's."""
    assert dataclasses.asdict(get_arch(arch)) == dataclasses.asdict(JAX_ARCHS[arch])
    assert dataclasses.asdict(reduced_config(get_arch(arch))) == dataclasses.asdict(
        jax_reduced(JAX_ARCHS[arch]))


def test_the_four_decoders_are_registered_with_their_sources():
    sources = {"stablelm-1.6b": "hf:stabilityai/stablelm-2-1_6b", "starcoder2-3b": "arXiv:2402.19173",
               "granite-34b": "arXiv:2405.04324", "chameleon-34b": "arXiv:2405.09818"}
    assert {a: get_arch(a).source for a in NEW_ARCHS} == sources


# ------------------------------------------------------------------- models


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_param_tree_matches_jax_layout_and_init_rule(arch):
    """Leaf for leaf, in the same order: the path, the shape, the init rule,
    the fan-in axis and the dtype (LayerNorm's bias, the untied head,
    QK-norm's scales included)."""
    jcfg, tcfg = configs(arch)
    jleaves = jax.tree_util.tree_flatten_with_path(jax_build_model(jcfg).param_defs,
                                                   is_leaf=lambda x: hasattr(x, "logical"))[0]
    tleaves, _ = tree.flatten(build_model(tcfg).param_defs)
    jrows = [(tuple(str(getattr(k, "key", k)) for k in path), d.shape, d.init, d.scale_axis,
              jnp.dtype(d.dtype).name) for path, d in jleaves]
    trows = [(d.shape, d.init, d.scale_axis, str(d.dtype).removeprefix("torch.")) for d in tleaves]
    assert [r[1:] for r in jrows] == trows
    paths = {r[0][-1] for r in jrows}
    tcfg_full = get_arch(arch)
    assert ("bias" in paths) == (tcfg_full.norm == "layernorm")
    assert ("head" in paths) == (not tcfg_full.tie_embeddings)
    assert ("q_norm" in paths) == tcfg_full.qk_norm
    assert ("wi" in paths) == (tcfg_full.act == "gelu")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_init_params_draws_each_leaf_by_its_rule(arch):
    _, tcfg = configs(arch)
    params = build_model(tcfg).init(3, device=CPU)
    blocks = params["blocks"]
    if tcfg.norm == "layernorm":
        assert torch.equal(blocks["ln1"]["bias"], torch.zeros_like(blocks["ln1"]["bias"]))
    assert torch.equal(params["ln_f"]["scale"], torch.ones_like(params["ln_f"]["scale"]))
    assert abs(params["embed"]["table"].float().std().item() - 1.0) < 0.05
    wk = blocks["attn"]["wk"].float()  # (L, d, KV, hd): fan-in KV (axis -2), as in JAX
    assert abs(wk.std().item() - 1 / np.sqrt(wk.shape[-2])) < 0.05 / np.sqrt(wk.shape[-2])
    if "head" in params["embed"]:  # untied: (d, V), fan-in d
        head = params["embed"]["head"].float()
        assert abs(head.std().item() - 1 / np.sqrt(tcfg.d_model)) < 0.01


def model_inputs(tcfg, seed, t):
    """(JAX batch, torch batch) of a two-row prompt: tokens, or embeds for vlm."""
    if tcfg.family == "vlm":
        e = embeds_np(seed, (2, t, tcfg.d_model))
        return e, {"embeds": lambda dt: jnp.asarray(e, dt)}, {"embeds": lambda dt: torch.from_numpy(e).to(dt)}
    toks = tokens_np(seed, (2, t), tcfg.vocab_size)
    return toks, {"tokens": lambda dt: jnp.asarray(toks)}, {"tokens": lambda dt: torch.from_numpy(toks)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_logits_match_jax(arch, dtype):
    """Prefill of 12 positions, then one decode step, in both packages."""
    t = 12
    jcfg, tcfg = configs(arch, dtype)
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jparams = jax.tree.map(lambda x: x.astype(jdt), jmodel.init(jax.random.PRNGKey(0)))
    tparams = params_from_numpy(to_numpy_f32(jparams), tmodel.param_defs, dtype=tdt, device=CPU)
    _, jin, tin = model_inputs(tcfg, 1, t)
    nxt = tokens_np(2, (2, 1), tcfg.vocab_size)
    cur = np.full((2,), t, np.int32)
    jl1, jcache = jax.jit(jmodel.prefill_fn)(jparams, {k: f(jdt) for k, f in jin.items()})
    jl2, _ = jax.jit(jmodel.decode_fn)(jparams, {"tokens": jnp.asarray(nxt), "cur_len": jnp.asarray(cur)},
                                      grow_jax(jcache, 1))
    with torch.no_grad():
        tl1, tcache = tmodel.prefill_fn(tparams, {k: f(tdt) for k, f in tin.items()})
        tl2, _ = tmodel.decode_fn(tparams, {"tokens": torch.from_numpy(nxt), "cur_len": torch.from_numpy(cur)},
                                  grow_torch(tcache, 1))
    close(tl1.numpy(), np.asarray(jl1), dtype)
    close(tl2.numpy(), np.asarray(jl2), dtype)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_then_decode_matches_full_forward(arch):
    """Inside the port, in float32: a prefill of T positions and one decode
    step give the logits of a prefill of T + 1 (for the vlm prompt, the
    decoded token's embedding appended to the embeds)."""
    t = 14
    tcfg = configs(arch, "float32")[1]
    model = build_model(tcfg)
    params = tree.map(lambda x: x.float(), model.init(0, device=CPU))
    raw, _, tin = model_inputs(tcfg, 5, t)
    nxt = torch.from_numpy(tokens_np(6, (2, 1), tcfg.vocab_size))
    with torch.no_grad():
        prompt = {k: f(torch.float32) for k, f in tin.items()}
        _, cache = model.prefill_fn(params, prompt)
        batch = {"tokens": nxt, "cur_len": torch.full((2,), t, dtype=torch.int32)}
        step, _ = model.decode_fn(params, batch, grow_torch(cache, 1))
        if "embeds" in prompt:
            longer = {"embeds": torch.cat([prompt["embeds"], params["embed"]["table"][nxt.long()]], dim=1)}
        else:
            longer = {"tokens": torch.cat([prompt["tokens"], nxt], dim=1)}
        full, _ = model.prefill_fn(params, longer)
    close(step.numpy(), full.numpy(), "float32")


# ------------------------------------------------------------------ serving


def direct_tokens(model, params, prompt: dict, steps: int):
    """The model without the platform: greedy prefill + decode steps."""
    t = next(iter(prompt.values())).shape[1]
    with torch.no_grad():
        logits, cache = model.prefill_fn(params, prompt)
        cache = grow_torch(cache, MAX_LEN - t)
        cur = torch.full((1,), t, dtype=torch.int32)
        out = [torch.argmax(logits, -1)[:, None].to(torch.int32)]
        for _ in range(steps - 1):
            logits, cache = model.decode_fn(params, {"tokens": out[-1], "cur_len": cur}, cache)
            cur = cur + 1
            out.append(torch.argmax(logits, -1)[:, None].to(torch.int32))
    return torch.cat(out, dim=1)


def serve_prompt(tcfg, seed, t):
    if tcfg.family == "vlm":
        return {"embeds": torch.from_numpy(embeds_np(seed, (1, t, tcfg.d_model))).to(torch.bfloat16)}
    return {"tokens": torch.from_numpy(tokens_np(seed, (1, t), tcfg.vocab_size))}


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_chain_matches_direct_model_and_fuses_to_one_instance(arch):
    """The serving chain (chameleon's fed ``embeds``) generates the model's
    own greedy tokens bit for bit, and the platform fuses the whole chain
    into one instance with less ``ram_bytes`` on the way."""
    _, tcfg = configs(arch)
    model = build_model(tcfg)
    params = model.init(0, device=CPU)
    platform = TinyTorchBackend(FusionPolicy(min_observations=2, merge_cost_s=0.0))
    try:
        engine = ServingEngine(model, platform, max_len=MAX_LEN, params=params, device=CPU)
        assert len(platform.registry.live_instances()) == len(engine.chain_names()) == 4
        ram_unfused = platform.ram_bytes()
        prompts = [serve_prompt(tcfg, s, t) for s, t in ((3, 9), (4, 12))]
        got = [engine.generate(p, steps=8)[0] for p in prompts]
        live = platform.registry.live_instances()
        assert len(live) == 1 and set(live[0].members) == set(engine.chain_names())
        assert any(m.healthy and set(m.members) == set(engine.chain_names()) for m in platform.merger.merge_log)
        assert platform.ram_bytes() < ram_unfused
    finally:
        platform.shutdown()
    for p, g in zip(prompts, got):
        assert torch.equal(g, direct_tokens(model, params, p, 8))


# The JAX chain's logits, computed in a process of its own with XLA's excess
# precision off (see tests/test_torch_serving.py): per architecture and
# dtype, the bridged params and the teacher-forced logits of SEQ; for
# chameleon-34b in float32 also an ``embeds`` prompt's first-token logits and
# two teacher-forced steps after it.
JAX_CHAINS = """
import dataclasses, os, pickle, sys
os.nice(10)  # yield the CPU to the suite's timing-sensitive tests running beside it
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_arch, reduced_config
from repro.core import FusionPolicy, TinyJaxBackend
from repro.models.model import build_model
from repro.serving.engine import ServingEngine

max_len, t_in, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
archs = sys.argv[4].split(",")
seq = np.load(out + ".tokens.npy")
emb = np.load(out + ".embeds.npy")
result = {}
for arch in archs:
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(reduced_config(get_arch(arch)), kv_cache_dtype=dtype)
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
            embeds = None
            if cfg.family == "vlm" and dtype == "float32":
                logits, caches, cur = engine.prefill({"embeds": jnp.asarray(emb)})
                embeds = [np.asarray(logits)]
                for i in range(2):
                    logits, caches = engine.decode_step(jnp.asarray(seq[:, i : i + 1]), cur, caches)
                    cur = cur + 1
                    embeds.append(np.asarray(logits))
        finally:
            platform.shutdown()
        result[(arch, dtype)] = {"params": jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), params),
                                 "logits": got, "embeds_logits": embeds}
with open(out, "wb") as f:
    pickle.dump(result, f)
"""
SEQ = tokens_np(9, (1, 13), 256)
EMBEDS = embeds_np(10, (1, 11, 64))
T_IN = 10


@pytest.fixture(scope="module")
def jax_chains(tmp_path_factory):
    """{(arch, dtype): {"params", "logits", "embeds_logits"}} from the JAX chains."""
    out = tmp_path_factory.mktemp("jax_chains") / "logits.pkl"
    np.save(f"{out}.tokens.npy", SEQ)
    np.save(f"{out}.embeds.npy", EMBEDS)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false").strip())
    proc = subprocess.run([sys.executable, "-c", JAX_CHAINS, str(MAX_LEN), str(T_IN), str(out), ",".join(NEW_ARCHS)],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def port_engine(arch, dtype, ref, policy):
    tcfg = dataclasses.replace(reduced_config(get_arch(arch)), kv_cache_dtype=dtype)
    tmodel = build_model(tcfg)
    tparams = params_from_numpy(ref["params"], tmodel.param_defs, dtype=getattr(torch, dtype), device=CPU)
    platform = TinyTorchBackend(policy)
    return ServingEngine(tmodel, platform, max_len=MAX_LEN, params=tparams, device=CPU), platform


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_teacher_forced_logits_match_jax_engine(jax_chains, arch, dtype):
    """The same weights (JAX's, bridged) and the same tokens through both
    chains; the port's chain fuses to one instance meanwhile."""
    ref = jax_chains[(arch, dtype)]
    engine, platform = port_engine(arch, dtype, ref, FusionPolicy(min_observations=2, merge_cost_s=0.0))
    try:
        logits, caches, cur = engine.prefill({"tokens": torch.from_numpy(SEQ[:, :T_IN])})
        got = [logits.numpy()]
        for i in range(T_IN, SEQ.shape[1]):
            logits, caches = engine.decode_step(torch.from_numpy(SEQ[:, i : i + 1]), cur, caches)
            cur = cur + 1
            got.append(logits.numpy())
        assert len(platform.registry.live_instances()) == 1
    finally:
        platform.shutdown()
    assert len(got) == len(ref["logits"]) == 4
    for t, j in zip(got, ref["logits"]):
        close(t, j, dtype)


# ----------------------------------------------------------- chameleon embeds

VLM = "chameleon-34b"


def test_embeds_chain_logits_match_jax_engine_in_float32(jax_chains):
    """An ``embeds`` prompt through the port's chain: its first-token logits
    and two teacher-forced steps after it, against the JAX engine's."""
    ref = jax_chains[(VLM, "float32")]
    engine, platform = port_engine(VLM, "float32", ref, FusionPolicy(enabled=False))
    try:
        logits, caches, cur = engine.prefill({"embeds": torch.from_numpy(EMBEDS)})
        assert cur.tolist() == [EMBEDS.shape[1]]
        got = [logits.numpy()]
        for i in range(2):
            logits, caches = engine.decode_step(torch.from_numpy(SEQ[:, i : i + 1]), cur, caches)
            cur = cur + 1
            got.append(logits.numpy())
    finally:
        platform.shutdown()
    for t, j in zip(got, ref["embeds_logits"]):
        close(t, j, "float32")


@pytest.fixture()
def vlm_paged():
    cfg = reduced_config(get_arch(VLM))
    platform = TinyTorchBackend(FusionPolicy(min_observations=2, merge_cost_s=0.0))
    engine = ServingEngine(build_model(cfg), platform, max_len=64, device=CPU, kv_pages=40, kv_page_size=16)
    yield engine
    platform.shutdown()


def test_embeds_generate_paged_equals_generate(vlm_paged):
    prompt = {"embeds": torch.from_numpy(embeds_np(11, (2, 21, 64))).to(torch.bfloat16)}
    dense, _ = vlm_paged.generate(prompt, steps=8)
    paged, _ = vlm_paged.generate_paged(prompt, steps=8)
    assert torch.equal(dense, paged)
    assert vlm_paged.arena.used_pages() == 0


def test_identical_embeds_prompts_share_no_page(vlm_paged):
    """Raw embeds carry no content hash: two identical prompts take fresh
    pages each, and the prefix cache records no hit."""
    arena = vlm_paged.arena
    prompt = {"embeds": torch.from_numpy(embeds_np(12, (1, 40, 64))).to(torch.bfloat16)}
    hits = arena.shared_hits
    la, ta = vlm_paged.prefill_paged("a", prompt)
    lb, tb = vlm_paged.prefill_paged("b", prompt)
    try:
        assert ta == tb == 40 and torch.equal(la, lb)
        row_a, row_b = arena.block_row("a", vlm_paged.block_width), arena.block_row("b", vlm_paged.block_width)
        pages_a, pages_b = set(row_a[: arena.pages_for(40)]), set(row_b[: arena.pages_for(40)])
        assert len(pages_a) == len(pages_b) == 3 and not pages_a & pages_b
        assert arena.shared_hits == hits and arena.shared_pages("b") == 0
        arena.check_consistency()
    finally:
        arena.free("a")
        arena.free("b")


def test_batcher_serves_an_embeds_request(vlm_paged):
    """An ``embeds`` request through the ContinuousBatcher (the serialized
    prefill route, as in the reference) completes beside a token request,
    each with per-request generate's tokens."""
    cfg = vlm_paged.cfg
    e = {"embeds": torch.from_numpy(embeds_np(13, (1, 19, 64))).to(torch.bfloat16)}
    t = {"tokens": tokens_np(14, (1, 23), cfg.vocab_size)}
    want = [vlm_paged.generate(e, steps=6)[0].numpy(),
            vlm_paged.generate({"tokens": torch.from_numpy(t["tokens"])}, steps=6)[0].numpy()]
    cb = ContinuousBatcher(vlm_paged, capacity=2)
    try:
        got = [f.result(timeout=120)["tokens"] for f in (cb.submit(e, 6), cb.submit(t, 6))]
    finally:
        cb.shutdown()
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert vlm_paged.arena.used_pages() == 0


# ------------------------------------------------------- chip_smoke rehearsal


def _smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("arch", ["granite-34b", VLM])
def test_chip_smoke_decoder_phases_rehearsal_on_cpu(arch):
    """chip_smoke.py's decoder phases at a tiny size on the CPU: the same
    control flow and checks the card run makes, minus the kernel counts (the
    plain versions stand in): the serve phase (chameleon's with an embeds
    prompt), the paged serve phase (granite's token prompts share pages,
    chameleon's embeds share none and prefill densely) and the block check."""
    smoke = _smoke()
    cfg = reduced_config(get_arch(arch))
    vlm = cfg.family == "vlm"
    params = build_model(cfg).init(0, device=CPU)
    out = smoke.serve_phase(torch, CPU, cfg, prompt_lens=(5, 9, 12), new_tokens=4, max_len=24, params=params,
                            embeds_len=7 if vlm else 0)
    prompts = 4 if vlm else 3
    assert out["live_instances"] == {"unfused": 4, "fused": 1} and out["tokens_identical"]
    assert out["ram_bytes"]["fused"] < out["ram_bytes"]["unfused"]
    assert out["prefills"] == 2 * prompts and out["embeds_prompt"] == (7 if vlm else None)
    assert out["plain_calls"]["mha_ref"] == out["expected_launches"]["flash_attention"] >= 2 * prompts * 2
    paged = smoke.paged_serve_phase(torch, CPU, cfg, prompt_lens=(5, 16, 30), n_requests=8, steps=6, max_len=64,
                                    capacity=4, prefix_len=16, small_cfg=smoke.small_config(cfg), params=params,
                                    embeds=vlm)
    assert paged["live_instances"] == {"fused": 1, "unfused": 4}
    assert paged["fused_vs_unfused_identical_requests"] == 8
    assert paged["block_rel_err"] == [0.0] * cfg.num_layers
    calls = paged["plain_calls"]["fused"]
    if vlm:
        assert paged["shared_hits"] == paged["cow_copies"] == {"fused": 0, "unfused": 0}
        assert set(paged["launches"]["fused"]) == {"paged_decode_attention", "flash_attention"}
        assert calls["mha_ref"] == 8 * cfg.num_layers and calls["paged_chunk_attn_ref"] == 0
    else:
        assert paged["shared_hits"]["fused"] >= 3
        assert set(paged["launches"]["fused"]) == {"paged_decode_attention", "paged_chunk_attention"}
        assert calls["paged_chunk_attn_ref"] > 0 and calls["mha_ref"] == 0
    block = smoke.decoder_block_phase(torch, CPU, cfg, params, prompt_len=9)  # both sides on the host here
    assert block["card_vs_host_rel_err"] == {"block_0": 0.0, f"block_{cfg.num_layers - 1}": 0.0}
    assert block["input"] == ("embeds" if vlm else "tokens")


@pytest.mark.parametrize("fusion", [True, False])
def test_an_admission_prefill_is_never_captured(captured, fusion):
    """Inside ``prefill_paged`` the dense prefill runs under ``no_capture``
    at every hop (its shape is the prompt's own length); the same prompt
    through ``generate`` is captured at its next run and replayed, with the
    same tokens."""
    cfg = reduced_config(get_arch(VLM))
    policy = FusionPolicy(min_observations=2, merge_cost_s=0.0) if fusion else FusionPolicy(enabled=False)
    platform = TinyTorchBackend(policy)
    try:
        engine = ServingEngine(build_model(cfg), platform, max_len=64, device=CPU, kv_pages=40, kv_page_size=16)
        prompt = {"embeds": torch.from_numpy(embeds_np(15, (1, 21, 64))).to(torch.bfloat16)}
        want = engine.generate(prompt, steps=4)[0]
        for i in range(3):
            engine.prefill_paged(("admit", i), prompt)
            engine.arena.free(("admit", i))

        def prefill_graphs():
            return [g for inst in platform.registry.live_instances() for g in inst.graph_stats()
                    if g["captured"] and len(g["arg_shape"]) >= 2 and g["arg_shape"][1] == 21]

        assert prefill_graphs() == []
        got = engine.generate(prompt, steps=4)[0]
        assert len(prefill_graphs()) == 1 and torch.equal(got, want)
        assert torch.equal(engine.generate(prompt, steps=4)[0], want)  # a replay
        assert prefill_graphs()[0]["replays"] == 1
    finally:
        platform.shutdown()
