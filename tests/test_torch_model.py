"""The port's dense model (reduced llama3.2-1b) against the JAX model.

The JAX model's parameters are carried across with
``bridge.params_from_numpy``, so both packages compute the same function on
the same weights and the same tokens (made with numpy)."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # the suite runs several workers at once: leave them cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

ARCH = "llama3.2-1b"
T = 12
CPU = torch.device("cpu")


def configs(kv_cache_dtype="bfloat16"):
    jcfg = dataclasses.replace(jax_reduced(jax_get_arch(ARCH)), kv_cache_dtype=kv_cache_dtype)
    tcfg = dataclasses.replace(reduced_config(get_arch(ARCH)), kv_cache_dtype=kv_cache_dtype)
    return jcfg, tcfg


def to_numpy_f32(params):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), params)


def tokens_np(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def grow_jax(cache, t, extra):
    return jax.tree.map(lambda x: jnp.pad(x, [(0, 0), (0, 0), (0, extra), (0, 0), (0, 0)]), cache)


def grow_torch(cache, extra):
    return {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, extra)) for k, v in cache.items()}


def run_both(kv_cache_dtype, jdtype, tdtype):
    """Prefill T tokens then decode one, in JAX and in the port."""
    jcfg, tcfg = configs(kv_cache_dtype)
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    jparams = jax.tree.map(lambda x: x.astype(jdtype), jmodel.init(jax.random.PRNGKey(0)))
    tparams = params_from_numpy(to_numpy_f32(jparams), dtype=tdtype, device=CPU)
    toks = tokens_np(1, (2, T + 1), tcfg.vocab_size)
    cur = np.full((2,), T, np.int32)

    jl1, jcache = jax.jit(jmodel.prefill_fn)(jparams, {"tokens": jnp.asarray(toks[:, :T])})
    jl2, _ = jax.jit(jmodel.decode_fn)(
        jparams, {"tokens": jnp.asarray(toks[:, T:]), "cur_len": jnp.asarray(cur)}, grow_jax(jcache, T, 1))
    with torch.no_grad():
        tl1, tcache = tmodel.prefill_fn(tparams, {"tokens": torch.from_numpy(toks[:, :T])})
        tl2, _ = tmodel.decode_fn(
            tparams, {"tokens": torch.from_numpy(toks[:, T:]), "cur_len": torch.from_numpy(cur)},
            grow_torch(tcache, 1))
    return (np.asarray(jl1), np.asarray(jl2)), (tl1.numpy(), tl2.numpy())


def test_logits_match_jax_in_float32():
    (j1, j2), (t1, t2) = run_both("float32", jnp.float32, torch.float32)
    np.testing.assert_allclose(t1, j1, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t2, j2, rtol=1e-4, atol=1e-4)


def test_logits_match_jax_in_bfloat16():
    (j1, j2), (t1, t2) = run_both("bfloat16", jnp.bfloat16, torch.bfloat16)
    assert np.isfinite(t1).all() and np.isfinite(t2).all()
    for j, t in ((j1, t1), (j2, t2)):
        assert np.abs(t - j).max() <= 2e-2 * np.abs(j).max()


def test_param_tree_matches_jax_layout():
    jcfg, tcfg = configs()
    jdefs = jax_build_model(jcfg).param_defs
    tdefs = build_model(tcfg).param_defs
    jleaves = jax.tree_util.tree_flatten_with_path(jdefs, is_leaf=lambda x: hasattr(x, "logical"))[0]
    tleaves, _ = tree.flatten(tdefs)
    assert [tuple(d.shape) for _, d in jleaves] == [tuple(d.shape) for d in tleaves]


def test_init_params_follows_the_jax_init_rule():
    _, tcfg = configs()
    model = build_model(tcfg)
    a = model.init(3, device=CPU)
    b = model.init(3, device=CPU)
    assert all(torch.equal(x, y) for x, y in zip(tree.leaves(a), tree.leaves(b)))  # seeded
    assert torch.equal(a["ln_f"]["scale"], torch.ones_like(a["ln_f"]["scale"]))
    table = a["embed"]["table"].float()
    assert abs(table.std().item() - 1.0) < 0.05  # 'embed': unit normal
    wq = a["blocks"]["attn"]["wq"].float()  # (L, d, H, hd): fan-in = H (axis -2)
    assert abs(wq.std().item() - 1 / math.sqrt(wq.shape[-2])) < 0.05
    assert a["blocks"]["mlp"]["wo"].dtype == torch.bfloat16


def test_prefill_then_decode_matches_full_forward():
    """Serving-path correctness inside the port: prefill a prompt, decode
    the next token — logits match a prefill over the extended prompt."""
    _, tcfg = configs()
    model = build_model(tcfg)
    params = model.init(0, device=CPU)
    t = 16
    toks = torch.from_numpy(tokens_np(5, (2, t + 1), tcfg.vocab_size))
    with torch.no_grad():
        la, cache = model.prefill_fn(params, {"tokens": toks[:, :t]})
        batch = {"tokens": toks[:, t:], "cur_len": torch.full((2,), t, dtype=torch.int32)}
        lb, _ = model.decode_fn(params, batch, grow_torch(cache, 1))
        lfull, _ = model.prefill_fn(params, {"tokens": toks})
    np.testing.assert_allclose(lb.numpy(), lfull.numpy(), rtol=3e-2, atol=3e-2)


def test_causality_future_tokens_do_not_change_past():
    _, tcfg = configs()
    model = build_model(tcfg)
    params = model.init(0, device=CPU)
    t = 16
    tok1 = torch.from_numpy(tokens_np(1, (1, t), tcfg.vocab_size))
    tok2 = tok1.clone()
    tok2[:, -1] = (tok1[:, -1] + 1) % tcfg.vocab_size
    with torch.no_grad():
        _, c1 = model.prefill_fn(params, {"tokens": tok1})
        _, c2 = model.prefill_fn(params, {"tokens": tok2})
        l1, _ = model.prefill_fn(params, {"tokens": tok1[:, : t - 1]})
        l2, _ = model.prefill_fn(params, {"tokens": tok2[:, : t - 1]})
    assert torch.equal(l1, l2)
    # cache rows of the unchanged prefix are identical too
    assert torch.equal(c1["k"][:, :, : t - 1], c2["k"][:, :, : t - 1])


def test_bridge_rejects_non_float32_leaves():
    with pytest.raises(TypeError):
        params_from_numpy({"w": np.zeros(3, np.float16)}, device=CPU)
