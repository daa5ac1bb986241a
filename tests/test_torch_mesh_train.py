"""The train step on a (data=2, model=2) mesh: the port on 4 ``gloo`` ranks
against the JAX package's step.

A small dense model (the reduced llama3.2-1b) and a small MoE model (the
reduced qwen3-moe with a capacity that drops nothing, so its G = 2 groups
on the mesh compute what one group does without it) take one AdamW step
under ``train_rules`` (FSDP over 'data', TP and sequence parallelism over
'model', the MoE's expert-parallel schedule), in fp32, from the JAX
package's initial weights and the pipeline's first batch (placed by the
rules: the test checks each leaf's placements). Against the reference's
unsharded ``jax.value_and_grad`` step and the port's own step with no mesh,
the loss agrees within 2e-5. The reference's sharded program rounds the
residual stream's cotangents to bf16 at every block boundary
(``shard_as_bf16_grad``), and so does the port's: with that rounding the
updated leaves agree within 2e-5 (of each leaf's largest magnitude) with
the reference's step on the same mesh (4 forced host devices in a
subprocess), and the gradient norm within the bf16 tolerance, 2e-2 (which
element of a cotangent rounds which way depends on the last bits of fp32
values, and the reduced llama's tied, unscaled embedding makes its
gradients sensitive to them). With the rounding off on both sides (the
two packages' ``shard_as_bf16_grad`` replaced by the plain ``shard_as`` in
the test's processes), the gradient norm and every updated leaf agree
within 2e-5 with the reference's mesh step, its unsharded step and the
port's step with no mesh. The donated step (AdamW in place on each
rank's shards) gives the functional step's bits. A checkpoint of the
updated state saved on (2, 2) restores bit for bit on a (4, 1) mesh and
with no mesh. Prefill and one decode step of the dense model on three
meshes give the unsharded logits within 2e-5.

Run as a script, this file is one rank of the port's side (``_rank``).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("llama3.2-1b", "qwen3-moe-30b-a3b")
BATCH, SEQ = 4, 16
TOL = 2e-5
BF16_TOL = 2e-2


def small_cfg(mod, arch: str):
    """The reduced config of ``arch`` from package ``mod``; an MoE's
    capacity factor E / k drops no token."""
    import dataclasses
    import importlib

    configs = importlib.import_module(f"{mod}.configs")
    cfg = configs.reduced_config(configs.get_arch(arch))
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.num_experts_per_tok,
                                  moe_impl="dropping_ep")
    return cfg


def shape_of(mod):
    import importlib

    return importlib.import_module(f"{mod}.configs.base").ShapeConfig("mesh_train", SEQ, BATCH, "train")


JAX_SIDE = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding
sys.path.insert(0, sys.argv[3])
from test_torch_mesh_train import ARCHS, shape_of, small_cfg
from repro.data.pipeline import SyntheticTokenPipeline
from repro.models import transformer
from repro.models.model import build_model
from repro.models.params import init_params, param_structs
from repro.sharding.specs import shard_as
bf16_grad = transformer.shard_as_bf16_grad
from repro.optim import adamw_init
from repro.sharding.specs import train_rules
from repro.training.train_step import make_train_state_defs, make_train_step
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
for arch in ARCHS:
    cfg = small_cfg("repro", arch)
    params = jax.tree.map(lambda x: x.astype(jnp.float32), build_model(cfg).init(jax.random.PRNGKey(0)))
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    for path, leaf in flat:
        out[f"{arch}/init/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)
    pipe = SyntheticTokenPipeline(cfg, shape_of("repro"), seed=0)
    batch = next(pipe)
    pipe.close()
    for name, rules in (("plain", None), ("mesh", train_rules(mesh)), ("mesh_fp32", train_rules(mesh))):
        # mesh_fp32: the residual cotangents kept in fp32 (the bf16 rounding off)
        transformer.shard_as_bf16_grad = shard_as if name == "mesh_fp32" else bf16_grad
        model = build_model(cfg, rules)
        state = {"params": params, "opt": adamw_init(params)}
        if rules is not None:
            structs = param_structs(make_train_state_defs(model), mesh, rules)
            state = jax.tree.map(lambda x, s: jax.device_put(x, s.sharding), state, structs)
        with mesh:
            new, metrics = jax.jit(make_train_step(model))(state, batch)
        out[f"{arch}/{name}/loss"] = np.asarray(metrics["loss"])
        out[f"{arch}/{name}/grad_norm"] = np.asarray(metrics["grad_norm"])
        for path, leaf in jax.tree_util.tree_flatten_with_path(new["params"])[0]:
            out[f"{arch}/{name}/new/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)
np.savez(sys.argv[2], **out)
"""


def jax_side(path_out: str) -> None:
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=4 --xla_allow_excess_precision=false",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", JAX_SIDE, "", path_out, str(ROOT / "tests")],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]


def state_from(ref: dict, arch: str, model):
    """The port's fp32 train state from the reference's initial weights."""
    from repro_torch import tree
    from repro_torch.checkpointing.manager import _flatten_with_paths
    from repro_torch.optim import adamw_init

    paths = list(_flatten_with_paths(model.param_defs))
    params = tree.unflatten(tree.flatten(model.param_defs)[1],
                            [torch.from_numpy(ref[f"{arch}/init/{p}"]) for p in paths])
    return {"params": params, "opt": adamw_init(params)}


def as_dtypes(defs, like):
    """``defs`` in the dtypes of ``like``'s leaves (the fp32 state)."""
    import dataclasses

    from repro_torch import tree

    return tree.map(lambda d, x: dataclasses.replace(d, dtype=x.dtype), defs, like)


def _rank(rank: int, world: int, path_ref: str, out_dir: str) -> None:
    """One rank: each arch's sharded step, the batch's placements, and a
    checkpoint saved on (2, 2) and restored on (4, 1)."""
    torch.set_num_threads(1)
    from repro_torch import donate, tree
    from repro_torch.checkpointing import CheckpointManager
    from repro_torch.checkpointing.manager import _flatten_with_paths
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    from repro_torch.models.params import param_structs
    from repro_torch.sharding import spmd
    from repro_torch.sharding.specs import to_named_sharding, train_rules
    from repro_torch.training.train_step import make_train_state_defs, make_train_step

    from repro_torch.models import transformer as tfm

    ref = dict(np.load(path_ref))
    mesh = make_mesh((2, 2), ("data", "model"))
    rules = train_rules(mesh)
    out = {}
    bf16_grad = tfm.shard_as_bf16_grad
    for arch, variant in [(a, v) for a in ARCHS for v in ("", "_fp32")]:
        # _fp32: the residual cotangents kept in fp32 (the bf16 rounding off)
        tfm.shard_as_bf16_grad = (lambda x, logical, rules: x) if variant else bf16_grad
        cfg = small_cfg("repro_torch", arch)
        model = build_model(cfg, rules)
        defs = make_train_state_defs(model)
        plain = state_from(ref, arch, model)
        state = tree.map(lambda x, d: spmd.distribute(x, mesh, spmd.strict_placements(d.shape, d.logical, rules,
                                                                                          mesh)), plain, defs)
        pipe = SyntheticTokenPipeline(cfg, shape_of("repro_torch"), seed=0, device="cpu", mesh=mesh, rules=rules)
        batch = next(pipe)
        pipe.close()
        for name, x in batch.items():
            assert x.placements == to_named_sharding(mesh, x.shape, ("batch", "seq", None)[:x.dim()], rules), name
        fresh = tree.map(lambda x: spmd.as_dtensor(x.to_local().clone(), mesh, x.placements, x.shape), state)
        new, metrics = make_train_step(model)(state, batch)
        with donate.donating():  # the in-place update on each rank's shards: the same bits
            donated, _ = make_train_step(model)(fresh, batch)
        assert donated is fresh
        out[f"{arch}/donated_equal{variant}"] = torch.tensor(all(
            torch.equal(a.to_local(), b.to_local()) for a, b in zip(tree.leaves(donated), tree.leaves(new))))
        out[f"{arch}/loss{variant}"] = metrics["loss"]
        out[f"{arch}/grad_norm{variant}"] = metrics["grad_norm"]
        for path, leaf in _flatten_with_paths(new["params"]).items():
            out[f"{arch}/new{variant}/{path}"] = leaf.full_tensor()
        if variant:
            continue
        ckpt = CheckpointManager(os.path.join(out_dir, f"ckpt_{arch}"))
        ckpt.save(1, new)
        mesh41 = make_mesh((4, 1), ("data", "model"))
        rules41 = train_rules(mesh41)
        like = param_structs(as_dtypes(defs, new), mesh41, rules41)
        back = ckpt.restore(like, 1, device="cpu")
        for path, leaf in _flatten_with_paths(back).items():
            assert leaf.device_mesh is mesh41
            out[f"{arch}/restored41/{path}"] = leaf.full_tensor()
    out.update(_serve(ref))
    if rank == 0:
        np.savez(os.path.join(out_dir, "torch.npz"), **{k: v.detach().numpy() for k, v in out.items()})


SERVE_MESHES = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1)}


def _serve(ref: dict) -> dict:
    """The dense model's prefill (``infer_rules``) and one decode step
    (``decode_rules``) on three meshes — the cache's heads over 'model'
    (2, 2), its sequence over 'model' with the query heads gathered (1, 4),
    its sequence over 'data' at a batch smaller than the data axis (4, 1) —
    and with no mesh: each mesh's logits and their error against none."""
    import torch.nn.functional as F

    from repro_torch import tree
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    from repro_torch.sharding import spmd
    from repro_torch.sharding.specs import decode_rules, infer_rules

    arch, b, t, s = "llama3.2-1b", 2, 16, 32
    cfg = small_cfg("repro_torch", arch)
    plain = build_model(cfg)
    params = state_from(ref, arch, plain)["params"]
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (b, t), generator=g, dtype=torch.int32)
    nxt = torch.randint(0, cfg.vocab_size, (b, 1), generator=g, dtype=torch.int32)
    cur = torch.full((b,), t, dtype=torch.int32)
    with torch.no_grad():
        want_p, cache = plain.prefill_fn(params, {"tokens": tokens})
        cache = {k: F.pad(v, (0, 0, 0, 0, 0, s - t)) for k, v in cache.items()}  # room for the new token
        want_d, _ = plain.decode_fn(params, {"tokens": nxt, "cur_len": cur}, cache)
    out = {}
    for name, shape in SERVE_MESHES.items():
        mesh = make_mesh(shape, ("data", "model"))

        def place(t_, defs, rules):
            return tree.map(lambda x, d: spmd.distribute(x, mesh, spmd.strict_placements(d.shape, d.logical, rules,
                                                                                             mesh)), t_, defs)

        with torch.no_grad():
            rules = infer_rules(mesh, kv_heads=cfg.num_kv_heads)
            model = build_model(cfg, rules)
            sh = ShapeConfig("serve", t, b, "prefill")
            got_p, _ = model.prefill_fn(place(params, model.param_defs, rules),
                                        place({"tokens": tokens}, model.input_defs(sh), rules))
            rules = decode_rules(mesh, kv_heads=cfg.num_kv_heads, batch=b)
            model = build_model(cfg, rules)
            sh = ShapeConfig("serve", s, b, "decode")
            got_d, _ = model.decode_fn(place(params, model.param_defs, rules),
                                       place({"tokens": nxt, "cur_len": cur}, model.input_defs(sh), rules),
                                       place(cache, model.cache_defs(sh), rules))
        for kind, got, want in (("prefill", got_p, want_p), ("decode", got_d, want_d)):
            out[f"serve/{name}/{kind}_err"] = (got.full_tensor() - want).abs().max() / want.abs().max()
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from repro_torch.launch.mesh import spawn

    d = tmp_path_factory.mktemp("mesh_train")
    jax_side(str(d / "jax.npz"))
    spawn(_rank, 4, str(d / "jax.npz"), str(d), store_dir=str(d))
    return d, dict(np.load(d / "jax.npz")), dict(np.load(d / "torch.npz"))


@pytest.fixture(scope="module")
def unsharded(results):
    """The port's own step with no mesh, from the same weights and batch."""
    from repro_torch.checkpointing.manager import _flatten_with_paths
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.models.model import build_model
    from repro_torch.training.train_step import make_train_step

    _, ref, _ = results
    out = {}
    for arch in ARCHS:
        cfg = small_cfg("repro_torch", arch)
        model = build_model(cfg)
        pipe = SyntheticTokenPipeline(cfg, shape_of("repro_torch"), seed=0, device="cpu")
        batch = next(pipe)
        pipe.close()
        new, metrics = make_train_step(model)(state_from(ref, arch, model), batch)
        out[f"{arch}/loss"] = metrics["loss"].numpy()
        out[f"{arch}/grad_norm"] = metrics["grad_norm"].numpy()
        out.update({f"{arch}/new/{p}": v.numpy() for p, v in _flatten_with_paths(new["params"]).items()})
    return out


def close(a, b, tol=TOL):
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale)


def new_leaves(d: dict, arch: str) -> list:
    return sorted(k for k in d if k.startswith(f"{arch}/new/"))


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_loss_matches_unsharded_steps(results, unsharded, arch):
    _, ref, got = results
    for variant in ("", "_fp32"):
        close(got[f"{arch}/loss{variant}"], ref[f"{arch}/plain/loss"])
        close(got[f"{arch}/loss{variant}"], unsharded[f"{arch}/loss"])
        close(got[f"{arch}/loss{variant}"], ref[f"{arch}/mesh/loss"])


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_grad_norm_matches(results, unsharded, arch):
    """With the bf16 cotangents, as the reference's step on the same mesh;
    with them in fp32, as every unsharded step too."""
    _, ref, got = results
    np.testing.assert_allclose(got[f"{arch}/grad_norm"], ref[f"{arch}/mesh/grad_norm"], rtol=BF16_TOL)
    np.testing.assert_allclose(got[f"{arch}/grad_norm"], unsharded[f"{arch}/grad_norm"], rtol=BF16_TOL)
    for want in (ref[f"{arch}/mesh_fp32/grad_norm"], ref[f"{arch}/plain/grad_norm"], unsharded[f"{arch}/grad_norm"]):
        np.testing.assert_allclose(got[f"{arch}/grad_norm_fp32"], want, rtol=TOL)


@pytest.mark.parametrize("against", ["jax_mesh", "jax_mesh_fp32", "jax_plain", "torch_plain"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_updated_leaves_match(results, unsharded, arch, against):
    """Every updated leaf: the bf16-cotangent step against the reference's
    on the same mesh, the fp32 one against it and every unsharded step."""
    _, ref, got = results
    variant = "" if against == "jax_mesh" else "_fp32"
    want = {"jax_plain": lambda k: ref[k.replace("/new/", "/plain/new/")],
            "jax_mesh": lambda k: ref[k.replace("/new/", "/mesh/new/")],
            "jax_mesh_fp32": lambda k: ref[k.replace("/new/", "/mesh_fp32/new/")],
            "torch_plain": lambda k: unsharded[k]}[against]
    keys = new_leaves(got, arch)
    assert keys and keys == new_leaves(unsharded, arch)
    for k in keys:
        close(got[k.replace("/new/", f"/new{variant}/")], want(k))


@pytest.mark.parametrize("variant", ["", "_fp32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_donated_step_is_bit_equal(results, arch, variant):
    """The donated step (AdamW in place on each rank's shards) gives the
    functional step's bits, params and moments."""
    _, _, got = results
    assert bool(got[f"{arch}/donated_equal{variant}"])


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_from_mesh_restores_bitwise(results, arch):
    """Saved on (2, 2): the same bits back on (4, 1) and with no mesh."""
    from repro_torch.checkpointing import CheckpointManager
    from repro_torch.checkpointing.manager import _flatten_with_paths
    from repro_torch.models.model import build_model
    from repro_torch.models.params import param_structs
    from repro_torch.training.train_step import make_train_state_defs

    d, ref, got = results
    model = build_model(small_cfg("repro_torch", arch))
    like = param_structs(as_dtypes(make_train_state_defs(model), state_from(ref, arch, model)))
    plain = CheckpointManager(str(d / f"ckpt_{arch}")).restore(like, 1, device="cpu")
    flat = _flatten_with_paths(plain["params"])
    for k in new_leaves(got, arch):
        path = k.removeprefix(f"{arch}/new/")
        assert np.array_equal(got[k].view(np.uint8), got[f"{arch}/restored41/params/{path}"].view(np.uint8)), k
        assert np.array_equal(got[k].view(np.uint8), flat[path].numpy().view(np.uint8)), k


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("mesh_name", sorted(SERVE_MESHES))
def test_mesh_serving_matches_unsharded(results, mesh_name, kind):
    """Prefill and a decode step on a mesh give the unsharded logits (the
    decode's partial softmaxes combined across the cache's sequence)."""
    _, _, got = results
    assert float(got[f"serve/{mesh_name}/{kind}_err"]) < TOL


if __name__ == "__main__":
    _rank(*map(int, sys.argv[1:3]), *sys.argv[3:])
