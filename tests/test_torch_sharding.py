"""The port's sharding rules (``repro_torch/sharding/specs.py``) against the
JAX package's.

Every test of tests/test_sharding.py, against the port; then, for every
architecture's parameter, input and cache defs, under ``train_rules``,
``infer_rules`` and ``decode_rules`` (each config's ``num_kv_heads``, each
shape's batch) on both production meshes' axis sizes, the port's
``to_pspec`` equals the reference's entry by entry, strict and lenient
(pure functions: no devices). Then placements: on 8 ``gloo`` ranks, each
rank's local shape and offset of a few leaves (dims over ('pod', 'data')
among them) equal JAX's ``NamedSharding.devices_indices_map`` on 8 forced
host devices (a subprocess) for a (2, 4) and a (2, 2, 2) mesh, and each
rank's shard holds the global tensor's values there; ``shard_as``
redistributes a ``DTensor`` to the lenient placements.

Run as a script, this file is one rank of the port's side (``_rank``).
"""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.sharding import specs  # noqa: E402
from repro_torch.sharding.specs import LogicalRules  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PRODUCTION = {"pod16x16": {"data": 16, "model": 16}, "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}


def rules_16x16(extra=None):
    base = {
        "batch": ("data",),
        "seq": "model",
        "heads": "model",
        "kv_heads": "model",
        "embed_fsdp": ("data",),
        "vocab": "model",
    }
    if extra:
        base.update(extra)
    return LogicalRules(base, {"data": 16, "model": 16})


# ------------------------------------------------- tests/test_sharding.py


def test_strict_drops_uneven_axes():
    r = rules_16x16()
    assert r.spec_entry("vocab", 50280, strict=True) is None
    assert r.spec_entry("vocab", 151936, strict=True) == "model"
    assert r.spec_entry("vocab", 50280, strict=False) == "model"


def test_heads_uneven_dropped_strict():
    r = rules_16x16()
    assert r.spec_entry("heads", 24, strict=True) is None   # starcoder2
    assert r.spec_entry("heads", 32, strict=True) == "model"


def test_no_duplicate_mesh_axes_in_spec():
    r = rules_16x16({"a": "model", "b": "model"})
    spec = specs.to_pspec((32, 32), ("a", "b"), r)
    flat = [ax for e in spec if e for ax in ((e,) if isinstance(e, str) else e)]
    assert len(flat) == len(set(flat))


@pytest.mark.parametrize("kv", [1, 2, 4, 8, 16, 32, 64])
def test_cache_rules_always_shard_somewhere(kv):
    sizes = {"data": 16, "model": 16}
    r = LogicalRules({**specs._cache_rules(sizes, kv)}, sizes)
    head_entry = r.spec_entry("cache_kv_heads", kv, strict=True)
    seq_entry = r.spec_entry("cache_seq", 32768, strict=True)
    assert head_entry is not None or seq_entry is not None
    assert (head_entry == "model") == (kv % 16 == 0 and kv >= 16)


def test_rules_fsdp_policy():
    """Train + prefill keep FSDP params; decode is TP-only (latency). The
    reference takes its one-device smoke mesh: a (1, 1) mesh's sizes."""
    sizes = {"data": 1, "model": 1}
    assert specs.train_rules(sizes).rules["embed_fsdp"] is not None
    assert specs.infer_rules(sizes).rules["embed_fsdp"] is not None
    assert specs.decode_rules(sizes, kv_heads=8, batch=128).rules["embed_fsdp"] is None


# ------------------------------------------------- every def vs the reference


def _jax_mesh_stub(sizes: dict):
    """What the reference's rule builders read of a Mesh: its axis names and
    device grid's shape."""
    return types.SimpleNamespace(axis_names=tuple(sizes), devices=np.empty(tuple(sizes.values())))


def _leaves_with_logical(defs, is_def):
    out = []

    def walk(node, path):
        if is_def(node):
            out.append(("/".join(path), node))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], (*path, str(k)))

    walk(defs, ())
    return out


@pytest.mark.parametrize("mesh_name", sorted(PRODUCTION))
@pytest.mark.parametrize("arch", ["chameleon-34b", "granite-34b", "llama3.2-1b", "mamba2-370m", "phi3.5-moe-42b-a6.6b",
                                  "qwen3-moe-30b-a3b", "seamless-m4t-medium", "stablelm-1.6b", "starcoder2-3b",
                                  "zamba2-7b"])
def test_to_pspec_matches_reference_for_every_def(arch, mesh_name):
    from repro.configs import SHAPES as jshapes
    from repro.configs import get_arch as jget_arch
    from repro.models.model import build_model as jbuild
    from repro.models.params import is_def as jis_def
    from repro.sharding import specs as jspecs
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.models.model import build_model
    from repro_torch.models.params import is_def

    sizes = PRODUCTION[mesh_name]
    jmodel, model = jbuild(jget_arch(arch)), build_model(get_arch(arch))
    kv = get_arch(arch).num_kv_heads or None
    checked = 0
    for shape_name, shape in SHAPES.items():
        jshape = jshapes[shape_name]
        rules = {"train": (specs.train_rules(sizes), jspecs.train_rules(_jax_mesh_stub(sizes))),
                 "infer": (specs.infer_rules(sizes, kv_heads=kv),
                           jspecs.infer_rules(_jax_mesh_stub(sizes), kv_heads=kv)),
                 "decode": (specs.decode_rules(sizes, kv_heads=kv, batch=shape.global_batch),
                            jspecs.decode_rules(_jax_mesh_stub(sizes), kv_heads=kv, batch=jshape.global_batch))}
        trees = [("params", model.param_defs, jmodel.param_defs),
                 ("inputs", model.input_defs(shape), jmodel.input_defs(jshape))]
        if shape.kind == "decode":
            trees.append(("cache", model.cache_defs(shape), jmodel.cache_defs(jshape)))
        for kind, (r, jr) in rules.items():
            for name, t, jt in trees:
                ours, theirs = _leaves_with_logical(t, is_def), _leaves_with_logical(jt, jis_def)
                assert [p for p, _ in ours] == [p for p, _ in theirs], (name, shape_name)
                for (path, d), (_, jd) in zip(ours, theirs):
                    assert d.shape == jd.shape and d.logical == jd.logical, (name, path)
                    for strict in (True, False):
                        got = specs.to_pspec(d.shape, d.logical, r, strict=strict)
                        want = tuple(jspecs.to_pspec(jd.shape, jd.logical, jr, strict=strict))
                        assert got == want, (kind, shape_name, name, path, strict)
                        checked += 1
    assert checked > 100


def test_to_placements_follows_the_mesh():
    from torch.distributed.tensor import Replicate, Shard

    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert specs.to_placements((("pod", "data"), "model", None), mesh) == (Shard(0), Shard(0), Shard(1))
    assert specs.to_placements((None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        specs.to_placements((("data", "pod"),), mesh)


def test_shard_as_bf16_grad_rounds_the_cotangent():
    r = specs.train_rules({"data": 2, "model": 2})
    x = torch.tensor([1.0 + 2 ** -12, 3.0], requires_grad=True)
    assert specs.shard_as(x, ("batch",), r) is x and specs.shard_as_bf16_grad(x, ("batch",), None) is x
    y = specs.shard_as_bf16_grad(x, ("batch",), r)
    y.backward(torch.tensor([1.0 + 2 ** -12, 0.5]))
    assert x.grad.tolist() == [1.0, 0.5]  # 1 + 2^-12 is not a bf16 value


# ------------------------------------------------- placements vs devices_indices_map

MESHES = {"2x4": ((2, 4), ("data", "model")), "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
# (name, shape, logical, rules): leaves whose dims cover ('pod', 'data'),
# 'model', both, and a cache sequence over every axis
LEAVES = [
    ("wq", (64, 8, 16), ("embed_fsdp", "heads", "head_dim"), "train"),
    ("table", (256, 64), ("vocab", "embed_fsdp"), "train"),
    ("tokens", (8, 32), ("batch", "seq"), "train"),
    ("experts", (8, 64, 32), ("experts", "embed_fsdp", "expert_ff"), "train"),
    ("cache", (2, 2, 64, 1, 16), ("layers", "batch", "cache_seq", "cache_kv_heads", "head_dim"), "decode"),
]


def _rules(module, mesh, kind):
    if kind == "decode":  # MQA at a batch smaller than the data axes: the cache's sequence over every axis
        return module.decode_rules(mesh, kv_heads=1, batch=2)
    return module.train_rules(mesh)


JAX_SIDE = r"""
import json, sys
import numpy as np
import jax
from jax.sharding import NamedSharding
sys.path.insert(0, sys.argv[2])
from test_torch_sharding import LEAVES, MESHES, _rules
from repro.sharding import specs
out = {}
for mname, (shape, axes) in MESHES.items():
    mesh = jax.make_mesh(shape, axes, axis_types=(jax.sharding.AxisType.Auto,) * len(axes))
    for name, gshape, logical, kind in LEAVES:
        idx = NamedSharding(mesh, specs.to_pspec(gshape, logical, _rules(specs, mesh, kind), strict=True)).devices_indices_map(gshape)
        for coord in np.ndindex(*shape):
            sl = idx[mesh.devices[coord]]
            out[f"{mname}/{name}/{list(coord)}"] = [[s.indices(n)[0] for s, n in zip(sl, gshape)],
                                                    [len(range(*s.indices(n))) for s, n in zip(sl, gshape)]]
json.dump(out, open(sys.argv[1], "w"))
"""


def _rank(rank: int, world: int, out_dir: str) -> None:
    """One rank: its local shape and offset of every leaf on both meshes,
    checked against the global tensor's values, and shard_as's placements."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import spmd

    out = {}
    for mname, (shape, axes) in MESHES.items():
        mesh = make_mesh(shape, axes)
        coord = list(mesh.get_coordinate())
        for name, gshape, logical, kind in LEAVES:
            rules = _rules(specs, mesh, kind)
            full = torch.arange(int(np.prod(gshape)), dtype=torch.float32).reshape(gshape)
            dt = spmd.distribute(full, mesh, spmd.strict_placements(gshape, logical, rules, mesh))
            local = dt.to_local()
            from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

            lshape, offset = compute_local_shape_and_global_offset(gshape, mesh, list(dt.placements))
            want = full
            for d, (n, o) in enumerate(zip(lshape, offset)):
                want = want.narrow(d, o, n)
            assert tuple(local.shape) == tuple(lshape) and torch.equal(local, want), (mname, name)
            assert torch.equal(dt.full_tensor(), full)
            out[f"{mname}/{name}/{coord}"] = [list(offset), list(lshape)]
        # shard_as: a replicated DTensor to the lenient placements of its logical axes
        rules = specs.train_rules(mesh)
        x = spmd.distribute(torch.randn(8, 32, 4, generator=torch.Generator().manual_seed(0)), mesh,
                            specs.to_placements((None, None, None), mesh))
        y = specs.shard_as(x, ("batch", "seq", None), rules)
        assert y.placements == specs.to_placements(specs.to_pspec(y.shape, ("batch", "seq", None), rules), mesh)
        assert torch.equal(y.full_tensor(), x.full_tensor())
    gathered = [None] * world
    dist.all_gather_object(gathered, out)
    if rank == 0:
        merged = {k: v for part in gathered for k, v in part.items()}
        with open(os.path.join(out_dir, "torch.json"), "w") as f:
            json.dump(merged, f)


@pytest.fixture(scope="module")
def placements(tmp_path_factory):
    from repro_torch.launch.mesh import spawn

    d = tmp_path_factory.mktemp("sharding")
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", JAX_SIDE, str(d / "jax.json"), str(ROOT / "tests")], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    spawn(_rank, 8, str(d), store_dir=str(d))
    return json.load(open(d / "jax.json")), json.load(open(d / "torch.json"))


@pytest.mark.parametrize("leaf", [name for name, *_ in LEAVES])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_local_shards_match_devices_indices_map(placements, mesh_name, leaf):
    jax_map, torch_map = placements
    keys = sorted(k for k in jax_map if k.startswith(f"{mesh_name}/{leaf}/"))
    assert len(keys) == 8 and keys == sorted(k for k in torch_map if k.startswith(f"{mesh_name}/{leaf}/"))
    for k in keys:
        assert torch_map[k] == jax_map[k], k


def test_leaves_cover_pod_and_data():
    """The placement cases reach a dim split over ('pod', 'data') and one over
    every axis of the (2, 2, 2) mesh."""
    sizes = {"pod": 2, "data": 2, "model": 2}
    got = {name: specs.to_pspec(shape, logical, _rules(specs, sizes, kind), strict=True)
           for name, shape, logical, kind in LEAVES}
    assert got["wq"][0] == ("pod", "data") and got["cache"][2] == ("pod", "data", "model")


if __name__ == "__main__":
    _rank(*map(int, sys.argv[1:3]), *sys.argv[3:])
