"""The MoE layer on a (data=2, model=4) mesh: the port on 8 ``gloo`` ranks
against the JAX package's ``shard_map`` schedules on 8 forced host devices.

A small MoE (E = 8, k = 2, d = 64, fp32, capacity factor 1 so that tokens
drop) goes through ``apply_moe`` under ``train_rules`` with the
expert-parallel schedule (``dropping_ep``: each 'model' rank builds its 2
experts' buffer and runs K5's plain version on it, the combine a
reduce-scatter) and the data-parallel one (``dropping``), at a batch whose
groups follow the data-parallel shards (G = 2) and at one too small for them
(G = 1: every rank computes the group from the gathered tokens). Both sides
start from the same numpy weights and input; y, ``moe_aux``, ``moe_dropped``
and the gradients of sum(y * r) with respect to x and every weight agree
within 2e-5 of their largest magnitude. The JAX side runs in a subprocess
(its host device count is fixed when JAX starts); the port's ranks are
processes of their own, met through a ``FileStore`` (no port is taken).

Run as a script, this file is one rank of the port's side (``_rank``).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
MESH = ((2, 4), ("data", "model"))
# (name, moe_impl, batch, seq): G = 2 at 4 x 16 tokens, G = 1 at 2 x 4
CASES = [("ep_groups", "dropping_ep", 4, 16), ("dp_groups", "dropping", 4, 16),
         ("ep_small", "dropping_ep", 2, 4), ("dp_small", "dropping", 2, 4)]
LEAVES = ("router", "wi_gate", "wi_up", "wo")
TOL = 2e-5


def small_cfg(mod, impl: str):
    """The reduced qwen3-moe config at E = 8, k = 2, capacity factor 1, from
    the package ``mod`` (``repro`` or ``repro_torch``)."""
    import dataclasses
    import importlib

    configs = importlib.import_module(f"{mod}.configs")
    cfg = configs.reduced_config(configs.get_arch("qwen3-moe-30b-a3b"))
    return dataclasses.replace(cfg, num_experts=8, num_experts_per_tok=2, capacity_factor=1.0, moe_impl=impl)


def inputs(seed: int = 0) -> dict:
    """Weights, inputs and the cotangent r of every case, as float32 numpy."""
    rng = np.random.default_rng(seed)
    cfg = small_cfg("repro_torch", "dropping")
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    out = {"router": rng.standard_normal((d, e)) / np.sqrt(d),
           "wi_gate": rng.standard_normal((e, d, f)) / np.sqrt(d),
           "wi_up": rng.standard_normal((e, d, f)) / np.sqrt(d),
           "wo": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    for name, _, b, t in CASES:
        out[f"{name}/x"] = rng.standard_normal((b, t, d))
        out[f"{name}/r"] = rng.standard_normal((b, t, d))
    return {k: v.astype(np.float32) for k, v in out.items()}


JAX_SIDE = r"""
import os, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding
sys.path.insert(0, sys.argv[3])
from test_torch_mesh_moe import CASES, LEAVES, MESH, small_cfg
from repro.models import moe
from repro.sharding.specs import to_named_sharding, to_pspec, train_rules
data = dict(np.load(sys.argv[1]))
mesh = jax.make_mesh(*MESH, axis_types=(jax.sharding.AxisType.Auto,) * 2)  # as launch/mesh.py
rules = train_rules(mesh)
out = {}
for name, impl, b, t in CASES:
    cfg = small_cfg("repro", impl)
    defs = moe.moe_defs(cfg)
    params = {k: jax.device_put(data[k], to_named_sharding(mesh, defs[k].shape, defs[k].logical, rules)) for k in LEAVES}
    x = jax.device_put(data[f"{name}/x"], NamedSharding(mesh, to_pspec(data[f"{name}/x"].shape, ("batch", "seq", None), rules)))
    r = jnp.asarray(data[f"{name}/r"])

    def f(params, x):
        y, m = moe.apply_moe(params, x, cfg, rules)
        return jnp.sum(y * r), (y, m)

    with mesh:
        (_, (y, m)), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(params, x)
    out[f"{name}/y"] = np.asarray(y)
    out[f"{name}/aux"] = np.asarray(m["moe_aux"])
    out[f"{name}/dropped"] = np.asarray(m["moe_dropped"])
    out[f"{name}/grad/x"] = np.asarray(gx)
    for k in LEAVES:
        out[f"{name}/grad/{k}"] = np.asarray(gp[k])
np.savez(sys.argv[2], **out)
"""


def jax_side(path_in: str, path_out: str) -> None:
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=8 --xla_allow_excess_precision=false",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", JAX_SIDE, path_in, path_out, str(ROOT / "tests")],
                          env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]


def _rank(rank: int, world: int, path_in: str, path_out: str) -> None:
    """One rank of the port's side: every case's y, metrics and gathered
    gradients (rank 0 writes them)."""
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.sharding import spmd
    from repro_torch.sharding.specs import to_placements, to_pspec, train_rules

    data = {k: torch.from_numpy(v) for k, v in np.load(path_in).items()}
    mesh = make_mesh(*MESH)
    rules = train_rules(mesh)
    out = {}
    for name, impl, b, t in CASES:
        cfg = small_cfg("repro_torch", impl)
        defs = moe.moe_defs(cfg)
        params = {k: spmd.distribute(data[k], mesh, spmd.strict_placements(defs[k].shape, defs[k].logical,
                                                                            rules, mesh)).requires_grad_()
                  for k in LEAVES}
        x_full = data[f"{name}/x"]
        pl = to_placements(to_pspec(x_full.shape, ("batch", "seq", None), rules), mesh)
        x = spmd.distribute(x_full, mesh, pl).requires_grad_()
        r = spmd.distribute(data[f"{name}/r"], mesh, pl)
        y, m = moe.apply_moe(params, x, cfg, rules)
        assert y.placements == x.placements
        # y is split over all 8 ranks, so the local sums add up to the global one
        (y.to_local() * r.to_local()).sum().backward()
        res = {"y": y.full_tensor(), "aux": m["moe_aux"], "dropped": m["moe_dropped"], "grad/x": x.grad.full_tensor()}
        res.update({f"grad/{k}": params[k].grad.full_tensor() for k in LEAVES})
        out.update({f"{name}/{k}": v.detach().numpy() for k, v in res.items()})
    if rank == 0:
        np.savez(path_out, **out)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from repro_torch.launch.mesh import spawn

    d = tmp_path_factory.mktemp("mesh_moe")
    np.savez(d / "in.npz", **inputs())
    jax_side(str(d / "in.npz"), str(d / "jax.npz"))
    spawn(_rank, 8, str(d / "in.npz"), str(d / "torch.npz"), store_dir=str(d))
    return dict(np.load(d / "jax.npz")), dict(np.load(d / "torch.npz"))


def close(a, b, tol=TOL):
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_mesh_moe_forward_matches_reference(results, case):
    ref, got = results
    close(got[f"{case}/y"], ref[f"{case}/y"])
    close(got[f"{case}/aux"], ref[f"{case}/aux"])
    np.testing.assert_allclose(got[f"{case}/dropped"], ref[f"{case}/dropped"], rtol=0, atol=1e-7)


@pytest.mark.parametrize("leaf", ("x", *LEAVES))
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_mesh_moe_gradients_match_reference(results, case, leaf):
    ref, got = results
    close(got[f"{case}/grad/{leaf}"], ref[f"{case}/grad/{leaf}"])


def test_mesh_moe_cases_drop_and_group():
    """The cases reach what they are for: G = 2 groups at the large batch and
    1 at the small, and a capacity that drops tokens."""
    from repro_torch.models import moe
    from repro_torch.sharding.specs import train_rules

    rules = train_rules(dict(zip(MESH[1], MESH[0])))
    cfg = small_cfg("repro_torch", "dropping_ep")
    assert [moe.num_groups(b * t, b, cfg, rules) for _, _, b, t in CASES] == [2, 2, 1, 1]


def test_mesh_moe_drops_tokens(results):
    _, got = results
    assert all(float(got[f"{c[0]}/dropped"]) > 0 for c in CASES[:2])


if __name__ == "__main__":
    _rank(*map(int, sys.argv[1:3]), *sys.argv[3:])
