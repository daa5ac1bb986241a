"""The dry run on the reference's production meshes (``launch/dryrun.py
--mesh``): rank 0's program of a (16, 16) and a (2, 16, 16) mesh on meta
tensors in a fake process group, in a subprocess.

For ``llama3.2-1b decode_32k`` the per-device parameter bytes and model
FLOPs are reckoned from shapes and the strict placements, so they equal the
reference's record in ``results/dryrun.jsonl`` (read, never written); the
collectives are the port's own explicit ones, not GSPMD's, and
only have to be there. The cost analysis's ring model is checked on one
known collective of each kind.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def _run(args, tmp_path, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, *args], env=env, capture_output=True, text=True, timeout=timeout,
                          cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_dryrun")
    out = d / "dryrun_torch.jsonl"
    _run(["-m", "repro_torch.launch.dryrun", "--arch", "llama3.2-1b", "--shape", "decode_32k", "--both-meshes",
          "--out", str(out)], d)
    _run(["-m", "repro_torch.launch.dryrun", "--arch", "mamba2-370m", "--shape", "decode_32k", "--mesh",
          "pod16x16", "--out", str(out)], d)
    ref = [json.loads(line) for line in open(ROOT / "results" / "dryrun.jsonl")]
    return [json.loads(line) for line in open(out)], ref


@pytest.mark.parametrize("mesh", ["pod16x16", "pod2x16x16"])
def test_mesh_dryrun_matches_reference_shape_counts(records, mesh):
    got, ref = records
    mine = next(r for r in got if r["mesh"] == mesh and r["arch"] == "llama3.2-1b")
    theirs = next(r for r in ref if r["mesh"] == mesh and r["arch"] == "llama3.2-1b" and r["shape"] == "decode_32k")
    assert mine["status"] == "ok" and mine["n_chips"] == theirs["n_chips"]
    assert mine["params_bytes_per_device"] == theirs["params_bytes_per_device"] == 217518080
    assert mine["model_flops_per_device"] == theirs["model_flops_per_device"]
    assert mine["model_flops_global"] == theirs["model_flops_global"]
    coll = mine["collectives"]
    assert coll["total_bytes"] > 0 and coll["all-reduce"]["count"] > 0 and coll["all-reduce"]["bytes"] > 0
    assert mine["roofline"]["collective_s"] > 0
    assert mine["kernel_calls_per_device"] == {"decode_attention": 16}  # K4 once per layer, on the rank's rows
    for key in ("flops_per_device", "bytes_per_device", "memory", "hbm_per_device_gb", "useful_flops_ratio"):
        assert key in mine


def test_mesh_dryrun_skips_the_next_slice(records):
    got, _ = records
    ssm = next(r for r in got if r["arch"] == "mamba2-370m")
    assert ssm["status"] == "skipped" and "item 16" in ssm["reason"]


COUNT = r"""
import json, torch
from repro_torch.launch.cost_analysis import analyze
from repro_torch.launch.mesh import init_fake_world, make_mesh
from repro_torch.sharding import spmd
init_fake_world(8)
ctx = spmd.Ctx(make_mesh((2, 4), ("data", "model")))
def prog(x):
    a = ctx.all_gather(x, 0, ("model",))          # (16, 8) from (4, 8) over 4
    b = ctx.reduce_scatter(a, 1, ("data",))       # (16, 4) over 2
    return ctx.all_reduce(b, ("data", "model"))   # over 2, then 4
s = analyze(prog, torch.empty(4, 8, device="meta"))
print(json.dumps({"detail": s.collective_detail, "total": s.collective_bytes}))
"""


def test_cost_analysis_counts_collectives_by_the_ring_model(tmp_path):
    got = json.loads(_run(["-c", COUNT], tmp_path).strip().splitlines()[-1])
    d = got["detail"]
    assert d["all-gather"] == {"count": 1, "bytes": 16 * 8 * 4 * 3 / 4}
    assert d["reduce-scatter"] == {"count": 1, "bytes": 16 * 8 * 4 * 1 / 2}
    assert d["all-reduce"] == {"count": 2, "bytes": 2 * 16 * 4 * 4 * (1 / 2 + 3 / 4)}
    assert got["total"] == sum(v["bytes"] for v in d.values())
