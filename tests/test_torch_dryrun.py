"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's (``tests/test_dryrun.py``): the shapes and their skips, the
parameter and model-FLOP counts of every cell, one cell's record, and the
cells that cannot fit one card. ``repro.launch.dryrun`` sets XLA_FLAGS to
512 host devices when imported, so it runs only in a subprocess here."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import applicable_shapes as jax_applicable  # noqa: E402
from repro.configs import shape_skip_reason as jax_skip  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.models.params import param_count as jax_param_count  # noqa: E402

from repro_torch.configs import ARCHS, SHAPES, applicable_shapes, get_arch, get_shape, shape_skip_reason  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.params import is_def, map_defs, param_count  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}

# the reference's counts of every (arch, shape), printed by a subprocess
REFERENCE_COUNTS = """
import json
from repro.configs import ARCHS, SHAPES, get_shape
from repro.launch import dryrun
out = {}
for arch, cfg in ARCHS.items():
    total, active = dryrun.count_params(cfg)
    out[arch] = {"params": [total, active],
                 "model_flops": {s: dryrun.model_flops(cfg, get_shape(s))
                                 for s in SHAPES}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_counts():
    proc = subprocess.run([sys.executable, "-c", REFERENCE_COUNTS], capture_output=True, text=True, timeout=600,
                          env=ENV, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_every_reference_arch_and_shape_is_registered():
    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    assert {k: vars(v) for k, v in SHAPES.items()} == {k: vars(v) for k, v in JAX_SHAPES.items()}
    assert [get_shape(s).name for s in SHAPES] == list(SHAPES)
    assert sorted((a, s) for a, s in dryrun.all_cells()) == sorted((a, s) for a in JAX_ARCHS for s in JAX_SHAPES)


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_long_500k_skips_full_attention_archs(arch):
    """tests/test_dryrun.py::test_long_500k_skips_full_attention_archs for
    every arch: the same applicable shapes and the same skip reasons."""
    cfg = get_arch(arch)
    assert applicable_shapes(cfg) == jax_applicable(JAX_ARCHS[arch])
    for shape in SHAPES:
        assert shape_skip_reason(cfg, shape) == jax_skip(JAX_ARCHS[arch], shape)
    assert cfg.sub_quadratic == JAX_ARCHS[arch].sub_quadratic
    assert cfg.attention_free == JAX_ARCHS[arch].attention_free


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_param_count_is_the_references(arch):
    defs = build_model(get_arch(arch)).param_defs
    assert param_count(defs) == jax_param_count(jax_build_model(JAX_ARCHS[arch]).param_defs)
    # map_defs keeps the tree; every leaf a def
    doubled = map_defs(lambda d: d, defs)
    assert param_count(doubled) == param_count(defs)
    assert is_def(next(iter(doubled["ln_f"].values())))


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_count_params_and_model_flops_are_the_references(arch, reference_counts):
    cfg = get_arch(arch)
    want = reference_counts[arch]
    assert list(dryrun.count_params(cfg)) == want["params"]
    assert {s: dryrun.model_flops(cfg, get_shape(s)) for s in SHAPES} == want["model_flops"]


def run_cli(*args, timeout=600):
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args], capture_output=True,
                          text=True, timeout=timeout, env=ENV, cwd=ROOT)


def test_llama_decode_cell_on_one_card(tmp_path):
    """tests/test_dryrun.py::test_llama_decode_cell_production_mesh on one
    card: the record's roofline terms are coherent."""
    out = tmp_path / "cells.jsonl"
    proc = run_cli("--arch", "llama3.2-1b", "--shape", "decode_32k", "--out", str(out))
    assert proc.returncode == 0, proc.stderr[-2000:]
    r = json.loads(proc.stdout)
    assert r == json.loads(out.read_text().splitlines()[-1])
    assert r["status"] == "ok" and r["mesh"] == "h100x1" and r["n_chips"] == 1
    assert r["fits_card"], f"HBM {r['hbm_per_device_gb']} GiB over the card"
    rf = r["roofline"]
    assert rf["bound_s"] > 0 and rf["collective_s"] == 0.0
    assert rf["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0 and r["memory"]["peak_bytes"] > 0
    assert 0 < r["useful_flops_ratio"] < 4
    # the step's batch divides the global batch; the cache is updated in place (donated)
    assert 128 % r["batch_per_step"] == 0 and r["steps"] * r["batch_per_step"] == 128
    mem = r["memory"]
    assert mem["peak_bytes"] < mem["param_bytes"] + 1.1 * mem["cache_bytes"]
    assert r["kernel_calls_per_step"] == {"decode_attention": 16}


def test_execute_without_a_card_raises(tmp_path):
    proc = run_cli("--arch", "llama3.2-1b", "--shape", "decode_32k", "--out", str(tmp_path / "x.jsonl"),
                   "--execute", "--device", "cpu")
    assert proc.returncode != 0 and "runs on the card" in proc.stderr
    if not torch.cuda.is_available():
        proc = run_cli("--arch", "llama3.2-1b", "--shape", "decode_32k", "--out", str(tmp_path / "y.jsonl"),
                       "--execute")
        assert proc.returncode != 0 and "CUDA" in proc.stderr


def test_skipped_cell_has_the_references_reason(tmp_path):
    r = dryrun.run_cell("llama3.2-1b", "long_500k", str(tmp_path / "s.jsonl"))
    assert r["status"] == "skipped" and r["reason"] == jax_skip(JAX_ARCHS["llama3.2-1b"], "long_500k")


@pytest.mark.parametrize("arch,shape", [("zamba2-7b", "long_500k"), ("phi3.5-moe-42b-a6.6b", "decode_32k")])
def test_cells_that_do_not_fit_one_card(arch, shape):
    """zamba2-7b's 13 shared-attention caches of 524,288 rows and
    phi3.5-moe-42b-a6.6b's 83.7 GB of bf16 weights exceed the H100's 85.0 GB
    at batch 1."""
    r = dryrun.run_cell(arch, shape)
    assert r["status"] == "ok" and not r["fits_card"] and r["batch_per_step"] == 1
    assert r["memory"]["peak_bytes"] + dryrun.RESERVE_BYTES > dryrun.HW["hbm_bytes"]
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0


def test_batch_search_takes_the_largest_batch_that_fits():
    """The peak is affine in the batch for a decode cell; the chosen batch
    fits, the next one up would not."""
    cell = dryrun.Cell("llama3.2-1b", "decode_32k")
    limit = 40e9
    batch, s, fits, _ = dryrun.choose_batch(cell, limit)
    assert fits and s.peak_bytes + dryrun.RESERVE_BYTES <= limit
    bigger = [b for b in cell.batches() if b > batch][0]
    assert cell.run(cell.meta_args(bigger)).peak_bytes + dryrun.RESERVE_BYTES > limit


# ------------------------------------------------ chip_smoke's long checks


@pytest.fixture(scope="module")
def smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_long_attention_check_refuses_an_eighth_of_the_keys_dropped(smoke):
    """chip_smoke.py's ``long_kernels`` check of K3's tail and K4 at an
    eighth of its length (S = 4096) on the CPU: bf16 attention passes the
    per-row check against fp32 attention, and the same rows over the first
    7/8 of the keys fail it."""
    from repro_torch.kernels import ref

    g = torch.Generator().manual_seed(0)
    s, tail, h, kv, hd = 4096, 64, 8, 2, 64
    q, k, v = (torch.randn(1, n, m, hd, generator=g) for n, m in ((tail, h), (s, kv), (s, kv)))
    want = ref.mha_ref(q, k, v, q_offset=s - tail)
    got = ref.mha_ref(*(x.to(torch.bfloat16) for x in (q, k, v)), q_offset=s - tail)
    fault = ref.mha_ref(q, k[:, : s - s // 8], v[:, : s - s // 8], q_offset=s - tail)
    assert smoke.row_rel_err(torch, got, want) <= smoke.RTOL < smoke.row_rel_err(torch, fault, want)


def test_long_ssd_check_refuses_a_dropped_state(smoke):
    """chip_smoke.py's ``long_kernels`` check of K6 at T = 2048 on the CPU,
    on its draws: the chunked scan against the exact dual form passes it
    (y and the final state within 2e-2 of their max), and the same scan
    with the state dropped every 256 positions fails it."""
    from repro_torch.kernels import ref
    from repro_torch.models import ssm

    g = torch.Generator().manual_seed(0)
    t, h, p, n, every = 2048, 4, 64, 128, 256
    x = torch.randn(1, t, h, p, generator=g).to(torch.bfloat16).float()
    bm, cm = ((torch.randn(1, t, 1, n, generator=g) * 0.5).to(torch.bfloat16).float() for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn(1, t, h, generator=g))
    a_log, d_skip = torch.randn(h, generator=g) * 0.3, torch.ones(h)

    def chunked(lo, hi):
        return ssm.ssd_chunked(x[:, lo:hi], bm[:, lo:hi], cm[:, lo:hi], dt[:, lo:hi], a_log, d_skip, 64,
                               init_state=torch.zeros(1, h, p, n))

    y_want, state_want = ref.ssd_ref(x, bm, cm, dt, a_log, d_skip)
    y, state = chunked(0, t)
    assert max(smoke.rel_err(y, y_want), smoke.rel_err(state, state_want)) <= smoke.RTOL
    fault = torch.cat([chunked(lo, lo + every)[0] for lo in range(0, t, every)], 1)
    assert smoke.rel_err(fault, y_want) > smoke.RTOL
