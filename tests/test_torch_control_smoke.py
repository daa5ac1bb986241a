"""chip_smoke.py's control-plane phases rehearsed at a tiny size on the CPU:
``orchestrated_serve`` (the serve phase and the batched main path through
``OrchestratedBackend``'s pods, tokens identical to ``TinyTorchBackend``'s),
``replicas`` (``load_bench``'s replicas gate through the port, and the fused
chain with a second replica), ``churn`` (``load_bench``'s churn: a fused
pair that saturates is split) and ``split`` (``Merger.split`` of the fused
chain and its re-merge). The same control flow and checks as on the card,
but for those only a device can give: memory, graph captures, and the
throughput gates (the ratios are reported here)."""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # the suite runs several workers at once: leave them cores

from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
PROMPTS = (5, 9, 12)
SMALL = dict(prompt_lens=PROMPTS, new_tokens=4, max_len=32)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def llama():
    cfg = reduced_config(get_arch("llama3.2-1b"))
    return cfg, build_model(cfg).init(0, device=CPU)


def test_orchestrated_serve_phase_rehearsal(smoke, llama):
    from repro_torch.launch.compile_cache import EXECUTABLE_INDEX

    # the index is process-wide: a chain another test of this worker served
    # would be an index hit, with no fused-inline event for the trace checks
    EXECUTABLE_INDEX.clear()
    cfg, params = llama
    tokens: list = []
    tiny = smoke.serve_phase(torch, CPU, cfg, tokens_out=tokens, **SMALL)
    out = smoke.orchestrated_phase(torch, CPU, cfg, params, tiny, tokens, serve_kw=SMALL,
                                   batched_kw=dict(clients=4, prompt_len=5, warmup=2, steps=3, max_len=32))
    serve, batched = out["serve"], out["batched"]
    assert serve["backend"] == "orchestrated" and serve["tokens_identical_to_tinytorch"]
    assert serve["live_instances"] == {"unfused": 4, "fused": 1}
    assert serve["pods"]["unfused"]["pods"] == 4 and serve["pods"]["fused"]["pods"] == 1
    assert serve["pods"]["fused"]["retired_pods_exited"] >= 4  # the originals of every merge
    assert serve["trace"]["unfused"]["conserved"] and serve["trace"]["fused"]["conserved"]
    assert batched["backend"] == "orchestrated" and batched["max_batch_seen"] >= 2
    assert batched["decode_attention_launches"] == batched["layers"] * batched["decode_program_runs"]
    assert max(batched["lane_rel_err"]) <= smoke.LANE_TOL


def test_replicas_phase_rehearsal(smoke, llama):
    cfg, params = llama
    out = smoke.replicas_phase(torch, CPU, cfg, params, scenario_kw=dict(duration=1.0, ramp=1.0, gate=False),
                               unit_kw=dict(prompt_lens=(5, 9), new_tokens=4, max_len=32))
    scenario, unit = out["scenario"], out["fused_unit"]
    assert scenario["peak_replicas"] >= 2 and scenario["scale_outs_warm"]
    assert scenario["dispatch_window"]["entries"] == 0 and scenario["scale_ins"] >= 1
    assert sum(n > 0 for n in scenario["picks"].values()) >= 2
    assert scenario["single_instance"]["strict_requests"] > 0 and scenario["speedup"] > 0
    assert unit["tokens_identical"] and unit["replicas"] == 2 and unit["scale_out_warm"]
    assert unit["spinup_canary_runs"] == len(unit["chain"]) and unit["spinup_window"]["entries"] == 0
    assert unit["pods"]["pods"] == 2  # one unit and its replica


def test_churn_phase_rehearsal(smoke):
    out = smoke.churn_phase(torch, CPU, width=64, rows=8, duration=1.0, target_batch_s=0.01, gate=False)
    assert out["split_epoch"] > out["merge_epoch"] and out["split_reason"]
    assert out["failed"] == 0 and out["hung"] == 0 and out["requests"] > 0
    assert out["pods"]["pods"] == 2 and out["pods"]["retired_pods_exited"] >= 1


def test_split_phase_rehearsal(smoke, llama):
    cfg, params = llama
    out = smoke.split_phase(torch, CPU, cfg, params, **SMALL)
    assert out["healthy"] and out["tokens_identical"] and out["remerge_warm"]
    assert out["cells"] == [sorted(out["chain"][:2]), sorted(out["chain"][2:])]
    assert out["checked_members"] and set(out["checked_members"]) <= set(out["chain"][2:])
    assert "recently split" in out["refused_reason"]
    assert out["remerge_window"]["entries"] == 0
    assert out["pods"]["pods"] == 1
