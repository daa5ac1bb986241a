"""Whether the in-place training step changes what full-width
qwen3-moe-30b-a3b learns: ``chip_smoke.py``'s ``moe_train`` setting (T =
4096, a batch of 4 as 2 microbatches, the affine stream of seed 0, AdamW
with the launcher's cosine schedule, remat) at 2 layers and lr 1e-3, where
the functional step fits the card, run twice from the same initial state:
every step functional (``train_step`` returns a new state), then every step
donated (``donate.donating()``: AdamW in place). Both under
``torch.use_deterministic_algorithms``, so that a sum has one order. Prints
one JSON line: each run's losses and grad norms, whether they and the final
params and moments are equal bit for bit, and each run's peak memory.

Run from the repository root on the card:

    python3 tools/probes/moe_donated.py
"""
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # cuBLAS's deterministic workspace

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import donate, tree  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import SyntheticTokenPipeline  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import AdamWConfig, cosine_schedule  # noqa: E402
from repro_torch.training.train_step import init_train_state, make_train_step  # noqa: E402

ARCH = "qwen3-moe-30b-a3b"
LAYERS, LR, STEPS = 2, 1e-3, cs.FAMILY_TRAIN_STEPS


def run(cfg, shape, donated: bool):
    """STEPS steps from seed 0's state; (history, final state, peak GB)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    step = make_train_step(model, AdamWConfig(lr=LR), cosine_schedule(LR, max(1, STEPS // 10), STEPS))
    state = init_train_state(model, 0, device=torch.device("cuda"))
    data = SyntheticTokenPipeline(cfg, shape, seed=0, mode="affine", start_batch=0, device=torch.device("cuda"))
    hist = []
    for _ in range(STEPS):
        with donate.donating(donated):
            state, metrics = step(state, next(data))
        hist.append({k: float(metrics[k]) for k in ("loss", "grad_norm")})
    data.close()
    torch.cuda.synchronize()
    return hist, state, torch.cuda.max_memory_allocated() / 1e9


def main() -> None:
    import dataclasses

    print(cs.device_line(), flush=True)
    build.load()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(cs.family_config(ARCH, LAYERS), microbatches=cs.FAMILY_TRAIN_MICRO)
    shape = ShapeConfig("train_4k on one card", cs.TRAIN_SEQ, cs.FAMILY_TRAIN_BATCH, "train")
    torch.use_deterministic_algorithms(True)
    h_fun, s_fun, peak_fun = run(cfg, shape, donated=False)
    s_fun = tree.map(lambda x: x.cpu(), s_fun)  # the functional run's final state, off the card
    h_don, s_don, peak_don = run(cfg, shape, donated=True)
    same = all(torch.equal(a.cpu(), b) for a, b in zip(tree.leaves(s_don), tree.leaves(s_fun)))
    first, last = (sum(h["loss"] for h in h_don[i]) / len(h_don[i]) for i in (slice(0, 3), slice(-3, None)))
    print(json.dumps({"arch": ARCH, "layers": LAYERS, "lr": LR, "steps": STEPS,
                      "history_equal": h_fun == h_don, "final_state_equal": same,
                      "functional": h_fun, "donated": h_don, "first3_mean_loss": first, "last3_mean_loss": last,
                      "peak_gb": {"functional": peak_fun, "donated": peak_don}}), flush=True)


if __name__ == "__main__":
    main()
