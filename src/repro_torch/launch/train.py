"""Training launcher (the JAX package's ``launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --reduced \\
      --steps 200 --batch 8 --seq 128 --device cpu

The same flags and the same JSON line as the reference, plus ``device``
(the device the run used) and ``--device`` (default ``cuda``: the run raises
when no CUDA device is present and ``--device cpu`` was not given; it never
falls back to the host). ``--reduced`` gives the JAX package's reduced
configuration; on the card its heads are widened to 64, the smallest head
dim the attention kernels take. Checkpoints go under ``--ckpt-dir`` (by
default ``repro_torch_ckpt`` in the temporary directory); a run restores the
latest checkpoint it finds there, as the reference's does. The run hands
its state to the loop (``donate.donating()``), so AdamW updates it in place
from the first step and the card holds one training state.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true", help="tiny same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mode", default="affine", choices=["affine", "random"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu; never falls back")
    args = ap.parse_args(argv)

    import dataclasses

    from repro_torch import donate
    from repro_torch.checkpointing import CheckpointManager
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.device import resolve_device
    from repro_torch.launch.serve import resolve_arch
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamWConfig, cosine_schedule
    from repro_torch.training import TrainLoop
    from repro_torch.training.train_step import init_train_state, make_train_step

    dev = resolve_device(args.device)
    cfg = resolve_arch(args.arch, args.reduced, dev)
    if args.microbatches > 1:
        cfg = dataclasses.replace(cfg, microbatches=args.microbatches)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    model = build_model(cfg)
    step_fn = make_train_step(
        model, AdamWConfig(lr=args.lr), cosine_schedule(args.lr, max(1, args.steps // 10), args.steps)
    )
    state = init_train_state(model, 0, device=dev)
    manager = CheckpointManager(args.ckpt_dir, retain=3, async_save=True)
    loop = TrainLoop(
        step_fn,
        lambda start: SyntheticTokenPipeline(cfg, shape, seed=0, mode=args.mode, start_batch=start, device=dev),
        manager,
        ckpt_every=args.ckpt_every,
    )
    t0 = time.perf_counter()
    with donate.donating():  # the launcher keeps no other use for its state: every step updates it in place
        state, history = loop.run(state, args.steps)
    wall = time.perf_counter() - t0
    for h in history[:: args.log_every]:
        print(f"step {h['step']:5d} loss {h['loss']:.4f} {h['seconds']*1e3:.0f}ms")
    tokens = args.steps * args.batch * args.seq
    print(json.dumps({
        "arch": cfg.name, "steps": args.steps, "wall_s": round(wall, 1),
        "tokens_per_s": round(tokens / wall, 1),
        "final_loss": round(history[-1]["loss"], 4),
        "first_loss": round(history[0]["loss"], 4),
        "stragglers": len(loop.straggler_events),
        "device": dev.type,
    }))


if __name__ == "__main__":
    main()
