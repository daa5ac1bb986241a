"""Serving launcher: deploy a model as a Provuse function chain and serve a
batched request stream, reporting per-token latency before/after the
platform's automatic fusion.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b --reduced \\
      --backend tinytorch --tokens 16 --device cpu

The counterpart of the JAX package's ``launch/serve.py``: the same flags and
the same JSON keys, plus ``device`` (the device the run used) and
``--device`` (default ``cuda``: the run raises when no CUDA device is
present and ``--device cpu`` was not given; it never falls back to the
host). ``--backend`` takes the port's backends, ``tinytorch`` and
``orchestrated``. The same draws from ``np.random.default_rng(0)`` make the
prompts: token ids for the text families, ``embeds`` of 0.02 x N(0, 1) in
bf16 for ``vlm`` and ``src_embeds`` of the same draw with a BOS token 0
for the enc-dec ``audio`` family (cast to the weights' dtype, a no-op for
the bf16 weights of :func:`serve`'s default). ``--reduced`` gives the JAX package's reduced
configuration; on the card its heads are widened to 64, the smallest head
dim the attention kernels take (``kernels/flash_attention.py``).

One default differs: ``--min-observations`` is 1 here, 2 there. The
reference's first hop over each edge compiles its callee, a wait past the
policy's ``promote_wait_s`` (50 ms) that promotes the edge and halves its
floor of 2 to 1, so each edge fuses at its first sight, the head's first.
The port's first run compiles nothing: under a floor of 2 the head's edge,
with a sub-millisecond wait, is weighed only after the inner edges'
merges have raised the measured merge cost, and was left out in some runs.
At 1 the port takes the reference's merges in the reference's order
(``tests/test_torch_launch.py``).

The JAX launcher's ``maybe_enable_from_env`` (XLA's persistent compilation
cache) has no counterpart: the port's executable index
(``launch/compile_cache.py``) lives in the process, and the only state kept
across processes is the kernel build directory.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

# Architectures of the JAX package that the port does not serve, and why.
NOT_SERVED = {
    "phi3.5-moe-42b-a6.6b": "its bf16 weights (83.7 GB) do not fit one 80 GB card, "
                            "and the port serves on one card",
}


def resolve_arch(name: str, reduced: bool = False, device="cpu"):
    """The port's config of ``name`` (reduced with ``reduced``, for a run on
    ``device``: on a CUDA device the reduced heads are widened to the
    smallest head dim the kernels take). An architecture the port does not
    register raises with the reason."""
    from repro_torch.configs import ARCHS, get_arch, reduced_config
    from repro_torch.kernels.flash_attention import HEAD_DIMS

    if name in NOT_SERVED:
        raise ValueError(f"{name} is not served by repro_torch: {NOT_SERVED[name]}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; repro_torch serves {sorted(ARCHS)}")
    cfg = get_arch(name)
    if not reduced:
        return cfg
    cfg = reduced_config(cfg)
    if torch.device(device).type == "cuda":
        cfg = dataclasses.replace(cfg, d_head=min(HEAD_DIMS))
    return cfg


def prompt_inputs(cfg, batch: int, prompt_len: int, device, dtype=torch.bfloat16) -> dict:
    """The launcher's prompts, drawn from ``np.random.default_rng(0)``:
    ``tokens`` for the text families, ``embeds`` for ``vlm`` and
    ``src_embeds`` with a BOS ``tokens`` (B, 1) of zeros for ``audio``
    (embeddings drawn in float32, rounded to bf16, then cast to
    ``dtype``)."""
    rng = np.random.default_rng(0)
    if cfg.family in ("vlm", "audio"):
        x = (rng.standard_normal((batch, prompt_len, cfg.d_model)) * 0.02).astype(np.float32)
        x = torch.from_numpy(x).to(torch.bfloat16).to(device=device, dtype=dtype)
        if cfg.family == "vlm":
            return {"embeds": x}
        return {"src_embeds": x, "tokens": torch.zeros((batch, 1), dtype=torch.int32, device=device)}
    toks = rng.integers(0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)
    return {"tokens": torch.from_numpy(toks).to(device)}


def serve(cfg, *, backend: str = "tinytorch", fusion: bool = True, batch: int = 2, prompt_len: int = 16,
          tokens: int = 16, max_len: int = 64, min_observations: int = 1, device=None,
          params=None) -> tuple[dict, torch.Tensor]:
    """Deploy ``cfg`` on a fresh platform and generate ``tokens`` greedy
    tokens for the launcher's prompts. ``params``: the model's weights (made
    from seed 0 on ``device`` when not given). Returns the launcher's record
    and the generated tokens (batch, tokens) on the host."""
    from repro_torch.core import FusionPolicy, OrchestratedBackend, TinyTorchBackend
    from repro_torch.device import resolve_device
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ServingEngine

    backends = {"tinytorch": TinyTorchBackend, "orchestrated": OrchestratedBackend}
    dev = resolve_device(device)
    model = build_model(cfg)
    policy = FusionPolicy(min_observations=min_observations, merge_cost_s=0.0, enabled=fusion)
    platform = backends[backend](policy)
    try:
        engine = ServingEngine(model, platform, max_len=max_len, params=params, device=dev)
        dtype = engine.params["embed"]["table"].dtype
        inputs = prompt_inputs(cfg, batch, prompt_len, dev, dtype)
        t0 = time.perf_counter()
        toks, lat = engine.generate(inputs, steps=tokens)
        toks = toks.cpu()
        wall = time.perf_counter() - t0
        stats = platform.stats()
    finally:
        platform.shutdown()
    merges = [m for m in stats["merges"] if m["healthy"]]
    pre = float(np.median(lat[:3])) if len(lat) >= 3 else float("nan")
    post = float(np.median(lat[-3:])) if len(lat) >= 3 else float("nan")
    record = {
        "arch": cfg.name,
        "backend": platform.backend_name,
        "fusion": fusion,
        "generated": toks[0, :8].tolist(),
        "merges": [list(m["members"]) for m in merges],
        "per_token_ms_pre": round(pre * 1e3, 2),
        "per_token_ms_post": round(post * 1e3, 2),
        "instances_left": len(stats["instances"]),
        "ram_bytes": stats["ram_bytes"],
        "billing_gb_s": round(stats["billing"]["total_gb_s"], 6),
        "wall_s": round(wall, 2),
        "device": str(dev),
    }
    return record, toks


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--backend", default="tinytorch", choices=["tinytorch", "orchestrated"])
    ap.add_argument("--no-fusion", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--min-observations", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = resolve_arch(args.arch, args.reduced, args.device)
    record, _ = serve(cfg, backend=args.backend, fusion=not args.no_fusion, batch=args.batch,
                      prompt_len=args.prompt_len, tokens=args.tokens, max_len=args.max_len,
                      min_observations=args.min_observations, device=args.device)
    print(json.dumps(record, indent=2))


if __name__ == "__main__":
    main()
