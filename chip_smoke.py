#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failed check exits non-zero and prints no result):

1. Device line: the card's name and power limit from ``nvidia-smi``; then
   the hand-written kernels are built from ``src/repro_torch/kernels/csrc``.
2. Kernel phase: K3 ``flash_attention`` and K4 ``decode_attention`` at the
   serving chain's shapes, each held against its plain PyTorch version at
   rtol = atol = 2e-2 and timed with CUDA events (median of 21 samples of
   10 back-to-back calls, after warm-up) beside its plain version, one
   ``scaled_dot_product_attention`` call on the same inputs (a yardstick
   only; the port never calls it) and the least time the card could take
   (``bound_ms``).
3. Serve phase: full-width ``llama3.2-1b`` (16 layers, random bf16 weights
   from a fixed seed) deployed as the six-function chain on an unfused and a
   fusing ``TinyTorchBackend`` sharing the same weights; three prompts
   (37, 128, 300 tokens) generate 16 greedy tokens each, the two platforms
   taking turns; the first prompt (warm-up and the merges) is not timed.
   Checks: 6 live instances unfused, 1 fused with a healthy merge, identical
   tokens on both platforms and against the model run without the
   platform, and that the main path launched K3 and K4 and never called
   their plain versions.
4. Reference phase: the card against the host's CPU (plain versions, the
   same bf16 weights). A small input — llama3.2-1b cut to 2 layers of width
   256 (head dim 64, which the kernels take) — must give the same prefill
   and decode logits within 2e-2 of max |logit|; at full width each
   block's contribution on the same input must agree within 5e-2, and how
   far bf16 rounding alone carries the end-to-end logits is reported.
5. Profile phase: where a fused decode step's time goes — the host's wall
   clock against the device's kernel time (``torch.profiler``) — and its
   ten costliest kernels.

Standard output opens with the device line; its last five lines are the
``serve``, ``reference``, ``profile`` and ``kernels`` JSON lines and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Datasheet peaks of the H100 SXM (dense bf16 tensor-core rate, HBM3 rate).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
RTOL = ATOL = 2e-2  # tests/test_kernels.py bf16 tolerance
REF_TOL = 2e-2  # bf16 logits, card vs host, over max |logit| (tests/test_torch_model.py)
# A full-width block's output, card vs host, over its max. The JAX init rule
# draws wq and wk with fan-in H = 32 and KV = 8, not d_model = 2048, so with
# random weights q and k entries have variances 64 and 256, the attention
# scores a std of about 128, and attention is nearly hard: rounding alone
# moves a block by up to ~2 %.
BLOCK_TOL = 5e-2
TIMED_SAMPLES = 21  # CUDA-event samples per timing, of REPS calls each
REPS = 10
SLEEP_CYCLES = 2_000_000  # ~1 ms of device sleep ahead of each sample


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def time_ms(torch, fn, samples: int = TIMED_SAMPLES, reps: int = REPS) -> float:
    """Median device time of one ``fn()`` in ms, after warm-up: CUDA events
    around ``reps`` back-to-back calls, queued behind a short device sleep
    so that the host's cost of issuing them does not show."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(torch, got, want) -> float:
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), "kernel output has non-finite values")
    excess = (got - want).abs() - (ATOL + RTOL * want.abs())
    check(float(excess.max()) <= 0.0, f"kernel disagrees with its plain version beyond {RTOL}")
    return float((got - want).abs().max())


# --------------------------------------------------------------- kernel phase


def kernel_phase(torch, F) -> dict:
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    H, KV, HD = 32, 8, 64
    G = H // KV
    out = {}

    cases = []
    for t in (37, 128, 300):
        q = torch.randn(1, t, H, HD, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(1, t, KV, HD, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(1, t, KV, HD, generator=gen, device=dev).to(torch.bfloat16)
        got = fa.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = max_err(torch, got, fa.plain(q, k, v, causal=True))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kr, vr = kt.repeat_interleave(G, dim=1), vt.repeat_interleave(G, dim=1)
        flops = 4 * H * t * t * HD / 2
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + got.numel())
        b_ms, b_by = bound(flops, nbytes)
        cases.append({
            "shape": f"B=1 T=S={t} H={H} KV={KV} hd={HD} causal bf16",
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True)),
            "plain_ms": time_ms(torch, lambda: fa.plain(q, k, v, causal=True)),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kr, vr, is_causal=True)),
            "bound_ms": b_ms,
            "bound_by": b_by,
        })
    out["flash_attention"] = cases

    cases = []
    S = 512
    for b in (1, 4):
        q = torch.randn(b, H, HD, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(b, S, KV, HD, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(b, S, KV, HD, generator=gen, device=dev).to(torch.bfloat16)
        cur = torch.randint(1, S + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
        if b > 1:  # the edges: one visible row, every row
            cur[0] = 1
            cur[-1] = S
        got = dec.decode_attention(q, k, v, cur)
        torch.cuda.synchronize()
        err = max_err(torch, got, dec.plain(q, k, v, cur))
        zeros = dec.decode_attention(q, k, v, torch.zeros_like(cur))
        check(bool((zeros == 0).all()), "decode_attention must give exact zeros at cur_len == 0")
        mask = (torch.arange(S, device=dev)[None, :] < cur[:, None])[:, None, None, :]
        qt = q[:, :, None, :]
        kr = k.transpose(1, 2).repeat_interleave(G, dim=1)
        vr = v.transpose(1, 2).repeat_interleave(G, dim=1)
        rows = int(cur.clamp(max=S).sum())
        nbytes = 2 * (2 * rows * KV * HD + q.numel() + got.numel())
        b_ms, b_by = bound(4 * H * HD * rows, nbytes)
        cases.append({
            "shape": f"B={b} S={S} H={H} KV={KV} hd={HD} cur_len={cur.tolist()} bf16",
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: dec.decode_attention(q, k, v, cur)),
            "plain_ms": time_ms(torch, lambda: dec.plain(q, k, v, cur)),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kr, vr, attn_mask=mask)),
            "bound_ms": b_ms,
            "bound_by": b_by,
        })
    out["decode_attention"] = cases
    return out


# --------------------------------------------------------------- serve phase

PROMPT_LENS = (37, 128, 300)
NEW_TOKENS = 16
MAX_LEN = 512


def direct_generate(torch, model, params, tokens, steps: int, max_len: int):
    """The model without the platform: prefill_fn + decode_fn in a loop."""
    t = tokens.shape[1]
    logits, cache = model.prefill_fn(params, {"tokens": tokens})
    pad = max_len - t
    cache = {n: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, pad)) for n, c in cache.items()}
    cur = torch.full((tokens.shape[0],), t, dtype=torch.int32, device=tokens.device)
    out = [torch.argmax(logits, -1)[:, None].to(torch.int32)]
    for _ in range(steps - 1):
        logits, cache = model.decode_fn(params, {"tokens": out[-1], "cur_len": cur}, cache)
        cur = cur + 1
        out.append(torch.argmax(logits, -1)[:, None].to(torch.int32))
    return torch.cat(out, dim=1)


def serve_phase(torch, dev, cfg, prompt_lens=PROMPT_LENS, new_tokens=NEW_TOKENS,
                max_len=MAX_LEN) -> dict:
    """Drive the serving chain unfused and fused on ``dev``. On the card it
    also checks that the kernels, and never their plain versions, ran."""
    from repro_torch.core import FusionPolicy, TinyTorchBackend
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ServingEngine

    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(7)
    prompts = [torch.randint(0, cfg.vocab_size, (1, t), generator=gen, device=dev, dtype=torch.int32)
               for t in prompt_lens]

    platforms = {
        "unfused": TinyTorchBackend(FusionPolicy(enabled=False)),
        "fused": TinyTorchBackend(FusionPolicy(min_observations=2, merge_cost_s=0.0)),
    }
    results = {}
    ops.reset_counts()
    try:
        engines = {label: ServingEngine(model, p, max_len=max_len, params=params, device=dev)
                   for label, p in platforms.items()}
        tokens = {label: [] for label in platforms}
        lats = {label: [] for label in platforms}
        for i, prompt in enumerate(prompts):
            # the two platforms take turns (fused first on even prompts), so
            # that neither is always the one that runs first
            for label in ("fused", "unfused") if i % 2 == 0 else ("unfused", "fused"):
                toks, lat = engines[label].generate({"tokens": prompt}, steps=new_tokens)
                if i == 0:
                    platforms[label].merger.wait_idle()
                else:  # the first request carries warm-up and, fused, the merges
                    lats[label].extend(lat)
                tokens[label].append(toks)
        for label, platform in platforms.items():
            results[label] = {
                "tokens": tokens[label],
                "p50_token_ms": statistics.median(lats[label]) * 1e3,
                "tokens_per_s": len(lats[label]) / sum(lats[label]),
                "ram_bytes": platform.ram_bytes(),
                "live_instances": len(platform.registry.live_instances()),
                "merges": [(m.members, m.healthy) for m in platform.merger.merge_log],
            }
    finally:
        for platform in platforms.values():
            platform.shutdown()
    counts = ops.counts()

    chain = set(engines["fused"].chain_names())  # embed, g0..g3, head at full depth: 6
    check(results["unfused"]["live_instances"] == len(chain),
          f"unfused chain should hold {len(chain)} instances, has {results['unfused']['live_instances']}")
    check(results["fused"]["live_instances"] == 1,
          f"fused chain should hold 1 instance, has {results['fused']['live_instances']}")
    check(any(ok and set(m) == chain for m, ok in results["fused"]["merges"]),
          "no healthy merge of the whole chain in merge_log")
    for i, t in enumerate(prompt_lens):
        a, b = results["unfused"]["tokens"][i], results["fused"]["tokens"][i]
        check(a.shape == (1, new_tokens), f"prompt {t}: tokens of shape {tuple(a.shape)}")
        check(torch.equal(a, b), f"prompt {t}: greedy tokens differ fused vs unfused")
    if dev.type == "cuda":
        check(counts["flash_attention"] > 0 and counts["decode_attention"] > 0,
              f"the main path did not launch both kernels: {counts}")
        check(counts["mha_ref"] == 0 and counts["decode_attn_ref"] == 0,
              f"the main path called a plain version on the card: {counts}")

    # the chain computes what the model computes without the platform
    ref = direct_generate(torch, model, params, prompts[0], new_tokens, max_len)
    check(torch.equal(ref, results["unfused"]["tokens"][0]),
          "chain tokens differ from the model run without the platform")

    prefills = 2 * len(prompt_lens)  # client requests; the merges' canary replays come on top
    decode_steps = prefills * (new_tokens - 1)
    return {
        "arch": cfg.name,
        "layers": cfg.num_layers,
        "d_model": cfg.d_model,
        "params_init_s": init_s,
        "prompts": list(prompt_lens),
        "new_tokens": new_tokens,
        "max_len": max_len,
        "p50_token_ms": {k: r["p50_token_ms"] for k, r in results.items()},
        "tokens_per_s": {k: r["tokens_per_s"] for k, r in results.items()},
        "ram_bytes": {k: r["ram_bytes"] for k, r in results.items()},
        "live_instances": {k: r["live_instances"] for k, r in results.items()},
        "tokens_identical": True,
        "launches": {"flash_attention": counts["flash_attention"],
                     "decode_attention": counts["decode_attention"]},
        "plain_calls": {"mha_ref": counts["mha_ref"], "decode_attn_ref": counts["decode_attn_ref"]},
        "prefills": prefills,
        "decode_steps": decode_steps,
        "launches_per_request": {
            "flash_attention_per_prefill": counts["flash_attention"] / prefills,
            "decode_attention_per_decode_step": counts["decode_attention"] / decode_steps,
        },
        "first_tokens": results["fused"]["tokens"][0][0, :8].tolist(),
    }


def rel_err(a, b) -> float:
    """max |a - b| over max |b|, in float32 on the host."""
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).abs().max() / b.abs().max())


def reference_phase(torch, dev, cfg, prompt_len: int = 37) -> dict:
    """The model on ``dev`` against the same bf16 weights on the host's CPU
    (the plain versions): a small input end to end, and the full width
    block by block."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.configs import reduced_config
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import embed_tokens
    from repro_torch.models.model import build_model

    def prefill_and_decode(model, p, toks, nxt):
        logits, cache = model.prefill_fn(p, {"tokens": toks})
        cache = {n: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 1)) for n, c in cache.items()}
        cur = torch.full((toks.shape[0],), toks.shape[1], dtype=torch.int32, device=toks.device)
        step, _ = model.decode_fn(p, {"tokens": nxt, "cur_len": cur}, cache)
        return logits, step

    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    with torch.no_grad():
        small = build_model(dataclasses.replace(reduced_config(cfg), d_model=256, d_head=64))
        params = small.init(0, device=dev)
        toks = torch.randint(0, small.cfg.vocab_size, (1, prompt_len), generator=gen, device=dev,
                             dtype=torch.int32)
        nxt = torch.argmax(small.prefill_fn(params, {"tokens": toks})[0], -1)[:, None].to(torch.int32)
        here = prefill_and_decode(small, params, toks, nxt)
        host = prefill_and_decode(small, tree.map(lambda x: x.cpu(), params), toks.cpu(), nxt.cpu())
        for a in here:
            check(tuple(a.shape) == (1, small.cfg.vocab_size), f"logits of shape {tuple(a.shape)}")
            check(bool(torch.isfinite(a).all()), "non-finite logits")
        out["small"] = {"d_model": small.cfg.d_model, "layers": small.cfg.num_layers,
                        "rel_err": [rel_err(a, b) for a, b in zip(here, host)]}
        check(max(out["small"]["rel_err"]) <= REF_TOL,
              f"small-input logits differ from the host's beyond {REF_TOL}: {out['small']}")

        model = build_model(cfg)
        params = model.init(0, device=dev)
        host_params = tree.map(lambda x: x.cpu(), params)
        toks = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=gen, device=dev,
                             dtype=torch.int32)
        x = embed_tokens(params["embed"], toks)
        pos = torch.arange(prompt_len, device=dev)[None]
        blocks = []
        for i in range(cfg.num_layers):
            y, _ = tfm.apply_block_full(tree.map(lambda a: a[i], params["blocks"]), x, cfg, pos)
            y_host, _ = tfm.apply_block_full(tree.map(lambda a: a[i], host_params["blocks"]),
                                             x.cpu(), cfg, pos.cpu())
            blocks.append(rel_err(y - x, y_host - x.cpu()))  # the block's own contribution
            x = y
        out["full_width_blocks_rel_err"] = blocks
        check(max(blocks) <= BLOCK_TOL, f"a full-width block differs from the host's beyond {BLOCK_TOL}")
        logits = model.prefill_fn(params, {"tokens": toks})[0]
        host_logits = model.prefill_fn(host_params, {"tokens": toks.cpu()})[0]
        fp32 = dataclasses.replace(cfg, kv_cache_dtype="float32")
        host_fp32 = build_model(fp32).prefill_fn(tree.map(lambda x: x.float(), host_params),
                                                 {"tokens": toks.cpu()})[0]
        out["full_width_logits_rel_err"] = {"card_vs_host": rel_err(logits, host_logits),
                                            "host_bf16_vs_host_fp32": rel_err(host_logits, host_fp32)}
    return out


def profile_phase(torch, dev, cfg, prompt_len: int = 128, steps: int = 8,
                  max_len: int = MAX_LEN) -> dict:
    """Where a fused decode step's time goes: ``steps`` decode steps timed on
    the host clock, then ``steps`` more under torch.profiler for the
    device's kernel time and the kernels that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import FusionPolicy, TinyTorchBackend
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ServingEngine, _greedy_token

    model = build_model(cfg)
    params = model.init(0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    prompt = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=gen, device=dev,
                           dtype=torch.int32)
    platform = TinyTorchBackend(FusionPolicy(min_observations=2, merge_cost_s=0.0))
    try:
        engine = ServingEngine(model, platform, max_len=max_len, params=params, device=dev)
        engine.generate({"tokens": prompt}, steps=6)  # observe, fuse, warm up
        platform.merger.wait_idle()
        check(len(platform.registry.live_instances()) == 1, "profile: the chain did not fuse")
        logits, caches, cur = engine.prefill({"tokens": prompt})
        tok = _greedy_token(logits)

        def run_steps() -> float:
            nonlocal logits, caches, cur, tok
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                logits, caches = engine.decode_step(tok, cur, caches)
                cur = cur + 1
                tok = _greedy_token(logits)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        wall_ms = run_steps()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled_wall_ms = run_steps()
    finally:
        platform.shutdown()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, list] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    device_ms = sum(sum(v) for v in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:10]
    return {
        "prompt_len": prompt_len,
        "steps": steps,
        "wall_ms_per_step": wall_ms / steps,
        "profiled_wall_ms_per_step": profiled_wall_ms / steps,
        "device_kernel_ms_per_step": device_ms / steps,
        "device_busy_share": device_ms / wall_ms,
        "kernels_per_step": len(kernels) / steps,
        "host_ops_per_step": sum(1 for e in prof.events()
                                 if e.device_type == DeviceType.CPU and e.name.startswith("aten::")
                                 and e.cpu_parent is None) / steps,
        "top_kernels": [{"name": n[:80], "calls_per_step": len(v) / steps,
                         "ms_per_step": sum(v) / 1e3 / steps} for n, v in top],
    }


def kernels_line(kern: dict, launches: dict) -> dict:
    meta = {
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:73"),
        "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:59"),
    }
    entries = []
    for name, cases in kern.items():
        main = cases[-1] if name == "flash_attention" else cases[0]  # the serve path's shape
        source, replaces = meta[name]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["ms"], "kernel_ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": main["shape"], "cases": cases,
        })
    return {"kernels": entries}


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        raise SmokeFailure(f"{SRC / 'repro_torch'} is missing: run from a checkout of the repository")
    sys.path.insert(0, str(SRC))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device is available")
    # full float32 matmuls wherever fp32 appears (norms, RoPE, logits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    dev_line = device_line()
    print(dev_line, flush=True)

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.load()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    for line in build.build_report().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}", file=sys.stderr)

    from repro_torch.configs import get_arch

    cfg, dev = get_arch("llama3.2-1b"), torch.device("cuda")
    t0 = time.perf_counter()
    kern = kernel_phase(torch, F)
    print(f"kernel phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    t0 = time.perf_counter()
    serve = serve_phase(torch, dev, cfg)
    print(json.dumps({"serve": serve}), flush=True)
    print(f"serve phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    t0 = time.perf_counter()
    print(json.dumps({"reference": reference_phase(torch, dev, cfg)}), flush=True)
    print(f"reference phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    t0 = time.perf_counter()
    print(json.dumps({"profile": profile_phase(torch, dev, cfg)}), flush=True)
    print(f"profile phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    print(json.dumps(kernels_line(kern, serve["launches"])), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
