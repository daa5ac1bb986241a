#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failed check exits non-zero and prints no result):

1. Device line: the card's name and power limit from ``nvidia-smi``; then
   the hand-written kernels are built from ``src/repro_torch/kernels/csrc``.
2. Kernel phase: K3 ``flash_attention`` and K4 ``decode_attention`` at the
   dense serving chain's shapes and at zamba2-7b's shared block (32 heads of
   112), then at fixed lengths a later change can compare with (K3 at a
   causal T = 1024; K4 over a full cache of 512 rows at both shapes and of
   4096 rows, where the bytes set the time: ``bound_share`` is bound_ms / ms,
   and every timed call reads the next of enough copies of the cache to
   exceed the L2 four times over), then at qwen3-moe-30b-a3b's attention
   (32 query heads over 4 kv heads of 128) and at the groups of starcoder2-3b
   (24/2 heads of 128) and granite-34b (48/1), wider than one head slice of
   the kernel; K1 ``paged_decode_attention`` (the paged serve path's shape,
   B = 1, MQA, qwen3's 32/4 heads of 128 and the two wide groups) and K2
   ``paged_chunk_attention`` at the paged serve paths' (llama's 32/8 heads of
   64, qwen3's 32/4 of 128: the 512-row chunk); K5 ``moe_gmm`` at the
   MoE serve path's (E = 128): every row kept at C = 8, 24, 40, and ``rows``
   from a top-8 routing through the layer's own ``route`` (a decode step's
   gate/up and down, 8 paged sequences' gate/up: skipped rows exact zeros,
   equal to the kernel without ``rows``, timed over copies of w that exceed
   the L2, the bound counting the active experts' bytes; the dense bound
   beside it); K6 ``ssd_scan`` at the SSM and hybrid paths' (T = 300 for
   each model, T = 37, T = 512, G = 2; y and the final state), each held
   against its plain PyTorch version at rtol = atol = 2e-2 and timed with
   CUDA events (median of 21 samples of 10 back-to-back calls, after
   warm-up) beside its plain version, one library call on the same inputs (a
   yardstick only; the port never calls it: ``scaled_dot_product_attention``
   — for K1 and K2 on the pre-gathered contiguous cache, the gather timed
   apart — ``torch.bmm`` for K5; none computes K6) and the least time the
   card could take (``bound_ms``). Every kernel must give equal bits on two
   launches. A ``ptxas`` line gives every kernel's registers and spills, per
   head dim for K3 and K4. A ``grad_refusal`` line: each of the six wrappers,
   given a CUDA input that requires grad under grad mode, raises before its
   launch (the kernels have no backward on the card yet).
3. Serve phase: full-width ``llama3.2-1b`` (16 layers, random bf16 weights
   from a fixed seed) deployed as the six-function chain on an unfused and a
   fusing ``TinyTorchBackend`` sharing the same weights; three prompts
   (37, 128, 300 tokens) generate 16 greedy tokens each, the two platforms
   taking turns; the first prompt (warm-up and the merges) is not timed.
   Checks: 6 live instances unfused, 1 fused with a healthy merge, identical
   tokens on both platforms and against the model run without the
   platform, and that the main path launched K3 once per layer of each
   prefill and K4 once per layer of each decode step (the merges' canary
   replays counted) and never called their plain versions. ``ram_bytes``
   counts, per live instance, the 32 MiB runtime constant, the weights and
   the largest recorded workspace + output bytes of its compiled entries
   (``footprints`` lists each instance's entries); fused must stay below
   unfused. (A unit's first run resets the device's peak-memory counter to
   measure its workspace, so a phase's ``peak_allocated_gb`` is the peak
   since the last such run.) Every compiled entry is captured as a CUDA
   graph at its second run and replayed from then on: ``graphs`` lists each
   live instance's captured entries, and every decode entry that ran twice
   must have been captured and one replayed (every serve and paged phase
   checks it); the launch counts stay exact, ``launch_parts`` giving the
   eager and the replayed part (a capture records its launches, each replay
   adds them once). Per-token p50 fused / unfused is reported. Every
   platform traces (``repro_torch.obs``); a ``trace_serve`` line checks
   that every trace conserves (its phases sum to its wall time within
   1e-9 s), that each unfused ``invoke`` trace holds the chain's 5
   ``cross-function-sync`` spans and each fused one after the merge none,
   and that the control timeline holds the fused unit's ``fused-inline:``
   events and one ``merge:`` span per healthy merge whose seconds are its
   ``build_s``; it gives the decode steps' phase shares. The fused
   platforms of the serve, paged and profile phases turn the reference's
   promotion of a cold edge off (``SERVE_POLICY``: their traffic is serial
   ``invoke``, which gives the scheduler no tail).
4. Paged serve phase: full-width ``llama3.2-1b`` served from the paged KV
   arena (321 pages of 16 tokens) by the continuous batcher at capacity 8:
   24 requests of 37, 128 and 300 prompt tokens (8 sharing a 128-token
   prefix, 2 exact repeats) generating 18-30 tokens each, fused (the chain
   fused on dense traffic first) and then unfused. Checks: every request
   completes, K1 and K2 launched and no plain version ran, the arena is
   consistent and empty afterwards, 1 live instance fused with a healthy
   merge and less ``ram_bytes``, one batched paged decode step against the
   dense one block by block within 5e-2, and a small model served by the
   batcher gives per-request generate's tokens; every ``serve`` trace
   conserves (chunked prefill and copy-on-write included).
5. Reference phase: the card against the host's CPU (plain versions, the
   same bf16 weights). A small input — llama3.2-1b cut to 2 layers of width
   256 (head dim 64, which the kernels take) — must give the same prefill
   and decode logits within 2e-2 of max |logit|; at full width each
   block's contribution on the same input must agree within 5e-2, and how
   far bf16 rounding alone carries the end-to-end logits is reported.
6. Profile phase: where a fused decode step's time goes — the host's wall
   clock against the device's kernel time (``torch.profiler``) — its ten
   costliest kernels and the device time of each hand-written kernel; the
   step is a replay of the fused unit's captured CUDA graph. ``step_gap``
   (here and in the MoE profile) splits a step's wall time beyond its
   kernels into the copy-in, the host's replay call, the gaps between the
   graph's nodes and the copy-out (host clocks and CUDA events around each;
   the graph's kernels from ``torch.profiler`` over bare replays).
6b. Batched phase: ``load_bench``'s closed-loop main path driven against the
   port on full-width ``llama3.2-1b``: 8 client threads, each prefilled
   once with a random 8-token prompt and its own max_len caches, feeding a
   constant token; one fused platform with ``max_batch`` 8 and
   ``max_delay_ms`` 2; 8 warm-up then 48 timed decode steps per client,
   first ``fused-serial`` (``invoke``), then ``fused-batched``
   (``decode_step_async`` -> ``invoke_async`` -> the scheduler -> one
   vmapped program per power-of-two bucket, captured at its second run).
   Checks: a batch of 2 or more formed, no request of the decode entry fell
   back to per-request execution, K4 launched exactly once per layer of each
   program run, a bucket program was captured, and one batched step's lanes
   against the same requests' ``invoke`` (logits and caches within 2e-2 of
   max |value|; K4 under vmap at the lanes' own caches equal in bits to K4
   per lane). Prints requests/s and p50/p95/p99 of both modes. A
   ``trace_batched`` line: every ``invoke_async`` trace tiles its wall time
   exactly (residual 0.0), its members reference exactly the batch traces,
   and the tracing-overhead gate of ``load_bench``: requests/s of
   ``fused-batched`` with tracing on over off at least 0.97, in 8
   interleaved rounds on the warm platform, one retry.
6c. Dispatch and export: a ``dispatch`` line — the dispatch tracer armed
   over the steady state of the serve phase (the first prompt served a
   third time on each platform), the paged serve phase (its requests a
   third time, fused) and the batched phase (24 more batched steps): no
   new program (entry, capture or bucket), host fetches within decode steps
   + 2 x requests + capacity, and the sync-debug count beside them; a
   ``chrome_trace`` line — the llama phases' traces written to
   ``chiprun_out/trace_llama.json`` (Chrome ``trace_event``) and parsed back.
7. MoE serve phase: the llama tensors freed, full-width
   ``qwen3-moe-30b-a3b`` at full depth (48 layers, 128 experts, top 8,
   random bf16 weights from seed 0, about 61 GB) as the eight-function
   chain, unfused and fused, with the serve phase's prompts and checks
   (8 live instances unfused, 1 fused, less ``ram_bytes``, identical tokens
   fused, unfused and without the platform), and K5 launched exactly three
   times per MoE layer applied, the merges' canary replays counted.
8. Paged MoE phase: the same weights served by the continuous batcher over
   the 321-page arena, the first 8 of the paged phase's requests, fused and
   then unfused, with the paged phase's checks (K1, K2 and K5 launched).
9. MoE block check: one full-width MoE layer on the same bf16 input on the
   card (K5) and on the host's CPU: at least 99 % of the tokens' top-8
   expert sets agree, and the outputs on those tokens within 2e-2 of max |y|.
10. MoE profile: phase 6 for a fused MoE decode step; then peak device
   memory (``torch.cuda.max_memory_allocated``).
11. SSM phases: the qwen3 tensors freed, full-width ``mamba2-370m`` at full
   depth (48 layers, 0.74 GB) as the six-function chain, unfused and fused,
   with the serve phase's prompts and checks, every kernel's launches
   exactly as the run's prefills, decode steps and canary replays make them
   (K6 once per SSM layer of each prefill, none in a decode step: that is
   the recurrent form); K6 on the inputs the first layer gives it (held at
   2e-2 of max |y|); the first block card vs host, every block's prefill +
   one decode step against its longer prefill, a small model card vs host;
   a profiled fused decode step and prefill.
12. Hybrid phases: the same for full-width ``zamba2-7b`` (81 layers: 13
   groups of 6 Mamba layers each followed by the shared attention block,
   and a tail of 3; 13.5 GB) as the three-function chain
   ``embed -> core -> head``; K3 once per shared-block application of each
   prefill, K4 once per application of each decode step, K6 as above.

Standard output opens with the device line and the ``ptxas`` line; its
last lines are the ``serve``, ``trace_serve``, ``paged_serve``,
``reference``, ``profile``, ``batched``, ``trace_batched``, ``dispatch``,
``chrome_trace``, ``moe_serve``, ``moe_paged_serve``, ``moe_block``,
``moe_profile``, ``moe_memory``,
``ssm_serve``, ``ssm_block``, ``ssm_profile``, ``ssm_memory``,
``hybrid_serve``, ``hybrid_block``, ``hybrid_profile``, ``hybrid_memory``
and ``kernels`` JSON lines and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import itertools
import json
import re
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
# K/V bytes a cold K4 case rotates through: four times the H100's 50 MB L2
COLD_BYTES = 4 * 50 * 2**20


# the plain versions' call counters (repro_torch.kernels.ref.CALLS)
PLAIN = ("mha_ref", "decode_attn_ref", "paged_decode_attn_ref", "paged_chunk_attn_ref", "gmm_ref", "ssd_ref")
# each kernel of a serve phase and the plain version that stands in for it on
# the CPU (the CPU's SSM prefill runs the chunked scan, not the plain K6)
STAND_INS = {"flash_attention": "mha_ref", "decode_attention": "decode_attn_ref", "moe_gmm": "gmm_ref"}


# the device-side names of the hand-written kernels (csrc/*.cu)
PORT_KERNELS = ("flash_attention_kernel", "decode_attention_kernel", "paged_decode_kernel",
                "paged_chunk_kernel", "moe_gmm_kernel", "ssd_scan_kernel")


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


def flash_case(torch, F, t, H, KV, HD, rng) -> dict:
    """K3 at B = 1, T = S = ``t``, causal, on inputs drawn from ``rng``:
    against its plain version, two launches for equal bits, timed beside the
    plain version and SDPA on the same inputs."""
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    G = H // KV
    q = torch.randn(1, t, H, HD, generator=rng, device=dev).to(torch.bfloat16)
    k = torch.randn(1, t, KV, HD, generator=rng, device=dev).to(torch.bfloat16)
    v = torch.randn(1, t, KV, HD, generator=rng, device=dev).to(torch.bfloat16)
    got = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = max_err(torch, got, fa.plain(q, k, v, causal=True))
    check(torch.equal(got, fa.flash_attention(q, k, v, causal=True)), f"flash_attention T={t} is not deterministic")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kr, vr = kt.repeat_interleave(G, dim=1), vt.repeat_interleave(G, dim=1)
    flops = 4 * H * t * t * HD / 2
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + got.numel())
    b_ms, b_by = bound(flops, nbytes)
    ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True))
    return {
        "shape": f"B=1 T=S={t} H={H} KV={KV} hd={HD} causal bf16",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": time_ms(torch, lambda: fa.plain(q, k, v, causal=True)),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kr, vr, is_causal=True)),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "bound_share": b_ms / ms,
    }


def rotating(fn, n: int):
    """A call that passes 0, 1, ..., n - 1, 0, ... to ``fn`` in turn."""
    calls = itertools.count()
    return lambda: fn(next(calls) % n)


def decode_case(torch, F, b, S, H, KV, HD, rng, lens=None, cold: bool = False) -> dict:
    """K4 at batch ``b`` over a cache of ``S`` rows on inputs drawn from
    ``rng`` (cur_len ``lens``, else drawn from ``rng`` too: random in [1, S],
    the edges 1 and S where b > 1): against its plain version, exact zeros
    at cur_len 0, two launches for equal bits, timed beside the plain version
    and SDPA with the cur_len mask on the same inputs. ``cold``: every timed
    call (kernel, plain version and SDPA alike) reads the next of ``copies``
    copies of K and V, together at least COLD_BYTES, so that the cache comes
    from device memory and not from the L2, as in a decode step, where each
    layer's cache is read once between the other layers' weights."""
    from repro_torch.kernels import decode_attention as dec

    dev = torch.device("cuda")
    G = H // KV
    q = torch.randn(b, H, HD, generator=rng, device=dev).to(torch.bfloat16)
    k = torch.randn(b, S, KV, HD, generator=rng, device=dev).to(torch.bfloat16)
    v = torch.randn(b, S, KV, HD, generator=rng, device=dev).to(torch.bfloat16)
    if lens is None:
        cur = torch.randint(1, S + 1, (b,), generator=rng, device=dev, dtype=torch.int32)
        if b > 1:  # the edges: one visible row, every row
            cur[0] = 1
            cur[-1] = S
    else:
        cur = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = dec.decode_attention(q, k, v, cur)
    torch.cuda.synchronize()
    err = max_err(torch, got, dec.plain(q, k, v, cur))
    check(torch.equal(got, dec.decode_attention(q, k, v, cur)), f"decode_attention S={S} is not deterministic")
    zeros = dec.decode_attention(q, k, v, torch.zeros_like(cur))
    check(bool((zeros == 0).all()), "decode_attention must give exact zeros at cur_len == 0")
    mask = (torch.arange(S, device=dev)[None, :] < cur[:, None])[:, None, None, :]
    qt = q[:, :, None, :]
    copies = -(-COLD_BYTES // (2 * k.numel() * k.element_size())) if cold else 1
    ks = [k] + [k.clone() for _ in range(copies - 1)]
    vs = [v] + [v.clone() for _ in range(copies - 1)]
    krs = [x.transpose(1, 2).repeat_interleave(G, dim=1) for x in ks]
    vrs = [x.transpose(1, 2).repeat_interleave(G, dim=1) for x in vs]
    rows = int(cur.clamp(max=S).sum())
    nbytes = 2 * (2 * rows * KV * HD + q.numel() + got.numel())
    b_ms, b_by = bound(4 * H * HD * rows, nbytes)
    ms = time_ms(torch, rotating(lambda i: dec.decode_attention(q, ks[i], vs[i], cur), copies))
    return {
        "shape": f"B={b} S={S} H={H} KV={KV} hd={HD} cur_len={cur.tolist()} bf16",
        "copies": copies,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": time_ms(torch, rotating(lambda i: dec.plain(q, ks[i], vs[i], cur), copies)),
        "library_ms": time_ms(torch, rotating(
            lambda i: F.scaled_dot_product_attention(qt, krs[i], vrs[i], attn_mask=mask), copies)),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "bound_share": b_ms / ms,
    }


def kernel_phase(torch, F) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    # zamba2-7b's shared-block cases, and the fixed-length and long cases
    # after them, draw from generators of their own, so that every earlier
    # case draws the inputs it drew before they were added
    gen112 = torch.Generator(device=dev).manual_seed(112)
    gen_fixed = torch.Generator(device=dev).manual_seed(15)
    gen128 = torch.Generator(device=dev).manual_seed(128)
    gen_wide = torch.Generator(device=dev).manual_seed(16)
    out = {}
    # the dense chain's prompts (llama3.2-1b), zamba2-7b's shared block, a
    # long causal prompt, and qwen3-moe-30b-a3b's attention (32/4 heads of 128)
    out["flash_attention"] = [flash_case(torch, F, *args) for args in (
        (37, 32, 8, 64, gen), (128, 32, 8, 64, gen), (300, 32, 8, 64, gen), (300, 32, 32, 112, gen112),
        (1024, 32, 8, 64, gen_fixed), (300, 32, 4, 128, gen128))]
    # the dense chain's decode (B = 1, 4; llama3.2-1b), zamba2-7b's shared
    # block; then fixed lengths that a later change can compare with: the
    # full S = 512 cache at both shapes, and a long cache of 4096 rows, where
    # the bytes, not the launch, set the time (read cold: see decode_case);
    # then qwen3-moe-30b-a3b's decode at the main case's cur_len
    out["decode_attention"] = [decode_case(torch, F, *args) for args in (
        (1, 512, 32, 8, 64, gen), (4, 512, 32, 8, 64, gen), (1, 512, 32, 32, 112, gen112))] + [
        decode_case(torch, F, 1, S, H, KV, HD, gen_fixed, lens=[S], cold=S > 512)
        for S, H, KV, HD in ((512, 32, 8, 64), (512, 32, 32, 112), (4096, 32, 8, 64), (4096, 32, 32, 112))] + [
        decode_case(torch, F, 1, 512, 32, 4, 128, gen128, lens=[406])] + [
        # starcoder2-3b's and granite-34b's groups (G * hd 1536 and 6144),
        # wider than one head slice of the kernel
        decode_case(torch, F, 2, 512, h, kv, 128, gen_wide) for h, kv in ((24, 2), (48, 1))]
    out.update(paged_kernel_cases(torch, F, gen))
    out["moe_gmm"] = moe_kernel_cases(torch, gen)
    out["ssd_scan"] = ssd_kernel_cases(torch, gen)
    return out


def grad_refusal_check(torch) -> dict:
    """Each of the six kernel wrappers, given a CUDA input that requires grad
    under grad mode, raises before its launch (the kernels have no backward
    on the card yet: an output filled by a kernel would carry no gradient)."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssd_scan as sd

    dev = torch.device("cuda")
    bf = dict(device=dev, dtype=torch.bfloat16)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    pages = torch.zeros(3, 16, 2, 64, **bf)
    table = torch.ones(1, 2, dtype=torch.int32, device=dev)
    x = lambda *shape: torch.zeros(*shape, **bf).requires_grad_()  # noqa: E731
    calls = {
        "flash_attention": lambda: fa.flash_attention(x(1, 8, 4, 64), torch.zeros(1, 8, 2, 64, **bf),
                                                      torch.zeros(1, 8, 2, 64, **bf)),
        "decode_attention": lambda: dec.decode_attention(x(1, 4, 64), torch.zeros(1, 16, 2, 64, **bf),
                                                         torch.zeros(1, 16, 2, 64, **bf), one),
        "paged_decode_attention": lambda: pa.paged_decode_attention(x(1, 4, 64), pages, pages, table, one),
        "paged_chunk_attention": lambda: pa.paged_chunk_attention(x(1, 4, 4, 64), pages, pages, table, one),
        "moe_gmm": lambda: gm.moe_gmm(x(2, 8, 64), torch.zeros(2, 64, 32, **bf)),
        "ssd_scan": lambda: sd.ssd_scan(x(1, 8, 2, 64), torch.zeros(1, 8, 1, 64, **bf),
                                        torch.zeros(1, 8, 1, 64, **bf), torch.ones(1, 8, 2, device=dev),
                                        torch.zeros(2, device=dev), torch.ones(2, device=dev)),
    }
    out = {}
    with torch.enable_grad():
        for name, call in calls.items():
            try:
                call()
            except RuntimeError as exc:
                check("no backward" in str(exc), f"{name}: raised, but not the refusal: {exc}")
                out[name] = "raises"
            else:
                raise SmokeFailure(f"{name}: launched on a requires-grad input under grad mode")
    return out


def ptxas_report(report: str) -> dict:
    """Registers, spills and shared memory of each hand-written kernel's
    instantiations (``name<template ints>``), from the compiler's
    ``-Xptxas -v`` report of this run's build."""
    out, entry = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            args = ",".join(re.findall(r"Li(\d+)E", mangled))
            entry = next((f"{k}<{args}>" if args else k for k in PORT_KERNELS if k in mangled), None)
        elif entry and ("registers" in line or "spill" in line):
            out.setdefault(entry, []).append(line.split("ptxas info    :")[-1].strip())
    return out


# (label, B, T, H, G, P, N) of K6: each model's prompt of 300 tokens
# (mamba2-370m: 32 heads of 64 over a state of 128; zamba2-7b: 112 heads of 64
# over 64), one partial chunk, two full chunks of the configured 256, groups
SSD_CASES = (
    ("mamba2-370m T=300", 1, 300, 32, 1, 64, 128),
    ("zamba2-7b T=300", 1, 300, 112, 1, 64, 64),
    ("T=37", 1, 37, 32, 1, 64, 128),
    ("T=512", 1, 512, 112, 1, 64, 64),
    ("G=2", 2, 300, 8, 2, 64, 64),
)
SSD_CHUNK = 64  # the kernel's own chunk (csrc/ssd_scan.cu: kQ)


def ssd_bound(b, t, h, g, p, n) -> tuple[float, str]:
    """K6's least time: x, B, C, dt, A_log, D read once, y written once and
    the final state (B, H, P, N) fp32 written once; per (b, h) the dual
    form's products over chunks of the kernel's SSD_CHUNK rows, sum of
    2Q^2 N + 2Q^2 P + 4QNP."""
    chunks = [min(SSD_CHUNK, t - c) for c in range(0, t, SSD_CHUNK)]
    flops = b * h * sum(2 * q * q * n + 2 * q * q * p + 4 * q * n * p for q in chunks)
    nbytes = 2 * (2 * b * t * h * p + 2 * b * t * g * n) + 4 * (b * t * h + 2 * h) + 4 * b * h * p * n
    return bound(flops, nbytes)


def ssd_case(torch, label, x, bm, cm, dt, a_log, d_skip, captured: bool = False) -> dict:
    """K6 against its plain version on the same inputs, y and the final
    state, timed beside it (no single PyTorch call computes the SSD scan:
    library "none"). A captured case is held at 2e-2 of max |y| and of max
    |state| (its outputs reach ~1e6, where the two summation orders differ
    by more than the elementwise atol near 0); every other case elementwise
    at rtol = atol = 2e-2."""
    from repro_torch.kernels import ssd_scan as sd

    b, t, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    got, state = sd.ssd_scan(x, bm, cm, dt, a_log, d_skip, return_state=True)
    torch.cuda.synchronize()
    want, want_state = sd.plain(x, bm, cm, dt, a_log, d_skip)
    check(bool(torch.isfinite(got).all()) and bool(torch.isfinite(state).all()), f"ssd_scan {label}: non-finite output")
    rel, rel_state = rel_err(got, want), rel_err(state, want_state)
    if captured:
        check(rel <= RTOL, f"ssd_scan {label}: {rel} of max |y| from its plain version")
        check(rel_state <= RTOL, f"ssd_scan {label}: state {rel_state} of max |state| from its plain version")
        err = float((got.float() - want).abs().max())
        state_err = float((state - want_state).abs().max())
    else:
        err = max_err(torch, got, want)
        state_err = max_err(torch, state, want_state)
    again, again_state = sd.ssd_scan(x, bm, cm, dt, a_log, d_skip, return_state=True)
    check(torch.equal(got, again) and torch.equal(state, again_state), f"ssd_scan {label} is not deterministic")
    b_ms, b_by = ssd_bound(b, t, h, g, p, n)
    ms = time_ms(torch, lambda: sd.ssd_scan(x, bm, cm, dt, a_log, d_skip, return_state=True))
    return {
        "shape": f"{label}: B={b} T={t} H={h} G={g} P={p} N={n} x/B/C bf16, dt fp32",
        "max_abs_err": err,
        "state_max_abs_err": state_err,
        "rel_err_of_max": rel,
        "state_rel_err_of_max": rel_state,
        "max_abs_y": float(want.abs().max()),
        "ms": ms,
        "plain_ms": time_ms(torch, lambda: sd.plain(x, bm, cm, dt, a_log, d_skip)),
        "library_ms": None,
        "library": "none",
        "bound_ms": b_ms,
        "bound_by": b_by,
        "bound_share": b_ms / ms,
    }


def ssd_kernel_cases(torch, gen) -> list:
    """K6 at the SSM and hybrid serve paths' shapes on unit-scale inputs
    (tests/test_kernels.py's recipe: B, C of std 0.5, dt = softplus(N(0, 1)),
    A_log of std 0.3, D = 1)."""
    dev = torch.device("cuda")
    cases = []
    for label, b, t, h, g, p, n in SSD_CASES:
        x = torch.randn(b, t, h, p, generator=gen, device=dev).to(torch.bfloat16)
        bm = (torch.randn(b, t, g, n, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        cm = (torch.randn(b, t, g, n, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        dt = torch.nn.functional.softplus(torch.randn(b, t, h, generator=gen, device=dev))
        a_log = torch.randn(h, generator=gen, device=dev) * 0.3
        cases.append(ssd_case(torch, label, x, bm, cm, dt, a_log, torch.ones(h, device=dev)))
    return cases


# (C, d, f) of the MoE serve path's expert products, E = 128 (qwen3-moe-30b-a3b):
# gate/up and down at a decode step (C = 8), gate/up at a 300-token dense
# prefill (C = 24) and at a 512-row paged chunk (C = 40); every row kept
MOE_CASES = ((8, 2048, 768), (8, 768, 2048), (24, 2048, 768), (40, 2048, 768))
MOE_EXPERTS = 128
# (label, tokens routed, d, f) of the routed cases: rows from a top-8 routing
# of that many tokens through the MoE layer's own route() and capacity
MOE_ROUTED = (("decode gate/up", 1, 2048, 768), ("decode down", 1, 768, 2048),
              ("paged decode gate/up", 8, 2048, 768))
MOE_MAIN_CASE = len(MOE_CASES)  # the main path's shape: the routed decode gate/up


def moe_routing(torch, gen, tokens: int):
    """Each expert's kept rows (min(count, capacity)) and the capacity C for
    ``tokens`` tokens routed by qwen3-moe-30b-a3b's own ``route`` (a random
    fp32 router on random hidden states), as ``apply_moe`` computes them."""
    from repro_torch.configs import get_arch
    from repro_torch.models import moe

    dev = torch.device("cuda")
    cfg = get_arch("qwen3-moe-30b-a3b")
    router = torch.randn(cfg.d_model, cfg.num_experts, generator=gen, device=dev) * cfg.d_model ** -0.5
    x = torch.randn(1, tokens, cfg.d_model, generator=gen, device=dev).to(torch.bfloat16)
    _, e_flat, _, pos = moe.route({"router": router}, x, cfg)
    cap = moe.capacity(tokens, cfg)
    rows = torch.zeros(cfg.num_experts, dtype=torch.int32, device=dev).index_add_(0, e_flat, (pos < cap).int())
    return rows, cap, min(cfg.num_experts, tokens * cfg.num_experts_per_tok)


def moe_kernel_cases(torch, gen) -> list:
    """K5 at the MoE serve path's shapes against its plain version, timed
    beside it and beside the library yardstick ``torch.bmm`` on the same full
    buffers (the port never calls it). The dense cases keep every row of
    every expert; the routed cases take ``rows`` from a real top-8 routing
    (:func:`moe_routing`), zero xe's rows past them (as the layer's scatter
    leaves them) and check the outputs' skipped rows are exact zeros, equal
    bits on two launches, and equality with the kernel without ``rows`` on
    the same input. A routed call reads only its active experts' weights, so
    it is timed reading the next of ``copies`` copies of w each call, together
    at least COLD_BYTES of active weights (a decode step reads each layer's
    experts once, between the other layers' weights), and its bound counts
    the active experts' bytes; the dense bound is printed beside it."""
    from repro_torch.kernels import moe_gmm as gm

    dev = torch.device("cuda")
    e = MOE_EXPERTS
    cases = []
    routings = {}
    # the routed cases draw from a generator of their own, so that the dense
    # cases (and the cases after K5) draw the inputs they drew before
    gen_routed = torch.Generator(device=dev).manual_seed(5)
    for label, c, d, f, tokens in ([(f"dense C={c}", c, d, f, None) for c, d, f in MOE_CASES] +
                                   [(label, None, d, f, tokens) for label, tokens, d, f in MOE_ROUTED]):
        if tokens is None:
            rows, active = torch.full((e,), c, dtype=torch.int32, device=dev), e
        else:
            if tokens not in routings:
                routings[tokens] = moe_routing(torch, gen_routed, tokens)
            rows, c, active = routings[tokens]
        g_case = gen if tokens is None else gen_routed
        keep = torch.arange(c, device=dev)[None, :] < rows[:, None]  # (E, C)
        xe = torch.randn(e, c, d, generator=g_case, device=dev).to(torch.bfloat16).masked_fill(~keep[..., None], 0)
        w = (torch.randn(e, d, f, generator=g_case, device=dev) * d ** -0.5).to(torch.bfloat16)
        got = gm.moe_gmm(xe, w, rows, active)
        torch.cuda.synchronize()
        err = max_err(torch, got, gm.plain(xe, w, rows))
        check(bool((got.masked_select(~keep[..., None]) == 0).all()), f"moe_gmm {label}: a skipped row is not 0")
        check(torch.equal(got, gm.moe_gmm(xe, w, rows, active)), f"moe_gmm {label} is not deterministic")
        check(torch.equal(got, gm.moe_gmm(xe, w)), f"moe_gmm {label}: differs from the kernel without rows")
        n_active = int((rows > 0).sum())
        kept_rows = int(rows.sum())
        nbytes = 2 * (kept_rows * d + n_active * d * f + e * c * f)
        b_ms, b_by = bound(2 * kept_rows * d * f, nbytes)
        dense_ms, _ = bound(2 * e * c * d * f, 2 * (e * c * d + e * d * f + e * c * f))
        copies = min(16, -(-COLD_BYTES // (2 * n_active * d * f)))
        ws = [w] + [w.clone() for _ in range(copies - 1)]
        ms = time_ms(torch, rotating(lambda i: gm.moe_gmm(xe, ws[i], rows, active), copies))
        cases.append({
            "shape": f"{label}: E={e} C={c} d={d} f={f} active={n_active} rows={kept_rows} bf16",
            "copies": copies,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": time_ms(torch, rotating(lambda i: gm.plain(xe, ws[i], rows), copies)),
            "library_ms": time_ms(torch, rotating(lambda i: torch.bmm(xe, ws[i]), copies)),
            "library": "torch.bmm on the full buffers",
            "bound_ms": b_ms,
            "bound_by": b_by,
            "bound_share": b_ms / ms,
            "dense_bound_ms": dense_ms,
            "achieved_gb_s": nbytes / ms / 1e6,
        })
        del ws, w
    return cases


def _paged_inputs(torch, gen, b, n, page, p, kv, hd):
    """Random bf16 pages and a block table of distinct live pages per
    sequence (page 0 is the arena's scratch page)."""
    dev = torch.device("cuda")
    kp = torch.randn(p, page, kv, hd, generator=gen, device=dev).to(torch.bfloat16)
    vp = torch.randn(p, page, kv, hd, generator=gen, device=dev).to(torch.bfloat16)
    perm = torch.randperm(p - 1, generator=gen, device=dev)[: b * n] + 1
    return kp, vp, perm.reshape(b, n).to(torch.int32).contiguous()


def paged_kernel_cases(torch, F, gen) -> dict:
    """K1 and K2 at the paged serve path's shapes (and an MQA one), each
    against its plain version, timed beside it and beside the library
    yardstick: ``scaled_dot_product_attention`` on the PRE-GATHERED
    contiguous cache (no single PyTorch call computes the paged function;
    the gather's own time is reported apart, as ``gather_ms``)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import gather_pages

    dev = torch.device("cuda")
    # the cases added after the first three draw from a generator of their
    # own, so that every other case draws the inputs it drew before
    gen_added = torch.Generator(device=dev).manual_seed(16)
    out = {}
    cases = []
    # (label, B, n, page, P, H, KV, hd, cur_len): the serve shape (capacity
    # 8, 32 pages of 16 per sequence, the arena of 321 pages), B = 1, MQA;
    # qwen3-moe-30b-a3b's paged shape (32/4 heads of 128); the groups of
    # starcoder2-3b (24/2 heads of 128: G * hd = 1536) and granite-34b (48/1:
    # 6144), wider than one head slice of the kernel (1024 outputs)
    for label, b, n, page, p, h, kv, hd, lens in (
        ("serve", 8, 32, 16, 321, 32, 8, 64, [0, 37, 129, 300, 406, 511, 150, 64]),
        ("B=1", 1, 32, 16, 321, 32, 8, 64, [406]),
        ("MQA", 4, 32, 16, 321, 16, 1, 64, [37, 128, 300, 500]),
        ("qwen3", 8, 32, 16, 321, 32, 4, 128, [0, 37, 129, 300, 406, 511, 150, 64]),
        ("G*hd=1536", 4, 32, 16, 321, 24, 2, 128, [0, 37, 300, 512]),
        ("G*hd=6144", 4, 32, 16, 321, 48, 1, 128, [1, 64, 300, 511]),
    ):
        g_case = gen if label in ("serve", "B=1", "MQA") else gen_added
        kp, vp, bt = _paged_inputs(torch, g_case, b, n, page, p, kv, hd)
        q = torch.randn(b, h, hd, generator=g_case, device=dev).to(torch.bfloat16)
        cur = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = pa.paged_decode_attention(q, kp, vp, bt, cur)
        torch.cuda.synchronize()
        err = max_err(torch, got, pa.plain_decode(q, kp, vp, bt, cur))
        check(torch.equal(got, pa.paged_decode_attention(q, kp, vp, bt, cur)),
              f"paged_decode_attention {label} is not deterministic")
        for i, n_valid in enumerate(lens):
            if n_valid == 0:
                check(bool((got[i] == 0).all()), "paged_decode_attention must give exact zeros at cur_len 0")
        g = h // kv
        kr = gather_pages(kp, bt).transpose(1, 2).repeat_interleave(g, dim=1)
        vr = gather_pages(vp, bt).transpose(1, 2).repeat_interleave(g, dim=1)
        mask = (torch.arange(n * page, device=dev)[None, :] < cur[:, None])[:, None, None, :]
        qt = q[:, :, None, :]
        rows = sum(lens)
        nbytes = 2 * (2 * rows * kv * hd + q.numel() + got.numel()) + 4 * (bt.numel() + b)
        b_ms, b_by = bound(4 * h * hd * rows, nbytes)
        cases.append({
            "shape": f"{label}: B={b} n={n} page={page} P={p} H={h} KV={kv} hd={hd} cur_len={lens} bf16",
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: pa.paged_decode_attention(q, kp, vp, bt, cur)),
            "plain_ms": time_ms(torch, lambda: pa.plain_decode(q, kp, vp, bt, cur)),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kr, vr, attn_mask=mask)),
            "library": "scaled_dot_product_attention on the pre-gathered contiguous cache",
            "gather_ms": time_ms(torch, lambda: (gather_pages(kp, bt), gather_pages(vp, bt))),
            "bound_ms": b_ms,
            "bound_by": b_by,
        })
    out["paged_decode_attention"] = cases

    cases = []
    # qwen3-moe-30b-a3b's paged chunk (32/4 heads of 128) draws from a
    # generator of its own, so that every other case draws what it drew before
    gen_qwen3 = torch.Generator(device=dev).manual_seed(17)
    # (C, start, valid rows, H, KV, hd, generator): a 37-token prompt padded
    # to 64, a chunk from 192, a 300-token prompt padded to 512, a 5-row
    # chunk from 37 (llama3.2-1b, 32/8 heads of 64); qwen3's 512-row chunk
    for c, start, valid, h, kv, hd, g_case in (
        (64, 0, 37, 32, 8, 64, gen), (64, 192, 64, 32, 8, 64, gen), (512, 0, 300, 32, 8, 64, gen),
        (5, 37, 5, 32, 8, 64, gen), (512, 0, 300, 32, 4, 128, gen_qwen3),
    ):
        n, page, p = 32, 16, 321
        kp, vp, bt = _paged_inputs(torch, g_case, 1, n, page, p, kv, hd)
        q = torch.randn(1, c, h, hd, generator=g_case, device=dev).to(torch.bfloat16)
        st = torch.tensor([start], dtype=torch.int32, device=dev)
        got = pa.paged_chunk_attention(q, kp, vp, bt, st)
        torch.cuda.synchronize()
        err = max_err(torch, got, pa.plain_chunk(q, kp, vp, bt, st))
        check(torch.equal(got, pa.paged_chunk_attention(q, kp, vp, bt, st)),
              f"paged_chunk_attention C={c} start={start} H={h}/{kv} is not deterministic")
        g = h // kv
        qt = q.transpose(1, 2)
        kr = gather_pages(kp, bt).transpose(1, 2).repeat_interleave(g, dim=1)
        vr = gather_pages(vp, bt).transpose(1, 2).repeat_interleave(g, dim=1)
        limit = start + torch.arange(c, device=dev)
        mask = (torch.arange(n * page, device=dev)[None, :] <= limit[:, None])[None, None]
        pairs = c * start + c * (c + 1) // 2  # (row, visible column) pairs: all C rows are computed
        nbytes = 2 * (q.numel() + got.numel() + 2 * min(start + c, n * page) * kv * hd) + 4 * (n + 1)
        b_ms, b_by = bound(4 * h * hd * pairs, nbytes)
        ms = time_ms(torch, lambda: pa.paged_chunk_attention(q, kp, vp, bt, st))
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kr, vr, attn_mask=mask))
        gather_ms = time_ms(torch, lambda: (gather_pages(kp, bt), gather_pages(vp, bt)))
        cases.append({
            "shape": f"B=1 C={c} start={start} valid={valid} n={n} page={page} P={p} H={h} KV={kv} hd={hd} bf16",
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": time_ms(torch, lambda: pa.plain_chunk(q, kp, vp, bt, st)),
            "library_ms": library_ms,
            "library": "scaled_dot_product_attention on the pre-gathered contiguous cache",
            "gather_ms": gather_ms,
            "vs_library": ms / library_ms,
            "vs_library_and_gather": ms / (library_ms + gather_ms),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "bound_share": b_ms / ms,
        })
    out["paged_chunk_attention"] = cases
    return out


# --------------------------------------------------------------- serve phase

PROMPT_LENS = (37, 128, 300)
NEW_TOKENS = 16
MAX_LEN = 512
# The fused platforms of the phases whose traffic is serial ``invoke`` (the
# dense and paged serve phases, the profile phases). Such traffic gives the
# scheduler no tail (its p95 reads 0), and an edge's first sync wait there
# holds the callee's cold first run on the card, so the reference's default
# promotion (``promote_wait_s`` 50 ms) would merge edges at their first
# observation, before the leaf edge has been seen twice, and the measured
# merge costs then outgrow what the leaf edge's short waits save: the chain
# stops short (qwen3-moe-30b-a3b at 2 instances). Promotion is turned off
# here; the batched phase keeps load_bench's knobs.
SERVE_POLICY = {"min_observations": 2, "merge_cost_s": 0.0, "promote_wait_s": float("inf")}
TRACE_TOL = 1e-9  # |residual| of a conserved trace, seconds
OVERHEAD_MIN = 0.97  # tracing on / off requests/s of fused-batched (load_bench.py:1464-1478)


def pad_caches(torch, cache: dict, pad: int) -> dict:
    """A prefill's cache with its attention caches ((layers, B, S, KV, hd))
    grown by ``pad`` sequence slots; SSM states are not length-indexed."""
    if "attn" in cache:  # the hybrid
        return {**cache, "attn": pad_caches(torch, cache["attn"], pad)}
    if "k" in cache:
        return {n: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, pad)) for n, c in cache.items()}
    return cache


def direct_generate(torch, model, params, tokens, steps: int, max_len: int):
    """The model without the platform: prefill_fn + decode_fn in a loop."""
    t = tokens.shape[1]
    logits, cache = model.prefill_fn(params, {"tokens": tokens})
    cache = pad_caches(torch, cache, max_len - t)
    cur = torch.full((tokens.shape[0],), t, dtype=torch.int32, device=tokens.device)
    out = [torch.argmax(logits, -1)[:, None].to(torch.int32)]
    for _ in range(steps - 1):
        logits, cache = model.decode_fn(params, {"tokens": out[-1], "cur_len": cur}, cache)
        cur = cur + 1
        out.append(torch.argmax(logits, -1)[:, None].to(torch.int32))
    return torch.cat(out, dim=1)


def layers_below(cfg, engine) -> dict:
    """For each member of ``engine``'s chain, the attention, SSM and MoE
    layers that one invocation entering there applies (it runs the chain
    from that member down)."""
    names = engine.chain_names()
    if cfg.family == "hybrid":  # embed -> core -> head: the core holds every layer
        every = {"attn": cfg.num_layers // cfg.shared_attn_every, "ssm": cfg.num_layers, "moe": 0}
        none = {"attn": 0, "ssm": 0, "moe": 0}
        return {n: none if n == names[-1] else every for n in names}
    per = cfg.num_layers // len(engine.group_names)
    out = {}
    for i, n in enumerate(names):
        layers = per * sum(1 for m in names[i:] if m in engine.group_names)
        out[n] = {"attn": 0 if cfg.family == "ssm" else layers, "ssm": layers if cfg.family == "ssm" else 0,
                  "moe": layers if cfg.family == "moe" else 0}
    return out


def moe_layer_runs(cfg, engine, client_invocations: int, checked_members) -> int:
    """How many MoE layers a run applied: each client invocation runs the
    whole chain; each canary a merge's health check replayed runs the chain
    from its member down, twice (through the live path and the new unit)."""
    if cfg.family != "moe":
        return 0
    below = layers_below(cfg, engine)
    return client_invocations * cfg.num_layers + sum(2 * below[m]["moe"] for m in checked_members)


def expected_launches(cfg, engine, prefills: int, decodes: int, replays) -> dict:
    """The attention and SSD launches a run makes: K3 once per attention
    layer and K6 once per SSM layer of each prefill, K4 once per attention
    layer of each decode step (an SSM decode step is the recurrent form, no
    kernel); ``prefills`` and ``decodes`` client invocations run the whole
    chain, and each replayed canary ``(member, is_prefill)`` runs it from its
    member down twice (the live path and the new unit)."""
    below = layers_below(cfg, engine)
    entry = below[engine.entry]
    exp = {"flash_attention": prefills * entry["attn"], "decode_attention": decodes * entry["attn"],
           "ssd_scan": prefills * entry["ssm"]}
    for member, is_prefill in replays:
        layers = below[member]
        if is_prefill:
            exp["flash_attention"] += 2 * layers["attn"]
            exp["ssd_scan"] += 2 * layers["ssm"]
        else:
            exp["decode_attention"] += 2 * layers["attn"]
    return exp


def record_replays(platform) -> list:
    """Record, for every canary a merge's health check fetches to replay,
    its member and whether it was a prefill (T > 1) or a decode step."""
    replays = []
    fetch = platform.handler.canary

    def canary(name):
        args = fetch(name)
        if args is not None:
            x = args[0]["tokens"] if isinstance(args[0], dict) else args[0]
            replays.append((name, x.shape[1] > 1))
        return args

    platform.handler.canary = canary
    return replays


def footprints(platform) -> list:
    """Each live instance's counted footprint (``resident_bytes``), its eager
    compiled entries' recorded workspace and output bytes (the largest of
    each entry's sum is what is counted) and its graphs' shared pool (the
    graphs' static bytes are in ``graphs``)."""
    out = []
    for inst in platform.registry.live_instances():
        entries = inst.entry_bytes()
        out.append({"instance": inst.instance_id, "resident_bytes": inst.resident_bytes(),
                    "entries": len(entries), "workspace_bytes": [w for w, _ in entries],
                    "output_bytes": [o for _, o in entries], "graph_pool_bytes": inst.graph_pool_bytes()})
    return out


def graph_summary(platform, label: str) -> dict:
    """The live instances' compiled entries (``FunctionInstance.graph_stats``),
    checked: a decode entry (its first argument holds one token per
    sequence: (B, 1, ...)) that ran twice is captured, and at least one is
    replayed. A key seen once (a prompt length, a frozen prefix-hit step)
    stays eager: it is captured at its second run."""
    entries = [dict(g, instance=inst.instance_id) for inst in platform.registry.live_instances()
               for g in inst.graph_stats()]
    decode = [g for g in entries if g["bucket"] is None and len(g["arg_shape"]) >= 2 and g["arg_shape"][1] == 1]
    eager = [g for g in decode if g["runs"] >= 2 and not g["captured"]]
    check(not eager, f"{label}: decode entries that ran twice and were not captured: {eager}")
    check(any(g["replays"] for g in decode), f"{label}: no decode entry was replayed from a graph: {decode}")
    captured = [g for g in entries if g["captured"]]
    return {"entries": len(entries), "captured": len(captured),
            "decode_replays": sum(g["replays"] for g in decode),
            "captured_entries": [{k: g[k] for k in ("entry", "bucket", "arg_shape", "replays", "static_bytes",
                                                   "pool_bytes", "launches_per_replay")} for g in captured]}


def serve_phase(torch, dev, cfg, prompt_lens=PROMPT_LENS, new_tokens=NEW_TOKENS,
                max_len=MAX_LEN, params=None, dispatch_window: bool = False) -> dict:
    """Drive the serving chain unfused and fused on ``dev`` (``params``:
    the model's weights, made from seed 0 when not given). On the card it
    also checks that the kernels, and never their plain versions, ran, each
    exactly as often as the run's prefills, decode steps and canary replays
    make it (:func:`expected_launches`; K5 three times per MoE layer
    applied); on the CPU the plain attention versions stand in. Every
    platform traces (:func:`serve_traces`); with ``dispatch_window`` each
    platform then serves the first prompt twice more and a third time with
    the dispatch tracer armed (:func:`dispatch_window`)."""
    from repro_torch.core import FusionPolicy, TinyTorchBackend
    from repro_torch.kernels import build, ops
    from repro_torch.models.model import build_model
    from repro_torch.obs import prometheus_text
    from repro_torch.serving.engine import ServingEngine

    model = build_model(cfg)
    t0 = time.perf_counter()
    if params is None:
        params = model.init(0, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(7)
    prompts = [torch.randint(0, cfg.vocab_size, (1, t), generator=gen, device=dev, dtype=torch.int32)
               for t in prompt_lens]

    platforms = {
        "unfused": TinyTorchBackend(FusionPolicy(enabled=False)),
        "fused": TinyTorchBackend(FusionPolicy(**SERVE_POLICY)),
    }
    results = {}
    replays = {label: record_replays(p) for label, p in platforms.items()}
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
            platform.merger.wait_idle()  # no merge (and no canary replay) still in flight
            results[label] = {
                "tokens": tokens[label],
                "p50_token_ms": statistics.median(lats[label]) * 1e3,
                "tokens_per_s": len(lats[label]) / sum(lats[label]),
                "ram_bytes": platform.ram_bytes(),
                "footprints": footprints(platform),
                "live_instances": len(platform.registry.live_instances()),
                "merges": [(m.members, m.healthy) for m in platform.merger.merge_log],
                "replayed": [n for m in platform.merger.merge_log for n in m.checked_members],
                "graphs": graph_summary(platform, label) if dev.type == "cuda" else None,
            }
            check([n for n, _ in replays[label]] == results[label]["replayed"],
                  f"{label}: replayed canaries {replays[label]} against the merge log's {results[label]['replayed']}")
        counts, parts = ops.counts(), build.LAUNCHES.parts()
        dispatch = None
        if dispatch_window:
            dispatch = {label: serve_dispatch(torch, engines[label], prompts[0], new_tokens)
                        for label in platforms}
        traces = {label: serve_traces(p, label, len(engines[label].chain_names()), new_tokens)
                  for label, p in platforms.items()}
        traces["prometheus_lines"] = len(prometheus_text(platforms["fused"]).splitlines())
    finally:
        for platform in platforms.values():
            platform.shutdown()

    chain = set(engines["fused"].chain_names())  # embed, g0..g{G-1}, head
    check(results["unfused"]["live_instances"] == len(chain),
          f"unfused chain should hold {len(chain)} instances, has {results['unfused']['live_instances']}")
    check(results["fused"]["live_instances"] == 1,
          f"fused chain should hold 1 instance, has {results['fused']['live_instances']}")
    check(any(ok and set(m) == chain for m, ok in results["fused"]["merges"]),
          "no healthy merge of the whole chain in merge_log")
    check(results["fused"]["ram_bytes"] < results["unfused"]["ram_bytes"],
          f"fused ram_bytes is not below unfused: {results['fused']['ram_bytes']} vs "
          f"{results['unfused']['ram_bytes']}; fused {results['fused']['footprints']}, "
          f"{results['fused']['graphs']}; unfused {results['unfused']['footprints']}, {results['unfused']['graphs']}")
    invocations = len(prompt_lens) * new_tokens  # per platform: a prefill and new_tokens - 1 steps
    moe_runs = sum(moe_layer_runs(cfg, engines[label], invocations, results[label]["replayed"])
                   for label in platforms)
    expected = {"moe_gmm": 3 * moe_runs}
    for label in platforms:
        for k, n in expected_launches(cfg, engines[label], len(prompt_lens), len(prompt_lens) * (new_tokens - 1),
                                      replays[label]).items():
            expected[k] = expected.get(k, 0) + n
    for i, t in enumerate(prompt_lens):
        a, b = results["unfused"]["tokens"][i], results["fused"]["tokens"][i]
        check(a.shape == (1, new_tokens), f"prompt {t}: tokens of shape {tuple(a.shape)}")
        check(torch.equal(a, b), f"prompt {t}: greedy tokens differ fused vs unfused")
    for k, want in expected.items():
        if dev.type == "cuda":
            check(counts[k] == want, f"{k} launched {counts[k]} times, the run makes {want} ({counts})")
        elif k in STAND_INS:
            check(counts[STAND_INS[k]] == want, f"{STAND_INS[k]} ran {counts[STAND_INS[k]]} times for {want}")
    if dev.type == "cuda":
        check(all(counts[k] == 0 for k in PLAIN), f"the main path called a plain version on the card: {counts}")

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
        "footprints": {k: r["footprints"] for k, r in results.items()},
        "live_instances": {k: r["live_instances"] for k, r in results.items()},
        "tokens_identical": True,
        "launches": {k: counts[k] for k in ("flash_attention", "decode_attention", "moe_gmm", "ssd_scan")},
        "launch_parts": {part: {k: n[k] for k in ("flash_attention", "decode_attention", "moe_gmm", "ssd_scan")}
                         for part, n in parts.items()},
        "expected_launches": expected,
        "graphs": {k: r["graphs"] for k, r in results.items()},
        "p50_fused_over_unfused": results["fused"]["p50_token_ms"] / results["unfused"]["p50_token_ms"],
        "plain_calls": {k: counts[k] for k in PLAIN},
        "moe_layers_applied": moe_runs,
        "canary_replays": {label: len(r["replayed"]) for label, r in results.items()},
        "prefill_replays": {label: sum(p for _, p in replays[label]) for label in platforms},
        "prefills": prefills,
        "decode_steps": decode_steps,
        "launches_per_request": {
            "flash_attention_per_prefill": counts["flash_attention"] / prefills,
            "decode_attention_per_decode_step": counts["decode_attention"] / decode_steps,
            "ssd_scan_per_prefill": counts["ssd_scan"] / prefills,
        },
        "first_tokens": results["fused"]["tokens"][0][0, :8].tolist(),
        "distinct_tokens": len(set(torch.cat(results["fused"]["tokens"], dim=1).flatten().tolist())),
        "trace": traces,
        "dispatch": dispatch,
    }


def serve_traces(platform, label: str, chain_len: int, new_tokens: int) -> dict:
    """The serve phase's traces on one platform, checked: the recorder
    dropped nothing and every finished trace conserves (|residual| <=
    TRACE_TOL); every unfused ``invoke`` trace holds the chain's
    ``chain_len - 1`` cross-function-sync spans, every fused one that began
    after the last healthy merge none; the control timeline holds the
    fused-inline events of the fused unit's programs and one merge span per
    healthy merge, its seconds its ``MergeEvent.build_s``. Returns the
    counts and the decode steps' phase shares (``execute``,
    ``cross-function-sync``, ``unattributed``; a generate is a prefill and
    ``new_tokens - 1`` decode steps)."""
    from repro_torch.obs import CONTROL_TRACE_ID, attribute, build_trees, summarize

    recorder = platform.tracer.recorder
    records = recorder.snapshot()
    check(recorder.dropped() == 0, f"{label}: the flight recorder dropped {recorder.dropped()} records")
    results = attribute(records)
    bad = [r for r in results if not r["conserved"] or abs(r["residual_s"]) > TRACE_TOL]
    check(not bad, f"{label}: {len(bad)} traces do not conserve: {bad[:2]}")
    trees = build_trees(records)
    invokes = [r for r in results if r["kind"] == "invoke"]
    merges = [m for m in platform.merger.merge_log if m.healthy]
    after = merges[-1].t_completed if merges else float("inf")
    hops = [sum(1 for s in trees[r["trace_id"]].values() if s.cat == "cross-function-sync") for r in invokes]
    fused_after = [h for r, h in zip(invokes, hops) if trees[r["trace_id"]][1].t0 > after]
    if label == "unfused":
        check(set(hops) == {chain_len - 1}, f"unfused traces hold {set(hops)} sync spans, not {chain_len - 1}")
    else:
        check(fused_after and set(fused_after) == {0},
              f"fused traces after the merge hold {set(fused_after)} sync spans ({len(fused_after)} traces)")
    control = [r for r in records if r.trace_id == CONTROL_TRACE_ID]
    spans = [r for r in control if r.ph == "X" and r.name.startswith("merge:")]
    inline = sum(1 for r in control if r.name.startswith("fused-inline:"))
    check(len(spans) == len(merges), f"{label}: {len(spans)} merge spans for {len(merges)} healthy merges")
    check(all(r.args["seconds"] == m.build_s and abs(r.dur_s - m.build_s) <= TRACE_TOL
              for r, m in zip(spans, merges)), f"{label}: merge spans differ from build_s")
    check(label == "unfused" or inline > 0, f"{label}: no fused-inline event on the control timeline")
    steps = [r for i, r in enumerate(invokes) if i % new_tokens
             and (label == "unfused" or trees[r["trace_id"]][1].t0 > after)]
    shares = summarize(steps)["phase_share"]
    return {"traces": len(results), "invokes": len(invokes), "conserved": True,
            "max_abs_residual_s": max((abs(r["residual_s"]) for r in results), default=0.0),
            "sync_spans_per_invoke": sorted(set(hops)), "fused_invokes_after_merge": len(fused_after),
            "merge_spans_s": [r.args["seconds"] for r in spans], "fused_inline_events": inline,
            "decode_steps": len(steps),
            "decode_phase_share": {k: shares.get(k, 0.0) for k in ("execute", "cross-function-sync",
                                                                    "unattributed")}}


def dispatch_window(torch, run, requests: int, capacity: int) -> dict:
    """``run()`` with the dispatch tracer armed, checked as the reference's
    serve gate (load_bench.py:1194-1208): no new program (compiled entry,
    graph capture or batched bucket), and host syncs within one batched
    fetch per decode step plus seating and finishing per request plus the
    batch's capacity. ``cuda_syncs`` counts every synchronizing CUDA call
    (``torch.cuda.set_sync_debug_mode``), the syncs that end each execution
    included; reported beside the budget."""
    from repro_torch.analysis.dispatch import TRACER

    base = TRACER.snapshot()
    TRACER.arm()
    try:
        run()
    finally:
        TRACER.disarm()
    d = TRACER.delta(base)
    budget = d.decode_steps + 2 * requests + capacity
    check(d.decode_steps > 0, "dispatch: the window took no decode step")
    check(d.compiles == 0, f"dispatch: the steady state made new programs: {d}")
    check(d.host_syncs <= budget, f"dispatch: {d.host_syncs} host syncs over the budget {budget}: {d}")
    return {"decode_steps": d.decode_steps, "requests": requests, "capacity": capacity,
            "host_syncs": d.host_syncs, "budget": budget, "entries": d.entries, "captures": d.captures,
            "buckets": d.buckets, "cuda_syncs": d.cuda_syncs, "eager_kernel_calls": d.kernel_calls}


def serve_dispatch(torch, engine, prompt, new_tokens: int) -> dict:
    """The serve phase's steady state: the prompt served twice more (every
    entry of the window has then run twice: its graph is captured), then a
    third time with the dispatch tracer armed."""
    for _ in range(2):
        engine.generate({"tokens": prompt}, steps=new_tokens)
    return dispatch_window(torch, lambda: engine.generate({"tokens": prompt}, steps=new_tokens), 1, 1)


# ---------------------------------------------------------- paged serve phase

PAGED_REQUESTS = 24
PAGED_STEPS = 24  # load_bench's --steps: generation lengths 18-30
PAGE = 16
CAPACITY = 8
SHARED_PREFIX = 128


def paged_requests(cfg, prompt_lens=PROMPT_LENS, n_requests=PAGED_REQUESTS, steps=PAGED_STEPS,
                   prefix_len=SHARED_PREFIX, seed=0):
    """The paged serve phase's requests, made on the host from ``seed``:
    prompts of ``prompt_lens`` in turn; request 3 repeats request 0 and
    request 4 repeats request 1 (whole-prompt hits: the frozen K1 step, and
    copy-on-write of a shared partial tail page); the (up to 8) prompts
    longer than the prefix begin with one shared ``prefix_len``-token
    prefix (shared pages, K2 from ``start > 0``). Generation lengths follow
    load_bench's formula (``run_serve``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab_size, prefix_len)
    prompts, shared = [], 0
    for i in range(n_requests):
        t = prompt_lens[i % len(prompt_lens)]
        if i in (3, 4):
            p = prompts[i - 3][0]
        elif t > prefix_len and shared < 8:
            p = np.concatenate([prefix, rng.integers(0, cfg.vocab_size, t - prefix_len)])
            shared += 1
        else:
            p = rng.integers(0, cfg.vocab_size, t)
        prompts.append(np.asarray(p, np.int32)[None, :])
    gens = [max(6, steps + ((i * 7) % 13) - 6) for i in range(n_requests)]
    return prompts, gens


def serve_paged(torch, engine, prompts, gens, capacity, warm_prompts) -> dict:
    """One run of the continuous batcher over ``engine``'s arena: warm-up
    (one request per prompt shape and one whole-prompt repeat), then the
    measured requests, all submitted at once. The kernel counts are set to
    0 just before the measured requests and read just after them."""
    from repro_torch.kernels import build, ops
    from repro_torch.scheduler.metrics import percentiles_ms
    from repro_torch.serving.continuous import ContinuousBatcher

    arena, platform = engine.arena, engine.platform
    cb = ContinuousBatcher(engine, capacity=capacity)
    try:
        for f in [cb.submit({"tokens": w}, 3) for w in warm_prompts]:
            f.result(timeout=600)
        cb.submit({"tokens": warm_prompts[0]}, 3).result(timeout=600)
        platform.meter.reset()
        cb.reset_stats()
        hits0, cow0 = arena.shared_hits, arena.cow_copies
        if engine.device.type == "cuda":
            torch.cuda.synchronize()
        ops.reset_counts()
        t0 = time.perf_counter()
        futs = [cb.submit({"tokens": p}, g) for p, g in zip(prompts, gens)]
        results = [f.result(timeout=600) for f in futs]
        elapsed = time.perf_counter() - t0
        counts, parts = ops.counts(), build.LAUNCHES.parts()
        stats = cb.stats()
    finally:
        cb.shutdown()
    traces = conserved_traces(platform, "paged")
    for r, g in zip(results, gens):
        check(r["tokens"].shape == (1, g), f"a request returned {r['tokens'].shape[1]} of {g} tokens")
    arena.check_consistency()
    check(arena.used_pages() == 0, f"{arena.used_pages()} pages still held after the run")
    itl = [x for r in results for x in r["step_s"]]
    pct = percentiles_ms(itl, points=(50, 95))
    bill = platform.meter.arena_summary()
    n_tokens = sum(r["tokens"].shape[1] for r in results)
    return {
        "tokens": [r["tokens"] for r in results],
        "tokens_per_s": n_tokens / elapsed,
        "elapsed_s": elapsed,
        "itl_p50_ms": pct["p50_ms"],
        "itl_p95_ms": pct["p95_ms"],
        "mean_occupancy": stats["mean_occupancy"],
        "decode_steps": stats["steps"],
        "prefill_chunks": stats["prefill_chunks"],
        "mean_pages_per_request": bill["mean_pages"],
        "mean_billed_pages_per_request": bill["mean_billed_pages"],
        "arena_gb_s": bill["gb_s"],
        "shared_hits": arena.shared_hits - hits0,
        "cow_copies": arena.cow_copies - cow0,
        "live_instances": len(platform.registry.live_instances()),
        "ram_bytes": platform.ram_bytes(),
        "footprints": footprints(platform),
        "counts": counts,
        "launch_parts": parts,
        "graphs": graph_summary(platform, "paged") if engine.device.type == "cuda" else None,
        "traces": traces,
    }


def conserved_traces(platform, label: str) -> dict:
    """Every finished trace of the platform conserves (the batcher's
    ``serve`` traces through chunked prefill and copy-on-write included) and
    the recorder dropped nothing; returns the traces by kind."""
    from repro_torch.obs import attribute

    recorder = platform.tracer.recorder
    check(recorder.dropped() == 0, f"{label}: the flight recorder dropped {recorder.dropped()} records")
    results = attribute(recorder.snapshot())
    bad = [r for r in results if not r["conserved"] or abs(r["residual_s"]) > TRACE_TOL]
    check(not bad, f"{label}: {len(bad)} traces do not conserve: {bad[:2]}")
    kinds: dict[str, int] = {}
    for r in results:
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    return kinds


def paged_dispatch(torch, engine, prompts, gens, capacity: int) -> dict:
    """The paged serve path's steady state: the measured requests served
    once more by a new batcher (every entry of the window has then run
    twice: its graph is captured), then again with the dispatch tracer
    armed."""
    from repro_torch.serving.continuous import ContinuousBatcher

    cb = ContinuousBatcher(engine, capacity=capacity)

    def serve():
        for f in [cb.submit({"tokens": p}, g) for p, g in zip(prompts, gens)]:
            f.result(timeout=600)

    try:
        serve()
        return dispatch_window(torch, serve, len(prompts), capacity)
    finally:
        cb.shutdown()


def paged_block_check(torch, engine, lens, seed=3) -> list:
    """One batched paged decode step against the dense decode step from the
    same prompt state, block by block on the same input: each prompt's
    dense prefill cache is both kept (K4's side) and scattered into the
    arena (K1's side). Returns each block's contribution's difference over
    its max."""
    import numpy as np

    from repro_torch import tree
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import embed_tokens

    cfg, arena, dev = engine.cfg, engine.arena, engine.device
    rng = np.random.default_rng(seed)
    kind = tfm.layer_kind(cfg)
    per = cfg.num_layers // len(engine.group_names)
    dense, sids, first = [], [], []
    for i, t in enumerate(lens):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, t)).astype(np.int32)).to(dev)
        logits, caches, _ = engine.prefill({"tokens": toks})
        sid = ("block-check", i)
        arena.alloc(sid, t)
        arena.write_prefill(sid, caches, t)
        arena.extend(sid, t + 1)
        dense.append(caches)
        sids.append(sid)
        first.append(torch.argmax(logits, -1).to(torch.int32))
    errs = []
    try:
        with torch.no_grad():
            bt = torch.from_numpy(np.stack([arena.block_row(s, engine.block_width) for s in sids])).to(dev)
            cur = torch.tensor(lens, dtype=torch.int32, device=dev)
            x = embed_tokens(engine.params["embed"], torch.stack(first))  # (B, 1, d)
            for layer in range(cfg.num_layers):
                lp = tree.map(lambda a: a[layer], engine.params["blocks"])
                stage, j = f"g{layer // per}", layer % per
                cache = {kv: torch.cat([c[stage][kv][j] for c in dense]) for kv in ("k", "v")}
                y_dense, _ = tfm.apply_block_decode(lp, x, cache, cfg, kind, cur)
                pages = arena.data[stage]
                y_paged, _, _ = tfm.apply_block_decode_paged(lp, x, pages["k"][j], pages["v"][j], bt, cfg,
                                                             kind, cur)
                errs.append(rel_err(y_paged - x, y_dense - x))
                x = y_dense
    finally:
        for sid in sids:
            arena.free(sid)
    return errs


def paged_serve_phase(torch, dev, cfg, prompt_lens=PROMPT_LENS, n_requests=PAGED_REQUESTS,
                      steps=PAGED_STEPS, max_len=MAX_LEN, page=PAGE, capacity=CAPACITY,
                      prefix_len=SHARED_PREFIX, small_cfg=None, params=None,
                      dispatch: bool = False) -> dict:
    """The paged continuous-batching serve path: ``ServingEngine(...,
    kv_pages=(capacity + 2) * max_len / page + 1)`` (load_bench's arena
    size) and ``ContinuousBatcher(engine, capacity)`` with the default chunk
    budget, fused (the chain fused on dense traffic first, as load_bench's
    ``run_serve`` warms it) and then unfused, with the same requests. On
    the card it also checks that K1 and K2, and never a plain version, ran.
    Then one batched paged decode step against the dense one, block by
    block, and a small model (``small_cfg``) served by the batcher against
    per-request generate. ``params``: the model's weights, made from seed 0
    when not given. With ``dispatch``, the fused run ends with the dispatch
    tracer armed over its steady state (:func:`paged_dispatch`)."""
    import numpy as np

    from repro_torch.core import FusionPolicy, TinyTorchBackend
    from repro_torch.models.model import build_model
    from repro_torch.serving.continuous import ContinuousBatcher
    from repro_torch.serving.engine import ServingEngine

    model = build_model(cfg)
    if params is None:
        params = model.init(0, device=dev)
    prompts, gens = paged_requests(cfg, prompt_lens, n_requests, steps, prefix_len)
    warm_rng = np.random.default_rng(1)
    warm = [warm_rng.integers(0, cfg.vocab_size, (1, t)).astype(np.int32) for t in prompt_lens]
    kv_pages = (capacity + 2) * (max_len // page) + 1
    runs, block_errs = {}, None
    for label, policy in (("fused", FusionPolicy(**SERVE_POLICY)),
                          ("unfused", FusionPolicy(enabled=False))):
        platform = TinyTorchBackend(policy)
        try:
            engine = ServingEngine(model, platform, max_len=max_len, params=params, device=dev,
                                   kv_pages=kv_pages, kv_page_size=page)
            # dense traffic first: the fusing platform merges the chain here
            engine.generate({"tokens": torch.from_numpy(warm[0]).to(dev)}, steps=6)
            platform.merger.wait_idle()
            run = serve_paged(torch, engine, prompts, gens, capacity, warm)
            run["merges"] = [(m.members, m.healthy) for m in platform.merger.merge_log]
            run["chain"] = set(engine.chain_names())
            runs[label] = run
            if label == "fused" and dispatch:
                run["dispatch"] = paged_dispatch(torch, engine, prompts, gens, capacity)
            if label == "fused":
                block_errs = paged_block_check(torch, engine, [t + 5 * i for i, t in
                                                                enumerate(prompt_lens * 3)][:capacity])
        finally:
            platform.shutdown()

    fused, unfused = runs["fused"], runs["unfused"]
    check(unfused["live_instances"] == len(unfused["chain"]),
          f"unfused chain should hold {len(unfused['chain'])} instances, has {unfused['live_instances']}")
    check(fused["live_instances"] == 1, f"fused chain should hold 1 instance, has {fused['live_instances']}")
    check(any(ok and set(m) == fused["chain"] for m, ok in fused["merges"]),
          "no healthy merge of the whole chain in merge_log")
    check(fused["ram_bytes"] < unfused["ram_bytes"],
          f"paged: fused ram_bytes is not below unfused: {fused['ram_bytes']} vs {unfused['ram_bytes']}; "
          f"fused {fused['footprints']}, {fused['graphs']}; unfused {unfused['footprints']}, {unfused['graphs']}")
    check(fused["shared_hits"] > 0, "no request hit the shared-prefix cache")
    check(max(block_errs) <= BLOCK_TOL,
          f"a block's paged decode step differs from its dense one beyond {BLOCK_TOL}: {block_errs}")
    kernels = ("paged_decode_attention", "paged_chunk_attention") + (("moe_gmm",) if cfg.family == "moe" else ())
    if dev.type == "cuda":
        for label, run in runs.items():
            c = run["counts"]
            check(all(c[k] > 0 for k in kernels), f"{label}: the paged serve path did not launch {kernels}: {c}")
            check(all(c[k] == 0 for k in PLAIN), f"{label}: a plain version ran on the card: {c}")

    # a small model served by the batcher gives per-request generate's tokens
    small = build_model(small_cfg or cfg)
    rng = np.random.default_rng(2)
    small_prompts = [rng.integers(0, small.cfg.vocab_size, (1, t)).astype(np.int32) for t in (9, 23, 40)]
    platform = TinyTorchBackend(FusionPolicy(min_observations=2, merge_cost_s=0.0))
    try:
        engine = ServingEngine(small, platform, max_len=64, device=dev, kv_pages=25, kv_page_size=16)
        refs = [engine.generate({"tokens": torch.from_numpy(p).to(dev)}, steps=8)[0].cpu().numpy()
                for p in small_prompts]
        cb = ContinuousBatcher(engine, capacity=4)
        try:
            got = [f.result(timeout=600)["tokens"] for f in
                   [cb.submit({"tokens": p}, 8) for p in small_prompts]]
        finally:
            cb.shutdown()
    finally:
        platform.shutdown()
    for t, (a, b) in zip((9, 23, 40), zip(got, refs)):
        check(np.array_equal(a, b), f"small model, prompt {t}: batcher tokens {a} != generate {b}")

    agree = [bool(np.array_equal(a, b)) for a, b in zip(fused["tokens"], unfused["tokens"])]
    check(all(agree), f"fused and unfused tokens differ in {agree.count(False)} of {len(agree)} requests")
    keys = ("tokens_per_s", "itl_p50_ms", "itl_p95_ms", "mean_occupancy", "decode_steps",
            "prefill_chunks", "mean_pages_per_request", "mean_billed_pages_per_request",
            "arena_gb_s", "shared_hits", "cow_copies", "live_instances", "ram_bytes", "footprints", "elapsed_s",
            "graphs", "traces")
    return {
        "arch": cfg.name,
        "layers": cfg.num_layers,
        "d_model": cfg.d_model,
        "requests": n_requests,
        "prompt_lens": list(prompt_lens),
        "gen_lens": gens,
        "capacity": capacity,
        "max_len": max_len,
        "page": page,
        "kv_pages": kv_pages,
        **{k: {label: run[k] for label, run in runs.items()} for k in keys},
        "launches": {label: {k: run["counts"][k] for k in kernels} for label, run in runs.items()},
        "launch_parts": {label: {part: {k: n[k] for k in kernels} for part, n in run["launch_parts"].items()}
                         for label, run in runs.items()},
        "plain_calls": {label: {k: run["counts"][k] for k in PLAIN} for label, run in runs.items()},
        "block_rel_err": block_errs,
        "small_model_tokens_identical": True,
        "fused_vs_unfused_identical_requests": sum(agree),
        "dispatch": fused.get("dispatch"),
    }


# ------------------------------------------------------------- batched phase

BATCH_CLIENTS = 8  # load_bench's closed loop (benchmarks/load_bench.py:1497-1504)
BATCH_PROMPT = 8
BATCH_WARMUP = 8
BATCH_STEPS = 48
BATCH_MAX = 8
BATCH_DELAY_MS = 2.0
GATE_ROUNDS = 8  # interleaved tracing on / off rounds of the overhead gate (on, off, off, on, ...)
GATE_STEPS = 24  # decode steps per client and round
LANE_TOL = 2e-2  # a lane's logits and caches vs the same request's invoke, over max |value|


def closed_loop(torch, engine, clients, batched: bool, warmup: int, steps: int) -> dict:
    """load_bench's closed loop: one thread per client, each taking
    ``warmup`` then ``steps`` decode steps (``decode_step_async`` and the
    future's result when ``batched``, else ``decode_step``) with a constant
    fed token; returns requests/s and the timed steps' percentiles."""
    import threading

    from repro_torch.scheduler.metrics import percentiles_ms

    lats = [[] for _ in clients]

    def drive(i: int, n: int, barrier, timed: bool) -> None:
        c = clients[i]
        barrier.wait()
        for _ in range(n):
            t0 = time.perf_counter()
            if batched:
                _, c["caches"] = engine.decode_step_async(c["token"], c["cur_len"], c["caches"]).result()
            else:
                _, c["caches"] = engine.decode_step(c["token"], c["cur_len"], c["caches"])
            if timed:
                lats[i].append(time.perf_counter() - t0)
            c["cur_len"] = c["cur_len"] + 1

    elapsed = 0.0
    for n, timed in ((warmup, False), (steps, True)):
        barrier = threading.Barrier(len(clients))
        threads = [threading.Thread(target=drive, args=(i, n, barrier, timed)) for i in range(len(clients))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        elapsed = time.perf_counter() - t0
    flat = [x for lat in lats for x in lat]
    check(len(flat) == steps * len(clients), f"{len(flat)} timed steps of {steps * len(clients)}")
    return {"requests": len(flat), "elapsed_s": elapsed, "requests_per_s": len(flat) / elapsed,
            **percentiles_ms(flat)}


def batched_phase(torch, dev, cfg, clients=BATCH_CLIENTS, prompt_len=BATCH_PROMPT, warmup=BATCH_WARMUP,
                  steps=BATCH_STEPS, max_len=MAX_LEN, params=None) -> dict:
    """The main path's two modes on one fused platform (``max_batch`` 8,
    ``max_delay_ms`` 2): ``clients`` closed-loop clients, each prefilled
    once with a random prompt and its own max_len caches, feeding a constant
    token; first ``fused-serial`` (``invoke``), then ``fused-batched``
    (``invoke_async`` -> the scheduler -> one vmapped program per
    power-of-two bucket, captured at its second run). Checks: batches of 2
    or more formed, the decode entry never fell back to per-request
    execution, K4 launched exactly once per layer of each program run, K4
    at the lanes' own caches under vmap equal in bits to K4 per lane, and
    each lane of a batched step that the captured bucket programs served
    against the same request's ``invoke`` (:func:`lane_check`)."""
    from repro_torch.core import FusionPolicy, TinyTorchBackend
    from repro_torch.core.function import _capture_device
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import decode_attention as k4
    from repro_torch.models.model import build_model
    from repro_torch.obs import prometheus_text
    from repro_torch.serving.engine import ServingEngine, _greedy_token

    model = build_model(cfg)
    if params is None:
        params = model.init(0, device=dev)
    captures = _capture_device(params) is not None  # the card captures; the CPU runs every program eagerly
    gen = torch.Generator(device=dev).manual_seed(13)
    platform = TinyTorchBackend(FusionPolicy(min_observations=2, merge_cost_s=0.0), max_batch=BATCH_MAX,
                                max_delay_ms=BATCH_DELAY_MS)
    try:
        engine = ServingEngine(model, platform, max_len=max_len, params=params, device=dev)
        warm = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=gen, device=dev, dtype=torch.int32)
        engine.generate({"tokens": warm}, steps=6)  # observe, fuse, warm up (load_bench's warm())
        platform.merger.wait_idle()
        check(len(platform.registry.live_instances()) == 1, "batched: the chain did not fuse")
        state = []
        for _ in range(clients):
            prompt = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=gen, device=dev,
                                   dtype=torch.int32)
            logits, caches, cur = engine.prefill({"tokens": prompt})
            state.append({"token": _greedy_token(logits), "cur_len": cur, "caches": caches})

        # K4 under vmap at the main path's shape and layout: layer 0 of the
        # lanes' stacked layer-first caches (lanes, L, B, S, KV, hd), read in place
        k, v = (torch.stack([c["caches"]["g0"][n] for c in state]) for n in ("k", "v"))
        q = torch.randn(clients, 1, cfg.num_heads, cfg.head_dim, generator=gen, device=dev).to(k.dtype)
        cur = torch.stack([c["cur_len"] for c in state]) + 1
        with torch.no_grad():
            lanes = torch.func.vmap(lambda q, k, v, c: k4.decode_attention(q, k[0], v[0], c))(q, k, v, cur)
            loop = torch.stack([k4.decode_attention(q[i], k[i, 0], v[i, 0], cur[i]) for i in range(clients)])
        check(torch.equal(lanes, loop), "K4 under vmap differs in bits from K4 per lane")

        start = [c["cur_len"] for c in state]

        def window(n: int) -> dict:
            """``n`` more batched steps per client from the prefilled length
            (the caches' rows there are rewritten), so that the extra windows
            stay inside max_len and each does the same work."""
            for c, cur in zip(state, start):
                c["cur_len"] = cur
            return closed_loop(torch, engine, state, True, 0, n)


        batches0 = platform.scheduler.stats()["batches"]
        ops.reset_counts()
        serial = closed_loop(torch, engine, state, False, warmup, steps)
        batched = closed_loop(torch, engine, state, True, warmup, steps)
        counts, parts = ops.counts(), build.LAUNCHES.parts()
        sched = platform.scheduler.stats()
        fallbacks = platform.batching_stats()
        traces = batched_traces(platform, clients * (warmup + steps))
        gate_steps = min(GATE_STEPS, steps)
        dispatch = dispatch_window(torch, lambda: window(gate_steps), clients * gate_steps, BATCH_MAX)
        traces["overhead"] = overhead_gate(platform, window, gate_steps, dev.type == "cuda")
        traces["prometheus_lines"] = len(prometheus_text(platform).splitlines())
        lane_err, lane_replays = lane_check(torch, engine, platform, state, captures)
        graphs = graph_summary(platform, "batched") if captures else None
    finally:
        platform.shutdown()
    runs = clients * (warmup + steps) + sched["batches"] - batches0  # decode program runs
    check(sched["max_batch_seen"] >= 2, f"batched: no batch of 2 or more formed ({sched})")
    check(all(not f["fallback_requests"] for f in fallbacks.values()),
          f"batched: requests fell back to per-request execution: {fallbacks}")
    k4_name = "decode_attention" if dev.type == "cuda" else STAND_INS["decode_attention"]
    check(counts[k4_name] == cfg.num_layers * runs,
          f"{k4_name} ran {counts[k4_name]} times, {runs} decode program runs make {cfg.num_layers * runs}")
    buckets = None
    if captures:
        buckets = sorted({g["bucket"] for g in graphs["captured_entries"] if g["bucket"] is not None})
        check(buckets, "batched: no bucket program was captured")
    return {
        "arch": cfg.name, "layers": cfg.num_layers, "clients": clients, "prompt_len": prompt_len,
        "warmup_steps": warmup, "steps": steps, "max_batch": BATCH_MAX, "max_delay_ms": BATCH_DELAY_MS,
        "fused_serial": serial, "fused_batched": batched,
        "batched_over_serial_requests_per_s": batched["requests_per_s"] / serial["requests_per_s"],
        "max_batch_seen": sched["max_batch_seen"], "mean_batch": sched["mean_batch"],
        "batches": sched["batches"] - batches0, "buckets_captured": buckets,
        "decode_program_runs": runs, "decode_attention_launches": counts[k4_name],
        "launch_parts": {part: n["decode_attention"] for part, n in parts.items()},
        "lane_rel_err": lane_err, "lane_check_bucket_replays": lane_replays, "k4_vmap_bits_equal": True,
        "batch_fallbacks": fallbacks,
        "graphs": graphs,
        "trace": traces,
        "dispatch": dispatch,
    }


def batched_traces(platform, requests: int) -> dict:
    """The batched mode's traces, checked: the recorder dropped nothing;
    each of the ``requests`` ``invoke_async`` traces tiles its wall time
    exactly (queue-wait, window-wait, batch-compute: residual 0.0); the
    batch traces its members reference are exactly the batch traces."""
    from repro_torch.obs import attribute, summarize

    recorder = platform.tracer.recorder
    records = recorder.snapshot()
    check(recorder.dropped() == 0, f"batched: the flight recorder dropped {recorder.dropped()} records")
    results = attribute(records)
    reqs = [r for r in results if r["kind"] == "invoke_async"]
    check(len(reqs) == requests, f"batched: {len(reqs)} invoke_async traces for {requests} requests")
    bad = [r for r in reqs if not r["conserved"] or r["residual_s"] != 0.0]
    check(not bad, f"batched: {len(bad)} invoke_async traces do not tile their wall time: {bad[:2]}")
    batches = {r["trace_id"] for r in results if r["kind"] == "batch"}
    refs = {r.args["batch_trace"] for r in records
            if r.cat == "batch-compute" and r.args and "batch_trace" in r.args}
    check(batches and refs == batches, f"batched: {len(refs)} referenced batch traces, {len(batches)} minted")
    return {"invoke_async_traces": len(reqs), "batch_traces": len(batches), "residual_s": 0.0,
            "phase_share": summarize(reqs)["phase_share"]}


def overhead_gate(platform, window, steps: int, gate: bool, rounds: int = GATE_ROUNDS) -> dict:
    """load_bench's tracing-overhead gate (load_bench.py:1464-1478) on the
    batched mode: requests/s with tracing on over requests/s with it off
    (``Tracer.enabled``, which ``tracing=False`` sets) must be at least
    OVERHEAD_MIN. Interleaved rounds on one warm platform (on, off, off,
    on, ...), ``window(steps)`` each; one retry, as the reference has it.
    Checked where ``gate`` (on the card); the CPU reports the ratio only."""
    order = [True, False, False, True] * (rounds // 4)
    formed = {True: [0, 0], False: [0, 0]}  # requests and batches per mode, all attempts

    def attempt() -> float:
        done = {True: [0, 0.0], False: [0, 0.0]}
        try:
            for on in order:
                platform.tracer.enabled = on
                b0 = platform.scheduler.stats()["batches"]
                r = window(steps)
                formed[on][0] += r["requests"]
                formed[on][1] += platform.scheduler.stats()["batches"] - b0
                done[on][0] += r["requests"]
                done[on][1] += r["elapsed_s"]
        finally:
            platform.tracer.enabled = True
        return (done[True][0] / done[True][1]) / (done[False][0] / done[False][1])

    ratios = [attempt()]
    if ratios[0] < OVERHEAD_MIN:
        ratios.append(attempt())
    if gate:
        check(ratios[-1] >= OVERHEAD_MIN, f"batched: tracing on / off requests/s {ratios} < {OVERHEAD_MIN}")
    return {"on_over_off_requests_per_s": ratios, "rounds": rounds, "steps_per_round": steps,
            "mean_batch": {"on": formed[True][0] / formed[True][1], "off": formed[False][0] / formed[False][1]}}


def lane_check(torch, engine, platform, state, captures: bool, attempts: int = 4):
    """Each lane of one batched decode step against the same request's
    ``invoke``: logits and caches within LANE_TOL of max |value| (the
    batched einsums may choose other cuBLAS algorithms). Where programs are
    captured, the lanes are taken from a step whose every batch was a
    replay of a captured bucket program (a bucket's first run is eager and
    its second captures it; the timed loop has run both), so the replayed
    graph itself is held against ``invoke``: its stacked static inputs, the
    caches donated under vmap, the split of its pool into lanes. Returns
    (each lane's error, the bucket replays of the checked step)."""
    import threading

    from repro_torch import tree

    (unit,) = platform.registry.live_instances()

    def bucket_replays() -> int:
        return sum(g["replays"] for g in unit.graph_stats() if g["bucket"] is not None)

    want = [engine.decode_step(c["token"], c["cur_len"], c["caches"]) for c in state]
    for _ in range(attempts):
        batches0, replays0 = platform.scheduler.stats()["batches"], bucket_replays()
        barrier = threading.Barrier(len(state))
        got = [None] * len(state)

        def one(i):
            barrier.wait()
            got[i] = engine.decode_step_async(state[i]["token"], state[i]["cur_len"], state[i]["caches"]).result()

        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(state))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        batches, replays = platform.scheduler.stats()["batches"] - batches0, bucket_replays() - replays0
        if not captures or replays == batches:
            break
    check(not captures or replays == batches > 0,
          f"batched: no step in {attempts} was served by captured bucket programs alone "
          f"(last: {batches} batches, {replays} bucket replays)")
    lane_err = [max(rel_err(a, b) for a, b in zip(tree.leaves(g), tree.leaves(w))) for g, w in zip(got, want)]
    check(max(lane_err) <= LANE_TOL, f"batched lanes differ from invoke beyond {LANE_TOL}: {lane_err}")
    return lane_err, replays


def rel_err(a, b) -> float:
    """max |a - b| over max |b|, in float32 on the host."""
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).abs().max() / b.abs().max())


def small_config(cfg):
    """``cfg`` reduced (2 layers; the hybrid 5) at width 256 with the head
    dims the kernels take (attention heads of 64; SSM heads of 64 over a
    state of 64): the small model of the card-vs-host and batcher checks."""
    import dataclasses

    from repro_torch.configs import reduced_config

    changes: dict = {"d_model": 256}
    if cfg.num_heads:
        changes["d_head"] = 64
    if cfg.ssm_state:
        changes.update(ssm_head_dim=64, ssm_state=64)
    return dataclasses.replace(reduced_config(cfg), **changes)


def attention_fan_in_d(params, cfg) -> None:
    """Rescale, in place, every attention block's wq and wk as if drawn with
    the fan-in d_model instead of the JAX init rule's H and KV (axis -2 of
    (d, H, hd)). Under the JAX rule a small model's attention is near-hard
    (scores of std ~100), and a hybrid's prefill logits move by 20-54 % of
    max |logit| when K6's output is rounded once instead of twice (6 of 8
    seeds on the host); with fan-in d, by at most 1 %."""
    import math

    for key, sub in params.items():
        if key == "attn":
            sub["wq"].mul_(math.sqrt(cfg.num_heads / cfg.d_model))
            sub["wk"].mul_(math.sqrt(cfg.num_kv_heads / cfg.d_model))
        elif isinstance(sub, dict):
            attention_fan_in_d(sub, cfg)


def small_model_check(torch, dev, small_cfg, prompt_len: int = 37, fan_in_d: bool = False) -> dict:
    """The small model on ``dev`` against the same bf16 weights on the
    host's CPU (the plain versions): prefill and one decode step, end to end,
    within REF_TOL of max |logit|; ``fan_in_d``: its attention projections
    rescaled by :func:`attention_fan_in_d`."""
    from repro_torch import tree
    from repro_torch.models.model import build_model

    def prefill_and_decode(model, p, toks, nxt):
        logits, cache = model.prefill_fn(p, {"tokens": toks})
        cache = pad_caches(torch, cache, 1)
        cur = torch.full((toks.shape[0],), toks.shape[1], dtype=torch.int32, device=toks.device)
        step, _ = model.decode_fn(p, {"tokens": nxt, "cur_len": cur}, cache)
        return logits, step

    gen = torch.Generator(device=dev).manual_seed(5)
    with torch.no_grad():
        small = build_model(small_cfg)
        params = small.init(0, device=dev)
        if fan_in_d:
            attention_fan_in_d(params, small_cfg)
        toks = torch.randint(0, small.cfg.vocab_size, (1, prompt_len), generator=gen, device=dev,
                             dtype=torch.int32)
        nxt = torch.argmax(small.prefill_fn(params, {"tokens": toks})[0], -1)[:, None].to(torch.int32)
        here = prefill_and_decode(small, params, toks, nxt)
        host = prefill_and_decode(small, tree.map(lambda x: x.cpu(), params), toks.cpu(), nxt.cpu())
    for a in here:
        check(tuple(a.shape) == (1, small.cfg.vocab_size), f"logits of shape {tuple(a.shape)}")
        check(bool(torch.isfinite(a).all()), "non-finite logits")
    out = {"arch": small.cfg.name, "d_model": small.cfg.d_model, "layers": small.cfg.num_layers,
           "attention_fan_in_d": fan_in_d, "rel_err": [rel_err(a, b) for a, b in zip(here, host)]}
    check(max(out["rel_err"]) <= REF_TOL, f"small-input logits differ from the host's beyond {REF_TOL}: {out}")
    return out


def reference_phase(torch, dev, cfg, prompt_len: int = 37) -> dict:
    """The model on ``dev`` against the same bf16 weights on the host's CPU
    (the plain versions): a small input end to end, and the full width
    block by block."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import embed_tokens
    from repro_torch.models.model import build_model

    gen = torch.Generator(device=dev).manual_seed(5)
    out = {"small": small_model_check(torch, dev, small_config(cfg), prompt_len)}
    with torch.no_grad():
        model = build_model(cfg)
        params = model.init(0, device=dev)
        host_params = tree.map(lambda x: x.cpu(), params)
        toks = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=gen, device=dev,
                             dtype=torch.int32)
        kind = tfm.layer_kind(cfg)
        x = embed_tokens(params["embed"], toks)
        pos = torch.arange(prompt_len, device=dev)[None]
        blocks = []
        for i in range(cfg.num_layers):
            y, _ = tfm.apply_block_full(tree.map(lambda a: a[i], params["blocks"]), x, cfg, kind, pos)
            y_host, _ = tfm.apply_block_full(tree.map(lambda a: a[i], host_params["blocks"]),
                                             x.cpu(), cfg, kind, pos.cpu())
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


def device_profile(torch, run, steps: int) -> dict:
    """Where the time of ``run()`` (``steps`` invocations, ending in a
    device sync; returns its wall ms) goes: one run timed on the host clock,
    then one under torch.profiler for the device's kernel time, the host's
    top-level ops and the kernels that take most of it, per invocation."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    wall_ms = run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_wall_ms = run()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, list] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    device_ms = sum(sum(v) for v in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:10]
    return {
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
        # the port's own kernels, wherever they rank
        "port_kernels": {k: {"calls_per_step": sum(len(v) for n, v in by_name.items() if k in n) / steps,
                             "ms_per_step": sum(sum(v) for n, v in by_name.items() if k in n) / 1e3 / steps}
                         for k in PORT_KERNELS if any(k in n for n in by_name)},
    }


def profile_phase(torch, dev, cfg, prompt_len: int = 128, steps: int = 8,
                  max_len: int = MAX_LEN, params=None, prefill: bool = False, gap: bool = False) -> dict:
    """Where a fused decode step's time goes (:func:`device_profile` over
    ``steps`` decode steps) and, with ``prefill``, a fused prefill's (over
    ``steps`` prefills of the prompt, under "prefill"); with ``gap``, the
    split of a step's wall time beyond its kernels (:func:`step_gap`, under
    "step_gap"). ``params``: the model's weights, made from seed 0 when not
    given."""
    from repro_torch.core import FusionPolicy, TinyTorchBackend
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ServingEngine, _greedy_token

    model = build_model(cfg)
    if params is None:
        params = model.init(0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    prompt = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=gen, device=dev,
                           dtype=torch.int32)
    platform = TinyTorchBackend(FusionPolicy(**SERVE_POLICY))
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

        def run_prefills() -> float:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                engine.prefill({"tokens": prompt})
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        out = {"prompt_len": prompt_len, **device_profile(torch, run_steps, steps)}
        if prefill:
            out["prefill"] = device_profile(torch, run_prefills, steps)
        if gap:
            def step() -> None:
                nonlocal logits, caches, cur, tok
                logits, caches = engine.decode_step(tok, cur, caches)
                cur = cur + 1
                tok = _greedy_token(logits)

            out["step_gap"] = step_gap(torch, platform, step, 4 * steps)
    finally:
        platform.shutdown()
    return out


def step_gap(torch, platform, step, steps: int) -> dict:
    """Split a captured fused decode step's wall time beyond its kernel time
    (PERF.md's open question) into the copy-in of the arguments, the host's
    replay call, the gaps between the graph's nodes and the copy-out of the
    returned tree, and what is left (the platform's host code around the
    replay and the wait for the device). The decode entry's graph (the
    fused unit's most replayed one) is instrumented for ``steps`` calls of
    ``step()``: host clocks and CUDA events around the copy-in, the replay
    call and the copy-out. Its kernels (count and time per replay, from
    ``torch.profiler``) and its device time (``steps`` replays back to back,
    CUDA events, so the host's launch is hidden) come from bare replays of
    the graph, which touch only the graph's own static inputs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import function as fn_mod

    (unit,) = platform.registry.live_instances()
    graphs = [ce.graph for ce in list(unit._compiled.values()) if ce.graph is not None]
    cg = max(graphs, key=lambda g: g.replays)
    real, orig_sync, marks = cg.graph, fn_mod._synchronize, []

    def mark(name: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks[-1][name] = (time.perf_counter(), ev)

    class TimedGraph:  # stands in for the torch.cuda.CUDAGraph while measured
        def replay(self):
            mark("graph")
            real.replay()
            mark("copy_out")

    def replay(leaves, lanes=None):
        marks.append({})
        mark("copy_in")
        out = fn_mod.CapturedGraph.replay(cg, leaves, lanes)
        marks[-1]["done"] = (time.perf_counter(), None)
        return out

    def synchronize(dev) -> None:
        mark("sync")
        orig_sync(dev)

    walls = []
    cg.replay, cg.graph, fn_mod._synchronize = replay, TimedGraph(), synchronize
    try:
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            walls.append((time.perf_counter() - t0) * 1e3)
    finally:
        del cg.replay
        cg.graph, fn_mod._synchronize = real, orig_sync
    check(len(marks) == steps, f"step_gap: {len(marks)} replays of the decode graph in {steps} steps")

    def ms(a: str, b: str, device: bool) -> float:
        return statistics.median(m[a][1].elapsed_time(m[b][1]) if device else (m[b][0] - m[a][0]) * 1e3
                                 for m in marks)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            real.replay()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernel_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / steps
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(steps):
        real.replay()
    e1.record()
    torch.cuda.synchronize()
    graph_ms = e0.elapsed_time(e1) / steps
    wall = statistics.median(walls)
    parts = {
        "copy_in_ms": ms("copy_in", "graph", True),
        "replay_call_ms": ms("graph", "copy_out", False),
        "node_gaps_ms": graph_ms - kernel_ms if kernels else None,
        "copy_out_ms": ms("copy_out", "sync", True),
    }
    beyond = wall - kernel_ms
    return {
        "steps": steps, "wall_ms": wall, "kernel_ms": kernel_ms if kernels else None,
        "graph_nodes": len(kernels) / steps, "graph_device_ms": graph_ms, "beyond_kernels_ms": beyond,
        **parts,
        "rest_ms": beyond - sum(v for v in parts.values() if v is not None),
        "copy_in_host_ms": ms("copy_in", "graph", False), "copy_out_host_ms": ms("copy_out", "sync", False),
        "graph_in_step_device_ms": ms("graph", "copy_out", True), "sync_wait_ms": ms("sync", "done", False),
        "outside_replay_ms": wall - ms("copy_in", "done", False),
    }


MOE_AGREE = 0.99  # share of tokens whose top-k expert sets must agree, card vs host


def moe_block_phase(torch, dev, cfg, params, prompt_len: int = 37) -> dict:
    """One full-width MoE layer (``apply_moe`` with layer 0's weights) on the
    same bf16 input on ``dev`` (K5) and on the host's CPU (the plain
    version): how many tokens' top-k expert sets agree (a flip needs an fp32
    near-tie), and the outputs on the tokens that agree."""
    from repro_torch import tree
    from repro_torch.models import moe
    from repro_torch.models.layers import apply_norm, embed_tokens

    gen = torch.Generator(device=dev).manual_seed(13)
    toks = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=gen, device=dev, dtype=torch.int32)
    layer = tree.map(lambda a: a[0], params["blocks"])
    host = tree.map(lambda a: a.cpu(), layer["moe"])
    k = cfg.num_experts_per_tok
    with torch.no_grad():
        x = apply_norm(layer["ln2"], embed_tokens(params["embed"], toks), cfg)
        y, metrics = moe.apply_moe(layer["moe"], x, cfg)
        y_host, metrics_host = moe.apply_moe(host, x.cpu(), cfg)
        sets = moe.route(layer["moe"], x, cfg)[1].reshape(-1, k).sort(dim=-1).values.cpu()
        sets_host = moe.route(host, x.cpu(), cfg)[1].reshape(-1, k).sort(dim=-1).values
    agree = (sets == sets_host).all(dim=-1)
    y, y_host = y.float().cpu()[0], y_host.float()[0]
    check(bool(torch.isfinite(y).all()), "MoE layer output has non-finite values")
    err = float((y - y_host)[agree].abs().max() / y_host.abs().max())
    check(int(agree.sum()) >= MOE_AGREE * prompt_len,
          f"top-{k} expert sets agree for {int(agree.sum())} of {prompt_len} tokens only")
    check(err <= REF_TOL, f"MoE layer output, card vs host, differs by {err} of max |y| (limit {REF_TOL})")
    return {
        "tokens": prompt_len,
        "topk_sets_agree": int(agree.sum()),
        "rel_err_on_agreeing_tokens": err,
        "moe_dropped": {"card": float(metrics["moe_dropped"]), "host": float(metrics_host["moe_dropped"])},
        "moe_aux": {"card": float(metrics["moe_aux"]), "host": float(metrics_host["moe_aux"])},
    }


def model_blocks(cfg, params) -> list:
    """The SSM or hybrid model's blocks in the order a forward applies them:
    (name, kind, the block's weights)."""
    from repro_torch import tree

    layer = lambda stack, i: tree.map(lambda a: a[i], stack)  # noqa: E731
    if cfg.family == "ssm":
        return [(f"ssm_{i}", "ssm", layer(params["blocks"], i)) for i in range(cfg.num_layers)]
    hyb, every = params["hybrid"], cfg.shared_attn_every
    n_groups = cfg.num_layers // every
    out = []
    for g in range(n_groups):
        group = layer(hyb["groups"], g)
        out += [(f"ssm_{g * every + j}", "ssm", layer(group, j)) for j in range(every)]
        out.append((f"shared_{g}", "dense", hyb["shared"]))
    if "tail" in hyb:
        out += [(f"ssm_{n_groups * every + j}", "ssm", layer(hyb["tail"], j))
                for j in range(cfg.num_layers - n_groups * every)]
    return out


def ssm_block_phase(torch, dev, cfg, params, small_cfg, prompt_len: int = 37) -> dict:
    """The SSM and hybrid models' block checks on a random prompt of
    ``prompt_len`` + 1 tokens, each block on the input the previous ones
    give it: (1) the first SSM block and the first application of the
    shared block, full width on ``dev`` against the same bf16 weights on the
    host's CPU (the chunked scan and the plain attention there), relative to
    the block's own largest contribution, within BLOCK_TOL; (2) every
    block's prefill of T tokens plus one decode step against its prefill of
    T + 1 tokens (the recurrent step against K6's dual form; K4 against K3),
    relative to the block output's max |y| at row T (a contribution that is
    small beside the residual stream is rounded at the stream's scale in
    bf16, so its own max is no yardstick there), within BLOCK_TOL; (3) the
    small model end to end, card against host (:func:`small_model_check`,
    the hybrid's shared attention drawn with fan-in d so that rounding is
    not amplified)."""
    from repro_torch import tree
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import embed_tokens

    t = prompt_len
    gen = torch.Generator(device=dev).manual_seed(17)
    toks = torch.randint(0, cfg.vocab_size, (1, t + 1), generator=gen, device=dev, dtype=torch.int32)
    pos = torch.arange(t + 1, device=dev)[None]
    cur = torch.full((1,), t, dtype=torch.int32, device=dev)
    host, consistency = {}, {}
    with torch.no_grad():
        x = embed_tokens(params["embed"], toks)
        for name, kind, lp in model_blocks(cfg, params):
            y, _ = tfm.apply_block_full(lp, x, cfg, kind, pos)
            label = "ssm_block_0" if kind == "ssm" else "shared_block"
            if label not in host:
                y_host, _ = tfm.apply_block_full(tree.map(lambda a: a.cpu(), lp), x.cpu(), cfg, kind, pos.cpu())
                host[label] = rel_err(y - x, y_host - x.cpu())
            _, cache = tfm.apply_block_full(lp, x[:, :t], cfg, kind, pos[:, :t], collect_cache=True)
            if kind != "ssm":  # (k, v) of (B, T, KV, hd): one more slot for the step's write
                cache = {n: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 1)) for n, c in zip("kv", cache)}
            step, _ = tfm.apply_block_decode(lp, x[:, t:], cache, cfg, kind, cur)
            consistency[name] = rel_err(step[:, 0], y[:, t])
            x = y
    check(bool(torch.isfinite(x).all()), "non-finite hidden state after the last block")
    check(max(host.values()) <= BLOCK_TOL, f"a full-width block differs from the host's beyond {BLOCK_TOL}: {host}")
    worst = max(consistency, key=consistency.get)
    check(consistency[worst] <= BLOCK_TOL,
          f"block {worst}: prefill + decode differs from the longer prefill by {consistency[worst]}")
    return {
        "prompt_len": t,
        "card_vs_host_rel_err": host,
        "prefill_decode_rel_err": consistency,
        "prefill_decode_worst": [worst, consistency[worst]],
        "small": small_model_check(torch, dev, small_cfg, fan_in_d=True),
    }


def ssd_captured_case(torch, dev, cfg, params, prompt_len: int = 300) -> dict:
    """K6 against its plain version on the inputs the model's first SSM
    layer gives it for a random prompt (:func:`ssd_case`, captured): at full
    width with the JAX init rule, in_B and in_C have a fan-in of G = 1, so
    B and C reach a std of about sqrt(d_model) and the scores the thousands."""
    from repro_torch.models import ssm
    from repro_torch.models.layers import apply_norm, embed_tokens

    _, _, layer = model_blocks(cfg, params)[0]
    gen = torch.Generator(device=dev).manual_seed(19)
    toks = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=gen, device=dev, dtype=torch.int32)
    with torch.no_grad():
        u = apply_norm(layer["ln1"], embed_tokens(params["embed"], toks), cfg)
        *_, xh, bm, cm, dt = ssm.ssd_inputs(layer["ssm"], u, cfg)
        return ssd_case(torch, f"captured: {cfg.name} layer 0, T={prompt_len}", xh.contiguous(),
                        bm.contiguous(), cm.contiguous(), dt.contiguous(), layer["ssm"]["A_log"],
                        layer["ssm"]["D"], captured=True)


def kernels_line(kern: dict, launches: dict, by_path: dict, captured: dict, parts: dict) -> dict:
    """One entry per kernel: its source, the TPU kernel it replaces, its
    launches on the main path that runs it (``launch_parts``: made by eager
    runs and replayed from captured graphs; on every path of the run,
    ``launches_by_path``), and the kernel phase's figures at that path's
    shape (``main_case``: the serve shape of each); ``captured``: cases on
    a model's own inputs, held relative to max |y| (K6)."""
    paged = "src/repro_torch/kernels/csrc/paged_attention.cu"
    meta = {  # source, TPU kernel, index of the main path's case
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:73", 2),
        "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:59", 0),
        "paged_decode_attention": (paged, "src/repro/kernels/paged_attention.py:86", 0),
        "paged_chunk_attention": (paged, "src/repro/kernels/paged_attention.py:178", 2),
        "moe_gmm": ("src/repro_torch/kernels/csrc/moe_gmm.cu", "src/repro/kernels/moe_gmm.py:39", MOE_MAIN_CASE),
        "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu", "src/repro/kernels/ssd_scan.py:63", 0),
    }
    entries = []
    for name, cases in kern.items():
        source, replaces, main_case = meta[name]
        main = cases[main_case]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "launch_parts": parts[name], "launches_by_path": by_path.get(name, {}),
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["ms"], "kernel_ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "library": main.get("library", "scaled_dot_product_attention"),
            "shape": main["shape"], "cases": cases, "captured_cases": captured.get(name, []),
        })
    return {"kernels": entries}


def fresh_model(torch, dev, arch: str):
    """Free the earlier phases' tensors, then make ``arch`` at full width and
    depth with random bf16 weights from seed 0. Returns (cfg, params, the
    memory record: parameter bytes, init seconds, allocated GB after it)."""
    import gc

    from repro_torch.configs import get_arch
    from repro_torch.models.model import build_model
    from repro_torch.models.params import param_bytes

    gc.collect()  # the platforms of earlier phases hold reference cycles
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch(arch)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    memory = {"param_bytes": param_bytes(model.param_defs), "params_init_s": time.perf_counter() - t0,
              "after_init_gb": torch.cuda.memory_allocated() / 1e9}
    return cfg, params, memory


def moe_phases(torch, dev) -> dict:
    """Full-width qwen3-moe-30b-a3b at full depth (48 layers, random bf16
    weights from seed 0, made once after the llama phases' tensors are
    freed): the dense serve phase, the paged serve phase (the first 8
    requests), the MoE block check and a profiled decode step."""
    import dataclasses

    cfg, params, memory = fresh_model(torch, dev, "qwen3-moe-30b-a3b")
    t0 = time.perf_counter()
    serve = serve_phase(torch, dev, cfg, params=params)
    serve["params_init_s"] = memory["params_init_s"]
    serve["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps({"moe_serve": serve}), flush=True)
    print(f"moe serve phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)

    t0 = time.perf_counter()
    # the small model of the batcher-vs-generate check: capacity factor E / k,
    # so that no prompt drops a token (a drop depends on the call's row count)
    small = small_config(cfg)
    small = dataclasses.replace(small, capacity_factor=small.num_experts / small.num_experts_per_tok)
    paged = paged_serve_phase(torch, dev, cfg, n_requests=8, small_cfg=small, params=params)
    print(json.dumps({"moe_paged_serve": paged}), flush=True)
    print(f"moe paged serve phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)

    t0 = time.perf_counter()
    print(json.dumps({"moe_block": moe_block_phase(torch, dev, cfg, params)}), flush=True)
    print(json.dumps({"moe_profile": profile_phase(torch, dev, cfg, params=params, gap=True)}), flush=True)
    memory["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps({"moe_memory": memory}), flush=True)
    print(f"moe block and profile phases {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return {"launches": serve["launches"], "paged_launches": paged["launches"]["fused"],
            "parts": serve["launch_parts"]}


def ssm_phases(torch, dev, arch: str, key: str) -> dict:
    """Full-width ``arch`` (mamba2-370m or zamba2-7b) at full depth, random
    bf16 weights from seed 0, made after the earlier phases' tensors are
    freed: the serve phase (unfused, then fused to one instance; K6 once per
    SSM layer of each prefill), K6 on the inputs the first layer gives it,
    the block checks and a profiled fused decode step and prefill. Prints the
    ``<key>_serve``, ``<key>_block``, ``<key>_profile`` and ``<key>_memory``
    lines."""
    cfg, params, memory = fresh_model(torch, dev, arch)
    t0 = time.perf_counter()
    serve = serve_phase(torch, dev, cfg, params=params)
    serve["params_init_s"] = memory["params_init_s"]
    serve["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps({f"{key}_serve": serve}), flush=True)
    print(f"{key} serve phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)

    t0 = time.perf_counter()
    captured = ssd_captured_case(torch, dev, cfg, params)
    block = ssm_block_phase(torch, dev, cfg, params, small_config(cfg))
    print(json.dumps({f"{key}_block": {**block, "ssd_captured": captured}}), flush=True)
    print(json.dumps({f"{key}_profile": profile_phase(torch, dev, cfg, params=params, prefill=True)}),
          flush=True)
    memory["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps({f"{key}_memory": memory}), flush=True)
    print(f"{key} block and profile phases {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return {"launches": serve["launches"], "captured": captured, "parts": serve["launch_parts"]}


def chrome_export(path: Path) -> dict:
    """Every live tracer's records (the llama phases') as one Chrome
    ``trace_event`` file at ``path``, parsed back."""
    from repro_torch.obs import export_all_chrome

    path.parent.mkdir(parents=True, exist_ok=True)
    written = export_all_chrome(str(path))
    doc = json.loads(path.read_text())
    events = doc["traceEvents"]
    check(len(events) == written and all(ev["ph"] in ("X", "i", "M") for ev in events),
          f"chrome trace: {len(events)} events parsed back of {written} written")
    return {"path": str(path.relative_to(ROOT)), "events": len(events), "bytes": path.stat().st_size,
            "tracers": len({ev["pid"] for ev in events}),
            "spans": sum(1 for ev in events if ev["ph"] == "X")}


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
    print(json.dumps({"ptxas": ptxas_report(build.build_report())}), flush=True)

    from repro_torch.configs import get_arch

    from repro_torch.obs import retain_tracers

    cfg, dev = get_arch("llama3.2-1b"), torch.device("cuda")
    t0 = time.perf_counter()
    kern = kernel_phase(torch, F)
    print(json.dumps({"grad_refusal": grad_refusal_check(torch)}), flush=True)
    print(f"kernel phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    retain_tracers(True)  # the llama phases' traces outlive their platforms, for the export
    t0 = time.perf_counter()
    serve = serve_phase(torch, dev, cfg, dispatch_window=True)
    trace_serve, dispatch = serve.pop("trace"), {"serve": serve.pop("dispatch")}
    print(json.dumps({"serve": serve}), flush=True)
    print(json.dumps({"trace_serve": trace_serve}), flush=True)
    print(f"serve phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    t0 = time.perf_counter()
    paged = paged_serve_phase(torch, dev, cfg, small_cfg=small_config(cfg), dispatch=True)
    dispatch["paged_serve"] = paged.pop("dispatch")
    print(json.dumps({"paged_serve": paged}), flush=True)
    print(f"paged serve phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    t0 = time.perf_counter()
    print(json.dumps({"reference": reference_phase(torch, dev, cfg)}), flush=True)
    print(f"reference phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    t0 = time.perf_counter()
    print(json.dumps({"profile": profile_phase(torch, dev, cfg, gap=True)}), flush=True)
    print(f"profile phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    t0 = time.perf_counter()
    batched = batched_phase(torch, dev, cfg)
    trace_batched, dispatch["batched"] = batched.pop("trace"), batched.pop("dispatch")
    print(json.dumps({"batched": batched}), flush=True)
    print(json.dumps({"trace_batched": trace_batched}), flush=True)
    print(json.dumps({"dispatch": dispatch}), flush=True)
    print(f"batched phase {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    print(json.dumps({"chrome_trace": chrome_export(ROOT / "chiprun_out" / "trace_llama.json")}), flush=True)
    retain_tracers(False)

    moe = moe_phases(torch, dev)
    ssm = ssm_phases(torch, dev, "mamba2-370m", "ssm")
    hybrid = ssm_phases(torch, dev, "zamba2-7b", "hybrid")
    launches = {**serve["launches"], **paged["launches"]["fused"], "moe_gmm": moe["launches"]["moe_gmm"],
                "ssd_scan": ssm["launches"]["ssd_scan"] + hybrid["launches"]["ssd_scan"]}
    by_path = {name: {"llama3.2-1b": serve["launches"][name], "qwen3-moe-30b-a3b": moe["launches"][name],
                      "zamba2-7b": hybrid["launches"][name]} for name in ("flash_attention", "decode_attention")}
    by_path["ssd_scan"] = {"mamba2-370m": ssm["launches"]["ssd_scan"], "zamba2-7b": hybrid["launches"]["ssd_scan"]}
    for kernel in ("paged_decode_attention", "paged_chunk_attention"):
        by_path[kernel] = {"llama3.2-1b paged": paged["launches"]["fused"][kernel],
                           "qwen3-moe-30b-a3b paged": moe["paged_launches"][kernel]}
    by_path["moe_gmm"] = {"qwen3-moe-30b-a3b": moe["launches"]["moe_gmm"],
                          "qwen3-moe-30b-a3b paged": moe["paged_launches"]["moe_gmm"]}
    captured = {"ssd_scan": [ssm["captured"], hybrid["captured"]]}
    part_src = {"flash_attention": serve["launch_parts"], "decode_attention": serve["launch_parts"],
                "paged_decode_attention": paged["launch_parts"]["fused"],
                "paged_chunk_attention": paged["launch_parts"]["fused"], "moe_gmm": moe["parts"]}
    parts = {k: {p: src[p][k] for p in ("eager", "replayed")} for k, src in part_src.items()}
    parts["ssd_scan"] = {p: ssm["parts"][p]["ssd_scan"] + hybrid["parts"][p]["ssd_scan"]
                         for p in ("eager", "replayed")}
    print(json.dumps(kernels_line(kern, launches, by_path, captured, parts)), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
