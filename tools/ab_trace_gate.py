"""Tracing on / off in the batched closed loop, and whether the batched
warm-up fuses, from the source tree given as argv[1] (full-width
llama3.2-1b, random weights from seed 0, on the card). Prints one JSON line.

The gate: 8 closed-loop clients (8-token prompts), one fused platform
(``max_batch`` 8, ``max_delay_ms`` 2), ``ROUNDS`` interleaved rounds (on,
off, off, on, ...) of ``STEPS`` timed ``decode_step_async`` steps per client
after ``WARMUP`` untimed ones; two attempts, each read as requests/s with
tracing on over requests/s with it off. The procedure is this file's own, so
two trees are measured the same way. The fusion trials: ``TRIALS`` fresh
platforms with ``load_bench``'s knobs (``min_observations`` 2,
``merge_cost_s`` 0, the default promotion) each take the batched phase's
warm-up (one 8-token prompt, 6 greedy tokens); each trial reports its live
instances, merges and the policy's reasons in order. The first trial
meets an empty executable index where the tree has one; later trials meet
the first's entries. To compare two trees, run them in one call, in the
order A, B, B, A:

    for t in parent change change parent; do python3 tools/ab_trace_gate.py $t; done
"""
import json
import sys
import threading
import time
from pathlib import Path

ROOT = Path(sys.argv[1]).resolve()
sys.path.insert(0, str(ROOT / "src"))
import torch  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import FusionPolicy, TinyTorchBackend  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import ServingEngine, _greedy_token  # noqa: E402

CLIENTS, PROMPT, MAX_BATCH, DELAY_MS, MAX_LEN = 8, 8, 8, 2.0, 512
ROUNDS, STEPS, WARMUP, ATTEMPTS, TRIALS = 32, 48, 4, 2, 4
LOAD_BENCH_POLICY = {"min_observations": 2, "merge_cost_s": 0.0}
SERVE_POLICY = {**LOAD_BENCH_POLICY, "promote_wait_s": float("inf")}


def closed_loop(engine, clients, warmup: int, steps: int) -> tuple[int, float]:
    """Each client thread takes ``warmup`` then ``steps`` batched decode
    steps; returns the timed requests and the timed window's seconds."""

    def drive(c, n, barrier):
        barrier.wait()
        for _ in range(n):
            _, c["caches"] = engine.decode_step_async(c["token"], c["cur_len"], c["caches"]).result()
            c["cur_len"] = c["cur_len"] + 1

    elapsed = 0.0
    for n in (warmup, steps):
        barrier = threading.Barrier(len(clients))
        threads = [threading.Thread(target=drive, args=(c, n, barrier)) for c in clients]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        elapsed = time.perf_counter() - t0
    return steps * len(clients), elapsed


def fusion_trial(model, params, dev, gen) -> dict:
    platform = TinyTorchBackend(FusionPolicy(**LOAD_BENCH_POLICY), max_batch=MAX_BATCH, max_delay_ms=DELAY_MS)
    reasons = []
    decide = platform.policy.decide

    def recording(caller, callee, *args, **kwargs):
        d = decide(caller, callee, *args, **kwargs)
        if d.reason not in ("edge already fused", "already in same fusion group"):
            reasons.append(f"{caller.split('/')[-1]}->{callee.split('/')[-1]}: {d.reason}")
        return d

    platform.policy.decide = recording
    try:
        engine = ServingEngine(model, platform, max_len=MAX_LEN, params=params, device=dev)
        warm = torch.randint(0, model.cfg.vocab_size, (1, PROMPT), generator=gen, device=dev, dtype=torch.int32)
        t0 = time.perf_counter()
        engine.generate({"tokens": warm}, steps=6)
        platform.merger.wait_idle()
        return {"live": len(platform.registry.live_instances()), "warmup_s": time.perf_counter() - t0,
                "merges": [{"members": len(m.members), "healthy": m.healthy, "build_s": m.build_s,
                            "warm": getattr(m, "warm", None)} for m in platform.merger.merge_log],
                "merge_cost_s": platform.policy.merge_cost_s, "reasons": reasons}
    finally:
        platform.shutdown()


def gate(model, params, dev, gen) -> dict:
    platform = TinyTorchBackend(FusionPolicy(**SERVE_POLICY), max_batch=MAX_BATCH, max_delay_ms=DELAY_MS)
    try:
        engine = ServingEngine(model, platform, max_len=MAX_LEN, params=params, device=dev)
        warm = torch.randint(0, model.cfg.vocab_size, (1, PROMPT), generator=gen, device=dev, dtype=torch.int32)
        engine.generate({"tokens": warm}, steps=6)
        platform.merger.wait_idle()
        live = len(platform.registry.live_instances())
        clients = []
        for _ in range(CLIENTS):
            prompt = torch.randint(0, model.cfg.vocab_size, (1, PROMPT), generator=gen, device=dev,
                                   dtype=torch.int32)
            logits, caches, cur = engine.prefill({"tokens": prompt})
            clients.append({"token": _greedy_token(logits), "cur_len": cur, "caches": caches})
        start = [c["cur_len"] for c in clients]
        closed_loop(engine, clients, WARMUP, STEPS)  # the bucket programs' first runs and captures
        ratios, rounds = [], []
        for _ in range(ATTEMPTS):
            done = {True: [0, 0.0], False: [0, 0.0]}
            for on in [True, False, False, True] * (ROUNDS // 4):
                platform.tracer.enabled = on
                for c, cur in zip(clients, start):
                    c["cur_len"] = cur
                n, s = closed_loop(engine, clients, WARMUP, STEPS)
                done[on][0] += n
                done[on][1] += s
                rounds.append([on, n / s])
            platform.tracer.enabled = True
            ratios.append((done[True][0] / done[True][1]) / (done[False][0] / done[False][1]))
        return {"live": live, "on_over_off": ratios, "rounds_requests_per_s": rounds}
    finally:
        platform.shutdown()


def main() -> None:
    dev = torch.device("cuda")
    build.load()
    model = build_model(get_arch("llama3.2-1b"))
    params = model.init(0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(13)
    t0 = time.perf_counter()
    trials = [fusion_trial(model, params, dev, gen) for _ in range(TRIALS)]
    out = {"tree": ROOT.name, "fusion_trials": trials, "gate": gate(model, params, dev, gen),
           "seconds": time.perf_counter() - t0}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
