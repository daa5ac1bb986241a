"""Tracing's host work for one batched decode step, from the source tree
given as argv[1], on the host's CPU (no card, no model). Prints one JSON line.

A step of ``MEMBERS`` requests does what the batched path records with
tracing on: each member's trace minted as ``RequestScheduler.submit`` mints
it, the batch's own trace begun and activated as
``AdmissionQueue._run_batch`` does, one handler ``execute`` span inside it,
then the tree's own ``AdmissionQueue._emit_phases`` closing every member
and the batch. The requests themselves are made once, so only the tracing
is timed. The result is the least mean over ``REPEATS`` runs of ``STEPS``
steps, in microseconds. To compare two trees, run them in turn,
A, B, B, A:

    for t in parent change change parent; do python3 tools/trace_cost.py $t; done
"""
import json
import sys
import time
import types
from concurrent.futures import Future
from pathlib import Path

ROOT = Path(sys.argv[1]).resolve()
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.obs import Tracer  # noqa: E402
from repro_torch.scheduler.coalescer import AdmissionQueue, PendingRequest  # noqa: E402

MEMBERS, STEPS, REPEATS = 8, 20000, 5


def step(tracer: Tracer, lane, batch: list) -> None:
    clock = tracer.clock
    for req in batch:
        req.t_enqueue = clock.now()
        req.span = tracer.begin_request("llama/embed", "invoke_async", t0=req.t_enqueue,
                                        attrs={"slo": "best-effort"})
    t_exec = lane._t_open = clock.now()
    bctx = tracer.begin_request("batch:llama/embed", "batch", t0=t_exec, attrs={
        "lane": "llama/embed", "size": len(batch), "slo": "best-effort",
        "members": [r.span.trace_id for r in batch]})
    with tracer.activate(bctx):
        ctx, parent = tracer.current()
        sid = ctx.alloc_id()
        tracer.push(ctx, sid)
        tracer.pop()
        ctx.emit("execute:llama/embed", "execute", t_exec, clock.now(), parent_id=parent, span_id=sid,
                 args={"instance": 1, "batch": len(batch)})
    AdmissionQueue._emit_phases(lane, batch, t_exec, clock.now(), bctx)


def main() -> None:
    tracer = Tracer()
    lane = types.SimpleNamespace(_t_open=0.0)
    batch = [PendingRequest((), Future(), 0.0) for _ in range(MEMBERS)]
    for _ in range(1000):
        step(tracer, lane, batch)
    means = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step(tracer, lane, batch)
        means.append((time.perf_counter() - t0) / STEPS * 1e6)
    print(json.dumps({"tree": str(ROOT), "members": MEMBERS, "us_per_step": min(means),
                      "us_per_step_runs": means}))


if __name__ == "__main__":
    main()
