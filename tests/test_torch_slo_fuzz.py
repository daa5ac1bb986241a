"""The reference's scheduler conservation fuzz (``tests/test_slo_fuzz.py``) on
the port's ``repro_torch.scheduler``: seeded random bursts of classes,
priorities and shapes through a real ``RequestScheduler``, with faults at
every observability seam. On every trace every submitted future resolves
exactly once with its own request's result (or the injected fault, or a
shed), no batch mixes classes or shapes, raising sinks and dispatches kill
no dispatcher, and the lock graph stays acyclic.

Payloads are 0-d tensors: the port's lanes key a non-tensor leaf by value
(``scheduler/batching.py: request_key``), so the reference's int payloads
would each get a lane of their own. Where the reference pauses on the wall
clock (``time.sleep``) so that windows sometimes expire, the port's tests
wait for the requests already submitted to resolve (state the test can see);
each test has its own time limit and fails on a hang."""
import random
import threading
import time
from concurrent.futures import Future, wait

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # the suite runs several workers at once: leave them cores

from repro_torch.analysis.lockorder import LockGraph, patched_locks  # noqa: E402
from repro_torch.scheduler.adaptive import PRIORITY_HIGH  # noqa: E402
from repro_torch.scheduler.coalescer import AdmissionQueue, PendingRequest  # noqa: E402
from repro_torch.scheduler.scheduler import OverloadShedError, RequestScheduler  # noqa: E402
from repro_torch.scheduler.slo import BEST_EFFORT, IMMEDIATE, SLOClass  # noqa: E402
from test_torch_kvpool import time_limit  # noqa: E402

CLASSES = [BEST_EFFORT, SLOClass("gold", 10.0), SLOClass("silver", 80.0), IMMEDIATE]
#: class identity rides in the payload, so that the dispatch can check that
#: a batch holds one class without the scheduler's internals
CLASS_TAG = {s.name: i for i, s in enumerate(CLASSES)}
RESOLVE_S = 30.0  # a bound on the real time every future may take


def resolved_once(futs, timeout: float = RESOLVE_S) -> dict:
    """Count each future's done-callbacks; wait (event-driven) until every
    future's has run, then return the counts."""
    cv = threading.Condition()
    counts: dict[int, int] = {}

    def stamp(idx):
        def cb(_fut):
            with cv:
                counts[idx] = counts.get(idx, 0) + 1
                cv.notify_all()
        return cb

    for idx, fut in futs:
        fut.add_done_callback(stamp(idx))
    with cv:
        assert cv.wait_for(lambda: len(counts) >= len(futs), timeout=timeout), "a done-callback never ran"
    return counts


@time_limit(90)
@pytest.mark.parametrize("seed", [0xC0FFEE, 7, 20260727])
def test_conservation_random_traces(seed):
    """``tests/test_slo_fuzz.py:48``: 250 requests in bursts of 1-12, four
    classes (a strict one half the time by priority), three argument
    structures; some batches raise from dispatch, every fifth request-level
    metrics call raises. The scheduler's locks (made under
    ``patched_locks``, lane conditions included, which are made lazily at
    the first submit of a key) record their acquisition order."""
    rng = random.Random(seed)
    n_requests = 250
    violations: list[str] = []
    fail_every = rng.randrange(7, 15)
    dispatched = {"batches": 0}

    def dispatch(name, args_list):
        dispatched["batches"] += 1
        if len({int(a[1]) for a in args_list}) != 1:
            violations.append(f"mixed-class batch: {args_list}")
        if len({len(a[2]) for a in args_list}) != 1:
            violations.append(f"mixed-shape batch: {args_list}")
        if dispatched["batches"] % fail_every == 0:
            raise RuntimeError("injected dispatch fault")
        return [int(a[0]) * 3 for a in args_list]

    calls = {"n": 0}

    def flaky_request_sink(name, lat_s, k):
        calls["n"] += 1
        if calls["n"] % 5 == 0:
            raise RuntimeError("injected metrics fault")

    lock_graph = LockGraph()
    lock_patch = patched_locks(lock_graph)
    lock_patch.__enter__()
    sched = RequestScheduler(dispatch, max_batch=rng.choice([2, 4, 8]), max_delay_ms=rng.choice([0.0, 1.0, 3.0]),
                             adaptive=rng.random() < 0.5, on_request_done=flaky_request_sink)
    futs: list[tuple[int, Future]] = []
    try:
        i = 0
        while i < n_requests:
            for _ in range(rng.randrange(1, 13)):
                if i >= n_requests:
                    break
                slo = rng.choice(CLASSES)
                shape = tuple(torch.tensor(0) for _ in range(rng.randrange(1, 4)))  # 1-3 leaves: distinct trees
                pri = PRIORITY_HIGH if (slo is IMMEDIATE and rng.random() < 0.5) else 0
                fut = sched.submit("f", (torch.tensor(i), torch.tensor(CLASS_TAG[slo.name]), shape),
                                   slo=None if pri else slo, priority=pri)
                futs.append((i, fut))
                i += 1
            if rng.random() < 0.3:  # let the open windows expire: the burst resolves before the next
                wait([f for _, f in futs], timeout=RESOLVE_S)
        counts = resolved_once(futs)
        done, not_done = wait([f for _, f in futs], timeout=RESOLVE_S)
        lock_patch.__exit__(None, None, None)
        lock_patch = None
        assert not not_done, f"{len(not_done)} futures hung (conservation violated)"
        lock_graph.assert_acyclic()
        assert lock_graph.edges(), "lock instrumentation never fired"
        assert not violations, violations[:3]
        ok = failed = shed = 0
        for idx, fut in futs:
            exc = fut.exception()
            if exc is None:
                assert fut.result() == idx * 3, f"request {idx} got another's result"
                ok += 1
            elif isinstance(exc, OverloadShedError):
                shed += 1  # a legitimate exactly-once resolution, never a hang
            else:
                assert "injected dispatch fault" in str(exc)
                failed += 1
        assert ok + failed + shed == n_requests
        assert failed > 0, "the fault schedule must actually have fired"
        assert len(counts) == n_requests and all(c == 1 for c in counts.values()), "a future resolved twice"
    finally:
        if lock_patch is not None:
            lock_patch.__exit__(None, None, None)
        sched.shutdown()
        lock_graph.assert_acyclic()  # shutdown's drain is part of the trace
    with pytest.raises(RuntimeError):
        sched.submit("f", (torch.tensor(0), torch.tensor(0), (torch.tensor(0),)))


@time_limit(60)
@pytest.mark.parametrize("seed", [3, 99])
def test_queue_level_on_batch_done_faults_never_strand_futures(seed):
    """``tests/test_slo_fuzz.py:166``: a batch-level observability callback
    that raises at random leaves no future unresolved and kills no
    dispatcher."""
    rng = random.Random(seed)

    def boom(name, batch, t_done):
        if rng.random() < 0.5:
            raise ValueError("injected on_batch_done fault")

    q = AdmissionQueue("f", lambda name, args_list: [int(a[0]) for a in args_list], max_batch=4,
                       max_delay_s=0.001, on_batch_done=boom)
    try:
        reqs = []
        for i in range(60):
            r = PendingRequest((torch.tensor(i),), Future(), time.perf_counter())
            q.put(r)
            reqs.append(r)
            if rng.random() < 0.2:  # let the window expire: what is queued resolves first
                wait([x.future for x in reqs], timeout=RESOLVE_S)
        done, not_done = wait([r.future for r in reqs], timeout=RESOLVE_S)
        assert not not_done
        assert [r.future.result() for r in reqs] == list(range(60))
        assert q.thread.is_alive()
    finally:
        q.stop()
        q.thread.join(timeout=RESOLVE_S)
    assert not q.thread.is_alive()


@time_limit(60)
def test_cancelled_future_cannot_kill_the_dispatcher():
    """``tests/test_slo_fuzz.py:198``: a client cancelling its queued future
    must not orphan the rest of its batch (the InvalidStateError path in
    ``_resolve``). The first request holds the lane's dispatcher inside
    dispatch (seen through an event, not waited out) while the rest queue."""
    entered, gate = threading.Event(), threading.Event()

    def dispatch(name, args_list):
        entered.set()
        assert gate.wait(RESOLVE_S)
        return [int(a[0]) for a in args_list]

    sched = RequestScheduler(dispatch, max_batch=4, max_delay_ms=0.0)
    try:
        first = sched.submit("f", (torch.tensor(0),))  # occupies the dispatcher
        assert entered.wait(RESOLVE_S)
        rest = [sched.submit("f", (torch.tensor(i),)) for i in range(1, 4)]
        assert rest[0].cancel()  # queued, not yet running: cancellable
        gate.set()
        done, not_done = wait([first] + rest[1:], timeout=RESOLVE_S)
        assert not not_done, "a cancelled co-batched future stranded the others"
        assert [f.result() for f in [first] + rest[1:]] == [0, 2, 3]
        assert sched.submit("f", (torch.tensor(9),)).result(timeout=RESOLVE_S) == 9  # dispatcher alive
    finally:
        gate.set()
        sched.shutdown()
