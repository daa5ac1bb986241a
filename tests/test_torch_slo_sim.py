"""The reference's SLO-scheduler simulations (``tests/test_slo_sim.py``) on the
port's virtual clock: ``repro_torch.scheduler.{scheduler,coalescer,slo,clock}``
and ``repro_torch.serving.continuous.ContinuousBatcher``.

Arrivals land at exact simulated instants and windows expire because the
test advances the clock. Unlike the reference, no step settles on
``VirtualClock.wait_for_waiters``'s 5 ms grace window (the likely cause of
the reference's load-sensitive failures, ROADMAP Queue 3): the test waits,
event-driven, for state it can see — a lane parked on the clock in an open
window with nothing left to take, the batcher parked in a step whose
virtual deadline lies ahead, a future resolved. Each simulation ends with
the clock's real-time guard, and each test has its own time limit.

Payloads are 0-d tensors (:func:`req`): the port's lanes key a non-tensor
leaf by value (``scheduler/batching.py: request_key``), so an int payload
would get a lane of its own per request, as ``tests/test_torch_replicas.py``
notes."""
import time
from concurrent.futures import wait

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # the suite runs several workers at once: leave them cores

from repro_torch.core.billing import BillingMeter  # noqa: E402
from repro_torch.scheduler.adaptive import PRIORITY_HIGH  # noqa: E402
from repro_torch.scheduler.clock import VirtualClock  # noqa: E402
from repro_torch.scheduler.scheduler import RequestScheduler  # noqa: E402
from repro_torch.scheduler.slo import SLOClass  # noqa: E402
from repro_torch.serving.continuous import ContinuousBatcher  # noqa: E402
from repro_torch.serving.engine import PagedPrefillJob  # noqa: E402
from repro_torch.serving.kvpool import KVArena  # noqa: E402
from test_torch_kvpool import time_limit  # noqa: E402

#: real-time budget of one whole simulation (the reference's)
REAL_BUDGET_S = 10.0
#: a bound on the real time one settle may take; reaching it fails the test
SETTLE_S = 5.0


def parked_on(clock, cond) -> bool:
    """Whether a thread is parked in a clock wait on ``cond``."""
    with clock._mu:
        return id(cond) in clock._parked


def settle(clock, settled, what: str) -> None:
    """Wait until ``settled()`` holds, woken by every park and unpark on the
    clock (no grace window): the state the next advance or arrival must
    find. Fails after SETTLE_S of real time."""
    deadline = time.perf_counter() + SETTLE_S
    while True:
        with clock._mu:
            gen = clock._transitions
        if settled():
            return
        with clock._state_cv:
            if clock._transitions == gen:
                clock._state_cv.wait(max(0.0, deadline - time.perf_counter()))
        assert time.perf_counter() < deadline, f"never settled: {what}"


def lane(sched, slo_name: str = "best-effort"):
    lanes = [q for q in list(sched._queues.values()) if q.slo.name == slo_name]
    return lanes[0] if lanes else None


def window_parked(clock, sched, slo_name: str = "best-effort"):
    """The lane's dispatcher has taken every request into its open window
    and is parked on the clock (held under the lane's lock: it is inside
    its wait, not between a check and the wait)."""
    def settled():
        q = lane(sched, slo_name)
        if q is None:
            return False
        with q._cv:
            return not q._items and q._window_open and parked_on(clock, q._cv)
    return settled


def req(i: int):
    """A request's arguments: one 0-d tensor, so requests share a lane."""
    return (torch.tensor(i),)


def echo(name, argss):
    return [int(a[0]) for a in argss]


def make_sim(dispatch=None, **kw):
    clock = VirtualClock()
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_delay_ms", 16.0)
    sched = RequestScheduler(dispatch or echo, clock=clock, **kw)
    return clock, sched


# ------------------------------------------------- early-close regression


@time_limit(30)
def test_sim_strict_arrival_preempts_in_flight_window_timer():
    """``tests/test_slo_sim.py:354``: a PRIORITY_HIGH request arriving while a
    looser lane's window timer is mid-flight (1.98 simulated seconds left)
    preempts it: everything resolves with no more virtual time, every
    latency bounded by the 20 ms that passed before the urgent arrival."""
    clock, sched = make_sim(max_batch=8, max_delay_ms=2000.0)
    try:
        normal = [sched.submit("f", req(i)) for i in range(3)]
        settle(clock, window_parked(clock, sched), "the three requests in an open window")
        clock.advance(0.020)  # the window is now in flight, 1.98 s residual
        settle(clock, window_parked(clock, sched), "the window still open after 20 ms")
        urgent = sched.submit("f", req(99), priority=PRIORITY_HIGH)
        done, not_done = wait(normal + [urgent], timeout=SETTLE_S)
        assert not not_done, "strict arrival failed to preempt the window timer"
        assert urgent.result() == 99 and [f.result() for f in normal] == [0, 1, 2]
        st = sched.stats()
        assert st["p95_ms"] <= 20.0 + 0.5, st
        clock.assert_elapsed_real_below(REAL_BUDGET_S)
    finally:
        sched.shutdown()


@time_limit(30)
def test_sim_preempt_is_edge_triggered_not_latched():
    """``tests/test_slo_sim.py:381``: a preempt with no window open must not
    shorten the next window, or the lane would degrade to greedy dispatch
    after the first strict arrival."""
    batches = []
    clock, sched = make_sim(lambda n, a: (batches.append(len(a)), echo(n, a))[1], max_batch=4, max_delay_ms=16.0)
    try:
        # a strict arrival with NO best-effort window open anywhere
        assert sched.submit("f", req(0), priority=PRIORITY_HIGH).result(timeout=SETTLE_S) == 0
        f1 = sched.submit("f", req(1))
        settle(clock, window_parked(clock, sched), "the first request in its window")
        clock.advance(0.008)
        f2 = sched.submit("f", req(2))
        settle(clock, window_parked(clock, sched), "the second request in the same window")
        assert not f1.done(), "window closed early: preempt latched across batches"
        clock.advance(0.008)
        done, not_done = wait([f1, f2], timeout=SETTLE_S)
        assert not not_done
        assert batches[-1] == 2, "the full window must still coalesce the pair"
        clock.assert_elapsed_real_below(REAL_BUDGET_S)
    finally:
        sched.shutdown()


# ------------------------------------------------------ trough


@time_limit(30)
def test_sim_trough_ignores_best_effort_trickle_but_not_strict():
    """``tests/test_slo_sim.py:410``: the reconciler's trough detector
    considers deadline-bearing traffic only: a best-effort trickle does not
    block deferred control-plane work, a fresh strict arrival does."""
    clock, sched = make_sim(max_delay_ms=0.0)
    try:
        for i in range(5):
            assert sched.submit("f", req(i)).result(timeout=SETTLE_S) == i
            assert sched.is_trough(min_quiet_s=0.01), "best-effort trickle must not defeat the trough detector"
            clock.advance(0.005)
        sched.submit("f", req(9), slo=SLOClass("gold", 40.0)).result(timeout=SETTLE_S)
        assert not sched.is_trough(min_quiet_s=0.01), (
            "a fresh strict arrival means a stall would land on deadline traffic")
        clock.advance(0.02)
        assert sched.is_trough(min_quiet_s=0.01)
        clock.assert_elapsed_real_below(REAL_BUDGET_S)
    finally:
        sched.shutdown()


# ------------------------------- continuous batcher: chunked prefill sim


class _SimPlatform:
    def __init__(self, clock):
        self.clock = clock
        self.meter = BillingMeter(clock=clock)


class _SimEngine:
    """The reference's timing model of the paged ServingEngine
    (``tests/test_slo_sim.py:556``): the page bookkeeping is the port's real
    :class:`KVArena`; compute is replaced by virtual sleeps, ``per_token_s``
    per prompt token of prefill and ``step_s`` per decode step. Each sleep
    records its virtual deadline, so the test can see the batcher parked in
    a step that only an advance ends."""

    def __init__(self, clock, *, per_token_s=0.005, step_s=0.010, num_pages=64, page_size=8, block_width=16):
        self.platform = _SimPlatform(clock)
        self.clock = clock
        self.entry = "sim/embed"
        self.block_width = block_width
        self.per_token_s = per_token_s
        self.step_s = step_s
        self.deadline = -1.0
        self.arena = KVArena({"sim": 1}, num_pages=num_pages, page_size=page_size, kv_heads=1, head_dim=2,
                             dtype=torch.float32, device="cpu")

    def _sleep(self, seconds: float) -> None:
        self.deadline = self.clock.now() + seconds
        self.clock.sleep(seconds)

    def _logits(self, batch):
        out = torch.zeros((batch, 16), dtype=torch.float32)
        out[:, 7] = 1.0  # deterministic greedy token, never EOS
        return out

    def begin_prefill_paged(self, seq_id, inputs):
        tokens = np.asarray(inputs["tokens"], np.int32)[0]
        self.arena.alloc(seq_id, len(tokens))
        return PagedPrefillJob(seq_id, tokens, 0)

    def prefill_chunk_paged(self, job, max_tokens):
        c = max(1, min(int(max_tokens), job.remaining))
        self._sleep(c * self.per_token_s)
        job.pos += c
        return self._logits(1) if job.pos >= job.t_in else None

    def prefill_paged(self, seq_id, inputs):
        tokens = np.asarray(inputs["tokens"], np.int32)[0]
        self.arena.alloc(seq_id, len(tokens))
        self._sleep(len(tokens) * self.per_token_s)
        return self._logits(1), len(tokens)

    def paged_decode_step(self, tok, cur, bt, *, write_kv=True):
        self._sleep(self.step_s)
        return self._logits(int(tok.shape[0]))


def batcher_parked(clock, eng, b):
    """The batcher is parked in a compute sleep whose virtual deadline is
    still ahead, or parked idle with nothing to do."""
    def settled():
        if parked_on(clock, clock._sleep_cv) and clock.now() < eng.deadline:
            return True
        st = b.stats()
        return parked_on(clock, b._cv) and st["active"] == 0 and not any(st["queued"].values()) \
            and not st["prefilling"]
    return settled


def _advance_until(clock, eng, b, dt, pred, max_iters=2000):
    """Drive simulated time on a fixed grid until ``pred()`` holds: settle
    the batcher, then advance one grid step (every sim sleep lands on the
    10 ms grid)."""
    for _ in range(max_iters):
        settle(clock, batcher_parked(clock, eng, b), "the batcher parked")
        if pred():
            return
        clock.advance(dt)
    raise AssertionError("simulation did not converge")


def _run_batcher_sim(serialize_prefill):
    """One strict resident stream + three long-prompt best-effort joiners
    admitted mid-stream, under chunked (default) or serialized prefill
    (``tests/test_slo_sim.py:614``). Returns (strict result, joiner results,
    stats)."""
    clock = VirtualClock()
    eng = _SimEngine(clock)
    gold = SLOClass("gold", 100.0)  # 100 ms inter-token target
    b = ContinuousBatcher(eng, capacity=4, serialize_prefill=serialize_prefill, min_chunk=2, slack_fraction=0.5)
    try:
        strict_fut = b.submit({"tokens": np.arange(1, 9, dtype=np.int32)[None, :]}, 60, slo=gold)
        # phase 1: the strict stream reaches steady state (~20 emissions)
        t_joiners = 0.2
        _advance_until(clock, eng, b, 0.01, lambda: clock.now() >= t_joiners - 1e-9)
        prompt = (np.arange(2, 82, dtype=np.int32) % 13)[None, :]  # 80 tokens
        joiner_futs = [b.submit({"tokens": prompt}, 8) for _ in range(3)]
        if not serialize_prefill:
            # mid-stream co-residency: drive until the first joiner's chunked
            # prefill finishes and seats it — the strict stream must still be
            # emitting at that moment
            _advance_until(clock, eng, b, 0.01, lambda: b.stats()["active"] >= 2)
            st = b.stats()
            assert not strict_fut.done(), "strict stream must still be mid-flight"
            assert st["prefill_chunks"] > 3, st
        futs = [strict_fut] + joiner_futs
        _advance_until(clock, eng, b, 0.01, lambda: all(f.done() for f in futs))
        strict = strict_fut.result(timeout=SETTLE_S)
        joiners = [f.result(timeout=SETTLE_S) for f in joiner_futs]
        stats = b.stats()
    finally:
        b.shutdown()
    clock.assert_elapsed_real_below(REAL_BUDGET_S)
    return strict, joiners, stats


@time_limit(60)
def test_sim_chunked_prefill_protects_strict_stream_and_joiners():
    """``tests/test_slo_sim.py:659``. Serialized prefill: three 400 ms joiner
    prompts run back to back in front of the batch, so the strict resident's
    worst inter-token gap passes its 100 ms target. Chunked prefill: the same
    trace holds the strict stream's inter-token p95 (and max) under target,
    each chunk budgeted from the strict lane's slack, while joiners seat
    mid-stream and their own emission-to-emission p95 strictly improves."""
    strict_c, joiners_c, stats_c = _run_batcher_sim(serialize_prefill=False)
    strict_s, joiners_s, stats_s = _run_batcher_sim(serialize_prefill=True)
    target_s = 0.100

    assert strict_c["tokens"].shape == strict_s["tokens"].shape == (1, 60)
    for j in joiners_c + joiners_s:
        assert j["tokens"].shape == (1, 8)

    gaps_strict_s = np.asarray(strict_s["step_s"])
    assert gaps_strict_s.max() > target_s, f"baseline not stressful: max strict gap {gaps_strict_s.max():.3f}s"
    assert stats_s["prefill_chunks"] == 0

    gaps_strict_c = np.asarray(strict_c["step_s"])
    assert np.percentile(gaps_strict_c, 95) <= target_s + 1e-6, gaps_strict_c
    assert gaps_strict_c.max() <= target_s + 1e-6, f"strict stream stalled {gaps_strict_c.max():.3f}s under chunking"
    assert stats_c["prefill_chunks"] >= 30  # 3 x 80-token prompts, <= 8 a chunk

    j_gaps_c = np.concatenate([np.asarray(j["step_s"]) for j in joiners_c])
    j_gaps_s = np.concatenate([np.asarray(j["step_s"]) for j in joiners_s])
    p95_c = float(np.percentile(j_gaps_c, 95))
    p95_s = float(np.percentile(j_gaps_s, 95))
    assert p95_c < p95_s, f"chunked {p95_c:.3f}s !< serialized {p95_s:.3f}s"
    assert p95_s > 2 * p95_c, (p95_c, p95_s)

