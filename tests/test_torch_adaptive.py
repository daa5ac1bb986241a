"""The port's adaptive batching windows and overload shedding: the cases of
``tests/test_adaptive.py``. The controller (``QueueingWindow``, pure
arithmetic, no threads) is driven through the same observations in the port
and in the JAX package's ``repro.scheduler``, and must retune identically;
the scheduler's adaptive mode runs on the deterministic virtual clock and on
events, as the reference's cases do, and the platform hands its knobs
(``adaptive``, ``adaptive_config``, ``be_shed_depth``) to its scheduler."""
import threading
import time
from concurrent.futures import wait

import pytest

torch = pytest.importorskip("torch")

import repro.scheduler as ref  # noqa: E402
from repro.scheduler.slo import SLOClass as RefSLOClass  # noqa: E402
from repro_torch.core import FunctionSpec, FusionPolicy, TinyTorchBackend  # noqa: E402
from repro_torch.scheduler import adaptive as port  # noqa: E402
from repro_torch.scheduler.clock import VirtualClock  # noqa: E402
from repro_torch.scheduler.scheduler import OverloadShedError, RequestScheduler  # noqa: E402
from repro_torch.scheduler.slo import SLOClass  # noqa: E402


def t(i):
    """A request's argument: a 0-d tensor (a non-tensor leaf is a constant
    of the program in the port, keyed by value, so ints never share a
    queue; the reference's cases pass ints)."""
    return torch.tensor(i)


def first(name, args_list):
    return [a[0] for a in args_list]


# ------------------------------------------------------- controller (no threads)
#
# Each case drives one package's controller and returns what it observed;
# the port must observe exactly what the reference does, and the reference
# case's own assertion is then checked on the port's observations.


def dense_arrivals(mod):
    win = mod.QueueingWindow(8, 0.001, mod.AdaptiveConfig(max_delay_s=0.020))
    t0, seen = 0.0, []
    for _ in range(30):  # singleton batches 2ms apart: dense traffic the 1ms window misses
        win.observe_batch([t0], closed_full=False)
        seen.append(win.delay_s)
        t0 += 0.002
    return seen


def serial_trickle(mod):
    win = mod.QueueingWindow(8, 0.020, mod.AdaptiveConfig(max_delay_s=0.020))
    t0, seen = 0.0, []
    for _ in range(30):
        win.observe_batch([t0], closed_full=False)
        seen.append(win.delay_s)
        t0 += 0.100  # gap far beyond any allowed window: waiting buys nothing
    return seen


def full_batches(mod):
    win = mod.QueueingWindow(4, 0.020, mod.AdaptiveConfig(max_delay_s=0.020))
    t0, seen = 0.0, []
    for _ in range(30):
        win.observe_batch([t0, t0 + 1e-4, t0 + 2e-4, t0 + 3e-4], closed_full=True)
        seen.append(win.delay_s)
        t0 += 0.005
    return seen


def stationary(mod):
    win = mod.QueueingWindow(8, 0.002, mod.AdaptiveConfig(max_delay_s=0.020))
    t0, seen = 0.0, []
    for _ in range(60):
        win.observe_batch([t0, t0 + 0.002, t0 + 0.004], closed_full=False)
        seen.append((win.delay_s, win.retunes))
        t0 += 0.010
    return seen


def at_target(mod):
    win = mod.QueueingWindow(5, 0.004, mod.AdaptiveConfig(max_delay_s=0.050, target_occupancy=0.75))
    t0, seen = 0.0, []
    for _ in range(30):  # batches of 4/5 = 0.8, above target; arrivals 4ms apart
        win.observe_batch([t0, t0 + 0.004, t0 + 0.008, t0 + 0.012], closed_full=False)
        seen.append(win.delay_s)
        t0 += 0.024
    return seen


def reset(mod):
    win = mod.QueueingWindow(8, 0.010, mod.AdaptiveConfig(max_delay_s=0.020))
    t0 = 0.0
    for _ in range(10):
        win.observe_batch([t0], closed_full=False)
        t0 += 0.100
    decayed = win.delay_s
    win.reset(0.010)
    return [decayed, win.delay_s, win.snapshot()["ewma_gap_ms"]]


def intra_burst(mod):
    win = mod.QueueingWindow(8, 0.002, mod.AdaptiveConfig(max_delay_s=0.020))
    seen = [win.idle_close_s()]  # no estimate yet: the window governs alone
    t0 = 0.0
    for _ in range(10):  # bursts spaced 1ms inside, 37ms apart
        win.observe_batch([t0, t0 + 0.001, t0 + 0.002, t0 + 0.003], closed_full=False)
        t0 += 0.040
    return seen + [win.idle_close_s()]


def bounds(mod):
    cfg = mod.AdaptiveConfig(min_delay_s=0.0005, max_delay_s=0.004)
    win = mod.QueueingWindow(8, 0.050, cfg)
    seen = [win.delay_s]  # the seed clamps into [min, max]
    t0 = 0.0
    for _ in range(30):  # dense arrivals push the target above the cap
        win.observe_batch([t0, t0 + 1e-3], closed_full=False)
        seen.append(win.delay_s)
        t0 += 2e-3
    return seen


def shared_service(mod):
    slo = SLOClass if mod is port else RefSLOClass
    est = mod.ServiceTimeEstimate(alpha=0.3)
    cfg = mod.AdaptiveConfig(max_delay_s=0.020)
    lane_a = mod.QueueingWindow(8, 0.002, cfg, service=est)
    lane_b = mod.QueueingWindow(8, 0.002, cfg, slo=slo("strict", 50.0), service=est)
    lane_a.observe_batch([0.0, 0.001], closed_full=False, service_s=0.008)
    seen = [lane_b.service.value, lane_b.snapshot()["service_ms"]]
    lane_b.observe_batch([0.01], closed_full=False, service_s=0.004)  # B's feed back into A's view
    return seen + [lane_a.service.value]


def check_dense(seen):
    assert seen[-1] > 0.004, "window must grow toward the occupancy target"
    assert seen[-1] <= 0.020


def check_stationary(seen):
    settled, retunes = seen[39]
    assert all(s == (settled, retunes) for s in seen[40:]), "stationary traffic must not flap the window"


CONTROLLER_CASES = {
    "grows_on_dense_arrivals_with_low_occupancy": (dense_arrivals, check_dense),
    "decays_to_zero_on_serial_trickle": (serial_trickle, lambda s: s[-1] == port.AdaptiveConfig().min_delay_s),
    "shrinks_when_batches_close_full": (full_batches, lambda s: s[-1] < 0.010),
    "hysteresis_prevents_flapping": (stationary, check_stationary),
    "growth_stops_at_target_occupancy": (at_target, lambda s: s[-1] == 0.004),
    "reset_forgets_learned_state": (reset, lambda s: s == [port.AdaptiveConfig().min_delay_s, 0.010, 0.0]),
    "idle_close_tracks_intra_burst_spacing": (intra_burst, lambda s: s[0] is None and 0.001 <= s[1] <= 0.006),
    "bounds_respected": (bounds, lambda s: s[0] == 0.004 and all(0.0005 <= x <= 0.004 for x in s)),
    "service_estimate_shared_across_lanes_warm_start": (
        shared_service, lambda s: s[:2] == pytest.approx([0.008, 8.0]) and s[2] == pytest.approx(0.3 * 0.004 + 0.7 * 0.008)),
}


@pytest.mark.parametrize("case", sorted(CONTROLLER_CASES))
def test_window_controller_retunes_as_the_reference(case):
    drive, holds = CONTROLLER_CASES[case]
    got = drive(port)
    assert got == drive(ref)
    assert holds(got) is not False


def test_static_window_and_default_config_match_the_reference():
    for slo, rslo in ((SLOClass("strict", 50.0), RefSLOClass("strict", 50.0)),
                      (SLOClass("now", 0.0), RefSLOClass("now", 0.0)),
                      (SLOClass("best-effort", float("inf")), RefSLOClass("best-effort", float("inf")))):
        for max_delay_s in (0.0, 0.002, 0.050):
            assert port.static_window_s(slo, max_delay_s) == ref.static_window_s(rslo, max_delay_s)
    assert port.AdaptiveConfig() == port.AdaptiveConfig(**vars(ref.AdaptiveConfig()))


# ------------------------------------------------------- scheduler integration


def test_default_config_cap_stretches_with_large_seed():
    """adaptive=True with max_delay_ms above the default 20ms cap stretches
    the cap to 2x the seed; small seeds keep the stock config."""
    sched = RequestScheduler(first, max_delay_ms=50.0, adaptive=True)
    try:
        assert sched.adaptive_config.max_delay_s == pytest.approx(0.100)
    finally:
        sched.shutdown()
    sched = RequestScheduler(first, max_delay_ms=2.0, adaptive=True)
    try:
        assert sched.adaptive_config.max_delay_s == pytest.approx(port.AdaptiveConfig().max_delay_s)
    finally:
        sched.shutdown()


def test_reset_stats_clears_history_but_keeps_serving():
    sched = RequestScheduler(first, max_batch=4, max_delay_ms=5.0, adaptive=True)
    try:
        wait([sched.submit("f", (t(i),)) for i in range(8)], timeout=5)
        assert sched.stats()["batches"] > 0
        sched.reset_stats()
        st = sched.stats()
        assert st["batches"] == 0 and st["requests"] == 0 and st["mean_batch"] == 0.0
        assert sched.signals_for("f").mean_occupancy == 0.0
        assert int(sched.submit("f", (t(9),)).result(timeout=5)) == 9  # queues still live
    finally:
        sched.shutdown()


def test_adaptive_scheduler_converges_bursty_grows_trickle_decays():
    """Through real dispatcher threads on the virtual clock: a serial trickle
    decays the window to ~0, so lone requests stop paying it; dense arrivals
    grow it above its seed."""
    clock = VirtualClock()
    sched = RequestScheduler(first, max_batch=4, max_delay_ms=20.0, adaptive=True,
                             adaptive_config=port.AdaptiveConfig(max_delay_s=0.020), clock=clock)
    try:
        t_lone = []
        for i in range(14):  # one request every 30ms (virtual) against a 20ms-max window
            t0 = clock.now()
            fut = sched.submit("f", (t(i),))
            clock.wait_for_waiters(1)
            if not fut.done():  # window still open: expire it virtually
                clock.advance(max(q.max_delay_s for q in sched._queues.values()) + 1e-4)
            assert int(fut.result(timeout=5)) == i
            t_lone.append(clock.now() - t0)
            clock.advance(0.030 - (clock.now() - t0))
        windows = sched.window_snapshot()
        assert windows and windows[0]["max_delay_ms"] < 1.0, windows
        assert min(t_lone[-3:]) < 0.010, t_lone
        clock.assert_elapsed_real_below(10.0)
    finally:
        sched.shutdown()

    clock = VirtualClock()
    sched = RequestScheduler(first, max_batch=8, max_delay_ms=1.0, adaptive=True,
                             adaptive_config=port.AdaptiveConfig(max_delay_s=0.050), clock=clock)
    try:
        futs = []
        for i in range(60):  # 3ms-spaced (virtual) arrivals against a 1ms seed window
            futs.append(sched.submit("f", (t(i),)))
            clock.wait_for_waiters(1)
            clock.advance(0.003)
        clock.wait_for_waiters(1)
        clock.advance(0.050)  # flush the last open window
        _, not_done = wait(futs, timeout=30)
        assert not not_done
        windows = sched.window_snapshot()
        assert windows and windows[0]["max_delay_ms"] > 2.0, windows
        st = sched.stats()
        assert st["mean_batch"] > 1.5, st
        assert st["adaptive"]["retunes"] > 0
        clock.assert_elapsed_real_below(10.0)
    finally:
        sched.shutdown()


def test_scheduler_new_class_lane_starts_with_warm_service():
    """A lane made for a new class of an already-hot function starts from
    the function's service estimate; another function still starts cold."""

    def dispatch(name, args_list):
        time.sleep(0.004)
        return first(name, args_list)

    sched = RequestScheduler(dispatch, max_batch=4, max_delay_ms=1.0, adaptive=True)
    try:
        for _ in range(3):
            assert int(sched.submit("f", (t(1),)).result(timeout=5)) == 1
        warm = [r for r in sched.window_snapshot() if r["name"] == "f"]
        assert warm and warm[0]["service_ms"] > 1.0
        assert int(sched.submit("f", (t(2),), slo=SLOClass("gold", 100.0)).result(timeout=5)) == 2
        rows = {r["slo"]: r for r in sched.window_snapshot() if r["name"] == "f"}
        assert rows["gold"]["service_ms"] > 1.0
        assert int(sched.submit("g", (t(3),)).result(timeout=5)) == 3
    finally:
        sched.shutdown()


def test_overload_sheds_best_effort_not_strict():
    """Predicted rho >= 1 and a best-effort backlog at the bound fail fast
    with OverloadShedError; strict submissions keep being admitted; the
    shed shows in class_stats(); reset_stats disarms shedding."""
    gate, entered = threading.Event(), threading.Event()

    def dispatch(name, args_list):
        entered.set()
        gate.wait(10)
        return first(name, args_list)

    sched = RequestScheduler(dispatch, max_batch=4, max_delay_ms=0.5, adaptive=True, be_shed_depth=3)
    try:
        armer = sched.submit("f", (t(-1),), slo=SLOClass("strict", 50.0))  # strict traffic arms shedding
        assert entered.wait(5)
        head = sched.submit("f", (t(0),))
        lane = next(q for q in sched._queues.values() if q.name == "f" and q.slo.best_effort)
        deadline = time.perf_counter() + 5
        while lane.depth() and time.perf_counter() < deadline:
            time.sleep(0.001)  # the first popped into its own (blocked) batch
        lane.adaptive._ewma_gap_s = 0.001  # 1ms arrivals, 100ms batches: overload
        lane.adaptive.service.observe(0.100)
        assert sched._predicted_rho_locked("f") >= 1.0
        queued = [sched.submit("f", (t(i),)) for i in range(1, 4)]  # depth -> 3
        with pytest.raises(OverloadShedError):
            sched.submit("f", (t(99),)).result(timeout=1)
        strict = sched.submit("f", (t(7),), slo=SLOClass("strict", 50.0))
        gate.set()
        assert int(strict.result(timeout=5)) == 7
        assert int(armer.result(timeout=5)) == -1 and int(head.result(timeout=5)) == 0
        assert [int(f.result(timeout=5)) for f in queued] == [1, 2, 3]
        stats = sched.class_stats()
        assert stats["best-effort"]["shed"] == 1 and stats.get("strict", {}).get("shed", 0) == 0
        sched.reset_stats()
        assert sched._strict_fns == set()
    finally:
        gate.set()
        sched.shutdown()


def test_no_shed_below_rho_one():
    """A deep best-effort backlog alone sheds nothing: only predicted
    overload does."""
    gate = threading.Event()

    def dispatch(name, args_list):
        gate.wait(10)
        return first(name, args_list)

    sched = RequestScheduler(dispatch, max_batch=4, max_delay_ms=0.5, adaptive=True, be_shed_depth=2)
    try:
        futs = [sched.submit("f", (t(i),)) for i in range(8)]  # depth far past the bound
        gate.set()
        assert [int(f.result(timeout=5)) for f in futs] == list(range(8))
        assert sched.class_stats()["best-effort"]["shed"] == 0
    finally:
        gate.set()
        sched.shutdown()


def test_platform_hands_its_adaptive_knobs_to_the_scheduler():
    """``TinyTorchBackend(adaptive=..., adaptive_config=..., be_shed_depth=...)``
    configures its scheduler, and a leaf served through ``invoke_async`` in
    adaptive mode returns what ``invoke`` does."""
    cfg = port.AdaptiveConfig(max_delay_s=0.010)
    p = TinyTorchBackend(FusionPolicy(enabled=False), max_batch=4, max_delay_ms=2.0, adaptive=True,
                         adaptive_config=cfg, be_shed_depth=5)
    try:
        assert p.scheduler.adaptive and p.scheduler.adaptive_config is cfg and p.scheduler.be_shed_depth == 5
        w = torch.linspace(-1.0, 1.0, 16).reshape(4, 4)
        p.deploy(FunctionSpec("leaf", lambda ctx, params, x: torch.tanh(x @ params), w))
        xs = [torch.full((2, 4), 0.1 * i) for i in range(6)]
        futs = [p.invoke_async("leaf", x) for x in xs]
        _, not_done = wait(futs, timeout=30)
        assert not not_done
        for f, x in zip(futs, xs):
            assert torch.allclose(f.result(), p.invoke("leaf", x), rtol=2e-5, atol=2e-5)
        assert p.scheduler.stats()["adaptive"]["window_max_ms"] <= 10.0
    finally:
        p.shutdown()
    p = TinyTorchBackend(FusionPolicy(enabled=False))
    try:
        assert not p.scheduler.adaptive and p.scheduler.be_shed_depth == 2 * p.scheduler.max_batch
    finally:
        p.shutdown()
