"""The port's replicated data plane against the JAX package's: the cases of
``tests/test_replicas_sim.py`` and the two seeds of
``tests/test_replicas_fuzz.py``, each run on both packages' routing table,
control plane, autoscaler and scheduler, with the outcomes compared; and
parity cases — a scripted replica sequence gives equal ``version``s and
equal spread picks in both packages' ``RoutingTable``s, and the same inputs
give equal ``decide`` (the replicate arm) and ``decide_split`` results in
both policies over a grid.

The virtual-clock sims drive the real routing table, control plane and
autoscaler, with timing stubs for the execution units (one virtual-time pod
per replica), as the reference's do."""
import itertools
import random
import threading
import time
from concurrent.futures import wait

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # the suite runs several workers at once: leave them cores

import jax.numpy as jnp  # noqa: E402

from repro.core import FunctionSpec as RefSpec  # noqa: E402
from repro.core import TinyJaxBackend  # noqa: E402
from repro.core.autoscaler import Autoscaler as RefAutoscaler  # noqa: E402
from repro.core.function import InstanceState as RefState  # noqa: E402
from repro.core.handler import EdgeStats as RefEdgeStats  # noqa: E402
from repro.core.lifecycle import ControlPlane as RefControlPlane  # noqa: E402
from repro.core.policy import FusionPolicy as RefPolicy  # noqa: E402
from repro.core.registry import RoutingTable as RefRoutingTable  # noqa: E402
from repro.scheduler import AdaptiveConfig as RefAdaptiveConfig  # noqa: E402
from repro.scheduler import RequestScheduler as RefScheduler  # noqa: E402
from repro.scheduler import SLOClass as RefSLOClass  # noqa: E402
from repro.scheduler import VirtualClock as RefClock  # noqa: E402
from repro.scheduler.adaptive import SchedulerSignals as RefSignals  # noqa: E402
from repro_torch.analysis.lockorder import LockGraph, patched_locks  # noqa: E402
from repro_torch.core import FunctionSpec, FusionPolicy, InstanceState, TinyTorchBackend  # noqa: E402
from repro_torch.core.autoscaler import Autoscaler  # noqa: E402
from repro_torch.core.handler import EdgeStats  # noqa: E402
from repro_torch.core.lifecycle import ControlPlane  # noqa: E402
from repro_torch.core.registry import (  # noqa: E402
    LeastOutstandingSpread,
    RoundRobinSpread,
    RoutingTable,
    make_spread,
)
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.scheduler.adaptive import AdaptiveConfig, SchedulerSignals  # noqa: E402
from repro_torch.scheduler.clock import VirtualClock  # noqa: E402
from repro_torch.scheduler.scheduler import RequestScheduler  # noqa: E402
from repro_torch.scheduler.slo import SLOClass  # noqa: E402

REAL_BUDGET_S = 10.0

PKGS = {
    "port": {"RoutingTable": RoutingTable, "ControlPlane": ControlPlane, "Autoscaler": Autoscaler,
             "Scheduler": RequestScheduler, "AdaptiveConfig": AdaptiveConfig, "SLOClass": SLOClass,
             "Clock": VirtualClock, "State": InstanceState, "Policy": FusionPolicy,
             "Signals": SchedulerSignals, "EdgeStats": EdgeStats},
    "jax": {"RoutingTable": RefRoutingTable, "ControlPlane": RefControlPlane, "Autoscaler": RefAutoscaler,
            "Scheduler": RefScheduler, "AdaptiveConfig": RefAdaptiveConfig, "SLOClass": RefSLOClass,
            "Clock": RefClock, "State": RefState, "Policy": RefPolicy,
            "Signals": RefSignals, "EdgeStats": RefEdgeStats},
}


def settle(clock, n=1):
    clock.wait_for_waiters(n, timeout=5.0)


def _pump(clock, dt, pred, max_iters=3000):
    """Advance virtual time on a fixed grid until ``pred()`` holds: the sims
    settle on state the test can see, never on a fixed real-time sleep."""
    for _ in range(max_iters):
        if pred():
            return
        settle(clock)
        clock.advance(dt)
    raise AssertionError("simulation did not converge")


# --------------------------------------------------------- execution stub


_IDS = itertools.count()


class _SimReplica:
    """Timing stub of a FunctionInstance: the package's lifecycle states and
    in-flight bracketing, with compute replaced by one virtual-time pod
    (requests serialize per replica, ``service_s`` of simulated time per
    batch) so replica parallelism is exactly the pod count."""

    def __init__(self, pkg, clock, members, service_s=0.008):
        self.S = PKGS[pkg]["State"]
        self.clock = clock
        self.instance_id = f"sim-{next(_IDS)}"
        self.members = set(members)
        self.state = self.S.PROVISIONING
        self.service_s = service_s
        self._cv = threading.Condition()
        self._active = 0
        self._busy = False
        self.served = 0

    def mark_ready(self):
        self.state = self.S.READY

    def mark_serving(self):
        if self.state != self.S.RETIRED:
            self.state = self.S.SERVING

    def begin_drain(self):
        with self._cv:
            if self.state != self.S.RETIRED:
                self.state = self.S.DRAINING

    def begin_request(self):
        with self._cv:
            assert self.state != self.S.RETIRED, "request on retired unit"
            self._active += 1

    def end_request(self):
        with self._cv:
            self._active -= 1
            self._cv.notify_all()

    def outstanding(self):
        with self._cv:
            return self._active

    def occupy(self):
        """Hold this replica's pod for one batch service time."""
        with self._cv:
            while self._busy:
                self.clock.wait_on(self._cv, 0.5)
            self._busy = True
        self.clock.sleep(self.service_s)
        with self._cv:
            self._busy = False
            self.served += 1
            self._cv.notify_all()

    def retire(self, timeout=30.0):
        self.begin_drain()
        with self._cv:
            while self._active:
                self.clock.wait_on(self._cv, 0.5)
            self.state = self.S.RETIRED
        return 1000  # nominal freed bytes


class _SimPlatform:
    """One package's real RoutingTable + ControlPlane + RequestScheduler +
    Autoscaler on a virtual clock, dispatching into :class:`_SimReplica`
    pods. It carries a tracer: the port's control plane stamps every epoch
    on the platform's control timeline."""

    def __init__(self, pkg, clock, *, service_s=0.008, spread=None, max_batch=4,
                 autoscale=None, idle_timeout_s=1.0):
        k = PKGS[pkg]
        self.pkg, self.S = pkg, k["State"]
        self.clock = clock
        self.tracer = Tracer(clock=clock)
        self.service_s = service_s
        self.registry = k["RoutingTable"](spread=spread)
        self.lifecycle = k["ControlPlane"](self, self.registry, clock=clock)
        self.scheduler = k["Scheduler"](
            self._dispatch, max_batch=max_batch, adaptive=True,
            adaptive_config=k["AdaptiveConfig"](max_delay_s=0.016),
            idle_timeout_s=idle_timeout_s, be_shed_depth=10**6, clock=clock,
        )
        self.violations = []
        self.spawned = []
        self.autoscaler = None
        if autoscale is not None:
            self.autoscaler = k["Autoscaler"](self, **autoscale)
            self.lifecycle.add_tick_hook(self.autoscaler.tick)

    def deploy(self, name):
        inst = _SimReplica(self.pkg, self.clock, {name}, self.service_s)
        inst.mark_ready()
        self.lifecycle.publish({name: inst}, kind="deploy", reason="deploy")
        return inst

    def _spawn_replica(self, name):
        primary = self.registry.get(name)
        if primary is None:
            return None
        replica = _SimReplica(self.pkg, self.clock, set(primary.members), self.service_s)
        replica.mark_ready()
        event = self.lifecycle.scale_out(
            replica, tuple(sorted(replica.members)),
            reason=f"replica of {primary.instance_id}",
        )
        if event is None:
            return None
        self.spawned.append(replica)
        return replica

    def request_replica(self, name, reason=""):
        if self.autoscaler is not None:
            self.autoscaler.request_scale_out(name, reason)

    def retire_instance(self, instance):
        return instance.retire()

    def _dispatch(self, name, args_list):
        instance, state = self.registry.resolve_entry(name)
        if state in (self.S.DRAINING, self.S.RETIRED):
            self.violations.append(f"resolved {instance.instance_id} in {state}")
        instance.begin_request()
        try:
            instance.occupy()
        finally:
            instance.end_request()
        return [a[0] for a in args_list]

    def shutdown(self):
        self.scheduler.shutdown()
        self.lifecycle.shutdown()


def both(case, *args, **kwargs):
    """``case(pkg, ...)`` on the port and on the JAX package: (port, jax)."""
    return case("port", *args, **kwargs), case("jax", *args, **kwargs)


# ------------------------------------ epoch pins (publish bump semantics)


def _version_case(pkg):
    clock = PKGS[pkg]["Clock"]()
    rt = PKGS[pkg]["RoutingTable"]()
    a = _SimReplica(pkg, clock, {"f"})
    b = _SimReplica(pkg, clock, {"f"})
    v0 = rt.version
    seen = []
    rt.publish({})
    assert rt.version == v0  # empty publish: no epoch
    rt.register("f", a)
    rt.register("f", a)  # identical single route: no epoch
    assert rt.version == v0 + 1
    rt.publish({"f": (a, b)})  # replica set grew: ONE epoch
    assert rt.version == v0 + 2
    rt.publish({"f": (a, b)})  # identical ordered set: no epoch
    rt.publish({"f": [a, b]})  # list spelling of the same set: no epoch
    assert rt.version == v0 + 2
    assert rt.replicas("f") == (a, b)
    seen.append(rt.version)
    assert rt.add_replicas(["f"], b) == ()  # already present
    assert rt.add_replicas(["ghost"], b) == ()  # unrouted name skipped
    assert rt.version == v0 + 2
    assert rt.remove_replicas(["f"], b) == ("f",)
    assert rt.version == v0 + 3
    assert rt.remove_replicas(["f"], b) == ()  # not a member anymore
    assert rt.remove_replicas(["f"], a) == ()  # keep_last: sole replica stays
    assert rt.version == v0 + 3
    assert rt.replicas("f") == (a,)
    rt.publish({"f": (a, b)})
    rt.swap(["f"], a)  # a swap collapses the set to one unit
    assert rt.version == v0 + 5
    rt.swap(["f"], a)
    rt.swap([], b)
    assert rt.version == v0 + 5
    rt.publish({"f": a, "g": b})  # one real change among no-ops: ONE epoch
    assert rt.version == v0 + 6
    rt.unpublish(["f", "g"])
    assert rt.version == v0 + 7
    rt.unpublish(["f"])  # nothing routed: no epoch
    assert rt.version == v0 + 7
    return seen + [rt.version]


def test_version_bumps_once_per_effective_replica_set_change():
    """The no-op pins extended to multi-replica updates: ``version`` is a
    routing epoch, so identical republishes of a replica SET, no-op
    add/removes and empty updates mint no new epoch — in both packages."""
    port, ref = both(_version_case)
    assert port == ref


def _unroute_case(pkg):
    clock = PKGS[pkg]["Clock"]()
    rt = PKGS[pkg]["RoutingTable"]()
    a = _SimReplica(pkg, clock, {"f"})
    b = _SimReplica(pkg, clock, {"f"})
    rt.publish({"f": (a, b)})
    assert rt.get("f") is a  # primary = first-published replica
    assert rt.replica_count("f") == 2
    assert rt.is_routed(b)
    displaced = rt.publish({"f": ()})
    assert displaced == {"f": (a, b)}
    assert rt.get("f") is None and not rt.is_routed(a)
    with pytest.raises(Exception) as exc:
        rt.resolve("f")
    return type(exc.value).__name__, rt.version


def test_publish_empty_sequence_unroutes_and_get_returns_primary():
    port, ref = both(_unroute_case)
    assert port == ref == ("UnknownFunctionError", 2)


# -------------------------------------------------------- spread policies


def _round_robin_case(pkg):
    clock = PKGS[pkg]["Clock"]()
    rt = PKGS[pkg]["RoutingTable"](spread="round-robin")
    assert rt.spread_name == "round-robin"
    reps = [_SimReplica(pkg, clock, {"f"}) for _ in range(3)]
    rt.publish({"f": tuple(reps)})
    picked = [reps.index(rt.resolve("f")) for _ in range(6)]
    summary = rt.replica_summary()["f"]
    assert summary["replicas"] == [r.instance_id for r in reps]
    assert summary["picks"] == {r.instance_id: 2 for r in reps}
    return picked


def test_round_robin_spread_cycles_in_publish_order():
    port, ref = both(_round_robin_case)
    assert port == ref == [0, 1, 2, 0, 1, 2]


def _least_outstanding_case(pkg):
    clock = PKGS[pkg]["Clock"]()
    rt = PKGS[pkg]["RoutingTable"]()  # least-outstanding is the default
    assert rt.spread_name == "least-outstanding"
    a, b = _SimReplica(pkg, clock, {"f"}), _SimReplica(pkg, clock, {"f"})
    rt.publish({"f": (a, b)})
    a.begin_request()  # a is busy: every pick must land on b
    busy = [rt.resolve("f") is b for _ in range(4)]
    a.end_request()
    picked = [(a, b).index(rt.resolve("f")) for _ in range(2)]
    inst, state = rt.resolve_entry("f")  # the picked replica's state, read atomically
    return busy, picked, state.value


def test_least_outstanding_spread_prefers_idle_replica_and_rotates_ties():
    port, ref = both(_least_outstanding_case)
    busy, picked, state = port
    assert all(busy)
    assert sorted(picked) == [0, 1], "ties must rotate, not pin one replica"
    assert state == "provisioning"  # stub default; never draining
    assert port == ref


def test_make_spread_resolves_names_instances_and_rejects_unknown():
    from repro.core.registry import make_spread as ref_make_spread

    assert isinstance(make_spread(None), LeastOutstandingSpread)
    assert isinstance(make_spread("round-robin"), RoundRobinSpread)
    rr = RoundRobinSpread()
    assert make_spread(rr) is rr
    for mk in (make_spread, ref_make_spread):
        with pytest.raises(ValueError, match="unknown spread"):
            mk("po2")
    assert type(ref_make_spread(None)).__name__ == type(make_spread(None)).__name__


class _Stub:
    """A replica for the routing parity script: an id and an in-flight count."""

    def __init__(self, i):
        self.instance_id = f"r{i}"
        self.load = 0
        self.state = None

    def outstanding(self):
        return self.load


@pytest.mark.parametrize("spread", ["least-outstanding", "round-robin"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scripted_replica_sequence_gives_equal_versions_and_picks(spread, seed):
    """The same scripted sequence of publishes, scale-outs, scale-ins, swaps,
    unpublishes, load changes and resolves on both packages' tables gives
    the same version after every step and the same pick (by replica index)
    at every resolve."""
    logs = {}
    for pkg in PKGS:
        rng = random.Random(seed)
        rt = PKGS[pkg]["RoutingTable"](spread=spread)
        stubs = [_Stub(i) for i in range(5)]
        log = []
        for _ in range(200):
            op = rng.choice(["publish", "add", "remove", "swap", "unpublish", "load", "resolve", "resolve"])
            name = rng.choice(["f", "g"])
            r = rng.choice(stubs)
            if op == "publish":
                rt.publish({name: tuple(rng.sample(stubs, rng.randint(0, 3)))})
            elif op == "add":
                log.append(rt.add_replicas([name], r))
            elif op == "remove":
                log.append(rt.remove_replicas([name], r, keep_last=rng.random() < 0.7))
            elif op == "swap":
                rt.swap([name], r)
            elif op == "unpublish":
                rt.unpublish([name])
            elif op == "load":
                r.load = rng.randint(0, 2)
            else:
                try:
                    log.append(stubs.index(rt.resolve(name)))
                except Exception as exc:  # noqa: BLE001 — an unrouted name
                    log.append(type(exc).__name__)
            log.append(rt.version)
        summary = rt.replica_summary()
        log.append({n: (v["replicas"], v["picks"]) for n, v in summary.items()})
        logs[pkg] = log
    assert logs["port"] == logs["jax"]


# ------------------------------------------------------------- autoscaler


def test_autoscaler_rejects_inverted_replica_bounds():
    for pkg in PKGS:
        clock = PKGS[pkg]["Clock"]()
        plat = _SimPlatform(pkg, clock)
        try:
            with pytest.raises(ValueError):
                PKGS[pkg]["Autoscaler"](plat, max_replicas=1, min_replicas=2)
        finally:
            plat.shutdown()


def _hint_case(pkg):
    clock = PKGS[pkg]["Clock"]()
    plat = _SimPlatform(pkg, clock, autoscale=dict(
        rho_high=99.0, sustain=99, max_replicas=2, cooldown_s=0.0,
        eval_interval_s=0.01,
    ))
    try:
        plat.deploy("svc")
        plat.request_replica("svc", reason="saturated callee: replicate")
        _pump(clock, 0.01, lambda: plat.registry.replica_count("svc") == 2)
        plat.request_replica("svc", reason="again")  # over the cap: no-op
        for _ in range(10):
            settle(clock)
            clock.advance(0.01)
        events = plat.autoscaler.stats()["events"]
        clock.assert_elapsed_real_below(REAL_BUDGET_S)
        return (plat.registry.replica_count("svc"), [e["kind"] for e in events],
                "replicate" in events[0]["reason"], [e.kind for e in plat.lifecycle.events])
    finally:
        plat.shutdown()


def test_replicate_hint_spawns_replica_up_to_the_cap():
    """The fusion policy's replicate arm lands as a reconciler-tick hint:
    the spin-up happens on the control-plane thread, respects max_replicas,
    and records a scale-out event and a scale-out epoch."""
    port, ref = both(_hint_case)
    assert port == (2, ["scale-out"], True, ["deploy", "scale-out"])
    assert port == ref


# ------------------------------- the tentpole sim: scale out, then back in


def _payload(pkg, v):
    """A request's payload: a 0-d tensor in the port, whose lanes key a
    non-tensor leaf by its value (``request_key``) — an int payload would
    give every request a lane of its own — and an int in the JAX package."""
    return torch.tensor(v) if pkg == "port" else v


def _run_hot_function_trace(pkg, plat, clock, rounds=40, per_lane=2):
    """Open-loop skewed load: ``per_lane`` requests per virtual 8ms round on
    each of 4 shape-distinct lanes of "hot", plus a strict gold trickle.
    Returns (best-effort futures, gold futures, makespan seconds)."""
    gold = PKGS[pkg]["SLOClass"]("gold", 250.0)
    futs, gold_futs = [], []
    t0 = clock.now()
    for r in range(rounds):
        for lane in range(4):
            for k in range(per_lane):
                futs.append(plat.scheduler.submit(
                    "hot", (_payload(pkg, r * 100 + lane * 10 + k), (0,) * (lane + 1))))
        if r % 4 == 0:
            gold_futs.append(plat.scheduler.submit("hot", (_payload(pkg, 9000 + r), (0,) * 5), slo=gold))
        target = t0 + (r + 1) * 0.008
        _pump(clock, 0.002, lambda: clock.now() >= target - 1e-9)
    _pump(clock, 0.002, lambda: all(f.done() for f in futs + gold_futs), max_iters=5000)
    return futs, gold_futs, clock.now() - t0


def _scale_case(pkg):
    clock_b = PKGS[pkg]["Clock"]()
    base = _SimPlatform(pkg, clock_b)
    try:
        base.deploy("hot")
        futs_b, gold_b, makespan_base = _run_hot_function_trace(pkg, base, clock_b)
        assert not base.violations, base.violations[:3]
        assert base.registry.replica_count("hot") == 1
        assert all(f.exception() is None for f in futs_b + gold_b)
        clock_b.assert_elapsed_real_below(REAL_BUDGET_S)
    finally:
        base.shutdown()

    clock = PKGS[pkg]["Clock"]()
    plat = _SimPlatform(pkg, clock, autoscale=dict(
        rho_high=1.0, rho_low=0.2, sustain=2, max_replicas=3,
        cooldown_s=0.05, eval_interval_s=0.02,
    ))
    try:
        plat.deploy("hot")
        futs, gold_futs, makespan = _run_hot_function_trace(pkg, plat, clock)
        assert not plat.violations, plat.violations[:3]
        done, not_done = wait(futs + gold_futs, timeout=5)
        assert not not_done
        assert all(f.exception() is None for f in futs + gold_futs)
        payloads = [int(f.result()) for f in futs]
        replicas = plat.registry.replica_count("hot")
        out_events = [e for e in plat.autoscaler.stats()["events"] if e["kind"] == "scale-out"]
        served = [rep.served for rep in plat.spawned]
        picks = plat.registry.replica_summary()["hot"]["picks"]
        gold_met = plat.scheduler.class_stats()["gold"]["met"]

        # load stops -> lanes idle out -> rho reads 0 -> trough scale-in
        # drains back to one replica, newest first, nothing dropped
        _pump(clock, 0.05, lambda: plat.registry.replica_count("hot") == 1, max_iters=300)
        assert not plat.violations, plat.violations[:3]
        in_events = [e for e in plat.autoscaler.stats()["events"] if e["kind"] == "scale-in"]
        primary = plat.registry.get("hot")
        clock.assert_elapsed_real_below(REAL_BUDGET_S)
        return {"payloads": payloads, "replicas": replicas, "scale_outs": len(out_events),
                "rho_reasons": all("rho" in e["reason"] for e in out_events),
                "all_served": all(n > 0 for n in served), "picked": sorted(n > 0 for n in picks.values()),
                "speedup_ok": makespan <= 0.75 * makespan_base, "gold_met": gold_met,
                "scale_ins": len(in_events), "spawned_retired": all(r.state == r.S.RETIRED for r in plat.spawned),
                "primary": (primary.state.value, primary not in plat.spawned)}
    finally:
        plat.shutdown()


def test_sim_scale_out_recovers_throughput_then_trough_scale_in():
    """The replicated data plane end to end, in virtual time, on both
    packages: a hot function under 2x its single-unit capacity gains
    replicas from the rho-driven autoscaler (makespan shrinks vs the
    single-instance baseline), the strict class stays in target, every
    future resolves with its own payload, no resolve lands on a draining
    replica, and once the load stops trough scale-in drains back to one
    replica, newest first."""
    port, ref = both(_scale_case)
    assert port["payloads"] == [r * 100 + lane * 10 + k for r in range(40) for lane in range(4) for k in range(2)]
    assert port["replicas"] == 3 and port["scale_outs"] == 2 and port["rho_reasons"]
    assert port["all_served"] and port["picked"] == [True, True, True]
    assert port["speedup_ok"] and port["gold_met"] is True
    assert port["scale_ins"] == 2 and port["spawned_retired"]
    assert port["primary"] == ("serving", True), "the primary replica must persist"
    assert port == ref


def _drain_case(pkg):
    clock = PKGS[pkg]["Clock"]()
    plat = _SimPlatform(pkg, clock)
    S = plat.S
    try:
        plat.deploy("hot")
        victim = plat._spawn_replica("hot")
        assert victim is not None and plat.registry.replica_count("hot") == 2
        finished = []

        def in_flight():
            victim.begin_request()
            try:
                clock.sleep(0.05)
            finally:
                victim.end_request()
            finished.append(clock.now())

        worker = threading.Thread(target=in_flight, daemon=True)
        worker.start()
        settle(clock)  # the request is mid-service, parked on the clock
        out = {}
        drainer = threading.Thread(
            target=lambda: out.update(event=plat.lifecycle.scale_in(victim, reason="trough")), daemon=True)
        drainer.start()
        settle(clock, 2)  # drainer blocked in retire, worker still serving
        assert victim.state == S.DRAINING
        assert not finished, "scale-in must not cancel the in-flight request"
        assert plat.registry.replicas("hot") == (plat.registry.get("hot"),)
        for _ in range(8):
            inst, state = plat.registry.resolve_entry("hot")
            assert inst is not victim and state == S.SERVING
        clock.advance(0.05)  # the request completes -> drain finishes
        worker.join(timeout=5)
        drainer.join(timeout=5)
        assert finished and victim.state == S.RETIRED
        event = out["event"]
        sole = plat.lifecycle.scale_in(plat.registry.get("hot"))
        clock.assert_elapsed_real_below(REAL_BUDGET_S)
        return (event.kind, event.names, event.retired == (victim.instance_id,), sole,
                plat.registry.get("hot").state.value)
    finally:
        plat.shutdown()


def test_sim_scale_in_never_drops_an_in_flight_request():
    """Scale-in's drain path: route removal + DRAINING happen atomically
    (no resolve can pick the victim), but retirement waits for the victim's
    in-flight request to finish; a sole replica refuses to scale in."""
    port, ref = both(_drain_case)
    assert port == ("scale-in", ("hot",), True, None, "serving")
    assert port == ref


# ----------------------------------------------- fuse-vs-replicate policy


def _edge(pkg, sync_count=50, mean_wait_s=0.05):
    return PKGS[pkg]["EdgeStats"](sync_count=sync_count, total_wait_s=sync_count * mean_wait_s)


def _saturated(pkg):
    return PKGS[pkg]["Signals"](queue_depth=4, mean_occupancy=1.0, p95_ms=0.0)


def _decision(d):
    return (d.fuse, d.replicate, d.reason, sorted(d.group))


def test_policy_flips_replicate_when_spinup_beats_merge_cost():
    out = {}
    for pkg in PKGS:
        pol = PKGS[pkg]["Policy"](merge_cost_s=2.0)
        warm = pol.decide("A", "B", _edge(pkg), "t", "t", _saturated(pkg), replica_spinup_s=0.05,
                          callee_replicas=1)
        slow = pol.decide("A", "B", _edge(pkg), "t", "t", _saturated(pkg), replica_spinup_s=5.0,
                          callee_replicas=1)
        out[pkg] = (_decision(warm), _decision(slow))
    (warm, slow) = out["port"]
    assert warm[1] and not warm[0] and "replica" in warm[2] and "beats merge" in warm[2]
    # spin-up slower than the merge itself: back to the penalized-merge arm
    assert not slow[1] and slow[0] and "saturated" in slow[2]
    assert out["port"] == out["jax"]


def test_policy_replicate_arm_respects_cap_estimate_and_kill_switch():
    cases = [
        (dict(merge_cost_s=2.0, max_replica_hint=2), True, dict(replica_spinup_s=0.05, callee_replicas=2)),
        (dict(merge_cost_s=2.0), True, dict(replica_spinup_s=None, callee_replicas=1)),
        (dict(merge_cost_s=2.0, replicate_enabled=False), True, dict(replica_spinup_s=0.05, callee_replicas=1)),
        (dict(merge_cost_s=2.0), False, dict(replica_spinup_s=0.05, callee_replicas=1)),
    ]
    for knobs, saturated, kw in cases:
        got = {}
        for pkg in PKGS:
            sig = _saturated(pkg) if saturated else PKGS[pkg]["Signals"](queue_depth=0, mean_occupancy=0.1)
            got[pkg] = _decision(PKGS[pkg]["Policy"](**knobs).decide("A", "B", _edge(pkg), "t", "t", sig, **kw))
        assert not got["port"][1], (knobs, kw, got["port"])
        assert got["port"] == got["jax"]


@pytest.mark.parametrize("spinup", [None, 0.01, 0.5, 2.0, 8.0])
@pytest.mark.parametrize("replicas", [1, 3, 4])
@pytest.mark.parametrize("load", ["saturated", "calm", "slo", "cold-slow", "none"])
@pytest.mark.parametrize("bias", [0.5, 1.0])
def test_decide_replicate_arm_grid_equals_the_jax_policy(spinup, replicas, load, bias):
    """``decide`` on the same edge, signals, spin-up estimate, replica count
    and replicate bias gives the same decision in both policies — fuse,
    replicate, reason and group — over a grid of the replicate arm's
    inputs, with the measured-cost model absent and present."""
    sig_kw = {"saturated": dict(queue_depth=4, mean_occupancy=1.0, p95_ms=0.0),
              "calm": dict(queue_depth=0, mean_occupancy=0.1, p95_ms=0.0),
              "slo": dict(queue_depth=0, mean_occupancy=0.1, p95_ms=400.0,
                          class_p95_ms=(("gold", 300.0, 250.0),)),
              "cold-slow": dict(queue_depth=0, mean_occupancy=0.1, p95_ms=100.0),
              "none": None}[load]
    from repro.obs.critical_path import EdgeCostModel as RefCost
    from repro_torch.obs.critical_path import EdgeCostModel

    for with_costs in (False, True):
        got = {}
        for pkg, Cost in (("port", EdgeCostModel), ("jax", RefCost)):
            pol = PKGS[pkg]["Policy"](merge_cost_s=2.0, replicate_bias=bias, max_replica_hint=4,
                                      min_observations=3)
            if with_costs:
                pol.cost_model = Cost()
                pol.cost_model.observe_sync_edge("A", "B", 0.02)
                pol.cost_model.observe_merge_stall(1.5, 3)
            sig = None if sig_kw is None else PKGS[pkg]["Signals"](**sig_kw)
            got[pkg] = [_decision(pol.decide("A", "B", _edge(pkg, n, w), "t", "t", sig,
                                             replica_spinup_s=spinup, callee_replicas=replicas))
                        for n, w in ((1, 0.1), (2, 0.08), (50, 0.05), (500, 0.001))]
        assert got["port"] == got["jax"], (with_costs, got)


def test_decide_split_replica_count_halves_the_sustain_floor():
    out = {}
    for pkg in PKGS:
        members = frozenset({"a", "b"})
        sat = PKGS[pkg]["Signals"](queue_depth=4, mean_occupancy=1.0)
        pol = PKGS[pkg]["Policy"]()
        first = [pol.decide_split(members, signals=sat, age_s=5.0).split for _ in range(3)]
        d = PKGS[pkg]["Policy"]().decide_split(members, signals=sat, age_s=5.0, replica_count=3)
        out[pkg] = (first, d.split, "replica pressure" in d.reason, d.partition)
    assert out["port"] == ([False, False, True], True, True, (frozenset({"a"}), frozenset({"b"})))
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("replica_count", [1, 2, 4])
@pytest.mark.parametrize("sustain", [1, 3])
@pytest.mark.parametrize("age_s", [0.2, 5.0])
def test_decide_split_grid_equals_the_jax_policy(replica_count, sustain, age_s):
    """The same sequence of regret evaluations — saturated, SLO-violating,
    calm, tail-regressed and diverged inputs, in an order that builds and
    breaks streaks — gives the same SplitDecisions in both policies."""
    steps = [
        dict(signals=dict(queue_depth=4, mean_occupancy=1.0)),
        dict(signals=dict(queue_depth=4, mean_occupancy=1.0)),
        dict(signals=dict(queue_depth=0, mean_occupancy=0.1)),
        dict(signals=dict(queue_depth=0, mean_occupancy=0.1, p95_ms=300.0, class_p95_ms=(("gold", 300.0, 250.0),))),
        dict(signals=dict(queue_depth=0, mean_occupancy=0.1, p95_ms=300.0, class_p95_ms=(("gold", 300.0, 250.0),))),
        dict(signals=dict(queue_depth=4, mean_occupancy=1.0)),
        dict(signals=dict(queue_depth=4, mean_occupancy=1.0)),
        dict(signals=dict(queue_depth=4, mean_occupancy=1.0)),
        dict(baseline_p95_ms=10.0, current_p95_ms=14.0),
        dict(baseline_p95_ms=10.0, current_p95_ms=20.0),
        dict(member_rates={"a": 100.0, "b": 0.0, "c": 50.0}, baseline_rates={"a": 90.0, "b": 0.0, "c": 40.0}),
        dict(member_rates={"a": 100.0, "b": 1.0, "c": 2.0}, baseline_rates={"a": 90.0, "b": 30.0, "c": 40.0}),
        dict(member_rates={"a": 0.0, "b": 0.0, "c": 0.0}, baseline_rates={"a": 9.0, "b": 3.0, "c": 4.0}),
    ]
    got = {}
    for pkg in PKGS:
        pol = PKGS[pkg]["Policy"](split_sustain=sustain, min_group_age_s=1.0, cold_rate_ratio=0.05)
        out = []
        for step in steps:
            kw = dict(step)
            if "signals" in kw:
                kw["signals"] = PKGS[pkg]["Signals"](**kw["signals"])
            d = pol.decide_split(frozenset({"a", "b", "c"}), age_s=age_s, replica_count=replica_count, **kw)
            out.append((d.split, d.reason, d.partition))
        got[pkg] = out
    assert got["port"] == got["jax"]
    if age_s >= 1.0:
        assert any(split for split, _, _ in got["port"])


# ------------------------------------- demand + billing attribution (real)


def _spawn_case(pkg):
    clock = PKGS[pkg]["Clock"]()
    if pkg == "port":
        p = TinyTorchBackend(FusionPolicy(enabled=False), clock=clock)
        p.deploy(FunctionSpec("f", lambda ctx, params, x: x * 2 + 1, None))
        x = torch.tensor
    else:
        p = TinyJaxBackend(RefPolicy(enabled=False), clock=clock)
        p.deploy(RefSpec("f", lambda ctx, params, x: x * 2 + 1, None))
        x = jnp.float32
    try:
        for i in range(6):
            p.invoke("f", x(float(i)))
        rate_before = p.handler.recent_rate("f")
        assert rate_before > 0.0
        replica = p._spawn_replica("f")
        assert replica is not None
        # the canary warm-up billed nothing and stamped no demand (the
        # virtual clock froze time, so the windowed rate is exact)
        assert p.handler.recent_rate("f") == rate_before
        calls_after_spawn = p.meter.summary()["by_function"]["f"]["calls"]
        prov = [r for r in p.meter.provisioning if r.kind == "scale-out"]
        outs = [float(p.invoke("f", x(float(i)))) for i in range(6)]
        by_inst = p.meter.by_instance()
        stats = p.stats()["replicas"]
        info = stats["functions"]["f"]
        clock.assert_elapsed_real_below(REAL_BUDGET_S)
        return {"calls_after_spawn": calls_after_spawn, "prov": [(r.billed, r.warm) for r in prov],
                "estimate": p.replica_spinup_estimate() is not None, "outs": outs,
                "replicas": len(info["replicas"]), "billed_calls": sum(d["calls"] for d in by_inst.values()),
                "picks": sorted(info["picks"].values()), "billing_subset": set(info["billing"]) <= set(info["replicas"]),
                "spread": stats["spread"], "calls": p.meter.summary()["by_function"]["f"]["calls"]}
    finally:
        p.shutdown()


def test_spawn_replica_stamps_no_demand_and_bills_each_request_once():
    """note_demand fires once per client request at the entry points; the
    spin-up canary goes through direct execute, so replica provisioning
    leaves the demand rate untouched, and the per-instance buckets sum to
    exactly the client request count across the replica set."""
    port, ref = both(_spawn_case)
    assert port["calls_after_spawn"] == 6
    assert port["prov"] == [(True, True)], "replica spin-up must be billed and warm"
    assert port["estimate"]
    assert port["outs"] == [i * 2 + 1 for i in range(6)]
    assert port["replicas"] == 2 and port["billed_calls"] == 12 and sum(port["picks"]) == 12
    assert all(n >= 2 for n in port["picks"]), "least-outstanding ties must rotate across idle replicas"
    assert port["billing_subset"] and port["spread"] == "least-outstanding" and port["calls"] == 12
    assert port == ref


# ------------------------------------------------ race fuzz (real platform)


class _CheckedTiny(TinyTorchBackend):
    """TinyTorchBackend whose dispatch paths resolve through ``resolve_entry``
    and record the replica state they observed — the fuzz's probe for 'no
    request lands on a DRAINING/RETIRED replica'."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.dispatches = 0
        self.state_violations = []
        self._obs_lock = threading.Lock()

    def _observe(self, instance, state):
        with self._obs_lock:
            self.dispatches += 1
            if state in (InstanceState.DRAINING, InstanceState.RETIRED):
                self.state_violations.append(f"{instance.instance_id} resolved while {state.value}")

    def _dispatch_sync(self, name, args):
        instance, state = self.registry.resolve_entry(name)
        self._observe(instance, state)
        return self._run_request(instance, name, args)

    def _dispatch_batch_impl(self, name, args_list):
        instance, state = self.registry.resolve_entry(name)
        self._observe(instance, state)
        return self._run_batch(instance, name, args_list)


@pytest.mark.parametrize("seed", [7, 23])
def test_conservation_under_replica_churn(seed):
    """Concurrent ``invoke_async`` traffic against a real TinyTorchBackend
    while a churn thread scales the replica set out and in and sometimes
    redeploys (displacing the WHOLE set): every future resolves exactly
    once with its own payload — the JAX platform's answer on the same
    inputs — no dispatch resolves a draining or retired replica, and the
    runtime lock graph stays acyclic."""
    rng = random.Random(seed)
    n_requests = 160
    max_replicas = 3
    lock_graph = LockGraph()
    lock_patch = patched_locks(lock_graph)
    lock_patch.__enter__()
    p = _CheckedTiny(FusionPolicy(enabled=False), max_batch=4, max_delay_ms=1.0, adaptive=True)
    stop = threading.Event()
    churn_errors = []
    try:
        p.deploy(FunctionSpec("hot", lambda ctx, params, x: x * 2 + 1, None))
        assert float(p.invoke("hot", torch.tensor(3.0))) == 7.0
        for _ in range(3):  # the 1/2/4 buckets exist before the trace
            done, not_done = wait([p.invoke_async("hot", torch.tensor(float(i))) for i in range(4)], timeout=30)
            assert not not_done

        def churn():
            while not stop.is_set():
                try:
                    roll = rng.random()
                    replicas = p.registry.replicas("hot")
                    if roll < 0.45 and len(replicas) < max_replicas:
                        p._spawn_replica("hot")
                    elif roll < 0.8 and len(replicas) > 1:
                        p.lifecycle.scale_in(replicas[-1], reason="fuzz")  # raced no-ops return None
                    elif roll >= 0.9:
                        p._redeploy("hot")  # publish churn: displace the WHOLE replica set
                except Exception as exc:  # noqa: BLE001 — a churn crash is a finding
                    churn_errors.append(repr(exc))
                time.sleep(0.002)  # provlint: ok — real concurrency, not a simulated wait

        churner = threading.Thread(target=churn, daemon=True)
        churner.start()
        futs = []
        resolution_counts = {}
        counts_lock = threading.Lock()

        def stamp(idx):
            def cb(_fut):
                with counts_lock:
                    resolution_counts[idx] = resolution_counts.get(idx, 0) + 1
            return cb

        i = 0
        while i < n_requests:
            for _ in range(rng.randrange(1, 7)):  # bursts coalesce into batches
                if i >= n_requests:
                    break
                fut = p.invoke_async("hot", torch.tensor(float(i)))
                fut.add_done_callback(stamp(i))
                futs.append((i, fut))
                i += 1
            if rng.random() < 0.4:
                time.sleep(rng.choice([0.0005, 0.002]))  # provlint: ok — real arrival gaps

        done, not_done = wait([f for _, f in futs], timeout=60)
        stop.set()
        churner.join(timeout=10)
        lock_patch.__exit__(None, None, None)
        lock_patch = None
        assert not not_done, f"{len(not_done)} futures hung (conservation violated)"
        assert not churn_errors, churn_errors[:3]
        assert not p.state_violations, p.state_violations[:3]
        got = [float(fut.result()) for _, fut in futs]
        deadline = time.perf_counter() + 5.0
        while time.perf_counter() < deadline:
            with counts_lock:
                if len(resolution_counts) >= n_requests:
                    break
            time.sleep(0.001)  # provlint: ok — done-callbacks run after result()
        with counts_lock:
            assert len(resolution_counts) == n_requests
            assert all(c == 1 for c in resolution_counts.values()), "a future resolved more than once"
        kinds = {e.kind for e in p.lifecycle.events}
        assert "scale-out" in kinds, kinds
        assert p.registry.replica_count("hot") >= 1 and p.dispatches > 0
        lock_graph.assert_acyclic()
        assert lock_graph.edges(), "lock instrumentation never fired"
    finally:
        stop.set()
        if lock_patch is not None:
            lock_patch.__exit__(None, None, None)
        p.shutdown()
        lock_graph.assert_acyclic()  # shutdown's drains are part of the trace
    jp = TinyJaxBackend(RefPolicy(enabled=False))
    try:
        jp.deploy(RefSpec("hot", lambda ctx, params, x: x * 2 + 1, None))
        want = np.asarray([jp.invoke("hot", jnp.float32(i)) for i in range(n_requests)], dtype=np.float64)
    finally:
        jp.shutdown()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
