"""The port's control plane against the JAX package's: the cases of
``tests/test_lifecycle.py`` — epoch-versioned routing, the instance
lifecycle, reversible fusion (fission), the merge<->split hysteresis, the
trough-gated transition queue — on both port backends, each compared with
the JAX package on the same inputs; and the split -> re-merge round trip on
a reduced llama chain in both packages (logits within 2e-5 of max |logit|
before the split, after it and after the re-merge)."""
import dataclasses
import os
import pickle
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # the suite runs several workers at once: leave them cores

import jax.numpy as jnp  # noqa: E402

from repro.core import FunctionSpec as RefSpec  # noqa: E402
from repro.core import FusionPolicy as RefPolicy  # noqa: E402
from repro.core import TinyJaxBackend  # noqa: E402
from repro.core.handler import EdgeStats as RefEdgeStats  # noqa: E402
from repro.core.registry import RoutingTable as RefRoutingTable  # noqa: E402
from repro.scheduler import SchedulerSignals as RefSignals  # noqa: E402
from repro.scheduler import VirtualClock as RefClock  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.core import (  # noqa: E402
    FunctionInstance,
    FunctionSpec,
    FusionPolicy,
    InstanceState,
    OrchestratedBackend,
    SplitDecision,
    TinyTorchBackend,
)
from repro_torch.core.function import INSTANCE_RUNTIME_OVERHEAD_BYTES  # noqa: E402
from repro_torch.core.handler import EdgeStats  # noqa: E402
from repro_torch.core.registry import RoutingTable  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.scheduler.adaptive import SchedulerSignals  # noqa: E402
from repro_torch.scheduler.clock import VirtualClock  # noqa: E402
from repro_torch.scheduler.scheduler import RequestScheduler  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TOL = 2e-5  # fp32 (tests/test_kernels.py)
BACKENDS = [TinyTorchBackend, OrchestratedBackend]

W = np.eye(8, dtype=np.float32) * 0.5
X = np.ones((2, 8), np.float32)


def deploy_chain(platform, w=W):
    wt = torch.from_numpy(w)
    platform.deploy(FunctionSpec("A", lambda ctx, p, x: ctx.call("B", torch.tanh(x @ p)), wt))
    platform.deploy(FunctionSpec("B", lambda ctx, p, x: ctx.call("C", torch.tanh(x @ p)), wt))
    platform.deploy(FunctionSpec("C", lambda ctx, p, x: torch.tanh(x @ p), wt))


@pytest.fixture(scope="module")
def jax_chain():
    """The JAX platform's answer for the toy chain A -> B -> C on X."""
    p = TinyJaxBackend(RefPolicy(enabled=False))
    try:
        w = jnp.asarray(W)
        p.deploy(RefSpec("A", lambda ctx, q, x: ctx.call("B", jnp.tanh(x @ q)), w))
        p.deploy(RefSpec("B", lambda ctx, q, x: ctx.call("C", jnp.tanh(x @ q)), w))
        p.deploy(RefSpec("C", lambda ctx, q, x: jnp.tanh(x @ q), w))
        return np.asarray(p.invoke("A", jnp.asarray(X)))
    finally:
        p.shutdown()


def near(out, want):
    np.testing.assert_allclose(np.asarray(out), want, rtol=TOL, atol=TOL)


# --------------------------------------------------------------- registry


def _version_pins(rt):
    a, b = object(), object()
    out = [rt.version]
    rt.publish({})  # empty publish: no epoch
    out.append(rt.version)
    rt.register("f", a)
    out.append(rt.version)
    rt.register("f", a)  # identical route: no epoch
    out.append(rt.version)
    rt.swap([], b)  # empty swap: no epoch
    rt.swap(["f"], a)  # still identical: no epoch
    out.append(rt.version)
    rt.swap(["f"], b)
    out.append(rt.version)
    rt.publish({"f": b, "g": b})  # one real change among no-ops: ONE epoch
    out.append(rt.version)
    rt.unpublish(["f", "g"])
    rt.unpublish(["f"])  # nothing routed: no epoch
    out.append(rt.version)
    return out


def test_routing_version_bumps_only_on_actual_change():
    port = _version_pins(RoutingTable())
    assert port == [0, 0, 1, 1, 1, 2, 3, 4]
    assert port == _version_pins(RefRoutingTable())


# --------------------------------------------------- resolve-during-swap


@pytest.mark.parametrize("backend_cls", BACKENDS)
def test_concurrent_resolve_never_observes_draining(backend_cls):
    """Readers hammer resolve_entry while epoch publishes displace and
    retire the routed instance underneath them: the state read atomically
    with the route is never DRAINING or RETIRED."""
    p = backend_cls(FusionPolicy(enabled=False))
    try:
        p.deploy(FunctionSpec("F", lambda ctx, params, x: x + 1, None))
        bad: list = []
        stop = threading.Event()

        def reader():
            while not stop.is_set():
                inst, state = p.registry.resolve_entry("F")
                if state in (InstanceState.DRAINING, InstanceState.RETIRED):
                    bad.append((inst.instance_id, state))

        threads = [threading.Thread(target=reader, daemon=True) for _ in range(4)]
        for t in threads:
            t.start()
        spec = p.spec_of("F")
        for _ in range(60):
            fresh = FunctionInstance({"F": spec}, p)
            p.attach_instance(fresh)
            fresh.mark_ready()
            event = p.lifecycle.publish({"F": fresh}, kind="redeploy", reason="churn")
            assert event.retired, "each publish must retire the displaced instance"
        stop.set()
        for t in threads:
            t.join(timeout=10)
        assert not bad, f"resolve observed draining/retired instances: {bad[:5]}"
        assert p.registry.resolve("F").state == InstanceState.SERVING
        assert int(p.invoke("F", torch.tensor(1))) == 2
        if backend_cls is OrchestratedBackend:
            assert set(p.pods()) == {p.registry.resolve("F").instance_id}, "every displaced pod stops"
    finally:
        p.shutdown()


# --------------------------------------------------------- split round trip


@pytest.mark.parametrize("backend_cls", BACKENDS)
def test_split_merge_round_trip_preserves_outputs(backend_cls, jax_chain):
    # the policy's re-merge backoff runs on its own virtual clock: the test
    # expires the hysteresis window by advancing, not by sleeping
    policy_clock = VirtualClock()
    p = backend_cls(FusionPolicy(min_observations=1, merge_cost_s=0.0,
                                 remerge_backoff_s=0.05, clock=policy_clock))
    try:
        deploy_chain(p)
        x = torch.from_numpy(X)
        ref = p.invoke("A", x)
        near(ref, jax_chain)
        for _ in range(4):
            p.invoke("A", x)
        p.merger.wait_idle()
        fused = p.registry.resolve("A")
        assert fused.members.keys() == {"A", "B", "C"}, "chain must fully fuse"
        epoch_before = p.lifecycle.epoch

        event = p.merger.split(
            frozenset({"A", "B", "C"}),
            [frozenset({"A"}), frozenset({"B"}), frozenset({"C"})],
            reason="test fission",
        )
        assert event is not None and event.healthy
        assert event.epoch == p.lifecycle.epoch == epoch_before + 1
        assert set(event.checked_members), "split must health-check against canaries"
        insts = {n: p.registry.resolve(n) for n in ("A", "B", "C")}
        assert len({id(i) for i in insts.values()}) == 3
        assert fused.state == InstanceState.RETIRED
        near(p.invoke("A", x), jax_chain)
        if backend_cls is OrchestratedBackend:
            assert set(p.pods()) == {i.instance_id for i in insts.values()}, "the fused unit's pod stops"

        # hysteresis: fresh hot traffic must NOT immediately re-merge
        n_merges = len(p.merger.merge_log)
        p.invoke("A", x)
        p.merger.wait_idle()
        assert len(p.merger.merge_log) == n_merges, "re-merge inside backoff window"

        # after the backoff expires the merge is allowed again (reversible
        # fusion, not permanent fission) and semantics still hold
        policy_clock.advance(0.08)
        for _ in range(6):
            p.invoke("A", x)
        p.merger.wait_idle()
        assert p.registry.resolve("A").members.keys() == {"A", "B", "C"}
        near(p.invoke("A", x), jax_chain)
        stats = p.stats()
        kinds = [e["kind"] for e in stats["lifecycle"]["events"]]
        assert "split" in kinds and "merge" in kinds and "deploy" in kinds
        assert stats["splits"] and stats["splits"][0]["reason"] == "test fission"
    finally:
        p.shutdown()


@pytest.mark.parametrize("backend_cls", BACKENDS)
def test_split_rejects_bad_partition_and_stale_group(backend_cls):
    p = backend_cls(FusionPolicy(min_observations=1, merge_cost_s=0.0))
    try:
        deploy_chain(p)
        x = torch.from_numpy(X)
        for _ in range(4):
            p.invoke("A", x)
        p.merger.wait_idle()
        with pytest.raises(ValueError):
            p.merger.split(frozenset({"A", "B", "C"}), [frozenset({"A"})])
        # a group that is not (or no longer) routed as one unit: no-op
        assert p.merger.split(frozenset({"A", "D"}), [frozenset({"A"}), frozenset({"D"})]) is None
    finally:
        p.shutdown()


# ----------------------------------------------------------- hysteresis


def _flapping(pkg):
    Clock, Policy, Signals, Stats = {
        "port": (VirtualClock, FusionPolicy, SchedulerSignals, EdgeStats),
        "jax": (RefClock, RefPolicy, RefSignals, RefEdgeStats)}[pkg]
    clock = Clock()
    policy = Policy(split_sustain=3, min_group_age_s=0.5, remerge_backoff_s=0.2,
                    split_occupancy=0.8, split_depth=2, clock=clock)
    policy.commit("A", "B")
    members = frozenset({"A", "B"})
    hot = Signals(queue_depth=10, mean_occupancy=0.95, p95_ms=50.0)
    cold = Signals(queue_depth=0, mean_occupancy=0.1, p95_ms=5.0)
    log = []
    for _ in range(5):  # too young: even sustained saturation cannot split
        log.append(policy.decide_split(members, signals=hot, age_s=0.1).split)
    for _ in range(6):  # oscillating saturation: the streak resets
        for sig in (hot, hot, cold):
            log.append(policy.decide_split(members, signals=sig, age_s=1.0).split)
    log.append(policy.decide_split(members, signals=hot, age_s=1.0).split)
    log.append(policy.decide_split(members, signals=hot, age_s=1.0).split)
    d = policy.decide_split(members, signals=hot, age_s=1.0)
    log.append((d.split, d.reason, d.partition))
    policy.dissolve(d.partition)  # post-split: the edge is in backoff
    stats = Stats(sync_count=100, total_wait_s=10.0)
    refused = policy.decide("A", "B", stats, "t", "t")
    log.append((refused.fuse, refused.reason))
    clock.advance(0.25)  # backoff expired (virtually): fusion available again
    log.append(policy.decide("A", "B", stats, "t", "t").fuse)
    clock.assert_elapsed_real_below(10.0)
    return log


def test_fission_hysteresis_prevents_flapping():
    """Oscillating load must not flap merge<->split: saturation has to be
    *sustained* to split, a fresh merge cannot split inside its age floor,
    and a fresh split cannot re-merge inside its backoff — on the virtual
    clock, with the same decisions in both policies."""
    port = _flapping("port")
    assert len(port) == 28 and not any(port[:25])
    split, reason, partition = port[25]
    assert split and "saturation" in reason and set().union(*partition) == {"A", "B"}
    assert port[26] == (False, "recently split (fission hysteresis)")
    assert port[27] is True
    assert port == _flapping("jax")


def _regret(Policy):
    policy = Policy(min_group_age_s=0.0, regret_p95_factor=1.5, cold_rate_ratio=0.1)
    members = frozenset({"A", "B"})
    out = []
    for kw in (dict(baseline_p95_ms=10.0, current_p95_ms=20.0),
               dict(member_rates={"A": 100.0, "B": 0.0}, baseline_rates={"A": 90.0, "B": 0.0}),
               dict(member_rates={"A": 100.0, "B": 0.0}, baseline_rates={"A": 90.0, "B": 50.0})):
        d = policy.decide_split(members, age_s=1.0, **kw)
        out.append((d.split, d.reason, d.partition))
    return out


def test_decide_split_regret_signals():
    tail, interior, diverged = _regret(FusionPolicy)
    assert tail[0] and "p95" in tail[1]
    # only members with DIRECT pre-merge demand can go cold
    assert not interior[0]
    assert diverged[0] and "diverged" in diverged[1] and frozenset({"B"}) in diverged[2]
    assert [tail, interior, diverged] == _regret(RefPolicy)


@pytest.mark.parametrize("backend_cls", BACKENDS)
def test_healthy_fused_chain_never_splits_on_divergence(backend_cls, jax_chain):
    """A chain whose interior members are served by inlined calls must not
    read as 'traffic diverged': demand baselines count only direct client
    traffic and inbound edges from OUTSIDE the group."""
    p = backend_cls(FusionPolicy(min_observations=1, merge_cost_s=0.0, min_group_age_s=0.0))
    try:
        deploy_chain(p)
        x = torch.from_numpy(X)
        for _ in range(5):
            p.invoke("A", x)  # client traffic lands on A only
        p.merger.wait_idle()
        assert p.registry.resolve("A").members.keys() == {"A", "B", "C"}
        rec = p.merger.committed_groups()[0]
        assert rec.baseline_rates["B"] == 0.0 and rec.baseline_rates["C"] == 0.0
        for _ in range(5):
            assert p.merger.evaluate_splits() == []
        assert p.registry.resolve("A").members.keys() == {"A", "B", "C"}
        near(p.invoke("A", x), jax_chain)
    finally:
        p.shutdown()


@pytest.mark.parametrize("backend_cls", BACKENDS)
def test_failed_split_is_quarantined_not_retried(backend_cls):
    p = backend_cls(FusionPolicy(min_observations=1, merge_cost_s=0.0))
    try:
        w = torch.from_numpy(W)
        p.deploy(FunctionSpec("A", lambda ctx, q, x: ctx.call("B", x @ q), w))
        p.deploy(FunctionSpec("B", lambda ctx, q, x: torch.tanh(x @ q), w))
        x = torch.from_numpy(X)
        for _ in range(3):
            p.invoke("A", x)
        p.merger.wait_idle()
        fused = p.registry.resolve("A")
        assert fused.members.keys() == {"A", "B"}
        # corrupt B's SPEC: rebuilt units diverge from the live fused unit
        good = p._specs["B"]
        p._specs["B"] = FunctionSpec("B", lambda ctx, q, xx: torch.tanh(xx @ q) + 100.0, good.params)
        members = frozenset({"A", "B"})
        cells = [frozenset({"A"}), frozenset({"B"})]
        event = p.merger.split(members, cells, reason="doomed")
        assert event is not None and not event.healthy
        assert event.reason == "health check failed"
        assert p.registry.resolve("A") is fused, "unhealthy split must not swap"
        if backend_cls is OrchestratedBackend:
            assert set(p.pods()) == {fused.instance_id}, "the rebuilt units' pods stop"
        # a persistent regret signal must NOT rebuild the doomed partition
        p.policy.decide_split = lambda *a, **k: SplitDecision(True, "forced", tuple(cells))
        n_events = len(p.merger.split_log)
        assert p.merger.evaluate_splits() == []
        assert len(p.merger.split_log) == n_events, "quarantined split was rebuilt"
    finally:
        p.shutdown()


# ------------------------------------------------------------- redeploy


def test_redeploy_retires_displaced_worker():
    p = OrchestratedBackend(FusionPolicy(enabled=False))
    try:
        p.deploy(FunctionSpec("B", lambda ctx, params, x: x + 1, None))
        old = p.registry.resolve("B")
        old_worker = p._workers[old.instance_id]
        ram_before = p.ram_bytes()
        old.state = InstanceState.RETIRED  # simulate a crashed container
        old.params = {}
        assert int(p.invoke("B", torch.tensor(1, dtype=torch.int32))) == 2  # re-provisions
        fresh = p.registry.resolve("B")
        assert fresh is not old and fresh.state == InstanceState.SERVING
        old_worker.thread.join(timeout=10)
        assert not old_worker.thread.is_alive(), "displaced pod's loop must exit"
        assert old.instance_id not in p._workers, "displaced pod leaked"
        assert p.ram_bytes() < ram_before + INSTANCE_RUNTIME_OVERHEAD_BYTES, \
            "retired instance still counted in RAM"
        events = [e for e in p.lifecycle.stats()["events"] if e["kind"] == "redeploy"]
        assert events and old.instance_id in events[-1]["retired"]
    finally:
        p.shutdown()
    jp = TinyJaxBackend(RefPolicy(enabled=False))
    try:  # the JAX platform re-provisions the same crashed container alike
        jp.deploy(RefSpec("B", lambda ctx, params, x: x + 1, None))
        jold = jp.registry.resolve("B")
        jold.state = jold.state.__class__.RETIRED
        jold.params = {}
        assert int(jp.invoke("B", jnp.int32(1))) == 2
        assert [e.kind for e in jp.lifecycle.events] == [e.kind for e in p.lifecycle.events]
    finally:
        jp.shutdown()


# ------------------------------------------------------- merger threads


@pytest.mark.parametrize("backend_cls", BACKENDS)
def test_merger_threads_pruned_under_async_build(backend_cls, jax_chain):
    p = backend_cls(FusionPolicy(min_observations=1, merge_cost_s=0.0), async_build=True)
    try:
        deploy_chain(p)
        x = torch.from_numpy(X)
        # park a pile of completed threads where submit used to leak them
        for _ in range(50):
            t = threading.Thread(target=lambda: None)
            t.start()
            t.join()
            p.merger._threads.append(t)
        for _ in range(4):
            p.invoke("A", x)
        p.merger.wait_idle()
        assert p.merger._threads == [], "wait_idle must prune completed builds"
        assert [m for m in p.merger.merge_log if m.healthy], "merge must have run"
        near(p.invoke("A", x), jax_chain)
    finally:
        p.shutdown()


# ----------------------------------------------------- trough + barrier


def _trough_barrier(Scheduler):
    release = threading.Event()

    def dispatch(name, args_list):
        release.wait(2.0)
        return [a[0] for a in args_list]

    s = Scheduler(dispatch, max_batch=4, max_delay_ms=1.0)
    try:
        futs = [s.submit("f", (i,)) for i in range(4)]
        deadline = time.perf_counter() + 1.0
        saw_busy = False
        while time.perf_counter() < deadline:
            if not s.is_trough(min_quiet_s=0.0):
                saw_busy = True
                break
            time.sleep(0.001)  # provlint: ok — polls a real dispatcher thread
        timed_out = not s.quiesce(timeout=0.05)
        release.set()
        drained = s.quiesce(timeout=5.0)
        results = [f.result(timeout=5) for f in futs]
        deadline = time.perf_counter() + 5.0
        while not s.is_trough(min_quiet_s=0.01) and time.perf_counter() < deadline:
            time.sleep(0.002)  # provlint: ok — waits out the real quiet window
        return saw_busy, timed_out, drained, results, s.is_trough(min_quiet_s=0.01)
    finally:
        s.shutdown()


def test_scheduler_trough_and_quiesce_barrier():
    """An in-flight batch defeats the trough detector and the quiesce
    barrier; both clear once the dispatch finishes — in both schedulers."""
    from repro.scheduler import RequestScheduler as RefScheduler

    port = _trough_barrier(RequestScheduler)
    assert port == (True, True, True, [0, 1, 2, 3], True)
    assert port == _trough_barrier(RefScheduler)


@pytest.mark.parametrize("backend_cls", BACKENDS)
def test_reconciler_executes_queued_transition_in_trough(backend_cls):
    p = backend_cls(FusionPolicy(enabled=False))
    try:
        ran = threading.Event()
        p.lifecycle.enqueue(ran.set, kind="test", names=("X",), max_defer_s=30.0)
        # no traffic at all -> permanent trough -> runs on the next tick,
        # long before the 30s deadline
        assert ran.wait(5.0), "reconciler must run queued work in a trough"
        assert p.lifecycle.wait_idle(5.0) and p.lifecycle.queued_transitions() == 0
    finally:
        p.shutdown()
    jp = TinyJaxBackend(RefPolicy(enabled=False))
    try:
        jran = threading.Event()
        jp.lifecycle.enqueue(jran.set, kind="test", names=("X",), max_defer_s=30.0)
        assert jran.wait(5.0)
    finally:
        jp.shutdown()


@pytest.mark.parametrize("backend_cls", BACKENDS)
def test_trough_merge_runs_on_the_reconciler_and_records_its_deferral(backend_cls):
    """``trough_merges`` on a two-function chain (``load_bench``'s churn
    scenario): the promoted merge queues on the reconciler, re-runs its
    decision when it executes, and its epoch records how long it was held;
    ``merger.wait_idle`` forces what is still queued. The outputs match the
    JAX platform's on the same inputs. (A three-function chain can end in
    two overlapping units in the reference: ``wait_idle`` runs queued merges
    on the caller's thread while the reconciler runs another, so two
    revalidated decisions can both see the other's group uncommitted. The
    port's ends in one: the next test.)"""
    w = torch.from_numpy(W)
    p = backend_cls(FusionPolicy(min_observations=2, merge_cost_s=0.0), trough_merges=True, max_defer_s=0.2)
    try:
        p.deploy(FunctionSpec("H", lambda ctx, q, x: ctx.call("L", torch.tanh(x @ q)), w))
        p.deploy(FunctionSpec("L", lambda ctx, q, x: torch.tanh(x @ q), w))
        x = torch.from_numpy(X)
        outs = [p.invoke("H", x) for _ in range(4)]
        p.merger.wait_idle()
        assert p.registry.resolve("H").members.keys() == {"H", "L"}
        merges = [e for e in p.lifecycle.events if e.kind == "merge"]
        assert len(merges) == 1 and merges[0].deferred_s >= 0.0
        assert p.lifecycle.queued_transitions() == 0
        outs.append(p.invoke("H", x))
    finally:
        p.shutdown()
    jp = TinyJaxBackend(RefPolicy(enabled=False))
    try:
        jw = jnp.asarray(W)
        jp.deploy(RefSpec("H", lambda ctx, q, x: ctx.call("L", jnp.tanh(x @ q)), jw))
        jp.deploy(RefSpec("L", lambda ctx, q, x: jnp.tanh(x @ q), jw))
        want = np.asarray(jp.invoke("H", jnp.asarray(X)))
    finally:
        jp.shutdown()
    for out in outs:
        near(out, want)


TROUGH_TRIALS = 4


@pytest.mark.parametrize("backend_cls", BACKENDS)
def test_trough_merges_of_a_three_function_chain_end_in_one_unit(backend_cls):
    """The case beside the one above that the reference can lose: ``trough_merges``
    on a three-function chain A -> B -> C. Both edges promote; their merges
    queue on the reconciler, and ``merger.wait_idle`` runs what is still
    queued on this thread while the reconciler may run another. The port's
    Merger publishes by compare-and-swap over the live closure of the units
    its functions are routed to (``core/merger.py``, a deviation by design:
    ROADMAP), so every trial ends in ONE unit holding all three, routed from
    each name, with no transition left queued and the JAX platform's
    outputs before and after."""
    w = torch.from_numpy(W)
    x = torch.from_numpy(X)
    jp = TinyJaxBackend(RefPolicy(enabled=False))
    try:
        jw = jnp.asarray(W)
        jp.deploy(RefSpec("A", lambda ctx, q, v: ctx.call("B", jnp.tanh(v @ q)), jw))
        jp.deploy(RefSpec("B", lambda ctx, q, v: ctx.call("C", jnp.tanh(v @ q)), jw))
        jp.deploy(RefSpec("C", lambda ctx, q, v: jnp.tanh(v @ q), jw))
        want = np.asarray(jp.invoke("A", jnp.asarray(X)))
    finally:
        jp.shutdown()
    for _ in range(TROUGH_TRIALS):
        p = backend_cls(FusionPolicy(min_observations=2, merge_cost_s=0.0), trough_merges=True, max_defer_s=0.2)
        try:
            p.deploy(FunctionSpec("A", lambda ctx, q, v: ctx.call("B", torch.tanh(v @ q)), w))
            p.deploy(FunctionSpec("B", lambda ctx, q, v: ctx.call("C", torch.tanh(v @ q)), w))
            p.deploy(FunctionSpec("C", lambda ctx, q, v: torch.tanh(v @ q), w))
            outs = [p.invoke("A", x) for _ in range(4)]
            p.merger.wait_idle()
            assert p.lifecycle.wait_idle(5.0) and p.lifecycle.queued_transitions() == 0
            live = p.registry.live_instances()
            assert len(live) == 1, f"overlapping units: {live}"
            assert {n: set(p.registry.resolve(n).members) for n in "ABC"} == dict.fromkeys("ABC", {"A", "B", "C"})
            assert all(p.registry.resolve(n) is live[0] for n in "ABC")
            assert any(e.kind == "merge" for e in p.lifecycle.events)
            outs.append(p.invoke("A", x))
        finally:
            p.shutdown()
        for out in outs:
            near(out, want)


# ----------------------------------- split -> re-merge on a reduced llama


PROMPT = np.random.default_rng(5).integers(0, 256, (2, 8)).astype(np.int32)
STEPS = 4
MAX_LEN = 32
FUSING = dict(min_observations=2, merge_cost_s=0.0, promote_wait_s=float("inf"), remerge_backoff_s=0.05)

# The JAX engine's side, in a process of its own at a lower priority (as
# tests/test_torch_coldstart.py runs it): fused, split into two cells,
# re-merged after the backoff (advanced on a virtual clock); each phase's
# greedy logits.
JAX_SPLIT = """
import dataclasses, os, pickle, sys
os.nice(10)
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_arch, reduced_config
from repro.core import FusionPolicy, TinyJaxBackend
from repro.models.model import build_model
from repro.scheduler import VirtualClock
from repro.serving.engine import ServingEngine

max_len, steps, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
cfg = dataclasses.replace(reduced_config(get_arch("llama3.2-1b")), kv_cache_dtype="float32")
model = build_model(cfg)
params = jax.tree.map(lambda x: x.astype(jnp.float32), model.init(jax.random.PRNGKey(0)))
clock = VirtualClock()
platform = TinyJaxBackend(FusionPolicy(min_observations=2, merge_cost_s=0.0, promote_wait_s=float("inf"),
                                       remerge_backoff_s=0.05, clock=clock))
toks = jnp.asarray(np.load(out + ".prompt.npy"))

def greedy(engine):
    logits, caches, cur = engine.prefill({"tokens": toks})
    got = [np.asarray(logits)]
    for _ in range(steps - 1):
        logits, caches = engine.decode_step(jnp.argmax(logits, -1)[:, None].astype(jnp.int32), cur, caches)
        cur = cur + 1
        got.append(np.asarray(logits))
    return got

try:
    engine = ServingEngine(model, platform, max_len=max_len, params=params)
    names = engine.chain_names()
    greedy(engine)
    platform.merger.wait_idle()
    fused = greedy(engine)
    n = len(names) // 2
    event = platform.merger.split(frozenset(names), [frozenset(names[:n]), frozenset(names[n:])], reason="test")
    split = greedy(engine)
    live_split = len(platform.registry.live_instances())
    clock.advance(0.1)
    greedy(engine)
    platform.merger.wait_idle()
    remerged = greedy(engine)
    live = len(platform.registry.live_instances())
finally:
    platform.shutdown()
with open(out, "wb") as f:
    pickle.dump({"params": jax.tree.map(np.asarray, params), "fused": fused, "split": split, "remerged": remerged,
                 "healthy": event.healthy, "checked": sorted(event.checked_members), "live_split": live_split,
                 "live": live}, f)
"""


@pytest.fixture(scope="module")
def jax_split(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_split") / "out.pkl"
    np.save(f"{out}.prompt.npy", PROMPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", JAX_SPLIT, str(MAX_LEN), str(STEPS), str(out)],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _greedy(engine, toks):
    logits, caches, cur = engine.prefill({"tokens": toks})
    out = [logits]
    for _ in range(STEPS - 1):
        logits, caches = engine.decode_step(torch.argmax(logits, -1)[:, None].to(torch.int32), cur, caches)
        cur = cur + 1
        out.append(logits)
    return out


def _near_jax(got, want):
    assert len(got) == len(want)
    for t, j in zip(got, want):
        assert np.abs(t.numpy() - j).max() <= TOL * np.abs(j).max()


@pytest.mark.parametrize("backend_cls", BACKENDS)
def test_llama_chain_split_and_remerge_match_the_jax_package(backend_cls, jax_split):
    """The reduced llama chain fused, split into two cells with
    ``Merger.split`` (each cell health-checked against the fused unit's
    canaries), then re-merged once the backoff has passed: each phase's
    logits within 2e-5 of max |logit| of the JAX engine's through the same
    three phases, the split and re-merged logits equal to the fused ones in
    bits, and the same members checked."""
    cfg = dataclasses.replace(reduced_config(get_arch("llama3.2-1b")), kv_cache_dtype="float32")
    model = build_model(cfg)
    params = params_from_numpy(jax_split["params"], model.param_defs, dtype=torch.float32, device=CPU)
    clock = VirtualClock()
    platform = backend_cls(FusionPolicy(**FUSING, clock=clock))
    toks = torch.from_numpy(PROMPT)
    try:
        engine = ServingEngine(model, platform, max_len=MAX_LEN, params=params, device=CPU)
        names = engine.chain_names()
        _greedy(engine, toks)
        platform.merger.wait_idle()
        assert len(platform.registry.live_instances()) == 1
        fused = _greedy(engine, toks)
        n = len(names) // 2
        event = platform.merger.split(frozenset(names), [frozenset(names[:n]), frozenset(names[n:])],
                                      reason="test")
        assert event.healthy and sorted(event.checked_members) == jax_split["checked"]
        assert len(platform.registry.live_instances()) == 2 == jax_split["live_split"]
        n_merges = len(platform.merger.merge_log)
        split = _greedy(engine, toks)  # served inside the backoff: nothing re-merges
        platform.merger.wait_idle()
        assert not any(m.healthy for m in platform.merger.merge_log[n_merges:])
        assert len(platform.registry.live_instances()) == 2
        clock.advance(0.1)
        _greedy(engine, toks)
        platform.merger.wait_idle()
        remerged = _greedy(engine, toks)
        assert len(platform.registry.live_instances()) == 1 == jax_split["live"]
        if backend_cls is OrchestratedBackend:
            assert set(platform.pods()) == {i.instance_id for i in platform.registry.live_instances()}
        for phase, got in (("fused", fused), ("split", split), ("remerged", remerged)):
            _near_jax(got, jax_split[phase])
        for a, b, c in zip(fused, split, remerged):
            assert torch.equal(a, b) and torch.equal(a, c)
    finally:
        platform.shutdown()
