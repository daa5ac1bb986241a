"""The port's tracing layer against the reference: the flight recorder, span
trees and critical-path attribution, the deterministic exporters, the
coherent stats snapshot, the dispatch tracer, and the fusion policy's
measured costs and scheduler signals.

Each of ``tests/test_obs.py``'s cases has its counterpart here, run on the
port and, where the two can be set side by side, on the reference with the
same inputs. The conservation contract is the reference's: every finished
request trace's phases (plus parent self-time) sum EXACTLY to its end-to-end
latency, on the serial invoke path, the coalesced async path and under
fault injection.
"""
import gc
import json
import random
import threading
import time
from concurrent.futures import wait

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.obs as ref_obs  # noqa: E402
from repro.analysis.dispatch import TRACER as REF_TRACER  # noqa: E402
from repro.core import FunctionSpec as RefSpec  # noqa: E402
from repro.core import FusionPolicy as RefPolicy  # noqa: E402
from repro.core import TinyJaxBackend  # noqa: E402
from repro.core.handler import EdgeStats as RefEdgeStats  # noqa: E402
from repro.launch.compile_cache import EXECUTABLE_INDEX as REF_INDEX  # noqa: E402
from repro.scheduler import RequestScheduler as RefScheduler  # noqa: E402
from repro.scheduler import VirtualClock as RefClock  # noqa: E402
from repro.scheduler.adaptive import SchedulerSignals as RefSignals  # noqa: E402

import repro_torch.obs as obs  # noqa: E402
from repro_torch.analysis.dispatch import TRACER  # noqa: E402
from repro_torch.core import FunctionSpec, FusionPolicy, TinyTorchBackend  # noqa: E402
from repro_torch.core.handler import EdgeStats  # noqa: E402
from repro_torch.launch.compile_cache import EXECUTABLE_INDEX  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    CONTROL_TRACE_ID,
    FlightRecorder,
    SpanRecord,
    Tracer,
    attribute,
    attribute_trace,
    chrome_trace,
    dumps_chrome,
    prometheus_text,
)
from repro_torch.scheduler.clock import VirtualClock  # noqa: E402
from repro_torch.scheduler.scheduler import RequestScheduler  # noqa: E402
from repro_torch.scheduler.adaptive import SchedulerSignals  # noqa: E402

REAL_BUDGET_S = 10.0


@pytest.fixture(autouse=True)
def _fresh_index():
    """Each case starts with both packages' executable indexes empty (as
    ``tests/test_coldstart.py`` does): a unit an earlier case built would be
    an index hit here, with no shape-only run, no ``fused-inline`` event and
    no new entry to count."""
    EXECUTABLE_INDEX.clear()
    REF_INDEX.clear()
    yield
    EXECUTABLE_INDEX.clear()
    REF_INDEX.clear()
FETCHES = ("item", "tolist", "numpy", "cpu")

# each package's side of a cross-package case
PKGS = {
    "port": {"obs": obs, "Scheduler": RequestScheduler, "Clock": VirtualClock,
             "Backend": TinyTorchBackend, "Spec": FunctionSpec, "Policy": FusionPolicy,
             "EdgeStats": EdgeStats, "Signals": SchedulerSignals,
             "eye": torch.eye, "ones": lambda *s: torch.ones(s), "tanh": torch.tanh,
             # a request argument of the sim: the port keys a lane by a
             # non-tensor leaf's value, the reference by its type
             "scalar": torch.tensor},
    "ref": {"obs": ref_obs, "Scheduler": RefScheduler, "Clock": RefClock,
            "Backend": TinyJaxBackend, "Spec": RefSpec, "Policy": RefPolicy,
            "EdgeStats": RefEdgeStats, "Signals": RefSignals,
            "eye": jnp.eye, "ones": lambda *s: jnp.ones(s), "tanh": jnp.tanh,
            "scalar": int},
}


# ------------------------------------------------------- flight recorder


def _rec(trace_id, span_id, t0=0.0, t1=1.0, parent=1, name="s", cat="execute",
         ph="X", record=SpanRecord):
    return record(trace_id, span_id, parent, name, cat, t0, t1, ph)


def test_trace_and_span_ids_stay_unique_under_threads():
    """Trace ids and a context's span ids come from lock-free counters: many
    threads minting at once (a short switch interval forcing interleaving)
    get every id once, with nothing lost."""
    import sys

    tracer = Tracer()
    ctx = tracer.begin_request("r", "invoke")
    n_threads, per = 16, 500
    traces, spans = [[] for _ in range(n_threads)], [[] for _ in range(n_threads)]

    def mint(i):
        for _ in range(per):
            traces[i].append(tracer.begin_request("r", "invoke_async").trace_id)
            spans[i].append(ctx.alloc_id())

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=mint, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    got_traces = sorted(x for xs in traces for x in xs)
    got_spans = sorted(x for xs in spans for x in xs)
    assert got_traces == list(range(ctx.trace_id + 1, ctx.trace_id + 1 + n_threads * per))
    assert got_spans == list(range(2, 2 + n_threads * per))


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_flight_recorder_drop_oldest_and_counter(pkg):
    o = PKGS[pkg]["obs"]
    rec = o.FlightRecorder(capacity_per_thread=4)
    for i in range(10):
        rec.append(_rec(1, i + 1, t0=float(i), record=o.SpanRecord))
    records = rec.snapshot()
    assert len(records) == 4
    assert [r.span_id for r in records] == [7, 8, 9, 10], "oldest must drop"
    assert rec.dropped() == 6
    rec.clear()
    assert rec.snapshot() == [] and rec.dropped() == 0


def test_flight_recorder_extend_drops_oldest_as_appends_would():
    one, many = FlightRecorder(capacity_per_thread=4), FlightRecorder(capacity_per_thread=4)
    recs = [_rec(1, i + 1, t0=float(i)) for i in range(13)]
    for r in recs:
        one.append(r)
    for lo, hi in ((0, 3), (3, 6), (6, 13)):
        many.extend(recs[lo:hi])
    assert many.snapshot() == one.snapshot() and [r.span_id for r in many.snapshot()] == [10, 11, 12, 13]
    assert many.dropped() == one.dropped() == 9


def test_tile_records_what_emit_and_finish_record():
    """``SpanContext.tile`` (the batched dispatch's close of each member):
    the records of ``emit`` for each phase then ``finish``, bit for bit, in
    one append; a later close records nothing."""
    phases = [("queue-wait", "queue-wait", 1.0, 1.5, None), ("window-wait", "window-wait", 1.5, 1.25, None),
              ("batch-compute", "batch-compute", 1.5, 4.0, {"size": 3, "batch_trace": 9})]
    got = []
    for tiled in (False, True):
        tracer = Tracer()
        ctx = tracer.begin_request("f", "invoke_async", t0=1.0, attrs={"slo": "best-effort"})
        if tiled:
            ctx.tile(phases, 4.0, args={"error": "X"})
        else:
            for name, cat, t0, t1, args in phases:
                ctx.emit(name, cat, t0, t1, args=args)
            ctx.finish(4.0, args={"error": "X"})
        ctx.finish(5.0)
        ctx.tile(phases[:1], 6.0)
        got.append(tracer.recorder.snapshot())
    assert got[1] == got[0] and [r.span_id for r in got[1]] == [1, 2, 5, 3, 4]
    assert got[1][0].args == {"slo": "best-effort", "error": "X"} and got[1][3].t1 == 1.5


def test_flight_recorder_never_mixes_threads_buffers():
    rec = FlightRecorder(capacity_per_thread=8)

    def writer(tid):
        for i in range(8):
            rec.append(_rec(tid, i + 1))

    threads = [threading.Thread(target=writer, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert len(rec.snapshot()) == 32 and rec.dropped() == 0


# ----------------------------------------------------------- attribution


def test_attribution_exact_conservation_unit():
    # root [0, 10]; queue-wait [0, 3]; compute [3, 10] with a nested child
    records = [
        _rec(7, 1, 0.0, 10.0, parent=0, name="req", cat="invoke"),
        _rec(7, 2, 0.0, 3.0, parent=1, cat="queue-wait"),
        _rec(7, 3, 3.0, 10.0, parent=1, cat="batch-compute"),
        _rec(7, 4, 4.0, 6.0, parent=3, cat="cross-function-sync"),
    ]
    out = attribute_trace(records)
    assert out["conserved"] and out["residual_s"] == pytest.approx(0.0, abs=1e-12)
    assert out["wall_s"] == 10.0
    assert out["phases"]["queue-wait"] == pytest.approx(3.0)
    # compute self-time excludes the nested sync wait
    assert out["phases"]["batch-compute"] == pytest.approx(5.0)
    assert out["phases"]["cross-function-sync"] == pytest.approx(2.0)
    assert sum(out["phases"].values()) == pytest.approx(out["wall_s"])


def test_attribution_flags_orphans_and_negative_self_time():
    orphan = [
        _rec(1, 1, 0.0, 4.0, parent=0, cat="invoke"),
        _rec(1, 5, 1.0, 2.0, parent=99, cat="execute"),  # parent never emitted
    ]
    assert not attribute_trace(orphan)["conserved"]
    overlap = [
        _rec(2, 1, 0.0, 4.0, parent=0, cat="invoke"),
        _rec(2, 2, 0.0, 3.0, parent=1, cat="execute"),
        _rec(2, 3, 0.0, 3.0, parent=1, cat="execute"),  # siblings overlap: 6 > 4
    ]
    assert not attribute_trace(overlap)["conserved"]
    # unfinished root: trace not attributable at all
    assert attribute_trace([_rec(3, 4, 0.0, 1.0, parent=1)]) is None


SCRIPTED = [  # (trace, span, parent, name, cat, t0, t1, ph, args)
    (0, 2, 0, "merge:A+B", "control-plane", 0.5, 1.25, "X", {"kind": "merge"}),
    (0, 3, 0, "fused-inline:A->B", "event", 0.75, 0.75, "i", None),
    (1, 1, 0, "A", "invoke", 0.0, 2.0, "X", {"slo": "be"}),
    (1, 2, 1, "execute:A", "execute", 0.125, 1.875, "X", {"instance": "i1", "batch": 1}),
    (1, 3, 2, "A->B", "cross-function-sync", 0.25, 1.5, "X", None),
    (1, 4, 3, "execute:B", "execute", 0.3, 1.4, "X", None),
    (2, 1, 0, "A", "invoke_async", 1.0, 1.9, "X", {"error": "RuntimeError"}),
    (2, 2, 1, "queue-wait", "queue-wait", 1.0, 1.1, "X", None),
    (2, 3, 1, "window-wait", "window-wait", 1.1, 1.3, "X", None),
    (2, 4, 1, "batch-compute", "batch-compute", 1.3, 1.9, "X", {"batch_trace": 3, "size": 2}),
    (3, 1, 0, "batch:A", "batch", 1.3, 1.9, "X", {"members": [2]}),
    (4, 2, 1, "execute:A", "execute", 2.0, 2.5, "X", None),  # root never finished
    (5, 1, 0, "s", "serve", 0.0, 4.0, "X", None),
    (5, 2, 1, "prefill-stall", "prefill-stall", 0.5, 1.5, "X", None),
    (5, 3, 2, "prefill-chunk", "prefill-chunk", 0.5, 1.0, "X", None),
    (5, 4, 1, "page-cow", "event", 2.0, 2.0, "i", {"page": 3}),
]


def test_attribution_summary_and_chrome_bytes_equal_the_reference():
    """The same scripted records give the same attribution, the same
    rollup and the same Chrome bytes from both packages."""
    got = {}
    for pkg in ("port", "ref"):
        o = PKGS[pkg]["obs"]
        records = [o.SpanRecord(*row) for row in SCRIPTED]
        rec = o.FlightRecorder()
        for r in reversed(records):
            rec.append(r)
        ordered = rec.snapshot()
        results = o.attribute(ordered)
        got[pkg] = (results, o.summarize(results), o.dumps_chrome(o.chrome_trace(ordered, pid=3)))
    assert got["port"] == got["ref"]
    results = got["port"][0]
    assert [r["trace_id"] for r in results] == [1, 2, 3, 5]
    assert all(r["conserved"] for r in results)


# ----------------------------------------- serial invoke path (platform)


def _chain(pkg, **policy):
    """A -> B on ``pkg``'s tiny backend."""
    k = PKGS[pkg]
    p = k["Backend"](k["Policy"](**policy))
    w, tanh = k["eye"](8), k["tanh"]
    p.deploy(k["Spec"]("A", lambda ctx, params, x: ctx.call("B", x @ params), w))
    p.deploy(k["Spec"]("B", lambda ctx, params, x: tanh(x @ params), w))
    return p, k["ones"](2, 8)


def _structure(records, trace_id):
    """(span id, parent id, name, cat) of one trace, in span-id order."""
    return sorted((r.span_id, r.parent_id, r.name, r.cat) for r in records if r.trace_id == trace_id)


def test_serial_invoke_trace_conserves_latency():
    p, x = _chain("port", enabled=False)
    try:
        for _ in range(3):
            p.invoke("A", x)
        results = attribute(p.tracer.recorder.snapshot())
        invokes = [r for r in results if r["kind"] == "invoke"]
        assert len(invokes) == 3
        for r in invokes:
            assert r["conserved"], r
            assert r["residual_s"] == pytest.approx(0.0, abs=1e-9)
            assert sum(r["phases"].values()) == pytest.approx(r["wall_s"])
            assert "execute" in r["phases"]
            # unfused chain: the A->B boundary hop must appear as sync wait
            assert "cross-function-sync" in r["phases"]
        assert list(p.stats()["edge_costs"]["edges"]) == ["A->B"]
    finally:
        p.shutdown()


def test_fused_chain_records_inline_not_boundary_edges():
    p, x = _chain("port", min_observations=2, merge_cost_s=0.0)
    try:
        for _ in range(8):
            p.invoke("A", x)
        p.merger.wait_idle()
        merges = [m for m in p.merger.merge_log if m.healthy]
        assert merges
        records = p.tracer.recorder.snapshot()
        # post-merge the edge is compiled away: a fused-inline control event
        # exists, and the LAST invoke's trace has no boundary hop
        control = [r for r in records if r.trace_id == CONTROL_TRACE_ID]
        assert any(r.name.startswith("fused-inline:A->B") for r in control)
        spans = [r for r in control if r.name.startswith("merge:") and r.ph == "X"]
        assert [r.args["seconds"] for r in spans] == [m.build_s for m in merges]
        assert all(r.dur_s == pytest.approx(m.build_s, abs=1e-9) for r, m in zip(spans, merges))
        results = attribute(records)
        invokes = [r for r in results if r["kind"] == "invoke"]
        assert all(r["conserved"] for r in invokes)
        assert "cross-function-sync" not in invokes[-1]["phases"]
        # the merge's canary replays ran outside the client trace that
        # triggered it: every unfused trace holds exactly one hop, one per
        # function executed
        trees = obs.build_trees(records)
        for r in invokes:
            cats = [s.cat for s in trees[r["trace_id"]].values()]
            assert cats.count("execute") == 1 + cats.count("cross-function-sync") <= 2
        assert p.meter.snapshot()["billing"]["provisioning"]["events"] == len(merges)
    finally:
        p.shutdown()


def test_chain_span_structure_matches_the_reference():
    """A -> B unfused, then fused: the same spans (names, cats, parent
    links) in both packages' traces, and the same control-plane names."""
    got = {}
    for pkg in ("port", "ref"):
        p, x = _chain(pkg, min_observations=2, merge_cost_s=0.0, promote_wait_s=float("inf"))
        try:
            for _ in range(4):
                p.invoke("A", x)
            p.merger.wait_idle()
            records = p.tracer.recorder.snapshot()
            tids = sorted({r.trace_id for r in records if r.trace_id != CONTROL_TRACE_ID})
            control = {r.name for r in records if r.trace_id == CONTROL_TRACE_ID}
            got[pkg] = (_structure(records, tids[0]), _structure(records, tids[-1]), control,
                        len(p.registry.live_instances()))
        finally:
            p.shutdown()
    assert got["port"] == got["ref"]
    unfused, fused, control, live = got["port"]
    assert [s[3] for s in unfused] == ["invoke", "execute", "cross-function-sync", "execute"]
    assert [s[1] for s in unfused] == [0, 1, 2, 3]
    assert [s[3] for s in fused] == ["invoke", "execute"] and live == 1
    assert {"fused-inline:A->B", "merge:A+B", "epoch:merge"} <= control


# ------------------------------------- coalesced async path (sim, exact)


def settle(sched, clock, fut):
    """Wait until the request behind ``fut`` is where the next ``advance``
    must find it — its batch finished, or the request taken into an open
    window — and the dispatcher parked on the clock. A condition the test
    can see, not a grace window alone: under a loaded host a dispatcher
    may not run for longer than any grace window."""
    deadline = time.perf_counter() + 5.0
    while True:
        lanes = list(sched._queues.values())
        if fut.done():
            break
        taken = True
        for q in lanes:
            with q._cv:
                taken = taken and not q._items and q._window_open
        if lanes and taken:
            break
        assert time.perf_counter() < deadline, "the dispatcher never took the request"
        clock.wait_for_waiters(1, timeout=5.0)
    clock.wait_for_waiters(1, timeout=5.0)


def _sim_once(pkg="port", fail_batches=(), n=6):
    """Scripted virtual-time sim: n arrivals 4ms apart into a 16ms window,
    dispatch optionally failing for chosen batch ordinals. Returns the
    tracer's records."""
    k = PKGS[pkg]
    clock = k["Clock"]()
    tracer = k["obs"].Tracer(clock=clock)
    seen = {"batches": 0}

    def dispatch(name, argss):
        seen["batches"] += 1
        if seen["batches"] in fail_batches:
            raise RuntimeError("injected dispatch failure")
        return [a[0] for a in argss]

    sched = k["Scheduler"](dispatch, clock=clock, max_batch=4, max_delay_ms=16.0, tracer=tracer)
    try:
        futs = []
        for i in range(n):
            futs.append(sched.submit("f", (k["scalar"](i),)))
            settle(sched, clock, futs[-1])
            clock.advance(0.004)
        clock.advance(0.1)  # drain every window
        done, not_done = wait(futs, timeout=5)
        assert not not_done
        clock.assert_elapsed_real_below(REAL_BUDGET_S)
        return tracer.recorder.snapshot()
    finally:
        sched.shutdown()


def test_batched_trace_phases_tile_wall_exactly():
    records = _sim_once()
    results = attribute(records)
    reqs = [r for r in results if r["kind"] == "invoke_async"]
    assert len(reqs) == 6
    for r in reqs:
        assert r["conserved"], r
        assert r["residual_s"] == 0.0, "phases must tile the wall EXACTLY"
        assert {"queue-wait", "window-wait", "batch-compute"} <= set(r["phases"])
        assert sum(r["phases"].values()) == pytest.approx(r["wall_s"], abs=1e-12)
    # the shared execution is its own trace, referenced by the members
    batches = [r for r in results if r["kind"] == "batch"]
    assert len(batches) == 2, "6 arrivals, max_batch 4: a full batch, then the window's"
    member_refs = {
        r.args["batch_trace"]
        for r in records
        if r.cat == "batch-compute" and r.args and "batch_trace" in r.args
    }
    assert member_refs == {b["trace_id"] for b in batches}


def test_conservation_holds_under_fault_injection():
    rng = random.Random(0xBAD5EED)
    for trial in range(4):
        fail = {rng.randint(1, 2)}  # 8 arrivals / max_batch 4 -> 2 batches
        records = _sim_once(fail_batches=fail, n=8)
        results = attribute(records)
        reqs = [r for r in results if r["kind"] == "invoke_async"]
        assert len(reqs) == 8, "failed requests must still close their traces"
        assert sum(1 for r in reqs if r["attrs"] and r["attrs"].get("error")) == 4
        for r in reqs:
            assert r["conserved"], (trial, r)
            assert r["residual_s"] == 0.0


def test_same_seed_sim_exports_byte_identical_traces():
    runs = [dumps_chrome(chrome_trace(_sim_once())) for _ in range(3)]
    assert runs[0] == runs[1] == runs[2], "same-seed virtual-clock runs must export identical bytes"
    doc = json.loads(runs[0])
    events = doc["traceEvents"]
    assert events and doc["displayTimeUnit"] == "ms"
    for ev in events:
        # perfetto-loadable trace_event schema: complete spans carry dur,
        # instants a scope, metadata only names
        assert ev["ph"] in ("X", "i", "M")
        if ev["ph"] == "X":
            assert ev["dur"] >= 0 and isinstance(ev["ts"], float | int)


@pytest.mark.parametrize("fail", [(), (2,)])
def test_sim_chrome_bytes_equal_the_reference(fail):
    """The reference's sim scenario on each package's scheduler and virtual
    clock exports the same bytes."""
    port = dumps_chrome(chrome_trace(_sim_once("port", fail_batches=fail, n=8)))
    ref = ref_obs.dumps_chrome(ref_obs.chrome_trace(_sim_once("ref", fail_batches=fail, n=8)))
    assert port == ref


# ------------------------------------------------------ coherent stats


def test_stats_snapshot_totals_conserved_under_concurrent_invokes():
    """One meter snapshot keeps its per-function and per-instance views
    equal while invokes land concurrently."""
    p = TinyTorchBackend(FusionPolicy(enabled=False))
    try:
        w = torch.eye(4)
        p.deploy(FunctionSpec("F", lambda ctx, params, x: x @ params, w))
        stop = threading.Event()
        mismatches = []

        def sampler():
            while not stop.is_set():
                snap = p.meter.snapshot()
                by_fn = snap["billing"]["by_function"]
                fn_calls = sum(d["calls"] for d in by_fn.values())
                inst_calls = sum(d["calls"] for d in snap["by_instance"].values())
                if fn_calls != inst_calls:
                    mismatches.append((fn_calls, inst_calls))
                gb_fn = sum(d["gb_s"] for d in by_fn.values())
                if abs(gb_fn - snap["billing"]["total_gb_s"]) > 1e-12:
                    mismatches.append(("gb", gb_fn, snap["billing"]["total_gb_s"]))

        def invoker():
            x = torch.ones(1, 4)
            for _ in range(40):
                p.invoke("F", x)

        sam = threading.Thread(target=sampler)
        sam.start()
        workers = [threading.Thread(target=invoker) for _ in range(4)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=60)
        stop.set()
        sam.join(timeout=5)
        assert not sam.is_alive() and not any(t.is_alive() for t in workers)
        assert not mismatches, mismatches[:5]
        snap = p.meter.snapshot()
        assert sum(d["calls"] for d in snap["billing"]["by_function"].values()) == 160
        assert sum(d["calls"] for d in snap["by_instance"].values()) == 160
    finally:
        p.shutdown()


# ------------------------------------------------- exporters / prometheus


def _metric_names(text):
    return {line.split("{")[0].split(" ")[0] for line in text.splitlines()}


def test_prometheus_dump_flattens_stats_and_trace_aggregates():
    names = {}
    for pkg in ("port", "ref"):
        k = PKGS[pkg]
        p = k["Backend"](k["Policy"](enabled=False))
        try:
            p.deploy(k["Spec"]("F", lambda ctx, params, x: x @ params, k["eye"](4)))
            for _ in range(3):
                p.invoke("F", k["ones"](1, 4))
            text = k["obs"].prometheus_text(p)
            names[pkg] = _metric_names(text)
            # every line is valid exposition: metric[{labels}] value
            for line in text.splitlines():
                head, _, value = line.rpartition(" ")
                assert head and float(value) is not None
        finally:
            p.shutdown()
    for name in ("repro_trace_spans_total", "repro_trace_dropped_total", "repro_trace_phase_seconds",
                 "repro_dispatch_compiles_total", "repro_dispatch_host_syncs_total",
                 "repro_merge_stall_samples_total"):
        assert name in names["port"]
    assert any(n.startswith("repro_stats_billing") for n in names["port"])
    # the same metric names as the reference, beyond the stats each
    # platform has of its own
    traced = {n for n in names["ref"] if not n.startswith("repro_stats_")}
    assert traced <= names["port"]


def test_prometheus_endpoint_serves_metrics():
    import urllib.request

    p = TinyTorchBackend(FusionPolicy(enabled=False))
    server = None
    try:
        p.deploy(FunctionSpec("F", lambda ctx, params, x: x @ params, torch.eye(4)))
        p.invoke("F", torch.ones(1, 4))
        server = obs.serve_prometheus(p, port=0)
        port = server.server_address[1]
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
        assert "repro_trace_spans_total" in body
    finally:
        if server is not None:
            server.shutdown()
        p.shutdown()


# ------------------------------------------------- dispatch tracer re-arm


def test_dispatch_tracer_rearm_is_refcounted_and_restores_patches():
    orig = {n: getattr(torch.Tensor, n) for n in FETCHES}
    base, ref_base = TRACER.snapshot(), REF_TRACER.snapshot()
    for tracer, x in ((TRACER, torch.ones(2, 2)), (REF_TRACER, jnp.ones((2, 2)))):
        tracer.arm()
        tracer.arm()  # nested window (overhead gate inside smoke gate)
        np.asarray(x)
        tracer.disarm()
        assert tracer.armed, "inner disarm must not tear down the outer window"
        np.asarray(x)
        tracer.disarm()
        np.asarray(x)  # fully disarmed: not counted
        tracer.disarm()  # stray disarm: no underflow, no double-unpatch
        assert not tracer.armed
    assert TRACER.delta(base).host_syncs == REF_TRACER.delta(ref_base).host_syncs == 2
    assert all(getattr(torch.Tensor, n) is orig[n] for n in FETCHES), "patches must restore the ORIGINAL"
    assert not any(n in torch.Tensor.__dict__ for n in FETCHES)


def test_dispatch_tracer_counts_each_fetch_once():
    x = torch.arange(4.0)
    base = TRACER.snapshot()
    TRACER.arm()
    try:
        x[0].item()
        x.tolist()
        x.cpu().numpy()  # .cpu() of a host tensor moves nothing: the .numpy() counts
        np.asarray(x)  # through Tensor.__array__ -> .numpy(): once
        torch.empty(2, device="meta").cpu  # a meta tensor fetches nothing
        x.cpu()
    finally:
        TRACER.disarm()
    assert TRACER.delta(base).host_syncs == 4


def test_dispatch_tracer_concurrent_arm_disarm_never_leaks_patch():
    orig = {n: getattr(torch.Tensor, n) for n in FETCHES}
    x = torch.ones(2, 2)
    errors = []
    base = TRACER.snapshot()

    def churn():
        try:
            for _ in range(50):
                TRACER.arm()
                x.tolist()
                TRACER.disarm()
        except Exception as exc:  # pragma: no cover - the assert is the test
            errors.append(exc)

    threads = [threading.Thread(target=churn) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert not TRACER.armed
    assert all(getattr(torch.Tensor, n) is orig[n] for n in FETCHES), "unbalanced unpatch leaked a wrapper"
    assert TRACER.delta(base).host_syncs <= 300


def test_fused_unit_third_run_adds_no_program():
    """The first run of a fused unit makes its program; with the unit warm,
    a third run makes none, in the port as in the reference."""
    got = {}
    for pkg, tracer in (("port", TRACER), ("ref", REF_TRACER)):
        p, x = _chain(pkg, min_observations=2, merge_cost_s=0.0, promote_wait_s=float("inf"))
        try:
            for _ in range(3):
                p.invoke("A", x)
            p.merger.wait_idle()
            assert len(p.registry.live_instances()) == 1
            p.invoke("A", x * 2)
            p.invoke("A", x * 3)
            base = tracer.snapshot()
            tracer.arm()
            try:
                p.invoke("A", x * 4)
            finally:
                tracer.disarm()
            got[pkg] = tracer.delta(base).compiles
        finally:
            p.shutdown()
    assert got == {"port": 0, "ref": 0}
    EXECUTABLE_INDEX.clear()  # B ran above: its record would be an index hit
    p, x = _chain("port", enabled=False)
    try:
        base = TRACER.snapshot()
        TRACER.arm()
        try:
            p.invoke("B", x)  # a leaf's first run: one compiled entry
        finally:
            TRACER.disarm()
        d = TRACER.delta(base)
        assert (d.compiles, d.entries, d.captures, d.buckets) == (1, 1, 0, 0)
    finally:
        p.shutdown()


def _batcher_counts(pkg):
    """decode_steps and host_syncs of the same ContinuousBatcher traffic on
    ``pkg``'s reduced llama (random weights of its own: the counts do not
    depend on the values)."""
    if pkg == "port":
        from repro_torch.configs import get_arch, reduced_config
        from repro_torch.models.model import build_model
        from repro_torch.serving.continuous import ContinuousBatcher
        from repro_torch.serving.engine import ServingEngine

        tracer, kw = TRACER, {"device": torch.device("cpu")}
    else:
        from repro.configs import get_arch, reduced_config
        from repro.models.model import build_model
        from repro.serving.continuous import ContinuousBatcher
        from repro.serving.engine import ServingEngine

        tracer, kw = REF_TRACER, {}
    k = PKGS[pkg]
    platform = k["Backend"](k["Policy"](enabled=False))
    prompts = [np.arange(1, 9, dtype=np.int32).reshape(1, -1) * (i + 1) % 97 for i in range(3)]
    try:
        engine = ServingEngine(build_model(reduced_config(get_arch("llama3.2-1b"))), platform,
                               max_len=64, kv_pages=32, kv_page_size=16, **kw)
        cb = ContinuousBatcher(engine, capacity=2)
        try:
            cb.submit({"tokens": np.full((1, 5), 7, np.int32)}, 3).result(timeout=300)  # warm-up
            base = tracer.snapshot()
            tracer.arm()
            try:
                futs = [cb.submit({"tokens": q}, n) for q, n in zip(prompts, (5, 4, 6))]
                for f in futs:
                    f.result(timeout=300)
            finally:
                tracer.disarm()
            d = tracer.delta(base)
            return d.decode_steps, d.host_syncs
        finally:
            cb.shutdown()
    finally:
        platform.shutdown()


def test_batcher_decode_steps_and_host_syncs_equal_the_reference():
    port, ref = _batcher_counts("port"), _batcher_counts("ref")
    assert port == ref
    steps, syncs = port
    # one batched token fetch per decode step, one first-token fetch per
    # seated request
    assert steps > 0 and syncs == steps + 3


# --------------------------------------------------------- registry pins


def test_retain_tracers_survives_platform_drop():
    obs.retain_tracers(True)
    try:
        p = TinyTorchBackend(FusionPolicy(enabled=False))
        p.deploy(FunctionSpec("F", lambda ctx, params, x: x @ params, torch.eye(4)))
        p.invoke("F", torch.ones(1, 4))
        tracer = p.tracer
        p.shutdown()
        del p
        gc.collect()
        assert tracer in obs.live_tracers(), "retention must pin dropped platforms"
    finally:
        obs.retain_tracers(False)
    gc.collect()


# ---------------------------------------- the policy's measured costs (Step 0)


def _decide(pkg, case):
    """One decision of ``pkg``'s policy on the case's edge statistics,
    scheduler signals and cost-model observations."""
    k = PKGS[pkg]
    policy = k["Policy"](**case.get("policy", {}))
    costs = k["obs"].EdgeCostModel()
    for wait_s in case.get("edge_waits", ()):
        costs.observe_sync_edge("a", "b", wait_s)
    for build_s, depth in case.get("stalls", ()):
        costs.observe_merge_stall(build_s, depth)
    policy.cost_model = costs
    st = k["EdgeStats"]()
    for wait_s in case["waits"]:
        st.sync_count += 1
        st.total_wait_s += wait_s
        st.recent_waits.append(wait_s)
    sig = case.get("signals")
    signals = None if sig is None else (lambda: k["Signals"](**sig))
    d = policy.decide("a", "b", st, "t", "t", signals=signals)
    return d.fuse, d.reason


POLICY_CASES = {
    "promoted at the first observation": {
        "policy": {"min_observations": 2}, "waits": [0.08], "edge_waits": [0.08],
        "signals": {}, "want": (True, "promoted: cold chain")},
    "saturated, measured stall": {
        "waits": [0.01] * 4, "edge_waits": [0.01] * 4, "stalls": [(1.5, 3)],
        "signals": {"queue_depth": 3, "mean_occupancy": 0.9, "p95_ms": 40.0},
        "want": (False, "saturated: measured stall ~1.500s x depth 3")},
    "saturated, measured stall, amortizable": {
        "waits": [0.02] * 4, "edge_waits": [0.02] * 4, "stalls": [(1.5, 3)],
        "signals": {"queue_depth": 3, "mean_occupancy": 0.9, "p95_ms": 40.0},
        "want": (True, "saturated: measured stall")},
    "not amortizable under the measured EWMA": {
        "waits": [0.01] * 4, "edge_waits": [0.001] * 4, "signals": {"p95_ms": 40.0},
        "want": (False, "not amortizable: saving 0.500s")},
    "SLO-fixable violation": {
        "policy": {"merge_cost_s": 8.0}, "waits": [0.03, 0.03], "edge_waits": [0.03, 0.03],
        "signals": {"p95_ms": 120.0, "class_p95_ms": (("gold", 120.0, 100.0),)},
        "want": (True, "promoted: class 'gold'")},
    "no signals": {
        "waits": [0.001] * 3, "edge_waits": [0.01] * 3, "want": (True, "sync edge hot")},
}


@pytest.mark.parametrize("case", list(POLICY_CASES))
def test_policy_decision_equals_the_reference(case):
    c = POLICY_CASES[case]
    got = _decide("port", c)
    assert got == _decide("ref", c)
    fuse, note = c["want"]
    assert got[0] == fuse and note in got[1], got


def test_merger_passes_lazy_scheduler_signals():
    p, x = _chain("port", min_observations=2, merge_cost_s=0.0)
    seen = []
    decide = p.policy.decide

    def spy(caller, callee, stats, trust_a, trust_b, signals=None, **replicate_arm):
        seen.append((caller, callee, signals))
        return decide(caller, callee, stats, trust_a, trust_b, signals=signals, **replicate_arm)

    p.policy.decide = spy
    try:
        p.invoke("A", x)
        p.invoke("A", x)
        p.merger.wait_idle()
        assert seen and all(callable(s) for _, _, s in seen)
        caller, callee, signals = seen[0]
        assert (caller, callee) == ("A", "B")
        assert signals() == p.scheduler_signals(("A", "B"))
        assert p.policy.cost_model is p.edge_costs
    finally:
        p.shutdown()


# qwen3-moe-30b-a3b's serve phase under the reference's default promotion,
# as tools/probes/fusion_decisions.py logged it on an NVIDIA H100 80GB HBM3:
# the g5 -> head decision after the other edges merged. Each of those edges'
# first sync wait held its callee's cold first run on the card (0.16-10.1 s)
# and crossed promote_wait_s, so each merged at its first observation; their
# measured build stalls (EWMA 2.663 s) and the fed-back merge cost (3.385 s)
# outgrew what head's waits save over the amortization horizon (EWMA 0.68
# ms, 55 observations of mean 1.45 ms): the chain stopped at 2 instances.
QWEN3_G5_HEAD = {
    "policy": {"min_observations": 2, "merge_cost_s": 3.385332642750007},
    "waits": [0.0014459758000012616] * 55, "edge_waits": [0.0006829324186394285],
    "stalls": [(2.663079032857592, 0)], "signals": {},
    "want": (False, "not amortizable: saving 0.341s < cost 3.385s"),
}


def test_qwen3_chain_stops_where_the_reference_rule_stops_it():
    got = _decide("port", QWEN3_G5_HEAD)
    assert got == _decide("ref", QWEN3_G5_HEAD)
    assert got[0] is False and QWEN3_G5_HEAD["want"][1] in got[1]


def test_serve_traces_conserve_through_chunks_cow_and_shed():
    """The continuous batcher's ``serve`` traces (its hooks live now that
    the port's platform traces): a request shed at admission closes its
    trace with the error, a chunked prefill nests its chunks under the
    prefill stall, a repeated prompt copies its shared tail page on write;
    every trace conserves."""
    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.models.model import build_model
    from repro_torch.serving.continuous import ContinuousBatcher, ShedError
    from repro_torch.serving.engine import ServingEngine

    platform = TinyTorchBackend(FusionPolicy(enabled=False))
    p = np.arange(3, 13, dtype=np.int32).reshape(1, -1)
    try:
        engine = ServingEngine(build_model(reduced_config(get_arch("llama3.2-1b"))), platform, max_len=64,
                               device=torch.device("cpu"), kv_pages=32, kv_page_size=16)
        cb = ContinuousBatcher(engine, capacity=2, max_queue=1, prefill_chunk=4)
        try:
            with cb._cv:  # both queue before the loop can admit either
                first = cb.submit({"tokens": p}, 5)
                shed = cb.submit({"tokens": p + 1}, 5)
            with pytest.raises(ShedError):
                shed.result(timeout=10)
            first.result(timeout=300)
        finally:
            cb.shutdown()
        cb = ContinuousBatcher(engine, capacity=2, prefill_chunk=4)
        try:
            with cb._cv:
                # the second prefill waits for the first's (one chunked
                # prefill at a time), then hits its pages whole, sharing the
                # partial tail page that the first's next token writes
                futs = [cb.submit({"tokens": p}, 5) for _ in range(2)]
            for f in futs:
                f.result(timeout=300)
        finally:
            cb.shutdown()
    finally:
        platform.shutdown()
    records = platform.tracer.recorder.snapshot()
    serve = [r for r in attribute(records) if r["kind"] == "serve"]
    assert len(serve) == 4 and all(r["conserved"] and r["residual_s"] == 0.0 for r in serve)
    assert [r["attrs"].get("error") for r in serve] == [None, "ShedError", None, None]
    cats = {r.cat for r in records}
    assert {"queue-wait", "prefill-stall", "prefill-chunk", "batch-compute"} <= cats
    chunks = [r for r in records if r.cat == "prefill-chunk"]
    stalls = {(r.trace_id, r.span_id) for r in records if r.cat == "prefill-stall"}
    assert len(chunks) >= 3 and all((r.trace_id, r.parent_id) in stalls for r in chunks)
    assert any(r.name == "page-cow" for r in records)
