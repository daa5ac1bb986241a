"""The port's request scheduler: the cases of ``tests/test_scheduler.py``
on torch trees — coalescing mechanics (no platform), then batched dispatch
through ``TinyTorchBackend.invoke_async`` — and a leaf's batched outputs
against the JAX platform's ``invoke_async`` on the same inputs."""
import threading
import time
from concurrent.futures import Future, wait

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import FunctionSpec, FusionPolicy, OrchestratedBackend, TinyTorchBackend  # noqa: E402
from repro_torch.scheduler.batching import next_batch_bucket, split_results, stack_requests  # noqa: E402
from repro_torch.scheduler.clock import VirtualClock  # noqa: E402
from repro_torch.scheduler.coalescer import AdmissionQueue, PendingRequest  # noqa: E402
from repro_torch.scheduler.metrics import percentiles_ms  # noqa: E402
from repro_torch.scheduler.scheduler import RequestScheduler  # noqa: E402

FP32 = dict(rtol=2e-5, atol=2e-5)  # tests/test_kernels.py's fp32 tolerance
BACKENDS = [TinyTorchBackend, OrchestratedBackend]  # the reference's test_scheduler runs both


# --------------------------------------------------------------- pure units


def test_percentiles_ms_nearest_rank():
    samples = [i / 1e3 for i in range(1, 101)]
    p = percentiles_ms(samples)
    assert (p["p50_ms"], p["p95_ms"], p["p99_ms"]) == pytest.approx((50.0, 95.0, 99.0))
    assert percentiles_ms([i / 1e3 for i in (1, 2, 3, 4, 5)])["p50_ms"] == pytest.approx(3.0)


def test_next_batch_bucket_pow2_capped_and_never_odd():
    assert [next_batch_bucket(k, 8) for k in (1, 2, 3, 5, 8, 9, 30)] == [1, 2, 4, 8, 8, 8, 8]
    assert [next_batch_bucket(k, 6) for k in (1, 2, 3, 4, 5, 6, 9)] == [1, 2, 4, 4, 4, 4, 4]
    for cap in range(1, 17):
        for k in range(1, 20):
            b = next_batch_bucket(k, cap)
            assert b & (b - 1) == 0 and b <= cap


def test_stack_then_split_roundtrips_requests():
    reqs = [({"x": torch.full((2, 3), float(i))}, torch.tensor(i, dtype=torch.int32)) for i in range(3)]
    stacked = stack_requests(reqs)
    assert stacked[0]["x"].shape == (3, 2, 3)
    for i, (tree, scalar) in enumerate(split_results(stacked, 3)):
        assert torch.equal(tree["x"], torch.full((2, 3), float(i))) and int(scalar) == i


# ------------------------------------------------------- coalescer (no model)
#
# Requests carry 0-d tensors where the reference's carry Python ints: in the
# port a non-tensor leaf is a constant of the program (``request_key`` keys
# it by value, as ``get_compiled`` does), so ints of different values never
# share a queue.


def t(i):
    return torch.tensor(i)


def make_scheduler(dispatch, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_delay_ms", 50.0)
    return RequestScheduler(dispatch, **kw)


def test_coalescer_groups_requests_within_window():
    batches = []

    def dispatch(name, args_list):
        batches.append(len(args_list))
        time.sleep(0.02)  # hold the dispatcher so later submits coalesce
        return [a[0] * 10 for a in args_list]

    sched = make_scheduler(dispatch)
    try:
        futs = [sched.submit("f", (t(i),)) for i in range(10)]
        _, not_done = wait(futs, timeout=10)
        assert not not_done
        assert [int(f.result()) for f in futs] == [i * 10 for i in range(10)]
        assert sum(batches) == 10 and max(batches) > 1 and all(b <= 4 for b in batches)
        st = sched.stats()
        assert st["requests"] == 10 and st["throughput_rps"] > 0
    finally:
        sched.shutdown()


def test_incompatible_shapes_use_separate_queues():
    seen = []

    def dispatch(name, args_list):
        seen.append({tuple(a[0].shape) for a in args_list})
        return [a[0] for a in args_list]

    sched = make_scheduler(dispatch)
    try:
        futs = [sched.submit("f", (torch.zeros(s),)) for s in (2, 3, 2, 3, 2)]
        wait(futs, timeout=10)
        assert sched.stats()["queues"] == 2
        assert all(len(shapes) == 1 for shapes in seen), "a batch must never mix request shapes"
    finally:
        sched.shutdown()


def test_dispatch_exception_reaches_every_future():
    def dispatch(name, args_list):
        raise ValueError("boom")

    sched = make_scheduler(dispatch)
    try:
        futs = [sched.submit("f", (t(i),)) for i in range(3)]
        wait(futs, timeout=10)
        for f in futs:
            with pytest.raises(ValueError, match="boom"):
                f.result()
    finally:
        sched.shutdown()


def test_raising_metrics_sinks_cannot_hang_futures():
    def bad_sink(name, lat_s, k):
        raise RuntimeError("billing meter exploded")

    def dispatch(name, args_list):
        time.sleep(0.02)
        return [a[0] * 10 for a in args_list]

    sched = make_scheduler(dispatch, on_request_done=bad_sink)
    try:
        futs = [sched.submit("f", (t(i),)) for i in range(6)]
        _, not_done = wait(futs, timeout=5)
        assert not not_done and [int(f.result()) for f in futs] == [i * 10 for i in range(6)]
        assert int(sched.submit("f", (t(7),)).result(timeout=5)) == 70
    finally:
        sched.shutdown()

    def boom(name, batch, t_done):
        raise ValueError("metrics sink down")

    q = AdmissionQueue("f", lambda name, args_list: [a[0] for a in args_list],
                       max_batch=4, max_delay_s=0.02, on_batch_done=boom)
    try:
        reqs = [PendingRequest((i,), Future(), time.perf_counter()) for i in range(3)]
        for r in reqs:
            q.put(r)
        _, not_done = wait([r.future for r in reqs], timeout=5)
        assert not not_done and [r.future.result() for r in reqs] == [0, 1, 2]
        assert q.thread.is_alive()
    finally:
        q.stop()
        q.thread.join(timeout=5)


def test_result_count_mismatch_is_an_error():
    sched = make_scheduler(lambda name, args_list: [0])
    try:
        futs = [sched.submit("f", (t(1),)), sched.submit("f", (t(2),))]
        wait(futs, timeout=10)
        assert [f for f in futs if f.exception() is not None]
    finally:
        sched.shutdown()


def test_shutdown_stops_dispatchers_and_rejects_submits():
    sched = make_scheduler(lambda name, args_list: [a[0] for a in args_list])
    assert sched.submit("f", (1,)).result(timeout=10) == 1
    sched.shutdown()
    assert all(not q.thread.is_alive() for q in sched._queues.values())
    with pytest.raises(RuntimeError):
        sched.submit("f", (2,))


def test_idle_dispatcher_retires_then_fresh_queue_serves():
    """Virtual clock: the 60 s idle timeout elapses in simulated time."""
    clock = VirtualClock()
    sched = make_scheduler(lambda name, args_list: [a[0] for a in args_list],
                           idle_timeout_s=60.0, max_delay_ms=0.0, clock=clock)
    try:
        assert sched.submit("f", (1,)).result(timeout=10) == 1
        q = next(iter(sched._queues.values()))
        clock.wait_for_waiters(1)
        clock.advance(61.0)
        q.thread.join(timeout=10)
        assert not q.thread.is_alive() and sched.stats()["queues"] == 0
        assert sched.submit("f", (2,)).result(timeout=10) == 2
        clock.assert_elapsed_real_below(10.0)
    finally:
        sched.shutdown()


# ----------------------------------------------------- platform integration


def leaf_inputs(seed, n, shape, d=16):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((d, d)) * 0.1).astype(np.float32)
    xs = [rng.standard_normal(shape + (d,)).astype(np.float32) for _ in range(n)]
    return w, xs


@pytest.mark.parametrize("backend_cls", BACKENDS)
def test_batched_matches_serial_on_leaf_and_the_jax_platform(backend_cls):
    """11 requests (an odd count pads a bucket) through invoke_async equal
    the same requests through invoke on the port, and the JAX platform's
    invoke_async on the same numpy inputs (fp32, 2e-5)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import FunctionSpec as JaxSpec
    from repro.core import FusionPolicy as JaxPolicy
    from repro.core import TinyJaxBackend

    w, xs = leaf_inputs(0, 11, (3,))
    p = backend_cls(FusionPolicy(enabled=False), max_batch=4, max_delay_ms=10.0)
    try:
        p.deploy(FunctionSpec("leaf", lambda ctx, params, x: torch.tanh(x @ params), torch.from_numpy(w)))
        ref = [p.invoke("leaf", torch.from_numpy(x)) for x in xs]
        futs = [p.invoke_async("leaf", torch.from_numpy(x)) for x in xs]
        _, not_done = wait(futs, timeout=60)
        assert not not_done
        for f, r in zip(futs, ref):
            np.testing.assert_allclose(f.result().numpy(), r.numpy(), **FP32)
        assert p.scheduler.stats()["max_batch_seen"] > 1
        got = [f.result().numpy() for f in futs]
    finally:
        p.shutdown()
    jp = TinyJaxBackend(JaxPolicy(enabled=False), max_batch=4, max_delay_ms=10.0)
    try:
        jp.deploy(JaxSpec("leaf", lambda ctx, params, x: jnp.tanh(x @ params), jnp.asarray(w)))
        jfuts = [jp.invoke_async("leaf", jnp.asarray(x)) for x in xs]
        wait(jfuts, timeout=60)
        for a, f in zip(got, jfuts):
            np.testing.assert_allclose(a, np.asarray(f.result()), **FP32)
    finally:
        jp.shutdown()
    del jax


def test_non_pow2_max_batch_clamps_and_chunks_pow2():
    p = TinyTorchBackend(FusionPolicy(enabled=False), max_batch=6, max_delay_ms=60.0)
    try:
        assert p.scheduler.max_batch == 4
        w, xs = leaf_inputs(2, 6, (2,), d=8)
        p.deploy(FunctionSpec("leaf", lambda ctx, params, x: torch.tanh(x @ params), torch.from_numpy(w)))
        xs = [torch.from_numpy(x) for x in xs]
        ref = [p.invoke("leaf", x) for x in xs]
        futs = [p.invoke_async("leaf", x) for x in xs]
        wait(futs, timeout=60)
        for f, r in zip(futs, ref):
            np.testing.assert_allclose(f.result().numpy(), r.numpy(), **FP32)
        inst = p.registry.resolve("leaf")
        out = inst.execute_batch("leaf", [(x,) for x in xs], max_bucket=6)  # runs as 4 + 2
        for got, r in zip(out, ref):
            np.testing.assert_allclose(got.numpy(), r.numpy(), **FP32)
        buckets = [g["bucket"] for g in inst.graph_stats() if g["bucket"] is not None]
        assert buckets and all(b & (b - 1) == 0 for b in buckets)
    finally:
        p.shutdown()


def test_batched_billing_one_record_per_request_and_split_gbs():
    p = TinyTorchBackend(FusionPolicy(enabled=False), max_batch=8, max_delay_ms=10.0)
    try:
        p.deploy(FunctionSpec("leaf", lambda ctx, params, x: x @ params, torch.eye(8)))
        p.invoke("leaf", torch.ones(2, 8))
        p.meter.reset()
        futs = [p.invoke_async("leaf", torch.ones(2, 8) * i) for i in range(8)]
        wait(futs, timeout=60)
        recs = [r for r in p.meter.records if r.function == "leaf"]
        assert len(recs) == 8, "one billing record per client request"
        batched = [r for r in recs if r.batch_size > 1]
        assert batched
        by_batch = {}
        for r in batched:
            by_batch.setdefault((r.t_start, r.t_end), []).append(r)
        for (t0, t1), group in by_batch.items():
            assert len(group) == group[0].batch_size
            total = sum(r.gb_seconds for r in group)
            assert total == pytest.approx((t1 - t0) * group[0].resident_bytes / 1e9, rel=1e-6)
    finally:
        p.shutdown()


@pytest.mark.parametrize("backend_cls", BACKENDS)
def test_invoke_async_works_on_boundary_entries(backend_cls):
    """A chain entry before fusion cannot be one program: its batches run per
    request, counted in the platform's batching stats, and never fail."""
    p = backend_cls(FusionPolicy(enabled=False), max_batch=4, max_delay_ms=10.0)
    try:
        w = torch.eye(8) * 0.5
        p.deploy(FunctionSpec("A", lambda ctx, params, x: ctx.call("B", x @ params), w))
        p.deploy(FunctionSpec("B", lambda ctx, params, x: torch.tanh(x @ params), w))
        xs = [torch.full((2, 8), float(i)) for i in range(6)]
        ref = [p.invoke("A", x) for x in xs]
        futs = [p.invoke_async("A", x) for x in xs]
        wait(futs, timeout=60)
        for f, r in zip(futs, ref):
            assert torch.equal(f.result(), r)
        if p.scheduler.stats()["max_batch_seen"] > 1:
            stats = p.batching_stats()[p.registry.resolve("A").instance_id]
            assert stats["fallback_requests"]["A"] >= 2
            assert "crosses an instance boundary" in stats["unsupported"].popitem()[1]
    finally:
        p.shutdown()


def test_async_effects_never_replayed_by_batch_padding():
    """Bucket padding duplicates the last request's args; a ctx.call_async in
    the entry would fire once per padded lane. Such entries run per request."""
    p = TinyTorchBackend(FusionPolicy(enabled=False), max_batch=8, max_delay_ms=20.0)
    try:
        p.deploy(FunctionSpec("D", lambda ctx, params, x: (x * x).sum(), None))

        def fn_a(ctx, params, x):
            ctx.call_async("D", x)
            return x + 1

        p.deploy(FunctionSpec("A", fn_a, None))
        futs = [p.invoke_async("A", torch.full((2,), float(i))) for i in range(3)]
        wait(futs, timeout=60)
        for i, f in enumerate(futs):
            assert torch.equal(f.result(), torch.full((2,), i + 1.0))
        deadline = time.perf_counter() + 5.0
        while time.perf_counter() < deadline:
            if sum(1 for r in p.meter.records if r.function == "D") >= 3:
                break
            time.sleep(0.005)
        time.sleep(0.05)  # a short grace: a 4th (replayed) call must NOT appear
        assert sum(1 for r in p.meter.records if r.function == "D") == 3
    finally:
        p.shutdown()


def test_stats_report_latency_percentiles_and_throughput():
    p = TinyTorchBackend(FusionPolicy(enabled=False))
    try:
        p.deploy(FunctionSpec("f", lambda ctx, params, x: x + 1, None))
        for i in range(5):
            p.invoke("f", torch.tensor(float(i)))
        wait([p.invoke_async("f", torch.tensor(9.0))], timeout=30)
        st = p.stats()
        for key in ("p50_ms", "p95_ms", "p99_ms"):
            assert key in st["latency"] and key in st["scheduler"]
        assert st["latency"]["requests"] == 6 and st["scheduler"]["requests"] == 1
    finally:
        p.shutdown()


def test_shutdown_is_idempotent_and_stops_scheduler():
    p = TinyTorchBackend(FusionPolicy(enabled=False))
    p.deploy(FunctionSpec("f", lambda ctx, params, x: x, None))
    wait([p.invoke_async("f", torch.tensor(1.0))], timeout=30)
    p.shutdown()
    p.shutdown()
    with pytest.raises(RuntimeError):
        p.invoke_async("f", torch.tensor(2.0))


def test_batched_execution_coalesces_under_contention():
    p = TinyTorchBackend(FusionPolicy(enabled=False), max_batch=4, max_delay_ms=25.0)
    try:
        w, _ = leaf_inputs(1, 0, (2,), d=12)
        p.deploy(FunctionSpec("leaf", lambda ctx, params, x: torch.tanh(x @ params), torch.from_numpy(w)))
        wait([p.invoke_async("leaf", torch.ones(2, 12))], timeout=60)
        stop = time.perf_counter() + 0.6

        def client():
            while time.perf_counter() < stop:
                p.invoke_async("leaf", torch.ones(2, 12)).result(timeout=30)

        threads = [threading.Thread(target=client) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert p.scheduler.stats()["mean_batch"] > 1.2
    finally:
        p.shutdown()
