"""The port's concurrency stress (``tests/test_concurrency.py``) on both port
backends: client threads hammer ``invoke`` / ``invoke_async`` WHILE the
Merger builds, health-checks and swaps the routing table underneath them.
No response may be lost, billing stays exact (one record per request, the
control plane's canary replays accounted), and every result matches the
JAX package's serial chain on the same inputs and weights."""
import threading
from concurrent.futures import wait

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # the suite runs several workers at once: leave them cores

import jax.numpy as jnp  # noqa: E402

from repro_torch.core import FunctionSpec, FusionPolicy, OrchestratedBackend, TinyTorchBackend  # noqa: E402

BACKENDS = [TinyTorchBackend, OrchestratedBackend]

FP32 = 2e-5  # tests/test_kernels.py's fp32 tolerance
N_THREADS = 6
REQS_PER_THREAD = 10


def _weights():
    return [np.random.RandomState(s).randn(24, 24).astype(np.float32) * 0.2 for s in range(3)]


def deploy_chain(platform):
    """A -> B -> C, weights chosen so results are deterministic per input."""
    wa, wb, wc = (torch.from_numpy(w) for w in _weights())
    platform.deploy(FunctionSpec("A", lambda ctx, p, x: ctx.call("B", torch.tanh(x @ p)), wa))
    platform.deploy(FunctionSpec("B", lambda ctx, p, x: ctx.call("C", torch.tanh(x @ p)), wb))
    platform.deploy(FunctionSpec("C", lambda ctx, p, x: torch.tanh(x @ p), wc))


def jax_reference(x):
    """The JAX package's serial chain on the same weights."""
    wa, wb, wc = (jnp.asarray(w) for w in _weights())
    return np.asarray(jnp.tanh(jnp.tanh(jnp.tanh(jnp.asarray(x) @ wa) @ wb) @ wc))


@pytest.mark.parametrize("backend_cls", BACKENDS)
def test_stress_invocations_race_merge_swap(backend_cls):
    # min_observations is tuned so the first merges trigger MID-traffic:
    # early requests observe the edges, later ones race the swaps.
    p = backend_cls(FusionPolicy(min_observations=8, merge_cost_s=0.0), max_batch=4, max_delay_ms=2.0)
    try:
        deploy_chain(p)
        inputs = [np.full((2, 24), 0.1 + 0.05 * (t * REQS_PER_THREAD + i), np.float32)
                  for t in range(N_THREADS) for i in range(REQS_PER_THREAD)]
        results: dict[int, np.ndarray] = {}
        errors: list[Exception] = []
        lock = threading.Lock()

        def client(tid: int):
            try:
                futs = []
                for i in range(REQS_PER_THREAD):
                    idx = tid * REQS_PER_THREAD + i
                    x = torch.from_numpy(inputs[idx])
                    if i % 2 == 0:  # alternate serial and scheduled dispatch
                        out = p.invoke("A", x)
                        with lock:
                            results[idx] = out.numpy()
                    else:
                        futs.append((idx, p.invoke_async("A", x)))
                done, not_done = wait([f for _, f in futs], timeout=120)
                assert not not_done, "scheduled requests must all complete"
                for idx, f in futs:
                    with lock:
                        results[idx] = f.result().numpy()
            except Exception as exc:  # noqa: BLE001
                with lock:
                    errors.append(exc)

        threads = [threading.Thread(target=client, args=(t,)) for t in range(N_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errors, errors
        p.merger.wait_idle()

        # --- no lost responses, each correct vs the JAX serial chain ---
        total = N_THREADS * REQS_PER_THREAD
        assert len(results) == total, "every request must produce a response"
        want = jax_reference(np.stack(inputs))
        for idx in range(total):
            np.testing.assert_allclose(results[idx], want[idx], rtol=FP32, atol=FP32,
                                       err_msg=f"request {idx} diverged from serial semantics")

        # --- the swap really happened mid-traffic ---
        healthy = [m for m in p.merger.merge_log if m.healthy]
        assert healthy, "fusion must have occurred during the stress run"
        assert {"A", "B", "C"} <= set(healthy[-1].members)

        # --- billing: exactly one record per client request on the entry,
        # plus one per control-plane canary replay of A (no dupes, no losses)
        a_records = [r for r in p.meter.records if r.function == "A"]
        canary_replays = sum("A" in m.checked_members for m in p.merger.merge_log)
        assert len(a_records) == total + canary_replays
        if backend_cls is OrchestratedBackend:  # every displaced unit's pod stopped
            assert set(p.pods()) == {i.instance_id for i in p.registry.live_instances()}
    finally:
        p.shutdown()


@pytest.mark.parametrize("backend_cls", BACKENDS)
def test_overlapping_merges_held_before_the_swap_end_in_one_unit(backend_cls):
    """Two merges of overlapping groups, {A,B} and {B,C}, each built and
    health-checked before either swaps: both threads wait at a barrier just
    before their publish. The publish is a compare-and-swap on the group's
    routes, so the loser rebuilds over the union and the chain ends in ONE
    live unit {A,B,C} (the reference can end with {A,B} and {B,C} both
    routed)."""
    p = backend_cls(FusionPolicy(min_observations=10**6, merge_cost_s=0.0), max_batch=4, max_delay_ms=2.0)
    try:
        deploy_chain(p)
        x = torch.from_numpy(np.full((2, 24), 0.3, np.float32))
        p.invoke("A", x)  # canaries for every member; the policy never fuses on its own
        barrier = threading.Barrier(2, timeout=60)
        held = threading.local()
        publish = p.lifecycle.publish

        def held_publish(routes, **kw):
            if not getattr(held, "done", False):  # each thread's first swap waits for the other's
                held.done = True
                barrier.wait()
            return publish(routes, **kw)

        p.lifecycle.publish = held_publish
        errors: list[Exception] = []

        def merge(caller, callee):
            try:
                p.merger._do_merge(caller, callee, frozenset({caller, callee}))
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

        threads = [threading.Thread(target=merge, args=edge) for edge in (("A", "B"), ("B", "C"))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors
        live = p.registry.live_instances()
        assert [set(i.members) for i in live] == [{"A", "B", "C"}]
        assert {m.members for m in p.merger.merge_log if m.healthy} >= {("A", "B", "C")}
        np.testing.assert_allclose(p.invoke("A", x).numpy(), jax_reference(x.numpy()), rtol=FP32, atol=FP32)
    finally:
        p.shutdown()


@pytest.mark.parametrize("backend_cls", BACKENDS)
def test_a_hop_whose_callee_a_swap_retired_takes_the_new_route(backend_cls):
    """A merge's health check runs the candidate unit on a member's canary,
    and the unit's hop to a function outside it can resolve that function's
    instance just as another publish retires it (the reconciler swapping in
    {B,C} while ``merger.wait_idle`` ran the {A,B} merge on the caller's
    thread: under load a three-function trough merge lost its second merge
    that way, with no record). The hop re-resolves and runs on the new
    route, as a client's entry does (``_invoke_with_retry``); here C's
    instance is replaced and retired between the hop's resolve and its run.
    The reference lets the hop raise."""
    from repro_torch.core.function import FunctionInstance

    p = backend_cls(FusionPolicy(min_observations=10**6, merge_cost_s=0.0))
    try:
        deploy_chain(p)
        x = torch.from_numpy(np.full((2, 24), 0.3, np.float32))
        unit = FunctionInstance({n: p.spec_of(n) for n in "AB"}, p)
        p.attach_instance(unit)
        resolve = p.registry.resolve
        swapped = []

        def racing_resolve(name):
            inst = resolve(name)
            if name == "C" and not swapped:
                fresh = FunctionInstance({"C": p.spec_of("C")}, p)
                p.attach_instance(fresh)
                fresh.mark_ready()
                swapped.append(p.lifecycle.publish({"C": fresh}, kind="merge", expect={"C": inst}))
            return inst

        p.registry.resolve = racing_resolve
        try:
            out = unit.execute("A", (x,))
        finally:
            p.registry.resolve = resolve
        assert swapped and swapped[0] is not None and swapped[0].retired  # C's old instance retired mid-hop
        np.testing.assert_allclose(out.numpy(), jax_reference(x.numpy()), rtol=FP32, atol=FP32)
        p.detach_instance(unit)
    finally:
        p.shutdown()
