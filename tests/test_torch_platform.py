"""The port's platform core on toy torch functions: observation -> policy ->
merge -> health check -> swap -> retire (the scheduler-free cases of
test_core_fusion.py and test_merger_aborts.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # the suite runs several workers at once: leave them cores

from repro_torch.core import FunctionInstance, FunctionSpec, FusionPolicy, OrchestratedBackend, TinyTorchBackend  # noqa: E402
from repro_torch.core.handler import EdgeStats  # noqa: E402
from repro_torch.core.merger import _allclose_tree  # noqa: E402

BACKENDS = [TinyTorchBackend, OrchestratedBackend]  # the reference's test_core_fusion / test_merger_aborts


def weights(seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((64, 64)).astype(np.float32) * 0.05)


def deploy_chain_app(platform):
    """A -> B -> C synchronously; A fires async D."""
    wa, wb, wc = weights(0), weights(1), weights(2)

    def fn_c(ctx, params, x):
        return torch.tanh(x @ params)

    def fn_b(ctx, params, x):
        return ctx.call("C", torch.tanh(x @ params))

    def fn_a(ctx, params, x):
        h = torch.tanh(x @ params)
        ctx.call_async("D", h)
        return ctx.call("B", h)

    def fn_d(ctx, params, x):
        return (x * x).sum()

    platform.deploy(FunctionSpec("A", fn_a, wa))
    platform.deploy(FunctionSpec("B", fn_b, wb))
    platform.deploy(FunctionSpec("C", fn_c, wc))
    platform.deploy(FunctionSpec("D", fn_d, None))
    return wa, wb, wc


def chain_reference(wa, wb, wc, x):
    return torch.tanh(torch.tanh(torch.tanh(x @ wa) @ wb) @ wc)


@pytest.mark.parametrize("backend_cls", BACKENDS)
def test_progressive_fusion_preserves_semantics(backend_cls):
    p = backend_cls(FusionPolicy(min_observations=3, merge_cost_s=0.0))
    try:
        wa, wb, wc = deploy_chain_app(p)
        x = torch.ones(4, 64)
        outs = [p.invoke("A", x) for _ in range(10)]
        ref = chain_reference(wa, wb, wc, x)
        for out in outs:
            np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)
        merges = [m for m in p.merger.merge_log if m.healthy]
        assert len(merges) >= 2
        assert merges[-1].members == ("A", "B", "C")
        assert len({id(p.registry.resolve(n)) for n in ("A", "B", "C")}) == 1
        # the fused unit runs A as ONE unit: the async call to D is queued in
        # the run and dispatched after it
        fused = p.registry.resolve("A")
        assert fused._compiled and not fused._eager_entries
    finally:
        p.shutdown()


@pytest.mark.parametrize("backend_cls", BACKENDS)
def test_async_edges_never_fuse(backend_cls):
    p = backend_cls(FusionPolicy(min_observations=1, merge_cost_s=0.0))
    try:
        deploy_chain_app(p)
        x = torch.ones(4, 64)
        for _ in range(8):
            p.invoke("A", x)
    finally:
        p.shutdown()  # drains the async pool (or D's pod): every D invocation has run
    assert p.registry.resolve("D").members.keys() == {"D"}
    edge = p.handler.edges[("A", "D")]
    # 8 client requests plus the merges' canary replays of A
    assert edge.async_count >= 8 and edge.sync_count == 0
    assert p.meter.summary()["by_function"]["D"]["calls"] == edge.async_count


def test_trust_domain_blocks_fusion():
    p = TinyTorchBackend(FusionPolicy(min_observations=1, merge_cost_s=0.0))
    try:
        w = torch.eye(8)
        p.deploy(FunctionSpec("A", lambda ctx, params, x: ctx.call("B", x @ params), w, trust_domain="tenant1"))
        p.deploy(FunctionSpec("B", lambda ctx, params, x: x @ params, w, trust_domain="tenant2"))
        for _ in range(6):
            p.invoke("A", torch.ones(2, 8))
        assert not [m for m in p.merger.merge_log if m.healthy]
        assert len({id(p.registry.resolve(n)) for n in ("A", "B")}) == 2
    finally:
        p.shutdown()


def test_ram_reduction_and_billing():
    p = TinyTorchBackend(FusionPolicy(min_observations=3, merge_cost_s=0.0))
    try:
        deploy_chain_app(p)
        x = torch.ones(4, 64)
        p.invoke("A", x)
        p.invoke("A", x)
        ram_before = p.ram_bytes()
        assert p.meter.blocked_gb_seconds() > 0, "double billing must be observable pre-fusion"
        for _ in range(8):
            p.invoke("A", x)
        merges = [m for m in p.merger.merge_log if m.healthy]
        assert merges and all(m.freed_bytes >= 0 for m in merges)
        assert len(p.registry.live_instances()) == 2  # merged[A+B+C] + D
        assert p.ram_bytes() < ram_before  # two runtimes retired
        p.meter.reset()
        for _ in range(5):
            p.invoke("A", x)
        assert p.meter.blocked_gb_seconds() == 0.0, "no blocking after full fusion"
    finally:
        p.shutdown()


def deploy_pair(platform, w):
    platform.deploy(FunctionSpec("A", lambda ctx, params, x: ctx.call("B", x @ params), w))
    platform.deploy(FunctionSpec("B", lambda ctx, params, x: torch.tanh(x @ params), w))


@pytest.mark.parametrize("backend_cls", BACKENDS)
def test_merge_aborts_without_canary(backend_cls):
    p = backend_cls(FusionPolicy(min_observations=1, merge_cost_s=0.0))
    try:
        deploy_pair(p, torch.eye(8) * 0.5)
        before = {n: id(p.registry.resolve(n)) for n in ("A", "B")}
        p.handler.edges[("A", "B")] = EdgeStats(sync_count=5, total_wait_s=1.0)
        p.merger.submit("A", "B")
        events = p.merger.merge_log
        assert events and not events[-1].healthy
        assert events[-1].reason == "no canary traffic captured"
        assert {n: id(p.registry.resolve(n)) for n in ("A", "B")} == before
        if backend_cls is OrchestratedBackend:  # the never-promoted unit's pod is gone
            assert {tuple(sorted(w.instance.members)) for w in p._workers.values()} == {("A",), ("B",)}
    finally:
        p.shutdown()


@pytest.mark.parametrize("backend_cls", BACKENDS)
def test_health_check_failure_never_swaps_routing(backend_cls):
    """Bad callee output in the merged unit -> abort; originals keep serving."""
    p = backend_cls(FusionPolicy(min_observations=1, merge_cost_s=0.0, enabled=False))
    try:
        w = torch.eye(8) * 0.5
        deploy_pair(p, w)
        x = torch.ones(2, 8)
        ref = p.invoke("A", x)  # records canaries for A and B
        before = {n: id(p.registry.resolve(n)) for n in ("A", "B")}
        good = p._specs["B"]
        p._specs["B"] = FunctionSpec("B", lambda ctx, params, xx: torch.tanh(xx @ params) + 100.0, good.params)
        p.policy.enabled = True
        p.handler.edges[("A", "B")] = EdgeStats(sync_count=5, total_wait_s=1.0)
        p.merger.submit("A", "B")
        events = p.merger.merge_log
        assert events and not events[-1].healthy
        assert events[-1].reason == "health check failed"
        assert events[-1].checked_members
        assert {n: id(p.registry.resolve(n)) for n in ("A", "B")} == before
        n_events = len(events)
        assert torch.equal(p.invoke("A", x), ref)
        assert len(p.merger.merge_log) == n_events  # quarantined: no rebuild spin
    finally:
        p.shutdown()


def test_compiled_vs_eager_entry_selection():
    p = TinyTorchBackend(FusionPolicy(enabled=False))
    try:
        deploy_chain_app(p)
        p.invoke("A", torch.ones(4, 64))
        # C is a leaf -> one unit; A and B have boundary calls -> eager glue
        inst_c, inst_a = p.registry.resolve("C"), p.registry.resolve("A")
        assert inst_c._compiled and not inst_c._eager_entries
        assert inst_a._eager_entries and not inst_a._compiled
    finally:
        p.shutdown()


def test_fault_tolerance_redeploys_terminated_instance():
    p = TinyTorchBackend(FusionPolicy(enabled=False))
    try:
        deploy_chain_app(p)
        p.invoke("A", torch.ones(4, 64))
        inst = p.registry.resolve("C")  # simulate a crashed container
        inst.state = inst.state.__class__.RETIRED
        inst.params = {}
        out = p.invoke("C", torch.ones(4, 64))  # platform must re-provision
        assert out.shape == (4, 64)
        assert p.registry.resolve("C").state.value == "serving"
        assert [e.kind for e in p.lifecycle.events][-1] == "redeploy"
    finally:
        p.shutdown()


def test_output_structs_resolve_through_the_chain_without_running():
    p = TinyTorchBackend(FusionPolicy(enabled=False))
    try:
        deploy_chain_app(p)
        out = p.output_structs("A", (torch.ones(3, 64),))
        assert out.device.type == "meta" and tuple(out.shape) == (3, 64)
        assert p.meter.summary()["by_function"] == {}  # nothing executed
    finally:
        p.shutdown()


def test_allclose_tree_compares_bfloat16_in_float32():
    a = {"x": torch.ones(4, dtype=torch.bfloat16), "n": torch.arange(3)}
    assert _allclose_tree(a, {"x": a["x"] + 0.005, "n": torch.arange(3)}, 2e-2, 1e-2)
    assert not _allclose_tree(a, {"x": a["x"] + 1.0, "n": torch.arange(3)}, 2e-2, 1e-2)
    assert not _allclose_tree(a, {"x": a["x"], "n": torch.arange(3) + 1}, 2e-2, 1e-2)


def test_resident_bytes_count_what_the_reference_counts():
    """``resident_bytes`` counts the runtime constant, the weights and the
    compiled entry's recorded workspace and output bytes, as the JAX
    package's does, and ``retire`` frees what was counted. On the CPU there
    is no allocator statistic, so the workspace is 0: after one request an
    instance holds 32 MiB + weights + output bytes. The JAX instance after
    the same request holds more than its constant plus weights: the compiled
    program's bytes that the port used to leave out."""
    import jax.numpy as jnp

    from repro.core import FunctionSpec as JaxSpec
    from repro.core import FusionPolicy as JaxPolicy
    from repro.core import TinyJaxBackend
    from repro_torch.core.function import INSTANCE_RUNTIME_OVERHEAD_BYTES

    w = weights(0)
    weight_bytes = w.numel() * w.element_size()
    p = TinyTorchBackend(FusionPolicy(enabled=False))
    try:
        inst = p.deploy(FunctionSpec("f", lambda ctx, params, x: torch.tanh(x @ params), w))
        assert inst.resident_bytes() == INSTANCE_RUNTIME_OVERHEAD_BYTES + weight_bytes  # nothing has run
        out = p.invoke("f", torch.ones(4, 64))
        output_bytes = out.numel() * out.element_size()
        assert inst.entry_bytes() == [(0, output_bytes)]
        counted = INSTANCE_RUNTIME_OVERHEAD_BYTES + weight_bytes + output_bytes
        assert inst.resident_bytes() == counted and p.ram_bytes() == counted
        p.invoke("f", torch.ones(4, 64))  # the same entry: recorded once
        assert inst.resident_bytes() == counted
        assert inst.retire() == counted and inst.resident_bytes() == 0
    finally:
        p.shutdown()

    jp = TinyJaxBackend(JaxPolicy(enabled=False))
    try:
        jinst = jp.deploy(JaxSpec("f", lambda ctx, params, x: jnp.tanh(x @ params), jnp.asarray(w.numpy())))
        jp.invoke("f", jnp.ones((4, 64)))
        assert jinst.resident_bytes() > INSTANCE_RUNTIME_OVERHEAD_BYTES + weight_bytes
    finally:
        jp.shutdown()


def test_largest_entry_is_counted_and_boundary_entries_record_nothing():
    """An instance holds one entry's workspace and outputs at a time (one
    allocator serves them all): the largest is counted, not their sum. An
    entry that crosses an instance boundary (interpreter glue) records
    nothing, as in the reference."""
    from repro_torch.core.function import INSTANCE_RUNTIME_OVERHEAD_BYTES

    p = TinyTorchBackend(FusionPolicy(enabled=False))
    try:
        wa, wb, wc = deploy_chain_app(p)
        for rows in (4, 16, 8):
            p.invoke("A", torch.ones(rows, 64))
        inst_a, inst_c = p.registry.resolve("A"), p.registry.resolve("C")
        assert inst_a.entry_bytes() == []  # A calls B synchronously: glue
        assert sorted(o for _, o in inst_c.entry_bytes()) == [4 * 64 * 4, 8 * 64 * 4, 16 * 64 * 4]
        assert inst_c.resident_bytes() == INSTANCE_RUNTIME_OVERHEAD_BYTES + wc.numel() * 4 + 16 * 64 * 4
        assert inst_a.resident_bytes() == INSTANCE_RUNTIME_OVERHEAD_BYTES + wa.numel() * 4
    finally:
        p.shutdown()


def test_kernel_wrappers_refuse_a_launch_that_would_drop_a_gradient():
    """On the card, a kernel's output carries no gradient (the kernels have
    no backward yet): each wrapper calls this check before its launch. It
    raises in grad mode when an input requires grad, and passes under
    no_grad (the serve paths) or for inputs that do not."""
    from repro_torch.kernels import build

    x = torch.ones(2, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward on the card"):
        build.refuse_grad("moe_gmm", torch.ones(2), x)
    with torch.no_grad():
        build.refuse_grad("moe_gmm", x)
    build.refuse_grad("moe_gmm", x.detach(), torch.ones(2), None)


def test_detach_instance_stops_never_promoted_worker():
    p = OrchestratedBackend(FusionPolicy(enabled=False))
    try:
        p.deploy(FunctionSpec("B", lambda ctx, params, x: x + 1, None))
        candidate = FunctionInstance({"B": p.spec_of("B")}, p)
        p.attach_instance(candidate)
        worker = p._workers[candidate.instance_id]
        assert worker.thread.is_alive()
        p.detach_instance(candidate)
        worker.thread.join(timeout=10)
        assert not worker.thread.is_alive(), "detached pod's request loop must exit"
        assert candidate.instance_id not in p._workers
        # routing never pointed at the candidate; B still serves
        assert int(p.invoke("B", torch.tensor(1, dtype=torch.int32))) == 2
    finally:
        p.shutdown()


def test_detach_is_noop_for_unknown_instance():
    p = OrchestratedBackend(FusionPolicy(enabled=False))
    try:
        p.deploy(FunctionSpec("B", lambda ctx, params, x: x, None))
        ghost = FunctionInstance({"B": p.spec_of("B")}, p)  # never attached
        p.detach_instance(ghost)  # must not raise or disturb live workers
        assert int(p.invoke("B", torch.tensor(7, dtype=torch.int32))) == 7
    finally:
        p.shutdown()


def test_pods_exit_at_shutdown_after_their_queued_work():
    """Each pod is a thread of its own that the platform's shutdown ends,
    after the requests already queued to it; a failing request reaches its
    caller through the pod's Future, as in the reference."""
    p = OrchestratedBackend(FusionPolicy(enabled=False))
    p.deploy(FunctionSpec("F", lambda ctx, params, x: x * 2, None))
    p.deploy(FunctionSpec("Bad", lambda ctx, params, x: x[10], None))
    threads = list(p.pods().values())
    assert len(threads) == 2 and all(t.is_alive() for t in threads)
    assert int(p.invoke("F", torch.tensor(3))) == 6
    with pytest.raises(IndexError):
        p.invoke("Bad", torch.zeros(2))
    p.shutdown()
    assert not any(t.is_alive() for t in threads) and p.pods() == {}


@pytest.mark.parametrize("backend_cls", BACKENDS)
def test_shut_down_platform_is_freed_by_the_cyclic_collector(backend_cls):
    """A platform that fused, retired instances and served scheduled traffic
    keeps nothing alive once it is shut down: its cycles (instances,
    merger, control plane and scheduler point back at it) are garbage, and
    one collection frees it with every instance it made, retired or live."""
    import gc
    import weakref

    made = []
    orig = FunctionInstance.__init__

    def record(self, *args, **kwargs):
        orig(self, *args, **kwargs)
        made.append(weakref.ref(self))

    FunctionInstance.__init__ = record
    try:
        p = backend_cls(FusionPolicy(min_observations=3, merge_cost_s=0.0))
        deploy_chain_app(p)
        x = torch.ones(4, 64)
        for _ in range(10):
            p.invoke("A", x)
        p.merger.wait_idle()
        assert any(m.healthy for m in p.merger.merge_log)
        assert all(f.result(timeout=60).shape == (4, 64) for f in [p.invoke_async("A", x) for _ in range(4)])
        p.shutdown()
    finally:
        FunctionInstance.__init__ = orig
    ref = weakref.ref(p)
    del p
    gc.collect()
    assert ref() is None, "the shut-down platform is still reachable"
    assert len(made) > 4 and not [r() for r in made if r() is not None]
