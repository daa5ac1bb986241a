"""The port's platform core on toy torch functions: observation -> policy ->
merge -> health check -> swap -> retire (the scheduler-free cases of
test_core_fusion.py and test_merger_aborts.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # the suite runs several workers at once: leave them cores

from repro_torch.core import FunctionSpec, FusionPolicy, TinyTorchBackend  # noqa: E402
from repro_torch.core.handler import EdgeStats  # noqa: E402
from repro_torch.core.merger import _allclose_tree  # noqa: E402


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


def test_progressive_fusion_preserves_semantics():
    p = TinyTorchBackend(FusionPolicy(min_observations=3, merge_cost_s=0.0))
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


def test_async_edges_never_fuse():
    p = TinyTorchBackend(FusionPolicy(min_observations=1, merge_cost_s=0.0))
    try:
        deploy_chain_app(p)
        x = torch.ones(4, 64)
        for _ in range(8):
            p.invoke("A", x)
    finally:
        p.shutdown()  # drains the async pool: every D invocation has run
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


def test_merge_aborts_without_canary():
    p = TinyTorchBackend(FusionPolicy(min_observations=1, merge_cost_s=0.0))
    try:
        deploy_pair(p, torch.eye(8) * 0.5)
        before = {n: id(p.registry.resolve(n)) for n in ("A", "B")}
        p.handler.edges[("A", "B")] = EdgeStats(sync_count=5, total_wait_s=1.0)
        p.merger.submit("A", "B")
        events = p.merger.merge_log
        assert events and not events[-1].healthy
        assert events[-1].reason == "no canary traffic captured"
        assert {n: id(p.registry.resolve(n)) for n in ("A", "B")} == before
    finally:
        p.shutdown()


def test_health_check_failure_never_swaps_routing():
    """Bad callee output in the merged unit -> abort; originals keep serving."""
    p = TinyTorchBackend(FusionPolicy(min_observations=1, merge_cost_s=0.0, enabled=False))
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
