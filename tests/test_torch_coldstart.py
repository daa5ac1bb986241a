"""Warm provisioning in the port: executable-index reuse, scale-to-zero park
and resurrect, and bit-exactness of restored instances on the serving paths
— the cases of the JAX package's ``tests/test_coldstart.py``, each run on
``TinyJaxBackend`` and ``TinyTorchBackend`` with the same inputs.

"Bit-exact" means, inside one package: a restored instance runs the same
entry on digest-verified restored params, so its outputs equal the pre-park
outputs bit for bit. Across the packages the outputs agree within 2e-5 (fp32)
and the provisioning counts, ``warm`` flags and parked lists are equal. The
port's counterpart of "zero XLA compiles" is zero new ``entries`` and
``buckets`` in its dispatch tracer (a CUDA-graph capture is counted apart and
happens only on the card).
"""
import dataclasses
import gc
import importlib.util
import os
import pickle
import subprocess
import sys
import threading
import weakref
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # the suite runs several workers at once: leave them cores

from repro.analysis.dispatch import TRACER as REF_TRACER  # noqa: E402
from repro.core import FunctionSpec as RefSpec  # noqa: E402
from repro.core import FusionPolicy as RefPolicy  # noqa: E402
from repro.core import TinyJaxBackend  # noqa: E402
from repro.launch.compile_cache import EXECUTABLE_INDEX as REF_INDEX  # noqa: E402
from repro.scheduler.clock import VirtualClock as RefClock  # noqa: E402

from repro_torch import tree  # noqa: E402
from repro_torch.analysis.dispatch import TRACER  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.core import FunctionSpec, FusionPolicy, TinyTorchBackend  # noqa: E402
from repro_torch.launch.compile_cache import EXECUTABLE_INDEX  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.scheduler.clock import VirtualClock  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-5  # fp32 (tests/test_kernels.py)
# serial traffic on a busy host: promotion by measured sync waits would make
# the merge order depend on timing (chip_smoke.SERVE_POLICY turns it off too),
# and so would the amortization gate: it weighs an edge's measured sync wait
# x the horizon against the EWMA of measured build seconds, and under load
# the innermost edge of a chain fell under it at its first decision after a
# park, so the chain fused another pair first (a group never built: a cold
# merge). With a horizon this long any measured wait pays for any build, the
# decisions read observation counts alone, and the merges follow the
# candidates' order.
FUSING = dict(min_observations=2, merge_cost_s=0.0, promote_wait_s=float("inf"), amortization_horizon=10**9)


def _leaf_fn(tanh):
    def leaf(ctx, params, x):
        return tanh(x @ params["w"])

    return leaf


def _head_fn(tanh):
    def head(ctx, params, x):
        return ctx.call("L", tanh(x @ params["w"]))

    return head


PKGS = {
    "port": {"Backend": TinyTorchBackend, "Spec": FunctionSpec, "Policy": FusionPolicy, "Clock": VirtualClock,
             "tracer": TRACER, "leaf": _leaf_fn(torch.tanh), "head": _head_fn(torch.tanh),
             "array": torch.from_numpy, "numpy": lambda x: x.numpy()},
    "ref": {"Backend": TinyJaxBackend, "Spec": RefSpec, "Policy": RefPolicy, "Clock": RefClock,
            "tracer": REF_TRACER, "leaf": _leaf_fn(jnp.tanh), "head": _head_fn(jnp.tanh),
            "array": jnp.asarray, "numpy": np.asarray},
}


def _weights(pkg, seed, n=32):
    return {"w": PKGS[pkg]["array"](np.random.RandomState(seed).randn(n, n).astype(np.float32) * 0.1)}


def _x(pkg):
    return PKGS[pkg]["array"](np.ones((4, 32), np.float32))


@pytest.fixture(autouse=True)
def _fresh_index():
    EXECUTABLE_INDEX.clear()
    REF_INDEX.clear()
    yield
    EXECUTABLE_INDEX.clear()
    REF_INDEX.clear()


def _new_programs(pkg, base) -> int:
    """Programs made since ``base``: XLA compiles in the reference; new
    compiled entries and batched buckets in the port."""
    d = PKGS[pkg]["tracer"].delta(base)
    return d.compiles if pkg == "ref" else d.entries + d.buckets


def _prov(platform) -> dict:
    """What both packages must agree on: provisioning counts, warm flags of
    the provisioning records, parked functions, healthy merges' warm flags."""
    stats = platform.provisioning_stats()
    return {"counts": stats["counts"], "parked": stats["parked"],
            "records": [(r.kind, r.functions, r.warm, r.billed) for r in platform.meter.provisioning],
            "merges": [m.warm for m in platform.merger.merge_log if m.healthy]}


def both(run):
    """``run(pkg)`` on both packages; returns {pkg: result}."""
    return {pkg: run(pkg) for pkg in ("port", "ref")}


def assert_close(got: dict, key: str = "out"):
    port, ref = np.asarray(got["port"][key]), np.asarray(got["ref"][key])
    np.testing.assert_allclose(port, ref, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------- the index


def test_rebuilt_instance_hits_index_and_is_bit_identical():
    """Tearing a platform down and deploying the same spec on a new one
    reuses the index's record: no new program, and the same outputs bit for
    bit."""

    def run(pkg):
        k = PKGS[pkg]
        spec = k["Spec"]("f", k["leaf"], _weights(pkg, 0))
        p1 = k["Backend"](k["Policy"](enabled=False))
        try:
            p1.deploy(spec)
            r1 = k["numpy"](p1.invoke("f", _x(pkg)))
            first = p1.registry.resolve("f").provision_profile()
        finally:
            p1.shutdown()
        p2 = k["Backend"](k["Policy"](enabled=False))
        try:
            p2.deploy(spec)
            base = k["tracer"].snapshot()
            k["tracer"].arm()
            try:
                r2 = k["numpy"](p2.invoke("f", _x(pkg)))
            finally:
                k["tracer"].disarm()
            new = _new_programs(pkg, base)
            second = p2.registry.resolve("f").provision_profile()
        finally:
            p2.shutdown()
        np.testing.assert_array_equal(r1, r2)
        return {"out": r2, "new": new, "profiles": [(p["cache_hits"], p["cache_misses"]) for p in (first, second)]}

    got = both(run)
    assert_close(got)
    assert got["port"]["new"] == got["ref"]["new"] == 0
    assert got["port"]["profiles"] == got["ref"]["profiles"] == [(0, 1), (1, 0)]


def test_effectful_program_never_enters_index():
    """An entry that queues async calls closes over ITS platform — serving
    its record to another platform would route them into a dead object. The
    index refuses such entries."""

    def run(pkg):
        k = PKGS[pkg]
        w = _weights(pkg, 0)

        def async_head(ctx, params, x):
            ctx.call_async("sink", x)
            return x @ params["w"]

        def sink(ctx, params, x):
            return x

        profiles = []
        for _ in range(2):  # the same specs on two platforms
            p = k["Backend"](k["Policy"](enabled=False))
            try:
                p.deploy(k["Spec"]("hd", async_head, w))
                p.deploy(k["Spec"]("sink", sink, {}))
                out = k["numpy"](p.invoke("hd", _x(pkg)))
                profile = p.registry.resolve("hd").provision_profile()
                profiles.append((profile["cache_hits"], profile["cache_misses"]))
            finally:
                p.shutdown()
        return {"out": out, "profiles": profiles}

    got = both(run)
    assert_close(got)
    assert got["port"]["profiles"] == got["ref"]["profiles"] == [(0, 1), (0, 1)]


# ------------------------------------------------------ park + resurrect


def _drive_fusion(platform, x, n=4):
    for _ in range(n):
        out = platform.invoke("H", x)
    platform.merger.wait_idle()
    return out


def _deploy_hl(pkg, platform):
    k = PKGS[pkg]
    platform.deploy(k["Spec"]("H", k["head"], _weights(pkg, 0)))
    platform.deploy(k["Spec"]("L", k["leaf"], _weights(pkg, 1)))


def test_merge_park_resurrect_remerge_zero_recompiles(tmp_path):
    """Merge, park the fused unit, resurrect its members and merge again
    (the fission half of the reference's merge -> split -> re-merge waits
    for fission): the resurrects and the re-merge are served from the index
    — no new program — and the re-fused outputs equal the first ones bit for
    bit."""

    def run(pkg):
        k = PKGS[pkg]
        p = k["Backend"](k["Policy"](**FUSING), snapshot_dir=str(tmp_path / pkg))
        x = _x(pkg)
        try:
            _deploy_hl(pkg, p)
            fused_ref = k["numpy"](_drive_fusion(p, x))
            assert p.scale_to_zero("H") == ("H", "L")
            base = k["tracer"].snapshot()
            k["tracer"].arm()
            try:
                fused_again = k["numpy"](_drive_fusion(p, x))
            finally:
                k["tracer"].disarm()
            new = _new_programs(pkg, base)
            np.testing.assert_array_equal(fused_ref, fused_again)
            stats = p.stats()["provisioning"]
            assert stats["compile_cache"]["hits"] > 0
            assert [m["warm"] for m in p.stats()["merges"]] == [False, True]
            return {"out": fused_again, "new": new, "prov": _prov(p)}
        finally:
            p.shutdown()

    got = both(run)
    assert_close(got)
    assert got["port"]["new"] == got["ref"]["new"] == 0
    assert got["port"]["prov"] == got["ref"]["prov"]
    assert got["port"]["prov"]["counts"] == {"merge": 2, "park": 1, "resurrect": 2}


def test_scale_to_zero_resurrect_bit_identical_and_billed(tmp_path):
    def run(pkg):
        k = PKGS[pkg]
        p = k["Backend"](k["Policy"](enabled=False), snapshot_dir=str(tmp_path / pkg))
        x = _x(pkg)
        try:
            p.deploy(k["Spec"]("f", k["leaf"], _weights(pkg, 0)))
            ref = k["numpy"](p.invoke("f", x))
            assert p.scale_to_zero("f") == ("f",)
            parked = p.provisioning_stats()["parked"]
            assert p.registry.get("f") is None  # route is gone, RAM released
            assert p.ram_bytes() == 0
            assert p.snapshots.stats()["puts"] == 1
            base = k["tracer"].snapshot()
            k["tracer"].arm()
            try:
                got = k["numpy"](p.invoke("f", x))
            finally:
                k["tracer"].disarm()
            new = _new_programs(pkg, base)
            np.testing.assert_array_equal(ref, got)
            prov = p.meter.summary()["provisioning"]
            # resurrect time is billed; the parked idle time is not a record at all
            assert prov["billed_s"] > 0.0
            return {"out": got, "new": new, "parked": parked, "prov": _prov(p)}
        finally:
            p.shutdown()

    got = both(run)
    assert_close(got)
    assert got["port"]["new"] == got["ref"]["new"] == 0
    assert got["port"]["parked"] == got["ref"]["parked"] == ["f"]
    assert got["port"]["prov"] == got["ref"]["prov"]
    assert got["port"]["prov"]["records"] == [("park", ("f",), True, False), ("resurrect", ("f",), True, True)]
    assert got["port"]["prov"]["parked"] == []


def test_invocation_billing_unchanged_by_provisioning(tmp_path):
    """Provisioning is a separate line item: total_gb_s covers exactly the
    invocation records, with or without parks in the session."""

    def run(pkg):
        k = PKGS[pkg]
        p = k["Backend"](k["Policy"](enabled=False), snapshot_dir=str(tmp_path / pkg))
        x = _x(pkg)
        try:
            p.deploy(k["Spec"]("f", k["leaf"], _weights(pkg, 0)))
            p.invoke("f", x)
            p.scale_to_zero("f")
            p.invoke("f", x)
            s = p.meter.summary()
            with p.meter._lock:
                invocation_total = sum(r.gb_seconds for r in p.meter.records)
                n = len(p.meter.records)
            assert s["total_gb_s"] == pytest.approx(invocation_total)
            return {"records": n, "prov": _prov(p)}
        finally:
            p.shutdown()

    got = both(run)
    assert got["port"] == got["ref"]


def test_resurrect_of_fused_group_re_fuses_bit_identical(tmp_path):
    """Round trip: merge -> park the fused unit -> resurrect -> re-merge. The
    re-fused unit reuses the first fused unit's records (a warm merge) and
    reproduces its outputs bit for bit."""

    def run(pkg):
        k = PKGS[pkg]
        p = k["Backend"](k["Policy"](**FUSING), snapshot_dir=str(tmp_path / pkg))
        x = _x(pkg)
        try:
            _deploy_hl(pkg, p)
            fused_ref = k["numpy"](_drive_fusion(p, x))
            assert any(m.healthy for m in p.merger.merge_log)
            assert set(p.scale_to_zero("H")) == {"H", "L"}  # the whole fused unit
            parked = p.provisioning_stats()["parked"]
            fused_again = k["numpy"](_drive_fusion(p, x))
            merges = [m for m in p.merger.merge_log if m.healthy]
            assert len(merges) == 2 and merges[1].warm is True
            np.testing.assert_array_equal(fused_ref, fused_again)
            return {"out": fused_again, "parked": parked, "prov": _prov(p)}
        finally:
            p.shutdown()

    got = both(run)
    assert_close(got)
    assert got["port"]["parked"] == got["ref"]["parked"] == ["H", "L"]
    assert got["port"]["prov"] == got["ref"]["prov"]


def test_idle_park_tick_parks_and_invoke_resurrects(tmp_path):
    """Scale-to-zero from the tick hook on a virtual clock: an idle function
    is parked by the tick, and the next invoke resurrects it. The reconciler
    thread is stopped first, so that the test's tick is the only one (the
    thread's own tick: the next test)."""

    def run(pkg):
        k = PKGS[pkg]
        clock = k["Clock"]()
        p = k["Backend"](k["Policy"](enabled=False), snapshot_dir=str(tmp_path / pkg),
                         idle_park_s=5.0, clock=clock)
        x = _x(pkg)
        try:
            p.lifecycle.shutdown()
            p.deploy(k["Spec"]("f", k["leaf"], _weights(pkg, 0)))
            ref = k["numpy"](p.invoke("f", x))
            clock.advance(4.0)
            p._idle_park_tick()
            assert p.provisioning_stats()["parked"] == []  # not idle long enough
            clock.advance(6.0)
            p._idle_park_tick()
            parked = p.provisioning_stats()["parked"]
            got = k["numpy"](p.invoke("f", x))
            np.testing.assert_array_equal(ref, got)
            assert p.provisioning_stats()["parked"] == []
            return {"out": got, "parked": parked, "prov": _prov(p)}
        finally:
            p.shutdown()

    got = both(run)
    assert_close(got)
    assert got["port"]["parked"] == got["ref"]["parked"] == ["f"]
    assert got["port"]["prov"] == got["ref"]["prov"]


def test_reconciler_thread_parks_an_idle_function(tmp_path):
    """The reconciler thread runs the idle-park tick itself: advancing the
    virtual clock past ``idle_park_s`` wakes it, and it parks the function
    (waited for in real time, bounded)."""
    clock = VirtualClock()
    p = TinyTorchBackend(FusionPolicy(enabled=False), snapshot_dir=str(tmp_path), idle_park_s=5.0, clock=clock)
    x = _x("port")
    done = threading.Event()
    try:
        p.deploy(FunctionSpec("f", PKGS["port"]["leaf"], _weights("port", 0)))
        ref = p.invoke("f", x)
        clock.wait_for_waiters(1)  # the reconciler is parked on its tick wait
        clock.advance(10.0)
        for _ in range(500):
            if p.provisioning_stats()["parked"] == ["f"]:
                break
            done.wait(0.01)
        assert p.provisioning_stats()["parked"] == ["f"]
        assert torch.equal(p.invoke("f", x), ref)
    finally:
        p.shutdown()
    assert not p.lifecycle._thread.is_alive()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_concurrent_invokes_of_a_parked_function_resurrect_it_once(tmp_path, pkg):
    """Threads that invoke a parked function at once: one resurrects it, the
    others wait for it; every caller gets the pre-park output."""
    k = PKGS[pkg]
    p = k["Backend"](k["Policy"](enabled=False), snapshot_dir=str(tmp_path))
    x = _x(pkg)
    threads_n, rounds = 4, 3
    try:
        p.deploy(k["Spec"]("f", k["leaf"], _weights(pkg, 0)))
        ref = k["numpy"](p.invoke("f", x))
        for _ in range(rounds):
            assert p.scale_to_zero("f") == ("f",)
            barrier = threading.Barrier(threads_n)
            outs, errors = [], []

            def call():
                try:
                    barrier.wait(timeout=30)
                    outs.append(k["numpy"](p.invoke("f", x)))
                except Exception as exc:  # noqa: BLE001 — reported below
                    errors.append(exc)

            threads = [threading.Thread(target=call) for _ in range(threads_n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads) and not errors
            assert len(outs) == threads_n and all(np.array_equal(o, ref) for o in outs)
        kinds = [r.kind for r in p.meter.provisioning]
        assert kinds.count("resurrect") == rounds and kinds.count("park") == rounds
    finally:
        p.shutdown()


# ------------------------------------------------------- the idle park's window


def test_idle_park_is_dropped_when_a_request_comes_during_the_puts(tmp_path):
    """A port-only check: the idle tick judges a function idle, then writes
    its snapshots (seconds on the card). A request that reaches it meanwhile
    drops the park: the function stays routed and live, and the next idle
    park of the same weights is a dedup."""
    clock = VirtualClock()
    p = TinyTorchBackend(FusionPolicy(enabled=False), snapshot_dir=str(tmp_path), idle_park_s=5.0, clock=clock)
    x = _x("port")
    try:
        p.lifecycle.shutdown()
        p.deploy(FunctionSpec("f", PKGS["port"]["leaf"], _weights("port", 0)))
        ref = p.invoke("f", x)
        inst = p.registry.get("f")
        clock.advance(10.0)
        put = p.snapshots.put

        def put_meeting_a_request(params):
            digest = put(params)
            clock.advance(1.0)
            p.invoke("f", x)  # served by the live instance while the park writes
            return digest

        p.snapshots.put = put_meeting_a_request
        p._idle_park_tick()
        p.snapshots.put = put
        assert p.provisioning_stats()["parked"] == []
        assert p.registry.get("f") is inst and p.ram_bytes() > 0
        assert [r.kind for r in p.meter.provisioning] == []
        clock.advance(10.0)
        p._idle_park_tick()
        assert p.provisioning_stats()["parked"] == ["f"]
        assert p.snapshots.stats()["dedup_hits"] == 1
        assert torch.equal(p.invoke("f", x), ref)
    finally:
        p.shutdown()


# -------------------------------------------------- serving paths, bit-exact


PROMPT = np.random.default_rng(5).integers(0, 256, (2, 8)).astype(np.int32)
STEPS = 6
MAX_LEN = 48


def _greedy(engine, toks, steps, argmax):
    """Prefill and ``steps - 1`` greedy decode steps; every step's logits."""
    logits, caches, cur = engine.prefill({"tokens": toks})
    out = [logits]
    for _ in range(steps - 1):
        logits, caches = engine.decode_step(argmax(logits), cur, caches)
        cur = cur + 1
        out.append(logits)
    return out


def _port_argmax(logits):
    return torch.argmax(logits, -1)[:, None].to(torch.int32)


# The JAX engine's side, in a process of its own at a lower priority (as
# tests/test_torch_serving.py runs it): its XLA compiles would otherwise take
# the cores from the suite's timing-sensitive tests running beside this file.
JAX_SERVING = """
import dataclasses, os, pickle, sys
os.nice(10)
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_arch, reduced_config
from repro.core import FusionPolicy, TinyJaxBackend
from repro.models.model import build_model
from repro.serving.engine import ServingEngine

arch, max_len, steps, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
cfg = dataclasses.replace(reduced_config(get_arch(arch)), kv_cache_dtype="float32")
model = build_model(cfg)
params = jax.tree.map(lambda x: x.astype(jnp.float32), model.init(jax.random.PRNGKey(0)))
platform = TinyJaxBackend(FusionPolicy(enabled=False))
try:
    engine = ServingEngine(model, platform, max_len=max_len, params=params)
    logits, caches, cur = engine.prefill({"tokens": jnp.asarray(np.load(out + ".prompt.npy"))})
    got = [np.asarray(logits)]
    for _ in range(steps - 1):
        logits, caches = engine.decode_step(jnp.argmax(logits, -1)[:, None].astype(jnp.int32), cur, caches)
        cur = cur + 1
        got.append(np.asarray(logits))
finally:
    platform.shutdown()
with open(out, "wb") as f:
    pickle.dump({"params": jax.tree.map(np.asarray, params), "logits": got}, f)
"""


def jax_serving(arch, tmp_path_factory):
    """The JAX engine (unfused, fp32: every leaf cast, fp32 caches) on the
    reduced ``arch``, greedy from PROMPT: its params as float32 numpy and
    each step's logits."""
    out = tmp_path_factory.mktemp("jax_serving") / "out.pkl"
    np.save(f"{out}.prompt.npy", PROMPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", JAX_SERVING, arch, str(MAX_LEN), str(STEPS), str(out)],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def jax_llama(tmp_path_factory):
    return jax_serving("llama3.2-1b", tmp_path_factory)


@pytest.fixture(scope="module")
def jax_mamba2(tmp_path_factory):
    return jax_serving("mamba2-370m", tmp_path_factory)


def port_engine(arch, jax_ref, tmp_path, *, fused=False, kv_pages=0):
    cfg = dataclasses.replace(reduced_config(get_arch(arch)), kv_cache_dtype="float32")
    model = build_model(cfg)
    params = params_from_numpy(jax_ref["params"], model.param_defs, dtype=torch.float32, device=CPU)
    platform = TinyTorchBackend(FusionPolicy(**FUSING) if fused else FusionPolicy(enabled=False),
                                snapshot_dir=str(tmp_path))
    engine = ServingEngine(model, platform, max_len=MAX_LEN, params=params, device=CPU,
                           kv_pages=kv_pages, kv_page_size=16)
    return engine, platform


def assert_bits(a: list, b: list):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def assert_near_jax(got: list, want: list, decode_tol: float = TOL):
    """Each step's logits within ``TOL`` of max |logit| of the JAX engine's
    (a decode step's within ``decode_tol``)."""
    assert len(got) == len(want)
    for i, (t, j) in enumerate(zip(got, want)):
        assert np.abs(t.numpy() - j).max() <= (TOL if i == 0 else decode_tol) * np.abs(j).max()


def _parked_and_released(engine, platform):
    names = engine.chain_names()
    assert platform.provisioning_stats()["parked"] == sorted(names)
    assert all(platform.registry.get(n) is None for n in names)
    assert platform.ram_bytes() == 0
    with pytest.raises(RuntimeError, match="scale_to_zero"):
        engine.params  # noqa: B018 — released by the park


def test_dense_and_paged_chains_resurrect_bit_identical(tmp_path, jax_llama):
    """One engine with a KV arena, two serving paths: dense decode and paged
    decode both reproduce their outputs bit for bit after a park -> resurrect
    cycle; the dense logits are within 2e-5 of the JAX engine's."""
    engine, platform = port_engine("llama3.2-1b", jax_llama, tmp_path, kv_pages=32)
    toks = torch.from_numpy(PROMPT)
    try:
        ref = _greedy(engine, toks, STEPS, _port_argmax)
        parked = engine.scale_to_zero()
        assert set(parked) == set(engine.chain_names())
        _parked_and_released(engine, platform)
        got = _greedy(engine, toks, STEPS, _port_argmax)
        assert_bits(ref, got)
        assert_near_jax(got, jax_llama["logits"])
        resurrects = [r for r in platform.meter.provisioning if r.kind == "resurrect"]
        assert len(resurrects) == len(engine.chain_names()) and all(r.warm and r.billed for r in resurrects)

        ref_p, _ = engine.generate_paged({"tokens": toks[:1]}, steps=STEPS)
        assert engine.scale_to_zero()
        got_p, _ = engine.generate_paged({"tokens": toks[:1]}, steps=STEPS)
        assert torch.equal(ref_p, got_p)
        dense = torch.cat([_port_argmax(lg) for lg in ref], dim=1)
        assert torch.equal(got_p, dense[:1])  # paged == dense
    finally:
        platform.shutdown()


def _park_cycle(engine, platform, toks):
    """Park the fused chain, serve ``toks`` (resurrect + re-fuse), wait for
    the merges and serve again: (settled outputs, new entries and buckets,
    the cycle's healthy merges)."""
    assert set(engine.scale_to_zero()) == set(engine.chain_names())
    _parked_and_released(engine, platform)
    n = len(platform.merger.merge_log)
    base = TRACER.snapshot()
    TRACER.arm()
    try:
        _greedy(engine, toks, STEPS, _port_argmax)
        platform.merger.wait_idle()
        got = _greedy(engine, toks, STEPS, _port_argmax)
    finally:
        TRACER.disarm()
    d = TRACER.delta(base)
    assert len(platform.registry.live_instances()) == 1
    return got, d.entries + d.buckets, [m for m in platform.merger.merge_log[n:] if m.healthy]


def test_fused_chain_resurrects_bit_identical(tmp_path, jax_llama):
    """A fused chain parked whole: its members resurrect as singletons and
    the chain re-fuses to one unit whose settled outputs equal the pre-park
    ones bit for bit. The first re-fusion may build entries the chain never
    built (the edges' observations outlive a park, as in the JAX package, so
    the chain re-merges at its first request, on prefill canaries, where it
    first merged at its second); from the next park on, every merge is warm
    and no entry is new — the reference's "cycle 1 pays, later cycles come
    from the index" (``benchmarks/load_bench.py:503``)."""
    engine, platform = port_engine("llama3.2-1b", jax_llama, tmp_path, fused=True)
    toks = torch.from_numpy(PROMPT)
    try:
        _greedy(engine, toks, STEPS, _port_argmax)
        platform.merger.wait_idle()
        assert len(platform.registry.live_instances()) == 1
        ref = _greedy(engine, toks, STEPS, _port_argmax)  # the settled (fused) chain
        first, _, merges = _park_cycle(engine, platform, toks)
        assert set(merges[-1].members) == set(engine.chain_names())
        second, new, merges = _park_cycle(engine, platform, toks)
        assert new == 0 and merges and all(m.warm for m in merges)
        assert set(merges[-1].members) == set(engine.chain_names())
        assert_bits(ref, first)
        assert_bits(ref, second)
        assert_near_jax(second, jax_llama["logits"])
    finally:
        platform.shutdown()


# The same two park cycles on the JAX engine (fused, fp32), in a process of
# its own as above: XLA compiles and the healthy merges' warm flags per cycle.
JAX_PARK_CYCLES = """
import dataclasses, os, pickle, sys
os.nice(10)
import numpy as np, jax, jax.numpy as jnp
from repro.analysis.dispatch import TRACER
from repro.configs import get_arch, reduced_config
from repro.core import FusionPolicy, TinyJaxBackend
from repro.models.model import build_model
from repro.serving.engine import ServingEngine

arch, max_len, steps, out, snap = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
cfg = dataclasses.replace(reduced_config(get_arch(arch)), kv_cache_dtype="float32")
model = build_model(cfg)
params = jax.tree.map(lambda x: x.astype(jnp.float32), model.init(jax.random.PRNGKey(0)))
platform = TinyJaxBackend(FusionPolicy(min_observations=2, merge_cost_s=0.0, promote_wait_s=float("inf"),
                                       amortization_horizon=10**9),
                          snapshot_dir=snap)
toks = jnp.asarray(np.load(out + ".prompt.npy"))

def greedy():
    logits, caches, cur = engine.prefill({"tokens": toks})
    got = [np.asarray(logits)]
    for _ in range(steps - 1):
        logits, caches = engine.decode_step(jnp.argmax(logits, -1)[:, None].astype(jnp.int32), cur, caches)
        cur = cur + 1
        got.append(np.asarray(logits))
    return got

cycles = []
try:
    engine = ServingEngine(model, platform, max_len=max_len, params=params)
    greedy()
    platform.merger.wait_idle()
    ref = greedy()
    for _ in range(2):
        engine.scale_to_zero()
        n = len(platform.merger.merge_log)
        base = TRACER.snapshot()
        TRACER.arm()
        try:
            greedy()
            platform.merger.wait_idle()
            got = greedy()
        finally:
            TRACER.disarm()
        merges = [m for m in platform.merger.merge_log[n:] if m.healthy]
        cycles.append({"new": TRACER.delta(base).compiles, "warm": [m.warm for m in merges],
                       "last_members": sorted(merges[-1].members) if merges else [],
                       "live": len(platform.registry.live_instances()),
                       "bits": all(np.array_equal(a, b) for a, b in zip(ref, got))})
finally:
    platform.shutdown()
with open(out, "wb") as f:
    pickle.dump(cycles, f)
"""


def test_two_park_cycles_build_and_warm_as_the_jax_package(tmp_path, jax_llama):
    """The fused chain through two park cycles in both packages: in the
    first re-fusion each builds new programs (the reference: XLA compiles;
    the port: compiled entries) and every merge is cold, because the
    edges' observations outlive the park and the chain re-merges at its
    first request, on prefill canaries; in the second every merge is warm
    in both, and the port builds no entry (the reference still compiles a
    few programs outside the index, 9 of its 17, none a merged unit's).
    Each package's settled outputs are bit-identical to its own before the
    parks."""
    out = tmp_path / "cycles.pkl"
    np.save(f"{out}.prompt.npy", PROMPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", JAX_PARK_CYCLES, "llama3.2-1b", str(MAX_LEN), str(STEPS),
                           str(out), str(tmp_path / "ref_snapshots")],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, "rb") as f:
        ref_cycles = pickle.load(f)

    engine, platform = port_engine("llama3.2-1b", jax_llama, tmp_path / "port", fused=True)
    toks = torch.from_numpy(PROMPT)
    try:
        _greedy(engine, toks, STEPS, _port_argmax)
        platform.merger.wait_idle()
        ref = _greedy(engine, toks, STEPS, _port_argmax)
        port_cycles = []
        for _ in range(2):
            got, new, merges = _park_cycle(engine, platform, toks)
            port_cycles.append({"new": new, "warm": [m.warm for m in merges],
                                "last_members": sorted(merges[-1].members) if merges else [],
                                "live": len(platform.registry.live_instances()),
                                "bits": all(torch.equal(a, b) for a, b in zip(ref, got))})
        chain = sorted(engine.chain_names())
    finally:
        platform.shutdown()
    for cycles in (ref_cycles, port_cycles):
        first, second = cycles
        assert first["new"] > 0 and not any(first["warm"])
        assert second["warm"] and all(second["warm"]) and second["new"] < first["new"]
        assert all(c["bits"] and c["live"] == 1 and c["last_members"] == chain for c in cycles)
    assert port_cycles[1]["new"] == 0
    assert [c["warm"] for c in port_cycles] == [c["warm"] for c in ref_cycles]


def test_mamba2_chain_resurrects_bit_identical(tmp_path, jax_mamba2):
    """The SSM chain parked and resurrected: bit-identical to itself; the
    prefill within 2e-5 of the JAX engine's logits, a decode step within 1e-3
    (both packages cache the conv history in bf16, tests/test_torch_ssm.py)."""
    engine, platform = port_engine("mamba2-370m", jax_mamba2, tmp_path)
    toks = torch.from_numpy(PROMPT)
    try:
        ref = _greedy(engine, toks, STEPS, _port_argmax)
        engine.scale_to_zero()
        _parked_and_released(engine, platform)
        got = _greedy(engine, toks, STEPS, _port_argmax)
        assert_bits(ref, got)
        assert_near_jax(got, jax_mamba2["logits"], decode_tol=1e-3)
    finally:
        platform.shutdown()


def test_a_park_frees_the_weights_without_the_cyclic_collector(tmp_path):
    """After the engine's park, nothing holds a weight tensor: each is freed
    by reference counting as the park returns (on the card, the allocated
    memory falls by the weights' bytes right then)."""
    cfg = reduced_config(get_arch("llama3.2-1b"))
    platform = TinyTorchBackend(FusionPolicy(**FUSING), snapshot_dir=str(tmp_path))
    engine = ServingEngine(build_model(cfg), platform, max_len=MAX_LEN, device=CPU)
    try:
        toks = torch.from_numpy(PROMPT)
        for _ in range(2):
            _greedy(engine, toks, STEPS, _port_argmax)  # fuses, then runs the fused unit
        refs = [weakref.ref(x) for x in tree.leaves(engine.params)]
        gc.collect()
        gc.disable()
        try:
            engine.scale_to_zero()
            alive = sum(r() is not None for r in refs)
        finally:
            gc.enable()
        assert alive == 0
        _greedy(engine, toks, STEPS, _port_argmax)  # and it resurrects
    finally:
        platform.shutdown()


# ------------------------------------------------- chip_smoke's phases, rehearsed


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_coldstart_phases_rehearsal_on_cpu():
    """chip_smoke.py's two cold-start phases at a tiny size on the CPU: the
    same control flow and checks as on the card (tokens across the parks,
    warm resurrects and re-merge, no new entry, launches of the plain
    versions counted with the health checks), but for the memory check."""
    smoke = load_chip_smoke()
    cfg = reduced_config(get_arch("llama3.2-1b"))
    out = smoke.coldstart_phase(torch, CPU, cfg, prompt_lens=(5, 9, 12), new_tokens=4, max_len=32)
    assert out["tokens_identical"] and out["paged_tokens_identical"]
    assert out["parked"] == len(out["chain"]) and out["ram_bytes_parked"] == 0
    assert out["resurrects"] == len(out["chain"]) and out["resurrects_warm"]
    assert out["last_merge_warm"] and out["new_entries_after_park"] == 0
    ssm = smoke.ssm_coldstart_phase(torch, CPU, reduced_config(get_arch("mamba2-370m")), prompt_lens=(5, 9),
                                    new_tokens=4, max_len=32, idle_park_s=0.2)
    assert ssm["tokens_identical"] and ssm["parked_by_reconciler"]
