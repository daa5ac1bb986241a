"""A compiled entry's second run is captured as a CUDA graph and replayed
from then on (``core/function.py``). The CPU has no CUDA graph, so these
tests stand a recording in for the capture (``EmulatedGraph``: a replay
re-runs the captured function on the graph's static inputs and writes its
outputs into the captured output tensors, as a replay overwrites its pool)
and check the platform's side of it: copy-in, copy-out, outputs handed on
by identity, inputs donated to the graph, arenas bound by address, the
launches recorded and replayed, effects never captured, and the tokens of
fused, unfused, paged and batched serving unchanged."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # the suite runs several workers at once: leave them cores

from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.core import FunctionSpec, FusionPolicy, TinyTorchBackend  # noqa: E402
from repro_torch.core import function as fn_mod  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.continuous import ContinuousBatcher  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

ARCH = "llama3.2-1b"
CPU = torch.device("cpu")
MAX_LEN = 32
FUSING = dict(min_observations=2, merge_cost_s=0.0)


class EmulatedGraph:
    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        new, _ = self.fn()
        for o, n in zip(tree.leaves(self.out), tree.leaves(new)):
            if o is not n:
                o.copy_(n)


@pytest.fixture
def captured(monkeypatch):
    """Every compiled entry's second run on the CPU is 'captured'. As a
    capture on the card launches nothing, the plain versions called while
    capturing are not counted; each replay re-runs them and counts them."""
    from repro_torch.kernels import ref

    capturing = threading.local()
    called = ref._called

    def capture_graph(warmup, fn, dev, pool):
        result = warmup()
        capturing.on = True
        try:
            out = fn()
        finally:
            capturing.on = False
        return result, EmulatedGraph(fn, out[0]), out, None, 0

    monkeypatch.setattr(ref, "_called", lambda name: None if getattr(capturing, "on", False) else called(name))
    monkeypatch.setattr(fn_mod, "_capture_graph", capture_graph)
    monkeypatch.setattr(fn_mod, "_capture_device", lambda *trees: CPU)
    monkeypatch.setattr(fn_mod, "_synchronize", lambda dev: None)


def direct_tokens(model, params, toks, steps):
    with torch.no_grad():
        logits, cache = model.prefill_fn(params, {"tokens": toks})
        cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, MAX_LEN - toks.shape[1])) for k, v in cache.items()}
        cur = torch.full((toks.shape[0],), toks.shape[1], dtype=torch.int32)
        out = [torch.argmax(logits, -1)[:, None].to(torch.int32)]
        for _ in range(steps - 1):
            logits, cache = model.decode_fn(params, {"tokens": out[-1], "cur_len": cur}, cache)
            cur = cur + 1
            out.append(torch.argmax(logits, -1)[:, None].to(torch.int32))
    return torch.cat(out, dim=1)


@pytest.mark.parametrize("fused", [True, False])
def test_captured_chain_gives_the_direct_tokens_and_replays_every_decode_step(captured, fused):
    cfg = reduced_config(get_arch(ARCH))
    model = build_model(cfg)
    params = model.init(0, device=CPU)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 12)).astype(np.int32))
    platform = TinyTorchBackend(FusionPolicy(**FUSING) if fused else FusionPolicy(enabled=False))
    try:
        engine = ServingEngine(model, platform, max_len=MAX_LEN, params=params, device=CPU)
        got, _ = engine.generate({"tokens": toks}, steps=10)
        live = platform.registry.live_instances()
        stats = [g for inst in live for g in inst.graph_stats()]
    finally:
        platform.shutdown()
    assert torch.equal(got, direct_tokens(model, params, toks, 10))
    assert len(live) == (1 if fused else len(engine.chain_names()))
    decode = [g for g in stats if g["arg_shape"][1] == 1]
    # the entry's decode key ran every step: captured at its second run,
    # replayed since; a key seen once (a merge's canary through an inner
    # member, the prompt) stays eager
    entry = f"{cfg.name}/embed" if fused else f"{cfg.name}/head"
    assert any(g["entry"] == entry and g["captured"] and g["replays"] >= 7 for g in decode)
    assert all(g["captured"] == (g["runs"] >= 2) for g in stats)
    if fused:  # the caches are donated: the graph holds ONE copy, written in place
        cache_bytes = sum(x.numel() * x.element_size() for x in tree.leaves(engine.empty_caches(1)))
        assert decode[0]["static_bytes"] < 2 * cache_bytes


def test_replays_hand_the_caller_its_own_outputs(captured):
    """Two requests through one captured entry: each caller gets tensors of
    its own (copied out of the graph), and an input the entry hands on
    unchanged comes back as the caller's own tensor."""
    p = TinyTorchBackend(FusionPolicy(enabled=False))
    try:
        p.deploy(FunctionSpec("f", lambda ctx, params, x, keep: (torch.tanh(x @ params), keep),
                              torch.eye(4) * 0.5))
        keeps = [torch.full((2,), float(i)) for i in range(3)]
        outs = [p.invoke("f", torch.full((2, 4), float(i)), keeps[i]) for i in range(3)]
        (inst,) = p.registry.live_instances()
        (g,) = inst.graph_stats()
        assert g["captured"] and g["replays"] == 1
        for i, (y, keep) in enumerate(outs):
            assert torch.equal(y, torch.tanh(torch.full((2, 4), i * 0.5)))
            assert keep is keeps[i]
        assert outs[1][0].data_ptr() != outs[2][0].data_ptr()
    finally:
        p.shutdown()


def test_launches_recorded_while_captured_are_added_per_replay(captured, monkeypatch):
    """A capture records its launches instead of counting them; each replay
    adds them once, so counts stay exact."""
    def fake_kernel(x):
        if x.device.type != "meta":  # as a wrapper: the shape-only run launches nothing
            build.count_launch("decode_attention")
        return x * 2

    p = TinyTorchBackend(FusionPolicy(enabled=False))
    try:
        p.deploy(FunctionSpec("f", lambda ctx, params, x: fake_kernel(x), None))
        build.LAUNCHES.reset()
        for i in range(5):
            p.invoke("f", torch.full((3,), float(i)))
        # first run, capture's warm-up (eager), then 3 replays: 5 launches
        assert build.LAUNCHES.parts()["eager"]["decode_attention"] == 2
        assert build.LAUNCHES.parts()["replayed"]["decode_attention"] == 3
        assert build.launches("decode_attention") == 5
    finally:
        p.shutdown()
        build.LAUNCHES.reset()


def test_launch_counts_are_exact_under_threads():
    build.LAUNCHES.reset()
    barrier = threading.Barrier(8)

    def bump():
        barrier.wait()
        for _ in range(2000):
            build.count_launch("ssd_scan")

    threads = [threading.Thread(target=bump) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert build.launches("ssd_scan") == 16000
    build.LAUNCHES.reset()


def test_effectful_entry_is_never_captured(captured):
    p = TinyTorchBackend(FusionPolicy(enabled=False))
    try:
        p.deploy(FunctionSpec("D", lambda ctx, params, x: x.sum(), None))

        def fn_a(ctx, params, x):
            ctx.call_async("D", x)
            return x + 1

        p.deploy(FunctionSpec("A", fn_a, None))
        for i in range(4):
            assert torch.equal(p.invoke("A", torch.full((2,), float(i))), torch.full((2,), i + 1.0))
        inst = p.registry.resolve("A")
        (g,) = inst.graph_stats()
        assert g["effectful"] and not g["captured"] and g["runs"] == 4
    finally:
        p.shutdown()


@pytest.mark.parametrize("fused", [True, False])
def test_paged_serving_binds_the_arena_by_address(captured, fused):
    """The paged steps write the arena in place, and the unfused head hands
    it on: every captured paged entry reads (and writes) the arena at its own
    address, with no copy, and the batcher's tokens are those of
    per-request generate."""
    cfg = reduced_config(get_arch(ARCH))
    model = build_model(cfg)
    platform = TinyTorchBackend(FusionPolicy(**FUSING) if fused else FusionPolicy(enabled=False))
    try:
        engine = ServingEngine(model, platform, max_len=MAX_LEN, device=CPU, kv_pages=16)
        rng = np.random.default_rng(5)
        ps = [rng.integers(0, cfg.vocab_size, (1, t)).astype(np.int32) for t in (5, 9)]
        refs = [engine.generate({"tokens": torch.from_numpy(p)}, steps=6)[0].numpy() for p in ps]
        cb = ContinuousBatcher(engine, capacity=2)
        try:
            got = [f.result(timeout=120)["tokens"] for f in [cb.submit({"tokens": p}, 6) for p in ps]]
        finally:
            cb.shutdown()
        units = platform.registry.live_instances()
        paged = [ce for unit in units for key, ce in unit._compiled.items() if "block_table" in repr(key[1][0])]
    finally:
        platform.shutdown()
    for a, b in zip(got, refs):
        np.testing.assert_array_equal(a, b)
    replayed = [ce for ce in paged if ce.graph is not None and ce.graph.replays]
    assert replayed and all(ce.mutated <= ce.graph.bound for ce in replayed)
    pools = [t for stage in engine.arena.data.values() for t in stage.values()]
    for ce in replayed:
        bound = [ce.graph.static[i] for i in ce.graph.bound]
        assert all(any(b is t for b in bound) for t in pools)  # every pool bound, none copied
        assert ce.graph.static_bytes < sum(t.numel() * t.element_size() for t in pools)


def test_a_replay_with_another_bound_tensor_runs_eagerly(captured):
    """An input the entry writes in place is bound by address: the graph
    writes the caller's own buffer, and a call with another buffer there runs
    eagerly. (The write is idempotent: the emulated capture runs it once.)"""
    p = TinyTorchBackend(FusionPolicy(enabled=False))
    try:
        def write(ctx, params, buf, x):
            buf.copy_(x)
            return buf * 2

        p.deploy(FunctionSpec("w", write, None))
        a, b = torch.zeros(3), torch.zeros(3)
        for v in (1.0, 2.0, 3.0):
            assert torch.equal(p.invoke("w", a, torch.full((3,), v)), torch.full((3,), 2 * v))
            assert torch.equal(a, torch.full((3,), v))
        assert torch.equal(p.invoke("w", b, torch.full((3,), 5.0)), torch.full((3,), 10.0))
        assert torch.equal(b, torch.full((3,), 5.0)) and torch.equal(a, torch.full((3,), 3.0))
        (g,) = p.registry.resolve("w").graph_stats()
        assert g["captured"] and g["replays"] == 1 and g["runs"] == 3
    finally:
        p.shutdown()


def test_batched_programs_are_captured_and_replay_each_lane(captured):
    """A bucket's program is captured at its second run; its replays take
    the requests straight into the stacked static inputs and give each lane
    the serial run's bits."""
    p = TinyTorchBackend(FusionPolicy(enabled=False), max_batch=4, max_delay_ms=20.0)
    try:
        w = torch.randn(8, 8, generator=torch.Generator().manual_seed(0)) * 0.3
        p.deploy(FunctionSpec("leaf", lambda ctx, params, x, keep: (torch.tanh(x @ params), keep), w))
        inst = p.registry.resolve("leaf")
        for round_ in range(4):
            args = [(torch.full((2, 8), 0.1 * i + round_), torch.full((1,), float(i))) for i in range(4)]
            outs = inst.execute_batch("leaf", args, max_bucket=4)
            for (x, keep), (y, k) in zip(args, outs):
                assert torch.equal(y, torch.tanh(x @ w)) and torch.equal(k, keep)
                assert (k is keep) == (round_ >= 2)  # a replay hands the lane's own input back
        (g,) = [g for g in inst.graph_stats() if g["bucket"] == 4]
        assert g["captured"] and g["replays"] == 2
    finally:
        p.shutdown()


def test_a_repeated_request_never_has_its_caches_written(captured):
    """The same request twice (as a merge's canary replay repeats one):
    its cache tensors are the same objects at the entry's first run and at
    its capture, but the decode step does not hand them on, so the graph
    gets copies — the caches it donates to itself are its own, never the
    caller's — and every run gives the same result."""
    cfg = reduced_config(get_arch(ARCH))
    model = build_model(cfg)
    platform = TinyTorchBackend(FusionPolicy(**FUSING))
    try:
        engine = ServingEngine(model, platform, max_len=MAX_LEN, device=CPU)
        engine.generate({"tokens": torch.ones(1, 6, dtype=torch.int32)}, steps=4)  # fuse
        (unit,) = platform.registry.live_instances()
        # a batch of 2: a decode key the fused unit has not run yet
        logits, caches, cur = engine.prefill({"tokens": torch.arange(1, 11, dtype=torch.int32).view(2, 5)})
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        before = [x.clone() for x in tree.leaves(caches)]
        outs = [engine.decode_step(tok, cur, caches) for _ in range(4)]
        assert all(torch.equal(a, b) for a, b in zip(tree.leaves(caches), before))
        for out in outs[1:]:
            assert all(torch.equal(a, b) for a, b in zip(tree.leaves(out), tree.leaves(outs[0])))
        (g,) = [g for g in unit.graph_stats() if g["arg_shape"] == [2, 1]]
        assert g["captured"] and g["replays"] == 2
    finally:
        platform.shutdown()


def test_a_moved_handed_on_input_is_captured_again_with_a_copy(captured):
    """A handed-on input bound by address (the same object at the first run
    and the capture) that is another tensor later: that replay is refused,
    the call runs eagerly, and the next run captures again with a copy."""
    p = TinyTorchBackend(FusionPolicy(enabled=False))
    try:
        p.deploy(FunctionSpec("f", lambda ctx, params, x, keep: (x * 2, keep), None))
        keep = torch.ones(3)
        for v in (1.0, 2.0):
            p.invoke("f", torch.full((3,), v), keep)  # first run, capture: keep bound
        (g,) = p.registry.resolve("f").graph_stats()
        assert g["captured"] and g["static_bytes"] == 3 * 4  # x copied, keep bound
        other = torch.zeros(3)
        y, k = p.invoke("f", torch.full((3,), 3.0), other)  # refused: eager, dropped
        assert k is other and torch.equal(y, torch.full((3,), 6.0))
        for v in (4.0, 5.0):
            y, k = p.invoke("f", torch.full((3,), v), other)  # captured again, then replayed
            assert k is other and torch.equal(y, torch.full((3,), 2 * v))
        (g,) = p.registry.resolve("f").graph_stats()
        assert g["captured"] and g["replays"] == 1 and g["static_bytes"] == 2 * 3 * 4
    finally:
        p.shutdown()


def test_a_dropped_last_graph_takes_the_pool_with_it(monkeypatch):
    """A pool dies with the last graph captured into it, and a capture into
    it afterwards fails on the card. So when a refused replay drops an
    instance's only graph, the next capture is handed no pool (it makes a
    new one); while another graph of the instance lives, the instance's
    pool is handed on."""
    handed, pools = [], iter(range(1, 10))

    def capture_graph(warmup, fn, dev, pool):
        handed.append(pool)
        result, out = warmup(), fn()
        return result, EmulatedGraph(fn, out[0]), out, pool or ("pool", next(pools)), 1000

    monkeypatch.setattr(fn_mod, "_capture_graph", capture_graph)
    monkeypatch.setattr(fn_mod, "_capture_device", lambda *trees: CPU)
    monkeypatch.setattr(fn_mod, "_synchronize", lambda dev: None)
    p = TinyTorchBackend(FusionPolicy(enabled=False))
    try:
        p.deploy(FunctionSpec("f", lambda ctx, params, x, keep: (x * 2, keep), None))
        keep, other = torch.ones(3), torch.zeros(3)
        for v in (1.0, 2.0):
            p.invoke("f", torch.full((3,), v), keep)  # first run, capture into a new pool
        p.invoke("f", torch.full((3,), 3.0), other)  # refused: the only graph dropped
        unit = p.registry.resolve("f")
        assert unit.graph_pool_bytes() == 0
        p.invoke("f", torch.full((3,), 4.0), other)  # captured again: a new pool
        keep2, other2 = torch.ones(2), torch.zeros(2)
        for v in (1.0, 2.0):
            p.invoke("f", torch.full((2,), v), keep2)  # a second entry, into that pool
        p.invoke("f", torch.full((2,), 5.0), other2)  # refused: one graph dropped, one lives
        p.invoke("f", torch.full((2,), 6.0), other2)  # captured again into the live pool
        assert handed == [None, None, ("pool", 2), ("pool", 2)]
        assert unit.graph_pool_bytes() == 1000
    finally:
        p.shutdown()


def test_a_retired_instance_forgets_its_pool_and_a_resurrect_binds_the_restored_params(monkeypatch, tmp_path):
    """``retire`` drops the graphs with the entries and forgets their pool,
    as dropping the last graph does; a resurrected instance captures into a
    pool of its own, and its graph reads the params restored from the
    snapshot, never the old ones (written with NaN after the park here)."""
    handed, pools = [], iter(range(1, 10))

    def capture_graph(warmup, fn, dev, pool):
        handed.append(pool)
        result, out = warmup(), fn()
        return result, EmulatedGraph(fn, out[0]), out, pool or ("pool", next(pools)), 1000

    monkeypatch.setattr(fn_mod, "_capture_graph", capture_graph)
    monkeypatch.setattr(fn_mod, "_capture_device", lambda *trees: CPU)
    monkeypatch.setattr(fn_mod, "_synchronize", lambda dev: None)
    w = torch.eye(4) * 0.5
    p = TinyTorchBackend(FusionPolicy(enabled=False), snapshot_dir=str(tmp_path))
    try:
        p.deploy(FunctionSpec("f", lambda ctx, params, x: torch.tanh(x @ params), w))
        x = torch.ones(2, 4)
        want = [p.invoke("f", x * i) for i in range(3)]  # first run, capture, replay
        old = p.registry.resolve("f")
        assert old.graph_pool_bytes() == 1000 and old.graph_stats()[0]["replays"] == 1
        assert p.scale_to_zero("f") == ("f",)
        assert old.graph_pool_bytes() == 0 and old._graph_pool is None and old.graph_stats() == []
        w.fill_(float("nan"))  # the old weights: nothing may read them now
        got = [p.invoke("f", x * i) for i in range(3)]  # resurrect (its health check runs first)
        new = p.registry.resolve("f")
        assert new is not old and new.params["f"].data_ptr() != w.data_ptr()
        (g,) = new.graph_stats()
        assert g["captured"] and g["replays"] >= 1
        for a, b in zip(want, got):
            assert torch.equal(a, b)
        assert handed == [None, None]  # the resurrected instance's pool is a new one
    finally:
        p.shutdown()


def load_chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b", "qwen3-moe-30b-a3b"])
def test_captured_families_give_the_direct_tokens(captured, arch):
    """The SSM, hybrid and MoE chains fused and captured: the decode steps
    write their donated caches in place (SSM states, the hybrid's shared
    attention K/V, the MoE layer's K/V) and the greedy tokens are those of
    the model run without the platform."""
    smoke = load_chip_smoke()
    cfg = reduced_config(get_arch(arch))
    model = build_model(cfg)
    params = model.init(0, device=CPU)
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 9)).astype(np.int32))
    platform = TinyTorchBackend(FusionPolicy(**FUSING))
    try:
        engine = ServingEngine(model, platform, max_len=MAX_LEN, params=params, device=CPU)
        got, _ = engine.generate({"tokens": toks}, steps=8)
        (unit,) = platform.registry.live_instances()
        assert any(g["captured"] and g["replays"] for g in unit.graph_stats())
    finally:
        platform.shutdown()
    with torch.no_grad():
        want = smoke.direct_generate(torch, model, params, toks, 8, MAX_LEN)
    assert torch.equal(got, want)


def test_captured_bucket_of_the_fused_chain_equals_serial(captured):
    """The fused chain's batched decode program, captured (its lanes' caches
    donated under vmap), gives each lane the serial step's bits."""
    cfg = reduced_config(get_arch(ARCH))
    model = build_model(cfg)
    platform = TinyTorchBackend(FusionPolicy(**FUSING), max_batch=4, max_delay_ms=20.0)
    try:
        engine = ServingEngine(model, platform, max_len=MAX_LEN, device=CPU)
        engine.generate({"tokens": torch.ones(1, 6, dtype=torch.int32)}, steps=4)
        (unit,) = platform.registry.live_instances()
        rng = np.random.default_rng(8)
        states = []
        for _ in range(4):
            logits, caches, cur = engine.prefill(
                {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 6)).astype(np.int32))})
            states.append([torch.argmax(logits, -1)[:, None].to(torch.int32), cur, caches])
        for _ in range(3):  # first run, capture, replay
            args = [({"tokens": t}, c, k) for t, c, k in states]
            serial = [engine.decode_step(t, c, k) for t, c, k in states]
            batched = unit.execute_batch(engine.entry, args, max_bucket=4)
            for s, b in zip(serial, batched):
                assert all(torch.equal(x, y) for x, y in zip(tree.leaves(s), tree.leaves(b)))
            for st, (logits, caches) in zip(states, batched):
                st[0], st[1], st[2] = torch.argmax(logits, -1)[:, None].to(torch.int32), st[1] + 1, caches
        (g,) = [g for g in unit.graph_stats() if g["bucket"] == 4]
        assert g["captured"] and g["replays"] == 1
    finally:
        platform.shutdown()


@pytest.mark.parametrize("limit", [1, 2**20])
def test_donated_ssm_state_update_keeps_the_eager_bits(monkeypatch, limit):
    """Inside a captured run the SSD state is decayed and updated in place,
    a slice of heads at a time (``ssm._donated_head_slices``: no product
    above 1 MiB, so none takes a 20 MiB allocator segment into the graph's
    pool; ``limit`` 1 makes every head a slice of its own). The step's output
    and new caches equal the eager step's bits, and the state returned is
    the donated tensor itself."""
    from repro_torch import donate
    from repro_torch.models import ssm
    from repro_torch.models.params import init_params

    monkeypatch.setattr(ssm, "_SMALL_ALLOC_BYTES", limit)
    cfg = reduced_config(get_arch("mamba2-370m"))
    params = init_params(ssm.ssm_defs(cfg), 4, device=CPU)
    gen = torch.Generator().manual_seed(5)
    cache = {name: torch.randn(shape, generator=gen).to(dtype)
             for name, (shape, dtype) in ssm.ssm_cache_shapes(cfg, 2).items()}
    u = torch.randn(2, 1, cfg.d_model, generator=gen).to(torch.bfloat16)
    assert len(ssm._donated_head_slices(cache["ssd"])) == (cfg.ssm_nheads if limit == 1 else 1)
    with torch.no_grad():
        want, want_cache = ssm.ssm_decode_step(params, u, cache, cfg)
        own = {name: x.clone() for name, x in cache.items()}
        with donate.donating():
            got, got_cache = ssm.ssm_decode_step(params, u, own, cfg)
    assert got_cache["ssd"] is own["ssd"]
    assert torch.equal(got, want)
    assert all(torch.equal(got_cache[n], want_cache[n]) for n in want_cache)


def test_chip_smoke_batched_phase_checks_a_replayed_bucket(captured):
    """chip_smoke.py's batched phase at a tiny size with capture emulated:
    its lanes are held against ``invoke`` on a step that the captured bucket
    programs served by replays alone."""
    smoke = load_chip_smoke()
    out = smoke.batched_phase(torch, CPU, reduced_config(get_arch(ARCH)), clients=4, prompt_len=5,
                              warmup=2, steps=3, max_len=MAX_LEN)
    assert out["lane_check_bucket_replays"] >= 1 and max(out["lane_rel_err"]) <= smoke.LANE_TOL
    assert out["buckets_captured"] and out["decode_attention_launches"] == out["layers"] * out["decode_program_runs"]


def test_an_instance_captures_every_graph_into_one_pool_counted_once(monkeypatch):
    """An instance's graphs share one memory pool: each capture after the
    first is handed the pool the first made, and ``resident_bytes`` counts
    the pool once, whole, beside every graph's static inputs and the
    largest eager entry."""
    seen = []

    def capture_graph(warmup, fn, dev, pool):
        seen.append(pool)
        result, out = warmup(), fn()
        return result, EmulatedGraph(fn, out[0]), out, ("pool", 7), 1000 * len(seen)

    monkeypatch.setattr(fn_mod, "_capture_graph", capture_graph)
    monkeypatch.setattr(fn_mod, "_capture_device", lambda *trees: CPU)
    monkeypatch.setattr(fn_mod, "_synchronize", lambda dev: None)
    w = torch.ones(4, 4)
    p = TinyTorchBackend(FusionPolicy(enabled=False))
    try:
        p.deploy(FunctionSpec("leaf", lambda ctx, params, x: x @ params, w))
        for shape in ((2, 4), (3, 4)):
            for _ in range(3):  # first run, capture, replay
                p.invoke("leaf", torch.ones(shape))
        (inst,) = p.registry.live_instances()
        assert seen == [None, ("pool", 7)]
        graphs = [g for g in inst.graph_stats() if g["captured"]]
        assert [g["pool_bytes"] for g in graphs] == [1000, 1000]  # what the pool grew by at each capture
        statics = sum(g["static_bytes"] for g in graphs)
        assert statics == (2 + 3) * 4 * 4
        weights = w.numel() * 4
        assert inst.resident_bytes() == fn_mod.INSTANCE_RUNTIME_OVERHEAD_BYTES + weights + statics + 2000
        p.invoke("leaf", torch.ones(5, 4))  # an eager entry: its output is the largest eager footprint
        assert inst.resident_bytes() == fn_mod.INSTANCE_RUNTIME_OVERHEAD_BYTES + weights + statics + 2000 + 5 * 4 * 4
        assert inst.retire() == fn_mod.INSTANCE_RUNTIME_OVERHEAD_BYTES + weights + statics + 2000 + 5 * 4 * 4
    finally:
        p.shutdown()
