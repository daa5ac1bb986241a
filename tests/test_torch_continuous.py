"""The port's paged serve path: ServingEngine with a KV arena and the
ContinuousBatcher, on a reduced llama3.2-1b on the CPU.

Inside the port, the reference's bit-exact invariants (paged == dense,
batcher == per-request generate, chunked == dense, copy-on-write parity);
against the JAX package, the first-token and decode logits of the paged
route at 2e-2 on the same bridged weights and the same block tables; the
in-place arena's safety (canaries, retries, masked slots); and the batcher's
admission semantics.
"""
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # the suite runs several workers at once: leave them cores

from repro_torch import tree  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.core import FusionPolicy, TinyTorchBackend  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.scheduler.slo import ClassLanes, SLOClass  # noqa: E402
from repro_torch.serving.continuous import ContinuousBatcher, ShedError  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.kvpool import ArenaFull, KVArena  # noqa: E402

ARCH = "llama3.2-1b"
CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]


def prompt(values):
    return np.asarray(values, np.int32).reshape(1, -1)


@pytest.fixture(scope="module")
def paged_engine():
    cfg = reduced_config(get_arch(ARCH))
    platform = TinyTorchBackend(FusionPolicy(min_observations=2, merge_cost_s=0.0))
    engine = ServingEngine(build_model(cfg), platform, max_len=64, device=CPU, kv_pages=64,
                           kv_page_size=16)
    yield engine
    platform.shutdown()


def dense(engine, p, steps):
    return engine.generate({"tokens": torch.from_numpy(p)}, steps=steps)[0].numpy()


# ------------------------------------------------------------- ClassLanes


def test_class_lanes_strictest_first_fifo_within():
    lanes = ClassLanes()
    strict = SLOClass("strict", 20.0)
    std = SLOClass("std", 200.0)
    for item, slo in (("be1", None), ("std1", std), ("be2", None), ("s1", strict), ("s2", strict)):
        lanes.push(item) if slo is None else lanes.push(item, slo)
    assert [lanes.pop()[0] for _ in range(5)] == ["s1", "s2", "std1", "be1", "be2"]
    assert lanes.pop() is None
    lanes.push("a", std)
    lanes.push("b", std)
    item, slo = lanes.pop()
    lanes.requeue(item, slo)
    assert lanes.pop()[0] == "a"  # a requeued item comes back first
    with pytest.raises(ValueError):
        lanes.push("x", SLOClass("std", 999.0))


# ------------------------------------------------------- bit-exact invariants


def test_generate_paged_matches_generate(paged_engine):
    p = np.random.default_rng(0).integers(0, 256, (2, 10)).astype(np.int32)
    got, lat = paged_engine.generate_paged({"tokens": torch.from_numpy(p)}, steps=8)
    assert len(lat) == 7
    np.testing.assert_array_equal(got.numpy(), dense(paged_engine, p, 8))
    paged_engine.arena.check_consistency()
    assert paged_engine.arena.used_pages() == 0


def test_batcher_matches_per_request_generate(paged_engine):
    """Ragged joins and leaves at capacity 4 (masked slots, mixed lengths)
    give exactly what solo dense generate gives."""
    engine = paged_engine
    prompts = [np.full((1, 4 + 3 * i), 3 + i, np.int32) for i in range(3)]
    gens = [6, 9, 5]
    refs = [dense(engine, p, g) for p, g in zip(prompts, gens)]
    cb = ContinuousBatcher(engine, capacity=4)
    try:
        futs = [cb.submit({"tokens": p}, g) for p, g in zip(prompts, gens)]
        for f, r in zip(futs, refs):
            res = f.result(timeout=120)
            np.testing.assert_array_equal(res["tokens"], r)
            assert res["pages"] >= 1
        stats = cb.stats()
        assert stats["completed"] == 3 and stats["tokens"] == sum(gens)
    finally:
        cb.shutdown()
    engine.arena.check_consistency()
    assert engine.arena.used_pages() == 0
    arena = engine.platform.meter.arena_summary()
    assert arena["requests"] >= 3 and arena["gb_s"] > 0


@pytest.mark.parametrize("chunk", [4, None])
def test_chunked_prefill_matches_dense(paged_engine, chunk):
    """A prompt forced through many small chunks (padded buffers, per-chunk
    causal offsets, writes into pages) gives the tokens of dense generate."""
    engine = paged_engine
    p = prompt((np.arange(1, 23) * 5) % 97)
    ref = dense(engine, p, 6)
    cb = ContinuousBatcher(engine, capacity=2, prefill_chunk=chunk)
    try:
        res = cb.submit({"tokens": p}, 6).result(timeout=120)
        np.testing.assert_array_equal(res["tokens"], ref)
        assert cb.stats()["prefill_chunks"] >= (6 if chunk else 1)  # 22 tokens / 4 per chunk
    finally:
        cb.shutdown()
    engine.arena.check_consistency()
    assert engine.arena.used_pages() == 0


def test_serialized_prefill_matches_dense(paged_engine):
    engine = paged_engine
    p = prompt((np.arange(1, 20) * 7) % 89)
    ref = dense(engine, p, 5)
    cb = ContinuousBatcher(engine, capacity=2, serialize_prefill=True)
    try:
        np.testing.assert_array_equal(cb.submit({"tokens": p}, 5).result(timeout=120)["tokens"], ref)
        assert cb.stats()["prefill_chunks"] == 0
    finally:
        cb.shutdown()
    engine.arena.check_consistency()


def test_shared_prefix_cow_parity(paged_engine):
    """Two residents sharing a whole 40-token prompt (2 full pages and a
    shared partial tail): the second is a whole-prompt hit served by a
    frozen step, its first divergent write copies the tail page, and both
    streams match unshared dense generate."""
    engine = paged_engine
    arena = engine.arena
    p = prompt((np.arange(3, 43) * 11) % 101)
    ref = dense(engine, p, 8)
    hits0, cow0 = arena.shared_hits, arena.cow_copies
    cb = ContinuousBatcher(engine, capacity=2)
    try:
        f1 = cb.submit({"tokens": p}, 8)
        f2 = cb.submit({"tokens": p}, 8)
        r1, r2 = f1.result(timeout=120), f2.result(timeout=120)
        np.testing.assert_array_equal(r1["tokens"], ref)
        np.testing.assert_array_equal(r2["tokens"], ref)
        assert arena.shared_hits > hits0, "the second request must hit the prefix cache"
        assert arena.cow_copies > cow0, "the divergent tail write must copy on write"
        assert min(r1["amortized_pages"], r2["amortized_pages"]) < min(r1["pages"], r2["pages"])
    finally:
        cb.shutdown()
    arena.check_consistency()
    assert arena.used_pages() == 0


def test_shared_prefix_then_divergent_prompt_parity(paged_engine):
    """B shares A's two full pages, then diverges inside the prompt: B
    prefills only its private suffix (K2 from start 32) and still matches."""
    engine = paged_engine
    base = (np.arange(5, 45) * 13) % 103
    pa = prompt(base)
    pb = prompt(np.concatenate([base[:32], (base[:8] + 1) % 103]))
    ref_a, ref_b = dense(engine, pa, 5), dense(engine, pb, 5)
    cb = ContinuousBatcher(engine, capacity=2)
    try:
        fa = cb.submit({"tokens": pa}, 5)
        fb = cb.submit({"tokens": pb}, 5)
        np.testing.assert_array_equal(fa.result(timeout=120)["tokens"], ref_a)
        np.testing.assert_array_equal(fb.result(timeout=120)["tokens"], ref_b)
    finally:
        cb.shutdown()
    engine.arena.check_consistency()
    assert engine.arena.used_pages() == 0


# ------------------------------------------------------- the in-place arena


def test_fused_paged_chain_is_one_unit():
    """After the chain fuses on dense traffic, paged decode, frozen and
    chunk steps run the fused entry as ONE unit: no tensor value is read on
    the host inside the chain, so the shape-only run never falls back to
    eager glue."""
    cfg = reduced_config(get_arch(ARCH))
    platform = TinyTorchBackend(FusionPolicy(min_observations=2, merge_cost_s=0.0))
    try:
        engine = ServingEngine(build_model(cfg), platform, max_len=32, device=CPU, kv_pages=16)
        engine.generate({"tokens": torch.ones(1, 6, dtype=torch.int32)}, steps=4)
        (unit,) = platform.registry.live_instances()
        cb = ContinuousBatcher(engine, capacity=2, prefill_chunk=4)
        try:
            p = prompt(np.arange(1, 11))
            cb.submit({"tokens": p}, 4).result(timeout=120)
            cb.submit({"tokens": p}, 3).result(timeout=120)  # whole-prompt hit: frozen step
        finally:
            cb.shutdown()
        assert platform.registry.live_instances() == [unit]
        assert not unit._eager_entries
        paged = [k for k in unit._compiled if "block_table" in repr(k[1][0])]
        frozen = [k for k in paged if "__frozen__" in repr(k[1][0])]
        chunked = [k for k in paged if "chunk_valid" in repr(k[1][0])]
        assert frozen and chunked and len(paged) > len(frozen) + len(chunked)
    finally:
        platform.shutdown()


def test_paged_traffic_records_no_canary_and_dense_canary_replays_unchanged():
    """The arena is written in place, so paged requests record no canary at
    any hop, even through the unfused chain; a dense-prefill canary shares
    no tensor with the arena, so serving paged traffic leaves it unchanged
    and its replay reproduces the original logits."""
    cfg = reduced_config(get_arch(ARCH))
    platform = TinyTorchBackend(FusionPolicy(enabled=False))
    try:
        engine = ServingEngine(build_model(cfg), platform, max_len=32, device=CPU, kv_pages=16)
        logits, _, _ = engine.prefill({"tokens": torch.arange(1, 8, dtype=torch.int32)[None]})
        canaries = dict(platform.handler.canaries)
        assert set(canaries) == set(engine.chain_names())
        snapshot = {n: tree.map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, a)
                    for n, a in canaries.items()}
        cb = ContinuousBatcher(engine, capacity=2, prefill_chunk=4)
        try:
            cb.submit({"tokens": prompt(np.arange(3, 14))}, 5).result(timeout=120)
        finally:
            cb.shutdown()
        assert platform.handler.canaries == canaries  # the same requests, none added
        for name, args in canaries.items():
            for a, b in zip(tree.leaves(args), tree.leaves(snapshot[name])):
                assert torch.equal(a, b)
        replay, _ = platform._invoke_with_retry(engine.entry, canaries[engine.entry])
        assert torch.equal(replay, logits)
    finally:
        platform.shutdown()


def test_merge_during_paged_serving_replays_only_dense_canaries():
    """The chain fuses WHILE the batcher serves paged traffic through the
    unfused chain: the merges' health checks can replay only the dense
    prefill's canaries (paged requests recorded none), the merges are
    healthy, and the paged requests still get the unfused reference's
    tokens."""
    cfg = reduced_config(get_arch(ARCH))
    model = build_model(cfg)
    params = model.init(0, device=CPU)
    ref_platform = TinyTorchBackend(FusionPolicy(enabled=False))
    platform = TinyTorchBackend(FusionPolicy(min_observations=2, merge_cost_s=0.0))
    prompts = [prompt((np.arange(1, 8 + 5 * i) * 3) % 97) for i in range(3)]
    try:
        ref_engine = ServingEngine(model, ref_platform, max_len=32, params=params, device=CPU)
        refs = [dense(ref_engine, p, 5) for p in prompts]
        engine = ServingEngine(model, platform, max_len=32, params=params, device=CPU, kv_pages=16)
        engine.prefill({"tokens": torch.arange(1, 6, dtype=torch.int32)[None]})  # dense canaries
        assert not platform.merger.merge_log  # one observation per edge: no merge yet
        cb = ContinuousBatcher(engine, capacity=2, prefill_chunk=4)
        try:
            got = [f.result(timeout=120)["tokens"] for f in [cb.submit({"tokens": p}, 5) for p in prompts]]
        finally:
            cb.shutdown()
        log = platform.merger.merge_log
        assert log and all(m.healthy for m in log)
        assert len(platform.registry.live_instances()) == 1
        for args in platform.handler.canaries.values():
            assert "block_table" not in repr(tree.flatten(args)[1])
        for g, r in zip(got, refs):
            np.testing.assert_array_equal(g, r)
        engine.arena.check_consistency()
    finally:
        platform.shutdown()
        ref_platform.shutdown()


def test_retried_paged_step_rewrites_the_same_rows(paged_engine):
    """A retry in _invoke_with_retry runs the same step again: it writes
    the same K/V values to the same rows, so the arena ends as after one
    attempt."""
    engine = paged_engine
    arena = engine.arena
    sid = ("retry", 0)
    p = np.arange(1, 13, dtype=np.int32)
    job = engine.begin_prefill_paged(sid, {"tokens": p[None]})
    assert engine.prefill_chunk_paged(job, 64) is not None
    try:
        arena.extend(sid, 13)
        bt = arena.block_row(sid, engine.block_width)[None]
        args = (np.asarray([[7]], np.int32), np.asarray([12], np.int32), bt)
        first = engine.paged_decode_step(*args)
        after_one = {g: {kv: t.clone() for kv, t in st.items()} for g, st in arena.data.items()}
        again = engine.paged_decode_step(*args)
        assert torch.equal(first, again)
        for g, st in arena.data.items():
            for kv, t in st.items():
                assert torch.equal(t, after_one[g][kv])
    finally:
        arena.free(sid)


def test_masked_slot_never_changes_a_live_row(paged_engine):
    """Masked slots (all-scratch rows, cur_len 0) and padded chunk rows
    write only the scratch page; no live sequence holds it, and a live
    sequence's logits are the same with or without masked company."""
    engine = paged_engine
    arena = engine.arena
    sid = ("live", 0)
    p = np.arange(2, 20, dtype=np.int32)
    job = engine.begin_prefill_paged(sid, {"tokens": p[None]})
    while engine.prefill_chunk_paged(job, 5) is None:  # 5 real rows in 8-row chunks: padding
        pass
    try:
        arena.extend(sid, 19)
        row = arena.block_row(sid, engine.block_width)
        held = row[: arena.pages_for(19)]
        assert KVArena.RESERVED_PAGE not in held
        before = {g: arena.gather(sid, g) for g in arena.data}
        batch = np.full((4, engine.block_width), KVArena.RESERVED_PAGE, np.int32)
        batch[2] = row
        tok = np.asarray([[5], [6], [7], [8]], np.int32)
        cur = np.asarray([0, 0, 18, 0], np.int32)
        logits = engine.paged_decode_step(tok, cur, batch)
        for g in arena.data:
            after = arena.gather(sid, g)
            for kv in ("k", "v"):
                assert torch.equal(after[kv][:, :18], before[g][kv][:, :18])  # the prompt's rows
                assert not torch.equal(after[kv][:, 18], before[g][kv][:, 18])  # the new token landed
        alone = engine.paged_decode_step(tok[2:3], cur[2:3], row[None])  # rewrites row 18 alike
        assert torch.equal(logits[2], alone[0])
    finally:
        arena.free(sid)


# ------------------------------------------------------- admission semantics


def test_batcher_sheds_best_effort_beyond_queue_bound(paged_engine):
    cb = ContinuousBatcher(paged_engine, capacity=1, max_queue=1)
    try:
        p = np.full((1, 4), 7, np.int32)
        occupant = cb.submit({"tokens": p}, 30)
        deadline = time.perf_counter() + 60
        while cb.stats()["active"] == 0 and time.perf_counter() < deadline:
            time.sleep(0.005)
        with cb._cv:  # both queue before the loop can admit either
            queued = cb.submit({"tokens": p}, 4)     # depth 1 (the bound)
            overflow = cb.submit({"tokens": p}, 4)   # best effort: shed
        with pytest.raises(ShedError):
            overflow.result(timeout=10)
        strict = cb.submit({"tokens": p}, 4, slo=SLOClass("interactive", 50.0))  # never shed
        assert strict.result(timeout=120)["tokens"].shape == (1, 4)
        queued.result(timeout=120)
        occupant.result(timeout=120)
        assert cb.stats()["shed"] == 1
    finally:
        cb.shutdown()


def test_strict_class_preempts_slot_assignment(paged_engine):
    cb = ContinuousBatcher(paged_engine, capacity=1)
    try:
        p = np.full((1, 4), 5, np.int32)
        occupant = cb.submit({"tokens": p}, 30)
        deadline = time.perf_counter() + 60
        while cb.stats()["active"] == 0 and time.perf_counter() < deadline:
            time.sleep(0.005)
        with cb._cv:  # both queue before the loop can admit either
            be = cb.submit({"tokens": p}, 40)
            strict = cb.submit({"tokens": p}, 4, slo=SLOClass("interactive", 50.0))
        strict.result(timeout=120)
        assert not be.done(), "best effort must not take the slot first"
        be.result(timeout=120)
        occupant.result(timeout=120)
    finally:
        cb.shutdown()


def test_unservable_prompt_fails_fast_not_starves(paged_engine):
    engine = paged_engine
    cb = ContinuousBatcher(engine, capacity=2)
    try:
        doomed = cb.submit({"tokens": np.full((1, engine.max_len + 16), 3, np.int32)}, 4)
        with pytest.raises(ArenaFull):
            doomed.result(timeout=30)
        overgen = cb.submit({"tokens": np.full((1, 8), 3, np.int32)}, engine.max_len)
        with pytest.raises(ArenaFull):
            overgen.result(timeout=30)
        ok = cb.submit({"tokens": np.full((1, 4), 3, np.int32)}, 4)
        assert ok.result(timeout=120)["tokens"].shape == (1, 4)
        with pytest.raises(ValueError):
            cb.submit({"tokens": np.full((2, 4), 3, np.int32)}, 4)  # one sequence per request
    finally:
        cb.shutdown()


def test_cancelled_future_does_not_poison_batch(paged_engine):
    engine = paged_engine
    p = np.full((1, 4), 11, np.int32)
    ref = dense(engine, p, 12)
    cb = ContinuousBatcher(engine, capacity=2)
    try:
        f1 = cb.submit({"tokens": p}, 12)
        f2 = cb.submit({"tokens": p}, 12)
        f1.cancel()  # may or may not win the race with admission; both fine
        np.testing.assert_array_equal(f2.result(timeout=120)["tokens"], ref)
        f3 = cb.submit({"tokens": p}, 5)  # the loop survived
        np.testing.assert_array_equal(f3.result(timeout=120)["tokens"], ref[:, :5])
        engine.arena.check_consistency()
    finally:
        cb.shutdown()


def test_batcher_eos_leaves_early(paged_engine):
    engine = paged_engine
    p = np.full((1, 4), 9, np.int32)
    toks = dense(engine, p, 10)[0]
    eos = int(toks[4])
    cb = ContinuousBatcher(engine, capacity=2)
    try:
        got = cb.submit({"tokens": p}, 10, eos_id=eos).result(timeout=120)["tokens"][0]
        assert got[-1] == eos and len(got) <= 5
        np.testing.assert_array_equal(got, toks[: len(got)])
    finally:
        cb.shutdown()


# ------------------------------------------------------- the port against JAX

# The JAX paged route in bf16, run in a process of its own with XLA's excess
# precision off (as tests/test_torch_serving.py does), so that bf16 rounds
# where the code says in both packages. (fp32 agreement of the same
# functions is held by the kernels' plain versions against the Pallas
# kernels at 2e-5, tests/test_torch_paged.py, and by paged == dense here.) A: admitted by prefill_paged (dense
# prefill, then the scatter into pages); C: by chunked prefill in 3 chunks
# of 4; then 4 batched decode steps of [A, C], teacher-forced.
JAX_PAGED = """
import os, pickle, sys
os.nice(10)  # yield the CPU to the suite's timing-sensitive tests running beside it
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_arch, reduced_config
from repro.core import FusionPolicy, TinyJaxBackend
from repro.models.model import build_model
from repro.serving.engine import ServingEngine

out = sys.argv[1]
seqs = np.load(out + ".tokens.npy")
cfg = reduced_config(get_arch("llama3.2-1b"))
model = build_model(cfg)
params = jax.tree.map(lambda x: x.astype(jnp.bfloat16), model.init(jax.random.PRNGKey(0)))
platform = TinyJaxBackend(FusionPolicy(enabled=False))
try:
    engine = ServingEngine(model, platform, max_len=64, params=params, kv_pages=16, kv_page_size=16)
    arena = engine.arena
    la, _ = engine.prefill_paged("A", {"tokens": jnp.asarray(seqs[0:1, :10])})
    job = engine.begin_prefill_paged("C", {"tokens": jnp.asarray(seqs[1:2, :12])})
    lc = None
    while lc is None:
        lc = engine.prefill_chunk_paged(job, 4)
    got, rows = [np.asarray(la), np.asarray(lc)], []
    cur = np.asarray([10, 12], np.int32)
    for i in range(4):
        for sid, c in zip("AC", cur):
            arena.extend(sid, int(c) + 1)
        bt = np.stack([arena.block_row(s, engine.block_width) for s in "AC"])
        tok = np.stack([seqs[0, 10 + i], seqs[1, 12 + i]]).astype(np.int32)[:, None]
        got.append(np.asarray(engine.paged_decode_step(jnp.asarray(tok), cur, bt)))
        rows.append(bt)
        cur = cur + 1
finally:
    platform.shutdown()
with open(out, "wb") as f:
    pickle.dump({"params": jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), params),
                 "logits": got, "rows": rows}, f)
"""
SEQS = np.random.default_rng(19).integers(0, 256, (2, 17)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_paged_logits(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_paged") / "logits.pkl"
    np.save(f"{out}.tokens.npy", SEQS)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false").strip())
    proc = subprocess.run([sys.executable, "-c", JAX_PAGED, str(out)], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def test_paged_logits_match_jax_engine(jax_paged_logits):
    """The same bf16 weights (JAX's, bridged), prompts, block tables and
    teacher-forced tokens through both packages' paged routes: first-token
    logits of a scattered and of a chunked prefill, then 4 batched decode
    steps, within 2e-2 of max |logit|."""
    ref = jax_paged_logits
    cfg = reduced_config(get_arch(ARCH))
    model = build_model(cfg)
    params = params_from_numpy(ref["params"], model.param_defs, dtype=torch.bfloat16, device=CPU)
    platform = TinyTorchBackend(FusionPolicy(enabled=False))
    try:
        engine = ServingEngine(model, platform, max_len=64, params=params, device=CPU,
                               kv_pages=16, kv_page_size=16)
        arena = engine.arena
        la, _ = engine.prefill_paged("A", {"tokens": SEQS[0:1, :10]})
        job = engine.begin_prefill_paged("C", {"tokens": SEQS[1:2, :12]})
        lc = None
        while lc is None:
            lc = engine.prefill_chunk_paged(job, 4)
        got = [la, lc]
        cur = np.asarray([10, 12], np.int32)
        for i in range(4):
            for sid, c in zip("AC", cur):
                arena.extend(sid, int(c) + 1)
            bt = np.stack([arena.block_row(s, engine.block_width) for s in "AC"])
            np.testing.assert_array_equal(bt, ref["rows"][i])  # the same block-table state
            tok = np.stack([SEQS[0, 10 + i], SEQS[1, 12 + i]]).astype(np.int32)[:, None]
            got.append(engine.paged_decode_step(tok, cur, bt))
            cur = cur + 1
    finally:
        platform.shutdown()
    assert len(got) == len(ref["logits"]) == 6
    for t, j in zip(got, ref["logits"]):
        t = t.numpy()
        assert t.shape == j.shape and np.isfinite(t).all()
        assert np.abs(t - j).max() <= 2e-2 * np.abs(j).max()


def test_chip_smoke_paged_serve_phase_rehearsal_on_cpu():
    """chip_smoke.py's paged serve phase at a tiny size on the CPU: the same
    control flow and checks the card run makes, minus the kernel counts."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = reduced_config(get_arch(ARCH))
    out = smoke.paged_serve_phase(torch, CPU, cfg, prompt_lens=(5, 16, 30), n_requests=9, steps=6,
                                  max_len=64, capacity=4, prefix_len=16)
    assert out["live_instances"] == {"fused": 1, "unfused": 4}
    assert out["ram_bytes"]["fused"] < out["ram_bytes"]["unfused"]
    assert out["shared_hits"]["fused"] >= 3 and out["cow_copies"]["fused"] >= 1
    assert out["fused_vs_unfused_identical_requests"] == 9  # the same plain path on the host
    assert out["block_rel_err"] == [0.0] * cfg.num_layers
    assert out["launches"]["fused"] == {"paged_decode_attention": 0, "paged_chunk_attention": 0}
    assert out["plain_calls"]["fused"]["paged_chunk_attn_ref"] > 0
