"""The reference's KV arena fuzz and concurrency tests (``tests/test_kvpool.py``)
held against the port's ``repro_torch.serving.kvpool.KVArena``.

The port's arena writes its pages IN PLACE (ROADMAP "Deviations by design":
the JAX arena swaps in new arrays after each write), so its races are not
the reference's: where a reference test checks that a read-modify-write of
the whole array keeps both writers' pages, the port's test checks the page
data itself. Each threaded test joins every thread with a timeout and fails
on it; none sleeps on the wall clock."""
import functools
import importlib.util
import random
import signal
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # the suite runs several workers at once: leave them cores

import jax.numpy as jnp  # noqa: E402

from repro.serving.kvpool import ArenaFull as JaxArenaFull  # noqa: E402
from repro.serving.kvpool import KVArena as JaxArena  # noqa: E402
from repro_torch.serving.kvpool import ArenaFull, KVArena  # noqa: E402

CPU = torch.device("cpu")
JOIN_S = 30.0  # every thread of a test must have finished within this
ROOT = Path(__file__).resolve().parents[1]


def make_arena(num_pages=16, page=8, stages=None, cls=KVArena):
    return cls(stages or {"g0": 2, "g1": 2}, num_pages=num_pages, page_size=page, kv_heads=2, head_dim=4,
               dtype=torch.float32, device=CPU)


def make_jax_arena(num_pages=16, page=8, stages=None):
    return JaxArena(stages or {"g0": 2, "g1": 2}, num_pages=num_pages, page_size=page, kv_heads=2, head_dim=4,
                    dtype=jnp.float32)


def time_limit(seconds: float):
    """The test's own time limit: past ``seconds`` it fails with a
    TimeoutError (a SIGALRM in the test's thread interrupts any join or
    wait), so that a deadlock fails the test instead of hanging the run."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            def expire(signum, frame):
                raise TimeoutError(f"{fn.__name__} ran past its {seconds} s limit")

            prev = signal.signal(signal.SIGALRM, expire)
            signal.setitimer(signal.ITIMER_REAL, seconds)
            try:
                return fn(*args, **kw)
            finally:
                signal.setitimer(signal.ITIMER_REAL, 0)
                signal.signal(signal.SIGALRM, prev)
        return run
    return deco


def run_threads(targets, timeout=JOIN_S):
    """Start one thread per callable, join each with ``timeout``; a thread
    still alive fails the test (it does not hang it)."""
    threads = [threading.Thread(target=t, daemon=True) for t in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
        assert not t.is_alive(), f"a thread did not finish within {timeout} s"


def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------------ the seeded fuzz


def bookkeeping(arena, live) -> tuple:
    return (arena.used_pages(), arena.free_pages(),
            {sid: (arena.pages_held(sid), arena.shared_pages(sid), arena.seq_len(sid)) for sid in live})


@time_limit(60)
@pytest.mark.parametrize("mix", ["reference", "prefix sharing"])
def test_alloc_extend_free_fuzz_no_double_use_no_leak_and_the_references_bookkeeping(mix):
    """``tests/test_kvpool.py:64``: a seeded 600-op alloc / extend / free
    storm; after every op the arena is consistent (every page in exactly one
    place, rows cover lengths, page 0 never handed out) and nothing leaks at
    the end. Single-threaded and seeded, so the same op sequence also runs
    on the JAX package's arena: every op returns the same pages (or raises
    ArenaFull in both) and after every op ``used_pages``, ``free_pages`` and
    each live sequence's ``pages_held``, ``shared_pages`` and length agree.
    The "prefix sharing" mix adds content-aware ``alloc_prefill`` +
    ``commit_prefill`` of a small prompt pool and ``make_private``, so that
    pages are shared, resurrected off the free list and copied on write."""
    rng = random.Random(1234)
    a, j = make_arena(num_pages=24, page=4), make_jax_arena(num_pages=24, page=4)
    prompts = [np.arange(s, s + n, dtype=np.int64) for s, n in [(0, 9), (0, 12), (100, 6), (100, 17), (200, 4)]]
    live: dict[int, int] = {}  # seq -> len
    next_id = 0
    for _ in range(600):
        op = rng.random()
        if op < 0.4 and len(live) < 10:
            sid = next_id
            next_id += 1
            if mix == "prefix sharing" and rng.random() < 0.5:
                prompt = rng.choice(prompts)
                try:
                    got = a.alloc_prefill(sid, prompt)
                except ArenaFull:
                    with pytest.raises(JaxArenaFull):
                        j.alloc_prefill(sid, prompt)
                    continue
                assert j.alloc_prefill(sid, prompt) == got
                a.commit_prefill(sid)
                j.commit_prefill(sid)
                live[sid] = len(prompt)
            else:
                length = rng.randint(1, 40)
                try:
                    got = a.alloc(sid, length)
                    live[sid] = length
                except ArenaFull:
                    assert a.free_pages() < a.pages_for(length)
                    with pytest.raises(JaxArenaFull):
                        j.alloc(sid, length)
                else:
                    assert j.alloc(sid, length) == got
        elif op < 0.75 and live:
            sid = rng.choice(list(live))
            new_len = live[sid] + rng.randint(1, 12)
            try:
                got = a.extend(sid, new_len)
                live[sid] = new_len
            except ArenaFull:
                with pytest.raises(JaxArenaFull):
                    j.extend(sid, new_len)
            else:
                assert j.extend(sid, new_len) == got
        elif mix == "prefix sharing" and op < 0.85 and live:
            sid = rng.choice(list(live))
            try:
                got = a.make_private(sid, live[sid] - 1)
            except ArenaFull:
                with pytest.raises(JaxArenaFull):
                    j.make_private(sid, live[sid] - 1)
            else:
                assert j.make_private(sid, live[sid] - 1) == got
        elif live:
            sid = rng.choice(list(live))
            freed = a.free(sid)
            assert freed == a.pages_for(live.pop(sid)) == j.free(sid)
        a.check_consistency()
        assert bookkeeping(a, live) == bookkeeping(j, live)
        for sid in live:
            assert list(a.block_row(sid, a.num_pages)) == list(j.block_row(sid, j.num_pages))
    for sid in list(live):
        assert a.free(sid) == j.free(sid)
    a.check_consistency()
    assert a.used_pages() == 0 == j.used_pages()
    assert a.free_pages() == a.num_pages - 1 == j.free_pages()  # page 0 reserved, all else free


# ------------------------------------------------------------------ concurrency


@time_limit(60)
def test_write_prefill_concurrent_keeps_both_sequences():
    """``tests/test_kvpool.py:151``: two concurrent prefills into the same
    stage must both land. The reference's fault was a read-modify-write of
    the whole array; the port scatters each prefill into its own pages in
    place, so both threads start together (a barrier) and every read of the
    stage's page tensors during a write is made under ``_data_lock`` (the
    stage dict records it); then both sequences' data gather back."""
    a = make_arena(num_pages=12, page=8, stages={"g0": 2})
    a.alloc("s1", 8)
    a.alloc("s2", 8)
    unlocked = []

    class Watched(dict):
        def __getitem__(self, key):
            if not a._data_lock.locked():
                unlocked.append(key)
            return super().__getitem__(key)

    a.data["g0"] = Watched(a.data["g0"])
    src1 = torch.full((2, 1, 8, 2, 4), 3.0)
    src2 = torch.full((2, 1, 8, 2, 4), 5.0)
    start = threading.Barrier(2)
    errs = []

    def write(sid, src):
        def run():
            try:
                start.wait(timeout=JOIN_S)
                a.write_prefill(sid, {"g0": {"k": src, "v": -src}}, 8)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errs.append(e)
        return run

    run_threads([write("s1", src1), write("s2", src2)])
    a.data["g0"] = dict(a.data["g0"])
    assert not errs and not unlocked
    for sid, src in (("s1", src1), ("s2", src2)):
        got = a.gather(sid, "g0")
        assert torch.equal(got["k"], src[:, 0]) and torch.equal(got["v"], -src[:, 0])
    a.check_consistency()


class _RacingExtendArena(KVArena):
    """A concurrent extend landing between a seq_len read and the page-list
    read (``tests/test_kvpool.py:170``): a gather that took its width from
    ``seq_len`` and re-read the pages under a second lock acquisition would
    raise a spurious ValueError."""

    def seq_len(self, seq_id):
        n = super().seq_len(seq_id)
        if n and seq_id in self._held:
            super().extend(seq_id, n + self.page_size)
        return n


def test_gather_width_snapshot_atomic_with_extend():
    """``tests/test_kvpool.py:192``."""
    a = make_arena(num_pages=16, page=8, stages={"g0": 2}, cls=_RacingExtendArena)
    a.alloc("s", 19)  # 3 pages
    got = a.gather("s", "g0")  # must not raise, must cover the 3-page snapshot
    assert got["k"].shape[1] == 3 * 8
    a.check_consistency()


class _HookedLock:
    """A lock that runs ``hook()`` before the first acquire (any later
    acquire, and every acquire from another thread, passes straight
    through), and sets ``waiting`` when a thread other than ``owner`` is
    about to block on it."""

    def __init__(self, inner, owner=None, hook=None):
        self._inner, self.owner, self.hook = inner, owner, hook
        self.waiting = threading.Event()

    def acquire(self, blocking=True, timeout=-1):
        if self.hook is not None and threading.get_ident() == self.owner:
            hook, self.hook = self.hook, None
            hook()
        elif threading.get_ident() != self.owner:
            self.waiting.set()
        return self._inner.acquire(blocking, timeout)

    def release(self):
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


@time_limit(60)
def test_copy_on_write_copies_the_page_before_a_co_holder_can_reuse_it():
    """A fault the sharing fuzz below can reach, forced here: ``make_private``
    (``tests/test_kvpool.py:241``, copy-on-write) of a page two sequences
    share hands this sequence a fresh page and drops its reference to the
    shared one; the other holder may then free it, and a new sequence may
    be given that page and write its own prefill there. The copy must have
    read the shared page first: here the other holder's free, the new
    sequence's allocation and its prefill are started from inside
    ``make_private``, at its first acquire of the data lock, and run as far
    as the arena lets them before the copy is made (to their end, or until
    they block on the allocator lock). B's pages must then still hold the
    prompt's data, and C's its own."""
    a = make_arena(num_pages=4, page=4, stages={"g0": 1})  # 3 usable pages
    prompt = np.arange(1, 9)  # two full pages
    vals = torch.tensor([float(t + 1000 * p) for p, t in enumerate(prompt)])
    src = vals[None, None, :, None, None].expand(1, 1, 8, 2, 4)
    a.alloc_prefill("A", prompt)
    a.write_prefill("A", {"g0": {"k": src, "v": -src}}, 8)
    a.commit_prefill("A")
    _, cached = a.alloc_prefill("B", prompt)
    a.commit_prefill("B")
    assert cached == 8 and a.free_pages() == 1
    other = {}
    done = threading.Event()

    def newcomer():
        try:
            a.free("A")
            other["pages"] = a.alloc("C", 4)
            c = torch.full((1, 1, 4, 2, 4), 99.0)
            a.write_prefill("C", {"g0": {"k": c, "v": -c}}, 4)
        except BaseException as e:  # noqa: BLE001 — surfaced below
            other["error"] = e
        finally:
            done.set()

    helper = threading.Thread(target=newcomer, daemon=True)
    alloc_lock = _HookedLock(a._lock, owner=threading.get_ident())

    def start_newcomer():
        helper.start()
        # visible state, no grace period: the newcomer finished, or it waits
        # on the allocator lock that make_private holds
        while not (done.wait(timeout=0.01) or alloc_lock.waiting.is_set()):
            assert helper.is_alive()

    a._lock = alloc_lock
    a._data_lock = _HookedLock(a._data_lock, owner=threading.get_ident(), hook=start_newcomer)
    assert a.make_private("B", 7) is True
    helper.join(timeout=JOIN_S)
    assert not helper.is_alive() and "error" not in other
    a._lock, a._data_lock = a._lock._inner, a._data_lock._inner
    got = a.gather("B", "g0")
    assert torch.equal(got["k"][0, :, 0, 0], vals), got["k"][0, :, 0, 0]
    assert torch.equal(got["v"][0, :, 0, 0], -vals)
    assert torch.equal(a.gather("C", "g0")["k"], torch.full((1, 4, 2, 4), 99.0))
    a.check_consistency()


@time_limit(120)
def test_concurrent_sharing_fuzz_keeps_the_bookkeeping_and_the_data():
    """``tests/test_kvpool.py:296``: three threads storm the arena with the
    full op mix (content-aware alloc over a shared prompt pool,
    write_prefill, extend, gather, make_private, free) for three rounds,
    its locks made under ``patched_locks``; after every round the arena is
    consistent and the lock graph acyclic, and no page is left held. The
    port writes pages in place, so the storm also writes decode rows
    (``make_private`` first, as the batcher does) and checks the data: each
    live sequence's gathered K/V equals what a single-threaded replay of its
    own writes gives (``chip_smoke.kvpool_stress``, which the card runs on
    CUDA pools)."""
    out = smoke().kvpool_stress(torch, CPU)
    assert out["rounds"] == 3 and out["positions_verified"] > 0
    assert out["cow_copies"] > 0 and out["shared_hits"] > 0
