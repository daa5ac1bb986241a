"""Lock-order / deadlock analysis: static and dynamic halves.

Static half
-----------

Extracts, per class, the nested-``with self.<lock>`` acquisition graph:
an edge ``A -> B`` means some method acquires ``B`` while holding ``A``
(directly nested ``with``, or by calling a ``self`` method whose body
acquires ``B``). Condition-over-lock aliases (``Condition(self._lock)``)
collapse to one node, mirroring the lock-discipline pass. A cycle in the
graph is a potential ABBA deadlock and is reported as a finding anchored
at one participating acquisition site.

Dynamic half
------------

:class:`LockGraph` + :class:`InstrumentedLock` record the *observed*
acquisition order at runtime — including cross-class, cross-object edges
the static pass cannot see (scheduler lock -> lane cv, batcher cv ->
arena lock). Two ways to wire it:

* wrap specific locks after construction::

      g = LockGraph()
      arena._lock = InstrumentedLock(g, inner=arena._lock, name="KVArena._lock")

* or patch ``threading.Lock/RLock/Condition`` for a scope so every lock
  created inside is instrumented, named by its creation call site::

      with patched_locks(g):
          sched = RequestScheduler(...)   # all its locks now record edges
          ... run the fuzz round ...
      g.assert_acyclic()

The fuzz suites call ``assert_acyclic()`` every round, so any change that
inverts an acquisition order anywhere in the exercised paths fails the
existing randomized tests, not a future post-mortem.
"""
from __future__ import annotations

import ast
import sys
import threading
from contextlib import contextmanager

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.lockcheck import ClassInfo, _is_self_attr, collect_classes

PASS = "lock-order"


# --------------------------------------------------------------------------
# static pass
# --------------------------------------------------------------------------


def _method_lock_summary(cls: ClassInfo) -> dict[str, set[str]]:
    """method name -> set of (canonical) locks its body acquires anywhere."""
    out: dict[str, set[str]] = {}
    for stmt in cls.node.body:
        if not isinstance(stmt, ast.FunctionDef):
            continue
        acquired: set[str] = set()
        for sub in ast.walk(stmt):
            if isinstance(sub, (ast.With, ast.AsyncWith)):
                for item in sub.items:
                    attr = _is_self_attr(item.context_expr)
                    if attr is not None:
                        acquired.add(cls.canon(attr))
        req = cls.guarded_methods.get(stmt.name)
        if req is not None:
            acquired.add(cls.canon(req))
        out[stmt.name] = acquired
    return out


def _collect_edges(cls: ClassInfo, path: str):
    """Yield (src_lock_node, dst_lock_node, path, line) acquisition edges."""
    summaries = _method_lock_summary(cls)

    def node_name(lock: str) -> str:
        return f"{cls.name}.{lock}"

    def walk(stmts, held: tuple):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                new_held = list(held)
                for item in stmt.items:
                    attr = _is_self_attr(item.context_expr)
                    if attr is None:
                        continue
                    lock = cls.canon(attr)
                    for h in new_held:
                        if h != lock:
                            yield node_name(h), node_name(lock), path, stmt.lineno
                    new_held.append(lock)
                yield from walk(stmt.body, tuple(new_held))
                continue
            # calls to self methods while holding locks: one-level summary
            if held:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call):
                        fattr = _is_self_attr(sub.func)
                        if fattr is not None and fattr in summaries:
                            for lock in summaries[fattr]:
                                for h in held:
                                    if h != lock:
                                        yield node_name(h), node_name(lock), path, sub.lineno
            for field in ("body", "orelse", "finalbody"):
                sub_body = getattr(stmt, field, None)
                if isinstance(sub_body, list) and sub_body and isinstance(sub_body[0], ast.stmt):
                    yield from walk(sub_body, held)
            for h in getattr(stmt, "handlers", []):
                yield from walk(h.body, held)

    for stmt in cls.node.body:
        if isinstance(stmt, ast.FunctionDef):
            start = ()
            req = cls.guarded_methods.get(stmt.name)
            if req is not None:
                start = (cls.canon(req),)
            yield from walk(stmt.body, start)


def find_cycle(edges: dict[str, set[str]]):
    """One cycle as a node list ``[a, b, ..., a]``, or None."""
    WHITE, GREY, BLACK = 0, 1, 2
    color = {n: WHITE for n in edges}
    stack: list[str] = []

    def dfs(n):
        color[n] = GREY
        stack.append(n)
        for m in sorted(edges.get(n, ())):
            if color.get(m, WHITE) == GREY:
                return stack[stack.index(m):] + [m]
            if color.get(m, WHITE) == WHITE:
                got = dfs(m)
                if got:
                    return got
        stack.pop()
        color[n] = BLACK
        return None

    for n in sorted(edges):
        if color[n] == WHITE:
            got = dfs(n)
            if got:
                return got
    return None


def check_source(source: str, path: str) -> list[Finding]:
    """Static lock-order findings for one module (per-class graphs)."""
    try:
        tree = ast.parse(source)
    except SyntaxError as exc:
        return [Finding(PASS, path, exc.lineno or 1, f"syntax error: {exc.msg}")]
    findings: list[Finding] = []
    for cls in collect_classes(tree):
        graph: dict[str, set[str]] = {}
        sites: dict[tuple, tuple] = {}
        for a, b, p, line in _collect_edges(cls, path):
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
            sites.setdefault((a, b), (p, line))
        cycle = find_cycle(graph)
        if cycle:
            site = sites.get((cycle[0], cycle[1]), (path, cls.node.lineno))
            findings.append(Finding(
                PASS, site[0], site[1],
                f"{cls.name}: lock acquisition cycle {' -> '.join(cycle)} "
                f"(potential ABBA deadlock)",
            ))
    return findings


def check_file(path) -> list[Finding]:
    with open(path, encoding="utf-8") as f:
        return check_source(f.read(), str(path))


# --------------------------------------------------------------------------
# dynamic half
# --------------------------------------------------------------------------


class LockGraph:
    """Aggregated runtime lock-acquisition graph across all threads.

    Locks are aggregated by NAME (their creation site or an explicit
    wrapper name), so the graph stays small and an inversion between two
    instances of the same lock pair is still a cycle."""

    def __init__(self):
        self._mu = threading.Lock()
        self._edges: dict[str, set[str]] = {}
        self._tls = threading.local()

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def note_acquire(self, name: str) -> None:
        st = self._stack()
        if name in st:  # reentrant (RLock) or condition re-acquire: no edge
            st.append(name)
            return
        if st:
            with self._mu:
                for held in set(st):
                    if held != name:
                        self._edges.setdefault(held, set()).add(name)
                        self._edges.setdefault(name, set())
        else:
            with self._mu:
                self._edges.setdefault(name, set())
        st.append(name)

    def note_release(self, name: str) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] == name:
                del st[i]
                return

    def edges(self) -> dict[str, set[str]]:
        with self._mu:
            return {k: set(v) for k, v in self._edges.items()}

    def find_cycle(self):
        return find_cycle(self.edges())

    def assert_acyclic(self) -> None:
        cycle = self.find_cycle()
        if cycle:
            raise AssertionError(
                "lock acquisition cycle observed (potential ABBA deadlock): "
                + " -> ".join(cycle)
            )


class InstrumentedLock:
    """Lock wrapper recording acquisition order into a :class:`LockGraph`.

    Duck-types ``threading.Lock`` (acquire/release/context manager), so it
    can replace a plain lock attribute after construction, or serve as the
    underlying lock of a ``threading.Condition``."""

    def __init__(self, graph: LockGraph, inner=None, name: str | None = None,
                 reentrant: bool = False):
        self._graph = graph
        self._inner = inner if inner is not None else (
            threading._orig_rlock() if reentrant and hasattr(threading, "_orig_rlock")
            else _ORIG_RLOCK() if reentrant else _ORIG_LOCK()
        )
        self.name = name or f"lock@{id(self):x}"

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._graph.note_acquire(self.name)
        return got

    def release(self):
        self._graph.note_release(self.name)
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def _at_fork_reinit(self):  # pragma: no cover - fork support parity
        self._inner._at_fork_reinit()

    def __repr__(self):
        return f"<InstrumentedLock {self.name}>"


_ORIG_LOCK = threading.Lock
_ORIG_RLOCK = threading.RLock
_ORIG_COND = threading.Condition


def _creation_site() -> str:
    """'file.py:123' of the first frame outside this module / threading."""
    f = sys._getframe(2)
    skip = (__file__.rsplit("/", 1)[-1], "threading.py")
    while f is not None:
        fname = f.f_code.co_filename.rsplit("/", 1)[-1]
        if fname not in skip:
            return f"{fname}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>"


@contextmanager
def patched_locks(graph: LockGraph):
    """Patch ``threading.Lock/RLock/Condition`` so every lock constructed
    in the scope records its acquisition order into ``graph``, named by
    creation site. Locks created inside keep working after the scope ends
    (they hold their own references); only *construction* is patched."""

    def make_lock():
        return InstrumentedLock(graph, inner=_ORIG_LOCK(), name=_creation_site())

    def make_rlock():
        return InstrumentedLock(
            graph, inner=_ORIG_RLOCK(), name=_creation_site(), reentrant=True
        )

    def make_cond(lock=None):
        if lock is None:
            lock = InstrumentedLock(graph, inner=_ORIG_LOCK(), name=_creation_site())
        return _ORIG_COND(lock)

    threading.Lock = make_lock
    threading.RLock = make_rlock
    threading.Condition = make_cond
    try:
        yield graph
    finally:
        threading.Lock = _ORIG_LOCK
        threading.RLock = _ORIG_RLOCK
        threading.Condition = _ORIG_COND
