"""Lock-discipline AST pass.

Walks every class that declares ``GUARDED_FIELDS`` / ``GUARDED_WRITES`` or
``@guarded_by`` methods (see :mod:`repro_torch.analysis.guards`) and flags any
access of a guarded field — or call of a guarded method — that is not
dominated by a ``with self.<lock>:`` block holding the declared lock.

What the pass understands:

* ``with self._lock:`` (including multi-item ``with a, b:``) adds the lock
  to the held set for the block's body;
* ``self._cond = threading.Condition(self._lock)`` in ``__init__`` /
  ``__post_init__`` aliases the two names to ONE lock — holding either
  counts as holding both (the scheduler's ``_lock``/``_cond`` pair);
* ``@guarded_by("_lock")`` methods run with the lock held by caller
  contract, and calling one without holding the lock is a violation;
* write-guarded fields (``GUARDED_WRITES``) track simple local aliases —
  ``dst = self.data[stage]`` followed by ``dst[kv] = ...`` outside the
  lock is the shape of a ``write_prefill`` race and is flagged as a write
  to the field;
* nested ``def`` / ``lambda`` bodies are NOT analyzed (a closure's call
  site, not its definition site, determines what is held — flagging them
  here would be noise).

``__init__`` / ``__post_init__`` / ``__del__`` are exempt: construction
and finalization happen before/after the object is shared.
"""
from __future__ import annotations

import ast
import dataclasses

from repro_torch.analysis.findings import Finding, waived

PASS = "lock-discipline"

_EXEMPT_METHODS = {"__init__", "__post_init__", "__del__"}


def _is_self_attr(node) -> str | None:
    """'F' when node is ``self.F``, else None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _literal_str_dict(node) -> dict[str, str] | None:
    if not isinstance(node, ast.Dict):
        return None
    out: dict[str, str] = {}
    for k, v in zip(node.keys, node.values):
        if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
            return None
        if not (isinstance(v, ast.Constant) and isinstance(v.value, str)):
            return None
        out[k.value] = v.value
    return out


def _guarded_by_decorator(dec) -> str | None:
    """Lock name when the decorator is ``guarded_by("...")`` (possibly
    attribute-qualified), else None."""
    if not (isinstance(dec, ast.Call) and dec.args):
        return None
    fn = dec.func
    name = fn.id if isinstance(fn, ast.Name) else (fn.attr if isinstance(fn, ast.Attribute) else None)
    if name != "guarded_by":
        return None
    arg = dec.args[0]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    return None


@dataclasses.dataclass
class ClassInfo:
    name: str
    node: ast.ClassDef
    guarded: dict[str, str]        # field -> lock (reads + writes)
    write_guarded: dict[str, str]  # field -> lock (writes only)
    lock_aliases: dict[str, str]   # cond attr -> underlying lock attr
    guarded_methods: dict[str, str]  # method -> required lock

    def canon(self, lock: str) -> str:
        seen = set()
        while lock in self.lock_aliases and lock not in seen:
            seen.add(lock)
            lock = self.lock_aliases[lock]
        return lock

    @property
    def annotated(self) -> bool:
        return bool(self.guarded or self.write_guarded or self.guarded_methods)


def collect_classes(tree: ast.Module) -> list[ClassInfo]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        guarded: dict[str, str] = {}
        write_guarded: dict[str, str] = {}
        aliases: dict[str, str] = {}
        methods: dict[str, str] = {}
        for stmt in node.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                tgt = stmt.targets[0]
                if isinstance(tgt, ast.Name):
                    if tgt.id == "GUARDED_FIELDS":
                        guarded.update(_literal_str_dict(stmt.value) or {})
                    elif tgt.id == "GUARDED_WRITES":
                        write_guarded.update(_literal_str_dict(stmt.value) or {})
            if isinstance(stmt, ast.FunctionDef):
                for dec in stmt.decorator_list:
                    lock = _guarded_by_decorator(dec)
                    if lock is not None:
                        methods[stmt.name] = lock
                if stmt.name in _EXEMPT_METHODS:
                    # condition-over-lock aliases declared at construction
                    for sub in ast.walk(stmt):
                        if not (isinstance(sub, ast.Assign) and len(sub.targets) == 1):
                            continue
                        tgt_attr = _is_self_attr(sub.targets[0])
                        if tgt_attr is None or not isinstance(sub.value, ast.Call):
                            continue
                        call = sub.value
                        fn = call.func
                        is_cond = (
                            isinstance(fn, ast.Attribute) and fn.attr == "Condition"
                        ) or (isinstance(fn, ast.Name) and fn.id == "Condition")
                        if is_cond and call.args:
                            src_attr = _is_self_attr(call.args[0])
                            if src_attr is not None:
                                aliases[tgt_attr] = src_attr
        out.append(ClassInfo(node.name, node, guarded, write_guarded, aliases, methods))
    return out


class _MethodChecker:
    def __init__(self, cls: ClassInfo, method: ast.FunctionDef, path: str,
                 lines: list[str], findings: list[Finding]):
        self.cls = cls
        self.method = method
        self.path = path
        self.lines = lines
        self.findings = findings
        # local name -> write-guarded field it aliases (dst = self.data[...])
        self.aliases: dict[str, str] = {}

    # ------------------------------------------------------------- report

    def _report(self, node, kind: str, field: str, lock: str):
        if waived(self.lines, node.lineno):
            return
        self.findings.append(Finding(
            PASS, self.path, node.lineno,
            f"{self.cls.name}.{self.method.name}: {kind} '{field}' "
            f"(guarded by '{lock}') outside 'with self.{lock}'",
        ))

    def _held_ok(self, lock: str, held: frozenset) -> bool:
        return self.cls.canon(lock) in held

    # ------------------------------------------------------------- drive

    def run(self):
        held = frozenset()
        required = self.cls.guarded_methods.get(self.method.name)
        if required is not None:
            held = frozenset({self.cls.canon(required)})
        self._walk(self.method.body, held)

    def _walk(self, stmts, held: frozenset):
        for stmt in stmts:
            self._stmt(stmt, held)

    def _stmt(self, stmt, held: frozenset):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # closures/nested defs: held set at call time is unknown
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            new_held = set(held)
            for item in stmt.items:
                attr = _is_self_attr(item.context_expr)
                if attr is not None:
                    new_held.add(self.cls.canon(attr))
                else:
                    self._expr(item.context_expr, held)
            self._walk(stmt.body, frozenset(new_held))
            return
        if isinstance(stmt, ast.Assign):
            self._expr(stmt.value, held)
            for tgt in stmt.targets:
                self._target(tgt, held)
            self._track_alias(stmt, held)
            return
        if isinstance(stmt, ast.AugAssign):
            self._expr(stmt.value, held)
            self._target(stmt.target, held, aug=True)
            return
        if isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._expr(stmt.value, held)
            self._target(stmt.target, held)
            return
        if isinstance(stmt, ast.Delete):
            for tgt in stmt.targets:
                self._target(tgt, held)
            return
        if isinstance(stmt, ast.For):
            self._expr(stmt.iter, held)
            self._track_for_alias(stmt)
            self._walk(stmt.body, held)
            self._walk(stmt.orelse, held)
            return
        if isinstance(stmt, ast.While):
            self._expr(stmt.test, held)
            self._walk(stmt.body, held)
            self._walk(stmt.orelse, held)
            return
        if isinstance(stmt, ast.If):
            self._expr(stmt.test, held)
            self._walk(stmt.body, held)
            self._walk(stmt.orelse, held)
            return
        if isinstance(stmt, ast.Try):
            self._walk(stmt.body, held)
            for h in stmt.handlers:
                self._walk(h.body, held)
            self._walk(stmt.orelse, held)
            self._walk(stmt.finalbody, held)
            return
        if isinstance(stmt, (ast.Return, ast.Expr)):
            if stmt.value is not None:
                self._expr(stmt.value, held)
            return
        if isinstance(stmt, (ast.Raise, ast.Assert)):
            for sub in ast.iter_child_nodes(stmt):
                self._expr(sub, held)
            return
        # pass/break/continue/global/import/...: nothing guarded inside
        for sub in ast.iter_child_nodes(stmt):
            if isinstance(sub, ast.expr):
                self._expr(sub, held)

    # --------------------------------------------------------- alias track

    def _alias_root_field(self, expr) -> str | None:
        """Write-guarded field when expr derives from one by subscripts /
        attribute lookups / .values()-style calls, else None."""
        node = expr
        while True:
            if isinstance(node, ast.Subscript):
                node = node.value
            elif isinstance(node, ast.Call):
                node = node.func
            elif isinstance(node, ast.Attribute):
                attr = _is_self_attr(node)
                if attr is not None:
                    return attr if attr in self.cls.write_guarded else None
                node = node.value
            elif isinstance(node, ast.Name):
                return self.aliases.get(node.id)
            else:
                return None

    def _track_alias(self, stmt: ast.Assign, held: frozenset):
        if len(stmt.targets) != 1 or not isinstance(stmt.targets[0], ast.Name):
            return
        name = stmt.targets[0].id
        field = self._alias_root_field(stmt.value)
        if field is not None:
            self.aliases[name] = field
        else:
            self.aliases.pop(name, None)

    def _track_for_alias(self, stmt: ast.For):
        field = self._alias_root_field(stmt.iter)
        targets = [stmt.target] if isinstance(stmt.target, ast.Name) else (
            [e for e in getattr(stmt.target, "elts", []) if isinstance(e, ast.Name)]
        )
        for t in targets:
            if field is not None:
                self.aliases[t.id] = field
            else:
                self.aliases.pop(t.id, None)

    # ------------------------------------------------------------- targets

    def _target(self, tgt, held: frozenset, aug: bool = False):
        attr = _is_self_attr(tgt)
        if attr is not None:
            lock = self.cls.guarded.get(attr) or self.cls.write_guarded.get(attr)
            if lock is not None and not self._held_ok(lock, held):
                self._report(tgt, "write to", attr, lock)
            return
        if isinstance(tgt, ast.Subscript):
            # self.F[...] = v  or  alias[...] = v (alias of a write-guarded field)
            field = self._alias_root_field(tgt)
            if field is not None:
                lock = self.cls.write_guarded.get(field) or self.cls.guarded.get(field)
                if lock is not None and not self._held_ok(lock, held):
                    self._report(tgt, "write through", field, lock)
            # the subscript expression itself contains loads (index, value)
            self._expr(tgt.value, held)
            self._expr(tgt.slice, held)
            return
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for e in tgt.elts:
                self._target(e, held, aug=aug)
            return
        if isinstance(tgt, ast.Attribute):
            self._expr(tgt.value, held)

    # --------------------------------------------------------------- exprs

    def _expr(self, node, held: frozenset):
        if node is None or not isinstance(node, ast.AST):
            return
        if isinstance(node, (ast.Lambda, ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # closure body: call-time held set unknown
        attr = _is_self_attr(node)
        if attr is not None and isinstance(node.ctx, ast.Load):
            lock = self.cls.guarded.get(attr)
            if lock is not None and not self._held_ok(lock, held):
                self._report(node, "read of", attr, lock)
        if isinstance(node, ast.Call):
            fattr = _is_self_attr(node.func)
            if fattr is not None and fattr in self.cls.guarded_methods:
                lock = self.cls.guarded_methods[fattr]
                if not self._held_ok(lock, held):
                    if not waived(self.lines, node.lineno):
                        self.findings.append(Finding(
                            PASS, self.path, node.lineno,
                            f"{self.cls.name}.{self.method.name}: call of "
                            f"'{fattr}' (requires '{lock}' held) outside "
                            f"'with self.{lock}'",
                        ))
        for child in ast.iter_child_nodes(node):
            self._expr(child, held)


def check_source(source: str, path: str) -> list[Finding]:
    try:
        tree = ast.parse(source)
    except SyntaxError as exc:
        return [Finding(PASS, path, exc.lineno or 1, f"syntax error: {exc.msg}")]
    lines = source.splitlines()
    findings: list[Finding] = []
    for cls in collect_classes(tree):
        if not cls.annotated:
            continue
        for stmt in cls.node.body:
            if isinstance(stmt, ast.FunctionDef) and stmt.name not in _EXEMPT_METHODS:
                # skip methods without a `self` receiver (static/class methods)
                if stmt.args.args and stmt.args.args[0].arg == "self":
                    _MethodChecker(cls, stmt, path, lines, findings).run()
    return findings


def check_file(path) -> list[Finding]:
    with open(path, encoding="utf-8") as f:
        return check_source(f.read(), str(path))
