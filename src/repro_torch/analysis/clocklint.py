"""Clock-and-sleep hygiene lint.

Two rules, both protecting the deterministic-simulation story and the
tier-1 wall-clock budget:

Source rule (``src/repro_torch``): every timed primitive goes through the
injectable :class:`~repro_torch.scheduler.clock.SystemClock`. Direct calls to
``time.time`` / ``time.monotonic`` / ``time.sleep`` and waits on
``threading.Condition`` objects (``.wait`` / ``.wait_for``) are banned
everywhere except ``scheduler/clock.py``, which is the one sanctioned
shim over the real clock. ``time.perf_counter`` is allowed — it is a
duration probe, not a scheduling decision, and virtual-clock runs do not
need to control it.

Test rule (``tests/``): a test function that calls ``time.sleep`` with a
literal ≥ 0.25 s must carry ``@pytest.mark.slow`` (directly or via module
``pytestmark``) so tier-1 CI's wall-clock budget is not silently eroded.

Either rule can be waived per-line with a ``provlint: ok`` comment.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.findings import Finding, waived

PASS_CLOCK = "clock-hygiene"
PASS_SLEEP = "test-sleep"

#: time.<fn> calls banned outside scheduler/clock.py. perf_counter is allowed.
BANNED_TIME_FNS = {"time", "monotonic", "sleep"}

#: literal sleeps at or above this (seconds) require @pytest.mark.slow
TEST_SLEEP_THRESHOLD_S = 0.25

_CLOCK_EXEMPT_SUFFIXES = ("scheduler/clock.py",)


def _is_exempt(path: str) -> bool:
    norm = path.replace("\\", "/")
    return any(norm.endswith(sfx) for sfx in _CLOCK_EXEMPT_SUFFIXES)


def _time_aliases(tree: ast.Module) -> tuple[set[str], dict[str, str]]:
    """(module aliases of ``time``, {local name: time fn} from-imports)."""
    mod_aliases: set[str] = set()
    fn_aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "time":
                    mod_aliases.add(a.asname or "time")
        elif isinstance(node, ast.ImportFrom) and node.module == "time":
            for a in node.names:
                fn_aliases[a.asname or a.name] = a.name
    return mod_aliases, fn_aliases


def _condition_receivers(tree: ast.Module) -> set[str]:
    """Names/attr-paths assigned from ``threading.Condition(...)``.

    Tracks ``self._cv = threading.Condition(...)`` (-> ``self._cv``) and
    ``cv = threading.Condition(...)`` (-> ``cv``) so ``<recv>.wait()`` can
    be distinguished from unrelated ``.wait()`` methods (Event.wait,
    Thread.join-style helpers), which are fine.
    """
    recv: set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        val = node.value
        if not (isinstance(val, ast.Call) and isinstance(val.func, ast.Attribute)
                and val.func.attr == "Condition"):
            continue
        for tgt in node.targets:
            dotted = _dotted(tgt)
            if dotted:
                recv.add(dotted)
    return recv


def _dotted(node: ast.AST) -> str | None:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def check_source(source: str, path: str) -> list[Finding]:
    """Clock-hygiene findings for one src module."""
    if _is_exempt(path):
        return []
    try:
        tree = ast.parse(source)
    except SyntaxError as exc:
        return [Finding(PASS_CLOCK, path, exc.lineno or 1, f"syntax error: {exc.msg}")]
    lines = source.splitlines()
    mod_aliases, fn_aliases = _time_aliases(tree)
    cond_recv = _condition_receivers(tree)
    findings: list[Finding] = []

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        banned: str | None = None
        if isinstance(func, ast.Attribute):
            base = _dotted(func.value)
            if base in mod_aliases and func.attr in BANNED_TIME_FNS:
                banned = f"time.{func.attr}"
            elif func.attr in ("wait", "wait_for") and base in cond_recv:
                banned = f"Condition.{func.attr} (on {base})"
        elif isinstance(func, ast.Name) and func.id in fn_aliases:
            if fn_aliases[func.id] in BANNED_TIME_FNS:
                banned = f"time.{fn_aliases[func.id]}"
        if banned and not waived(lines, node.lineno):
            findings.append(Finding(
                PASS_CLOCK, path, node.lineno,
                f"{banned} outside scheduler/clock.py — route timing through "
                f"the injectable Clock",
            ))
    return findings


# --------------------------------------------------------------------------
# test-sleep rule
# --------------------------------------------------------------------------


def _is_slow_mark(expr: ast.AST) -> bool:
    """True for ``pytest.mark.slow`` / ``mark.slow`` expressions."""
    dotted = _dotted(expr)
    return bool(dotted) and dotted.endswith("mark.slow")


def _module_is_slow(tree: ast.Module) -> bool:
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == "pytestmark":
                    vals = (node.value.elts
                            if isinstance(node.value, (ast.List, ast.Tuple))
                            else [node.value])
                    if any(_is_slow_mark(v) for v in vals):
                        return True
    return False


def _literal_seconds(call: ast.Call) -> float | None:
    if call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, (int, float)):
        return float(call.args[0].value)
    return None


def check_test_source(source: str, path: str) -> list[Finding]:
    """Test-sleep findings for one test module."""
    try:
        tree = ast.parse(source)
    except SyntaxError as exc:
        return [Finding(PASS_SLEEP, path, exc.lineno or 1, f"syntax error: {exc.msg}")]
    lines = source.splitlines()
    mod_aliases, fn_aliases = _time_aliases(tree)
    if _module_is_slow(tree):
        return []
    findings: list[Finding] = []

    def is_sleep(call: ast.Call) -> bool:
        func = call.func
        if isinstance(func, ast.Attribute) and func.attr == "sleep":
            return _dotted(func.value) in mod_aliases
        if isinstance(func, ast.Name):
            return fn_aliases.get(func.id) == "sleep"
        return False

    for node in tree.body:
        if not isinstance(node, ast.FunctionDef) or not node.name.startswith("test"):
            continue
        if any(_is_slow_mark(d) for d in node.decorator_list):
            continue
        # nested helper defs inside the test count — they run in the test
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and is_sleep(sub):
                secs = _literal_seconds(sub)
                if secs is not None and secs >= TEST_SLEEP_THRESHOLD_S \
                        and not waived(lines, sub.lineno):
                    findings.append(Finding(
                        PASS_SLEEP, path, sub.lineno,
                        f"test '{node.name}' sleeps {secs:g}s without "
                        f"@pytest.mark.slow — mark it slow or shrink the sleep",
                    ))
    return findings


def check_file(path) -> list[Finding]:
    with open(path, encoding="utf-8") as f:
        return check_source(f.read(), str(path))


def check_test_file(path) -> list[Finding]:
    with open(path, encoding="utf-8") as f:
        return check_test_source(f.read(), str(path))
