"""The port's provlint entry point (``python -m repro_torch.analysis.lint``):
clean over ``src/repro_torch`` and ``tests/test_torch_*.py``, and each of the
port's own passes still reports the reference's bad fixtures
(``tests/fixtures/provlint``) at their exact lines."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.analysis import clocklint, lockcheck, lockorder  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "provlint"


def findings(pass_mod, name, checker="check_source"):
    src = (FIXTURES / name).read_text(encoding="utf-8")
    return {(f.pass_name, f.line) for f in getattr(pass_mod, checker)(src, name)}


def test_lint_entry_point_exits_zero_over_the_port(tmp_path):
    out = tmp_path / "report.json"
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint", "--root", str(REPO),
                           "--json", str(out)], capture_output=True, text=True, cwd=REPO,
                          env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(out.read_text())
    assert report["ok"] and report["findings"] == []


def test_the_scan_covers_the_port_and_its_tests_only(monkeypatch):
    from repro_torch.analysis import lint

    seen = []
    monkeypatch.setattr(lint.lockcheck, "check_source", lambda src, rel: seen.append(rel) or [])
    monkeypatch.setattr(lint.clocklint, "check_test_source", lambda src, rel: seen.append(rel) or [])
    lint.collect_findings(REPO)
    assert "src/repro_torch/core/function.py" in seen and "tests/test_torch_scheduler.py" in seen
    assert not [p for p in seen if p.startswith("src/repro/") or p == "tests/test_scheduler.py"]


@pytest.mark.parametrize("pass_mod,fixture,checker,want", [
    (lockcheck, "bad_guarded_rmw.py", "check_source", {("lock-discipline", 20), ("lock-discipline", 24)}),
    (lockcheck, "bad_unlocked_policy.py", "check_source", {("lock-discipline", 14)}),
    (lockcheck, "bad_replica_cursor.py", "check_source", {("lock-discipline", 23), ("lock-discipline", 24)}),
    (lockorder, "bad_lock_order.py", "check_source", None),
    (clocklint, "bad_sleep_src.py", "check_source",
     {("clock-hygiene", 7), ("clock-hygiene", 8), ("clock-hygiene", 11)}),
    (clocklint, "bad_sleeping_test.py", "check_test_source", {("test-sleep", 6)}),
])
def test_each_pass_reports_the_reference_bad_fixtures(pass_mod, fixture, checker, want):
    got = findings(pass_mod, fixture, checker)
    if want is None:  # the cycle is anchored at one of its two nestings
        assert len(got) == 1 and got.pop() in {("lock-order", 14), ("lock-order", 19)}
    else:
        assert got == want


def test_good_fixtures_are_clean():
    assert findings(lockcheck, "good_guarded.py") == set()
    assert findings(lockorder, "good_guarded.py") == set()
    assert findings(clocklint, "good_test.py", "check_test_source") == set()


def test_delocking_the_launch_counters_is_caught():
    """The kernel launch counters are bumped from the scheduler's
    dispatchers and the merger's canary thread: stripping their lock is
    flagged at the bump."""
    path = "src/repro_torch/kernels/build.py"
    src = (REPO / path).read_text(encoding="utf-8")
    assert not lockcheck.check_source(src, path)
    bad = src.replace("        with self._lock:\n            self._eager[name] += 1\n",
                      "        self._eager[name] += 1\n")
    assert bad != src
    got = lockcheck.check_source(bad, path)
    assert got and all(f.pass_name == "lock-discipline" and "_eager" in f.message for f in got)


@pytest.mark.parametrize("path,locked,unlocked,field", [
    ("src/repro_torch/obs/trace.py",
     "            with self._lock:\n                self._buffers.append(buf)\n",
     "            self._buffers.append(buf)\n", "_buffers"),
    ("src/repro_torch/obs/critical_path.py",
     "        with self._lock:\n            self._edges[key] = self._ewma(self._edges.get(key), float(wait_s))\n",
     "        self._edges[key] = self._ewma(self._edges.get(key), float(wait_s))\n", "_edges"),
    ("src/repro_torch/analysis/dispatch.py",
     "            with self._mu:\n                self.decode_steps += 1\n",
     "            self.decode_steps += 1\n", "decode_steps"),
])
def test_delocking_the_tracing_modules_is_caught(path, locked, unlocked, field):
    """The tracing modules' GUARDED_FIELDS are checked: each is clean, and
    stripping the lock around one of its guarded fields is flagged."""
    from repro_torch.analysis import lint

    assert path in {str(p.relative_to(REPO)) for p in (REPO / "src" / "repro_torch").rglob("*.py")
                    if not lint._skip(p)}
    src = (REPO / path).read_text(encoding="utf-8")
    assert not lockcheck.check_source(src, path)
    bad = src.replace(locked, unlocked)
    assert bad != src
    got = lockcheck.check_source(bad, path)
    assert got and all(f.pass_name == "lock-discipline" and field in f.message for f in got)
