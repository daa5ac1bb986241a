"""provlint CLI: run all static passes over the repo and report.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis.lint [--root DIR] [--json OUT]

Passes and scopes:

* ``lock-discipline`` + ``lock-order`` — every module under
  ``src/repro_torch``
* ``clock-hygiene`` — every module under ``src/repro_torch`` except
  ``scheduler/clock.py``
* ``test-sleep`` — every ``test_torch_*.py`` under ``tests/`` (the
  port's own tests; the JAX package's tests are ``repro.analysis.lint``'s)

Fixture snippets (any path containing a ``fixtures`` component) are
skipped — they are *intentionally* bad and are exercised by
``tests/test_torch_provlint.py`` instead. Exit status is the number of findings
clamped to 1, so CI can gate on it directly.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis import clocklint, lockcheck, lockorder
from repro_torch.analysis.findings import Finding


def _skip(path: Path) -> bool:
    return "fixtures" in path.parts or "__pycache__" in path.parts


def collect_findings(root: Path) -> list[Finding]:
    findings: list[Finding] = []
    src = root / "src" / "repro_torch"
    tests = root / "tests"
    for path in sorted(src.rglob("*.py")):
        if _skip(path):
            continue
        rel = str(path.relative_to(root))
        source = path.read_text(encoding="utf-8")
        findings += lockcheck.check_source(source, rel)
        findings += lockorder.check_source(source, rel)
        findings += clocklint.check_source(source, rel)
    if tests.is_dir():
        for path in sorted(tests.glob("test_torch_*.py")):
            if _skip(path):
                continue
            rel = str(path.relative_to(root))
            findings += clocklint.check_test_source(
                path.read_text(encoding="utf-8"), rel)
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.analysis.lint", description=__doc__)
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[3],
                    help="repo root (default: inferred from this file)")
    ap.add_argument("--json", type=Path, default=None, metavar="OUT",
                    help="write machine-readable report to OUT")
    args = ap.parse_args(argv)

    findings = collect_findings(args.root)
    for f in findings:
        print(f, file=sys.stderr)
    report = {
        "root": str(args.root),
        "findings": [f.to_dict() for f in findings],
        "counts": _counts(findings),
        "ok": not findings,
    }
    if args.json:
        args.json.write_text(json.dumps(report, indent=2) + "\n", encoding="utf-8")
    print(f"provlint: {len(findings)} finding(s) "
          f"({', '.join(f'{k}={v}' for k, v in report['counts'].items()) or 'clean'})")
    return 1 if findings else 0


def _counts(findings: list[Finding]) -> dict[str, int]:
    out: dict[str, int] = {}
    for f in findings:
        out[f.pass_name] = out.get(f.pass_name, 0) + 1
    return out


if __name__ == "__main__":
    raise SystemExit(main())
