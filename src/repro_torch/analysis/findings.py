"""Shared finding record for every provlint pass.

A finding pins (pass name, file, line, message) — the tuple the fixture
tests assert on exactly, and the unit the JSON report serializes. Keeping
it dataclass-dumb means every pass stays a pure function from source text
to findings, trivially testable without touching the filesystem.
"""
from __future__ import annotations

import dataclasses


#: Substring that waives any provlint diagnostic on the line it appears on.
#: Use sparingly and leave the reason next to it, e.g.
#: ``time.sleep(0.5)  # provlint: ok — async drain is the scenario``.
WAIVER = "provlint: ok"


@dataclasses.dataclass(frozen=True)
class Finding:
    pass_name: str  # "lock-discipline" | "lock-order" | "clock-hygiene" | "test-sleep"
    path: str       # repo-relative where possible
    line: int       # 1-indexed
    message: str

    def to_dict(self) -> dict:
        return {
            "pass": self.pass_name,
            "path": self.path,
            "line": self.line,
            "message": self.message,
        }

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.pass_name}] {self.message}"


def waived(source_lines: list[str], lineno: int) -> bool:
    """True when the 1-indexed source line carries a waiver comment."""
    if 1 <= lineno <= len(source_lines):
        return WAIVER in source_lines[lineno - 1]
    return False
