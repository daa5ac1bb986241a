"""Lock-discipline annotations, zero-cost at runtime.

``GUARDED_FIELDS`` — a plain class attribute mapping attribute name -> the
``self.<lock>`` attribute that must be held for ANY access from the class's
own methods. ``GUARDED_WRITES`` — the same, for writes only (unlocked reads
are allowed). ``@guarded_by("<lock>")`` marks a method whose CALLER must
already hold the lock (the ``_locked``-suffix contract made
machine-readable); the decorator only attaches metadata.
"""
from __future__ import annotations

GUARDED_BY_ATTR = "__guarded_by__"


def guarded_by(lock_name: str):
    """Declare that callers of this method must hold ``self.<lock_name>``."""

    def mark(fn):
        setattr(fn, GUARDED_BY_ATTR, lock_name)
        return fn

    return mark
