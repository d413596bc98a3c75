"""The numbers that decide ``correct``, each set beside its limit.

Every number is a gap between what the program produced and what the plain
reference works out from the same inputs; a number that cannot be read (a
missing output, a shape that differs, a NaN) reads as infinite.
"""
from __future__ import annotations

import math
import statistics
import sys


def leaf_gaps(got: dict, want: dict, grad: dict) -> list[float]:
    """Each leaf's gap of norms, ``|got - want| / max(want, median leaf's
    want)``, over the leaves whose reference gradient norm ``grad`` is at
    least a thousandth of the median leaf's (the others move by round-off
    alone); a leaf the program lacks reads infinite."""
    med_grad = statistics.median(grad.values())
    med = statistics.median(want.values())
    gaps = []
    for k, w in want.items():
        if grad[k] < 1e-3 * med_grad:
            continue
        g = got.get(k)
        gaps.append(abs(g - w) / max(w, med) if g is not None and math.isfinite(g) else math.inf)
    return gaps


def worst(gaps: list[float]) -> float:
    return max(gaps, default=0.0)


def median(gaps: list[float]) -> float:
    """The median gap; infinite where any gap is."""
    return math.inf if math.inf in gaps else statistics.median(gaps)


def verdict(checks: dict) -> bool:
    return all(v <= lim for v, lim in checks.values())


def report(checks: dict) -> None:
    """Each number beside its limit, as the last lines on standard error."""
    for name, (v, lim) in checks.items():
        print(f"check {name} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}",
              file=sys.stderr)
