"""What the per-layer readers take from the program's own spans and counters.

The program (``repro_torch.runtime.spans``) keeps its last train steps in
memory while a profiler records; a traced run's device stretch records its
first ``mix["traced"]["device"]`` steps, which are the steps these readers
average.  A program without those spans gives None.
"""
from __future__ import annotations


def _spans():
    try:
        from repro_torch.runtime import spans
    except ImportError:
        return None
    return spans


def steps(ctx):
    """The device stretch's recorded steps, or None where none were recorded."""
    spans = _spans()
    if spans is None:
        return None
    got = spans.steps()[: ctx.mix["traced"]["device"]]
    return got or None


def device_ms(ctx, names) -> float | None:
    """Device ms a step covered by spans named in ``names`` (every phase),
    each stretch of the step's device timeline counted once."""
    got = steps(ctx)
    if got is None:
        return None
    per_step = []
    for st in got:
        ivs = [iv for s in st["spans"] if s["name"] in names
               for iv in (s["device_intervals"] or ())]
        if not ivs:
            return None
        per_step.append(_spans().length(ivs))
    return sum(per_step) / len(per_step)
