"""The experts' useful share: routed pairs kept over the capacity slots the
experts run (the program's counters ``moe.kept_pairs`` and ``moe.slots``,
summed over a step's MoE layers and microbatches, forward passes only)."""
from portbench import spanread


def read(ctx):
    got = spanread.steps(ctx)
    if got is None:
        return None
    kept = sum(st["counters"].get("moe.kept_pairs", 0) for st in got)
    slots = sum(st["counters"].get("moe.slots", 0) for st in got)
    return 100.0 * kept / slots if slots else None
