"""The share of the host-traced step's device idle time that the host's
waits on the device hold: idle gaps between device operations whose middle
lies inside one of the program's ``repro_torch.sync.*`` ranges, on any
thread of the host.  None where the host trace holds no
``repro_torch.train_step`` range (a program without spans)."""
from portbench.trace import _union

SYNC = "repro_torch.sync."
STEP = "repro_torch.train_step"


def read(ctx):
    t = ctx.trace
    if t is None or not t.host_ops or not any(e[0] == STEP for e in t.host):
        return None
    busy = _union([(s, s + d) for _, s, d in t.host_ops])
    gaps = [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:])]
    idle = sum(b - a for a, b in gaps)
    if idle <= 0:
        return None
    waits = [(s, e) for name, s, e, _ in t.host if name.startswith(SYNC)]
    held = sum(b - a for a, b in gaps if any(s <= (a + b) / 2 <= e for s, e in waits))
    return 100.0 * held / idle
