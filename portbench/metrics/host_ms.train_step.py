"""The host's enqueue of a train step: host ms in the program's
``repro_torch.train_step`` span less its ``repro_torch.sync.*`` spans, where
the host waited on the device."""
from portbench import spanread


def read(ctx):
    got = spanread.steps(ctx)
    if got is None:
        return None
    per_step = []
    for st in got:
        step = [s["host_ms"] for s in st["spans"] if s["name"] == "repro_torch.train_step"]
        if not step:
            return None
        waits = sum(s["host_ms"] for s in st["spans"] if s["name"].startswith("repro_torch.sync."))
        per_step.append(step[0] - waits)
    return sum(per_step) / len(per_step)
