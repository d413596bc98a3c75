"""Readings that the limits of ``correct`` are set from, many seeds in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 101-112 \
        [--control 101-103] [--faults 101-103]

For each seed of ``--seeds`` it runs the cell's set-up as a run does
(weights from the seed, the checked steps of a training cell), frees the
program and prints the numbers the check compares.  For the seeds of
``--control`` it also prints the control's: the reference itself in the
next precision below the stated one (float8 products, forward and backward,
where bf16 is stated), put in the program's place.  For the
seeds of ``--faults`` it prints the numbers of each fault the cell can have,
planted in the program (:mod:`portbench.faults`).  A cell on a mesh starts
its ranks once for all seeds.  One JSON line each; the benchmark's own runs
never run this.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def _seeds(text: str) -> list[int]:
    if not text:
        return []
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def _emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def _readings(program, reference, seeds, control, faults_at, fault_names) -> None:
    """One line a seed: the program's numbers (``program(seed, None)``)
    against the reference (``reference(seed, prec)``), the control's, and
    one line for each fault planted (``program(seed, fault)``)."""
    import torch

    from portbench.entries import train as tr

    for seed in sorted(set(seeds) | set(faults_at)):
        t = time.perf_counter()
        got = program(seed, None) if seed in seeds else None
        bad = {f: program(seed, f) for f in fault_names} if seed in faults_at else {}
        t_prog = time.perf_counter()
        want = reference(seed, tr.REF)
        t_ref = time.perf_counter()
        line = {"seed": seed, "run": "sound", "program_s": t_prog - t, "check_s": t_ref - t_prog,
                "losses": want["loss"]}
        if got is not None:
            line["program"] = tr.compare(got, want)
            line["program_losses"] = got["loss"]
        if seed in control:
            lowp = reference(seed, tr.CONTROL)
            line["control"] = tr.compare(lowp, want)
            line["control_losses"] = lowp["loss"]
            line["control_s"] = time.perf_counter() - t_ref
        _emit(line)
        for fault, b in bad.items():
            _emit({"seed": seed, "run": fault, "program": tr.compare(b, want)})
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def train_cell(conf, mix, seeds, control, faults_at, device) -> None:
    import torch

    from portbench import faults
    from portbench.entries import train as tr

    def program(seed, fault):
        with faults.planted(fault):
            job = tr.Job(conf, mix, device)
            job.load(seed)
            got = job.checked(seed)
            job.free()
            del job
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return got

    _readings(program, lambda seed, prec: tr.reference(conf, mix, seed, device, prec),
              seeds, control, faults_at, faults.of(mix))


def mesh_cell(conf, mix, seeds, control, faults_at, device) -> None:
    """As :func:`train_cell`, for a mix on a mesh: the ranks start once and
    run the program for every seed and fault first (``program_s`` is then
    that seed's share), and end before the reference runs on their cards."""
    from portbench import faults
    from portbench.entries import train_mesh as tm

    group = tm.Group(conf, mix, device)
    ok, got, took = False, {}, {}
    try:
        for seed in sorted(set(seeds) | set(faults_at)):
            t = time.perf_counter()
            for fault in ([None] if seed in seeds else []) + (
                    list(faults.of(mix)) if seed in faults_at else []):
                group.call("plant", fault)
                group.call("load", seed)
                got[seed, fault] = group.call("checked", seed)
                group.call("free")
            took[seed] = time.perf_counter() - t
        ok = True
    finally:
        group.close(ok)
    _emit({"program_s": took})
    _readings(lambda seed, fault: got[seed, fault],
              lambda seed, prec: tm.reference(conf, mix, seed, tm.devices(device, group.world), prec),
              seeds, control, faults_at, faults.of(mix))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)

    from portbench import spec

    cell = spec.workload(args.workload)
    conf, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    seeds, control, faults_at = _seeds(args.seeds), _seeds(args.control), _seeds(args.faults)
    (mesh_cell if "mesh" in mix else train_cell)(conf, mix, seeds, set(control), faults_at,
                                                 "cuda")
    _emit({"done_s": time.perf_counter() - T0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
