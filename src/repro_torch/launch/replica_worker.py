# Copied from src/repro/launch/replica_worker.py with repro -> repro_torch; keep the two in step.
"""Replica worker: subprocess entrypoint hosting one ``PartitionService``.

``python -m repro_torch.launch.replica_worker --port 0`` starts a service behind
``core.transport.PlanServer`` on a loopback TCP port and announces itself
on stdout as::

    REPLICA_WORKER_READY port=<port> pid=<pid>

so a parent can bind ``port 0`` without races.  The worker exits when it
receives the ``close`` RPC, or — with ``--parent-watch`` (default) — when
its stdin reaches EOF, which is how an abruptly dead parent reaps its
children without a supervisor.

Deterministic chaos needs stragglers *inside* the worker process (the
group's ``pre_job_hook`` cannot cross the process boundary), so
``--stall DELAY:FIRST:LAST`` installs a dispatch-order stall schedule
matching ``FaultInjector.stall_jobs`` semantics: jobs ``FIRST..LAST``
(0-based) sleep ``DELAY`` seconds before executing.

:func:`spawn_worker` / :func:`spawn_process_group` are the parent-side
helpers: spawn N workers, wrap each in a ``RemoteReplica``, and hand the
set to ``ReplicaGroup`` — the ``--transport=process`` path of
``launch.serve`` and the kill -9 scenario in ``benchmarks/svc_chaos.py``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import select
import subprocess
import sys
import threading
import time
from typing import Optional, Sequence

_READY_TAG = "REPLICA_WORKER_READY"


def _parse_stall(spec: str) -> tuple[float, int, int]:
    """``DELAY:FIRST:LAST`` -> (delay_s, first, last); LAST may be ``inf``."""
    parts = spec.split(":")
    if len(parts) != 3:
        raise argparse.ArgumentTypeError(
            f"--stall wants DELAY:FIRST:LAST, got {spec!r}")
    delay = float(parts[0])
    first = int(parts[1])
    last = (1 << 30) if parts[2] in ("inf", "") else int(parts[2])
    return delay, first, last


def _make_stall_hook(stalls: Sequence[tuple[float, int, int]]):
    lock = threading.Lock()
    counter = [0]

    def hook(_key) -> None:
        with lock:
            i = counter[0]
            counter[0] = i + 1
        for delay, first, last in stalls:
            if first <= i <= last:
                time.sleep(delay)
                return
    return hook


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Socket-backed PartitionService replica worker")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 binds an ephemeral port (announced on stdout)")
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--executor", choices=["thread", "process"], default="thread")
    p.add_argument("--max-entries", type=int, default=64)
    p.add_argument("--queue-bound", type=int, default=None,
                   help="bounded admission: max scheduler queue depth "
                        "(default unbounded); over-share submits answer "
                        "AdmissionRejectedError frames over the wire")
    p.add_argument("--persist-path", default=None)
    p.add_argument("--stall", action="append", type=_parse_stall, default=[],
                   metavar="DELAY:FIRST:LAST",
                   help="straggler schedule for this worker's jobs "
                        "(repeatable; FaultInjector.stall_jobs semantics)")
    p.add_argument("--no-parent-watch", dest="parent_watch",
                   action="store_false", default=True,
                   help="do not exit when stdin reaches EOF")
    args = p.parse_args(argv)

    # Deferred: only the child pays for importing the plan service.
    from repro_torch.core.partition_service import PartitionService
    from repro_torch.core.transport import PlanServer

    svc = PartitionService(workers=args.workers, executor=args.executor,
                           max_entries=args.max_entries,
                           persist_path=args.persist_path,
                           max_queue_depth=args.queue_bound)
    if args.stall:
        svc.scheduler.pre_job_hook = _make_stall_hook(args.stall)
    server = PlanServer(svc, host=args.host, port=args.port)
    print(f"{_READY_TAG} port={server.port} pid={os.getpid()}", flush=True)

    if args.parent_watch:
        def watch() -> None:
            try:
                sys.stdin.buffer.read()
            except Exception:
                pass
            os._exit(0)
        threading.Thread(target=watch, name="parent-watch",
                         daemon=True).start()

    server.serve_forever()
    svc.close()
    if args.parent_watch:
        # The watch thread is blocked inside stdin's buffered read and
        # would deadlock interpreter finalization; a drained worker has
        # nothing left to flush, so leave without the shutdown dance.
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)
    return 0


# ---------------------------------------------------------------------------
# Parent-side spawn helpers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WorkerHandle:
    """A spawned replica worker: the process plus its announced endpoint."""

    proc: subprocess.Popen
    address: tuple[str, int]
    pid: int


def _src_root() -> str:
    import repro_torch
    # repro_torch is a regular package: its __path__ names src/repro_torch.
    return os.path.dirname(os.path.abspath(list(repro_torch.__path__)[0]))


def spawn_worker(
    *,
    stalls: Sequence[tuple[float, int, int]] = (),
    workers: int = 1,
    executor: str = "thread",
    max_entries: int = 64,
    queue_bound: Optional[int] = None,
    persist_path: Optional[str] = None,
    host: str = "127.0.0.1",
    startup_timeout_s: float = 120.0,
    python: Optional[str] = None,
) -> WorkerHandle:
    """Start one worker subprocess and wait for its ready announcement."""
    cmd = [python or sys.executable, "-m", "repro_torch.launch.replica_worker",
           "--host", host, "--port", "0",
           "--workers", str(workers), "--executor", executor,
           "--max-entries", str(max_entries)]
    if queue_bound is not None:
        cmd += ["--queue-bound", str(queue_bound)]
    if persist_path:
        cmd += ["--persist-path", persist_path]
    for delay, first, last in stalls:
        cmd += ["--stall", f"{delay}:{first}:{last}"]
    env = dict(os.environ)
    src = _src_root()
    env["PYTHONPATH"] = (src + os.pathsep + env["PYTHONPATH"]
                         if env.get("PYTHONPATH") else src)
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, env=env)
    deadline = time.monotonic() + startup_timeout_s
    line = ""
    try:
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"replica worker did not announce within "
                    f"{startup_timeout_s}s")
            if proc.poll() is not None:
                raise RuntimeError(
                    f"replica worker exited rc={proc.returncode} "
                    "before announcing")
            ready, _, _ = select.select([proc.stdout], [], [], min(remaining, 0.5))
            if not ready:
                continue
            line = proc.stdout.readline().decode("utf-8", "replace").strip()
            if line.startswith(_READY_TAG):
                break
            if not line:  # EOF without announcement
                raise RuntimeError("replica worker closed stdout "
                                   "before announcing")
    except BaseException:
        proc.kill()
        raise
    fields = dict(kv.split("=", 1) for kv in line.split()[1:])
    return WorkerHandle(proc=proc, address=(host, int(fields["port"])),
                        pid=int(fields["pid"]))


def spawn_process_group(
    n: int,
    *,
    stalls_per_replica: Optional[Sequence[Sequence[tuple[float, int, int]]]] = None,
    worker_kwargs: Optional[dict] = None,
    replica_kwargs: Optional[dict] = None,
    **group_kwargs,
):
    """Spawn ``n`` worker processes and wrap them in a ``ReplicaGroup``.

    Replica ``r{i}`` maps to worker ``i`` (the same ids the group assigns),
    so ``FaultInjector`` process-probe schedules address workers by the
    familiar ``r0``/``r1`` names.  Closing the group closes the remote
    services and reaps the worker processes."""
    from repro_torch.core.replica import ReplicaGroup
    from repro_torch.core.transport import RemoteReplica

    handles = []
    try:
        for i in range(n):
            stalls = (stalls_per_replica[i]
                      if stalls_per_replica is not None else ())
            handles.append(spawn_worker(stalls=stalls, **(worker_kwargs or {})))
    except BaseException:
        for h in handles:
            h.proc.kill()
        raise
    remotes = [RemoteReplica(h.address, process=h.proc, pid=h.pid,
                             **(replica_kwargs or {}))
               for h in handles]
    return ReplicaGroup(remotes, **group_kwargs)


if __name__ == "__main__":
    sys.exit(main())
