"""Multi-process job bootstrap and worker lifecycle (port of
``common/cluster.py``; the reference's RayOnSpark bootstrap and JVMGuard).

* :class:`ClusterLauncher` spawns the N worker processes of a job on this
  host, each with the environment a process group needs: the JAX
  package's names (``ZOO_TPU_COORDINATOR_ADDRESS``,
  ``ZOO_TPU_NUM_PROCESSES``, ``ZOO_TPU_PROCESS_ID``, which
  ``init_zoo_context`` reads through ``apply_env_overrides``) and the ones
  ``torch.distributed`` reads (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
  ``WORLD_SIZE``). Workers log to files, never to a pipe nobody drains.
* :class:`ProcessMonitor` tracks the children, fails fast on the first
  non-zero exit and kills every child on exit or on timeout.
* :func:`configure_worker` (the JAX ``configure_worker_jax``) applies the
  launcher's ``ZOO_TPU_WORKER_PLATFORM`` (``cpu`` or ``cuda``: the
  worker's device, ``cuda:<rank mod cards>`` on a card) and
  ``ZOO_TPU_CPU_COLLECTIVES`` (the CPU process group's backend, ``gloo``).
* :func:`barrier` is a host-level barrier over the process group.

A worker is a script or, given none, this module's own worker
(``python -m analytics_zoo_tpu_torch.common.cluster``: configure, join
the process group through ``init_zoo_context``, pass a barrier, print
one JSON line with its rank, world size and mesh, exit 0), the smoke
check of a launch.
"""

from __future__ import annotations

import argparse
import atexit
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

#: the worker a launch runs when given no script and no module
WORKER_MODULE = "analytics_zoo_tpu_torch.common.cluster"


@dataclass
class WorkerProc:
    rank: int
    proc: subprocess.Popen
    cmd: List[str]
    log_path: Optional[str] = None

    @property
    def pid(self) -> int:
        return self.proc.pid

    def alive(self) -> bool:
        return self.proc.poll() is None

    def returncode(self) -> Optional[int]:
        return self.proc.poll()


class ProcessMonitor:
    """Tracks spawned workers; kills the whole group on exit or on the
    first failure, so no worker is orphaned."""

    def __init__(self):
        self.workers: List[WorkerProc] = []
        self._registered = False
        # guards ``workers``; kill_all signals outside it
        self._lock = threading.Lock()

    def register(self, worker: WorkerProc):
        with self._lock:
            self.workers.append(worker)
            if not self._registered:
                atexit.register(self.kill_all)
                self._registered = True

    def poll(self) -> Dict[int, Optional[int]]:
        return {w.rank: w.returncode() for w in self.workers}

    def failed(self) -> List[WorkerProc]:
        return [w for w in self.workers if w.returncode() not in (None, 0)]

    def all_done(self) -> bool:
        return all(not w.alive() for w in self.workers)

    def kill_all(self, sig=signal.SIGTERM, grace_s: float = 3.0):
        """Signal every live worker, then SIGKILL those still alive after
        ``grace_s``; reaps them all."""
        with self._lock:
            workers = list(self.workers)
        for w in workers:
            if w.alive():
                try:
                    w.proc.send_signal(sig)
                except ProcessLookupError:
                    pass
        deadline = time.time() + grace_s
        for w in workers:
            while w.alive() and time.time() < deadline:
                time.sleep(0.05)
            if w.alive():
                try:
                    w.proc.kill()
                except ProcessLookupError:
                    pass
            try:
                w.proc.wait(timeout=grace_s)
            except subprocess.TimeoutExpired:
                pass

    def wait(self, timeout_s: Optional[float] = None,
             on_failure: str = "kill") -> Dict[int, Optional[int]]:
        """Block until every worker exits, one fails, or ``timeout_s``.

        ``on_failure='kill'``: the first non-zero exit tears down the rest
        (fail fast: one lost process stalls every collective of the job);
        a timeout kills them all too, then raises ``TimeoutError``."""
        deadline = None if timeout_s is None else time.time() + timeout_s
        while True:
            bad = self.failed()
            if bad:
                if on_failure == "kill":
                    self.kill_all()
                return self.poll()
            if self.all_done():
                return self.poll()
            if deadline is not None and time.time() > deadline:
                still = [w.rank for w in self.workers if w.alive()]
                if on_failure == "kill":
                    self.kill_all()
                raise TimeoutError(f"workers still running: {still}")
            time.sleep(0.1)


class ClusterLauncher:
    """Spawn ``num_processes`` copies of a worker, each with the
    environment of its rank (:meth:`worker_env`)."""

    def __init__(self, num_processes: int, coordinator_port: int = 7877,
                 env_extra: Optional[Dict[str, str]] = None,
                 python: Optional[str] = None,
                 platform: Optional[str] = None,
                 collectives: Optional[str] = None):
        self.num_processes = int(num_processes)
        self.coordinator_port = int(coordinator_port)
        self.coordinator = f"127.0.0.1:{self.coordinator_port}"
        self.env_extra = dict(env_extra or {})
        self.python = python or sys.executable
        # picked up by configure_worker() in the worker
        self.platform = platform
        self.collectives = collectives
        self.monitor = ProcessMonitor()
        self.log_dir: Optional[str] = None

    def worker_env(self, rank: int) -> Dict[str, str]:
        env = dict(os.environ)
        env.update(self.env_extra)
        env.update({
            "ZOO_TPU_COORDINATOR": self.coordinator,
            "ZOO_TPU_COORDINATOR_ADDRESS": self.coordinator,
            "ZOO_TPU_NUM_PROCESSES": str(self.num_processes),
            "ZOO_TPU_PROCESS_ID": str(rank),
            "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(self.coordinator_port),
            "RANK": str(rank),
            "WORLD_SIZE": str(self.num_processes),
        })
        if self.platform:
            env["ZOO_TPU_WORKER_PLATFORM"] = self.platform
        if self.collectives:
            env["ZOO_TPU_CPU_COLLECTIVES"] = self.collectives
        return env

    def command(self, script: Optional[str] = None,
                args: Sequence[str] = ()) -> List[str]:
        """The argv a worker runs: ``python script args...``, or ``python
        -m analytics_zoo_tpu_torch.common.cluster args...`` without a
        script."""
        head = [script] if script is not None else ["-m", WORKER_MODULE]
        return [self.python, *head, *map(str, args)]

    def launch(self, script: Optional[str] = None, args: Sequence[str] = (),
               log_dir: Optional[str] = None) -> ProcessMonitor:
        """Spawn the workers (:meth:`command`); each logs to
        ``log_dir/worker-<rank>.log`` (a temporary directory when not
        given), never to a pipe."""
        log_dir = log_dir or tempfile.mkdtemp(prefix="zoo_cluster_")
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        cmd = self.command(script, args)
        for rank in range(self.num_processes):
            log_path = os.path.join(log_dir, f"worker-{rank}.log")
            with open(log_path, "wb") as logf:
                proc = subprocess.Popen(cmd, env=self.worker_env(rank),
                                        stdout=logf,
                                        stderr=subprocess.STDOUT,
                                        stdin=subprocess.DEVNULL)
            self.monitor.register(WorkerProc(rank=rank, proc=proc,
                                             cmd=list(cmd),
                                             log_path=log_path))
        return self.monitor


def configure_worker() -> Optional[str]:
    """Apply the launcher's settings in a worker, before it builds a
    context: ``ZOO_TPU_WORKER_PLATFORM`` becomes the context's platform
    (``ZOO_TPU_PLATFORM``) and, on a card, the current device
    (``cuda:<rank mod cards>``); ``ZOO_TPU_CPU_COLLECTIVES`` must name
    gloo, the CPU process group's backend. Returns the platform."""
    import torch

    collectives = os.environ.get("ZOO_TPU_CPU_COLLECTIVES")
    if collectives and collectives != "gloo":
        raise ValueError(f"ZOO_TPU_CPU_COLLECTIVES={collectives!r}: the "
                         f"CPU process group runs on gloo")
    platform = os.environ.get("ZOO_TPU_WORKER_PLATFORM")
    if platform:
        os.environ["ZOO_TPU_PLATFORM"] = platform
        if platform in ("gpu", "cuda"):
            rank = int(os.environ.get("ZOO_TPU_PROCESS_ID", "0"))
            torch.cuda.set_device(rank % max(1, torch.cuda.device_count()))
    return platform


def barrier(name: str = "zoo_barrier", timeout_s: float = 120.0):
    """Host-level barrier across the process group; a no-op in a single
    process."""
    import datetime

    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    if dist.get_backend() == "gloo":
        dist.monitored_barrier(
            timeout=datetime.timedelta(seconds=timeout_s))
    else:
        dist.barrier()


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m analytics_zoo_tpu_torch.common.cluster",
        description="A cluster worker: join the job's process group from "
                    "the launcher's environment, pass a barrier, print one "
                    "JSON line (rank, world size, devices, mesh), exit 0.")
    ap.parse_args(argv)
    platform = configure_worker()
    from .context import init_zoo_context, reset_zoo_context

    ctx = init_zoo_context()
    try:
        barrier()
        print(json.dumps({
            "rank": ctx.process_index, "world": ctx.process_count,
            "platform": platform,
            "devices": [str(d) for d in ctx.local_devices],
            "mesh": ctx.mesh.shape, "argv": sys.argv}), flush=True)
    finally:
        reset_zoo_context()
    return 0


__all__ = ["ClusterLauncher", "ProcessMonitor", "WorkerProc", "barrier",
           "configure_worker", "main", "WORKER_MODULE"]


if __name__ == "__main__":
    sys.exit(main())
