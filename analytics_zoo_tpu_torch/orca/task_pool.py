"""Task-parallel runner (port of ``analytics_zoo_tpu/orca/task_pool.py``):
the RayOnSpark *non-training* half.

N spawned worker processes run cloudpickled callables, and Ray-style
**actors** (a class instantiated inside one worker, where it keeps its
state; calls on it are served in submission order and return futures):

    pool = TaskPool(4)
    futs = [pool.submit(lambda x=i: x * x) for i in range(8)]
    [f.result() for f in futs]

    ps = pool.actor(ParameterServer, init_weights)      # lives in worker 0
    w = ps.call("get_weights").result()
    ps.call("apply_gradients", grads)

Workers never hold the card: each starts with ``CUDA_VISIBLE_DEVICES=""``
set before anything in it can initialise CUDA (the JAX workers force the
CPU backend for the same reason), so a task that builds a port model
without ``device="cpu"`` raises, as every entry point does with no CUDA.
``cloudpickle`` is imported by the pool and by the worker, not when this
module is imported.

Host spanning: ``pool_rank()`` / ``pool_world()`` read a ``ClusterLauncher``
job's ``ZOO_TPU_PROCESS_ID`` / ``ZOO_TPU_NUM_PROCESSES``.
"""

from __future__ import annotations

import itertools
import logging
import multiprocessing as mp
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..common.locks import traced_lock
from ..common.resilience import HealthRegistry


def pool_rank() -> int:
    """This host's rank in a ClusterLauncher job (0 standalone)."""
    return int(os.environ.get("ZOO_TPU_PROCESS_ID", "0"))


def pool_world() -> int:
    """Number of hosts in the ClusterLauncher job (1 standalone)."""
    return int(os.environ.get("ZOO_TPU_NUM_PROCESSES", "1"))


_HB = "__hb__"   # heartbeat sentinel on a worker's outbox


def _worker_main(widx, inbox, outbox, init_blob, chaos_blob, hb_interval_s):
    """Worker loop: run tasks, host actors. The card is hidden first.

    A daemon thread puts ``(_HB, widx, None)`` heartbeats on the outbox so
    the pool can tell a wedged worker (alive, loop stuck) from a busy one.
    The chaos schedule of the pool's process is installed here, so a plan
    such as "kill worker 1 at its 2nd task" fires in the worker."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    import cloudpickle

    from ..common import chaos as chaos_mod

    if chaos_blob is not None:
        chaos_mod.install_chaos(cloudpickle.loads(chaos_blob))
    if init_blob is not None:
        cloudpickle.loads(init_blob)()

    stop_hb = threading.Event()

    def _beat():
        while not stop_hb.wait(hb_interval_s):
            try:
                outbox.put((_HB, widx, None))
            except Exception:
                return

    threading.Thread(target=_beat, daemon=True, name="pool-hb").start()

    actors: Dict[int, Any] = {}
    while True:
        msg = inbox.get()
        if msg is None:
            stop_hb.set()
            return
        kind, tid = msg[0], msg[1]
        try:
            if kind == "task":
                chaos_mod.chaos_point("task_pool.worker", tag=widx)
                fn, args, kw = cloudpickle.loads(msg[2])
                result = fn(*args, **kw)
            elif kind == "actor_new":
                cls, args, kw = cloudpickle.loads(msg[2])
                actors[msg[3]] = cls(*args, **kw)
                result = True
            elif kind == "actor_call":
                chaos_mod.chaos_point("task_pool.worker", tag=widx)
                method, args, kw = cloudpickle.loads(msg[3])
                result = getattr(actors[msg[2]], method)(*args, **kw)
            elif kind == "actor_del":
                actors.pop(msg[2], None)
                result = True
            else:
                raise ValueError(f"unknown message {kind!r}")
            outbox.put((tid, True, cloudpickle.dumps(result)))
        except BaseException as e:  # report, keep serving
            outbox.put((tid, False, cloudpickle.dumps(
                RuntimeError(f"{type(e).__name__}: {e}"))))


class Future:
    """Result handle; ``result(timeout)`` blocks and re-raises task errors."""

    def __init__(self):
        self._ev = threading.Event()
        self._ok = None
        self._val = None

    def _set(self, ok: bool, val: Any):
        self._ok, self._val = ok, val
        self._ev.set()

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._ev.wait(timeout):
            raise TimeoutError("task did not complete in time")
        if not self._ok:
            raise self._val
        return self._val


class ActorHandle:
    """Proxy to a class instance living inside one worker process. Calls on
    the same actor execute in submission order (its worker inbox is FIFO)."""

    def __init__(self, pool: "TaskPool", actor_id: int, worker: int):
        self._pool = pool
        self.actor_id = actor_id
        self.worker = worker

    def call(self, method: str, *args, **kw) -> Future:
        import cloudpickle

        return self._pool._send(
            self.worker, "actor_call", self.actor_id,
            cloudpickle.dumps((method, args, kw)))

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return lambda *a, **kw: self.call(name, *a, **kw)

    def terminate(self):
        self._pool._forget_actor(self.actor_id)
        self._pool._send(self.worker, "actor_del", self.actor_id)


class TaskPool:
    """N spawned worker processes executing tasks and hosting actors.

    ``worker_init``: optional zero-arg callable run once in each worker.
    Workers are spawn-context processes without the card.

    ``respawn=True``: a dead worker (process exit, or a heartbeat stale
    past ``heartbeat_timeout_s`` after its first beat) is respawned in
    place; the messages in flight to it are resubmitted (tasks are taken
    to be idempotent, the Ray task model), and actors homed there are
    re-instantiated from their constructor arguments, then handed to their
    ``on_respawn(handle)``. ``respawn=False`` (default): a dead worker
    breaks the pool and fails every outstanding future.
    """

    def __init__(self, num_workers: int = 4,
                 worker_init: Optional[Callable[[], None]] = None,
                 respawn: bool = False,
                 heartbeat_interval_s: float = 0.2,
                 heartbeat_timeout_s: float = 10.0,
                 registry: Optional[HealthRegistry] = None):
        import cloudpickle

        from ..common.chaos import get_chaos

        self._ctx = mp.get_context("spawn")
        self.num_workers = int(num_workers)
        self.respawn = bool(respawn)
        self.workers_respawned = 0
        self.registry = registry if registry is not None else HealthRegistry(
            default_timeout_s=heartbeat_timeout_s)
        self._hb_interval_s = heartbeat_interval_s
        self._init_blob = (cloudpickle.dumps(worker_init) if worker_init
                           else None)
        # the process's installed chaos schedule goes to the first workers;
        # respawned ones run fault-free (one environment fault, not a
        # crash loop)
        sched = get_chaos()
        self._chaos_blob = cloudpickle.dumps(sched) if sched else None
        self._futures: Dict[int, Dict[str, Any]] = {}   # tid -> pending rec
        # zoo-lock: guards(_futures, _actors)
        self._flock = traced_lock("TaskPool._flock")
        self._tid = itertools.count()
        self._aid = itertools.count()
        self._rr = itertools.count()
        self._actors: Dict[int, Dict[str, Any]] = {}
        self._closed = False
        self._broken: Optional[str] = None
        self._inboxes: List[Any] = [None] * self.num_workers
        # one outbox a worker: a worker killed mid-write would leave a
        # shared queue's write lock held and wedge the others' results
        self._outboxes: List[Any] = [None] * self.num_workers
        self._procs: List[Any] = [None] * self.num_workers
        for i in range(self.num_workers):
            self._make_worker(i, with_chaos=True)
        self._start_procs(list(self._procs))
        self._watchdog = threading.Thread(target=self._watch, daemon=True)
        self._watchdog.start()

    # ------------------------------------------------------------ internals
    @staticmethod
    def _wname(i: int) -> str:
        return f"pool.worker-{i}"

    def _make_worker(self, i: int, with_chaos: bool):
        """Worker ``i``'s process (not started), a fresh inbox and outbox,
        and the outbox's collector thread."""
        self._inboxes[i] = self._ctx.Queue()
        outbox = self._ctx.Queue()
        self._outboxes[i] = outbox
        self._procs[i] = self._ctx.Process(
            target=_worker_main, daemon=True,
            args=(i, self._inboxes[i], outbox, self._init_blob,
                  self._chaos_blob if with_chaos else None,
                  self._hb_interval_s))
        self.registry.register(self._wname(i))
        threading.Thread(target=self._collect, args=(outbox,), daemon=True,
                         name=f"pool-collect-{i}").start()

    @staticmethod
    def _start_procs(procs):
        """Start processes with the REPL guard: spawn re-runs
        ``__main__`` from its ``__file__`` in every child; a REPL's
        ``<stdin>`` is no file and every worker would die at start. The
        attribute is dropped around ``start()`` (cloudpickle sends
        ``__main__`` callables by value, so workers never need the
        script)."""
        main_mod = sys.modules.get("__main__")
        main_file = getattr(main_mod, "__file__", None)
        strip = main_file is not None and not os.path.exists(main_file)
        if strip:
            del main_mod.__file__
        try:
            for p in procs:
                p.start()
        finally:
            if strip:
                main_mod.__file__ = main_file

    def _collect(self, outbox):
        """Drain one worker's outbox (results and heartbeats) until the
        shutdown sentinel or the queue's teardown; a revived worker gets a
        fresh queue and collector, and this one is abandoned."""
        import cloudpickle

        while True:
            try:
                msg = outbox.get()
            except (OSError, EOFError, ValueError, TypeError):
                return
            if msg is None:
                return
            try:
                tid, ok, blob = msg
            except (TypeError, ValueError):
                continue  # torn write from a hard-killed worker
            if tid == _HB:
                self.registry.beat(self._wname(ok))
                continue
            with self._flock:
                rec = self._futures.pop(tid, None)
            if rec is None:
                continue
            try:
                val = cloudpickle.loads(blob)
            except Exception as e:
                ok, val = False, RuntimeError(f"undecodable worker result: {e}")
            rec["fut"]._set(ok, val)

    def _watch(self):
        """Dead-worker detection: process exit, or in respawn mode a
        heartbeat stale past the timeout after the first beat (start-up may
        take longer than the timeout). ``respawn=False`` fails every
        outstanding future; ``respawn=True`` revives the worker."""
        while not self._closed:
            for i in range(self.num_workers):
                if self._closed:
                    return
                p = self._procs[i]
                dead = not p.is_alive()
                if not dead and self.respawn \
                        and self.registry.beats(self._wname(i)) > 0 \
                        and not self.registry.alive(self._wname(i)):
                    dead = True
                if not dead:
                    continue
                if self.respawn:
                    self._revive(i)
                    continue
                self._broken = (f"task pool worker pid={p.pid} died "
                                f"(exitcode {p.exitcode})")
                with self._flock:
                    recs = list(self._futures.values())
                    self._futures.clear()
                for rec in recs:
                    rec["fut"]._set(False, RuntimeError(self._broken))
                return
            time.sleep(0.1)

    def _revive(self, i: int):
        """Respawn worker ``i`` in place: a fresh process and inbox, its
        actors re-instantiated (then ``on_respawn``), and every message in
        flight to it sent again under its tid, so the original futures
        resolve on the second run."""
        old = self._procs[i]
        if old.is_alive():   # wedged, not exited
            old.terminate()
        old.join(timeout=2.0)
        self.workers_respawned += 1
        # swap the inbox before the snapshot of work in flight: a
        # concurrent _send reaches the new worker directly (a duplicate is
        # dropped by the future pop; a message to the dead inbox is lost)
        self._make_worker(i, with_chaos=False)
        with self._flock:
            pending = sorted(
                (tid, rec) for tid, rec in self._futures.items()
                if rec["worker"] == i)
        self._start_procs([self._procs[i]])
        inbox = self._inboxes[i]
        with self._flock:
            homed = [(aid, a) for aid, a in sorted(self._actors.items())
                     if a["worker"] == i]
        for aid, a in homed:
            inbox.put(("actor_new", next(self._tid), a["blob"], aid))
        # owners push externally-held state back in, ahead of the
        # resubmitted work
        for aid, a in homed:
            if a["on_respawn"] is not None:
                try:
                    a["on_respawn"](ActorHandle(self, aid, i))
                except Exception:  # a callback must not kill the watchdog
                    logging.getLogger("analytics_zoo_tpu_torch.orca"
                                      ).exception(
                        "actor %d on_respawn callback failed", aid)
        for tid, rec in pending:
            inbox.put(rec["msg"])

    def _forget_actor(self, actor_id: int) -> None:
        """Drop an actor from the respawn roster (``handle.terminate()``)."""
        with self._flock:
            self._actors.pop(actor_id, None)

    def _send(self, worker: int, kind: str, *payload) -> Future:
        if self._closed:
            raise RuntimeError("pool is shut down")
        if self._broken:
            raise RuntimeError(self._broken)
        tid = next(self._tid)
        fut = Future()
        msg = (kind, tid, *payload)
        with self._flock:
            self._futures[tid] = {"fut": fut, "worker": worker, "msg": msg}
        # the watchdog may have drained _futures since the check above
        if self._broken:
            with self._flock:
                self._futures.pop(tid, None)
            fut._set(False, RuntimeError(self._broken))
            return fut
        self._inboxes[worker].put(msg)
        return fut

    # -------------------------------------------------------------- tasks
    def submit(self, fn: Callable, *args, **kw) -> Future:
        """Run ``fn(*args, **kw)`` on the next worker in turn."""
        import cloudpickle

        worker = next(self._rr) % self.num_workers
        return self._send(worker, "task", cloudpickle.dumps((fn, args, kw)))

    def map(self, fn: Callable, items: Sequence[Any]) -> List[Any]:
        """Parallel map; blocks for all results (ordered)."""
        futs = [self.submit(fn, it) for it in items]
        return [f.result() for f in futs]

    # -------------------------------------------------------------- actors
    def actor(self, cls: type, *args, worker: Optional[int] = None,
              on_respawn: Optional[Callable[[ActorHandle], None]] = None,
              **kw) -> ActorHandle:
        """Instantiate ``cls`` inside one worker; returns a handle whose
        method calls are futures. ``on_respawn`` (respawn pools) is called
        with the handle after the actor is re-instantiated on a revived
        worker, to push back state its constructor cannot rebuild."""
        import cloudpickle

        aid = next(self._aid)
        worker = (next(self._rr) % self.num_workers) if worker is None \
            else worker % self.num_workers
        blob = cloudpickle.dumps((cls, args, kw))
        self._send(worker, "actor_new", blob, aid).result(timeout=120)
        with self._flock:
            self._actors[aid] = {"worker": worker, "blob": blob,
                                 "on_respawn": on_respawn}
        return ActorHandle(self, aid, worker)

    # ------------------------------------------------------------- control
    def shutdown(self):
        if self._closed:
            return
        self._closed = True
        for q in self._inboxes:
            q.put(None)
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
        for q in self._outboxes:   # release the collector threads
            try:
                q.put(None)
            except (OSError, ValueError):
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()


__all__ = ["ActorHandle", "Future", "TaskPool", "pool_rank", "pool_world"]
