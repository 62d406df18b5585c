"""The cluster launcher of the PyTorch port, on the CPU: real worker
processes on a gloo process group.

Held: a launch of 2 workers of the port's own worker module (``python -m
analytics_zoo_tpu_torch.common.cluster``) joins one process group through
the launcher's environment, passes a barrier as ranks 0 and 1 of 2 and
exits 0, each worker logging to its own file; the environment carries the
JAX package's names beside ``torch.distributed``'s; with a worker script
the test writes, a failing rank tears the job down (fail fast) and a job
past its timeout is killed. Each test
takes a free port of its own and a timeout, so the tests run side by side
under xdist.
"""

import json
import os
import socket
import sys
import textwrap
import time

import pytest

from analytics_zoo_tpu.common.cluster import ClusterLauncher as JLauncher
from analytics_zoo_tpu_torch.common.cluster import (WORKER_MODULE,
                                                    ClusterLauncher,
                                                    ProcessMonitor, barrier)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: a worker that fails (``argv[1]``: the rank that exits 3 before joining)
#: or outlives its job (``argv[2]``: seconds to stay up after joining)
FAULTY_WORKER = textwrap.dedent("""\
    import json, os, sys, time

    from analytics_zoo_tpu_torch.common.cluster import configure_worker
    from analytics_zoo_tpu_torch.common.context import init_zoo_context

    configure_worker()
    rank = int(os.environ["ZOO_TPU_PROCESS_ID"])
    if rank == int(sys.argv[1]):
        print(json.dumps({"rank": rank, "failed": True}), flush=True)
        sys.exit(3)
    init_zoo_context()
    time.sleep(float(sys.argv[2]))
""")


def _launcher(port=None):
    path = os.pathsep.join(filter(None, [REPO,
                                         os.environ.get("PYTHONPATH")]))
    return ClusterLauncher(2, coordinator_port=port or _free_port(),
                           platform="cpu", collectives="gloo",
                           env_extra={"PYTHONPATH": path})


def _faulty(tmp_path, fail_rank, sleep_s):
    script = tmp_path / "faulty_worker.py"
    script.write_text(FAULTY_WORKER)
    return _launcher().launch(str(script), [fail_rank, sleep_s],
                              log_dir=str(tmp_path))


def _report(worker):
    with open(worker.log_path) as f:
        lines = [l for l in f.read().splitlines() if l.startswith("{")]
    return json.loads(lines[-1])


def test_worker_env_carries_both_packages_names():
    port = _free_port()
    tl = ClusterLauncher(3, coordinator_port=port, platform="cpu",
                         collectives="gloo", env_extra={"A": "1"})
    jl = JLauncher(3, coordinator_port=port, platform="cpu",
                   collectives="gloo", env_extra={"A": "1"})
    for rank in range(3):
        t, j = tl.worker_env(rank), jl.worker_env(rank)
        for k, v in j.items():
            assert t[k] == v, k
        assert (t["MASTER_ADDR"], t["MASTER_PORT"], t["RANK"],
                t["WORLD_SIZE"]) == ("127.0.0.1", str(port), str(rank), "3")
    assert tl.command() == [sys.executable, "-m", WORKER_MODULE]
    assert tl.command("w.py", [1]) == [sys.executable, "w.py", "1"]


def test_two_gloo_workers_pass_a_barrier_and_log_to_files(tmp_path):
    launcher = _launcher()
    monitor = launcher.launch(log_dir=str(tmp_path))
    assert monitor.wait(timeout_s=90) == {0: 0, 1: 0}
    reports = sorted((_report(w) for w in monitor.workers),
                     key=lambda r: r["rank"])
    assert [(r["rank"], r["world"]) for r in reports] == [(0, 2), (1, 2)]
    for r in reports:
        assert r["platform"] == "cpu" and r["devices"] == ["cpu"]
        assert r["mesh"]["dp"] == 2
    for w in monitor.workers:
        assert w.log_path == str(tmp_path / f"worker-{w.rank}.log")
        assert w.cmd == [sys.executable, "-m", WORKER_MODULE]
        assert w.proc.stdout is None           # a file, never a pipe


def test_a_failing_rank_tears_the_job_down(tmp_path):
    """Rank 1 exits 3 before joining; rank 0 would wait for it in the
    rendezvous until killed."""
    monitor = _faulty(tmp_path, fail_rank=1, sleep_s=0)
    t0 = time.time()
    rcs = monitor.wait(timeout_s=60)
    assert rcs[1] == 3 and rcs[0] not in (None, 0)
    assert time.time() - t0 < 30
    assert monitor.all_done()
    assert _report(monitor.workers[1]) == {"rank": 1, "failed": True}


def test_a_job_past_its_timeout_is_killed(tmp_path):
    monitor = _faulty(tmp_path, fail_rank=-1, sleep_s=60)
    with pytest.raises(TimeoutError, match="still running"):
        monitor.wait(timeout_s=4)
    assert monitor.all_done()
    assert all(w.returncode() not in (None, 0) for w in monitor.workers)


def test_barrier_is_a_no_op_in_one_process():
    barrier()
    assert ProcessMonitor().all_done()
