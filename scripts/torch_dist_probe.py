#!/usr/bin/env python3
"""Which collectives the installed torch's gloo backend runs, and what
NCCL says to two ranks on one card.

    python3 scripts/torch_dist_probe.py            # 2 CPU ranks on gloo;
                                                   # on a CUDA host also the
                                                   # NCCL probe below

Prints one JSON line per probe: the torch and CUDA versions; for gloo, each
collective ``ok`` or the error it raised (2 ranks, CPU tensors: gloo given
a CUDA tensor by a collective it does not stage aborts the process with
``gloo::IoException``, so the port stages CUDA tensors through host
buffers and this probe does not try them); for NCCL, the error (or ``ok``)
of an all-reduce on a communicator whose two ranks both hold ``cuda:0``.
"""

import json
import os
import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gloo_rank(rank, world, port, q):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    out = {}
    for dev in ["cpu"]:
        x = torch.arange(4.0, device=dev) + rank
        probes = {
            "all_reduce": lambda: dist.all_reduce(x.clone()),
            "all_gather": lambda: dist.all_gather(
                [torch.empty_like(x) for _ in range(world)], x),
            "reduce_scatter": lambda: dist.reduce_scatter(
                torch.empty(2, device=dev), list(x.clone().chunk(2))),
            "all_to_all": lambda: dist.all_to_all(
                list(torch.empty(4, device=dev).chunk(2)),
                list(x.clone().chunk(2))),
            "send_recv": lambda: [r.wait() for r in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, (rank + 1) % world),
                dist.P2POp(dist.irecv, torch.empty_like(x),
                           (rank - 1) % world)])],
        }
        for name, fn in probes.items():
            try:
                fn()
                out[f"{dev}:{name}"] = "ok"
            except Exception as e:          # noqa: BLE001 - the probe's result
                out[f"{dev}:{name}"] = f"{type(e).__name__}: {e}"[:300]
            dist.barrier()
    dist.destroy_process_group()
    q.put((rank, out))


def _nccl_rank(rank, world, port, q):
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)
        x = torch.ones(4, device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        res = "ok"
    except Exception as e:                  # noqa: BLE001 - the probe's result
        res = f"{type(e).__name__}: {e}"[:600]
    q.put((rank, res))


def _run(target, world=2, timeout=120):
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=target, args=(r, world, port, q))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(world):
            r, res = q.get(timeout=timeout)
            got[r] = res
    except Exception as e:                  # noqa: BLE001 - a hung probe
        got["timeout"] = f"{type(e).__name__}: {e}"
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
    return got


def main() -> int:
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "python": sys.version.split()[0]}), flush=True)
    print(json.dumps({"gloo": _run(_gloo_rank).get(0)}), flush=True)
    if torch.cuda.is_available():
        print(json.dumps({"nccl_two_ranks_one_card": _run(_nccl_rank,
                                                          timeout=60)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
