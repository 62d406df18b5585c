#!/usr/bin/env python3
"""Round trips through the port's serving data plane with a model that
costs next to nothing, to see what the data plane itself costs.

    python3 scripts/torch_data_plane_rtt.py                  # on the card
    python3 scripts/torch_data_plane_rtt.py --device cpu     # host only

A ``ClusterServing`` over a global-average-pool + Dense(10) model serves
224x224x3 f32 images (602 KB, over the shm ring) that N client threads
send one at a time for ``--seconds``, each querying its answer before it
sends the next. The broker runs in this process (``start_broker``) or in a
process of its own (``python -m analytics_zoo_tpu_torch.serving.broker``).
Each (broker, threads) pair runs ``--repeats`` times, the pairs taking
turns; each run prints one JSON line with requests/s, round-trip p50 and
p99, the engine's predict calls and the time inside them, beside the
model's direct batch-1 predict time, and each pair ends with a
``"summary"`` line: the least, median and most of requests/s and p50 over
its runs. Clients, engine and (in-process) the broker share one
interpreter, as in ``chip_smoke.py`` phase 16, so the lines show what
threads contending in one process cost against one client alone.
"""

from __future__ import annotations

import argparse
import json
import select
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _process_broker():
    proc = subprocess.Popen(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.serving.broker",
         "--host", "127.0.0.1", "--port", "0"], cwd=ROOT,
        stdout=subprocess.PIPE, text=True)
    ready, _, _ = select.select([proc.stdout], [], [], 120)
    if not ready:
        proc.kill()
        raise RuntimeError("the broker process printed nothing in 120 s")
    return proc, int(proc.stdout.readline().rsplit(":", 1)[1])


def _pct(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))]


def run(device: str, broker_mode: str, threads: int, seconds: float,
        images: np.ndarray) -> dict:
    from analytics_zoo_tpu_torch.inference.inference_model import \
        InferenceModel
    from analytics_zoo_tpu_torch.nn import layers as L
    from analytics_zoo_tpu_torch.nn.topology import Sequential
    from analytics_zoo_tpu_torch.serving import (ClusterServing, InputQueue,
                                                 OutputQueue, ServingConfig,
                                                 start_broker)

    if broker_mode == "process":
        proc, port = _process_broker()
        broker = None
    else:
        broker, proc = start_broker(), None
        port = broker.port
    im = InferenceModel(supported_concurrent_num=4, max_batch_size=32,
                        device=device).load(Sequential(
                            [L.GlobalAveragePooling2D(input_shape=(224, 224,
                                                                   3)),
                             L.Dense(10)], device=device))
    direct = []
    for _ in range(200):
        t0 = time.perf_counter()
        im.predict(images[:1])
        direct.append(time.perf_counter() - t0)
    calls, busy, predict = [0], [0.0], im.predict

    def counted(x):
        calls[0] += 1
        t = time.perf_counter()
        y = predict(x)
        busy[0] += time.perf_counter() - t
        return y

    im.predict = counted
    job = ClusterServing(im, ServingConfig(queue_port=port, batch_size=32,
                                           graph_checks="off"),
                         group="rtt").start()
    lat, errors = [], []

    def client(t):
        iq, oq = InputQueue(port=port), OutputQueue(port=port)
        try:
            while time.perf_counter() < deadline:
                t0 = time.perf_counter()
                oq.query(iq.enqueue(None, input=images[t]), timeout_s=120)
                lat.append(time.perf_counter() - t0)
        except Exception as e:               # reported below
            errors.append(repr(e))
        finally:
            iq.close()
            oq.close()

    try:
        ths = [threading.Thread(target=client, args=(t,))
               for t in range(threads)]
        t0 = time.perf_counter()
        deadline = t0 + seconds
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=seconds + 600)
        wall = time.perf_counter() - t0
    finally:
        job.stop()
        if broker is not None:
            broker.shutdown()
            broker.server_close()
        else:
            proc.terminate()
            proc.wait(timeout=30)
    if errors:
        raise RuntimeError(f"clients failed: {errors[:3]}")
    return {"broker": broker_mode, "threads": threads,
            "requests": len(lat), "requests_per_s": len(lat) / wall,
            "rtt_p50_ms": _pct(lat, 50) * 1e3,
            "rtt_p99_ms": _pct(lat, 99) * 1e3,
            "engine_predicts": calls[0], "engine_predict_s": busy[0],
            "engine_predict_ms_mean": busy[0] / max(1, calls[0]) * 1e3,
            "direct_predict_ms_p50": statistics.median(direct) * 1e3,
            "wall_s": wall}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--threads", default="1,4")
    ap.add_argument("--seconds", type=float, default=10.0,
                    help="length of each run's window")
    ap.add_argument("--repeats", type=int, default=3,
                    help="runs of each (broker, threads) pair")
    ap.add_argument("--broker", choices=("inproc", "process", "both"),
                    default="both")
    args = ap.parse_args(argv)
    import torch

    card = "cpu (host only)"
    if args.device != "cpu":
        if not torch.cuda.is_available():
            print("torch_data_plane_rtt: CUDA is not available; pass "
                  "--device cpu for the host-only run", file=sys.stderr)
            return 1
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    threads = [int(t) for t in args.threads.split(",")]
    images = np.random.default_rng(0).normal(
        size=(max(threads), 224, 224, 3)).astype(np.float32)
    modes = ("inproc", "process") if args.broker == "both" \
        else (args.broker,)
    pairs = [(mode, n) for mode in modes for n in threads]
    runs = {pair: [] for pair in pairs}
    for _ in range(args.repeats):
        for mode, n in pairs:
            res = run(args.device, mode, n, args.seconds, images)
            res["device"] = card
            runs[(mode, n)].append(res)
            print(json.dumps(res), flush=True)
    for (mode, n), rs in runs.items():
        summary = {"summary": True, "broker": mode, "threads": n,
                   "runs": len(rs), "seconds": args.seconds, "device": card}
        for key in ("requests_per_s", "rtt_p50_ms",
                    "engine_predict_ms_mean"):
            xs = [r[key] for r in rs]
            summary[key] = {"min": min(xs), "median": statistics.median(xs),
                            "max": max(xs)}
        print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
