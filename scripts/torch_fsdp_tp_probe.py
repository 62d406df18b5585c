"""What sets the tp cells' update error, and what fsdp keeps whole without
remat, at the LM cell's full width on one CUDA card.

``chip_smoke.py`` phase 19 holds each fsdp/tp cell to the one-rank run by
Δ, ``||Δ − Δ_ref|| / ||Δ_ref||`` over the f32 masters' change in a 2-step
bf16 fit. This script reuses that phase's recipe and helpers (4 rank
processes on the card, the JAX rules placing the leaves, flash attention
on K1/K3/K4) and prints one JSON line per run:

1. Δ of tp=4 and of dp=4 when the fit runs in f32 (the params their own
   masters; the one-rank reference in f32 too), beside tp=4 in bf16 as
   19g runs it. Whether tp's larger bf16 Δ comes from rounding (it falls
   to dp's level in f32) or from the computation (it stays).
2. Each rank's peak memory on fsdp=4 in bf16: remat "flash" (19f),
   remat off, and remat off with the backward's saved-tensor hook
   removed, so that the backward keeps every gathered leaf whole (the
   layout before the hook). These run first, on fresh ranks; every run
   also prints what the runs before it left allocated on each rank.

Run from the repository root on a card: ``python3
scripts/torch_fsdp_tp_probe.py [--out FILE]`` (a few minutes, the
kernels' build included). The lines also go to ``--out`` as a JSON list.
"""

import argparse
import json
import os
import sys
import tempfile
import time

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, _ROOT)

import chip_smoke as cs  # noqa: E402


def _train_keeping_whole(mode, ref_path, compute_dtype, remat):
    """Rank side: ``chip_smoke.mr_train`` with the placement's saved-tensor
    hook packing every tensor as itself (detached), so the backward saves
    gathered leaves whole."""
    from analytics_zoo_tpu_torch.parallel import placement

    pack = placement._pack
    placement._pack = lambda t: t.detach()
    try:
        return cs.mr_train(mode, ref_path, compute_dtype, remat)
    finally:
        placement._pack = pack


def _held():
    """Rank side: the bytes still allocated on the card after garbage
    collection (what earlier runs left), before a run starts."""
    import gc

    import torch

    gc.collect()
    return torch.cuda.memory_allocated()


def _reference(torch, tmp, compute_dtype):
    """The one-rank run of 19b in ``compute_dtype``: its losses and the
    path of its saved Δ."""
    model = cs._mr_lm(torch, "flash")
    init = cs._mr_init(model)
    torch.cuda.reset_peak_memory_stats()
    losses = cs._mr_fit(torch, model, compute_dtype=compute_dtype)
    delta = cs._mr_delta(init, cs._mr_masters(model.estimator))
    path = os.path.join(tmp, f"ref_{compute_dtype}.pt")
    torch.save(delta, path)
    peak = torch.cuda.max_memory_allocated()
    del model, init, delta
    torch.cuda.empty_cache()
    return losses, path, peak


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the lines here, as a list")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_fsdp_tp_probe: needs a CUDA card", file=sys.stderr)
        return 1
    from analytics_zoo_tpu_torch.parallel import comm

    smi = cs.phase_device(torch)
    cs.phase_build(None)
    lines = []

    def emit(d):
        d["card"] = smi
        lines.append(d)
        print(json.dumps(d), flush=True)

    with tempfile.TemporaryDirectory(prefix="zoo_probe_") as tmp:
        refs = {}
        for dt in ("bfloat16", "float32"):
            t = time.perf_counter()
            losses, path, peak = _reference(torch, tmp, dt)
            refs[dt] = (losses, path)
            emit({"run": f"one_rank_{dt}", "losses": losses,
                  "peak_bytes": peak, "wall_s": time.perf_counter() - t})
        runs = [("fsdp", "bfloat16", "flash", cs.mr_train),
                ("fsdp", "bfloat16", False, cs.mr_train),
                ("fsdp", "bfloat16", False, _train_keeping_whole),
                ("tp", "bfloat16", "flash", cs.mr_train),
                ("tp", "float32", "flash", cs.mr_train),
                ("dp", "float32", "flash", cs.mr_train)]
        pool = comm.RankPool(cs.MR_WORLD, device="cuda", threads=0,
                             timeout_s=900)
        try:
            pool.run(cs._mr_reset)
            for mode, dt, remat, fn in runs:
                t = time.perf_counter()
                ref_losses, ref_path = refs[dt]
                held = pool.run(_held)
                res = pool.run(fn, mode, ref_path, dt, remat)
                emit({"run": f"{mode}4_{dt}_remat_{remat}"
                             + ("_saving_whole" if fn is not cs.mr_train
                                else ""),
                      "losses": res[0]["losses"], "reference": ref_losses,
                      "loss_err": max(abs(a - b) for r in res for a, b in
                                      zip(r["losses"], ref_losses)),
                      "delta_err_by_rank": [r["delta_err"] for r in res],
                      "delta_err_skipped": res[0]["delta_err_skipped"],
                      "peak_bytes": [r["peak_bytes"] for r in res],
                      "held_before_bytes": held,
                      "elements": [r["elements"] for r in res],
                      "collectives": res[0]["collectives"],
                      "rank_wall_s": [r["wall_s"] for r in res],
                      "wall_s": time.perf_counter() - t})
        finally:
            pool.close()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
