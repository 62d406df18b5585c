#!/usr/bin/env python3
"""Compare the serving phase of ``chip_smoke.py`` between two checkouts of
the PyTorch port on one CUDA card, in turns.

    python3 scripts/torch_serving_ab.py OLD_TREE NEW_TREE [--order ONNOONNO]

Each letter of ``--order`` is one turn: a fresh process that imports that
tree's ``chip_smoke.py``, builds its kernels, makes the full-width model
and runs ``phase_serving`` twice (the first burst warms the process up;
the second is the one compared). Every turn prints one JSON line with
the warm burst's tokens/s, TTFT and ITL; the last line gives each side's
values in turn order. Needs a CUDA card; exits non-zero if a turn fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

_TURN = """
import json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
smi = cs.phase_device(torch)
cs.phase_build()
model = cs.full_model(torch, "cuda")
cs.phase_serving(torch, model, smi)
cs.phase_serving(torch, model, smi)
"""
KEYS = ("tokens_per_s", "ttft_p50_ms", "itl_p50_ms", "itl_p95_ms")


def run_turn(tree: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", _TURN, tree],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"serving turn in {tree} failed:\n"
                           f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    bursts = [json.loads(line.split(" ", 1)[1])
              for line in proc.stdout.splitlines()
              if line.startswith("[serving] {")]
    if len(bursts) != 2:
        raise RuntimeError(f"expected two serving results from {tree}, "
                           f"got {len(bursts)}")
    return bursts[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old_tree")
    ap.add_argument("new_tree")
    ap.add_argument("--order", default="ONNOONNO",
                    help="turns: O = old tree, N = new tree")
    args = ap.parse_args(argv)
    trees = {"O": args.old_tree, "N": args.new_tree}
    if set(args.order) - set(trees):
        ap.error("--order takes only the letters O and N")
    sides = {"O": {k: [] for k in KEYS}, "N": {k: [] for k in KEYS}}
    for i, side in enumerate(args.order):
        res = run_turn(trees[side])
        for k in KEYS:
            sides[side][k].append(res[k])
        print(json.dumps({"turn": i, "side": side, "tree": trees[side],
                          **{k: res[k] for k in KEYS},
                          "sample_tokens_ms": res.get("sample_tokens_ms"),
                          "card": res["card"]}), flush=True)
    print(json.dumps({"old": sides["O"], "new": sides["N"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
