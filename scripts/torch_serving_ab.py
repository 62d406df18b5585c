#!/usr/bin/env python3
"""Compare a serving phase of ``chip_smoke.py`` between two checkouts of
the PyTorch port on one CUDA card, in turns.

    python3 scripts/torch_serving_ab.py OLD_TREE NEW_TREE [--order ONNOONNO]
        [--phase serving|int8_swap]

Each letter of ``--order`` is one turn: a fresh process that imports that
tree's ``chip_smoke.py``, builds its kernels and runs the phase twice (the
first run warms the process up; the second is the one compared).
``serving`` is phase 5's burst on the full-width LM (tokens/s, TTFT,
ITL); ``int8_swap`` is phase 15d, the int8 ResNet-50 swapped under 4
predicting threads (the re-pack and staging ms, the gate's hold ms,
images/s before and after). Every turn prints one JSON line; the last
line gives each side's values in turn order. Needs a CUDA card; exits
non-zero if a turn fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

_SETUP = """
import json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
smi = cs.phase_device(torch)
cs.phase_build()
"""
PHASES = {
    "serving": dict(
        run="model = cs.full_model(torch, 'cuda')\n"
            "cs.phase_serving(torch, model, smi)\n"
            "cs.phase_serving(torch, model, smi)\n",
        tag="[serving] {",
        keys=("tokens_per_s", "ttft_p50_ms", "itl_p50_ms", "itl_p95_ms")),
    "int8_swap": dict(
        run="state = cs.resnet_state(torch)\n"
            "cs.phase15_int8_swap(torch, state, smi)\n"
            "cs.phase15_int8_swap(torch, state, smi)\n",
        tag="[serve-qos] 15d {",
        keys=("stage_ms", "gate_hold_ms", "before_images_per_s",
              "after_images_per_s")),
}


def run_turn(tree: str, phase: str) -> dict:
    spec = PHASES[phase]
    proc = subprocess.run([sys.executable, "-c", _SETUP + spec["run"], tree],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{phase} turn in {tree} failed:\n"
                           f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    runs = [json.loads(line[len(spec["tag"]) - 1:])
            for line in proc.stdout.splitlines()
            if line.startswith(spec["tag"])]
    if len(runs) != 2:
        raise RuntimeError(f"expected two {phase} results from {tree}, "
                           f"got {len(runs)}")
    res = runs[1]
    for w, v in res.get("windows", {}).items():
        res[f"{w}_images_per_s"] = v["images_per_s"]
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old_tree")
    ap.add_argument("new_tree")
    ap.add_argument("--order", default="ONNOONNO",
                    help="turns: O = old tree, N = new tree")
    ap.add_argument("--phase", choices=sorted(PHASES), default="serving")
    args = ap.parse_args(argv)
    keys = PHASES[args.phase]["keys"]
    trees = {"O": args.old_tree, "N": args.new_tree}
    if set(args.order) - set(trees):
        ap.error("--order takes only the letters O and N")
    sides = {"O": {k: [] for k in keys}, "N": {k: [] for k in keys}}
    for i, side in enumerate(args.order):
        res = run_turn(trees[side], args.phase)
        for k in keys:
            sides[side][k].append(res[k])
        print(json.dumps({"turn": i, "side": side, "tree": trees[side],
                          **{k: res[k] for k in keys},
                          "sample_tokens_ms": res.get("sample_tokens_ms"),
                          "card": res["card"]}), flush=True)
    print(json.dumps({"old": sides["O"], "new": sides["N"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
