#!/usr/bin/env python3
"""Build edited copies of K1's source (``csrc/flash_fwd.cu``) and hold them
against each other on one CUDA card.

    python3 scripts/torch_k1_variants.py A.cu B.cu ...          # build, time
    python3 scripts/torch_k1_variants.py --build-only A.cu ...  # ptxas only
    python3 scripts/torch_k1_variants.py --check                # this tree

Each variant is a whole copy of ``flash_fwd.cu`` (with its own edit: a ring
depth, a tile size, a part of the softmax taken out) compiled with the
port's nvcc flags, all at once, into a temporary directory; the script
prints whether ptxas serialized its wgmma instructions (warning C7513) and
its spill stores. Unless ``--build-only``, each library's ``zoo_flash_fwd``
is then called on the same bf16 inputs (the training micro-batch B=2
T=2048 H=16 D=64 and the serving prefill B=1 T=1024, causal, q/k/v strided
out of one fused QKV tensor), its max |out - plain| printed (an edit that
drops work is meant to be wrong), and its device-only time taken by
chip_smoke's ``DeviceTimer`` in two rounds, the variants in turns, beside
SDPA's forward. ``--check`` holds this tree's K1 to its plain version at 11
shapes (T at and off the 128-row tiles, Tq != Tk both ways, D 16 to 256).
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CHECK_SHAPES = [(1, 64, 64, 64, False), (1, 128, 128, 64, False),
                (1, 128, 128, 64, True), (2, 300, 300, 64, True),
                (1, 129, 129, 128, True), (1, 200, 200, 256, True),
                (1, 65, 65, 16, False), (1, 100, 100, 96, True),
                (1, 70, 40, 64, True), (1, 40, 70, 64, True),
                (2, 2048, 2048, 64, True)]


def build(paths, out_dir):
    """Compile each variant at once; returns {path: library or None}."""
    from analytics_zoo_tpu_torch.ops import _build

    procs = {}
    for p in paths:
        lib = Path(out_dir) / (Path(p).stem + ".so")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
               str(_build.CSRC_DIR), "-o", str(lib), str(p)]
        procs[p] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    lib)
    libs = {}
    for p, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        spills = sorted({line.strip() for line in log.splitlines()
                         if "spill stores" in line})
        print(f"== {p}: exit {proc.returncode}, C7513 x "
              f"{log.count('C7513')}; {spills}", flush=True)
        libs[p] = lib if proc.returncode == 0 else None
    return libs


def caller(lib_path):
    from analytics_zoo_tpu_torch.ops import flash_attention as tfa
    import torch

    fn = ctypes.CDLL(str(lib_path)).zoo_flash_fwd
    fn.argtypes = tfa._SIG["zoo_flash_fwd"]
    fn.restype = ctypes.c_int

    def call(q, k, v):
        b, tq, h, d = q.shape
        out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), 1, b, h, tq, k.shape[1], d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], 1,
                 d ** -0.5, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{lib_path}: launch failed ({err})")
        return out, lse
    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*",
                    help="edited copies of flash_fwd.cu")
    ap.add_argument("--build-only", action="store_true")
    ap.add_argument("--check", action="store_true",
                    help="hold this tree's K1 to its plain version")
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_k1_variants: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from analytics_zoo_tpu_torch.ops import flash_attention as tfa

    print(cs.smi_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.check:
        for b, t, tk, d, causal in CHECK_SHAPES:
            q = torch.randn((b, t, 16, d), generator=gen, device="cuda")
            k, v = (torch.randn((b, tk, 16, d), generator=gen, device="cuda")
                    for _ in range(2))
            q, k, v = (x.bfloat16() for x in (q, k, v))
            out, lse = tfa.flash_attention_fwd(q, k, v, causal)
            ref, ref_lse = tfa.flash_attention_plain(q, k, v, causal)
            print(f"B={b} T={t} Tk={tk} D={d} causal={causal}: max|d out| "
                  f"{cs.maxerr(out, ref):.3g} max|d lse| "
                  f"{cs.maxerr(lse, ref_lse):.3g}", flush=True)
    if not args.variants:
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(args.variants, tmp)
        if args.build_only:
            return 0 if all(libs.values()) else 1
        qkv = torch.randn((2, 2048, 3, 16, 64), generator=gen,
                          device="cuda").bfloat16()
        train = qkv.unbind(2)
        serve = tuple(torch.randn((1, 1024, 16, 64), generator=gen,
                                  device="cuda").bfloat16() for _ in range(3))
        ref, _ = tfa.flash_attention_plain(*train, True)
        calls = {p: caller(lib) for p, lib in libs.items() if lib}
        for p, call in calls.items():
            print(f"{p}: max|d out| {cs.maxerr(call(*train)[0], ref):.3g}",
                  flush=True)
        timer = cs.DeviceTimer(torch, torch.empty(128 << 20, dtype=torch.uint8,
                                                  device="cuda"))
        for rnd in range(2):
            for p, call in calls.items():
                print(f"round {rnd} {p}: device ms B=2 T=2048 "
                      f"{timer(lambda: call(*train)):.5f}, B=1 T=1024 "
                      f"{timer(lambda: call(*serve)):.5f}", flush=True)
        qt, kt, vt = (x.transpose(1, 2) for x in train)
        sdpa = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        print(f"SDPA forward B=2 T=2048 device ms {sdpa:.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
