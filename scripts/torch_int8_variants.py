#!/usr/bin/env python3
"""Build edited copies of the int8 kernels' sources (K5, K6) and hold them
against each other on one CUDA card.

    python3 scripts/torch_int8_variants.py                 # this tree
    python3 scripts/torch_int8_variants.py DIR [DIR ...]   # and variants
    python3 scripts/torch_int8_variants.py --stem-tc DIR   # + the stem on
                                                           # tensor cores

Each DIR is a whole copy of ``analytics_zoo_tpu_torch/csrc`` with its own
edit (a tile shape, a ring depth, a thread tile of the Cin <= 4 kernel, the
quantize pass's loads in flight); this tree's ``csrc`` is always the first
variant. Each variant's ``int8_matmul.cu`` and ``int8_conv.cu`` are compiled
with the port's nvcc flags, all at once, into a temporary directory, and
its spill stores printed. Each library is then called through its C entry by
the wrappers' own launch code (``ops/int8_fused.py``'s ``_matmul_on`` and
``_conv_on``) on the same f32 inputs:
K5 at the int8 MLP's (2048, 4096) x (4096, 4096), g = 512, and K6 at
ResNet-50's 3x3/1 64->64 at 56 px, 1x1/1 64->256 and 256->64 at 56 px,
3x3/1 128->128 at 28 px, 3x3/1 256->256 at 14 px, 1x1/1 1024->256 at 14
px, 1x1/2 512->1024 at 28 px and the 7x7/2 stem, batch 32. Each result is
checked bitwise against the plain version and each call timed device-only
by chip_smoke's ``DeviceTimer`` in two rounds, the variants in turns; then
each K6 shape's time is split by kernel (quantize pass, GEMM) for this
tree. ``--stem-tc`` also times the stem through the tensor-core GEMM, its
3 channels padded with zeros to 8 (the same bits). Needs a CUDA card and
nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
CONVS = [(56, 3, 64, 64, 1), (56, 1, 64, 256, 1), (56, 1, 256, 64, 1),
         (28, 3, 128, 128, 1), (14, 3, 256, 256, 1), (14, 1, 1024, 256, 1),
         (28, 1, 512, 1024, 2), (224, 7, 3, 64, 2)]
BATCH = 32


def build(dirs, out_dir):
    """Compile each variant's two libraries at once; returns {(dir, lib):
    ctypes library}."""
    from analytics_zoo_tpu_torch.ops import _build
    from analytics_zoo_tpu_torch.ops import int8_fused as f8

    procs = {}
    for i, d in enumerate(dirs):
        for lib in ("int8_matmul", "int8_conv"):
            out = Path(out_dir) / f"{i}_{lib}.so"
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(d),
                   "-o", str(out), str(Path(d) / f"{lib}.cu")]
            procs[(d, lib)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), out)
    libs = {}
    for (d, lib), (proc, out) in procs.items():
        log = proc.communicate()[0]
        spills = sorted({line.strip() for line in log.splitlines()
                         if "spill stores" in line
                         and " 0 bytes spill stores" not in line})
        print(f"== {d} {lib}: exit {proc.returncode}; {spills}", flush=True)
        if proc.returncode:
            print(log[-3000:])
            continue
        lib_ = ctypes.CDLL(str(out))
        for fn, sig in {**f8._SIG_MM, **f8._SIG_CONV}.items():
            if hasattr(lib_, fn):
                getattr(lib_, fn).argtypes = sig
                getattr(lib_, fn).restype = ctypes.c_int
        libs[(d, lib)] = lib_
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="*", help="edited copies of csrc")
    ap.add_argument("--stem-tc", action="store_true",
                    help="also time the stem on the tensor-core GEMM")
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from analytics_zoo_tpu_torch.ops import _build
    from analytics_zoo_tpu_torch.ops import int8_fused as f8
    from torch.profiler import ProfilerActivity, profile

    dirs = [str(_build.CSRC_DIR)] + [str(Path(d).resolve())
                                     for d in args.dirs]
    print(cs.smi_line(), flush=True)
    tmp = tempfile.mkdtemp(prefix="int8_variants_")
    libs = build(dirs, tmp)
    timer = cs.Timer(torch)
    dtimer = cs.DeviceTimer(torch, timer.flush)
    rng = np.random.default_rng(0)
    cases = []
    x = torch.randn((2048, 4096), device="cuda") * 3
    packed = cs._i8_packed(torch, rng, (4096, 4096))
    cases.append(("K5 (2048, 4096) x (4096, 4096) g=512", "int8_matmul",
                  lambda lib, x=x, p=packed: f8._matmul_on(
                      lib, x, p["qt"], p["scale"].reshape(-1), 512, "fused"),
                  f8.int8_matmul_fused_plain(x, packed, 512)))
    for hw, k, cin, cout, st in CONVS:
        packed = cs._i8_packed(torch, rng, (k, k, cin, cout))
        pads = f8.same_pads((hw, hw), (k, k), (st, st))
        rule = "fused" if st == 1 else "lax"
        x = torch.randn((BATCH, hw, hw, cin), device="cuda")
        ref = f8.int8_conv2d_fused_plain(x, packed, (st, st), pads, rule)
        cases.append((f"K6 {k}x{k}/{st} {cin}->{cout} @{hw}", "int8_conv",
                      lambda lib, x=x, p=packed, s=st, pd=pads, r=rule:
                      f8._conv_on(lib, x, p["qt"], p["scale"].reshape(-1),
                                  (s, s), pd, r), ref))
        if cin == 3 and args.stem_tc:
            # the same conv on the tensor-core path: channels padded to 8
            xp = F.pad(x, (0, 5))
            qp = F.pad(packed["q"], (0, 0, 0, 5)).contiguous()
            pp = {"q": qp, "scale": packed["scale"],
                  "qt": f8.kernel_major(qp)}
            cases.append(("K6 stem on tensor cores (Cin 3 padded to 8)",
                          "int8_conv",
                          lambda lib, x=xp, p=pp, s=st, pd=pads, r=rule:
                          f8._conv_on(lib, x, p["qt"],
                                      p["scale"].reshape(-1), (s, s), pd, r),
                          ref))
    for name, kind, fn, ref in cases:
        for d in dirs:
            if (d, kind) in libs:
                same = torch.equal(fn(libs[(d, kind)]), ref)
                print(f"{name} {d}: bitwise equal to plain: {same}",
                      flush=True)
    times = {}
    for _ in range(2):
        for name, kind, fn, _ in cases:
            for d in dirs:
                if (d, kind) in libs:
                    lib = libs[(d, kind)]
                    times.setdefault((name, d), []).append(
                        dtimer(lambda: fn(lib)))
    for (name, d), ts in times.items():
        print(f"{name:44s} {d}: device ms "
              + " ".join(f"{t:.5f}" for t in ts))
    for name, kind, fn, _ in cases:
        if kind != "int8_conv":
            continue
        lib = libs[(dirs[0], kind)]
        for _ in range(3):
            fn(lib)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                timer.flush.zero_()
                fn(lib)
            torch.cuda.synchronize()
        for key, c, ms in cs._device_rows(prof)[0]:
            if "quantize" in key or "gemm" in key or "dp4a" in key:
                print(f"  {name}: {ms / c:.5f} ms x{c} {key[:80]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
