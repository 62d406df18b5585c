#!/usr/bin/env python3
"""Host time of the K2 (paged attention) wrapper on one CUDA card, part by
part, this checkout against another (the parent commit unpacked with
``git archive``, say).

    python3 scripts/torch_k2_host_cost.py OTHER_TREE

Serving calls the wrapper once per layer and decode step in a host-bound
loop, so its host work is part of every token's latency. At chip_smoke's
decode shape (8 slots, 64 pages of 16, H=16, D=64, q_len 1, bf16) each
line times one part enqueue-only (no sync inside the window): the whole
wrapper on both sides, the C entry alone (the other tree's too where it
predates the split kernel's scratch), the input checks, the output
allocation and the stream lookup. Every part runs 7 rounds of 500 calls,
the parts in turns, and the median is printed with the card's name and
power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_k2_host_cost: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from analytics_zoo_tpu_torch.ops import _build
    from analytics_zoo_tpu_torch.ops import paged_attention as pa

    other = cs.load_parent(args.other)
    _build.build(["paged_attention"])
    other.build.build(["paged_attention"])
    case = pa.synthetic_paged_case(
        cs.N_SLOTS, cs.MAX_SEQ // cs.PAGE, cs.PAGE, cs.N_HEAD,
        cs.HIDDEN // cs.N_HEAD, q_len=1, dtype=torch.bfloat16,
        device="cuda", generator=torch.Generator().manual_seed(2))
    q, kp, vp, table, lens = case
    b, q_len, h, d = q.shape
    pps = table.shape[1]
    out = pa.paged_attention(*case, page_size=cs.PAGE)
    lib = _build.load_library("paged_attention", pa._SIG)
    olib = other.build.load_library("paged_attention", other.paged._SIG)
    stream = torch.cuda.current_stream().cuda_stream
    span = cs.PAGE * -(-pa.SPLIT_POSITIONS // cs.PAGE)
    n_split = -(-(pps * cs.PAGE) // span)
    done, work = pa._scratch(q.device, stream, b * h,
                             b * h * n_split * q_len * (d + 2))
    ptrs = (q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(),
            lens.data_ptr(), out.data_ptr())
    strides = (q.stride(0), q.stride(1), q.stride(2), kp.stride(0),
               kp.stride(1), kp.stride(2), 1.0 / d ** 0.5, stream)
    parts = {
        "wrapper": lambda: pa.paged_attention(*case, page_size=cs.PAGE),
        "other wrapper": lambda: other.paged.paged_attention(
            *case, page_size=cs.PAGE),
        "C entry": lambda: lib.zoo_paged_attention(
            *ptrs, work, done, 1, b, h, d, q_len, cs.PAGE, pps, span,
            *strides),
        "_check": lambda: pa._check(q, kp, vp, table, lens, cs.PAGE),
        "other _check": lambda: other.paged._check(q, kp, vp, table, lens,
                                                   cs.PAGE),
        "output torch.empty": lambda: torch.empty(
            (b, q_len, h, d), dtype=q.dtype, device=q.device),
        "scratch lookup": lambda: pa._scratch(
            q.device, stream, b * h, b * h * n_split * q_len * (d + 2)),
        "current_stream().cuda_stream": lambda: torch.cuda.current_stream(
            q.device).cuda_stream,
        "raw stream": lambda: torch._C._cuda_getCurrentRawStream(
            q.device.index),
    }
    if len(other.paged._SIG["zoo_paged_attention"]) < len(
            pa._SIG["zoo_paged_attention"]):
        # a tree from before the split kernel: its C entry takes no scratch
        parts["other C entry"] = lambda: olib.zoo_paged_attention(
            *ptrs, 1, b, h, d, q_len, cs.PAGE, pps, *strides)
    names = list(parts)
    times = cs.host_us([parts[n] for n in names], n=500, rounds=7)
    print(cs.smi_line())
    for name, us in zip(names, times):
        print(f"{name:30s} {us:8.2f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
