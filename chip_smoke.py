#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # device, build and kernel checks only

Phases, each fatal on failure (no result line is printed then):

1. device: the card's name and power limit, torch/CUDA versions; TF32 off
   for matmuls and cuDNN so the f32 checks compare f32 arithmetic.
2. build: compile every kernel in ``analytics_zoo_tpu_torch/csrc`` with
   nvcc (one process per source, all at once), timed.
3. kernels: K1 (flash forward, out + LSE) and K2 (paged attention, q_len 1
   and 4, with a zero-length slot) against their plain PyTorch versions on
   the card, f32 within 1e-4 and bf16 within 2e-2, and timed with CUDA
   events (median of 30 launches after warm-up, L2 flushed before each):
   the kernel, its plain version, one library call computing the same
   function (a yardstick the port never calls), and the bound — the larger
   of bytes over 3.35 TB/s and operations over the peak rate of the inputs'
   type.
4. parity: the full-width f32 model on the card (kernels) against the same
   seeded model on the CPU (plain versions): a 128-token prefill and 8
   decode steps teacher-forced with the CPU's tokens, logits within 1e-3
   (12 layers and another summation order grow the f32 error).
5. serving: the full-width model in bf16 under ContinuousBatcher(n_slots=8,
   page_size=16, max_seq_len=1024): 16 requests with seeded prompt lengths
   in 8..700, 32 new tokens each, 12 greedy and 4 at temperature 0.8. Every
   stream must end ok with 32 tokens, the launch counts of both kernels
   (set to 0 just before) must show one K1 launch per prefill and layer and
   one K2 launch per decode step and layer, and greedy tokens must be the
   argmax of a full forward over the emitted sequence.

The last three lines of standard output are the card's name and power
limit, the per-kernel JSON, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the repo's documented serving model (docs/programming-guide/generation.md)
VOCAB, HIDDEN, N_BLOCK, N_HEAD, SEQ_LEN = 32000, 1024, 12, 16, 2048
N_SLOTS, PAGE, MAX_SEQ = 8, 16, 1024
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


class Timer:
    """Median CUDA-event time of ``fn`` over ``n`` launches after warm-up,
    with the L2 cache flushed (a 128 MiB write) before each launch."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, n: int = 30, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(n):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def maxerr(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ------------------------------------------------------------------- phases

def phase_device(torch):
    smi = smi_line()
    log(f"[device] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    log(f"[device] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32}"
        f" cudnn={torch.backends.cudnn.allow_tf32} -> both set False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from analytics_zoo_tpu_torch.ops import _build

    t0 = time.perf_counter()
    secs = _build.build()
    log(f"[build] {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
        f"wall {time.perf_counter() - t0:.2f}s into {_build.BUILD_DIR}")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def check_k1(torch, timer):
    import torch.nn.functional as F
    from analytics_zoo_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_plain)

    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    cases = [(t, 64, dt) for t in (16, 100, 1024)
             for dt in ("float32", "bfloat16")]
    cases += [(100, 128, "float32"), (100, 128, "bfloat16")]
    for t, d, dt in cases:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn((1, t, N_HEAD, d), generator=gen,
                               device="cuda").to(dtype) for _ in range(3))
        out, lse = flash_attention_fwd(q, k, v, True)
        ref, ref_lse = flash_attention_plain(q, k, v, True)
        torch.cuda.synchronize()
        e_out, e_lse = maxerr(out, ref), maxerr(lse, ref_lse)
        ok = e_out <= TOL[dt] and e_lse <= TOL[dt]
        log(f"[K1] T={t} D={d} {dt} causal: max|d out| {e_out:.3g} "
            f"max|d lse| {e_lse:.3g} (tol {TOL[dt]}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"T={t} D={d} {dt}")
    # timed at the longest prefill bucket of the serving path, in bf16
    t, d, dt = 1024, 64, "bfloat16"
    q, k, v = (torch.randn((1, t, N_HEAD, d), generator=gen,
                           device="cuda").to(torch.bfloat16)
               for _ in range(3))
    out, lse = flash_attention_fwd(q, k, v, True)
    ref, ref_lse = flash_attention_plain(q, k, v, True)
    worst = max(maxerr(out, ref), maxerr(lse, ref_lse))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ms = timer(lambda: flash_attention_fwd(q, k, v, True))
    plain = timer(lambda: flash_attention_plain(q, k, v, True))
    lib = timer(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True))
    elt = 2
    nbytes = 4 * t * N_HEAD * d * elt + N_HEAD * t * 4
    flops = 4 * N_HEAD * d * (t * (t + 1) // 2)
    bms, by = bound_ms(nbytes, flops, dt)
    return {"name": "flash_fwd", "route": "cuda",
            "source": "analytics_zoo_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "analytics_zoo_tpu/ops/flash_attention.py:46",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": lib,
            "shape": f"B=1 T={t} H={N_HEAD} D={d} causal", "dtype": dt}


def check_k2(torch, timer):
    import torch.nn.functional as F
    from analytics_zoo_tpu_torch.ops.kv_cache import paged_read
    from analytics_zoo_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_plain, synthetic_paged_case)

    pps = MAX_SEQ // PAGE
    gen = torch.Generator().manual_seed(2)
    # a zero-length (inactive) slot among a ladder of live lengths
    lengths = [0, 37, 130, 255, 400, 600, 777, 1024]
    for dt in ("float32", "bfloat16"):
        for q_len in (1, 4):
            dtype = getattr(torch, dt)
            case = synthetic_paged_case(
                N_SLOTS, pps, PAGE, N_HEAD, HIDDEN // N_HEAD, q_len=q_len,
                dtype=dtype, lengths=lengths, device="cuda", generator=gen)
            out = paged_attention(*case, page_size=PAGE)
            ref = paged_attention_plain(*case, page_size=PAGE)
            torch.cuda.synchronize()
            e = maxerr(out, ref)
            zero = float(out[0].float().abs().max())
            ok = e <= TOL[dt] and zero == 0.0
            log(f"[K2] slots={N_SLOTS} pps={pps} page={PAGE} q_len={q_len} "
                f"{dt}: max|d| {e:.3g} (tol {TOL[dt]}), zero-length slot "
                f"max|out| {zero} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K2 disagrees with its plain version "
                                     f"at q_len={q_len} {dt}")
    # timed at the decode shape of the serving path (q_len 1, bf16), with a
    # half-full ladder of lengths (the steady serving regime)
    d = HIDDEN // N_HEAD
    case = synthetic_paged_case(N_SLOTS, pps, PAGE, N_HEAD, d, q_len=1,
                                dtype=torch.bfloat16, device="cuda",
                                generator=gen)
    q, kp, vp, table, lens = case
    out = paged_attention(*case, page_size=PAGE)
    worst = maxerr(out, paged_attention_plain(*case, page_size=PAGE))
    ks, vs = paged_read(kp, table), paged_read(vp, table)
    mask = (torch.arange(ks.shape[1], device="cuda")[None, :]
            < lens.long()[:, None])[:, None, None, :]         # (B,1,1,T)
    qt, kt, vt = q.transpose(1, 2), ks.transpose(1, 2), vs.transpose(1, 2)
    ms = timer(lambda: paged_attention(*case, page_size=PAGE))
    plain = timer(lambda: paged_attention_plain(*case, page_size=PAGE))
    lib = timer(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       attn_mask=mask))
    n_valid = int(lens.sum())
    elt = 2
    nbytes = (2 * n_valid * N_HEAD * d * elt          # K and V read
              + 2 * N_SLOTS * N_HEAD * d * elt        # q read, out written
              + sum(-(-int(x) // PAGE) for x in lens) * 4 + N_SLOTS * 4)
    flops = 4 * N_HEAD * d * n_valid
    bms, by = bound_ms(nbytes, flops, "bfloat16")
    return {"name": "paged_attention", "route": "cuda",
            "source": "analytics_zoo_tpu_torch/csrc/paged_attention.cu",
            "replaces": "analytics_zoo_tpu/ops/paged_attention.py:113",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": lib,
            "shape": (f"slots={N_SLOTS} pps={pps} page={PAGE} H={N_HEAD} "
                      f"D={d} q_len=1 lengths={lens.tolist()}"),
            "dtype": "bfloat16"}


def full_model(torch, device):
    from analytics_zoo_tpu_torch.models.transformer import TransformerLM

    return TransformerLM(vocab=VOCAB, hidden_size=HIDDEN, n_block=N_BLOCK,
                         n_head=N_HEAD, seq_len=SEQ_LEN,
                         attn_strategy="flash", device=device, seed=0)


def phase_parity(torch, gpu_model):
    import numpy as np

    from analytics_zoo_tpu_torch.ops.kv_cache import SCRATCH_PAGE

    cpu_model = full_model(torch, "cpu")
    rng = np.random.default_rng(3)
    n_prompt, steps = 128, 8
    prompt = rng.integers(1, VOCAB, size=n_prompt).astype(np.int32)
    caches = {}
    for name, m in (("cuda", gpu_model), ("cpu", cpu_model)):
        cfg, cache = m.init_kv_cache(2, page_size=PAGE, max_seq_len=MAX_SEQ,
                                     dtype=torch.float32)
        caches[name] = (cfg, cache)
    cfg = caches["cpu"][0]
    table = np.full((2, cfg.pages_per_slot), SCRATCH_PAGE, np.int32)
    n_pg = -(-(n_prompt + steps) // PAGE)
    table[0, :n_pg] = np.arange(1, n_pg + 1)   # slot 1 stays inactive
    ids = np.zeros((2, n_prompt), np.int32)
    ids[0] = prompt
    lens = np.array([n_prompt, 0], np.int32)
    worst = 0.0
    logits = {}
    for name, m in (("cuda", gpu_model), ("cpu", cpu_model)):
        lg, _ = m.prefill(caches[name][1], ids, lens, table, page_size=PAGE)
        logits[name] = lg[0].cpu()
    worst = max(worst, maxerr(logits["cuda"], logits["cpu"]))
    tok = int(logits["cpu"].argmax())
    zeros = np.zeros(2, np.int64)
    for s in range(steps):
        step_ids = np.array([tok, 0], np.int32)
        pos = np.array([n_prompt + s, 0], np.int32)
        for name, m in (("cuda", gpu_model), ("cpu", cpu_model)):
            _, lg, _ = m.decode_step(caches[name][1], step_ids, pos, table,
                                     zeros, zeros, np.zeros(2, np.float32),
                                     page_size=PAGE)
            logits[name] = lg[0].cpu()
        assert torch.isfinite(logits["cuda"]).all()
        worst = max(worst, maxerr(logits["cuda"], logits["cpu"]))
        tok = int(logits["cpu"].argmax())      # teacher-forced by the CPU
    ok = worst <= 1e-3
    log(f"[parity] full-width f32 cuda vs cpu, 128-token prefill + {steps} "
        f"decode steps: max|d logits| {worst:.3g} (tol 1e-3) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("full-width cuda logits disagree with cpu")
    del cpu_model


def pct(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))]


def phase_serving(torch, model, smi):
    import numpy as np

    from analytics_zoo_tpu_torch.nn.module import set_policy
    from analytics_zoo_tpu_torch.ops.flash_attention import \
        flash_attention_fwd
    from analytics_zoo_tpu_torch.ops.paged_attention import paged_attention
    from analytics_zoo_tpu_torch.serving.generation import ContinuousBatcher

    set_policy(compute_dtype="bfloat16")
    model.to(torch.bfloat16)
    rng = np.random.default_rng(4)
    n_req, n_new = 16, 32
    lens = rng.integers(8, 701, size=n_req)
    prompts = [rng.integers(1, VOCAB, size=int(n)).astype(np.int32)
               for n in lens]
    temps = [0.0] * 12 + [0.8] * 4
    batcher = ContinuousBatcher(model, n_slots=N_SLOTS, page_size=PAGE,
                                max_seq_len=MAX_SEQ, device="cuda",
                                autostart=False)
    emits = [[] for _ in range(n_req)]
    try:
        flash_attention_fwd.launches = 0
        paged_attention.launches = 0
        t0 = time.perf_counter()
        handles = []
        for i in range(n_req):
            handles.append(batcher.submit(
                prompts[i], max_new_tokens=n_new, temperature=temps[i],
                seed=100 + i,
                on_chunk=lambda toks, final, meta, i=i: emits[i].append(
                    (time.perf_counter(), len(toks), final, meta))))
        batcher.start()
        outs = [h.result(timeout_s=600) for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1, k2 = flash_attention_fwd.launches, paged_attention.launches
        stats = batcher.stats()
    finally:
        batcher.close()
    finals = [e[-1][3] for e in emits]
    bad = [(i, f.get("outcome"), len(outs[i])) for i, f in enumerate(finals)
           if f.get("outcome") != "ok" or len(outs[i]) != n_new]
    if bad:
        raise AssertionError(f"streams not ok with {n_new} tokens: {bad}")
    steps = stats["steps"]
    log(f"[serving] launches: K1 {k1} (need {n_req} prefills x {N_BLOCK} "
        f"layers = {n_req * N_BLOCK}), K2 {k2} (need {steps} decode steps x "
        f"{N_BLOCK} layers = {steps * N_BLOCK})")
    if k1 < n_req * N_BLOCK or k2 < steps * N_BLOCK or steps < 1:
        raise AssertionError("the serving path did not go through both "
                             "kernels")
    # greedy streams must be the argmax of a full forward (flash path) over
    # prompt + emitted tokens, up to bf16 rounding: the chosen token's logit
    # within a small margin of the row max
    margins = []
    for i in range(3):
        seq = np.concatenate([prompts[i], np.asarray(outs[i][:-1], np.int32)])
        lg = model.apply(torch.as_tensor(seq[None]))[0].float()
        rows = lg[len(prompts[i]) - 1:]
        chosen = rows[torch.arange(n_new), torch.as_tensor(outs[i]).long()]
        margins.append(float((rows.max(dim=-1).values - chosen).max()))
    log(f"[serving] greedy argmax margins vs full forward: "
        f"{[round(m, 4) for m in margins]}")
    if max(margins) > 0.1:
        raise AssertionError("greedy tokens are not the argmax of a full "
                             "forward")
    ttft = [f[0][3]["ttft_s"] for f in emits]
    itl = []
    for e in emits:
        ts = [t for t, n, final, _ in e if not final and n]
        itl += [b - a for a, b in zip(ts, ts[1:])]
    n_tok = sum(len(o) for o in outs)
    res = {"requests": n_req, "tokens": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall, "ttft_p50_ms": pct(ttft, 50) * 1e3,
           "itl_p50_ms": pct(itl, 50) * 1e3, "itl_p95_ms": pct(itl, 95) * 1e3,
           "decode_steps": steps, "prompt_tokens": int(lens.sum()),
           "prefill_buckets": stats["prefill_buckets"],
           "slot_occupancy": stats["slot_occupancy"], "card": smi}
    log(f"[serving] {json.dumps(res)}")
    return k1, k2


def phase_profile(torch, model, smi):
    """Trace one burst of 8 requests (256-token prompts, 32 new tokens,
    greedy) and print the device time by kernel and the device's busy
    share of the traced wall time."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from analytics_zoo_tpu_torch.serving.generation import ContinuousBatcher

    rng = np.random.default_rng(5)
    batcher = ContinuousBatcher(model, n_slots=N_SLOTS, page_size=PAGE,
                                max_seq_len=MAX_SEQ, device="cuda",
                                autostart=False)
    try:
        handles = [batcher.submit(rng.integers(1, VOCAB, size=256),
                                  max_new_tokens=32) for _ in range(N_SLOTS)]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            batcher.start()
            for h in handles:
                h.result(timeout_s=600)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        steps = batcher.stats()["steps"]
    finally:
        batcher.close()

    def dev_ms(evt, attr):
        v = getattr(evt, attr.replace("cuda", "device"), None)
        return (v if v is not None else getattr(evt, attr, 0.0)) / 1e3

    rows = [(e.key, e.count, dev_ms(e, "self_cuda_time_total"))
            for e in prof.key_averages()]
    rows = [r for r in rows if r[2] > 0]
    busy = sum(r[2] for r in rows)
    log(f"[profile] {smi} | burst of {N_SLOTS} x (256 prompt + 32 new), "
        f"{steps} decode steps, wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms ({busy / wall_ms:.3f} of wall)")
    for key, count, ms in sorted(rows, key=lambda r: -r[2])[:15]:
        log(f"[profile] {ms:9.3f} ms {count:6d} calls  {key[:100]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="device, build and kernel checks only")
    ap.add_argument("--profile", action="store_true",
                    help="after serving, trace one more burst with "
                         "torch.profiler and print where the device time "
                         "goes")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "a CUDA card", file=sys.stderr)
        return 1
    if not (ROOT / "analytics_zoo_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no analytics_zoo_tpu_torch package beside "
              f"{__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        smi = phase_device(torch)
        phase_build()
        timer = Timer(torch)
        kernels = [check_k1(torch, timer), check_k2(torch, timer)]
        del timer
        if not args.quick:
            gpu_model = full_model(torch, "cuda")
            phase_parity(torch, gpu_model)
            k1, k2 = phase_serving(torch, gpu_model, smi)
            kernels[0]["launches"], kernels[1]["launches"] = k1, k2
            if args.profile:
                phase_profile(torch, gpu_model, smi)
        for k in kernels:
            for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                        "max_abs_err"):
                if not math.isfinite(k[key]):
                    raise AssertionError(f"{k['name']}: {key} not finite")
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
