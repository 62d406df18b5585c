#!/usr/bin/env python3
"""Find where the port's ResNet-50 on the card first departs from the same
model on the CPU, layer by layer, quantized and float.

    python3 scripts/torch_int8_layer_diff.py      # needs one CUDA card

Builds ``chip_smoke.py``'s full-width ResNet-50 (weights from seed 0, BN
statistics calibrated on 4 seeded images) on the card and on the CPU, runs
2 seeded images through each, and prints for the int8 and the float model
the max |d prob| and the first 12 layers whose outputs differ: max |d|,
relative to the CPU's max |output|, and how many elements differ. In the
int8 model every layer up to the softmax should print nothing.
"""

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from analytics_zoo_tpu_torch.inference.inference_model import \
    InferenceModel  # noqa: E402


def run(state, x, dev, quantize):
    """(per-layer outputs on the CPU, probabilities, the model)."""
    model = cs.resnet_on(torch, state, dev)
    im = InferenceModel(max_batch_size=len(x), device=dev).load(model)
    if quantize:
        im.quantize_int8()
    outs = {}
    for layer in model.layers:
        layer.register_forward_hook(
            lambda mod, a, y, slot=model.slot(layer): outs.__setitem__(
                slot, y.detach().float().cpu()))
    return outs, im.predict(x), model


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.smi_line())
    state = cs.resnet_state(torch)
    x = np.random.default_rng(11).normal(
        size=(2, cs.IMG, cs.IMG, 3)).astype(np.float32)
    for quantize in (True, False):
        card, p_card, model = run(state, x, "cuda", quantize)
        cpu, p_cpu, _ = run(state, x, "cpu", quantize)
        print(f"{'int8' if quantize else 'float'}: max|d prob| "
              f"{float(np.abs(p_card - p_cpu).max()):.3g}")
        shown = 0
        for layer in model.layers:
            slot = model.slot(layer)
            d = (card[slot] - cpu[slot]).abs()
            if float(d.max()) > 0 and shown < 12:
                print(f"  {slot}: max|d| {float(d.max()):.3g} rel "
                      f"{float(d.max()) / float(cpu[slot].abs().max()):.3g}"
                      f" differing {int((d > 0).sum())} of {d.numel()}")
                shown += 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
