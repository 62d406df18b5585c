#!/usr/bin/env python3
"""The JAX package's own int8-versus-float gap of SSD300-VGG16's raw head
outputs, on the CPU, at a small width: the yardstick ``chip_smoke.py``
phase 23a holds the port's int8 SSD300 on the card to (twice this).

    python3 scripts/torch_ssd_int8_gap.py [--base-filters 8] [--images 2]

Builds the JAX ``SSD300VGG(21, base_filters)`` from ``PRNGKey(0)``
(jitted), runs seeded 300x300 images (``chip_smoke.ssd_images``, seed 23)
through its float forward and through ``InferenceModel.quantize_int8``
with the fused int8 route in interpret mode (``ZOO_INT8_FUSED=interpret``,
the TPU's tiling floor, no tuning cache), the route the port's K6 computes,
and prints ``||int8 - float|| / ||float||`` over the (N, 8732, 25) outputs
and the max |d| relative to max |float|. Takes ~1-2 min.
"""

import argparse
import os
import sys
import tempfile
from pathlib import Path

os.environ["ZOO_INT8_FUSED"] = "interpret"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["ZOO_TPU_TUNING_CACHE"] = os.path.join(tempfile.mkdtemp(),
                                                  "tuning.json")

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base-filters", type=int, default=8)
    ap.add_argument("--images", type=int, default=2)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import numpy as np

    import chip_smoke as cs
    from analytics_zoo_tpu.inference import InferenceModel
    from analytics_zoo_tpu.models.image.objectdetection import SSD300VGG
    from analytics_zoo_tpu.ops import int8_fused

    int8_fused._MIN_INTERPRET = 128
    model = SSD300VGG(21, base_filters=args.base_filters)
    params, state = jax.jit(model.build)(jax.random.PRNGKey(0))
    x, _, _ = cs.ssd_images(args.images, 300, seed=23)
    floats = np.asarray(jax.jit(
        lambda p, s, xx: model.apply(p, s, xx)[0])(params, state, x))
    im = InferenceModel(max_batch_size=args.images).load(model, params,
                                                         state)
    im.quantize_int8()
    raw = np.asarray(im.predict(x))
    gap = float(np.linalg.norm(raw - floats) / np.linalg.norm(floats))
    rel_max = float(np.abs(raw - floats).max() / np.abs(floats).max())
    print(f"JAX SSD300VGG(21, base_filters={args.base_filters}), "
          f"{args.images} images, outputs {raw.shape}: int8 vs float "
          f"||d||/||float|| {gap!r}, max|d|/max|float| {rel_max!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
