"""3D image transforms — reference ``zoo/.../feature/image3d/``
(``Cropper.scala`` Crop3D/RandomCrop3D/CenterCrop3D, ``Rotation.scala`` Rotate3D,
``AffineTransform.scala`` Affine3D; used by the image-augmentation-3d app).

Volumes are (D, H, W) or (D, H, W, C) numpy arrays on the host; affine
resampling is trilinear with constant padding, vectorized over the whole output
grid (no per-voxel Python loops).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np

from .image import ImageProcessing


def _as_4d(vol: np.ndarray) -> Tuple[np.ndarray, bool]:
    if vol.ndim == 3:
        return vol[..., None], True
    if vol.ndim == 4:
        return vol, False
    raise ValueError(f"expected (D,H,W[,C]) volume, got shape {vol.shape}")


def crop3d(vol: np.ndarray, start: Sequence[int],
           patch_size: Sequence[int]) -> np.ndarray:
    """Fixed-position crop (Cropper.scala Crop3D parity)."""
    v, squeeze = _as_4d(np.asarray(vol))
    d0, h0, w0 = (int(s) for s in start)
    dd, hh, ww = (int(s) for s in patch_size)
    if d0 < 0 or h0 < 0 or w0 < 0 or d0 + dd > v.shape[0] \
            or h0 + hh > v.shape[1] or w0 + ww > v.shape[2]:
        raise ValueError(f"crop {start}+{patch_size} outside volume "
                         f"{v.shape[:3]}")
    out = v[d0:d0 + dd, h0:h0 + hh, w0:w0 + ww]
    return out[..., 0] if squeeze else out


def center_crop3d(vol: np.ndarray, patch_size: Sequence[int]) -> np.ndarray:
    v, _ = _as_4d(np.asarray(vol))
    start = [(s - p) // 2 for s, p in zip(v.shape[:3], patch_size)]
    return crop3d(vol, start, patch_size)


def random_crop3d(vol: np.ndarray, patch_size: Sequence[int],
                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
    rng = rng or np.random.default_rng()
    v, _ = _as_4d(np.asarray(vol))
    start = [int(rng.integers(0, s - p + 1))
             for s, p in zip(v.shape[:3], patch_size)]
    return crop3d(vol, start, patch_size)


def affine3d(vol: np.ndarray, matrix: np.ndarray,
             translation: Sequence[float] = (0, 0, 0),
             fill: float = 0.0) -> np.ndarray:
    """Affine resample (AffineTransform.scala parity): output voxel o maps to
    input coordinate ``matrix @ (o - c) + c + translation`` (c = center).
    Trilinear interpolation, constant fill outside."""
    v, squeeze = _as_4d(np.asarray(vol, dtype="float32"))
    D, H, W, C = v.shape
    mat = np.asarray(matrix, dtype="float64").reshape(3, 3)
    t = np.asarray(translation, dtype="float64")
    center = (np.asarray([D, H, W], dtype="float64") - 1) / 2

    grid = np.stack(np.meshgrid(np.arange(D), np.arange(H), np.arange(W),
                                indexing="ij"), axis=-1).reshape(-1, 3)
    src = (grid - center) @ mat.T + center + t   # (N, 3) float

    lo = np.floor(src).astype(np.int64)
    frac = src - lo
    out = np.zeros((grid.shape[0], C), dtype="float32")
    for corner in range(8):
        off = np.array([(corner >> 2) & 1, (corner >> 1) & 1, corner & 1])
        idx = lo + off
        w = np.prod(np.where(off == 1, frac, 1 - frac), axis=1)
        valid = ((idx >= 0) & (idx < np.array([D, H, W]))).all(axis=1)
        ci = np.clip(idx, 0, np.array([D, H, W]) - 1)
        vals = v[ci[:, 0], ci[:, 1], ci[:, 2]]
        # out-of-bounds corners contribute the fill value at their weight, so
        # border voxels blend toward fill rather than toward 0
        out += np.where(valid[:, None], vals * w[:, None], fill * w[:, None])
    out = out.reshape(D, H, W, C)
    return out[..., 0] if squeeze else out


def rotation_matrix(yaw: float = 0.0, pitch: float = 0.0,
                    roll: float = 0.0) -> np.ndarray:
    """Rotation about the W (yaw), H (pitch), D (roll) axes, composed R_d·R_h·R_w
    (Rotation.scala convention: Euler angles in radians)."""
    cy, sy = math.cos(yaw), math.sin(yaw)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cr, sr = math.cos(roll), math.sin(roll)
    rw = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    rh = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rd = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return rd @ rh @ rw


def rotate3d(vol: np.ndarray, yaw: float = 0.0, pitch: float = 0.0,
             roll: float = 0.0, fill: float = 0.0) -> np.ndarray:
    return affine3d(vol, rotation_matrix(yaw, pitch, roll), fill=fill)


# ------------------------------------------------------ ImageProcessing stages


class Crop3D(ImageProcessing):
    def __init__(self, start: Sequence[int], patch_size: Sequence[int]):
        self.start = start
        self.patch_size = patch_size

    def apply_image(self, img, rng):
        return crop3d(img, self.start, self.patch_size)


class CenterCrop3D(ImageProcessing):
    def __init__(self, patch_size: Sequence[int]):
        self.patch_size = patch_size

    def apply_image(self, img, rng):
        return center_crop3d(img, self.patch_size)


class RandomCrop3D(ImageProcessing):
    def __init__(self, patch_size: Sequence[int]):
        self.patch_size = patch_size

    def apply_image(self, img, rng):
        return random_crop3d(img, self.patch_size, rng)


class Rotate3D(ImageProcessing):
    def __init__(self, yaw: float = 0.0, pitch: float = 0.0, roll: float = 0.0,
                 fill: float = 0.0):
        self.args = (yaw, pitch, roll, fill)

    def apply_image(self, img, rng):
        return rotate3d(img, *self.args)


class AffineTransform3D(ImageProcessing):
    def __init__(self, matrix: np.ndarray, translation=(0, 0, 0),
                 fill: float = 0.0):
        self.matrix = matrix
        self.translation = translation
        self.fill = fill

    def apply_image(self, img, rng):
        return affine3d(img, self.matrix, self.translation, self.fill)
