"""Image pipeline (port of ``analytics_zoo_tpu/data/image.py``, which
needs no JAX): ``ImageFeature``, ``ImageSet`` and the chained
``ImageProcessing`` stages (resize, crops, flips, colour jitter, channel
normalisation, ...), the reference's ``feature/image`` package.

Every stage is a numpy function over an HWC float32 RGB array on the host,
drawing its randomness from the set's seeded ``np.random.Generator``, so
the same seed gives the same bytes in both packages. The terminal
``to_arrays`` emits the dense ``(N, H, W, C)`` NHWC batch that the port's
convolutions take. PIL (``ImageSet.read``) and ``scipy.ndimage`` (the 3D
affine stages) are imported only where they are used.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class ImageFeature:
    """One image record (ImageFeature.scala parity): HWC float32 RGB ``image``,
    optional ``label``/``uri``; transform outputs accumulate as keys."""

    def __init__(self, image: Optional[np.ndarray] = None,
                 label: Optional[int] = None, uri: Optional[str] = None):
        self._d: Dict = {}
        if image is not None:
            self._d["image"] = np.asarray(image, dtype="float32")
        if label is not None:
            self._d["label"] = label
        if uri is not None:
            self._d["uri"] = uri

    def get_image(self) -> np.ndarray:
        return self._d["image"]

    def set_image(self, img: np.ndarray) -> "ImageFeature":
        self._d["image"] = np.asarray(img, dtype="float32")
        return self

    def get_label(self):
        return self._d.get("label", -1)

    def get_uri(self):
        return self._d.get("uri")

    def __getitem__(self, k):
        return self._d[k]

    def __setitem__(self, k, v):
        self._d[k] = v

    def __contains__(self, k):
        return k in self._d

    def keys(self):
        return list(self._d.keys())

    def copy(self) -> "ImageFeature":
        out = ImageFeature()
        out._d = dict(self._d)
        return out


# ----------------------------------------------------------------- processing base


class ImageProcessing:
    """One pipeline stage (ImageProcessing.scala parity). Stages operate on the
    HWC array; chain with ``>>``. Random stages draw from the rng handed in by
    ImageSet.transform for reproducibility."""

    def apply_image(self, img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        raise NotImplementedError

    def transform(self, feature: ImageFeature,
                  rng: np.random.Generator) -> ImageFeature:
        return feature.set_image(self.apply_image(feature.get_image(), rng))

    def __rshift__(self, other: "ImageProcessing") -> "ChainedImageProcessing":
        return ChainedImageProcessing([self, other])


class ChainedImageProcessing(ImageProcessing):
    def __init__(self, stages: Sequence[ImageProcessing]):
        self.stages = list(stages)

    def transform(self, feature, rng):
        for s in self.stages:
            feature = s.transform(feature, rng)
        return feature

    def __rshift__(self, other):
        return ChainedImageProcessing(self.stages + [other])


# -------------------------------------------------------------- geometry stages


class ImageResize(ImageProcessing):
    """Bilinear resize to (resize_h, resize_w) (ImageResize.scala parity)."""

    def __init__(self, resize_h: int, resize_w: int):
        self.h, self.w = int(resize_h), int(resize_w)

    def apply_image(self, img, rng):
        return _bilinear_resize(img, self.h, self.w)


class ImageAspectScale(ImageProcessing):
    """Scale the short side to ``min_size``, cap the long side at ``max_size``
    (ImageAspectScale.scala parity)."""

    def __init__(self, min_size: int, max_size: int = 1000, scale_multiple_of: int = 1):
        self.min_size, self.max_size = int(min_size), int(max_size)
        self.multiple = int(scale_multiple_of)

    def apply_image(self, img, rng):
        h, w = img.shape[:2]
        short, long = min(h, w), max(h, w)
        scale = self.min_size / short
        if long * scale > self.max_size:
            scale = self.max_size / long
        nh, nw = int(round(h * scale)), int(round(w * scale))
        if self.multiple > 1:
            nh = max(self.multiple, nh // self.multiple * self.multiple)
            nw = max(self.multiple, nw // self.multiple * self.multiple)
        return _bilinear_resize(img, nh, nw)


class ImageRandomResize(ImageProcessing):
    """Resize to a random size in [min, max] (ImageRandomResize.scala)."""

    def __init__(self, min_size: int, max_size: int):
        self.min_size, self.max_size = int(min_size), int(max_size)

    def apply_image(self, img, rng):
        s = int(rng.integers(self.min_size, self.max_size + 1))
        return _bilinear_resize(img, s, s)


class ImageCenterCrop(ImageProcessing):
    def __init__(self, crop_height: int, crop_width: int):
        self.ch, self.cw = int(crop_height), int(crop_width)

    def apply_image(self, img, rng):
        h, w = img.shape[:2]
        y0, x0 = (h - self.ch) // 2, (w - self.cw) // 2
        return img[y0:y0 + self.ch, x0:x0 + self.cw]


class ImageRandomCrop(ImageProcessing):
    def __init__(self, crop_height: int, crop_width: int):
        self.ch, self.cw = int(crop_height), int(crop_width)

    def apply_image(self, img, rng):
        h, w = img.shape[:2]
        y0 = int(rng.integers(0, h - self.ch + 1))
        x0 = int(rng.integers(0, w - self.cw + 1))
        return img[y0:y0 + self.ch, x0:x0 + self.cw]


class ImageFixedCrop(ImageProcessing):
    """Crop a fixed region; normalized coords if ``normalized`` (ImageFixedCrop)."""

    def __init__(self, x1: float, y1: float, x2: float, y2: float,
                 normalized: bool = True):
        self.box = (x1, y1, x2, y2)
        self.normalized = normalized

    def apply_image(self, img, rng):
        h, w = img.shape[:2]
        x1, y1, x2, y2 = self.box
        if self.normalized:
            x1, x2 = x1 * w, x2 * w
            y1, y2 = y1 * h, y2 * h
        return img[int(y1):int(y2), int(x1):int(x2)]


class ImageExpand(ImageProcessing):
    """Randomly pad the image into a larger canvas (ImageExpand.scala — SSD aug)."""

    def __init__(self, means_r=123, means_g=117, means_b=104,
                 max_expand_ratio: float = 4.0):
        self.means = np.asarray([means_r, means_g, means_b], dtype="float32")
        self.max_ratio = float(max_expand_ratio)

    def apply_image(self, img, rng):
        ratio = float(rng.uniform(1.0, self.max_ratio))
        h, w, c = img.shape
        nh, nw = int(h * ratio), int(w * ratio)
        out = np.broadcast_to(self.means, (nh, nw, c)).copy()
        y0 = int(rng.integers(0, nh - h + 1))
        x0 = int(rng.integers(0, nw - w + 1))
        out[y0:y0 + h, x0:x0 + w] = img
        return out


class ImageFiller(ImageProcessing):
    """Fill a (normalized) region with ``value`` (ImageFiller.scala)."""

    def __init__(self, start_x: float, start_y: float, end_x: float, end_y: float,
                 value: int = 255):
        self.box = (start_x, start_y, end_x, end_y)
        self.value = float(value)

    def apply_image(self, img, rng):
        h, w = img.shape[:2]
        x1, y1, x2, y2 = self.box
        img = img.copy()
        img[int(y1 * h):int(y2 * h), int(x1 * w):int(x2 * w)] = self.value
        return img


class ImageHFlip(ImageProcessing):
    def apply_image(self, img, rng):
        return img[:, ::-1]


class ImageRandomPreprocessing(ImageProcessing):
    """Apply an inner stage with probability ``prob``
    (ImageRandomPreprocessing.scala parity — used for random flips etc.)."""

    def __init__(self, inner: ImageProcessing, prob: float = 0.5):
        self.inner = inner
        self.prob = float(prob)

    def transform(self, feature, rng):
        if rng.uniform() < self.prob:
            return self.inner.transform(feature, rng)
        return feature


# ----------------------------------------------------------------- color stages


class ImageBrightness(ImageProcessing):
    """Add a random delta in [delta_low, delta_high] (ImageBrightness.scala)."""

    def __init__(self, delta_low: float = -32.0, delta_high: float = 32.0):
        self.lo, self.hi = float(delta_low), float(delta_high)

    def apply_image(self, img, rng):
        return img + float(rng.uniform(self.lo, self.hi))


class ImageContrast(ImageProcessing):
    def __init__(self, delta_low: float = 0.5, delta_high: float = 1.5):
        self.lo, self.hi = float(delta_low), float(delta_high)

    def apply_image(self, img, rng):
        return img * float(rng.uniform(self.lo, self.hi))


class ImageSaturation(ImageProcessing):
    def __init__(self, delta_low: float = 0.5, delta_high: float = 1.5):
        self.lo, self.hi = float(delta_low), float(delta_high)

    def apply_image(self, img, rng):
        factor = float(rng.uniform(self.lo, self.hi))
        gray = img.mean(axis=-1, keepdims=True)
        return gray + (img - gray) * factor


class ImageHue(ImageProcessing):
    """Rotate hue by a random angle in degrees (ImageHue.scala)."""

    def __init__(self, delta_low: float = -18.0, delta_high: float = 18.0):
        self.lo, self.hi = float(delta_low), float(delta_high)

    def apply_image(self, img, rng):
        theta = np.deg2rad(float(rng.uniform(self.lo, self.hi)))
        # rotate around the RGB diagonal (YIQ-space hue rotation, float math)
        u, w_ = np.cos(theta), np.sin(theta)
        m = np.array([
            [0.299 + 0.701 * u + 0.168 * w_, 0.587 - 0.587 * u + 0.330 * w_,
             0.114 - 0.114 * u - 0.497 * w_],
            [0.299 - 0.299 * u - 0.328 * w_, 0.587 + 0.413 * u + 0.035 * w_,
             0.114 - 0.114 * u + 0.292 * w_],
            [0.299 - 0.300 * u + 1.250 * w_, 0.587 - 0.588 * u - 1.050 * w_,
             0.114 + 0.886 * u - 0.203 * w_]], dtype="float32")
        return img @ m.T


class ImageColorJitter(ImageProcessing):
    """Random brightness/contrast/saturation in random order
    (ImageColorJitter.scala parity)."""

    def __init__(self, brightness_prob=0.5, brightness_delta=32.0,
                 contrast_prob=0.5, contrast_lower=0.5, contrast_upper=1.5,
                 saturation_prob=0.5, saturation_lower=0.5, saturation_upper=1.5,
                 hue_prob=0.5, hue_delta=18.0):
        self.stages = [
            (brightness_prob, ImageBrightness(-brightness_delta, brightness_delta)),
            (contrast_prob, ImageContrast(contrast_lower, contrast_upper)),
            (saturation_prob, ImageSaturation(saturation_lower, saturation_upper)),
            (hue_prob, ImageHue(-hue_delta, hue_delta)),
        ]

    def apply_image(self, img, rng):
        order = rng.permutation(len(self.stages))
        for i in order:
            prob, stage = self.stages[i]
            if rng.uniform() < prob:
                img = stage.apply_image(img, rng)
        return img


class ImageChannelNormalize(ImageProcessing):
    """(img - mean) / std per channel (ImageChannelNormalize.scala)."""

    def __init__(self, mean_r: float, mean_g: float, mean_b: float,
                 std_r: float = 1.0, std_g: float = 1.0, std_b: float = 1.0):
        self.mean = np.asarray([mean_r, mean_g, mean_b], dtype="float32")
        self.std = np.asarray([std_r, std_g, std_b], dtype="float32")

    def apply_image(self, img, rng):
        return (img - self.mean) / self.std


class ImagePixelNormalizer(ImageProcessing):
    """Subtract a per-pixel mean image (ImagePixelNormalizer.scala)."""

    def __init__(self, means: np.ndarray):
        self.means = np.asarray(means, dtype="float32")

    def apply_image(self, img, rng):
        return img - self.means


class ImageChannelOrder(ImageProcessing):
    """Swap RGB ↔ BGR (ImageChannelOrder.scala)."""

    def apply_image(self, img, rng):
        return img[..., ::-1]


class ImageMatToTensor(ImageProcessing):
    """Finalize layout (ImageMatToTensor.scala): NHWC is the default;
    ``format="NCHW"`` available for checkpoint-porting workflows."""

    def __init__(self, format: str = "NHWC"):
        assert format in ("NHWC", "NCHW")
        self.format = format

    def apply_image(self, img, rng):
        return np.transpose(img, (2, 0, 1)) if self.format == "NCHW" else img


class ImageSetToSample(ImageProcessing):
    """Attach (image, label) sample arrays (ImageSetToSample.scala)."""

    def transform(self, feature, rng):
        feature["sample"] = (feature.get_image(),
                             np.asarray(feature.get_label()))
        return feature


def _bilinear_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Pure-numpy bilinear resize (no OpenCV JNI — vectorized gather math)."""
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    r0, r1 = img[y0], img[y1]
    top = r0[:, x0] * (1 - wx) + r0[:, x1] * wx
    bot = r1[:, x0] * (1 - wx) + r1[:, x1] * wx
    return (top * (1 - wy) + bot * wy).astype("float32")


# ---------------------------------------------------------------------- ImageSet


class ImageSet:
    """Collection of ImageFeatures with chained transforms (ImageSet.scala).

    ``read`` decodes with PIL (host side); the terminal ``to_arrays`` emits the
    dense NHWC batch for the device."""

    def __init__(self, features: Sequence[ImageFeature], seed: int = 0):
        self.features: List[ImageFeature] = list(features)
        self.seed = seed

    @classmethod
    def from_arrays(cls, images: np.ndarray, labels: Optional[Sequence] = None,
                    seed: int = 0) -> "ImageSet":
        labels = labels if labels is not None else [None] * len(images)
        return cls([ImageFeature(im, l) for im, l in zip(images, labels)],
                   seed=seed)

    @classmethod
    def read(cls, path: str, with_label: bool = False) -> "ImageSet":
        """Read image files; with_label: ``<category>/<file>`` dirs map to labels
        (ImageSet.read parity)."""
        from PIL import Image

        feats = []
        if with_label:
            cats = [c for c in sorted(os.listdir(path))
                    if os.path.isdir(os.path.join(path, c))]
            for label, cat in enumerate(cats):
                cat_dir = os.path.join(path, cat)
                for fn in sorted(os.listdir(cat_dir)):
                    img = np.asarray(Image.open(os.path.join(cat_dir, fn))
                                     .convert("RGB"), dtype="float32")
                    feats.append(ImageFeature(img, label, uri=os.path.join(cat, fn)))
        else:
            names = ([path] if os.path.isfile(path) else
                     [os.path.join(path, f) for f in sorted(os.listdir(path))])
            for fn in names:
                img = np.asarray(Image.open(fn).convert("RGB"), dtype="float32")
                feats.append(ImageFeature(img, uri=fn))
        return cls(feats)

    def transform(self, stage: ImageProcessing) -> "ImageSet":
        """Returns a NEW ImageSet; source features are never mutated (matching
        the reference's immutable RDD-map semantics)."""
        rng = np.random.default_rng(self.seed)
        return ImageSet([stage.transform(f.copy(), rng) for f in self.features],
                        seed=self.seed + 1)

    def get_images(self) -> List[np.ndarray]:
        return [f.get_image() for f in self.features]

    def get_labels(self) -> List:
        return [f.get_label() for f in self.features]

    def to_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        xs = np.stack([f.get_image() for f in self.features])
        ys = np.asarray([f.get_label() for f in self.features])
        return xs, ys

    def __len__(self):
        return len(self.features)


# ------------------------------------------------------------------- 3D variants


class ImageProcessing3D(ImageProcessing):
    """Base for volumetric (D, H, W) transforms (feature/image3d/ parity)."""


class Crop3D(ImageProcessing3D):
    """Crop a (D, H, W) patch at ``start`` (image3d/Cropper.scala parity)."""

    def __init__(self, start: Sequence[int], patch_size: Sequence[int]):
        self.start = tuple(int(s) for s in start)
        self.patch = tuple(int(p) for p in patch_size)

    def apply_image(self, vol, rng):
        z, y, x = self.start
        d, h, w = self.patch
        return vol[z:z + d, y:y + h, x:x + w]


class RandomCrop3D(ImageProcessing3D):
    def __init__(self, patch_size: Sequence[int]):
        self.patch = tuple(int(p) for p in patch_size)

    def apply_image(self, vol, rng):
        d, h, w = self.patch
        z = int(rng.integers(0, vol.shape[0] - d + 1))
        y = int(rng.integers(0, vol.shape[1] - h + 1))
        x = int(rng.integers(0, vol.shape[2] - w + 1))
        return vol[z:z + d, y:y + h, x:x + w]


class Rotate3D(ImageProcessing3D):
    """Rotate by Euler angles (yaw, pitch, roll) radians
    (image3d/Rotation.scala parity; scipy affine on host)."""

    def __init__(self, rotation_angles: Sequence[float]):
        self.angles = tuple(float(a) for a in rotation_angles)

    def apply_image(self, vol, rng):
        from scipy.ndimage import affine_transform

        a, b, c = self.angles
        rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                       [0, 0, 1]])
        ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0],
                       [-np.sin(b), 0, np.cos(b)]])
        rx = np.array([[1, 0, 0], [0, np.cos(c), -np.sin(c)],
                       [0, np.sin(c), np.cos(c)]])
        m = rz @ ry @ rx
        center = (np.asarray(vol.shape) - 1) / 2
        offset = center - m @ center
        return affine_transform(vol, m, offset=offset, order=1).astype("float32")


class AffineTransform3D(ImageProcessing3D):
    """General 3×3 affine + translation (image3d/AffineTransform.scala parity)."""

    def __init__(self, mat: np.ndarray, translation: Optional[np.ndarray] = None):
        self.mat = np.asarray(mat, dtype="float64")
        self.translation = (np.zeros(3) if translation is None
                            else np.asarray(translation, dtype="float64"))

    def apply_image(self, vol, rng):
        from scipy.ndimage import affine_transform

        center = (np.asarray(vol.shape) - 1) / 2
        offset = center - self.mat @ center - self.translation
        return affine_transform(vol, self.mat, offset=offset,
                                order=1).astype("float32")
