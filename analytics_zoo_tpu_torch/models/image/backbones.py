"""Config-driven classification backbones (port of
``analytics_zoo_tpu/models/image/backbones.py``).

Each name maps to a builder producing a functional
:class:`~analytics_zoo_tpu_torch.nn.topology.Model` for NHWC inputs, with
the JAX package's topology and slot names. Every builder takes
``input_shape=(H, W, 3)`` and ``num_classes``, plus ``device`` (CUDA unless
the caller names another; raises with no CUDA and no device) and ``seed``
(the weights' draw). ``mobilenet`` also takes the width multiplier
``alpha`` (MobileNet v1, Howard et al., arXiv:1704.04861).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

from ...nn import layers as L
from ...nn.graph import Input
from ...nn.topology import Model


def _conv_bn(x, filters, k, stride=1, activation="relu", mode="same"):
    x = L.Convolution2D(filters, k, k, subsample=(stride, stride),
                        border_mode=mode, use_bias=False)(x)
    x = L.BatchNormalization()(x)
    return L.Activation(activation)(x)


# --------------------------------------------------------------------- alexnet
def alexnet(input_shape=(224, 224, 3), num_classes=1000, *, device=None,
        seed=0):
    inp = Input(input_shape)
    x = L.Convolution2D(64, 11, 11, subsample=(4, 4), border_mode="same",
                        activation="relu")(inp)
    x = L.MaxPooling2D((3, 3), strides=(2, 2))(x)
    x = L.Convolution2D(192, 5, 5, border_mode="same", activation="relu")(x)
    x = L.MaxPooling2D((3, 3), strides=(2, 2))(x)
    x = L.Convolution2D(384, 3, 3, border_mode="same", activation="relu")(x)
    x = L.Convolution2D(256, 3, 3, border_mode="same", activation="relu")(x)
    x = L.Convolution2D(256, 3, 3, border_mode="same", activation="relu")(x)
    x = L.GlobalAveragePooling2D()(x)
    x = L.Dense(num_classes, activation="softmax")(x)
    return Model(inp, x, name="alexnet", device=device, seed=seed)


# ------------------------------------------------------------------------ vgg
def _vgg(blocks, input_shape, num_classes, name, device, seed):
    inp = Input(input_shape)
    x = inp
    for filters, reps in blocks:
        for _ in range(reps):
            x = L.Convolution2D(filters, 3, 3, border_mode="same",
                                activation="relu")(x)
        x = L.MaxPooling2D((2, 2))(x)
    x = L.GlobalAveragePooling2D()(x)
    x = L.Dense(num_classes, activation="softmax")(x)
    return Model(inp, x, name=name, device=device, seed=seed)


def vgg16(input_shape=(224, 224, 3), num_classes=1000, *, device=None,
        seed=0):
    return _vgg([(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)],
                input_shape, num_classes, "vgg-16", device, seed)


def vgg19(input_shape=(224, 224, 3), num_classes=1000, *, device=None,
        seed=0):
    return _vgg([(64, 2), (128, 2), (256, 4), (512, 4), (512, 4)],
                input_shape, num_classes, "vgg-19", device, seed)


# --------------------------------------------------------------------- resnet
def _res_block(x, filters, stride, bottleneck):
    shortcut = x
    if bottleneck:
        y = _conv_bn(x, filters, 1, stride)
        y = _conv_bn(y, filters, 3)
        y = L.Convolution2D(filters * 4, 1, 1, border_mode="same",
                            use_bias=False)(y)
        y = L.BatchNormalization()(y)
        out_ch = filters * 4
    else:
        y = _conv_bn(x, filters, 3, stride)
        y = L.Convolution2D(filters, 3, 3, border_mode="same", use_bias=False)(y)
        y = L.BatchNormalization()(y)
        out_ch = filters
    if stride != 1 or shortcut.shape[-1] != out_ch:
        shortcut = L.Convolution2D(out_ch, 1, 1, subsample=(stride, stride),
                                   border_mode="same", use_bias=False)(shortcut)
        shortcut = L.BatchNormalization()(shortcut)
    y = L.Merge(mode="sum")([y, shortcut])
    return L.Activation("relu")(y)


def _resnet(layers_per_stage, bottleneck, input_shape, num_classes, name,
            device, seed):
    inp = Input(input_shape)
    x = _conv_bn(inp, 64, 7, stride=2)
    x = L.MaxPooling2D((3, 3), strides=(2, 2), border_mode="same")(x)
    filters = 64
    for stage, reps in enumerate(layers_per_stage):
        for i in range(reps):
            stride = 2 if (stage > 0 and i == 0) else 1
            x = _res_block(x, filters, stride, bottleneck)
        filters *= 2
    x = L.GlobalAveragePooling2D()(x)
    x = L.Dense(num_classes, activation="softmax")(x)
    return Model(inp, x, name=name, device=device, seed=seed)


def resnet18(input_shape=(224, 224, 3), num_classes=1000, *, device=None,
        seed=0):
    return _resnet([2, 2, 2, 2], False, input_shape, num_classes, "resnet-18",
                   device, seed)


def resnet50(input_shape=(224, 224, 3), num_classes=1000, *, device=None,
        seed=0):
    return _resnet([3, 4, 6, 3], True, input_shape, num_classes, "resnet-50",
                   device, seed)


# ----------------------------------------------------------------- squeezenet
def squeezenet(input_shape=(224, 224, 3), num_classes=1000, *, device=None,
        seed=0):
    def fire(x, squeeze, expand):
        s = L.Convolution2D(squeeze, 1, 1, border_mode="same",
                            activation="relu")(x)
        e1 = L.Convolution2D(expand, 1, 1, border_mode="same",
                             activation="relu")(s)
        e3 = L.Convolution2D(expand, 3, 3, border_mode="same",
                             activation="relu")(s)
        return L.Merge(mode="concat")([e1, e3])

    inp = Input(input_shape)
    x = L.Convolution2D(96, 7, 7, subsample=(2, 2), border_mode="same",
                        activation="relu")(inp)
    x = L.MaxPooling2D((3, 3), strides=(2, 2))(x)
    for squeeze, expand in [(16, 64), (16, 64), (32, 128)]:
        x = fire(x, squeeze, expand)
    x = L.MaxPooling2D((3, 3), strides=(2, 2))(x)
    for squeeze, expand in [(32, 128), (48, 192), (48, 192), (64, 256)]:
        x = fire(x, squeeze, expand)
    x = L.Convolution2D(num_classes, 1, 1, border_mode="same",
                        activation="relu")(x)
    x = L.GlobalAveragePooling2D()(x)
    x = L.Activation("softmax")(x)
    return Model(inp, x, name="squeezenet", device=device, seed=seed)


# ---------------------------------------------------------------- inception-v1
def inception_v1(input_shape=(224, 224, 3), num_classes=1000, *, device=None,
        seed=0):
    def module(x, c1, c3r, c3, c5r, c5, pp):
        b1 = L.Convolution2D(c1, 1, 1, border_mode="same", activation="relu")(x)
        b3 = L.Convolution2D(c3r, 1, 1, border_mode="same", activation="relu")(x)
        b3 = L.Convolution2D(c3, 3, 3, border_mode="same", activation="relu")(b3)
        b5 = L.Convolution2D(c5r, 1, 1, border_mode="same", activation="relu")(x)
        b5 = L.Convolution2D(c5, 5, 5, border_mode="same", activation="relu")(b5)
        bp = L.MaxPooling2D((3, 3), strides=(1, 1), border_mode="same")(x)
        bp = L.Convolution2D(pp, 1, 1, border_mode="same", activation="relu")(bp)
        return L.Merge(mode="concat")([b1, b3, b5, bp])

    inp = Input(input_shape)
    x = L.Convolution2D(64, 7, 7, subsample=(2, 2), border_mode="same",
                        activation="relu")(inp)
    x = L.MaxPooling2D((3, 3), strides=(2, 2), border_mode="same")(x)
    x = L.Convolution2D(192, 3, 3, border_mode="same", activation="relu")(x)
    x = L.MaxPooling2D((3, 3), strides=(2, 2), border_mode="same")(x)
    x = module(x, 64, 96, 128, 16, 32, 32)
    x = module(x, 128, 128, 192, 32, 96, 64)
    x = L.MaxPooling2D((3, 3), strides=(2, 2), border_mode="same")(x)
    x = module(x, 192, 96, 208, 16, 48, 64)
    x = module(x, 256, 160, 320, 32, 128, 128)
    x = L.GlobalAveragePooling2D()(x)
    x = L.Dense(num_classes, activation="softmax")(x)
    return Model(inp, x, name="inception-v1", device=device, seed=seed)


# ------------------------------------------------------------------ mobilenet
def mobilenet(input_shape=(224, 224, 3), num_classes=1000, alpha=1.0, *,
              device=None, seed=0):
    inp = Input(input_shape)
    x = _conv_bn(inp, int(32 * alpha), 3, stride=2)
    cfg = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
           (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
           (1024, 1)]
    for filters, stride in cfg:
        x = L.DepthwiseConv2D((3, 3), subsample=(stride, stride))(x)
        x = L.BatchNormalization()(x)
        x = L.Activation("relu")(x)
        x = _conv_bn(x, int(filters * alpha), 1)
    x = L.GlobalAveragePooling2D()(x)
    x = L.Dense(num_classes, activation="softmax")(x)
    return Model(inp, x, name="mobilenet", device=device, seed=seed)


def mobilenet_v2(input_shape=(224, 224, 3), num_classes=1000, *,
                 device=None, seed=0):
    def inverted_residual(x, filters, stride, expand):
        in_ch = x.shape[-1]
        y = _conv_bn(x, in_ch * expand, 1) if expand > 1 else x
        y = L.DepthwiseConv2D((3, 3), subsample=(stride, stride))(y)
        y = L.BatchNormalization()(y)
        y = L.Activation("relu")(y)
        y = L.Convolution2D(filters, 1, 1, border_mode="same",
                            use_bias=False)(y)
        y = L.BatchNormalization()(y)
        if stride == 1 and in_ch == filters:
            y = L.Merge(mode="sum")([x, y])
        return y

    inp = Input(input_shape)
    x = _conv_bn(inp, 32, 3, stride=2)
    cfg = [(16, 1, 1, 1), (24, 2, 2, 6), (32, 3, 2, 6), (64, 4, 2, 6),
           (96, 3, 1, 6), (160, 3, 2, 6), (320, 1, 1, 6)]
    for filters, reps, stride, expand in cfg:
        for i in range(reps):
            x = inverted_residual(x, filters, stride if i == 0 else 1, expand)
    x = _conv_bn(x, 1280, 1)
    x = L.GlobalAveragePooling2D()(x)
    x = L.Dense(num_classes, activation="softmax")(x)
    return Model(inp, x, name="mobilenet-v2", device=device, seed=seed)


BACKBONES: Dict[str, Callable] = {
    "alexnet": alexnet,
    "vgg-16": vgg16,
    "vgg-19": vgg19,
    "resnet-18": resnet18,
    "resnet-50": resnet50,
    "mobilenet": mobilenet,
    "mobilenet-v2": mobilenet_v2,
    "squeezenet": squeezenet,
    "inception-v1": inception_v1,
}


def build_backbone(name: str, input_shape: Tuple[int, int, int] = (224, 224, 3),
                   num_classes: int = 1000, *, device=None, seed: int = 0):
    try:
        builder = BACKBONES[name]
    except KeyError:
        raise ValueError(f"unknown backbone {name!r}; known: "
                         f"{sorted(BACKBONES)}") from None
    return builder(input_shape=input_shape, num_classes=num_classes,
                   device=device, seed=seed)


__all__ = ["BACKBONES", "alexnet", "build_backbone", "inception_v1",
           "mobilenet", "mobilenet_v2", "resnet18", "resnet50", "squeezenet",
           "vgg16", "vgg19"]
