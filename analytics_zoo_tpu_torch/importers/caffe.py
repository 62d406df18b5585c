"""Caffe model ingestion — prototxt + caffemodel → executable PyTorch model
(port of ``analytics_zoo_tpu/importers/caffe.py``).

The prototxt gives the DAG, the caffemodel donates blobs, which are the
model's trainable parameters (``<layer>.<i>``), and the layers execute in
order in torch, NCHW as caffe defines them, so blobs need no
transposition.

Covered layer set: Input/Data, Convolution, Deconvolution (grouped),
InnerProduct, Pooling (MAX/AVE, caffe's ceil-mode output:
``_ceil_pool_pads``), ReLU, PReLU, ELU, Sigmoid, TanH, AbsVal, Exp, Log,
Power, Threshold, Softmax, Dropout, LRN, BatchNorm, Scale, Bias (both
broadcast from ``axis``), Eltwise (PROD/SUM/MAX), Concat, Flatten,
Reshape, Slice, Split, Tile; any other raises ``NotImplementedError``
naming it.

Formats decoded without any caffe/protobuf dependency:
* prototxt — protobuf TEXT format, parsed by a small recursive parser into
  nested dicts (repeated fields become lists).
* caffemodel — NetParameter wire format (field numbers from caffe.proto:
  NetParameter{name=1, layers=2 (V1), input=3, input_dim=4, layer=100};
  LayerParameter{name=1, type=2, bottom=3, top=4, blobs=7};
  V1LayerParameter{bottom=2, top=3, name=4, blobs=6};
  BlobProto{num=1..width=4 legacy dims, data=5 packed float, shape=7{dim=1},
  double_data=8}); only names + blobs are read — structure comes from the
  prototxt.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..common import prng
from ..nn.module import Layer, resolve_device
from .onnx_proto import _iter_fields, _ld, _read_varint, _s64, _vi

# ------------------------------------------------------------ prototxt parser


def _tokenize(text: str) -> List[str]:
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "#":                       # comment to end of line
            while i < n and text[i] != "\n":
                i += 1
        elif c in " \t\r\n,":
            i += 1
        elif c in "{}:":
            out.append(c)
            i += 1
        elif c in "\"'":
            j = i + 1
            while j < n and text[j] != c:
                j += 1
            out.append(text[i:j + 1])
            i = j + 1
        else:
            j = i
            while j < n and text[j] not in " \t\r\n{}:#,":
                j += 1
            out.append(text[i:j])
            i = j
    return out


def _parse_value(tok: str):
    if tok and tok[0] in "\"'":
        return tok[1:-1]
    if tok in ("true", "True"):
        return True
    if tok in ("false", "False"):
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        return tok                       # enum token (MAX, AVE, SUM, ...)


def _parse_message(tokens: List[str], pos: int) -> Tuple[Dict, int]:
    """Parse fields until '}' or EOF. Repeated fields collect into lists."""
    msg: Dict = {}

    def put(key, value):
        if key in msg:
            if not isinstance(msg[key], list):
                msg[key] = [msg[key]]
            msg[key].append(value)
        else:
            msg[key] = value

    while pos < len(tokens):
        tok = tokens[pos]
        if tok == "}":
            return msg, pos + 1
        key = tok
        pos += 1
        if tokens[pos] == ":":
            pos += 1
            if tokens[pos] == "{":       # "key: { ... }" is legal text-proto
                sub, pos = _parse_message(tokens, pos + 1)
                put(key, sub)
            else:
                put(key, _parse_value(tokens[pos]))
                pos += 1
        elif tokens[pos] == "{":
            sub, pos = _parse_message(tokens, pos + 1)
            put(key, sub)
        else:
            raise ValueError(f"prototxt parse error near {key!r} "
                             f"{tokens[pos:pos + 3]}")
    return msg, pos


def parse_prototxt(text: str) -> Dict:
    msg, _ = _parse_message(_tokenize(text), 0)
    return msg


def _as_list(v) -> List:
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


# ------------------------------------------------------- caffemodel (binary)


def decode_caffemodel(buf: bytes) -> Dict[str, List[np.ndarray]]:
    """NetParameter bytes → {layer_name: [blob arrays]}."""
    out: Dict[str, List[np.ndarray]] = {}
    for fnum, _wt, v in _iter_fields(buf):
        if fnum == 100:                   # LayerParameter (V2)
            name, blobs = _decode_layer(v, name_field=1, blob_field=7)
            out[name] = blobs
        elif fnum == 2:                   # V1LayerParameter
            name, blobs = _decode_layer(v, name_field=4, blob_field=6)
            out[name] = blobs
    return out


def _decode_layer(buf: bytes, name_field: int,
                  blob_field: int) -> Tuple[str, List[np.ndarray]]:
    name = ""
    blobs: List[np.ndarray] = []
    for fnum, _wt, v in _iter_fields(buf):
        if fnum == name_field:
            name = v.decode()
        elif fnum == blob_field:
            blobs.append(_decode_blob(v))
    return name, blobs


def _decode_blob(buf: bytes) -> np.ndarray:
    legacy = [None, None, None, None]     # num, channels, height, width
    shape: Optional[Tuple[int, ...]] = None
    data: List[float] = []
    for fnum, wtype, v in _iter_fields(buf):
        if 1 <= fnum <= 4 and wtype == 0:
            legacy[fnum - 1] = _s64(v)
        elif fnum == 5:                   # packed float data
            if wtype == 2:
                data.extend(struct.unpack(f"<{len(v) // 4}f", v))
            else:
                data.append(struct.unpack("<f", struct.pack("<i", v))[0])
        elif fnum == 8 and wtype == 2:    # double_data
            data.extend(struct.unpack(f"<{len(v) // 8}d", v))
        elif fnum == 7:                   # BlobShape{dim=1 repeated}
            dims = []
            for f2, w2, v2 in _iter_fields(v):
                if f2 == 1:
                    if w2 == 2:
                        p = 0
                        while p < len(v2):
                            d, p = _read_varint(v2, p)
                            dims.append(_s64(d))
                    else:
                        dims.append(_s64(v2))
            shape = tuple(dims)
    arr = np.asarray(data, dtype=np.float32)
    if shape is None and any(d is not None for d in legacy):
        shape = tuple(d for d in legacy if d is not None)
    return arr.reshape(shape) if shape else arr


def encode_caffemodel(layers: Dict[str, List[np.ndarray]]) -> bytes:
    """Inverse of :func:`decode_caffemodel` — test-fixture writer."""
    out = b""
    for name, blobs in layers.items():
        body = _ld(1, name.encode())
        for b in blobs:
            b = np.ascontiguousarray(b, dtype=np.float32)
            blob = _ld(7, b"".join(_vi(1, d) for d in b.shape))
            blob += _ld(5, b.tobytes())
            body += _ld(7, blob)
        out += _ld(100, body)
    return out


# ------------------------------------------------------------------ executor


def _ceil_pool_pads(size: int, k: int, s: int, p: int) -> Tuple[int, int]:
    """Caffe pools with ceil-mode output: (low, high) padding so a window
    sweep without padding of its own lands on caffe's output count."""
    out = -((size + 2 * p - k) // -s) + 1
    # caffe clips windows that start entirely in the padding
    if p > 0 and (out - 1) * s >= size + p:
        out -= 1
    needed = (out - 1) * s + k - size - p
    return p, max(needed, 0)


def _pad4(pads) -> List[int]:
    """((h_lo, h_hi), (w_lo, w_hi)) → ``F.pad``'s [w_lo, w_hi, h_lo,
    h_hi]."""
    (h_lo, h_hi), (w_lo, w_hi) = pads
    return [w_lo, w_hi, h_lo, h_hi]


class _CaffeExecutor:
    def __init__(self, params: Dict[str, List[torch.Tensor]],
                 training: bool, rng):
        self.params = params
        self.training = training
        self.rng = rng
        self._drop_count = 0
        self._current_tops: List[str] = []

    def blobs(self, layer: Dict) -> List[torch.Tensor]:
        return self.params.get(layer["name"], [])

    def run(self, layer: Dict, ins: List):
        kind = str(layer.get("type", "")).replace("_", "").lower()
        h = getattr(self, f"op_{kind}", None)
        if h is None:
            raise NotImplementedError(
                f"caffe layer type {layer.get('type')!r} not supported "
                f"(layer {layer.get('name')!r})")
        out = h(layer, ins)
        return out if isinstance(out, (list, tuple)) else [out]

    # ---------------------------------------------------------- conv/fc/pool
    @staticmethod
    def _spatial(param: Dict, key: str, default: int) -> Tuple[int, int]:
        vs = _as_list(param.get(key))
        if vs:
            return (int(vs[0]), int(vs[-1]))
        h = param.get(f"{key}_h")
        w = param.get(f"{key}_w")
        if h is not None or w is not None:
            return (int(h or default), int(w or default))
        return (default, default)

    def op_convolution(self, layer, ins):
        p = layer.get("convolution_param", {})
        kh, kw = self._spatial(p, "kernel_size", 1)
        sh, sw = self._spatial(p, "stride", 1)
        ph, pw = self._spatial(p, "pad", 0)
        dil = int(_as_list(p.get("dilation", 1))[0] or 1)
        group = int(p.get("group", 1))
        blobs = self.blobs(layer)
        w = blobs[0].reshape(int(p["num_output"]), -1, kh, kw)
        b = blobs[1].reshape(-1) if len(blobs) > 1 and bool(
            p.get("bias_term", True)) else None
        return F.conv2d(ins[0], w, b, stride=(sh, sw), padding=(ph, pw),
                        dilation=dil, groups=group)

    def op_deconvolution(self, layer, ins):
        # caffe's deconvolution is the conv gradient: torch's
        # conv_transpose2d, blob (in, out/group, kh, kw), grouped as is
        p = layer.get("convolution_param", {})
        kh, kw = self._spatial(p, "kernel_size", 1)
        sh, sw = self._spatial(p, "stride", 1)
        ph, pw = self._spatial(p, "pad", 0)
        blobs = self.blobs(layer)
        n_out = int(p["num_output"])
        group = int(p.get("group", 1))
        w = blobs[0].reshape(-1, n_out // group, kh, kw)
        b = blobs[1].reshape(-1) if len(blobs) > 1 and bool(
            p.get("bias_term", True)) else None
        return F.conv_transpose2d(ins[0], w, b, stride=(sh, sw),
                                  padding=(ph, pw), groups=group)

    def op_innerproduct(self, layer, ins):
        p = layer.get("inner_product_param", {})
        axis = int(p.get("axis", 1))
        x = ins[0]
        lead = int(np.prod(x.shape[:axis])) if axis else 1
        x2 = x.reshape(lead, -1)
        blobs = self.blobs(layer)
        w = blobs[0].reshape(int(p["num_output"]), -1)   # (out, in)
        y = x2 @ w.t()
        if len(blobs) > 1 and bool(p.get("bias_term", True)):
            y = y + blobs[1].reshape(-1)
        return y.reshape(tuple(x.shape[:axis]) + (int(p["num_output"]),))

    def op_pooling(self, layer, ins):
        p = layer.get("pooling_param", {})
        x = ins[0]
        if bool(p.get("global_pooling", False)):
            kh, kw = x.shape[2], x.shape[3]
            sh = sw = 1
            pads = ((0, 0), (0, 0))
        else:
            kh, kw = self._spatial(p, "kernel_size", 1)
            sh, sw = self._spatial(p, "stride", 1)
            ph, pw = self._spatial(p, "pad", 0)
            pads = (_ceil_pool_pads(x.shape[2], kh, sh, ph),
                    _ceil_pool_pads(x.shape[3], kw, sw, pw))
        method = str(p.get("pool", "MAX")).upper()
        if method in ("MAX", "0"):
            return F.max_pool2d(F.pad(x, _pad4(pads), value=float("-inf")),
                                (kh, kw), (sh, sw))
        # AVE: caffe divides by the window's area clipped to the symmetric
        # padding bounds [0, size+2p): padded cells inside p count, cells
        # in the ceil-mode extension beyond it do not
        area = float(kh * kw)
        summed = F.avg_pool2d(F.pad(x, _pad4(pads)), (kh, kw),
                              (sh, sw)) * area
        (ph_lo, ph_hi), (pw_lo, pw_hi) = pads
        ones = F.pad(torch.ones_like(x), [pw_lo, min(pw_lo, pw_hi), ph_lo,
                                          min(ph_lo, ph_hi)], value=1.0)
        ones = F.pad(ones, [0, pw_hi - min(pw_lo, pw_hi), 0,
                            ph_hi - min(ph_lo, ph_hi)])
        counts = F.avg_pool2d(ones, (kh, kw), (sh, sw)) * area
        return summed / counts

    # ----------------------------------------------------------- activations
    def op_relu(self, layer, ins):
        slope = float(layer.get("relu_param", {}).get("negative_slope", 0.0))
        if slope:
            return F.leaky_relu(ins[0], slope)
        return F.relu(ins[0])

    def op_prelu(self, layer, ins):
        alpha = self.blobs(layer)[0].reshape(1, -1, 1, 1)
        return torch.where(ins[0] >= 0, ins[0], alpha * ins[0])

    def op_elu(self, layer, ins):
        alpha = float(layer.get("elu_param", {}).get("alpha", 1.0))
        return F.elu(ins[0], alpha)

    def op_sigmoid(self, layer, ins):
        return torch.sigmoid(ins[0])

    def op_tanh(self, layer, ins):
        return torch.tanh(ins[0])

    def op_absval(self, layer, ins):
        return torch.abs(ins[0])

    def op_exp(self, layer, ins):
        p = layer.get("exp_param", {})
        base = float(p.get("base", -1.0))
        scale = float(p.get("scale", 1.0))
        shift = float(p.get("shift", 0.0))
        z = scale * ins[0] + shift
        return torch.exp(z) if base <= 0 else base ** z

    def op_log(self, layer, ins):
        p = layer.get("log_param", {})
        base = float(p.get("base", -1.0))
        scale = float(p.get("scale", 1.0))
        shift = float(p.get("shift", 0.0))
        y = torch.log(scale * ins[0] + shift)
        return y if base <= 0 else y / np.log(base)

    def op_power(self, layer, ins):
        p = layer.get("power_param", {})
        power = float(p.get("power", 1.0))
        scale = float(p.get("scale", 1.0))
        shift = float(p.get("shift", 0.0))
        return (shift + scale * ins[0]) ** power

    def op_threshold(self, layer, ins):
        th = float(layer.get("threshold_param", {}).get("threshold", 0.0))
        return (ins[0] > th).to(ins[0].dtype)

    def op_softmax(self, layer, ins):
        axis = int(layer.get("softmax_param", {}).get("axis", 1))
        return torch.softmax(ins[0], dim=axis)

    def op_dropout(self, layer, ins):
        if not self.training or self.rng is None:
            return ins[0]
        ratio = float(layer.get("dropout_param", {}).get("dropout_ratio",
                                                         0.5))
        self._drop_count += 1
        key = prng.fold_in(self.rng, self._drop_count)
        keep = 1.0 - ratio
        mask = prng.bernoulli(key, keep, tuple(ins[0].shape),
                              device=ins[0].device)
        return torch.where(mask, ins[0] / keep, torch.zeros_like(ins[0]))

    # ------------------------------------------------------------------ norm
    def op_lrn(self, layer, ins):
        p = layer.get("lrn_param", {})
        n = int(p.get("local_size", 5))
        alpha = float(p.get("alpha", 1.0))
        beta = float(p.get("beta", 0.75))
        k = float(p.get("k", 1.0))
        region = str(p.get("norm_region", "ACROSS_CHANNELS")).upper()
        x = ins[0]
        sq = x * x
        lo, hi = (n - 1) // 2, n - 1 - (n - 1) // 2    # XLA's SAME window
        if region in ("ACROSS_CHANNELS", "0"):
            # a window of n channels: pad the channel axis, sum the shifts
            padded = F.pad(sq.unsqueeze(1), [0, 0, 0, 0, lo, hi]).squeeze(1)
            c = x.shape[1]
            ssum = padded[:, 0:c]
            for i in range(1, n):
                ssum = ssum + padded[:, i:i + c]
            size = n
        else:
            ssum = F.avg_pool2d(F.pad(sq, [lo, hi, lo, hi]), n, 1) * (n * n)
            size = n * n
        return x / (k + (alpha / size) * ssum) ** beta

    def op_batchnorm(self, layer, ins):
        eps = float(layer.get("batch_norm_param", {}).get("eps", 1e-5))
        blobs = self.blobs(layer)
        mean, var = blobs[0], blobs[1]
        if len(blobs) > 2:
            # caffe stores mean/var times a moving-average factor; factor 0
            # (an untrained net) means "use 0" (caffe's own rule)
            f = blobs[2].reshape(-1)[0]
            sf = torch.where(f == 0, torch.zeros_like(f),
                             1.0 / torch.where(f == 0, torch.ones_like(f),
                                               f))
        else:
            sf = 1.0
        shape = (1, -1) + (1,) * (ins[0].dim() - 2)
        return ((ins[0] - (mean * sf).reshape(shape))
                / torch.sqrt((var * sf).reshape(shape) + eps))

    @staticmethod
    def _axis_broadcast(x, other, axis: int):
        """Caffe broadcast: ``other``'s dims align with ``x`` from ``axis``
        (default 1 = channels), not from the trailing axis."""
        if other.dim() == x.dim():
            return other
        shape = ((1,) * axis + tuple(other.shape)
                 + (1,) * (x.dim() - axis - other.dim()))
        return other.reshape(shape)

    def op_scale(self, layer, ins):
        p = layer.get("scale_param", {})
        axis = int(p.get("axis", 1))
        blobs = self.blobs(layer)
        if len(ins) > 1:                  # two-bottom form: y = x0 * x1
            return ins[0] * self._axis_broadcast(ins[0], ins[1], axis)
        y = ins[0] * self._axis_broadcast(ins[0], blobs[0], axis)
        if len(blobs) > 1 and bool(p.get("bias_term", False)):
            y = y + self._axis_broadcast(ins[0], blobs[1], axis)
        return y

    def op_bias(self, layer, ins):
        axis = int(layer.get("bias_param", {}).get("axis", 1))
        other = ins[1] if len(ins) > 1 else self.blobs(layer)[0]
        return ins[0] + self._axis_broadcast(ins[0], other, axis)

    # ----------------------------------------------------------------- shape
    def op_eltwise(self, layer, ins):
        p = layer.get("eltwise_param", {})
        op = str(p.get("operation", "SUM")).upper()
        if op in ("PROD", "0"):
            out = ins[0]
            for x in ins[1:]:
                out = out * x
            return out
        if op in ("MAX", "2"):
            out = ins[0]
            for x in ins[1:]:
                out = torch.maximum(out, x)
            return out
        coeffs = [float(c) for c in _as_list(p.get("coeff"))] or \
            [1.0] * len(ins)
        out = coeffs[0] * ins[0]
        for c, x in zip(coeffs[1:], ins[1:]):
            out = out + c * x
        return out

    def op_concat(self, layer, ins):
        axis = int(layer.get("concat_param", {}).get("axis", 1))
        return torch.cat(ins, dim=axis)

    def op_flatten(self, layer, ins):
        # caffe Flatten collapses dims from axis onward
        axis = int(layer.get("flatten_param", {}).get("axis", 1))
        return ins[0].reshape(tuple(ins[0].shape[:axis]) + (-1,))

    def op_reshape(self, layer, ins):
        dims = [int(d) for d in
                _as_list(layer.get("reshape_param", {}).get("shape", {})
                         .get("dim"))]
        shape = tuple(ins[0].shape[i] if d == 0 else d
                      for i, d in enumerate(dims))
        return ins[0].reshape(shape)

    def op_slice(self, layer, ins):
        p = layer.get("slice_param", {})
        axis = int(p.get("axis", 1))
        points = [int(v) for v in _as_list(p.get("slice_point"))]
        x = ins[0]
        if points:
            edges = [0] + points + [x.shape[axis]]
            return list(torch.split(x, [b - a for a, b in
                                        zip(edges, edges[1:])], dim=axis))
        n_top = len(_as_list(self._current_tops))
        return list(torch.chunk(x, n_top, dim=axis))

    def op_split(self, layer, ins):
        return [ins[0]] * len(_as_list(self._current_tops))

    def op_tile(self, layer, ins):
        p = layer.get("tile_param", {})
        axis = int(p.get("axis", 1))
        reps = [1] * ins[0].dim()
        reps[axis] = int(p.get("tiles", 1))
        return ins[0].repeat(reps)

    def op_input(self, layer, ins):
        raise RuntimeError("Input layers are bound by the caller")

    op_data = op_input


class CaffeModel(Layer):
    """An imported caffe net as a trainable layer: each blob a parameter
    (``<layer>.<i>``), the layers run in prototxt order. ``net_layers``
    holds the prototxt's layer dicts. ``device``: CUDA unless the caller
    names another (raises with no CUDA and no device). Made by
    :func:`load_caffe`."""

    takes_rng = True

    def __init__(self, net: Dict, blobs: Dict[str, List[np.ndarray]],
                 name=None, *, device=None):
        super().__init__(name=name or str(net.get("name", "caffe_net")))
        self.net = net
        self.net_layers = [l for l in _as_list(net.get("layer"))
                           or _as_list(net.get("layers"))]
        self.initial_blobs = blobs
        self.input_names = self._find_inputs()
        self.output_names = self._find_outputs()
        self._blob_names: Dict[str, int] = {}
        for lname, arrs in blobs.items():
            holder = torch.nn.Module()
            for i, a in enumerate(arrs):
                holder.register_parameter(str(i), torch.nn.Parameter(
                    torch.from_numpy(np.array(a, dtype=np.float32))))
            self.add_module(lname, holder)
            self._blob_names[lname] = len(arrs)
        self.built = True
        self.device = resolve_device(device)
        self.to(self.device)
        self.eval()

    def _find_inputs(self) -> List[str]:
        ins = [str(v) for v in _as_list(self.net.get("input"))]
        for l in self.net_layers:
            if str(l.get("type", "")).lower() in ("input", "data"):
                ins.extend(str(t) for t in _as_list(l.get("top")))
        return ins

    def _find_outputs(self) -> List[str]:
        produced: List[str] = []
        consumed = set()
        for l in self.net_layers:
            tops = [str(t) for t in _as_list(l.get("top"))]
            bottoms = [str(b) for b in _as_list(l.get("bottom"))]
            consumed.update(b for b in bottoms if b not in tops)  # in-place
            for t in tops:
                if t in produced:
                    produced.remove(t)
                produced.append(t)
        return [t for t in produced if t not in consumed] or produced[-1:]

    def blob_params(self) -> Dict[str, List[torch.Tensor]]:
        """{layer name: [blob parameters]}, the JAX tree's layout."""
        return {name: [getattr(self._modules[name], str(i))
                       for i in range(n)]
                for name, n in self._blob_names.items()}

    def apply(self, x, rng=None):
        xs = list(x) if isinstance(x, (list, tuple)) else [x]
        if len(xs) != len(self.input_names):
            raise ValueError(f"net takes inputs {self.input_names}, "
                             f"got {len(xs)} arrays")
        env: Dict[str, object] = dict(zip(self.input_names, xs))
        ex = _CaffeExecutor(self.blob_params(), self.training, rng)
        for l in self.net_layers:
            kind = str(l.get("type", "")).lower()
            if kind in ("input", "data"):
                continue
            bottoms = [str(b) for b in _as_list(l.get("bottom"))]
            tops = [str(t) for t in _as_list(l.get("top"))]
            ex._current_tops = tops
            outs = ex.run(l, [env[b] for b in bottoms])
            for t, o in zip(tops, outs):
                env[t] = o
        outs = [env[o] for o in self.output_names]
        return outs[0] if len(outs) == 1 else outs

    def predict(self, x):
        """The net's outputs on numpy input(s), as numpy (a list for
        several outputs)."""
        xs = list(x) if isinstance(x, (list, tuple)) else [x]
        ts = [torch.as_tensor(np.asarray(a, np.float32), device=self.device)
              for a in xs]
        with torch.no_grad():
            y = self.apply(ts[0] if len(ts) == 1 else ts)
        if isinstance(y, (list, tuple)):
            return [o.cpu().numpy() for o in y]
        return y.cpu().numpy()


def load_caffe(def_path: str, model_path: Optional[str] = None, *,
               device=None) -> CaffeModel:
    """prototxt (+ an optional caffemodel's weights) → :class:`CaffeModel`
    on ``device`` (CUDA unless given)."""
    with open(def_path) as f:
        net = parse_prototxt(f.read())
    blobs: Dict[str, List[np.ndarray]] = {}
    if model_path is not None:
        with open(model_path, "rb") as f:
            blobs = decode_caffemodel(f.read())
    return CaffeModel(net, blobs, device=device)


__all__ = ["CaffeModel", "decode_caffemodel", "encode_caffemodel",
           "load_caffe", "parse_prototxt"]
