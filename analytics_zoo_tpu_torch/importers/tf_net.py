"""TFNet — run TF frozen graphs and SavedModels on the port (port of
``analytics_zoo_tpu/importers/tf_net.py``).

The GraphDef executes node by node in torch (the ONNX executor's pattern,
``onnx_loader.py``), in TF's own NHWC layout, so imported weights need no
transposition. Weights come from Const nodes (frozen graphs), which stay
numpy constants copied to the device once, or from the checkpoint bundle
under ``variables/`` (SavedModels, read by
``tf_proto.read_checkpoint_bundle``), which are the net's ``variables``
and, served through ``InferenceModel.load_tf``, its parameters. No
tensorflow import on either path.

Supported ops: Placeholder/PlaceholderWithDefault, Const, Identity(N),
NoOp, VariableV2/VarHandleOp/ReadVariableOp, MatMul, BatchMatMul(V2),
BiasAdd, Add, AddV2, AddN, Sub, Mul, RealDiv, Maximum, Minimum,
SquaredDifference, Neg, Abs, Exp, Log, Sqrt, Rsqrt, Square, Pow, Relu,
Relu6, LeakyRelu, Elu, Selu, Sigmoid, Tanh, Softmax, LogSoftmax, Softplus,
Erf, Conv2D, DepthwiseConv2dNative, Conv2DBackpropInput, MaxPool, AvgPool,
FusedBatchNorm(V2/V3), Mean, Sum, Max, Min, Prod, ArgMax, Pad, PadV2,
ConcatV2, Reshape, Squeeze, ExpandDims, Transpose, Shape, StridedSlice,
Slice, Pack, Unpack, Fill, Cast, Rank, Tile, GatherV2, Greater, Less,
Select/SelectV2, StopGradient; any other raises ``NotImplementedError``
naming it. Doubles compute as float32, as JAX's default precision does.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.module import resolve_device
from .tf_proto import SavedModel, TFGraph, TFNode, read_checkpoint_bundle


def _base(name: str) -> Tuple[str, int]:
    """'node:1' → ('node', 1); control inputs '^node' → ('node', -1)."""
    if name.startswith("^"):
        return name[1:], -1
    if ":" in name:
        base, idx = name.rsplit(":", 1)
        return base, int(idx)
    return name, 0


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _scalar(v) -> np.generic:
    """A scalar operand's value (the codec gives a 0-d tensor shape
    (1,))."""
    return _host(v).reshape(-1)[0]


_TF_TORCH = {1: torch.float32, 2: torch.float32, 3: torch.int32,
             4: torch.uint8, 5: torch.int16, 6: torch.int8, 9: torch.int64,
             10: torch.bool, 14: torch.bfloat16, 19: torch.float16}


def _same_pads(size: int, k: int, s: int, d: int = 1) -> Tuple[int, int]:
    """TF/XLA SAME padding of one dim: the odd pixel at the end."""
    k_eff = (k - 1) * d + 1
    out = -(-size // s)
    total = max((out - 1) * s + k_eff - size, 0)
    return total // 2, total - total // 2


class _TFExecutor:
    """Per-node dispatch over torch tensors on ``device`` and numpy host
    constants; mirrors ``onnx_loader._Executor``."""

    def __init__(self, variables: Dict[str, object], device, consts):
        self.variables = variables
        self.device = device
        self.consts = consts

    def t(self, v) -> torch.Tensor:
        """A tensor operand on the device (a Const's copy made once)."""
        if isinstance(v, torch.Tensor):
            return v
        hit = self.consts.get(id(v))
        if hit is not None and hit[0] is v:
            return hit[1]
        a = np.asarray(v)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def run(self, node: TFNode, ins: List):
        h = getattr(self, f"op_{node.op}", None)
        if h is None:
            raise NotImplementedError(
                f"TF op {node.op!r} not supported (node {node.name!r}); "
                "supported set listed in tf_net.py module docstring")
        out = h(node, ins)
        return out if isinstance(out, (list, tuple)) else [out]

    # -------------------------------------------------------------- variables
    def op_VariableV2(self, n, ins):
        return self.t(self.variables[n.name])

    op_VarHandleOp = op_VariableV2

    def op_ReadVariableOp(self, n, ins):
        return ins[0]

    # ------------------------------------------------------------ structural
    def op_Placeholder(self, n, ins):
        raise RuntimeError(f"unbound placeholder {n.name!r} — pass it as "
                           f"input")

    def op_PlaceholderWithDefault(self, n, ins):
        return ins[0]

    def op_Const(self, n, ins):
        value = n.attr("value")
        if isinstance(value, np.ndarray) and value.size > 1 and \
                id(value) not in self.consts:
            # copied to the device once; the cache keeps the array alive,
            # so its id stays its own
            self.consts[id(value)] = (value, self.t(value))
        return value

    def op_Identity(self, n, ins):
        return ins[0]

    op_StopGradient = op_Identity
    op_PreventGradient = op_Identity

    def op_IdentityN(self, n, ins):
        return list(ins)

    def op_NoOp(self, n, ins):
        return []

    # ------------------------------------------------------------ arithmetic
    def op_Add(self, n, ins):
        return self.t(ins[0]) + self.t(ins[1])

    op_AddV2 = op_Add

    def op_AddN(self, n, ins):
        out = self.t(ins[0])
        for x in ins[1:]:
            out = out + self.t(x)
        return out

    def op_Sub(self, n, ins):
        return self.t(ins[0]) - self.t(ins[1])

    def op_Mul(self, n, ins):
        return self.t(ins[0]) * self.t(ins[1])

    def op_RealDiv(self, n, ins):
        return self.t(ins[0]) / self.t(ins[1])

    op_Div = op_RealDiv

    def op_Maximum(self, n, ins):
        return torch.maximum(self.t(ins[0]), self.t(ins[1]))

    def op_Minimum(self, n, ins):
        return torch.minimum(self.t(ins[0]), self.t(ins[1]))

    def op_SquaredDifference(self, n, ins):
        d = self.t(ins[0]) - self.t(ins[1])
        return d * d

    def op_Neg(self, n, ins):
        return -self.t(ins[0])

    def op_Abs(self, n, ins):
        return torch.abs(self.t(ins[0]))

    def op_Exp(self, n, ins):
        return torch.exp(self.t(ins[0]))

    def op_Log(self, n, ins):
        return torch.log(self.t(ins[0]))

    def op_Sqrt(self, n, ins):
        return torch.sqrt(self.t(ins[0]))

    def op_Rsqrt(self, n, ins):
        return torch.rsqrt(self.t(ins[0]))

    def op_Square(self, n, ins):
        x = self.t(ins[0])
        return x * x

    def op_Pow(self, n, ins):
        return torch.pow(self.t(ins[0]), self.t(ins[1]))

    def op_Greater(self, n, ins):
        return self.t(ins[0]) > self.t(ins[1])

    def op_Less(self, n, ins):
        return self.t(ins[0]) < self.t(ins[1])

    def op_Select(self, n, ins):
        return torch.where(self.t(ins[0]), self.t(ins[1]), self.t(ins[2]))

    op_SelectV2 = op_Select

    # ----------------------------------------------------------- activations
    def op_Relu(self, n, ins):
        return F.relu(self.t(ins[0]))

    def op_Relu6(self, n, ins):
        return torch.clamp(self.t(ins[0]), 0, 6)

    def op_LeakyRelu(self, n, ins):
        return F.leaky_relu(self.t(ins[0]), n.attr("alpha", 0.2))

    def op_Elu(self, n, ins):
        return F.elu(self.t(ins[0]))

    def op_Selu(self, n, ins):
        return F.selu(self.t(ins[0]))

    def op_Sigmoid(self, n, ins):
        return torch.sigmoid(self.t(ins[0]))

    def op_Tanh(self, n, ins):
        return torch.tanh(self.t(ins[0]))

    def op_Softmax(self, n, ins):
        return torch.softmax(self.t(ins[0]), dim=-1)

    def op_LogSoftmax(self, n, ins):
        return torch.log_softmax(self.t(ins[0]), dim=-1)

    def op_Softplus(self, n, ins):
        return F.softplus(self.t(ins[0]))

    def op_Erf(self, n, ins):
        return torch.erf(self.t(ins[0]))

    # ---------------------------------------------------------------- matmul
    def op_MatMul(self, n, ins):
        a, b = self.t(ins[0]), self.t(ins[1])
        if n.attr("transpose_a", False):
            a = a.t()
        if n.attr("transpose_b", False):
            b = b.t()
        return a @ b

    def op_BatchMatMul(self, n, ins):
        a, b = self.t(ins[0]), self.t(ins[1])
        if n.attr("adj_x", False):
            a = a.transpose(-1, -2)
        if n.attr("adj_y", False):
            b = b.transpose(-1, -2)
        return a @ b

    op_BatchMatMulV2 = op_BatchMatMul

    def op_BiasAdd(self, n, ins):
        x, b = self.t(ins[0]), self.t(ins[1])
        fmt = n.attr("data_format", b"NHWC")
        if fmt == b"NCHW" and x.dim() > 2:
            return x + b.reshape((1, -1) + (1,) * (x.dim() - 2))
        return x + b

    # ------------------------------------------------------------------ conv
    def _padding(self, n):
        p = n.attr("padding", b"VALID")
        return p.decode() if isinstance(p, bytes) else p

    def _strides_2d(self, n):
        s = n.attr("strides", (1, 1, 1, 1))
        return (int(s[1]), int(s[2]))

    def _conv_nhwc(self, n, x, w_oihw, strides, dil=(1, 1), groups=1):
        """An NHWC conv through ``F.conv2d`` (NCHW), TF's padding."""
        x = x.permute(0, 3, 1, 2)
        kh, kw = w_oihw.shape[2:]
        if self._padding(n) == "SAME":
            (t, b) = _same_pads(x.shape[2], kh, strides[0], dil[0])
            (l, r) = _same_pads(x.shape[3], kw, strides[1], dil[1])
            x = F.pad(x, [l, r, t, b])
        y = F.conv2d(x, w_oihw, stride=strides, dilation=dil, groups=groups)
        return y.permute(0, 2, 3, 1)

    def op_Conv2D(self, n, ins):
        if n.attr("data_format", b"NHWC") != b"NHWC":
            raise NotImplementedError("Conv2D NCHW data_format")
        dil = n.attr("dilations", (1, 1, 1, 1))
        w = self.t(ins[1]).permute(3, 2, 0, 1)         # HWIO → OIHW
        return self._conv_nhwc(n, self.t(ins[0]), w, self._strides_2d(n),
                               (int(dil[1]), int(dil[2])))

    def op_DepthwiseConv2dNative(self, n, ins):
        x, w = self.t(ins[0]), self.t(ins[1])   # w: (kh, kw, in, mult)
        kh, kw, in_ch, mult = w.shape
        w = w.reshape(kh, kw, 1, in_ch * mult).permute(3, 2, 0, 1)
        return self._conv_nhwc(n, x, w, self._strides_2d(n), groups=in_ch)

    def op_Conv2DBackpropInput(self, n, ins):
        # (output_shape, filter, grad): the deconv forward pass, padded as
        # jax.lax.conv_transpose pads ("SAME" / "VALID")
        out_shape = tuple(int(s) for s in _host(ins[0]).reshape(-1))
        w, x = self.t(ins[1]), self.t(ins[2])   # w: (kh, kw, out, in)
        sh, sw = self._strides_2d(n)
        pad = self._padding(n)
        kh, kw = w.shape[:2]
        pads = []
        for k, s in ((kh, sh), (kw, sw)):
            if pad == "SAME":
                pad_len = k + s - 2
                lo = k - 1 if s > k - 1 else int(np.ceil(pad_len / 2))
            else:
                pad_len = k + s - 2 + max(k - s, 0)
                lo = k - 1
            pads.append((lo, pad_len - lo))
        # conv_transpose2d(padding p, output_padding o) pads the dilated
        # input by k-1-p low and k-1-p+o high; a high side one short of
        # the low side is cropped after
        p = [k - 1 - lo for (lo, _), k in zip(pads, (kh, kw))]
        o = [max(hi - lo, 0) for lo, hi in pads]
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                               stride=(sh, sw), padding=p, output_padding=o)
        for d, (lo, hi) in enumerate(pads):
            if hi < lo:
                y = y.narrow(2 + d, 0, y.shape[2 + d] - (lo - hi))
        y = y.permute(0, 2, 3, 1)
        if tuple(y.shape) != out_shape:
            raise NotImplementedError(
                f"Conv2DBackpropInput output shape {tuple(y.shape)} != "
                f"requested {out_shape} (padding {pad})")
        return y

    def _pool(self, n, x, pool, fill):
        k = [int(v) for v in n.attr("ksize", (1, 2, 2, 1))]
        s = [int(v) for v in n.attr("strides", (1, 2, 2, 1))]
        if k[0] != 1 or k[3] != 1 or s[0] != 1 or s[3] != 1:
            raise NotImplementedError("pooling over the batch or channels")
        x = x.permute(0, 3, 1, 2)
        if self._padding(n) == "SAME":
            (t, b) = _same_pads(x.shape[2], k[1], s[1])
            (l, r) = _same_pads(x.shape[3], k[2], s[2])
            x = F.pad(x, [l, r, t, b], value=fill)
        return pool(x, (k[1], k[2]), (s[1], s[2])).permute(0, 2, 3, 1)

    def op_MaxPool(self, n, ins):
        return self._pool(n, self.t(ins[0]), F.max_pool2d, float("-inf"))

    def op_AvgPool(self, n, ins):
        x = self.t(ins[0])
        k = [int(v) for v in n.attr("ksize", (1, 2, 2, 1))]
        area = float(k[1] * k[2])
        summed = self._pool(n, x, F.avg_pool2d, 0.0) * area
        if self._padding(n) == "VALID":
            return summed / area
        counts = self._pool(n, torch.ones_like(x), F.avg_pool2d, 0.0) * area
        return summed / counts

    def op_FusedBatchNorm(self, n, ins):
        if n.attr("data_format", b"NHWC") not in (b"NHWC", None):
            raise NotImplementedError("FusedBatchNorm NCHW data_format")
        x, scale, bias, mean, var = [self.t(v) for v in ins[:5]]
        eps = n.attr("epsilon", 1e-4)
        y = (x - mean) * torch.rsqrt(var + eps) * scale + bias
        return [y, mean, var, mean, var]

    op_FusedBatchNormV2 = op_FusedBatchNorm
    op_FusedBatchNormV3 = op_FusedBatchNorm

    # ------------------------------------------------------------ reductions
    def _axes(self, ins):
        return tuple(int(a) for a in np.ravel(_host(ins[1])))

    def _reduce(self, n, ins, fn):
        x = self.t(ins[0])
        axes = self._axes(ins)
        keep = bool(n.attr("keep_dims", False))
        if not axes:
            return x
        if fn in (torch.amax, torch.amin, torch.sum, torch.mean):
            return fn(x, dim=axes, keepdim=keep)
        for a in sorted((a % x.dim() for a in axes), reverse=True):
            x = fn(x, dim=a, keepdim=keep)
        return x

    def op_Mean(self, n, ins):
        return self._reduce(n, ins, torch.mean)

    def op_Sum(self, n, ins):
        return self._reduce(n, ins, torch.sum)

    def op_Max(self, n, ins):
        return self._reduce(n, ins, torch.amax)

    def op_Min(self, n, ins):
        return self._reduce(n, ins, torch.amin)

    def op_Prod(self, n, ins):
        return self._reduce(n, ins, torch.prod)

    def op_ArgMax(self, n, ins):
        axis = int(_scalar(ins[1])) if len(ins) > 1 else -1
        return torch.argmax(self.t(ins[0]), dim=axis).to(torch.int64)

    # ----------------------------------------------------------------- shape
    def op_Reshape(self, n, ins):
        shape = tuple(int(s) for s in _host(ins[1]).reshape(-1))
        return self.t(ins[0]).reshape(shape)

    def op_Squeeze(self, n, ins):
        dims = n.attr("squeeze_dims", ()) or n.attr("axis", ())
        x = self.t(ins[0])
        return x.squeeze(tuple(int(d) for d in dims)) if dims else \
            x.squeeze()

    def op_ExpandDims(self, n, ins):
        return self.t(ins[0]).unsqueeze(int(_scalar(ins[1])))

    def op_Transpose(self, n, ins):
        return self.t(ins[0]).permute(
            tuple(int(p) for p in _host(ins[1]).reshape(-1)))

    def op_Shape(self, n, ins):
        return np.asarray(tuple(ins[0].shape), dtype=np.int32)

    def op_Rank(self, n, ins):
        return np.asarray(len(ins[0].shape), dtype=np.int32)

    def op_Fill(self, n, ins):
        shape = tuple(int(s) for s in _host(ins[0]).reshape(-1))
        value = self.t(ins[1])
        return value.expand(shape).clone()

    def op_Cast(self, n, ins):
        dst = n.attr("DstT", 1)
        return self.t(ins[0]).to(_TF_TORCH.get(dst, torch.float32))

    def op_Tile(self, n, ins):
        return self.t(ins[0]).repeat(
            tuple(int(m) for m in _host(ins[1]).reshape(-1)))

    def op_Pack(self, n, ins):
        return torch.stack([self.t(v) for v in ins],
                           dim=int(n.attr("axis", 0)))

    def op_Unpack(self, n, ins):
        x = self.t(ins[0])
        axis = int(n.attr("axis", 0))
        return list(x.unbind(axis))

    def op_ConcatV2(self, n, ins):
        axis = int(_scalar(ins[-1]))
        return torch.cat([self.t(v) for v in ins[:-1]], dim=axis)

    def op_Pad(self, n, ins):
        pairs = [(int(a), int(b)) for a, b in _host(ins[1])]
        const = float(_scalar(ins[2])) if len(ins) > 2 else 0.0
        return F.pad(self.t(ins[0]),
                     [v for lo, hi in reversed(pairs) for v in (lo, hi)],
                     value=const)

    op_PadV2 = op_Pad

    def op_Slice(self, n, ins):
        x = self.t(ins[0])
        begin = [int(b) for b in _host(ins[1]).reshape(-1)]
        size = [int(s) for s in _host(ins[2]).reshape(-1)]
        for i, (b, s) in enumerate(zip(begin, size)):
            x = x.narrow(i, b, s if s != -1 else x.shape[i] - b)
        return x

    def op_StridedSlice(self, n, ins):
        x = self.t(ins[0])
        begin = _host(ins[1]).reshape(-1)
        end = _host(ins[2]).reshape(-1)
        strides = (_host(ins[3]).reshape(-1) if len(ins) > 3
                   else np.ones_like(begin))
        bm = int(n.attr("begin_mask", 0))
        em = int(n.attr("end_mask", 0))
        sm = int(n.attr("shrink_axis_mask", 0))
        nm = int(n.attr("new_axis_mask", 0))
        el = int(n.attr("ellipsis_mask", 0))
        if nm or el:
            raise NotImplementedError(
                "StridedSlice new_axis_mask/ellipsis_mask")
        # dim by dim from the last, so a shrunk dim does not renumber the
        # ones still to slice; torch slices take steps > 0 only, so a
        # negative step selects its indices
        for i in reversed(range(len(begin))):
            dim = x.shape[i]
            if sm & (1 << i):
                x = x.select(i, int(begin[i]))
                continue
            st = int(strides[i])
            b = None if bm & (1 << i) else int(begin[i])
            e = None if em & (1 << i) else int(end[i])
            if st > 0:
                x = x[(slice(None),) * i + (slice(b, e, st),)]
            else:
                idx = list(range(*slice(b, e, st).indices(dim)))
                x = torch.index_select(x, i, torch.as_tensor(
                    idx, dtype=torch.long, device=x.device))
        return x

    def op_GatherV2(self, n, ins):
        x = self.t(ins[0])
        axis = (int(_scalar(ins[2])) if len(ins) > 2 else 0) % x.dim()
        idx = torch.as_tensor(_host(ins[1]).astype(np.int64),
                              device=x.device)
        out = torch.index_select(x, axis, idx.reshape(-1))
        return out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                           + tuple(x.shape[axis + 1:]))

    op_Gather = op_GatherV2


class TFNet:
    """An executable TF graph (a forward-only module).

    ``predict(x)`` runs the graph on numpy inputs and returns numpy;
    ``__call__`` runs it on tensors. ``device``: CUDA unless the caller
    names another (raises with no CUDA and no device). Use
    :func:`from_frozen_graph` / :func:`from_saved_model`.
    """

    def __init__(self, graph: TFGraph, input_names: Sequence[str],
                 output_names: Sequence[str],
                 variables: Optional[Dict[str, np.ndarray]] = None,
                 input_args: Optional[Sequence[str]] = None, *,
                 device=None):
        self.graph = graph
        self.device = resolve_device(device)
        self.input_names = [_base(s)[0] for s in input_names]
        self.output_names = list(output_names)
        # signature argument names aligned with input_names: positional
        # predict() binds in this (sorted-by-arg-name) order; predict also
        # takes these as keywords
        self.input_args = (list(input_args) if input_args
                           else list(self.input_names))
        self.variables = {k: np.asarray(v)
                          for k, v in (variables or {}).items()}
        self._nodes = {n.name: n for n in graph.nodes}
        self._consts: Dict[int, tuple] = {}
        self._var_tensors: Optional[Dict[str, torch.Tensor]] = None

    # -- graph evaluation ----------------------------------------------------
    def _run(self, *inputs, variables: Optional[Dict] = None):
        if len(inputs) != len(self.input_names):
            raise ValueError(
                f"graph takes {len(self.input_names)} inputs "
                f"{self.input_names}, got {len(inputs)}")
        if variables is None:
            if self._var_tensors is None:
                self._var_tensors = {
                    k: torch.as_tensor(v.astype(np.float32)
                                       if v.dtype == np.float64 else v,
                                       device=self.device)
                    for k, v in self.variables.items()}
            variables = self._var_tensors
        env: Dict[str, List] = {}
        ex = _TFExecutor(variables, self.device, self._consts)
        for name, x in zip(self.input_names, inputs):
            env[name] = [ex.t(x)]

        def ensure(name: str):
            """Iterative post-order evaluation (deep graphs would overflow
            Python's recursion)."""
            stack = [(name, False)]
            while stack:
                cur, expanded = stack.pop()
                if cur in env:
                    continue
                node = self._nodes.get(cur)
                if node is None:
                    raise KeyError(f"graph references unknown node {cur!r}")
                deps = [_base(r)[0] for r in node.inputs]
                if not expanded:
                    stack.append((cur, True))
                    stack.extend((d, False) for d in reversed(deps)
                                 if d not in env)
                    continue
                ins = []
                for ref in node.inputs:
                    base, idx = _base(ref)
                    if idx >= 0:                     # drop control deps (^x)
                        ins.append(env[base][idx])
                env[cur] = ex.run(node, ins)

        outs = []
        for ref in self.output_names:
            base, idx = _base(ref)
            ensure(base)
            outs.append(ex.t(env[base][max(idx, 0)]))
        return outs[0] if len(outs) == 1 else tuple(outs)

    def _bind(self, inputs, kwargs):
        if kwargs:
            if inputs:
                raise TypeError("pass inputs positionally or by signature "
                                "arg name, not both")
            try:
                return [kwargs[a] for a in self.input_args]
            except KeyError as e:
                raise KeyError(f"missing input {e.args[0]!r}; signature "
                               f"args: {self.input_args}") from None
        return list(inputs)

    def __call__(self, *inputs, **kwargs):
        return self._run(*self._bind(inputs, kwargs))

    def predict(self, *inputs, **kwargs):
        """Run the graph on numpy inputs. Positional inputs bind in
        ``input_args`` order (sorted signature arg names for SavedModels);
        keywords bind by signature arg name."""
        xs = [torch.as_tensor(np.asarray(x), device=self.device)
              for x in self._bind(inputs, kwargs)]
        with torch.no_grad():
            out = self._run(*xs)

        def host(t):
            return (t.float() if t.dtype == torch.bfloat16 else t).cpu() \
                .numpy()

        return host(out) if not isinstance(out, tuple) else \
            tuple(host(o) for o in out)

    # -- introspection -------------------------------------------------------
    @property
    def ops_used(self):
        return sorted({n.op for n in self.graph.nodes})


def _find_io(graph: TFGraph) -> Tuple[List[str], List[str]]:
    """Infer inputs (Placeholders, with-default included: treating one as
    a constant would make predict() ignore the user's data) and outputs
    (nodes nobody consumes)."""
    inputs = [n.name for n in graph.nodes
              if n.op in ("Placeholder", "PlaceholderWithDefault")]
    consumed = {_base(r)[0] for n in graph.nodes for r in n.inputs}
    terminal_skip = {"Const", "Placeholder", "NoOp", "Assert", "SaveV2",
                     "RestoreV2", "VariableV2", "VarHandleOp"}
    outputs = [n.name for n in graph.nodes
               if n.name not in consumed and n.op not in terminal_skip]
    return inputs, outputs


def from_frozen_graph(path: str, inputs: Optional[Sequence[str]] = None,
                      outputs: Optional[Sequence[str]] = None, *,
                      device=None) -> TFNet:
    """Load a frozen GraphDef ``.pb``."""
    with open(path, "rb") as f:
        graph = TFGraph.decode(f.read())
    auto_in, auto_out = _find_io(graph)
    return TFNet(graph, list(inputs or auto_in), list(outputs or auto_out),
                 device=device)


def from_saved_model(path: str, signature: str = "serving_default",
                     inputs: Optional[Sequence[str]] = None,
                     outputs: Optional[Sequence[str]] = None, *,
                     device=None) -> TFNet:
    """Load a SavedModel dir (saved_model.pb + variables/), no tensorflow
    needed."""
    with open(os.path.join(path, "saved_model.pb"), "rb") as f:
        sm = SavedModel.decode(f.read())
    sig = sm.signatures.get(signature)
    if sig is None and sm.signatures:
        if signature == "serving_default" and len(sm.signatures) == 1:
            sig = next(iter(sm.signatures.values()))   # the only one
        else:
            raise KeyError(
                f"signature {signature!r} not in SavedModel; available: "
                f"{sorted(sm.signatures)}")
    input_args = None
    if inputs is None:
        if sig and sig.inputs:
            # deterministic order by signature ARG name; predict() also
            # takes these names as keywords
            input_args = sorted(sig.inputs)
            inputs = [sig.inputs[a] for a in input_args]
        else:
            inputs = _find_io(sm.graph)[0]
    if outputs is None:
        outputs = (sorted(sig.outputs.values()) if sig and sig.outputs
                   else _find_io(sm.graph)[1])

    variables: Dict[str, np.ndarray] = {}
    prefix = os.path.join(path, "variables", "variables")
    if os.path.exists(prefix + ".index"):
        bundle = read_checkpoint_bundle(prefix)
        var_nodes = [n.name for n in sm.graph.nodes
                     if n.op in ("VariableV2", "VarHandleOp")]
        for name in var_nodes:
            for key in (name, f"{name}/.ATTRIBUTES/VARIABLE_VALUE"):
                if key in bundle:
                    variables[name] = bundle[key]
                    break
            else:
                raise KeyError(
                    f"variable {name!r} not found in checkpoint bundle "
                    f"(keys: {sorted(bundle)[:8]}...)")
    return TFNet(sm.graph, list(inputs), list(outputs), variables,
                 input_args=input_args, device=device)


__all__ = ["TFNet", "from_frozen_graph", "from_saved_model"]
