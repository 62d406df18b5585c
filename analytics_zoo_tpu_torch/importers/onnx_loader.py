"""ONNX graph → executable PyTorch model (port of
``analytics_zoo_tpu/importers/onnx_loader.py``).

The graph executes node by node inside an :class:`OnnxModel` layer, in
NCHW as ONNX defines it, so imported weights need no transposition: float
initializers are the layer's trainable parameters, every other one (shape
constants, indices) stays a numpy constant on the host. Ops whose operands
are all host constants run in numpy (``_HOST_OPS``), so shape chains
(Shape → Gather → Concat → Reshape) stay concrete values, as they do under
JAX's tracing.

Supported ops: Conv, Gemm, MatMul, Add, Sub, Mul, Div, Neg, Abs, Exp, Log,
Sqrt, Pow, Clip, Relu, LeakyRelu, Elu, Sigmoid, HardSigmoid, Tanh,
Softmax, LogSoftmax, Greater, Cast, LRN, Slice, BatchNormalization,
Dropout, Flatten, Reshape, Transpose, Concat, Squeeze, Unsqueeze, MaxPool,
AveragePool, GlobalAveragePool, ReduceMean, ReduceSum, Gather, Shape,
Constant, Identity; any other raises ``NotImplementedError`` naming it.

The JAX package's semantics where its tests pin them: an omitted optional
input (an empty name) keeps its slot, so Clip's max stays its max;
AveragePool divides by the real elements of a padded window
(``count_include_pad=0``); LRN's window at an even size is
``[c - (size-1)//2, c + size//2]``; Unsqueeze's axes index the output
rank; an unknown Cast enum raises ``ValueError`` naming the node. Doubles
compute as float32, as JAX's default precision does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..common import prng
from ..nn.module import Layer, register_dotted
from ..nn.topology import Sequential
from .onnx_proto import Graph, Node, decode_model


def _host(v) -> np.ndarray:
    """A host value of a constant operand (numpy, or a tensor read
    back)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _host_axes(n: Node, ins) -> tuple:
    """Axes for Squeeze/Unsqueeze: opset>=13 passes them as input[1], older
    opsets as the 'axes' attribute."""
    if len(ins) > 1 and ins[1] is not None:
        return tuple(int(a) for a in _host(ins[1]).reshape(-1))
    return tuple(n.attr("axes", ()))


def _np_unsqueeze(x: np.ndarray, axes: tuple) -> np.ndarray:
    """ONNX Unsqueeze: axes are positions in the OUTPUT rank."""
    out_rank = x.ndim + len(axes)
    for a in sorted(a % out_rank for a in axes):
        x = np.expand_dims(x, a)
    return x


def _pads(pads: Sequence[int], n_spatial: int):
    """ONNX pads [b1..bn, e1..en] → [(b1,e1)...]; none → zeros."""
    if not pads:
        return [(0, 0)] * n_spatial
    half = len(pads) // 2
    return list(zip(pads[:half], pads[half:]))


def _torch_pad(pairs) -> List[int]:
    """[(lo, hi) per spatial dim] → ``F.pad``'s last-dim-first list."""
    out: List[int] = []
    for lo, hi in reversed(pairs):
        out += [int(lo), int(hi)]
    return out


_CAST = {1: torch.float32, 2: torch.uint8, 3: torch.int8, 5: torch.int16,
         6: torch.int32, 7: torch.int64, 9: torch.bool, 10: torch.float16,
         11: torch.float32, 16: torch.bfloat16}


class _Executor:
    """Single-node dispatch over an environment of tensors (on
    ``device``) and numpy host constants."""

    def __init__(self, device, training: bool, rng):
        self.device = device
        self.training = training
        self.rng = rng
        self._drop_count = 0

    def t(self, v) -> torch.Tensor:
        """A tensor operand on the device (a float64 constant as f32)."""
        if isinstance(v, torch.Tensor):
            return v
        a = np.asarray(v)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    # ops evaluated in numpy when every operand is a host constant: keeps
    # shape chains (Shape→Gather→Concat→Reshape) concrete
    _HOST_OPS = {
        "Gather": lambda n, ins: np.take(ins[0], np.asarray(ins[1], np.int64),
                                         axis=int(n.attr("axis", 0))),
        "Concat": lambda n, ins: np.concatenate(ins,
                                                axis=int(n.attr("axis", 0))),
        "Add": lambda n, ins: ins[0] + ins[1],
        "Sub": lambda n, ins: ins[0] - ins[1],
        "Mul": lambda n, ins: ins[0] * ins[1],
        "Squeeze": lambda n, ins: np.squeeze(
            ins[0], axis=_host_axes(n, ins) or None),
        "Unsqueeze": lambda n, ins: _np_unsqueeze(ins[0],
                                                  _host_axes(n, ins)),
        "Identity": lambda n, ins: ins[0],
    }

    def run(self, node: Node, ins: List):
        live = [i for i in ins if i is not None]
        if (node.op_type in self._HOST_OPS and live
                and all(isinstance(i, np.ndarray) for i in live)):
            return [self._HOST_OPS[node.op_type](node, ins)]
        h = getattr(self, f"op_{node.op_type}", None)
        if h is None:
            raise NotImplementedError(
                f"ONNX op {node.op_type!r} not supported (node "
                f"{node.name!r})")
        out = h(node, ins)
        return out if isinstance(out, (list, tuple)) else [out]

    # ------------------------------------------------------------ arithmetic
    def op_Add(self, n, ins):
        return self.t(ins[0]) + self.t(ins[1])

    def op_Sub(self, n, ins):
        return self.t(ins[0]) - self.t(ins[1])

    def op_Mul(self, n, ins):
        return self.t(ins[0]) * self.t(ins[1])

    def op_Div(self, n, ins):
        return self.t(ins[0]) / self.t(ins[1])

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

    def op_Pow(self, n, ins):
        return torch.pow(self.t(ins[0]), self.t(ins[1]))

    def op_Clip(self, n, ins):
        x = self.t(ins[0])
        lo = ins[1] if len(ins) > 1 and ins[1] is not None \
            else n.attr("min", -np.inf)
        hi = ins[2] if len(ins) > 2 and ins[2] is not None \
            else n.attr("max", np.inf)
        lo = self.t(np.asarray(lo, np.float32) if not isinstance(
            lo, torch.Tensor) else lo).to(x.dtype)
        hi = self.t(np.asarray(hi, np.float32) if not isinstance(
            hi, torch.Tensor) else hi).to(x.dtype)
        return torch.minimum(torch.maximum(x, lo), hi)

    # ----------------------------------------------------------- activations
    def op_Relu(self, n, ins):
        return F.relu(self.t(ins[0]))

    def op_LeakyRelu(self, n, ins):
        return F.leaky_relu(self.t(ins[0]), n.attr("alpha", 0.01))

    def op_Elu(self, n, ins):
        return F.elu(self.t(ins[0]), n.attr("alpha", 1.0))

    def op_Sigmoid(self, n, ins):
        return torch.sigmoid(self.t(ins[0]))

    def op_HardSigmoid(self, n, ins):
        a, b = n.attr("alpha", 0.2), n.attr("beta", 0.5)
        return torch.clamp(a * self.t(ins[0]) + b, 0.0, 1.0)

    def op_Tanh(self, n, ins):
        return torch.tanh(self.t(ins[0]))

    def op_Softmax(self, n, ins):
        return torch.softmax(self.t(ins[0]), dim=int(n.attr("axis", -1)))

    def op_LogSoftmax(self, n, ins):
        return torch.log_softmax(self.t(ins[0]),
                                 dim=int(n.attr("axis", -1)))

    # ------------------------------------------------------------ comparison
    def op_Greater(self, n, ins):
        return self.t(ins[0]) > self.t(ins[1])

    def op_Cast(self, n, ins):
        enum = int(n.attr("to"))
        to = _CAST.get(enum)
        if to is None:
            raise ValueError(
                f"Cast node {n.name!r}: unsupported TensorProto dtype enum "
                f"{enum} (supported: float/ints/bool/f16/bf16/f64)")
        return self.t(ins[0]).to(to)

    def op_LRN(self, n, ins):
        # local response normalization over channels (axis 1, NCHW); the
        # ONNX window is [c - floor((size-1)/2), c + ceil((size-1)/2)]
        x = self.t(ins[0])
        size = int(n.attr("size"))
        alpha = float(n.attr("alpha", 1e-4))
        beta = float(n.attr("beta", 0.75))
        bias = float(n.attr("bias", 1.0))
        half = (size - 1) // 2
        sq = x * x
        lo = sq.new_zeros(sq.shape[:1] + (half,) + sq.shape[2:])
        hi = sq.new_zeros(sq.shape[:1] + (size - 1 - half,) + sq.shape[2:])
        padded = torch.cat([lo, sq, hi], dim=1)
        c = x.shape[1]
        acc = padded[:, 0:c]
        for i in range(1, size):
            acc = acc + padded[:, i:i + c]
        return x / torch.pow(bias + (alpha / size) * acc, beta)

    def op_Slice(self, n, ins):
        # opset >= 10: starts/ends/[axes]/[steps] as inputs; opset 1 as
        # attributes
        x = self.t(ins[0])

        def vals(v):
            return [int(a) for a in _host(v).reshape(-1)]

        if len(ins) > 1 and ins[1] is not None:
            starts, ends = vals(ins[1]), vals(ins[2])
            axes = (vals(ins[3]) if len(ins) > 3 and ins[3] is not None
                    else list(range(len(starts))))
            steps = (vals(ins[4]) if len(ins) > 4 and ins[4] is not None
                     else [1] * len(starts))
        else:
            starts = [int(v) for v in n.attr("starts")]
            ends = [int(v) for v in n.attr("ends")]
            axes = ([int(v) for v in n.attr("axes")]
                    if n.attr("axes", None) is not None
                    else list(range(len(starts))))
            steps = [1] * len(starts)
        for s, e, a, st in zip(starts, ends, axes, steps):
            a %= x.dim()
            dim = x.shape[a]
            e = min(e, dim) if e >= 0 else e   # onnx clamps INT_MAX ends
            if st > 0:
                x = x[(slice(None),) * a + (slice(s, e, st),)]
            else:                               # torch slices step > 0 only
                idx = list(range(*slice(s, e, st).indices(dim)))
                x = torch.index_select(x, a, torch.as_tensor(
                    idx, dtype=torch.long, device=x.device))
        return x

    # ---------------------------------------------------------------- linear
    def op_Gemm(self, n, ins):
        a, b = self.t(ins[0]), self.t(ins[1])
        if int(n.attr("transA", 0)):
            a = a.t()
        if int(n.attr("transB", 0)):
            b = b.t()
        y = n.attr("alpha", 1.0) * (a @ b)
        if len(ins) > 2 and ins[2] is not None:
            y = y + n.attr("beta", 1.0) * self.t(ins[2])
        return y

    def op_MatMul(self, n, ins):
        return torch.matmul(self.t(ins[0]), self.t(ins[1]))

    # ------------------------------------------------------------------ conv
    def op_Conv(self, n, ins):
        x, w = self.t(ins[0]), self.t(ins[1])
        n_sp = x.dim() - 2
        if n_sp not in (1, 2):
            raise NotImplementedError(f"Conv over {n_sp} spatial dims "
                                      f"(node {n.name!r})")
        strides = tuple(n.attr("strides", (1,) * n_sp))
        dilations = tuple(n.attr("dilations", (1,) * n_sp))
        groups = int(n.attr("group", 1))
        auto_pad = n.attr("auto_pad", b"NOTSET")
        if isinstance(auto_pad, bytes):
            auto_pad = auto_pad.decode()
        if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
            # ONNX SAME_LOWER puts the odd pixel first
            padding = []
            for i in range(n_sp):
                size = x.shape[2 + i]
                k_eff = (w.shape[2 + i] - 1) * dilations[i] + 1
                out = -(-size // strides[i])
                total = max((out - 1) * strides[i] + k_eff - size, 0)
                half, odd = divmod(total, 2)
                padding.append((half + odd, half) if auto_pad == "SAME_LOWER"
                               else (half, half + odd))
        else:
            padding = _pads(n.attr("pads", ()), n_sp)
        if all(lo == hi for lo, hi in padding):
            pad_arg = tuple(int(lo) for lo, _ in padding)
        else:
            x = F.pad(x, _torch_pad(padding))
            pad_arg = 0
        conv = F.conv2d if n_sp == 2 else F.conv1d
        b = self.t(ins[2]) if len(ins) > 2 and ins[2] is not None else None
        return conv(x, w, b, stride=strides, padding=pad_arg,
                    dilation=dilations, groups=groups)

    # ------------------------------------------------------------------ pool
    def _window(self, n):
        k = tuple(int(v) for v in n.attr("kernel_shape"))
        strides = tuple(int(v) for v in n.attr("strides", k))
        return k, strides, _pads(n.attr("pads", ()), len(k))

    _POOL_FNS = {1: (F.max_pool1d, F.avg_pool1d),
                 2: (F.max_pool2d, F.avg_pool2d),
                 3: (F.max_pool3d, F.avg_pool3d)}

    def op_MaxPool(self, n, ins):
        k, s, pads = self._window(n)
        x = F.pad(self.t(ins[0]), _torch_pad(pads), value=float("-inf"))
        return self._POOL_FNS[len(k)][0](x, k, s)

    def op_AveragePool(self, n, ins):
        # ONNX default count_include_pad=0: border windows divide by the
        # number of real elements, not the kernel's area
        k, s, pads = self._window(n)
        x = self.t(ins[0])
        avg = self._POOL_FNS[len(k)][1]
        area = float(np.prod(k))
        summed = avg(F.pad(x, _torch_pad(pads)), k, s) * area
        if int(n.attr("count_include_pad", 0)):
            return summed / area
        counts = avg(F.pad(torch.ones_like(x), _torch_pad(pads)), k,
                     s) * area
        return summed / counts

    def op_GlobalAveragePool(self, n, ins):
        x = self.t(ins[0])
        return x.mean(dim=tuple(range(2, x.dim())), keepdim=True)

    # ------------------------------------------------------------------ norm
    def op_BatchNormalization(self, n, ins):
        x, scale, bias, mean, var = [self.t(v) for v in ins[:5]]
        eps = n.attr("epsilon", 1e-5)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return ((x - mean.reshape(shape))
                / torch.sqrt(var.reshape(shape) + eps)
                * scale.reshape(shape) + bias.reshape(shape))

    def op_Dropout(self, n, ins):
        x = self.t(ins[0])
        if not self.training or self.rng is None:
            return x
        # opset>=12: ratio as input[1]; older opsets as an attribute
        if len(ins) > 1 and ins[1] is not None:
            ratio = float(_host(ins[1]).reshape(-1)[0])
        else:
            ratio = n.attr("ratio", 0.5)
        keep = 1.0 - ratio
        # a key per dropout node, as the JAX executor folds its count in
        self._drop_count += 1
        key = prng.fold_in(self.rng, self._drop_count)
        mask = prng.bernoulli(key, keep, tuple(x.shape), device=x.device)
        return torch.where(mask, x / keep, torch.zeros_like(x))

    # ----------------------------------------------------------------- shape
    def op_Flatten(self, n, ins):
        axis = int(n.attr("axis", 1))
        x = self.t(ins[0])
        lead = int(np.prod(x.shape[:axis])) if axis else 1
        return x.reshape(lead, -1)

    def op_Reshape(self, n, ins):
        x = self.t(ins[0])
        shape = tuple(int(s) for s in _host(ins[1]).reshape(-1))
        return x.reshape(tuple(x.shape[i] if s == 0 else s
                               for i, s in enumerate(shape)))

    def op_Transpose(self, n, ins):
        x = self.t(ins[0])
        perm = n.attr("perm")
        return x.permute(tuple(perm) if perm is not None
                         else tuple(reversed(range(x.dim()))))

    def op_Concat(self, n, ins):
        return torch.cat([self.t(v) for v in ins],
                         dim=int(n.attr("axis", 0)))

    def op_Squeeze(self, n, ins):
        x = self.t(ins[0])
        axes = _host_axes(n, ins)
        return x.squeeze(axes) if axes else x.squeeze()

    def op_Unsqueeze(self, n, ins):
        x = self.t(ins[0])
        axes = _host_axes(n, ins)
        out_rank = x.dim() + len(axes)
        for a in sorted(a % out_rank for a in axes):
            x = x.unsqueeze(a)
        return x

    def op_Shape(self, n, ins):
        # a host constant: downstream Reshape/Gather read its values
        return np.asarray(ins[0].shape, np.int64)

    def op_Gather(self, n, ins):
        x = self.t(ins[0])
        axis = int(n.attr("axis", 0)) % x.dim()
        idx = torch.as_tensor(_host(ins[1]).astype(np.int64),
                              device=x.device)
        out = torch.index_select(x, axis, idx.reshape(-1))
        return out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                           + tuple(x.shape[axis + 1:]))

    # ---------------------------------------------------------------- reduce
    def _reduce(self, n, ins, fn):
        # opset>=18 (ReduceMean) / >=13 (ReduceSum) pass axes as input[1]
        axes = (tuple(int(a) for a in _host(ins[1]).reshape(-1))
                if len(ins) > 1 and ins[1] is not None
                else tuple(n.attr("axes", ())))
        x = self.t(ins[0])
        return fn(x, dim=axes or tuple(range(x.dim())),
                  keepdim=bool(n.attr("keepdims", 1)))

    def op_ReduceMean(self, n, ins):
        return self._reduce(n, ins, torch.mean)

    def op_ReduceSum(self, n, ins):
        return self._reduce(n, ins, torch.sum)

    # ------------------------------------------------------------------ misc
    def op_Constant(self, n, ins):
        return self.t(n.attr("value").data)

    def op_Identity(self, n, ins):
        return ins[0]


class OnnxModel(Layer):
    """An ONNX graph as a layer: float initializers are trainable
    parameters (by their initializer names), the rest host constants;
    ``apply`` replays the node list."""

    takes_rng = True

    def __init__(self, graph: Graph, name=None):
        super().__init__(name=name or (graph.name or "onnx_model"))
        self.graph = graph
        init_names = set(graph.initializers)
        self.input_names = [vi.name for vi in graph.inputs
                            if vi.name not in init_names]
        if not self.input_names:
            raise ValueError("ONNX graph has no runtime inputs")
        self.output_names = [vi.name for vi in graph.outputs]
        self.input_shape_hint = tuple(graph.inputs[0].shape[1:]) \
            if graph.inputs and graph.inputs[0].shape else ()
        self._static: Dict[str, np.ndarray] = {}
        self._param_names: List[str] = []

    def build(self, input_shape, gen: torch.Generator) -> None:
        for k, v in self.graph.initializers.items():
            v = np.asarray(v)
            if np.issubdtype(v.dtype, np.floating):
                t = torch.from_numpy(np.array(
                    v, dtype=np.float32 if v.dtype == np.float64
                    else v.dtype))
                # an initializer called ``conv1.weight`` is child
                # ``conv1``'s ``weight``: the state dict reads its name
                register_dotted(self, k, torch.nn.Parameter(t))
                self._param_names.append(k)
            else:
                self._static[k] = v
        self.built = True

    def _params(self) -> Dict[str, torch.Tensor]:
        named = dict(self.named_parameters())
        return {k: named[k] for k in self._param_names}

    def apply(self, x, rng=None):
        env: Dict[str, object] = dict(self._static)
        env.update(self._params())
        xs = list(x) if isinstance(x, (list, tuple)) else [x]
        if len(xs) != len(self.input_names):
            raise ValueError(f"graph expects {len(self.input_names)} inputs "
                             f"({self.input_names}), got {len(xs)}")
        dev = xs[0].device if isinstance(xs[0], torch.Tensor) else None
        ex = _Executor(dev, self.training, rng)
        for name, arr in zip(self.input_names, xs):
            env[name] = ex.t(arr)
        for node in self.graph.nodes:
            # an empty name marks an omitted OPTIONAL input: keep its slot
            # as None so positional operands (Clip's min/max) don't shift
            ins = [env[i] if i else None for i in node.inputs]
            while ins and ins[-1] is None:
                ins.pop()
            outs = ex.run(node, ins)
            for out_name, val in zip(node.outputs, outs):
                env[out_name] = val
        outs = [ex.t(env[o]) for o in self.output_names]
        return outs[0] if len(outs) == 1 else outs

    def compute_output_shape(self, input_shape):
        return input_shape  # unknown statically; predict does not need it


def load_onnx(path_or_bytes, *, device=None) -> Sequential:
    """An ONNX model file (or its bytes) → a ``Sequential`` holding one
    :class:`OnnxModel`, ready to ``compile``. ``device``: CUDA unless the
    caller names another (raises with no CUDA and no device)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    graph = decode_model(buf)
    layer = OnnxModel(graph)
    m = Sequential(name=layer.name, device=device)
    m.add(layer)
    return m


__all__ = ["OnnxModel", "load_onnx"]
