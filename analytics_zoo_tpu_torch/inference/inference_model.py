"""InferenceModel — concurrency-bounded predictor with int8 inference and
hot swap (port of ``analytics_zoo_tpu/inference/inference_model.py``).

One module serves every caller; a semaphore bounds how many ``predict``
calls run at once (``supported_concurrent_num``, the reference's replica
pool) and ``borrowed_peak`` records the most that did. Requests are padded
up to a ladder of batch buckets (1, 2, 4, ..., ``max_batch_size``) and the
outputs sliced back, as in the JAX package, so a caller sees the same
shapes; requests above ``max_batch_size`` run in chunks. PyTorch compiles
nothing, so ``compile_stats()["compiled_shapes"]`` counts the distinct
bucket keys seen (what the JAX package compiles one executable for), and
``zoo_infer_compiles_total`` / ``zoo_infer_cache_hits_total`` count them
as the JAX package counts its executables.

``quantize_int8`` packs the Dense and Convolution2D kernels of a graph or
Sequential model to per-output-channel int8 (the slots JAX's
``_quantize_module_params`` packs) and the forward then computes in int8:
K5 and K6 on the card, their plain versions on the CPU (``ops/int8.py``).
It packs the loaded module in place (the port's modules hold their
weights, where the JAX package packs a separate params tree): load a
second module to keep a float one. A model with no such layer takes the
weight-only path: every float param leaf of at least ``min_elements``
elements packs to int8 with the JAX package's 1e-8 amax floor
(``_quantize_leaf``). The module then holds only the int8 codes and f32
scales (``_WeightOnlyInt8``): each operation that reads a packed leaf
sees its dequantization ``q * scale`` in f32 (the values JAX's dequant
computes in its apply), made for that operation and freed after it, so
the device keeps the JAX path's ~4x size cut.

Hot swap: ``load`` records the load-time template (parameter names in
JAX's flatten order, ``(shape, dtype)`` per leaf, the signature).
``swap_params`` stages new weights (``stage_params``: re-packed for a
quantized model, copied to the device on a side stream; ``probe_staged``
runs them on a private copy of the module) BEFORE it holds every
concurrency slot (``_hold_all_slots``, which also waits for borrowed
``predict_async`` slots), and inside that gate only flips references, so
no request ever sees mixed weights; K5/K6 serve the re-packed kernels with
nothing else changed. ``apply_row_delta`` scatters
a row-delta publish (``engine/checkpoint.read_row_delta``) into copies of
the touched leaves and flips those in the same way; a quantized model
refuses it.
``last_served_version`` is the version that served this thread's last
``predict``. ``summary=`` feeds an ``InferenceSummary``.

``load_zoo`` serves a weight bundle (``models/common/zoo_model.py``,
written by either package) as ``load`` serves a module; ``load_tf`` a TF
frozen graph or SavedModel (``importers/tf_net.py``) and ``load_fn`` a
bare ``fn(params, state, x)``, whose params leaves become the served
module's parameters (so ``quantize_int8`` takes the weight-only path, as
in the JAX package: no K5 or K6 there).

Graph checks at model load: ``warm_up(graph_checks=)`` runs
:meth:`check_fused_dispatch` (the ``fused-int8-dispatch`` rule over the
recorded dispatch of a quantized model: K5/K6 sites, no quantize op and no
int8 tensor outside them) and :meth:`check_memory` (``hbm-budget`` and
``peak-temporary`` over its static live-range peak). Each ``predict``
samples the memory witness at site ``inference.dispatch``.
"""

from __future__ import annotations

import contextlib
import copy
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_map

from ..bridge import flat_tree, land_tensors, stage_tensors, \
    state_dict_from_jax
from ..common import memwitness as _mw
from ..common import telemetry as _tm
from ..common.locks import traced_lock
from ..engine.checkpoint import leaf_dtype_name, param_tree_signature
from ..nn.graph import GraphModule
from ..nn.module import register_dotted, resolve_device
from ..ops.int8 import quantize_weight
from ..ops.int8_fused import kernel_major
from .summary import InferenceSummary, timing

# the dtypes numpy's np.floating covers: JAX packs only those kernels
_PACKABLE = (torch.float16, torch.float32, torch.float64)

_COMPILES = _tm.counter("zoo_infer_compiles_total",
                        "Bucketed executables built by InferenceModel "
                        "(flat under steady traffic = no mid-stream "
                        "recompiles)")
_CACHE_HITS = _tm.counter("zoo_infer_cache_hits_total",
                          "Dispatches served by a compiled-cache dict lookup")


def _tree_leaves(tree, path=()):
    """((key, ...), leaf) of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_leaves(tree[k], path + (str(k),))
    else:
        yield path, tree


def _as_device_tensor(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to(device)
    return torch.from_numpy(np.ascontiguousarray(v)).to(device)


class _FnModule(torch.nn.Module):
    """``fn(params, state, x)`` as a module (``InferenceModel.load_fn``):
    each params leaf a parameter at its key path, a dotted name (a key's
    own dots nest too), rebuilt into the caller's nesting for each call."""

    def __init__(self, fn, params, state, device):
        super().__init__()
        self.fn = fn
        self._paths: List[Tuple[Tuple[str, ...], str]] = []
        for path, leaf in _tree_leaves(params or {}):
            name = ".".join(path)
            register_dotted(self, name, torch.nn.Parameter(
                _as_device_tensor(leaf, device), requires_grad=False))
            self._paths.append((path, name))
        self.state = tree_map(lambda v: _as_device_tensor(v, device),
                              state if state is not None else {})

    def forward(self, x):
        named = dict(self.named_parameters())
        params: Dict[str, Any] = {}
        for path, name in self._paths:
            node = params
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = named[name]
        return self.fn(params, self.state, x)


def _buckets(max_batch: int) -> List[int]:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


def _pad_to(arr: np.ndarray, n: int) -> np.ndarray:
    if arr.shape[0] == n:
        return arr
    pad = [(0, n - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


def _quantize_leaf(w: np.ndarray) -> Dict[str, np.ndarray]:
    """Per-output-channel symmetric int8 (channels = last dim), the JAX
    package's weight-only packing: its amax floor is 1e-8, where
    ``quantize_weight``'s is 1e-12."""
    scale = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)), keepdims=True)
    scale = np.maximum(scale, 1e-8) / 127.0
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return {"q": q, "scale": scale.astype(np.float32)}


def _quantize_module_params(module, min_elements: int,
                            prefix: str = "") -> List[str]:
    """The int8-computable kernels of a graph/Sequential module tree that
    ``quantize_int8`` packs, as slot paths (nested ones as
    ``outer.inner``); nothing is packed here.

    Only layers whose forward implements the int8 path count: the check is
    the unoverridden ``apply`` of Dense / Convolution2D, as in the JAX
    package."""
    from ..nn.layers.convolution import Convolution2D
    from ..nn.layers.core import Dense

    int8_applies = (Dense.apply, Convolution2D.apply)
    packed: List[str] = []
    for layer in getattr(module, "layers", ()) or ():
        slot = module.slot(layer)
        if hasattr(layer, "layers") and hasattr(layer, "slot"):
            packed += _quantize_module_params(layer, min_elements,
                                              f"{prefix}{slot}.")
            continue
        if type(layer).apply not in int8_applies:
            continue
        kernel = layer._parameters.get("kernel")
        if kernel is not None and kernel.dim() >= 2 and \
                kernel.numel() >= min_elements and kernel.dtype in _PACKABLE:
            packed.append(prefix + slot)
    return packed


class _WeightOnlyInt8(torch.Tensor):
    """A float32 leaf held as per-channel int8 codes ``q`` and f32 scales
    ``scale``: any aten operation it reaches reads ``q.float() * scale``,
    computed for that operation (concurrent forwards each make their own),
    so only the packed tensors stay on the device. ``detach`` keeps the
    packing, which lets an ``nn.Parameter`` hold it."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    @staticmethod
    def __new__(cls, q: torch.Tensor, scale: torch.Tensor):
        return torch.Tensor._make_wrapper_subclass(
            cls, q.shape, dtype=torch.float32, device=q.device)

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q, self.scale = q, scale

    def dequantize(self) -> torch.Tensor:
        return self.q.float() * self.scale

    def __repr__(self):
        return (f"_WeightOnlyInt8(shape={tuple(self.shape)}, "
                f"device={self.device})")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.detach.default:
            return cls(args[0].q, args[0].scale)
        if func._schema.is_mutable:
            # a write would land in a temporary: refuse it (load a float
            # module, or swap_params, to change the weights)
            raise RuntimeError(f"{func} cannot write a weight-only int8 "
                               f"leaf")

        def unpack(t):
            return t.dequantize() if isinstance(t, cls) else t
        return func(*tree_map(unpack, args), **tree_map(unpack, kwargs or {}))


def _set_param(module, name: str, tensor: torch.Tensor) -> None:
    """Install ``tensor`` as the parameter at dotted ``name``, replacing
    what was there (not writing into it)."""
    owner, _, leaf = name.rpartition(".")
    (module.get_submodule(owner) if owner else module).register_parameter(
        leaf, torch.nn.Parameter(tensor, requires_grad=False))


def _deepcopy_module(module, memo: Dict[int, Any]):
    """``copy.deepcopy(module, memo)``, each graph's nodes copied first in
    topological order: a node's copy then finds its inbound nodes' copies
    in the memo, where a deep graph (ResNet-50's ~175 nodes) would
    otherwise recurse along the inbound chain past Python's limit."""
    for m in module.modules():
        if isinstance(m, GraphModule):
            for node in m.nodes:
                copy.deepcopy(node, memo)
    return copy.deepcopy(module, memo)


def _host_f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


class StagedParams:
    """New weights on the model's device, ready to probe and flip
    (:meth:`InferenceModel.stage_params`). ``tensors``: the staged tensors
    by name (a packed leaf as ``#q``/``#scale``, a kernel's kernel-major
    copy as ``#qt``); ``ready``: the side stream's event (None on the
    CPU); ``install(module)`` puts them into a module by reference, the
    live one at the flip or the probe's private copy; ``packing``: the
    ``(packed slots, weight-only leaves)`` they carry, None for a float
    model; ``stage_ms``: what staging took."""

    __slots__ = ("tensors", "ready", "install", "packing", "stage_ms")

    def __init__(self, tensors, ready, install, packing=None):
        self.tensors, self.ready = tensors, ready
        self.install, self.packing = install, packing
        self.stage_ms = 0.0


def _to_numpy(y, m: int):
    if isinstance(y, (list, tuple)):
        return [_to_numpy(t, m) for t in y]
    y = y[:m]
    return (y.float() if y.dtype == torch.bfloat16 else y).cpu().numpy()


def _concat(outs):
    if isinstance(outs[0], list):
        return [_concat([o[i] for o in outs]) for i in range(len(outs[0]))]
    return np.concatenate(outs, axis=0)


class InferenceModel:
    """Bounded-concurrency predictor over a module's forward.

    Usage::

        im = InferenceModel(supported_concurrent_num=4, max_batch_size=32)
        im.load(resnet50()).quantize_int8()
        probs = im.predict(images)          # thread-safe, numpy in and out
        im.swap_params(new_params, version="v2")   # between dispatches

    ``device``: where the module runs — CUDA unless the caller names
    another; raises when CUDA is absent and no device is given.
    """

    def __init__(self, supported_concurrent_num: int = 20,
                 max_batch_size: int = 1024,
                 summary: Optional[InferenceSummary] = None, *, device=None):
        if supported_concurrent_num < 1:
            raise ValueError("supported_concurrent_num must be >= 1")
        self.concurrent_num = supported_concurrent_num
        self.max_batch_size = max_batch_size
        self.device = resolve_device(device)
        self.summary = summary
        self._sem = threading.Semaphore(supported_concurrent_num)
        # every slot acquisition passes this turnstile, and a swap holds it
        # while it drains the slots: callers that loop on predict cannot
        # starve the swap by taking each released slot back at once
        self._turnstile = traced_lock("InferenceModel._turnstile")
        self._lock = traced_lock("InferenceModel._lock")
        self._module = None
        self._keys: set = set()
        self._quantized = False
        self._quant_min_elements: Optional[int] = None
        #: slots ``quantize_int8`` packed (nested ones as ``outer.inner``)
        self.packed_slots: List[str] = []
        # the weight-only path's packed leaves: name -> {"q", "scale"}
        self._wo_packed: Dict[str, Dict[str, torch.Tensor]] = {}
        # the load-time template: names in JAX's flatten order, avals, the
        # signature; `version` tags what this model serves
        self.version: Optional[str] = None
        self.load_names: Optional[List[str]] = None
        self.load_avals: Optional[List[Tuple[Tuple, str]]] = None
        self.load_signature: Optional[str] = None
        # per-thread version snapshot taken INSIDE the concurrency slot
        self._served_version: Dict[int, Optional[str]] = {}
        self.borrowed_peak = 0
        self._borrowed = 0
        self.compile_count = 0
        self.cache_hit_count = 0
        self.quantize_seconds = 0.0

    # ------------------------------------------------------------------ loading

    def load(self, module, params=None, state=None) -> "InferenceModel":
        """Serve ``module`` (moved to the model's device, in inference
        mode). ``params``/``state``: optional JAX-layout trees (numpy
        leaves) loaded into it first through the bridge."""
        if params is not None:
            module.load_state_dict(state_dict_from_jax(params, state))
        elif state is not None:
            raise ValueError("state without params")
        module.to(self.device).eval()
        if isinstance(getattr(module, "device", None), torch.device):
            module.device = self.device
        self._module = module
        self._keys.clear()
        self._quantized = False
        self.packed_slots = []
        self._wo_packed = {}
        self._record_template()
        return self

    def load_zoo(self, path: str, model_class=None) -> "InferenceModel":
        """Serve the model bundle at ``path``: the architecture rebuilt
        from its config (``model_class(device=...)`` when given, else the
        registered class it names) on this model's device, then its
        weights."""
        from ..models.common.zoo_model import load_model_bundle

        model, _cfg = load_model_bundle(
            path, device=self.device, model=None if model_class is None
            else model_class(device=self.device))
        return self.load(model)

    def load_tf(self, path: str, signature: str = "serving_default",
                inputs=None, outputs=None) -> "InferenceModel":
        """Serve a TF frozen graph (``.pb``) or a SavedModel directory,
        executed by ``importers.tf_net`` on this model's device. A
        SavedModel's variables are the served parameters, so
        ``quantize_int8`` packs them (weight-only); a frozen graph's
        weights are Const nodes and stay float (it has no parameters)."""
        import os

        from ..importers.tf_net import from_frozen_graph, from_saved_model

        if os.path.isdir(path):
            net = from_saved_model(path, signature=signature, inputs=inputs,
                                   outputs=outputs, device=self.device)
        else:
            net = from_frozen_graph(path, inputs=inputs, outputs=outputs,
                                    device=self.device)

        def apply(p, s, x, net=net):
            xs = list(x) if isinstance(x, (list, tuple)) else [x]
            return net._run(*xs, variables=p)

        return self.load_fn(apply, params=dict(net.variables), state=None)

    def load_fn(self, fn, params, state=None) -> "InferenceModel":
        """Serve a bare ``fn(params, state, x) -> y`` (imported graphs land
        here): ``params`` (a nested dict of arrays or tensors) become the
        served module's parameters, handed back to ``fn`` in the same
        nesting each call (weight-only int8 leaves after
        ``quantize_int8``); ``state`` is handed back as given, on this
        model's device."""
        return self.load(_FnModule(fn, params, state, self.device))

    def _record_template(self) -> None:
        """Remember the as-loaded (unquantized) params' shape: names in the
        JAX tree's flatten order, ``(shape, dtype name)`` per leaf and their
        signature. A swap or a row delta is validated against it, and a row
        delta's leaf indices count in this order."""
        named = dict(self._module.named_parameters())
        # the nested tree's keys sorted level by level, as JAX flattens it
        self.load_names = sorted(named, key=lambda n: n.split("."))
        leaves = [named[n] for n in self.load_names]
        self.load_avals = [(tuple(t.shape), leaf_dtype_name(t))
                           for t in leaves]
        self.load_signature = param_tree_signature(leaves)
        self.version = None

    # ------------------------------------------------------------- quantization

    def quantize_int8(self, min_elements: int = 4096) -> "InferenceModel":
        """Int8 inference: Dense / Convolution2D kernels with at least
        ``min_elements`` elements pack to per-output-channel int8 and the
        forward computes in int8 with dynamic activation quantization; a
        model with none of them packs its float leaves weight-only (module
        docstring). The packing wall time adds to
        ``compile_stats()['quantize_seconds']``."""
        if self._module is None:
            raise RuntimeError("load a model before quantizing")
        if self._quantized:
            raise RuntimeError("the model is already quantized")
        t0 = time.perf_counter()
        self._quant_min_elements = min_elements
        staged = self._build_quantized(self.host_params(), min_elements)
        land_tensors(staged.tensors, staged.ready, self.device)
        staged.install(self._module)
        self.packed_slots, self._wo_packed = staged.packing
        self._keys.clear()
        self._quantized = True
        self.quantize_seconds += time.perf_counter() - t0
        return self

    def _native_slots(self, min_elements: int) -> List[str]:
        if not hasattr(self._module, "layers"):
            return []
        return _quantize_module_params(self._module, min_elements)

    def _build_quantized(self, host: Dict[str, torch.Tensor],
                         min_elements: int) -> "StagedParams":
        """Pack ``host`` (an unquantized host tree in the load-time layout)
        for int8 serving and stage the result on the device. Shared by
        :meth:`quantize_int8` and a swap's re-pack, so a swap lands a
        consistent set."""
        slots = (self.packed_slots if self._quantized
                 else self._native_slots(min_elements))
        kernels = {f"{s}.kernel": s for s in slots}
        wo: List[str] = []
        if not slots:
            # no int8-computable layer: the generic weight-only path
            wo = [n for n in self.load_names
                  if host[n].dim() >= 2 and host[n].numel() >= min_elements
                  and host[n].dtype in _PACKABLE]
        tensors: Dict[str, torch.Tensor] = {}
        for n in self.load_names:
            if n in kernels:
                packed = quantize_weight(_host_f32(host[n]), axis=-1)
            elif n in wo:
                packed = _quantize_leaf(_host_f32(host[n]))
            else:
                tensors[n] = host[n].to(self._param_dtype(n))
                continue
            tensors[n + "#q"] = torch.from_numpy(packed["q"])
            tensors[n + "#scale"] = torch.from_numpy(packed["scale"])

        def make(staged):
            for n in kernels:
                staged[n + "#qt"] = kernel_major(staged[n + "#q"])

        staged, ready = stage_tensors(tensors, self.device, make)

        def install(module):
            for n, slot in kernels.items():
                module.get_submodule(slot).pack_int8(
                    {k: staged[f"{n}#{k}"] for k in ("q", "scale", "qt")})
            for n in wo:
                _set_param(module, n, _WeightOnlyInt8(staged[n + "#q"],
                                                      staged[n + "#scale"]))
            for n, p in module.named_parameters():
                if n in staged:
                    p.data = staged[n]

        packing = (list(slots), {n: {"q": staged[n + "#q"],
                                     "scale": staged[n + "#scale"]}
                                 for n in wo})
        return StagedParams(staged, ready, install, packing)

    def _param_dtype(self, name: str) -> torch.dtype:
        # the aval's numpy name ("float32", "bfloat16") is torch's too
        return getattr(torch, self.load_avals[self.load_names.index(name)][1])

    # ----------------------------------------------------------------- hot swap

    def host_params(self) -> Dict[str, torch.Tensor]:
        """The live params as host tensors in the load-time (unquantized)
        layout, ``{dotted name: tensor}``: the rollback snapshot. Packed
        kernels and weight-only leaves come back dequantized to f32
        (``q * scale``, as the JAX package's ``host_params``); packing them
        again gives the same packed values."""
        if self._module is None:
            raise RuntimeError("no model loaded")
        named = dict(self._module.named_parameters())
        out: Dict[str, torch.Tensor] = {}
        for n in self.load_names:
            slot = n[:-len(".kernel")] if n.endswith(".kernel") else None
            if slot is not None and slot in self.packed_slots:
                layer = self._module.get_submodule(slot)
                out[n] = (layer.kernel_q.float()
                          * layer.kernel_scale).cpu()
            elif n in self._wo_packed:
                p = self._wo_packed[n]
                out[n] = (p["q"].float() * p["scale"]).cpu()
            else:
                out[n] = named[n].detach().to("cpu", copy=True)
        return out

    def _check_tree(self, params) -> Dict[str, torch.Tensor]:
        """A swap's params as ``{name: tensor}`` in the template's names
        and shapes (the port's own tree, or a JAX-layout numpy tree)."""
        if self.load_names is None:
            raise RuntimeError("no load-time template (use load)")
        flat = flat_tree(params)
        if set(flat) != set(self.load_names):
            raise ValueError(
                f"swap params do not match the loaded model: missing "
                f"{sorted(set(self.load_names) - set(flat))[:5]}, unknown "
                f"{sorted(set(flat) - set(self.load_names))[:5]}")
        for n, (shape, _) in zip(self.load_names, self.load_avals):
            if tuple(flat[n].shape) != tuple(shape):
                raise ValueError(f"swap param {n} is "
                                 f"{tuple(flat[n].shape)}, the model's "
                                 f"{tuple(shape)}")
        return flat

    def probe_forward(self, params, x):
        """Run the load-time (float) forward with CANDIDATE params without
        touching the live model: the swap's warm-up probe. It runs on a
        private copy of the module, its packed kernels unpacked, so a
        concurrent ``predict`` never sees the candidate."""
        flat = self._check_tree(params)
        # the packed leaves are not copied: the candidate replaces them
        skip = {id(self._module.get_parameter(n)): None
                for n in self._wo_packed}
        probe = _deepcopy_module(self._module, skip)
        for slot in self.packed_slots:
            layer = probe.get_submodule(slot)
            for b in ("kernel_q", "kernel_scale", "kernel_qt"):
                layer._buffers.pop(b, None)
            layer.kernel = torch.nn.Parameter(torch.empty(0),
                                              requires_grad=False)
        named = dict(probe.named_parameters())
        with torch.no_grad():
            for n in self.load_names:
                value = flat[n].to(self.device, self._param_dtype(n))
                if n in self._wo_packed:
                    _set_param(probe, n, value)
                else:
                    named[n].data = value
            return probe(self._device_inputs(x))

    def stage_params(self, params) -> StagedParams:
        """Validate ``params`` (a tree in the load-time layout: the port's
        ``{dotted name: tensor}`` or a JAX-layout numpy tree) and put them
        on the device for a flip, the tree's one crossing to the card: a
        quantized model re-packs on the host first; the tensors cross in
        a side-stream copy (``bridge.stage_tensors``), with the
        kernel-major copies made there. Nothing live changes:
        :meth:`probe_staged` runs the result, :meth:`swap_params` flips it
        in."""
        flat = self._check_tree(params)
        t0 = time.perf_counter()
        if self._quantized:
            staged = self._build_quantized(flat,
                                           self._quant_min_elements or 4096)
        else:
            tensors, ready = stage_tensors(
                {n: flat[n].to(self._param_dtype(n))
                 for n in self.load_names}, self.device)

            def install(module):
                named = dict(module.named_parameters())
                for n in self.load_names:
                    named[n].data = tensors[n]

            staged = StagedParams(tensors, ready, install)
        staged.stage_ms = (time.perf_counter() - t0) * 1e3
        return staged

    def probe_staged(self, staged: StagedParams, x):
        """Run the forward with ``staged`` on a private copy of the module,
        without touching the live model: the swap's warm-up probe on the
        very tensors the flip installs (packed for a quantized model, so
        its kernels run). The copy shares the buffers and holds no copy of
        the live weights."""
        memo: Dict[int, Any] = {
            id(p): torch.nn.Parameter(torch.empty(0, dtype=p.dtype,
                                                  device=p.device),
                                      requires_grad=False)
            for p in self._module.parameters()}
        memo.update({id(b): b for b in self._module.buffers()})
        probe = _deepcopy_module(self._module, memo)
        with torch.no_grad():
            land_tensors(staged.tensors, staged.ready, self.device)
            staged.install(probe)
            return probe(self._device_inputs(x))

    def _device_inputs(self, x):
        xs = [torch.as_tensor(np.asarray(a)).to(self.device) for a in
              (x if isinstance(x, (list, tuple)) else [x])]
        return xs if isinstance(x, (list, tuple)) else xs[0]

    def _acquire_slot(self) -> None:
        with self._turnstile:
            self._sem.acquire()

    @contextlib.contextmanager
    def _hold_all_slots(self):
        """Acquire every concurrency slot — ``predict_async``'s borrowed
        ones come back at their ``fetch`` — so nothing is mid-dispatch
        while held: a reference flip inside lands exactly BETWEEN dispatch
        waves and no request sees mixed weights. New requests wait at the
        turnstile meanwhile."""
        with self._turnstile:
            for _ in range(self.concurrent_num):
                self._sem.acquire()
        try:
            yield
        finally:
            for _ in range(self.concurrent_num):
                self._sem.release()

    def swap_params(self, params, version: Optional[str] = None
                    ) -> "InferenceModel":
        """Atomically replace the live params with ``params``: a tree in
        the load-time layout, which goes through :meth:`stage_params`
        first, or what :meth:`stage_params` returned.

        All the expensive work — re-packing a quantized model on the host,
        the copy to the device on a side stream, the kernel-major copies —
        happens BEFORE the gate; the flip holds every concurrency slot and
        only swaps references, so it lands between dispatch waves. Per
        swap, ``swap_timings`` records ``stage_ms`` (re-pack and staging)
        and ``gate_ms`` (waiting for the slots and flipping)."""
        staged = params if isinstance(params, StagedParams) \
            else self.stage_params(params)
        t1 = time.perf_counter()
        with self._hold_all_slots():
            land_tensors(staged.tensors, staged.ready, self.device)
            staged.install(self._module)
            if staged.packing is not None:
                self.packed_slots, self._wo_packed = staged.packing
            self.version = version
        self.swap_timings = {"stage_ms": staged.stage_ms,
                             "gate_ms": (time.perf_counter() - t1) * 1e3}
        return self

    def apply_row_delta(self, entries, *, version: Optional[str] = None
                        ) -> "InferenceModel":
        """Patch the live params from a row-delta publish: ``entries`` is
        ``[(leaf_index, idx, rows)]`` in the load-time flatten order
        (``engine/checkpoint.read_row_delta``), ``idx=None`` a whole-leaf
        replacement. Only the touched rows cross to the device; they are
        scattered into COPIES of their leaves (a predict on another slot
        may still read the old ones), and the copies flip in under the
        gate. A quantized model refuses: rows cannot be scattered into
        packed kernels, so it takes a full swap."""
        if self.load_names is None:
            raise RuntimeError("apply_row_delta needs a load-time template "
                               "(use load)")
        if self._quantized:
            raise RuntimeError(
                "row deltas cannot patch int8-packed params: publish a full "
                "checkpoint for quantized serving")
        named = dict(self._module.named_parameters())
        tensors, rows_of = {}, {}
        for leaf_idx, idx, rows in entries:
            n = self.load_names[leaf_idx]
            rows = torch.as_tensor(rows).to(named[n].dtype)
            if idx is None:
                tensors[n] = rows
            else:
                tensors[n + "#idx"] = torch.as_tensor(np.asarray(idx,
                                                                 np.int64))
                tensors[n + "#rows"] = rows
                rows_of[n] = named[n]

        def make(staged):
            for n, cur in rows_of.items():
                new = cur.detach().clone()
                new[staged.pop(n + "#idx")] = staged.pop(n + "#rows")
                staged[n] = new

        staged, ready = stage_tensors(tensors, self.device, make)
        with self._hold_all_slots():
            land_tensors(staged, ready, self.device)
            for n, t in staged.items():
                named[n].data = t
            if version is not None:
                self.version = version
        return self

    # ---------------------------------------------------------------- predicting

    def compile_stats(self) -> Dict[str, Any]:
        """``compiled_shapes``/``compiles``: distinct bucket keys seen (one
        JAX executable each), ``cache_hits``: dispatches of a key seen
        before, ``quantize_seconds``: int8 packing wall time."""
        return {"compiled_shapes": len(self._keys),
                "compiles": self.compile_count,
                "cache_hits": self.cache_hit_count,
                "quantize_seconds": round(self.quantize_seconds, 4)}

    def _bucket(self, n: int) -> int:
        for b in _buckets(self.max_batch_size):
            if n <= b:
                return b
        return self.max_batch_size

    def _note_key(self, key: Tuple) -> None:
        with self._lock:
            if key in self._keys:
                self.cache_hit_count += 1
                hit = True
            else:
                self._keys.add(key)
                self.compile_count += 1
                hit = False
        (_CACHE_HITS if hit else _COMPILES).inc()

    def _validate_inputs(self, inputs):
        if self._module is None:
            raise RuntimeError("no model loaded (call load first)")
        multi = isinstance(inputs, (list, tuple))
        arrs = [np.asarray(a) for a in (inputs if multi else [inputs])]
        n = arrs[0].shape[0]
        if any(a.shape[0] != n for a in arrs):
            raise ValueError("all inputs must share the batch dimension")
        return arrs, multi, n

    def _dispatch_chunks(self, arrs, multi, n):
        """Pad each <= max_batch chunk to its bucket and launch the forward
        — returns ``[(device_result, valid_count), ...]`` without waiting
        for the device."""
        dispatched = []
        for lo in range(0, n, self.max_batch_size):
            hi = min(lo + self.max_batch_size, n)
            bucket = self._bucket(hi - lo)
            padded = [_pad_to(a[lo:hi], bucket) for a in arrs]
            self._note_key((bucket,) + tuple((a.shape[1:], str(a.dtype))
                                             for a in padded))
            xs = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                  for a in padded]
            with timing("inference.forward"), torch.no_grad():
                y = self._module(xs if multi else xs[0])
            dispatched.append((y, hi - lo))
        return dispatched

    @staticmethod
    def _gather_chunks(dispatched):
        outs = [_to_numpy(y, m) for y, m in dispatched]
        return outs[0] if len(outs) == 1 else _concat(outs)

    def _borrow(self) -> None:
        with self._lock:
            self._borrowed += 1
            self.borrowed_peak = max(self.borrowed_peak, self._borrowed)
        # slot held: no swap can be mid-flight, so this version IS the one
        # whose weights the dispatch reads
        if len(self._served_version) > 4096:     # dead-thread-id bound
            self._served_version.clear()
        self._served_version[threading.get_ident()] = self.version

    def _give_back(self) -> None:
        with self._lock:
            self._borrowed -= 1

    def predict(self, inputs):
        """Thread-safe bounded-concurrency predict. ``inputs``: an ndarray
        or a list/tuple of them (multi-input models); returns numpy (bf16
        outputs as f32). Requests above ``max_batch_size`` are chunked."""
        arrs, multi, n = self._validate_inputs(inputs)
        t0 = time.perf_counter()
        self._acquire_slot()
        try:
            self._borrow()
            try:
                result = self._gather_chunks(
                    self._dispatch_chunks(arrs, multi, n))
            finally:
                self._give_back()
        finally:
            self._sem.release()
        _mw.sample("inference.dispatch", self._witness_tensors)
        if self.summary is not None:
            self.summary.add_batch(n, time.perf_counter() - t0)
        return result

    def _witness_tensors(self):
        """What the dispatch holds on the device, for the memory witness."""
        module = self._module
        return (list(module.parameters()) + list(module.buffers())
                if module is not None else [])

    def last_served_version(self) -> Optional[str]:
        """Version of the params that served THIS thread's last ``predict``
        (None before the first call, or for a never-swapped model); the
        snapshot is taken inside the concurrency slot, so a concurrent swap
        cannot race it."""
        return self._served_version.get(threading.get_ident())

    def predict_async(self, inputs):
        """Launch a predict without waiting; returns ``fetch() -> result``.
        The concurrency slot is held from dispatch until ``fetch()``
        returns, so every ``fetch`` must be called once."""
        arrs, multi, n = self._validate_inputs(inputs)
        t0 = time.perf_counter()
        self._acquire_slot()
        self._borrow()
        try:
            dispatched = self._dispatch_chunks(arrs, multi, n)
        except BaseException:
            self._give_back()
            self._sem.release()
            raise
        released = [False]

        def fetch():
            try:
                return self._gather_chunks(dispatched)
            finally:
                with self._lock:
                    first = not released[0]
                    released[0] = True
                    if first:
                        self._borrowed -= 1
                if first:
                    self._sem.release()
                    if self.summary is not None:
                        self.summary.add_batch(n, time.perf_counter() - t0)

        return fetch

    # ------------------------------------------------------- device-level access

    def device_apply(self):
        """``(apply_fn, params, state)``: the computation ``predict`` runs,
        with its tensors on the device. ``apply_fn(params, state, x)`` runs
        the module over those tensors (``torch.func.functional_call``); the
        packed int8 kernels count as params, BatchNormalization's moving
        statistics as state. A weight-only model's packed leaves come as
        ``{"q", "scale"}`` dicts, dequantized inside ``apply_fn``."""
        if self._module is None:
            raise RuntimeError("no model loaded (call load first)")
        module = self._module
        params: Dict[str, Any] = {n: p.detach()
                                  for n, p in module.named_parameters()}
        params.update(self._wo_packed)
        state = {}
        for n, b in module.named_buffers():
            (params if n.endswith(("kernel_q", "kernel_scale", "kernel_qt"))
             else state)[n] = b

        def apply_fn(p, s, x):
            p = {n: (v["q"].float() * v["scale"] if isinstance(v, dict)
                     else v) for n, v in p.items()}
            with torch.no_grad():
                return torch.func.functional_call(module, {**p, **s}, (x,))

        return apply_fn, params, state

    # ------------------------------------------------------------------- warmup

    def warm_up(self, example_inputs, graph_checks: Optional[str] = None
                ) -> None:
        """Run one padded predict per bucket of the ladder ahead of
        traffic. ``graph_checks`` ("warn"/"raise") then runs
        :meth:`check_fused_dispatch` and :meth:`check_memory`, so a
        quantized model whose kernels are not dispatching is caught here,
        at model load."""
        multi = isinstance(example_inputs, (list, tuple))
        arrs = [np.asarray(a) for a in
                (example_inputs if multi else [example_inputs])]
        for b in _buckets(self.max_batch_size):
            padded = [_pad_to(a[:1], b) for a in arrs]
            self.predict(padded if multi else padded[0])
        if graph_checks:
            self.check_fused_dispatch(example_inputs, mode=graph_checks)
            self.check_memory(example_inputs, mode=graph_checks)

    def _example_row(self, example_inputs):
        """One example row on the device, as ``predict`` takes it."""
        multi = isinstance(example_inputs, (list, tuple))
        xs = self._device_inputs([np.asarray(a)[:1] for a in
                                  (example_inputs if multi
                                   else [example_inputs])])
        return xs if multi else xs[0]

    def check_fused_dispatch(self, example_inputs, mode: str = "warn"):
        """Run the ``fused-int8-dispatch`` rule over the recorded dispatch
        :meth:`predict` runs on one example row: at least one K5/K6 site,
        no standalone quantize op and no int8 tensor allocated outside the
        kernel sites. No-op unless the model is quantized. ``mode``:
        "warn" logs findings, "raise" raises
        :class:`analytics_zoo_tpu_torch.analysis.GraphLintError`. Returns
        the findings."""
        import logging

        from ..analysis import RuleContext, enforce
        from ..analysis.rules.fused_int8 import lint_fused_dispatch

        if not mode or mode == "off" or not self._quantized:
            return []
        findings = lint_fused_dispatch(
            self, self._example_row(example_inputs),
            ctx=RuleContext(where="inference.load", fused_expected=True))
        return enforce(findings, mode,
                       logging.getLogger("analytics_zoo_tpu_torch.inference"))

    def check_memory(self, example_inputs, mode: str = "warn",
                     budget_bytes: Optional[int] = None):
        """Run the memory tier over the recorded dispatch of one example
        row: ``hbm-budget`` when ``budget_bytes`` declares a per-device
        budget (``ServingConfig.hbm_budget_mb`` through ``_warm_model``)
        and ``peak-temporary`` always. Notes the static peak into the
        memory witness (site ``inference.dispatch``) when witnessing is
        on. Returns the findings."""
        import logging

        from ..analysis import RuleContext, enforce, profile_trace
        from ..analysis.rules.fused_int8 import trace_dispatch
        from ..analysis.rules.memory import lint_memory

        if not mode or mode == "off":
            return []
        trace = trace_dispatch(self, self._example_row(example_inputs))
        findings = lint_memory(trace, ctx=RuleContext(
            where="inference.load", hbm_budget_bytes=budget_bytes),
            rules=["hbm-budget", "peak-temporary"])
        if _mw.enabled():
            _mw.note_static("inference.dispatch",
                            profile_trace(trace).peak_live_bytes,
                            budget_bytes)
        return enforce(findings, mode,
                       logging.getLogger("analytics_zoo_tpu_torch.inference"))

    @property
    def is_quantized(self) -> bool:
        return self._quantized

    def __repr__(self):
        return (f"InferenceModel(concurrent_num={self.concurrent_num}, "
                f"loaded={self._module is not None}, "
                f"int8={self._quantized}, device={self.device})")


__all__ = ["InferenceModel"]
