"""InferenceModel — concurrency-bounded predictor with int8 inference
(port of ``analytics_zoo_tpu/inference/inference_model.py``).

One module serves every caller; a semaphore bounds how many ``predict``
calls run at once (``supported_concurrent_num``, the reference's replica
pool) and ``borrowed_peak`` records the most that did. Requests are padded
up to a ladder of batch buckets (1, 2, 4, ..., ``max_batch_size``) and the
outputs sliced back, as in the JAX package, so a caller sees the same
shapes; requests above ``max_batch_size`` run in chunks. PyTorch compiles
nothing, so ``compile_stats()["compiled_shapes"]`` counts the distinct
bucket keys seen (what the JAX package compiles one executable for).

``quantize_int8`` packs the Dense and Convolution2D kernels of a graph or
Sequential model to per-output-channel int8 (the slots JAX's
``_quantize_module_params`` packs) and the forward then computes in int8:
K5 and K6 on the card, their plain versions on the CPU (``ops/int8.py``).
It packs the loaded module in place (the port's modules hold their
weights, where the JAX package packs a separate params tree): load a
second module to keep a float one.

``load_zoo`` serves a weight bundle (``models/common/zoo_model.py``,
written by either package) as ``load`` serves a module.

Not ported: the model loaders ``load_tf`` and ``load_fn``, the weight-only
int8 path for modules without int8 layers, hot-swap and row deltas, the
graph checks, and the InferenceSummary; each raises
``NotImplementedError`` naming ROADMAP.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..bridge import state_dict_from_jax
from ..nn.module import resolve_device
from ..ops.int8 import quantize_weight

# the dtypes numpy's np.floating covers: JAX packs only those kernels
_PACKABLE = (torch.float16, torch.float32, torch.float64)


def _not_ported(what: str, item: int):
    return NotImplementedError(f"{what} is not ported (ROADMAP Queue 1, "
                               f"item {item})")


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


def _quantize_module_params(module, min_elements: int,
                            prefix: str = "") -> List[str]:
    """Pack, in place, the int8-computable kernels of a graph/Sequential
    module tree; returns the packed slots (nested ones as ``outer.inner``).

    Only layers whose forward implements the int8 path are packed: the
    check is the unoverridden ``apply`` of Dense / Convolution2D, as in
    the JAX package."""
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
            layer.pack_int8(quantize_weight(kernel.detach().cpu().numpy(),
                                            axis=-1))
            packed.append(prefix + slot)
    return packed


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

    ``device``: where the module runs — CUDA unless the caller names
    another; raises when CUDA is absent and no device is given.
    """

    def __init__(self, supported_concurrent_num: int = 20,
                 max_batch_size: int = 1024, *, device=None):
        if supported_concurrent_num < 1:
            raise ValueError("supported_concurrent_num must be >= 1")
        self.concurrent_num = supported_concurrent_num
        self.max_batch_size = max_batch_size
        self.device = resolve_device(device)
        self._sem = threading.Semaphore(supported_concurrent_num)
        self._lock = threading.Lock()
        self._module = None
        self._keys: set = set()
        self._quantized = False
        #: slots ``quantize_int8`` packed (nested ones as ``outer.inner``)
        self.packed_slots: List[str] = []
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

    def load_tf(self, path: str, *args, **kwargs):
        raise _not_ported("load_tf (the TF importer)", 11)

    def load_fn(self, fn, params, state=None):
        raise _not_ported("load_fn (imported graphs)", 11)

    # ------------------------------------------------------------- quantization

    def quantize_int8(self, min_elements: int = 4096) -> "InferenceModel":
        """Int8 inference: Dense / Convolution2D kernels with at least
        ``min_elements`` elements pack to per-output-channel int8 and the
        forward computes in int8 with dynamic activation quantization. The
        packing wall time adds to ``compile_stats()['quantize_seconds']``.
        """
        if self._module is None:
            raise RuntimeError("load a model before quantizing")
        if self._quantized:
            raise RuntimeError("the model is already quantized")
        t0 = time.perf_counter()
        if not hasattr(self._module, "layers"):
            raise _not_ported("int8 weight-only packing of a module that is "
                              "not a graph/Sequential model", 6)
        packed = _quantize_module_params(self._module, min_elements)
        if not packed:
            raise _not_ported("int8 weight-only packing (no Dense or "
                              "Convolution2D kernel to pack)", 6)
        self.packed_slots = packed
        self._keys.clear()
        self._quantized = True
        self.quantize_seconds += time.perf_counter() - t0
        return self

    # ----------------------------------------------------------------- hot-swap

    def host_params(self):
        raise _not_ported("hot-swap (host_params)", 6)

    def probe_forward(self, params, x):
        raise _not_ported("hot-swap (probe_forward)", 6)

    def swap_params(self, params, version=None):
        raise _not_ported("hot-swap (swap_params)", 6)

    def apply_row_delta(self, entries, *, version=None):
        raise _not_ported("row deltas (apply_row_delta)", 6)

    def last_served_version(self):
        raise _not_ported("hot-swap versions (last_served_version)", 6)

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
            else:
                self._keys.add(key)
                self.compile_count += 1

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
            with torch.no_grad():
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

    def _give_back(self) -> None:
        with self._lock:
            self._borrowed -= 1

    def predict(self, inputs):
        """Thread-safe bounded-concurrency predict. ``inputs``: an ndarray
        or a list/tuple of them (multi-input models); returns numpy (bf16
        outputs as f32). Requests above ``max_batch_size`` are chunked."""
        arrs, multi, n = self._validate_inputs(inputs)
        with self._sem:
            self._borrow()
            try:
                return self._gather_chunks(
                    self._dispatch_chunks(arrs, multi, n))
            finally:
                self._give_back()

    def predict_async(self, inputs):
        """Launch a predict without waiting; returns ``fetch() -> result``.
        The concurrency slot is held from dispatch until ``fetch()``
        returns, so every ``fetch`` must be called once."""
        arrs, multi, n = self._validate_inputs(inputs)
        self._sem.acquire()
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

        return fetch

    # ------------------------------------------------------- device-level access

    def device_apply(self):
        """``(apply_fn, params, state)``: the computation ``predict`` runs,
        with its tensors on the device. ``apply_fn(params, state, x)`` runs
        the module over those tensors (``torch.func.functional_call``); the
        packed int8 kernels count as params, BatchNormalization's moving
        statistics as state."""
        if self._module is None:
            raise RuntimeError("no model loaded (call load first)")
        module = self._module
        params = {n: p.detach() for n, p in module.named_parameters()}
        state = {}
        for n, b in module.named_buffers():
            (params if n.endswith(("kernel_q", "kernel_scale", "kernel_qt"))
             else state)[n] = b

        def apply_fn(p, s, x):
            with torch.no_grad():
                return torch.func.functional_call(module, {**p, **s}, (x,))

        return apply_fn, params, state

    # ------------------------------------------------------------------- warmup

    def warm_up(self, example_inputs, graph_checks=None) -> None:
        """Run one padded predict per bucket of the ladder ahead of
        traffic."""
        if graph_checks:
            raise _not_ported("warm_up(graph_checks=...) (the analysis "
                              "rules)", 11)
        multi = isinstance(example_inputs, (list, tuple))
        arrs = [np.asarray(a) for a in
                (example_inputs if multi else [example_inputs])]
        for b in _buckets(self.max_batch_size):
            padded = [_pad_to(a[:1], b) for a in arrs]
            self.predict(padded if multi else padded[0])

    def check_fused_dispatch(self, example_inputs, mode: str = "warn"):
        raise _not_ported("check_fused_dispatch (the analysis rules)", 11)

    def check_memory(self, example_inputs, mode: str = "warn",
                     budget_bytes=None):
        raise _not_ported("check_memory (the analysis rules)", 11)

    @property
    def is_quantized(self) -> bool:
        return self._quantized

    def __repr__(self):
        return (f"InferenceModel(concurrent_num={self.concurrent_num}, "
                f"loaded={self._module is not None}, "
                f"int8={self._quantized}, device={self.device})")


__all__ = ["InferenceModel"]
