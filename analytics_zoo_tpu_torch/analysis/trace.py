"""The artifact the port's graph rules walk: a recorded op trace of one call.

The JAX package's rules walk a jaxpr, an abstract trace with no execution
in which each ``pallas_call`` is one equation whose body is "inside the
kernel". :func:`trace_call` is the port's counterpart of
``jax.make_jaxpr``:

* the call runs under ``FakeTensorMode``: tensors carry shapes, dtypes,
  devices and storages but no data, so nothing computes, nothing launches
  and no state changes. The call's tensor arguments and the parameters and
  buffers of the ``modules`` it reads are swapped for fakes for its
  duration (``torch.nn.utils.stateless._reparametrize_module``);
* a ``TorchDispatchMode`` above the fake mode records every aten op: its
  name, the shape, dtype, device and storage of each input and output, the
  storages it writes in place, and whether it sits inside a kernel site or
  the accumulation loop (:func:`loop_region`, the counterpart of a scan
  body);
* host values stay host values. A tensor made from Python or numpy data
  (``torch.tensor``, ``torch.as_tensor``, ``torch.from_numpy``) stays a real
  CPU tensor, and ops whose inputs are all such tensors run for real on the
  host, so code that reads them back (``.tolist()`` of a host-built tensor)
  sees their values. Such a tensor entering an op on the traced side is an
  **upload**. ``.item()``/``.tolist()`` of a traced tensor, and a copy of
  one to the host, is a **host read**: the trace notes it and hands the
  caller a placeholder (1, 1.0, False) so the walk goes on;
* each kernel wrapper (K1–K6, the sampler) and each collective of
  ``parallel/comm.py`` checks :data:`RECORDING` first. While a trace
  records in this thread (or in an autograd thread running its backward:
  the recorder is found on the dispatch-mode stack, which torch hands on
  to them), the wrapper records one **site** (its name, its
  inputs, its outputs and the scratch bytes its launch would allocate) and
  computes its outputs by running its plain version under the fake mode:
  those ops are recorded as inside the site (the counterpart of a kernel
  body, which holds no device-memory structure) and nothing launches.

Outside a trace the wrappers pay one module-level boolean.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import (Any, Callable, Dict, FrozenSet, Iterator, List,
                    Optional, Sequence, Tuple)

import torch
from torch.utils._pytree import tree_flatten, tree_map

#: True while a trace records in any thread: the wrappers' one boolean
RECORDING = False

_OPEN_LOCK = threading.Lock()
_OPEN = 0


@dataclasses.dataclass(frozen=True)
class TensorMeta:
    """What the trace keeps of one tensor."""

    shape: Tuple[int, ...]
    dtype: str
    device: str
    nbytes: int
    storage: int                  # the storage's identity within the trace
    storage_nbytes: int
    name: Optional[str] = None    # argument leaves: their path

    @property
    def key(self) -> Tuple[Tuple[int, ...], str]:
        return (self.shape, self.dtype)


@dataclasses.dataclass
class Op:
    """One recorded event: an aten op, or a kernel or collective site."""

    index: int
    name: str                     # "aten.mm.default", "K2", "reduce-scatter"
    inputs: Tuple[TensorMeta, ...]
    outputs: Tuple[TensorMeta, ...]
    written: FrozenSet[int] = frozenset()   # storages written in place
    in_kernel: bool = False       # inside a kernel or collective site
    in_loop: bool = False         # inside the accumulation loop
    site: Optional[str] = None    # "kernel" | "collective" for a site
    scratch_bytes: int = 0        # a kernel site's wrapper scratch
    axis: Optional[str] = None    # a collective site's mesh axis

    @property
    def kind(self) -> str:
        """The aten op's short name (``"mm"``), or the site's name."""
        if self.site is not None:
            return self.name
        parts = self.name.split(".")
        return parts[1] if len(parts) >= 2 else self.name


@dataclasses.dataclass
class HostRead:
    """A traced tensor read on the host (a device-to-host sync)."""

    what: str                     # "item", "cpu"
    tensor: TensorMeta
    in_kernel: bool
    in_loop: bool


@dataclasses.dataclass
class Upload:
    """A host tensor entering the traced side (an argument-free upload)."""

    tensor: TensorMeta
    op: str
    in_kernel: bool
    in_loop: bool


@dataclasses.dataclass
class Trace:
    """A recorded call: its argument and output leaves, its ops and sites
    in order, its host reads and uploads."""

    args: List[TensorMeta] = dataclasses.field(default_factory=list)
    outputs: List[TensorMeta] = dataclasses.field(default_factory=list)
    ops: List[Op] = dataclasses.field(default_factory=list)
    host_reads: List[HostRead] = dataclasses.field(default_factory=list)
    uploads: List[Upload] = dataclasses.field(default_factory=list)

    def sites(self, site: Optional[str] = None) -> List[Op]:
        """Kernel and collective sites, optionally of one kind."""
        return [o for o in self.ops if o.site is not None
                and (site is None or o.site == site)]

    def kernel_counts(self) -> Dict[str, int]:
        """``{"K2": 12, ...}``: kernel sites by name."""
        out: Dict[str, int] = {}
        for o in self.sites("kernel"):
            out[o.name] = out.get(o.name, 0) + 1
        return out

    def outside(self) -> Iterator[Op]:
        """Every op and site that is not inside a site (what device memory
        sees)."""
        return (o for o in self.ops if not o.in_kernel)


# ---------------------------------------------------------------- recording

def _placeholder(t: torch.Tensor):
    if t.dtype == torch.bool:
        return False
    return 1.0 if t.dtype.is_floating_point or t.dtype.is_complex else 1


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


class _Recorder:
    """The per-trace state: ops, sites, loop depth, storage identities."""

    def __init__(self, trace: Trace):
        self.trace = trace
        self.site_depth = 0
        self.loop_depth = 0
        # every storage seen, kept alive so no identity is reused
        self._storages: Dict[int, Any] = {}
        self._uploaded: set = set()

    def meta(self, t: torch.Tensor, name: Optional[str] = None
             ) -> TensorMeta:
        st = t.untyped_storage()
        sid = st._cdata
        self._storages.setdefault(sid, st)
        return TensorMeta(tuple(int(d) for d in t.shape),
                          _dtype_name(t.dtype), str(t.device),
                          t.numel() * t.element_size(), sid,
                          int(st.nbytes()), name)

    def metas(self, tree) -> Tuple[TensorMeta, ...]:
        leaves, _ = tree_flatten(tree)
        return tuple(self.meta(t) for t in leaves
                     if isinstance(t, torch.Tensor))

    def add(self, **kw) -> Op:
        op = Op(index=len(self.trace.ops), in_kernel=self.site_depth > 0,
                in_loop=self.loop_depth > 0, **kw)
        self.trace.ops.append(op)
        return op

    def upload(self, t: torch.Tensor, op: str) -> None:
        m = self.meta(t)
        if m.storage in self._uploaded:
            return
        self._uploaded.add(m.storage)
        self.trace.uploads.append(Upload(m, op, self.site_depth > 0,
                                         self.loop_depth > 0))

    def host_read(self, what: str, t: torch.Tensor) -> None:
        self.trace.host_reads.append(HostRead(
            what, self.meta(t), self.site_depth > 0, self.loop_depth > 0))


def _mode_class():
    from torch.utils._python_dispatch import (TorchDispatchMode,
                                              _disable_current_modes)

    aten = torch.ops.aten
    lifts = {aten.lift_fresh.default, aten.lift_fresh_copy.default}
    scalar_reads = {aten._local_scalar_dense.default}

    class _RecordingMode(TorchDispatchMode):
        def __init__(self, rec: _Recorder):
            super().__init__()
            self.zoo_recorder = rec

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            leaves, _ = tree_flatten((args, kwargs))
            tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
            fakes = [t for t in tensors if _is_fake(t)]
            rec = self.zoo_recorder
            if not fakes:
                if func in lifts:
                    # host data becoming a tensor: it stays a host value
                    with _disable_current_modes():
                        return func(*args, **kwargs)
                dev = kwargs.get("device")
                if tensors and (dev is None or torch.device(dev).type
                                == "cpu") and all(t.device.type == "cpu"
                                                  for t in tensors):
                    with _disable_current_modes():
                        return func(*args, **kwargs)
            if func in scalar_reads:
                rec.host_read("item", args[0])
                return _placeholder(args[0])
            if func is aten._to_copy.default and fakes:
                dev = kwargs.get("device")
                src = args[0]
                if dev is not None and torch.device(dev).type == "cpu" \
                        and src.device.type != "cpu":
                    rec.host_read("cpu", src)
            if func is aten.copy_.default and fakes and not _is_fake(args[0]) \
                    and args[0].device.type == "cpu" \
                    and args[1].device.type != "cpu":
                rec.host_read("cpu", args[1])
            name = str(func)
            for t in tensors:
                if not _is_fake(t):
                    rec.upload(t, name)
            written = []
            for i, a in enumerate(func._schema.arguments):
                if a.alias_info is not None and a.alias_info.is_write:
                    v = args[i] if i < len(args) else kwargs.get(a.name)
                    if isinstance(v, torch.Tensor):
                        written.append(v)
            inputs = rec.metas((args, kwargs))
            out = func(*args, **kwargs)
            if not name.startswith("prim."):
                rec.add(name=name, inputs=inputs, outputs=rec.metas(out),
                        written=frozenset(rec.meta(t).storage
                                          for t in written))
            return out

    return _RecordingMode


def active() -> Optional[_Recorder]:
    """The recorder of the trace recording in this thread, else None. It
    is read off the dispatch-mode stack, which torch hands on to the
    autograd engine's device threads: a CUDA backward runs there."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in _get_current_dispatch_mode_stack():
        rec = getattr(mode, "zoo_recorder", None)
        if rec is not None:
            return rec
    return None


@contextlib.contextmanager
def loop_region():
    """Mark the ops and collectives inside as in-loop (the accumulation
    loop; a collective there runs once per micro-step). Costs one boolean
    outside a trace."""
    rec = active() if RECORDING else None
    if rec is None:
        yield
        return
    rec.loop_depth += 1
    try:
        yield
    finally:
        rec.loop_depth -= 1


def _site(kind: str, name: str, compute: Callable[[], Any], inputs,
          scratch_bytes: int = 0, axis: Optional[str] = None):
    rec = active()
    in_metas = rec.metas(inputs)
    op = rec.add(name=name, inputs=in_metas, outputs=(), site=kind,
                 scratch_bytes=int(scratch_bytes), axis=axis)
    rec.site_depth += 1
    try:
        out = compute()
    finally:
        rec.site_depth -= 1
    op.outputs = rec.metas(out)
    return out


def kernel_site(name: str, plain: Callable, *args, scratch_bytes: int = 0,
                **kwargs):
    """Record one launch of kernel ``name`` and return its outputs, made
    by ``plain(*args, **kwargs)`` under the fake mode (nothing launches)."""
    return _site("kernel", name, lambda: plain(*args, **kwargs),
                 (args, kwargs), scratch_bytes)


def collective_site(kind: str, axis: str, x: torch.Tensor,
                    shape_of: Callable[[], torch.Tensor]):
    """Record one collective (``kind`` in the HLO spelling) over ``axis``
    moving ``x``, and return ``shape_of()``: a tensor of the shape the
    collective returns."""
    return _site("collective", kind, shape_of, (x,), axis=axis)


def recording() -> bool:
    """Whether a trace records in this thread (the wrappers' check)."""
    return RECORDING and active() is not None


@contextlib.contextmanager
def _open():
    global RECORDING, _OPEN
    if active() is not None:
        raise RuntimeError("trace_call: a trace is already recording in "
                           "this thread")
    with _OPEN_LOCK:
        _OPEN += 1
        RECORDING = True
    try:
        yield
    finally:
        with _OPEN_LOCK:
            _OPEN -= 1
            RECORDING = _OPEN > 0


def _named_leaves(tree, prefix: str) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` for a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _named_leaves(v, f"{prefix}.{k}" if prefix else str(k))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _named_leaves(v, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def trace_call(fn: Callable, *args, modules: Sequence[torch.nn.Module] = (),
               outputs: Optional[Callable[[], Any]] = None,
               **kwargs) -> Trace:
    """Record ``fn(*args, **kwargs)`` without running it.

    ``args``/``kwargs`` may hold tensors (swapped for fakes; named
    ``arg0...``), numpy arrays and Python values (host values, passed as
    they are). ``modules``: the modules whose parameters and buffers the
    call reads (swapped for fakes, named ``param:<name>``). ``outputs``:
    called after ``fn`` inside the trace; its tensor leaves are the
    trace's outputs besides ``fn``'s return value (the state a step
    installs). Nothing of the caller's state changes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.nn.utils.stateless import _reparametrize_module

    trace = Trace()
    rec = _Recorder(trace)
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)

    def fake(t):
        return fake_mode.from_tensor(t) if isinstance(t, torch.Tensor) else t

    fargs, fkwargs = tree_map(fake, (args, kwargs))
    for name, leaf in _named_leaves((fargs, fkwargs), "arg"):
        if isinstance(leaf, torch.Tensor):
            trace.args.append(rec.meta(leaf, name))
    swaps = []
    for m in modules:
        fakes = {n: fake_mode.from_tensor(t) for n, t in
                 list(m.named_parameters(remove_duplicate=False))
                 + list(m.named_buffers(remove_duplicate=False))}
        for n, t in fakes.items():
            trace.args.append(rec.meta(t, f"param:{n}"))
        swaps.append((m, fakes))
    mode = _mode_class()(rec)
    with contextlib.ExitStack() as stack:
        for m, fakes in swaps:
            stack.enter_context(_reparametrize_module(m, fakes,
                                                      strict=False))
        stack.enter_context(_open())
        stack.enter_context(fake_mode)
        stack.enter_context(mode)
        out = fn(*fargs, **fkwargs)
        extra = outputs() if outputs is not None else None
        trace.outputs = list(rec.metas(out) + rec.metas(extra))
    return trace


__all__ = ["HostRead", "Op", "RECORDING", "TensorMeta", "Trace", "Upload",
           "active", "collective_site", "kernel_site", "loop_region",
           "recording", "trace_call"]
