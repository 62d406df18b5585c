"""Runtime context, the ``init_nncontext`` equivalent (port of
``common/context.py``).

:func:`init_zoo_context` finds the devices, joins a ``torch.distributed``
process group when ``RuntimeConfig.coordinator_address`` is set (gloo on
the CPU, NCCL on CUDA; the JAX package joins ``jax.distributed`` only
then too), engages the precision policy of ``RuntimeConfig.precision``,
lays the devices out as a :class:`Mesh` over the axes ``dp``, ``fsdp``,
``tp``, ``sp``, ``pp`` and ``ep`` (sizes from ``MeshConfig.sizes``, as the
JAX package computes them) and returns the :class:`ZooContext` every
subsystem reads. :func:`reset_zoo_context` drops it, destroys the process
group it joined and restores the f32 policy.

Devices: ``platform=None`` means CUDA (with no CUDA it raises, as every
entry point of the port does), ``"gpu"``/``"cuda"`` the same, ``"cpu"``
the CPU, counted ``num_virtual_devices`` times when that is set (the JAX
package's virtual host devices; torch has one CPU device, so the entries
repeat it). On CUDA a process holds one card, its current device (the
one :func:`~analytics_zoo_tpu_torch.common.cluster.configure_worker`
pins), however many are visible, so a job of N processes describes N
devices, one a rank. In a ``torch.distributed`` job the mesh is a mesh
of ranks: rank r is the r-th entry of the device array in C order, its
coordinates are that entry's index, and each axis has a process group of
the ranks that differ only in that axis's coordinate
(:meth:`Mesh.axis`; the collectives of ``parallel/comm.py`` run on
them). An axis that spans every rank is the world group; with no job
every axis is trivial. Nothing makes a context behind the caller's back:
the Estimator reads one only when it was initialised, and otherwise
trains alone on its own device.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import MeshConfig, RuntimeConfig, apply_env_overrides

logger = logging.getLogger("analytics_zoo_tpu_torch")

_CONTEXT_LOCK = threading.Lock()
_CURRENT: Optional["ZooContext"] = None


#: process groups by their ranks: ``new_group`` is collective, and every
#: rank builds the same meshes in the same order, so each reuses the same
#: groups
_GROUPS: Dict[Tuple[int, ...], object] = {}


def _group(ranks: Tuple[int, ...]):
    import torch.distributed as dist

    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(list(ranks))
    return _GROUPS[ranks]


class Mesh:
    """Devices laid out over named axes: ``devices`` is a numpy array of
    ``torch.device`` whose shape is the axes' sizes; ``shape`` maps each
    axis name to its size, as a JAX mesh's does. In a ``torch.distributed``
    job, :meth:`bind` makes it this rank's view: its ``coords`` and one
    :class:`~analytics_zoo_tpu_torch.parallel.comm.Axis` an axis."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for "
                             f"{len(axis_names)} axis names")
        self.devices = devices
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.rank: Optional[int] = None
        self.coords: Dict[str, int] = {a: 0 for a in self.axis_names}
        self._axes: Dict[str, object] = {}

    def bind(self, rank: Optional[int]) -> "Mesh":
        """This rank's coordinates and the axes' process groups (every rank
        of the job calls it, in the same order); ``rank=None``: no job,
        every axis trivial."""
        import torch.distributed as dist

        from ..parallel.comm import Axis

        self.rank = rank
        shape = self.devices.shape
        if rank is None:
            self._axes = {a: Axis(a, None, n, 0, (0,) * n)
                          for a, n in zip(self.axis_names, shape)}
            return self
        if self.size != dist.get_world_size():
            raise ValueError(f"mesh {self.shape} of {self.size} devices in a "
                             f"job of a different number of ranks")
        idx = np.unravel_index(rank, shape)
        self.coords = {a: int(i) for a, i in zip(self.axis_names, idx)}
        ids = np.arange(self.size).reshape(shape)
        for d, a in enumerate(self.axis_names):
            # every line of ranks along axis d, so each rank joins all groups
            lines = np.moveaxis(ids, d, -1).reshape(-1, shape[d])
            for line in lines:
                ranks = tuple(int(r) for r in line)
                group = _group(ranks)
                if rank in ranks:
                    self._axes[a] = Axis(a, group, shape[d],
                                         ranks.index(rank), ranks)
        return self

    def axis(self, name: str):
        """The named axis as this rank sees it (trivial before
        :meth:`bind` or outside a job)."""
        if name not in self.axis_names:
            raise KeyError(f"mesh has no axis {name!r}; axes "
                           f"{self.axis_names}")
        if not self._axes:
            self.bind(None)
        return self._axes[name]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __enter__(self) -> "Mesh":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def _platform(platform: Optional[str]) -> str:
    if platform is None or platform in ("gpu", "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass platform='cpu' explicitly to "
                "run the port on the CPU")
        return "cuda"
    if platform == "cpu":
        return "cpu"
    raise ValueError(f"platform {platform!r}; known: None, 'cpu', 'gpu', "
                     f"'cuda'")


def local_devices(platform: Optional[str] = None,
                  num_virtual_devices: int = 0) -> List[torch.device]:
    """This process's devices: its current card, or the CPU (repeated
    ``num_virtual_devices`` times when that is set)."""
    if _platform(platform) == "cuda":
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cpu")] * max(1, int(num_virtual_devices))


class ZooContext:
    """The devices, the mesh over them and this process's place in the
    job. One per process."""

    def __init__(self, config: RuntimeConfig):
        import torch.distributed as dist

        self.config = config
        kind = _platform(config.platform)
        self._owns_group = False
        if config.coordinator_address is not None \
                and not dist.is_initialized():
            addr = config.coordinator_address
            dist.init_process_group(
                backend="nccl" if kind == "cuda" else "gloo",
                init_method=addr if "://" in addr else f"tcp://{addr}",
                world_size=int(config.num_processes),
                rank=int(config.process_id))
            self._owns_group = True
        if dist.is_initialized():
            self.process_index = dist.get_rank()
            self.process_count = dist.get_world_size()
        else:
            self.process_index, self.process_count = 0, 1
        self._local = local_devices(kind, config.num_virtual_devices)
        # every process's devices, in rank order (this process sees only
        # its own; the others' entries describe the layout)
        self.devices = self._local * self.process_count
        from ..nn.module import set_policy

        set_policy(param_dtype=config.precision.param_dtype,
                   compute_dtype=config.precision.compute_dtype)
        self.mesh = build_mesh(config.mesh, self.devices).bind(
            self.process_index if dist.is_initialized() else None)

    @property
    def num_devices(self) -> int:
        return len(self.devices)

    @property
    def local_devices(self) -> List[torch.device]:
        return list(self._local)

    def __enter__(self) -> "ZooContext":
        self.mesh.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mesh.__exit__(*exc)


def build_mesh(mesh_config: MeshConfig,
               devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """A :class:`Mesh` over ``devices`` (every card when not given) with
    the framework's axis names and ``mesh_config.sizes``."""
    if devices is None:
        devices = local_devices()
    sizes = mesh_config.sizes(len(devices))
    arr = np.empty(len(devices), dtype=object)
    arr[:] = list(devices)
    return Mesh(arr.reshape(sizes), mesh_config.axis_names)


def init_zoo_context(config: Optional[RuntimeConfig] = None, *,
                     set_current: bool = True, **overrides) -> ZooContext:
    """Create (and register) the process's :class:`ZooContext`: keyword
    overrides on top of ``config``, then the ``ZOO_TPU_*`` environment."""
    global _CURRENT
    cfg = config or RuntimeConfig()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cfg = apply_env_overrides(cfg)
    ctx = ZooContext(cfg)
    if set_current:
        with _CONTEXT_LOCK:
            _CURRENT = ctx
    logger.info("initialized ZooContext: %d devices, mesh=%s, process %d/%d",
                ctx.num_devices, ctx.mesh.shape, ctx.process_index,
                ctx.process_count)
    return ctx


def get_zoo_context(auto_init: bool = True) -> ZooContext:
    """The process's context; with none yet, a default one (the
    ``ZOO_TPU_*`` environment over ``RuntimeConfig()``)."""
    global _CURRENT
    with _CONTEXT_LOCK:
        if _CURRENT is None:
            if not auto_init:
                raise RuntimeError("no ZooContext; call init_zoo_context() "
                                   "first")
            _CURRENT = ZooContext(apply_env_overrides(RuntimeConfig()))
        return _CURRENT


def reset_zoo_context() -> None:
    """Drop the current context, destroy the process group it joined, and
    restore the f32 precision policy it engaged."""
    global _CURRENT
    from ..nn.module import set_policy

    with _CONTEXT_LOCK:
        ctx, _CURRENT = _CURRENT, None
    if ctx is not None and ctx._owns_group:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    set_policy(param_dtype="float32", compute_dtype="float32")


__all__ = ["Mesh", "ZooContext", "build_mesh", "get_zoo_context",
           "init_zoo_context", "local_devices", "reset_zoo_context"]
