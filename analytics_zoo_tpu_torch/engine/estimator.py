"""Training engine (port of ``engine/estimator.py``): the replicated,
single-card layout of the JAX ``Estimator``.

One optimizer step (:meth:`Estimator._step`) is the JAX ``_step_fn`` in
its replicated layout: gradients from :meth:`Estimator._grads` (the JAX
``_grads_fn``), upcast to f32, their global L2 norm, the optimizer chain
(clipping first, then the optimizer, wrapped in ``with_master_weights``
under mixed precision), and the new parameters installed in the model in
place. With ``grad_accum_steps=K`` the global batch splits into K
contiguous microbatches whose gradients are summed in f32 accumulators and
divided by K once: one update per global step, and the step's loss is the
mean of the micro-losses — the JAX accumulation contract.

The rng schedule is the JAX one, on :mod:`..common.prng` (``jax.random``'s
bits): the first ``fit`` splits ``PRNGKey(seed)`` into ``(k_init,
k_train)``; step ``n`` hands ``fold_in(k_train, n)`` to the model (a model
whose ``apply`` takes ``rng=``, such as ``ImplicitNCF`` drawing its
negatives), and under accumulation micro-step ``i`` gets
``fold_in(step_rng, i)``. The model's weights are its own (drawn at
construction); ``k_init`` is unused.

The model's float buffers are the JAX ``model_state``:
BatchNormalization's moving statistics move in each micro-batch's
forward, in micro-batch order, and each micro-batch's loss carries the
layers' regularization terms (``regularization()``), as the JAX
``loss_of`` adds them. Over ranks the replicated and per-leaf steps
normalise with the global batch's statistics (``comm.batch_psum``), the
flat step with each rank's own and then averages the float buffers over
dp; a BN model on a mesh with sp, pp, ep or tp above 1 raises.

Mixed precision (``TrainConfig(compute_dtype="bfloat16")``): the model's
parameters are cast to bf16 in place (the JAX ``cast_params``) and the f32
masters exist only in the optimizer state; each forward/backward runs
under the bf16 precision policy.

:meth:`Estimator.fit` walks :class:`~..data.featureset.FeatureSet`
epochs in the JAX order (the same seeded permutation; remainders
dropped) until the end trigger fires, and records the loss and the
pre-clip gradient norm at every ``log_every_n_steps``. A streaming epoch
takes its batches through ``data/pipeline.py``'s ``PrefetchLoader``:
``TrainConfig.prefetch_depth`` batches ahead on a producer thread, each
staged in pinned memory and copied to the card on a side stream while
the step on the batch before runs (depth 0: in line, no thread), in the
synchronous order, so every depth gives the same batches; ``DataWaitMs``
is the time the loop waits for the next batch. ``evaluate`` and
``predict`` read their batches the same way. With
``TrainConfig(cache_on_device=True)`` (a DRAM FeatureSet of arrays; a
memmap tier or byte records stream) the dataset goes to the card once
and each epoch's order is ``jax.random.permutation(PRNGKey(seed + epoch *
1_000_003), n)``, computed on the card; steps run in blocks of
``scan_block_steps`` (the JAX ``lax.scan``; a Python loop over the block
here), batches gathered on the card, log points at block granularity, and
the steps that do not fill a block after the last one. :meth:`evaluate`
streams metrics (``nn/metrics.py``) over batches in order, the last one
partial. Runs on CUDA unless given ``device="cpu"`` (or a model that
lives on the CPU); without CUDA and without a device it raises.

Fault tolerance is the JAX ``fit``'s (``engine/checkpoint.py``'s format,
so each package resumes the other's checkpoints):

- with ``TrainConfig(checkpoint_dir=...)`` the first ``fit`` resumes from
  the newest checkpoint there (state, iteration and epoch); every epoch
  ends with a durable save, and ``checkpoint_trigger`` (default
  ``SeveralIteration(checkpoint_every_n_iters)``) saves mid-epoch through
  the async writer (``async_checkpoint``);
- a step that raises rolls back to the newest durable checkpoint (after
  draining the writer) and re-runs the failed epoch from there, up to
  ``retry_times`` times, with ``RetryPolicy``'s seeded backoff;
- with ``graceful_shutdown`` a SIGTERM (main thread only) sets a flag that
  the next step turns into ``_GracefulStop``, a BaseException the retry
  cannot absorb: one final durable save, then ``SystemExit(143)``; the
  previous handler is restored on every exit.

``fit(validation_data=..., validation_metrics=...)`` evaluates after each
epoch, and :meth:`set_tensorboard` writes the JAX package's TensorBoard
scalars (``Loss``, ``Throughput``, ``GradNorm``, ``DataWaitMs``,
``ComputeMs`` at log points and epoch ends; each validation metric).
``chaos_point("estimator.step")`` marks every step (every block of the
device-cached path).

The Estimator reads the process's runtime context
(``common/context.py::init_zoo_context``) when one was initialised: its
mesh and its process index (process 0 writes the checkpoints). With none
it makes none, and trains alone on its own device.

Multi-rank training (a mesh of N devices in a ``torch.distributed`` job of
N ranks, one process a rank): every rank runs this same loop over the same
global batches (one seeded order) and takes its block along the batch
axes ``("dp", "fsdp")``, block ``dp_index * fsdp + fsdp_index`` (the JAX
``P(("dp", "fsdp"))``): the contiguous ``1/(dp * fsdp)`` of each global
batch (under accumulation with per-leaf or replicated updates, its share
of each micro-batch, as the JAX step's micro-batches are laid out); tp
ranks take the same block. Gradients are averaged over ``dp * fsdp``:
each leaf is summed over the batch axes its own exchange has not summed
it over (an fsdp-stored leaf's gather already did over fsdp, a row-sharded
table's over dp), then divided. The update's layout is the JAX
``_update_mode``: replicated (all-reduces of the gradients), ``"flat"`` (a
pure-dp mesh, no ``param_sharding``:
``parallel/update_sharding.py::flat_exchange``) or per-leaf (``"gspmd"``
in JAX: each leaf reduce-scattered over dp along the dim
``shard_spec_over_axis`` gives its spec, updated, all-gathered; a
row-sharded table keeps its rows local). The step key is
``fold_in(k_train, step)`` on every rank; the flat step folds the dp index
in after that, as JAX's does, and the others do not: their dropout masks
are drawn for the global batch and sliced (``nn/layers/core.py::dropout``).
``param_sharding`` (``(name, leaf) -> P``, e.g.
``parallel.sharding.make_param_sharding``) places every leaf whose spec
names an axis above 1 (``parallel/placement.py``): each rank keeps its
block; ``fsdp`` blocks are all-gathered where a module reads them;
``TransformerLM``'s layers compute Megatron-style over ``tp`` on their
blocks (vocab-parallel embeddings, head and ``lm_loss``), and any other
leaf stored over ``tp`` is gathered where it is read. The axes ``sp``,
``ep`` and ``pp`` shard work inside the model (ring attention, the MoE
layer, the pipeline), whose gradients come out whole on every rank.
Checkpoints stay in the JAX format: every rank gathers the sharded leaves
and optimizer state, and process 0 writes; a restore slices each rank's
blocks back out. At log points a dp axis above 1 times one param-sized
exchange round (``make_comm_probe``) into ``zoo_train_comm_seconds``.
``TrainConfig(donate_state=False)`` keeps the pre-step parameter tensors
alive: a step installs its new parameters as new tensors instead of
writing into the old ones (same bits).

``TrainConfig.graph_checks`` ("warn"/"raise") runs the analysis tier at
``fit`` start (:meth:`Estimator._run_graph_checks`): one step on the first
batch is recorded without running (fake tensors: no kernel launches, and
the parameters, optimizer state, step count, key and every
``zoo_train_*`` counter stay as they were) and held to the collective
budget (the flat update: one reduce-scatter and one all-gather, none in
the accumulation loop), ``host-transfer``, ``large-constant``,
``dtype-discipline`` under a bf16 policy, and the memory tier
(``donation-missed`` for ``donate_state=False``, ``hbm-budget`` under
``hbm_budget_mb``, ``peak-temporary``). "raise" fails before the first
update. The memory witness samples site ``estimator.step`` at log points
and epoch ends, and each new step signature feeds a recompilation-hazard
tracker.

Telemetry: the JAX Estimator's families, on the port's registry
(``common/telemetry.py``), with its names, labels and counts:
``zoo_train_steps_total``, ``zoo_train_data_wait_seconds`` (each streamed
batch's wait), ``zoo_train_compute_seconds`` and ``zoo_train_grad_norm``
(each log point), ``zoo_train_rollbacks_total``,
``zoo_train_checkpoints_total``, ``zoo_train_sigterm_exits_total`` and
``zoo_train_comm_seconds`` (a dp axis above 1 only). ``zoo_train_compiles_total`` and ``zoo_train_compile_seconds``
count XLA compiles in the JAX package, which the port does not have:
here they record the first step of each new batch signature (shapes and
dtypes; a scan block's shape on the device-cached path), which is where
JAX compiles, timed to the device's finish: in the port that first step
pays lazy kernel builds, library handles and allocator growth. Their
counts are JAX's on the same run. The FeatureSet's
``zoo_data_batches_total`` and ``zoo_data_batch_gather_seconds`` count
one batch fewer than JAX's for an Estimator's first ``fit`` or
``evaluate``: the JAX Estimator draws one host batch there to trace its
step, the port builds its state without one.
"""

from __future__ import annotations

import contextlib
import inspect
import logging
import math
import signal
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import bridge
from ..common import memwitness as _mw
from ..common import prng
from ..common import telemetry as _tm
from ..common.chaos import chaos_point
from ..common.context import ZooContext, get_zoo_context
from ..common.config import TrainConfig, check_ported
from ..common.resilience import ResilienceError, RetryPolicy
from ..common.summary import TrainSummary, ValidationSummary
from ..common.triggers import (MaxEpoch, SeveralIteration, Trigger,
                               TrainerState)
from ..data.featureset import FeatureSet, _tree_leaves, _tree_map
from ..data.pipeline import device_prefetch
from ..nn.layers.normalization import has_batchnorm
from ..nn.losses import get_loss
from ..nn.metrics import get_metric
from ..nn.module import cast_params, precision_policy, resolve_device
from ..nn.optimizers import (apply_updates, get_optimizer, global_norm,
                             with_clipping)
from ..analysis import trace as _trace
from ..parallel import comm, placement
from ..parallel import update_sharding as upd
from ..parallel.sharding import P, entry_axes, spec_axes
from ..parallel.update_sharding import with_master_weights
from . import checkpoint as ckpt

logger = logging.getLogger("analytics_zoo_tpu_torch.estimator")

_STEPS = _tm.counter("zoo_train_steps_total", "Optimizer steps run")
_DATA_WAIT = _tm.histogram("zoo_train_data_wait_seconds",
                           "Per-step host wait on the input pipeline")
_COMPUTE = _tm.histogram("zoo_train_compute_seconds",
                         "Per-step dispatch + device time (window mean, "
                         "synced at log points)")
_COMPILES = _tm.counter("zoo_train_compiles_total",
                        "Train-step executables built (first dispatch of a "
                        "jitted step/scan-block)")
_COMPILE_TIME = _tm.histogram("zoo_train_compile_seconds",
                              "Wall time of first-dispatch (compile) steps",
                              buckets=(0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30,
                                       60, 120))
_ROLLBACKS = _tm.counter("zoo_train_rollbacks_total",
                         "Checkpoint rollbacks taken by fit's retry loop")
_CHECKPOINTS = _tm.counter("zoo_train_checkpoints_total",
                           "Checkpoints saved")
_SIGTERM_EXITS = _tm.counter("zoo_train_sigterm_exits_total",
                             "Graceful SIGTERM teardowns (final checkpoint "
                             "+ exit 143)")
_GRAD_NORM = _tm.histogram("zoo_train_grad_norm",
                           "f32 global (pre-clip) gradient L2 norm, observed "
                           "at log points",
                           buckets=(0.001, 0.01, 0.1, 0.5, 1, 2.5, 5, 10, 25,
                                    100, 1000))
_COMM = _tm.histogram("zoo_train_comm_seconds",
                      "Measured one-round gradient-exchange time (param-sized "
                      "collective probe on the dp axis, timed off the hot "
                      "path at each log point)",
                      buckets=(.0001, .0005, .001, .0025, .005, .01, .025,
                               .05, .1, .25, 1))


class _GracefulStop(BaseException):
    """Raised at the next step after SIGTERM requested a clean exit; a
    BaseException so the retry-from-checkpoint handler cannot absorb it."""


def _as_featureset(data) -> FeatureSet:
    if isinstance(data, FeatureSet):
        return data
    if isinstance(data, tuple) and len(data) == 2:
        return FeatureSet.from_numpy(data[0], data[1])
    raise TypeError(f"cannot build FeatureSet from {type(data)}")


def _context() -> Optional[ZooContext]:
    """The process's runtime context if one was initialised, else None."""
    try:
        return get_zoo_context(auto_init=False)
    except RuntimeError:
        return None


def _model_device(model) -> Optional[torch.device]:
    dev = getattr(model, "device", None)
    if dev is not None:
        return torch.device(dev)
    first = next(iter(model.parameters()), None)
    return None if first is None else first.device


class Estimator:
    """Drives the training step of ``model`` (any module whose
    ``apply(x)`` returns the prediction; ``apply(x, rng=key)`` if it
    draws randomness in training) on one device."""

    def __init__(self, model, optimizer="adam", loss="mse", mesh=None,
                 config: Optional[TrainConfig] = None, param_sharding=None,
                 *, device=None):
        self.model = model
        self.loss_fn = get_loss(loss)
        self.config = check_ported(config or TrainConfig())
        self.device = resolve_device(device if device is not None
                                     else getattr(model, "device", None))
        ctx = _context()
        self.mesh = mesh if mesh is not None or ctx is None else ctx.mesh
        self.param_sharding = param_sharding
        if self.mesh is not None:
            if self.mesh.size > 1 and self.mesh.rank is None:
                raise ValueError(
                    f"mesh {self.mesh.shape} needs a torch.distributed job "
                    f"of {self.mesh.size} ranks (init_zoo_context with a "
                    f"coordinator, or parallel.comm.RankPool)")
        have = _model_device(model)
        if have is not None and have.type != self.device.type:
            raise ValueError(f"the model's parameters live on {have}, the "
                             f"Estimator runs on {self.device}")
        self._base_tx = get_optimizer(optimizer)
        self._takes_rng = "rng" in inspect.signature(model.apply).parameters
        # first-dispatch signatures: the streamed steps' batches, the
        # device-cached scan blocks' shapes
        self._step_shapes: set = set()
        self._recompile_tracker = None
        self._scan_shapes: set = set()
        self.train_state: Optional[Dict[str, Any]] = None
        self.trainer_state = TrainerState()
        #: one entry per log point: epoch, iteration, loss, grad_norm and
        #: the window's per-step data/compute milliseconds
        self.history: List[Dict[str, float]] = []
        #: the last step's f32 pre-clip gradient norm (0-d tensor)
        self.last_grad_norm: Optional[torch.Tensor] = None
        # cache_on_device: the dataset on the card, keyed by its arrays
        self._device_data = None
        self._device_data_key = None
        self.train_summary: Optional[TrainSummary] = None
        self.val_summary: Optional[ValidationSummary] = None
        # the at-most-one-in-flight async checkpoint writer (made at the
        # first async save)
        self._ckpt_writer: Optional[ckpt.CheckpointWriter] = None
        self._sigterm = False
        # multi-rank layout, fixed at the first _init_state: each placed
        # leaf's storage spec (axes above 1), the rule's own spec, and its
        # placement
        self._specs: Dict[str, P] = {}
        self._rule_specs: Dict[str, P] = {}
        self._placements: Dict[str, placement.Placement] = {}
        # a model's loss over its sharded outputs (a vocab-parallel head)
        self._sharded_loss = None
        self._upd_dims: Dict[str, Optional[int]] = {}
        self._flat_meta: Optional[upd.FlatParamMeta] = None
        self._comm_probe = None
        # the streamed batches are this rank's block already (host shards)
        self._batches_local = False
        # leaf name -> the axes its gradient's blocks are sharded over
        self._norm_axes: Dict[str, tuple] = {}
        self._rebuild_tx()

    def _rebuild_tx(self) -> "Estimator":
        """Clipping first, then the optimizer; under mixed precision the
        ``with_master_weights`` wrapper whose updates ARE the new
        low-precision params."""
        cfg = self.config
        self.tx = with_clipping(self._base_tx, cfg.gradient_clip_norm,
                                cfg.gradient_clip_value,
                                norm_fn=self._global_norm)
        self._mp_dtype = None
        if cfg.compute_dtype not in (None, "float32"):
            self._mp_dtype = torch.bfloat16
            self.tx = with_master_weights(self.tx)
        return self

    def set_gradient_clipping(self, clip_norm: Optional[float] = None,
                              clip_value: Optional[tuple] = None
                              ) -> "Estimator":
        """setGradientClippingByL2Norm / setConstantGradientClipping; only
        before the first step."""
        if self.train_state is not None:
            raise RuntimeError("set clipping before training starts: "
                               "optimizer state is already initialized")
        self.config.gradient_clip_norm = clip_norm
        self.config.gradient_clip_value = clip_value
        return self._rebuild_tx()

    def _policy(self):
        if self.config.compute_dtype is None:
            return contextlib.nullcontext()
        return precision_policy(compute_dtype=self.config.compute_dtype)

    def _gathering(self):
        """``placement.gathering()`` when this Estimator placed leaves;
        otherwise nothing, and the step's saved tensors go unhooked."""
        if not self._placements:
            return contextlib.nullcontext()
        return placement.gathering()

    def _params(self) -> Dict[str, torch.nn.Parameter]:
        return {n: p for n, p in self.model.named_parameters()
                if p.requires_grad}

    def _to_device(self, tree):
        def put(a):
            if isinstance(a, torch.Tensor):
                return a.to(self.device)
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        return _tree_map(put, tree)

    # ------------------------------------------------------------ the layout
    def _dp_axis(self) -> Optional[comm.Axis]:
        """The dp axis when it is above 1, else None."""
        if self.mesh is None or self.mesh.shape.get("dp", 1) <= 1:
            return None
        return self.mesh.axis("dp")

    def _update_mode(self) -> Optional[str]:
        """``None`` (replicated update), ``"flat"`` (a pure-dp mesh and no
        ``param_sharding``) or ``"gspmd"`` (per-leaf), as the JAX
        ``_update_mode`` picks them."""
        us = self.config.update_sharding
        if not us or self._dp_axis() is None:
            return None
        pure_dp = all(n == 1 for a, n in self.mesh.shape.items() if a != "dp")
        if us == "gspmd":
            return "gspmd"
        if pure_dp and self.param_sharding is None:
            return "flat"
        if us == "flat":
            logger.warning("update_sharding='flat' needs a pure-dp mesh and "
                           "no param_sharding rules; using per-leaf update "
                           "sharding")
        return "gspmd"

    def _batch_axes(self) -> tuple:
        """The batch axes above 1, of ``("dp", "fsdp")`` (the JAX
        ``_batch_axes``)."""
        if self.mesh is None:
            return ()
        return tuple(a for a in ("dp", "fsdp")
                     if self.mesh.shape.get(a, 1) > 1)

    def _live_spec(self, spec: P) -> P:
        """``spec`` with its axes of size 1 dropped; a tuple entry keeps
        its order, the major axis first."""
        out = []
        for e in spec:
            axes = tuple(a for a in entry_axes(e)
                         if self.mesh.shape.get(a, 1) > 1)
            out.append(None if not axes else axes[0] if len(axes) == 1
                       else axes)
        while out and out[-1] is None:
            out.pop()
        return P(*out)

    def _place_params(self) -> None:
        """Each leaf whose spec names an axis keeps this rank's block of it
        (the JAX ``_place_state`` of the params), and the modules read
        their leaves by ``parallel/placement.py``'s rules."""
        if self.param_sharding is None or self.mesh is None:
            return
        params = self._params()
        specs = {}
        for name, p in params.items():
            self._rule_specs[name] = P(*self.param_sharding(name, p))
            spec = self._live_spec(self._rule_specs[name])
            if spec_axes(spec):
                specs[name] = spec
        self._placements = placement.plan(self.model, specs, self.mesh)
        for name, pl in self._placements.items():
            p = params[name]
            p.data = placement.block_of(p.detach(), pl).clone()
            if spec_axes(pl.spec):
                self._specs[name] = pl.spec
        placement.install(self.model, self._placements)

    def _whole_shape(self, name: str, t: torch.Tensor) -> tuple:
        """A stored block's whole leaf's shape."""
        shape = list(t.shape)
        for d, e in enumerate(self._specs.get(name, ())):
            for a in entry_axes(e):
                shape[d] *= self.mesh.shape[a]
        return tuple(shape)

    def _full(self, name: str, t: torch.Tensor, upd_dim=None) -> torch.Tensor:
        """A leaf's whole value, in the JAX layout, from this rank's block
        (every rank calls it): the per-leaf update's dp shard first, then
        the placement's blocks."""
        if upd_dim is not None:
            t = comm.all_gather(t, "dp", dim=upd_dim, tiled=True,
                                mesh=self.mesh)
        pl = self._placements.get(name)
        return t if pl is None else placement.whole_of(t, pl)

    def _block(self, name: str, t: torch.Tensor, upd_dim=None
               ) -> torch.Tensor:
        """The inverse of :meth:`_full`: this rank's block of a whole
        leaf."""
        pl = self._placements.get(name)
        if pl is not None:
            t = placement.block_of(t, pl)
        if upd_dim is not None:
            ax = self.mesh.axis("dp")
            t = t.chunk(ax.size, upd_dim)[ax.index]
        return t.contiguous()

    def _global_norm(self, g: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The f32 L2 norm of the whole gradient when ``g`` holds this
        rank's blocks of some leaves: each group of leaves' sum of squares
        summed over the axes its leaves are sharded on (a leaf replicated
        over an axis is whole, and the same, on its ranks, so it counts
        once)."""
        if not self._norm_axes:
            return global_norm(g)
        groups: Dict[tuple, list] = {}
        for n, x in g.items():
            groups.setdefault(self._norm_axes.get(n, ()), []).append(
                torch.sum(x.float() * x.float()))
        total = None
        for axes in sorted(groups):
            t = sum(groups[axes])
            for a in axes:
                t = comm.psum(t, a, mesh=self.mesh)
            total = t if total is None else total + t
        return torch.sqrt(total)

    def _local_values(self, values: Dict[str, torch.Tensor]):
        """The per-leaf update's dp shards of ``values``."""
        ax = self._dp_axis()
        return {n: v.chunk(ax.size, self._upd_dims[n])[ax.index]
                if self._upd_dims.get(n) is not None else v
                for n, v in values.items()}

    def _opt_init(self, values: Dict[str, torch.Tensor]):
        """The optimizer state for ``values`` in this run's layout."""
        mode = self._update_mode()
        if mode == "flat":
            return upd.flat_opt_init(self._base_tx, values, self._flat_meta,
                                     keep_master=self._mp_dtype is not None,
                                     index=self._dp_axis().index)
        if mode == "gspmd":
            return self.tx.init(self._local_values(values))
        return self.tx.init(values)

    # ------------------------------------------------------------------ build
    def _init_state(self, seed: int = 0) -> None:
        """Optimizer state from the model's current weights, and the
        training key: ``split(PRNGKey(seed))[1]``. Under mixed precision
        the masters are taken in f32 first, then the model's copy is cast
        down. On a mesh, sharded leaves keep their blocks first."""
        if self.mesh is not None and has_batchnorm(self.model):
            axes = [a for a in ("sp", "pp", "ep", "tp")
                    if self.mesh.shape.get(a, 1) > 1]
            if axes:
                raise NotImplementedError(
                    f"BatchNormalization in training on a mesh with "
                    f"{'/'.join(axes)} above 1 is not ported (ROADMAP Queue "
                    f"1, [13]); dp and fsdp are")
        self._place_params()
        values = {n: p.detach() for n, p in self._params().items()}
        self._norm_axes = {n: spec_axes(self._specs[n]) for n in values
                           if spec_axes(self._specs.get(n, ()))}
        mode = self._update_mode()
        if mode == "gspmd":
            ax = self._dp_axis()
            for n, v in values.items():
                base = self._specs.get(n, P())
                if "dp" in spec_axes(base):
                    self._upd_dims[n] = None
                    continue
                # the rule's own spec, as JAX extends it (an axis of size 1
                # still marks its dim sharded there)
                d = upd.dp_dim(upd.shard_spec_over_axis(
                    self._rule_specs.get(n, base), self._whole_shape(n, v),
                    self.mesh))
                if d is not None and v.shape[d] % ax.size:
                    d = None
                self._upd_dims[n] = d
                if d is not None:
                    self._norm_axes[n] = spec_axes(base) + ("dp",)
        if mode == "flat":
            model_vals = {n: v.to(self._mp_dtype) if self._mp_dtype
                          is not None and v.is_floating_point() else v
                          for n, v in values.items()}
            self._flat_meta = upd.flat_meta(model_vals,
                                            self._dp_axis().size)
        opt_state = self._opt_init(values)
        if self._mp_dtype is not None:
            cast_params(self.model, self._mp_dtype)
        sharded_loss = getattr(self.model, "sharded_loss", None)
        self._sharded_loss = (sharded_loss(self.loss_fn)
                              if sharded_loss is not None else None)
        _k_init, k_train = prng.split(prng.PRNGKey(seed))
        self.train_state = {"opt_state": opt_state, "step": 0,
                            "rng": k_train}

    def reset_optimizer(self) -> "Estimator":
        """Restart the optimizer from the model's current weights (moments
        and step count back to zero, the training key kept): what loading
        new weights into a trained model needs."""
        if self.train_state is not None:
            values = {n: p.detach() for n, p in self._params().items()}
            self.train_state = {"opt_state": self._opt_init(values),
                                "step": 0, "rng": self.train_state["rng"]}
        return self

    def _loss_of(self, x, y, rng) -> torch.Tensor:
        """One (micro-)batch's loss, plus the layers' regularization
        terms (0.0 without regularizers), where the JAX ``loss_of`` adds
        them."""
        if self._sharded_loss is not None:
            total = self._sharded_loss(x, y)
        else:
            y_hat = (self.model.apply(x, rng=rng) if self._takes_rng
                     else self.model.apply(x))
            total = self.loss_fn(y, y_hat)
        reg = getattr(self.model, "regularization", None)
        if reg is not None:
            total = total + reg()
        return total

    def _step_key(self):
        """The next step's key, ``fold_in(k_train, step)``."""
        ts = self.train_state
        if ts is None:
            return prng.fold_in(prng.split(prng.PRNGKey(0))[1], 0)
        return prng.fold_in(ts["rng"], ts["step"])

    def _grads(self, batch, rng=None):
        """``(loss, grads)`` of one global batch, grads in the params'
        dtype (K = 1) or summed over K microbatches in f32 and divided by
        K once; micro-step ``i`` sees ``fold_in(rng, i)`` (``rng``: the
        next step's key unless given)."""
        x, y = batch
        if rng is None:
            rng = self._step_key()
        params = self._params()

        def one(xb, yb, key):
            for p in params.values():
                p.grad = None
            loss = self._loss_of(xb, yb, key)
            loss.backward()
            return loss.detach(), {
                n: p.grad if p.grad is not None else torch.zeros_like(p)
                for n, p in params.items()}

        k = max(1, int(self.config.grad_accum_steps))
        if k == 1:
            return one(x, y, rng)
        m = _tree_leading(batch) // k
        acc = {n: torch.zeros_like(p, dtype=torch.float32)
               for n, p in params.items()}
        losses = []
        for i in range(k):
            with _trace.loop_region():
                part = _tree_map(lambda a: a[i * m:(i + 1) * m], (x, y))
                loss, g = one(*part, prng.fold_in(rng, i))
                for n, a in acc.items():
                    a.add_(g[n].float())
            losses.append(loss)
        return torch.stack(losses).mean(), {n: a / k for n, a in acc.items()}

    def _batch_shard(self, mode) -> Optional[comm.BatchShard]:
        """This rank's block of the global batch over the batch axes:
        block ``dp_index * fsdp + fsdp_index`` of ``dp * fsdp``."""
        axes = self._batch_axes()
        if not axes:
            return None
        index, count = 0, 1
        for a in axes:
            ax = self.mesh.axis(a)
            index, count = index * ax.size + ax.index, count * ax.size
        return comm.BatchShard(index, count, axes,
                               global_draws=mode != "flat", mesh=self.mesh)

    def _local_batch(self, batch, shard: comm.BatchShard, mode):
        """This rank's rows of a global batch: its contiguous block, or
        under accumulation outside the flat layout its block of each
        micro-batch (the JAX step's micro-batches are global rows sharded
        over the batch axes)."""
        k = max(1, int(self.config.grad_accum_steps))
        n, r = shard.count, shard.index

        def take(a):
            b = a.shape[0]
            if b % (n * k):
                raise ValueError(f"global batch {b} does not split over "
                                 f"{'x'.join(shard.axis)}={n} x "
                                 f"grad_accum_steps={k}")
            if mode == "flat" or k == 1:
                return a[r * (b // n):(r + 1) * (b // n)]
            m = b // k
            return a.reshape((k, n, m // n) + tuple(a.shape[1:]))[:, r] \
                .reshape((b // n,) + tuple(a.shape[1:]))

        return _tree_map(take, batch)

    def _allreduce(self, g: Dict[str, torch.Tensor], names, axes) -> None:
        """Sum ``g[names]`` over ``axes`` in place: per axis one
        all-reduce of the leaves flattened in the JAX order."""
        names = upd.leaf_order(names)
        flat = torch.cat([g[n].reshape(-1) for n in names])
        for a in axes:
            flat = comm.psum(flat, a, mesh=self.mesh)
        off = 0
        for n in names:
            size = g[n].numel()
            g[n] = flat[off:off + size].reshape(g[n].shape)
            off += size

    def _mean_grads(self, g: Dict[str, torch.Tensor], count: int) -> None:
        """The mean over the batch axes of the ranks' local-mean gradients,
        in place: each leaf summed over the batch axes its own exchange has
        not summed it over (an fsdp-stored leaf's gather backward sums over
        fsdp, a row-sharded table's exchange over dp), reduce-scattered over
        dp along its update dim under the per-leaf update, then divided by
        ``count``."""
        groups: Dict[tuple, list] = {}
        for n in g:
            stored = spec_axes(self._specs.get(n, ()))
            axes = tuple(a for a in self._batch_axes() if a not in stored)
            if self._upd_dims.get(n) is not None:
                axes = tuple(a for a in axes if a != "dp")
            groups.setdefault(axes, []).append(n)
        for axes in sorted(groups):
            if axes:
                self._allreduce(g, groups[axes], axes)
        for n, d in self._upd_dims.items():
            if d is not None:
                g[n] = comm.psum_scatter(g[n], "dp", dim=d, tiled=True,
                                         mesh=self.mesh)
        for n in g:
            g[n] = g[n] / count

    def _mean_model_state(self) -> None:
        """The flat step's float model state (BatchNormalization's moving
        statistics, moved by each rank's local batch) averaged over dp in
        place, in one all-reduce, as the JAX flat step's ``pmean`` keeps it
        the same on every replica."""
        floats = [b for b in bridge.model_state(self.model).values()
                  if b.is_floating_point()]
        if not floats:
            return
        with torch.no_grad():
            flat = comm.psum(torch.cat([b.reshape(-1) for b in floats]),
                             "dp", mesh=self.mesh) / self._dp_axis().size
            off = 0
            for b in floats:
                b.copy_(flat[off:off + b.numel()].reshape(b.shape))
                off += b.numel()

    def _step(self, batch):
        """One optimizer step; returns ``(loss, grad_norm)`` as 0-d
        tensors (no host sync)."""
        ts = self.train_state
        mode = self._update_mode()
        shard = self._batch_shard(mode)
        key = self._step_key()
        if shard is not None:
            if not self._batches_local:
                batch = self._local_batch(batch, shard, mode)
            if mode == "flat":
                # decorrelate the replicas' dropout and negative draws
                key = prng.fold_in(key, shard.index)
        with self._policy(), comm.batch_shard(shard), self._gathering():
            loss, grads = self._grads(batch, key)
        params = self._params()
        g32 = {n: g.float() for n, g in grads.items()}
        for p in params.values():
            p.grad = None
        values = {n: p.detach() for n, p in params.items()}
        if shard is not None:
            for a in self._batch_axes():
                loss = comm.psum(loss, a, mesh=self.mesh)
            loss = loss / shard.count
        if mode == "flat":
            self._mean_model_state()
            cfg = self.config
            new, new_opt, gnorm = upd.flat_exchange(
                values, g32, ts["opt_state"], self._flat_meta,
                self._base_tx, mesh=self.mesh, clip_norm=cfg.gradient_clip_norm,
                clip_value=cfg.gradient_clip_value)
        else:
            if shard is not None:
                self._mean_grads(g32, shard.count)
            if mode == "gspmd":
                values = self._local_values(values)
            gnorm = self._global_norm(g32)
            updates, new_opt = self.tx.update(g32, ts["opt_state"], values)
            new = updates if self._mp_dtype is not None else apply_updates(
                values, updates)
            if mode == "gspmd":
                new = {n: comm.all_gather(t, "dp", dim=self._upd_dims[n],
                                          tiled=True, mesh=self.mesh)
                       if self._upd_dims.get(n) is not None else t
                       for n, t in new.items()}
        with torch.no_grad():
            if self.config.donate_state:
                for n, p in params.items():
                    p.copy_(new[n])
            else:                       # the pre-step tensors stay as they were
                for n, p in params.items():
                    p.data = new[n]
        self.train_state = {"opt_state": new_opt, "step": ts["step"] + 1,
                            "rng": ts["rng"]}
        return loss, gnorm

    # -------------------------------------------------------------------- fit
    def fit(self, data, batch_size: Optional[int] = None,
            epochs: Optional[int] = None,
            end_trigger: Optional[Trigger] = None, validation_data=None,
            validation_metrics=(), checkpoint_trigger=None, seed: int = 0):
        """Train until ``end_trigger`` (default ``MaxEpoch(epochs or
        config.max_epochs)``). ``data``: a FeatureSet or an (x, y) pair;
        ``batch_size`` is global. ``seed`` keys the training rng at the
        first ``fit`` (the JAX ``PRNGKey(seed)`` split) and the retry
        backoff's jitter; the weights are the model's own, drawn from its
        constructor's seed, unless a checkpoint in ``checkpoint_dir``
        resumes them. Validation, checkpoints, retry and the SIGTERM save
        as the module docstring says."""
        cfg = check_ported(self.config)
        batch_size = batch_size or cfg.batch_size
        accum = max(1, int(cfg.grad_accum_steps))
        if batch_size % accum:
            raise ValueError(f"batch_size={batch_size} must divide by "
                             f"grad_accum_steps={accum}")
        train_set = _as_featureset(data)
        end_trigger = end_trigger or MaxEpoch(
            epochs if epochs is not None else cfg.max_epochs)
        if checkpoint_trigger is None and cfg.checkpoint_every_n_iters:
            checkpoint_trigger = SeveralIteration(cfg.checkpoint_every_n_iters)
        if self.train_state is None:
            self._init_state(seed)
            if cfg.checkpoint_dir:
                latest = ckpt.latest_checkpoint(cfg.checkpoint_dir)
                if latest:
                    self._restore(latest)
                    logger.info("resumed from %s (iter %d)", latest,
                                self.trainer_state.iteration)
        retry_policy = RetryPolicy(
            max_attempts=cfg.retry_times + 1, base_delay_s=cfg.retry_backoff_s,
            max_delay_s=cfg.retry_max_backoff_s,
            deadline_s=cfg.retry_deadline_s, jitter=0.1, seed=seed)
        tracker = retry_policy.tracker()
        self._sigterm = False
        prev_handler = None
        handler_installed = (cfg.graceful_shutdown
                             and threading.current_thread()
                             is threading.main_thread())
        if handler_installed:
            prev_handler = signal.signal(
                signal.SIGTERM, lambda *_: setattr(self, "_sigterm", True))
        # training mode for the steps, as JAX's apply(training=True)
        self.model.train()
        try:
            if cfg.graph_checks and cfg.graph_checks != "off":
                self._run_graph_checks(train_set, batch_size)
            while not end_trigger(self.trainer_state):
                try:
                    if (cfg.cache_on_device and train_set.memory_type
                            == "DRAM" and not hasattr(train_set, "decoder")
                            and getattr(_context(), "process_count",
                                        1) == 1):
                        self._run_epoch_cached(train_set, batch_size,
                                               checkpoint_trigger)
                    else:
                        self._run_epoch(train_set, batch_size,
                                        checkpoint_trigger)
                except (KeyboardInterrupt, ValueError, TypeError):
                    raise
                except Exception as e:          # retry from checkpoint
                    if not cfg.checkpoint_dir:
                        raise
                    # never roll back onto a write still in flight; a failed
                    # one is forfeited for the last durable snapshot
                    self._drain_checkpoints(raise_errors=False)
                    latest = ckpt.latest_checkpoint(cfg.checkpoint_dir)
                    if latest is None:
                        raise
                    try:
                        delay = tracker.record_failure(e)
                    except ResilienceError:
                        raise e
                    logger.warning("step failed (%s); retry %d/%d from %s "
                                   "in %.2fs", e, tracker.attempts,
                                   cfg.retry_times, latest, delay)
                    _ROLLBACKS.inc()
                    if delay > 0:
                        time.sleep(delay)
                    self._restore(latest)
                    continue
                if validation_data is not None and validation_metrics:
                    self._validate(validation_data, batch_size,
                                   validation_metrics)
            # fit returning means the newest checkpoint is durable
            self._drain_checkpoints()
        except _GracefulStop:
            self._sync()
            _SIGTERM_EXITS.inc()
            if cfg.checkpoint_dir:
                self._save(cfg.checkpoint_dir, durable=True,
                           raise_drain_errors=False)
                logger.warning("SIGTERM: final checkpoint saved at iter %d; "
                               "exiting", self.trainer_state.iteration)
            raise SystemExit(143)
        finally:
            if handler_installed:
                signal.signal(signal.SIGTERM, prev_handler)
            self._drain_checkpoints(raise_errors=False)
            self.model.eval()
        self._sync()
        return self

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _validate(self, data, batch_size: int, metrics) -> Dict[str, float]:
        """Evaluate after an epoch, in inference mode; the first metric is
        the score triggers read."""
        self.model.eval()
        try:
            results = self.evaluate(data, batch_size=batch_size,
                                    metrics=metrics)
        finally:
            self.model.train()
        ts = self.trainer_state
        ts.last_score = next(iter(results.values()))
        if self.val_summary:
            self.val_summary.add_scalars(ts.iteration, results)
        logger.info("epoch %d validation: %s", ts.epoch, results)
        return results

    def set_tensorboard(self, log_dir: str, app_name: str) -> "Estimator":
        """Train and validation summaries under ``log_dir/app_name``."""
        self.train_summary = TrainSummary(log_dir, app_name)
        self.val_summary = ValidationSummary(log_dir, app_name)
        return self

    # ------------------------------------------------------------ checkpoints
    def _sharded_state(self) -> bool:
        return bool(self._specs) or self._update_mode() is not None

    def checkpoint_state(self) -> Dict[str, Any]:
        """The train state as the JAX package's tree over the live tensors
        (``bridge.train_state_to_jax``): what a checkpoint holds. With
        sharded leaves or a sharded optimizer state every rank must call
        it: their blocks are gathered."""
        if self.train_state is None:
            self._init_state()
        if not self._sharded_state():
            return bridge.train_state_to_jax(self.model, self.train_state)
        ts = self.train_state
        mode = self._update_mode()
        if mode == "flat":
            opt = bridge.flat_opt_state_to_jax(
                ts["opt_state"], lambda t: comm.all_gather(
                    t, "dp", dim=0, tiled=True, mesh=self.mesh))
        else:
            opt = bridge.opt_state_to_jax(bridge.map_param_dicts(
                ts["opt_state"], lambda n, t: self._full(
                    n, t, self._upd_dims.get(n))))
        return bridge.train_state_to_jax(
            self.model, {**ts, "opt_state": opt},
            params={n: self._full(n, p.detach())
                    for n, p in self.model.named_parameters()},
            opt_is_jax=True)

    def _restore(self, path: str) -> Dict[str, Any]:
        """Load a checkpoint (written by either package) into the model and
        the optimizer state, and its iteration and epoch into the loop;
        each rank keeps its blocks of sharded leaves and state."""
        restored, meta = ckpt.load_checkpoint(path, self.checkpoint_state())
        if not self._sharded_state():
            self.train_state = bridge.train_state_from_jax(
                self.model, restored, self.train_state)
        else:
            ts = self.train_state
            if self._update_mode() == "flat":
                sh = self._flat_meta.shard_size
                i = self._dp_axis().index
                opt_tree = restored["opt_state"]
                opt = bridge.flat_opt_state_from_jax(
                    opt_tree, ts["opt_state"],
                    lambda t: t[i * sh:(i + 1) * sh].clone())
                restored = {**restored, "opt_state": None}
            state = bridge.train_state_from_jax(
                self.model, restored, {**ts, "opt_state": None},
                block=self._block)
            if self._update_mode() != "flat":
                full = bridge.opt_state_from_jax(restored["opt_state"],
                                                 ts["opt_state"])
                opt = bridge.map_param_dicts(full, lambda n, t: self._block(
                    n, t, self._upd_dims.get(n)))
            self.train_state = {**state, "opt_state": opt}
        self.trainer_state.iteration = meta["iteration"]
        self.trainer_state.epoch = meta["epoch"]
        return meta

    def _save(self, directory: str, durable: bool = False,
              raise_drain_errors: bool = True) -> str:
        """A trigger save (``durable=False``) returns after the snapshot and
        writes on the writer thread when ``async_checkpoint``; a durable
        save (epoch ends, SIGTERM) drains the writer and writes before it
        returns. ``raise_drain_errors=False`` forfeits an earlier failed
        async write instead of raising it. Only process 0 writes (it
        returns ``None`` elsewhere)."""
        state = self.checkpoint_state() if self._sharded_state() else None
        if getattr(_context(), "process_index", 0) != 0:
            return None
        _CHECKPOINTS.inc()
        writer = None
        if self.config.async_checkpoint and not durable:
            if self._ckpt_writer is None:
                self._ckpt_writer = ckpt.CheckpointWriter()
            writer = self._ckpt_writer
        else:
            self._drain_checkpoints(raise_errors=raise_drain_errors)
        return ckpt.save_checkpoint(directory, state or
                                    self.checkpoint_state(),
                                    iteration=self.trainer_state.iteration,
                                    epoch=self.trainer_state.epoch,
                                    writer=writer)

    def _drain_checkpoints(self, raise_errors: bool = True) -> None:
        """Block until the async write in flight is durable; with
        ``raise_errors=False`` a failed write is logged and forfeited."""
        w = self._ckpt_writer
        if w is None:
            return
        try:
            w.drain()
        except BaseException:
            if raise_errors:
                raise
            logger.exception("async checkpoint write failed; continuing "
                             "with the last durable snapshot")

    def _check_interrupt(self) -> None:
        """SIGTERM lands between steps, never inside one."""
        if self._sigterm:
            raise _GracefulStop()

    @staticmethod
    def _trigger_crossed(trigger: Trigger, ts: TrainerState,
                         block: int) -> bool:
        """Block-granular trigger test: after a block of ``block`` steps an
        interval trigger fires if the block crossed one of its multiples."""
        if isinstance(trigger, SeveralIteration):
            return (ts.iteration // trigger.interval
                    > (ts.iteration - block) // trigger.interval)
        return trigger(ts)

    def _maybe_save(self, trigger: Optional[Trigger],
                    block: Optional[int] = None) -> None:
        """A mid-epoch save where ``trigger`` fires (after a block of the
        cached path: where it was crossed)."""
        d = self.config.checkpoint_dir
        if trigger is None or not d:
            return
        ts = self.trainer_state
        if (trigger(ts) if block is None
                else self._trigger_crossed(trigger, ts, block)):
            self._save(d)

    def _log_point(self, loss, gnorm, t0: float, seen: int, win_t0: float,
                   win_steps: int, win_data: float) -> None:
        """One history record (and train-summary event): the loss and
        gradient norm (this syncs), the epoch's records per second so far,
        and the window's per-step data and compute milliseconds (observed
        in ``zoo_train_grad_norm`` and ``zoo_train_compute_seconds``)."""
        ts = self.trainer_state
        loss_val, gnorm_val = float(loss), float(gnorm)
        _GRAD_NORM.observe(gnorm_val)
        self._observe_comm()
        ts.last_loss = loss_val
        now = time.perf_counter()
        rec = {"epoch": ts.epoch, "iteration": ts.iteration,
               "loss": loss_val, "grad_norm": gnorm_val,
               "data_ms": win_data / win_steps * 1e3,
               "compute_ms": max(0.0, now - win_t0 - win_data)
               / win_steps * 1e3}
        _COMPUTE.observe(rec["compute_ms"] / 1e3)
        _mw.sample("estimator.step", self._witness_tensors)
        self.history.append(rec)
        if self.train_summary:
            self.train_summary.add_scalars(ts.iteration, {
                "Loss": loss_val, "Throughput": seen / max(now - t0, 1e-9),
                "GradNorm": gnorm_val, "DataWaitMs": rec["data_ms"],
                "ComputeMs": rec["compute_ms"]})
        logger.info("epoch %d iter %d loss %.4f gnorm %.3f (data %.2fms "
                    "compute %.2fms /step)", ts.epoch, ts.iteration,
                    loss_val, gnorm_val, rec["data_ms"], rec["compute_ms"])

    def _observe_comm(self) -> None:
        """Feed ``zoo_train_comm_seconds``: one param-sized exchange round
        on the dp axis (psum, or reduce-scatter + all-gather under update
        sharding), timed off the step."""
        if self._dp_axis() is None:
            return
        if self._comm_probe is None:
            # the whole params' size, as JAX's probe counts the global tree
            n = sum(math.prod(self._whole_shape(name, p))
                    for name, p in self._params().items())
            self._comm_probe = upd.make_comm_probe(
                n, sharded=self._update_mode() is not None, mesh=self.mesh,
                device=self.device)
        fn, vec = self._comm_probe
        t0 = time.perf_counter()
        fn(vec)
        _COMM.observe(time.perf_counter() - t0)

    def _finish_epoch(self, t0: float, seen: int, loss, batch_size: int,
                      data_wait_s: float = 0.0,
                      compile_s: float = 0.0) -> None:
        """The epoch's summary event, its counters, then a durable save."""
        ts = self.trainer_state
        if loss is not None:
            ts.last_loss = loss                # lazy: read on demand
            if self.train_summary:
                steps = max(1, seen // batch_size)
                dt = time.perf_counter() - t0
                self.train_summary.add_scalars(ts.iteration, {
                    "Loss": ts.last_loss, "Throughput": seen / max(dt, 1e-9),
                    "DataWaitMs": data_wait_s / steps * 1e3,
                    "ComputeMs": max(0.0, dt - data_wait_s - compile_s)
                    / steps * 1e3})
        ts.epoch += 1
        ts.records_processed += seen
        # an epoch boundary is a witness point even when the epoch is
        # shorter than log_every_n_steps
        _mw.sample("estimator.step", self._witness_tensors)
        if self.config.checkpoint_dir:
            self._save(self.config.checkpoint_dir, durable=True)
        if self.train_summary:
            self.train_summary.flush()

    def _run_epoch(self, train_set: FeatureSet, batch_size: int,
                   checkpoint_trigger: Optional[Trigger] = None) -> None:
        cfg = self.config
        ts = self.trainer_state
        self._batches_local = train_set.host_shard
        if train_set.host_shard:
            dp = self._dp_axis()
            if (dp.size if dp else 1) != train_set.process_count:
                raise ValueError(
                    f"a host-sharded FeatureSet of {train_set.process_count} "
                    f"processes needs a dp axis of that size (mesh "
                    f"{getattr(self.mesh, 'shape', None)})")
        seen = 0
        loss = None
        t0 = time.perf_counter()
        win_t0, win_steps, win_data, epoch_data = t0, 0, 0.0, 0.0
        epoch_compile = 0.0
        with self._device_batches(train_set, batch_size, epoch=ts.epoch,
                                  shuffle=cfg.shuffle) as it:
            while True:
                td = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    break
                dw = time.perf_counter() - td
                win_data += dw
                epoch_data += dw
                _DATA_WAIT.observe(dw)
                self._check_interrupt()
                chaos_point("estimator.step")
                key = _batch_signature(batch)
                t_step = time.perf_counter()
                loss, gnorm = self._step(batch)
                if key not in self._step_shapes:
                    compile_s = self._first_dispatch(key, self._step_shapes,
                                                     t_step)
                    epoch_compile += compile_s
                    win_t0 += compile_s
                _STEPS.inc()
                self.last_grad_norm = gnorm
                ts.iteration += 1
                win_steps += 1
                seen += batch_size
                if ts.iteration % cfg.log_every_n_steps == 0:
                    self._log_point(loss, gnorm, t0, seen, win_t0,
                                    win_steps, win_data)
                    win_t0, win_steps, win_data = time.perf_counter(), 0, 0.0
                self._maybe_save(checkpoint_trigger)
        self._finish_epoch(t0, seen, loss, batch_size, epoch_data,
                           epoch_compile)

    def _first_dispatch(self, key, seen_keys: set, t_start: float) -> float:
        """A new batch signature's first step (where the JAX package
        compiles): wait for the device, then count it and time it in
        ``zoo_train_compiles_total``/``zoo_train_compile_seconds``; a
        streamed step's signature also feeds the recompilation-hazard
        tracker."""
        self._sync()
        seen_keys.add(key)
        if seen_keys is self._step_shapes:
            self._note_step_signature(key)
        compile_s = time.perf_counter() - t_start
        _COMPILES.inc()
        _COMPILE_TIME.observe(compile_s)
        return compile_s

    def _note_step_signature(self, key) -> None:
        """Feed a new step signature to the ``recompile-hazard`` tracker: a
        train step meeting more than a handful of distinct batch shapes
        (unbucketed ragged batches, drifting dtypes) flags once."""
        if self._recompile_tracker is None:
            from ..analysis.graphlint import SignatureTracker

            self._recompile_tracker = SignatureTracker("estimator.step",
                                                       max_distinct=4)
        self._recompile_tracker.add(key)

    def _witness_tensors(self):
        """What training holds on the device: the parameters and the
        optimizer state (the memory witness's CPU reading)."""
        ts = self.train_state or {}
        return [list(self.model.parameters()),
                list(self.model.buffers()), ts.get("opt_state")]

    def _run_graph_checks(self, train_set: FeatureSet,
                          batch_size: int) -> None:
        """Record one step on the first batch (nothing runs: fake tensors,
        no kernel launches) and run the trace rules on it per
        ``TrainConfig.graph_checks``.

        Expectations come from the config: the flat update-sharding path
        has exactly one reduce-scatter + one all-gather per global step
        and none inside the accumulation loop; a declared bf16 policy must
        reach the matmuls; no host read of a device value and no large
        host array may ride the step. The memory tier rides the same
        trace: the parameters are replaced every step, so a step that
        does not write them in place (``donate_state=False``) is
        ``donation-missed``; a declared ``hbm_budget_mb`` bounds the
        static peak; outsized temporaries warn. The parameters, optimizer
        state, step count and key are left as they were."""
        from ..analysis import (RuleContext, enforce, lint_trace,
                                profile_trace, trace_call)
        from ..analysis.rules.memory import lint_memory

        cfg = self.config
        self._batches_local = train_set.host_shard
        host = next(iter(train_set.batches(batch_size, epoch=0,
                                           shuffle=False)))
        batch = self._to_device(host)
        saved = self.train_state

        def step(opt_state, batch):
            self.train_state = {**saved, "opt_state": opt_state}
            return self._step(batch)

        def installed():
            return ([p.detach() for p in self._params().values()],
                    self.train_state["opt_state"])

        try:
            trace = trace_call(step, saved["opt_state"], batch,
                               modules=[self.model], outputs=installed)
        finally:
            self.train_state = saved
        trainable = {f"param:{n}" for n in self._params()}
        budget = (int(cfg.hbm_budget_mb * 2 ** 20)
                  if cfg.hbm_budget_mb else None)
        ctx = RuleContext(
            where="estimator.fit",
            expect_collectives=({"reduce-scatter": 1, "all-gather": 1}
                                if self._update_mode() == "flat" else None),
            compute_dtype=cfg.compute_dtype, hbm_budget_bytes=budget,
            dead_invars=[a.name in trainable for a in trace.args])
        findings = lint_trace(trace, ctx=ctx,
                              rules=["collective-budget", "host-transfer",
                                     "large-constant", "dtype-discipline"])
        findings += lint_memory(trace, ctx=ctx)
        if _mw.enabled():
            _mw.note_static("estimator.step",
                            profile_trace(trace).peak_live_bytes, budget)
        enforce(findings, cfg.graph_checks, logger)

    def _device_batches(self, data: FeatureSet, batch_size: int, **kw):
        """``data.batches(batch_size, **kw)`` on the device through
        ``device_prefetch`` at ``prefetch_depth``, as a context manager:
        the epoch's end, a step's exception and the SIGTERM unwind all
        close the loader, so its producer thread never outlives the
        loop."""
        return contextlib.closing(device_prefetch(
            data.batches(batch_size, **kw), self.device,
            depth=self.config.prefetch_depth))

    def _cache_dataset(self, train_set: FeatureSet) -> None:
        """Put the dataset on the card once, keyed on its arrays (strong
        references, so a new dataset can never alias an old id)."""
        leaves = _tree_leaves(train_set.data)
        key = self._device_data_key
        if key is None or len(key) != len(leaves) or any(
                a is not b for a, b in zip(key, leaves)):
            self._device_data = self._to_device(train_set.data)
            self._device_data_key = leaves

    def epoch_order(self, train_set: FeatureSet, epoch: int) -> torch.Tensor:
        """The device-cached epoch's example order on the card:
        ``jax.random.permutation(PRNGKey(seed + epoch * 1_000_003), n)``
        (``arange(n)`` without shuffling)."""
        n = len(train_set)
        if not self.config.shuffle:
            return torch.arange(n, device=self.device)
        return prng.permutation(
            prng.PRNGKey(train_set.seed + epoch * 1_000_003), n,
            device=self.device)

    def _run_epoch_cached(self, train_set: FeatureSet, batch_size: int,
                          checkpoint_trigger: Optional[Trigger] = None
                          ) -> None:
        """An epoch over the dataset on the card
        (``TrainConfig(cache_on_device=True)``): blocks of
        ``scan_block_steps`` steps, each batch gathered on the card by its
        indices; log points, interrupts, chaos points and checkpoint
        triggers at block granularity (a log point where a block crosses a
        multiple of ``log_every_n_steps`` counted from the epoch's start, a
        save where it crosses a multiple of an interval trigger's, as the
        JAX scan does); the steps that do not fill a block after the last
        block, one at a time."""
        cfg = self.config
        ts = self.trainer_state
        self._batches_local = False
        self._cache_dataset(train_set)
        data = self._device_data
        idx = self.epoch_order(train_set, ts.epoch)
        n_steps = len(train_set) // batch_size
        block = max(1, min(cfg.scan_block_steps, n_steps))
        n_blocks = n_steps // block
        seen = 0
        loss = None
        t0 = time.perf_counter()
        win_t0, win_steps = t0, 0
        epoch_compile = 0.0
        every = cfg.log_every_n_steps

        def take(s):
            sel = idx[s * batch_size:(s + 1) * batch_size]
            return _tree_map(lambda a: a.index_select(0, sel), data)

        for b in range(n_blocks):
            self._check_interrupt()
            chaos_point("estimator.step")
            t_blk = time.perf_counter()
            for s in range(b * block, (b + 1) * block):
                loss, gnorm = self._step(take(s))
            scan_key = (block, batch_size)
            if scan_key not in self._scan_shapes:
                compile_s = self._first_dispatch(scan_key, self._scan_shapes,
                                                 t_blk)
                epoch_compile += compile_s
                win_t0 += compile_s
            _STEPS.inc(block)
            self.last_grad_norm = gnorm
            win_steps += block
            ts.iteration += block
            seen += block * batch_size
            if every and (b + 1) * block >= every \
                    and ((b + 1) * block) // every > (b * block) // every:
                self._log_point(loss, gnorm, t0, seen, win_t0, win_steps,
                                0.0)
                win_t0, win_steps = time.perf_counter(), 0
            self._maybe_save(checkpoint_trigger, block)
        for s in range(n_blocks * block, n_steps):
            self._check_interrupt()
            chaos_point("estimator.step")
            batch = take(s)
            key = _batch_signature(batch)
            t_step = time.perf_counter()
            loss, self.last_grad_norm = self._step(batch)
            if key not in self._step_shapes:
                epoch_compile += self._first_dispatch(key, self._step_shapes,
                                                      t_step)
            _STEPS.inc()
            ts.iteration += 1
            seen += batch_size
            self._maybe_save(checkpoint_trigger)
        self._finish_epoch(t0, seen, loss, batch_size,
                           compile_s=epoch_compile)

    # --------------------------------------------------------------- evaluate
    def evaluate(self, data, batch_size: int = 256,
                 metrics: Sequence = ("accuracy",)) -> Dict[str, float]:
        """Streaming metrics over ``data`` (a FeatureSet or an (x, y)
        pair) in order, in batches of ``batch_size`` (the last one
        partial), the model in inference mode: ``{metric.name: value}``.
        The accumulators stay on the card; each result is read once. On a
        mesh every rank evaluates every batch (placed leaves gathered where
        read)."""
        eval_set = _as_featureset(data)
        if self.train_state is None:
            self._init_state()
        metric_objs = [get_metric(m) for m in metrics]
        accs = [m.init(device=self.device) for m in metric_objs]
        with torch.no_grad(), self._policy(), self._gathering(), \
                self._device_batches(eval_set, batch_size, shuffle=False,
                                     drop_remainder=False) as batches:
            for x, y in batches:
                y_hat = self.model.apply(x)
                accs = [m.update(a, y, y_hat)
                        for m, a in zip(metric_objs, accs)]
        return {m.name: m.result(a) for m, a in zip(metric_objs, accs)}

    # ---------------------------------------------------------------- predict
    def predict(self, x, batch_size: int = 256) -> np.ndarray:
        """The model's outputs over ``x`` in batches (the last one
        partial), as a numpy array; bf16 outputs come back as f32."""
        data = (x,) if not isinstance(x, (tuple, list)) else tuple(x)
        outs = []
        with torch.no_grad(), self._policy(), self._gathering(), \
                self._device_batches(FeatureSet(data), batch_size,
                                     shuffle=False,
                                     drop_remainder=False) as batches:
            for xb in batches:
                y = self.model.apply(xb[0] if len(xb) == 1 else list(xb))
                outs.append((y.float() if y.dtype == torch.bfloat16 else y)
                            .cpu().numpy())
        return np.concatenate(outs, axis=0)

    @property
    def params(self) -> Optional[Dict[str, torch.Tensor]]:
        return {n: p.detach() for n, p in self._params().items()}


def _batch_signature(batch) -> tuple:
    """Shapes and dtypes of a batch's leaves: the key the JAX step
    re-traces on."""
    return tuple((tuple(a.shape), str(a.dtype)) for a in _tree_leaves(batch))


def _tree_leading(tree) -> int:
    while isinstance(tree, (tuple, list, dict)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree.shape[0]


__all__ = ["Estimator"]
