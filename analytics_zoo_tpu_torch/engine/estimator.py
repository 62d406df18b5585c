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

Mixed precision (``TrainConfig(compute_dtype="bfloat16")``): the model's
parameters are cast to bf16 in place (the JAX ``cast_params``) and the f32
masters exist only in the optimizer state; each forward/backward runs
under the bf16 precision policy.

:meth:`Estimator.fit` walks :class:`~..data.featureset.FeatureSet`
epochs in the JAX order (the same seeded permutation; remainders
dropped) until the end trigger fires, and records the loss and the
pre-clip gradient norm at every ``log_every_n_steps``. Runs on CUDA unless
given ``device="cpu"`` (or a model that lives on the CPU); without CUDA
and without a device it raises.

Not ported yet (ROADMAP Queue 1): meshes and sharded updates, checkpoints
and retry from them, TensorBoard summaries, chaos hooks, device-cached
scan epochs, ``evaluate`` (it needs ``nn/metrics.py``) and validation.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..common.config import TrainConfig, check_ported
from ..common.triggers import MaxEpoch, Trigger, TrainerState
from ..data.featureset import FeatureSet, _tree_map
from ..nn.losses import get_loss
from ..nn.module import cast_params, precision_policy, resolve_device
from ..nn.optimizers import (apply_updates, get_optimizer, global_norm,
                             with_clipping)
from ..parallel.update_sharding import with_master_weights

logger = logging.getLogger("analytics_zoo_tpu_torch.estimator")

_ROADMAP = "ROADMAP Queue 1 (Estimator remainder)"


def _as_featureset(data) -> FeatureSet:
    if isinstance(data, FeatureSet):
        return data
    if isinstance(data, tuple) and len(data) == 2:
        return FeatureSet.from_numpy(data[0], data[1])
    raise TypeError(f"cannot build FeatureSet from {type(data)}")


def _model_device(model) -> Optional[torch.device]:
    dev = getattr(model, "device", None)
    if dev is not None:
        return torch.device(dev)
    first = next(iter(model.parameters()), None)
    return None if first is None else first.device


class Estimator:
    """Drives the training step of ``model`` (any module whose
    ``apply(x)`` returns the prediction) on one device."""

    def __init__(self, model, optimizer="adam", loss="mse", mesh=None,
                 config: Optional[TrainConfig] = None, param_sharding=None,
                 *, device=None):
        if mesh is not None or param_sharding is not None:
            raise NotImplementedError(
                "mesh / param_sharding: the port trains on one card "
                "(multi-GPU is ROADMAP Queue 1, item 9)")
        self.model = model
        self.loss_fn = get_loss(loss)
        self.config = check_ported(config or TrainConfig())
        self.device = resolve_device(device if device is not None
                                     else getattr(model, "device", None))
        have = _model_device(model)
        if have is not None and have.type != self.device.type:
            raise ValueError(f"the model's parameters live on {have}, the "
                             f"Estimator runs on {self.device}")
        self._base_tx = get_optimizer(optimizer)
        self.train_state: Optional[Dict[str, Any]] = None
        self.trainer_state = TrainerState()
        #: one entry per log point: epoch, iteration, loss, grad_norm and
        #: the window's per-step data/compute milliseconds
        self.history: List[Dict[str, float]] = []
        #: the last step's f32 pre-clip gradient norm (0-d tensor)
        self.last_grad_norm: Optional[torch.Tensor] = None
        self._rebuild_tx()

    def _rebuild_tx(self) -> "Estimator":
        """Clipping first, then the optimizer; under mixed precision the
        ``with_master_weights`` wrapper whose updates ARE the new
        low-precision params."""
        cfg = self.config
        self.tx = with_clipping(self._base_tx, cfg.gradient_clip_norm,
                                cfg.gradient_clip_value)
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

    def _params(self) -> Dict[str, torch.nn.Parameter]:
        return {n: p for n, p in self.model.named_parameters()
                if p.requires_grad}

    def _to_device(self, tree):
        def put(a):
            if isinstance(a, torch.Tensor):
                return a.to(self.device)
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        return _tree_map(put, tree)

    # ------------------------------------------------------------------ build
    def _init_state(self) -> None:
        """Optimizer state from the model's current weights. Under mixed
        precision the masters are taken in f32 first, then the model's
        copy is cast down."""
        values = {n: p.detach() for n, p in self._params().items()}
        opt_state = self.tx.init(values)
        if self._mp_dtype is not None:
            cast_params(self.model, self._mp_dtype)
        self.train_state = {"opt_state": opt_state, "step": 0}

    def _loss_of(self, x, y) -> torch.Tensor:
        return self.loss_fn(y, self.model.apply(x))

    def _grads(self, batch):
        """``(loss, grads)`` of one global batch, grads in the params'
        dtype (K = 1) or summed over K microbatches in f32 and divided by
        K once."""
        x, y = batch
        params = self._params()

        def one(xb, yb):
            for p in params.values():
                p.grad = None
            loss = self._loss_of(xb, yb)
            loss.backward()
            return loss.detach(), {
                n: p.grad if p.grad is not None else torch.zeros_like(p)
                for n, p in params.items()}

        k = max(1, int(self.config.grad_accum_steps))
        if k == 1:
            return one(x, y)
        m = _tree_leading(batch) // k
        acc = {n: torch.zeros_like(p, dtype=torch.float32)
               for n, p in params.items()}
        losses = []
        for i in range(k):
            part = _tree_map(lambda a: a[i * m:(i + 1) * m], (x, y))
            loss, g = one(*part)
            for n, a in acc.items():
                a.add_(g[n].float())
            losses.append(loss)
        return torch.stack(losses).mean(), {n: a / k for n, a in acc.items()}

    def _step(self, batch):
        """One optimizer step; returns ``(loss, grad_norm)`` as 0-d
        tensors (no host sync)."""
        with self._policy():
            loss, grads = self._grads(batch)
        params = self._params()
        g32 = {n: g.float() for n, g in grads.items()}
        for p in params.values():
            p.grad = None
        gnorm = global_norm(g32)
        values = {n: p.detach() for n, p in params.items()}
        updates, new_opt = self.tx.update(g32, self.train_state["opt_state"],
                                          values)
        new = updates if self._mp_dtype is not None else apply_updates(
            values, updates)
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(new[n])
        self.train_state = {"opt_state": new_opt,
                            "step": self.train_state["step"] + 1}
        return loss, gnorm

    # -------------------------------------------------------------------- fit
    def fit(self, data, batch_size: Optional[int] = None,
            epochs: Optional[int] = None,
            end_trigger: Optional[Trigger] = None, validation_data=None,
            validation_metrics=(), checkpoint_trigger=None, seed: int = 0):
        """Train until ``end_trigger`` (default ``MaxEpoch(epochs or
        config.max_epochs)``). ``data``: a FeatureSet or an (x, y) pair;
        ``batch_size`` is global. The weights are the model's own (drawn
        from its constructor's seed), so ``seed`` must stay 0."""
        cfg = check_ported(self.config)
        if validation_data is not None or validation_metrics \
                or checkpoint_trigger is not None:
            raise NotImplementedError(
                f"validation and checkpoint triggers need evaluate and "
                f"checkpoints ({_ROADMAP})")
        if seed:
            raise NotImplementedError(
                "fit(seed=...) re-draws the JAX model's weights; the port's "
                "model draws them at construction (TransformerLM(seed=...))")
        batch_size = batch_size or cfg.batch_size
        accum = max(1, int(cfg.grad_accum_steps))
        if batch_size % accum:
            raise ValueError(f"batch_size={batch_size} must divide by "
                             f"grad_accum_steps={accum}")
        train_set = _as_featureset(data)
        end_trigger = end_trigger or MaxEpoch(
            epochs if epochs is not None else cfg.max_epochs)
        if self.train_state is None:
            self._init_state()
        # training mode for the steps, as JAX's apply(training=True); a
        # layer whose training mode is not ported (BatchNormalization)
        # raises instead of silently running its inference form
        self.model.train()
        try:
            while not end_trigger(self.trainer_state):
                self._run_epoch(train_set, batch_size)
        finally:
            self.model.eval()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def _run_epoch(self, train_set: FeatureSet, batch_size: int) -> None:
        cfg = self.config
        ts = self.trainer_state
        seen = 0
        loss = None
        win_t0, win_steps, win_data = time.perf_counter(), 0, 0.0
        it = train_set.batches(batch_size, epoch=ts.epoch,
                               shuffle=cfg.shuffle)
        while True:
            td = time.perf_counter()
            try:
                batch = self._to_device(next(it))
            except StopIteration:
                break
            win_data += time.perf_counter() - td
            loss, gnorm = self._step(batch)
            self.last_grad_norm = gnorm
            ts.iteration += 1
            win_steps += 1
            seen += batch_size
            if ts.iteration % cfg.log_every_n_steps == 0:
                loss_val, gnorm_val = float(loss), float(gnorm)   # syncs
                ts.last_loss = loss_val
                now = time.perf_counter()
                rec = {"epoch": ts.epoch, "iteration": ts.iteration,
                       "loss": loss_val, "grad_norm": gnorm_val,
                       "data_ms": win_data / win_steps * 1e3,
                       "compute_ms": max(0.0, now - win_t0 - win_data)
                       / win_steps * 1e3}
                self.history.append(rec)
                logger.info("epoch %d iter %d loss %.4f gnorm %.3f (data "
                            "%.2fms compute %.2fms /step)", ts.epoch,
                            ts.iteration, loss_val, gnorm_val,
                            rec["data_ms"], rec["compute_ms"])
                win_t0, win_steps, win_data = time.perf_counter(), 0, 0.0
        if loss is not None:
            ts.last_loss = loss                # lazy: read on demand
        ts.epoch += 1
        ts.records_processed += seen

    # ---------------------------------------------------------------- predict
    def predict(self, x, batch_size: int = 256) -> np.ndarray:
        """The model's outputs over ``x`` in batches (the last one
        partial), as a numpy array; bf16 outputs come back as f32."""
        data = (x,) if not isinstance(x, (tuple, list)) else tuple(x)
        fs = FeatureSet(data)
        outs = []
        with torch.no_grad(), self._policy():
            for hb in fs.batches(batch_size, shuffle=False,
                                 drop_remainder=False):
                xb = hb[0] if len(hb) == 1 else list(hb)
                y = self.model.apply(self._to_device(xb))
                outs.append((y.float() if y.dtype == torch.bfloat16 else y)
                            .cpu().numpy())
        return np.concatenate(outs, axis=0)

    @property
    def params(self) -> Optional[Dict[str, torch.Tensor]]:
        return {n: p.detach() for n, p in self._params().items()}


def _tree_leading(tree) -> int:
    while isinstance(tree, (tuple, list, dict)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree.shape[0]


__all__ = ["Estimator"]
