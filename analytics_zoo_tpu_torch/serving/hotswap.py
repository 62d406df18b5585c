"""Model hot swap from published checkpoints (port of the serving half of
``analytics_zoo_tpu/serving/hotswap.py``).

* :class:`ModelPublisher` (training side) — hooked into
  :class:`~..engine.checkpoint.CheckpointWriter` via ``on_durable``: every
  durable checkpoint is announced on the broker stream ``model_updates`` as
  ``{version, step, path, signature, checksum}`` (all fields from the
  checkpoint's fsync'd manifest). ``check_rejections()`` reads the
  ``model_rejections`` stream, so the trainer sees a poisoned publish.

* :class:`ModelSwapper` (serving side) — stages a published checkpoint off
  the hot path: manifest and content-checksum verification, per-leaf
  shape/dtype and param-tree signature checks against the live model's
  load-time template, a NaN/Inf scan, a probe forward on the staged
  weights; then flips them in between dispatch waves
  (:meth:`~..inference.inference_model.InferenceModel.swap_params` holds
  every concurrency slot for the flip), so no request sees mixed weights.
  The pre-swap params are kept on the host for :meth:`~ModelSwapper.rollback`.

Where the JAX swapper rebuilds the tree with ``tree_unflatten(load_treedef,
leaves)``, the port maps the checkpoint's leaves onto
``InferenceModel.load_names``, which lists the model's parameters in the
JAX tree's flatten order. The staged tree crosses to the card once, float
or int8: ``InferenceModel.stage_params`` re-packs a quantized model on the
host and copies the result on a side stream (``bridge.stage_tensors``;
staging from pinned memory measured slower under load,
``scripts/torch_serving_ab.py --phase int8_swap``), ``probe_staged`` runs
the probe on those device tensors, and ``swap_params`` flips the same
tensors in by reference. The JAX swapper's ``spec`` hand-over (a
speculative ``ContinuousBatcher`` as the swap target) is left out: the
port's swapper serves an ``InferenceModel``. Row deltas are read by
``engine/checkpoint.read_row_delta`` and patched in by
``apply_row_delta``. Rejections carry the JAX swapper's reasons and
messages.

Not ported here: the fleet-level ``RolloutController`` (canary rollout,
automatic rollback, the reconciler) and the ``model:rollout`` key; they come
with the replica fleet (ROADMAP Queue 1, item 8's next slice).

Broker keys::

    model_updates          publisher XADDs (one record per durable ckpt)
    model_rejections       XADDs of rejected versions
    model:current          promoted-version record (the fleet's target)
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common import telemetry as _tm
from ..common.chaos import chaos_point
from ..common.resilience import RetryPolicy
from ..engine.checkpoint import (CheckpointCorruptError, RowDeltaRejected,
                                 _from_host, _stored_dtype_name,
                                 param_tree_signature, read_manifest,
                                 read_row_delta, verify_checkpoint)
from ..observability import events as _ev
from .client import _Conn

logger = logging.getLogger("analytics_zoo_tpu_torch.serving.hotswap")

MODEL_STREAM = "model_updates"
MODEL_REJECT_STREAM = "model_rejections"
MODEL_CURRENT_KEY = "model:current"

# the JAX package's families (the rollout ones come with the fleet)
_PUBLISHED = _tm.counter("zoo_swap_published_total",
                         "Checkpoint versions announced on the publisher "
                         "stream, by outcome", labels=("outcome",))
_SWAPS = _tm.counter("zoo_swap_total",
                     "Model hot-swap attempts, by outcome "
                     "(ok / rejected / failed / stale)", labels=("outcome",))
_SWAP_REJECTS = _tm.counter(
    "zoo_swap_validation_failures_total",
    "Hot-swap stagings rejected before touching live params, by reason",
    labels=("reason",))
_STAGE_TIME = _tm.histogram(
    "zoo_swap_stage_seconds",
    "Off-hot-path staging time (load + checksum + validation + warmup) per "
    "swap attempt",
    buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30))


class SwapRejected(Exception):
    """A published checkpoint failed swap-side validation; the live model is
    untouched. ``reason`` is one of checksum/signature/shape/nan/io/
    warmup/unsupported/base — the label on
    ``zoo_swap_validation_failures_total``. ``base`` is row-delta specific:
    the delta's base version is not what the replica is serving, so the
    patch cannot be applied (the forced reconcile path converges through
    the base checkpoint instead)."""

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


class _StagedRowDelta:
    """Validated row-delta publish, ready for the in-place flip.

    ``entries`` is ``[(leaf_index, idx, rows)]`` in the live model's params
    flatten order: ``idx=None`` marks a whole-leaf replacement, otherwise
    ``rows[i]`` lands at row ``idx[i]``. Everything here already passed the
    manifest/shape/NaN gauntlet — the swap step only scatters and flips."""

    __slots__ = ("entries", "base_version", "rows_touched", "nbytes")

    def __init__(self, entries: List[Tuple[int, Optional[np.ndarray],
                                           np.ndarray]],
                 base_version: str, rows_touched: int, nbytes: int):
        self.entries = entries
        self.base_version = base_version
        self.rows_touched = rows_touched
        self.nbytes = nbytes


def _conn_policy() -> RetryPolicy:
    return RetryPolicy(max_attempts=None, base_delay_s=0.05, max_delay_s=0.5,
                       attempt_timeout_s=5.0,
                       retryable=(ConnectionError, OSError))


def publish_record(path: str, manifest: Optional[Dict] = None) -> Dict:
    """Build the stream record for a durable checkpoint from its manifest."""
    manifest = manifest or read_manifest(path)
    if manifest is None:
        raise ValueError(f"{path} has no manifest.json — only "
                         "manifest-carrying checkpoints can be published")
    record = {"version": manifest["version"],
              "step": int(manifest["iteration"]),
              "path": path,
              "signature": manifest["signature"],
              "checksum": manifest["checksum"],
              "n_leaves": int(manifest["n_leaves"]),
              "ts": time.time()}
    rd = manifest.get("row_delta")
    if rd:
        # replicas already on base_version apply the delta in place; a
        # replica on anything else (respawned, late-joining) force-converges
        # through base_path first — both facts ride the stream record
        record["delta"] = True
        record["base_version"] = rd.get("base_version")
        record["base_path"] = rd.get("base_path")
        record["rows_touched"] = int(rd.get("rows_touched", 0))
        record["delta_bytes"] = int(manifest.get("state_bytes", 0))
    return record


class ModelPublisher:
    """Training-side announcer: one durable checkpoint → one stream record.

    Designed to be handed to :class:`~..engine.checkpoint.CheckpointWriter`
    as its ``on_durable`` hook; the callback
    runs on the writer thread, and the underlying connection serializes
    calls, so concurrent saves cannot interleave publishes. A publish
    failure is logged + counted, never raised into the checkpoint path —
    the checkpoint itself is already durable.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 6380, *,
                 stream: str = MODEL_STREAM,
                 reject_stream: str = MODEL_REJECT_STREAM):
        self.stream = stream
        self.reject_stream = reject_stream
        self._conn = _Conn(host, port, policy=_conn_policy(),
                           tag="model.publisher")
        self._reject_cursor = 0
        self.published: List[Dict] = []
        self.rejections: List[Dict] = []

    def on_durable(self, path: str, manifest: Dict) -> Optional[Dict]:
        """CheckpointWriter hook: announce ``path`` on the publish stream."""
        try:
            record = publish_record(path, manifest)
            self._conn.call("XADD", self.stream, record)
        except Exception:
            _PUBLISHED.labels(outcome="error").inc()
            logger.exception("model publish failed for %s", path)
            return None
        _PUBLISHED.labels(outcome="ok").inc()
        self.published.append(record)
        logger.info("published model %s (step %d) from %s",
                    record["version"], record["step"], path)
        return record

    def publish(self, path: str) -> Optional[Dict]:
        """Directly announce an on-disk checkpoint (reads its manifest)."""
        return self.on_durable(path, read_manifest(path))

    def check_rejections(self, block_ms: int = 0) -> List[Dict]:
        """New rejection records since the last call (cursor-read on the
        rejection stream) — how the trainer learns a publish was poisoned
        or rolled back instead of deployed."""
        cursor, entries = self._conn.call("XREAD", self.reject_stream,
                                          self._reject_cursor, 64, block_ms)
        self._reject_cursor = cursor
        new = [payload for _id, payload in entries]
        self.rejections.extend(new)
        return new

    def close(self):
        self._conn.close()


# ---------------------------------------------------------------------------
# serving-side staging + swap
# ---------------------------------------------------------------------------

class ModelSwapper:
    """Stages a published checkpoint and swaps it into a live
    :class:`~..inference.inference_model.InferenceModel` without dropping
    requests.

    ``stage`` does every expensive/validating step off the hot path and
    raises :class:`SwapRejected` before live params are touched; ``swap``
    is the short atomic flip (the model holds all concurrency slots for it,
    so it lands between dispatch waves). The pre-swap host params are
    retained for :meth:`rollback`. ``timings`` keeps the last swap's
    ``stage_ms``, ``probe_ms`` and ``flip_ms``.
    """

    def __init__(self, model, *, warmup: bool = True,
                 probe_shape: Optional[Tuple[int, ...]] = None):
        self.model = model
        self.warmup = warmup
        self.probe_shape = probe_shape
        # (version, host params) retained across swaps for rollback
        self.prev: Optional[Tuple[Optional[str], Any]] = None
        self.current_step: Optional[int] = None
        self.timings: Dict[str, float] = {}

    def supported(self) -> bool:
        """Only a model that recorded a load-time template (``load``) can
        validate a checkpoint's flat leaves and name them."""
        return getattr(self.model, "load_names", None) is not None

    # -- staging (off the hot path) ------------------------------------------

    def stage(self, record: Dict) -> Any:
        """Load + validate the published checkpoint; returns the staged
        params ready for :meth:`swap`. Raises :class:`SwapRejected` (reason
        tagged) on any validation failure — the live model is untouched."""
        t0 = time.perf_counter()
        try:
            return self._stage(record)
        finally:
            _STAGE_TIME.observe(time.perf_counter() - t0)
            self.timings["stage_ms"] = (time.perf_counter() - t0) * 1e3

    def _stage(self, record: Dict) -> Any:
        if not self.supported():
            raise SwapRejected("unsupported",
                               "model has no load-time template (use "
                               "InferenceModel.load)")
        path = record.get("path")
        if not path:
            raise SwapRejected("io", f"swap record has no path: {record}")
        try:
            manifest = verify_checkpoint(path)
        except CheckpointCorruptError as e:
            raise SwapRejected("checksum", str(e))
        except OSError as e:
            raise SwapRejected("io", f"cannot read checkpoint {path}: {e}")
        if manifest is None:
            raise SwapRejected("io", f"{path} has no manifest sidecar")
        if record.get("checksum") and \
                record["checksum"] != manifest["checksum"]:
            raise SwapRejected(
                "checksum",
                f"published checksum {record['checksum'][:12]}… does not "
                f"match on-disk manifest {manifest['checksum'][:12]}… — "
                "stale or tampered record")
        # deterministic chaos site BETWEEN validation and the load: a drill
        # killing the swapper here models replica death mid-swap
        chaos_point("swap.stage")
        if manifest.get("row_delta"):
            return self._stage_delta(record, manifest, path)
        try:
            data = np.load(os.path.join(path, "state.npz"))
        except Exception as e:
            raise SwapRejected("io", f"cannot deserialize {path}: {e}")
        avals = self.model.load_avals
        indices = self._select_param_leaves(manifest, len(avals))
        leaves = []
        for i, (shape, dtype) in zip(indices, avals):
            raw = data[f"leaf_{i}"]
            # npz holds bf16 as raw 2-byte voids; the live template names
            # the real dtype (load_checkpoint parity)
            got = _stored_dtype_name(raw)
            if tuple(raw.shape) != tuple(shape) or got != dtype:
                raise SwapRejected(
                    "shape", f"leaf {i}: checkpoint {raw.shape}/{got} "
                    f"vs live executable {tuple(shape)}/{dtype}")
            leaves.append(_from_host(raw, torch.empty(0)))
        sig = param_tree_signature(leaves)
        if sig != self.model.load_signature:
            raise SwapRejected(
                "signature", f"param-tree signature {sig} does not match "
                f"live model {self.model.load_signature}")
        for i, l in enumerate(leaves):
            if l.is_floating_point() and \
                    not bool(torch.isfinite(l.float()).all()):
                raise SwapRejected(
                    "nan", f"leaf {i} contains NaN/Inf values — poisoned "
                    "checkpoint")
        staged = self.model.stage_params(dict(zip(self.model.load_names,
                                                  leaves)))
        if self.warmup:
            t0 = time.perf_counter()
            self._probe(staged)
            self.timings["probe_ms"] = (time.perf_counter() - t0) * 1e3
        return staged

    def _stage_delta(self, record: Dict, manifest: Dict,
                     path: str) -> "_StagedRowDelta":
        """Validate an incremental row-delta publish against the LIVE model
        (``engine/checkpoint.read_row_delta``: per-shard checksums, shapes,
        NaN scan). The base check is first and has its own reason
        (``base``), so a forced reconcile can tell "needs the base first"
        from a poisoned publish."""
        rd = manifest["row_delta"]
        live = getattr(self.model, "version", None)
        base = rd.get("base_version")
        if live != base:
            raise SwapRejected(
                "base", f"row delta {manifest['version']} applies on top of "
                f"{base}, but this replica serves {live or 'boot params'}")
        if getattr(self.model, "apply_row_delta", None) is None \
                or getattr(self.model, "is_quantized", False):
            raise SwapRejected("unsupported",
                               "model cannot apply row deltas in place")
        try:
            entries, _ = read_row_delta(path, self.model.load_avals)
        except RowDeltaRejected as e:
            raise SwapRejected(e.reason, str(e))
        except OSError as e:
            raise SwapRejected("io", f"cannot deserialize {path}: {e}")
        nbytes = sum(int(rows.numel()) * rows.element_size()
                     for _, _, rows in entries)
        return _StagedRowDelta(entries, base, int(rd.get("rows_touched", 0)),
                               nbytes)

    def _select_param_leaves(self, manifest: Dict, n_model: int) -> List[int]:
        """Which checkpoint leaves are the MODEL PARAMS. A serving snapshot
        is the params tree itself (leaf count matches). A trainer snapshot
        is the whole train state; its manifest's per-leaf tree paths select
        exactly the ``params`` subtree (its flatten order is the live
        model's template order). Only params swap."""
        n_ckpt = int(manifest["n_leaves"])
        if n_ckpt == n_model:
            return list(range(n_model))
        paths = manifest.get("leaf_paths") or []
        if len(paths) == n_ckpt:
            sel = [i for i, p in enumerate(paths)
                   if str(p).startswith("['params']")]
            if len(sel) == n_model:
                logger.info("staging the params subtree (%d of %d "
                            "train-state leaves)", n_model, n_ckpt)
                return sel
            if sel:
                raise SwapRejected(
                    "shape", f"checkpoint params subtree has {len(sel)} "
                    f"leaves, live model has {n_model}")
        raise SwapRejected(
            "shape", f"checkpoint has {n_ckpt} leaves, live model has "
            f"{n_model} (and no selectable 'params' subtree)")

    def _probe(self, staged) -> None:
        """Warmup forward on a probe batch with the STAGED params — a
        checkpoint that crashes or emits non-finite outputs is rejected
        before it can serve a single request. The outputs are checked on
        the device and only the verdict crosses to the host."""
        shape = self.probe_shape
        if shape is None:
            return
        x = np.zeros((1,) + tuple(int(d) for d in shape), np.float32)
        try:
            y = self.model.probe_staged(staged, x)
            outs = [t for t in (y if isinstance(y, (list, tuple)) else [y])
                    if isinstance(t, torch.Tensor)]
            finite = all(bool(torch.isfinite(t).all()) for t in outs
                         if t.is_floating_point())
        except SwapRejected:
            raise
        except Exception as e:
            raise SwapRejected("warmup", f"probe forward failed: {e!r}")
        if not finite:
            raise SwapRejected("warmup",
                               "probe forward produced NaN/Inf outputs")

    # -- the flip -------------------------------------------------------------

    def swap(self, params: Any, record: Dict) -> str:
        """Atomic reference flip of what :meth:`stage` returned (plus
        rollback retention). Returns the new version id."""
        if isinstance(params, _StagedRowDelta):
            return self._swap_delta(params, record)
        t0 = time.perf_counter()
        prev_version = getattr(self.model, "version", None)
        prev_params = self.model.host_params()
        self.model.swap_params(params, version=record["version"])
        self.prev = (prev_version, prev_params)
        self.current_step = int(record.get("step", 0))
        self.timings["flip_ms"] = (time.perf_counter() - t0) * 1e3
        return record["version"]

    def _swap_delta(self, staged: "_StagedRowDelta", record: Dict) -> str:
        """In-place incremental flip: only the touched rows move. Rollback
        retention is unchanged — the FULL pre-patch params are snapshotted
        host-side, so :meth:`rollback` undoes a bad delta exactly like a bad
        full swap."""
        prev_version = getattr(self.model, "version", None)
        prev_params = self.model.host_params()
        self.model.apply_row_delta(staged.entries, version=record["version"])
        self.prev = (prev_version, prev_params)
        self.current_step = int(record.get("step", 0))
        _ev.emit("swap.row_delta", version=str(record["version"]),
                 base=str(staged.base_version), rows=staged.rows_touched,
                 leaves=len(staged.entries), bytes=staged.nbytes)
        logger.info("applied row delta %s on top of %s (%d rows, %d leaves, "
                    "%d bytes)", record["version"], staged.base_version,
                    staged.rows_touched, len(staged.entries), staged.nbytes)
        return record["version"]

    def stage_and_swap(self, record: Dict, force: bool = False) -> str:
        """Full pipeline; ``force`` bypasses the stale-step guard (rollback
        commands re-apply an OLDER version on purpose). Duplicate or
        out-of-order publishes (step <= current) are skipped, not errors —
        at-least-once streams redeliver."""
        step = int(record.get("step", 0))
        if not force and self.current_step is not None \
                and step <= self.current_step:
            _SWAPS.labels(outcome="stale").inc()
            logger.info("ignoring stale/duplicate publish %s (step %d <= "
                        "current %d)", record.get("version"), step,
                        self.current_step)
            return getattr(self.model, "version", None) or "initial"
        try:
            params = self.stage(record)
        except SwapRejected as e:
            if e.reason == "base" and force and record.get("base_path"):
                # forced reconcile of a row-delta publish onto a replica
                # that isn't serving the delta's base (respawned on boot
                # params, joined late): full-swap the base checkpoint first,
                # then re-stage the delta on top — the zero-loss convergence
                # path for a replica killed mid-row-delta-rollout
                logger.info("replica serves %s, not delta base %s — "
                            "converging through base checkpoint %s",
                            getattr(self.model, "version", None),
                            record.get("base_version"), record["base_path"])
                params = self._stage_through_base(record)
            else:
                _SWAPS.labels(outcome="rejected").inc()
                _SWAP_REJECTS.labels(reason=e.reason).inc()
                raise
        version = self.swap(params, record)
        _SWAPS.labels(outcome="ok").inc()
        logger.info("hot-swapped model to %s (step %d)", version, step)
        return version

    def _stage_through_base(self, record: Dict) -> "_StagedRowDelta":
        """Swap in the delta's base checkpoint (full pipeline: verify,
        validate, probe, flip), then stage the delta against it. Any failure
        along the way is a rejection of the DELTA record — counted and
        raised like every other staging failure."""
        try:
            base_record = publish_record(record["base_path"])
            base_params = self.stage(base_record)
            self.swap(base_params, base_record)
            return self.stage(record)
        except SwapRejected as e:
            _SWAPS.labels(outcome="rejected").inc()
            _SWAP_REJECTS.labels(reason=e.reason).inc()
            raise
        except (OSError, ValueError) as e:
            _SWAPS.labels(outcome="rejected").inc()
            _SWAP_REJECTS.labels(reason="io").inc()
            raise SwapRejected("io", f"cannot converge through delta base "
                               f"{record.get('base_path')}: {e}")

    def rollback(self) -> Optional[str]:
        """Restore the retained pre-swap params (instant, no file needed —
        works even when the previous version was the boot state). Returns
        the restored version id, or None when there is nothing to restore."""
        if self.prev is None:
            return None
        version, params = self.prev
        cur_version = getattr(self.model, "version", None)
        cur_params = self.model.host_params()
        self.model.swap_params(params, version=version)
        self.prev = (cur_version, cur_params)
        self.current_step = None    # explicit rollback resets the ordering
        _SWAPS.labels(outcome="rollback").inc()
        logger.warning("rolled model back to %s", version or "boot params")
        return version or "initial"


__all__ = ["MODEL_CURRENT_KEY", "MODEL_REJECT_STREAM", "MODEL_STREAM",
           "ModelPublisher", "ModelSwapper", "SwapRejected", "publish_record"]
