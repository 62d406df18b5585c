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

* :class:`RolloutController` (fleet level, owned by the
  :class:`~.fleet.FleetSupervisor`; a copy of the JAX controller, which
  needs no JAX) — staged canary deployment: swap ONE replica, route
  ``rollout_canary_fraction`` of traffic to it via the
  :class:`~.fleet.ReplicaRouter`'s traffic-weight hook, compare its
  error-rate/latency telemetry against the stable cohort over a validation
  window, then promote fleet-wide or roll back automatically. Rollback also
  triggers on poisoned checkpoints (checksum mismatch, NaN/Inf params,
  validation-gate failure) and on a canary that dies mid-rollout; every
  rejection lands on the ``model_rejections`` stream. The idle-phase
  reconciler re-issues the current version to any replica whose heartbeat
  reports a different one — which is how a replica respawned mid-swap (or
  joining mid-rollout) converges on the *correct* version. Each replica
  stages through its own :class:`ModelSwapper`, so an int8 swap still
  crosses to the card once per replica.

Broker keys::

    model_updates          publisher XADDs (one record per durable ckpt)
    model_rejections       controller XADDs (rejected/rolled-back versions)
    model:current          promoted-version record (respawn/reconcile target)
    model:rollout          controller phase hash (fleet-status / cli info)
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common import telemetry as _tm
from ..common.chaos import chaos_point
from ..common.resilience import RetryAbortedError, RetryPolicy
from ..engine.checkpoint import (CheckpointCorruptError, RowDeltaRejected,
                                 _from_host, _stored_dtype_name,
                                 param_tree_signature, read_manifest,
                                 read_row_delta, verify_checkpoint)
from ..observability import events as _ev
from .client import _Conn
from .config import ServingConfig

logger = logging.getLogger("analytics_zoo_tpu_torch.serving.hotswap")

MODEL_STREAM = "model_updates"
MODEL_REJECT_STREAM = "model_rejections"
MODEL_CURRENT_KEY = "model:current"
ROLLOUT_KEY = "model:rollout"

# the JAX package's families
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
_ROLLOUTS = _tm.counter(
    "zoo_rollout_total",
    "Canary rollouts finished, by outcome (promoted / rolled_back / "
    "aborted / skipped)", labels=("outcome",))
_ROLLOUT_PHASES = _tm.counter(
    "zoo_rollout_phase_transitions_total",
    "Rollout state-machine phase entries", labels=("phase",))
_RECONCILES = _tm.counter(
    "zoo_rollout_reconcile_swaps_total",
    "Swap commands re-issued by the idle-phase reconciler (respawned or "
    "late-joining replica converging on the current version)")


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


# ---------------------------------------------------------------------------
# fleet-level canary rollout
# ---------------------------------------------------------------------------

class RolloutController:
    """Staged canary deployment over a replica fleet.

    Consumes the publisher stream, drives per-replica swap commands through
    the fleet control hashes (so thread- and process-mode replicas take the
    same path), weights canary traffic via the router hook, and promotes or
    rolls back on the canary's error/latency telemetry. Owned and started by
    :class:`~.fleet.FleetSupervisor`; runs one rollout at a time.
    """

    PHASES = ("idle", "canary", "validating", "promoting", "rolling_back")

    def __init__(self, supervisor, config: Optional[ServingConfig] = None,
                 *, group: str = "rollout-ctl"):
        self.sup = supervisor
        self.config = config or supervisor.config
        self.group = group
        self.phase = "idle"
        self.target: Optional[Dict] = None     # record being rolled out
        self.current: Optional[Dict] = None    # last promoted record
        self.canary: Optional[str] = None
        self.outcomes: List[Tuple[str, str]] = []   # (version, outcome)
        self._swap_nonce = 0
        # (rid -> (version, generation)) of reconcile commands in flight
        self._reconciling: Dict[str, Tuple[str, int]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._conn: Optional[_Conn] = None
        self._state_published: Optional[Tuple] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "RolloutController":
        self._stop.clear()
        self._conn = _Conn(self.config.queue_host, self.config.queue_port,
                           policy=_conn_policy(), abort=self._stop.is_set,
                           tag="rollout.ctl")
        try:
            # group first (tail), THEN the catch-up peek: anything published
            # before the peek is covered by XLAST, anything after by the
            # group cursor — no gap, no replay of full history
            self._conn.call("XGROUPCREATE", MODEL_STREAM, self.group, "$")
            cur = self._conn.call("HGET", MODEL_CURRENT_KEY, 0)
            if isinstance(cur, dict) and cur.get("version"):
                self.current = cur
        except RetryAbortedError:
            pass
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="zoo-rollout-ctl")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    # -- introspection -------------------------------------------------------

    def state(self) -> Dict[str, Any]:
        return {"phase": self.phase,
                "current": (self.current or {}).get("version"),
                "target": (self.target or {}).get("version"),
                "canary": self.canary,
                "outcomes": list(self.outcomes[-8:])}

    def _set_phase(self, phase: str) -> None:
        if phase != self.phase:
            self.phase = phase
            _ROLLOUT_PHASES.labels(phase=phase).inc()
        self._publish_state()

    def _publish_state(self) -> None:
        st = self.state()
        key = (st["phase"], st["current"], st["target"], st["canary"])
        if key == self._state_published:
            return
        self._state_published = key
        try:
            self._conn.call("HSET", ROLLOUT_KEY, {**st, "ts": time.time()})
        except Exception:
            pass

    # -- main loop -----------------------------------------------------------

    def _loop(self):
        # catch-up: a version published while no controller was running
        pending: Optional[Dict] = None
        try:
            last = self._conn.call("XLAST", MODEL_STREAM)
            if last is not None:
                _id, rec = last
                cur_step = int((self.current or {}).get("step", -1))
                if isinstance(rec, dict) and int(rec.get("step", 0)) > cur_step:
                    pending = rec
        except RetryAbortedError:
            return
        except Exception:
            logger.exception("rollout: publish-stream catch-up failed")
        self._publish_state()
        while not self._stop.is_set():
            try:
                if pending is not None:
                    rec, pending = pending, None
                    self._rollout(rec)
                    continue
                entries = self._conn.call("XREADGROUP", MODEL_STREAM,
                                          self.group, 1, 200)
                if entries:
                    entry_id, rec = entries[0]
                    try:
                        if isinstance(rec, dict):
                            self._rollout(rec)
                    finally:
                        self._conn.call("XACK", MODEL_STREAM, self.group,
                                        [entry_id])
                else:
                    self._reconcile()
            except RetryAbortedError:
                break
            except Exception:
                logger.exception("rollout: controller iteration failed")
                self._stop.wait(0.2)

    # -- swap command plumbing -----------------------------------------------

    def _command_swap(self, rid: str, record: Dict,
                      force: bool = False) -> int:
        """Write a swap command into the replica's control hash (merged so a
        concurrent drain command is not clobbered); returns the nonce."""
        from .engine import FLEET_CTL_PREFIX

        self._swap_nonce += 1
        ctl = self._conn.call("HGET", FLEET_CTL_PREFIX + rid, 0)
        ctl = dict(ctl) if isinstance(ctl, dict) else {}
        ctl["swap"] = {**record, "force": bool(force),
                       "nonce": self._swap_nonce}
        self._conn.call("HSET", FLEET_CTL_PREFIX + rid, ctl)
        return self._swap_nonce

    def _slot(self, rid: str):
        # locked router accessor: a bare _slots read would race membership
        # churn (failover remove/respawn add) from the supervisor threads
        return self.sup.router.slot(rid)

    def _generation(self, rid: str) -> int:
        h = self.sup._handles.get(rid)
        return h.generation if h is not None else -1

    def _wait_swap(self, rid: str, version: str, gen: int, timeout_s: float,
                   nonce: Any = None) -> Tuple[bool, str]:
        """Wait for the replica's heartbeat to confirm ``version`` (ok) or
        report a swap error / die / get respawned (failed). ``nonce`` scopes
        the error to THIS command: a heartbeat still carrying the error of a
        previously rejected version (the replica hasn't polled the new
        command yet) must not fail a later good rollout."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline and not self._stop.is_set():
            slot = self._slot(rid)
            if slot is None:
                return False, "replica removed"
            if self._generation(rid) != gen:
                return False, "replica respawned mid-swap"
            if not slot.alive:
                return False, "replica died mid-swap"
            if slot.model_version == version:
                return True, "ok"
            err = slot.swap_error
            if err and (nonce is None or slot.swap_nonce == nonce):
                return False, err
            time.sleep(0.05)
        return False, f"swap not confirmed within {timeout_s}s"

    # -- the rollout state machine -------------------------------------------

    def _reject(self, record: Dict, reason: str, outcome: str) -> None:
        """Trip the publisher stream with a rejection record and count the
        rollout outcome — the trainer-visible 'this version did not ship'."""
        logger.warning("rollout: rejecting %s: %s",
                       record.get("version"), reason)
        try:
            self._conn.call("XADD", MODEL_REJECT_STREAM,
                            {"version": record.get("version"),
                             "step": record.get("step"),
                             "reason": reason, "outcome": outcome,
                             "ts": time.time()})
        except Exception:
            logger.exception("rollout: rejection record write failed")
        _ROLLOUTS.labels(outcome=outcome).inc()
        self.outcomes.append((str(record.get("version")), outcome))
        # decision event, trace-linked via the ambient rollout span — a
        # rollback on /debug/events resolves to the full rollout timeline
        _ev.emit("rollout.rejected", severity="warning",
                 version=str(record.get("version")), outcome=outcome,
                 reason=reason)

    def _cohort_snapshot(self, exclude: str) -> Dict[str, Tuple[int, int]]:
        """(served, errors) per stable-cohort replica."""
        out = {}
        for rid in self.sup.router.replica_ids():
            if rid == exclude:
                continue
            slot = self._slot(rid)
            if slot is not None and slot.alive:
                out[rid] = (slot.served, slot.errors)
        return out

    def _rollout(self, record: Dict) -> None:
        cfg = self.config
        version = str(record.get("version"))
        step = int(record.get("step", 0))
        cur_step = int((self.current or {}).get("step", -1))
        seen = {v for v, _ in self.outcomes}
        if step <= cur_step or version == (self.current or {}).get("version") \
                or version in seen:
            # duplicate or out-of-order publish (at-least-once stream):
            # skipped, not an error — and never re-deploys an older version
            _ROLLOUTS.labels(outcome="skipped").inc()
            logger.info("rollout: skipping %s (step %d <= current %d or "
                        "already decided)", version, step, cur_step)
            return
        chaos_point("rollout.phase", tag="start")
        self.target = record
        # one span covers the whole rollout (entered manually: the body
        # below returns from several phases); every decision event emitted
        # inside — rejection or promotion — inherits its trace id, so
        # /debug/events links straight to the rollout's Perfetto timeline
        rollout_span = _tm.span("rollout", version=version)
        rollout_span.__enter__()
        try:
            # ---- phase 1: canary swap -------------------------------------
            self._set_phase("canary")
            canary = None
            deadline = time.monotonic() + cfg.swap_timeout_s
            while canary is None and time.monotonic() < deadline \
                    and not self._stop.is_set():
                eligible = self.sup.router.eligible_ids()
                if eligible:
                    canary = eligible[0]
                else:
                    time.sleep(0.05)
            if canary is None:
                self._reject(record, "no eligible replica to canary",
                             "aborted")
                return
            self.canary = canary
            self._publish_state()
            gen = self._generation(canary)
            nonce = self._command_swap(canary, record)
            ok, why = self._wait_swap(canary, version, gen,
                                      cfg.swap_timeout_s, nonce=nonce)
            if not ok:
                # staging failed (poisoned checkpoint: checksum/NaN/shape →
                # "rolled_back") or the canary died mid-swap ("aborted").
                # Either way the stable cohort never saw the version; a dead
                # canary respawns on its boot params and the reconciler
                # converges it back to `current`.
                died = any(s in why for s in ("died", "respawned", "removed",
                                              "not confirmed"))
                self._reject(record, f"canary {canary}: {why}",
                             "aborted" if died else "rolled_back")
                return
            # ---- phase 2: canary validation window ------------------------
            self._set_phase("validating")
            chaos_point("rollout.phase", tag="validating")
            self.sup.router.set_traffic_fraction(
                canary, cfg.rollout_canary_fraction)
            try:
                verdict, why = self._validate(canary, gen)
                if verdict == "fail":
                    # roll back BEFORE restoring the traffic weight: a canary
                    # that just failed validation must stay quarantined at
                    # the canary fraction until the rollback is confirmed —
                    # not promoted to a full rotation share of a known-bad
                    # model for the whole ctl-poll + restage window
                    self._set_phase("rolling_back")
                    self._command_rollback(canary, gen)
                    self._reject(record, f"canary validation failed: {why}",
                                 "rolled_back")
                    return
            finally:
                # dead/ok/exception paths — and the fail path above, where
                # the rollback has already confirmed (or the canary died)
                self.sup.router.set_traffic_fraction(canary, 1.0)
            if verdict == "dead":
                # canary killed mid-rollout: abort cleanly; its requeued work
                # re-serves on the stable cohort and the respawn reconciles
                # back to the stable version
                self._reject(record, f"canary {canary} died during "
                             f"validation: {why}", "aborted")
                return
            # ---- phase 3: fleet-wide promotion ----------------------------
            self._set_phase("promoting")
            chaos_point("rollout.phase", tag="promoting")
            swapped = [canary]
            for rid in self.sup.router.replica_ids():
                if rid == canary or self._stop.is_set():
                    continue
                slot = self._slot(rid)
                if slot is None or not slot.alive:
                    continue    # dead replica: the reconciler catches it up
                g = self._generation(rid)
                n = self._command_swap(rid, record)
                ok, why = self._wait_swap(rid, version, g, cfg.swap_timeout_s,
                                          nonce=n)
                if ok:
                    swapped.append(rid)
                elif self._generation(rid) != g or not (
                        self._slot(rid) and self._slot(rid).alive):
                    # died during promotion: requeue machinery keeps its
                    # work; once respawned the reconciler converges it onto
                    # whatever version wins below
                    logger.warning("rollout: %s died during promotion (%s); "
                                   "reconciler will converge it", rid, why)
                else:
                    # live replica refused the version late: roll everything
                    # back to the stable version rather than serve split
                    self._set_phase("rolling_back")
                    for sid in swapped:
                        self._command_rollback(sid, self._generation(sid))
                    self._reject(record, f"promotion failed on {rid}: {why}",
                                 "rolled_back")
                    return
            # ---- promoted --------------------------------------------------
            self.current = record
            try:
                self._conn.call("HSET", MODEL_CURRENT_KEY, record)
            except Exception:
                logger.exception("rollout: model:current update failed")
            _ROLLOUTS.labels(outcome="promoted").inc()
            self.outcomes.append((version, "promoted"))
            _ev.emit("rollout.promoted", version=version,
                     replicas=len(swapped))
            logger.info("rollout: %s promoted fleet-wide (%d replicas)",
                        version, len(swapped))
        finally:
            # propagate the in-flight exception (if any) into the span so a
            # crashed rollout records status=error and earns the recorder's
            # errored-trace retention
            import sys as _sys

            rollout_span.__exit__(*_sys.exc_info())
            self.target = None
            self.canary = None
            self._set_phase("idle")

    def _validate(self, canary: str, gen: int) -> Tuple[str, str]:
        """Compare the canary against the stable cohort over the validation
        window. Returns ("ok"|"fail"|"dead", why).

        Promotion requires the canary's heartbeat FRESH (within ~2 beat
        intervals) at window end, not merely "not yet declared dead": a
        canary killed in the window's final ``failover_timeout_s`` would
        otherwise look alive (staleness not yet expired) and promote a dead
        replica's version on evidence gathered before its death — the window
        extends (bounded by the hard deadline) until the heartbeat refreshes
        or the death is confirmed."""
        cfg = self.config
        hb_fresh_s = max(2 * getattr(cfg, "fleet_heartbeat_s", 0.5) + 0.2,
                         0.5)

        def fresh(s) -> bool:
            return (time.monotonic() - s.last_seen) <= hb_fresh_s

        slot = self._slot(canary)
        if slot is None:
            return "dead", "slot removed"
        c_served0, c_errors0 = slot.served, slot.errors
        cohort0 = self._cohort_snapshot(exclude=canary)
        t0 = time.monotonic()
        hard_deadline = t0 + max(cfg.rollout_window_s * 3,
                                 cfg.rollout_window_s + 1.0)
        while not self._stop.is_set():
            time.sleep(0.05)
            slot = self._slot(canary)
            if slot is None or self._generation(canary) != gen:
                return "dead", "respawned"
            if not slot.alive:
                return "dead", "heartbeat lost"
            if slot.swap_error:
                return "fail", slot.swap_error
            elapsed = time.monotonic() - t0
            c_served = slot.served - c_served0
            if elapsed >= cfg.rollout_window_s and \
                    c_served >= cfg.rollout_min_requests and fresh(slot):
                break
            if time.monotonic() >= hard_deadline:
                # low traffic: decide on whatever evidence exists
                break
        slot = self._slot(canary)
        if slot is None or not slot.alive:
            return "dead", "heartbeat lost at window end"
        if not fresh(slot):
            return "dead", "heartbeat stale at window end"
        c_served = max(0, slot.served - c_served0)
        c_errors = max(0, slot.errors - c_errors0)
        cohort1 = self._cohort_snapshot(exclude=canary)
        s_served = s_errors = 0
        for rid, (sv0, er0) in cohort0.items():
            sv1, er1 = cohort1.get(rid, (sv0, er0))
            s_served += max(0, sv1 - sv0)
            s_errors += max(0, er1 - er0)
        c_rate = c_errors / c_served if c_served else 0.0
        s_rate = s_errors / s_served if s_served else 0.0
        if c_errors and c_rate > s_rate + cfg.rollout_max_error_delta:
            return "fail", (f"canary error rate {c_rate:.3f} vs stable "
                            f"{s_rate:.3f} (+{cfg.rollout_max_error_delta} "
                            "allowed)")
        c_lat = slot.lat_ms
        s_lats = [self._slot(r).lat_ms for r in cohort1
                  if self._slot(r) is not None and self._slot(r).lat_ms > 0]
        if c_lat > 0 and s_lats:
            s_lat = sorted(s_lats)[len(s_lats) // 2]
            if s_lat > 0 and c_lat > s_lat * cfg.rollout_max_latency_ratio:
                return "fail", (f"canary latency {c_lat:.1f}ms > "
                                f"{cfg.rollout_max_latency_ratio}x stable "
                                f"median {s_lat:.1f}ms")
        return "ok", (f"served={c_served} errors={c_errors} "
                      f"lat={c_lat:.1f}ms")

    def _command_rollback(self, rid: str, gen: int) -> None:
        from .engine import FLEET_CTL_PREFIX

        self._swap_nonce += 1
        try:
            ctl = self._conn.call("HGET", FLEET_CTL_PREFIX + rid, 0)
            ctl = dict(ctl) if isinstance(ctl, dict) else {}
            ctl["swap"] = {"rollback": True, "nonce": self._swap_nonce}
            self._conn.call("HSET", FLEET_CTL_PREFIX + rid, ctl)
        except Exception:
            logger.exception("rollout: rollback command for %s failed", rid)
            return
        want = (self.current or {}).get("version")
        deadline = time.monotonic() + self.config.swap_timeout_s
        while time.monotonic() < deadline and not self._stop.is_set():
            slot = self._slot(rid)
            if slot is None or self._generation(rid) != gen \
                    or not slot.alive:
                return      # death → respawn → reconciler path
            if want is None or slot.model_version in (want, "initial", None):
                return
            time.sleep(0.05)

    # -- idle-phase reconciler ------------------------------------------------

    def _reconcile(self) -> None:
        """Converge every live replica onto the promoted version: a replica
        respawned mid-swap boots on its factory params, one joining
        mid-rollout boots stale — both heartbeat a version that differs from
        ``model:current``, and get the swap command re-issued (deduped per
        (replica, version, incarnation))."""
        if self.current is None or self.phase != "idle":
            return
        want = self.current.get("version")
        for rid in self.sup.router.replica_ids():
            slot = self._slot(rid)
            if slot is None or not slot.alive or slot.state != "up":
                continue
            if slot.model_version in (want, None):
                # None = heartbeat predates the version field (replica still
                # starting); wait for a real report before commanding
                if slot.model_version == want:
                    self._reconciling.pop(rid, None)
                continue
            if slot.swap_state == "staging":
                continue
            gen = self._generation(rid)
            if self._reconciling.get(rid) == (want, gen):
                continue        # command already in flight for this incarnation
            logger.info("rollout: reconciling %s from %s to %s",
                        rid, slot.model_version, want)
            try:
                self._command_swap(rid, self.current, force=True)
            except Exception:
                logger.exception("rollout: reconcile command for %s failed",
                                 rid)
                continue
            self._reconciling[rid] = (want, gen)
            _RECONCILES.inc()


__all__ = ["MODEL_CURRENT_KEY", "MODEL_REJECT_STREAM", "MODEL_STREAM",
           "ROLLOUT_KEY", "ModelPublisher", "ModelSwapper",
           "RolloutController", "SwapRejected", "publish_record"]
