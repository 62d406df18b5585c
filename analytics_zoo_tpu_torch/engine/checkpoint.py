"""Checkpoints in the JAX package's format (port of ``engine/checkpoint.py``).

One ``checkpoint_<iteration>`` directory per snapshot holds:

- ``state.npz``: the state's leaves as ``leaf_<i>`` in JAX's flatten order
  (dict keys sorted, NamedTuple fields in order, ``None`` and field-less
  states contributing nothing). bf16 leaves are stored as their raw 16-bit
  patterns in a ``V2`` void dtype, as numpy writes JAX's ``ml_dtypes``
  bfloat16 arrays; both packages view them back by the leaf's dtype;
- ``meta.json``: ``iteration``, ``epoch``, ``time``, ``n_leaves``,
  ``leaf_paths`` (the leaves' tree paths in ``jax.tree_util.keystr`` form,
  ``['opt_state'][0].mu['block0']['attn']['qkv_kernel']``) and ``extra``;
- ``manifest.json``: ``version``, ``signature`` (a digest of every leaf's
  ``(shape, dtype)`` in flatten order), ``checksum`` (sha256 of
  ``state.npz``), ``state_bytes`` and the loop counters.

A state here is a tree of dicts, tuples, NamedTuples and ``None`` whose
leaves are tensors or numpy arrays, shaped as the JAX package's train
state (``bridge.train_state_to_jax`` builds one from the port's
Estimator). :func:`load_checkpoint` maps the stored leaves onto a template
by path, never by position, and checks each ``(shape, dtype)``.

Writes stage under ``*.tmp``, fsync, and publish by atomic rename (an
existing snapshot of the same iteration is set aside as ``.old`` first),
so :func:`latest_checkpoint`, which matches completed names only, never
surfaces a torn snapshot. :class:`CheckpointWriter` runs the serialization
on an at-most-one-in-flight ``zoo-ckpt-write`` thread; the loop pays only
the device-to-host snapshot. Leaves on the card are copied into pinned
host memory without blocking, and the write waits on the copy's event;
every leaf is copied, so the next in-place step never reaches a snapshot.

The publish half of the serving fleet's hot swap: ``on_durable(path,
manifest)`` hooks (on :class:`CheckpointWriter` or per
:func:`save_checkpoint` call) fire once a snapshot is durable;
:func:`save_row_delta` publishes only the rows of a params tree that
changed since a base checkpoint (a ``rowdelta_<iteration>`` directory in
the JAX package's format: ``idx_<k>``/``rows_<k>`` for a 2-D leaf whose
touched rows stay under ``ROW_DELTA_THRESHOLD`` of it, ``full_<k>``
otherwise, and a ``row_delta`` manifest record with per-shard checksums);
:func:`read_row_delta` validates one against a live model's template and
returns ``[(leaf_index, idx, rows)]`` for
``InferenceModel.apply_row_delta``. :func:`param_tree_signature` is the
``(shape, dtype)`` digest a swap is validated by.

Each snapshot's seconds land in ``zoo_train_checkpoint_snapshot_seconds``
and each write's (checkpoint or row delta) in
``zoo_train_checkpoint_write_seconds``, the JAX package's histograms on
the port's registry; :data:`timings` keeps the same two durations as
lists.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common import telemetry as _tm
from ..common.chaos import chaos_point

_SNAPSHOT_TIME = _tm.histogram(
    "zoo_train_checkpoint_snapshot_seconds",
    "Device→host state-snapshot time — the only checkpoint cost the hot "
    "loop pays in async mode")
_WRITE_TIME = _tm.histogram(
    "zoo_train_checkpoint_write_seconds",
    "Checkpoint serialization + fsync + atomic-rename time (background "
    "zoo-ckpt-write thread in async mode)",
    buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30))

_CKPT_RE = re.compile(r"^checkpoint_(\d+)$")
_DELTA_RE = re.compile(r"^rowdelta_(\d+)$")

MANIFEST_NAME = "manifest.json"

#: a 2-D leaf publishes as a row delta only while the touched rows (plus
#: index bytes) stay under this fraction of the full leaf; past it, one
#: contiguous full-leaf write beats a scattered row apply
ROW_DELTA_THRESHOLD = 0.5

#: how numpy stores a bfloat16 leaf: its raw bits as 2-byte voids
_BF16_VOID = np.dtype("V2")

#: seconds of each device-to-host snapshot and of each write (serialize,
#: fsync, rename), newest last; the JAX package's histograms
timings: Dict[str, List[float]] = {"snapshot": [], "write": []}


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed its manifest validation (truncated ``state.npz``,
    checksum mismatch, missing files): it must not be loaded."""


# ------------------------------------------------------------------ trees

def tree_leaves_with_paths(tree) -> List[Tuple[str, Any]]:
    """``(keystr path, leaf)`` pairs in JAX's flatten order."""
    out: List[Tuple[str, Any]] = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}[{k!r}]")
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for f in node._fields:
                walk(getattr(node, f), f"{path}.{f}")
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
        else:
            out.append((path, node))

    walk(tree, "")
    return out


def tree_map_with_paths(fn: Callable[[str, Any], Any], tree):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""

    def rebuild(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: rebuild(v, f"{path}[{k!r}]") for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(rebuild(getattr(node, f), f"{path}.{f}")
                                for f in node._fields))
        if isinstance(node, (tuple, list)):
            return type(node)(rebuild(v, f"{path}[{i}]")
                              for i, v in enumerate(node))
        return fn(path, node)

    return rebuild(tree, "")


def leaf_dtype_name(leaf) -> str:
    """The numpy name of a leaf's dtype (``"bfloat16"`` for bf16)."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).rsplit(".", 1)[-1]
    return np.asarray(leaf).dtype.name


def _stored_dtype_name(raw: np.ndarray) -> str:
    return "bfloat16" if raw.dtype == _BF16_VOID else raw.dtype.name


def _signature(parts: List[Tuple[Tuple[int, ...], str]]) -> str:
    joined = ";".join(f"{tuple(s)}:{d}" for s, d in parts)
    return hashlib.sha256(joined.encode("utf-8")).hexdigest()[:16]


def param_tree_signature(leaves) -> str:
    """Stable digest of a parameter tree's shape — ``(shape, dtype)`` per
    leaf, in flatten order, the JAX package's digest. Two trees with
    equal signatures swap into the same model with nothing rebuilt."""
    return _signature([(tuple(np.shape(l)) if not isinstance(
        l, torch.Tensor) else tuple(l.shape), leaf_dtype_name(l))
        for l in leaves])


# --------------------------------------------------------------- snapshot

class Snapshot:
    """Independent host copies of a state's leaves. ``ready`` (a CUDA
    event, or ``None``) completes when copies from the card have landed;
    :meth:`wait` must return before the arrays are read."""

    def __init__(self, leaves: List[np.ndarray], dtypes: List[str],
                 ready=None):
        self.leaves, self.dtypes, self.ready = leaves, dtypes, ready

    def wait(self) -> List[np.ndarray]:
        if self.ready is not None:
            self.ready.synchronize()
            self.ready = None
        return self.leaves


def _host_copy(leaf):
    """A host copy of ``leaf`` that nothing else aliases, and whether its
    copy from the card may still be in flight."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            pending = True
        else:
            host = t.clone(memory_format=torch.contiguous_format)
            pending = False
        if host.dtype == torch.bfloat16:
            return host.view(torch.int16).numpy().view(_BF16_VOID), pending
        return host.numpy(), pending
    return np.array(leaf, copy=True), False


def snapshot_state(state: Any) -> Snapshot:
    """Copy every leaf of ``state`` to the host (pinned and asynchronous
    for leaves on the card). The copies never alias the live state: the
    port updates parameters in place, and on the CPU ``.numpy()`` would
    hand the writer thread a view of the buffer the next step rewrites."""
    t0 = time.perf_counter()
    host, dtypes, on_card = [], [], False
    for _, leaf in tree_leaves_with_paths(state):
        dtypes.append(leaf_dtype_name(leaf))
        arr, pending = _host_copy(leaf)
        on_card |= pending
        host.append(arr)
    ready = None
    if on_card:
        ready = torch.cuda.Event()
        ready.record()
    dt = time.perf_counter() - t0
    timings["snapshot"].append(dt)
    _SNAPSHOT_TIME.observe(dt)
    return Snapshot(host, dtypes, ready)


# ------------------------------------------------------------- manifest

def content_checksum(path: str) -> str:
    """sha256 of a file's bytes (the manifest's torn-write detector)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _build_manifest(state_path: str, snap: Snapshot, meta: Dict) -> Dict:
    checksum = content_checksum(state_path)
    manifest = {
        "version": f"v{meta['iteration']}-{checksum[:8]}",
        "iteration": meta["iteration"],
        "epoch": meta.get("epoch", 0),
        "n_leaves": len(snap.leaves),
        "signature": _signature([(l.shape, d) for l, d in
                                 zip(snap.leaves, snap.dtypes)]),
        "checksum": checksum,
        "state_bytes": os.path.getsize(state_path),
        "time": meta.get("time", time.time()),
    }
    if meta.get("leaf_paths"):
        manifest["leaf_paths"] = list(meta["leaf_paths"])
    return manifest


def read_manifest(path: str) -> Optional[Dict]:
    """The snapshot's manifest, or ``None`` for one that predates them."""
    mpath = os.path.join(path, MANIFEST_NAME)
    if not os.path.exists(mpath):
        return None
    with open(mpath) as f:
        return json.load(f)


def verify_checkpoint(path: str) -> Optional[Dict]:
    """Validate a snapshot against its manifest and return the manifest
    (``None`` without one). Raises :class:`CheckpointCorruptError` on a
    missing or truncated ``state.npz`` or a checksum mismatch."""
    manifest = read_manifest(path)
    if manifest is None:
        return None
    state = os.path.join(path, "state.npz")
    if not os.path.exists(state):
        raise CheckpointCorruptError(f"{path}: state.npz missing "
                                     "(manifest present: torn snapshot)")
    size = os.path.getsize(state)
    if size != manifest["state_bytes"]:
        raise CheckpointCorruptError(
            f"{path}: state.npz is {size} bytes, manifest says "
            f"{manifest['state_bytes']}: truncated or torn write")
    checksum = content_checksum(state)
    if checksum != manifest["checksum"]:
        raise CheckpointCorruptError(
            f"{path}: state.npz checksum {checksum[:12]}... does not match "
            f"manifest {manifest['checksum'][:12]}...: corrupt snapshot")
    return manifest


# ---------------------------------------------------------------- write

def _fsync(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:      # directories on filesystems that do not support it
        pass
    finally:
        os.close(fd)


def _write_snapshot(directory: str, snap: Snapshot, meta: Dict,
                    keep: int,
                    on_durable: Optional[Callable[[str, Dict], None]] = None
                    ) -> str:
    """Stage under ``*.tmp``, fsync, rename atomically, fsync the parent
    directory; then collect all but the newest ``keep``. ``on_durable(path,
    manifest)`` fires only after the rename and the directory fsync: the
    checkpoint it announces cannot be lost to a crash right after it."""
    path = os.path.join(directory, f"checkpoint_{meta['iteration']}")
    tmp = path + ".tmp"
    t0 = time.perf_counter()
    try:
        leaves = snap.wait()
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "state.npz"),
                 **{f"leaf_{i}": l for i, l in enumerate(leaves)})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync(os.path.join(tmp, "state.npz"))
        manifest = _build_manifest(os.path.join(tmp, "state.npz"), snap,
                                   meta)
        with open(os.path.join(tmp, MANIFEST_NAME), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        # the kill site between serialization and publication: a writer
        # killed here must leave only complete, durable checkpoints
        chaos_point("ckpt.write")
        _fsync(tmp)
        # re-saving an iteration: set the durable one aside, never delete
        # it first, so no moment exists in which neither is recoverable
        old = None
        if os.path.exists(path):
            old = path + ".old"
            shutil.rmtree(old, ignore_errors=True)
            os.rename(path, old)
        os.rename(tmp, path)
        _fsync(directory)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
    except BaseException:       # chaos WorkerKilled too: never leave a .tmp
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    finally:
        dt = time.perf_counter() - t0
        timings["write"].append(dt)
        _WRITE_TIME.observe(dt)
    _gc(directory, keep)
    _announce(on_durable, path, manifest)
    return path


def _announce(on_durable, path: str, manifest: Dict) -> None:
    if on_durable is None:
        return
    try:
        on_durable(path, manifest)
    except Exception:   # a failed publish is not a failed checkpoint
        import logging

        logging.getLogger("analytics_zoo_tpu_torch.checkpoint").exception(
            "on_durable hook failed for %s", path)


def save_checkpoint(directory: str, state: Any, *, iteration: int,
                    epoch: int, extra: Optional[Dict] = None, keep: int = 5,
                    writer: Optional["CheckpointWriter"] = None,
                    on_durable: Optional[Callable[[str, Dict], None]] = None
                    ) -> str:
    """Snapshot ``state`` under ``directory``. With ``writer`` the call
    returns after the snapshot and the write runs on the writer's thread
    (drain the writer before depending on the file); without it the write
    is synchronous. ``on_durable(path, manifest)`` fires once the snapshot
    is durable (the writer's own hook when this one is omitted)."""
    os.makedirs(directory, exist_ok=True)
    paths = [p for p, _ in tree_leaves_with_paths(state)]
    snap = snapshot_state(state)
    meta = {
        "iteration": int(iteration),
        "epoch": int(epoch),
        "time": time.time(),
        "n_leaves": len(snap.leaves),
        "leaf_paths": paths,
        "extra": extra or {},
    }
    if writer is not None:
        return writer.submit(directory, snap, meta, keep,
                             on_durable=on_durable)
    return _write_snapshot(directory, snap, meta, keep, on_durable=on_durable)


class CheckpointWriter:
    """At-most-one-in-flight background checkpoint writer.

    ``submit`` drains the previous write first (re-raising its failure),
    then hands the snapshot to a fresh daemon ``zoo-ckpt-write`` thread;
    ``drain`` blocks until the write in flight is durable.
    ``on_durable(path, manifest)``, called on the writer thread after each
    durable publication, is where a publisher announces the checkpoint to
    the serving fleet."""

    def __init__(self, on_durable: Optional[Callable[[str, Dict],
                                                     None]] = None):
        self.on_durable = on_durable
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None
        self._path: Optional[str] = None

    def submit(self, directory: str, snap: Snapshot, meta: Dict,
               keep: int,
               on_durable: Optional[Callable[[str, Dict], None]] = None
               ) -> str:
        self.drain()
        hook = on_durable or self.on_durable

        def run():
            try:
                self._path = _write_snapshot(directory, snap, meta, keep,
                                             on_durable=hook)
            except BaseException as e:     # surfaced at the next drain
                self._exc = e

        self._thread = threading.Thread(target=run, name="zoo-ckpt-write",
                                        daemon=True)
        self._thread.start()
        return os.path.join(directory, f"checkpoint_{meta['iteration']}")

    def in_flight(self) -> bool:
        """Whether a submitted write is still running."""
        t = self._thread
        return t is not None and t.is_alive()

    def drain(self) -> Optional[str]:
        """Block until pending work is durable; re-raise a failed write."""
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        if self._exc is not None:
            e, self._exc = self._exc, None
            raise e
        return self._path


def _gc(directory: str, keep: int) -> None:
    names = os.listdir(directory)
    for rx in (_CKPT_RE, _DELTA_RE):
        ckpts = sorted((int(m.group(1)), name) for name in names
                       if (m := rx.match(name)))
        for _, name in ckpts[:-keep]:
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
    for name in names:          # .old dirs stranded by a crash mid-replace
        if name.endswith(".old") and (_CKPT_RE.match(name[:-4])
                                      or _DELTA_RE.match(name[:-4])):
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)


def latest_checkpoint(directory: str) -> Optional[str]:
    """The newest complete snapshot; ``*.tmp`` and ``.old`` never match."""
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        m = _CKPT_RE.match(name)
        if m:
            it = int(m.group(1))
            if best is None or it > best[0]:
                best = (it, os.path.join(directory, name))
    return best[1] if best else None


# ----------------------------------------------------------------- load

def _from_host(raw: np.ndarray, like):
    """A stored leaf as the template's kind: a tensor on the template's
    device, or a numpy array."""
    if raw.dtype == _BF16_VOID:
        t = torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(raw)
    if isinstance(like, torch.Tensor):
        return t.to(like.device)
    return raw


def load_checkpoint(path: str, state_template: Any) -> Tuple[Any, Dict]:
    """Restore a snapshot into the structure of ``state_template``.

    The snapshot is verified first (:class:`CheckpointCorruptError`). Each
    template leaf takes the stored leaf of its path; a path on one side
    only raises naming it, and so does a leaf whose ``(shape, dtype)``
    differs (the manifest's ``signature`` is checked against the
    template's)."""
    manifest = verify_checkpoint(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    paths = meta.get("leaf_paths") or (manifest or {}).get("leaf_paths")
    if not paths or len(paths) != meta["n_leaves"]:
        raise ValueError(f"{path}: no leaf paths for its {meta['n_leaves']} "
                         f"leaves; a checkpoint is loaded by path, never by "
                         f"position")
    index = {p: i for i, p in enumerate(paths)}
    template = dict(tree_leaves_with_paths(state_template))
    missing = [p for p in template if p not in index]
    extra = [p for p in paths if p not in template]
    if missing or extra:
        raise ValueError(f"{path}: leaves do not map: not in the checkpoint "
                         f"{missing[:5]}, not in this state {extra[:5]}")
    data = np.load(os.path.join(path, "state.npz"))

    def check(p: str, raw: np.ndarray) -> None:
        like = template[p]
        want = (tuple(like.shape), leaf_dtype_name(like))
        got = (tuple(raw.shape), _stored_dtype_name(raw))
        if want != got:
            raise ValueError(f"{path}: leaf {p} is {got[0]} {got[1]} in the "
                             f"checkpoint, {want[0]} {want[1]} here")

    if manifest is not None:
        mine = _signature([(tuple(template[p].shape),
                            leaf_dtype_name(template[p])) for p in paths])
        if mine != manifest["signature"]:
            for i, p in enumerate(paths):
                check(p, data[f"leaf_{i}"])
            raise ValueError(f"{path}: signature {manifest['signature']} "
                             f"is not this state's {mine}")

    def restore(p: str, like):
        raw = data[f"leaf_{index[p]}"]
        check(p, raw)
        return _from_host(raw, like)

    return tree_map_with_paths(restore, state_template), meta


# ------------------------------------------------------------ row deltas

def _shard_checksums(idx: np.ndarray, rows: np.ndarray, rows_total: int,
                     n_shards: int) -> List[Dict]:
    """Per-owner-shard ``{shard, count, checksum}`` of a row delta under
    contiguous row sharding (rows ``[s*per, (s+1)*per)`` are shard ``s``'s),
    so each serving shard can verify exactly the slice it applies."""
    n_shards = max(1, int(n_shards))
    per = max(1, rows_total // n_shards)
    out: List[Dict] = []
    for s in range(n_shards):
        lo = s * per
        hi = (s + 1) * per if s < n_shards - 1 else rows_total
        m = (idx >= lo) & (idx < hi)
        if not m.any():
            continue
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(idx[m]).tobytes())
        h.update(np.ascontiguousarray(rows[m]).tobytes())
        out.append({"shard": s, "count": int(m.sum()),
                    "checksum": h.hexdigest()[:16]})
    return out


def _select_base_params(base_manifest: Dict, n_params: int) -> List[int]:
    """Indices of the params leaves in the base checkpoint's flat leaf
    list: all of them for a params-only snapshot, the ``['params']``
    subtree (by the manifest's leaf paths) for a whole train state."""
    n_base = int(base_manifest["n_leaves"])
    if n_base == n_params:
        return list(range(n_base))
    paths = base_manifest.get("leaf_paths") or []
    if len(paths) == n_base:
        sel = [i for i, p in enumerate(paths)
               if str(p).startswith("['params']")]
        if len(sel) == n_params:
            return sel
    raise ValueError(
        f"base checkpoint has {n_base} leaves and no params subtree "
        f"matching the {n_params}-leaf publish tree")


def _as_tree(params):
    """A params tree in JAX's shape: a flat ``{dotted name: tensor}`` state
    dict nested by its names, any other tree as it is."""
    if isinstance(params, dict) and params and all(
            isinstance(v, torch.Tensor) for v in params.values()) and any(
            "." in k for k in params):
        from ..bridge import nest

        return nest(params)
    return params


def save_row_delta(directory: str, params: Any, base_path: str, *,
                   iteration: int, epoch: int = 0, n_shards: int = 1,
                   keep: int = 5,
                   rows_threshold: float = ROW_DELTA_THRESHOLD,
                   on_durable: Optional[Callable[[str, Dict], None]] = None
                   ) -> str:
    """Publish only the rows of ``params`` that changed since ``base_path``.

    A training step touches the few embedding rows its batch looked up, so
    shipping the whole table per publish is almost all redundant bytes.
    This diffs a host snapshot of ``params`` (a JAX-shaped tree, or the
    port's ``{dotted name: tensor}`` state dict) against the durable base
    checkpoint and writes a ``rowdelta_<iteration>`` directory whose
    ``state.npz`` holds, per leaf: nothing (untouched), ``idx_<k>`` +
    ``rows_<k>`` (a 2-D leaf whose touched rows stay under
    ``rows_threshold`` of it) or ``full_<k>`` (the dense fallback). The
    manifest carries the usual version, checksum and ``state_bytes`` (so
    :func:`verify_checkpoint` applies unchanged) plus a ``row_delta``
    record — base version, shard count, per-owner-shard row counts and
    checksums — and its ``signature``/``n_leaves`` describe the FULL params
    tree. The JAX package's function writes the same arrays and record.

    Same durability as :func:`save_checkpoint`: staged under ``*.tmp``,
    fsync'd, renamed atomically; ``on_durable(path, manifest)`` fires only
    after publication. Raises ``ValueError`` when the base's params are not
    signature-identical to ``params``: a delta against the wrong base is
    garbage, better refused at the source."""
    os.makedirs(directory, exist_ok=True)
    base_manifest = verify_checkpoint(base_path)
    if base_manifest is None:
        raise ValueError(f"{base_path} has no manifest: row deltas need a "
                         "manifest-carrying base checkpoint")
    tree = _as_tree(params)
    leaf_paths = [p for p, _ in tree_leaves_with_paths(tree)]
    snap = snapshot_state(tree)
    host_leaves = snap.wait()
    base_idx = _select_base_params(base_manifest, len(host_leaves))
    base_data = np.load(os.path.join(base_path, "state.npz"))

    arrays: Dict[str, np.ndarray] = {}
    delta_leaves: List[Dict] = []
    rows_touched = 0
    for k, (leaf, bi) in enumerate(zip(host_leaves, base_idx)):
        base_leaf = base_data[f"leaf_{bi}"]
        if tuple(base_leaf.shape) != tuple(leaf.shape) \
                or base_leaf.dtype != leaf.dtype:
            raise ValueError(
                f"leaf {k}: publish {leaf.shape}/{snap.dtypes[k]} vs base "
                f"{base_leaf.shape}/{_stored_dtype_name(base_leaf)}: row "
                f"deltas need a signature-identical base")
        # bytewise row comparison: dtype-agnostic (bf16 safe) and a
        # NaN-poisoned row counts as touched, so the reader's scan sees it
        a = leaf.reshape(leaf.shape[0], -1).view(np.uint8) \
            if leaf.ndim == 2 \
            else np.ascontiguousarray(leaf).view(np.uint8).reshape(1, -1)
        b = base_leaf.reshape(base_leaf.shape[0], -1).view(np.uint8) \
            if leaf.ndim == 2 \
            else np.ascontiguousarray(base_leaf).view(np.uint8).reshape(1, -1)
        touched = np.flatnonzero((a != b).any(axis=1))
        if touched.size == 0:
            delta_leaves.append({"leaf": k, "mode": "same"})
            continue
        if leaf.ndim == 2:
            idx = touched.astype(np.int64)
            rows = np.ascontiguousarray(leaf[idx])
            if idx.size * (rows[0].nbytes + idx.itemsize) \
                    < rows_threshold * leaf.nbytes:
                arrays[f"idx_{k}"] = idx
                arrays[f"rows_{k}"] = rows
                rows_touched += int(idx.size)
                delta_leaves.append({
                    "leaf": k, "mode": "rows", "count": int(idx.size),
                    "rows_total": int(leaf.shape[0]),
                    "shards": _shard_checksums(idx, rows, leaf.shape[0],
                                               n_shards)})
                continue
        arrays[f"full_{k}"] = leaf
        delta_leaves.append({
            "leaf": k, "mode": "full",
            "checksum": hashlib.sha256(
                np.ascontiguousarray(leaf).tobytes()).hexdigest()[:16]})

    path = os.path.join(directory, f"rowdelta_{iteration}")
    tmp = path + ".tmp"
    t0 = time.perf_counter()
    try:
        os.makedirs(tmp, exist_ok=True)
        state_path = os.path.join(tmp, "state.npz")
        np.savez(state_path, **arrays)
        meta = {"iteration": int(iteration), "epoch": int(epoch),
                "time": time.time(), "n_leaves": len(host_leaves),
                "leaf_paths": leaf_paths,
                "base_version": base_manifest["version"]}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync(state_path)
        manifest = _build_manifest(state_path, snap, meta)
        manifest["row_delta"] = {
            "base_version": base_manifest["version"],
            "base_path": os.path.abspath(base_path),
            "n_shards": int(max(1, n_shards)),
            "rows_touched": rows_touched,
            "leaves": delta_leaves,
        }
        with open(os.path.join(tmp, MANIFEST_NAME), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        chaos_point("ckpt.write")
        _fsync(tmp)
        old = None
        if os.path.exists(path):
            old = path + ".old"
            shutil.rmtree(old, ignore_errors=True)
            os.rename(path, old)
        os.rename(tmp, path)
        _fsync(directory)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    finally:
        dt = time.perf_counter() - t0
        timings["write"].append(dt)
        _WRITE_TIME.observe(dt)
    _gc(directory, keep)
    _announce(on_durable, path, manifest)
    return path


class RowDeltaRejected(ValueError):
    """A row-delta publish failed validation against the live model;
    ``reason`` names the check (``base``, ``io``, ``shape``, ``checksum``,
    ``nan``), as the JAX swapper's rejections do."""

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


def read_row_delta(path: str, avals: List[Tuple[Tuple[int, ...], str]], *,
                   live_version: Optional[str] = None
                   ) -> Tuple[List[Tuple[int, Optional[np.ndarray],
                                         torch.Tensor]], Dict]:
    """Read and validate a row-delta publish against a live model's
    template ``avals`` (``[(shape, dtype name)]`` in flatten order, as
    ``InferenceModel.load_avals`` holds it): the manifest's checksum, the
    base version (when ``live_version`` is given, it must be the delta's
    base), every array's shape and dtype, the per-shard row checksums
    recomputed over the loaded bytes, and no NaN or Inf in a float leaf.

    Returns ``(entries, manifest)``: ``entries`` is ``[(leaf_index, idx,
    rows)]`` (``idx`` int64 numpy, ``None`` for a whole-leaf replacement;
    ``rows`` a CPU tensor of the leaf's dtype), what
    ``InferenceModel.apply_row_delta`` takes. Raises
    :class:`RowDeltaRejected`."""
    try:
        manifest = verify_checkpoint(path)
    except CheckpointCorruptError as e:
        raise RowDeltaRejected("checksum", str(e)) from None
    if manifest is None or "row_delta" not in manifest:
        raise RowDeltaRejected("io", f"{path} is not a row-delta publish")
    rd = manifest["row_delta"]
    base = rd.get("base_version")
    if live_version is not None and live_version != base:
        raise RowDeltaRejected(
            "base", f"row delta {manifest['version']} applies on top of "
            f"{base}, but the model serves {live_version}")
    if int(manifest["n_leaves"]) != len(avals):
        raise RowDeltaRejected(
            "shape", f"delta describes {manifest['n_leaves']} param leaves, "
            f"the live model has {len(avals)}")
    data = np.load(os.path.join(path, "state.npz"))

    def load(key, dtype):
        try:
            raw = data[key]
        except KeyError:
            raise RowDeltaRejected(
                "io", f"delta file is missing array {key!r}") from None
        if _stored_dtype_name(raw) != dtype:
            raise RowDeltaRejected(
                "shape", f"delta array {key}: dtype "
                f"{_stored_dtype_name(raw)}, the live leaf's {dtype}")
        return raw

    entries = []
    for leaf in rd.get("leaves", []):
        k = int(leaf["leaf"])
        mode = leaf.get("mode", "same")
        if mode == "same":
            continue
        if k >= len(avals):
            raise RowDeltaRejected("shape", f"delta leaf {k} out of range")
        shape, dtype = tuple(avals[k][0]), avals[k][1]
        if mode == "rows":
            try:
                idx = np.asarray(data[f"idx_{k}"])
            except KeyError:
                raise RowDeltaRejected(
                    "io", f"delta file is missing array 'idx_{k}'") from None
            raw = load(f"rows_{k}", dtype)
            if idx.ndim != 1 or not np.issubdtype(idx.dtype, np.integer) \
                    or raw.shape[:1] != idx.shape \
                    or tuple(raw.shape[1:]) != shape[1:]:
                raise RowDeltaRejected(
                    "shape", f"delta leaf {k}: rows {raw.shape} with "
                    f"{idx.shape} indices vs live {shape}")
            if idx.size and (idx.min() < 0 or idx.max() >= shape[0]):
                raise RowDeltaRejected(
                    "shape", f"delta leaf {k}: row index out of range for "
                    f"{shape[0]} rows")
            if _shard_checksums(idx, raw, int(shape[0]),
                                int(rd.get("n_shards", 1))) \
                    != leaf.get("shards", []):
                raise RowDeltaRejected(
                    "checksum", f"delta leaf {k}: per-shard row checksums "
                    f"do not match the manifest")
            entry_idx = idx
        else:   # the dense fallback: the whole leaf
            raw = load(f"full_{k}", dtype)
            if tuple(raw.shape) != shape:
                raise RowDeltaRejected(
                    "shape", f"delta leaf {k}: full replacement "
                    f"{raw.shape} vs live {shape}")
            entry_idx = None
        rows = _from_host(raw, torch.empty(0))
        if rows.is_floating_point() and not bool(
                torch.isfinite(rows.float()).all()):
            raise RowDeltaRejected(
                "nan", f"delta leaf {k} carries NaN/Inf rows: a poisoned "
                f"publish")
        entries.append((k, entry_idx, rows))
    return entries, manifest


__all__ = ["CheckpointCorruptError", "CheckpointWriter", "MANIFEST_NAME",
           "ROW_DELTA_THRESHOLD", "RowDeltaRejected", "Snapshot",
           "content_checksum", "latest_checkpoint", "leaf_dtype_name",
           "load_checkpoint", "param_tree_signature", "read_manifest",
           "read_row_delta", "save_checkpoint", "save_row_delta",
           "snapshot_state", "timings", "tree_leaves_with_paths",
           "tree_map_with_paths", "verify_checkpoint"]
