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

Not ported: ``save_row_delta`` and the ``on_durable`` publish hooks of
the serving fleet's hot-swap (ROADMAP Queue 1, item 6), and the
``zoo_train_checkpoint_snapshot_seconds`` / ``..._write_seconds``
histograms (item 8); :data:`timings` keeps the same two durations.
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

from ..common.chaos import chaos_point

_CKPT_RE = re.compile(r"^checkpoint_(\d+)$")

MANIFEST_NAME = "manifest.json"

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
    timings["snapshot"].append(time.perf_counter() - t0)
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
                    keep: int) -> str:
    """Stage under ``*.tmp``, fsync, rename atomically, fsync the parent
    directory; then collect all but the newest ``keep``."""
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
        timings["write"].append(time.perf_counter() - t0)
    _gc(directory, keep)
    return path


def save_checkpoint(directory: str, state: Any, *, iteration: int,
                    epoch: int, extra: Optional[Dict] = None, keep: int = 5,
                    writer: Optional["CheckpointWriter"] = None) -> str:
    """Snapshot ``state`` under ``directory``. With ``writer`` the call
    returns after the snapshot and the write runs on the writer's thread
    (drain the writer before depending on the file); without it the write
    is synchronous."""
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
        return writer.submit(directory, snap, meta, keep)
    return _write_snapshot(directory, snap, meta, keep)


class CheckpointWriter:
    """At-most-one-in-flight background checkpoint writer.

    ``submit`` drains the previous write first (re-raising its failure),
    then hands the snapshot to a fresh daemon ``zoo-ckpt-write`` thread;
    ``drain`` blocks until the write in flight is durable."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None
        self._path: Optional[str] = None

    def submit(self, directory: str, snap: Snapshot, meta: Dict,
               keep: int) -> str:
        self.drain()

        def run():
            try:
                self._path = _write_snapshot(directory, snap, meta, keep)
            except BaseException as e:     # surfaced at the next drain
                self._exc = e

        self._thread = threading.Thread(target=run, name="zoo-ckpt-write",
                                        daemon=True)
        self._thread.start()
        return os.path.join(directory, f"checkpoint_{meta['iteration']}")

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
    ckpts = sorted((int(m.group(1)), name) for name in names
                   if (m := _CKPT_RE.match(name)))
    for _, name in ckpts[:-keep]:
        shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
    for name in names:          # .old dirs stranded by a crash mid-replace
        if name.endswith(".old") and _CKPT_RE.match(name[:-4]):
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


__all__ = ["CheckpointCorruptError", "CheckpointWriter", "MANIFEST_NAME",
           "Snapshot", "content_checksum", "latest_checkpoint",
           "leaf_dtype_name", "load_checkpoint", "read_manifest",
           "save_checkpoint", "snapshot_state", "timings",
           "tree_leaves_with_paths", "tree_map_with_paths",
           "verify_checkpoint"]
