"""Datasets of array trees with cache tiers (port of
``data/featureset.py``).

Tiers (``memory_type``):

- ``DRAM`` (and its alias ``DIRECT``): host arrays as given;
- ``DISK_AND_DRAM(n)``: every leaf written once to a ``.npy`` file under
  ``cache_dir`` (a temp directory when not given) and read back through
  ``np.memmap``; ``n`` is the number of epoch slices :meth:`slices`
  makes;
- ``PMEM``: the same over a memmap (meant for a pmem or NVMe mount), one
  slice.

A shuffled epoch visits the examples in the JAX package's order: the
permutation of ``default_rng(seed + epoch * 1_000_003)``. Batches are
host numpy arrays (a memmap tier gathers in sorted index order, then
restores the batch order); training drops the remainder batch. The
constructors :meth:`~FeatureSet.from_numpy`, ``from_generator``,
``from_dataframe`` (duck-typed: anything with ``df[col].to_numpy()``;
pandas is never imported) and ``from_bytes`` (a :class:`BytesFeatureSet`
that decodes each batch's records through ``pipeline.decode_map``) are
the JAX package's, and so are ``from_tfrecord`` (tf.Example files read
by ``data/tfrecord.py``), ``from_xshards`` (``data/xshards.py``) and
``from_tf_dataset`` (duck-typed on ``as_numpy_iterator()``; tensorflow is
never imported).

Each batch a FeatureSet yields counts in ``zoo_data_batches_total`` and
times its host materialisation (gather, memmap reads and a byte tier's
decode) in ``zoo_data_batch_gather_seconds``; a byte tier's decode alone
is ``zoo_data_decode_seconds``: the JAX package's families on the port's
registry (``common/telemetry.py``). An Estimator's first ``fit`` or
``evaluate`` reads one batch fewer than the JAX package's, which draws
one to trace its step (``engine/estimator.py``).

Multi-process ingest: :meth:`FeatureSet.from_host_shard` holds only this
process's rows (``data[process_index::process_count]`` of the global
dataset, or any balanced split); its ``batches(batch_size)`` walks the
local rows in a local seeded order and yields ``batch_size /
process_count`` of them per global step, so no process ever holds the
global dataset. The Estimator takes such a batch as the rank's own block
(a pure-dp mesh whose dp equals the process count).
"""

from __future__ import annotations

import itertools
import math
import os
import tempfile
import time
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np

from .. import native
from ..common import telemetry as _tm

_DATA_BATCHES = _tm.counter("zoo_data_batches_total",
                            "Host batches produced by FeatureSet iterators")
_DATA_GATHER = _tm.histogram("zoo_data_batch_gather_seconds",
                             "Host time to materialize one batch "
                             "(gather/slice, memmap reads, AND per-record "
                             "decode for byte-record tiers)")
_DATA_DECODE = _tm.histogram("zoo_data_decode_seconds",
                             "Per-batch record-decode time "
                             "(BytesFeatureSet.decoder over the gathered "
                             "records; subset of zoo_data_batch_gather_seconds)")


class MemoryType:
    DRAM = "DRAM"
    PMEM = "PMEM"
    # the reference's off-heap tier; numpy arrays already live off any
    # managed heap, so it is the DRAM tier
    DIRECT = "DIRECT"

    @staticmethod
    def DISK_AND_DRAM(num_slice: int) -> str:
        return f"DISK_AND_DRAM_{num_slice}"


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def _num_slices(memory_type: str) -> Optional[int]:
    """The epoch slices of a memmap tier; ``None`` for the DRAM tiers."""
    if memory_type in (MemoryType.DRAM, MemoryType.DIRECT):
        return None
    if memory_type == MemoryType.PMEM:
        return 1
    prefix = "DISK_AND_DRAM_"
    if memory_type.startswith(prefix) and memory_type[len(prefix):].isdigit():
        return int(memory_type[len(prefix):])
    raise ValueError(f"unknown memory_type {memory_type!r}; known: DRAM, "
                     f"DIRECT, PMEM, DISK_AND_DRAM(n)")


def _stack_rows(rows, what: str):
    """Stack per-example elements (arrays, tuples or dicts of arrays) into
    one array tree."""
    if not rows:
        raise ValueError(f"{what} yielded no elements")
    first = rows[0]
    if isinstance(first, dict):
        return {k: np.stack([np.asarray(r[k]) for r in rows]) for k in first}
    if isinstance(first, (tuple, list)):
        return tuple(np.stack([np.asarray(r[i]) for r in rows])
                     for i in range(len(first)))
    return np.stack([np.asarray(r) for r in rows])


class FeatureSet:
    """An immutable dataset of array trees sharing a leading dimension."""

    #: the data is this process's shard (:meth:`from_host_shard`)
    host_shard = False
    process_index = 0
    process_count = 1

    def __init__(self, data, memory_type: str = MemoryType.DRAM,
                 cache_dir: Optional[str] = None, seed: int = 0):
        leaves = _tree_leaves(data)
        if not leaves:
            raise ValueError("empty FeatureSet")
        n = leaves[0].shape[0]
        if any(leaf.shape[0] != n for leaf in leaves):
            raise ValueError("all arrays must share the leading dimension")
        slices = _num_slices(memory_type)
        self.memory_type = memory_type
        self.seed = seed
        self._n_total = n
        self.num_slices = slices or 1
        self._cache_dir = None
        if slices is None:
            self.data = data
        else:
            self._cache_dir = cache_dir or tempfile.mkdtemp(
                prefix="zoo_featureset_")
            counter = itertools.count()
            self.data = _tree_map(
                lambda a: self._to_memmap(a, next(counter)), data)

    # -------------------------------------------------------------- constructors
    @classmethod
    def from_numpy(cls, x, y=None, **kw) -> "FeatureSet":
        """Build from feature array(s) and optional label array(s)."""
        data = (x,) if y is None else (x, y)
        return cls(data, **kw)

    @classmethod
    def from_generator(cls, generator, max_elements: Optional[int] = None,
                       **kw) -> "FeatureSet":
        """Materialize a generator (or a callable returning one, or any
        iterable) of per-example elements: arrays, ``(x, y)`` tuples or
        dicts of arrays; at most ``max_elements``."""
        it = iter(generator() if callable(generator) else generator)
        if max_elements is not None:
            it = itertools.islice(it, max_elements)
        return cls(_stack_rows(list(it), "generator"), **kw)

    @classmethod
    def from_dataframe(cls, df, feature_cols: Sequence[str],
                       label_cols: Optional[Sequence[str]] = None,
                       **kw) -> "FeatureSet":
        """A DataFrame's columns as a FeatureSet: the feature columns
        stacked into one ``(N, F)`` array (cells holding arrays stack row
        by row), the label columns likewise, one label column squeezed to
        ``(N,)``."""

        def gather(cols, squeeze: bool):
            arrays = []
            for c in cols:
                col = df[c].to_numpy()
                if col.dtype == object:       # cells hold arrays or lists
                    col = np.stack([np.asarray(v) for v in col])
                arrays.append(col if col.ndim > 1 else col[:, None])
            out = arrays[0] if len(arrays) == 1 else np.concatenate(
                [a.astype(np.result_type(*[x.dtype for x in arrays]))
                 for a in arrays], axis=1)
            if squeeze and out.ndim == 2 and out.shape[1] == 1:
                return out[:, 0]
            return out

        x = gather(feature_cols, squeeze=False)
        if not label_cols:
            return cls((x,), **kw)
        return cls((x, gather(label_cols, squeeze=True)), **kw)

    @classmethod
    def from_bytes(cls, records: Sequence[bytes], decoder: Callable,
                   **kw) -> "BytesFeatureSet":
        """Raw byte records decoded at batch time: ``decoder(record)``
        returns one example's array tree, and only the records of the
        batch at hand are decoded."""
        return BytesFeatureSet(records, decoder, **kw)

    @classmethod
    def from_tf_dataset(cls, dataset, max_elements: Optional[int] = None,
                        **kw) -> "FeatureSet":
        """Materialize an unbatched ``tf.data.Dataset`` (anything with
        ``as_numpy_iterator()``) of tensors, ``(x, y)`` tuples or dicts:
        the pipeline runs on the host once, at most ``max_elements``
        elements."""
        it = dataset.as_numpy_iterator()
        if max_elements is not None:
            it = itertools.islice(it, max_elements)
        return cls(_stack_rows(list(it), "tf.data dataset"), **kw)

    @classmethod
    def from_tfrecord(cls, paths, feature_cols: Optional[Sequence[str]] = None,
                      label_cols: Optional[Sequence[str]] = None,
                      max_records: Optional[int] = None, **kw) -> "FeatureSet":
        """tf.Example TFRecord file(s) as a FeatureSet. Without
        ``feature_cols`` the tree is a dict of every feature; with them,
        ``(x,)`` or ``(x, y)``, where several columns make a tuple and a
        label column of width 1 is squeezed to ``(N,)``."""
        from .tfrecord import read_tfrecord_examples

        table = read_tfrecord_examples(paths, max_records=max_records)

        def label(c):
            arr = table[c]
            return arr[:, 0] if (arr.ndim == 2 and arr.shape[1] == 1) else arr

        if feature_cols is None:
            return cls(table, **kw)
        feats = tuple(table[c] for c in feature_cols)
        x = feats[0] if len(feats) == 1 else feats
        if not label_cols:
            return cls((x,), **kw)
        labels = tuple(label(c) for c in label_cols)
        y = labels[0] if len(labels) == 1 else labels
        return cls((x, y), **kw)

    @classmethod
    def from_xshards(cls, shards, **kw) -> "FeatureSet":
        """The partitions of an :class:`~.xshards.XShards`, concatenated."""
        from .xshards import XShards

        if not isinstance(shards, XShards):
            raise TypeError(f"from_xshards wants an XShards, got "
                            f"{type(shards).__name__}")
        return cls(shards.collect_tree(), **kw)

    @classmethod
    def from_host_shard(cls, data, process_index: Optional[int] = None,
                        process_count: Optional[int] = None,
                        **kw) -> "FeatureSet":
        """This process's slice of a dataset (e.g.
        ``data[process_index::process_count]``): ``batches`` then yields
        the local ``batch / process_count`` rows of each global step; keep
        the shards balanced (within a batch) so processes stay in
        lockstep. The ranks default to the ``torch.distributed`` job's
        (0 of 1 without one)."""
        import torch.distributed as dist

        job = dist.is_available() and dist.is_initialized()
        if process_index is None:
            process_index = dist.get_rank() if job else 0
        if process_count is None:
            process_count = dist.get_world_size() if job else 1
        fs = cls(data, **kw)
        fs.host_shard = True
        fs.process_index = int(process_index)
        fs.process_count = int(process_count)
        return fs

    def _local_batch_size(self, batch_size: int) -> int:
        if batch_size % self.process_count:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{self.process_count} processes")
        return batch_size // self.process_count

    # ----------------------------------------------------------------- internals
    def _to_memmap(self, arr: np.ndarray, i: int) -> np.ndarray:
        path = os.path.join(self._cache_dir, f"arr_{i}.npy")
        mm = np.lib.format.open_memmap(path, mode="w+", dtype=arr.dtype,
                                       shape=arr.shape)
        mm[:] = arr
        mm.flush()
        del mm
        return np.lib.format.open_memmap(path, mode="r")

    @staticmethod
    def _gather(a: np.ndarray, sel: np.ndarray) -> np.ndarray:
        """The rows ``sel`` of ``a``, in that order. A memmap is read in
        sorted index order (page-cache friendly); a C-contiguous,
        non-object DRAM array of at least 1 MiB goes through the native
        threaded gather (``native.gather_rows``), as in the JAX package:
        smaller ones are not worth the threads, a strided one would be
        copied whole per batch, and an object array's pointers must not be
        copied without their references."""
        if isinstance(a, np.memmap):
            order = np.argsort(sel, kind="stable")
            inv = np.empty_like(order)
            inv[order] = np.arange(len(order))
            return np.ascontiguousarray(a[sel[order]][inv])
        a = np.asarray(a)
        if (native.native_available() and a.nbytes >= (1 << 20)
                and a.flags["C_CONTIGUOUS"] and not a.dtype.hasobject):
            return native.gather_rows(a, sel)
        return np.ascontiguousarray(a[sel])

    # ------------------------------------------------------------------- API
    def size(self) -> int:
        return self._n_total

    def __len__(self) -> int:
        return self._n_total

    def shuffle_indices(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + epoch * 1_000_003)
        return rng.permutation(self._n_total)

    def num_batches(self, batch_size: int, drop_remainder: bool = True) -> int:
        if self.host_shard:
            batch_size = self._local_batch_size(batch_size)
        if drop_remainder:
            return self._n_total // batch_size
        return math.ceil(self._n_total / batch_size)

    def batches(self, batch_size: int, *, epoch: int = 0,
                shuffle: bool = True,
                drop_remainder: bool = True) -> Iterator:
        """Yield every batch of the epoch as a tree of numpy arrays, in the
        epoch's shuffled order (or in order: slices of the data),
        remainder dropped unless ``drop_remainder=False``. Each batch
        counts in ``zoo_data_batches_total`` and its host time in
        ``zoo_data_batch_gather_seconds``."""
        inner = self._iter_batches(batch_size, epoch=epoch, shuffle=shuffle,
                                   drop_remainder=drop_remainder)
        while True:
            t0 = time.perf_counter()
            try:
                b = next(inner)
            except StopIteration:
                return
            _DATA_GATHER.observe(time.perf_counter() - t0)
            _DATA_BATCHES.inc()
            yield b

    def _iter_batches(self, batch_size: int, *, epoch: int = 0,
                      shuffle: bool = True,
                      drop_remainder: bool = True) -> Iterator:
        nb = self.num_batches(batch_size, drop_remainder)
        if self.host_shard:
            batch_size = self._local_batch_size(batch_size)
        if not shuffle:
            for b in range(nb):
                lo = b * batch_size
                hi = min(lo + batch_size, self._n_total)
                yield _tree_map(lambda a: a[lo:hi], self.data)
            return
        idx = self.shuffle_indices(epoch)
        for b in range(nb):
            sel = idx[b * batch_size:(b + 1) * batch_size]
            yield _tree_map(lambda a: self._gather(a, sel), self.data)

    def row_slice(self, indices) -> object:
        """The rows at ``indices`` (any order, repeats allowed), in that
        order, as in-DRAM arrays; a memmap tier reads only those rows."""
        sel = np.asarray(indices)
        if sel.ndim != 1:
            raise ValueError(f"row_slice wants a 1-D index array, got "
                             f"shape {sel.shape}")
        if not np.issubdtype(sel.dtype, np.integer):
            raise ValueError(f"row_slice wants integer indices, got "
                             f"{sel.dtype}")
        if sel.size and (sel.min() < 0 or sel.max() >= self._n_total):
            raise IndexError(
                f"row_slice indices out of range [0, {self._n_total}): "
                f"min={sel.min()} max={sel.max()}")
        t0 = time.perf_counter()
        out = _tree_map(lambda a: self._gather(a, sel), self.data)
        _DATA_GATHER.observe(time.perf_counter() - t0)
        return out

    def _slice_bounds(self, num_slices: Optional[int]) -> List[slice]:
        k = num_slices or self.num_slices
        per = math.ceil(self._n_total / k)
        return [slice(i * per, min((i + 1) * per, self._n_total))
                for i in range(k)]

    def slices(self, num_slices: Optional[int] = None) -> List["FeatureSet"]:
        """Epoch slicing: contiguous sub-epoch DRAM FeatureSets (``num_
        slices``, else the tier's), slice ``i`` seeded ``seed + 17 (i +
        1)``."""
        return [FeatureSet(_tree_map(lambda a: np.asarray(a[sl]), self.data),
                           seed=self.seed + 17 * (i + 1))
                for i, sl in enumerate(self._slice_bounds(num_slices))]

    def transform(self, fn) -> "FeatureSet":
        """Apply ``fn`` to the whole tree on the host; a memmap tier stays
        one, in a new directory under its cache directory."""
        kw = {}
        if self._cache_dir is not None:
            kw = dict(memory_type=self.memory_type,
                      cache_dir=tempfile.mkdtemp(prefix="transform_",
                                                 dir=self._cache_dir))
        return FeatureSet(fn(self.data), seed=self.seed, **kw)


class BytesFeatureSet(FeatureSet):
    """Raw byte records and a per-record decoder, decoded at batch time
    only. The stored tier is an object array of ``bytes`` (always DRAM);
    shuffling and slicing act on the raw records, and ``batches`` decodes
    just the gathered ones through ``pipeline.decode_map`` (in parallel
    with ``decode_workers=None``, so the decoder must be thread-safe; 0
    decodes in line), in order."""

    def __init__(self, records: Sequence[bytes], decoder: Callable,
                 decode_workers: Optional[int] = None, seed: int = 0,
                 **kw):
        kw.pop("memory_type", None)
        arr = np.empty(len(records), dtype=object)
        arr[:] = list(records)
        super().__init__((arr,), seed=seed, **kw)
        self.decoder = decoder
        self.decode_workers = decode_workers

    def _iter_batches(self, batch_size: int, *, epoch: int = 0,
                      shuffle: bool = True,
                      drop_remainder: bool = True) -> Iterator:
        from .pipeline import decode_map

        for (raw,) in super()._iter_batches(batch_size, epoch=epoch,
                                            shuffle=shuffle,
                                            drop_remainder=drop_remainder):
            t0 = time.perf_counter()
            rows = decode_map(self.decoder, raw, self.decode_workers)
            first = rows[0]
            if isinstance(first, (dict, tuple, list)):
                out = _stack_rows(rows, "decoder")
            else:
                out = (np.stack(rows),)
            _DATA_DECODE.observe(time.perf_counter() - t0)
            yield out

    def slices(self, num_slices: Optional[int] = None) -> List["FeatureSet"]:
        """Sub-epoch slices of the raw records; each keeps the decoder."""
        return [BytesFeatureSet(list(self.data[0][sl]), self.decoder,
                                decode_workers=self.decode_workers,
                                seed=self.seed + 17 * (i + 1))
                for i, sl in enumerate(self._slice_bounds(num_slices))]

    def transform(self, fn) -> "FeatureSet":
        """Transform the raw record array; the decoder rides along."""
        (arr,) = fn(self.data)
        return BytesFeatureSet(list(arr), self.decoder,
                               decode_workers=self.decode_workers,
                               seed=self.seed)


__all__ = ["BytesFeatureSet", "FeatureSet", "MemoryType"]
