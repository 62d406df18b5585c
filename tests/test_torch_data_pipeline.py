"""The prefetching input pipeline and the FeatureSet tiers of the PyTorch
port, against the JAX package where it has a counterpart, on the CPU.

Held: ``PrefetchLoader`` at depths 0, 2 and 4 yields the synchronous
stream byte for byte (and through ``PinnedCopy``, the same values as
tensors); an error of the source, of ``put_fn`` or of the
``data.prefetch`` chaos site surfaces at the consumer's ``next()``;
``close()`` is idempotent mid-epoch, stops a producer blocked on a full
queue and leaves no thread alive; ``decode_map`` keeps order. The
``DISK_AND_DRAM(n)`` and ``PMEM`` tiers, ``from_bytes``,
``from_generator`` and ``from_dataframe`` give the JAX FeatureSet's
batches for the same seed, bit for bit, and so do ``slices``,
``transform`` and ``row_slice``. ``fit`` at ``prefetch_depth`` 0 and 2
gives the same losses bit for bit, within 1e-5 of the JAX Estimator's
over the same byte records, and ``evaluate`` and ``predict`` the same
results; no producer thread outlives ``fit``, ``evaluate``, ``predict``
or a step's exception; a SIGTERM'd fit at depth 2 saves and exits 143.
"""

import ast
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from jax.sharding import Mesh

from analytics_zoo_tpu.common import config as jconfig
from analytics_zoo_tpu.data import featureset as jfs
from analytics_zoo_tpu.data import pipeline as jpipe
from analytics_zoo_tpu.engine.estimator import Estimator as JEstimator
from analytics_zoo_tpu.nn import layers as JL
from analytics_zoo_tpu.nn import optimizers as jopt
from analytics_zoo_tpu.nn.topology import Sequential as JSequential
from analytics_zoo_tpu_torch.bridge import state_dict_from_jax
from analytics_zoo_tpu_torch.common.chaos import KNOWN_SITES, ChaosSchedule
from analytics_zoo_tpu_torch.common.config import TrainConfig, check_ported
from analytics_zoo_tpu_torch.data import featureset as tfs
from analytics_zoo_tpu_torch.data import pipeline as tpipe
from analytics_zoo_tpu_torch.engine import checkpoint as tck
from analytics_zoo_tpu_torch.engine.estimator import Estimator
from analytics_zoo_tpu_torch.nn import layers as TL
from analytics_zoo_tpu_torch.nn import optimizers as topt
from analytics_zoo_tpu_torch.nn.topology import Sequential

REPO = Path(__file__).resolve().parent.parent
AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")
TIERS = ["DRAM", "DISK_AND_DRAM_3", "PMEM"]


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape((1,) * 6), AXES)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("zoo-prefetch") and t.is_alive()]


def _tree(n=103, seed=0):
    rng = np.random.default_rng(seed)
    return ({"a": rng.normal(size=(n, 3)).astype(np.float32),
             "b": rng.integers(0, 9, (n, 2, 2)).astype(np.int32)},
            rng.integers(0, 5, n).astype(np.int64))


def _leaves(tree):
    return jfs._tree_leaves(tree)


def _assert_same_stream(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gl, wl = _leaves(g), _leaves(w)
        assert len(gl) == len(wl)
        for a, b in zip(gl, wl):
            a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            assert a.dtype == np.asarray(b).dtype and a.shape == b.shape
            assert a.tobytes() == np.asarray(b).tobytes()


# ------------------------------------------------------------ PrefetchLoader

@pytest.mark.parametrize("depth", [0, 2, 4])
def test_loader_stream_is_the_sync_stream(depth):
    fs = tfs.FeatureSet(_tree(), seed=3)
    for epoch, shuffle, drop in ((0, True, True), (1, True, True),
                                 (0, False, False)):
        kw = dict(epoch=epoch, shuffle=shuffle, drop_remainder=drop)
        want = list(fs.batches(16, **kw))
        loader = tpipe.PrefetchLoader(fs, 16, depth=depth, **kw)
        with loader:
            got = list(loader)
        _assert_same_stream(got, want)
        copy = tpipe.PinnedCopy("cpu")
        loader = tpipe.PrefetchLoader(fs, 16, depth=depth, put_fn=copy, **kw)
        with loader:
            got = [copy.ready(item) for item in loader]
        _assert_same_stream(got, want)
    assert not _prefetch_threads()


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("where", ["source", "put_fn", "chaos"])
def test_errors_surface_at_the_consumers_next(depth, where):
    batches = [np.full((2,), i) for i in range(6)]

    def source():
        for i, b in enumerate(batches):
            if where == "source" and i == 3:
                raise KeyError("bad record")
            yield b

    def put(b):
        if where == "put_fn" and int(b[0]) == 3:
            raise KeyError("bad copy")
        return b

    sched = ChaosSchedule()
    if where == "chaos":
        sched.fail("data.prefetch", at=4, exc=KeyError)
    got = []
    with sched:       # installed before the producer starts
        loader = tpipe.PrefetchLoader(source(), put_fn=put, depth=depth)
        try:
            with pytest.raises(KeyError):
                for b in loader:
                    got.append(int(b[0]))
        finally:
            loader.close()
    assert got == [0, 1, 2]
    assert not _prefetch_threads()


def test_close_is_idempotent_mid_epoch_and_stops_a_blocked_producer():
    fs = tfs.FeatureSet(_tree(400), seed=1)
    loader = tpipe.PrefetchLoader(fs, 4, depth=2)
    it = iter(loader)
    next(it)
    deadline = time.time() + 10
    while loader.queue_depth() < 2:           # the producer is now blocked
        assert time.time() < deadline
        time.sleep(0.01)
    assert loader.queue_depth() == 2
    loader.close()
    loader.close()
    assert not loader._thread.is_alive()
    assert loader.queue_depth() == 0
    assert list(it) == []                     # a closed loader ends
    with pytest.raises(RuntimeError, match="single-pass"):
        iter(loader).__next__()
    assert tpipe.PrefetchLoader(fs, 4, depth=0).queue_depth() == 0
    with pytest.raises(TypeError, match="batch_size"):
        tpipe.PrefetchLoader(fs)
    assert not _prefetch_threads()


def test_device_prefetch_on_the_cpu():
    batches = [np.arange(6, dtype=np.float32).reshape(2, 3) + i
               for i in range(5)]
    got = list(tpipe.device_prefetch(iter(batches), "cpu", depth=2))
    _assert_same_stream(got, batches)
    assert all(isinstance(g, torch.Tensor) for g in got)
    assert not _prefetch_threads()


def test_decode_map_keeps_order_and_raises_the_first_error():
    items = list(range(37))
    for workers in (None, 0, 1, 2, 5):
        assert tpipe.decode_map(lambda v: v * v, items, workers) == \
            [v * v for v in items]
    assert tpipe.decode_map(str, [1, 2], 4) == ["1", "2"]

    def bad(v):
        if v == 20:
            raise ValueError("record 20")
        return v

    with pytest.raises(ValueError, match="record 20"):
        tpipe.decode_map(bad, items, 4)
    assert tpipe.decode_map(bad, items[:5], 4) == items[:5]
    assert all(t.daemon for t in threading.enumerate()
               if t.name.startswith("zoo-decode"))
    # the same split as the JAX package's
    assert jpipe.decode_map(lambda v: -v, items, 3) == \
        tpipe.decode_map(lambda v: -v, items, 3)


def test_every_chaos_point_of_the_port_is_a_known_site():
    sites = set()
    for path in (REPO / "analytics_zoo_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) == "chaos_point"):
                arg = node.args[0]
                assert isinstance(arg, ast.Constant), path
                sites.add(arg.value)
    assert "data.prefetch" in sites
    assert sites <= KNOWN_SITES
    from analytics_zoo_tpu.common.chaos import KNOWN_SITES as JSITES

    assert KNOWN_SITES <= JSITES


# ----------------------------------------------------------- FeatureSet tiers

def _jax_fs(tier, data, tmp_path, seed):
    return jfs.FeatureSet(data, memory_type=tier, seed=seed,
                          cache_dir=str(tmp_path / "jax"))


@pytest.mark.parametrize("tier", TIERS)
def test_tiers_give_the_jax_batches(tier, tmp_path):
    data = _tree()
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    j = _jax_fs(tier, data, tmp_path, 5)
    t = tfs.FeatureSet(data, memory_type=tier, seed=5,
                       cache_dir=str(tmp_path / "port"))
    assert t.num_slices == j.num_slices and len(t) == len(j)
    if tier != "DRAM":
        assert all(isinstance(a, np.memmap) for a in _leaves(t.data))
        assert sorted(os.listdir(tmp_path / "port")) == \
            sorted(os.listdir(tmp_path / "jax"))
    for kw in (dict(epoch=0), dict(epoch=2),
               dict(shuffle=False, drop_remainder=False)):
        _assert_same_stream(list(t.batches(16, **kw)),
                            list(j.batches(16, **kw)))
    sel = np.array([7, 3, 3, 100, 0])
    _assert_same_stream([t.row_slice(sel)], [j.row_slice(sel)])
    for k in (None, 2):
        ts, js = t.slices(k), j.slices(k)
        assert len(ts) == len(js)
        for a, b in zip(ts, js):
            assert a.seed == b.seed
            _assert_same_stream(list(a.batches(8)), list(b.batches(8)))

    def double(tree):
        return jfs._tree_map(lambda a: np.asarray(a) * 2, tree)

    tt, jt = t.transform(double), j.transform(double)
    assert tt.memory_type == jt.memory_type == tier
    _assert_same_stream(list(tt.batches(16)), list(jt.batches(16)))
    with pytest.raises(IndexError):
        t.row_slice([len(t)])
    with pytest.raises(ValueError, match="integer"):
        t.row_slice([0.5])


def test_memory_type_names_equal_jax():
    assert tfs.MemoryType.DISK_AND_DRAM(4) == jfs.MemoryType.DISK_AND_DRAM(4)
    assert (tfs.MemoryType.PMEM, tfs.MemoryType.DIRECT) == \
        (jfs.MemoryType.PMEM, jfs.MemoryType.DIRECT)
    with pytest.raises(ValueError, match="memory_type"):
        tfs.FeatureSet(_tree(), memory_type="DISK")
    fs = tfs.FeatureSet(_tree(), memory_type="DIRECT")
    assert fs.num_slices == 1 and fs.data is not None


def _records(n=70, width=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=width).astype(np.float32).tobytes()
            for _ in range(n)]


def _decode_xy(rec):
    v = np.frombuffer(rec, np.float32)
    return v, np.float32(v.sum())


@pytest.mark.parametrize("decoder", ["array", "tuple", "dict"])
def test_from_bytes_gives_the_jax_batches(decoder):
    fn = {"array": lambda r: np.frombuffer(r, np.float32),
          "tuple": _decode_xy,
          "dict": lambda r: {"x": np.frombuffer(r, np.float32)}}[decoder]
    recs = _records()
    t = tfs.FeatureSet.from_bytes(recs, fn, seed=2, decode_workers=3)
    j = jfs.FeatureSet.from_bytes(recs, fn, seed=2, decode_workers=3)
    for kw in (dict(epoch=0), dict(epoch=1),
               dict(shuffle=False, drop_remainder=False)):
        _assert_same_stream(list(t.batches(16, **kw)),
                            list(j.batches(16, **kw)))
    for a, b in zip(t.slices(3), j.slices(3)):
        _assert_same_stream(list(a.batches(8)), list(b.batches(8)))
    rev = t.transform(lambda d: (d[0][::-1],))
    jrev = j.transform(lambda d: (d[0][::-1],))
    assert isinstance(rev, tfs.BytesFeatureSet)
    _assert_same_stream(list(rev.batches(16)), list(jrev.batches(16)))


def test_from_generator_and_dataframe_give_the_jax_batches():
    rng = np.random.default_rng(3)
    rows = [(rng.normal(size=3).astype(np.float32), np.int32(i % 4))
            for i in range(50)]
    for make in (lambda: iter(rows), lambda: (lambda: iter(rows))):
        t = tfs.FeatureSet.from_generator(make(), max_elements=45, seed=1)
        j = jfs.FeatureSet.from_generator(make(), max_elements=45, seed=1)
        assert len(t) == 45
        _assert_same_stream(list(t.batches(8)), list(j.batches(8)))
    dicts = [{"x": r[0], "y": r[1]} for r in rows]
    _assert_same_stream(
        list(tfs.FeatureSet.from_generator(dicts).batches(8)),
        list(jfs.FeatureSet.from_generator(dicts).batches(8)))
    with pytest.raises(ValueError, match="no elements"):
        tfs.FeatureSet.from_generator([])
    df = pd.DataFrame({"a": rng.normal(size=30).astype(np.float32),
                       "b": rng.integers(0, 5, 30),
                       "v": [rng.normal(size=2) for _ in range(30)],
                       "label": rng.integers(0, 2, 30)})
    for feats, labels in ((["a", "b"], ["label"]), (["v", "a"], None),
                          (["a"], ["label", "b"])):
        t = tfs.FeatureSet.from_dataframe(df, feats, labels, seed=4)
        j = jfs.FeatureSet.from_dataframe(df, feats, labels, seed=4)
        _assert_same_stream(list(t.batches(8)), list(j.batches(8)))


def test_unported_constructors_raise_naming_their_item(tmp_path):
    """Multi-host ingest is ported: a host shard yields its share of each
    global batch, in the JAX package's order (the multi-rank fit is held
    in tests/test_torch_update_sharding.py); the tf.data, TFRecord and
    XShards constructors are ported (held to the JAX package in
    tests/test_torch_file_data.py) and build a FeatureSet."""
    rows = np.arange(40, dtype=np.float32).reshape(20, 2)
    t = tfs.FeatureSet.from_host_shard(rows[1::2], process_index=1,
                                       process_count=2, seed=3)
    j = jfs.FeatureSet.from_host_shard(rows[1::2], process_index=1,
                                       process_count=2, seed=3)
    assert t.num_batches(4) == j.num_batches(4) == 5
    _assert_same_stream(list(t.batches(4, epoch=1)),
                        list(j.batches(4, epoch=1)))
    from analytics_zoo_tpu_torch.data.tfrecord import (encode_example,
                                                       write_records)
    from analytics_zoo_tpu_torch.data.xshards import XShards

    x = np.arange(12, dtype=np.float32).reshape(6, 2)

    class _Dataset:
        def as_numpy_iterator(self):
            return iter(list(x))

    path = str(tmp_path / "a.tfrecord")
    write_records(path, [encode_example({"x": r}) for r in x])
    for fs in (tfs.FeatureSet.from_tf_dataset(_Dataset()),
               tfs.FeatureSet.from_tfrecord(path, ["x"]),
               tfs.FeatureSet.from_xshards(XShards.partition(x, 3))):
        assert len(fs) == 6
        b = next(fs.batches(6, shuffle=False))
        np.testing.assert_array_equal(b[0] if isinstance(b, tuple) else b, x)


# ---------------------------------------------------------------- Estimator

def _bytes_recipe(n=96, width=16, seed=0):
    """``bench.py::run_data_pipeline``'s recipe at a small size: float32
    records decoded by a sort and a matmul, an MLP, SGD, MSE."""
    rng = np.random.default_rng(seed)
    recs = [rng.normal(size=width).astype(np.float32).tobytes()
            for _ in range(n)]
    proj = rng.normal(size=(width, width)).astype(np.float32) / width

    def decode(rec):
        v = np.sort(np.frombuffer(rec, np.float32)) @ proj
        return v.astype(np.float32), np.float32(v.sum())[None]

    return recs, decode


def _mlp(L, Seq, width=16, **kw):
    return Seq([L.Dense(12, activation="relu", input_shape=(width,)),
                L.Dense(12, activation="relu"), L.Dense(1)], **kw)


def _port_run(model, data, depth, epochs=2, **cfg):
    """Fit, recording each step's loss and each loader the Estimator
    made: ``(depth, whether it started a producer thread)``."""
    est = Estimator(model, optimizer=topt.SGD(lr=0.05), loss="mse",
                    config=TrainConfig(prefetch_depth=depth, **cfg))
    losses, loaders, step = [], [], est._step

    def recording(b):
        loss, gnorm = step(b)
        losses.append(float(loss))
        return loss, gnorm

    class Recorded(tpipe.PrefetchLoader):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            loaders.append((self.depth, self._thread is not None))

    est._step = recording
    plain = tpipe.PrefetchLoader
    tpipe.PrefetchLoader = Recorded
    try:
        est.fit(data, batch_size=16, epochs=epochs, seed=2)
    finally:
        tpipe.PrefetchLoader = plain
    return est, losses, loaders


def test_fit_at_depths_0_and_2_equal_each_other_and_jax():
    recs, decode = _bytes_recipe()
    jm = _mlp(JL, JSequential)
    params, state = jm.build(jax.random.PRNGKey(0))
    weights = state_dict_from_jax(_np(params), _np(state))  # JAX donates
    jest = JEstimator(jm, optimizer=jopt.SGD(lr=0.05), loss="mse",
                      mesh=_mesh(), config=jconfig.TrainConfig())
    jest.initial_weights = (params, state)
    want, jstep = [], jest._make_train_step()

    def jrecord(st, b):
        st, (loss, gnorm) = jstep(st, b)
        want.append(float(loss))
        return st, (loss, gnorm)

    jest._train_step = jrecord
    jest.fit(jfs.FeatureSet.from_bytes(recs, decode), batch_size=16,
             epochs=2, seed=2)
    runs = {}
    for depth in (0, 2):
        model = _mlp(TL, Sequential, device="cpu")
        model.load_state_dict(weights)
        data = tfs.FeatureSet.from_bytes(recs, decode)
        est, losses, threads = _port_run(model, data, depth)
        x = np.stack([decode(r)[0] for r in recs])
        y = np.stack([decode(r)[1] for r in recs])
        runs[depth] = (losses, threads, est.evaluate(
            (x, y), batch_size=20, metrics=["mae"]),
            est.predict(x, batch_size=20))
    assert len(want) == len(runs[0][0]) == 2 * (len(recs) // 16)
    assert runs[0][0] == runs[2][0]
    np.testing.assert_allclose(runs[2][0], want, rtol=1e-5, atol=1e-6)
    # one loader an epoch: a producer thread at depth 2, none at depth 0
    assert runs[0][1] == [(0, False)] * 2 and runs[2][1] == [(2, True)] * 2
    assert runs[0][2] == runs[2][2]
    np.testing.assert_array_equal(runs[0][3], runs[2][3])
    assert not _prefetch_threads()


def test_prefetch_depth_is_honoured_at_any_depth():
    for depth in (0, 1, 2, 4, 8):
        assert check_ported(TrainConfig(prefetch_depth=depth))
    x = np.random.default_rng(0).normal(size=(64, 16)).astype(np.float32)
    y = x.sum(1, keepdims=True)
    seen = []
    for depth in (0, 1, 4):
        est, losses, threads = _port_run(_mlp(TL, Sequential, device="cpu"),
                                         (x, y), depth, epochs=1)
        seen.append(losses)
        assert threads == [(depth, depth > 0)]
    assert seen[0] == seen[1] == seen[2]


def test_no_producer_outlives_fit_evaluate_predict_or_an_exception():
    x = np.random.default_rng(1).normal(size=(64, 16)).astype(np.float32)
    y = x.sum(1, keepdims=True)
    model = _mlp(TL, Sequential, device="cpu")
    est = Estimator(model, optimizer="sgd", loss="mse",
                    config=TrainConfig(prefetch_depth=2))
    est.fit((x, y), batch_size=8, epochs=1)
    assert not _prefetch_threads()
    est.evaluate((x, y), batch_size=8, metrics=["mae"])
    est.predict(x, batch_size=8)
    assert not _prefetch_threads()
    with ChaosSchedule().fail("estimator.step", at=3, exc=KeyError):
        with pytest.raises(KeyError):
            est.fit((x, y), batch_size=8, epochs=2)
    assert not _prefetch_threads()
    with ChaosSchedule().fail("data.prefetch", at=2, exc=KeyError):
        with pytest.raises(KeyError):
            est.fit((x, y), batch_size=8, epochs=3)
    assert not _prefetch_threads()


def test_cache_on_device_streams_a_memmap_tier(tmp_path):
    """As in the JAX Estimator, only a DRAM set of arrays goes to the card
    once; a memmap tier streams through the loader, as DRAM streams."""
    x = np.random.default_rng(2).normal(size=(64, 16)).astype(np.float32)
    y = x.sum(1, keepdims=True)
    runs = []
    for tier, cached in (("DRAM", False), ("PMEM", True)):
        data = tfs.FeatureSet((x, y), memory_type=tier,
                              cache_dir=str(tmp_path))
        _, losses, threads = _port_run(_mlp(TL, Sequential, device="cpu"),
                                       data, 2, epochs=1,
                                       cache_on_device=cached)
        runs.append(losses)
        assert threads == [(2, True)]
    assert runs[0] == runs[1]


SIGTERM_WORKER = textwrap.dedent("""
    import atexit
    import sys
    import threading
    import numpy as np
    sys.path.insert(0, {repo!r})

    from analytics_zoo_tpu_torch.common.chaos import (ChaosSchedule,
                                                      install_chaos)
    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.nn import layers as L
    from analytics_zoo_tpu_torch.nn.topology import Sequential

    atexit.register(lambda: print("THREADS", sorted(
        t.name for t in threading.enumerate()
        if t.name.startswith("zoo-prefetch") and t.is_alive()), flush=True))
    install_chaos(ChaosSchedule().delay("estimator.step", at=None,
                                        seconds=0.02))
    model = Sequential([L.Dense(8, activation="relu", input_shape=(4,)),
                        L.Dense(1)], device="cpu", seed=0)
    x = np.random.default_rng(0).standard_normal((256, 4)).astype("float32")
    y = x.sum(axis=1, keepdims=True).astype("float32")
    est = Estimator(model, optimizer="adam", loss="mse",
                    config=TrainConfig(checkpoint_dir=sys.argv[1],
                                       prefetch_depth=2))
    est.fit((x, y), batch_size=16, epochs=100000)
    print("FINISHED", flush=True)   # never reached
""")


def test_sigterm_at_depth_2_saves_and_exits_143(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(SIGTERM_WORKER.format(repo=str(REPO)))
    ckpt = str(tmp_path / "ckpt")
    proc = subprocess.Popen([sys.executable, str(script), ckpt],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 120
        while tck.latest_checkpoint(ckpt) is None:
            assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
            assert time.time() < deadline, "no checkpoint within 120 s"
            time.sleep(0.05)
        time.sleep(0.1)                       # mid-epoch
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 143, err.decode()[-2000:]
    assert b"FINISHED" not in out
    assert b"THREADS []" in out, out.decode()[-500:]
    final = tck.verify_checkpoint(tck.latest_checkpoint(ckpt))
    assert final["iteration"] >= 16
