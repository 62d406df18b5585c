"""The file and partitioned data tiers of the PyTorch port against the JAX
package, on the CPU: TFRecord, XShards and the FeatureSet constructors
over them.

Held: the TFRecord framing and the tf.Example codec write the same bytes
in both packages and each reads the other's files to the same arrays
(bytes, float and int64 features, negative ints, multi-value and packed
lists); a flipped byte is caught by the CRC check in both; ragged and
missing features raise as in JAX; ``FeatureSet.from_tfrecord`` gives the
JAX package's tree and batches; XShards partitions, lazy and eager
transforms, ``collect_tree``, ``repartition``, ``host_split`` and
``to_featureset`` equal JAX's, pandas only through its readers;
``FeatureSet.from_xshards`` and ``from_tf_dataset`` (a duck-typed stand-in
with ``as_numpy_iterator()``) equal JAX's.
"""

import numpy as np
import pytest

from analytics_zoo_tpu.data import featureset as jfs
from analytics_zoo_tpu.data import tfrecord as jtf
from analytics_zoo_tpu.data import xshards as jxs
from analytics_zoo_tpu_torch.data import featureset as tfs
from analytics_zoo_tpu_torch.data import tfrecord as ttf
from analytics_zoo_tpu_torch.data import xshards as txs


def _examples(n=12, seed=0):
    rng = np.random.default_rng(seed)
    return [{"ids": rng.integers(-2 ** 40, 2 ** 40, 5),
             "x": rng.normal(size=3).astype(np.float32),
             "label": [int(rng.integers(0, 4))],
             "name": [f"row{i}".encode(), b"\x00\xff"],
             "flag": np.array([i % 2], np.int64)} for i in range(n)]


def _same_tree(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for u, v in zip(a, b):
            _same_tree(u, v)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


def test_examples_and_records_are_the_same_bytes_both_ways(tmp_path):
    exs = _examples()
    enc_t = [ttf.encode_example(e) for e in exs]
    assert enc_t == [jtf.encode_example(e) for e in exs]
    pt, pj = str(tmp_path / "t.tfrecord"), str(tmp_path / "j.tfrecord")
    assert ttf.write_records(pt, enc_t) == jtf.write_records(pj, enc_t) == 12
    with open(pt, "rb") as f, open(pj, "rb") as g:
        assert f.read() == g.read()
    for reader in (ttf, jtf):
        for path in (pt, pj):
            recs = list(reader.read_records(path, verify_crc=True))
            assert recs == enc_t
    for rec in enc_t:
        _same_tree(ttf.decode_example(rec), jtf.decode_example(rec))
    _same_tree(ttf.read_tfrecord_examples([pt, pj], max_records=20),
               jtf.read_tfrecord_examples([pt, pj], max_records=20))


def test_a_flipped_byte_is_caught_by_the_crc(tmp_path):
    path = str(tmp_path / "c.tfrecord")
    ttf.write_records(path, [ttf.encode_example(e) for e in _examples(3)])
    raw = bytearray(open(path, "rb").read())
    for at, what in ((3, "length CRC"), (20, "data CRC")):
        bad = bytearray(raw)
        bad[at] ^= 0x40
        p = str(tmp_path / f"bad{at}.tfrecord")
        with open(p, "wb") as f:
            f.write(bytes(bad))
        for reader in (ttf, jtf):
            with pytest.raises(ValueError, match=what):
                list(reader.read_records(p, verify_crc=True))
    short = str(tmp_path / "short.tfrecord")
    with open(short, "wb") as f:
        f.write(bytes(raw[:-3]))
    with pytest.raises(ValueError, match="truncated"):
        list(ttf.read_records(short))


def test_ragged_and_missing_features_raise_as_in_jax(tmp_path):
    for rows, what in (([{"a": [1, 2]}, {"a": [3]}], "ragged"),
                       ([{"a": [1]}, {"b": [2]}], "missing")):
        p = str(tmp_path / f"{what}.tfrecord")
        ttf.write_records(p, [ttf.encode_example(r) for r in rows])
        for reader in (ttf, jtf):
            with pytest.raises(ValueError, match=what):
                reader.read_tfrecord_examples(p)


@pytest.mark.parametrize("cols", [(None, None), (["x"], ["label"]),
                                  (["x", "ids"], None),
                                  (["x"], ["label", "flag"])])
def test_from_tfrecord_matches_jax(tmp_path, cols):
    path = str(tmp_path / "f.tfrecord")
    rows = [{k: v for k, v in e.items() if k != "name"} for e in _examples()]
    ttf.write_records(path, [ttf.encode_example(r) for r in rows])
    t = tfs.FeatureSet.from_tfrecord(path, *cols, seed=3)
    j = jfs.FeatureSet.from_tfrecord(path, *cols, seed=3)
    _same_tree(t.data, j.data)
    for shuffle in (False, True):
        for a, b in zip(t.batches(5, shuffle=shuffle),
                        j.batches(5, shuffle=shuffle)):
            _same_tree(a, b)


def _shards(mod, kind):
    rng = np.random.default_rng(1)
    if kind == "dict":
        data = {"a": rng.normal(size=(10, 2)).astype(np.float32),
                "b": rng.integers(0, 9, 10)}
    else:
        data = rng.normal(size=(10, 3)).astype(np.float32)
    return mod.XShards.partition(data, num_partitions=3)


@pytest.mark.parametrize("kind", ["dict", "array"])
def test_xshards_match_jax(kind):
    t, j = _shards(txs, kind), _shards(jxs, kind)
    assert t.num_partitions() == j.num_partitions() == 3
    _same_tree(t.collect(), j.collect())
    assert len(t) == len(j) == 10

    def double(p):
        return {k: v * 2 for k, v in p.items()} if isinstance(p, dict) \
            else p * 2

    for lazy in (False, True):
        tt = t.transform_shard(double, lazy=lazy)
        jj = j.transform_shard(double, lazy=lazy)
        assert bool(tt._pending) is lazy
        _same_tree(tt.collect_tree(), jj.collect_tree())
    _same_tree(t.repartition(4).collect(), j.repartition(4).collect())
    _same_tree(t.host_split(1, 2).collect(), j.host_split(1, 2).collect())
    ft = tfs.FeatureSet.from_xshards(t, seed=2)
    fj = jfs.FeatureSet.from_xshards(j, seed=2)
    _same_tree(ft.data, fj.data)
    for a, b in zip(ft.batches(4), fj.batches(4)):
        _same_tree(a, b)
    with pytest.raises(TypeError):
        tfs.FeatureSet.from_xshards(t.collect())
    # parallel_apply runs in orca's TaskPool workers, as the serial apply
    _same_tree(t.parallel_apply(double, num_workers=2).collect_tree(),
               t.transform_shard(double).collect_tree())


def test_xshards_to_featureset_over_frames_matches_jax():
    pd = pytest.importorskip("pandas")
    rng = np.random.default_rng(2)
    df = pd.DataFrame({"a": rng.normal(size=9), "b": rng.normal(size=9),
                       "y": rng.integers(0, 2, 9)})
    t, j = txs.XShards.partition(df, 2), jxs.XShards.partition(df, 2)
    _same_tree(t.to_featureset(["a", "b"], ["y"]).data,
               j.to_featureset(["a", "b"], ["y"]).data)


def test_xshards_readers_match_jax(tmp_path):
    pd = pytest.importorskip("pandas")
    df = pd.DataFrame({"a": np.arange(7.0), "b": list("abcdefg")})
    df.to_csv(tmp_path / "d.csv", index=False)
    df.to_json(tmp_path / "d.json")
    for reader in ("read_csv", "read_json"):
        path = str(tmp_path / ("d." + reader[5:]))
        t = getattr(txs.XShards, reader)(path, num_partitions=2)
        j = getattr(jxs.XShards, reader)(path, num_partitions=2)
        for a, b in zip(t.collect(), j.collect()):
            assert a.equals(b)


class _Dataset:
    """A stand-in for an unbatched ``tf.data.Dataset``."""

    def __init__(self, rows):
        self.rows = rows

    def as_numpy_iterator(self):
        return iter(self.rows)


@pytest.mark.parametrize("kind", ["array", "tuple", "dict"])
def test_from_tf_dataset_matches_jax(kind):
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(9, 4)).astype(np.float32)
    ys = rng.integers(0, 3, 9)
    rows = {"array": list(xs), "tuple": list(zip(xs, ys)),
            "dict": [{"x": a, "y": b} for a, b in zip(xs, ys)]}[kind]
    for cap in (None, 5):
        t = tfs.FeatureSet.from_tf_dataset(_Dataset(rows), max_elements=cap)
        j = jfs.FeatureSet.from_tf_dataset(_Dataset(rows), max_elements=cap)
        _same_tree(t.data, j.data)
    with pytest.raises(ValueError, match="no elements"):
        tfs.FeatureSet.from_tf_dataset(_Dataset([]))
