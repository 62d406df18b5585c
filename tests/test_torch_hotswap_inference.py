"""The port's InferenceModel hot swap, weight-only int8 packing and row
deltas, and the publish half of its checkpoints, against the JAX
package's, on the CPU.

Both packages load the same JAX-built weights. ``swap_params`` to the
weights x 1.01 gives outputs within 1e-5 of JAX's after the same swap,
float and int8, and a swapped int8 model predicts bit for bit what a fresh
port model quantized from the new weights predicts. ``host_params`` gives
JAX's values and swaps back without a bit changing. Weight-only packing
gives JAX's ``_quantize_leaf`` codes and scales (its 1e-8 amax floor, seen
on an all-zero leaf). ``save_row_delta`` writes JAX's arrays and
``row_delta`` record from the same base and params; ``read_row_delta``
validates and ``apply_row_delta`` moves only the touched rows, as a full
swap to the same params would.
"""

import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.engine import checkpoint as jckpt
from analytics_zoo_tpu.inference import InferenceModel as JaxInferenceModel
from analytics_zoo_tpu.inference import summary as jsum
from analytics_zoo_tpu.inference.inference_model import \
    _quantize_leaf as jax_quantize_leaf
from analytics_zoo_tpu.nn import layers as JL
from analytics_zoo_tpu.nn.graph import Input as JaxInput
from analytics_zoo_tpu.nn.topology import Model as JaxModel
from analytics_zoo_tpu.nn.topology import Sequential as JaxSequential
from analytics_zoo_tpu_torch.bridge import nest
from analytics_zoo_tpu_torch.common import telemetry as ttm
from analytics_zoo_tpu_torch.engine import checkpoint as tckpt
from analytics_zoo_tpu_torch.inference import summary as tsum
from analytics_zoo_tpu_torch.inference.inference_model import (
    InferenceModel, _quantize_leaf)
from analytics_zoo_tpu_torch.nn import layers as TL
from analytics_zoo_tpu_torch.nn.graph import Input
from analytics_zoo_tpu_torch.nn.topology import Model, Sequential


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _scaled(tree, f=1.01):
    return jax.tree_util.tree_map(lambda a: (a * np.float32(f)).astype(
        a.dtype), tree)


def _graph_pair(seed=0):
    """The same graph in both packages: a conv branch, a Dense at exactly
    4096 elements and a nested Sequential."""
    def build(L, In, Mod, Seq, **kw):
        inp = In((8, 8, 4))
        a = L.Convolution2D(16, 3, 3, border_mode="same")(inp)
        a = L.Convolution2D(32, 3, 3, border_mode="same")(a)
        a = L.GlobalAveragePooling2D()(a)
        b = L.Dense(128)(a)
        c = L.Dense(127)(a)
        sub = Seq([L.Dense(64, input_shape=(255,)), L.Dense(3)], **kw)
        out = sub(L.Merge(mode="concat")([b, c]))
        return Mod(inp, out, **kw)

    jm = build(JL, JaxInput, JaxModel, JaxSequential)
    tm = build(TL, Input, Model, Sequential, device="cpu")
    params, state = jm.build(jax.random.PRNGKey(seed))
    return jm, _np(params), _np(state), tm


def _seq_pair(seed=0):
    """Embedding (200 x 32 = 6400 elements) -> GRU(8) -> Dense(4): no
    Dense or Convolution2D kernel reaches 4096 elements, so int8 packs
    weight-only, and the table is the leaf that packs."""
    def build(L, Seq, **kw):
        return Seq([L.Embedding(200, 32, input_shape=(5,)), L.GRU(8),
                    L.Dense(4, activation="softmax")], **kw)

    jm = build(JL, JaxSequential)
    tm = build(TL, Sequential, device="cpu")
    params, state = jm.build(jax.random.PRNGKey(seed))
    return jm, _np(params), _np(state), tm


def _x_graph(n=3, seed=2):
    return np.random.default_rng(seed).normal(size=(n, 8, 8, 4)).astype(
        np.float32)


def _x_seq(n=6, seed=3):
    return np.random.default_rng(seed).integers(0, 200, size=(n, 5)).astype(
        np.int32)


PAIRS = {"graph": (_graph_pair, _x_graph), "seq": (_seq_pair, _x_seq)}


def _load(pair, quant):
    jm, params, state, tm = pair
    im = InferenceModel(supported_concurrent_num=2, max_batch_size=8,
                        device="cpu").load(tm, params, state)
    jim = JaxInferenceModel(supported_concurrent_num=2,
                            max_batch_size=8).load(jm, params, state)
    if quant is not None:
        im.quantize_int8(quant)
        jim.quantize_int8(quant)
    return im, jim


# ------------------------------------------------------------------ swaps

@pytest.mark.parametrize("which,quant", [("graph", None), ("graph", 4096),
                                         ("graph", 1), ("seq", None),
                                         ("seq", 4096)])
def test_swap_params_matches_jax(which, quant):
    make, xs = PAIRS[which]
    pair = make()
    params2 = _scaled(pair[1])
    im, jim = _load(pair, quant)
    x = xs()
    before = im.predict(x)
    np.testing.assert_allclose(before, jim.predict(x), rtol=1e-5, atol=1e-5)
    compiles = im.compile_stats()["compiles"]
    im.swap_params(params2, version="v2")
    jim.swap_params(params2, version="v2")
    got = im.predict(x)
    np.testing.assert_allclose(got, jim.predict(x), rtol=1e-5, atol=1e-5)
    assert not np.array_equal(got, before)
    assert im.version == "v2" and im.last_served_version() == "v2"
    assert im.compile_stats()["compiles"] == compiles
    assert set(im.swap_timings) == {"stage_ms", "gate_ms"}
    # the port's own plain path from the new weights, bit for bit
    fresh = make()[3]
    ref = InferenceModel(max_batch_size=8, device="cpu").load(
        fresh, params2, pair[2])
    if quant is not None:
        ref.quantize_int8(quant)
        assert ref.packed_slots == im.packed_slots
    np.testing.assert_array_equal(ref.predict(x), got)


@pytest.mark.parametrize("which,quant", [("graph", None), ("graph", 4096),
                                         ("seq", 4096)])
def test_host_params_round_trip(which, quant):
    make, xs = PAIRS[which]
    pair = make()
    im, jim = _load(pair, quant)
    host = im.host_params()
    jhost = jim.host_params()
    flat_j = {".".join(str(k.key) for k in path): np.asarray(v)
              for path, v in jax.tree_util.tree_flatten_with_path(jhost)[0]}
    assert set(host) == set(flat_j) == set(im.load_names)
    for n, t in host.items():
        np.testing.assert_array_equal(t.numpy(), flat_j[n], err_msg=n)
    x = xs()
    before = im.predict(x)
    im.swap_params(host, version="same")
    np.testing.assert_array_equal(im.predict(x), before)
    assert im.load_signature == jckpt.param_tree_signature(
        jax.tree_util.tree_leaves(pair[1]))


def test_swap_validates_the_tree():
    pair = _graph_pair()
    im, _ = _load(pair, None)
    host = im.host_params()
    bad = dict(host)
    bad.pop(next(iter(bad)))
    with pytest.raises(ValueError, match="missing"):
        im.swap_params(bad)
    bad = dict(host)
    k = im.load_names[0]
    bad[k] = bad[k][:1]
    with pytest.raises(ValueError, match=k):
        im.swap_params(bad)


def test_probe_forward_leaves_the_live_model_alone():
    pair = _graph_pair()
    params2 = _scaled(pair[1])
    for quant in (None, 4096):
        im, jim = _load(pair, quant)
        x = _x_graph()
        live = im.predict(x)
        probe = im.probe_forward(params2, x)
        jprobe = np.asarray(jim.probe_forward(params2, x))
        np.testing.assert_allclose(probe.numpy(), jprobe, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(im.predict(x), live)


def test_swap_waits_for_borrowed_slots():
    """A ``predict_async`` holds its slot until ``fetch``: the swap's gate
    waits for it, so the fetch reads the old weights' result."""
    pair = _graph_pair()
    im, _ = _load(pair, None)
    x = _x_graph()
    old = im.predict(x)
    fetch = im.predict_async(x)
    done = threading.Event()
    t = threading.Thread(target=lambda: (im.swap_params(_scaled(pair[1])),
                                         done.set()))
    t.start()
    assert not done.wait(0.3)
    np.testing.assert_array_equal(fetch(), old)
    t.join(10)
    assert done.is_set() and not np.array_equal(im.predict(x), old)


def test_concurrent_predicts_see_old_or_new_weights():
    pair = _graph_pair()
    im, _ = _load(pair, 4096)
    params2 = _scaled(pair[1])
    xs = [_x_graph(2, seed=s) for s in range(4)]
    old = [im.predict(x) for x in xs]
    ref = InferenceModel(max_batch_size=8, device="cpu").load(
        _graph_pair()[3], params2, pair[2]).quantize_int8(4096)
    new = [ref.predict(x) for x in xs]
    outs, stop = [], threading.Event()

    def worker(i):
        while not stop.is_set():
            outs.append((i, im.predict(xs[i]), im.last_served_version()))
    ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    im.swap_params(params2, version="v2")
    import time
    deadline = time.monotonic() + 30
    while not any(v == "v2" for _, _, v in list(outs)) \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    stop.set()
    for t in ts:
        t.join(10)
    seen = {"old": 0, "new": 0}
    for i, y, v in outs:
        if np.array_equal(y, old[i]):
            seen["old"] += 1
            assert v is None
        else:
            np.testing.assert_array_equal(y, new[i])
            seen["new"] += 1
            assert v == "v2"
    assert seen["new"] > 0


# --------------------------------------------------------- weight-only

@pytest.mark.parametrize("shape,zero", [((64, 32), False), ((3, 3, 4, 8),
                                                            False),
                                        ((40, 16), True), ((5, 7), False)])
def test_quantize_leaf_matches_jax(shape, zero):
    w = np.random.default_rng(sum(shape)).normal(size=shape).astype(
        np.float32) * 0.3
    if zero:
        w[:] = 0.0
    w[..., 0] = 0.0             # one all-zero output channel either way
    got, want = _quantize_leaf(w), jax_quantize_leaf(w)
    np.testing.assert_array_equal(got["q"], want["q"])
    np.testing.assert_array_equal(got["scale"], want["scale"])
    assert got["q"].dtype == np.int8 and got["scale"].dtype == np.float32
    # the 1e-8 floor, not quantize_weight's 1e-12
    assert got["scale"].reshape(-1)[0] == np.float32(1e-8 / 127.0)


def test_weight_only_packing_matches_jax():
    pair = _seq_pair()
    im, jim = _load(pair, 4096)
    assert im.packed_slots == [] and im.is_quantized
    assert list(im._wo_packed) == ["0_embedding.embeddings"]
    packed = im._wo_packed["0_embedding.embeddings"]
    assert packed["q"].dtype == torch.int8
    want = jax_quantize_leaf(pair[1]["0_embedding"]["embeddings"])
    np.testing.assert_array_equal(packed["q"].numpy(), want["q"])
    np.testing.assert_array_equal(packed["scale"].numpy(), want["scale"])
    x = _x_seq()
    np.testing.assert_allclose(im.predict(x), jim.predict(x), rtol=1e-5,
                               atol=1e-5)
    fn, params, state = im.device_apply()
    assert isinstance(params["0_embedding.embeddings"], dict)
    np.testing.assert_array_equal(
        fn(params, state, torch.from_numpy(x)).numpy(), im.predict(x))
    # float within the int8 error of the float model (a module of its own:
    # the packed one cannot load float weights again)
    fim, _ = _load(_seq_pair(), None)
    with pytest.raises(RuntimeError, match="weight-only"):
        _load(pair, None)
    np.testing.assert_allclose(im.predict(x), fim.predict(x), atol=2e-2)
    # row deltas refuse a packed model
    with pytest.raises(RuntimeError, match="int8"):
        im.apply_row_delta([])


def _held_bytes(module):
    """Bytes of the storages the module's params and buffers hold (a
    weight-only leaf holds its codes and scales)."""
    seen = {}
    for t in list(module.parameters()) + list(module.buffers()):
        for u in ((t.q, t.scale) if hasattr(t, "q") else (t,)):
            st = u.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def test_weight_only_model_holds_the_packed_table_alone():
    """The weight-only module keeps the table as int8 codes and f32 scales
    and no float copy beside them, through a swap and a probe; it predicts
    bit for bit what a float model loaded with JAX's ``q * scale`` for the
    table predicts."""
    pair = _seq_pair()
    im, _ = _load(pair, 4096)
    fim, _ = _load(_seq_pair(), None)
    name = "0_embedding.embeddings"
    table = im._module.get_parameter(name)
    assert table.q.dtype == torch.int8 and table.scale.dtype == torch.float32
    rows, width = pair[1]["0_embedding"]["embeddings"].shape
    want = _held_bytes(fim._module) - rows * width * 3 + width * 4
    assert _held_bytes(im._module) == want
    x = _x_seq()

    def dequantized(params):
        out = jax.tree_util.tree_map(np.array, params)
        w = out["0_embedding"]["embeddings"]
        packed = jax_quantize_leaf(w)
        out["0_embedding"]["embeddings"] = \
            packed["q"].astype(np.float32) * packed["scale"]
        return out

    def plain(params):
        return InferenceModel(max_batch_size=8, device="cpu").load(
            _seq_pair()[3], dequantized(params), pair[2]).predict(x)

    np.testing.assert_array_equal(im.predict(x), plain(pair[1]))
    params2 = _scaled(pair[1])
    live = im.predict(x)
    probe = im.probe_forward(params2, x)
    np.testing.assert_array_equal(im.predict(x), live)
    np.testing.assert_array_equal(
        probe.numpy(), InferenceModel(max_batch_size=8, device="cpu").load(
            _seq_pair()[3], params2, pair[2]).predict(x))
    im.swap_params(params2, version="v2")
    assert _held_bytes(im._module) == want
    np.testing.assert_array_equal(im.predict(x), plain(params2))


# ------------------------------------------------------------ row deltas

def _publish_both(tmp_path, params, params2):
    """The base checkpoint and the row delta, written by each package from
    the same trees."""
    out = {}
    for name, ck in (("torch", tckpt), ("jax", jckpt)):
        d = str(tmp_path / name)
        tree = params if name == "jax" else nest(
            {k: torch.from_numpy(np.array(v)) for k, v in
             _flat(params).items()})
        base = ck.save_checkpoint(d, tree, iteration=1, epoch=0)
        tree2 = params2 if name == "jax" else nest(
            {k: torch.from_numpy(np.array(v)) for k, v in
             _flat(params2).items()})
        seen = []
        delta = ck.save_row_delta(d, tree2, base, iteration=2, n_shards=3,
                                  on_durable=lambda p, m: seen.append(p))
        assert seen == [delta]
        out[name] = (base, delta)
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _touch_rows(params, rows):
    p2 = jax.tree_util.tree_map(np.copy, params)
    emb = p2["0_embedding"]["embeddings"]
    emb[rows] = emb[rows] * np.float32(1.5) + np.float32(0.25)
    return p2


def test_save_row_delta_writes_jaxs_files(tmp_path):
    _, params, _, _ = _seq_pair()
    params2 = _touch_rows(params, [3, 77, 150])
    # a dense change too: the GRU kernel moves entirely (the full fallback)
    params2["1_gru"]["kernel"] = params2["1_gru"]["kernel"] * np.float32(2)
    paths = _publish_both(tmp_path, params, params2)
    (tb, td), (jb, jd) = paths["torch"], paths["jax"]
    tz, jz = np.load(os.path.join(td, "state.npz")), \
        np.load(os.path.join(jd, "state.npz"))
    assert sorted(tz.files) == sorted(jz.files)
    for k in tz.files:
        np.testing.assert_array_equal(tz[k], jz[k], err_msg=k)
        assert tz[k].dtype == jz[k].dtype
    tm_, jm_ = (json.load(open(os.path.join(p, "manifest.json")))
                for p in (td, jd))
    for m in (tm_, jm_):
        for k in ("time", "checksum", "version", "state_bytes"):
            m.pop(k)
        m["row_delta"].pop("base_path")
        m["row_delta"].pop("base_version")
    assert tm_ == jm_
    rd = tm_["row_delta"]
    assert rd["rows_touched"] == 3 and rd["n_shards"] == 3
    modes = {lf["leaf"]: lf["mode"] for lf in rd["leaves"]}
    assert sorted(set(modes.values())) == ["full", "rows", "same"]
    assert os.path.getsize(os.path.join(td, "state.npz")) < \
        os.path.getsize(os.path.join(tb, "state.npz"))


def test_apply_row_delta_matches_jax_and_a_full_swap(tmp_path):
    pair = _seq_pair()
    jm, params, state, tm = pair
    touched = [3, 77, 150]
    params2 = _touch_rows(params, touched)
    paths = _publish_both(tmp_path, params, params2)
    im, jim = _load(pair, None)
    entries, manifest = tckpt.read_row_delta(paths["torch"][1], im.load_avals)
    assert manifest["row_delta"]["rows_touched"] == 3
    assert [(k, list(idx)) for k, idx, _ in entries] == [(0, touched)]
    x = np.array([[3, 4, 5, 6, 7], [8, 9, 10, 11, 12], [77, 1, 2, 150, 0]],
                 np.int32)
    before = im.predict(x)
    im.apply_row_delta(entries, version="d2")
    jim.apply_row_delta([(k, idx, rows.numpy()) for k, idx, rows in entries],
                        version="d2")
    got = im.predict(x)
    np.testing.assert_allclose(got, jim.predict(x), rtol=1e-5, atol=1e-5)
    # untouched rows (user 1) keep their bits; touched ones move
    np.testing.assert_array_equal(got[1], before[1])
    assert not np.array_equal(got[0], before[0])
    # the same bits as a full swap to the perturbed params
    full, _ = _load(_seq_pair(), None)
    full.swap_params(params2)
    np.testing.assert_array_equal(full.predict(x), got)
    assert im.version == "d2"


def test_read_row_delta_rejects_bad_publishes(tmp_path):
    pair = _seq_pair()
    _, params, _, _ = pair
    im, _ = _load(pair, None)
    bad = _touch_rows(params, [5])
    bad["0_embedding"]["embeddings"][5, 0] = np.nan
    d = str(tmp_path / "d")
    tree = lambda p: nest({k: torch.from_numpy(np.array(v))
                           for k, v in _flat(p).items()})
    base = tckpt.save_checkpoint(d, tree(params), iteration=1, epoch=0)
    delta = tckpt.save_row_delta(d, tree(bad), base, iteration=2)
    with pytest.raises(tckpt.RowDeltaRejected) as ei:
        tckpt.read_row_delta(delta, im.load_avals)
    assert ei.value.reason == "nan"
    good = tckpt.save_row_delta(d, tree(_touch_rows(params, [5])), base,
                                iteration=3)
    base_version = tckpt.read_manifest(base)["version"]
    tckpt.read_row_delta(good, im.load_avals, live_version=base_version)
    with pytest.raises(tckpt.RowDeltaRejected) as ei:
        tckpt.read_row_delta(good, im.load_avals, live_version="v-other")
    assert ei.value.reason == "base"
    with pytest.raises(tckpt.RowDeltaRejected) as ei:
        tckpt.read_row_delta(good, im.load_avals[1:])
    assert ei.value.reason == "shape"
    with pytest.raises(tckpt.RowDeltaRejected) as ei:
        tckpt.read_row_delta(base, im.load_avals)
    assert ei.value.reason == "io"
    # a torn file fails its manifest checksum
    with open(os.path.join(good, "state.npz"), "r+b") as f:
        f.seek(-3, os.SEEK_END)
        f.write(b"\x00\x01\x02")
    with pytest.raises(tckpt.RowDeltaRejected) as ei:
        tckpt.read_row_delta(good, im.load_avals)
    assert ei.value.reason == "checksum"
    # a delta against another base is refused at the source
    other = tckpt.save_checkpoint(str(tmp_path / "o"),
                                  {"w": torch.zeros(3)}, iteration=1,
                                  epoch=0)
    with pytest.raises(ValueError, match="leaves"):
        tckpt.save_row_delta(d, tree(params), other, iteration=4)


def test_checkpoint_writer_on_durable(tmp_path):
    seen = []
    w = tckpt.CheckpointWriter(on_durable=lambda p, m: seen.append(
        (p, m["iteration"], os.path.exists(os.path.join(p,
                                                        "manifest.json")))))
    state = {"a": torch.arange(6.0)}
    p1 = tckpt.save_checkpoint(str(tmp_path), state, iteration=1, epoch=0,
                               writer=w)
    w.drain()
    own = []
    p2 = tckpt.save_checkpoint(str(tmp_path), state, iteration=2, epoch=0,
                               writer=w, on_durable=lambda p, m: own.append(p))
    w.drain()
    assert seen == [(p1, 1, True)] and own == [p2]
    # a failing hook is not a failed checkpoint
    p3 = tckpt.save_checkpoint(str(tmp_path), state, iteration=3, epoch=0,
                               on_durable=lambda p, m: 1 / 0)
    assert tckpt.latest_checkpoint(str(tmp_path)) == p3


# ------------------------------------------------------- summary, counters

def test_summary_timing_and_compile_counters():
    ttm.reset_telemetry()
    tsum.reset_timing_stats()
    jsum.reset_timing_stats()
    pair = _graph_pair()
    ts, js = tsum.InferenceSummary(), jsum.InferenceSummary()
    im = InferenceModel(max_batch_size=4, summary=ts, device="cpu").load(
        pair[3], pair[1], pair[2])
    jim = JaxInferenceModel(max_batch_size=4, summary=js).load(
        pair[0], pair[1], pair[2])
    for n in (1, 3, 4, 6):
        x = _x_graph(n)
        np.testing.assert_allclose(im.predict(x), jim.predict(x), rtol=1e-5,
                                   atol=1e-5)
    im.predict_async(_x_graph(2))()
    jim.predict_async(_x_graph(2))()
    tsnap, jsnap = ts.snapshot(), js.snapshot()
    assert (tsnap["records"], tsnap["batches"]) == \
        (jsnap["records"], jsnap["batches"]) == (16, 5)
    assert tsum.timing_stats()["inference.forward"]["count"] == \
        jsum.timing_stats()["inference.forward"]["count"]
    stats = im.compile_stats()
    assert (stats["compiles"], stats["cache_hits"]) == \
        (jim.compile_stats()["compiles"], jim.compile_stats()["cache_hits"])
    fam = ttm.parse_prometheus(ttm.render_prometheus())
    assert fam["zoo_infer_compiles_total"]["samples"][0][2] == \
        stats["compiles"]
    assert fam["zoo_infer_cache_hits_total"]["samples"][0][2] == \
        stats["cache_hits"]
    ttm.reset_telemetry()
