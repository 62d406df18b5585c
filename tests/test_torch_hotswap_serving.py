"""Hot swap through the port's data plane, against the JAX package's, on
the CPU.

A checkpoint the JAX package's ``save_checkpoint`` writes is announced by
``ModelPublisher`` and swapped into a running ``ClusterServing`` by its
``ModelSwapper`` (staged, probed, flipped between dispatch waves); results
after the swap equal the JAX engine's after the same swap within 1e-5, carry
the new version, and no result mixes versions, also while four threads keep
enqueueing. A NaN checkpoint and a wrong-shaped one are rejected with the
JAX swapper's reasons and messages, the old model still serving and a record
on ``model_rejections``. A row delta from JAX's ``save_row_delta`` moves only
the touched rows' outputs.
"""

import queue
import threading

import jax
import numpy as np
import pytest

from analytics_zoo_tpu.engine import checkpoint as jckpt
from analytics_zoo_tpu.inference import InferenceModel as JaxInferenceModel
from analytics_zoo_tpu.nn import layers as JL
from analytics_zoo_tpu.nn.topology import Sequential as JaxSequential
from analytics_zoo_tpu.serving import ClusterServing as JaxClusterServing
from analytics_zoo_tpu.serving import InputQueue as JaxInputQueue
from analytics_zoo_tpu.serving import OutputQueue as JaxOutputQueue
from analytics_zoo_tpu.serving import ServingConfig as JaxServingConfig
from analytics_zoo_tpu.serving import hotswap as jhotswap
from analytics_zoo_tpu.serving import start_broker as jax_start_broker
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.nn import layers as TL
from analytics_zoo_tpu_torch.nn.topology import Sequential
from analytics_zoo_tpu_torch.serving import (ClusterServing, InputQueue,
                                             OutputQueue, ServingConfig,
                                             start_broker)
from analytics_zoo_tpu_torch.serving import hotswap as thotswap
from analytics_zoo_tpu_torch.serving.client import _Conn

pytestmark = pytest.mark.serving

PKG = {
    "torch": dict(start_broker=start_broker, Job=ClusterServing,
                  Cfg=ServingConfig, IQ=InputQueue, OQ=OutputQueue,
                  hotswap=thotswap),
    "jax": dict(start_broker=jax_start_broker, Job=JaxClusterServing,
                Cfg=JaxServingConfig, IQ=JaxInputQueue, OQ=JaxOutputQueue,
                hotswap=jhotswap),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _dense_pair(seed=0):
    jm = JaxSequential([JL.Dense(16, activation="relu", input_shape=(8,)),
                        JL.Dense(4, activation="softmax")])
    tm = Sequential([TL.Dense(16, activation="relu", input_shape=(8,)),
                     TL.Dense(4, activation="softmax")], device="cpu")
    params, state = jm.build(jax.random.PRNGKey(seed))
    return jm, tm, _np(params), _np(state)


def _seq_pair(seed=0):
    jm = JaxSequential([JL.Embedding(200, 32, input_shape=(5,)), JL.GRU(8),
                        JL.Dense(4, activation="softmax")])
    tm = Sequential([TL.Embedding(200, 32, input_shape=(5,)), TL.GRU(8),
                     TL.Dense(4, activation="softmax")], device="cpu")
    params, state = jm.build(jax.random.PRNGKey(seed))
    return jm, tm, _np(params), _np(state)


def _models(pair):
    jm, tm, params, state = pair
    return {"torch": InferenceModel(supported_concurrent_num=2,
                                    max_batch_size=8,
                                    device="cpu").load(tm, params, state),
            "jax": JaxInferenceModel(supported_concurrent_num=2,
                                     max_batch_size=8).load(jm, params,
                                                            state)}


def _scaled(tree, f=1.01):
    return jax.tree_util.tree_map(lambda a: (a * np.float32(f)).astype(
        a.dtype), tree)


class _Stack:
    """A broker, an engine with a swap listener, and the queue clients, of
    one package; ``swapped`` yields one item per publish the listener
    processed."""

    def __init__(self, side, model, **cfg):
        p = PKG[side]
        self.broker = p["start_broker"]()
        cfg = p["Cfg"](batch_size=4, concurrent_num=2,
                       queue_port=self.broker.port, **cfg)
        self.job = p["Job"](model, cfg, group=f"swap-{side}")
        self.swapped: "queue.Queue" = queue.Queue()
        report = self.job._report_rejection

        def reported(conn, record, _job=self.job):
            report(conn, record)
            self.swapped.put((_job._swap_state, _job._swap_error,
                              _job.model_version))

        self.job._report_rejection = reported
        # publish only after the swap listener's catch-up peek: a publish
        # between its group create and the peek is seen twice (ROADMAP
        # Queue 3, gap 6), which would hand a later publish's waiter a
        # stale event
        self.listening = threading.Event()
        connect = self.job._connect

        def connect_and_watch(tag="engine"):
            conn = connect(tag)
            if tag == "engine.swap-listener":
                call = conn.call

                def watched(*req):
                    out = call(*req)
                    if req[0] == "XLAST":
                        self.listening.set()
                    return out

                conn.call = watched
            return conn

        self.job._connect = connect_and_watch
        self.job.start()
        assert self.listening.wait(timeout=60)
        self.iq = p["IQ"](port=self.broker.port)
        self.oq = p["OQ"](port=self.broker.port)
        self.publisher = p["hotswap"].ModelPublisher(port=self.broker.port)

    def publish(self, path):
        record = self.publisher.publish(path)
        assert record is not None
        return record, self.swapped.get(timeout=60)

    def serve(self, xs):
        uris = [self.iq.enqueue(None, input=x) for x in xs]
        out = []
        for u in uris:
            out.append((self.oq.query(u, timeout_s=30),
                        self.oq.last_model_version))
        return out

    def rejections(self):
        c = _Conn("127.0.0.1", self.broker.port, timeout=10.0)
        try:
            return [p for _, p in c.call("XREAD", "model_rejections", 0,
                                         64, 0)[1]]
        finally:
            c.close()

    def close(self):
        for c in (self.iq, self.oq, self.publisher):
            c.close()
        self.job.stop()
        self.broker.shutdown()
        self.broker.server_close()


def test_a_jax_checkpoint_swaps_into_both_engines_alike(tmp_path):
    pair = _dense_pair()
    params2 = _scaled(pair[2])
    path = jckpt.save_checkpoint(str(tmp_path / "ckpt"), params2,
                                 iteration=5, epoch=0)
    x = np.random.default_rng(0).normal(size=(12, 8)).astype(np.float32)
    got = {}
    models = _models(pair)
    for side in ("torch", "jax"):
        st = _Stack(side, models[side], warmup_shape=(8,))
        try:
            before = st.serve(x[:6])
            record, (state, err, version) = st.publish(path)
            assert (state, err) == ("ok", None)
            assert version == record["version"]
            after = st.serve(x[6:])
        finally:
            st.close()
        assert {v for _, v in before} == {"initial"}
        assert {v for _, v in after} == {record["version"]}
        got[side] = (np.stack([o for o, _ in before + after]), record)
    np.testing.assert_allclose(got["torch"][0], got["jax"][0], rtol=1e-5,
                               atol=1e-5)
    assert got["torch"][1]["version"] == got["jax"][1]["version"]
    assert models["torch"].version == got["torch"][1]["version"]


def test_no_result_mixes_versions_under_concurrent_traffic(tmp_path):
    pair = _dense_pair(1)
    params2 = _scaled(pair[2])
    path = jckpt.save_checkpoint(str(tmp_path / "ckpt"), params2,
                                 iteration=5, epoch=0)
    x = np.random.default_rng(1).normal(size=(16, 8)).astype(np.float32)
    old = _models(_dense_pair(1))["torch"].predict(x)
    new_model = _models(_dense_pair(1))["torch"]
    new_model.swap_params(params2)
    new = new_model.predict(x)
    st = _Stack("torch", _models(pair)["torch"], warmup_shape=(8,))
    results, errors = [], []
    stop = threading.Event()

    def client(k):
        iq, oq = InputQueue(port=st.broker.port), \
            OutputQueue(port=st.broker.port)
        try:
            n = 0
            while not stop.is_set() or n < 4:
                i = (4 * n + k) % len(x)
                u = iq.enqueue(None, input=x[i])
                results.append((i, oq.query(u, timeout_s=30),
                                oq.last_model_version))
                n += 1
        except Exception as e:  # pragma: no cover
            errors.append(e)
        finally:
            iq.close()
            oq.close()

    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    try:
        for t in threads:
            t.start()
        record, (state, _, version) = st.publish(path)
        assert state == "ok"
        tail = st.serve(x[:4])         # after the flip: the new version
        stop.set()
        for t in threads:
            t.join(timeout=60)
    finally:
        stop.set()
        st.close()
    assert not errors
    assert {v for _, v in tail} == {record["version"]}
    seen = set()
    for i, y, v in results:
        want = {"initial": old, record["version"]: new}[v]
        np.testing.assert_allclose(y, want[i], rtol=1e-5, atol=1e-6)
        seen.add(v)
    assert "initial" in seen and len(results) >= 16


def _poisoned(params, kind):
    p = jax.tree_util.tree_map(np.copy, params)
    layer = sorted(p)[0]
    if kind == "nan":
        p[layer]["kernel"][0, 0] = np.nan
    else:           # a wider first layer: a different param-tree shape
        p[layer]["kernel"] = np.zeros((8, 17), np.float32)
    return p


@pytest.mark.parametrize("kind", ["nan", "shape"])
def test_poisoned_checkpoints_are_rejected_as_jax_rejects_them(kind,
                                                               tmp_path):
    pair = _dense_pair(2)
    bad = _poisoned(pair[2], kind)
    path = jckpt.save_checkpoint(str(tmp_path / "bad"), bad, iteration=3,
                                 epoch=0)
    record = thotswap.publish_record(path)
    models = _models(pair)
    errs = {}
    for side, mod in (("torch", thotswap), ("jax", jhotswap)):
        sw = mod.ModelSwapper(models[side], probe_shape=(8,))
        with pytest.raises(mod.SwapRejected) as e:
            sw.stage(record)
        errs[side] = (e.value.reason, str(e.value))
    assert errs["torch"] == errs["jax"]
    assert errs["torch"][0] == kind
    # through the engine: rejected, reported, the old model still serving
    x = np.random.default_rng(2).normal(size=(4, 8)).astype(np.float32)
    want = models["jax"].predict(x)
    st = _Stack("torch", models["torch"], warmup_shape=(8,))
    try:
        _, (state, err, version) = st.publish(path)
        assert state == "error" and err.startswith(f"{kind}:")
        assert version == "initial"
        out = st.serve(x)
        rejected = st.rejections()
    finally:
        st.close()
    np.testing.assert_allclose(np.stack([o for o, _ in out]), want,
                               rtol=1e-5, atol=1e-5)
    assert {v for _, v in out} == {"initial"}
    assert [r["version"] for r in rejected] == [record["version"]]
    assert (rejected[0]["outcome"], rejected[0]["reason"]) == \
        ("rejected", err)


def test_probe_rejects_a_checkpoint_whose_forward_is_not_finite(tmp_path):
    pair = _dense_pair(3)
    # finite weights whose forward overflows even on the all-zero probe
    big = jax.tree_util.tree_map(lambda a: np.full_like(a, 3e38), pair[2])
    path = jckpt.save_checkpoint(str(tmp_path / "big"), big, iteration=3,
                                 epoch=0)
    models = _models(pair)
    errs = {}
    for side, mod in (("torch", thotswap), ("jax", jhotswap)):
        sw = mod.ModelSwapper(models[side], probe_shape=(8,))
        with pytest.raises(mod.SwapRejected) as e:
            sw.stage(mod.publish_record(path))
        errs[side] = (e.value.reason, str(e.value))
    assert errs["torch"] == errs["jax"] == \
        ("warmup", "probe forward produced NaN/Inf outputs")


def test_a_row_delta_moves_only_the_touched_rows(tmp_path):
    pair = _seq_pair()
    params = pair[2]
    touched = [3, 77, 150]
    params2 = jax.tree_util.tree_map(np.copy, params)
    emb = params2["0_embedding"]["embeddings"]
    emb[touched] = emb[touched] * np.float32(1.5) + np.float32(0.25)
    d = str(tmp_path / "ckpt")
    base = jckpt.save_checkpoint(d, params, iteration=1, epoch=0)
    delta = jckpt.save_row_delta(d, params2, base, iteration=2, n_shards=3)
    x = np.array([[3, 4, 5, 6, 7], [8, 9, 10, 11, 12], [77, 1, 2, 150, 0],
                  [20, 21, 22, 23, 24]], np.int32)
    models = _models(pair)
    st = _Stack("torch", models["torch"])
    try:
        rec_base, (state, _, v1) = st.publish(base)
        assert state == "ok" and v1 == rec_base["version"]
        before = st.serve(x)
        rec_delta, (state, err, v2) = st.publish(delta)
        assert (state, err) == ("ok", None)
        assert v2 == rec_delta["version"] and rec_delta["delta"] is True
        assert rec_delta["rows_touched"] == 3
        after = st.serve(x)
    finally:
        st.close()
    assert {v for _, v in before} == {v1} and {v for _, v in after} == {v2}
    y0 = np.stack([o for o, _ in before])
    y1 = np.stack([o for o, _ in after])
    np.testing.assert_array_equal(y1[[1, 3]], y0[[1, 3]])   # untouched
    assert not np.allclose(y1[[0, 2]], y0[[0, 2]])          # touched
    ref = models["jax"]
    ref.swap_params(params2)
    np.testing.assert_allclose(y1, ref.predict(x), rtol=1e-5, atol=1e-5)


def test_swapper_rollback_and_stale_publishes(tmp_path):
    pair = _dense_pair(4)
    params2 = _scaled(pair[2])
    path = jckpt.save_checkpoint(str(tmp_path / "c"), params2, iteration=5,
                                 epoch=0)
    model = _models(pair)["torch"]
    x = np.random.default_rng(4).normal(size=(3, 8)).astype(np.float32)
    y0 = model.predict(x)
    sw = thotswap.ModelSwapper(model, probe_shape=(8,))
    rec = thotswap.publish_record(path)
    assert sw.stage_and_swap(rec) == rec["version"]
    assert set(sw.timings) == {"stage_ms", "probe_ms", "flip_ms"}
    y1 = model.predict(x)
    assert not np.array_equal(y1, y0)
    # a redelivered publish of the same step is skipped, not re-staged
    assert sw.stage_and_swap(rec) == rec["version"]
    assert sw.rollback() == "initial"
    np.testing.assert_array_equal(model.predict(x), y0)
    assert model.version is None


@pytest.mark.parametrize("quant", [None, 64], ids=["float", "int8"])
def test_swapper_stages_once_and_flips_the_probed_tensors(tmp_path,
                                                          monkeypatch, quant):
    """The swapper's staging is the tree's one trip to the model's device,
    float or int8 (re-packed first): one ``stage_tensors`` call a swap; the
    probe runs on the staged tensors with the live model untouched, and the
    flip installs those same tensors. The answers after it equal the JAX
    model's after the same swap."""
    from analytics_zoo_tpu_torch.inference import inference_model as tim

    pair = _dense_pair(5)
    models = _models(pair)
    if quant is not None:
        for m in models.values():
            m.quantize_int8(quant)
    model = models["torch"]
    assert model.is_quantized == (quant is not None)
    params2 = _scaled(pair[2])
    path = jckpt.save_checkpoint(str(tmp_path / "c"), params2, iteration=1,
                                 epoch=0)
    x = np.random.default_rng(5).normal(size=(3, 8)).astype(np.float32)
    y0 = model.predict(x)
    crossings, probed = [], []
    stage, probe = tim.stage_tensors, model.probe_staged

    def counted(tensors, *a, **k):
        crossings.append(sorted(tensors))
        return stage(tensors, *a, **k)

    def probe_staged(staged, xp):
        probed.append(staged.tensors)
        y = probe(staged, xp)
        np.testing.assert_array_equal(model.predict(x), y0)
        return y

    monkeypatch.setattr(tim, "stage_tensors", counted)
    model.probe_staged = probe_staged
    sw = thotswap.ModelSwapper(model, probe_shape=(8,))
    rec = thotswap.publish_record(path)
    assert sw.stage_and_swap(rec) == rec["version"]
    assert len(crossings) == 1 and len(probed) == 1
    assert any(n.endswith("#q") for n in crossings[0]) == (quant is not None)
    held = {t.data_ptr() for t in model._module.parameters()} | \
        {t.data_ptr() for t in model._module.buffers()}
    assert all(t.data_ptr() in held for t in probed[0].values())
    ref = models["jax"]
    ref.swap_params(params2)
    np.testing.assert_allclose(model.predict(x), ref.predict(x), rtol=1e-5,
                               atol=1e-5)

