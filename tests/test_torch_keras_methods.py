"""The Estimator and KerasNet methods the port took over from the JAX
package, held against it on the CPU on the same inputs.

``Estimator.save``/``load`` (synchronous, a write in flight drained first;
a checkpoint each package reads from the other), ``set_model_publisher``
(a durable ``fit`` save announced on the publish stream, as
``tests/test_hotswap.py``'s JAX case), ``recalibrate_batchnorm`` (moving
statistics within 1e-5 of JAX's, the dropout silenced and restored, a
dict-tree batch refused for a graph model), ``KerasNet.
set_initial_weights`` (full and partial donation, then a step matching
JAX's), ``CheckpointWriter.in_flight``, ``EventWriter.add_scalar`` (the
JAX bytes) and the ``timing`` block (the JAX line).
"""

import os
import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from analytics_zoo_tpu.common import summary as jsummary
from analytics_zoo_tpu.data import FeatureSet as JFeatureSet
from analytics_zoo_tpu.engine.estimator import Estimator as JEstimator
from analytics_zoo_tpu.nn import layers as JL
from analytics_zoo_tpu.nn.graph import Input as JInput
from analytics_zoo_tpu.nn.topology import Model as JModel
from analytics_zoo_tpu_torch.bridge import (params_to_numpy,
                                            state_dict_from_jax)
from analytics_zoo_tpu_torch.common import summary as tsummary
from analytics_zoo_tpu_torch.common.config import TrainConfig
from analytics_zoo_tpu_torch.data.featureset import FeatureSet
from analytics_zoo_tpu_torch.engine import checkpoint as tckpt
from analytics_zoo_tpu_torch.engine.estimator import Estimator
from analytics_zoo_tpu_torch.nn import layers as TL
from analytics_zoo_tpu_torch.nn.graph import Input
from analytics_zoo_tpu_torch.nn.topology import Model
from analytics_zoo_tpu_torch.serving.broker import start_broker
from analytics_zoo_tpu_torch.serving.hotswap import ModelPublisher

AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")
LOSS = "sparse_categorical_crossentropy"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape((1,) * 6), AXES)


def _graph(m, inp, bn=True):
    x = inp((6,))
    h = m.Dense(8)(x)
    if bn:
        h = m.BatchNormalization()(h)
    h = m.Dropout(0.3)(h)
    return x, m.Dense(3, activation="softmax")(h)


def _pair(bn=True, seed=0):
    jm = JModel(*_graph(JL, JInput, bn))
    params, state = jm.build(jax.random.PRNGKey(seed))
    tm = Model(*_graph(TL, Input, bn), device="cpu")
    tm.load_state_dict(state_dict_from_jax(_np(params), _np(state)))
    return jm, params, state, tm


def _data(n=128, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, 6)) * 3 + 1).astype(np.float32)
    return x, rng.integers(0, 3, n).astype(np.int32)


def _leaves(tm):
    return {k: v.detach().clone() for k, v in tm.state_dict().items()}


def test_save_and_load_round_trip_and_cross_package(tmp_path):
    _, params, state, tm = _pair(seed=1)
    x, y = _data()
    est = Estimator(tm, optimizer="adam", loss=LOSS)
    est.fit((x, y), batch_size=32, epochs=1)
    path = est.save(str(tmp_path / "ck"))
    assert os.path.isdir(path) and est._ckpt_writer is None
    trained = _leaves(tm)
    # a fresh port model and Estimator take the weights, the optimizer
    # state and the counters back
    _, _, _, fresh = _pair(seed=2)
    est2 = Estimator(fresh, optimizer="adam", loss=LOSS).load(
        str(tmp_path / "ck"))
    for k, v in _leaves(fresh).items():
        assert torch.equal(v, trained[k]), k
    assert est2.trainer_state.iteration == est.trainer_state.iteration == 4
    assert est2.train_state["step"] == 4
    # the JAX Estimator reads the port's checkpoint
    jm = JModel(*_graph(JL, JInput))
    jest = JEstimator(jm, optimizer="adam", loss=LOSS, mesh=_mesh())
    jest.load(str(tmp_path / "ck"), sample_batch=(x[:32], y[:32]))
    got = params_to_numpy(tm)
    for slot, leaves in _np(jest.train_state["params"]).items():
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(got[slot][leaf], v)
    assert jest.trainer_state.iteration == 4
    # and the port reads one the JAX Estimator writes
    jest.fit((x, y), batch_size=32, epochs=2)
    jest.save(str(tmp_path / "jck"))
    est2.load(str(tmp_path / "jck"))
    got = params_to_numpy(fresh)
    for slot, leaves in _np(jest.train_state["params"]).items():
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(got[slot][leaf], v)
    assert est2.trainer_state.iteration == jest.trainer_state.iteration


def test_save_drains_an_async_write_first(tmp_path, monkeypatch):
    """``save`` returns with its own checkpoint durable and the async
    write submitted before it finished: ``in_flight`` goes from True to
    False across the drain."""
    _, _, _, tm = _pair(seed=3)
    est = Estimator(tm, optimizer="sgd", loss=LOSS)
    est.fit(_data(), batch_size=32, epochs=1)
    gate = threading.Event()
    real = tckpt._write_snapshot

    def slow(*a, **kw):
        gate.wait(10)
        return real(*a, **kw)

    monkeypatch.setattr(tckpt, "_write_snapshot", slow)
    writer = est._ckpt_writer = tckpt.CheckpointWriter()
    tckpt.save_checkpoint(str(tmp_path / "a"), est.checkpoint_state(),
                          iteration=1, epoch=0, writer=writer)
    assert writer.in_flight()
    threading.Timer(0.2, gate.set).start()
    path = est.save(str(tmp_path / "b"))
    assert not writer.in_flight()
    assert tckpt.latest_checkpoint(str(tmp_path / "a")) is not None
    assert tckpt.latest_checkpoint(str(tmp_path / "b")) == path


def test_model_publisher_announces_the_fit_saves(tmp_path):
    broker = start_broker()
    try:
        pub = ModelPublisher(port=broker.port)
        _, _, _, tm = _pair(bn=False, seed=4)
        est = Estimator(tm, optimizer="sgd", loss=LOSS,
                        config=TrainConfig(checkpoint_dir=str(tmp_path),
                                           log_every_n_steps=1000))
        assert est.set_model_publisher(pub) is est
        est.fit(_data(), batch_size=32, epochs=1)
        assert pub.published, "epoch-end checkpoint was not announced"
        assert pub.published[-1]["step"] == 4
        pub.close()
    finally:
        broker.shutdown()


def test_recalibrate_batchnorm_matches_jax():
    jm, params, state, tm = _pair(seed=5)
    x, y = _data(n=192, seed=5)
    jest = JEstimator(jm, optimizer="sgd", loss=LOSS, mesh=_mesh())
    jest.initial_weights = (params, state)
    jest.train_state = jest._init_state((x[:64], y[:64]))
    jest.recalibrate_batchnorm((x, y), batch_size=64)
    est = Estimator(tm, optimizer="sgd", loss=LOSS)
    assert est.recalibrate_batchnorm((x, y), batch_size=64) is est
    want = _np(jest.train_state["model_state"])["1_batchnormalization"]
    got = tm.state_dict()
    for name in ("moving_mean", "moving_var"):
        np.testing.assert_allclose(
            got[f"1_batchnormalization.{name}"].numpy(), want[name],
            rtol=0, atol=1e-5, err_msg=name)
    assert not np.allclose(want["moving_mean"], 0.0)
    drop = [l for l in tm.layers if isinstance(l, TL.Dropout)][0]
    bn = [l for l in tm.layers if isinstance(l, TL.BatchNormalization)][0]
    assert drop.rate == 0.3 and bn.momentum == 0.99 and not tm.training
    # a model without BN is left as it was
    _, _, _, plain = _pair(bn=False)
    before = _leaves(plain)
    Estimator(plain, optimizer="sgd", loss=LOSS).recalibrate_batchnorm(x)
    for k, v in _leaves(plain).items():
        assert torch.equal(v, before[k])


def test_recalibrate_batchnorm_refuses_dict_batches_for_graph_models():
    _, _, _, tm = _pair(seed=6)
    x, _ = _data(n=32)
    est = Estimator(tm, optimizer="sgd", loss=LOSS)
    fs = FeatureSet({"x": x, "y": np.zeros((32, 2), np.float32)})
    with pytest.raises(ValueError, match="dict-tree"):
        est.recalibrate_batchnorm(fs, batch_size=16)
    bn = [l for l in tm.layers if isinstance(l, TL.BatchNormalization)][0]
    assert bn.momentum == 0.99
    # the JAX package refuses the same batch the same way
    jm = JModel(*_graph(JL, JInput))
    jest = JEstimator(jm, optimizer="sgd", loss=LOSS, mesh=_mesh())
    jest.fit((x, np.zeros(32, np.int32)), batch_size=16, epochs=1)
    with pytest.raises(ValueError, match="dict-tree"):
        jest.recalibrate_batchnorm(JFeatureSet(
            {"x": x, "y": np.zeros((32, 2), np.float32)}), batch_size=16)


@pytest.mark.parametrize("partial", [False, True])
def test_set_initial_weights_then_a_step_matches_jax(partial):
    jm, params, state, _ = _pair(bn=False, seed=7)
    donor = _np(params)
    if partial:
        donor = {"0_dense": donor["0_dense"]}
    x, y = _data(n=32, seed=7)
    jm.compile(optimizer="sgd", loss=LOSS, mesh=_mesh())
    jm.set_initial_weights(donor, partial=partial)
    tm = Model(*_graph(TL, Input, bn=False), device="cpu")
    with pytest.raises(RuntimeError, match="compile"):
        tm.set_initial_weights(donor)
    tm.compile(optimizer="sgd", loss=LOSS)
    assert tm.set_initial_weights(donor, partial=partial) is tm
    if partial:
        # the slots not donated keep their own draws: give both packages
        # the port's, then step both
        own = params_to_numpy(tm)
        jm.set_initial_weights({**own, **donor})
    jm.fit(x, y, batch_size=32, nb_epoch=1)
    tm.fit(x, y, batch_size=32, nb_epoch=1)
    got = params_to_numpy(tm)
    for slot, leaves in _np(jm.estimator.train_state["params"]).items():
        for leaf, v in leaves.items():
            np.testing.assert_allclose(got[slot][leaf], v, rtol=0,
                                       atol=1e-5)


def test_set_initial_weights_checks_keys():
    _, params, _, tm = _pair(bn=False)
    tm.compile(optimizer="sgd", loss=LOSS)
    donor = _np(params)
    with pytest.raises(ValueError, match="missing"):
        tm.set_initial_weights({"0_dense": donor["0_dense"]})
    with pytest.raises(ValueError, match="unexpected"):
        tm.set_initial_weights({**donor, "9_dense": donor["0_dense"]},
                               partial=True)


def test_event_writer_add_scalar_writes_the_jax_bytes(tmp_path,
                                                       monkeypatch):
    for mod in (jsummary, tsummary):
        monkeypatch.setattr(mod.time, "time", lambda: 1234.5)
    paths = []
    for mod, sub in ((jsummary, "jax"), (tsummary, "port")):
        w = mod.EventWriter(str(tmp_path / sub))
        w.add_scalar(3, "Loss", 0.25)
        w.add_scalar(4, "Loss", 0.125)
        w.close()
        paths.append(w.path)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    assert tsummary.read_scalars(paths[1]) == [(3, "Loss", 0.25),
                                               (4, "Loss", 0.125)]


def test_timing_block_logs_as_jax(capsys):
    class Log:
        lines = []

        def info(self, msg):
            self.lines.append(msg)

    log = Log()
    with tsummary.timing("phase", logger=log) as t:
        pass
    assert t.elapsed >= 0 and log.lines[0].startswith("[timing] phase: ")
    with tsummary.timing("bare"):
        pass
    err = capsys.readouterr().err
    assert err.startswith("[timing] bare: ") and err.endswith(" ms\n")
