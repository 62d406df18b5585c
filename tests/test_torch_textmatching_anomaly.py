"""KNRM and AnomalyDetector of the PyTorch port against the JAX package, on
the CPU, at the sizes of ``tests/test_model_zoo.py``.

Held, with the JAX model's weights loaded through the bridge: KNRM's
scores (ranking and classification heads, a trainable and a frozen
table) within 1e-4, two f32 Adam steps through ``fit`` (``rank_hinge``)
with losses and parameters within 1e-5, its NDCG and MAP over query
groups equal to JAX's; AnomalyDetector's forecasts within 1e-4 and two
steps of ``fit`` (its dropouts on, the masks JAX's) within 1e-5, its
host helpers (``unroll``, ``standard_scale``, ``detect_anomalies``,
``train_test_split``) equal to JAX's; and each model's bundle read both
ways.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from analytics_zoo_tpu.models import anomalydetection as jad
from analytics_zoo_tpu.models.textmatching import KNRM as JKNRM
from analytics_zoo_tpu.nn import optimizers as jopt
from analytics_zoo_tpu_torch.bridge import (params_from_jax, params_to_numpy,
                                            state_dict_from_jax)
from analytics_zoo_tpu_torch.models import anomalydetection as tad
from analytics_zoo_tpu_torch.models.common import MODEL_REGISTRY
from analytics_zoo_tpu_torch.models.textmatching import KNRM
from analytics_zoo_tpu_torch.nn import optimizers as topt

AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape((1,) * 6), AXES)


def _pair(jcls, tcls, seed=0, **kw):
    jm = jcls(**kw)
    params, state = jm.build(jax.random.PRNGKey(seed))
    tm = tcls(device="cpu", **kw)
    tm.load_state_dict(state_dict_from_jax(_np(params), _np(state)))
    return jm, params, state, tm


def _fit_both(jm, params, state, tm, x, y, loss, batch_size):
    """Per-step losses of one epoch in each package, and the final params
    of each as flat dicts."""
    jm.compile(optimizer=jopt.Adam(lr=0.01, epsilon=1e-4), loss=loss,
               mesh=_mesh())
    jest = jm.estimator
    jest.initial_weights = (params, state)
    want, step = [], jest._make_train_step()

    def jrecord(st, b):
        st, (v, gnorm) = step(st, b)
        want.append(float(v))
        return st, (v, gnorm)

    jest._train_step = jrecord
    jm.fit(x, y, batch_size=batch_size, nb_epoch=1, seed=2)
    tm.compile(optimizer=topt.Adam(lr=0.01, epsilon=1e-4), loss=loss)
    got, tstep = [], tm.estimator._step

    def trecord(b):
        v, gnorm = tstep(b)
        got.append(float(v))
        return v, gnorm

    tm.estimator._step = trecord
    tm.fit(x, y, batch_size=batch_size, nb_epoch=1, seed=2)
    return (want, got, params_from_jax(_np(jest.train_state["params"])),
            params_from_jax(params_to_numpy(tm)))


KNRM_KW = {
    "ranking": dict(text1_length=4, text2_length=8, vocab_size=40,
                    embed_size=8, kernel_num=5, target_mode="ranking"),
    "classification": dict(text1_length=3, text2_length=5, vocab_size=20,
                           embed_size=4, kernel_num=3, train_embed=False,
                           target_mode="classification"),
}


@pytest.mark.parametrize("mode", sorted(KNRM_KW))
def test_knrm_scores_match_jax(mode):
    kw = KNRM_KW[mode]
    jm, params, state, tm = _pair(JKNRM, KNRM, **kw)
    assert [tm.slot(l) for l in tm.layers] == [jm.slot(l) for l in jm.layers]
    assert tm.constructor_config() == jm.constructor_config()
    assert MODEL_REGISTRY["KNRM"] is KNRM
    n = kw["text1_length"] + kw["text2_length"]
    x = np.random.default_rng(0).integers(0, kw["vocab_size"], size=(16, n)) \
        .astype(np.int32)
    want, _ = jm.apply(params, state, x)
    with torch.no_grad():
        got = tm.apply(torch.from_numpy(x)).numpy()
    assert got.shape == (16, 1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)
    if mode == "classification":
        assert "0_embedding" in state and not any(
            "embeddings" in name for name, _ in tm.named_parameters())


def test_knrm_fit_and_ranking_metrics_match_jax(tmp_path):
    kw = KNRM_KW["ranking"]
    jm, params, state, tm = _pair(JKNRM, KNRM, seed=1, **kw)
    rng = np.random.default_rng(1)
    x = rng.integers(0, 40, size=(32, 12)).astype(np.int32)
    y = rng.uniform(0, 1, size=(32, 1)).astype(np.float32)
    want, got, jp, tp = _fit_both(jm, params, state, tm, x, y, "rank_hinge",
                                  16)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert sorted(jp) == sorted(tp)
    for name, v in jp.items():
        np.testing.assert_allclose(tp[name].numpy(), v.numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)
    groups = [(x[i * 8:(i + 1) * 8],
               (rng.uniform(size=8) > 0.5).astype(np.float32))
              for i in range(4)]
    for metric in ("evaluate_ndcg", "evaluate_map"):
        args = (3,) if metric == "evaluate_ndcg" else ()
        np.testing.assert_allclose(getattr(tm, metric)(groups, *args),
                                   getattr(jm, metric)(groups, *args),
                                   rtol=0, atol=1e-5)
    tm.save_model(str(tmp_path / "knrm"))
    back = KNRM.load_model(str(tmp_path / "knrm"), device="cpu")
    back.compile(optimizer="adam", loss="rank_hinge")
    np.testing.assert_array_equal(back.predict(x), tm.predict(x))
    jback = JKNRM.load_model(str(tmp_path / "knrm"))
    jback.compile(optimizer="adam", loss="rank_hinge")
    np.testing.assert_allclose(np.asarray(jback.predict(x)), tm.predict(x),
                               rtol=0, atol=1e-5)


AD_KW = dict(feature_shape=(10, 1), hidden_layers=(8, 8, 6),
             dropouts=(0.2, 0.2, 0.2))


def _series():
    t = np.arange(200, dtype=np.float32)
    series = np.sin(t / 10)
    series[150] += 5.0
    return series


def test_anomaly_detector_forecast_and_fit_match_jax():
    jm, params, state, tm = _pair(jad.AnomalyDetector, tad.AnomalyDetector,
                                  seed=2, **AD_KW)
    assert [tm.slot(l) for l in tm.layers] == [jm.slot(l) for l in jm.layers]
    assert tm.constructor_config() == jm.constructor_config()
    x, y = tad.unroll(_series(), unroll_length=10)
    want, _ = jm.apply(params, state, x[:40])
    with torch.no_grad():
        got = tm.apply(torch.from_numpy(x[:40])).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)
    want_l, got_l, jp, tp = _fit_both(jm, params, state, tm, x[:64],
                                      y[:64], "mse", 32)
    assert len(got_l) == len(want_l) == 2
    np.testing.assert_allclose(got_l, want_l, rtol=0, atol=1e-5)
    for name, v in jp.items():
        np.testing.assert_allclose(tp[name].numpy(), v.numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)


def test_anomaly_helpers_match_jax():
    series = _series()
    for length, step in [(10, 1), (4, 3)]:
        for a, b in zip(tad.unroll(series, length, step),
                        jad.unroll(series, length, step)):
            np.testing.assert_array_equal(a, b)
    x, y = tad.AnomalyDetector.unroll(np.array([1, 2, 3, 4, 5, 6],
                                               np.float32), 2, 1)
    np.testing.assert_array_equal(x[:, :, 0], [[1, 2], [2, 3], [3, 4],
                                               [4, 5]])
    np.testing.assert_array_equal(y, [3, 4, 5, 6])
    with pytest.raises(ValueError, match="too short"):
        tad.unroll(series[:5], 10)
    data = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32)
    data[:, 2] = 4.0
    np.testing.assert_array_equal(tad.standard_scale(data),
                                  jad.standard_scale(data))
    pred = series + np.random.default_rng(1).normal(
        scale=0.05, size=series.shape).astype(np.float32)
    np.testing.assert_array_equal(tad.detect_anomalies(series, pred, 5),
                                  jad.detect_anomalies(series, pred, 5))
    out = tad.AnomalyDetector.detect_anomalies(series, pred, 5)
    assert out.shape == (200, 3) and (~np.isnan(out[:, 2])).sum() == 5
    xs, ys = tad.unroll(series, 10)
    for a, b in zip(tad.AnomalyDetector.train_test_split(xs, ys, 30),
                    jad.AnomalyDetector.train_test_split(xs, ys, 30)):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    with pytest.raises(ValueError, match="equal"):
        tad.AnomalyDetector((10, 1), (8, 8), (0.2,), device="cpu")


def test_anomaly_detector_bundles_load_both_ways(tmp_path):
    jm, params, state, tm = _pair(jad.AnomalyDetector, tad.AnomalyDetector,
                                  seed=3, **AD_KW)
    x, y = tad.unroll(_series(), unroll_length=10)
    jm.compile(optimizer="adam", loss="mse", mesh=_mesh())
    jm.estimator.initial_weights = (params, state)
    jm.fit(x[:32], y[:32], batch_size=32, nb_epoch=1)
    jm.save_model(str(tmp_path / "jax"))
    back = tad.AnomalyDetector.load_model(str(tmp_path / "jax"),
                                          device="cpu")
    back.compile(optimizer="adam", loss="mse")
    np.testing.assert_allclose(back.predict(x[:8]),
                               np.asarray(jm.predict(x[:8])), rtol=0,
                               atol=1e-5)
    tm.save_model(str(tmp_path / "pt"))
    jback = jad.AnomalyDetector.load_model(str(tmp_path / "pt"))
    jback.compile(optimizer="adam", loss="mse")
    with torch.no_grad():
        mine = tm.apply(torch.from_numpy(x[:8])).numpy()
    np.testing.assert_allclose(np.asarray(jback.predict(x[:8])), mine,
                               rtol=0, atol=1e-5)
