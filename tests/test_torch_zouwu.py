"""The port's Zouwu against the JAX package's, on the CPU.

Mirrors the cases of ``tests/test_zouwu.py`` (JAX's ``slow`` AutoTS case
runs here at a smaller size). The forecasters start from the weights the
JAX Estimator's first fit draws and train, predict and forecast within
1e-5 of JAX's. TCMF's initial factors are ``prng.normal``'s, within
7.2e-7 of ``jax.random.normal``'s, and from the same factors a fit's steps
are JAX's within 1e-5 (dict input, incremental fits); it recovers a
low-rank panel as JAX's does. The thresholds and detectors give JAX's
indices exactly; ``AEDetector`` trains from JAX's initial weights and
returns JAX's indices.
"""

import jax
import numpy as np
import pytest

from analytics_zoo_tpu import zouwu as jzouwu
from analytics_zoo_tpu.automl import models as jmodels
from analytics_zoo_tpu.automl.recipe import SmokeRecipe as JSmokeRecipe
from analytics_zoo_tpu.zouwu.model import anomaly as janomaly
from analytics_zoo_tpu_torch.automl import models as tmodels
from analytics_zoo_tpu_torch.automl.recipe import SmokeRecipe
from analytics_zoo_tpu_torch.bridge import params_from_jax
from analytics_zoo_tpu_torch.common import prng
from analytics_zoo_tpu_torch.zouwu import (AEDetector, AutoTSTrainer,
                                           LSTMForecaster, MTNetForecaster,
                                           Seq2SeqForecaster, TCMFForecaster,
                                           ThresholdDetector,
                                           ThresholdEstimator, TSPipeline)

TOL = 1e-5


def make_df(n=80):
    import pandas as pd

    dt = pd.date_range("2020-01-01", periods=n, freq="1h")
    value = np.sin(np.arange(n) / 6.0)
    return pd.DataFrame({"datetime": dt, "value": value})


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _k_init():
    return jax.random.split(jax.random.PRNGKey(0))[0]


@pytest.fixture
def jax_init(monkeypatch):
    """Every port forecaster model built in the test starts from the
    weights the JAX Estimator's first fit draws for the same config."""
    build = tmodels.BaseTSModel.build

    def built_from_jax(self, input_shape, **config):
        build(self, input_shape, **config)
        jm = getattr(jmodels, type(self).__name__)(
            future_seq_len=self.future_seq_len)
        shape = tuple(self.config["input_shape"])
        jm.build(shape, **{k: v for k, v in self.config.items()
                           if k != "input_shape"})
        params, _ = jm.model.build(_k_init(), shape)
        self.model.load_state_dict(params_from_jax(_np(params)))
        return self

    monkeypatch.setattr(tmodels.BaseTSModel, "build", built_from_jax)


def test_autots_trainer_end_to_end(tmp_path, jax_init):
    df = make_df(40)
    ppl = AutoTSTrainer(horizon=1, device="cpu").fit(
        df, metric="mse", recipe=SmokeRecipe())
    jppl = jzouwu.AutoTSTrainer(horizon=1).fit(df, metric="mse",
                                               recipe=JSmokeRecipe())
    pred = ppl.predict(df)
    assert "value" in pred.columns
    np.testing.assert_allclose(pred["value"].to_numpy(),
                               jppl.predict(df)["value"].to_numpy(), rtol=0,
                               atol=TOL)
    ev = ppl.evaluate(df, metrics=["mse"])
    assert np.isfinite(ev[0])
    np.testing.assert_allclose(ev, jppl.evaluate(df, metrics=["mse"]),
                               rtol=1e-5, atol=TOL)
    p = str(tmp_path / "ts")
    ppl.save(p)
    loaded = TSPipeline.load(p, device="cpu")
    np.testing.assert_allclose(loaded.predict(df)["value"].to_numpy(),
                               pred["value"].to_numpy(), rtol=0, atol=TOL)
    jloaded = jzouwu.TSPipeline.load(p)
    mean_df, unc = loaded.predict_with_uncertainty(df, n_iter=2)
    _, junc = jloaded.predict_with_uncertainty(df, n_iter=2)
    assert np.isfinite(unc).all()
    np.testing.assert_allclose(unc, junc, rtol=0, atol=TOL)
    loaded.fit(df, epochs=1)
    jloaded.fit(df, epochs=1)
    np.testing.assert_allclose(loaded.predict(df)["value"].to_numpy(),
                               jloaded.predict(df)["value"].to_numpy(),
                               rtol=0, atol=TOL)


def _forecast_pair(f, jf, x, y, **fit):
    got, want = f.fit(x, y, **fit), jf.fit(x, y, **fit)
    assert np.isfinite(got) and abs(got - want) <= TOL
    np.testing.assert_allclose(f.predict(x), jf.predict(x), rtol=0, atol=TOL)
    np.testing.assert_allclose(f.evaluate(x, y, metrics=["mse"]),
                               jf.evaluate(x, y, metrics=["mse"]), rtol=0,
                               atol=TOL)
    return f.predict(x)


def test_lstm_forecaster(jax_init):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((48, 5, 2)).astype("float32")
    y = x[:, -1, :1]
    kw = dict(target_dim=1, lstm_1_units=8, lstm_2_units=8)
    pred = _forecast_pair(LSTMForecaster(**kw, device="cpu"),
                          jzouwu.LSTMForecaster(**kw), x, y, epochs=2,
                          batch_size=16)
    assert pred.shape == (48, 1)


def test_mtnet_forecaster_stacked_rnn(jax_init):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 8, 2)).astype("float32")  # (1+1)*4 = 8
    y = rng.standard_normal((16, 1)).astype("float32")
    kw = dict(target_dim=1, long_series_num=1, series_length=4,
              ar_window_size=2, cnn_height=2, cnn_hid_size=8,
              rnn_hid_sizes=[8, 16])
    f = MTNetForecaster(**kw, device="cpu")
    jf = jzouwu.MTNetForecaster(**kw)
    assert _forecast_pair(f, jf, x, y, epochs=1,
                          batch_size=8).shape == (16, 1)
    mean, std = f.predict_with_uncertainty(x, n_iter=2)
    jmean, jstd = jf.predict_with_uncertainty(x, n_iter=2)
    np.testing.assert_allclose(mean, jmean, rtol=0, atol=TOL)
    np.testing.assert_allclose(std, jstd, rtol=0, atol=TOL)


def test_seq2seq_forecaster_horizon(tmp_path, jax_init):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((24, 6, 1)).astype("float32")
    y = rng.standard_normal((24, 4)).astype("float32")
    f = Seq2SeqForecaster(horizon=4, latent_dim=8, device="cpu")
    jf = jzouwu.Seq2SeqForecaster(horizon=4, latent_dim=8)
    pred = _forecast_pair(f, jf, x, y, epochs=1, batch_size=8)
    assert pred.shape == (24, 4)
    path = str(tmp_path / "s2s")
    f.save(path)
    g = Seq2SeqForecaster(horizon=4, device="cpu").restore(path)
    np.testing.assert_allclose(g.predict(x), pred, rtol=0, atol=0)


def test_tcmf_initial_factors_are_jax_normals():
    for seed, (n, t) in ((0, (12, 60)), (3, (5, 30))):
        kf, kx = jax.random.split(jax.random.PRNGKey(seed))
        tkf, tkx = prng.split(prng.PRNGKey(seed))
        for jk, tk, shape in ((kf, tkf, (n, 4)), (kx, tkx, (4, t))):
            want = np.asarray(jax.random.normal(jk, shape))
            got = prng.normal(tk, shape).numpy()
            assert np.abs(got - want).max() <= 7.2e-7


def _tcmf_from(factors, cls, y, **kw):
    """A TCMF of ``cls`` holding ``factors`` as a previous fit's, then
    fitted incrementally on ``y``."""
    f = cls(**kw) if cls is jzouwu.TCMFForecaster else cls(**kw, device="cpu")
    f.F, f.X = (np.array(a) for a in factors)
    return f, f.fit(y, incremental=True)


def test_tcmf_steps_match_jax_from_bridged_factors():
    rng = np.random.default_rng(5)
    y = rng.standard_normal((6, 30)).astype("float32")
    jf = jzouwu.TCMFForecaster(rank=3, max_iter=5)
    jf.fit(y)
    factors = (jf.F, jf.X)
    for y_next in (y, np.concatenate([y, y[:, :4]], axis=1)):
        kw = dict(rank=3, max_iter=7, lr=0.03)
        f, loss = _tcmf_from(factors, TCMFForecaster, y_next, **kw)
        jf2, jloss = _tcmf_from(factors, jzouwu.TCMFForecaster, y_next, **kw)
        assert abs(loss - jloss) <= TOL
        np.testing.assert_allclose(f.F, jf2.F, rtol=0, atol=TOL)
        np.testing.assert_allclose(f.X, jf2.X, rtol=0, atol=TOL)
        np.testing.assert_allclose(f.ar_coef, jf2.ar_coef, rtol=0, atol=1e-4)
        np.testing.assert_allclose(f.predict(horizon=3),
                                   jf2.predict(horizon=3), rtol=0, atol=1e-4)


def test_tcmf_forecaster_recovers_low_rank():
    rng = np.random.default_rng(0)
    n, T, k = 12, 60, 3
    F = rng.standard_normal((n, k))
    t = np.arange(T + 8)
    basis = np.stack([np.sin(t / 5), np.cos(t / 7), 0.01 * t])
    Y_full = F @ basis
    f = TCMFForecaster(rank=4, max_iter=400, ar_lags=6, device="cpu")
    loss = f.fit(Y_full[:, :T])
    assert loss < 0.05
    pred = f.predict(horizon=8)
    assert pred.shape == (n, 8)
    mae = f.evaluate(Y_full[:, T:], metric=["mae"])[0]
    naive = np.abs(Y_full[:, T:] - Y_full[:, T - 1:T]).mean()
    assert mae < naive
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TCMFForecaster(rank=2, max_iter=2).fit(Y_full[:, :T])


def test_tcmf_save_restore_both_ways(tmp_path):
    rng = np.random.default_rng(2)
    y = rng.standard_normal((6, 40)).astype("float32")
    f = TCMFForecaster(rank=3, max_iter=80, device="cpu")
    f.fit(y)
    pred = f.predict(horizon=5)
    path = str(tmp_path / "tcmf")
    f.save(path)
    g = TCMFForecaster().restore(path)
    np.testing.assert_allclose(g.predict(horizon=5), pred, rtol=1e-6)
    assert g.ar_lags_eff == f.ar_lags_eff and g.rank == f.rank
    jg = jzouwu.TCMFForecaster().restore(path)
    np.testing.assert_array_equal(jg.predict(horizon=5), pred)


def test_tcmf_dict_input_and_incremental():
    rng = np.random.default_rng(1)
    y = rng.standard_normal((5, 30)).astype("float32")
    f = TCMFForecaster(rank=2, max_iter=50, device="cpu")
    f.fit({"id": np.arange(5), "y": y})
    l2 = f.fit(y, incremental=True)
    assert np.isfinite(l2)
    y_longer = np.concatenate(
        [y, rng.standard_normal((5, 10)).astype("float32")], axis=1)
    l3 = f.fit(y_longer, incremental=True)
    assert np.isfinite(l3) and f.X.shape[1] == 40


# ------------------------------------------------------------------ anomaly
def test_threshold_estimator_and_detector():
    rng = np.random.default_rng(0)
    y = rng.standard_normal((100, 3))
    yhat = y + 0.01 * rng.standard_normal((100, 3))
    y[7] += 10.0
    for mode in ("default", "gaussian"):
        th = ThresholdEstimator().fit(y, yhat, mode=mode, ratio=0.01)
        assert th == janomaly.ThresholdEstimator().fit(y, yhat, mode=mode,
                                                       ratio=0.01)
        found = ThresholdDetector().detect(y, yhat, threshold=th)
        assert found == janomaly.ThresholdDetector().detect(y, yhat,
                                                            threshold=th)
    th = ThresholdEstimator().fit(y, yhat, ratio=0.01)
    found = ThresholdDetector().detect(y, yhat, threshold=th)
    assert 7 in found and len(found) <= 3
    with pytest.raises(ValueError, match="mode"):
        ThresholdEstimator().fit(y, yhat, mode="nope")


def test_threshold_detector_modes():
    y = np.array([[0.0, 0.0], [1.0, 1.0], [5.0, 5.0]])
    yhat = np.zeros_like(y)
    d, jd = ThresholdDetector(), janomaly.ThresholdDetector()
    per_sample = np.array([10.0, 0.5, 10.0])
    per_dim = np.full_like(y, 2.0)
    lo, hi = np.full_like(y, -1.0), np.full_like(y, 2.0)
    for kw, want in ((dict(yhat=yhat, threshold=3.0), [2]),
                     (dict(yhat=yhat, threshold=per_sample), [1]),
                     (dict(yhat=yhat, threshold=np.float32(3.0)), [2]),
                     (dict(yhat=yhat, threshold=per_dim), [2]),
                     (dict(threshold=(lo, hi)), [2])):
        assert d.detect(y, **kw) == jd.detect(y, **kw) == want
    with pytest.raises(ValueError):
        d.detect(y, yhat=None, threshold=1.0)


class _AEFromJax(AEDetector):
    """AEDetector whose autoencoder starts from the JAX detector's first
    fit's weights."""

    def _build(self, dim):
        m = super()._build(dim)
        jm = janomaly_ae_model(self, dim)
        params, _ = jm.build(_k_init(), (dim,))
        m.load_state_dict(params_from_jax(_np(params)))
        return m


def janomaly_ae_model(det, dim):
    from analytics_zoo_tpu.nn import layers as JL
    from analytics_zoo_tpu.nn.topology import Sequential as JSequential

    jm = JSequential(name="ae_detector")
    jm.add(JL.InputLayer((dim,)))
    jm.add(JL.Dense(det.hidden, activation="relu"))
    jm.add(JL.Dense(det.latent_dim, activation="relu"))
    jm.add(JL.Dense(det.hidden, activation="relu"))
    jm.add(JL.Dense(dim))
    return jm


def test_ae_detector():
    rng = np.random.default_rng(0)
    y = rng.standard_normal((128, 6)).astype("float32") * 0.1
    y[5] += 8.0
    kw = dict(latent_dim=2, hidden=8, epochs=5, ratio=0.02)
    det = _AEFromJax(**kw, device="cpu").fit(y)
    jdet = jzouwu.AEDetector(**kw).fit(y)
    found = det.detect(y)
    assert 5 in found
    assert found == jdet.detect(y)
    np.testing.assert_allclose(det.score(y), jdet.score(y), rtol=0,
                               atol=1e-4)
    assert abs(det.threshold_ - jdet.threshold_) <= 1e-4
    with pytest.raises(RuntimeError, match="not fitted"):
        AEDetector(device="cpu").score(y)
