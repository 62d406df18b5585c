"""The port's AutoML against the JAX package's, on the CPU.

Mirrors the cases of ``tests/test_automl.py``. Spaces, grids, metrics,
recipes and TPE draw JAX's configs exactly; the feature transformer makes
JAX's arrays and frames. The three forecasters start from the weights the
JAX Estimator's first fit draws (``split(PRNGKey(0))[0]``, loaded through
``bridge.params_from_jax``: the cores keep JAX's trees), and their forward
passes, 2-epoch fits with dropout in training, predictions and
``predict_with_uncertainty`` (the MC-dropout masks are JAX's bits) are
within 1e-5 of JAX's. The search picks JAX's best trial and stops JAX's
trials, with threads; failing trials are handled as in JAX; the predictor
and the pipeline run end to end, and each package loads the other's saved
pipeline. JAX's ``slow`` LSTM case runs here, at a smaller size.
"""

import json

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu import automl as jautoml
from analytics_zoo_tpu.automl import models as jmodels
from analytics_zoo_tpu.automl import space as jspace
from analytics_zoo_tpu_torch import automl as tautoml
from analytics_zoo_tpu_torch.automl import models as tmodels
from analytics_zoo_tpu_torch.automl import space as tspace
from analytics_zoo_tpu_torch.automl.search import SearchEngine
from analytics_zoo_tpu_torch.bridge import params_from_jax, params_to_numpy

TOL = 1e-5


def make_df(n=200, freq_hours=1):
    import pandas as pd

    dt = pd.date_range("2020-01-01", periods=n, freq=f"{freq_hours}h")
    rng = np.random.default_rng(0)
    value = np.sin(np.arange(n) / 10.0) + 0.1 * rng.standard_normal(n)
    return pd.DataFrame({"datetime": dt, "value": value})


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_init_params(m):
    """The weights the JAX Estimator's first fit gives the JAX model of
    ``m``'s class and config: ``build(split(PRNGKey(0))[0], shape)``."""
    jm = getattr(jmodels, type(m).__name__)(future_seq_len=m.future_seq_len)
    shape = tuple(m.config["input_shape"])
    jm.build(shape, **{k: v for k, v in m.config.items()
                       if k != "input_shape"})
    k_init = jax.random.split(jax.random.PRNGKey(0))[0]
    params, _ = jm.model.build(k_init, shape)
    return _np(params)


@pytest.fixture
def jax_init(monkeypatch):
    """Every port model built in the test starts from JAX's weights."""
    build = tmodels.BaseTSModel.build

    def built_from_jax(self, input_shape, **config):
        build(self, input_shape, **config)
        self.model.load_state_dict(params_from_jax(jax_init_params(self)))
        return self

    monkeypatch.setattr(tmodels.BaseTSModel, "build", built_from_jax)


def _same_weights(jm, tm):
    jp = _np(jm.model.estimator.train_state["params"])
    tp = params_to_numpy(tm.model)

    def walk(j, t, path):
        if isinstance(j, dict):
            for k, v in j.items():
                walk(v, t[k], f"{path}.{k}")
        elif isinstance(j, list):
            for i, v in enumerate(j):
                walk(v, t[str(i)], f"{path}.{i}")
        else:
            np.testing.assert_allclose(t, j, rtol=0, atol=TOL, err_msg=path)

    walk(jp, tp, "params")


# ------------------------------------------------------------------ space
def test_sample_config_deterministic_and_jax():
    space = {"a": tspace.Choice([1, 2, 3]), "b": tspace.Uniform(0, 1),
             "c": "fixed", "d": tspace.LogUniform(1e-4, 1.0),
             "e": tspace.QUniform(0, 10, 0.5), "f": tspace.RandInt(2, 9)}
    jsp = {"a": jspace.Choice([1, 2, 3]), "b": jspace.Uniform(0, 1),
           "c": "fixed", "d": jspace.LogUniform(1e-4, 1.0),
           "e": jspace.QUniform(0, 10, 0.5), "f": jspace.RandInt(2, 9)}
    c1 = tspace.sample_config(space, np.random.default_rng(7))
    c2 = tspace.sample_config(space, np.random.default_rng(7))
    assert c1 == c2 and c1["c"] == "fixed" and c1["a"] in (1, 2, 3)
    rng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(5):
        assert tspace.sample_config(space, rng) == \
            jspace.sample_config(jsp, jrng)


def test_grid_product_expansion():
    space = {"u": tspace.GridSearch([16, 32]),
             "v": tspace.GridSearch(["x", "y"]), "w": 1}
    combos = tspace.grid_product(space)
    assert len(combos) == 4 and {"u": 16, "v": "x"} in combos
    assert combos == jspace.grid_product(
        {"u": jspace.GridSearch([16, 32]), "v": jspace.GridSearch(["x", "y"]),
         "w": 1})


# ------------------------------------------------------------------ metrics
def test_evaluator_metrics():
    ev, jev = tautoml.Evaluator, jautoml.Evaluator
    y = np.array([1.0, 2.0, 3.0])
    p = np.array([1.0, 2.0, 4.0])
    assert ev.evaluate("mse", y, p) == pytest.approx(1 / 3)
    assert ev.evaluate("mae", y, p) == pytest.approx(1 / 3)
    assert ev.evaluate("r_square", y, y) == pytest.approx(1.0, abs=1e-6)
    for m in ("mse", "rmse", "mae", "r2", "smape", "mape", "accuracy"):
        assert ev.evaluate(m, y, p) == jev.evaluate(m, y, p)
    assert ev.reward("mse", 2.0) == -2.0
    assert ev.reward("r2", 0.5) == 0.5
    with pytest.raises(ValueError):
        ev.check_metric("nope")


# ------------------------------------------------------------------ features
def test_feature_transformer_matches_jax_and_unscales():
    df = make_df(50)
    ft = tautoml.TimeSequenceFeatureTransformer(future_seq_len=2)
    jft = jautoml.TimeSequenceFeatureTransformer(future_seq_len=2)
    feats = ft.get_feature_list(df)
    assert feats == jft.get_feature_list(df)
    x, y = ft.fit_transform(df, past_seq_len=5,
                            selected_features=json.dumps(feats))
    jx, jy = jft.fit_transform(df, past_seq_len=5,
                               selected_features=json.dumps(feats))
    assert x.shape == (50 - 5 - 2 + 1, 5, 1 + len(feats))
    assert y.shape == (x.shape[0], 2)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    back = ft.unscale(y)
    expect = df["value"].to_numpy()[np.arange(y.shape[0])[:, None]
                                    + 5 + np.arange(2)[None, :]]
    np.testing.assert_allclose(back, expect, atol=1e-8)
    np.testing.assert_array_equal(ft.unscale_uncertainty(y),
                                  jft.unscale_uncertainty(y))


def test_feature_transformer_save_restore_both_ways(tmp_path):
    df = make_df(30)
    ft = tautoml.TimeSequenceFeatureTransformer(future_seq_len=1)
    x, y = ft.fit_transform(df, past_seq_len=4)
    p, jp = str(tmp_path / "ft.json"), str(tmp_path / "jft.json")
    ft.save(p)
    jft = jautoml.TimeSequenceFeatureTransformer(future_seq_len=1)
    jft.fit_transform(df, past_seq_len=4)
    jft.save(jp)
    for path in (p, jp):
        ft2 = tautoml.TimeSequenceFeatureTransformer().restore(path)
        x2, y2 = ft2.transform(df, is_train=True)
        np.testing.assert_array_equal(x, x2)
        np.testing.assert_array_equal(y, y2)


def test_feature_transformer_predict_mode():
    import pandas as pd

    df = make_df(30)
    ft = tautoml.TimeSequenceFeatureTransformer(future_seq_len=1)
    ft.fit_transform(df, past_seq_len=4)
    jft = jautoml.TimeSequenceFeatureTransformer(future_seq_len=1)
    jft.fit_transform(df, past_seq_len=4)
    x, y = ft.transform(df, is_train=False)
    assert y is None and x.shape[0] == 30 - 4 + 1
    out = ft.post_processing(df, np.zeros((x.shape[0], 1)), is_train=False)
    jout = jft.post_processing(df, np.zeros((x.shape[0], 1)), is_train=False)
    pd.testing.assert_frame_equal(out, jout)
    assert out["datetime"].iloc[0] == \
        pd.Timestamp("2020-01-01") + pd.Timedelta(hours=4)
    assert out["datetime"].iloc[-1] == \
        pd.Timestamp("2020-01-01") + pd.Timedelta(hours=30)


# ------------------------------------------------------------------ models
def _pair(cls, future=1):
    return (getattr(tmodels, cls)(future_seq_len=future, device="cpu"),
            getattr(jmodels, cls)(future_seq_len=future))


def test_vanilla_lstm_fit_predict_matches_jax(tmp_path, jax_init):
    """JAX's ``slow`` case, at (32, 4, 3): 2 epochs with dropout, MC
    dropout, save/restore (each package restores the other's)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 4, 3)).astype("float32")
    y = x[:, -1, :1]
    m, jm = _pair("VanillaLSTM")
    cfg = dict(lstm_1_units=8, lstm_2_units=8, epochs=2, batch_size=16)
    val, jval = m.fit_eval(x, y, **cfg), jm.fit_eval(x, y, **cfg)
    assert np.isfinite(val) and abs(val - jval) <= TOL
    _same_weights(jm, m)
    pred = m.predict(x)
    assert pred.shape == (32, 1)
    np.testing.assert_allclose(pred, jm.predict(x), rtol=0, atol=TOL)
    mean, std = m.predict_with_uncertainty(x, n_iter=3)
    jmean, jstd = jm.predict_with_uncertainty(x, n_iter=3)
    assert mean.shape == (32, 1) and std.shape == (32, 1)
    np.testing.assert_allclose(mean, jmean, rtol=0, atol=TOL)
    np.testing.assert_allclose(std, jstd, rtol=0, atol=TOL)
    assert float(std.max()) > 0          # the masks differ between passes
    mp, jmp = str(tmp_path / "m"), str(tmp_path / "jm")
    m.save(mp)
    jm.save(jmp)
    for path, want in ((mp, pred), (jmp, jm.predict(x))):
        m2 = tmodels.VanillaLSTM(device="cpu").restore(path)
        mp2 = str(tmp_path / "m2")
        m2.save(mp2)                      # a restored model saves its weights
        np.testing.assert_allclose(m2.predict(x), want, rtol=0, atol=TOL)
        m3 = tmodels.VanillaLSTM(device="cpu").restore(mp2)
        np.testing.assert_allclose(m3.predict(x), want, rtol=0, atol=TOL)


def test_seq2seq_multistep_matches_jax(jax_init):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 6, 2)).astype("float32")
    y = rng.standard_normal((32, 3)).astype("float32")
    m, jm = _pair("TSSeq2Seq", 3)
    cfg = dict(latent_dim=8, epochs=2, batch_size=16, dropout=0.3)
    assert abs(m.fit_eval(x, y, **cfg) - jm.fit_eval(x, y, **cfg)) <= TOL
    _same_weights(jm, m)
    pred = m.predict(x)
    assert pred.shape == (32, 3)
    np.testing.assert_allclose(pred, jm.predict(x), rtol=0, atol=TOL)
    mean, std = m.predict_with_uncertainty(x, n_iter=3)
    jmean, jstd = jm.predict_with_uncertainty(x, n_iter=3)
    np.testing.assert_allclose(mean, jmean, rtol=0, atol=TOL)
    np.testing.assert_allclose(std, jstd, rtol=0, atol=TOL)


def test_mtnet_matches_jax(jax_init):
    rng = np.random.default_rng(0)
    # (long_num+1)*time_step = 4*3 = 12
    x = rng.standard_normal((16, 12, 2)).astype("float32")
    y = rng.standard_normal((16, 1)).astype("float32")
    m, jm = _pair("MTNet")
    cfg = dict(time_step=3, long_num=3, cnn_height=2, cnn_hid_size=8,
               rnn_hid_size=8, ar_window=2, epochs=2, batch_size=8)
    val, jval = m.fit_eval(x, y, **cfg), jm.fit_eval(x, y, **cfg)
    assert np.isfinite(val) and abs(val - jval) <= TOL
    _same_weights(jm, m)
    assert m.predict(x).shape == (16, 1)
    np.testing.assert_allclose(m.predict(x), jm.predict(x), rtol=0, atol=TOL)
    mean, std = m.predict_with_uncertainty(x, n_iter=2)
    jmean, jstd = jm.predict_with_uncertainty(x, n_iter=2)
    np.testing.assert_allclose(mean, jmean, rtol=0, atol=TOL)
    np.testing.assert_allclose(std, jstd, rtol=0, atol=TOL)


def test_mtnet_forward_matches_jax_on_bridged_weights():
    """The core's forward alone, inference and training mode (the conv,
    GRU stack, attention and AR term; dropout masks from one key)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 10, 3)).astype("float32")
    m, jm = _pair("MTNet", 2)
    cfg = dict(time_step=2, long_num=4, cnn_height=2, cnn_hid_size=6,
               rnn_hid_sizes=[5, 7], ar_window=3)
    m.build((10, 3), **cfg)
    jm.build((10, 3), **cfg)
    params, state = jm.model.build(jax.random.PRNGKey(9), (10, 3))
    m.model.load_state_dict(params_from_jax(_np(params)))
    assert sorted(m.model.state_dict())[:2] == ["1__mtnetcore.ar",
                                                "1__mtnetcore.att"]
    key = jax.random.PRNGKey(21)
    for training in (False, True):
        want, _ = jm.model.apply(params, state, x, training=training,
                                 rng=key)
        m.model.train(training)
        with torch.no_grad():
            got = m.model.apply(torch.from_numpy(x),
                                rng=tuple(int(w) for w in np.asarray(key)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL)
    m.model.eval()


def test_mtnet_rejects_short_window():
    m = tmodels.MTNet(future_seq_len=1, device="cpu")
    x = np.zeros((4, 5, 2), dtype="float32")
    y = np.zeros((4, 1), dtype="float32")
    with pytest.raises(ValueError):
        m.fit_eval(x, y, time_step=3, long_num=3, epochs=1)


def test_models_need_a_device_without_cuda():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmodels.VanillaLSTM().fit_eval(np.zeros((4, 3, 1), np.float32),
                                       np.zeros((4, 1), np.float32))
    assert tmodels.MODEL_REGISTRY.keys() == jmodels.MODEL_REGISTRY.keys() \
        == {"LSTM", "Seq2Seq", "MTNet"}


# ------------------------------------------------------------------ search
def _quality_trainable(calls):
    def trainable(config, trial_seed=0):
        quality = config["q"]

        def round_fn():
            calls.append(quality)
            return 1.0 / quality

        return round_fn

    return trainable


def _results(eng):
    return [(r.trial_id, r.config, r.metric, r.stopped_early, r.error,
             r.history) for r in eng.results]


def test_search_engine_picks_best_and_median_stops():
    out = []
    for cls, grid in ((SearchEngine, tspace.GridSearch),
                      (jautoml.SearchEngine, jspace.GridSearch)):
        calls = []
        eng = cls(_quality_trainable(calls), metric="mse", num_samples=1,
                  training_iteration=4, grace_rounds=1, seed=0)
        best = eng.run({"q": grid([1, 2, 3, 4])})
        out.append((best.config, best.metric, _results(eng), sorted(calls)))
    assert out[0] == out[1]
    assert out[0][0]["q"] == 4 and out[0][1] == pytest.approx(0.25)
    assert any(r[3] for r in out[0][2])


def test_search_engine_survives_failing_trial():
    def trainable(config, trial_seed=0):
        if config["q"] == 2:
            raise RuntimeError("boom")
        return lambda: float(config["q"])

    out = []
    for cls, grid in ((SearchEngine, tspace.GridSearch),
                      (jautoml.SearchEngine, jspace.GridSearch)):
        eng = cls(trainable, metric="mse", training_iteration=1)
        best = eng.run({"q": grid([1, 2, 3])})
        assert best.config["q"] == 1
        assert sum(1 for r in eng.results if r.error) == 1
        out.append(_results(eng))
    assert out[0] == out[1]


def test_search_engine_round_failure_and_all_fail():
    def flaky(config, trial_seed=0):
        def round_fn():
            if config["q"] == 3:
                raise ValueError("diverged")
            return float(config["q"])
        return round_fn

    eng = SearchEngine(flaky, metric="mse", training_iteration=2,
                       max_workers=2)
    jeng = jautoml.SearchEngine(flaky, metric="mse", training_iteration=2,
                                max_workers=2)
    assert eng.run({"q": tspace.GridSearch([1, 3, 5])}).config["q"] == \
        jeng.run({"q": jspace.GridSearch([1, 3, 5])}).config["q"] == 1
    assert _results(eng) == _results(jeng)

    def trainable(config, trial_seed=0):
        raise RuntimeError("nope")

    with pytest.raises(RuntimeError, match="all .* trials failed"):
        SearchEngine(trainable, metric="mse").run({"q": 1})


def test_search_over_time_sequence_models_matches_jax(jax_init):
    """LSTM, Seq2Seq and MTNet trials on a seeded sine-plus-noise series,
    2 rounds, 2 threads: JAX's configs, metrics (1e-5), stopped trials and
    best trial."""
    rng = np.random.default_rng(0)
    series = (np.sin(np.arange(80) / 5.0)
              + 0.1 * rng.standard_normal(80)).astype(np.float32)
    idx = np.arange(12)[None, :] + np.arange(80 - 12)[:, None]
    x = series[idx][:, :, None]
    y = series[idx[:, -1] + 1][:, None]

    def trainable_for(pkg, device):
        def trainable(config, trial_seed=0):
            kw = {} if device is None else {"device": device}
            model = pkg.TimeSequenceModel(future_seq_len=1, **kw)
            return lambda: model.fit_eval(x, y, **config)
        return trainable

    def space(sp):
        return {"model": sp.Choice(["LSTM", "Seq2Seq", "MTNet"]),
                "lstm_1_units": 4, "lstm_2_units": 4, "latent_dim": 4,
                "time_step": 3, "long_num": 3, "cnn_height": 2,
                "cnn_hid_size": 4, "rnn_hid_size": 4,
                "lr": sp.Uniform(1e-3, 1e-2), "epochs": 1, "batch_size": 16}

    eng = SearchEngine(trainable_for(tautoml, "cpu"), metric="mse",
                       num_samples=4, training_iteration=2, max_workers=2,
                       seed=1)
    jeng = jautoml.SearchEngine(trainable_for(jautoml, None), metric="mse",
                                num_samples=4, training_iteration=2,
                                max_workers=2, seed=1)
    best, jbest = eng.run(space(tspace)), jeng.run(space(jspace))
    assert best.trial_id == jbest.trial_id and best.config == jbest.config
    for r, jr in zip(eng.results, jeng.results):
        assert (r.trial_id, r.config, r.stopped_early, r.error) == \
            (jr.trial_id, jr.config, jr.stopped_early, jr.error)
        np.testing.assert_allclose(r.history, jr.history, rtol=0, atol=TOL)


# ------------------------------------------------------------------ recipes
def test_recipes_produce_jax_spaces():
    feats = ["HOUR", "IS_WEEKEND"]
    names = ("SmokeRecipe", "LSTMRandomGridRecipe", "MTNetSmokeRecipe",
             "MTNetRandomGridRecipe", "Seq2SeqRandomRecipe", "RandomRecipe")
    for name in names:
        recipe = getattr(tautoml, name)()
        jrecipe = getattr(jautoml, name)()
        assert recipe.runtime_params() == jrecipe.runtime_params()
        space = recipe.search_space(feats)
        jsp = jrecipe.search_space(feats)
        rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
        grid = tspace.grid_product(space)
        assert grid == jspace.grid_product(jsp)
        for grid_part in grid[:2]:
            cfg = tspace.sample_config(space, rng, fixed=grid_part)
            assert cfg == jspace.sample_config(jsp, jrng, fixed=grid_part)
            assert "model" in cfg
            assert isinstance(json.loads(cfg["selected_features"]), list)


def test_tpe_search_beats_random_on_quadratic():
    def trainable(config, trial_seed=0):
        def round_fn():
            return ((config["x"] - 2.0) ** 2
                    + (np.log10(config["lr"]) + 2.0) ** 2)
        return round_fn

    def best_of(pkg, sp, alg):
        eng = pkg(trainable, metric="mse", num_samples=24,
                  training_iteration=1, seed=7, search_alg=alg, n_initial=6)
        best = eng.run({"x": sp.Uniform(-5.0, 5.0),
                        "lr": sp.LogUniform(1e-4, 1.0)})
        return best.metric, _results(eng)

    tpe, tres = best_of(SearchEngine, tspace, "tpe")
    jtpe, jres = best_of(jautoml.SearchEngine, jspace, "tpe")
    assert tpe == jtpe and tres == jres
    rand, _ = best_of(SearchEngine, tspace, "random")
    assert tpe <= rand + 1e-9, (tpe, rand)
    assert tpe < 0.5, f"tpe did not converge near optimum: {tpe}"


def test_tpe_handles_choice_and_grid_dims():
    out = []
    for pkg, sp in ((SearchEngine, tspace), (jautoml.SearchEngine, jspace)):
        seen = []

        def trainable(config, trial_seed=0):
            seen.append(dict(config))
            return lambda: abs(config["units"] - 32) + \
                (0.0 if config["act"] == "tanh" else 5.0)

        eng = pkg(trainable, metric="mse", num_samples=10,
                  training_iteration=1, seed=3, search_alg="tpe", n_initial=3)
        best = eng.run({"units": sp.RandInt(4, 64),
                        "act": sp.Choice(["relu", "tanh"]),
                        "depth": sp.GridSearch([1, 2])})
        assert best.config["act"] == "tanh"
        assert {c["depth"] for c in seen} == {1, 2}
        assert len(eng.results) == 20
        out.append((seen, _results(eng)))
    assert out[0] == out[1]


# ------------------------------------------------------------------ end to end
def test_time_sequence_predictor_end_to_end(tmp_path, jax_init):
    """SmokeRecipe through the predictor in both packages: the same best
    config and refit, evaluation and forecasts within 1e-5; each package
    loads the other's saved pipeline; MC dropout on the restored one."""
    df = make_df(60)
    tsp = tautoml.TimeSequencePredictor(future_seq_len=1, device="cpu")
    jtsp = jautoml.TimeSequencePredictor(future_seq_len=1)
    pipeline = tsp.fit(df, metric="mse", recipe=tautoml.SmokeRecipe())
    jpipeline = jtsp.fit(df, metric="mse", recipe=jautoml.SmokeRecipe())
    assert pipeline.config == jpipeline.config
    ev = pipeline.evaluate(df, metrics=["mse", "smape"])
    assert len(ev) == 2 and all(np.isfinite(v) for v in ev)
    np.testing.assert_allclose(ev, jpipeline.evaluate(
        df, metrics=["mse", "smape"]), rtol=1e-5, atol=TOL)
    out = tsp.predict(df)
    assert "value" in out.columns and len(out) > 0
    np.testing.assert_allclose(out["value"].to_numpy(),
                               jtsp.predict(df)["value"].to_numpy(),
                               rtol=0, atol=TOL)
    pdir, jdir = str(tmp_path / "pipe"), str(tmp_path / "jpipe")
    pipeline.save(pdir)
    jpipeline.save(jdir)
    for path in (pdir, jdir):
        loaded = tautoml.load_ts_pipeline(path, device="cpu")
        np.testing.assert_allclose(loaded.predict(df)["value"].to_numpy(),
                                   out["value"].to_numpy(), rtol=0,
                                   atol=TOL)
    jloaded = jautoml.load_ts_pipeline(pdir)
    np.testing.assert_allclose(jloaded.predict(df)["value"].to_numpy(),
                               out["value"].to_numpy(), rtol=0, atol=TOL)
    mean_df, unc = loaded.predict_with_uncertainty(df, n_iter=2)
    jmean_df, junc = jloaded.predict_with_uncertainty(df, n_iter=2)
    np.testing.assert_allclose(unc, junc, rtol=0, atol=TOL)
    np.testing.assert_allclose(mean_df["value"].to_numpy(),
                               jmean_df["value"].to_numpy(), rtol=0,
                               atol=TOL)
    # incremental fit with the same config, in both
    loaded.fit(df, epoch_num=1)
    jloaded.fit(df, epoch_num=1)
    np.testing.assert_allclose(loaded.predict(df)["value"].to_numpy(),
                               jloaded.predict(df)["value"].to_numpy(),
                               rtol=0, atol=TOL)
    with pytest.raises(RuntimeError, match="not fitted"):
        tautoml.TimeSequencePredictor(device="cpu").predict(df)
