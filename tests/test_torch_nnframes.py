"""The port's NNFrames against the JAX package's, on the CPU.

Mirrors the nine cases of ``tests/test_nnframes.py``. Both packages start
from the same weights (the port's, written as a weight bundle and loaded
into the JAX model before its ``compile``), fit the same DataFrame and
transform it: predictions, classes and final parameters within 1e-5 of
JAX's. The setters (validation, ``setEndWhen``, both kinds of gradient
clipping, checkpoint, train summary, data cache level) drive the same
training. The image reader reads JAX's frame exactly; the XGBoost
passthrough fits the same engine (xgboost, else scikit-learn) and gives
JAX's predictions exactly, with the same save/load checks.
"""

import numpy as np
import pytest

from analytics_zoo_tpu.common.triggers import MaxIteration as JMaxIteration
from analytics_zoo_tpu.nn import layers as JL
from analytics_zoo_tpu.nn.topology import Sequential as JSequential
from analytics_zoo_tpu import nnframes as jnnf
from analytics_zoo_tpu_torch.bridge import params_to_numpy
from analytics_zoo_tpu_torch.common.triggers import MaxIteration
from analytics_zoo_tpu_torch.nn import layers as TL
from analytics_zoo_tpu_torch.nn.topology import Sequential
from analytics_zoo_tpu_torch.nnframes import (NNClassifier, NNClassifierModel,
                                              NNEstimator, NNImageReader,
                                              NNModel)

pd = pytest.importorskip("pandas")
TOL = 1e-5


def make_reg_df(n=128):
    rng = np.random.default_rng(0)
    a = rng.standard_normal(n)
    b = rng.standard_normal(n)
    return pd.DataFrame({"a": a, "b": b, "target": 2 * a - b})


def make_cls_df(n=128):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 4)).astype("float32")
    y = (x.sum(axis=1) > 0).astype("int64")
    return pd.DataFrame({"features": list(x), "label": y})


def mlp_pair(tmp_path, in_dim, out_dim, softmax=False, seed=0):
    """The port's MLP (weights drawn from ``seed``) and JAX's, loading the
    port's weights at its compile."""
    act = "softmax" if softmax else None
    tm = Sequential(device="cpu", seed=seed)
    tm.add(TL.InputLayer((in_dim,)))
    tm.add(TL.Dense(16, activation="relu"))
    tm.add(TL.Dense(out_dim, activation=act))
    jm = JSequential()
    jm.add(JL.InputLayer((in_dim,)))
    jm.add(JL.Dense(16, activation="relu"))
    jm.add(JL.Dense(out_dim, activation=act))
    path = str(tmp_path / f"init_{in_dim}_{out_dim}_{seed}")
    tm.save_model(path)
    jm.load_weights(path)
    return tm, jm


def _same_params(jm, tm):
    jp = jm.estimator.train_state["params"]
    tp = params_to_numpy(tm)
    for slot, leaves in jp.items():
        for leaf, v in leaves.items():
            np.testing.assert_allclose(tp[slot][leaf], np.asarray(v),
                                       rtol=0, atol=TOL,
                                       err_msg=f"{slot}.{leaf}")


def test_nnestimator_multi_column_regression(tmp_path):
    df = make_reg_df()
    tm, jm = mlp_pair(tmp_path, 2, 1)
    models = []
    for cls, m in ((NNEstimator, tm), (jnnf.NNEstimator, jm)):
        est = (cls(m, "mse").setFeaturesCol(["a", "b"]).setLabelCol("target")
               .setBatchSize(32).setMaxEpoch(30).setLearningRate(0.05))
        models.append(est.fit(df))
    out, jout = (m.transform(df) for m in models)
    assert "prediction" in out.columns and len(out) == len(df)
    mse = float(np.mean((out["prediction"] - df["target"]) ** 2))
    assert mse < 0.3, mse
    np.testing.assert_allclose(out["prediction"].to_numpy(),
                               jout["prediction"].to_numpy(), rtol=0,
                               atol=TOL)
    _same_params(jm, tm)


def test_nnestimator_array_column_and_preprocessing(tmp_path):
    df = make_cls_df()
    tm, jm = mlp_pair(tmp_path, 4, 1)
    outs = []
    for cls, m in ((NNEstimator, tm), (jnnf.NNEstimator, jm)):
        est = (cls(m, "mse", feature_preprocessing=lambda r: r * 1.0)
               .setFeaturesCol("features").setLabelCol("label")
               .setMaxEpoch(2))
        outs.append(est.fit(df).transform(df))
    assert np.isfinite(outs[0]["prediction"]).all()
    np.testing.assert_allclose(outs[0]["prediction"].to_numpy(),
                               outs[1]["prediction"].to_numpy(), rtol=0,
                               atol=TOL)


def test_nnclassifier_end_to_end(tmp_path):
    df = make_cls_df(256)
    tm, jm = mlp_pair(tmp_path, 4, 2, softmax=True)
    outs = []
    for cls, m in ((NNClassifier, tm), (jnnf.NNClassifier, jm)):
        clf = (cls(m).setFeaturesCol("features").setLabelCol("label")
               .setBatchSize(64).setMaxEpoch(20).setLearningRate(0.05))
        model = clf.fit(df)
        outs.append(model.transform(df))
    assert isinstance(model, jnnf.NNClassifierModel)
    out = outs[0]
    acc = float((out["prediction"].to_numpy() ==
                 df["label"].to_numpy()).mean())
    assert acc > 0.9, acc
    np.testing.assert_array_equal(out["prediction"].to_numpy(),
                                  outs[1]["prediction"].to_numpy())
    _same_params(jm, tm)
    # the fitted transformer saves and loads into a model of the same shape
    path = str(tmp_path / "nnmodel")
    NNClassifierModel(tm, features_col="features").save(path)
    fresh = mlp_pair(tmp_path, 4, 2, softmax=True, seed=5)[0]
    fresh.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    loaded = NNModel.load(path, model=fresh)
    got = loaded.setFeaturesCol("features").transform(df)
    want = NNModel(tm, features_col="features").transform(df)
    np.testing.assert_allclose(np.stack(got["prediction"]),
                               np.stack(want["prediction"]), rtol=0, atol=0)


def test_nnestimator_validation_and_end_when(tmp_path):
    df = make_reg_df(64)
    tm, jm = mlp_pair(tmp_path, 2, 1)
    for cls, m, trig in ((NNEstimator, tm, MaxIteration),
                         (jnnf.NNEstimator, jm, JMaxIteration)):
        est = (cls(m, "mse").setFeaturesCol(["a", "b"]).setLabelCol("target")
               .setMaxEpoch(5).setEndWhen(trig(3))
               .setValidation(None, make_reg_df(32), ["mse"], 32))
        est.fit(df)
    # end_when bounds the run where JAX's bounds it
    assert tm.estimator.trainer_state.iteration == \
        jm.estimator.trainer_state.iteration < 5 * 2
    _same_params(jm, tm)


def test_nnestimator_setters_drive_the_same_training(tmp_path):
    """Both kinds of gradient clipping, a checkpoint directory, a train
    summary and the data cache level, set through the Spark-ML setters:
    the run is JAX's, the summary carries the loss and the checkpoint
    directory fills."""
    df = make_reg_df(64)
    tm, jm = mlp_pair(tmp_path, 2, 1)
    for cls, m, tag in ((NNEstimator, tm, "t"), (jnnf.NNEstimator, jm, "j")):
        est = (cls(m, "mse").setFeaturesCol(["a", "b"]).setLabelCol("target")
               .setBatchSize(16).setMaxEpoch(2).setLearningRate(0.05)
               .setGradientClippingByL2Norm(0.5)
               .setConstantGradientClipping(-0.2, 0.2)
               .setCheckpoint(str(tmp_path / f"ckpt_{tag}"))
               .setTrainSummary(str(tmp_path / f"tb_{tag}"), "app")
               .setDataCacheLevel("DISK_AND_DRAM", 2))
        assert est.cache_level == ("DISK_AND_DRAM", 2)
        assert est.clip_norm == 0.5 and est.clip_range == (-0.2, 0.2)
        est.fit(df)
    _same_params(jm, tm)
    # the later clipping setter wins in both packages
    for name in ("gradient_clip_norm", "gradient_clip_value"):
        assert getattr(tm.estimator.config, name) == \
            getattr(jm.estimator.config, name)
    assert tm.estimator.config.gradient_clip_value == (-0.2, 0.2)
    assert tm.get_train_summary("Loss")
    assert any((tmp_path / "ckpt_t").iterdir())
    est = NNEstimator(tm).setGradientClippingByL2Norm(1.0).clearGradientClipping()
    assert est.clip_norm is None and est.clip_range is None


def test_nnestimator_ragged_rows_rejected():
    df = pd.DataFrame({"features": [np.zeros(3), np.zeros(4)],
                       "label": [0.0, 1.0]})
    tm = Sequential([TL.Dense(1, input_shape=(3,))], device="cpu")
    est = NNEstimator(tm).setFeaturesCol("features").setLabelCol("label")
    with pytest.raises(ValueError, match="disagree in shape"):
        est.fit(df)


def test_nn_image_reader_matches_jax(tmp_path):
    from PIL import Image

    for sub, color in (("cat", (255, 0, 0)), ("dog", (0, 255, 0))):
        d = tmp_path / sub
        d.mkdir()
        for i in range(2):
            Image.new("RGB", (8 + i, 6), color).save(str(d / f"{i}.png"))
    df = NNImageReader.readImages(str(tmp_path), resizeH=6, resizeW=8,
                                  with_label_from_dirs=True)
    jdf = jnnf.NNImageReader.readImages(str(tmp_path), resizeH=6, resizeW=8,
                                        with_label_from_dirs=True)
    assert len(df) == 4
    assert df["image"].iloc[0].shape == (6, 8, 3)
    assert set(df["label"]) == {0, 1}
    assert list(df.columns) == list(jdf.columns)
    for col in ("origin", "height", "width", "label"):
        assert df[col].tolist() == jdf[col].tolist()
    for a, b in zip(df["image"], jdf["image"]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        NNImageReader.readImages(str(tmp_path / "nothing"))


def test_xgb_classifier_dataframe_passthrough(tmp_path):
    from analytics_zoo_tpu_torch.nnframes import (XGBClassifier,
                                                  XGBClassifierModel)

    pytest.importorskip("sklearn")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(400, 4)).astype("float32")
    y = (x[:, 0] + 2 * x[:, 1] > 0).astype("int64")
    df = pd.DataFrame({f"f{i}": x[:, i] for i in range(4)})
    df["label"] = y
    cols = [f"f{i}" for i in range(4)]
    model = (XGBClassifier().setNumRound(40).setMaxDepth(3)
             .setLearningRate(0.3).fit(df, feature_cols=cols,
                                       label_col="label"))
    jmodel = (jnnf.XGBClassifier().setNumRound(40).setMaxDepth(3)
              .setLearningRate(0.3).fit(df, feature_cols=cols,
                                        label_col="label"))
    assert model.backend == jmodel.backend
    out = model.transform(df)
    np.testing.assert_array_equal(out["prediction"].to_numpy(),
                                  jmodel.transform(df)["prediction"]
                                  .to_numpy())
    assert (out["prediction"].to_numpy() == y).mean() > 0.9
    proba = model.predict_proba(df)
    assert proba.shape == (400, 2)
    np.testing.assert_array_equal(proba, jmodel.predict_proba(df))
    p = str(tmp_path / "xgb.pkl")
    model.save(p)
    loaded = XGBClassifierModel.loadModel(p, numClasses=2)
    out2 = loaded.setPredictionCol("pred2").transform(df)
    np.testing.assert_array_equal(out2["pred2"].to_numpy(),
                                  out["prediction"].to_numpy())
    with pytest.raises(ValueError, match="classes"):
        XGBClassifierModel.loadModel(p, numClasses=7)


def test_xgb_regressor_dataframe_passthrough():
    from analytics_zoo_tpu_torch.nnframes import XGBRegressor

    pytest.importorskip("sklearn")
    rng = np.random.default_rng(1)
    x = rng.normal(size=(400, 3)).astype("float32")
    y = x @ np.array([1.0, -2.0, 0.5], dtype="float32")
    df = pd.DataFrame({f"f{i}": x[:, i] for i in range(3)})
    df["target"] = y
    cols = ["f0", "f1", "f2"]
    out = XGBRegressor({"n_estimators": 60}).fit(
        df, feature_cols=cols, label_col="target").transform(df)
    jout = jnnf.XGBRegressor({"n_estimators": 60}).fit(
        df, feature_cols=cols, label_col="target").transform(df)
    np.testing.assert_array_equal(out["prediction"].to_numpy(),
                                  jout["prediction"].to_numpy())
    assert float(np.abs(out["prediction"].to_numpy() - y).mean()) < 0.3


def test_xgb_load_rejects_wrong_model_type(tmp_path):
    from analytics_zoo_tpu_torch.nnframes import (XGBClassifierModel,
                                                  XGBRegressor)

    pytest.importorskip("sklearn")
    rng = np.random.default_rng(2)
    df = pd.DataFrame({"f0": rng.normal(size=100).astype("float32")})
    df["target"] = df["f0"] * 2
    model = XGBRegressor({"n_estimators": 5}).fit(df, feature_cols=["f0"],
                                                  label_col="target")
    p = str(tmp_path / "reg.pkl")
    model.save(p)
    with pytest.raises(ValueError, match="XGBRegressorModel"):
        XGBClassifierModel.loadModel(p, numClasses=2)
    # a bundle the JAX package pickled loads in the port
    jp = str(tmp_path / "jreg.pkl")
    jnnf.XGBRegressor({"n_estimators": 5}).fit(
        df, feature_cols=["f0"], label_col="target").save(jp)
    from analytics_zoo_tpu_torch.nnframes import XGBRegressorModel

    np.testing.assert_array_equal(
        XGBRegressorModel.loadModel(jp).transform(df)["prediction"],
        model.transform(df)["prediction"])
