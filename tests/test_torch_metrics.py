"""The port's ``nn/metrics.py`` against the JAX package's, on the CPU.

Every metric streams the same numpy-seeded batches (labels and
predictions, several batch sizes, ties included where the metric breaks
them) through ``init``/``update``/``result`` in both packages: results
within 1e-6. ``ndcg_at_k`` and ``map_at_k`` likewise, over binary and
graded relevance and k up to the candidate count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.nn import metrics as jm
from analytics_zoo_tpu_torch.nn import metrics as tm


def _stream(jmetric, tmetric, batches):
    ja, ta = jmetric.init(), tmetric.init()
    for y, p in batches:
        ja = jmetric.update(ja, None if y is None else jnp.asarray(y),
                            jnp.asarray(p))
        ta = tmetric.update(ta, None if y is None else torch.from_numpy(y),
                            torch.from_numpy(p))
    return jmetric.result(ja), tmetric.result(ta)


def _classes(rng, n, c, ties=False):
    p = rng.random((n, c)).astype(np.float32)
    if ties:
        p = np.round(p * 4) / 4                 # many exact ties
    return rng.integers(0, c, n).astype(np.int32), p


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("name", ["accuracy", "sparse_categorical_accuracy",
                                  "top5", "acc"])
def test_sparse_label_metrics_match_jax(name, ties):
    rng = np.random.default_rng(1)
    batches = [_classes(rng, n, 8, ties) for n in (7, 32, 1)]
    want, got = _stream(jm.get_metric(name), tm.get_metric(name), batches)
    assert abs(got - want) <= 1e-6


@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_breaks_ties_as_lax_top_k(k):
    rng = np.random.default_rng(k)
    batches = [_classes(rng, 50, 6, ties=True) for _ in range(3)]
    want, got = _stream(jm.TopK(k), tm.TopK(k), batches)
    assert abs(got - want) <= 1e-6
    assert tm.TopK(k).name == jm.TopK(k).name


def test_categorical_accuracy_matches_jax():
    rng = np.random.default_rng(2)
    batches = []
    for n in (9, 20):
        y, p = _classes(rng, n, 5)
        batches.append((np.eye(5, dtype=np.float32)[y], p))
    want, got = _stream(jm.CategoricalAccuracy(), tm.CategoricalAccuracy(),
                        batches)
    assert abs(got - want) <= 1e-6


def test_binary_accuracy_matches_jax():
    rng = np.random.default_rng(3)
    batches = [(rng.integers(0, 2, (n, 1)).astype(np.float32),
                rng.random((n, 1)).astype(np.float32)) for n in (11, 40)]
    batches.append((np.array([[1.0]], np.float32),
                    np.array([[0.5]], np.float32)))      # the threshold
    want, got = _stream(jm.BinaryAccuracy(), tm.BinaryAccuracy(), batches)
    assert abs(got - want) <= 1e-6


@pytest.mark.parametrize("name", ["mae", "mse"])
def test_regression_metrics_match_jax(name):
    rng = np.random.default_rng(4)
    batches = [(rng.normal(size=(n, 3)).astype(np.float32),
                rng.normal(size=(n, 3)).astype(np.float32)) for n in (5, 17)]
    want, got = _stream(jm.get_metric(name), tm.get_metric(name), batches)
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


@pytest.mark.parametrize("loss", ["sparse_categorical_crossentropy",
                                  "binary_crossentropy", "mse"])
def test_loss_metric_matches_jax(loss):
    rng = np.random.default_rng(5)
    if loss == "sparse_categorical_crossentropy":
        batches = []
        for n in (6, 13):
            y, p = _classes(rng, n, 4)
            batches.append((y, p / p.sum(-1, keepdims=True)))
    else:
        batches = [(rng.integers(0, 2, (n, 1)).astype(np.float32),
                    rng.random((n, 1)).astype(np.float32)) for n in (6, 13)]
    want, got = _stream(jm.Loss(loss), tm.Loss(loss), batches)
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
    assert tm.Loss(loss).name == "loss"


@pytest.mark.parametrize("n_thresholds", [200, 37])
def test_auc_matches_jax(n_thresholds):
    rng = np.random.default_rng(6)
    batches = []
    for n in (30, 64):
        y = rng.integers(0, 2, n).astype(np.float32)
        p = np.clip(0.3 * y + 0.7 * rng.random(n), 0, 1).astype(np.float32)
        batches.append((y, p))
    want, got = _stream(jm.AUC(n_thresholds), tm.AUC(n_thresholds), batches)
    assert abs(got - want) <= 1e-6
    assert 0.5 < got <= 1.0


@pytest.mark.parametrize("k", [1, 3, 10])
@pytest.mark.parametrize("cls", ["HitRate", "NDCG"])
def test_grouped_ranking_metrics_match_jax(cls, k):
    rng = np.random.default_rng(k)
    batches = []
    for g in (8, 25):
        s = rng.random((g, 12)).astype(np.float32)
        s[::3, 3] = s[::3, 0]                   # ties with the positive
        batches.append((None, s))
    want, got = _stream(getattr(jm, cls)(k), getattr(tm, cls)(k), batches)
    assert abs(got - want) <= 1e-6
    assert getattr(tm, cls)(k).name == getattr(jm, cls)(k).name


@pytest.mark.parametrize("graded", [False, True])
@pytest.mark.parametrize("k", [1, 4, 9])
def test_ndcg_and_map_at_k_match_jax(graded, k):
    rng = np.random.default_rng(10 + k)
    rel = (rng.integers(0, 4, (6, 9)) if graded
           else rng.integers(0, 2, (6, 9))).astype(np.float32)
    rel[0] = 0.0                                # a row with nothing relevant
    score = rng.random((6, 9)).astype(np.float32)
    score[1, :4] = 0.5                          # ties in the ordering
    for fn in ("ndcg_at_k", "map_at_k"):
        want = getattr(jm, fn)(rel, score, k)
        got = getattr(tm, fn)(rel, score, k)
        assert abs(got - want) <= 1e-6, fn
        # one query as 1-D arrays, as the Ranker passes them
        assert abs(getattr(tm, fn)(rel[2], score[2], k)
                   - getattr(jm, fn)(rel[2], score[2], k)) <= 1e-6, fn


def test_metric_names_and_registry_match_jax():
    assert sorted(tm.METRICS) == sorted(jm.METRICS)
    for name in jm.METRICS:
        assert tm.get_metric(name).name == jm.get_metric(name).name, name
    m = tm.HitRate(5)
    assert tm.get_metric(m) is m
    with pytest.raises(ValueError, match="unknown metric"):
        tm.get_metric("nope")


def test_accumulators_live_on_the_given_device():
    acc = tm.AUC().init(device="cpu")
    assert all(v.device.type == "cpu" and v.dtype == torch.float32
               for v in acc.values())
    acc = tm.get_metric("accuracy").init()
    assert set(acc) == {"total", "count"}
    assert tm.get_metric("accuracy").result(acc) == 0.0
