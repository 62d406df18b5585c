"""The training telemetry of the PyTorch port against the JAX package, on
the CPU, and ``TrainConfig(donate_state=False)``.

One small f32 training run (a Sequential with a Dropout, Adam, 2 epochs of
6 steps, a log point every 2 steps, an async checkpoint every 4
iterations beside the durable one at each epoch end, TensorBoard
summaries, prefetch depth 2) goes through both Estimators from the same
JAX weights. Every family the JAX training path registers (the
Estimator's, the checkpoint writer's, the summaries', the loader's and
the FeatureSet's) exists in the port's registry with the same name, kind,
help, label names and buckets; over the run, each counter moves by the
same value, each histogram by the same number of observations (the
FeatureSet's batch count and gather time one fewer: the JAX fit draws one
batch to trace its step before it trains), the
summary gauge carries the same label sets (``Loss`` and ``GradNorm``
within 1e-5), and the queue-depth collector reads 0 after both. The
producer-stall histogram depends on timing, so only its family is held.
The compile pair counts first dispatches of a batch signature in the
port (its module docstring), which equals JAX's compile count.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from analytics_zoo_tpu.common import config as jconfig
from analytics_zoo_tpu.common import telemetry as jtm
from analytics_zoo_tpu.data import featureset as jfs
from analytics_zoo_tpu.engine.estimator import Estimator as JEstimator
from analytics_zoo_tpu.nn import layers as JL
from analytics_zoo_tpu.nn import optimizers as jopt
from analytics_zoo_tpu.nn.topology import Sequential as JSequential
from analytics_zoo_tpu_torch.bridge import params_from_jax, params_to_numpy
from analytics_zoo_tpu_torch.common import telemetry as ttm
from analytics_zoo_tpu_torch.common.config import TrainConfig
from analytics_zoo_tpu_torch.data import featureset as tfs
from analytics_zoo_tpu_torch.engine import estimator as test_mod
from analytics_zoo_tpu_torch.engine.estimator import Estimator
from analytics_zoo_tpu_torch.nn import layers as TL
from analytics_zoo_tpu_torch.nn import optimizers as topt
from analytics_zoo_tpu_torch.nn.topology import Sequential

AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")
LOSS = "sparse_categorical_crossentropy"

#: every family the JAX training path registers (item 6 of the slice)
FAMILIES = (
    "zoo_train_steps_total", "zoo_train_data_wait_seconds",
    "zoo_train_compute_seconds", "zoo_train_compiles_total",
    "zoo_train_compile_seconds", "zoo_train_rollbacks_total",
    "zoo_train_checkpoints_total", "zoo_train_sigterm_exits_total",
    "zoo_train_grad_norm", "zoo_train_comm_seconds",
    "zoo_train_checkpoint_snapshot_seconds",
    "zoo_train_checkpoint_write_seconds", "zoo_summary_scalar",
    "zoo_summary_events_total", "zoo_data_prefetch_producer_stall_seconds",
    "zoo_data_prefetch_consumer_wait_seconds",
    "zoo_data_prefetch_queue_depth", "zoo_data_batches_total",
    "zoo_data_batch_gather_seconds", "zoo_data_decode_seconds")
TIMING_ONLY = ("zoo_data_prefetch_producer_stall_seconds",)
#: one batch more in JAX's count: its first fit draws a batch to trace its
#: step, the port's builds its state without one (``engine/estimator.py``)
FIRST_DRAW = ("zoo_data_batches_total", "zoo_data_batch_gather_seconds")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape((1,) * 6), AXES)


def _family(mod, name):
    reg = mod.default_registry()
    fam = reg._families.get(name)
    if fam is not None:
        return fam.kind, fam.help, fam.label_names, fam.buckets
    help_, kind, labels, _fn = reg._collectors[name]
    return kind, help_, tuple(labels), None


def _counts(mod):
    """``{family: {labels: value or observation count}}``."""
    out = {}
    for name, fam in mod.snapshot().items():
        if name in FAMILIES:
            out[name] = {k: (v["count"] if isinstance(v, dict) else v)
                         for k, v in fam["samples"].items()}
    return out


def _delta(before, after):
    return {name: {k: v - before.get(name, {}).get(k, 0.0)
                   for k, v in samples.items()}
            for name, samples in after.items()}


def _models():
    jm = JSequential([JL.Dense(12, activation="relu", input_shape=(6,)),
                      JL.Dropout(0.3), JL.Dense(3, activation="softmax")])
    params, state = jm.build(jax.random.PRNGKey(0))
    tm = Sequential([TL.Dense(12, activation="relu", input_shape=(6,)),
                     TL.Dropout(0.3), TL.Dense(3, activation="softmax")],
                    device="cpu")
    tm.load_state_dict(params_from_jax(_np(params)))
    return jm, params, state, tm


def test_every_training_family_has_the_jax_name_kind_and_labels():
    for name in FAMILIES:
        assert _family(ttm, name) == _family(jtm, name), name


def test_training_run_moves_the_jax_counts(tmp_path):
    jm, params, state, tm = _models()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(96, 6)).astype(np.float32)
    y = rng.integers(0, 3, 96).astype(np.int32)
    kw = dict(log_every_n_steps=2, checkpoint_every_n_iters=4,
              prefetch_depth=2)
    jest = JEstimator(jm, optimizer=jopt.Adam(lr=0.01), loss=LOSS,
                      mesh=_mesh(), config=jconfig.TrainConfig(
                          checkpoint_dir=str(tmp_path / "jax"), **kw))
    jest.initial_weights = (params, state)
    jest.set_tensorboard(str(tmp_path / "jtb"), "app")
    est = Estimator(tm, optimizer=topt.Adam(lr=0.01), loss=LOSS,
                    config=TrainConfig(checkpoint_dir=str(tmp_path / "pt"),
                                       **kw))
    est.set_tensorboard(str(tmp_path / "ttb"), "app")
    j0 = _counts(jtm)
    jest.fit((x, y), batch_size=16, epochs=2, seed=2)
    j1 = _counts(jtm)
    t0 = _counts(ttm)
    est.fit((x, y), batch_size=16, epochs=2, seed=2)
    t1 = _counts(ttm)
    jd, td = _delta(j0, j1), _delta(t0, t1)
    for name in FAMILIES:
        if name in TIMING_ONLY or name == "zoo_summary_scalar":
            continue
        want = jd.get(name, {})
        if name in FIRST_DRAW:
            # the JAX fit's extra batch, drawn to trace its step
            want = {k: v - 1 for k, v in want.items()}
        assert td.get(name, {}) == want, name
    # the run's own numbers, so the equality above is not 0 == 0
    assert td["zoo_train_steps_total"][""] == 12
    assert td["zoo_train_checkpoints_total"][""] == 5
    assert td["zoo_train_checkpoint_write_seconds"][""] == 5
    assert td["zoo_train_grad_norm"][""] == 6
    assert td["zoo_train_compiles_total"][""] == 1
    assert td["zoo_summary_events_total"][""] == 6 * 5 + 2 * 4
    assert td["zoo_data_batches_total"][""] == 12
    assert jd["zoo_data_batches_total"][""] == 13
    assert td["zoo_data_prefetch_consumer_wait_seconds"][""] == 14
    assert t1["zoo_data_prefetch_queue_depth"] == {"": 0.0}
    # the summary gauge: the same label sets; Loss and GradNorm values
    jg = jtm.snapshot()["zoo_summary_scalar"]["samples"]
    tg = ttm.snapshot()["zoo_summary_scalar"]["samples"]
    mine = {k for k in tg if k.startswith("app,train,")}
    assert mine == {k for k in jg if k.startswith("app,train,")}
    for tag in ("Loss", "GradNorm"):
        np.testing.assert_allclose(tg[f"app,train,{tag}"],
                                   jg[f"app,train,{tag}"], rtol=0,
                                   atol=1e-5)


def test_byte_tier_decode_counts_match_jax():
    recs = [np.full(3, i, np.float32).tobytes() for i in range(10)]

    def dec(b):
        return np.frombuffer(b, np.float32).copy()

    counts = []
    for mod, fs_mod in ((jtm, jfs), (ttm, tfs)):
        before = _counts(mod)
        fs = fs_mod.FeatureSet.from_bytes(recs, dec, decode_workers=0)
        got = [b[0] for b in fs.batches(4, shuffle=False,
                                        drop_remainder=False)]
        counts.append(_delta(before, _counts(mod)))
        assert np.array_equal(np.concatenate(got), np.stack(
            [dec(r) for r in recs]))
    jd, td = counts
    for name in ("zoo_data_batches_total", "zoo_data_batch_gather_seconds",
                 "zoo_data_decode_seconds"):
        assert td[name] == jd[name] == {"": 3.0}, name


def test_the_compile_pair_counts_first_dispatches():
    """A second fit with a new batch size dispatches a new signature: one
    more first dispatch, as JAX compiles once more."""
    _jm, _p, _s, tm = _models()
    x = np.random.default_rng(0).normal(size=(64, 6)).astype(np.float32)
    y = np.zeros(64, np.int32)
    est = Estimator(tm, optimizer="sgd", loss=LOSS,
                    config=TrainConfig(prefetch_depth=0))
    before = _counts(ttm)
    est.fit((x, y), batch_size=16, epochs=1)
    est.fit((x, y), batch_size=16, epochs=2)
    est.fit((x, y), batch_size=32, epochs=3)
    d = _delta(before, _counts(ttm))
    assert d["zoo_train_compiles_total"][""] == 2
    assert d["zoo_train_compile_seconds"][""] == 2
    assert d["zoo_train_steps_total"][""] == 4 + 4 + 2
    assert "first step of each new batch signature" in " ".join(
        test_mod.__doc__.split())


@pytest.mark.parametrize("accum", [1, 2])
def test_donate_state_false_keeps_the_pre_step_tensors(accum):
    """``donate_state=False``: a step leaves the tensors the parameters
    held before it untouched, and ends on the same bits as the in-place
    (``True``) run."""
    runs = {}
    x = np.random.default_rng(1).normal(size=(32, 6)).astype(np.float32)
    y = np.random.default_rng(2).integers(0, 3, 32).astype(np.int32)
    for donate in (True, False):
        _jm, _p, _s, tm = _models()
        est = Estimator(tm, optimizer=topt.Adam(lr=0.05), loss=LOSS,
                        config=TrainConfig(donate_state=donate,
                                           grad_accum_steps=accum))
        pre = {n: p.data for n, p in tm.named_parameters()}
        snap = {n: t.clone() for n, t in pre.items()}
        est.fit((x, y), batch_size=16, epochs=1, seed=4)
        kept = all(torch.equal(pre[n], snap[n]) for n in pre)
        assert kept is (not donate)
        runs[donate] = params_to_numpy(tm)
    for slot, d in runs[True].items():
        for leaf, v in d.items():
            assert np.array_equal(runs[False][slot][leaf], v), (slot, leaf)
