"""TensorBoard summaries and validation during ``fit`` in the PyTorch port
against the JAX package's, on the CPU.

``common/summary.py`` writes the same TF event bytes as the JAX package's
for the same ``(step, wall_time, scalars)``, and each package reads the
other's files. ``compile``/``set_tensorboard``/``fit(validation_data=...)``
on a Dense classifier, from the JAX model's own weights, records the same
per-epoch validation results and the same train-summary losses as the JAX
package within 1e-5.
"""

import os

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from analytics_zoo_tpu.common import config as jconfig
from analytics_zoo_tpu.common import summary as jsum
from analytics_zoo_tpu.nn import layers as JL
from analytics_zoo_tpu.nn.topology import Sequential as JSequential
from analytics_zoo_tpu_torch.bridge import state_dict_from_jax
from analytics_zoo_tpu_torch.common import config as tconfig
from analytics_zoo_tpu_torch.common import summary as tsum
from analytics_zoo_tpu_torch.nn import layers as TL
from analytics_zoo_tpu_torch.nn.topology import Sequential

AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")
EVENTS = [(0, 1700000000.25, {"Loss": 2.5, "Throughput": 1234.5}),
          (7, 1700000001.5, {"Top1Accuracy": 0.875}),
          (300, 1700000002.0, {"Loss": -0.0, "GradNorm": 3e-9,
                               "ComputeMs": 12.125, "DataWaitMs": 0.0})]


def test_crc32c_matches_jax():
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 64, 1000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert tsum.crc32c(data) == jsum.crc32c(data)
    assert tsum.crc32c(b"123456789") == 0xE3069283     # the CRC-32C check


def test_event_files_are_byte_identical(tmp_path, monkeypatch):
    monkeypatch.setattr(jsum.time, "time", lambda: 1700000000.0)
    writers = {"jax": jsum.EventWriter(str(tmp_path / "j")),
               "port": tsum.EventWriter(str(tmp_path / "t"))}
    for w in writers.values():
        for step, wall, scalars in EVENTS:
            w.add_scalars(step, scalars, wall_time=wall)
        w.close()
    j, t = (open(w.path, "rb").read() for w in writers.values())
    assert j == t and len(j) > 100
    assert os.path.basename(writers["jax"].path) == os.path.basename(
        writers["port"].path)
    # each package reads the other's file
    want = [(s, tag, np.float32(v)) for s, _, sc in EVENTS
            for tag, v in sc.items()]
    for path in (writers["jax"].path, writers["port"].path):
        for m in (jsum, tsum):
            got = m.read_scalars(path)
            assert [(s, tag) for s, tag, _ in got] == \
                [(s, tag) for s, tag, _ in want]
            assert all(np.float32(v) == w for (_, _, v), (_, _, w)
                       in zip(got, want))


def test_summaries_write_events_and_jsonl(tmp_path):
    train = tsum.TrainSummary(str(tmp_path), "app")
    train.add_scalars(3, {"Loss": 0.5})
    train.add_scalars(6, {"Loss": 0.25, "Throughput": 10.0})
    assert train.read_scalar("Loss") == [(3, 0.5), (6, 0.25)]
    assert train.log_dir == str(tmp_path / "app" / "train")
    lines = open(tmp_path / "app" / "train" / "metrics.jsonl").readlines()
    assert len(lines) == 2 and '"Throughput": 10.0' in lines[1]
    train.close()
    val = tsum.ValidationSummary(str(tmp_path), "app")
    assert val.log_dir.endswith(os.path.join("app", "validation"))


@pytest.mark.parametrize("cached", [False, True], ids=["stream", "cached"])
def test_validation_and_summaries_during_fit_match_jax(tmp_path, cached):
    """3 epochs of 4 steps, a log point every 2 steps, validation after
    each epoch on held-out data: the validation summary's every metric
    and the train summary's losses within 1e-5 of the JAX package's."""
    jm = JSequential([JL.Dense(8, activation="relu", input_shape=(4,)),
                      JL.Dense(6, activation="softmax")])
    params, _ = jm.build(jax.random.PRNGKey(2), (4,))
    tree = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((160, 4)).astype(np.float32)
    y = np.argmax(x, 1).astype(np.int32)
    (xt, yt), (xv, yv) = (x[:128], y[:128]), (x[128:], y[128:])
    metrics = ["accuracy", "top5"]

    def cfg(m):
        return m.TrainConfig(log_every_n_steps=2, cache_on_device=cached,
                             scan_block_steps=2)

    jm.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
               metrics=metrics, config=cfg(jconfig),
               mesh=Mesh(np.array(jax.devices()[:1]).reshape((1,) * 6),
                         AXES))
    jm.set_initial_weights(params)
    jm.set_tensorboard(str(tmp_path / "j"), "app")
    jm.fit(xt, yt, batch_size=32, nb_epoch=3, validation_data=(xv, yv))

    tm = Sequential([TL.Dense(8, activation="relu", input_shape=(4,)),
                     TL.Dense(6, activation="softmax")], device="cpu")
    tm.load_state_dict(state_dict_from_jax(tree))
    tm.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
               metrics=metrics, config=cfg(tconfig))
    tm.set_tensorboard(str(tmp_path / "t"), "app")
    tm.fit(xt, yt, batch_size=32, nb_epoch=3, validation_data=(xv, yv))

    tags = {t for _, t, _ in jsum.read_scalars(
        jm.estimator.val_summary.writer.path)}
    assert len(tags) == 2
    for tag in tags:
        want, got = (m.get_validation_summary(tag) for m in (jm, tm))
        assert [s for s, _ in got] == [s for s, _ in want] == [4, 8, 12]
        np.testing.assert_allclose([v for _, v in got],
                                   [v for _, v in want], atol=1e-5)
    want, got = (m.get_train_summary("Loss") for m in (jm, tm))
    assert [s for s, _ in got] == [s for s, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               atol=1e-5)
    train_tags = {t for _, t, _ in tsum.read_scalars(
        tm.estimator.train_summary.writer.path)}
    assert train_tags == {t for _, t, _ in jsum.read_scalars(
        jm.estimator.train_summary.writer.path)}
    assert tm.estimator.trainer_state.last_score == pytest.approx(
        jm.estimator.trainer_state.last_score, abs=1e-5)
