"""Checkpoints in the PyTorch port against the JAX package's, on the CPU.

The port reads and writes ``engine/checkpoint.py``'s format, so each
package resumes the other's checkpoints. The same numpy-seeded data and
the JAX model's own ``build`` weights go through both ``Estimator.fit``s
(a Dense regression MLP for every optimizer, f32 and bf16 with f32
masters; the LM of ``tests/test_torch_training.py`` for the main path's
tree). Held: the manifests' ``signature`` and ``leaf_paths`` are equal; a
checkpoint the JAX Estimator wrote resumes in the port to JAX's own
per-step losses, and one the port wrote resumes in JAX to the port's,
within 1e-5 in f32 and 2e-2 in bf16 (the packages' bf16 forwards round
apart); a JAX checkpoint loaded into the port and saved again gives JAX's
leaves bit for bit. Then the format's failure cases: torn, truncated and
bit-flipped snapshots raise ``CheckpointCorruptError`` in both packages,
staging and set-aside directories never win ``latest_checkpoint``, ``keep``
collects, a writer killed at ``chaos_point("ckpt.write")`` leaves only
durable snapshots, leaves that do not map raise naming the path, and an
async snapshot never aliases the live state. Last, the model bundles:
``InferenceModel.load_zoo`` and ``ImageClassifier.save_model``/
``load_model``.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from analytics_zoo_tpu.common import config as jconfig
from analytics_zoo_tpu.engine import checkpoint as jck
from analytics_zoo_tpu.engine.estimator import Estimator as JEstimator
from analytics_zoo_tpu.models.transformer import TransformerLM as JaxLM
from analytics_zoo_tpu.models.transformer import lm_loss as jlm_loss
from analytics_zoo_tpu.nn import layers as JL
from analytics_zoo_tpu.nn import optimizers as jopt
from analytics_zoo_tpu.nn.topology import Sequential as JSequential
from analytics_zoo_tpu_torch.bridge import params_from_jax, state_dict_from_jax
from analytics_zoo_tpu_torch.common.chaos import ChaosSchedule, WorkerKilled
from analytics_zoo_tpu_torch.common import config as tconfig
from analytics_zoo_tpu_torch.common.config import TrainConfig
from analytics_zoo_tpu_torch.engine import checkpoint as tck
from analytics_zoo_tpu_torch.engine.estimator import Estimator
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models.image.classification import \
    ImageClassifier
from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
from analytics_zoo_tpu_torch.models.transformer import TransformerLM, lm_loss
from analytics_zoo_tpu_torch.nn import layers as TL
from analytics_zoo_tpu_torch.nn import optimizers as topt
from analytics_zoo_tpu_torch.nn.topology import Sequential

AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")
N, BATCH, EPOCHS = 48, 16, 2          # 3 steps an epoch
TOL = {None: 1e-5, "bfloat16": 2e-2}

OPTS = {
    "sgd": lambda m: m.SGD(lr=0.05, momentum=0.9, weight_decay=1e-3),
    "adam": lambda m: m.Adam(lr=m.poly(1e-2, 2.0, 10)),
    "adamw": lambda m: m.AdamWeightDecay(lr=1e-2),
    "rmsprop": lambda m: m.RMSprop(lr=1e-2),
    "adagrad": lambda m: m.Adagrad(lr=0.05),
    "adadelta": lambda m: m.Adadelta(),
    "adamax": lambda m: m.Adamax(lr=1e-2),
    "lars": lambda m: m.LARS(lr=0.05),
}


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape((1,) * 6), AXES)


@pytest.fixture(scope="module")
def mlp():
    jm = JSequential([JL.Dense(8, activation="relu", input_shape=(4,)),
                      JL.Dense(1)])
    params, _ = jm.build(jax.random.PRNGKey(1), (4,))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, 4)).astype(np.float32)
    y = x.sum(axis=1, keepdims=True).astype(np.float32)
    return jm, params, jax.tree_util.tree_map(np.asarray, params), (x, y)


def _cfg(m, directory, cd):
    return m.TrainConfig(checkpoint_dir=str(directory), compute_dtype=cd,
                         checkpoint_every_n_iters=2, gradient_clip_norm=1.0,
                         log_every_n_steps=1)


def _jax_estimator(jm, params, make_opt, directory, cd):
    est = JEstimator(jm, optimizer=make_opt(jopt), loss="mse", mesh=_mesh(),
                     config=_cfg(jconfig, directory, cd))
    est.initial_weights = (params, {})
    step, record = est._make_train_step(), []

    def recording_step(state, batch):
        state, (loss, gnorm) = step(state, batch)
        record.append(float(loss))
        return state, (loss, gnorm)

    est._train_step = recording_step
    return est, record


def _jax_resume(est, record, directory, data):
    """Resume the same JAX Estimator (its compiled step kept) from the
    checkpoints in ``directory``: its fit's own resume path."""
    del record[:]
    est.train_state = None
    est.trainer_state = type(est.trainer_state)()
    est.config.checkpoint_dir = str(directory)
    est.fit(data, batch_size=BATCH, epochs=EPOCHS)
    return list(record)


def _port_model(tree, seed=0):
    tm = Sequential([TL.Dense(8, activation="relu", input_shape=(4,)),
                     TL.Dense(1)], device="cpu", seed=seed)
    tm.load_state_dict(state_dict_from_jax(tree))
    return tm


def _port_estimator(tree, make_opt, directory, cd, seed=0):
    return Estimator(_port_model(tree, seed), optimizer=make_opt(topt),
                     loss="mse", config=_cfg(tconfig, directory, cd))


def _only(src, name, dst):
    """A fresh checkpoint directory holding ``src/name`` alone."""
    os.makedirs(dst)
    shutil.copytree(os.path.join(src, name), os.path.join(dst, name))
    return str(dst)


def _close(want, got, tol):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert abs(w - g) <= tol * max(1.0, abs(w)), (want, got)


@pytest.mark.parametrize("cd", [None, "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_checkpoints_cross_between_the_packages(mlp, tmp_path, name, cd):
    jm, params, tree, data = mlp
    make = OPTS[name]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jest, jrec = _jax_estimator(jm, params, make, jdir, cd)
    jest.fit(data, batch_size=BATCH, epochs=EPOCHS)
    jax_losses = list(jrec)
    test = _port_estimator(tree, make, tdir, cd)
    test.fit(data, batch_size=BATCH, epochs=EPOCHS)
    port_losses = [h["loss"] for h in test.history]
    _close(jax_losses, port_losses, TOL[cd])
    # the same tree: equal leaf paths and (shape, dtype) signature
    for it in (3, 4, 6):
        jm_, tm_ = (tck.read_manifest(os.path.join(d, f"checkpoint_{it}"))
                    for d in (jdir, tdir))
        assert jm_["leaf_paths"] == tm_["leaf_paths"]
        assert jm_["signature"] == tm_["signature"]
        assert (jm_["iteration"], jm_["epoch"]) == (tm_["iteration"],
                                                    tm_["epoch"])
    # JAX's epoch-end checkpoint resumes in the port to JAX's own resumed
    # losses (which are its uninterrupted run's)
    want = _jax_resume(jest, jrec, _only(jdir, "checkpoint_3",
                                         tmp_path / "j3j"), data)
    assert want == jax_losses[3:]
    resume = _port_estimator(tree, make, _only(jdir, "checkpoint_3",
                                               tmp_path / "j3"), cd, seed=9)
    resume.fit(data, batch_size=BATCH, epochs=EPOCHS)
    assert resume.trainer_state.iteration == 6
    _close(want, [h["loss"] for h in resume.history], TOL[cd])
    # the port's resumes in JAX to the port's
    got = _jax_resume(jest, jrec, _only(tdir, "checkpoint_3",
                                        tmp_path / "t3"), data)
    _close(port_losses[3:], got, TOL[cd])
    # a mid-epoch (async trigger) checkpoint replays its epoch in both
    want = _jax_resume(jest, jrec, _only(jdir, "checkpoint_4",
                                         tmp_path / "j4"), data)
    resume = _port_estimator(tree, make, _only(jdir, "checkpoint_4",
                                               tmp_path / "j4p"), cd)
    resume.fit(data, batch_size=BATCH, epochs=EPOCHS)
    assert len(want) == 3 and resume.trainer_state.iteration == 7
    _close(want, [h["loss"] for h in resume.history], TOL[cd])
    # loaded into the port and saved again: JAX's leaves, bit for bit
    again = _port_estimator(tree, make, tmp_path / "none", cd, seed=5)
    again._init_state()
    again._restore(os.path.join(jdir, "checkpoint_3"))
    out = tck.save_checkpoint(str(tmp_path / "again"),
                              again.checkpoint_state(), iteration=3, epoch=1)
    with np.load(os.path.join(jdir, "checkpoint_3", "state.npz")) as a, \
            np.load(os.path.join(out, "state.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
            assert a[k].tobytes() == b[k].tobytes(), k
    assert tck.read_manifest(out)["signature"] == tck.read_manifest(
        os.path.join(jdir, "checkpoint_3"))["signature"]
    if cd == "bfloat16":
        # bf16 params stored as 2-byte voids; JAX views them back
        restored, _ = jck.load_checkpoint(out, jest.train_state)
        leaf = jax.tree_util.tree_leaves(restored["params"])[0]
        assert np.asarray(leaf).dtype.name == "bfloat16"


def test_the_lm_train_state_maps_onto_jax(tmp_path):
    """The LM under bf16 with masters, remat "flash", accumulation 2: the
    port's checkpoint has JAX's leaf paths and signature, and each
    resumes the other's to per-step losses within bf16 tolerance."""
    kw = dict(vocab=64, hidden_size=32, n_block=2, n_head=2, seq_len=16,
              attn_strategy="flash", remat="flash")
    jm = JaxLM(**kw)
    params, _ = jm.build(jax.random.PRNGKey(3))
    tree = jax.tree_util.tree_map(np.asarray, params)
    ids = np.random.default_rng(0).integers(0, 64, size=(8, 17))
    data = (ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32))
    cfg = dict(compute_dtype="bfloat16", grad_accum_steps=2,
               gradient_clip_norm=1.0, log_every_n_steps=1, shuffle=False)
    jest = JEstimator(jm, optimizer="adam", loss=jlm_loss, mesh=_mesh(),
                      config=jconfig.TrainConfig(
                          checkpoint_dir=str(tmp_path / "j"), **cfg))
    jest.initial_weights = (params, {})
    jest.fit(data, batch_size=4, epochs=1)

    def port(directory, seed=0):
        tm = TransformerLM(**kw, device="cpu", seed=seed)
        tm.load_state_dict(params_from_jax(tree))
        return Estimator(tm, optimizer="adam", loss=lm_loss,
                         config=TrainConfig(checkpoint_dir=str(directory),
                                            **cfg))

    test = port(tmp_path / "t")
    test.fit(data, batch_size=4, epochs=2)
    jm_, tm_ = (tck.read_manifest(str(tmp_path / d / "checkpoint_2"))
                for d in ("j", "t"))
    assert jm_["leaf_paths"] == tm_["leaf_paths"]
    assert jm_["signature"] == tm_["signature"]
    assert "['opt_state'].inner_state[1][0].mu['block1']['attn']" \
           "['qkv_kernel']" in tm_["leaf_paths"]
    resume = port(tmp_path / "j", seed=4)
    resume.fit(data, batch_size=4, epochs=2)
    _close([h["loss"] for h in test.history][2:],
           [h["loss"] for h in resume.history], 2e-2)


# ------------------------------------------------------------- failure cases

def _tiny_state(value=1.0):
    return {"params": {"w": torch.full((3, 2), value),
                       "b": torch.zeros(2, dtype=torch.bfloat16)},
            "opt_state": (topt.ScaleByAdamState(np.asarray(2, np.int32), {
                "w": torch.ones(3, 2)}, {"w": torch.ones(3, 2)}), None),
            "step": np.asarray(2, np.int32),
            "rng": np.asarray([0, 7], np.uint32)}


def _corrupt(path, how):
    state = os.path.join(path, "state.npz")
    if how == "torn":
        os.remove(state)
    elif how == "truncated":
        with open(state, "r+b") as f:
            f.truncate(os.path.getsize(state) // 2)
    else:
        with open(state, "r+b") as f:
            f.seek(os.path.getsize(state) // 2)
            b = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([b[0] ^ 0x10]))


@pytest.mark.parametrize("how", ["torn", "truncated", "bitflip"])
def test_corrupt_checkpoints_raise_in_both_packages(tmp_path, how):
    path = tck.save_checkpoint(str(tmp_path), _tiny_state(), iteration=2,
                               epoch=0)
    assert tck.verify_checkpoint(path)["iteration"] == 2
    _corrupt(path, how)
    with pytest.raises(tck.CheckpointCorruptError):
        tck.load_checkpoint(path, _tiny_state())
    with pytest.raises(jck.CheckpointCorruptError):
        jck.verify_checkpoint(path)


def test_staging_and_set_aside_dirs_never_win_and_keep_collects(tmp_path):
    d = str(tmp_path)
    for it in (1, 2, 3, 4):
        tck.save_checkpoint(d, _tiny_state(it), iteration=it, epoch=0,
                            keep=2)
    assert sorted(os.listdir(d)) == ["checkpoint_3", "checkpoint_4"]
    os.makedirs(os.path.join(d, "checkpoint_9.tmp"))
    os.makedirs(os.path.join(d, "checkpoint_8.old"))
    assert tck.latest_checkpoint(d) == os.path.join(d, "checkpoint_4")
    assert jck.latest_checkpoint(d) == os.path.join(d, "checkpoint_4")
    # a re-save of an iteration replaces it through a set-aside .old that
    # the collection removes
    tck.save_checkpoint(d, _tiny_state(5.0), iteration=4, epoch=0, keep=2)
    assert not os.path.exists(os.path.join(d, "checkpoint_8.old"))
    restored, meta = tck.load_checkpoint(tck.latest_checkpoint(d),
                                         _tiny_state())
    assert meta["iteration"] == 4
    assert torch.equal(restored["params"]["w"], torch.full((3, 2), 5.0))
    assert restored["params"]["b"].dtype == torch.bfloat16
    assert tck.latest_checkpoint(str(tmp_path / "nothing")) is None


def test_a_writer_killed_before_publication_leaves_only_durable(tmp_path):
    d = str(tmp_path)
    writer = tck.CheckpointWriter()
    with ChaosSchedule().kill("ckpt.write", at=2):
        tck.save_checkpoint(d, _tiny_state(1.0), iteration=1, epoch=0,
                            writer=writer)
        writer.drain()
        tck.save_checkpoint(d, _tiny_state(2.0), iteration=2, epoch=0,
                            writer=writer)
        with pytest.raises(WorkerKilled):
            writer.drain()
    assert sorted(os.listdir(d)) == ["checkpoint_1"]
    assert tck.latest_checkpoint(d).endswith("checkpoint_1")
    tck.verify_checkpoint(tck.latest_checkpoint(d))


def test_leaves_map_by_path_and_mismatches_name_the_leaf(tmp_path):
    path = tck.save_checkpoint(str(tmp_path), _tiny_state(), iteration=1,
                               epoch=0)
    wrong = _tiny_state()
    wrong["params"]["w"] = torch.zeros(2, 3)
    with pytest.raises(ValueError, match=r"\['params'\]\['w'\]"):
        tck.load_checkpoint(path, wrong)
    other = _tiny_state()
    other["params"]["v"] = other["params"].pop("w")
    with pytest.raises(ValueError, match="do not map"):
        tck.load_checkpoint(path, other)
    cast = _tiny_state()
    cast["params"]["b"] = torch.zeros(2)
    with pytest.raises(ValueError, match="bfloat16"):
        tck.load_checkpoint(path, cast)


def test_an_async_snapshot_never_aliases_the_live_state(tmp_path,
                                                        monkeypatch):
    """The write is held until the live state has moved on in place, as
    the next step moves it. The saved leaves are the state at the save;
    the same check catches a snapshot that hands the writer views of the
    live buffers (planted by replacing the host copy with ``.numpy()``)."""
    import threading

    release = threading.Event()
    write = tck._write_snapshot

    def held(*a, **kw):
        release.wait(10)
        return write(*a, **kw)

    monkeypatch.setattr(tck, "_write_snapshot", held)

    def saved_after_a_step(tag):
        live = _tiny_state(1.0)
        writer = tck.CheckpointWriter()
        tck.save_checkpoint(str(tmp_path / tag), live, iteration=1, epoch=0,
                            writer=writer)
        live["params"]["w"].add_(1.0)            # the next step, in place
        release.set()
        writer.drain()
        release.clear()
        path = str(tmp_path / tag / "checkpoint_1")
        i = tck.read_manifest(path)["leaf_paths"].index("['params']['w']")
        with np.load(os.path.join(path, "state.npz")) as z:
            return z[f"leaf_{i}"]

    assert np.array_equal(saved_after_a_step("copy"), np.full((3, 2), 1.0))
    copy = tck._host_copy
    monkeypatch.setattr(tck, "_host_copy",
                        lambda leaf: (leaf.detach().numpy(), False)
                        if isinstance(leaf, torch.Tensor)
                        and leaf.dtype == torch.float32 else copy(leaf))
    assert np.array_equal(saved_after_a_step("alias"), np.full((3, 2), 2.0))


# ------------------------------------------------------------- model bundles

def test_load_zoo_serves_a_bundle(tmp_path):
    model = NeuralCF(user_count=10, item_count=12, class_num=3,
                     user_embed=4, item_embed=4, hidden_layers=(8,),
                     mf_embed=4, device="cpu", seed=3)
    model.save_model(str(tmp_path / "ncf"))
    x = np.stack([np.arange(1, 7), np.arange(2, 8)], 1).astype(np.int32)
    with torch.no_grad():
        want = model.apply(torch.from_numpy(x)).numpy()
    im = InferenceModel(device="cpu").load_zoo(str(tmp_path / "ncf"))
    np.testing.assert_array_equal(im.predict(x), want)
    im2 = InferenceModel(device="cpu").load_zoo(
        str(tmp_path / "ncf"), model_class=lambda device: NeuralCF(
            user_count=10, item_count=12, class_num=3, user_embed=4,
            item_embed=4, hidden_layers=(8,), mf_embed=4, device=device))
    np.testing.assert_array_equal(im2.predict(x), want)


def test_image_classifier_bundle_round_trips(tmp_path):
    clf = ImageClassifier("resnet-18", (32, 32, 3), 4, label_map=list("abcd"),
                          device="cpu", seed=2)
    clf.save_model(str(tmp_path / "clf"))
    with open(tmp_path / "clf" / "config.json") as f:
        cfg = json.load(f)["config"]
    assert cfg == {"model_name": "resnet-18", "input_shape": [32, 32, 3],
                   "num_classes": 4, "label_map": list("abcd")}
    back = ImageClassifier.load_model(str(tmp_path / "clf"), device="cpu")
    assert back.label_map == list("abcd") and back.num_classes == 4
    x = np.random.default_rng(3).normal(size=(2, 32, 32, 3))
    np.testing.assert_array_equal(back.predict(x), clf.predict(x))
    other = ImageClassifier("resnet-18", (32, 32, 3), 4, device="cpu",
                            seed=7)
    assert not np.array_equal(other.predict(x), clf.predict(x))
