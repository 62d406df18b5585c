"""TextClassifier of the PyTorch port against the JAX package, on the CPU,
for the ``cnn``, ``lstm`` and ``gru`` encoders, with the new layers it
needs (``Convolution1D``, ``GlobalMaxPooling1D``).

Held: ``Convolution1D`` (valid and same, strides 1 and 2) and
``GlobalMaxPooling1D`` within 1e-5 of JAX's with its weights; the
classifier's slot names, constructor config and probabilities within
1e-4 with the JAX model's weights; 3 f32 Adam steps through ``fit`` on a
``TextSet`` (the Dropout's masks JAX's) with per-step losses and final
parameters within 1e-5 of the JAX Estimator's; the weight bundle read both
ways (a JAX bundle loads in the port, a port bundle in JAX and through
``InferenceModel.load_zoo``, the same predictions); and the GloVe path on
a file built here (the frozen table, its bundle, and ``word_index``
required with a file).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from analytics_zoo_tpu.data import text as jtext
from analytics_zoo_tpu.engine.estimator import Estimator as JEstimator
from analytics_zoo_tpu.models.textclassification import \
    TextClassifier as JTextClassifier
from analytics_zoo_tpu.nn import layers as JL
from analytics_zoo_tpu.nn import optimizers as jopt
from analytics_zoo_tpu_torch.bridge import (params_to_numpy,
                                            state_dict_from_jax)
from analytics_zoo_tpu_torch.data import text as ttext
from analytics_zoo_tpu_torch.engine.estimator import Estimator
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models.common import MODEL_REGISTRY
from analytics_zoo_tpu_torch.models.textclassification import TextClassifier
from analytics_zoo_tpu_torch.nn import layers as TL
from analytics_zoo_tpu_torch.nn import optimizers as topt

AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")
SEQ, EMBED, ENC, CLASSES = 12, 8, 10, 4
LOSS = "sparse_categorical_crossentropy"
ENCODERS = ["cnn", "lstm", "gru"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape((1,) * 6), AXES)


@pytest.mark.parametrize("stride,padding", [(1, "valid"), (1, "same"),
                                            (2, "valid"), (2, "same")])
def test_conv1d_and_global_max_pool_match_jax(stride, padding):
    x = np.random.default_rng(stride).normal(size=(3, 11, 5)).astype(
        np.float32)
    kw = dict(border_mode=padding, subsample_length=stride,
              activation="relu")
    j = JL.Convolution1D(7, 4, **kw)
    params, _ = j.build(jax.random.PRNGKey(0), (11, 5))
    t = TL.Convolution1D(7, 4, **kw)
    t.build((11, 5), torch.Generator().manual_seed(0))
    t.load_state_dict(state_dict_from_jax(_np(params)))
    want, _ = j.apply(params, {}, x)
    with torch.no_grad():
        got = t(torch.from_numpy(x))
    assert tuple(got.shape[1:]) == t.compute_output_shape((11, 5)) == \
        j.compute_output_shape((11, 5))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    pooled, _ = JL.GlobalMaxPooling1D().apply({}, {}, want)
    np.testing.assert_array_equal(
        TL.GlobalMaxPooling1D()(got).numpy(), np.asarray(pooled))


def _texts(n=48, seed=0):
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta",
             "theta", "iota", "kappa", "lambda", "mu", "nu", "xi"]
    labels = rng.integers(0, CLASSES, n)
    texts = [" ".join(rng.choice(words[c * 3:c * 3 + 5], rng.integers(4, 16)))
             for c in labels]
    return texts, labels.tolist()


def _text_set(m, n=48):
    texts, labels = _texts(n)
    return (m.TextSet.from_texts(texts, labels).tokenize().normalize()
            .word2idx().shape_sequence(SEQ))


def _pair(encoder, seed=0, **kw):
    jm = JTextClassifier(CLASSES, sequence_length=SEQ, encoder=encoder,
                         encoder_output_dim=ENC, vocab_size=20,
                         embed_dim=EMBED, **kw)
    params, state = jm.build(jax.random.PRNGKey(seed))
    tm = TextClassifier(CLASSES, sequence_length=SEQ, encoder=encoder,
                        encoder_output_dim=ENC, vocab_size=20,
                        embed_dim=EMBED, device="cpu", **kw)
    tm.load_state_dict(state_dict_from_jax(_np(params), _np(state)))
    return jm, params, state, tm


@pytest.mark.parametrize("encoder", ENCODERS)
def test_probabilities_match_jax(encoder):
    jm, params, state, tm = _pair(encoder)
    assert [tm.slot(l) for l in tm.layers] == [jm.slot(l) for l in jm.layers]
    assert tm.constructor_config() == jm.constructor_config()
    assert MODEL_REGISTRY["TextClassifier"] is TextClassifier
    x, _ = _text_set(ttext).to_arrays()
    want, _ = jm.apply(params, state, x)
    with torch.no_grad():
        got = tm.apply(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("encoder", ENCODERS)
def test_fit_on_a_text_set_matches_jax(encoder):
    jm, params, state, tm = _pair(encoder, seed=1)
    jts, tts = _text_set(jtext), _text_set(ttext)
    jm.compile(optimizer=jopt.Adam(lr=0.01), loss=LOSS, mesh=_mesh())
    jest = jm.estimator
    jest.initial_weights = (params, state)
    want, step = [], jest._make_train_step()

    def jrecord(st, b):
        st, (loss, gnorm) = step(st, b)
        want.append(float(loss))
        return st, (loss, gnorm)

    jest._train_step = jrecord
    jm.fit(jts, batch_size=16, nb_epoch=1, seed=5)
    tm.compile(optimizer=topt.Adam(lr=0.01), loss=LOSS)
    got, tstep = [], tm.estimator._step

    def trecord(b):
        loss, gnorm = tstep(b)
        got.append(float(loss))
        return loss, gnorm

    tm.estimator._step = trecord
    tm.fit(tts, batch_size=16, nb_epoch=1, seed=5)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    jp, tp = _np(jest.train_state["params"]), params_to_numpy(tm)
    for slot, d in jp.items():
        for leaf, v in d.items():
            np.testing.assert_allclose(tp[slot][leaf], v, rtol=0,
                                       atol=1e-5, err_msg=f"{slot}.{leaf}")


@pytest.mark.parametrize("encoder", ["cnn", "gru"])
def test_bundles_load_both_ways(encoder, tmp_path):
    jm, params, state, tm = _pair(encoder, seed=2)
    x, y = _text_set(ttext).to_arrays()
    # JAX -> port: a JAX bundle (after one fit step) in the port
    jm.compile(optimizer="sgd", loss=LOSS, mesh=_mesh())
    jm.estimator.initial_weights = (params, state)
    jm.fit(x[:16], y[:16], batch_size=16, nb_epoch=1)
    jm.save_model(str(tmp_path / "jax"))
    want = np.asarray(jm.predict(x))
    back = TextClassifier.load_model(str(tmp_path / "jax"), device="cpu")
    assert back.constructor_config() == jm.constructor_config()
    with torch.no_grad():
        got = back.apply(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # port -> JAX and -> InferenceModel.load_zoo
    tm.save_model(str(tmp_path / "pt"))
    jback = JTextClassifier.load_model(str(tmp_path / "pt"))
    jback.compile(optimizer="sgd", loss=LOSS, mesh=_mesh())
    with torch.no_grad():
        mine = tm.apply(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.asarray(jback.predict(x)), mine, rtol=0,
                               atol=1e-5)
    im = InferenceModel(1, 64, device="cpu").load_zoo(str(tmp_path / "pt"))
    direct = InferenceModel(1, 64, device="cpu").load(tm)
    assert np.array_equal(im.predict(x), direct.predict(x))


def test_glove_file_path(tmp_path):
    ts = _text_set(ttext)
    wi = ts.get_word_index()
    rng = np.random.default_rng(4)
    glove = tmp_path / "glove.txt"
    with open(glove, "w") as f:
        for w in list(wi)[:-2] + ["unused"]:
            f.write(w + " " + " ".join(f"{v:.5f}" for v in
                                       rng.normal(size=EMBED)) + "\n")
    kw = dict(sequence_length=SEQ, encoder="cnn", encoder_output_dim=ENC,
              embed_dim=EMBED)
    with pytest.raises(ValueError, match="word_index"):
        TextClassifier(CLASSES, embedding_file=str(glove), device="cpu",
                       **kw)
    jm = JTextClassifier(CLASSES, embedding_file=str(glove), word_index=wi,
                         **kw)
    tm = TextClassifier(CLASSES, embedding_file=str(glove), word_index=wi,
                        device="cpu", **kw)
    params, state = jm.build(jax.random.PRNGKey(0))
    assert "0_wordembedding" in state and "0_wordembedding" not in params
    table = tm.state_dict()["0_wordembedding.embeddings"]
    np.testing.assert_array_equal(table.numpy(),
                                  state["0_wordembedding"]["embeddings"])
    assert not any("embeddings" in n for n, _ in tm.named_parameters())
    tm.load_state_dict(state_dict_from_jax(_np(params), _np(state)))
    x, _ = ts.to_arrays()
    want, _ = jm.apply(params, state, x)
    with torch.no_grad():
        got = tm.apply(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)
    assert tm.frozen_embedding and tm.vocab_size == max(wi.values()) + 1
    tm.save_model(str(tmp_path / "frozen"))
    back = TextClassifier.load_model(str(tmp_path / "frozen"), device="cpu")
    assert back.frozen_embedding
    with torch.no_grad():
        np.testing.assert_array_equal(back.apply(torch.from_numpy(x)).numpy(),
                                      got)


def test_entry_points_need_cuda_or_a_device():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TextClassifier(CLASSES, sequence_length=SEQ, vocab_size=20,
                       embed_dim=EMBED)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Estimator(torch.nn.Linear(2, 2))
