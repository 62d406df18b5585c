"""The sequence-labelling text models of the PyTorch port against the JAX
package, on the CPU: NER in its "reg" and "pad" CRF modes, SequenceTagger
with its softmax and CRF heads (with and without the char encoder) and
IntentEntity, at the sizes of ``tests/test_text_estimators.py``.

Held, with the JAX model's weights loaded through the bridge: outputs
within 1e-4; the Viterbi tags of ``predict_tags`` identical; two f32 Adam
steps through ``fit`` (dropout on, its masks JAX's) with per-step losses
and final parameters within 1e-5 of the JAX Estimator's (Adam with
``epsilon=1e-4``, as in ``tests/test_torch_training.py``: a gate weight
whose gradient is rounding noise, in a saturated ``hard_sigmoid``, would
move by up to ±lr with a tiny epsilon, which neither package can
reproduce); a bundle saved
by the port loading through ``load_model`` with the same outputs. Also the
model registry: after every module under each package's ``models/`` is
imported, the two ``MODEL_REGISTRY``s hold the same names.
"""

import importlib
import pkgutil

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from analytics_zoo_tpu.models import text as jtext
from analytics_zoo_tpu.nn import optimizers as jopt
from analytics_zoo_tpu_torch.bridge import params_from_jax, params_to_numpy
from analytics_zoo_tpu_torch.models import text as ttext
from analytics_zoo_tpu_torch.nn import optimizers as topt

AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")
VOCAB, T, W, CHAR_VOCAB = 40, 8, 5, 20


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape((1,) * 6), AXES)


def _batch(n=32, seed=0, pad=0):
    rng = np.random.default_rng(seed)
    words = rng.integers(1, VOCAB, size=(n, T)).astype(np.int32)
    chars = rng.integers(1, CHAR_VOCAB, size=(n, T, W)).astype(np.int32)
    if pad:
        words[:, -pad:] = 0
        chars[:, -pad:, :] = 0
    return words, chars


def _ner(m, mode, **kw):
    return m.NER(num_entities=4, word_vocab_size=VOCAB,
                 char_vocab_size=CHAR_VOCAB, word_length=W, word_emb_dim=24,
                 char_emb_dim=8, tagger_lstm_dim=16, crf_mode=mode, **kw)


def _tagger(m, classifier, chars=True, **kw):
    return m.SequenceTagger(num_pos_labels=3, num_chunk_labels=2,
                            word_vocab_size=VOCAB,
                            char_vocab_size=CHAR_VOCAB if chars else None,
                            word_length=W, feature_size=16,
                            classifier=classifier, **kw)


def _intent(m, **kw):
    return m.IntentEntity(num_intents=3, num_entities=4,
                          word_vocab_size=VOCAB, char_vocab_size=CHAR_VOCAB,
                          word_length=W, word_emb_dim=24, char_emb_dim=8,
                          char_lstm_dim=8, tagger_lstm_dim=16, **kw)


def _case(kind):
    """``(make(module, **kw), x(words, chars), y(words), loss(model))``."""
    if kind in ("ner_reg", "ner_pad"):
        mode = kind[4:]

        def y(words):
            tags = (words % 4).astype(np.int32)
            if mode == "pad":
                tags[words == 0] = -1
            return tags

        return (lambda m, **kw: _ner(m, mode, **kw),
                lambda w, c: [w, c], y, lambda model: model.loss)
    if kind.startswith("tagger"):
        classifier = "crf" if kind.endswith("crf") else "softmax"
        chars = "words" not in kind
        return (lambda m, **kw: _tagger(m, classifier, chars, **kw),
                (lambda w, c: [w, c]) if chars else (lambda w, c: w),
                lambda words: ((words % 3).astype(np.int32),
                               (words % 2).astype(np.int32)),
                lambda model: (model.crf_loss if classifier == "crf"
                               else model.loss))
    return (_intent, lambda w, c: [w, c],
            lambda words: ((words[:, 0] % 3).astype(np.int32),
                           (words % 4).astype(np.int32)),
            lambda model: model.loss)


KINDS = ["ner_reg", "ner_pad", "tagger_softmax", "tagger_crf",
         "tagger_words_crf", "intent"]


def _pair(kind, seed=0):
    make = _case(kind)[0]
    jm = make(jtext)
    params, state = jm.build(jax.random.PRNGKey(seed))
    tm = make(ttext, device="cpu")
    tm.load_state_dict(params_from_jax(_np(params)))
    return jm, params, state, tm


def _torch(x):
    return ([torch.from_numpy(a) for a in x] if isinstance(x, list)
            else torch.from_numpy(x))


@pytest.mark.parametrize("kind", KINDS)
def test_outputs_match_jax(kind):
    jm, params, state, tm = _pair(kind)
    _, xf, _, _ = _case(kind)
    x = xf(*_batch(n=6, pad=3 if kind == "ner_pad" else 0))
    want, _ = jm.apply(params, state, x)
    with torch.no_grad():
        got = tm.apply(_torch(x))
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert tuple(g.shape) == np.asarray(w).shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-4)
    assert tm.config == jm.config


@pytest.mark.parametrize("kind", KINDS)
def test_two_fit_steps_match_jax(kind):
    jm, params, state, tm = _pair(kind, seed=1)
    _, xf, yf, lossf = _case(kind)
    words, chars = _batch(n=32, seed=1, pad=3 if kind == "ner_pad" else 0)
    x, y = xf(words, chars), yf(words)
    jm.compile(optimizer=jopt.Adam(lr=0.01, epsilon=1e-4), loss=lossf(jm),
               mesh=_mesh())
    jest = jm.estimator
    jest.initial_weights = (params, state)
    want, step = [], jest._make_train_step()

    def jrecord(st, b):
        st, (loss, gnorm) = step(st, b)
        want.append(float(loss))
        return st, (loss, gnorm)

    jest._train_step = jrecord
    jm.fit(x, y, batch_size=16, nb_epoch=1, seed=3)
    tm.compile(optimizer=topt.Adam(lr=0.01, epsilon=1e-4), loss=lossf(tm))
    got, tstep = [], tm.estimator._step

    def trecord(b):
        loss, gnorm = tstep(b)
        got.append(float(loss))
        return loss, gnorm

    tm.estimator._step = trecord
    tm.fit(x, y, batch_size=16, nb_epoch=1, seed=3)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    flat = params_from_jax(_np(jest.train_state["params"]))
    mine = params_from_jax(params_to_numpy(tm))
    assert sorted(flat) == sorted(mine)
    for name, v in flat.items():
        np.testing.assert_allclose(mine[name].numpy(), v.numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("mode", ["reg", "pad"])
def test_viterbi_tags_are_identical(mode):
    kind = f"ner_{mode}"
    jm, params, state, tm = _pair(kind, seed=2)
    words, chars = _batch(n=12, seed=2, pad=3 if mode == "pad" else 0)
    jm.compile(optimizer="adam", loss=jm.loss, mesh=_mesh())
    jm.estimator.initial_weights = (params, state)
    tm.compile(optimizer="adam", loss=tm.loss)
    want = jm.predict_tags([words, chars], batch_size=8)
    got = tm.predict_tags([words, chars], batch_size=8)
    assert got.dtype == np.int32 and got.shape == (12, T)
    np.testing.assert_array_equal(got, np.asarray(want))
    if mode == "pad":
        assert (got[:, -3:] == 0).all()


@pytest.mark.parametrize("kind", ["ner_pad", "tagger_crf", "intent"])
def test_bundles_round_trip(kind, tmp_path):
    _, _, _, tm = _pair(kind, seed=3)
    _, xf, _, _ = _case(kind)
    x = _torch(xf(*_batch(n=4, seed=3)))
    tm.save_model(str(tmp_path / kind))
    back = type(tm).load_model(str(tmp_path / kind), device="cpu")
    assert back.config == tm.config and back.estimator is not None
    with torch.no_grad():
        for a, b in zip(tm.apply(x), back.apply(x)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    # the JAX package reads the port's bundle
    jcls = getattr(jtext, type(tm).__name__)
    jback = jcls.load_model(str(tmp_path / kind))
    want = jback.predict([a.numpy() for a in x] if isinstance(x, list)
                         else x.numpy())
    with torch.no_grad():
        for w, g in zip(want, tm.apply(x)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-4)


def test_constructor_checks_and_aliases():
    with pytest.raises(ValueError, match="crf_mode"):
        ttext.NER(num_entities=2, word_vocab_size=5, char_vocab_size=5,
                  crf_mode="nope", device="cpu")
    with pytest.raises(ValueError, match="softmax or crf"):
        ttext.SequenceTagger(2, 2, 5, classifier="hmm", device="cpu")
    assert ttext.POSTagger is ttext.SequenceTagger
    assert sorted(ttext.__all__) == sorted(jtext.__all__)


def _registry(pkg_name):
    pkg = importlib.import_module(pkg_name)
    for info in pkgutil.walk_packages(pkg.__path__, pkg_name + "."):
        importlib.import_module(info.name)
    return importlib.import_module(
        pkg_name + ".common.zoo_model").MODEL_REGISTRY


def test_model_registries_hold_the_same_names():
    jax_names = set(_registry("analytics_zoo_tpu.models"))
    port_names = set(_registry("analytics_zoo_tpu_torch.models"))
    assert port_names == jax_names
    assert {"BERTClassifier", "BERTNER", "BERTSQuAD", "NER",
            "SequenceTagger", "IntentEntity", "KNRM", "AnomalyDetector",
            "TransformerLM", "PipelinedTransformerLM"} <= port_names
