"""BERT and the graph-form attention layers of the PyTorch port against the
JAX package, on the CPU.

Held: ``PositionalEmbedding``, ``MultiHeadAttention`` (with and without a
causal mask, an input wider than its hidden size), ``TransformerLayer``
(also in training with dropout under the container's key) and ``BERT``
(one input and ``[ids, segment_ids]``, its two outputs picked by
``SelectTable``) as layers of a ``Sequential`` and a ``Model``, within
1e-5 of JAX's with its weights; ``BERTClassifier``, ``BERTNER`` and
``BERTSQuAD`` outputs within 1e-4; two f32 Adam steps of each head through
``fit`` with dropout 0.1 (the masks JAX's), losses and parameters within
1e-5 of the JAX Estimator's (Adam with ``epsilon=1e-4``, as in
``tests/test_torch_training.py``: the K-projection bias has a gradient
that is zero in exact arithmetic, and a tiny epsilon scales each
package's rounding noise there up to ±lr); the heads training under a bf16 compute
policy; and bundles that each package saves loading in the other, through
``load_model_bundle`` and ``InferenceModel.load_zoo``.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from analytics_zoo_tpu.models.text import BERTNER as JBERTNER
from analytics_zoo_tpu.models.text import BERTSQuAD as JBERTSQuAD
from analytics_zoo_tpu.models.text import BERTClassifier as JBERTClassifier
from analytics_zoo_tpu.nn import layers as JL
from analytics_zoo_tpu.nn import optimizers as jopt
from analytics_zoo_tpu.nn.graph import Input as JInput
from analytics_zoo_tpu.nn.topology import Model as JModel
from analytics_zoo_tpu.nn.topology import Sequential as JSequential
from analytics_zoo_tpu_torch.bridge import (params_from_jax, params_to_numpy,
                                            state_dict_from_jax)
from analytics_zoo_tpu_torch.common import prng
from analytics_zoo_tpu_torch.common.config import TrainConfig
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models.common.zoo_model import \
    load_model_bundle
from analytics_zoo_tpu_torch.models.text import (NER, BERTNER,
                                                 BERTClassifier, BERTSQuAD)
from analytics_zoo_tpu_torch.nn import layers as TL
from analytics_zoo_tpu_torch.nn import optimizers as topt
from analytics_zoo_tpu_torch.nn.graph import Input
from analytics_zoo_tpu_torch.nn.topology import Model, Sequential

AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")
T, D, VOCAB = 8, 16, 50
BERT_KW = dict(vocab=VOCAB, hidden_size=D, n_block=2, n_head=2, seq_len=T)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape((1,) * 6), AXES)


def _close(want, got, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


def _ids(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, VOCAB, size=(n, T)).astype(np.int32),
            rng.integers(0, 2, size=(n, T)).astype(np.int32))


# ------------------------------------------------------- graph-form layers
def _stacks(m, dropout=0.0):
    return [m.PositionalEmbedding(T, D, input_shape=(T, D)),
            m.TransformerLayer(D, 2, dropout=dropout),
            m.MultiHeadAttention(D, 2, causal=True),
            m.MultiHeadAttention(12, 3, attn_strategy="full")]


def test_attention_layers_in_a_sequential_match_jax():
    jm = JSequential(_stacks(JL))
    params, state = jm.build(jax.random.PRNGKey(0))
    tm = Sequential(_stacks(TL), device="cpu")
    assert all(l.built for l in tm.layers)
    assert [tm.slot(l) for l in tm.layers] == [jm.slot(l) for l in jm.layers]
    tm.load_state_dict(state_dict_from_jax(_np(params), _np(state)))
    x = np.random.default_rng(1).normal(size=(3, T, D)).astype(np.float32)
    want, _ = jm.apply(params, state, x)
    with torch.no_grad():
        got = tm.apply(torch.from_numpy(x))
    assert tuple(got.shape[1:]) == tm.compute_output_shape((T, D)) \
        == tuple(jm.compute_output_shape((T, D))) == (T, 12)
    _close(want, got, 1e-5)


def test_transformer_layer_dropout_in_a_sequential_matches_jax():
    """In training the container splits its key among its layers as JAX's
    does; the block drops its attention output with ``fold_in(key, 1)``."""
    jm = JSequential(_stacks(JL, dropout=0.2))
    params, state = jm.build(jax.random.PRNGKey(3))
    tm = Sequential(_stacks(TL, dropout=0.2), device="cpu")
    tm.load_state_dict(state_dict_from_jax(_np(params), _np(state)))
    x = np.random.default_rng(3).normal(size=(2, T, D)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want, _ = jm.apply(params, state, x, training=True, rng=key)
    plain, _ = jm.apply(params, state, x)
    tm.train()
    with torch.no_grad():
        got = tm.apply(torch.from_numpy(x),
                       rng=prng.as_key(np.asarray(key)))
    _close(want, got, 1e-5)
    assert float(np.abs(np.asarray(want) - np.asarray(plain)).max()) > 1e-3


def _bert_model(m, inp):
    ids, segs = inp((T,)), inp((T,))
    b = m.BERT(intermediate_size=32, **BERT_KW)([ids, segs])
    seq = m.SelectTable(0)(b)
    out = m.Dense(3, activation="softmax")(m.SelectTable(1)(b))
    return [ids, segs], [seq, out]


def test_bert_in_a_model_with_segments_matches_jax():
    jm = JModel(*_bert_model(JL, JInput))
    params, state = jm.build(jax.random.PRNGKey(1))
    tm = Model(*_bert_model(TL, Input), device="cpu")
    assert [tm.slot(l) for l in tm.layers] == [jm.slot(l) for l in jm.layers]
    tm.load_state_dict(state_dict_from_jax(_np(params), _np(state)))
    assert sorted(params["0_bert"]) == sorted(
        ["token_embeddings", "pos_embeddings", "segment_embeddings",
         "block0", "block1", "ln_f", "pooler_kernel", "pooler_bias"])
    ids, segs = _ids()
    want, _ = jm.apply(params, state, [ids, segs])
    with torch.no_grad():
        got = tm.apply([torch.from_numpy(ids), torch.from_numpy(segs)])
    assert tm.output_shape == [(T, D), (3,)]
    for w, g in zip(want, got):
        _close(w, g, 1e-5)


def test_bert_in_a_sequential_and_its_two_outputs_match_jax():
    def stack(m):
        return [m.BERT(input_shape=(T,), **BERT_KW), m.SelectTable(1),
                m.Dense(4)]

    jm = JSequential(stack(JL))
    params, state = jm.build(jax.random.PRNGKey(2))
    tm = Sequential(stack(TL), device="cpu")
    tm.load_state_dict(state_dict_from_jax(_np(params), _np(state)))
    ids, _ = _ids(seed=2)
    want, _ = jm.apply(params, state, ids)
    with torch.no_grad():
        got = tm.apply(torch.from_numpy(ids))
    _close(want, got, 1e-5)
    jb, tb = jm.layers[0], tm.layers[0]
    assert tb.compute_output_shape((T,)) == \
        [tuple(s) for s in jb.compute_output_shape((T,))] == [(T, D), (D,)]
    (w_seq, w_pooled), _ = jb.apply(params["0_bert"], {}, ids)
    with torch.no_grad():
        t_seq, t_pooled = tb(torch.from_numpy(ids))
    _close(w_seq, t_seq, 1e-5)
    _close(w_pooled, t_pooled, 1e-5)


# ------------------------------------------------------------ the heads
HEADS = {
    "classifier": (lambda m, **kw: m(num_classes=3, **kw),
                   JBERTClassifier, BERTClassifier,
                   "sparse_categorical_crossentropy"),
    "ner": (lambda m, **kw: m(num_entities=3, **kw), JBERTNER, BERTNER,
            None),
    "squad": (lambda m, **kw: m(**kw), JBERTSQuAD, BERTSQuAD, None),
}


def _head_pair(kind, seed=0, **kw):
    make, jcls, tcls, _ = HEADS[kind]
    kw = {**BERT_KW, **kw}
    jm = make(jcls, **kw)
    params, state = jm.build(jax.random.PRNGKey(seed))
    tm = make(tcls, device="cpu", **kw)
    tm.load_state_dict(params_from_jax(_np(params)))
    return jm, params, state, tm


def _labels(kind, ids, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "classifier":
        return (ids[:, 0] % 3).astype(np.int32)
    if kind == "ner":
        tags = (ids % 3).astype(np.int32)
        tags[:, -2:] = -1
        return tags
    ans = rng.integers(0, T, size=len(ids))
    return np.stack([ans, ans], axis=1).astype(np.int32)


@pytest.mark.parametrize("kind", sorted(HEADS))
def test_head_outputs_match_jax(kind):
    jm, params, state, tm = _head_pair(kind)
    assert tm.constructor_config() == jm.constructor_config()
    ids, segs = _ids(n=3)
    for x in (ids, [ids, segs]):
        want, _ = jm.apply(params, state, x)
        with torch.no_grad():
            got = tm.apply(torch.from_numpy(ids) if x is ids else
                           [torch.from_numpy(ids), torch.from_numpy(segs)])
        assert got.dtype == torch.float32
        assert tuple(got.shape[1:]) == tuple(tm.compute_output_shape(None))
        _close(want, got, 1e-4)


@pytest.mark.parametrize("kind", sorted(HEADS))
def test_two_fit_steps_with_dropout_match_jax(kind):
    jm, params, state, tm = _head_pair(kind, seed=1, dropout=0.1)
    loss = HEADS[kind][3] or HEADS[kind][1].loss
    ids, _ = _ids(n=32, seed=1)
    y = _labels(kind, ids)
    jm.compile(optimizer=jopt.Adam(lr=0.01, epsilon=1e-4), loss=loss,
               mesh=_mesh())
    jest = jm.estimator
    jest.initial_weights = (params, state)
    want, step = [], jest._make_train_step()

    def jrecord(st, b):
        st, (loss_v, gnorm) = step(st, b)
        want.append(float(loss_v))
        return st, (loss_v, gnorm)

    jest._train_step = jrecord
    jm.fit(ids, y, batch_size=16, nb_epoch=1, seed=5)
    tm.compile(optimizer=topt.Adam(lr=0.01, epsilon=1e-4),
               loss=HEADS[kind][3] or HEADS[kind][2].loss)
    got, tstep = [], tm.estimator._step

    def trecord(b):
        loss_v, gnorm = tstep(b)
        got.append(float(loss_v))
        return loss_v, gnorm

    tm.estimator._step = trecord
    tm.fit(ids, y, batch_size=16, nb_epoch=1, seed=5)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    jp, tp = _np(jest.train_state["params"]), params_to_numpy(tm)
    flat = params_from_jax(jp)
    mine = params_from_jax(tp)
    assert sorted(flat) == sorted(mine)
    for name, v in flat.items():
        np.testing.assert_allclose(mine[name].numpy(), v.numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)


def test_heads_train_under_the_bf16_policy():
    """Mirror of the JAX text estimators' bf16 case: BERTNER and an NER
    tagger train and predict under a bf16 compute policy with f32
    masters, finite and decreasing."""
    rng = np.random.default_rng(0)
    ids = rng.integers(1, VOCAB, size=(64, T)).astype(np.int32)
    tags = (ids % 3).astype(np.int32)
    model = BERTNER(num_entities=3, vocab=VOCAB, hidden_size=32, n_block=1,
                    n_head=2, seq_len=T, device="cpu")
    model.compile(optimizer=topt.Adam(lr=0.01), loss=BERTNER.loss,
                  config=TrainConfig(compute_dtype="bfloat16"))
    model.fit(ids, tags, batch_size=32, nb_epoch=1)
    first = model.estimator.trainer_state.last_loss
    model.fit(ids, tags, batch_size=32, nb_epoch=4)
    last = model.estimator.trainer_state.last_loss
    assert model.head_kernel.dtype == torch.bfloat16
    assert np.isfinite(last) and last < first, (first, last)
    assert model.predict_tags(ids[:8]).shape == (8, T)
    # the BiLSTM-CRF tagger too: its CRF programs run in f32 inside
    words = rng.integers(1, 40, size=(64, T)).astype(np.int32)
    chars = rng.integers(1, 20, size=(64, T, 5)).astype(np.int32)
    ner = NER(num_entities=3, word_vocab_size=40, char_vocab_size=20,
              word_length=5, word_emb_dim=8, char_emb_dim=4,
              tagger_lstm_dim=8, device="cpu")
    ner.compile(optimizer=topt.Adam(lr=0.02), loss=ner.loss,
                config=TrainConfig(compute_dtype="bfloat16"))
    ner.fit([words, chars], (words % 3).astype(np.int32), batch_size=32,
            nb_epoch=1)
    first = ner.estimator.trainer_state.last_loss
    ner.fit([words, chars], (words % 3).astype(np.int32), batch_size=32,
            nb_epoch=8)
    last = ner.estimator.trainer_state.last_loss
    assert np.isfinite(last) and last < first, (first, last)
    assert ner.predict_tags([words[:4], chars[:4]]).shape == (4, T)


def test_bundles_load_both_ways(tmp_path):
    jm, params, state, tm = _head_pair("ner", seed=4)
    ids, segs = _ids(n=5, seed=4)
    tags = _labels("ner", ids)
    # JAX -> port, after one JAX step
    jm.compile(optimizer="sgd", loss=JBERTNER.loss, mesh=_mesh())
    jm.estimator.initial_weights = (params, state)
    jm.fit(ids, tags, batch_size=5, nb_epoch=1)
    jm.save_model(str(tmp_path / "jax"))
    want = np.asarray(jm.predict(ids))
    back, cfg = load_model_bundle(str(tmp_path / "jax"), device="cpu")
    assert isinstance(back, BERTNER) and cfg["class"] == "BERTNER"
    with torch.no_grad():
        _close(want, back.apply(torch.from_numpy(ids)), 1e-4)
    im = InferenceModel(1, 64, device="cpu").load_zoo(str(tmp_path / "jax"))
    _close(want, im.predict(ids), 1e-4)
    loaded = BERTNER.load_model(str(tmp_path / "jax"), device="cpu")
    np.testing.assert_array_equal(loaded.predict_tags(ids),
                                  np.argmax(want, axis=-1))
    # port -> port and port -> JAX
    tm.save_model(str(tmp_path / "pt"))
    with torch.no_grad():
        mine = tm.apply(torch.from_numpy(ids)).numpy()
    again = BERTNER.load_model(str(tmp_path / "pt"), device="cpu")
    with torch.no_grad():
        np.testing.assert_array_equal(
            again.apply(torch.from_numpy(ids)).numpy(), mine)
    jback = JBERTNER.load_model(str(tmp_path / "pt"))
    _close(mine, jback.predict(ids), 1e-4)
    # BERTSQuAD's spans are the argmax of its start and end rows
    sq = BERTSQuAD(device="cpu", **BERT_KW).compile(optimizer="adam",
                                                     loss=BERTSQuAD.loss)
    start, end = sq.predict_spans([ids, segs])
    with torch.no_grad():
        logp = sq.apply([torch.from_numpy(ids), torch.from_numpy(segs)])
    np.testing.assert_array_equal(start, logp[:, 0].argmax(-1).numpy())
    np.testing.assert_array_equal(end, logp[:, 1].argmax(-1).numpy())


def test_entry_points_need_cuda_or_a_device():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BERTClassifier(2, **BERT_KW)
