"""The image and text set tiers of the PyTorch port against the JAX
package, on the CPU.

Held: every ``ImageProcessing`` stage, alone, chained and under
``ImageRandomPreprocessing``, and the 3D stages of ``data/image3d.py``
and ``data/image.py``, give byte-equal outputs for the same seed;
``ImageSet.read`` (PIL) and ``to_arrays`` equal JAX's; ``TextSet``'s
pipeline (tokenize, normalize, word index with its options, shape,
samples) gives equal indices, word index and arrays, with ``read``,
``read_csv``, word-index save/load, ``random_split`` and the relation
sets; ``ImagenetConfig.preprocessing`` and ``predict_image_set`` of
``ImageClassifier`` match JAX's with its weights (labels equal,
probabilities within 1e-5); and ``fit``/``evaluate``/``predict`` of a
``KerasNet`` take a ``TextSet`` or an ``ImageSet`` where they take arrays.
"""

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.data import image as jimg
from analytics_zoo_tpu.data import image3d as jimg3
from analytics_zoo_tpu.data import text as jtext
from analytics_zoo_tpu.models.image.classification import \
    ImageClassifier as JImageClassifier
from analytics_zoo_tpu.nn import layers as JL
from analytics_zoo_tpu.nn.topology import Sequential as JSequential
from analytics_zoo_tpu_torch.bridge import state_dict_from_jax
from analytics_zoo_tpu_torch.data import image as timg
from analytics_zoo_tpu_torch.data import image3d as timg3
from analytics_zoo_tpu_torch.data import text as ttext
from analytics_zoo_tpu_torch.models.image.classification import (
    ImageClassifier, ImagenetConfig)
from analytics_zoo_tpu_torch.nn import layers as TL
from analytics_zoo_tpu_torch.nn.topology import Sequential


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _images(n=3, h=20, w=24, seed=0):
    return np.random.default_rng(seed).uniform(
        0, 255, size=(n, h, w, 3)).astype(np.float32)


def _stages(m):
    """Each module's stages, built alike (name, stage)."""
    return [
        ("resize", m.ImageResize(13, 17)),
        ("aspect", m.ImageAspectScale(16, 30, scale_multiple_of=4)),
        ("random_resize", m.ImageRandomResize(10, 18)),
        ("center_crop", m.ImageCenterCrop(10, 12)),
        ("random_crop", m.ImageRandomCrop(9, 11)),
        ("fixed_crop", m.ImageFixedCrop(0.1, 0.2, 0.7, 0.9)),
        ("fixed_crop_px", m.ImageFixedCrop(2, 3, 15, 12, normalized=False)),
        ("expand", m.ImageExpand(max_expand_ratio=2.0)),
        ("filler", m.ImageFiller(0.2, 0.2, 0.5, 0.6, value=7)),
        ("hflip", m.ImageHFlip()),
        ("brightness", m.ImageBrightness()),
        ("contrast", m.ImageContrast()),
        ("saturation", m.ImageSaturation()),
        ("hue", m.ImageHue()),
        ("jitter", m.ImageColorJitter()),
        ("channel_normalize", m.ImageChannelNormalize(120, 110, 100,
                                                      2.0, 3.0, 4.0)),
        ("pixel_normalize", m.ImagePixelNormalizer(
            np.full((20, 24, 3), 9.0, np.float32))),
        ("channel_order", m.ImageChannelOrder()),
        ("to_tensor_nchw", m.ImageMatToTensor("NCHW")),
        ("random_pre", m.ImageRandomPreprocessing(m.ImageHFlip(), 0.5)),
        ("chain", m.ImageResize(30, 30) >> m.ImageRandomCrop(24, 24)
         >> m.ImageHFlip() >> m.ImageColorJitter()),
        ("imagenet", m.ImageResize(24, 24) >> m.ImageCenterCrop(20, 20)
         >> m.ImageChannelNormalize(123.68, 116.779, 103.939)),
    ]


def _check_same_set(t, j):
    assert len(t) == len(j) and t.seed == j.seed
    for ft, fj in zip(t.features, j.features):
        assert sorted(ft.keys()) == sorted(fj.keys())
        a, b = ft.get_image(), fj.get_image()
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
        assert ft.get_label() == fj.get_label()


@pytest.mark.parametrize("idx", range(22))
@pytest.mark.parametrize("seed", [0, 5])
def test_image_stage_bytes_equal_jax(idx, seed):
    (name, ts), (_, js) = _stages(timg)[idx], _stages(jimg)[idx]
    imgs = _images(seed=seed)
    t = timg.ImageSet.from_arrays(imgs, [0, 1, 2], seed=seed).transform(ts)
    j = jimg.ImageSet.from_arrays(imgs, [0, 1, 2], seed=seed).transform(js)
    _check_same_set(t, j)
    # a second transform runs on the next seed, as in JAX
    _check_same_set(t.transform(ts), j.transform(js))


def test_image_set_to_sample_and_arrays_match_jax():
    imgs = _images()
    t = timg.ImageSet.from_arrays(imgs, [3, 1, 2]).transform(
        timg.ImageSetToSample())
    j = jimg.ImageSet.from_arrays(imgs, [3, 1, 2]).transform(
        jimg.ImageSetToSample())
    for ft, fj in zip(t.features, j.features):
        for a, b in zip(ft["sample"], fj["sample"]):
            assert np.array_equal(a, b)
    for a, b in zip(t.to_arrays(), j.to_arrays()):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    assert t.get_labels() == j.get_labels() == [3, 1, 2]


def test_image_set_read_matches_jax(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(2)
    for cat in ("cat", "dog"):
        (tmp_path / cat).mkdir()
        for i in range(2):
            Image.fromarray(rng.integers(0, 255, (8, 9, 3), np.uint8)).save(
                tmp_path / cat / f"{i}.png")
    for labeled in (True, False):
        path = str(tmp_path / ("" if labeled else "cat"))
        t = timg.ImageSet.read(path, with_label=labeled)
        j = jimg.ImageSet.read(path, with_label=labeled)
        _check_same_set(t, j)
        assert [f.get_uri() for f in t.features] == \
            [f.get_uri() for f in j.features]


def _volume(seed=0):
    return np.random.default_rng(seed).normal(size=(10, 12, 14)).astype(
        np.float32)


@pytest.mark.parametrize("make", [
    lambda m: m.Crop3D((1, 2, 3), (4, 5, 6)),
    lambda m: m.CenterCrop3D((4, 6, 8)),
    lambda m: m.RandomCrop3D((5, 5, 5)),
    lambda m: m.Rotate3D(0.3, -0.2, 0.5),
    lambda m: m.AffineTransform3D(np.array([[1.0, 0.1, 0], [0, 0.9, 0],
                                            [0.05, 0, 1.1]]), (1, -1, 0.5)),
])
def test_image3d_stages_bytes_equal_jax(make):
    vol = _volume()
    t = timg.ImageSet.from_arrays(vol[None], seed=4).transform(make(timg3))
    j = jimg.ImageSet.from_arrays(vol[None], seed=4).transform(make(jimg3))
    _check_same_set(t, j)


@pytest.mark.parametrize("make", [
    lambda m: m.Crop3D((1, 2, 3), (4, 5, 6)),
    lambda m: m.RandomCrop3D((5, 5, 5)),
    lambda m: m.Rotate3D((0.3, -0.2, 0.5)),
    lambda m: m.AffineTransform3D(np.eye(3) * 1.1, np.array([1, 0, 0.5])),
])
def test_image_module_3d_stages_bytes_equal_jax(make):
    vol = _volume(1)
    t = timg.ImageSet.from_arrays(vol[None], seed=6).transform(make(timg))
    j = jimg.ImageSet.from_arrays(vol[None], seed=6).transform(make(jimg))
    _check_same_set(t, j)


TEXTS = ["The quick brown fox, jumps over the lazy dog!",
         "A dog; a cat; 42 foxes and 7 dogs.",
         "Quick quick QUICK brown cat",
         "lazy afternoon: the dog sleeps", "brown fox brown dog brown cat"]


def _pipeline(m, **w2i):
    ts = m.TextSet.from_texts(TEXTS, [0, 1, 2, 1, 0])
    return ts.tokenize().normalize().word2idx(**w2i).shape_sequence(
        6, trunc_mode="post").generate_sample()


@pytest.mark.parametrize("w2i", [{}, {"remove_topN": 1},
                                 {"max_words_num": 5},
                                 {"min_freq": 2},
                                 {"existing_map": {"zebra": 3}}])
def test_text_set_pipeline_matches_jax(w2i):
    t, j = _pipeline(ttext, **w2i), _pipeline(jtext, **w2i)
    assert t.get_word_index() == j.get_word_index()
    for ft, fj in zip(t.features, j.features):
        assert ft.get_tokens() == fj.get_tokens()
        assert list(ft.get_indices()) == list(fj.get_indices())
        for a, b in zip(ft.get_sample(), fj.get_sample()):
            assert np.array_equal(a, b)
    for a, b in zip(t.to_arrays(), j.to_arrays()):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    for pre in ("pre", "post"):
        a = ttext.SequenceShaper(3, pre, pad_element=9).transform(
            t.features[1].copy())
        b = jtext.SequenceShaper(3, pre, pad_element=9).transform(
            j.features[1].copy())
        assert list(a.get_indices()) == list(b.get_indices())


def test_text_set_io_split_and_relations_match_jax(tmp_path):
    for i, cat in enumerate(("news", "sport")):
        (tmp_path / "d" / cat).mkdir(parents=True)
        for k in range(2):
            (tmp_path / "d" / cat / f"{k}.txt").write_text(TEXTS[i * 2 + k])
    with open(tmp_path / "t.csv", "w") as f:
        f.write('q1,"hello, world"\nq2,brown fox\n')
    for read in (lambda m: m.TextSet.read(str(tmp_path / "d")),
                 lambda m: m.TextSet.read_csv(str(tmp_path / "t.csv"))):
        t, j = read(ttext), read(jtext)
        assert t.get_texts() == j.get_texts()
        assert t.get_labels() == j.get_labels()
        assert t.get_uris() == j.get_uris()
    t = _pipeline(ttext)
    t.save_word_index(str(tmp_path / "wi.txt"))
    j = jtext.TextSet.from_texts(["x"]).load_word_index(
        str(tmp_path / "wi.txt"))
    assert j.get_word_index() == t.get_word_index()
    back = ttext.TextSet.from_texts(["x"]).load_word_index(
        str(tmp_path / "wi.txt"))
    assert back.get_word_index() == t.get_word_index()
    js = _pipeline(jtext)
    for a, b in zip(t.random_split([0.6, 0.4], seed=3),
                    js.random_split([0.6, 0.4], seed=3)):
        assert a.get_texts() == b.get_texts()
    c1 = {m: m.TextSet([m.TextFeature(uri=f"q{i}") for i in range(2)])
          for m in (ttext, jtext)}
    c2 = {m: m.TextSet([m.TextFeature(uri=f"a{i}") for i in range(3)])
          for m in (ttext, jtext)}
    for m in (ttext, jtext):
        for i, f in enumerate(c1[m].features):
            f["indexedTokens"] = [i + 1, i + 2]
        for i, f in enumerate(c2[m].features):
            f["indexedTokens"] = [10 + i]
    rel = {m: [m.Relation("q0", "a0", 1), m.Relation("q0", "a1", 0),
               m.Relation("q0", "a2", 0), m.Relation("q1", "a1", 1),
               m.Relation("q1", "a2", 0)] for m in (ttext, jtext)}
    for how in ("from_relation_pairs", "from_relation_lists"):
        a = getattr(ttext.TextSet, how)(rel[ttext], c1[ttext], c2[ttext])
        b = getattr(jtext.TextSet, how)(rel[jtext], c1[jtext], c2[jtext])
        assert len(a) == len(b) > 0
        for fa, fb in zip(a.features, b.features):
            for u, v in zip(fa.get_sample(), fb.get_sample()):
                assert np.array_equal(u, v)


def test_predict_image_set_matches_jax():
    """A small convolutional classifier stands in for the backbone (the
    backbones' parity is tests/test_torch_image.py's)."""
    jm = JSequential([JL.Convolution2D(6, 3, 3, activation="relu",
                                       input_shape=(32, 32, 3)),
                      JL.GlobalAveragePooling2D(),
                      JL.Dense(10, activation="softmax")])
    params, state = jm.build(jax.random.PRNGKey(3))
    jclf = JImageClassifier("custom", (32, 32, 3), 10, model=jm,
                            label_map=[f"c{i}" for i in range(10)])
    jclf.compile()
    jm.estimator.initial_weights = (params, state)
    tm = Sequential([TL.Convolution2D(6, 3, 3, activation="relu",
                                      input_shape=(32, 32, 3)),
                     TL.GlobalAveragePooling2D(),
                     TL.Dense(10, activation="softmax")], device="cpu")
    tm.load_state_dict(state_dict_from_jax(_np(params), _np(state)))
    clf = ImageClassifier("custom", (32, 32, 3), 10, model=tm,
                          label_map=[f"c{i}" for i in range(10)])
    imgs = _images(n=4, h=40, w=44, seed=9)
    want = jclf.set_top_n(3).predict_image_set(
        jimg.ImageSet.from_arrays(imgs, seed=1), batch_size=3)
    got = clf.set_top_n(3).predict_image_set(
        timg.ImageSet.from_arrays(imgs, seed=1), batch_size=3)
    assert [[l for l, _ in r] for r in got] == \
        [[l for l, _ in r] for r in want]
    np.testing.assert_allclose([[p for _, p in r] for r in got],
                               [[p for _, p in r] for r in want], rtol=0,
                               atol=1e-5)
    # the recipe itself is JAX's
    a = timg.ImageSet.from_arrays(imgs).transform(
        ImagenetConfig.preprocessing(32, 32))
    from analytics_zoo_tpu.models.image.classification import \
        ImagenetConfig as JCfg
    b = jimg.ImageSet.from_arrays(imgs).transform(JCfg.preprocessing(32, 32))
    _check_same_set(a, b)
    assert ImagenetConfig.MEANS == JCfg.MEANS
    with pytest.raises(NotImplementedError, match=r"\[11\]"):
        clf.fit_image_set(timg.ImageSet.from_arrays(imgs))


def test_keras_net_takes_text_and_image_sets():
    ts = _pipeline(ttext)
    m = Sequential([TL.Embedding(40, 4, input_shape=(6,)),
                    TL.Lambda(lambda h: h.mean(1),
                              lambda s: (s[-1],)),
                    TL.Dense(3, activation="softmax")], device="cpu")
    m.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
              metrics=["accuracy"])
    x, y = ts.to_arrays()
    m.fit(ts, batch_size=2, nb_epoch=1, validation_data=ts)
    assert m.predict(ts).shape == (5, 3)
    assert np.array_equal(m.predict(ts), m.predict(x))
    assert m.evaluate(ts, batch_size=5) == m.evaluate(x, y, batch_size=5)
    im = Sequential([TL.Lambda(lambda h: h.mean((1, 2)), lambda s: (s[-1],),
                               input_shape=(20, 24, 3)),
                     TL.Dense(2, activation="softmax")], device="cpu")
    im.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")
    iset = timg.ImageSet.from_arrays(_images() / 255.0, [0, 1, 0])
    im.fit(iset, batch_size=3, nb_epoch=1)
    assert np.array_equal(im.predict(iset), im.predict(_images() / 255.0))
