"""The port's InferenceModel on the CPU: the bucket ladder with padding and
slicing, chunking above ``max_batch_size``, the concurrency bound,
``quantize_int8``'s choice of slots against the JAX package's, and the
int8 MLP (two K-segments per row) against the JAX InferenceModel on the
TPU's route within 1e-4 with the same argmax."""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.inference import InferenceModel as JaxInferenceModel
from analytics_zoo_tpu.inference.inference_model import \
    _quantize_module_params as jax_quantize_module_params
from analytics_zoo_tpu.nn import layers as JL
from analytics_zoo_tpu.nn.graph import Input as JaxInput
from analytics_zoo_tpu.nn.topology import Model as JaxModel
from analytics_zoo_tpu.nn.topology import Sequential as JaxSequential
from analytics_zoo_tpu.ops import int8_fused as jfused
from analytics_zoo_tpu.ops import tuning
from analytics_zoo_tpu_torch.inference import inference_model as tim
from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
from analytics_zoo_tpu_torch.nn import layers as TL
from analytics_zoo_tpu_torch.nn.graph import Input
from analytics_zoo_tpu_torch.nn.topology import Model, Sequential
from analytics_zoo_tpu_torch.ops import int8_fused as tfused


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mlp(hidden=16, classes=4, seed=0):
    return Sequential([TL.Dense(hidden, activation="relu",
                                input_shape=(hidden,)),
                       TL.Dense(classes, activation="softmax")],
                      device="cpu", seed=seed)


def test_bucket_ladder_pads_and_slices():
    assert tim._buckets(32) == [1, 2, 4, 8, 16, 32]
    assert tim._buckets(24) == [1, 2, 4, 8, 16, 24]
    assert tim._buckets(1) == [1]
    m = _mlp()
    im = InferenceModel(max_batch_size=32, device="cpu").load(m)
    x = np.random.default_rng(0).normal(size=(5, 16)).astype(np.float32)
    seen = []
    m.register_forward_pre_hook(lambda mod, a: seen.append(a[0].shape[0]))
    y = im.predict(x)
    assert seen == [8] and y.shape == (5, 4)
    with torch.no_grad():
        want = m.apply(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, want, rtol=1e-6, atol=1e-7)
    im.predict(x[:1])
    im.predict(x)
    assert im.compile_stats() == {"compiled_shapes": 2, "compiles": 2,
                                  "cache_hits": 1, "quantize_seconds": 0.0}


def test_requests_above_max_batch_run_in_chunks():
    m = _mlp(seed=1)
    im = InferenceModel(max_batch_size=8, device="cpu").load(m)
    seen = []
    m.register_forward_pre_hook(lambda mod, a: seen.append(a[0].shape[0]))
    x = np.random.default_rng(1).normal(size=(20, 16)).astype(np.float32)
    y = im.predict(x)
    assert seen == [8, 8, 4] and y.shape == (20, 4)
    with torch.no_grad():
        want = m.apply(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, want, rtol=1e-6, atol=1e-7)
    fetch = im.predict_async(x[:3])
    np.testing.assert_allclose(fetch(), want[:3], rtol=1e-6, atol=1e-7)
    assert im._borrowed == 0


def test_concurrency_is_bounded():
    """Eight threads, three slots: never more than three predicts inside,
    and the bound is reached."""
    m = _mlp()

    def slow(mod, args):
        time.sleep(0.02)

    m.register_forward_pre_hook(slow)
    im = InferenceModel(supported_concurrent_num=3, max_batch_size=4,
                        device="cpu").load(m)
    x = np.ones((2, 16), np.float32)
    errors = []

    def worker():
        try:
            for _ in range(5):
                im.predict(x)
        except Exception as e:           # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors
    assert 2 <= im.borrowed_peak <= 3 and im._borrowed == 0


def _pair_models(seed=0):
    """The same graph in both packages: a Dense at exactly 4096 elements,
    one below, a conv branch, and a nested Sequential."""
    def build(L, In, Mod, Seq, **kw):
        inp = In((8, 8, 4))
        a = L.Convolution2D(16, 3, 3, border_mode="same")(inp)     # 576
        a = L.Convolution2D(32, 3, 3, border_mode="same")(a)       # 4608
        a = L.GlobalAveragePooling2D()(a)
        b = L.Dense(128)(a)                                        # 4096
        c = L.Dense(127)(a)                                        # 4064
        sub = Seq([L.Dense(64, input_shape=(255,)),                # 16320
                   L.Dense(3)], **kw)                              # 192
        out = sub(L.Merge(mode="concat")([b, c]))
        return Mod(inp, out, **kw)

    jm = build(JL, JaxInput, JaxModel, JaxSequential)
    tm = build(TL, Input, Model, Sequential, device="cpu")
    params, state = jm.build(jax.random.PRNGKey(seed))
    return jm, _np(params), _np(state), tm


def _jax_packed_slots(module, params, min_elements, prefix=""):
    out, _ = jax_quantize_module_params(module, params, min_elements)
    slots = []
    for layer in module.layers:
        slot = module.slot(layer)
        if hasattr(layer, "layers") and hasattr(layer, "slot"):
            slots += _jax_packed_slots(layer, params[slot], min_elements,
                                       f"{prefix}{slot}.")
        elif isinstance(out.get(slot), dict) and isinstance(
                out[slot].get("kernel"), dict):
            slots.append(prefix + slot)
    return slots


@pytest.mark.parametrize("min_elements", [4096, 4097, 4608, 1, 20000])
def test_quantize_int8_packs_the_slots_jax_packs(min_elements):
    jm, params, state, tm = _pair_models()
    want = _jax_packed_slots(jm, params, min_elements)
    im = InferenceModel(device="cpu").load(tm, params, state)
    im.quantize_int8(min_elements)
    # no int8-computable slot at this floor: both packages pack weight-only
    assert im.packed_slots == want
    x = np.random.default_rng(2).normal(size=(3, 8, 8, 4)).astype(np.float32)
    jim = JaxInferenceModel(max_batch_size=4).load(jm, params, state)
    np.testing.assert_allclose(im.predict(x),
                               jim.quantize_int8(min_elements).predict(x),
                               rtol=1e-5, atol=1e-5)


def test_int8_mlp_matches_jax_on_the_tpu_route(tmp_path, monkeypatch):
    """Hidden 1024, batch 8: resolve_blocks gives block_k 512, so every row
    has two K-segments with their own scales — the port must follow the
    fused route's block_k, not the lax route's whole-row scale."""
    monkeypatch.setenv("ZOO_INT8_FUSED", "interpret")
    monkeypatch.setattr(jfused, "_MIN_INTERPRET", 128)
    monkeypatch.setenv("ZOO_TPU_TUNING_CACHE", str(tmp_path / "t.json"))
    for ax in "MNK":
        monkeypatch.delenv(f"ZOO_INT8_BLOCK_{ax}", raising=False)
    tuning.invalidate()
    hidden, classes = 1024, 128
    assert tfused.resolve_blocks(8, hidden, hidden)[2] == 512
    jm = JaxSequential([JL.Dense(hidden, activation="relu",
                                 input_shape=(hidden,)),
                        JL.Dense(hidden, activation="relu"),
                        JL.Dense(classes, activation="softmax")])
    params, state = jm.build(jax.random.PRNGKey(0))
    params = _np(params)
    x = np.random.default_rng(3).normal(size=(8, hidden)).astype(np.float32)
    want = JaxInferenceModel(max_batch_size=8).load(
        jm, params, state).quantize_int8().predict(x)
    tuning.invalidate()
    tm = Sequential([TL.Dense(hidden, activation="relu",
                              input_shape=(hidden,)),
                     TL.Dense(hidden, activation="relu"),
                     TL.Dense(classes, activation="softmax")], device="cpu")
    im = InferenceModel(max_batch_size=8, device="cpu").load(tm, params)
    got = im.quantize_int8().predict(x)
    assert im.packed_slots == ["0_dense", "1_dense", "2_dense"]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))
    # the whole-row (lax) scales would give other numbers
    layer = tm.layers[0]
    xt = torch.from_numpy(x)
    fused = tfused.int8_matmul_fused(xt, layer.packed_kernel, 512, "fused")
    lax = tfused.int8_matmul_fused(xt, layer.packed_kernel, hidden, "lax")
    assert float((fused - lax).abs().max()) > 1e-4


def test_multi_input_model_and_warm_up():
    a, b = Input((3,)), Input((5,))
    out = TL.Dense(2)(TL.Merge(mode="concat")([a, b]))
    m = Model([a, b], out, device="cpu")
    im = InferenceModel(max_batch_size=8, device="cpu").load(m)
    rng = np.random.default_rng(4)
    xa, xb = (rng.normal(size=(6, n)).astype(np.float32) for n in (3, 5))
    im.warm_up([xa, xb])
    assert im.compile_stats()["compiled_shapes"] == len(tim._buckets(8))
    y = im.predict([xa, xb])
    with torch.no_grad():
        want = m.apply([torch.from_numpy(xa), torch.from_numpy(xb)])
    np.testing.assert_allclose(y, want.numpy(), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="batch dimension"):
        im.predict([xa, xb[:2]])


def test_device_apply_runs_the_quantized_forward():
    m = Sequential([TL.Dense(128, activation="relu", input_shape=(64,)),
                    TL.Dense(4)], device="cpu")
    im = InferenceModel(device="cpu").load(m).quantize_int8()
    fn, params, state = im.device_apply()
    assert "0_dense.kernel_q" in params and params["0_dense.kernel_q"].dtype \
        == torch.int8 and "0_dense.kernel" not in params
    x = np.random.default_rng(5).normal(size=(3, 64)).astype(np.float32)
    np.testing.assert_array_equal(
        fn(params, state, torch.from_numpy(x)).numpy(), im.predict(x))


_LOADERS = (lambda im: im.load_tf("p"),
            lambda im: im.load_fn(lambda p, s, x: x * 2.0, {}))


@pytest.mark.parametrize("call", list(_LOADERS) + [
    lambda im: im.check_fused_dispatch(np.ones((1, 16), np.float32)),
    lambda im: im.check_memory(np.ones((1, 16), np.float32)),
    lambda im: im.warm_up(np.ones((1, 16), np.float32), graph_checks="warn")])
def test_unported_paths_raise_naming_roadmap(call):
    """The model loaders are ported: ``load_tf`` of a missing file raises
    FileNotFoundError and ``load_fn`` serves its function
    (``tests/test_torch_importers.py`` holds both to the JAX package); the
    graph checks find nothing on a clean float model."""
    im = InferenceModel(device="cpu").load(_mlp())
    if call is _LOADERS[0]:
        with pytest.raises(FileNotFoundError):
            call(im)
    elif call is _LOADERS[1]:
        call(im)
        x = np.ones((2, 16), np.float32)
        np.testing.assert_array_equal(im.predict(x), 2 * x)
    else:
        assert call(im) in ([], None)


def test_quantize_guards():
    im = InferenceModel(device="cpu")
    with pytest.raises(RuntimeError, match="load a model"):
        im.quantize_int8()
    im.load(_mlp(hidden=128))
    im.quantize_int8()
    with pytest.raises(RuntimeError, match="already quantized"):
        im.quantize_int8()
