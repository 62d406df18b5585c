"""The importers of the PyTorch port against the JAX package's, on the CPU:
every donor of ``tests/test_importers.py``, ``tests/test_tf_import.py`` and
``tests/test_caffe_import.py``, built the same way (the formats' own
encoders, torch modules' weights, seeded numpy), run through both
packages. Outputs are held within 1e-5 of the JAX package's (1e-4 where a
graph sums many products), codecs byte for byte; unsupported ops and
layers raise in both; ``InferenceModel.load_tf``/``load_fn``, with and
without ``quantize_int8`` (weight-only), match JAX's. The Keras H5 case
needs ``h5py`` and skips without it.
"""

import os

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu import importers as J
from analytics_zoo_tpu.importers import caffe as jcaffe
from analytics_zoo_tpu.importers import onnx_proto as jop
from analytics_zoo_tpu.importers import tf_proto as jtp
from analytics_zoo_tpu.inference import InferenceModel as JInferenceModel
from analytics_zoo_tpu.nn import layers as JL
from analytics_zoo_tpu.nn.topology import Sequential as JSequential
from analytics_zoo_tpu_torch import importers as T
from analytics_zoo_tpu_torch.importers import caffe as tcaffe
from analytics_zoo_tpu_torch.importers import onnx_proto as top
from analytics_zoo_tpu_torch.importers import tf_proto as ttp
from analytics_zoo_tpu_torch.inference.inference_model import \
    InferenceModel as TInferenceModel
from analytics_zoo_tpu_torch.nn import layers as TL
from analytics_zoo_tpu_torch.nn.topology import Sequential as TSequential

from jax.sharding import Mesh

AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")
Graph, Node, Attribute, ValueInfo = jop.Graph, jop.Node, jop.Attribute, \
    jop.ValueInfo


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape((1,) * 6), AXES)


def _ints(name, v):
    return Attribute(name=name, ints=tuple(v))


# ------------------------------------------------------------------ ONNX

def _g(name, nodes, inputs, inits=None):
    g = Graph(name=name)
    g.initializers = dict(inits or {})
    g.inputs = [ValueInfo(n, s) for n, s in inputs]
    g.outputs = [ValueInfo("y", ())]
    g.nodes = nodes
    return g


def _onnx_case(kind):
    """(graph, input) of a ``tests/test_importers.py`` donor."""
    rng = np.random.default_rng(1)
    f32 = lambda *s: rng.standard_normal(s).astype("float32")  # noqa: E731
    if kind == "mlp":
        w1, b1, w2, b2 = f32(4, 8), f32(8), f32(8, 3), f32(3)
        return _g("mlp", [
            Node("Gemm", ["x", "w1", "b1"], ["h"], "gemm1"),
            Node("Relu", ["h"], ["hr"], "relu1"),
            Node("Gemm", ["hr", "w2", "b2"], ["logits"], "gemm2"),
            Node("Softmax", ["logits"], ["y"], "sm",
                 attrs={"axis": Attribute(name="axis", i=1)})],
            [("x", (None, 4))], {"w1": w1, "b1": b1, "w2": w2,
                                 "b2": b2}), f32(5, 4)
    if kind == "conv":
        torch.manual_seed(0)
        tm = torch.nn.Sequential(
            torch.nn.Conv2d(3, 6, 3, stride=1, padding=1),
            torch.nn.BatchNorm2d(6), torch.nn.ReLU(), torch.nn.MaxPool2d(2),
            torch.nn.Conv2d(6, 4, 3, padding=0), torch.nn.ReLU()).eval()
        sd = {k: v.numpy() for k, v in tm.state_dict().items()}
        return _g("conv", [
            Node("Conv", ["x", "w0", "b0"], ["c0"], "conv0", attrs={
                "pads": _ints("pads", (1, 1, 1, 1)),
                "strides": _ints("strides", (1, 1)),
                "kernel_shape": _ints("kernel_shape", (3, 3))}),
            Node("BatchNormalization", ["c0", "bn_s", "bn_b", "bn_m",
                                        "bn_v"], ["bn"], "bn1",
                 attrs={"epsilon": Attribute(name="epsilon", f=1e-5)}),
            Node("Relu", ["bn"], ["r1"], "r1"),
            Node("MaxPool", ["r1"], ["p"], "pool", attrs={
                "kernel_shape": _ints("kernel_shape", (2, 2)),
                "strides": _ints("strides", (2, 2))}),
            Node("Conv", ["p", "w4", "b4"], ["c4"], "conv4", attrs={
                "kernel_shape": _ints("kernel_shape", (3, 3))}),
            Node("Relu", ["c4"], ["y"], "r2")],
            [("x", (None, 3, 8, 8))], {
                "w0": sd["0.weight"], "b0": sd["0.bias"],
                "bn_s": sd["1.weight"], "bn_b": sd["1.bias"],
                "bn_m": sd["1.running_mean"], "bn_v": sd["1.running_var"],
                "w4": sd["4.weight"], "b4": sd["4.bias"]}), f32(2, 3, 8, 8)
    if kind == "elementwise":
        return _g("ew", [
            Node("Mul", ["x", "two"], ["m"]), Node("Exp", ["m"], ["e"]),
            Node("Log", ["e"], ["l"]), Node("Neg", ["l"], ["n"]),
            Node("Abs", ["n"], ["a"]),
            Node("Clip", ["a"], ["y"], attrs={
                "min": Attribute(name="min", f=0.5),
                "max": Attribute(name="max", f=4.0)})],
            [("x", (None, 3))], {"two": np.asarray([2.0], "float32")}), \
            np.asarray([[0.1, 1.0, 3.0]], "float32")
    if kind == "clip_omitted_min":
        return _g("clip", [Node("Clip", ["x", "", "mx"], ["y"])],
                  [("x", (None, 3))],
                  {"mx": np.asarray(4.0, "float32")}), \
            np.asarray([[-5.0, 2.0, 9.0]], "float32")
    if kind == "average_pool_padding":
        return _g("ap", [Node("AveragePool", ["x"], ["y"], attrs={
            "kernel_shape": _ints("kernel_shape", (2, 2)),
            "strides": _ints("strides", (1, 1)),
            "pads": _ints("pads", (1, 1, 1, 1))})],
            [("x", (None, 1, 2, 2))]), f32(1, 1, 2, 2)
    if kind == "shape_chain":
        return _g("flatten_dyn", [
            Node("Shape", ["x"], ["s"]),
            Node("Gather", ["s", "idx0"], ["n"],
                 attrs={"axis": Attribute(name="axis", i=0)}),
            Node("Concat", ["n", "minus1"], ["shape"],
                 attrs={"axis": Attribute(name="axis", i=0)}),
            Node("Reshape", ["x", "shape"], ["y"])],
            [("x", (None, 2, 3, 4))],
            {"idx0": np.asarray([0], "int64"),
             "minus1": np.asarray([-1], "int64")}), \
            np.arange(48, dtype="float32").reshape(2, 2, 3, 4)
    if kind == "unsqueeze_negative":
        return _g("unsq", [Node("Unsqueeze", ["x"], ["y"], attrs={
            "axes": _ints("axes", (-1, -2))})], [("x", (3, 4))]), f32(3, 4)
    if kind == "cast_greater":
        return _g("cg", [
            Node("Greater", ["x", "thr"], ["gt"]),
            Node("Cast", ["gt"], ["y"], attrs={"to": Attribute(name="to",
                                                               i=1)})],
            [("x", (None, 4))], {"thr": np.asarray([1.0], "float32")}), \
            np.asarray([[0.5, 1.5, 1.0, 2.0]], "float32")
    if kind == "slice_steps":
        return _g("sl", [Node("Slice", ["x", "st", "en", "ax", "sp"],
                              ["y"])], [("x", (None, 6))], {
            "st": np.asarray([1], "int64"),
            "en": np.asarray([2 ** 31 - 1], "int64"),
            "ax": np.asarray([1], "int64"), "sp": np.asarray([2], "int64")}
        ), np.arange(12, dtype="float32").reshape(2, 6)
    if kind in ("lrn", "lrn_even"):
        size, alpha, beta, bias = ((3, 2e-4, 0.7, 1.5) if kind == "lrn"
                                   else (2, 1e-2, 0.75, 1.0))
        return _g(kind, [Node("LRN", ["x"], ["y"], attrs={
            "size": Attribute(name="size", i=size),
            "alpha": Attribute(name="alpha", f=alpha),
            "beta": Attribute(name="beta", f=beta),
            "bias": Attribute(name="bias", f=bias)})],
            [("x", (None, 6, 5, 5))]), f32(2, 6, 5, 5)
    if kind == "ops_zoo":
        # the executor's remaining ops in one graph
        return _g("zoo", [
            Node("Transpose", ["x"], ["t"], attrs={"perm": _ints(
                "perm", (0, 2, 1))}),
            Node("Flatten", ["t"], ["f"]),
            Node("MatMul", ["f", "w"], ["m"]),
            Node("Sub", ["m", "c"], ["s"]), Node("Div", ["s", "c"], ["d"]),
            Node("Sigmoid", ["d"], ["sg"]), Node("Tanh", ["sg"], ["th"]),
            Node("HardSigmoid", ["th"], ["hs"]),
            Node("LeakyRelu", ["d"], ["lr"]), Node("Elu", ["lr"], ["el"]),
            Node("Add", ["hs", "el"], ["ad"]), Node("Sqrt", ["c"], ["sq"]),
            Node("Pow", ["ad", "sq"], ["pw"]),
            Node("LogSoftmax", ["pw"], ["ls"]),
            Node("Unsqueeze", ["ls"], ["u"], attrs={"axes": _ints(
                "axes", (1,))}),
            Node("Squeeze", ["u"], ["q"], attrs={"axes": _ints(
                "axes", (1,))}),
            Node("ReduceMean", ["q"], ["rm"], attrs={"axes": _ints(
                "axes", (1,))}),
            Node("ReduceSum", ["q"], ["rs"]),
            Node("Identity", ["rs"], ["id"]),
            Node("Constant", [], ["k"], attrs={"value": Attribute(
                name="value", t=jop.Tensor(data=np.asarray(
                    [0.5], "float32")))}),
            Node("Mul", ["rm", "k"], ["mk"]),
            Node("Concat", ["mk", "rm"], ["y"], attrs={
                "axis": Attribute(name="axis", i=1)})],
            [("x", (None, 3, 4))], {"w": f32(12, 5),
                                    "c": np.asarray([2.0], "float32")}), \
            np.abs(f32(2, 3, 4))
    if kind == "global_pool_gemm":
        return _g("gp", [
            Node("GlobalAveragePool", ["x"], ["p"]),
            Node("Flatten", ["p"], ["f"]),
            Node("Gemm", ["f", "w", "b"], ["y"], attrs={
                "transB": Attribute(name="transB", i=1),
                "alpha": Attribute(name="alpha", f=0.5)})],
            [("x", (None, 4, 3, 3))], {"w": f32(2, 4), "b": f32(2)}), \
            f32(3, 4, 3, 3)
    raise KeyError(kind)


ONNX_CASES = ["mlp", "conv", "elementwise", "clip_omitted_min",
              "average_pool_padding", "shape_chain", "unsqueeze_negative",
              "cast_greater", "slice_steps", "lrn", "lrn_even", "ops_zoo",
              "global_pool_gemm"]


def _onnx_both(buf, x):
    jm = J.load_onnx(buf)
    jm.compile(optimizer="adam", loss="mse", mesh=_mesh())
    tm = T.load_onnx(buf, device="cpu")
    tm.compile(optimizer="adam", loss="mse")
    return np.asarray(jm.predict(x)), tm.predict(x)


@pytest.mark.parametrize("kind", ONNX_CASES)
def test_onnx_graph_matches_jax(kind):
    g, x = _onnx_case(kind)
    want, got = _onnx_both(jop.encode_model(g), x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_onnx_wire_codec_is_the_jax_codec():
    g, _ = _onnx_case("conv")
    buf = jop.encode_model(g)
    assert top.encode_model(top.decode_model(buf)) == buf
    back = top.decode_model(buf)
    assert [n.op_type for n in back.nodes] == [n.op_type for n in g.nodes]
    for k, v in g.initializers.items():
        np.testing.assert_array_equal(back.initializers[k], v)
    assert back.inputs[0].shape == (None, 3, 8, 8)
    assert back.nodes[0].attr("pads") == (1, 1, 1, 1)


def test_onnx_initializers_are_parameters():
    g, x = _onnx_case("shape_chain")
    tm = T.load_onnx(jop.encode_model(g), device="cpu")
    assert [n for n, _ in tm.named_parameters()] == []
    g, x = _onnx_case("conv")
    tm = T.load_onnx(jop.encode_model(g), device="cpu")
    names = sorted(n for n, _ in tm.named_parameters())
    assert names == sorted(f"0_onnxmodel.{k}" for k in g.initializers)
    # trainable: a step changes them
    tm.compile(optimizer="sgd", loss="mse")
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    tm.fit(x, np.zeros((2, 4, 2, 2), "float32"), batch_size=2, nb_epoch=1)
    assert any(not torch.equal(before[n], p) for n, p in
               tm.named_parameters())


@pytest.mark.parametrize("kind,err,match", [
    ("einsum", NotImplementedError, "Einsum"),
    ("cast8", ValueError, "c0.*enum 8|enum 8")])
def test_onnx_refusals_match_jax(kind, err, match):
    if kind == "einsum":
        g = _g("bad", [Node("Einsum", ["x"], ["y"])], [("x", (None, 2))])
    else:
        g = _g("badcast", [Node("Cast", ["x"], ["y"], name="c0", attrs={
            "to": Attribute(name="to", i=8)})], [("x", (None, 2))])
    buf = jop.encode_model(g)
    x = np.zeros((1, 2), "float32")
    for load, kw in ((J.load_onnx, dict(mesh=_mesh())),
                     (lambda b: T.load_onnx(b, device="cpu"), {})):
        m = load(buf)
        m.compile(optimizer="adam", loss="mse", **kw)
        with pytest.raises(err, match=match):
            m.predict(x)


# ------------------------------------------------------------- torch / keras

def _dense_pair(sizes, name_kw=False):
    """The same Dense stack in both packages (InputLayer first)."""
    def build(Seq, L, **kw):
        m = Seq(**kw) if kw else Seq()
        layers = [L.InputLayer((sizes[0],))] + [
            L.Dense(n, activation="relu" if i < len(sizes) - 2 else None)
            for i, n in enumerate(sizes[1:])]
        for layer in layers:
            m.add(layer)
        return m

    jm = build(JSequential, JL)
    jm.compile(optimizer="adam", loss="mse", mesh=_mesh())
    tm = build(TSequential, TL, device="cpu")
    tm.compile(optimizer="adam", loss="mse")
    return jm, tm


def test_torch_state_dict_and_two_pass_assignment(tmp_path):
    torch.manual_seed(1)
    src = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.ReLU(),
                              torch.nn.Linear(4, 2))
    p = str(tmp_path / "m.pt")
    torch.save(src.state_dict(), p)
    sd_j, sd_t = J.load_torch_state_dict(p), T.load_torch_state_dict(p)
    assert sorted(sd_j) == sorted(sd_t) == ["0.bias", "0.weight",
                                             "2.bias", "2.weight"]
    for k in sd_j:
        np.testing.assert_array_equal(sd_t[k], sd_j[k])
    jm, tm = _dense_pair((3, 4, 2))
    for m, assign in ((jm, J.assign_torch_weights),
                      (tm, T.assign_torch_weights)):
        assign(m, sd_t, {"1_dense/kernel": "0.weight",
                         "1_dense/bias": "0.bias"})
        assign(m, sd_t, {"2_dense/kernel": "2.weight",
                         "2_dense/bias": "2.bias"})
    x = np.random.default_rng(0).standard_normal((4, 3)).astype("float32")
    with torch.no_grad():
        want = src(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tm.predict(x), np.asarray(jm.predict(x)),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tm.predict(x), want, rtol=0, atol=1e-5)
    with pytest.raises(KeyError, match="not found"):
        T.assign_torch_weights(tm, sd_t, {"9_dense/kernel": "0.weight"})
    with pytest.raises(KeyError, match="not in checkpoint"):
        T.assign_torch_weights(tm, sd_t, {"1_dense/kernel": "nope"})
    with pytest.raises(ValueError, match="does not fit"):
        T.assign_torch_weights(tm, sd_t, {"1_dense/kernel": "2.weight"})
    with pytest.raises(RuntimeError, match="compiled"):
        T.assign_torch_weights(TSequential([TL.Dense(2, input_shape=(3,))],
                                           device="cpu"), sd_t, {})


def test_torch_conv_weights_land_hwio(tmp_path):
    conv = torch.nn.Conv2d(3, 5, 3, padding=1)
    p = str(tmp_path / "c.pth")
    torch.save({"state_dict": conv.state_dict()}, p)
    sd = T.load_torch_state_dict(p)
    tm = TSequential([TL.Convolution2D(5, 3, 3, border_mode="same",
                                       input_shape=(6, 6, 3))], device="cpu")
    tm.compile(optimizer="adam", loss="mse")
    T.assign_torch_weights(tm, sd, {"0_convolution2d/kernel": "weight",
                                    "0_convolution2d/bias": "bias"})
    x = np.random.default_rng(2).standard_normal((2, 6, 6, 3)).astype(
        "float32")
    with torch.no_grad():
        want = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()
    np.testing.assert_allclose(tm.predict(x), want, rtol=0, atol=1e-5)


def test_torch_loader_refusals(tmp_path):
    for load in (J.load_torch_state_dict, T.load_torch_state_dict):
        with pytest.raises(FileNotFoundError):
            load(str(tmp_path / "nope.pt"))
    p = str(tmp_path / "full.pt")
    torch.save(torch.nn.Linear(2, 2), p)
    with pytest.raises(ValueError, match="allow_pickle"):
        T.load_torch_state_dict(p)
    assert "weight" in T.load_torch_state_dict(p, allow_pickle=True)


def test_net_dispatch_matches_jax(tmp_path):
    p = str(tmp_path / "w.pth")
    torch.save(torch.nn.Linear(2, 2).state_dict(), p)
    assert sorted(T.Net.load(p)) == sorted(J.Net.load(p))
    for name in ("weights.h5", "frozen.pb", "model.keras", "m.onnx",
                 "m.pt", "x.txt"):
        assert T.Net._detect(name) == J.Net._detect(name)
    with pytest.raises(ValueError, match="cannot determine"):
        T.Net.load(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        T.Net.load_caffe("a.prototxt", "a.caffemodel")
    with pytest.raises(Exception):
        T.Net.load(str(tmp_path / "x.h5"), kind="keras")


def test_keras_h5_weight_donor(tmp_path):
    h5py = pytest.importorskip("h5py")
    from analytics_zoo_tpu.importers.keras_h5 import assign_keras_weights \
        as jassign
    from analytics_zoo_tpu_torch.importers.keras_h5 import \
        assign_keras_weights as tassign

    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 8)).astype("float32")
    b = rng.standard_normal(8).astype("float32")
    p = str(tmp_path / "w.h5")
    with h5py.File(p, "w") as f:
        g = f.create_group("dense_1/dense_1")
        g.create_dataset("kernel:0", data=w)
        g.create_dataset("bias:0", data=b)
    donor = T.Net.load_keras(p)
    assert sorted(donor) == sorted(J.Net.load_keras(p))
    jm, tm = _dense_pair((4, 8))
    mapping = {"1_dense/kernel": "dense_1/dense_1/kernel:0",
               "1_dense/bias": "dense_1/dense_1/bias:0"}
    jassign(jm, donor, mapping)
    tassign(tm, donor, mapping)
    x = rng.standard_normal((3, 4)).astype("float32")
    np.testing.assert_allclose(tm.predict(x), np.asarray(jm.predict(x)),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tm.predict(x), x @ w + b, rtol=0, atol=1e-5)


# -------------------------------------------------------------------- TF

def _node(pkg, name, op, inputs=(), **attrs):
    n = pkg.TFNode(name=name, op=op, inputs=list(inputs))
    for k, v in attrs.items():
        if isinstance(v, np.ndarray):
            n.attrs[k] = pkg.AttrValue(tensor=v)
        elif isinstance(v, bool):
            n.attrs[k] = pkg.AttrValue(b=v)
        elif isinstance(v, int):
            n.attrs[k] = pkg.AttrValue(i=v)
        elif isinstance(v, float):
            n.attrs[k] = pkg.AttrValue(f=v)
        elif isinstance(v, bytes):
            n.attrs[k] = pkg.AttrValue(s=v)
        else:
            n.attrs[k] = pkg.AttrValue(list_i=tuple(v))
    return n


def _mlp_weights(d_in=6, hidden=8, d_out=3):
    rng = np.random.default_rng(0)
    return (rng.standard_normal((d_in, hidden)).astype("float32"),
            rng.standard_normal(hidden).astype("float32"),
            rng.standard_normal((hidden, d_out)).astype("float32"),
            rng.standard_normal(d_out).astype("float32"))


def _mlp_graph(w1, b1, w2, b2, pkg=jtp):
    n = lambda *a, **k: _node(pkg, *a, **k)  # noqa: E731
    return pkg.TFGraph(nodes=[
        n("x", "Placeholder"), n("w1", "Const", value=w1),
        n("b1", "Const", value=b1), n("w2", "Const", value=w2),
        n("b2", "Const", value=b2), n("mm1", "MatMul", ["x", "w1"]),
        n("add1", "BiasAdd", ["mm1", "b1"]), n("relu", "Relu", ["add1"]),
        n("mm2", "MatMul", ["relu", "w2"]),
        n("logits", "BiasAdd", ["mm2", "b2"]),
        n("probs", "Softmax", ["logits"])])


def _saved_mlp(d, w1, b1, w2, b2):
    n = lambda *a, **k: _node(jtp, *a, **k)  # noqa: E731
    graph = jtp.TFGraph(nodes=[
        n("x", "Placeholder"), n("w1", "VarHandleOp"),
        n("w1/Read", "ReadVariableOp", ["w1"]), n("b1", "VarHandleOp"),
        n("b1/Read", "ReadVariableOp", ["b1"]), n("w2", "VariableV2"),
        n("b2", "VariableV2"), n("mm1", "MatMul", ["x", "w1/Read"]),
        n("add1", "BiasAdd", ["mm1", "b1/Read"]),
        n("relu", "Relu", ["add1"]), n("mm2", "MatMul", ["relu", "w2"]),
        n("logits", "BiasAdd", ["mm2", "b2"]),
        n("probs", "Softmax", ["logits"])])
    sm = jtp.SavedModel(graph=graph, signatures={
        "serving_default": jtp.SignatureDef(
            inputs={"features": "x:0"}, outputs={"probabilities":
                                                 "probs:0"})})
    os.makedirs(d)
    with open(os.path.join(d, "saved_model.pb"), "wb") as f:
        f.write(sm.encode())
    jtp.write_checkpoint_bundle(os.path.join(d, "variables", "variables"), {
        "w1/.ATTRIBUTES/VARIABLE_VALUE": w1,
        "b1/.ATTRIBUTES/VARIABLE_VALUE": b1, "w2": w2, "b2": b2})


def _tf_case(kind, tmp_path):
    """(path or graph, inputs, outputs, x) of a ``tests/test_tf_import.py``
    donor."""
    rng = np.random.default_rng(5)
    n = lambda *a, **k: _node(jtp, *a, **k)  # noqa: E731
    if kind == "conv":
        w = rng.standard_normal((3, 3, 3, 5)).astype("float32")
        b = rng.standard_normal(5).astype("float32")
        g = jtp.TFGraph(nodes=[
            n("input", "Placeholder"), n("w", "Const", value=w),
            n("b", "Const", value=b),
            n("conv", "Conv2D", ["input", "w"], strides=(1, 2, 2, 1),
              padding=b"SAME"),
            n("bias", "BiasAdd", ["conv", "b"]),
            n("act", "Relu6", ["bias"]),
            n("pool", "MaxPool", ["act"], ksize=(1, 3, 3, 1),
              strides=(1, 2, 2, 1), padding=b"SAME"),
            n("avg", "AvgPool", ["act"], ksize=(1, 3, 3, 1),
              strides=(1, 2, 2, 1), padding=b"SAME"),
            n("sum", "AddV2", ["pool", "avg"]),
            n("mean", "Mean", ["sum", "axes"], keep_dims=False),
            n("axes", "Const", value=np.asarray([1, 2], np.int32))])
        return g, ["input"], ["mean"], \
            rng.standard_normal((2, 9, 9, 3)).astype("float32")
    if kind == "depthwise_deconv":
        dw = rng.standard_normal((3, 3, 4, 2)).astype("float32")
        wt = rng.standard_normal((3, 3, 5, 8)).astype("float32")
        g = jtp.TFGraph(nodes=[
            n("x", "Placeholder"), n("dw", "Const", value=dw),
            n("wt", "Const", value=wt),
            n("d", "DepthwiseConv2dNative", ["x", "dw"],
              strides=(1, 1, 1, 1), padding=b"SAME"),
            n("shape", "Const", value=np.asarray([2, 12, 12, 5], np.int32)),
            n("up", "Conv2DBackpropInput", ["shape", "wt", "d"],
              strides=(1, 2, 2, 1), padding=b"SAME"),
            n("y", "Elu", ["up"])])
        return g, ["x"], ["y"], \
            rng.standard_normal((2, 6, 6, 4)).astype("float32")
    if kind == "strided_slice":
        g = jtp.TFGraph(nodes=[
            n("x", "Placeholder"),
            n("begin", "Const", value=np.asarray([0, 2, 0], np.int32)),
            n("end", "Const", value=np.asarray([0, 8, 0], np.int32)),
            n("strides", "Const", value=np.asarray([1, 2, 1], np.int32)),
            n("sl", "StridedSlice", ["x", "begin", "end", "strides"],
              begin_mask=0b101, end_mask=0b101),
            n("perm", "Const", value=np.asarray([0, 2, 1], np.int32)),
            n("tr", "Transpose", ["sl", "perm"]),
            n("shape", "Const", value=np.asarray([3, -1], np.int32)),
            n("flat", "Reshape", ["tr", "shape"]),
            n("out", "Tanh", ["flat"])])
        return g, ["x"], ["out"], \
            rng.standard_normal((3, 10, 4)).astype("float32")
    if kind == "fused_batchnorm":
        c = lambda v: np.asarray(v, np.float32)  # noqa: E731
        g = jtp.TFGraph(nodes=[
            n("x", "Placeholder"), n("scale", "Const", value=c([1.5, .5, 2])),
            n("bias", "Const", value=c([.1, -.2, 0])),
            n("mean", "Const", value=c([.3, -.1, .2])),
            n("var", "Const", value=c([1.2, .8, 1.])),
            n("bn", "FusedBatchNormV3", ["x", "scale", "bias", "mean",
                                         "var"], epsilon=1e-3)])
        return g, ["x"], ["bn:0", "bn:1"], \
            rng.standard_normal((2, 4, 4, 3)).astype("float32")
    if kind == "ops_zoo":
        c = lambda v, t=np.int32: np.asarray(v, t)  # noqa: E731
        g = jtp.TFGraph(nodes=[
            n("x", "Placeholder"), n("two", "Const", value=c(2.0,
                                                             np.float32)),
            n("sq", "SquaredDifference", ["x", "two"]),
            n("rs", "Rsqrt", ["sq"]), n("mx", "Maximum", ["rs", "two"]),
            n("mn", "Minimum", ["mx", "x"]), n("ab", "Abs", ["mn"]),
            n("sp", "Softplus", ["ab"]), n("er", "Erf", ["sp"]),
            n("ax", "Const", value=c(1)),
            n("ex", "ExpandDims", ["er", "ax"]),
            n("sqz", "Squeeze", ["ex"], squeeze_dims=(1,)),
            n("pk", "Pack", ["sqz", "x"], axis=1),
            n("up", "Unpack", ["pk"], axis=1, num=2),
            n("cat", "ConcatV2", ["up", "up:1", "cax"]),
            n("cax", "Const", value=c(1)),
            n("pads", "Const", value=c([[0, 0], [1, 2]])),
            n("pd", "Pad", ["cat", "pads"]),
            n("bg", "Const", value=c([0, 1])),
            n("sz", "Const", value=c([-1, 5])),
            n("sl", "Slice", ["pd", "bg", "sz"]),
            n("ga", "GatherV2", ["sl", "idx", "gax"]),
            n("idx", "Const", value=c([4, 0, 2])),
            n("gax", "Const", value=c(1)),
            n("rd", "Const", value=c([1])),
            n("pr", "Prod", ["ga", "rd"], keep_dims=True),
            n("amx", "Max", ["ga", "rd"], keep_dims=True),
            n("gt", "Greater", ["pr", "amx"]),
            n("sel", "SelectV2", ["gt", "pr", "amx"]),
            n("tl", "Tile", ["sel", "mult"]),
            n("mult", "Const", value=c([1, 3])),
            n("y", "Sigmoid", ["tl"])])
        return g, ["x"], ["y"], \
            rng.standard_normal((4, 3)).astype("float32")
    if kind == "placeholder_with_default":
        g = jtp.TFGraph(nodes=[
            n("dflt", "Const", value=np.ones((2, 3), np.float32)),
            n("x", "PlaceholderWithDefault", ["dflt"]),
            n("y", "Mul", ["x", "x"])])
        return g, None, None, np.full((2, 3), 3.0, np.float32)
    raise KeyError(kind)


TF_CASES = ["conv", "depthwise_deconv", "strided_slice", "fused_batchnorm",
            "ops_zoo", "placeholder_with_default"]


@pytest.mark.parametrize("kind", TF_CASES)
def test_tf_frozen_graph_matches_jax(kind, tmp_path):
    g, ins, outs, x = _tf_case(kind, tmp_path)
    path = str(tmp_path / f"{kind}.pb")
    with open(path, "wb") as f:
        f.write(g.encode())
    jnet = J.from_frozen_graph(path, ins, outs)
    tnet = T.from_frozen_graph(path, ins, outs, device="cpu")
    assert tnet.input_names == jnet.input_names
    assert tnet.output_names == jnet.output_names
    assert tnet.ops_used == jnet.ops_used
    want, got = jnet.predict(x), tnet.predict(x)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for w, o in zip(want, got):
        assert o.shape == np.asarray(w).shape
        np.testing.assert_allclose(o, np.asarray(w), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="inputs"):
        tnet.predict(x, x)


def test_tf_mlp_and_saved_model_match_jax(tmp_path):
    w = _mlp_weights()
    path = str(tmp_path / "model.pb")
    with open(path, "wb") as f:
        f.write(_mlp_graph(*w).encode())
    x = np.random.default_rng(1).standard_normal((5, 6)).astype("float32")
    want = np.asarray(J.from_frozen_graph(path).predict(x))
    net = T.Net.load(path, device="cpu")
    assert net.input_names == ["x"] and net.output_names == ["probs"]
    np.testing.assert_allclose(net.predict(x), want, rtol=0, atol=1e-5)
    d = str(tmp_path / "saved")
    _saved_mlp(d, *w)
    tnet = T.Net.load(d, device="cpu")
    assert sorted(tnet.variables) == ["b1", "b2", "w1", "w2"]
    np.testing.assert_allclose(tnet.predict(x), np.asarray(
        J.from_saved_model(d).predict(x)), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tnet.predict(features=x), want, rtol=0,
                               atol=1e-5)


def test_tf_saved_model_binds_by_arg_name_and_refuses(tmp_path):
    n = lambda *a, **k: _node(ttp, *a, **k)  # noqa: E731
    graph = ttp.TFGraph(nodes=[n("input_1", "Placeholder"),
                               n("input_2", "Placeholder"),
                               n("diff", "Sub", ["input_2", "input_1"])])
    sm = ttp.SavedModel(graph=graph, signatures={
        "serving_default": ttp.SignatureDef(
            inputs={"image": "input_2:0", "mask": "input_1:0"},
            outputs={"out": "diff:0"})})
    d = tmp_path / "mi"
    os.makedirs(d)
    with open(d / "saved_model.pb", "wb") as f:
        f.write(sm.encode())
    net = T.from_saved_model(str(d), device="cpu")
    assert net.input_args == J.from_saved_model(str(d)).input_args == [
        "image", "mask"]
    image, mask = np.full((2, 2), 5.0, np.float32), np.ones((2, 2),
                                                           np.float32)
    np.testing.assert_allclose(net.predict(image, mask), image - mask)
    np.testing.assert_allclose(net.predict(mask=mask, image=image),
                               image - mask)
    with pytest.raises(KeyError, match="mask"):
        net.predict(image=image)
    with pytest.raises(KeyError, match="signature"):
        T.from_saved_model(str(d), signature="other", device="cpu")
    # a variable the bundle lacks
    graph = ttp.TFGraph(nodes=[n("x", "Placeholder"),
                               n("w1", "VariableV2"),
                               n("y", "MatMul", ["x", "w1"])])
    d = tmp_path / "sm"
    os.makedirs(d)
    with open(d / "saved_model.pb", "wb") as f:
        f.write(ttp.SavedModel(graph=graph).encode())
    ttp.write_checkpoint_bundle(str(d / "variables" / "variables"),
                                {"other": np.ones((2, 2), np.float32)})
    for load in (J.from_saved_model,
                 lambda p: T.from_saved_model(p, device="cpu")):
        with pytest.raises(KeyError, match="w1"):
            load(str(d))
    # an op neither executor has
    g = ttp.TFGraph(nodes=[n("x", "Placeholder"),
                           n("y", "SparseTensorDenseMatMul", ["x"])])
    with pytest.raises(NotImplementedError, match="SparseTensorDenseMatMul"):
        T.TFNet(g, ["x"], ["y"], device="cpu").predict(np.zeros((2, 2),
                                                                np.float32))


def test_tf_codecs_are_the_jax_codecs(tmp_path):
    rng = np.random.default_rng(2)
    tensors = {"dense/kernel": rng.standard_normal((4, 7)).astype("float32"),
               "dense/bias": rng.standard_normal(7).astype("float32"),
               "step": np.asarray(42, dtype=np.int64),
               "embed": rng.standard_normal((10, 3)).astype("float64")}
    for writer, reader in ((jtp, ttp), (ttp, jtp)):
        prefix = str(tmp_path / writer.__name__.split(".")[0] / "variables")
        writer.write_checkpoint_bundle(prefix, tensors)
        back = reader.read_checkpoint_bundle(prefix)
        assert set(back) == set(tensors)
        for k in tensors:
            np.testing.assert_array_equal(back[k], tensors[k])
            assert back[k].dtype == tensors[k].dtype
    donor = T.Net.load_tf(prefix)
    np.testing.assert_array_equal(donor["dense/kernel"],
                                  tensors["dense/kernel"])
    g = _mlp_graph(*_mlp_weights(), pkg=jtp)
    assert ttp.TFGraph.decode(g.encode()).encode() == g.encode()


@pytest.mark.parametrize("dtype", ["bfloat16", "half"])
def test_tf_16_bit_tensors_decode_without_ml_dtypes(dtype):
    """DT_BFLOAT16 tensors widen to float32 (exactly), DT_HALF ones are
    numpy's float16: the values the JAX package's ``ml_dtypes`` arrays
    hold."""
    vals = np.asarray([[1.5, -2.25, 3.0e-3], [65504.0 if dtype == "half"
                                               else 1e30, 0.0, -0.0]])
    if dtype == "half":
        raw, code = vals.astype(np.float16).tobytes(), jtp.TF_HALF
    else:
        bits = (vals.astype(np.float32).view(np.uint32) >> 16).astype(
            np.uint16)
        raw, code = bits.tobytes(), jtp.TF_BFLOAT16
    buf = (jop._vi(1, code) + jop._ld(2, jtp._encode_shape(vals.shape))
           + jop._ld(4, raw))
    want = jtp.decode_tf_tensor(buf)
    got = ttp.decode_tf_tensor(buf)
    assert got.shape == want.shape == (2, 3)
    np.testing.assert_array_equal(got.astype(np.float32),
                                  np.asarray(want, np.float32))
    if dtype == "half":
        assert got.dtype == np.float16


@pytest.mark.parametrize("kind", ["frozen", "saved"])
@pytest.mark.parametrize("int8", [False, True])
def test_inference_model_load_tf_matches_jax(kind, int8, tmp_path):
    w = _mlp_weights(d_in=64, hidden=128, d_out=64)
    if kind == "frozen":
        path = str(tmp_path / "m.pb")
        with open(path, "wb") as f:
            f.write(_mlp_graph(*w).encode())
    else:
        path = str(tmp_path / "saved")
        _saved_mlp(path, *w)
    jim = JInferenceModel().load_tf(path)
    tim = TInferenceModel(device="cpu").load_tf(path)
    if int8:
        jim.quantize_int8()
        tim.quantize_int8()
        assert sorted(tim._wo_packed) == ([] if kind == "frozen" else
                                          ["w1", "w2"])
    x = np.random.default_rng(7).standard_normal((5, 64)).astype("float32")
    np.testing.assert_allclose(tim.predict(x), np.asarray(jim.predict(x)),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("int8", [False, True])
def test_inference_model_load_fn_matches_jax(int8):
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    params = {"dense": {"kernel": rng.standard_normal((64, 96)).astype(
        "float32"), "bias": rng.standard_normal(96).astype("float32")},
        "scale": np.asarray(0.5, np.float32)}
    state = {"shift": np.asarray(0.25, np.float32)}

    def jfn(p, s, x):
        return jnp.tanh(x @ p["dense"]["kernel"] + p["dense"]["bias"]) \
            * p["scale"] + s["shift"]

    def tfn(p, s, x):
        return torch.tanh(x @ p["dense"]["kernel"] + p["dense"]["bias"]) \
            * p["scale"] + s["shift"]

    jim = JInferenceModel().load_fn(jfn, params, state)
    tim = TInferenceModel(device="cpu").load_fn(tfn, params, state)
    assert tim.load_names == ["dense.bias", "dense.kernel", "scale"]
    if int8:
        jim.quantize_int8()
        tim.quantize_int8()
        assert sorted(tim._wo_packed) == ["dense.kernel"]
    x = rng.standard_normal((6, 64)).astype("float32")
    np.testing.assert_allclose(tim.predict(x), np.asarray(jim.predict(x)),
                               rtol=0, atol=1e-5)


# ----------------------------------------------------------------- Caffe

LENET = """
name: "MiniLeNet"
layer { name: "data" type: "Input" top: "data"
        input_param { shape { dim: 1 dim: 3 dim: 12 dim: 12 } } }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
        convolution_param { num_output: 6 kernel_size: 3 stride: 1 pad: 1 } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
        pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "ip1" type: "InnerProduct" bottom: "pool1" top: "ip1"
        inner_product_param { num_output: 4 } }
layer { name: "prob" type: "Softmax" bottom: "ip1" top: "prob" }
"""


def _caffe_case(kind):
    """(prototxt, blobs, input) of a ``tests/test_caffe_import.py``
    donor."""
    rng = np.random.default_rng(4)
    f32 = lambda *s: rng.standard_normal(s).astype("float32")  # noqa: E731
    if kind == "lenet":
        return LENET, {"conv1": [f32(6, 3, 3, 3), f32(6)],
                       "ip1": [f32(4, 216), f32(4)]}, f32(2, 3, 12, 12)
    if kind == "bn_scale_eltwise_concat":
        return """
input: "data"
layer { name: "bn" type: "BatchNorm" bottom: "data" top: "bn"
        batch_norm_param { eps: 0.001 } }
layer { name: "sc" type: "Scale" bottom: "bn" top: "sc"
        scale_param { bias_term: true } }
layer { name: "sum" type: "Eltwise" bottom: "sc" bottom: "data" top: "sum" }
layer { name: "mx" type: "Eltwise" bottom: "sum" bottom: "data" top: "mx"
        eltwise_param { operation: MAX } }
layer { name: "cat" type: "Concat" bottom: "mx" bottom: "data" top: "cat" }
""", {"bn": [f32(3) * 2, np.abs(f32(3)) * 2 + 1, np.asarray([2.0],
                                                          np.float32)],
      "sc": [f32(3), f32(3)]}, f32(2, 3, 4, 4)
    if kind == "ceil_pooling":
        return """
input: "data"
layer { name: "p" type: "Pooling" bottom: "data" top: "p"
        pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "a" type: "Pooling" bottom: "data" top: "a"
        pooling_param { pool: AVE kernel_size: 3 stride: 2 pad: 1 } }
""", {}, f32(1, 2, 7, 7)
    if kind == "ave_global_and_deconv":
        return """
input: "data"
layer { name: "g" type: "Pooling" bottom: "data" top: "g"
        pooling_param { pool: AVE global_pooling: true } }
layer { name: "up" type: "Deconvolution" bottom: "data" top: "up"
        convolution_param { num_output: 5 kernel_size: 3 stride: 2 pad: 1 } }
""", {"up": [f32(3, 5, 3, 3), f32(5)]}, f32(2, 3, 6, 6)
    if kind == "grouped_deconv":
        return """
input: "data"
layer { name: "up" type: "Deconvolution" bottom: "data" top: "up"
        convolution_param { num_output: 3 group: 3 kernel_size: 4 stride: 2
                            pad: 1 bias_term: false } }
""", {"up": [f32(3, 1, 4, 4)]}, f32(1, 3, 5, 5)
    if kind == "elementwise_zoo":
        return """
input: "data"
layer { name: "pw" type: "Power" bottom: "data" top: "pw"
        power_param { power: 2.0 scale: 0.5 shift: 1.0 } }
layer { name: "lg" type: "Log" bottom: "pw" top: "lg" }
layer { name: "ab" type: "AbsVal" bottom: "lg" top: "ab" }
layer { name: "ex" type: "Exp" bottom: "ab" top: "ex"
        exp_param { base: 2.0 scale: 0.5 } }
layer { name: "el" type: "ELU" bottom: "ex" top: "el" }
layer { name: "pr" type: "PReLU" bottom: "el" top: "pr" }
layer { name: "sg" type: "Sigmoid" bottom: "pr" top: "sg" }
layer { name: "th" type: "TanH" bottom: "sg" top: "th" }
layer { name: "rl" type: "ReLU" bottom: "th" top: "rl"
        relu_param { negative_slope: 0.1 } }
layer { name: "tt" type: "Threshold" bottom: "rl" top: "tt"
        threshold_param { threshold: 0.5 } }
layer { name: "bi" type: "Bias" bottom: "tt" top: "bi" }
layer { name: "fl" type: "Flatten" bottom: "bi" top: "fl" }
layer { name: "rs" type: "Reshape" bottom: "fl" top: "rs"
        reshape_param { shape { dim: 0 dim: 3 dim: -1 } } }
layer { name: "tl" type: "Tile" bottom: "rs" top: "tl"
        tile_param { axis: 1 tiles: 2 } }
layer { name: "sm" type: "Softmax" bottom: "tl" top: "sm"
        softmax_param { axis: 2 } }
""", {"pr": [np.asarray([0.1, 0.2, 0.3], np.float32)],
      "bi": [np.asarray([1.0, -1.0, 0.5], np.float32)]}, \
            rng.uniform(0.5, 1.5, (2, 3, 4, 4)).astype("float32")
    if kind == "slice_split_lrn":
        return """
input: "data"
layer { name: "sl" type: "Slice" bottom: "data" top: "a" top: "b"
        slice_param { axis: 1 slice_point: 2 } }
layer { name: "sp" type: "Split" bottom: "b" top: "b1" top: "b2" }
layer { name: "lrn" type: "LRN" bottom: "b1" top: "lrn"
        lrn_param { local_size: 3 alpha: 0.9 beta: 0.75 } }
layer { name: "lrw" type: "LRN" bottom: "b2" top: "lrw"
        lrn_param { local_size: 3 alpha: 0.5 norm_region: WITHIN_CHANNEL } }
""", {}, f32(2, 6, 4, 4)
    raise KeyError(kind)


CAFFE_CASES = ["lenet", "bn_scale_eltwise_concat", "ceil_pooling",
               "ave_global_and_deconv", "grouped_deconv", "elementwise_zoo",
               "slice_split_lrn"]


@pytest.mark.parametrize("kind", CAFFE_CASES)
def test_caffe_net_matches_jax(kind, tmp_path):
    proto, blobs, x = _caffe_case(kind)
    p = tmp_path / "n.prototxt"
    p.write_text(proto)
    w = tmp_path / "n.caffemodel"
    w.write_bytes(jcaffe.encode_caffemodel(blobs))
    jm = J.load_caffe(str(p), str(w))
    tm = T.load_caffe(str(p), str(w), device="cpu")
    assert tm.input_names == jm.input_names
    assert tm.output_names == jm.output_names
    want, got = jm.predict(x), tm.predict(x)
    want = want if isinstance(want, list) else [want]
    got = got if isinstance(got, list) else [got]
    assert len(got) == len(want)
    for o, wv in zip(got, want):
        assert o.shape == np.asarray(wv).shape
        np.testing.assert_allclose(o, np.asarray(wv), rtol=0, atol=1e-4)


def test_caffe_codecs_are_the_jax_codecs():
    assert tcaffe.parse_prototxt(LENET) == jcaffe.parse_prototxt(LENET)
    _, blobs, _ = _caffe_case("lenet")
    buf = jcaffe.encode_caffemodel(blobs)
    assert tcaffe.encode_caffemodel(blobs) == buf
    back = tcaffe.decode_caffemodel(buf)
    for k in blobs:
        for a, b in zip(blobs[k], back[k]):
            np.testing.assert_array_equal(a, b)
    assert tcaffe._ceil_pool_pads(7, 2, 2, 0) == \
        jcaffe._ceil_pool_pads(7, 2, 2, 0) == (0, 1)


def test_caffe_two_bottom_scale_gradients_and_refusals(tmp_path):
    rng = np.random.default_rng(7)
    net = tcaffe.parse_prototxt('input: "x"\ninput: "s"\nlayer { name: '
                                '"sc" type: "Scale" bottom: "x" bottom: '
                                '"s" top: "y" }')
    x = rng.standard_normal((1, 3, 5, 5)).astype("float32")
    s = rng.standard_normal(3).astype("float32")
    got = tcaffe.CaffeModel(net, {}, device="cpu").predict([x, s])
    np.testing.assert_allclose(got, np.asarray(jcaffe.CaffeModel(
        jcaffe.parse_prototxt('input: "x"\ninput: "s"\nlayer { name: "sc" '
                              'type: "Scale" bottom: "x" bottom: "s" top: '
                              '"y" }'), {}).predict([x, s])), rtol=0,
        atol=1e-6)
    # the blobs are trainable parameters: gradients reach them
    proto, blobs, xl = _caffe_case("lenet")
    p = tmp_path / "l.prototxt"
    p.write_text(proto)
    w = tmp_path / "l.caffemodel"
    w.write_bytes(tcaffe.encode_caffemodel(blobs))
    tm = T.Net.load_caffe(str(p), str(w), device="cpu")
    assert sorted(n for n, _ in tm.named_parameters()) == [
        "conv1.0", "conv1.1", "ip1.0", "ip1.1"]
    # (a softmax's plain sum is constant: weight the classes)
    (tm.apply(torch.from_numpy(xl)) * torch.arange(4.0)).sum().backward()
    assert float(tm.conv1._parameters["0"].grad.abs().max()) > 0
    bad = tcaffe.parse_prototxt('input: "x"\nlayer { name: "r" type: '
                                '"LSTM" bottom: "x" top: "r" }')
    with pytest.raises(NotImplementedError, match="LSTM"):
        tcaffe.CaffeModel(bad, {}, device="cpu").predict(
            np.zeros((1, 2), np.float32))
