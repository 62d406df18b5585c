"""Parity of the port's int8 arithmetic (``ops/int8.py``,
``ops/int8_fused.py``) with the JAX package, on the CPU.

The JAX side runs the route the TPU takes: its Pallas kernels in interpret
mode with the TPU's tiling floor (``_MIN_INTERPRET`` = 128), no tuning
cache and no block override. The port's plain versions (what its K5/K6
wrappers run for CPU tensors) must match within 1e-5 relative to
max(1, max|JAX|) in f32 and within one bf16 ulp (2^-8 relative) in bf16,
and the int8 codes must be equal where a function exposes them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import int8 as jint8
from analytics_zoo_tpu.ops import int8_fused as jfused
from analytics_zoo_tpu.ops import tuning
from analytics_zoo_tpu_torch.ops import int8 as tint8
from analytics_zoo_tpu_torch.ops import int8_fused as tfused

F32_TOL, BF16_TOL = 1e-5, 2.0 ** -8


@pytest.fixture()
def tpu_route(tmp_path, monkeypatch):
    """The JAX package routed as on the TPU: fused kernels (interpreted),
    the TPU's tiling floor, an empty tuning cache, no block override."""
    monkeypatch.setenv("ZOO_INT8_FUSED", "interpret")
    monkeypatch.setattr(jfused, "_MIN_INTERPRET", 128)
    monkeypatch.setenv("ZOO_TPU_TUNING_CACHE", str(tmp_path / "t.json"))
    for ax in "MNK":
        monkeypatch.delenv(f"ZOO_INT8_BLOCK_{ax}", raising=False)
    tuning.invalidate()
    yield
    tuning.invalidate()


def _rel(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape
    if a.size == 0:
        return 0.0
    return float(np.abs(a - b).max()) / max(1.0, float(np.abs(a).max()))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _jx(x, dtype):
    return jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16
                       else jnp.float32)


def _out(y) -> np.ndarray:
    if isinstance(y, torch.Tensor):
        return y.float().numpy()
    return np.asarray(jnp.asarray(y, jnp.float32))


def _packs(w):
    jp = jint8.quantize_weight(w)
    tp = {k: torch.from_numpy(v) for k, v in tint8.quantize_weight(w).items()}
    return jp, tp


@pytest.mark.parametrize("shape,axis", [((96, 48), -1), ((3, 3, 8, 16), -1),
                                        ((7, 7, 3, 64), -1), ((20, 30), 0)])
def test_quantize_weight_bit_identical(shape, axis):
    w = np.random.default_rng(0).normal(size=shape).astype(np.float32) * 2
    w[..., 0] = 0.0                                   # an all-zero channel
    a, b = jint8.quantize_weight(w, axis), tint8.quantize_weight(w, axis)
    assert a["q"].dtype == b["q"].dtype == np.int8
    assert np.array_equal(a["q"], b["q"])
    assert a["scale"].dtype == b["scale"].dtype
    assert np.array_equal(a["scale"], b["scale"])
    assert tint8.is_quantized(b) and not tint8.is_quantized(w)
    np.testing.assert_array_equal(
        tint8.dequantize(b).numpy(), np.asarray(jint8.dequantize(a)))


def test_resolve_blocks_is_the_tpu_decision(tpu_route):
    """Over a grid of (m, n, k), N = 1000 and 4096 among them, the port's
    pinned resolve_blocks equals JAX's at interpret=False."""
    for m in (0, 1, 7, 8, 32, 100, 2048):
        for n in (100, 128, 256, 384, 1000, 4096):
            for k in (96, 128, 512, 1000, 2048, 4096):
                want = jfused.resolve_blocks(m, n, k, jnp.float32,
                                             interpret=False)
                assert tfused.resolve_blocks(m, n, k) == want, (m, n, k)
    assert tfused.resolve_blocks(32, 1000, 2048) is None       # ResNet head
    assert tfused.resolve_blocks(2048, 4096, 4096) == (256, 256, 512)
    assert tfused.resolve_blocks(2048, 128, 4096) == (256, 128, 512)


@pytest.mark.parametrize("rule", ["fused", "lax"])
def test_activation_codes_and_scales_equal_jax(rule):
    """The codes and scales of one group: the lax rule against
    ``_quant_activations``, the fused rule against the K5 kernel's lines
    (int8_fused.py:170-173) in jnp."""
    x = (np.random.default_rng(1).normal(size=(64, 256)) * 5).astype(
        np.float32)
    x[3] = 0.0
    q, s = tint8._quant_activations(_t(x), rule=rule)
    if rule == "lax":
        jq, js = jint8._quant_activations(jnp.asarray(x))
    else:
        xf = jnp.asarray(x)
        js = jnp.maximum(jnp.max(jnp.abs(xf), axis=1, keepdims=True),
                         1e-12) * (1.0 / 127.0)
        jq = jnp.clip(jnp.round(xf / js), -127, 127).astype(jnp.int8)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("block_k", [128, 256, 512])
@pytest.mark.parametrize("lead", [(37,), (2, 9), (0,)])
def test_fused_matmul_plain_matches_jax_kernel(dtype, tol, block_k, lead):
    """K5's plain version against the Pallas kernel at several block_k (the
    scale-group length), f32 and bf16 x, ragged M, 3-D leading dims and
    M = 0."""
    rng = np.random.default_rng(block_k)
    jp, tp = _packs(rng.normal(size=(1024, 256)).astype(np.float32))
    x = (rng.normal(size=lead + (1024,)) * 3).astype(np.float32)
    jx = _jx(x, dtype)
    want = jfused.int8_matmul_fused(jx, jp, block_m=8, block_n=128,
                                    block_k=block_k, out_dtype=jx.dtype,
                                    interpret=True)
    got = tfused.int8_matmul_fused(_t(x, dtype), tp, block_k, "fused")
    assert got.dtype == dtype and tuple(got.shape) == lead + (256,)
    assert _rel(_out(want), _out(got)) <= tol


def test_block_k_changes_the_result():
    """The scales are per block_k segment, so another block_k gives other
    numbers: the port has to pin the TPU's."""
    rng = np.random.default_rng(2)
    _, tp = _packs(rng.normal(size=(1024, 64)).astype(np.float32))
    x = _t(rng.normal(size=(16, 1024)).astype(np.float32) * 3)
    a = tfused.int8_matmul_fused(x, tp, 512, "fused")
    b = tfused.int8_matmul_fused(x, tp, 1024, "fused")
    assert float((a - b).abs().max()) > 0.0


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("k,n", [(256, 100), (96, 48), (2048, 1000)])
def test_lax_route_matches_unfused(dtype, tol, k, n):
    """A shape that does not tile at the TPU's floors takes the lax route:
    one scale per whole row, ``/ 127``."""
    assert tfused.resolve_blocks(8, n, k) is None
    rng = np.random.default_rng(k)
    jp, tp = _packs(rng.normal(size=(k, n)).astype(np.float32))
    x = (rng.normal(size=(8, k)) * 3).astype(np.float32)
    want = jint8.int8_matmul_unfused(_jx(x, dtype), jp).astype(
        _jx(x, dtype).dtype)
    for got in (tint8.int8_matmul(_t(x, dtype), tp),
                tint8.int8_matmul_unfused(_t(x, dtype), tp)):
        assert got.dtype == dtype
        assert _rel(_out(want), _out(got)) <= tol


def test_matmul_router_routes_as_the_tpu(tpu_route):
    """The routers of both packages on a shape that tiles (fused, block_k
    512 over K = 1024) and on one that does not (N = 1000)."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(24, 1024)) * 2).astype(np.float32)
    for n in (256, 1000):
        jp, tp = _packs(rng.normal(size=(1024, n)).astype(np.float32))
        want = jint8.int8_matmul(jnp.asarray(x), jp)
        got = tint8.int8_matmul(_t(x), tp)
        assert _rel(_out(want), _out(got)) <= F32_TOL


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("k,cin,cout,padding", [
    (3, 16, 32, "SAME"), (3, 8, 16, "VALID"), (1, 32, 16, "SAME"),
    (5, 4, 8, "SAME")])
def test_fused_conv_plain_matches_jax_kernel(dtype, tol, k, cin, cout,
                                             padding):
    """K6's plain version (through the stride-1 router) against the Pallas
    conv kernel at SAME and VALID."""
    rng = np.random.default_rng(k * cin)
    jp, tp = _packs(rng.normal(size=(k, k, cin, cout)).astype(np.float32))
    x = rng.normal(size=(2, 9, 10, cin)).astype(np.float32)
    jx = _jx(x, dtype)
    want = jfused.int8_conv2d_fused(jx, jp, padding=padding,
                                    out_dtype=jx.dtype, interpret=True)
    got = tint8.int8_conv2d(_t(x, dtype), tp, strides=(1, 1),
                            padding=padding)
    assert got.dtype == dtype
    assert _rel(_out(want), _out(got)) <= tol


@pytest.mark.parametrize("k,cin,cout,hw,padding", [
    (7, 3, 16, 32, "SAME"), (1, 32, 64, 14, "SAME"), (3, 4, 8, 11, "VALID")])
def test_strided_conv_route_matches_unfused(k, cin, cout, hw, padding):
    """Stride 2 takes the lax route: the 7x7/2 stem at Cin = 3 with SAME's
    asymmetric pads, the 1x1/2 shortcut, a VALID 3x3/2."""
    rng = np.random.default_rng(hw)
    jp, tp = _packs(rng.normal(size=(k, k, cin, cout)).astype(np.float32))
    x = rng.normal(size=(2, hw, hw, cin)).astype(np.float32)
    want = jint8.int8_conv2d_unfused(jnp.asarray(x), jp, strides=(2, 2),
                                     padding=padding)
    got = tint8.int8_conv2d(_t(x), tp, strides=(2, 2), padding=padding)
    assert _rel(_out(want), _out(got)) <= F32_TOL


def test_same_pads_match_lax():
    import jax

    for size in (7, 14, 28, 56, 112, 224, 9):
        for k in (1, 3, 7):
            for s in (1, 2):
                want = jax.lax.padtype_to_pads((size, size), (k, k), (s, s),
                                               "SAME")
                got = tfused.same_pads((size, size), (k, k), (s, s))
                assert tuple(map(tuple, want)) == got
    assert tfused.same_pads((224, 224), (7, 7), (2, 2)) == ((2, 3), (2, 3))


def test_kernel_wrappers_take_the_plain_version_on_cpu_only():
    """A CPU tensor runs the plain version (no build, no launch); the rules
    and shapes are checked before anything runs."""
    rng = np.random.default_rng(4)
    _, tp = _packs(rng.normal(size=(128, 8)).astype(np.float32))
    before = tfused.int8_matmul_fused.launches
    y = tfused.int8_matmul_fused(_t(rng.normal(size=(3, 128))), tp, 128)
    assert tuple(y.shape) == (3, 8)
    assert tfused.int8_matmul_fused.launches == before
    with pytest.raises(ValueError, match="rule"):
        tfused.int8_matmul_fused_plain(_t(np.ones((3, 128))), tp, 128, "x")
    with pytest.raises(ValueError, match="divide"):
        tfused.int8_matmul_fused_plain(_t(np.ones((3, 128))), tp, 100)


@pytest.mark.parametrize("shape", [(96, 48), (4096, 128), (3, 3, 8, 16),
                                   (7, 7, 3, 64), (1, 1, 2048, 512)])
def test_kernel_major_copy_is_q_transposed(shape):
    """The kernels' weights: k contiguous, (K, N) -> (N, K) and (KH, KW,
    Cin, Cout) -> (KH, KW, Cout, Cin), the same int8 values."""
    w = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    q = torch.from_numpy(tint8.quantize_weight(w)["q"])
    qt = tfused.kernel_major(q)
    assert qt.dtype == torch.int8 and qt.is_contiguous()
    assert tuple(qt.shape) == shape[:-2] + (shape[-1], shape[-2])
    assert torch.equal(qt, q.transpose(-1, -2))
    assert torch.equal(qt.transpose(-1, -2), q)


@pytest.mark.parametrize("rule", ["fused", "lax"])
@pytest.mark.parametrize("k,g", [(1024, 512), (2048, 2048), (300, 100),
                                 (3, 3), (64, 64)])
def test_quantize_pass_layout_holds_jax_codes(rule, k, g):
    """What the kernels' quantize pass writes (``quantize_rows_plain``):
    each group's codes and scale are JAX's for that group (the lax rule's
    ``_quant_activations``; the fused rule's kernel lines), followed by
    zero codes to 32 bytes a group."""
    x = (np.random.default_rng(6).normal(size=(9, k)) * 4).astype(np.float32)
    x[2] = 0.0
    codes, scales = tfused.quantize_rows_plain(_t(x), g, rule)
    gp = tfused.depth_of(g)
    assert gp % tfused.DEPTH == 0 and gp - g < tfused.DEPTH
    assert codes.dtype == torch.int8 and tuple(codes.shape) == (9, k // g * gp)
    assert scales.dtype == torch.float32 and tuple(scales.shape) == (9, k // g)
    codes = codes.reshape(9, k // g, gp).numpy()
    assert not codes[:, :, g:].any()
    for j in range(k // g):
        xg = jnp.asarray(x[:, j * g:(j + 1) * g])
        if rule == "lax":
            jq, js = jint8._quant_activations(xg)
        else:
            js = jnp.maximum(jnp.max(jnp.abs(xg), axis=1, keepdims=True),
                             1e-12) * (1.0 / 127.0)
            jq = jnp.clip(jnp.round(xg / js), -127, 127).astype(jnp.int8)
        np.testing.assert_array_equal(codes[:, j, :g], np.asarray(jq))
        np.testing.assert_array_equal(scales[:, j:j + 1].numpy(),
                                      np.asarray(js))


@pytest.mark.parametrize("args,want", [
    ((32, 56, 56, 64, 56, 56, 3, 3, (1, 1), 1, 1), (32 * 56 * 56, 64)),
    ((32, 56, 56, 256, 28, 28, 1, 1, (2, 2), 0, 0), (32 * 28 * 28, 256)),
    ((32, 224, 224, 3, 112, 112, 7, 7, (2, 2), 2, 2), (32 * 224 * 224, 4)),
    ((2, 14, 14, 48, 14, 14, 1, 1, (1, 1), 0, 0), (2 * 14 * 14, 64)),
    ((2, 13, 13, 40, 7, 7, 1, 1, (2, 2), 0, 0), (2 * 7 * 7, 64)),
    ((2, 8, 8, 40, 9, 9, 1, 1, (1, 1), 0, 0), (2 * 8 * 8, 64)),
    ((1, 8, 8, 4, 8, 8, 1, 1, (1, 1), 0, 0), (64, 4))])
def test_conv_scratch_codes_only_the_pixels_a_1x1_reads(args, want):
    """K6's codes: a 1x1 window at Cin > 4 that reads no padding codes its
    output pixels' inputs only (a quarter at stride 2); any other conv
    (a 3x3, the Cin <= 4 stem, a 1x1 whose output reaches the padding)
    codes every input pixel. A row is Cin rounded up to 32 bytes, one word
    at Cin <= 4."""
    assert tfused.conv_scratch(*args) == want


def test_wrappers_on_cpu_give_the_same_bits_with_the_kernel_major_copy():
    """A packed dict with ``qt`` (as a packed layer passes it) runs the same
    plain arithmetic as one without."""
    rng = np.random.default_rng(8)
    _, tp = _packs(rng.normal(size=(256, 64)).astype(np.float32))
    x = _t(rng.normal(size=(5, 256)))
    with_qt = {**tp, "qt": tfused.kernel_major(tp["q"])}
    assert torch.equal(tfused.int8_matmul_fused(x, with_qt, 128),
                       tfused.int8_matmul_fused(x, tp, 128))
    _, tc = _packs(rng.normal(size=(3, 3, 8, 16)).astype(np.float32))
    xc = _t(rng.normal(size=(2, 6, 6, 8)))
    with_qt = {**tc, "qt": tfused.kernel_major(tc["q"])}
    pads = ((1, 1), (1, 1))
    assert torch.equal(tfused.int8_conv2d_fused(xc, with_qt, (1, 1), pads),
                       tfused.int8_conv2d_fused(xc, tc, (1, 1), pads))
