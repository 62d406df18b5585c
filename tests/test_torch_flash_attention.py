"""K1 (flash-attention forward) in the PyTorch port.

On the CPU: the plain version against the JAX package's Pallas kernel run in
interpret mode (the LSE within 1e-5; out within 1e-5 in f32 and, in bf16,
where both round the probabilities to bf16 before P·V, within 2e-2), and
the wrapper's
routing — CPU tensors take the plain version, anything else goes to the
kernel or raises. The kernel itself is held against its plain version on
the card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops.flash_attention import (_flash_attention_fwd_res,
                                                   flash_attention as jflash)
from analytics_zoo_tpu_torch.ops import _build
from analytics_zoo_tpu_torch.ops import flash_attention as tfa

TOL = 1e-5
#: (dtype name, tolerance of out): f32 agrees to rounding; a bf16 out
#: rounds P at other places in the two frameworks (the running vs the
#: final row max). The LSE is f32 from the same inputs in both: TOL.
DTYPES = [("float32", TOL), ("bfloat16", 2e-2)]


def _qkv(t, h=2, d=16, b=2, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, t, h, d)).astype(np.float32)
                 for _ in range(3))


def _jax_out_lse(q, k, v, causal, block=None, dtype="float32"):
    out, res = _flash_attention_fwd_res(
        *(jnp.asarray(x).astype(dtype) for x in (q, k, v)), causal, block,
        block, True)
    assert res is not None, "the JAX call fell back to full attention"
    assert out.dtype == dtype
    return np.asarray(out.astype(jnp.float32)), np.asarray(res[4])


def _plain_out_lse(q, k, v, causal, dtype="float32"):
    out, lse = tfa.flash_attention_plain(
        *(torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)),
        causal)
    assert out.dtype == getattr(torch, dtype) and lse.dtype == torch.float32
    return out.float().numpy(), lse.numpy()


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("t", [16, 12, 37])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_jax_kernel_out_and_lse(t, causal, dtype, tol):
    q, k, v = _qkv(t, seed=t)
    want_out, want_lse = _jax_out_lse(q, k, v, causal, dtype=dtype)
    out, lse = _plain_out_lse(q, k, v, causal, dtype)
    assert lse.shape == (2, 2, t)
    assert float(np.abs(want_out - out).max()) <= tol
    assert float(np.abs(want_lse - lse).max()) <= TOL


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_plain_matches_jax_multi_tile_causal_skip(dtype, tol):
    """T=64 over 16-wide JAX tiles: the reference skips future K tiles; the
    plain version must agree with that tiled result."""
    q, k, v = _qkv(64, seed=3)
    want_out, want_lse = _jax_out_lse(q, k, v, True, block=16, dtype=dtype)
    out, lse = _plain_out_lse(q, k, v, True, dtype)
    assert float(np.abs(want_out - out).max()) <= tol
    assert float(np.abs(want_lse - lse).max()) <= TOL


@pytest.mark.parametrize("block", [None, 16])
def test_plain_rounds_probabilities_like_jax_kernel_bf16(block):
    """Near-tied scores whose probabilities all round down in bf16: key 0
    scores 0 and the 63 others 2.5 · -1.078125 / 4, so each p = 0.50975 is
    stored as 0.50781 (-0.38%). With v = 16 everywhere, rounding P before
    P·V gives out = 15.9375, keeping it in f32 gives 16. The plain version
    must land where the JAX kernel does, in one tile and in four, and a
    softmax that does not round P must not."""
    t, h, d = 64, 2, 16
    q = np.zeros((1, t, h, d), np.float32)
    q[..., 0] = 2.5
    k = np.zeros_like(q)
    k[:, 1:, :, 0] = -1.078125
    v = np.full_like(q, 16.0)
    tol = dict(DTYPES)["bfloat16"]
    want_out, want_lse = _jax_out_lse(q, k, v, False, block=block,
                                      dtype="bfloat16")
    out, lse = _plain_out_lse(q, k, v, False, "bfloat16")
    assert float(np.abs(want_out - out).max()) <= tol
    assert float(np.abs(want_lse - lse).max()) <= TOL
    qt, kt, vt = (torch.from_numpy(x).to(torch.bfloat16).float()
                  for x in (q, k, v))
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qt, kt) / d ** 0.5, -1)
    unrounded = torch.einsum("bhqk,bkhd->bqhd", p, vt).to(torch.bfloat16)
    assert float(np.abs(want_out - unrounded.float().numpy()).max()) > tol


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [12, 24, 32, 96, 264])
def test_plain_matches_jax_kernel_at_other_head_dims(d, causal, dtype, tol):
    """Head dims besides 64 and 128 (examples/transformer_lm.py has 16,
    bench.py's small LMs 32; 12 is not a multiple of 8 and 264 is past the
    kernels' compile-time tiles): the plain version, which the card's
    kernels are held to at every head dim, agrees with the Pallas kernel
    in one tile and across 16-wide tiles."""
    q, k, v = _qkv(32, d=d, seed=d + causal)
    for block in (None, 16):
        want_out, want_lse = _jax_out_lse(q, k, v, causal, block=block,
                                          dtype=dtype)
        out, lse = _plain_out_lse(q, k, v, causal, dtype)
        assert out.shape == (2, 32, 2, d)
        assert float(np.abs(want_out - out).max()) <= tol
        assert float(np.abs(want_lse - lse).max()) <= TOL


def test_kernel_envelope_takes_every_multiple_of_8_up_to_256():
    """Every multiple of 8 from 8 to 256 at any q_len, in f32 and bf16, is
    still taken; the head dims this test once saw refused (not a multiple
    of 8, or above 256) are taken too, and only a head dim below 1, a
    q_len below 1 or another dtype is refused."""
    from analytics_zoo_tpu_torch.ops.attention import kernel_envelope

    for dtype in (torch.float32, torch.bfloat16):
        for d in range(8, 257, 8):
            for q_len in (1, 16, 17, 48, 64, 128, 2048):
                assert kernel_envelope(d, q_len, dtype) is None
        for d in [x for x in range(1, 300) if x % 8 or x > 256]:
            assert kernel_envelope(d, 1, dtype) is None, d
        assert "not positive" in kernel_envelope(0, 1, dtype)
        assert "q_len" in kernel_envelope(64, 0, dtype)
    assert "dtype" in kernel_envelope(64, 1, torch.float16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_len", [1, 17, 128, 2048])
def test_kernel_envelope_takes_every_head_dim(dtype, q_len):
    """The card's attention kernels (K1-K4) take every head dim from 1 to
    well past 512 at any q_len, as the JAX kernels take any; the
    compile-time tiles end at 256 and the wide kernels take the rest."""
    from analytics_zoo_tpu_torch.ops.attention import (TILE_MAX_HEAD_DIM,
                                                       kernel_envelope)

    assert TILE_MAX_HEAD_DIM == 256
    for d in range(1, 1025):
        assert kernel_envelope(d, q_len, dtype) is None, d
    for d in (0, -8):
        assert "not positive" in kernel_envelope(d, q_len, dtype)


def test_kernel_head_dim_pads_only_bf16_head_dims_off_the_8_grid():
    """bf16 head dims up to 256 that are not a multiple of 8 run at the
    next multiple of 8 (TMA moves whole 16-byte rows); f32, the multiples
    of 8 and the wide head dims run as they are."""
    for d in range(1, 600):
        w = tfa.kernel_head_dim(d, torch.bfloat16)
        if d % 8 and d <= 256:
            assert w % 8 == 0 and d < w < d + 8, (d, w)
        else:
            assert w == d
        assert tfa.kernel_head_dim(d, torch.float32) == d


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [4, 12, 20, 100])
def test_pad_path_slices_back_to_the_unpadded_result(d, causal):
    """The route of a bf16 head dim that is not a multiple of 8, in plain
    code: q, k, v and dO zero-padded to ``kernel_head_dim``, the forward
    and both backward halves run at the true d's scale, the outputs'
    padded columns exactly zero and their first d columns (and the LSE)
    the unpadded result's. Computed in f32, where only the summation order
    differs."""
    w = tfa.kernel_head_dim(d, torch.bfloat16)
    rng = np.random.default_rng(d)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(2, 19, 2, d)).astype(
        np.float32)) for _ in range(4))
    pad = lambda t: tfa.pad_head_dim(t, w)        # noqa: E731
    assert pad(q).shape == (2, 19, 2, w) and pad(q).is_contiguous()
    assert tfa.pad_head_dim(q, d) is q
    scale = 1.0 / np.sqrt(d)
    out, lse = tfa.flash_attention_plain(q, k, v, causal)
    out_p, lse_p = tfa.flash_attention_plain(pad(q), pad(k), pad(v), causal,
                                             scale=scale)
    delta = tfa.flash_bwd_delta(out, g)
    grads = (tfa.flash_attention_bwd_dq_plain(q, k, v, g, lse, delta, causal),
             *tfa.flash_attention_bwd_dkv_plain(q, k, v, g, lse, delta,
                                                causal))
    args = (pad(q), pad(k), pad(v), pad(g), lse, delta, causal)
    grads_p = (tfa.flash_attention_bwd_dq_plain(*args, scale=scale),
               *tfa.flash_attention_bwd_dkv_plain(*args, scale=scale))
    assert float((lse_p - lse).abs().max()) <= TOL
    for want, got in ((out, out_p), *zip(grads, grads_p)):
        assert got.shape[-1] == w
        assert float(got[..., d:].abs().max()) == 0.0
        assert float((got[..., :d] - want).abs().max()) <= TOL


def test_wrapper_on_cpu_takes_plain_version_without_launching():
    q, k, v = map(torch.from_numpy, _qkv(12, seed=4))
    before = tfa.flash_attention_fwd.launches
    out = tfa.flash_attention(q, k, v, True)
    want = jflash(*(jnp.asarray(x.numpy()) for x in (q, k, v)), True)
    assert float(np.abs(np.asarray(want) - out.numpy()).max()) <= TOL
    assert tfa.flash_attention_fwd.launches == before


def test_non_cpu_tensor_never_gets_the_plain_result(monkeypatch):
    """With the built library failing to load, a call on device tensors
    raises instead of returning the plain version's result."""
    def broken(*a, **kw):
        raise RuntimeError("nvcc failed for flash_fwd.cu")

    monkeypatch.setattr(_build, "load_library", broken)
    q = torch.empty((1, 16, 2, 64), device="meta")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tfa.flash_attention_fwd(q, q, q, True)


def test_wrapper_rejects_non_cuda_and_unsupported_inputs(monkeypatch):
    monkeypatch.setattr(_build, "load_library", lambda *a, **kw: object())
    q = torch.empty((1, 16, 2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa.flash_attention_fwd(q, q, q, True)


def test_build_without_nvcc_raises_instead_of_falling_back(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "library_path",
                        lambda name: _build.BUILD_DIR / "absent.so")
    with pytest.raises(RuntimeError, match="no nvcc"):
        _build.load_library("flash_fwd")

