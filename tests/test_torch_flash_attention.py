"""K1 (flash-attention forward) in the PyTorch port.

On the CPU: the plain version against the JAX package's Pallas kernel run in
interpret mode (out and LSE, max |diff| <= 1e-5 in f32), and the wrapper's
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


def _qkv(t, h=2, d=16, b=2, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, t, h, d)).astype(np.float32)
                 for _ in range(3))


def _jax_out_lse(q, k, v, causal, block=None):
    out, res = _flash_attention_fwd_res(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal, block, block,
                                        True)
    assert res is not None, "the JAX call fell back to full attention"
    return np.asarray(out), np.asarray(res[4])


@pytest.mark.parametrize("t", [16, 12, 37])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_jax_kernel_out_and_lse(t, causal):
    q, k, v = _qkv(t, seed=t)
    want_out, want_lse = _jax_out_lse(q, k, v, causal)
    out, lse = tfa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                         causal)
    assert lse.dtype == torch.float32 and lse.shape == (2, 2, t)
    assert float(np.abs(want_out - out.numpy()).max()) <= TOL
    assert float(np.abs(want_lse - lse.numpy()).max()) <= TOL


def test_plain_matches_jax_multi_tile_causal_skip():
    """T=64 over 16-wide JAX tiles: the reference skips future K tiles; the
    plain version must agree with that tiled result."""
    q, k, v = _qkv(64, seed=3)
    want_out, want_lse = _jax_out_lse(q, k, v, True, block=16)
    out, lse = tfa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                         True)
    assert float(np.abs(want_out - out.numpy()).max()) <= TOL
    assert float(np.abs(want_lse - lse.numpy()).max()) <= TOL


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

