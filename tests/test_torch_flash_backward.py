"""K3/K4 (flash-attention backward) in the PyTorch port, on the CPU.

The plain backward (``flash_attention_bwd_plain``, what the kernels
compute) against ``jax.vjp`` through the JAX package's ``flash_attention``
with its Pallas kernels in interpret mode: single- and multi-tile blocks,
causal and not, f32 within 1e-5 and bf16 within 2e-2. For a ragged T (where
the JAX entry point falls back to full attention, and the port's kernels
mask) the reference is the VJP of JAX's ``full_attention``. The autograd
Function's grads are held to torch autograd through
``flash_attention_plain``, and the wrappers' routing is checked: CPU tensors
take the plain versions without launching, anything else launches or
raises. The kernels themselves are held to the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops.attention import full_attention as jfull
from analytics_zoo_tpu.ops.flash_attention import flash_attention as jflash
from analytics_zoo_tpu_torch.ops import _build
from analytics_zoo_tpu_torch.ops import flash_attention as tfa
from analytics_zoo_tpu_torch.ops.attention import full_attention

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
_NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _case(t, dtype="float32", h=2, d=16, b=2, seed=0, t_k=None):
    rng = np.random.default_rng(seed)
    t_k = t if t_k is None else t_k
    q = rng.normal(size=(b, t, h, d))
    k, v = (rng.normal(size=(b, t_k, h, d)) for _ in range(2))
    g = rng.normal(size=(b, t, h, d))
    return tuple(a.astype(np.float32).astype(_NP[dtype]) for a in (q, k, v, g))


def _torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(_TORCH[dtype])


def _port_grads(q, k, v, g, causal, dtype):
    q, k, v, g = (_torch(a, dtype) for a in (q, k, v, g))
    out, lse = tfa.flash_attention_plain(q, k, v, causal)
    return tfa.flash_attention_bwd_plain(q, k, v, out, lse, g, causal)


def _err(want, got):
    return float(np.abs(np.asarray(want, np.float32)
                        - got.float().numpy()).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,block", [(16, None), (32, 8)],
                         ids=["one-tile", "multi-tile"])
def test_plain_backward_matches_jax_kernel_vjp(dtype, causal, t, block):
    q, k, v, g = _case(t, dtype, seed=t + causal)
    _, vjp = jax.vjp(lambda *a: jflash(*a, causal, block, block, True),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g))
    got = _port_grads(q, k, v, g, causal, dtype)
    for w, x in zip(want, got):
        assert x.dtype == _TORCH[dtype]
        assert _err(w, x) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [12, 24, 32, 96, 264])
def test_plain_backward_matches_jax_kernel_vjp_at_other_head_dims(dtype,
                                                                  causal, d):
    """K3/K4's plain versions at head dims besides 64 and 128 (12 off the
    8 grid, 264 past the compile-time tiles), against the
    VJP through the Pallas kernels across 8-wide tiles."""
    q, k, v, g = _case(32, dtype, d=d, seed=d + causal)
    _, vjp = jax.vjp(lambda *a: jflash(*a, causal, 8, 8, True),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g))
    got = _port_grads(q, k, v, g, causal, dtype)
    for w, x in zip(want, got):
        assert x.dtype == _TORCH[dtype] and x.shape[-1] == d
        assert _err(w, x) <= TOL[dtype]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [12, 37])
def test_ragged_t_backward_matches_jax_full_attention(causal, t):
    q, k, v, g = _case(t, seed=100 + t)
    _, vjp = jax.vjp(lambda *a: jfull(*a, causal=causal),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g))
    for w, x in zip(want, _port_grads(q, k, v, g, causal, "float32")):
        assert _err(w, x) <= TOL["float32"]


@pytest.mark.parametrize("causal", [False, True])
def test_full_attention_grads_match_jax(causal):
    """The "full" strategy is differentiable and its grads are JAX's."""
    q, k, v, g = _case(12, seed=40 + causal)
    _, vjp = jax.vjp(lambda *a: jfull(*a, causal=causal),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(full_attention(*leaves, causal=causal), leaves,
                              torch.from_numpy(g))
    for w, x in zip(want, got):
        assert _err(w, x) <= TOL["float32"]


@pytest.mark.parametrize("t_q,t_k", [(12, 12), (7, 12), (12, 7)])
@pytest.mark.parametrize("causal", [False, True])
def test_function_grads_match_autograd_through_plain_forward(t_q, t_k,
                                                             causal):
    """The Function (K1 forward, K3+K4 backward; plain versions on the
    CPU) against torch autograd through the plain forward, Tq ≠ Tk aligned
    at position 0 under the causal mask."""
    q, k, v, g = (torch.from_numpy(a) for a in _case(t_q, seed=t_q + t_k,
                                                      t_k=t_k))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out, _ = tfa.flash_attention_plain(*leaves, causal)
    want = torch.autograd.grad(out, leaves, g)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(tfa.flash_attention(*leaves, causal), leaves, g)
    for w, x in zip(want, got):
        assert float((w - x).abs().max()) <= TOL["float32"]


def test_split_wrappers_equal_the_joint_backward():
    """K3's and K4's plain versions, fed δ, give the joint backward."""
    q, k, v, g = (torch.from_numpy(a) for a in _case(20, seed=5))
    out, lse = tfa.flash_attention_plain(q, k, v, True)
    delta = tfa.flash_bwd_delta(out, g)
    assert delta.shape == (2, 2, 20) and delta.is_contiguous()
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, out, lse, g, True)
    assert torch.equal(dq, tfa.flash_attention_bwd_dq(q, k, v, g, lse, delta,
                                                      True))
    for a, b in zip((dk, dv), tfa.flash_attention_bwd_dkv(q, k, v, g, lse,
                                                          delta, True)):
        assert torch.equal(a, b)


def test_cpu_backward_launches_no_kernel():
    q, k, v, g = (torch.from_numpy(a) for a in _case(16, seed=6))
    before = (tfa.flash_attention_fwd.launches,
              tfa.flash_attention_bwd_dq.launches,
              tfa.flash_attention_bwd_dkv.launches)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    torch.autograd.grad(tfa.flash_attention(*leaves, True), leaves, g)
    assert (tfa.flash_attention_fwd.launches,
            tfa.flash_attention_bwd_dq.launches,
            tfa.flash_attention_bwd_dkv.launches) == before


def test_non_cpu_tensors_never_take_the_plain_backward(monkeypatch):
    """A failed build raises for device tensors instead of returning the
    plain result; with the library 'loaded', non-CUDA tensors are
    rejected."""
    q = torch.empty((1, 16, 2, 64), device="meta")
    lse = torch.empty((1, 2, 16), device="meta")

    def broken(*a, **kw):
        raise RuntimeError("nvcc failed for flash_bwd.cu")

    monkeypatch.setattr(_build, "load_library", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tfa.flash_attention_bwd(q, q, q, q, lse, q, True)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tfa.flash_attention_bwd_dq(q, q, q, q, lse, lse, True)
    monkeypatch.setattr(_build, "load_library", lambda *a, **kw: object())
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa.flash_attention_bwd_dkv(q, q, q, q, lse, lse, True)


def test_backward_kernel_source_is_built_with_the_others():
    assert "flash_bwd" in _build.KERNELS
    assert (_build.CSRC_DIR / "flash_bwd.cu").is_file()
