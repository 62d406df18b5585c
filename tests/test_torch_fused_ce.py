"""The port's fused LM-head cross-entropy against the JAX package's, on the
CPU: value and grads of ``fused_softmax_xent`` within 1e-5 in f32 (and
within bf16 tolerance for bf16 operands), including a token count that the
chunk does not divide, and against the direct (logits) form of the loss."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops.fused_ce import fused_softmax_xent as jfused
from analytics_zoo_tpu_torch.models.transformer import lm_loss
from analytics_zoo_tpu_torch.ops.fused_ce import fused_softmax_xent

H, V = 16, 40


def _case(b, t, seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(b, t, H)).astype(np.float32)
    w = (rng.normal(size=(H, V)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, size=(b, t)).astype(np.int32)
    return h, w, labels


@pytest.mark.parametrize("b,t,chunk", [(2, 8, 16), (3, 7, 5), (1, 9, 64)],
                         ids=["divides", "ragged", "one-chunk"])
def test_value_and_grads_match_jax_f32(b, t, chunk):
    h, w, labels = _case(b, t, seed=b * 10 + t)
    loss, vjp = jax.vjp(lambda hh, ww: jfused(hh, ww, jnp.asarray(labels),
                                              chunk), jnp.asarray(h),
                        jnp.asarray(w))
    dh_want, dw_want = vjp(jnp.float32(1.0))
    ht, wt = (torch.from_numpy(a).requires_grad_() for a in (h, w))
    got = fused_softmax_xent(ht, wt, torch.from_numpy(labels), chunk)
    dh, dw = torch.autograd.grad(got, (ht, wt))
    assert abs(float(loss) - float(got.detach())) <= 1e-5
    assert float(np.abs(np.asarray(dh_want) - dh.numpy()).max()) <= 1e-5
    assert float(np.abs(np.asarray(dw_want) - dw.numpy()).max()) <= 1e-5


def test_bf16_operands_match_jax_within_bf16_tolerance():
    h, w, labels = _case(2, 9, seed=4)
    hb, wb = (a.astype(ml_dtypes.bfloat16) for a in (h, w))
    loss, vjp = jax.vjp(lambda hh, ww: jfused(hh, ww, jnp.asarray(labels), 4),
                        jnp.asarray(hb), jnp.asarray(wb))
    dh_want, dw_want = vjp(jnp.float32(1.0))
    ht, wt = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
              for a in (h, w))
    got = fused_softmax_xent(ht, wt, torch.from_numpy(labels), 4)
    dh, dw = torch.autograd.grad(got, (ht, wt))
    assert dh.dtype == dw.dtype == torch.bfloat16
    assert abs(float(loss) - float(got.detach())) <= 2e-5
    for want, x in ((dh_want, dh), (dw_want, dw)):
        assert float(np.abs(np.asarray(want, np.float32)
                            - x.float().numpy()).max()) <= 2e-2


def test_matches_the_direct_logits_loss():
    h, w, labels = _case(2, 11, seed=7)
    ht, wt = (torch.from_numpy(a).requires_grad_() for a in (h, w))
    fused = fused_softmax_xent(ht, wt, torch.from_numpy(labels), 6)
    g_fused = torch.autograd.grad(fused, (ht, wt))
    direct = lm_loss(torch.from_numpy(labels), ht @ wt)
    g_direct = torch.autograd.grad(direct, (ht, wt))
    assert abs(float(fused.detach()) - float(direct.detach())) <= 1e-5
    for a, b in zip(g_fused, g_direct):
        assert float((a - b).abs().max()) <= 1e-5


def test_zero_tokens_is_an_error():
    with pytest.raises(ValueError, match="zero tokens"):
        fused_softmax_xent(torch.zeros((0, H)), torch.zeros((H, V)),
                           torch.zeros((0,), dtype=torch.int64))
