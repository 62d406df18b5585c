"""K2 (fused paged attention) in the PyTorch port.

On the CPU: the plain version against the JAX package's Pallas kernel run in
interpret mode, on the JAX fixture's serving-cache layouts at q_len 1, 4 and
16, at the prefill chunk widths 48 and 64 and at head dims 12 and 264
(max |diff| <= 1e-5 in f32 and
<= 2e-2 in bf16; zero-length slots exactly 0), and the wrapper's routing.
The kernel itself is held against its plain version on the card by
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops.paged_attention import (
    paged_attention as jpaged, synthetic_paged_case as jcase)
from analytics_zoo_tpu_torch.ops import _build
from analytics_zoo_tpu_torch.ops import paged_attention as tpa

TOL = 1e-5
SLOTS, PPS, PAGE, H, D = 4, 4, 4, 2, 8


def _to_torch(case):
    """numpy/JAX arrays -> torch tensors; bf16 (which numpy holds as
    ml_dtypes) goes through f32, exactly."""
    out = []
    for x in case:
        if str(x.dtype) == "bfloat16":
            out.append(torch.from_numpy(np.asarray(x, np.float32)).to(
                torch.bfloat16))
        else:
            out.append(torch.from_numpy(np.array(x)))
    return tuple(out)


@pytest.mark.parametrize("dtype,tol", [("float32", TOL), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("q_len", [1, 4, 16])
@pytest.mark.parametrize("lengths", [None, [0, 5, 16, 0]])
def test_plain_matches_jax_kernel(q_len, lengths, dtype, tol):
    """The plain version is the oracle the card's kernel is held to: it
    agrees with the Pallas kernel within ``tol`` (in bf16 each side
    rounds to bf16 at its own places)."""
    if lengths is not None:
        lengths = [max(n, q_len) if n else 0 for n in lengths]
    case = jcase(SLOTS, PPS, PAGE, H, D, q_len=q_len, lengths=lengths,
                 dtype=getattr(jnp, dtype), rng=np.random.default_rng(q_len))
    want = np.asarray(jpaged(*case, page_size=PAGE, interpret=True),
                      np.float32)
    got = tpa.paged_attention_plain(*_to_torch(case), page_size=PAGE)
    assert got.shape == (SLOTS, q_len, H, D)
    assert got.dtype == getattr(torch, dtype)
    assert float(np.abs(want - got.float().numpy()).max()) <= tol
    for b, n in enumerate(np.asarray(case[4])):
        if n == 0:          # inactive slot: exactly zero on both sides
            assert float(got[b].abs().max()) == 0.0
            assert float(np.abs(want[b]).max()) == 0.0


@pytest.mark.parametrize("dtype,tol", [("float32", TOL), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("q_len", [48, 64])
def test_plain_matches_jax_kernel_at_prefill_chunk_widths(q_len, dtype, tol):
    """q_len at the JAX package's prefill chunk widths (48, 64), past the
    16 rows of one q tile, on 20 pages of 4 per slot: every live length
    from q_len up to the full 80 positions, and an inactive slot."""
    lengths = [0, q_len, q_len + 7, 80]
    case = jcase(len(lengths), 20, PAGE, H, D, q_len=q_len, lengths=lengths,
                 dtype=getattr(jnp, dtype),
                 rng=np.random.default_rng(q_len))
    want = np.asarray(jpaged(*case, page_size=PAGE, interpret=True),
                      np.float32)
    got = tpa.paged_attention_plain(*_to_torch(case), page_size=PAGE)
    assert got.shape == (len(lengths), q_len, H, D)
    assert float(np.abs(want - got.float().numpy()).max()) <= tol
    assert float(got[0].abs().max()) == 0.0


@pytest.mark.parametrize("dtype,tol", [("float32", TOL), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("q_len", [1, 17])
@pytest.mark.parametrize("d", [12, 264])
def test_plain_matches_jax_kernel_at_any_head_dim(d, q_len, dtype, tol):
    """Head dims off the 8 grid (12; the card runs K2's wide kernel there
    in bf16) and past the compile-time tiles (264, the wide kernel in both
    dtypes): the plain version agrees with the Pallas kernel."""
    lengths = [0, q_len, q_len + 5, 2 * PPS * PAGE]
    case = jcase(len(lengths), 2 * PPS, PAGE, H, d, q_len=q_len,
                 lengths=lengths,
                 dtype=getattr(jnp, dtype), rng=np.random.default_rng(d))
    want = np.asarray(jpaged(*case, page_size=PAGE, interpret=True),
                      np.float32)
    got = tpa.paged_attention_plain(*_to_torch(case), page_size=PAGE)
    assert got.shape == (len(lengths), q_len, H, d)
    assert float(np.abs(want - got.float().numpy()).max()) <= tol
    assert float(got[0].abs().max()) == 0.0


def test_synthetic_case_matches_the_jax_layout():
    lengths = [0, 3, 9, 16]
    jq, jk, jv, jt, jl = jcase(SLOTS, PPS, PAGE, H, D, lengths=lengths)
    q, k, v, t, ln = tpa.synthetic_paged_case(SLOTS, PPS, PAGE, H, D,
                                              lengths=lengths)
    np.testing.assert_array_equal(np.asarray(jt), t.numpy())
    np.testing.assert_array_equal(np.asarray(jl), ln.numpy())
    assert k.shape == tuple(jk.shape) and q.shape == tuple(jq.shape)


def test_wrapper_on_cpu_takes_plain_version_without_launching():
    case = _to_torch(jcase(SLOTS, PPS, PAGE, H, D, q_len=1))
    before = tpa.paged_attention.launches
    out = tpa.paged_attention(*case, page_size=PAGE)
    ref = tpa.paged_attention_plain(*case, page_size=PAGE)
    assert torch.equal(out, ref)
    assert tpa.paged_attention.launches == before


def test_non_cpu_tensor_never_gets_the_plain_result(monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("nvcc failed for paged_attention.cu")

    monkeypatch.setattr(_build, "load_library", broken)
    q = torch.empty((2, 1, 2, 64), device="meta")
    pages = torch.empty((5, 16, 2, 64), device="meta")
    table = torch.empty((2, 2), dtype=torch.int32, device="meta")
    lens = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tpa.paged_attention(q, pages, pages, table, lens, page_size=16)
    monkeypatch.setattr(_build, "load_library", lambda *a, **kw: object())
    with pytest.raises(ValueError, match="CUDA tensor"):
        tpa.paged_attention(q, pages, pages, table, lens, page_size=16)



@pytest.mark.parametrize("q_len", [1, 4, 16])
def test_every_row_a_caller_can_produce_matches_jax(q_len):
    """Callers (decode, speculative verify, prefill chunks) write the q_len
    new tokens before attending, so a slot's length is 0 (inactive) or at
    least q_len, and every row then has a valid position. On every such
    length the port equals both JAX paths: the Pallas kernel and the plain
    ``decode_attention_multi`` over the gathered cache. (Rows with no valid
    position but a length > 0 have no reference value — the two JAX paths
    disagree there — and no caller produces them.)"""
    from analytics_zoo_tpu.ops.kv_cache import (decode_attention_multi,
                                                paged_read)

    lengths = list(range(q_len, PPS * PAGE + 1))
    case = jcase(len(lengths), PPS, PAGE, H, D, q_len=q_len, lengths=lengths,
                 rng=np.random.default_rng(20 + q_len))
    q, k_pages, v_pages, table, lens = case
    got = tpa.paged_attention_plain(*_to_torch(case), page_size=PAGE).numpy()
    kernel = np.asarray(jpaged(*case, page_size=PAGE, interpret=True))
    plain = np.asarray(decode_attention_multi(
        q, paged_read(k_pages, table), paged_read(v_pages, table), lens))
    assert float(np.abs(kernel - got).max()) <= TOL
    assert float(np.abs(plain - got).max()) <= TOL
