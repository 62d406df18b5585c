"""On-card tests of the PyTorch port's CUDA kernels (marker ``cuda``).

The kernels have no CPU mode, so on a host without a CUDA card every test
here skips. On the card (where the JAX package need not be installed):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Each kernel is held against its plain PyTorch version on the same inputs:
f32 within 1e-4, bf16 within 2e-2. The small model runs its cache-threaded
path on the card (both kernels) against the same seeded model on the CPU
(plain versions), f32 logits within 1e-4.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.models.transformer import TransformerLM
from analytics_zoo_tpu_torch.ops import flash_attention as tfa
from analytics_zoo_tpu_torch.ops import paged_attention as tpa
from analytics_zoo_tpu_torch.ops.kv_cache import SCRATCH_PAGE

pytestmark = pytest.mark.cuda
TOLS = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the port's kernels have no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("t,d,causal", [(16, 64, True), (100, 64, True),
                                        (77, 128, False)])
def test_flash_kernel_matches_plain(cuda, dtype, tol, t, d, causal):
    g = torch.Generator(device=cuda).manual_seed(t)
    q, k, v = (torch.randn((2, t, 4, d), generator=g, device=cuda)
               .to(dtype) for _ in range(3))
    before = tfa.flash_attention_fwd.launches
    out, lse = tfa.flash_attention_fwd(q, k, v, causal)
    ref, ref_lse = tfa.flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches == before + 1
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert float((out.float() - ref.float()).abs().max()) <= tol
    assert float((lse - ref_lse).abs().max()) <= tol


def test_flash_kernel_takes_strided_qkv_and_rejects_bad_input(cuda):
    qkv = torch.randn((1, 40, 3, 4, 64), device=cuda)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = tfa.flash_attention(q, k, v, True)
    ref, _ = tfa.flash_attention_plain(q, k, v, True)
    assert float((out - ref).abs().max()) <= 1e-4
    with pytest.raises(ValueError, match="head dim"):
        x = torch.randn((1, 8, 2, 32), device=cuda)
        tfa.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="dtype"):
        x = torch.randn((1, 8, 2, 64), device=cuda, dtype=torch.float16)
        tfa.flash_attention(x, x, x)


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("q_len", [1, 4, 16])
def test_paged_kernel_matches_plain(cuda, dtype, tol, q_len):
    case = tpa.synthetic_paged_case(
        8, 8, 16, 4, 64, q_len=q_len, dtype=dtype, device=cuda,
        lengths=[0, q_len, 17, 40, 64, 100, 127, 128])
    before = tpa.paged_attention.launches
    out = tpa.paged_attention(*case, page_size=16)
    ref = tpa.paged_attention_plain(*case, page_size=16)
    torch.cuda.synchronize()
    assert tpa.paged_attention.launches == before + 1
    assert float((out.float() - ref.float()).abs().max()) <= tol
    assert float(out[0].abs().max()) == 0.0


def test_paged_kernel_rejects_bad_input(cuda):
    q, kp, vp, table, lens = tpa.synthetic_paged_case(
        2, 4, 16, 2, 64, q_len=17, device=cuda)
    with pytest.raises(ValueError, match="q_len"):
        tpa.paged_attention(q, kp, vp, table, lens, page_size=16)
    with pytest.raises(ValueError, match="int32"):
        tpa.paged_attention(q[:, :1], kp, vp, table.long(), lens,
                            page_size=16)
    with pytest.raises(ValueError, match="dtype"):
        tpa.paged_attention(q[:, :1].to(torch.bfloat16), kp, vp, table, lens,
                            page_size=16)


def test_small_model_cached_path_on_card_matches_cpu(cuda):
    kw = dict(vocab=128, hidden_size=128, n_block=2, n_head=2, seq_len=64,
              attn_strategy="flash", seed=5)
    models = {"cuda": TransformerLM(device=cuda, **kw),
              "cpu": TransformerLM(device="cpu", **kw)}
    rng = np.random.default_rng(0)
    lens = np.array([13, 0], np.int32)
    table = np.full((2, 4), SCRATCH_PAGE, np.int32)
    table[0] = [1, 2, 3, 4]
    ids = np.zeros((2, 16), np.int32)
    ids[0, :13] = rng.integers(1, 128, size=13)
    caches, logits = {}, {}
    k1, k2 = tfa.flash_attention_fwd.launches, tpa.paged_attention.launches
    for name, m in models.items():
        _, caches[name] = m.init_kv_cache(2, page_size=16, max_seq_len=64)
        lg, _ = m.prefill(caches[name], ids, lens, table, page_size=16)
        logits[name] = lg.cpu()
    assert float((logits["cuda"] - logits["cpu"]).abs().max()) <= 1e-4
    tok = np.array([int(logits["cpu"][0].argmax()), 0], np.int32)
    z = np.zeros(2, np.int64)
    for step in range(4):
        pos = np.array([13 + step, 0], np.int32)
        for name, m in models.items():
            _, lg, _ = m.decode_step(caches[name], tok, pos, table, z, z,
                                     np.zeros(2, np.float32), page_size=16)
            logits[name] = lg.cpu()
        assert float((logits["cuda"] - logits["cpu"]).abs().max()) <= 1e-4
        tok = np.array([int(logits["cpu"][0].argmax()), 0], np.int32)
    assert tfa.flash_attention_fwd.launches - k1 == 2
    assert tpa.paged_attention.launches - k2 == 2 * 4
