"""On-card tests of the PyTorch port's CUDA kernels (marker ``cuda``).

The kernels have no CPU mode, so on a host without a CUDA card every test
here skips. On the card (where the JAX package need not be installed):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Each kernel is held against its plain PyTorch version on the same inputs:
f32 within 1e-4, bf16 within 2e-2 (the backward kernels' gradients
relative to max(1, max|plain|)). The flash kernels are checked at every
tile edge (T = 1, 63, 64, 65, 127, 129), with Tq != Tk both ways, at
D = 64 and 128 and on q/k/v strided out of one fused QKV tensor; the bf16
tensor-core kernels (K1, K3, K4, and K2 split across the context) must
give the same bits twice and refuse a view their 16-byte copies cannot
take; the wgmma K3 and K4 give the same bits twice at the training
shape too. The bf16 K4 is held over D in {64, 128}, causal or not, T in
{1, 63, 64, 65, 127, 129, 2048} and Tq != Tk both ways; K2 over q_len
{1, 4, 16}, pages of 8, 16 and 32 positions and lengths at 0, 1, q_len, on
and around each split boundary and at the full 1024, and at the serving
features' shapes: q_len 256, 512 and 1024, a chunk's wide table and lengths
past the table (which the kernel clamps). Every head dim runs
K1-K4: 4, 8, 12, 16, 20, 24, 32, 96, 100, 160, 256, 264, 384 and 512 over
the tile edges, causal or not (off the 8 grid through the bf16 pad route,
above 256 on the wide kernels), and K2 runs at q_len 1, 16, 17, 48, 64 and
128 over head dims 16, 32, 64, 96 and 256, and at q_len 1, 17 and 64 over
4, 12, 20, 100, 264, 384 and 512. The small model runs its
cache-threaded path on the card (K1, K2) against the same seeded model on
the CPU (plain versions), f32 logits within 1e-4; the sampling kernel
draws the plain version's tokens exactly; its speculative, chunked and
prefix-cache serving gives the CPU's greedy streams; it trains on the card (K1, K3,
K4) to the CPU's loss, with K1 launched once per block and micro-step
under remat "flash" and twice under "full"; autograd through the flash
Function matches SDPA's grads, and no CUDA tensor takes a plain backward.
The int8 kernels (K5, K6) and their quantize pass are bitwise equal to
their plain versions (``torch.equal``) in f32 and bf16, K6 at every one of
ResNet-50's conv shapes. NeuralCF and ImplicitNCF train device-cached
steps on the card to the CPU's losses (f32 1e-5 relative, bf16 2e-2),
the implicit negatives bit for bit the CPU's. The pinned-memory loader
(``data/pipeline.py``'s ``PinnedCopy``) yields the host batches on the
card at depths 0, 2 and 4, and Wide & Deep and SessionRecommender train
streaming steps on the card to the CPU's losses, the same bits at
depths 0 and 2. The serving remainder on the card: a preempted stream
resumes with the CPU's tokens, a (params, spec) swap serves a fresh
batcher's tokens, a chaos-killed loop respawns with its streams, an int8
swap serves K5 on the re-packed kernels bit for bit, and a row delta
equals a full swap. The data plane on the card (``-k data_plane``): an int8
ResNet-50 behind ClusterServing answers through the broker and the shm ring
bit for bit as its direct predict (K6 = 53, K5 = 1 a batch), a
GenerationEngine streams a ContinuousBatcher's tokens (K1 a prefill and
layer, K2 a decode step and layer), and ModelSwapper's staged tensors are
the ones the model serves after the flip. Files and sets on the card
(``-k files_and_sets``): dropout masks drawn on the card are the CPU's
bits, and a TextClassifier trained on a TextSet on the card takes the
CPU's per-step losses. Multi-rank attention on the card (``-k
multi_rank``): the flash ring's per-block K1 calls merged by their LSEs,
and its per-block K3/K4 calls against the global lse and δ, equal the
plain whole-sequence forward and backward (one process); in 2 rank
processes on the card (gloo, CUDA tensors staged through host buffers)
the ring (causal and not) and zigzag give the one-process flash result,
with K1 = K3 = K4 = idx + 1 launches on rank idx of the causal ring. On a
host with two or more cards, ranks on cards of their own take NCCL by
default: every collective and its transpose equal numpy's, and the causal
flash ring over them gives the one-process result (it skips on one card).
fsdp and tp on the card (``-k multi_rank``): K1/K3/K4 at a tp rank's 4
and 8 heads against their plain versions, and 4 rank processes on
tp=2 x fsdp=2 training two f32 steps to the one-process CPU run. The
analysis tier on the card (``-k analysis``): while a trace records, each
wrapper (K1-K6, the sampler) launches nothing and records one site whose
outputs have its launch's shapes and dtypes; a small model's decode trace
holds one K2 site a block and the sampler, no host read; the memory
witness reads the caching allocator.
"""

import math

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.models.transformer import TransformerLM
from analytics_zoo_tpu_torch.ops import flash_attention as tfa
from analytics_zoo_tpu_torch.ops import kv_cache as kvc
from analytics_zoo_tpu_torch.ops import paged_attention as tpa
from analytics_zoo_tpu_torch.ops.kv_cache import SCRATCH_PAGE

pytestmark = pytest.mark.cuda
TOLS = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]
#: sequence lengths at and around the 64-row tiles of the flash kernels
EDGE_T = (1, 63, 64, 65, 127, 129)
#: head dims besides 64 and 128 (every head dim runs): multiples of 8 on
#: the compile-time tiles, others off the 8 grid, and past the tiles (the
#: wide kernels)
WIDE_D = (4, 12, 20, 100, 264, 384, 512)
MORE_D = (8, 16, 24, 32, 96, 160, 256) + WIDE_D


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the port's kernels have no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _fwd_case(cuda, dtype, t, t_k, d, fused, seed):
    """q (2, t, 4, d) and k, v (2, t_k, 4, d): three tensors, or (fused,
    t_k = t) strided views of one (2, t, 3, 4, d) QKV tensor."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    if fused:
        qkv = torch.randn((2, t, 3, 4, d), generator=g, device=cuda).to(dtype)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    t_k = t if t_k is None else t_k
    return tuple(torch.randn((2, n, 4, d), generator=g, device=cuda)
                 .to(dtype) for n in (t, t_k, t_k))


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("t,t_k,d,causal,fused", [
    (16, None, 64, True, False), (100, None, 64, True, False),
    (77, None, 128, False, False),
    *[(t, None, 64, c, False) for t in EDGE_T for c in (False, True)],
    *[(t, None, 128, True, False) for t in EDGE_T],
    (40, 70, 64, True, False), (70, 40, 64, True, False),
    (63, 129, 128, True, False), (129, 63, 128, True, False),
    (65, 130, 64, False, False),
    (129, None, 64, True, True), (100, None, 128, True, True)])
def test_flash_kernel_matches_plain(cuda, dtype, tol, t, t_k, d, causal,
                                    fused):
    q, k, v = _fwd_case(cuda, dtype, t, t_k, d, fused, seed=t)
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
    with pytest.raises(ValueError, match="head dim 0 is not positive"):
        x = torch.randn((1, 8, 2, 0), device=cuda)
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


#: K2 lengths: 0, 1, q_len, on and around the 128-position split
#: boundaries, and the full context
PAGED_LENGTHS = (0, 1, None, 127, 128, 129, 255, 256, 257, 640, 1023, 1024)


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("q_len", [1, 4, 16])
@pytest.mark.parametrize("page", [8, 16, 32])
@pytest.mark.parametrize("d", [64, 128])
def test_paged_kernel_split_across_the_context_matches_plain(
        cuda, dtype, tol, q_len, page, d):
    """K2 (bf16: split into 128-position spans, then combined) against its
    plain version at every page size the pool may have, on slots whose
    lengths sit at 0, 1, q_len, on and around the split boundaries and at
    the full 1024; a zero-length slot is exactly 0."""
    lengths = [q_len if n is None else n for n in PAGED_LENGTHS]
    case = tpa.synthetic_paged_case(
        len(lengths), 1024 // page, page, 4, d, q_len=q_len, dtype=dtype,
        lengths=lengths, device=cuda,
        generator=torch.Generator().manual_seed(page + q_len))
    before = tpa.paged_attention.launches
    out = tpa.paged_attention(*case, page_size=page)
    ref = tpa.paged_attention_plain(*case, page_size=page)
    torch.cuda.synchronize()
    assert tpa.paged_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == ref.shape
    assert float((out.float() - ref.float()).abs().max()) <= tol
    assert float(out[0].abs().max()) == 0.0


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("q_len", [1, 16, 17, 48, 64, 128])
@pytest.mark.parametrize("d", [16, 32, 64, 96, 256])
def test_paged_kernel_at_any_q_len_and_head_dim_matches_plain(
        cuda, dtype, tol, q_len, d):
    """K2 past one 16-row q tile (speculative verify, prefill chunks of 48,
    64, 128) and at head dims besides 64 and 128, on slots at 0, q_len,
    around the split boundaries and at the full 1024."""
    lengths = [0, q_len, q_len + 1, 127, 129, 257, 640, 1024]
    lengths = [max(n, q_len) if n else 0 for n in lengths]
    case = tpa.synthetic_paged_case(
        len(lengths), 64, 16, 4, d, q_len=q_len, dtype=dtype,
        lengths=lengths, device=cuda,
        generator=torch.Generator().manual_seed(q_len + d))
    before = tpa.paged_attention.launches
    out = tpa.paged_attention(*case, page_size=16)
    ref = tpa.paged_attention_plain(*case, page_size=16)
    torch.cuda.synchronize()
    assert tpa.paged_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == ref.shape
    assert float((out.float() - ref.float()).abs().max()) <= tol
    assert float(out[0].abs().max()) == 0.0


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("q_len", [1, 17, 64])
@pytest.mark.parametrize("d", WIDE_D)
def test_paged_kernel_at_every_head_dim_matches_plain(cuda, dtype, tol,
                                                      q_len, d):
    """K2 at head dims off the 8 grid (bf16 there runs the wide kernel: the
    pool's rows are not whole 16-byte chunks) and past the compile-time
    tiles (the wide kernel in both dtypes)."""
    lengths = [0, q_len, q_len + 1, 127, 129, 257, 640, 1024]
    lengths = [max(n, q_len) if n else 0 for n in lengths]
    case = tpa.synthetic_paged_case(
        len(lengths), 64, 16, 4, d, q_len=q_len, dtype=dtype,
        lengths=lengths, device=cuda,
        generator=torch.Generator().manual_seed(q_len + d))
    before = tpa.paged_attention.launches
    out = tpa.paged_attention(*case, page_size=16)
    ref = tpa.paged_attention_plain(*case, page_size=16)
    torch.cuda.synchronize()
    assert tpa.paged_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == ref.shape
    assert float((out.float() - ref.float()).abs().max()) <= tol
    assert float(out[0].abs().max()) == 0.0


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("q_len,kind", [(256, "ladder"), (512, "ladder"),
                                        (1024, "ladder"), (128, "wide"),
                                        (1024, "past")])
def test_paged_kernel_at_the_serving_features_shapes(cuda, dtype, tol, q_len,
                                                     kind):
    """K2 as the serving features launch it: long q_len (chunks, a prefix
    hit's suffix bucket), a chunk's wide table (8 scratch entries past the
    pool's pages, lengths reaching into them), and lengths past
    ``pages_per_slot * page_size`` (the suffix bucket of a hit), which the
    kernel clamps to the table."""
    want = {"ladder": [0, 37, 130, 255, 400, 600, 777, 1024],
            "wide": [0, 128, 300, 640, 1000, 1024, 1100, 1152],
            "past": [0, 1024, 1100, 1504, 1504, 2047, 1030, 1200]}[kind]
    want = [max(n, q_len) if n else 0 for n in want]
    q, kp, vp, table, _ = tpa.synthetic_paged_case(
        len(want), 64, 16, 4, 64, q_len=q_len, dtype=dtype,
        lengths=[min(n, 1024) for n in want], device=cuda,
        generator=torch.Generator().manual_seed(q_len))
    if kind == "wide":
        table = torch.cat([table, torch.zeros_like(table[:, :8])],
                          1).contiguous()
    lens = torch.tensor(want, dtype=torch.int32, device=cuda)
    out = tpa.paged_attention(q, kp, vp, table, lens, page_size=16)
    ref = tpa.paged_attention_plain(q, kp, vp, table, lens, page_size=16)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert float((out.float() - ref.float()).abs().max()) <= tol
    assert float(out[0].abs().max()) == 0.0


def test_paged_kernel_rejects_bad_input(cuda):
    q, kp, vp, table, lens = tpa.synthetic_paged_case(
        2, 4, 16, 2, 64, q_len=17, device=cuda)
    x = tpa.synthetic_paged_case(2, 4, 16, 2, 0, q_len=17, device=cuda)
    with pytest.raises(ValueError, match="head dim 0 is not positive"):
        tpa.paged_attention(*x, page_size=16)
    with pytest.raises(ValueError, match="int32"):
        tpa.paged_attention(q[:, :1], kp, vp, table.long(), lens,
                            page_size=16)
    with pytest.raises(ValueError, match="dtype"):
        tpa.paged_attention(q[:, :1].to(torch.bfloat16), kp, vp, table, lens,
                            page_size=16)
    # a bf16 pool whose rows cp.async cannot copy in 16-byte chunks
    q1 = q[:, :1].to(torch.bfloat16)
    n = kp.numel()
    buf = torch.zeros((n + 8,), device=cuda, dtype=torch.bfloat16)
    odd = buf[1:n + 1].view(kp.shape)
    with pytest.raises(ValueError, match="16-byte"):
        tpa.paged_attention(q1, odd, odd, table, lens, page_size=16)


@pytest.mark.parametrize("top_k", [0, 40])
def test_sampling_kernel_matches_plain_bit_for_bit(cuda, top_k):
    """The fused threefry/Gumbel-max kernel draws the plain version's token
    for 512 (seed, idx) pairs at V=32000, and sample_tokens on a CUDA
    tensor goes through it."""
    g = torch.Generator(device=cuda).manual_seed(11)
    temps = [0.8, 0.0, 1.3, 0.5, 0.0, 2.0, 0.8, 0.1]
    for step in range(64):
        logits = torch.randn((8, 32000), generator=g, device=cuda) * 3
        seeds = [step * 8 + i for i in range(8)]
        idx = [step * 37 + i for i in range(8)]
        before = kvc.gumbel_max.launches
        got = kvc.sample_tokens(logits, seeds, idx, temps, top_k=top_k)
        assert kvc.gumbel_max.launches == before + 1
        hot = [i for i, t in enumerate(temps) if t > 0]
        scaled = logits / torch.tensor(temps, device=cuda).clamp_min(
            1e-6)[:, None]
        if top_k:
            kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
            scaled = torch.where(scaled >= kth, scaled,
                                 torch.full_like(scaled, kvc.NEG_INF))
        want = kvc.gumbel_max_plain(scaled, hot, [seeds[i] for i in hot],
                                    [idx[i] for i in hot])
        assert torch.equal(got[hot].long(), want)
        assert torch.equal(got[[1, 4]].long(), logits[[1, 4]].argmax(-1))


def test_sampling_kernel_rejects_bad_input(cuda):
    x = torch.zeros((2, 10), device=cuda)
    with pytest.raises(ValueError, match="f32"):
        kvc.gumbel_max(x.to(torch.bfloat16), [0], [1], [2])
    with pytest.raises(ValueError, match="rows"):
        kvc.gumbel_max(x, [2], [1], [2])


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


def test_small_model_serving_features_on_card_match_cpu(cuda):
    """Speculative decode, chunked prefill and a prefix hit whose suffix
    bucket passes the page and position tables, on the card (K1, K2)
    against the CPU: the same greedy streams in every arm, equal to the
    plain arm's."""
    from analytics_zoo_tpu_torch.serving.generation import ContinuousBatcher

    kw = dict(vocab=128, hidden_size=64, n_block=2, n_head=4, seq_len=64,
              attn_strategy="flash", seed=3)
    rng = np.random.default_rng(2)
    first = rng.integers(1, 128, size=20).astype(np.int32)
    prompts = [rng.integers(1, 128, size=n).astype(np.int32)
               for n in (5, 30)]
    pair = [first, np.concatenate([first[:16],
                                   rng.integers(1, 128, size=44)])]
    streams = {}
    for dev in (cuda, "cpu"):
        model = TransformerLM(device=dev, **kw)
        for arm, opts in (("plain", {}), ("spec", dict(spec_k=3)),
                          ("prefix", dict(prefix_cache_pages=8)),
                          ("chunked", dict(prefill_chunk_tokens=32,
                                           prefix_cache_pages=8))):
            b = ContinuousBatcher(model, n_slots=2, page_size=16,
                                  max_seq_len=64, device=dev, **opts)
            try:
                out = [b.generate(p, max_new_tokens=8) for p in prompts]
                out += [b.generate(p, max_new_tokens=3) for p in pair]
            finally:
                b.close()
            streams[(str(dev), arm)] = out
    for arm in ("plain", "spec", "prefix", "chunked"):
        assert streams[("cuda", arm)] == streams[("cpu", arm)]
        assert streams[("cuda", arm)] == streams[("cuda", "plain")]


# ------------------------------------------------------- K3/K4 and training

def _bwd_case(cuda, dtype, t, d, causal, t_k=None, seed=0, fused=False):
    """q strided out of a fused QKV tensor; k and v from the same tensor
    (``fused``, t_k = t) or separate (2, t_k, 4, d) tensors."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    t_k = t if t_k is None else t_k
    qkv = torch.randn((2, t, 3, 4, d), generator=g, device=cuda).to(dtype)
    q = qkv[:, :, 0]
    if fused:
        k, v = qkv[:, :, 1], qkv[:, :, 2]
    else:
        k = torch.randn((2, t_k, 4, d), generator=g, device=cuda).to(dtype)
        v = torch.randn((2, t_k, 4, d), generator=g, device=cuda).to(dtype)
    out, lse = tfa.flash_attention_fwd(q, k, v, causal)
    go = torch.randn((2, t, 4, d), generator=g, device=cuda).to(dtype)
    return q, k, v, go, lse, tfa.flash_bwd_delta(out, go)


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("t,t_k,d,causal,fused", [
    (16, None, 64, True, False), (100, None, 64, True, False),
    (77, None, 128, False, False), (130, None, 64, False, False),
    (40, 70, 64, True, False), (70, 40, 128, True, False),
    *[(t, None, 64, True, False) for t in EDGE_T],
    *[(t, None, 128, False, False) for t in EDGE_T],
    (63, 129, 64, True, False), (129, 63, 64, True, False),
    (65, 127, 128, False, False),
    (129, None, 64, True, True), (100, None, 128, True, True)])
def test_flash_backward_kernels_match_plain(cuda, dtype, tol, t, t_k, d,
                                            causal, fused):
    """K3 (dq) and K4 (dk, dv) against their plain versions, strided q,
    ragged T and Tq != Tk included; errors relative to max(1, max|plain|)
    (bf16 gradients reach magnitudes where one ulp exceeds 2e-2)."""
    case = _bwd_case(cuda, dtype, t, d, causal, t_k, seed=t, fused=fused)
    before = (tfa.flash_attention_bwd_dq.launches,
              tfa.flash_attention_bwd_dkv.launches)
    dq = tfa.flash_attention_bwd_dq(*case, causal)
    dk, dv = tfa.flash_attention_bwd_dkv(*case, causal)
    rq = tfa.flash_attention_bwd_dq_plain(*case, causal)
    rk, rv = tfa.flash_attention_bwd_dkv_plain(*case, causal)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_bwd_dq.launches,
            tfa.flash_attention_bwd_dkv.launches) == (before[0] + 1,
                                                      before[1] + 1)
    for got, ref in ((dq, rq), (dk, rk), (dv, rv)):
        assert got.dtype == dtype
        scale = max(1.0, float(ref.float().abs().max()))
        assert float((got.float() - ref.float()).abs().max()) <= tol * scale


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", EDGE_T)
@pytest.mark.parametrize("d", MORE_D)
def test_flash_kernels_at_every_head_dim_match_plain(cuda, dtype, tol, d, t,
                                                     causal):
    """K1, K3 and K4 at head dims besides 64 and 128 (run on the smallest
    tile of 32, 64, 128 or 256 columns that holds them, bf16 off the 8
    grid through one zero-padded copy, and above 256 on the wide kernels),
    q/k/v strided out of one fused QKV tensor; backward errors relative to
    max(1, max|plain|)."""
    q, k, v, go, lse, delta = _bwd_case(cuda, dtype, t, d, causal,
                                        seed=t + d, fused=True)
    out, lse1 = tfa.flash_attention_fwd(q, k, v, causal)
    ref, ref_lse = tfa.flash_attention_plain(q, k, v, causal)
    case = (q, k, v, go, lse, delta)
    dq = tfa.flash_attention_bwd_dq(*case, causal)
    dk, dv = tfa.flash_attention_bwd_dkv(*case, causal)
    rq = tfa.flash_attention_bwd_dq_plain(*case, causal)
    rk, rv = tfa.flash_attention_bwd_dkv_plain(*case, causal)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == dtype
    assert float((out.float() - ref.float()).abs().max()) <= tol
    assert float((lse1 - ref_lse).abs().max()) <= tol
    for got, want in ((dq, rq), (dk, rk), (dv, rv)):
        assert got.dtype == dtype and got.shape == want.shape
        scale = max(1.0, float(want.float().abs().max()))
        assert float((got.float() - want.float()).abs().max()) <= tol * scale


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [*EDGE_T, 2048])
def test_bf16_dkv_tensor_core_kernel_matches_plain(cuda, d, causal, t):
    """The bf16 K4 (wgmma, keys owned per warpgroup, Q/dO streamed) against
    its plain version on q/k/v strided out of one fused QKV tensor, errors
    relative to max(1, max|plain|)."""
    case = _bwd_case(cuda, torch.bfloat16, t, d, causal, seed=t + d,
                     fused=True)
    before = tfa.flash_attention_bwd_dkv.launches
    dk, dv = tfa.flash_attention_bwd_dkv(*case, causal)
    rk, rv = tfa.flash_attention_bwd_dkv_plain(*case, causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bwd_dkv.launches == before + 1
    for got, ref in ((dk, rk), (dv, rv)):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        scale = max(1.0, float(ref.float().abs().max()))
        assert float((got.float() - ref.float()).abs().max()) <= 2e-2 * scale


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,t_k", [(63, 129), (129, 63), (1, 65), (65, 1),
                                   (100, 2048), (2048, 100)])
def test_bf16_dkv_tensor_core_kernel_with_tq_ne_tk(cuda, d, causal, t, t_k):
    """The bf16 K4 with Tq != Tk both ways: under the causal mask (absolute
    positions) key tiles past Tq get no query and write zeros."""
    case = _bwd_case(cuda, torch.bfloat16, t, d, causal, t_k, seed=t * t_k)
    dk, dv = tfa.flash_attention_bwd_dkv(*case, causal)
    rk, rv = tfa.flash_attention_bwd_dkv_plain(*case, causal)
    torch.cuda.synchronize()
    for got, ref in ((dk, rk), (dv, rv)):
        scale = max(1.0, float(ref.float().abs().max()))
        assert float((got.float() - ref.float()).abs().max()) <= 2e-2 * scale


def test_bf16_flash_kernels_give_the_same_bits_twice(cuda):
    """K1, K3, K4 and the split K2 in bf16 sum in a fixed order (no
    atomics): two launches on the same inputs give bitwise-equal out, lse,
    dq, dk, dv and paged output."""
    q, k, v, go, lse, delta = _bwd_case(cuda, torch.bfloat16, 200, 64, True,
                                        seed=9, fused=True)
    paged = tpa.synthetic_paged_case(4, 64, 16, 4, 64, q_len=4,
                                     dtype=torch.bfloat16, device=cuda,
                                     lengths=[0, 300, 777, 1024])
    runs = [(*tfa.flash_attention_fwd(q, k, v, True),
             tfa.flash_attention_bwd_dq(q, k, v, go, lse, delta, True),
             *tfa.flash_attention_bwd_dkv(q, k, v, go, lse, delta, True),
             tpa.paged_attention(*paged, page_size=16))
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_bf16_backward_kernels_give_the_same_bits_at_the_training_shape(cuda,
                                                                        d):
    """The wgmma K3 and K4 write every dQ, dK and dV element once, summed
    in a fixed order by one warpgroup: two launches at T=2048 (many items
    a persistent block) give bitwise-equal results."""
    g = torch.Generator(device=cuda).manual_seed(d)
    qkv = torch.randn((2, 2048, 3, 4, d), generator=g, device=cuda).to(
        torch.bfloat16)
    q, k, v = qkv.unbind(2)
    out, lse = tfa.flash_attention_fwd(q, k, v, True)
    go = torch.randn(q.shape, generator=g, device=cuda).to(torch.bfloat16)
    case = (q, k, v, go, lse, tfa.flash_bwd_delta(out, go))
    runs = [(tfa.flash_attention_bwd_dq(*case, True),
             *tfa.flash_attention_bwd_dkv(*case, True)) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_bf16_view_the_kernels_cannot_copy_raises(cuda):
    """cp.async moves 16-byte chunks: a bf16 view that starts off a 16-byte
    boundary, or whose head stride is not a multiple of 8 elements, raises
    ValueError instead of faulting."""
    n = 2 * 64 * 4 * 64
    buf = torch.randn((n + 8,), device=cuda).to(torch.bfloat16)
    odd = buf[1:n + 1].view(2, 64, 4, 64)
    assert odd.data_ptr() % 16
    padded = torch.randn((2, 64, 4, 68), device=cuda).to(
        torch.bfloat16)[..., :64]
    lse = torch.zeros((2, 4, 64), device=cuda)
    for x in (odd, padded):
        with pytest.raises(ValueError, match="16-byte"):
            tfa.flash_attention_fwd(x, x, x, True)
        with pytest.raises(ValueError, match="16-byte"):
            tfa.flash_attention_bwd_dq(x, x, x, x, lse, lse, True)
        with pytest.raises(ValueError, match="16-byte"):
            tfa.flash_attention_bwd_dkv(x, x, x, x, lse, lse, True)


def test_flash_autograd_on_card_matches_sdpa_grads(cuda):
    import torch.nn.functional as F

    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, go = (torch.randn((2, 96, 4, 64), generator=g, device=cuda)
                   for _ in range(4))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(tfa.flash_attention(*leaves, True), leaves, go)
    ref_leaves = [x.transpose(1, 2).clone().requires_grad_()
                  for x in (q, k, v)]
    ref_out = F.scaled_dot_product_attention(*ref_leaves, is_causal=True)
    ref = torch.autograd.grad(ref_out, ref_leaves, go.transpose(1, 2))
    for a, b in zip(got, ref):
        assert float((a - b.transpose(1, 2)).abs().max()) <= 1e-4


def test_cuda_tensors_never_take_the_plain_backward(cuda, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a plain backward ran on CUDA tensors")

    for name in ("flash_attention_bwd_plain", "flash_attention_bwd_dq_plain",
                 "flash_attention_bwd_dkv_plain", "flash_attention_plain"):
        monkeypatch.setattr(tfa, name, refuse)
    q, k, v = (torch.randn((1, 64, 2, 64), device=cuda).requires_grad_()
               for _ in range(3))
    before = tfa.flash_attention_bwd_dkv.launches
    tfa.flash_attention(q, k, v, True).sum().backward()
    torch.cuda.synchronize()
    assert tfa.flash_attention_bwd_dkv.launches == before + 1
    assert q.grad.is_cuda and torch.isfinite(q.grad).all()


@pytest.mark.parametrize("remat,per_block", [(False, 1), ("flash", 1),
                                             ("full", 2)])
def test_k1_launches_per_micro_step_under_each_remat_mode(cuda, remat,
                                                          per_block):
    """Two blocks, grad accumulation 2: "flash" (and no remat) run K1 once
    per block and micro-step, "full" twice (its recompute); K3 and K4 run
    once per block and micro-step in every mode."""
    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.models.transformer import lm_loss

    m = TransformerLM(vocab=128, hidden_size=128, n_block=2, n_head=2,
                      seq_len=64, attn_strategy="flash", remat=remat,
                      device=cuda, seed=1)
    m.compile(optimizer="adam", loss=lm_loss,
              config=TrainConfig(grad_accum_steps=2, shuffle=False))
    ids = np.random.default_rng(0).integers(0, 128, size=(4, 65))
    counts = (tfa.flash_attention_fwd.launches,
              tfa.flash_attention_bwd_dq.launches,
              tfa.flash_attention_bwd_dkv.launches)
    m.fit(ids[:, :-1], ids[:, 1:], batch_size=4, nb_epoch=1)
    got = (tfa.flash_attention_fwd.launches - counts[0],
           tfa.flash_attention_bwd_dq.launches - counts[1],
           tfa.flash_attention_bwd_dkv.launches - counts[2])
    assert got == (2 * 2 * per_block, 2 * 2, 2 * 2)


def test_small_model_training_step_on_card_matches_cpu(cuda):
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.models.transformer import lm_loss

    kw = dict(vocab=128, hidden_size=128, n_block=2, n_head=2, seq_len=64,
              attn_strategy="flash", remat="flash", seed=5)
    ids = np.random.default_rng(1).integers(0, 128, size=(2, 65))
    data = (ids[:, :-1], ids[:, 1:])
    losses = {}
    for name, dev in (("cuda", cuda), ("cpu", "cpu")):
        est = Estimator(TransformerLM(device=dev, **kw), optimizer="sgd",
                        loss=lm_loss)
        est.fit(data, batch_size=2, epochs=2)
        losses[name] = est.trainer_state.last_loss
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4


# ------------------------------------------------------------------ K5 / K6

def _packed(rng, shape, cuda):
    from analytics_zoo_tpu_torch.ops.int8 import quantize_weight

    w = quantize_weight(rng.normal(size=shape).astype(np.float32))
    return {k: torch.from_numpy(v).to(cuda) for k, v in w.items()}


def _rel(got, ref):
    return float((got.float() - ref.float()).abs().max()) / max(
        1.0, float(ref.float().abs().max()))


I8_DTYPES = [torch.float32, torch.bfloat16]


def _packed_kernel_major(rng, shape, cuda):
    """Packed as a quantized layer passes it: with q kernel-major."""
    from analytics_zoo_tpu_torch.ops.int8_fused import kernel_major

    packed = _packed(rng, shape, cuda)
    packed["qt"] = kernel_major(packed["q"])
    return packed


@pytest.mark.parametrize("dtype", I8_DTYPES)
@pytest.mark.parametrize("lead,k,n,g,rule", [
    ((64,), 512, 256, 128, "fused"), ((100,), 1024, 384, 512, "fused"),
    ((2, 9), 256, 128, 256, "fused"), ((8,), 2048, 1000, 2048, "lax"),
    ((5,), 96, 20, 96, "lax"), ((0,), 256, 128, 128, "fused"),
    ((77,), 300, 50, 100, "fused"), ((13,), 200, 33, 200, "lax"),
    ((3000,), 640, 130, 160, "fused"), ((1, 1), 256, 8, 256, "fused"),
    ((2048,), 1024, 2048, 512, "fused"), ((2100,), 512, 1000, 128, "fused"),
    ((2100,), 256, 999, 256, "lax")])
def test_int8_matmul_kernel_matches_plain(cuda, dtype, lead, k, n, g, rule):
    """K5 bitwise equal to its plain version: the fused route's segments,
    ragged M, 3-D leading dims, the lax route's one group of K (N = 1000
    and a K that is no multiple of the chunk), groups that are no multiple
    of 32 (g = 100, a lax K = 200), an M over many tiles with a ragged
    last one, one row, M = 0 (no launch), and shapes whose 128 x 128 tiles
    fill the SMs (the wgmma GEMM; ragged M and N, an odd N); with and
    without the packed kernel-major copy."""
    from analytics_zoo_tpu_torch.ops import int8_fused as f8

    rng = np.random.default_rng(k + n)
    packed = _packed_kernel_major(rng, (k, n), cuda)
    x = torch.from_numpy(rng.normal(size=lead + (k,)).astype(np.float32)
                         * 3).to(cuda).to(dtype)
    before = f8.int8_matmul_fused.launches
    y = f8.int8_matmul_fused(x, packed, g, rule)
    y_made_here = f8.int8_matmul_fused(
        x, {"q": packed["q"], "scale": packed["scale"]}, g, rule)
    ref = f8.int8_matmul_fused_plain(x, packed, g, rule)
    torch.cuda.synchronize()
    assert y.shape == lead + (n,) and y.dtype == dtype
    assert f8.int8_matmul_fused.launches == before + 2 * (
        math.prod(lead) > 0)
    assert torch.equal(y, ref) and torch.equal(y_made_here, ref)


@pytest.mark.parametrize("dtype", I8_DTYPES)
@pytest.mark.parametrize("b,hw,k,cin,cout,stride,padding,rule", [
    (2, 14, 3, 16, 32, 1, "SAME", "fused"), (2, 8, 1, 64, 16, 1, "SAME",
                                             "fused"),
    (2, 9, 3, 8, 70, 1, "VALID", "fused"), (2, 14, 1, 32, 64, 2, "SAME",
                                            "lax"),
    (2, 32, 7, 3, 16, 2, "SAME", "lax"), (2, 70, 3, 4, 8, 1, "SAME", "fused"),
    (2, 14, 3, 48, 40, 1, "SAME", "fused"), (2, 15, 3, 64, 96, 2, "SAME",
                                             "lax"),
    (3, 70, 3, 32, 72, 1, "SAME", "fused"), (2, 33, 11, 3, 20, 4, "SAME",
                                             "lax"),
    (2, 13, 1, 40, 24, 2, "VALID", "lax"), (8, 28, 1, 256, 512, 1, "SAME",
                                            "fused"),
    (16, 56, 1, 256, 250, 2, "SAME", "lax"), (32, 56, 1, 256, 64, 1,
                                              "SAME", "fused")])
def test_int8_conv_kernel_matches_plain(cuda, dtype, b, hw, k, cin, cout,
                                        stride, padding, rule):
    """K6 bitwise equal to its plain version: 3x3 and 1x1 at stride 1
    (fused rule), VALID with a ragged Cout, the stride-2 1x1 and the 7x7/2
    stem on the lax rule, an output row wider than a tile, Cin 48 (no
    multiple of 32), a 3x3 at stride 2 on the lax route, an M of 14700
    rows (many tiles, a ragged last one), an 11x11/4 window at Cin 3, a
    strided 1x1 VALID at an odd size, and 1x1 convs over many tiles (a
    ragged and a narrow Cout, stride 2); with and without the packed
    kernel-major copy."""
    from analytics_zoo_tpu_torch.ops import int8_fused as f8

    rng = np.random.default_rng(hw + cin)
    packed = _packed_kernel_major(rng, (k, k, cin, cout), cuda)
    x = torch.from_numpy(rng.normal(size=(b, hw, hw, cin)).astype(
        np.float32)).to(cuda).to(dtype)
    pads = (f8.same_pads((hw, hw), (k, k), (stride, stride))
            if padding == "SAME" else ((0, 0), (0, 0)))
    before = f8.int8_conv2d_fused.launches
    y = f8.int8_conv2d_fused(x, packed, (stride, stride), pads, rule)
    y_made_here = f8.int8_conv2d_fused(
        x, {"q": packed["q"], "scale": packed["scale"]}, (stride, stride),
        pads, rule)
    ref = f8.int8_conv2d_fused_plain(x, packed, (stride, stride), pads, rule)
    torch.cuda.synchronize()
    assert y.shape == ref.shape and y.dtype == dtype
    assert f8.int8_conv2d_fused.launches == before + 2
    assert torch.equal(y, ref) and torch.equal(y_made_here, ref)


def test_int8_conv_kernel_at_every_resnet50_shape(cuda):
    """K6 bitwise equal to its plain version at each of ResNet-50's 20
    distinct conv shapes (224 x 224 input, batch 2), f32 and bf16, on the
    route the router gives each (fused at stride 1, lax at stride 2)."""
    from analytics_zoo_tpu_torch.models.image.backbones import resnet50
    from analytics_zoo_tpu_torch.nn.layers import Convolution2D
    from analytics_zoo_tpu_torch.ops import int8 as i8
    from analytics_zoo_tpu_torch.ops import int8_fused as f8

    model = resnet50((224, 224, 3), 1000, device=cuda, seed=0)
    shapes = {}

    def hook(mod, args):
        shapes[(tuple(args[0].shape[1:]), mod.kernel_size[0],
                mod.strides[0], mod.filters)] = mod.padding

    hooks = [layer.register_forward_pre_hook(hook) for layer in model.layers
             if isinstance(layer, Convolution2D)]
    with torch.no_grad():
        model(torch.zeros((1, 224, 224, 3), device=cuda))
    for h in hooks:
        h.remove()
    assert len(shapes) == 20
    rng = np.random.default_rng(3)
    for ((h, w, cin), k, st, cout), padding in shapes.items():
        packed = _packed_kernel_major(rng, (k, k, cin, cout), cuda)
        pads = f8.conv_pads(padding, (h, w), (k, k), (st, st))
        rule = "fused" if st == 1 else "lax"
        x = torch.from_numpy(rng.normal(size=(2, h, w, cin)).astype(
            np.float32)).to(cuda)
        for dtype in I8_DTYPES:
            xd = x.to(dtype)
            y = i8.int8_conv2d(xd, packed, strides=(st, st),
                               padding=padding)
            ref = f8.int8_conv2d_fused_plain(xd, packed, (st, st), pads,
                                             rule)
            assert torch.equal(y, ref), ((h, cin, k, st, cout), dtype)


#: MobileNet v1's packed pointwise convs at 224 x 224 (alpha 1): (px,
#: Cin, Cout) a distinct shape; 12 convs over these 8 (512 -> 512 at 14 px
#: five times); the first, 32 -> 64, has 2048 weights and stays float
MOBILENET_1X1 = [(56, 64, 128), (56, 128, 128), (28, 128, 256),
                 (28, 256, 256), (14, 256, 512), (14, 512, 512),
                 (7, 512, 1024), (7, 1024, 1024)]


@pytest.mark.parametrize("dtype", I8_DTYPES)
@pytest.mark.parametrize("hw,cin,cout", MOBILENET_1X1)
def test_int8_conv_kernel_at_mobilenet_pointwise_shapes(cuda, dtype, hw, cin,
                                                        cout):
    """K6 bitwise equal to its plain version at each of MobileNet v1's
    packed 1x1 shapes at batch 32 (kh = kw = 1, Cin up to 1024, down to
    7 x 7 px), through the router (the fused rule at stride 1)."""
    from analytics_zoo_tpu_torch.ops import int8 as i8
    from analytics_zoo_tpu_torch.ops import int8_fused as f8

    rng = np.random.default_rng(hw * cin + cout)
    packed = _packed_kernel_major(rng, (1, 1, cin, cout), cuda)
    x = torch.from_numpy(rng.normal(size=(32, hw, hw, cin)).astype(
        np.float32)).to(cuda).to(dtype)
    before = f8.int8_conv2d_fused.launches
    y = i8.int8_conv2d(x, packed, strides=(1, 1), padding="SAME")
    ref = f8.int8_conv2d_fused_plain(x, packed, (1, 1), ((0, 0), (0, 0)),
                                     "fused")
    torch.cuda.synchronize()
    assert f8.int8_conv2d_fused.launches == before + 1
    assert y.shape == (32, hw, hw, cout) and torch.equal(y, ref)


@pytest.mark.parametrize("dtype", I8_DTYPES)
def test_int8_matmul_kernel_at_the_mobilenet_head(cuda, dtype):
    """K5 bitwise equal to its plain version at MobileNet's head, (32,
    1024) x (1024, 1000), on the route the router gives it."""
    from analytics_zoo_tpu_torch.ops import int8 as i8
    from analytics_zoo_tpu_torch.ops import int8_fused as f8

    rng = np.random.default_rng(1024)
    packed = _packed_kernel_major(rng, (1024, 1000), cuda)
    x = torch.from_numpy(np.abs(rng.normal(size=(32, 1024))).astype(
        np.float32)).to(cuda).to(dtype)
    blocks = f8.resolve_blocks(32, 1000, 1024)
    block_k, rule = (1024, "lax") if blocks is None else (blocks[2],
                                                          "fused")
    before = f8.int8_matmul_fused.launches
    y = i8.int8_matmul(x, packed)
    ref = f8.int8_matmul_fused_plain(x, packed, block_k, rule)
    torch.cuda.synchronize()
    assert f8.int8_matmul_fused.launches == before + 1
    assert y.shape == (32, 1000) and torch.equal(y, ref)


@pytest.mark.parametrize("dtype", I8_DTYPES)
@pytest.mark.parametrize("r,k,g,rule", [
    (64, 512, 128, "fused"), (100, 4096, 512, "fused"), (7, 300, 100, "lax"),
    (5, 96, 96, "lax"), (33, 3, 3, "fused"), (9, 200, 40, "fused"),
    (3, 8192, 8192, "lax")])
def test_int8_quantize_pass_matches_quantize_groups(cuda, dtype, r, k, g,
                                                    rule):
    """The kernels' quantize pass writes, bit for bit, the codes and scales
    of ``quantize_groups`` per group (codes padded with zeros to 32 bytes
    a group), an all-zero row included, at groups held in registers and at
    a group long enough to be read twice."""
    from analytics_zoo_tpu_torch.ops import int8_fused as f8

    x = (torch.randn((r, k), device=cuda) * 3).to(dtype)
    x[0] = 0
    codes, scales = f8.int8_quantize_rows(x, g, rule)
    torch.cuda.synchronize()
    xf = x.float().cpu().reshape(r, k // g, g)
    q, s = f8.quantize_groups(xf, rule)
    want = torch.nn.functional.pad(q.to(torch.int8), (0, f8.depth_of(g) - g))
    assert torch.equal(codes.cpu(), want.reshape(r, -1))
    assert torch.equal(scales.cpu(), s.reshape(r, k // g))


def test_int8_kernels_refuse_a_kernel_major_copy_of_another_shape(cuda):
    from analytics_zoo_tpu_torch.ops import int8_fused as f8

    rng = np.random.default_rng(1)
    packed = _packed(rng, (256, 64), cuda)
    packed["qt"] = packed["q"].clone()            # (K, N), not (N, K)
    with pytest.raises(ValueError, match="kernel-major"):
        f8.int8_matmul_fused(torch.randn((4, 256), device=cuda), packed, 128)
    packed = _packed(rng, (3, 3, 16, 8), cuda)
    packed["qt"] = packed["q"].clone()
    with pytest.raises(ValueError, match="kernel-major"):
        f8.int8_conv2d_fused(torch.randn((1, 8, 8, 16), device=cuda), packed,
                             (1, 1), ((1, 1), (1, 1)))


def test_int8_routers_launch_the_kernels_on_both_routes(cuda):
    """On CUDA tensors the routers take K5 on both matmul routes and K6 on
    both conv routes; bad inputs raise."""
    from analytics_zoo_tpu_torch.ops import int8 as i8
    from analytics_zoo_tpu_torch.ops import int8_fused as f8

    rng = np.random.default_rng(0)
    x = torch.randn((16, 256), device=cuda)
    for n in (256, 100):                                # fused, lax
        before = f8.int8_matmul_fused.launches
        i8.int8_matmul(x, _packed(rng, (256, n), cuda))
        assert f8.int8_matmul_fused.launches == before + 1
    xi = torch.randn((1, 8, 8, 16), device=cuda)
    for s in (1, 2):
        before = f8.int8_conv2d_fused.launches
        i8.int8_conv2d(xi, _packed(rng, (3, 3, 16, 8), cuda), strides=(s, s),
                       padding="SAME")
        assert f8.int8_conv2d_fused.launches == before + 1
    with pytest.raises(ValueError, match="block_k"):
        f8.int8_matmul_fused(x, _packed(rng, (256, 64), cuda), 100)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        f8.int8_matmul_fused(x.half(), _packed(rng, (256, 64), cuda), 128)


def test_small_int8_resnet_on_card_matches_cpu(cuda):
    """ResNet-50 at 32x32 with 10 classes, quantized: every conv launches
    K6 and the head K5 (53 + 1 per predict), probabilities on the card
    within 1e-4 of the same seeded model on the CPU (plain versions)."""
    from analytics_zoo_tpu_torch.inference.inference_model import \
        InferenceModel
    from analytics_zoo_tpu_torch.models.image.backbones import resnet50
    from analytics_zoo_tpu_torch.ops import int8_fused as f8

    x = np.random.default_rng(0).normal(size=(3, 32, 32, 3)).astype(
        np.float32)
    probs = {}
    for dev in ("cuda", "cpu"):
        im = InferenceModel(max_batch_size=4, device=dev).load(
            resnet50((32, 32, 3), 10, device=dev, seed=2)).quantize_int8()
        k5, k6 = f8.int8_matmul_fused.launches, f8.int8_conv2d_fused.launches
        probs[dev] = im.predict(x)
        if dev == "cuda":
            assert (f8.int8_matmul_fused.launches - k5,
                    f8.int8_conv2d_fused.launches - k6) == (1, 53)
    assert float(np.abs(probs["cuda"] - probs["cpu"]).max()) <= 1e-4


# ----------------------------------------------------------------------- NCF

@pytest.mark.parametrize("kind", ["explicit", "implicit"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_ncf_training_steps_on_card_match_cpu(cuda, kind, dtype, tol):
    """NeuralCF / ImplicitNCF (300 users, 200 items, narrow widths) train
    12 device-cached steps on the card and on the CPU from the same seeded
    weights: per-step losses within 1e-5 relative in f32 and 2e-2 in
    bf16; the implicit negatives drawn on the card equal the CPU's bit for
    bit (they come from the threefry bits, not the scatter)."""
    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.data.datasets import synthetic_movielens
    from analytics_zoo_tpu_torch.models.recommendation import (
        ImplicitNCF, NeuralCF, implicit_bce_loss)

    pairs, ratings = synthetic_movielens(12 * 256, n_users=300,
                                         n_items=200, seed=3)
    widths = dict(user_embed=8, item_embed=8, hidden_layers=(16, 8),
                  mf_embed=8)
    runs = {}
    for dev in (cuda, "cpu"):
        if kind == "implicit":
            model = ImplicitNCF(300, 200, n_negatives=4, device=dev,
                                **widths)
            loss, y = implicit_bce_loss, np.zeros(len(pairs), np.float32)
        else:
            model = NeuralCF(300, 200, 5, device=dev, **widths)
            loss, y = "sparse_categorical_crossentropy", ratings - 1
        negs = []
        if kind == "implicit":
            draw = model.negatives
            model.negatives = lambda p, k: negs.append(draw(p, k)) or negs[-1]
        cfg = TrainConfig(cache_on_device=True, scan_block_steps=1,
                          log_every_n_steps=1,
                          compute_dtype=None if dtype == "float32" else dtype)
        model.compile(optimizer="adam", loss=loss, config=cfg, device=dev)
        model.fit(pairs, y, batch_size=256, nb_epoch=1)
        runs[str(dev)] = ([h["loss"] for h in model.estimator.history],
                          [n.cpu() for n in negs])
    (lg, ng), (lc, nc) = runs[str(cuda)], runs["cpu"]
    assert len(lg) == len(lc) == 12
    for a, b in zip(lg, lc):
        assert abs(a - b) <= tol * abs(b) if dtype == "float32" \
            else abs(a - b) <= tol
    assert len(ng) == len(nc)
    assert all(torch.equal(a, b) for a, b in zip(ng, nc))


@pytest.mark.parametrize("depth", [0, 2, 4])
def test_pinned_copy_stream_equals_the_host_batches_on_card(cuda, depth):
    """``PrefetchLoader`` over ``PinnedCopy`` on the card (pinned staging, a
    side-stream copy, the consumer's stream waiting on its event): every
    batch, read on the consumer's stream after a kernel that overwrites
    the previous batch's storage, equals its host batch, over many
    batches (so freed blocks come back to the side stream)."""
    from analytics_zoo_tpu_torch.data import FeatureSet, PinnedCopy, \
        PrefetchLoader

    rng = np.random.default_rng(depth)
    x = rng.normal(size=(4096, 257)).astype(np.float32)
    y = rng.integers(0, 7, 4096).astype(np.int64)
    fs = FeatureSet((x, y), seed=1)
    want = list(fs.batches(64, epoch=2))
    copy = PinnedCopy(cuda)
    got, prev = [], None
    with PrefetchLoader(fs, 64, epoch=2, put_fn=copy, depth=depth) as ld:
        for item in ld:
            bx, by = copy.ready(item)
            if prev is not None:
                prev.mul_(0).add_(1)          # a step that writes its batch
            got.append((bx.cpu().numpy(), by.cpu().numpy()))
            prev = bx
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gy, wy)
        np.testing.assert_array_equal(gx, wx)


@pytest.mark.parametrize("kind", ["wide_n_deep", "session"])
def test_recommender_steps_on_card_match_cpu_at_every_depth(cuda, kind):
    """Wide & Deep and SessionRecommender (narrow widths) train 6
    streaming f32 steps on the card at prefetch_depth 0 and 2 and on the
    CPU from the same seeded weights: the card's two depths give the same
    bits, and the CPU's losses within 1e-5 relative."""
    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.models.recommendation import (
        SessionRecommender, WideAndDeep)

    rng = np.random.default_rng(5)
    n = 6 * 128
    if kind == "session":
        x = [rng.integers(1, 301, (n, 10)).astype(np.float32),
             rng.integers(0, 301, (n, 10)).astype(np.float32)]
        y = rng.integers(0, 300, n).astype(np.int32)

        def make(dev):
            return SessionRecommender(300, 16, (12, 8), session_length=10,
                                      include_history=True,
                                      mlp_hidden_layers=(16,),
                                      history_length=10, device=dev)
    else:
        cols = dict(wide_base_cols=["a"], wide_base_dims=[9],
                    indicator_cols=["b"], indicator_dims=[4],
                    embed_cols=["u", "i"], embed_in_dims=[700, 90],
                    embed_out_dims=[8, 8], continuous_cols=["c"])
        x = [np.eye(9, dtype=np.float32)[rng.integers(0, 9, n)],
             np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)],
             np.stack([rng.integers(1, 701, n), rng.integers(1, 91, n)],
                      1).astype(np.float32),
             rng.normal(size=(n, 1)).astype(np.float32)]
        y = rng.integers(0, 5, n).astype(np.int32)

        def make(dev):
            return WideAndDeep(5, cols, hidden_layers=(16, 8), device=dev)

    runs = {}
    for dev, depth in ((cuda, 0), (cuda, 2), ("cpu", 2)):
        model = make(dev)
        model.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                      device=dev, config=TrainConfig(prefetch_depth=depth,
                                                     log_every_n_steps=1))
        model.fit(x, y, batch_size=128, nb_epoch=1)
        runs[(str(dev), depth)] = [h["loss"] for h in model.estimator.history]
    card0, card2, cpu = runs[(str(cuda), 0)], runs[(str(cuda), 2)], \
        runs[("cpu", 2)]
    assert len(card0) == len(cpu) == 6
    assert card0 == card2
    for a, b in zip(card2, cpu):
        assert abs(a - b) <= 1e-5 * abs(b)


# -------------------------------------------------- the serving remainder

def _lm_pair(cuda, **extra):
    kw = dict(vocab=128, hidden_size=64, n_block=2, n_head=4, seq_len=64,
              attn_strategy="flash", seed=3, **extra)
    return TransformerLM(device=cuda, **kw), TransformerLM(device="cpu", **kw)


def test_preempted_stream_resumes_on_card_as_on_cpu(cuda):
    """One slot: a critical request preempts the bulk stream at its third
    token (from the loop thread); on the card (K1, K2) the streams and the
    finish order equal the CPU's, and the bulk stream equals an
    uninterrupted run's."""
    from analytics_zoo_tpu_torch.serving.generation import ContinuousBatcher

    got = []
    for dev, model in zip((cuda, "cpu"), _lm_pair(cuda)):
        ref = ContinuousBatcher(model, n_slots=1, page_size=16,
                                max_seq_len=64, device=dev)
        try:
            want = ref.generate([5, 6, 7, 8], max_new_tokens=10)
        finally:
            ref.close()
        b = ContinuousBatcher(model, n_slots=1, page_size=16, max_seq_len=64,
                              device=dev)
        order, toks = [], {"bulk": [], "crit": []}

        def on(name):
            def cb(tokens, final, meta):
                toks[name].extend(tokens)
                if final:
                    order.append(name)
                if name == "bulk" and len(toks["bulk"]) == 3 and not final:
                    b.submit([9, 10, 11], max_new_tokens=4,
                             priority="critical", on_chunk=on("crit"))
            return cb
        try:
            b.submit([5, 6, 7, 8], max_new_tokens=10, priority="bulk",
                     on_chunk=on("bulk")).result(timeout_s=120)
            import time
            deadline = time.monotonic() + 60
            while len(order) < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
            st = b.stats()
        finally:
            b.close()
        assert toks["bulk"] == want and order == ["crit", "bulk"]
        assert st["preemptions"] == 1 and st["preempted_parked"] == 0
        assert b.pool.free_count() == b.pool.capacity
        got.append((toks, order))
    assert got[0] == got[1]


def test_swap_params_on_card_equals_a_fresh_batcher(cuda):
    """A swap to the weights x 1.01 with spec k 3 lands between steps on
    the card: the staged copy waits on its event, the flip swaps
    references, the stream survives, and a request after the swap gives a
    fresh spec_k=3 batcher's tokens on the same weights."""
    from analytics_zoo_tpu_torch.serving.generation import ContinuousBatcher

    model, _ = _lm_pair(cuda)
    params2 = {n: (p.detach().float() * 1.01).to(p.dtype).cpu()
               for n, p in model.named_parameters()}
    b = ContinuousBatcher(model, n_slots=2, page_size=16, max_seq_len=64,
                          device=cuda, prefix_cache_pages=8)
    toks = []

    def cb(tokens, final, meta):
        toks.extend(tokens)
        if len(toks) >= 2 and not hasattr(cb, "sent"):
            cb.sent = True
            b.swap_params(params2, version="v2",
                          spec={"k": 3, "max_ngram": 2})
    try:
        b.submit(list(range(1, 20)), max_new_tokens=20, on_chunk=cb).result(
            timeout_s=120)
        after = b.generate([3, 1, 4, 1, 5], max_new_tokens=8)
        host = b.host_params()
        assert b.swaps == 1 and b.version == "v2" and b.spec_k == 3
    finally:
        b.close()
    assert len(toks) == 20
    assert all(host[n].equal(params2[n]) for n in params2)
    assert all(p.device.type == torch.device(cuda).type
               for p in model.parameters())
    fresh = ContinuousBatcher(model, n_slots=2, page_size=16, max_seq_len=64,
                              device=cuda, spec_k=3, spec_ngram=2)
    try:
        assert fresh.generate([3, 1, 4, 1, 5], max_new_tokens=8) == after
    finally:
        fresh.close()


def test_chaos_kill_on_card_keeps_streams(cuda):
    from analytics_zoo_tpu_torch.common.chaos import ChaosSchedule
    from analytics_zoo_tpu_torch.serving.generation import ContinuousBatcher

    model, _ = _lm_pair(cuda)
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10]]

    def burst():
        b = ContinuousBatcher(model, n_slots=2, page_size=16,
                              max_seq_len=64, device=cuda)
        try:
            hs = [b.submit(p, max_new_tokens=8, temperature=0.5, seed=i)
                  for i, p in enumerate(prompts)]
            return [h.result(timeout_s=120) for h in hs], b.loop_respawns
        finally:
            b.close()

    clean = burst()
    with ChaosSchedule(seed=1).kill("serving.generate", at=5):
        killed = burst()
    assert killed == (clean[0], 1) and clean[1] == 0


def _int8_mlp(dev, seed=0):
    from analytics_zoo_tpu_torch.nn.layers import Dense
    from analytics_zoo_tpu_torch.nn.topology import Sequential

    return Sequential([Dense(256, activation="relu", input_shape=(256,)),
                       Dense(64, activation="softmax")], device=dev,
                      seed=seed)


def test_int8_swap_on_card_serves_the_repacked_kernels(cuda):
    """A quantized InferenceModel swapped to new weights re-packs them and
    serves through K5 bit for bit what a fresh model quantized from them
    serves; no plain version runs."""
    from analytics_zoo_tpu_torch.inference.inference_model import \
        InferenceModel
    from analytics_zoo_tpu_torch.ops import int8_fused as f8

    x = np.random.default_rng(0).normal(size=(8, 256)).astype(np.float32)
    im = InferenceModel(max_batch_size=8, device=cuda).load(
        _int8_mlp(cuda)).quantize_int8()
    old = im.predict(x)
    params2 = {n: t * 1.01 for n, t in im.host_params().items()}
    ref = InferenceModel(max_batch_size=8, device=cuda).load(
        _int8_mlp(cuda))
    ref.swap_params(params2)
    ref.quantize_int8()
    f8.int8_matmul_fused.launches = 0
    im.swap_params(params2, version="v2")
    got = im.predict(x)
    assert f8.int8_matmul_fused.launches >= 2
    np.testing.assert_array_equal(got, ref.predict(x))
    assert not np.array_equal(got, old)
    assert im.last_served_version() == "v2"


def test_weight_only_on_card_holds_int8_and_equals_the_dequantized(cuda):
    """A model with no int8-computable layer packs its embedding table
    weight-only: the card holds the table's int8 codes and scales and no
    float copy, and the predict equals, bit for bit, a float model that
    holds the table's ``q * scale``."""
    from analytics_zoo_tpu_torch.inference.inference_model import \
        InferenceModel, _quantize_leaf
    from analytics_zoo_tpu_torch.nn.layers import GRU, Dense, Embedding
    from analytics_zoo_tpu_torch.nn.topology import Sequential

    def model():
        return Sequential([Embedding(500, 32, input_shape=(5,)), GRU(8),
                           Dense(4, activation="softmax")], device=cuda,
                          seed=0)

    x = np.random.default_rng(0).integers(0, 500, size=(16, 5)).astype(
        np.int32)
    im = InferenceModel(max_batch_size=16, device=cuda).load(
        model()).quantize_int8()
    name = "0_embedding.embeddings"
    table = im._module.get_parameter(name)
    assert table.q.dtype == torch.int8 and table.q.is_cuda
    assert not any(type(t) is torch.nn.Parameter and t.shape == table.shape
                   for t in im._module.parameters())
    plain = model()
    with torch.no_grad():
        w = plain.get_parameter(name)
        packed = _quantize_leaf(w.cpu().numpy())
        w.copy_(torch.from_numpy(packed["q"].astype(np.float32)
                                 * packed["scale"]))
    ref = InferenceModel(max_batch_size=16, device=cuda).load(plain)
    np.testing.assert_array_equal(im.predict(x), ref.predict(x))


def test_row_delta_on_card_equals_a_full_swap(cuda, tmp_path):
    from analytics_zoo_tpu_torch.bridge import nest
    from analytics_zoo_tpu_torch.engine import checkpoint as ck
    from analytics_zoo_tpu_torch.inference.inference_model import \
        InferenceModel
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF

    x = np.stack([np.arange(1, 201) % 50 + 1, np.arange(200) % 30 + 1],
                 1).astype(np.int32)
    im = InferenceModel(max_batch_size=256, device=cuda).load(
        NeuralCF(50, 30, class_num=5, device=cuda))
    base = im.host_params()
    p2 = dict(base)
    table = "0_fusedpairembedding.embeddings"
    p2[table] = base[table].clone()
    p2[table][[3, 7]] += 0.5
    b = ck.save_checkpoint(str(tmp_path), nest(base), iteration=1, epoch=0)
    d = ck.save_row_delta(str(tmp_path), nest(p2), b, iteration=2)
    entries, _ = ck.read_row_delta(d, im.load_avals)
    before = im.predict(x)
    im.apply_row_delta(entries)
    got = im.predict(x)
    full = InferenceModel(max_batch_size=256, device=cuda).load(
        NeuralCF(50, 30, class_num=5, device=cuda))
    full.swap_params(p2)
    np.testing.assert_array_equal(got, full.predict(x))
    hit = np.isin(x[:, 0], [3, 7])
    np.testing.assert_array_equal(got[~hit], before[~hit])
    assert not np.array_equal(got[hit], before[hit])


# ----------------------------------------------------------- the data plane

def test_data_plane_int8_queue_serving_on_card(cuda):
    """An int8 ResNet-50 (80 px, 10 classes) behind ClusterServing on the
    card, images (76.8 KB each, over the shm ring) through the port's
    broker: every answer bit for bit the direct predict of its image, K6 =
    53 and K5 = 1 per batch the engine dispatched."""
    from analytics_zoo_tpu_torch.inference.inference_model import \
        InferenceModel
    from analytics_zoo_tpu_torch.models.image.backbones import resnet50
    from analytics_zoo_tpu_torch.ops import int8_fused as f8
    from analytics_zoo_tpu_torch.serving import (ClusterServing, InputQueue,
                                                 OutputQueue, ServingConfig,
                                                 start_broker)
    from analytics_zoo_tpu_torch.serving.wire import wire_stats

    x = np.random.default_rng(0).normal(size=(12, 80, 80, 3)).astype(
        np.float32)
    im = InferenceModel(max_batch_size=8, device=cuda).load(
        resnet50((80, 80, 3), 10, device=cuda, seed=2))
    broker = start_broker()
    job = ClusterServing(im, ServingConfig(
        queue_port=broker.port, batch_size=8, int8=True,
        warmup_shape=(80, 80, 3)), group="card").start()
    try:
        direct = im.predict(x)
        calls, predict = [0], im.predict

        def counted(b):
            calls[0] += 1
            return predict(b)

        im.predict = counted
        f8.int8_matmul_fused.launches = f8.int8_conv2d_fused.launches = 0
        shm = wire_stats()["shm_bytes"]
        iq, oq = InputQueue(port=broker.port), OutputQueue(port=broker.port)
        uris = [iq.enqueue(None, input=x[i]) for i in range(len(x))]
        got = np.stack([oq.query(u, timeout_s=120) for u in uris])
        iq.close()
        oq.close()
    finally:
        job.stop()
        broker.shutdown()
        broker.server_close()
    np.testing.assert_array_equal(got, direct)
    assert wire_stats()["shm_bytes"] > shm
    assert f8.int8_conv2d_fused.launches == 53 * calls[0]
    assert f8.int8_matmul_fused.launches == calls[0] > 0


def test_data_plane_generation_on_card_matches_the_batcher(cuda):
    """GenerationEngine on the card streams, through the broker, the tokens
    a ContinuousBatcher on the card gives for the same requests, with K1
    once per prefill and layer and K2 once per decode step and layer."""
    from analytics_zoo_tpu_torch.serving import ServingConfig, start_broker
    from analytics_zoo_tpu_torch.serving.generation import (
        ContinuousBatcher, GenerationClient, GenerationEngine)

    kw = dict(vocab=256, hidden_size=64, n_block=2, n_head=4, seq_len=128,
              seed=0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 256, int(n)).astype(np.int32)
               for n in (5, 17, 33, 9)]
    direct = ContinuousBatcher(TransformerLM(device=cuda, **kw), n_slots=4,
                               page_size=8, max_seq_len=96, device=cuda)
    want = [direct.generate(p, max_new_tokens=12) for p in prompts]
    direct.close()
    broker = start_broker()
    cfg = ServingConfig(queue_port=broker.port, gen_slots=4, gen_page_size=8,
                        gen_max_seq_len=96)
    eng = GenerationEngine(TransformerLM(device=cuda, **kw), config=cfg,
                           device=cuda).start()
    client = GenerationClient(port=broker.port)
    try:
        tfa.flash_attention_fwd.launches = tpa.paged_attention.launches = 0
        got = [client.generate(p, max_new_tokens=12, timeout_s=120)
               for p in prompts]
        d = eng.batcher.stats()["dispatches"]
        k1, k2 = tfa.flash_attention_fwd.launches, \
            tpa.paged_attention.launches
    finally:
        client.close()
        eng.stop()
        broker.shutdown()
        broker.server_close()
    assert got == want
    assert k1 == 2 * d["prefill"] == 2 * len(prompts)
    assert k2 == 2 * d["decode"] > 0


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_data_plane_swapper_flips_the_staged_tensors_on_card(
        cuda, tmp_path, monkeypatch, int8):
    """ModelSwapper on the card, float or int8: the checkpoint's leaves
    (re-packed for an int8 model) cross to the card once, from host
    tensors through one side-stream staging; the probe runs on those
    tensors (K5 on the int8 model) and the flip installs them by
    reference; the answers equal a fresh model swapped to the new
    weights, bit for bit."""
    from analytics_zoo_tpu_torch.bridge import nest
    from analytics_zoo_tpu_torch.engine import checkpoint as ck
    from analytics_zoo_tpu_torch.inference import inference_model as tim
    from analytics_zoo_tpu_torch.ops import int8_fused as f8
    from analytics_zoo_tpu_torch.serving.hotswap import (ModelSwapper,
                                                         publish_record)

    def model():
        im = tim.InferenceModel(max_batch_size=8, device=cuda).load(
            _int8_mlp(cuda))
        return im.quantize_int8() if int8 else im

    im = model()
    params2 = {n: t * 1.01 for n, t in im.host_params().items()}
    path = ck.save_checkpoint(str(tmp_path), nest(params2), iteration=1,
                              epoch=0)
    crossings, stage = [], tim.stage_tensors

    def counted(tensors, *a, **k):
        crossings.append(all(t.device.type == "cpu"
                             for t in tensors.values()))
        return stage(tensors, *a, **k)

    monkeypatch.setattr(tim, "stage_tensors", counted)
    sw = ModelSwapper(im, probe_shape=(256,))
    f8.int8_matmul_fused.launches = 0
    staged = sw.stage(publish_record(path))
    assert crossings == [True]
    assert f8.int8_matmul_fused.launches == (2 if int8 else 0)
    assert all(t.is_cuda for t in staged.tensors.values())
    sw.swap(staged, publish_record(path))
    assert crossings == [True]
    held = {t.data_ptr() for t in im._module.parameters()} | \
        {t.data_ptr() for t in im._module.buffers()}
    assert all(t.data_ptr() in held for t in staged.tensors.values())
    monkeypatch.undo()
    ref = model()
    ref.swap_params(params2)
    x = np.random.default_rng(2).normal(size=(8, 256)).astype(np.float32)
    np.testing.assert_array_equal(im.predict(x), ref.predict(x))


def test_files_and_sets_dropout_masks_on_card_are_the_cpu_bits(cuda):
    from analytics_zoo_tpu_torch.common import prng
    from analytics_zoo_tpu_torch.nn.layers import Dropout

    for seed, shape, p in ((0, (7,), 0.5), (3, (4, 33, 65), 0.9),
                           (9, (2, 1024), 0.1)):
        key = prng.fold_in(prng.PRNGKey(seed), 1)
        assert torch.equal(prng.bernoulli(key, p, shape),
                           prng.bernoulli(key, p, shape, device=cuda).cpu())
        u = prng.uniform(key, shape, -1.5, 2.0)
        assert torch.equal(u, prng.uniform(key, shape, -1.5, 2.0,
                                           device=cuda).cpu())
    layer = Dropout(0.3).train()
    x = torch.randn(16, 48)
    key = prng.PRNGKey(4)
    assert torch.equal(layer(x, rng=key),
                       layer(x.to(cuda), rng=key).cpu())


def test_files_and_sets_text_classifier_trains_on_card_as_on_cpu(cuda):
    from analytics_zoo_tpu_torch.data.text import TextSet
    from analytics_zoo_tpu_torch.models.textclassification import \
        TextClassifier

    rng = np.random.default_rng(0)
    words = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta"]
    labels = rng.integers(0, 3, 64)
    texts = [" ".join(rng.choice(words[c * 2:c * 2 + 3], 9)) for c in labels]
    ts = (TextSet.from_texts(texts, labels.tolist()).tokenize().normalize()
          .word2idx().shape_sequence(10))
    losses = {}
    for dev in ("cpu", "cuda"):
        m = TextClassifier(3, sequence_length=10, encoder="cnn",
                           encoder_output_dim=16, vocab_size=10,
                           embed_dim=8, device=dev)
        m.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                  config=None)
        m.estimator.config.log_every_n_steps = 1
        m.fit(ts, batch_size=16, nb_epoch=2)
        losses[dev] = [h["loss"] for h in m.estimator.history]
    assert len(losses["cuda"]) == 8
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5,
                               atol=1e-6)


# ----------------------------------------------------- multi-rank attention
def _mr_inputs(dtype, device, b=1, t=256, h=4, d=64, seed=11):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn((b, t, h, d), generator=g).to(device=device,
                                                      dtype=dtype)
            for _ in range(4)]


@pytest.mark.parametrize("dtype,tol", TOLS)
def test_multi_rank_ring_blocks_and_lse_merge_on_card(cuda, dtype, tol):
    """One process: q's second half against K/V in two blocks (past block
    dense, diagonal block causal), K1 per block merged by the LSEs, equals
    the plain causal attention over the whole sequence for those rows; K3
    and K4 per block with the global lse and delta sum to the plain
    backward's dq and give each block's dk/dv."""
    from analytics_zoo_tpu_torch.ops.attention import _merge_blocks

    q, k, v, g = _mr_inputs(dtype, cuda)
    t = q.shape[1]
    c = t // 2
    out_ref, lse_ref = tfa.flash_attention_plain(q, k, v, True)
    dq_ref, dk_ref, dv_ref = tfa.flash_attention_bwd_plain(
        q, k, v, out_ref, lse_ref, g, True)
    qh = q[:, c:].contiguous()
    blocks = [(k[:, :c].contiguous(), v[:, :c].contiguous(), False),
              (k[:, c:].contiguous(), v[:, c:].contiguous(), True)]
    o = torch.zeros(qh.shape, dtype=torch.float32, device=cuda)
    lse = torch.full((1, 4, c), -1e30, device=cuda)
    for kb, vb, flag in blocks:
        ob, lb = tfa.flash_attention_fwd(qh, kb, vb, flag)
        o, lse = _merge_blocks(o, lse, ob, lb)
    out = o.to(dtype)
    assert (out.float() - out_ref[:, c:].float()).abs().max() <= tol
    assert (lse - lse_ref[..., c:]).abs().max() <= tol
    gh = g[:, c:].contiguous()
    delta = tfa.flash_bwd_delta(out, gh)
    lse = lse.contiguous()
    dq = torch.zeros(qh.shape, dtype=torch.float32, device=cuda)
    for i, (kb, vb, flag) in enumerate(blocks):
        dq += tfa.flash_attention_bwd_dq(qh, kb, vb, gh, lse, delta,
                                         flag).float()
        dk, dv = tfa.flash_attention_bwd_dkv(qh, kb, vb, gh, lse, delta,
                                             flag)
        # the second half of q contributes this much to each block's dk/dv
        _, dk_want, dv_want = tfa.flash_attention_bwd_plain(
            q, k, v, out_ref, lse_ref,
            torch.cat([torch.zeros_like(g[:, :c]), gh], 1), True)
        sl = slice(i * c, (i + 1) * c)
        scale = max(1.0, float(dk_want.float().abs().max()))
        assert (dk.float() - dk_want[:, sl].float()).abs().max() \
            <= tol * scale
        assert (dv.float() - dv_want[:, sl].float()).abs().max() \
            <= tol * scale
    scale = max(1.0, float(dq_ref.float().abs().max()))
    assert (dq - dq_ref[:, c:].float()).abs().max() <= tol * scale


def _mr_rank(strategy, causal, dtype_name):
    """Rank side (2 ranks on the card): the strategy's output and grads
    and this rank's K1/K3/K4 launches."""
    from analytics_zoo_tpu_torch.common.config import MeshConfig
    from analytics_zoo_tpu_torch.common.context import (init_zoo_context,
                                                        reset_zoo_context)
    from analytics_zoo_tpu_torch.ops.attention import sharded_attention

    dtype = getattr(torch, dtype_name)
    ctx = init_zoo_context(mesh=MeshConfig(sp=2))
    try:
        q, k, v, g = _mr_inputs(dtype, "cuda")
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        for fn in (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
                   tfa.flash_attention_bwd_dkv):
            fn.launches = 0
        out = sharded_attention(*leaves, ctx.mesh, strategy=strategy,
                                causal=causal)
        grads = torch.autograd.grad(out, leaves, g)
        torch.cuda.synchronize()
        counts = (tfa.flash_attention_fwd.launches,
                  tfa.flash_attention_bwd_dq.launches,
                  tfa.flash_attention_bwd_dkv.launches)
        return (out.detach().float().cpu().numpy(),
                [x.float().cpu().numpy() for x in grads], counts,
                ctx.mesh.coords["sp"])
    finally:
        reset_zoo_context()


@pytest.fixture(scope="module")
def card_pool():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the port's kernels have no "
                    "CPU mode")
    from analytics_zoo_tpu_torch.parallel import comm

    # build the kernels here, once, before any rank loads them
    q = torch.zeros((1, 8, 1, 64), device="cuda", dtype=torch.bfloat16)
    tfa.flash_attention_fwd(q, q, q, True)
    tfa.flash_attention_bwd(q, q, q, q, torch.zeros((1, 1, 8),
                                                    device="cuda"), q, True)
    pool = comm.RankPool(2, device="cuda", threads=0, timeout_s=300)
    yield pool
    pool.close()


@pytest.mark.parametrize("strategy,causal", [("ring", True),
                                             ("ring", False),
                                             ("zigzag", True)])
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_multi_rank_two_processes_on_card(cuda, card_pool, strategy, causal,
                                          dtype, tol):
    q, k, v, g = _mr_inputs(dtype, cuda)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = tfa.flash_attention(*leaves, causal)
    ref_grads = torch.autograd.grad(ref, leaves, g)
    res = card_pool.run(_mr_rank, strategy, causal, str(dtype).split(".")[1])
    for out, grads, counts, idx in res:
        assert np.abs(out - ref.detach().float().cpu().numpy()).max() <= tol
        for got, want in zip(grads, ref_grads):
            want = want.float().cpu().numpy()
            scale = max(1.0, float(np.abs(want).max()))
            assert np.abs(got - want).max() <= tol * scale
        n = (2 * 2 + 1) if strategy == "zigzag" else \
            (idx + 1 if causal else 2)
        assert counts == (n, n, n), counts


def _nccl_rank(seed):
    """Rank side, one card a rank: every collective's forward and backward
    on CUDA tensors over dp = world, and the causal flash ring over sp =
    world beside the one-process flash attention on the same inputs."""
    import torch.distributed as dist

    from analytics_zoo_tpu_torch.common.config import MeshConfig
    from analytics_zoo_tpu_torch.common.context import (init_zoo_context,
                                                        reset_zoo_context)
    from analytics_zoo_tpu_torch.ops.attention import sharded_attention
    from analytics_zoo_tpu_torch.parallel import comm

    n, r = dist.get_world_size(), dist.get_rank()
    ctx = init_zoo_context(mesh=MeshConfig(dp=n))
    try:
        backend = dist.get_backend(ctx.mesh.axis("dp").group)
        xs = np.random.default_rng(seed).standard_normal(
            (n, 4 * n, 6)).astype(np.float32)
        ops = {"all_gather": lambda t: comm.all_gather(t, "dp", tiled=True),
               "psum": lambda t: comm.psum(t, "dp"),
               "psum_scatter": lambda t: comm.psum_scatter(t, "dp",
                                                           tiled=True),
               "all_to_all": lambda t: comm.all_to_all(t, "dp", 0, 1),
               "ppermute": lambda t: comm.ppermute(t, "dp",
                                                   comm.ring_perm(n))}
        out = {}
        for i, (name, fn) in enumerate(ops.items()):
            x = torch.tensor(xs[r], device="cuda", requires_grad=True)
            y = fn(x)
            g = torch.tensor(np.random.default_rng(seed + 10 * i + r)
                             .standard_normal(tuple(y.shape))
                             .astype(np.float32), device="cuda")
            (dx,) = torch.autograd.grad(y, x, g)
            out[name] = tuple(a.detach().cpu().numpy() for a in (y, dx, g))
    finally:
        reset_zoo_context()
    ctx = init_zoo_context(mesh=MeshConfig(sp=n))
    try:
        q, k, v, g = _mr_inputs(torch.float32, "cuda")
        leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
        ref = tfa.flash_attention(*leaves, True)
        ref_grads = torch.autograd.grad(ref, leaves, g)
        leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
        o = sharded_attention(*leaves, ctx.mesh, strategy="ring",
                              causal=True)
        grads = torch.autograd.grad(o, leaves, g)
        ring_err = max(float((a.detach() - b.detach()).abs().max())
                       for a, b in zip((o, *grads), (ref, *ref_grads)))
    finally:
        reset_zoo_context()
    return backend, xs, out, ring_err


def _collective_oracle(name, xs, gs):
    """numpy forward and backward of ``name`` over the per-rank inputs
    ``xs`` (n, 4n, 6) and cotangents ``gs`` (rank order)."""
    n, rows = len(xs), xs.shape[1] // len(xs)
    blk = [slice(i * rows, (i + 1) * rows) for i in range(n)]
    if name == "all_gather":
        m = xs.shape[1]
        return ([np.concatenate(xs, 0)] * n,
                [sum(g[i * m:(i + 1) * m] for g in gs) for i in range(n)])
    if name == "psum":
        return [xs.sum(0)] * n, [sum(gs)] * n
    if name == "psum_scatter":
        return ([xs.sum(0)[blk[i]] for i in range(n)],
                [np.concatenate(gs, 0)] * n)
    if name == "all_to_all":
        w = xs.shape[2]
        return ([np.concatenate([xs[j][blk[i]] for j in range(n)], 1)
                 for i in range(n)],
                [np.concatenate([gs[j][:, i * w:(i + 1) * w]
                                 for j in range(n)], 0) for i in range(n)])
    return ([xs[(i - 1) % n] for i in range(n)],
            [gs[(i + 1) % n] for i in range(n)])


def test_collectives_and_ring_on_nccl_across_cards(cuda):
    """Ranks on cards of their own take NCCL by default
    (``comm.default_backend``): every collective and its transpose equal
    numpy's, and the causal flash ring over sp = cards gives the
    one-process flash forward and grads (f32, 1e-4)."""
    from analytics_zoo_tpu_torch.parallel import comm

    n = min(4, torch.cuda.device_count())
    if n < 2:
        pytest.skip("needs two or more cards: NCCL refuses ranks that "
                    "share one card")
    # build the kernels here, once, before any rank loads them
    q = torch.zeros((1, 8, 1, 64), device="cuda")
    tfa.flash_attention_fwd(q, q, q, True)
    tfa.flash_attention_bwd(q, q, q, q, torch.zeros((1, 1, 8),
                                                    device="cuda"), q, True)
    with comm.RankPool(n, threads=0, timeout_s=300) as pool:
        res = pool.run(_nccl_rank, 5)
    assert [r[0] for r in res] == ["nccl"] * n
    xs = res[0][1]
    for name in res[0][2]:
        gs = [r[2][name][2] for r in res]
        want_out, want_grad = _collective_oracle(name, xs, gs)
        for i, r in enumerate(res):
            y, dx, _ = r[2][name]
            np.testing.assert_allclose(y, want_out[i], rtol=1e-6, atol=1e-5,
                                       err_msg=f"{name} rank {i}")
            np.testing.assert_allclose(dx, want_grad[i], rtol=1e-6,
                                       atol=1e-5, err_msg=f"d{name} rank {i}")
    assert max(r[3] for r in res) <= 1e-4, [r[3] for r in res]


# ------------------------------------------------------- fsdp and tp
@pytest.mark.parametrize("heads", [4, 8])
def test_multi_rank_flash_kernels_at_local_head_counts(cuda, heads):
    """K1, K3 and K4 on a tp rank's heads (the LM cell's 16 heads over
    tp=4 and tp=2), as the layer hands them over: bf16 q/k/v views of one
    (B, T, 3, heads, 64) QKV block, against their plain versions within
    2e-2 (gradients relative to max(1, max|plain|))."""
    g = torch.Generator(device=cuda).manual_seed(heads)
    qkv = torch.randn((2, 512, 3, heads, 64), generator=g,
                      device=cuda).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    go = torch.randn((2, 512, heads, 64), generator=g,
                     device=cuda).to(torch.bfloat16)
    before = [f.launches for f in (tfa.flash_attention_fwd,
                                   tfa.flash_attention_bwd_dq,
                                   tfa.flash_attention_bwd_dkv)]
    out, lse = tfa.flash_attention_fwd(q, k, v, True)
    ref, ref_lse = tfa.flash_attention_plain(q, k, v, True)
    delta = tfa.flash_bwd_delta(out, go)
    dq = tfa.flash_attention_bwd_dq(q, k, v, go, lse, delta, True)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, go, lse, delta, True)
    rq = tfa.flash_attention_bwd_dq_plain(q, k, v, go, lse, delta, True)
    rk, rv = tfa.flash_attention_bwd_dkv_plain(q, k, v, go, lse, delta, True)
    torch.cuda.synchronize()
    after = [f.launches for f in (tfa.flash_attention_fwd,
                                  tfa.flash_attention_bwd_dq,
                                  tfa.flash_attention_bwd_dkv)]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    assert float((out.float() - ref.float()).abs().max()) <= 2e-2
    assert float((lse - ref_lse).abs().max()) <= 2e-2
    for got, want in ((dq, rq), (dk, rk), (dv, rv)):
        scale = max(1.0, float(want.float().abs().max()))
        assert float((got.float() - want.float()).abs().max()) \
            <= 2e-2 * scale


#: the small LM of the on-card fsdp x tp case (4 heads: 2 a tp rank)
TP_LM = dict(vocab=64, hidden_size=64, n_block=2, n_head=4, seq_len=64)


def _tp_fsdp_fit(device, axes):
    """Two f32 Adam steps of the small LM with flash attention (and remat
    "flash"); on ``axes`` with the JAX rules when given. Losses and the
    params gathered whole."""
    from analytics_zoo_tpu_torch.common.config import MeshConfig, TrainConfig
    from analytics_zoo_tpu_torch.common.context import (init_zoo_context,
                                                        reset_zoo_context)
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.models.transformer import lm_loss
    from analytics_zoo_tpu_torch.nn import optimizers as topt
    from analytics_zoo_tpu_torch.parallel.sharding import make_param_sharding

    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = init_zoo_context(mesh=MeshConfig(**axes)) if axes else None
    try:
        tm = TransformerLM(**TP_LM, attn_strategy="flash", remat="flash",
                           device=device, seed=4)
        rules = make_param_sharding(ctx.mesh) if ctx else None
        est = Estimator(tm, optimizer=topt.Adam(lr=1e-2, epsilon=1e-4),
                        loss=lm_loss, param_sharding=rules,
                        config=TrainConfig(log_every_n_steps=1,
                                           shuffle=False))
        ids = np.random.default_rng(6).integers(
            0, TP_LM["vocab"], size=(8, TP_LM["seq_len"] + 1))
        est.fit((ids[:, :-1], ids[:, 1:]), batch_size=4, epochs=1)
        return ([h["loss"] for h in est.history],
                {n: est._full(n, p.detach()).float().cpu().numpy()
                 for n, p in tm.named_parameters()},
                tfa.flash_attention_fwd.launches)
    finally:
        if ctx is not None:
            reset_zoo_context()


def test_multi_rank_tp2_fsdp2_on_card_matches_cpu(cuda):
    """4 rank processes on the card, tp=2 x fsdp=2 (Megatron blocks on 2
    heads a rank, vocab-parallel head and loss, fsdp blocks gathered at
    use; K1/K3/K4 on the card): two f32 steps give the one-process CPU
    run's losses and params within 1e-4."""
    from analytics_zoo_tpu_torch.parallel import comm

    q = torch.zeros((1, 8, 1, 16), device="cuda")
    tfa.flash_attention_fwd(q, q, q, True)
    tfa.flash_attention_bwd(q, q, q, q, torch.zeros((1, 1, 8),
                                                    device="cuda"), q, True)
    with comm.RankPool(4, device="cuda", threads=0, timeout_s=300) as pool:
        res = pool.run(_tp_fsdp_fit, "cuda", dict(fsdp=2, tp=2))
    want, wparams, _ = _tp_fsdp_fit("cpu", None)
    for losses, params, launches in res:
        assert launches == 2 * TP_LM["n_block"]
        np.testing.assert_allclose(losses, want, rtol=0, atol=1e-4)
        for n, v in wparams.items():
            np.testing.assert_allclose(params[n], v, rtol=0, atol=1e-4,
                                       err_msg=n)


# ----------------------------------------------------------- analysis tier

def _analysis_cases(cuda):
    """``name -> (wrapper, launch counter owner, args, kwargs)`` at small
    shapes, every input on the card."""
    from analytics_zoo_tpu_torch.ops import int8_fused as f8

    g = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (torch.randn((2, 64, 4, 64), generator=g, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    out, lse = tfa.flash_attention_fwd(q, k, v, True)
    gr = torch.randn(out.shape, generator=g, device=cuda).to(torch.bfloat16)
    delta = tfa.flash_bwd_delta(out, gr)
    paged = tpa.synthetic_paged_case(2, 4, 16, 4, 64, dtype=torch.bfloat16,
                                     device=cuda)
    rng = np.random.default_rng(3)
    scaled = torch.randn((4, 1000), generator=g, device=cuda)
    return {
        "K1": (tfa.flash_attention_fwd, tfa.flash_attention_fwd,
               (q, k, v, True), {}),
        "K3": (tfa.flash_attention_bwd_dq, tfa.flash_attention_bwd_dq,
               (q, k, v, gr, lse, delta, True), {}),
        "K4": (tfa.flash_attention_bwd_dkv, tfa.flash_attention_bwd_dkv,
               (q, k, v, gr, lse, delta, True), {}),
        "K2": (tpa.paged_attention, tpa.paged_attention, paged,
               {"page_size": 16}),
        "K5": (f8.int8_matmul_fused, f8.int8_matmul_fused,
               (torch.randn((8, 256), generator=g, device=cuda),
                _packed_kernel_major(rng, (256, 128), cuda), 128), {}),
        "K6": (f8.int8_conv2d_fused, f8.int8_conv2d_fused,
               (torch.randn((1, 8, 8, 16), generator=g, device=cuda),
                _packed_kernel_major(rng, (3, 3, 16, 32), cuda), (1, 1),
                ((1, 1), (1, 1))), {}),
        "sampler": (kvc.gumbel_max, kvc.gumbel_max,
                    (scaled, [0, 2], [1, 2], [0, 0]), {}),
    }


@pytest.mark.parametrize("name", ["K1", "K2", "K3", "K4", "K5", "K6",
                                  "sampler"])
def test_analysis_trace_branch_records_the_launch_shapes(cuda, name):
    """While a trace records, each wrapper launches nothing and records one
    site whose outputs have the shapes and dtypes its launch produces."""
    from torch.utils._pytree import tree_leaves

    from analytics_zoo_tpu_torch.analysis import trace_call

    fn, owner, args, kwargs = _analysis_cases(cuda)[name]
    real = [t for t in tree_leaves(fn(*args, **kwargs))
            if isinstance(t, torch.Tensor)]
    torch.cuda.synchronize()
    launches = owner.launches
    tr = trace_call(fn, *args, **kwargs)
    assert owner.launches == launches
    sites = tr.sites("kernel")
    assert [s.name for s in sites] == [name]
    assert [(o.shape, o.dtype, o.device.split(":")[0])
            for o in sites[0].outputs] == \
        [(tuple(t.shape), str(t.dtype).replace("torch.", ""), "cuda")
         for t in real]


def test_analysis_decode_trace_on_the_card(cuda):
    """The decode warm-up's trace of a model on the card: one K2 site a
    block and the sampler, no host read, no launch; the check is clean."""
    from analytics_zoo_tpu_torch.analysis.rules.decode import trace_decode
    from analytics_zoo_tpu_torch.serving.generation import ContinuousBatcher

    tm = TransformerLM(vocab=64, hidden_size=64, n_block=2, n_head=2,
                       seq_len=64, device=cuda)
    b = ContinuousBatcher(tm, n_slots=2, page_size=16, max_seq_len=64,
                          device=cuda, autostart=False)
    try:
        launches = (tpa.paged_attention.launches, kvc.gumbel_max.launches)
        tr = trace_decode(tm, b.cfg, b.cache)
        assert tr.kernel_counts() == {"K2": 2, "sampler": 1}
        assert tr.host_reads == []
        assert b.check_decode_stability("raise", 1 << 34) == []
        assert (tpa.paged_attention.launches,
                kvc.gumbel_max.launches) == launches
    finally:
        b.close()


def test_analysis_witness_reads_the_allocator(cuda, tmp_path, monkeypatch):
    """On the card a witness sample is the caching allocator's live bytes
    and its peak, not the site's storages."""
    from analytics_zoo_tpu_torch.common import memwitness as mw

    monkeypatch.setenv("ZOO_TPU_MEM_WITNESS", str(tmp_path / "w.jsonl"))
    mw.reset_witness()
    try:
        x = torch.zeros((1024, 1024), device=cuda)
        mw.sample("card", [x[:1]])
        agg = mw.witness_samples()["card"]
        assert agg["max_live_bytes"] == torch.cuda.memory_allocated(cuda)
        assert agg["max_live_bytes"] >= x.nbytes
        assert agg["max_bytes_in_use"] == torch.cuda.max_memory_allocated(
            cuda)
    finally:
        monkeypatch.delenv("ZOO_TPU_MEM_WITNESS")
        mw.reset_witness()
