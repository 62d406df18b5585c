"""The port's Hopper tile table (``analytics_zoo_tpu_torch.ops.tuning``)
against the JAX package's tuning cache, on the CPU: the key strings over a
seeded grid of shapes, the cache's record/lookup/invalidate round trip, a
corrupt or wrong-version file read as empty, the M bucket, the counters
(once per distinct key in the port: the wrappers' memo), the K5
``block_k`` reference gap, the sweeps refusing a host without a card, an
out-of-range tile index refused when read, and the C sources' tile lists
mirrored by the Python ones. Each test runs in its own cache file.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import int8_fused as jint8
from analytics_zoo_tpu.ops import tuning as jtuning
from analytics_zoo_tpu_torch.analysis.rules import docs
from analytics_zoo_tpu_torch.common import telemetry as ttm
from analytics_zoo_tpu_torch.ops import int8_fused as tint8
from analytics_zoo_tpu_torch.ops import paged_attention as tpaged
from analytics_zoo_tpu_torch.ops import tuning

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "analytics_zoo_tpu_torch" / "csrc"
FAMILIES = ("zoo_kernel_tuning_sweeps_total",
            "zoo_kernel_tuning_cache_hits_total",
            "zoo_kernel_tuning_cache_misses_total")
CARD = torch.device("cuda", 0)     # a memo key; nothing touches a card
BF16 = np.dtype("bfloat16")        # numpy's bfloat16 (ml_dtypes, via JAX)


@pytest.fixture()
def caches(tmp_path, monkeypatch):
    """Isolated tuning caches, one a package; ``use(which)`` points
    ``ZOO_TPU_TUNING_CACHE`` at one of them."""
    paths = {"jax": str(tmp_path / "jax.json"),
             "port": str(tmp_path / "port.json")}

    def use(which):
        monkeypatch.setenv("ZOO_TPU_TUNING_CACHE", paths[which])
        return paths[which]

    use("port")
    tuning.invalidate()
    jtuning.invalidate()
    yield use
    tuning.invalidate()
    jtuning.invalidate()


def test_keys_are_the_jax_strings_over_a_seeded_grid():
    rng = np.random.default_rng(24)
    for _ in range(40):
        m, n, k, q, p, s, h, d = (int(v) for v in rng.integers(1, 5000, 8))
        assert tuning.bucket(m) == jtuning.bucket(m)
        for tdt, jdt in ((torch.float32, np.float32),
                         (np.float32, np.float32),
                         (torch.bfloat16, BF16), ("bfloat16", BF16)):
            assert tuning.shape_key(m, n, dtype=tdt) == \
                jtuning.shape_key(m, n, dtype=jdt)
            assert tuning.matmul_key(m, n, k, tdt) == \
                jtuning.matmul_key(m, n, k, jdt)
            assert tuning.flash_key(q, k, tdt) == \
                jtuning.flash_key(q, k, jdt)
            assert tuning.paged_key(q, p, s, h, d, tdt) == \
                jtuning.paged_key(q, p, s, h, d, jdt)
            assert tuning.flash_key(q, k, tdt, d=d) == \
                f"{q}x{k}x{d}/{np.dtype(jdt).name}"
    assert tuning.bucket(0) == jtuning.bucket(0) == 1
    assert tuning.shape_key(3, 4) == jtuning.shape_key(3, 4) == "3x4"
    assert tuning.MATMUL_OP == jtuning.MATMUL_OP
    assert tuning.FLASH_OP == jtuning.FLASH_OP
    assert tuning.PAGED_OP == jtuning.PAGED_OP


def test_record_lookup_invalidate_round_trip_as_jax(caches):
    jpath = caches("jax")
    key = jtuning.matmul_key(8, 32, 64, np.float32)
    jtuning.record(jtuning.MATMUL_OP, key, {"block_m": 8, "block_n": 16,
                                             "block_k": 32})
    want = jtuning.lookup(jtuning.MATMUL_OP, key)
    jtuning.invalidate()
    assert jtuning.lookup(jtuning.MATMUL_OP, key) == want
    tpath = caches("port")
    entry = {"tile": 2, "elapsed_ms": 0.5, "swept": [{"tile": 0}]}
    tuning.record(tuning.MATMUL_OP, tuning.matmul_key(8, 32, 64,
                                                      torch.float32), entry)
    assert tuning.lookup(tuning.MATMUL_OP, key) == entry
    tuning.invalidate()
    assert tuning.lookup(tuning.MATMUL_OP, key) == entry
    assert tuning.matmul_lookup(8, 32, 64, torch.float32) == 2
    # the same file schema: version, then device kind -> op -> key
    jraw, traw = (json.load(open(p)) for p in (jpath, tpath))
    assert jraw["version"] == traw["version"] == 1
    (jkind, jops), = jraw["devices"].items()
    (tkind, tops), = traw["devices"].items()
    assert tkind == tuning.device_kind() and jkind != tkind
    assert set(jops) == set(tops) == {"int8_matmul"}
    assert set(jops["int8_matmul"]) == set(tops["int8_matmul"]) == {key}
    # a second record is a read-modify-write of the current file
    other = tuning.paged_key(1, 64, 16, 16, 64, torch.bfloat16)
    with open(tpath) as f:
        raw = json.load(f)
    raw["devices"][tkind]["paged"] = {other: {"tile": 1}}
    with open(tpath, "w") as f:
        json.dump(raw, f)
    tuning.record(tuning.FLASH_OP, "1x1x64/bfloat16", {"tile": 0})
    with open(tpath) as f:
        ops = json.load(f)["devices"][tkind]
    assert set(ops) == {"int8_matmul", "paged", "flash"}


@pytest.mark.parametrize("content", ["{not json",
                                     '{"version": 2, "devices": {}}',
                                     '["a list"]'])
def test_corrupt_or_wrong_version_cache_reads_as_empty(caches, content):
    for which, mod, key in (
            ("jax", jtuning, jtuning.matmul_key(8, 32, 64, np.float32)),
            ("port", tuning, tuning.matmul_key(8, 32, 64, torch.float32))):
        path = caches(which)
        mod.record(mod.MATMUL_OP, key, {"tile": 1, "block_m": 8,
                                        "block_n": 16, "block_k": 32})
        with open(path, "w") as f:
            f.write(content)
        mod.invalidate()
        assert mod.lookup(mod.MATMUL_OP, key) is None
        assert mod.matmul_lookup(8, 32, 64, np.float32) is None


def test_one_entry_answers_the_m_bucket_as_jax(caches):
    caches("jax")
    jtuning.record(jtuning.MATMUL_OP, jtuning.matmul_key(8, 32, 64,
                                                         np.float32),
                   {"block_m": 8, "block_n": 16, "block_k": 32})
    caches("port")
    tuning.record(tuning.MATMUL_OP, tuning.matmul_key(8, 32, 64,
                                                      torch.float32),
                  {"tile": 3})
    for m in range(1, 12):
        caches("jax")
        j = jtuning.matmul_lookup(m, 32, 64, np.float32)
        caches("port")
        t = tuning.matmul_lookup(m, 32, 64, torch.float32)
        assert (j is None) == (t is None), m
        assert (t == 3) == (5 <= m <= 8), m
        assert tuning.matmul_tile(m, 32, 64, torch.float32, CARD) == \
            (3 if 5 <= m <= 8 else 0)


def _count(name, op):
    return ttm.snapshot().get(name, {}).get("samples", {}).get(op, 0)


def test_counters_move_as_jax_and_once_per_key(caches):
    op = tuning.MATMUL_OP
    h0, m0 = _count(FAMILIES[1], op), _count(FAMILIES[2], op)
    assert tuning.matmul_lookup(8, 32, 64, torch.float32) is None   # miss
    tuning.record(op, tuning.matmul_key(8, 32, 64, torch.float32),
                  {"tile": 1})
    assert tuning.matmul_lookup(8, 32, 64, torch.float32) == 1      # hit
    assert (_count(FAMILIES[1], op) - h0, _count(FAMILIES[2], op) - m0) \
        == (1, 1)
    # the wrappers' memo: a key counts once however often it is read
    for _ in range(5):
        assert tuning.matmul_tile(8, 32, 64, torch.float32, CARD) == 1
        assert tuning.matmul_tile(16, 32, 64, torch.float32, CARD) == 0
    assert (_count(FAMILIES[1], op) - h0, _count(FAMILIES[2], op) - m0) \
        == (2, 2)
    # invalidate() drops the memo: the next read counts again
    tuning.invalidate()
    assert tuning.matmul_tile(8, 32, 64, torch.float32, CARD) == 1
    assert _count(FAMILIES[1], op) - h0 == 3
    for name in FAMILIES:
        assert name in ttm.snapshot()
    text = ttm.render_prometheus()
    assert 'zoo_kernel_tuning_cache_hits_total{op="int8_matmul"}' in text


def test_the_three_families_are_registered_and_documented():
    assert docs.NOT_YET_PORTED == {}
    code = docs.registered_metrics([str(ROOT / "analytics_zoo_tpu_torch")])
    theirs = docs.registered_metrics([str(ROOT / "analytics_zoo_tpu")])
    documented = docs.documented_metrics(str(ROOT / "docs" /
                                             "observability.md"))
    for name in FAMILIES:
        assert name in code and name in documented
        loc, kind, help_ = code[name]
        assert "ops/tuning.py" in loc and kind == "counter"
        assert (kind, help_) == theirs[name][1:]


def test_k5_entry_never_moves_block_k_the_reference_gap(caches):
    """JAX's entry for a shape changes its scale groups; the port's
    ``resolve_blocks`` stays the TPU's default decision whatever the table
    holds (ROADMAP Queue 3, reference gaps)."""
    default = tint8.resolve_blocks(8, 128, 256)
    assert default == (8, 128, 256)
    caches("jax")
    jtuning.record(jtuning.MATMUL_OP, jtuning.matmul_key(8, 128, 256,
                                                         np.float32),
                   {"block_m": 8, "block_n": 128, "block_k": 128})
    assert jint8.resolve_blocks(8, 128, 256, np.float32,
                                interpret=True) == (8, 128, 128)
    caches("port")
    for tile in range(len(tuning.MATMUL_CANDIDATES)):
        tuning.record(tuning.MATMUL_OP, tuning.matmul_key(8, 128, 256,
                                                          torch.float32),
                      {"tile": tile, "block_k": 128})
        assert tuning.matmul_tile(8, 128, 256, torch.float32, CARD) == tile
        assert tint8.resolve_blocks(8, 128, 256) == default


def test_sweeps_raise_without_a_card(caches):
    for tune, args in ((tuning.tune_int8_matmul, (32, 1024, 1024)),
                       (tuning.tune_flash_blocks, (128, 128)),
                       (tuning.tune_paged_attention, (1, 4, 16, 2, 64))):
        with pytest.raises(RuntimeError, match="CUDA card"):
            tune(*args, device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA card"):
                tune(*args)
    assert not Path(tuning.cache_path()).exists()


@pytest.mark.parametrize("bad", [9, -1, True, "1", 1.0, None])
def test_a_tile_outside_the_list_is_refused_when_read(caches, bad):
    cases = ((tuning.MATMUL_OP, tuning.matmul_key(8, 32, 64, torch.float32),
              lambda: tuning.matmul_lookup(8, 32, 64, torch.float32),
              lambda: tuning.matmul_tile(8, 32, 64, torch.float32, CARD)),
             (tuning.FLASH_OP, tuning.flash_key(128, 128, torch.bfloat16,
                                                d=64),
              lambda: tuning.flash_lookup(128, 128, torch.bfloat16, d=64),
              lambda: tuning.flash_tile(128, 128, 64, 64, torch.bfloat16,
                                        CARD)),
             (tuning.PAGED_OP, tuning.paged_key(1, 64, 16, 16, 64,
                                                torch.bfloat16),
              lambda: tuning.paged_lookup(1, 64, 16, 16, 64, torch.bfloat16),
              lambda: tuning.paged_tile(1, 64, 16, 16, 64, torch.bfloat16,
                                        CARD)))
    for op, key, read, tile in cases:
        tuning.record(op, key, {"tile": bad})
        assert read() is None
        assert tile() == 0
        tuning.record(op, key, {"tile": 1})
        assert read() == 1 and tile() == 1


def test_an_empty_table_runs_every_default_tile(caches):
    """No entry: the wrappers pass tile 0, the tile each kernel ran before
    the table."""
    assert tuning.matmul_tile(2048, 4096, 4096, torch.float32, CARD) == 0
    assert tuning.flash_tile(1024, 1024, 64, 64, torch.bfloat16, CARD) == 0
    assert tuning.paged_tile(1, 64, 16, 16, 64, torch.bfloat16, CARD) == 0
    # f32, and head dims past 256, run their one tile and read no table
    assert tuning.flash_tile(1024, 1024, 64, 64, torch.float32, CARD) == 0
    assert tuning.flash_tile(64, 64, 264, 264, torch.bfloat16, CARD) == 0
    assert tuning.flash_lookup(64, 64, torch.float32, d=64) is None
    assert tpaged.SPLIT_POSITIONS == 128
    for page in (1, 7, 16, 100, 128, 300):
        assert tuning.split_span(page, 0) == page * -(-128 // page)
    assert tuning.split_span(1, 3) == 128          # capped at 128 pages
    assert tuning.split_span(16, 3) == 1024


def test_candidate_lists_mirror_the_cuda_sources():
    """Each op's Python list is what its C entry compiles, entry 0 the
    kernel's earlier fixed tile, and 2-4 entries a head-dim class."""
    fwd = (CSRC / "flash_fwd.cu").read_text()
    body = fwd[fwd.index("int with_wgmma_tile("):]
    body = body[:body.index("\n}\n")]
    classes = re.split(r"else if \(D <= 128\)|} else {", body)
    for cls, text in zip((64, 128, 256), classes):
        got = [(int(bk), int(st)) for _, bk, st in re.findall(
            r"case \d+: return f\(WgTile<(\d+), (\d+), (\d+)>", text)]
        assert got == [c[:2] for c in tuning.FLASH_CANDIDATES[cls]], cls
        assert 2 <= len(got) <= 4
    assert [c[:2] for c in (tuning.FLASH_CANDIDATES[64][0],
                            tuning.FLASH_CANDIDATES[128][0],
                            tuning.FLASH_CANDIDATES[256][0])] == \
        [(128, 2), (128, 2), (32, 2)]
    bwd = (CSRC / "flash_bwd.cu").read_text()
    body = bwd[bwd.index("int with_bwd_tile("):]
    body = body[:body.index("\n}\n")]
    classes = re.split(r"else if \(D <= 128\)|} else {", body)
    for cls, text in zip((64, 128, 256), classes):
        stages = [int(s) for s in re.findall(
            r"case \d+: return f\(BwdTile<[^>]*, (\d+)>", text)]
        assert stages == [c[2] for c in tuning.FLASH_CANDIDATES[cls]], cls
        assert stages[0] == 3
    paged = (CSRC / "paged_attention.cu").read_text()
    spans = re.search(r"kSplitPositions\[\] = \{([^}]*)\}", paged).group(1)
    assert tuple(int(v) for v in spans.split(",")) == \
        tuple(tuning.PAGED_CANDIDATES)
    mm = (CSRC / "int8_matmul.cu").read_text()
    assert f"kMatmulTiles = {len(tuning.MATMUL_CANDIDATES)};" in mm
    assert tuning.MATMUL_CANDIDATES[0] == "auto"
    assert len(tuning.MATMUL_CANDIDATES) <= 4


def test_wrappers_take_a_tile_and_on_the_cpu_run_the_plain_versions():
    """A tile names a kernel instance; a CPU tensor takes the plain version
    whatever the tile."""
    from analytics_zoo_tpu_torch.ops import flash_attention as tfa

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 8, 2, 16), generator=g) for _ in range(3))
    for tile in (None, 0, 1):
        out, lse = tfa.flash_attention_fwd(q, k, v, True, tile=tile)
        want, want_lse = tfa.flash_attention_plain(q, k, v, True)
        assert torch.equal(out, want) and torch.equal(lse, want_lse)
    case = tpaged.synthetic_paged_case(2, 4, 4, 2, 16, q_len=1,
                                       generator=g)
    assert torch.equal(tpaged.paged_attention(*case, page_size=4, tile=2),
                       tpaged.paged_attention_plain(*case, page_size=4))
    x = torch.randn((4, 256), generator=g)
    w = torch.randint(-127, 128, (256, 128), generator=g).to(torch.int8)
    packed = {"q": w, "scale": torch.rand((1, 128), generator=g)}
    assert torch.equal(tint8.int8_matmul_fused(x, packed, 128, tile=3),
                       tint8.int8_matmul_fused_plain(x, packed, 128))
