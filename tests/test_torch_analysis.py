"""The port's analysis tier against the JAX package's, on the CPU: the rule
engine, the trace rules and their wiring into ``fit``, the decode warm-up
and the int8 model load.

Each trace rule has a golden fixture in both polarities, run through both
packages on the same inputs (the JAX side traces a jaxpr, the port records
a call): the same rule ids, severities and counts. The collective goldens
record the port's collectives over a stub mesh axis (a recorded collective
never reaches ``torch.distributed``). The fit-start check leaves the
parameters, optimizer state, step count, key and every ``zoo_train_*``
counter bit for bit as they were, and a ``"warn"`` fit's losses are an
``"off"`` fit's bit for bit. The decode warm-up's trace holds one K2 site
a block; the int8 census equals JAX's ``fused_structure_counts``.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu import analysis as janalysis
from analytics_zoo_tpu.analysis.rules import fused_int8 as jfused_rule
from analytics_zoo_tpu_torch import analysis
from analytics_zoo_tpu_torch.analysis import (GraphLintError, RuleContext,
                                              SignatureTracker, lint_traced,
                                              trace_call)
from analytics_zoo_tpu_torch.analysis import trace as ttrace
from analytics_zoo_tpu_torch.analysis.rules import fused_int8 as tfused_rule
from analytics_zoo_tpu_torch.analysis.rules.collectives import \
    trace_collective_counts
from analytics_zoo_tpu_torch.common import telemetry as ttm
from analytics_zoo_tpu_torch.data.featureset import FeatureSet
from analytics_zoo_tpu_torch.ops import int8_fused as tfused
from analytics_zoo_tpu_torch.ops.int8 import quantize_weight
from analytics_zoo_tpu_torch.parallel import comm

pytestmark = pytest.mark.analysis


def _summary(findings):
    """What both packages must agree on: rule ids and severities, in
    order."""
    return [(f.rule, f.severity) for f in findings]


class _StubMesh:
    """A 4-rank dp axis as a recorded call sees it: a recorded collective
    returns before it would reach the (absent) process group."""

    shape = {"dp": 4}

    def axis(self, name):
        return comm.Axis(name, object(), 4, 0, range(4))


# ------------------------------------------------------------ the catalog

def test_rule_catalog_lists_every_jax_rule(capsys):
    """``--list-rules`` names every JAX rule id (the registered rules and
    ``mem-witness-divergence``); the two halves with no counterpart say
    why."""
    from analytics_zoo_tpu_torch.analysis.__main__ import main

    want = {r.id for r in janalysis.all_rules()} | {"mem-witness-divergence"}
    assert len(janalysis.all_rules()) == 22
    assert main(["--list-rules"]) == 0
    lines = capsys.readouterr().out.splitlines()
    listed = {ln.split()[0]: ln for ln in lines}
    assert want <= set(listed), sorted(want - set(listed))
    assert "No counterpart" in listed["collective-budget-hlo"]
    assert "AST half: no counterpart" in listed["donation-missed"]
    for r in analysis.all_rules():
        jr = janalysis.get_rule(r.id)
        assert r.severity == jr.severity, r.id
    assert analysis.get_rule("telemetry-lock").id == "lock-guarded-by"


# --------------------------------------------------- golden trace fixtures

BIG = np.ones((1024, 512), np.float32)          # 2 MiB


def _port_collective(in_loop: bool, broken: bool):
    mesh = _StubMesh()

    def step(v):
        if broken:
            return comm.psum(v, "dp", mesh=mesh)
        if in_loop:
            out = v.sum() * 0
            for _ in range(2):
                with ttrace.loop_region():
                    out = out + comm.psum_scatter(v, "dp", tiled=True,
                                                  mesh=mesh).sum()
            return out
        return comm.psum_scatter(v, "dp", tiled=True, mesh=mesh)

    ctx = RuleContext(where="fixture", expect_collectives={
        "reduce-scatter": 2 if in_loop else 1})
    return lint_traced(step, torch.ones(16), ctx=ctx,
                       rules=["collective-budget"])


def _jax_collective(in_loop: bool, broken: bool):
    from jax.sharding import Mesh, PartitionSpec as JP

    from analytics_zoo_tpu.common.compat import shard_map

    mesh = Mesh(np.array(jax.devices()[:4]), ("dp",))

    def body(v):
        if broken:
            return jax.lax.psum(v, "dp")
        if in_loop:
            def step(c, _):
                return c + jax.lax.psum_scatter(
                    v, "dp", scatter_dimension=0, tiled=True).sum(), None
            return jax.lax.scan(step, jnp.float32(0), jnp.arange(2))[0]
        return jax.lax.psum_scatter(v, "dp", scatter_dimension=0, tiled=True)

    fn = shard_map(body, mesh=mesh, in_specs=JP(), out_specs=JP(),
                   check_vma=False)
    # JAX counts the scan body's collective once; the port's eager loop
    # records it at each micro-step
    ctx = janalysis.RuleContext(where="fixture", expect_collectives={
        "reduce-scatter": 1})
    return janalysis.lint_traced(fn, jnp.ones((16,)), ctx=ctx,
                                 rules=["collective-budget"])


def _port_fused(bad: bool):
    rng = np.random.default_rng(0)
    packed = {k: torch.from_numpy(np.asarray(v)) for k, v in quantize_weight(
        rng.normal(size=(32, 32)).astype(np.float32)).items()}

    def f(x):
        y = tfused.int8_matmul_fused(x, packed, 32)
        return torch.round(y) if bad else y

    return lint_traced(f, torch.from_numpy(
        rng.normal(size=(8, 32)).astype(np.float32)),
        ctx=RuleContext(where="fixture", fused_expected=True),
        rules=["fused-int8-dispatch"])


def _jax_fused(bad: bool, monkeypatch):
    monkeypatch.setenv("ZOO_INT8_FUSED", "interpret")
    from analytics_zoo_tpu.ops import int8_fused as jfused
    from analytics_zoo_tpu.ops.int8 import quantize_weight as jq

    rng = np.random.default_rng(0)
    packed = {k: jnp.asarray(v) for k, v in jq(
        rng.normal(size=(32, 32)).astype(np.float32)).items()}

    def f(x):
        y = jfused.int8_matmul_fused(x, packed, interpret=True)
        return jnp.round(y) if bad else y

    return janalysis.lint_traced(
        f, jnp.asarray(rng.normal(size=(8, 32)).astype(np.float32)),
        ctx=janalysis.RuleContext(where="fixture", fused_expected=True),
        rules=["fused-int8-dispatch"])


def _grow(cat, c, bad):
    return {"k": cat([c["k"], c["k"][:1]]) if bad else c["k"]}


CACHE = ((2, 64, 64), "float32")


def _port_decode(bad: bool):
    ctx = RuleContext(where="fixture", decode_cache_avals=[CACHE])
    return lint_traced(lambda c: _grow(torch.cat, c, bad),
                       {"k": torch.zeros(CACHE[0])}, ctx=ctx,
                       rules=["decode-shape-stability"])


def _jax_decode(bad: bool):
    ctx = janalysis.RuleContext(where="fixture", decode_cache_avals=[CACHE])
    return janalysis.lint_traced(
        lambda c: _grow(jnp.concatenate, c, bad),
        {"k": jax.ShapeDtypeStruct(CACHE[0], jnp.float32)}, ctx=ctx,
        rules=["decode-shape-stability"])


def _port_hygiene(rule, bad):
    if rule == "host-transfer":
        def f(x):
            return x * 2 + (x.sum().item() if bad else 0.0)
        return lint_traced(f, torch.ones(4), ctx=RuleContext(where="fix"),
                           rules=[rule])
    if rule == "large-constant":
        big = BIG if bad else BIG[:4]
        return lint_traced(lambda x: x @ torch.from_numpy(big),
                           torch.ones(4, big.shape[0]),
                           ctx=RuleContext(where="fix"), rules=[rule])
    dt = "bfloat16" if bad else None
    return lint_traced(lambda a, b: a @ b, torch.ones(4, 4), torch.ones(4, 4),
                       ctx=RuleContext(where="fix", compute_dtype=dt),
                       rules=[rule])


def _jax_hygiene(rule, bad):
    if rule == "host-transfer":
        def f(x):
            if bad:
                jax.debug.callback(lambda v: None, x)
            return x * 2
        return janalysis.lint_traced(f, jnp.ones((4,)),
                                     ctx=janalysis.RuleContext(where="fix"),
                                     rules=[rule])
    if rule == "large-constant":
        big = BIG if bad else BIG[:4]
        return janalysis.lint_traced(lambda x: x @ jnp.asarray(big),
                                     jnp.ones((4, big.shape[0])),
                                     ctx=janalysis.RuleContext(where="fix"),
                                     rules=[rule])
    dt = "bfloat16" if bad else None
    return janalysis.lint_traced(
        lambda a, b: a @ b, jnp.ones((4, 4)), jnp.ones((4, 4)),
        ctx=janalysis.RuleContext(where="fix", compute_dtype=dt),
        rules=[rule])


def _sigs(bad):
    return [((i, 32), "float32") for i in range(5 if bad else 4)]


GOLDENS = {
    "host-transfer": (lambda bad, mp: _port_hygiene("host-transfer", bad),
                      lambda bad, mp: _jax_hygiene("host-transfer", bad)),
    "large-constant": (lambda bad, mp: _port_hygiene("large-constant", bad),
                       lambda bad, mp: _jax_hygiene("large-constant", bad)),
    "dtype-discipline": (
        lambda bad, mp: _port_hygiene("dtype-discipline", bad),
        lambda bad, mp: _jax_hygiene("dtype-discipline", bad)),
    "collective-budget": (lambda bad, mp: _port_collective(False, bad),
                          lambda bad, mp: _jax_collective(False, bad)),
    "collective-budget-in-loop": (
        lambda bad, mp: _port_collective(bad, False),
        lambda bad, mp: _jax_collective(bad, False)),
    "fused-int8-dispatch": (lambda bad, mp: _port_fused(bad),
                            lambda bad, mp: _jax_fused(bad, mp)),
    "decode-shape-stability": (lambda bad, mp: _port_decode(bad),
                               lambda bad, mp: _jax_decode(bad)),
    "recompile-hazard": (
        lambda bad, mp: analysis.lint_signatures(
            _sigs(bad), ctx=RuleContext(where="fix", max_signatures=4)),
        lambda bad, mp: janalysis.lint_signatures(
            _sigs(bad), ctx=janalysis.RuleContext(where="fix",
                                                  max_signatures=4))),
}


@pytest.mark.parametrize("bad", [True, False], ids=["trips", "clean"])
@pytest.mark.parametrize("case", sorted(GOLDENS))
def test_golden_rule_matches_jax(case, bad, monkeypatch):
    """Each fixture trips its rule in the bad polarity and nothing in the
    clean one, with JAX's ids, severities, counts and data."""
    port_fn, jax_fn = GOLDENS[case]
    got, want = port_fn(bad, monkeypatch), jax_fn(bad, monkeypatch)
    assert _summary(got) == _summary(want), (got, want)
    assert bool(got) is bad
    rule = case.replace("-in-loop", "")
    assert all(f.rule == rule for f in got)
    # the port's eager loop records a collective at each micro-step, JAX's
    # scan body once: the in-loop tallies differ by design
    keys = {"count", "found", "expected", "nbytes", "distinct", "bound"}
    for g, w in zip(got, want):
        shared = keys & set(dict(w.data))
        assert {k: dict(g.data)[k] for k in shared} == \
            {k: dict(w.data)[k] for k in shared}, (g, w)


def test_in_loop_collectives_are_tallied_per_micro_step():
    mesh = _StubMesh()

    def step(v):
        out = comm.psum(v, "dp", mesh=mesh)
        for _ in range(3):
            with ttrace.loop_region():
                out = out + comm.all_gather(v, "dp", tiled=True,
                                            mesh=mesh)[:16]
        return out

    counts = trace_collective_counts(trace_call(step, torch.ones(16)))
    assert counts == {"counts": {"all-reduce": 1, "all-gather": 3},
                      "in_loop": {"all-gather": 3}}


def test_findings_land_in_telemetry():
    def count():
        return ttm.snapshot().get("zoo_analysis_findings_total", {}) \
            .get("samples", {}).get("host-transfer,error", 0)

    before = count()
    assert len(_port_hygiene("host-transfer", True)) == 1
    assert count() == before + 1


def test_enforce_modes():
    fs = _port_hygiene("host-transfer", True)
    assert analysis.enforce(fs, "off") == fs
    assert analysis.enforce(fs, "warn") == fs
    with pytest.raises(GraphLintError, match="host-transfer") as ei:
        analysis.enforce(fs, "raise")
    assert ei.value.findings == fs
    with pytest.raises(ValueError, match="graph_checks"):
        analysis.enforce(fs, "loud")
    warn_only = [analysis.finding("peak-temporary", "warning", "x", "m")]
    assert analysis.enforce(warn_only, "raise") == warn_only


def test_signature_tracker_flags_once_like_jax():
    sigs = _sigs(True)
    for Tracker in (SignatureTracker, janalysis.SignatureTracker):
        tr = Tracker("fixture", max_distinct=2)
        assert [tr.add(s) for s in sigs[:4]] == [False, False, True, False]
        for mb in (1, 8, 24, 32):
            assert (Tracker.for_bucket_ladder("f", mb).max_distinct
                    == janalysis.SignatureTracker.for_bucket_ladder(
                        "f", mb).max_distinct)


def test_trace_leaves_the_caller_untouched():
    """A recorded call runs nothing: the module's weights, a tensor the
    call writes in place and its storages are as they were."""
    lin = torch.nn.Linear(4, 4)
    before = {n: p.detach().clone() for n, p in lin.named_parameters()}
    buf = torch.zeros(4)

    def f(x, b):
        with torch.no_grad():
            lin.weight.add_(1.0)
            b.add_(1.0)
        return lin(x)

    tr = trace_call(f, torch.ones(2, 4), buf, modules=[lin])
    assert all(torch.equal(p, before[n]) for n, p in lin.named_parameters())
    assert torch.equal(buf, torch.zeros(4))
    assert {a.name for a in tr.args} >= {"param:weight", "param:bias"}
    written = set().union(*(op.written for op in tr.ops))
    assert {a.storage for a in tr.args if a.name in ("param:weight",
                                                     "arg[0][1]")} <= written
    assert not ttrace.RECORDING and ttrace.active() is None


def test_host_values_stay_host_values():
    """Tensors made from host data run for real on the host, so reading
    them back is no finding; reading a traced value is one."""
    def f(x, temps):
        t = torch.tensor(list(temps), dtype=torch.float32)
        hot = [i for i, v in enumerate(t.tolist()) if v > 0]
        assert hot == [0, 2]
        return x[torch.tensor(hot)] * t[hot][:, None]

    tr = trace_call(f, torch.ones(3, 4), np.array([0.5, 0.0, 1.0]))
    assert tr.host_reads == [] and len(tr.uploads) >= 1
    tr = trace_call(lambda x: x * x.max().item(), torch.ones(3))
    assert [r.what for r in tr.host_reads] == ["item"]


# ------------------------------------------------------ fit-start wiring

def _toy(graph_checks, loss="mse", epochs=1, **cfg_kw):
    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.nn import layers as TL
    from analytics_zoo_tpu_torch.nn.topology import Sequential

    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 16)).astype(np.float32)
    y = rng.normal(size=(64, 4)).astype(np.float32)
    model = Sequential([TL.Dense(8, activation="relu", input_shape=(16,)),
                        TL.Dense(4)], device="cpu", seed=1)
    est = Estimator(model, optimizer="adam", loss=loss, config=TrainConfig(
        shuffle=False, log_every_n_steps=1, graph_checks=graph_checks,
        **cfg_kw))
    est.fit((x, y), batch_size=32, epochs=epochs)
    return est


def _jax_toy(graph_checks, loss="mse", **cfg_kw):
    from analytics_zoo_tpu.common import TrainConfig
    from analytics_zoo_tpu.engine import Estimator
    from analytics_zoo_tpu.nn import Sequential
    from analytics_zoo_tpu.nn import layers as L

    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 16)).astype(np.float32)
    y = rng.normal(size=(64, 4)).astype(np.float32)
    model = Sequential([L.Dense(8, activation="relu", input_shape=(16,)),
                        L.Dense(4)])
    est = Estimator(model, optimizer="sgd", loss=loss, config=TrainConfig(
        shuffle=False, log_every_n_steps=10 ** 9, graph_checks=graph_checks,
        **cfg_kw))
    est.fit((x, y), batch_size=32, epochs=1)
    return est


def _train_counters():
    snap = ttm.snapshot()
    return {k: v for k, v in snap.items() if k.startswith("zoo_train_")}


def test_fit_check_changes_nothing_and_warn_trains_as_off():
    """The fit-start check leaves the parameters, optimizer state, step
    count, key and every zoo_train_* counter bit for bit; a "warn" fit's
    losses and weights are an "off" fit's bit for bit."""
    est = _toy("off")
    params = {n: p.detach().clone() for n, p in est.model.named_parameters()}
    opt = jax.tree_util.tree_map(
        lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
        est.train_state["opt_state"])
    state = dict(est.train_state)
    counters = _train_counters()
    est.config.graph_checks = "warn"
    est._run_graph_checks(FeatureSet.from_numpy(
        np.zeros((64, 16), np.float32), np.zeros((64, 4), np.float32)), 32)
    assert all(torch.equal(p, params[n])
               for n, p in est.model.named_parameters())
    assert (est.train_state["step"], est.train_state["rng"]) == \
        (state["step"], state["rng"])
    got_opt = est.train_state["opt_state"]
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: torch.equal(a, b) if isinstance(a, torch.Tensor)
        else a == b, got_opt, opt))
    assert _train_counters() == counters
    off, warn = _toy("off", epochs=2), _toy("warn", epochs=2)
    assert [h["loss"] for h in off.history] == \
        [h["loss"] for h in warn.history]
    assert all(torch.equal(a, b) for a, b in zip(off.model.parameters(),
                                                 warn.model.parameters()))


def test_graph_checks_clean_fit_passes_like_jax(zoo_ctx):
    assert _toy("raise").trainer_state.iteration == 2
    assert _jax_toy("raise").trainer_state.iteration == 2
    assert _toy("raise", grad_accum_steps=2).trainer_state.iteration == 2


def test_graph_checks_catch_closure_captured_weights(zoo_ctx):
    """A 2 MiB host array used in the loss is uploaded every step: "raise"
    fails fit() before the first update in both packages; "warn" trains."""
    def port_loss(y, y_hat):
        return ((y_hat - y) ** 2).mean() + 0.0 * (
            torch.from_numpy(BIG).to(y_hat.device) * y_hat.mean()).sum()

    def jax_loss(y, y_hat):
        return ((y_hat - y) ** 2).mean() + 0.0 * jnp.asarray(BIG).sum()

    with pytest.raises(GraphLintError, match="large-constant") as got:
        _toy("raise", loss=port_loss)
    with pytest.raises(janalysis.GraphLintError,
                       match="large-constant") as want:
        _jax_toy("raise", loss=jax_loss)
    assert _summary(got.value.findings) == _summary(want.value.findings)
    assert _toy("warn", loss=port_loss).trainer_state.iteration == 2


def test_fit_trace_sees_the_flash_kernels():
    """A training step of a flash-attention LM records K1 and, in its
    backward, K3 and K4 once a block; nothing launches."""
    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.models.transformer import (TransformerLM,
                                                            lm_loss)
    from analytics_zoo_tpu_torch.ops import flash_attention as tflash

    tm = TransformerLM(vocab=32, hidden_size=16, n_block=2, n_head=2,
                       seq_len=16, attn_strategy="flash", device="cpu")
    est = Estimator(tm, optimizer="adam", loss=lm_loss,
                    config=TrainConfig(graph_checks="raise"))
    est._init_state()
    ids = np.random.default_rng(0).integers(0, 32, (4, 17))
    batch = est._to_device((ids[:, :-1], ids[:, 1:]))
    counts = (tflash.flash_attention_fwd.launches,
              tflash.flash_attention_bwd_dq.launches)
    tr = trace_call(est._step, batch, modules=[tm])
    assert tr.kernel_counts() == {"K1": 2, "K3": 2, "K4": 2}
    assert (tflash.flash_attention_fwd.launches,
            tflash.flash_attention_bwd_dq.launches) == counts


# ------------------------------------------------------ decode warm-up

def _lm_pair():
    from analytics_zoo_tpu.models.transformer import TransformerLM as JLM
    from analytics_zoo_tpu_torch.bridge import params_from_jax
    from analytics_zoo_tpu_torch.models.transformer import TransformerLM

    jm = JLM(vocab=64, hidden_size=32, n_block=2, n_head=2, seq_len=64)
    params, _ = jm.build(jax.random.PRNGKey(0))
    tm = TransformerLM(vocab=64, hidden_size=32, n_block=2, n_head=2,
                       seq_len=64, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              params)))
    return jm, params, tm


def _batchers(**kw):
    from analytics_zoo_tpu.serving.generation import ContinuousBatcher as JCB
    from analytics_zoo_tpu_torch.serving.generation import ContinuousBatcher

    jm, params, tm = _lm_pair()
    common = dict(n_slots=2, page_size=16, max_seq_len=64, autostart=False)
    return (ContinuousBatcher(tm, device="cpu", **common, **kw),
            JCB(jm, params, **common, **kw))


@pytest.mark.parametrize("kw", [{}, dict(spec_k=4),
                                dict(prefill_chunk_tokens=16)],
                         ids=["decode", "verify", "chunk"])
def test_decode_checks_clean_like_jax(kw):
    """The default decode step (and the verify step, and the prefill
    chunk) has JAX's findings: none, in "raise" mode. The decode trace
    holds one K2 site a block and the sampler."""
    from analytics_zoo_tpu_torch.analysis.rules.decode import trace_decode

    tb, jb = _batchers(**kw)
    try:
        assert tb.check_decode_stability("raise") == []
        assert jb.check_decode_stability("raise") == []
        tr = trace_decode(tb.model, tb.cfg, tb.cache, spec_k=tb.spec_k)
        assert tr.kernel_counts() == {"K2": 2, "sampler": 1}
        assert tr.host_reads == []
    finally:
        tb.close()
        jb.close()


def _copying_step(step):
    """A decode step that builds new pools and copies them back: the
    un-donated pool's cost."""
    def copied(cache, *a, **kw):
        fresh = {k: v.clone() for k, v in cache.items()}
        out = step(fresh, *a, **kw)
        for k, v in cache.items():
            v.copy_(fresh[k])
        return out[:-1] + (cache,)
    return copied


def test_decode_cache_alias_both_polarities(monkeypatch):
    """A step that copies the pool is one cache-alias finding for both
    pools (k and v share a key), as JAX's un-donated pool is."""
    from analytics_zoo_tpu.serving.generation import ContinuousBatcher as JCB

    tb, jb = _batchers()
    jb.close()
    jm, params, _ = _lm_pair()
    jb_bad = JCB(jm, params, n_slots=2, page_size=16, max_seq_len=64,
                 autostart=False, donate_cache=False)
    jb_bad.close()
    try:
        assert tb.check_decode_stability("raise") == []
        monkeypatch.setattr(tb.model, "decode_step",
                            _copying_step(tb.model.decode_step))
        with pytest.raises(GraphLintError, match="cache-alias"):
            tb.check_decode_stability("raise")
        got = tb.check_decode_stability("warn")
        want = jb_bad.check_decode_stability("warn")
        assert _summary(got) == _summary(want) == [("cache-alias", "error")]
        assert dict(got[0].data)["leaves"] == dict(want[0].data)["leaves"] \
            == 2
    finally:
        tb.close()


def test_decode_host_read_and_growth_are_findings(monkeypatch):
    """A device value read on the host inside the step, and an O(T^2)
    tensor, are decode-shape-stability findings."""
    from analytics_zoo_tpu_torch.models import transformer as ttrans

    tb, jb = _batchers()
    jb.close()
    orig = ttrans.sample_tokens

    def reads(logits, *a, **kw):
        logits.max().item()
        return orig(logits, *a, **kw)

    def grows(logits, *a, **kw):
        big = logits.new_zeros(tb.cache["k"].numel() + 1)
        return orig(logits + big[:1], *a, **kw)

    try:
        monkeypatch.setattr(ttrans, "sample_tokens", reads)
        got = tb.check_decode_stability("warn")
        assert [f.rule for f in got] == ["decode-shape-stability"]
        assert "item" in got[0].message
        monkeypatch.setattr(ttrans, "sample_tokens", grows)
        got = tb.check_decode_stability("warn")
        # a tensor past the pool's size is also a pool-sized allocation
        assert {f.rule for f in got} == {"decode-shape-stability",
                                         "cache-alias"}
        assert any("larger than the whole KV cache leaf" in f.message
                   for f in got)
    finally:
        tb.close()


def test_decode_hbm_budget_enforced_like_jax():
    tb, jb = _batchers(hbm_budget_bytes=1024)
    try:
        for b, err in ((tb, GraphLintError), (jb, janalysis.GraphLintError)):
            with pytest.raises(err, match="hbm-budget"):
                b.check_decode_stability("raise")
        assert tb.check_decode_stability("raise", 1 << 30) == []
    finally:
        tb.close()
        jb.close()


def test_generation_engine_warm_up_raises_before_traffic():
    """``ServingConfig(graph_checks="raise", hbm_budget_mb=...)`` builds,
    and the engine's warm-up fails start() on a budget the step busts."""
    from analytics_zoo_tpu_torch.serving.config import ServingConfig
    from analytics_zoo_tpu_torch.serving.generation import GenerationEngine

    _, _, tm = _lm_pair()
    for mb, raises in ((1e-6, True), (64.0, False)):
        cfg = ServingConfig(graph_checks="raise", hbm_budget_mb=mb,
                            gen_slots=2, gen_page_size=16,
                            gen_max_seq_len=64)
        eng = GenerationEngine(tm, config=cfg, device="cpu")
        try:
            if raises:
                with pytest.raises(GraphLintError, match="hbm-budget"):
                    eng._warm()
            else:
                eng._warm()
                assert eng.graph_findings == []
        finally:
            eng.batcher.close()


# ------------------------------------------------------ int8 model load

def _quantized_pair(monkeypatch, tmp_path):
    """The JAX golden's int8 MLP in both packages, from one set of
    weights; the JAX side on the TPU's route in interpret mode."""
    from analytics_zoo_tpu.inference import InferenceModel as JIM
    from analytics_zoo_tpu.nn import layers as JL
    from analytics_zoo_tpu.nn.topology import Sequential as JSeq
    from analytics_zoo_tpu_torch.inference.inference_model import \
        InferenceModel
    from analytics_zoo_tpu_torch.nn import layers as TL
    from analytics_zoo_tpu_torch.nn.topology import Sequential

    monkeypatch.setenv("ZOO_INT8_FUSED", "interpret")
    monkeypatch.setenv("ZOO_TPU_TUNING_CACHE", str(tmp_path / "t.json"))
    jm = JSeq([JL.Dense(64, activation="relu", input_shape=(32,)),
               JL.Dense(8)])
    params, state = jm.build(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, params)
    jim = JIM(max_batch_size=8).load(jm, params, state).quantize_int8(
        min_elements=64)
    tm = Sequential([TL.Dense(64, activation="relu", input_shape=(32,)),
                     TL.Dense(8)], device="cpu")
    im = InferenceModel(max_batch_size=8, device="cpu").load(
        tm, params).quantize_int8(min_elements=64)
    return im, jim


def test_inference_model_fused_check_like_jax(monkeypatch, tmp_path):
    """The census equals JAX's ``fused_structure_counts`` (``kernel_calls``
    is JAX's ``pallas_calls``); a layer that runs the plain path instead
    of the kernel is caught at model load, as JAX's broken fused tier is."""
    from analytics_zoo_tpu.ops import int8_fused as jfused
    from analytics_zoo_tpu_torch.ops import int8 as tint8

    im, jim = _quantized_pair(monkeypatch, tmp_path)
    x = np.random.default_rng(4).normal(size=(4, 32)).astype(np.float32)
    got = tfused_rule.fused_dispatch_report(im, torch.from_numpy(x[:1]))
    want = jfused_rule.fused_dispatch_report(jim, jnp.asarray(x[:1]))
    assert got["kernels"] == {"K5": 2, "K6": 0}
    got["pallas_calls"] = got.pop("kernel_calls")
    del got["kernels"]
    assert got == want
    assert im.check_fused_dispatch(x, mode="raise") == []
    before = tfused.int8_matmul_fused.launches
    monkeypatch.setattr(tint8, "int8_matmul_fused",
                        lambda x, p, block_k, rule: tfused
                        .int8_matmul_fused_plain(x, p, block_k, rule))
    monkeypatch.setattr(jfused, "int8_matmul_fused", lambda *a, **k: None)
    jim._compiled.clear()
    got = im.check_fused_dispatch(x, mode="warn")
    want = jim.check_fused_dispatch(x, mode="warn")
    assert {f.rule for f in got} == {f.rule for f in want} \
        == {"fused-int8-dispatch"}
    with pytest.raises(GraphLintError, match="fused-int8-dispatch"):
        im.check_fused_dispatch(x, mode="raise")
    assert tfused.int8_matmul_fused.launches == before


def test_serving_warmup_runs_fused_check(monkeypatch, tmp_path):
    """The serving engine's ``_warm_model`` passes a healthy int8 model in
    "raise" mode and fails on one whose layers skip the kernel."""
    from analytics_zoo_tpu_torch.ops import int8 as tint8
    from analytics_zoo_tpu_torch.serving.config import ServingConfig
    from analytics_zoo_tpu_torch.serving.engine import ClusterServing

    im, _ = _quantized_pair(monkeypatch, tmp_path)
    cfg = ServingConfig(int8=True, warmup_shape=(32,), graph_checks="raise")
    cs = ClusterServing(model=im, config=cfg)
    cs._warm_model()
    assert cs.stats()["graph_findings"] == 0
    monkeypatch.setattr(tint8, "int8_matmul_fused",
                        lambda x, p, block_k, rule: tfused
                        .int8_matmul_fused_plain(x, p, block_k, rule))
    with pytest.raises(GraphLintError, match="fused-int8-dispatch"):
        cs._warm_model()


def test_warm_up_graph_checks_warn_logs_findings(monkeypatch, tmp_path,
                                                 caplog):
    from analytics_zoo_tpu_torch.ops import int8 as tint8

    im, _ = _quantized_pair(monkeypatch, tmp_path)
    x = np.ones((1, 32), np.float32)
    with caplog.at_level(logging.WARNING,
                         logger="analytics_zoo_tpu_torch.inference"):
        im.warm_up(x, graph_checks="warn")
    assert not [r for r in caplog.records if "graph-lint" in r.getMessage()]
    monkeypatch.setattr(tint8, "int8_matmul_fused",
                        lambda x, p, block_k, rule: tfused
                        .int8_matmul_fused_plain(x, p, block_k, rule))
    with caplog.at_level(logging.WARNING,
                         logger="analytics_zoo_tpu_torch.inference"):
        im.warm_up(x, graph_checks="warn")
    assert [r for r in caplog.records if "fused-int8-dispatch"
            in r.getMessage()]
    with pytest.raises(GraphLintError):
        im.warm_up(x, graph_checks="raise")
