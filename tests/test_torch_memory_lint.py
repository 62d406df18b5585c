"""The port's memory tier against the JAX package's, on the CPU: the
live-range walk of a recorded call, the memory rules in both polarities,
the run-time allocation witness and its CLI.

The walk credits in-place writes as the JAX walk credits donation (a step
that copies its pool pays a second pool; one that writes it in place does
not), keeps a loop's temporaries from piling up, and lands within a stated
ratio of ``profile_jaxpr``'s peak on the same decode step. The witness
reads, on the CPU, the unique storages a site hands it (a view or a
repeated tensor counts once); its JSONL is the JAX package's: a file
written by either package is read by the other's CLI with the same verdict.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu import analysis as janalysis
from analytics_zoo_tpu.analysis.rules import memory as jmem_rules
from analytics_zoo_tpu.common import memwitness as jmw
from analytics_zoo_tpu_torch.analysis import (GraphLintError, RuleContext,
                                              check_memory_witness,
                                              memory_fields, profile_trace,
                                              trace_call)
from analytics_zoo_tpu_torch.analysis import trace as ttrace
from analytics_zoo_tpu_torch.analysis.rules.memory import (flatten_donation,
                                                           lint_donation,
                                                           lint_memory,
                                                           lint_sharded_gather)
from analytics_zoo_tpu_torch.common import memwitness as mw

pytestmark = pytest.mark.analysis

POOL = 2 * 64 * 64 * 4


def _one(findings, rule):
    assert len(findings) == 1, [str(f) for f in findings]
    assert findings[0].rule == rule, str(findings[0])
    return findings[0]


# ----------------------------------------------------- the live-range walk

def _port_cache_step(in_place: bool):
    """JAX's ``_cache_step`` fixture in the port: two rows of a cache
    updated in place, or through a copy of the cache."""
    def step(params, cache, x):
        c = cache["k"] if in_place else cache["k"].clone()
        for i in range(2):
            c[i] += x @ params
        return x @ params, {"k": c}

    return trace_call(step, torch.zeros(64, 64), {"k": torch.zeros(2, 64, 64)},
                      torch.zeros(64, 64))


def _jax_cache_jaxpr():
    def step(params, cache, x):
        c = cache["k"]
        for i in range(2):
            c = c.at[i].set(c[i] + x @ params)
        return x @ params, {"k": c}

    s = jax.ShapeDtypeStruct
    return jax.make_jaxpr(step)(s((64, 64), jnp.float32),
                                {"k": s((2, 64, 64), jnp.float32)},
                                s((64, 64), jnp.float32))


def test_profile_in_place_write_is_the_donation_credit():
    """The copying step pays a second pool (its output is a new pool); the
    in-place step pays none and returns the argument's pool — the JAX
    walk's donated-vs-undonated gap."""
    copied = profile_trace(_port_cache_step(False))
    in_place = profile_trace(_port_cache_step(True))
    assert copied.peak_live_bytes - in_place.peak_live_bytes >= POOL
    assert copied.aliased_out_bytes == 0
    assert in_place.aliased_out_bytes == POOL
    assert in_place.written_arg_bytes == POOL
    closed = _jax_cache_jaxpr()
    jplain = janalysis.profile_jaxpr(closed)
    jdon = janalysis.profile_jaxpr(closed, donated_invars=[False, True,
                                                           False])
    assert jplain.peak_live_bytes - jdon.peak_live_bytes >= POOL
    assert jdon.aliased_out_bytes >= in_place.aliased_out_bytes
    fields = memory_fields(_port_cache_step(True))
    assert fields["alias_size_in_bytes"] == POOL
    assert fields["hbm_peak_bytes"] == in_place.peak_live_bytes


def test_profile_loop_temporaries_do_not_pile_up():
    """A loop's temporary dies after its use: the peak is the inputs plus
    about one iteration's temporaries, not 100 of them, and the
    temporaries inside the loop region are tagged in-loop (the JAX scan
    body's count-once)."""
    def looped(xs):
        acc = xs[0].sum() * 0
        for i in range(100):
            with ttrace.loop_region():
                acc = acc + torch.outer(xs[i], xs[i]).sum()
        return acc

    prof = profile_trace(trace_call(looped, torch.zeros(100, 64)))
    temp = 64 * 64 * 4
    assert prof.peak_live_bytes < 100 * 64 * 4 + 3 * temp
    assert any(t.in_loop and t.nbytes == temp for t in prof.temporaries)


#: the port's static decode peak over JAX's on the same decode step
#: (2 blocks, width 32, 2 slots): 0.706 measured. The port's K2 site keeps
#: the gathered slot-major K/V inside the kernel, where JAX's CPU decode
#: step materializes them between equations.
DECODE_PEAK_RATIO = (0.65, 1.0)


def test_profile_trace_peak_against_profile_jaxpr():
    from analytics_zoo_tpu.models.transformer import TransformerLM as JLM
    from analytics_zoo_tpu.serving.generation import ContinuousBatcher as JCB
    from analytics_zoo_tpu_torch.bridge import params_from_jax
    from analytics_zoo_tpu_torch.models.transformer import TransformerLM
    from analytics_zoo_tpu_torch.serving.generation import ContinuousBatcher

    jm = JLM(vocab=64, hidden_size=32, n_block=2, n_head=2, seq_len=64)
    params, _ = jm.build(jax.random.PRNGKey(0))
    tm = TransformerLM(vocab=64, hidden_size=32, n_block=2, n_head=2,
                       seq_len=64, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              params)))
    kw = dict(n_slots=2, page_size=16, max_seq_len=64, autostart=False)
    tb = ContinuousBatcher(tm, device="cpu", **kw)
    jb = JCB(jm, params, **kw)
    try:
        got, want = tb.decode_memory(), jb.decode_memory()
    finally:
        tb.close()
        jb.close()
    ratio = got["static_peak_bytes"] / want["static_peak_bytes"]
    assert DECODE_PEAK_RATIO[0] <= ratio <= DECODE_PEAK_RATIO[1], ratio
    assert got["cache_bytes"] == want["cache_bytes"]
    assert got["compiled"]["alias_size_in_bytes"] >= got["cache_bytes"]
    # no second pool: the peak stays under the resident set plus one pool
    assert got["static_peak_bytes"] < got["resident_bytes"] \
        + got["cache_bytes"]


# ------------------------------------------------------ rule goldens

def test_golden_hbm_budget_both_polarities():
    trace, closed = _port_cache_step(True), _jax_cache_jaxpr()
    for budget, n in ((2 * POOL, 1), (64 * POOL, 0)):
        got = lint_memory(trace, ctx=RuleContext(
            where="fixture", hbm_budget_bytes=budget), rules=["hbm-budget"])
        want = jmem_rules.lint_memory(closed, ctx=janalysis.RuleContext(
            where="fixture", hbm_budget_bytes=budget), rules=["hbm-budget"])
        assert len(got) == len(want) == n
        if n:
            assert dict(_one(got, "hbm-budget").data)["budget_bytes"] == \
                dict(want[0].data)["budget_bytes"] == budget


def test_golden_peak_temporary_both_polarities():
    def blowup(x):
        return torch.outer(x, x).sum()       # (4096, 4096) vs a 16 KiB arg

    ctx = RuleContext(where="fixture")
    fs = lint_memory(trace_call(blowup, torch.zeros(4096)), ctx=ctx,
                     rules=["peak-temporary"])
    want = jmem_rules.lint_memory(
        jax.make_jaxpr(lambda x: jnp.outer(x, x).sum())(
            jax.ShapeDtypeStruct((4096,), jnp.float32)),
        ctx=janalysis.RuleContext(where="fixture"), rules=["peak-temporary"])
    assert [f.rule for f in fs] == [f.rule for f in want]
    assert fs[0].severity == want[0].severity == "warning"
    assert dict(fs[0].data)["nbytes"] == dict(want[0].data)["nbytes"] \
        == 4096 * 4096 * 4
    assert lint_memory(trace_call(lambda x: (x * 2).sum(), torch.zeros(4096)),
                       ctx=ctx, rules=["peak-temporary"]) == []


def test_golden_cache_alias_both_polarities():
    avals = [((2, 64, 64), "float32")]
    ctx = RuleContext(where="fixture", decode_cache_avals=avals)
    f = _one(lint_memory(_port_cache_step(False), ctx=ctx,
                         rules=["cache-alias"]), "cache-alias")
    want = jmem_rules.lint_memory(_jax_cache_jaxpr(), ctx=janalysis.RuleContext(
        where="fixture", decode_cache_avals=avals,
        donated_invars=[False, False, False]), rules=["cache-alias"])
    assert (f.rule, f.severity) == (want[0].rule, want[0].severity)
    assert dict(f.data)["leaves"] == dict(want[0].data)["leaves"] == 1
    assert lint_memory(_port_cache_step(True), ctx=ctx,
                       rules=["cache-alias"]) == []


def test_golden_trace_time_donation_missed_both_polarities():
    """Replacing the cache with a new tensor of its shape (not writing it
    in place) is one donation-missed of the pool's bytes, as JAX's
    dead-but-undonated argument is."""
    def replaced(params, cache, x):
        return x @ params, {"k": cache["k"] + 1}

    args = (torch.zeros(64, 64), {"k": torch.zeros(2, 64, 64)},
            torch.zeros(64, 64))
    dead = [False, True, False]
    f = _one(lint_donation(trace_call(replaced, *args), RuleContext(
        where="fixture", dead_invars=dead)), "donation-missed")
    want = jmem_rules.lint_donation(_jax_cache_jaxpr(), janalysis.RuleContext(
        where="fixture", dead_invars=dead, donated_invars=[False] * 3))
    assert dict(f.data)["missed_bytes"] == dict(want[0].data)[
        "missed_bytes"] == POOL
    assert f.severity == want[0].severity
    assert lint_donation(_port_cache_step(True), RuleContext(
        where="fixture", dead_invars=dead)) == []


def test_flatten_donation_equals_jax():
    for n, d in (([2, 3, 1], (0, 2)), ([1, 1], ()), ([4], (0,))):
        assert flatten_donation(n, d) == jmem_rules.flatten_donation(n, d)


@pytest.mark.parametrize("budget", [1 << 20, 1 << 30])
def test_sharded_gather_budget_like_jax(budget):
    kw = dict(dtype="float32", hbm_budget_bytes=budget)
    got = lint_sharded_gather(8192, 64, 256, 4, **kw)
    want = jmem_rules.lint_sharded_gather(8192, 64, 256, 4, **kw)
    assert [(f.rule, f.severity) for f in got] == \
        [(f.rule, f.severity) for f in want]
    with pytest.raises(ValueError, match="divide"):
        lint_sharded_gather(10, 4, 8, 4)


# ------------------------------------------------------- the run-time witness

@pytest.fixture()
def witness_env(tmp_path, monkeypatch):
    path = str(tmp_path / "mem_witness.jsonl")
    monkeypatch.setenv("ZOO_TPU_MEM_WITNESS", path)
    mw.reset_witness()
    jmw.reset_witness()
    yield path
    monkeypatch.delenv("ZOO_TPU_MEM_WITNESS", raising=False)
    mw.reset_witness()
    jmw.reset_witness()


def test_witness_disabled_is_noop(monkeypatch):
    monkeypatch.delenv("ZOO_TPU_MEM_WITNESS", raising=False)
    mw.reset_witness()
    called = []
    mw.sample("nowhere", lambda: called.append(1) or [])
    mw.note_static("nowhere", 123)
    mw.record_bytes("nowhere", 5)
    assert mw.witness_samples() == {} and mw.witness_statics() == {}
    assert called == []             # the tensors are not even gathered


def test_witness_cpu_reads_unique_storages(witness_env):
    """On the CPU a sample is the unique storages the site hands over: a
    view of a tensor and the tensor again count once."""
    a = torch.zeros(256, 4)
    b = torch.zeros(10, dtype=torch.float64)
    mw.sample("site", [a, a[3:], {"again": a, "b": b}])
    mw.sample("site", lambda: [a])
    agg = mw.witness_samples()["site"]
    assert agg["n"] == 2
    assert agg["max_live_bytes"] == a.nbytes + b.nbytes
    assert agg["min_live_bytes"] == a.nbytes
    assert agg["max_bytes_in_use"] is None


def test_witness_roundtrip_and_cross_package_load(witness_env):
    x = torch.zeros(256, 4)
    for _ in range(3):
        mw.sample("test.site", [x])
    mw.note_static("test.site", 12345, budget_bytes=99999)
    agg = mw.witness_samples()["test.site"]
    mw.dump_witness(witness_env)
    mw.dump_witness(witness_env)       # a second process's dump merges
    for load in (mw.load_witness, jmw.load_witness):
        samples, statics = load(witness_env)
        assert samples["test.site"]["n"] == 6
        assert samples["test.site"]["max_live_bytes"] == agg["max_live_bytes"]
        assert statics["test.site"] == {"peak_bytes": 12345,
                                        "budget_bytes": 99999}


def test_check_memory_witness_equals_jax():
    gib = 1 << 30
    samples = {"s": {"n": 5, "min_live_bytes": 10, "max_live_bytes": gib,
                     "last_live_bytes": gib, "max_bytes_in_use": None}}
    small = {"s": {"n": 1, "min_live_bytes": 10, "max_live_bytes": 1000,
                   "last_live_bytes": 1000, "max_bytes_in_use": None}}
    cases = [(samples, {"s": {"budget_bytes": gib // 2}}, None),
             (samples, {}, gib // 2),
             (samples, {"s": {"peak_bytes": gib // 8}}, None),
             (small, {"s": {"peak_bytes": 100}}, None),
             (samples, {"s": {"peak_bytes": gib, "budget_bytes": 2 * gib}},
              None)]
    want_rules = [["hbm-budget"], ["hbm-budget"], ["mem-witness-divergence"],
                  [], []]
    for (smp, st, budget), rules in zip(cases, want_rules):
        got = check_memory_witness(smp, st, budget_bytes=budget)
        want = janalysis.check_memory_witness(smp, st, budget_bytes=budget)
        assert [f.rule for f in got] == [f.rule for f in want] == rules
        assert [f.severity for f in got] == [f.severity for f in want]
        assert [dict(f.data) for f in got] == [dict(f.data) for f in want]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cli_mem_witness_reads_either_package(witness_env, writer, capsys):
    """A witness written by either package gets the same verdict from both
    CLIs: clean with no budget, an error exit under a 1-byte budget."""
    from analytics_zoo_tpu.analysis.__main__ import main as jmain
    from analytics_zoo_tpu_torch.analysis.__main__ import main as tmain

    if writer == "port":
        mw.sample("cli.site", [torch.zeros(64)])
        mw.note_static("cli.site", 1)
        mw.dump_witness(witness_env)
    else:
        anchor = jnp.ones((64,), jnp.float32)
        jmw.sample("cli.site")
        del anchor
        jmw.note_static("cli.site", 1)
        jmw.dump_witness(witness_env)
    for main in (tmain, jmain):
        assert main(["--mem-witness", witness_env, "--json"]) == 0
        out = json.loads(capsys.readouterr().out)
        assert out["errors"] == 0 and "cli.site" in out["mem_sites"]
        assert main(["--mem-witness", witness_env,
                     "--budget-mb", "0.000001"]) == 1
        capsys.readouterr()


# ------------------------------------------- fit start, decode, model load

def _toy_fit(graph_checks, **cfg_kw):
    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.nn import layers as TL
    from analytics_zoo_tpu_torch.nn.topology import Sequential

    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 16)).astype(np.float32)
    y = rng.normal(size=(64, 4)).astype(np.float32)
    model = Sequential([TL.Dense(8, activation="relu", input_shape=(16,)),
                        TL.Dense(4)], device="cpu")
    est = Estimator(model, optimizer="sgd", loss="mse", config=TrainConfig(
        shuffle=False, log_every_n_steps=10 ** 9, graph_checks=graph_checks,
        **cfg_kw))
    est.fit((x, y), batch_size=32, epochs=1)
    return est


def _jax_toy_fit(graph_checks, **cfg_kw):
    from analytics_zoo_tpu.common import TrainConfig
    from analytics_zoo_tpu.engine import Estimator
    from analytics_zoo_tpu.nn import Sequential
    from analytics_zoo_tpu.nn import layers as L

    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 16)).astype(np.float32)
    y = rng.normal(size=(64, 4)).astype(np.float32)
    model = Sequential([L.Dense(8, activation="relu", input_shape=(16,)),
                        L.Dense(4)])
    est = Estimator(model, optimizer="sgd", loss="mse", config=TrainConfig(
        shuffle=False, log_every_n_steps=10 ** 9, graph_checks=graph_checks,
        **cfg_kw))
    est.fit((x, y), batch_size=32, epochs=1)
    return est


def test_fit_start_catches_undonated_train_step(zoo_ctx):
    """``donate_state=False`` under "raise" fails fit() before the first
    update in both packages; the default passes."""
    with pytest.raises(GraphLintError, match="donation-missed") as got:
        _toy_fit("raise", donate_state=False)
    with pytest.raises(janalysis.GraphLintError,
                       match="donation-missed") as want:
        _jax_toy_fit("raise", donate_state=False)
    assert [f.rule for f in got.value.findings] == \
        [f.rule for f in want.value.findings]
    assert dict(got.value.findings[0].data)["leaves"] == 4
    assert _toy_fit("raise").trainer_state.iteration == 2


def test_fit_start_hbm_budget_raise_and_pass():
    with pytest.raises(GraphLintError, match="hbm-budget"):
        _toy_fit("raise", hbm_budget_mb=0.001)
    assert _toy_fit("raise", hbm_budget_mb=512.0).trainer_state.iteration \
        == 2


def test_fit_notes_static_peak_into_witness(witness_env):
    _toy_fit("warn", hbm_budget_mb=512.0)
    statics = mw.witness_statics()
    assert statics["estimator.step"]["peak_bytes"] > 0
    assert statics["estimator.step"]["budget_bytes"] == 512 * 2 ** 20
    assert mw.witness_samples()["estimator.step"]["n"] >= 1


def test_decode_flat_witness(witness_env):
    """Bytes sampled at every decode step stay flat across a generation,
    and the decode warm-up notes its static peak."""
    from analytics_zoo_tpu_torch.models.transformer import TransformerLM
    from analytics_zoo_tpu_torch.serving.generation import ContinuousBatcher

    tm = TransformerLM(vocab=64, hidden_size=32, n_block=2, n_head=2,
                       seq_len=64, device="cpu")
    b = ContinuousBatcher(tm, n_slots=2, page_size=16, max_seq_len=64,
                          device="cpu", graph_checks="warn",
                          hbm_budget_bytes=1 << 30)
    try:
        out = b.generate([1, 2, 3], max_new_tokens=12, timeout_s=60)
        assert len(out) == 12
    finally:
        b.close()
    agg = mw.witness_samples()["serving.decode"]
    assert agg["n"] >= 10
    assert agg["max_live_bytes"] <= 1.25 * agg["min_live_bytes"]
    static = mw.witness_statics()["serving.decode"]
    assert static["budget_bytes"] == 1 << 30
    assert check_memory_witness(mw.witness_samples(),
                                mw.witness_statics()) == []


def test_inference_check_memory_budget(witness_env):
    from analytics_zoo_tpu_torch.inference.inference_model import \
        InferenceModel
    from analytics_zoo_tpu_torch.nn import layers as TL
    from analytics_zoo_tpu_torch.nn.topology import Sequential

    im = InferenceModel(max_batch_size=8, device="cpu").load(
        Sequential([TL.Dense(8, input_shape=(16,))], device="cpu"))
    x = np.random.default_rng(0).normal(size=(4, 16)).astype(np.float32)
    with pytest.raises(GraphLintError, match="hbm-budget"):
        im.check_memory(x, mode="raise", budget_bytes=8)
    assert im.check_memory(x, mode="raise", budget_bytes=64 * 2 ** 20) == []
    assert im.check_memory(x, mode="off") == []
    im.predict(x)
    assert mw.witness_samples()["inference.dispatch"]["n"] == 1
    assert mw.witness_statics()["inference.dispatch"]["budget_bytes"] == \
        64 * 2 ** 20


def test_rowcache_reports_host_bytes(witness_env):
    from analytics_zoo_tpu_torch.serving.rowcache import (MEM_SITE,
                                                          HostRowCache)

    table = np.arange(64 * 8, dtype=np.float32).reshape(64, 8)
    cache = HostRowCache(table, hot_rows=8, device="cpu",
                         budget_bytes=1 << 20)
    cache.gather([1, 2, 3])
    agg = mw.witness_samples()[MEM_SITE]
    assert agg["n"] == 2 and agg["max_live_bytes"] >= table.nbytes
    assert mw.witness_statics()[MEM_SITE] == {"peak_bytes": table.nbytes,
                                              "budget_bytes": 1 << 20}


def test_graph_forward_drops_values_after_their_last_use():
    """A functional graph's forward drops each node's value after its last
    consumer, as the live-range walk assumes (the witness found the int8
    ResNet-50's batch-1 predict holding every activation: 3.76x its static
    peak on the card)."""
    import weakref

    from analytics_zoo_tpu_torch.nn.graph import GraphModule, Input
    from analytics_zoo_tpu_torch.nn.module import Layer

    made, seen = {}, {}

    class Tag(Layer):
        def __init__(self, name):
            super().__init__(name=name)

        def apply(self, x):
            y = x * 2
            made[self.name] = weakref.ref(y)
            seen[self.name] = {k: r() is not None for k, r in made.items()}
            return y

    inp = Input((4,))
    a = Tag("a")(inp)
    b = Tag("b")(a)
    c = Tag("c")(b)
    d = Tag("d")(c)
    g = GraphModule(inp, [d, b], device="cpu")
    with torch.no_grad():
        outs = g.apply(torch.ones(2, 4))
    # a's value went with its one consumer b; c's before d's result came
    # back; b stays alive: it is an output
    assert seen["c"] == {"a": False, "b": True, "c": True}
    assert seen["d"] == {"a": False, "b": True, "c": True, "d": True}
    assert torch.equal(outs[1], torch.full((2, 4), 4.0))
    assert made["c"]() is None


def test_serving_config_hbm_budget_yaml(tmp_path):
    from analytics_zoo_tpu.serving import ServingConfig as JCfg
    from analytics_zoo_tpu_torch.serving import ServingConfig

    p = tmp_path / "c.yaml"
    for text, want in (("memory:\n  hbm_budget_mb: 64\n", 64.0),
                       ("hbm_budget_mb: 32\ngraph_checks: raise\n", 32.0),
                       ("model:\n  path: /x\n", None)):
        p.write_text(text)
        got = ServingConfig.from_yaml(str(p))
        assert got.hbm_budget_mb == JCfg.from_yaml(str(p)).hbm_budget_mb \
            == want
