"""The serving remainder of the port's ContinuousBatcher against the JAX
package's, on the CPU: admission in (priority, deadline, submission)
order, deadline shedding, bulk-slot preemption with the parked stream's
pages intact (the dry pool held only by parked streams included), cancel
by handle and by uri, the run-to-completion ``admit_policy="batch"``, the
(params, spec schedule) hot swap with its prefix-cache invalidation, and
the supervisor's respawn after a chaos kill.

Both batchers serve the same weights (the JAX model's ``build`` output
loaded through the bridge). Where a scenario needs something to happen at
a given point of a stream, a stream's ``on_chunk`` callback, which runs on
the loop thread, does it there (or blocks the loop until the test has
done it), so every scenario is deterministic and both packages see it at
the same step. Streams and outcomes must be identical between the
packages, greedy and at temperature > 0 (the sampler is threefry-exact).
"""

import threading
import time

import jax
import numpy as np
import pytest

from analytics_zoo_tpu.common import chaos as jchaos
from analytics_zoo_tpu.common import telemetry as jtm
from analytics_zoo_tpu.models.transformer import TransformerLM as JaxLM
from analytics_zoo_tpu.ops.speculative import \
    SpecDecodeConfig as JaxSpecConfig
from analytics_zoo_tpu.serving import qos as jqos
from analytics_zoo_tpu.serving.generation import \
    ContinuousBatcher as JaxBatcher
from analytics_zoo_tpu_torch.bridge import params_from_jax
from analytics_zoo_tpu_torch.common import chaos as tchaos
from analytics_zoo_tpu_torch.common import telemetry as ttm
from analytics_zoo_tpu_torch.models.transformer import TransformerLM
from analytics_zoo_tpu_torch.observability import events as tev
from analytics_zoo_tpu_torch.observability import recorder as trec
from analytics_zoo_tpu_torch.serving import qos as tqos
from analytics_zoo_tpu_torch.serving.generation import ContinuousBatcher

VOCAB, HIDDEN, BLOCKS, HEADS, SEQ = 64, 32, 2, 2, 64
PKGS = ("jax", "torch")


@pytest.fixture(scope="module")
def models():
    jm = JaxLM(vocab=VOCAB, hidden_size=HIDDEN, n_block=BLOCKS, n_head=HEADS,
               seq_len=SEQ)
    params, _ = jm.build(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    tm = TransformerLM(vocab=VOCAB, hidden_size=HIDDEN, n_block=BLOCKS,
                       n_head=HEADS, seq_len=SEQ, device="cpu")
    tm.load_state_dict(params_from_jax(np_params))
    return jm, params, tm, np_params


def _private_lm(np_params):
    """A port model of its own: a swap rewrites the served model's
    parameters, which must not leak into another test."""
    tm = TransformerLM(vocab=VOCAB, hidden_size=HIDDEN, n_block=BLOCKS,
                       n_head=HEADS, seq_len=SEQ, device="cpu")
    tm.load_state_dict(params_from_jax(np_params))
    return tm


def _mk(pkg, models, private=False, **kw):
    jm, params, tm, np_params = models
    kw.setdefault("page_size", 4)
    kw.setdefault("max_seq_len", 32)
    if pkg == "jax":
        return JaxBatcher(jm, params, **kw)
    if private:
        tm = _private_lm(np_params)
    return ContinuousBatcher(tm, device="cpu", **kw)


def _finals(log):
    """A recording on_chunk: (tokens, final meta) per uri into ``log``."""
    def cb_for(name):
        def cb(tokens, final, meta):
            ent = log.setdefault(name, {"tokens": [], "meta": None})
            ent["tokens"].extend(tokens)
            if final:
                ent["meta"] = {k: meta[k] for k in ("outcome", "n_tokens")
                               if k in meta}
                if "retry_after_s" in meta:
                    ent["meta"]["retry_after_s"] = meta["retry_after_s"]
                log.setdefault("_order", []).append(name)
        return cb
    return cb_for


def _wait_done(log, names, timeout_s=60):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if all(log.get(n, {}).get("meta") is not None for n in names):
            return
        time.sleep(0.005)
    raise AssertionError(f"streams {names} did not finish: {log}")


def _run_both(models, scenario, private=False):
    """``scenario(pkg, make)`` on both packages; returns both results.
    ``private``: the port's batchers serve a model of their own."""
    return [scenario(pkg, lambda **kw: _mk(pkg, models, private=private,
                                           **kw))
            for pkg in PKGS]


# ---------------------------------------------------------------- shedding

def test_expired_deadline_sheds_before_any_page(models):
    def scenario(pkg, make):
        b = make(n_slots=2)
        try:
            h = b.submit([1, 2, 3], max_new_tokens=4,
                         deadline=time.time() - 1.0)
            frames = list(h.frames(timeout_s=30))
            meta = frames[-1][2]
            out = b.generate([1, 2, 3], max_new_tokens=4, timeout_s=30)
            return (meta["outcome"], meta["retry_after_s"] >=
                    jqos.MIN_RETRY_AFTER_S, out,
                    b.requests_finished.get("shed"),
                    b.pool.free_count() == b.pool.capacity)
        finally:
            b.close()

    got = _run_both(models, scenario)
    assert got[0] == got[1]
    assert got[1][:2] == ("shed", True) and got[1][3] == 1 and got[1][4]


def test_shed_stream_raises_shed_error_and_is_recorded(models):
    ttm.reset_telemetry()
    rec = trec.install(capacity=64)
    b = _mk("torch", models, n_slots=2)
    try:
        h = b.submit([4, 5], max_new_tokens=3, deadline=time.time() - 5)
        with pytest.raises(tqos.ShedError) as ei:
            h.result(timeout_s=30)
        assert ei.value.retry_after_s >= tqos.MIN_RETRY_AFTER_S
        assert ei.value.reason == "deadline"
        ok = b.submit([4, 5], max_new_tokens=3,
                      deadline=time.time() + 600).result(timeout_s=30)
        assert len(ok) == 3
    finally:
        b.close()
        trec.uninstall()
    recs = rec.records("admission.generation")
    assert [r["decision"]["action"] for r in recs].count("shed") == 1
    assert recs[0]["inputs"]["priority"] == "normal"
    fam = ttm.parse_prometheus(ttm.render_prometheus())
    assert ("zoo_gen_shed_total", {"reason": "deadline"}, 1.0) in \
        fam["zoo_gen_shed_total"]["samples"]
    ttm.reset_telemetry()


# -------------------------------------------------------------- preemption

def _bulk_ref(pkg, make, prompt, n):
    b = make(n_slots=1)
    try:
        return b.generate(prompt, max_new_tokens=n, timeout_s=60)
    finally:
        b.close()


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_critical_preempts_bulk_with_pages_intact(models, temperature):
    """A critical request on a full batcher preempts the bulk stream (its
    slot freed, its pages kept), finishes first, and the bulk stream then
    resumes with exactly the tokens an uninterrupted run gives."""
    bulk, crit = [5, 6, 7, 8], [9, 10, 11]

    def scenario(pkg, make):
        ref = make(n_slots=1)
        try:
            want = ref.generate(bulk, max_new_tokens=10,
                                temperature=temperature, seed=2)
        finally:
            ref.close()
        b = make(n_slots=1)
        log = {}
        cb = _finals(log)

        def bulk_cb(tokens, final, meta):
            cb("bulk")(tokens, final, meta)
            if len(log["bulk"]["tokens"]) == 3 and not final:
                b.submit(crit, max_new_tokens=4, priority="critical",
                         on_chunk=cb("critical"))
        try:
            b.submit(bulk, max_new_tokens=10, temperature=temperature,
                     seed=2, priority="bulk", on_chunk=bulk_cb)
            _wait_done(log, ["bulk", "critical"])
            st = b.stats()
            return (log["bulk"]["tokens"] == want, log["critical"]["tokens"],
                    log["_order"], st["preempted_parked"],
                    b.pool.free_count() == b.pool.capacity,
                    st["requests"])
        finally:
            b.close()

    got = _run_both(models, scenario)
    assert got[0] == got[1]
    assert got[1][0] is True
    assert got[1][2] == ["critical", "bulk"] and got[1][3] == 0 and got[1][4]


def test_parked_streams_holding_a_dry_pool_resume(models):
    """One slot and a pool of 8 pages: the bulk stream holds 6 when the
    critical request preempts it, so the critical prefill finds the pool
    dry with only the PARKED stream holding pages. The parked stream
    resumes (no deadlock), finishes, and the critical request runs after."""
    bulk, crit = list(range(1, 21)), [9, 10, 11, 12, 13, 14, 15, 16, 17]

    def scenario(pkg, make):
        want = _bulk_ref(pkg, make, bulk, 8)
        b = make(n_slots=1, n_pages=9)
        log = {}
        cb = _finals(log)

        def bulk_cb(tokens, final, meta):
            cb("bulk")(tokens, final, meta)
            if len(log["bulk"]["tokens"]) == 5 and not final:
                b.submit(crit, max_new_tokens=3, priority="critical",
                         on_chunk=cb("critical"))
        try:
            b.submit(bulk, max_new_tokens=8, priority="bulk",
                     on_chunk=bulk_cb)
            _wait_done(log, ["bulk", "critical"])
            return (log["bulk"]["tokens"] == want, log["critical"]["tokens"],
                    log["_order"], b.stats()["preempted_parked"],
                    b.pool.free_count() == b.pool.capacity)
        finally:
            b.close()

    got = _run_both(models, scenario)
    assert got[0] == got[1]
    assert got[1][0] is True and got[1][2] == ["bulk", "critical"]
    assert got[1][3] == 0 and got[1][4]


def test_admission_runs_in_priority_deadline_order(models):
    """One slot, blocked by a first stream while six requests queue: they
    are served critical first, then normal by deadline (dated before
    undated), then bulk, FIFO within equal keys."""
    now = time.time()
    reqs = [("bulk-a", "bulk", None), ("normal-undated", None, None),
            ("normal-late", "normal", now + 500), ("crit", "critical", None),
            ("normal-soon", "normal", now + 400), ("bulk-b", "bulk", None)]

    def scenario(pkg, make):
        b = make(n_slots=1)
        log = {}
        cb = _finals(log)

        def first_cb(tokens, final, meta):
            cb("first")(tokens, final, meta)
            if len(log["first"]["tokens"]) == 1 and not final:
                for i, (name, prio, dl) in enumerate(reqs):
                    b.submit([3 + i, 4], max_new_tokens=2, priority=prio,
                             deadline=dl, on_chunk=cb(name))
        try:
            b.submit([1, 2], max_new_tokens=3, on_chunk=first_cb)
            _wait_done(log, ["first"] + [r[0] for r in reqs])
            return log["_order"], {n: log[n]["tokens"] for n, _, _ in reqs}
        finally:
            b.close()

    got = _run_both(models, scenario)
    assert got[0] == got[1]
    # the critical one preempts nothing (no bulk slot): it waits for the
    # first stream, then goes first
    assert got[1][0] == ["first", "crit", "normal-soon", "normal-late",
                         "normal-undated", "bulk-a", "bulk-b"]


# ------------------------------------------------------------------ cancel

def test_cancel_by_uri_queued_active_and_parked(models):
    def scenario(pkg, make):
        b = make(n_slots=1)
        log = {}
        cb = _finals(log)

        def first_cb(tokens, final, meta):
            cb("active")(tokens, final, meta)
            if len(log["active"]["tokens"]) == 2 and not final:
                b.submit([7, 8], max_new_tokens=4, uri="queued",
                         on_chunk=cb("queued"))
                b.cancel_uri("queued")      # still in the submit queue
                b.cancel_uri("active")
                b.cancel_uri("unknown-uri")
        try:
            b.submit([1, 2, 3], max_new_tokens=20, uri="active",
                     on_chunk=first_cb)
            _wait_done(log, ["active", "queued"])
            # a parked stream cancelled: it finishes cancelled at resume
            log2 = {}
            cb2 = _finals(log2)

            def bulk_cb(tokens, final, meta):
                cb2("bulk")(tokens, final, meta)
                if len(log2["bulk"]["tokens"]) == 2 and not final:
                    b.submit([9, 9], max_new_tokens=3, priority="critical",
                             uri="crit", on_chunk=crit_cb)

            def crit_cb(tokens, final, meta):
                cb2("crit")(tokens, final, meta)
                if tokens and len(log2["crit"]["tokens"]) == 1:
                    b.cancel_uri("bulk")
            b.submit([4, 5], max_new_tokens=10, priority="bulk", uri="bulk",
                     on_chunk=bulk_cb)
            _wait_done(log2, ["bulk", "crit"])
            return ({k: v for k, v in log.items() if k != "_order"},
                    {k: v for k, v in log2.items() if k != "_order"},
                    b.pool.free_count() == b.pool.capacity)
        finally:
            b.close()

    got = _run_both(models, scenario)
    assert got[0] == got[1]
    first, second, conserved = got[1]
    assert first["active"]["meta"]["outcome"] == "cancelled"
    assert first["queued"]["meta"]["outcome"] == "cancelled"
    assert first["queued"]["tokens"] == []
    assert second["bulk"]["meta"]["outcome"] == "cancelled"
    assert second["crit"]["meta"]["outcome"] == "ok" and conserved


def test_cancel_mid_stream_by_handle(models):
    def scenario(pkg, make):
        b = make(n_slots=2)
        try:
            h = b.submit([3, 9, 27, 17], max_new_tokens=30, temperature=0.5,
                         seed=3)
            got = []
            for tokens, final, meta in h.frames(timeout_s=60):
                got.extend(tokens)
                if len(got) >= 3 and not final:
                    h.cancel()
                if final:
                    outcome = meta["outcome"]
            return outcome, len(got) < 30, \
                b.pool.free_count() == b.pool.capacity
        finally:
            b.close()

    got = _run_both(models, scenario)
    assert got[0] == got[1] == ("cancelled", True, True)


# -------------------------------------------------------- admission policy

def test_batch_policy_streams_match(models):
    """Run-to-completion waves and continuous admission give the same
    streams, in both packages."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, VOCAB, size=int(n)).tolist()
               for n in (3, 7, 5, 2, 9)]

    def scenario(pkg, make):
        out = []
        for policy in ("batch", "continuous"):
            b = make(n_slots=2, admit_policy=policy, batch_window_s=0.02)
            try:
                hs = [b.submit(p, max_new_tokens=3 + i,
                               temperature=0.8 * (i % 2), seed=40 + i)
                      for i, p in enumerate(prompts)]
                out.append([h.result(timeout_s=60) for h in hs])
            finally:
                b.close()
        return out

    got = _run_both(models, scenario)
    assert got[0] == got[1]
    assert got[1][0] == got[1][1]


def test_batch_policy_waits_for_the_wave(models):
    """Under ``"batch"`` nothing is admitted while any slot is busy."""
    b = _mk("torch", models, n_slots=2, admit_policy="batch",
            batch_window_s=0.0)
    try:
        admitted_while_busy = []

        def cb(tokens, final, meta):
            if not final and b.active_slots() == 2:
                admitted_while_busy.append(True)
        hs = [b.submit([1 + i, 2], max_new_tokens=6, on_chunk=cb)
              for i in range(3)]
        outs = [h.result(timeout_s=60) for h in hs]
        assert all(len(o) == 6 for o in outs)
        # the third request only ever runs alone (after the first wave)
        assert b.stats()["slot_occupancy"] < 1.0
    finally:
        b.close()
    with pytest.raises(ValueError, match="admit_policy"):
        _mk("torch", models, admit_policy="lottery", autostart=False)


# -------------------------------------------------------------- hot swap

def test_swap_params_flips_target_and_spec_as_one_pair(models):
    """Mid-stream (at the stream's third token, from the loop thread) a
    swap to weights x 1.01 with spec k 4 -> 3: the stream survives, both
    packages give the same tokens before and after the flip, and the new
    k adds exactly one decode shape."""
    np_params = models[3]
    params2 = jax.tree_util.tree_map(lambda p: p * np.float32(1.01),
                                     np_params)

    def scenario(pkg, make):
        b = make(n_slots=2, max_seq_len=64, spec_k=4)
        toks = []
        done = threading.Event()

        def cb(tokens, final, meta):
            toks.extend(tokens)
            if len(toks) >= 3 and b.swaps == 0 and not hasattr(cb, "sent"):
                cb.sent = True
                b.swap_params(params2 if pkg == "torch" else
                              jax.tree_util.tree_map(jax.numpy.asarray,
                                                     params2),
                              version="v2-pair",
                              spec={"k": 3, "max_ngram": 2})
            if final:
                done.set()
        try:
            b.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=30,
                     temperature=0.7, seed=1, on_chunk=cb)
            assert done.wait(60)
            after = b.generate([1, 2, 3], max_new_tokens=6, timeout_s=60)
            st = b.stats()
            return (toks, after, st["model_version"], st["swaps"],
                    b.spec_k, b.spec_ngram,
                    sorted({s[3] for s in b.decode_shapes if len(s) > 3}))
        finally:
            b.close()

    got = _run_both(models, scenario, private=True)
    assert got[0] == got[1]
    toks, after, version, swaps, k, ngram, ks = got[1]
    assert len(toks) == 30 and version == "v2-pair" and swaps == 1
    assert (k, ngram, ks) == (3, 2, [3, 4])
    # a request after the swap equals a fresh batcher on the new weights
    fresh = ContinuousBatcher(_private_lm(params2), device="cpu", n_slots=2,
                              page_size=4, max_seq_len=64, spec_k=3,
                              spec_ngram=2)
    try:
        assert fresh.generate([1, 2, 3], max_new_tokens=6) == after
    finally:
        fresh.close()


def test_swap_accepts_the_ports_own_tree_and_validates(models):
    b = _mk("torch", models, private=True, n_slots=1, autostart=False)
    host = b.host_params()
    bumped = {n: t * 1.01 for n, t in host.items()}
    b.swap_params(bumped, version="own")
    b.start()
    try:
        b.generate([1, 2], max_new_tokens=2)
        assert b.version == "own" and b.swaps == 1
        for n, t in b.host_params().items():
            assert t.equal(bumped[n])
        with pytest.raises(TypeError):
            b.swap_params(host, spec="k=3")
        bad = dict(host)
        bad["ln_f.gamma"] = bad["ln_f.gamma"][:-1]
        with pytest.raises(ValueError, match="ln_f.gamma"):
            b.swap_params(bad)
        with pytest.raises(ValueError, match="missing"):
            b.swap_params({"ln_f.gamma": host["ln_f.gamma"]})
    finally:
        b.close()
    with pytest.raises(ValueError):
        JaxSpecConfig(k=0)


def test_swap_invalidates_prefix_cache_and_stays_token_exact(models):
    """The same weights republished under a new version mid-stream: the
    prefix index empties at the flip (a ``gen.prefix.invalidated`` event),
    the warm stream stays token-exact, and post-swap hits rebuild."""
    prefix = list(range(1, 17))
    np_params = models[3]

    def scenario(pkg, make):
        tev.reset_events()
        b = make(n_slots=2, prefix_cache_pages=32, max_seq_len=64)
        try:
            baseline = b.generate(prefix + [55], max_new_tokens=16,
                                  temperature=0.8, seed=9)
            entries_before = b.prefix_cache.stats()["entries"]
            toks = []

            def cb(tokens, final, meta):
                toks.extend(tokens)
                if len(toks) == 1 and not final:
                    b.swap_params(np_params if pkg == "torch"
                                  else models[1], version="v2")
            h = b.submit(prefix + [55], max_new_tokens=16, temperature=0.8,
                         seed=9, on_chunk=cb)
            h.result(timeout_s=60)
            entries_after = b.prefix_cache.stats()["entries"]
            again = b.generate(prefix + [55], max_new_tokens=16,
                               temperature=0.8, seed=9)
            return (baseline, toks, again, entries_before > 0,
                    entries_after, b.swaps, b.version,
                    b.prefix_cache.stats()["entries"] > 0)
        finally:
            b.close()
            b.pool.check_conservation()

    got = _run_both(models, scenario, private=True)
    assert got[0] == got[1]
    baseline, toks, again = got[1][:3]
    assert toks == baseline == again
    assert got[1][3:] == (True, 0, 1, "v2", True)
    inv = tev.events(kind="gen.prefix.invalidated")
    assert inv and inv[-1].fields["reason"] == "hot_swap"


# ------------------------------------------------------------ supervisor

@pytest.mark.parametrize("site,kw", [
    ("serving.generate", {}),
    ("prefix.publish", {"prefix_cache_pages": 16}),
    ("prefill.chunk", {"prefill_chunk_tokens": 4}),
])
def test_chaos_kill_respawns_with_streams_intact(models, site, kw):
    """The kill drill on the batcher itself: a seeded kill at ``site`` ends
    the decode loop; the supervisor respawns it once with slots, pages and
    cache intact (a request killed mid-prefill is requeued) and every
    stream completes with the tokens of the same burst without the kill,
    in both packages."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, VOCAB, size=int(n)).tolist()
               for n in (4, 6, 5)]

    def burst(make):
        b = make(n_slots=2, **kw)
        try:
            hs = [b.submit(p, max_new_tokens=8, temperature=0.3,
                           seed=100 + i) for i, p in enumerate(prompts)]
            outs = [h.result(timeout_s=60) for h in hs]
            return outs, b.loop_respawns, \
                b.pool.free_count() + (b.prefix_cache.held_pages()
                                       if b.prefix_cache else 0) \
                == b.pool.capacity
        finally:
            b.close()

    def scenario(pkg, make):
        chaos = tchaos if pkg == "torch" else jchaos
        clean = burst(make)
        sched = chaos.ChaosSchedule(seed=7).kill(site, at=2)
        with sched:
            killed = burst(make)
        return clean, killed, sched.occurrences(site) >= 2

    got = _run_both(models, scenario)
    assert got[0] == got[1]
    clean, killed, fired = got[1]
    assert killed[0] == clean[0] and all(len(o) == 8 for o in killed[0])
    assert killed[1] == 1 and clean[1] == 0 and killed[2] and fired


# ------------------------------------------------------- stats, telemetry

def _counts(tm):
    """``{(family, labels): value}`` of the ``zoo_gen_*`` counters."""
    fam = tm.parse_prometheus(tm.render_prometheus())
    return {(name, tuple(sorted(smp[1].items()))): smp[2]
            for name, f in fam.items() if name.startswith("zoo_gen_")
            and f["type"] == "counter" for smp in f["samples"]}


def _delta(after, before):
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v != before.get(k, 0.0)}


def test_stats_and_telemetry_agree(models):
    """The port's stats carry every key the JAX batcher's do, and its
    ``zoo_gen_*`` counters move as the JAX package's do and as ``stats()``
    says, over one scenario (a preemption and a shed)."""
    got, deltas = [], []
    for pkg, tm in zip(PKGS, (jtm, ttm)):
        before = _counts(tm)
        b = _mk(pkg, models, n_slots=1)
        log = {}
        cb = _finals(log)

        def bulk_cb(tokens, final, meta, b=b, cb=cb, log=log):
            cb("bulk")(tokens, final, meta)
            if len(log["bulk"]["tokens"]) == 2 and not final:
                b.submit([5], max_new_tokens=2, priority="critical",
                         on_chunk=cb("crit"))
                b.submit([6], max_new_tokens=2, deadline=time.time() - 1,
                         on_chunk=cb("shed"))
        try:
            b.submit([1, 2, 3], max_new_tokens=6, priority="bulk",
                     on_chunk=bulk_cb)
            _wait_done(log, ["bulk", "crit", "shed"])
            got.append(b.stats())
        finally:
            b.close()
        deltas.append(_delta(_counts(tm), before))
    jst, tst = got
    assert set(jst) <= set(tst)
    for key in ("requests", "preempted_parked", "backlog", "loop_respawns",
                "model_version", "swaps", "steps", "tokens_generated"):
        assert tst[key] == jst[key], key
    jd, td = deltas
    assert td == jd
    reqs = {dict(k[1])["outcome"]: v for k, v in td.items()
            if k[0] == "zoo_gen_requests_total"}
    assert reqs == {k: float(v) for k, v in tst["requests"].items()}
    assert td[("zoo_gen_preemptions_total", ())] == 1.0
    assert td[("zoo_gen_shed_total", (("reason", "deadline"),))] == 1.0
    assert td[("zoo_gen_decode_steps_total", ())] == tst["steps"]


def test_close_fails_parked_streams_and_frees_their_pages(models):
    b = _mk("torch", models, n_slots=1)
    log = {}
    cb = _finals(log)
    parked = threading.Event()
    release = threading.Event()

    def bulk_cb(tokens, final, meta):
        cb("bulk")(tokens, final, meta)
        if len(log["bulk"]["tokens"]) == 2 and not final:
            b.submit([5, 6], max_new_tokens=20, priority="critical",
                     on_chunk=crit_cb)

    def crit_cb(tokens, final, meta):
        cb("crit")(tokens, final, meta)
        if not final and not parked.is_set():
            parked.set()
            release.wait(10)
    b.submit([1, 2, 3], max_new_tokens=20, priority="bulk",
             on_chunk=bulk_cb)
    assert parked.wait(30)
    assert b.stats()["preempted_parked"] == 1
    release.set()
    b.close()
    assert log["bulk"]["meta"]["outcome"] == "error"
    assert b.pool.free_count() == b.pool.capacity
    assert not [t for t in threading.enumerate()
                if t.name.startswith("zoo-torch-gen") and t.is_alive()]
