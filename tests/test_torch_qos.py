"""The PyTorch port's ``serving/qos.py`` against the JAX package's, on the CPU.

Every function is pure host code; on a seeded grid of priorities,
deadlines, service-time EMAs, queue depths and concurrencies the port's
outputs must equal JAX's exactly (decisions, keys, floats and raised
errors alike).
"""

import itertools

import numpy as np
import pytest

from analytics_zoo_tpu.serving import qos as jq
from analytics_zoo_tpu_torch.serving import qos as tq

PRIORITIES = ["critical", "normal", "bulk", "CRITICAL", " Bulk ", "urgent",
              "", None, 3, True]
DEADLINES = [None, 0, -1.0, 1.5, 1e9, 1_700_000_000.25, True, "soon", 7]
NOW = 1_700_000_000.0


def _grid(seed: int, n: int):
    """(now, deadline, est_wait_s, service_ema_s, depth, concurrency,
    skew) tuples: deadlines around now, EMAs from 0 to 2 s."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out.append((NOW + float(rng.uniform(-5, 5)),
                    None if rng.random() < 0.15
                    else NOW + float(rng.uniform(-2, 10)),
                    float(rng.choice([0.0, rng.uniform(0, 3)])),
                    float(rng.choice([0.0, rng.uniform(0, 2)])),
                    int(rng.integers(0, 64)), int(rng.integers(0, 9)),
                    float(rng.choice([0.0, rng.uniform(0, 1)]))))
    return out


def test_constants_match():
    assert tq.PRIORITIES == jq.PRIORITIES
    assert tq.PRIORITY_RANK == jq.PRIORITY_RANK
    assert tq.DEFAULT_PRIORITY == jq.DEFAULT_PRIORITY
    assert tq.MIN_RETRY_AFTER_S == jq.MIN_RETRY_AFTER_S
    assert set(tq.__all__) == set(jq.__all__)


@pytest.mark.parametrize("priority", PRIORITIES)
def test_priority_normalization_matches(priority):
    assert tq.normalize_priority(priority) == jq.normalize_priority(priority)
    assert tq.priority_rank(priority) == jq.priority_rank(priority)


@pytest.mark.parametrize("deadline", DEADLINES)
def test_deadline_normalization_matches(deadline):
    assert tq.normalize_deadline(deadline) == jq.normalize_deadline(deadline)


@pytest.mark.parametrize("ms", [None, 0, 1, 250.5, -3])
def test_deadline_from_ms_matches(ms):
    assert tq.deadline_from_ms(ms, now=NOW) == jq.deadline_from_ms(ms,
                                                                   now=NOW)


def test_order_key_sorts_as_jax():
    rng = np.random.default_rng(0)
    items = [(PRIORITIES[int(rng.integers(len(PRIORITIES)))],
              DEADLINES[int(rng.integers(len(DEADLINES)))], seq)
             for seq in range(200)]
    for p, d, s in items:
        assert tq.order_key(p, d, s) == jq.order_key(p, d, s)
    assert sorted(items, key=lambda t: tq.order_key(*t)) == \
        sorted(items, key=lambda t: jq.order_key(*t))


@pytest.mark.parametrize("seed", range(4))
def test_wait_and_shed_predicates_match(seed):
    for now, dl, est, ema, depth, conc, skew in _grid(seed, 250):
        assert tq.estimated_wait_s(depth, ema, conc) == \
            jq.estimated_wait_s(depth, ema, conc)
        assert tq.retry_after_s(depth, ema, conc) == \
            jq.retry_after_s(depth, ema, conc)
        assert tq.cannot_meet(dl, est, ema, now=now,
                              skew_tolerance_s=skew) == \
            jq.cannot_meet(dl, est, ema, now=now, skew_tolerance_s=skew)


@pytest.mark.parametrize("seed", range(4))
def test_admission_decision_matches(seed):
    sheds = 0
    for now, dl, est, ema, depth, conc, skew in _grid(100 + seed, 250):
        inputs = {"now": now, "deadline": dl, "est_wait_s": est,
                  "service_ema_s": ema, "depth": depth,
                  "concurrency": conc, "skew_tolerance_s": skew,
                  "priority": "bulk"}
        got = tq.admission_decision(dict(inputs))
        assert got == jq.admission_decision(dict(inputs))
        sheds += got["action"] == "shed"
    assert 0 < sheds < 250       # both verdicts are exercised


@pytest.mark.parametrize("seed", range(3))
def test_autoscale_decision_matches_through_its_state(seed):
    """A seeded tick sequence: both packages' decisions equal at every
    tick, and the debounce state each mutates in place stays equal."""
    rng = np.random.default_rng(seed)
    ts, js = {}, {}
    t = 0.0
    for _ in range(300):
        t += float(rng.uniform(0, 3))
        obs = {"now": t, "n": int(rng.integers(1, 6)),
               "eligible": int(rng.integers(0, 6)),
               "owed": None if rng.random() < 0.05
               else int(rng.choice([0, rng.integers(0, 40)])),
               "shed_delta": int(rng.choice([0, rng.integers(0, 5)])),
               "routed_delta": int(rng.choice([0, rng.integers(0, 9)])),
               "up_depth": 4.0, "sustain_s": 2.0, "idle_s": 5.0,
               "cooldown_s": 3.0, "min_replicas": 1, "max_replicas": 4}
        assert tq.autoscale_decision(dict(obs), ts) == \
            jq.autoscale_decision(dict(obs), js)
        assert ts == js


@pytest.mark.parametrize("itl,decode,chunk,ct,static", list(itertools.product(
    [None, 0.0, 0.05, 0.2], [0.0, 0.01, 0.3], [0.0, 0.004, 0.05],
    [16, 128], [0, 512])))
def test_prefill_budget_decision_matches(itl, decode, chunk, ct, static):
    inputs = {"chunk_tokens": ct, "static_budget": static,
              "itl_target_s": itl, "decode_ema_s": decode,
              "chunk_ema_s": chunk}
    assert tq.prefill_budget_decision(inputs) == \
        jq.prefill_budget_decision(inputs)
    if itl:
        assert tq.prefill_budget_from_slo(itl, decode, chunk, ct) == \
            jq.prefill_budget_from_slo(itl, decode, chunk, ct)


@pytest.mark.parametrize("retry", [0.0, 0.01, 0.05, 2.5])
def test_shed_error_and_payloads_match(retry):
    te = tq.ShedError("full", retry_after_s=retry, reason="deadline")
    je = jq.ShedError("full", retry_after_s=retry, reason="deadline")
    assert (str(te), te.retry_after_s, te.reason) == \
        (str(je), je.retry_after_s, je.reason)
    assert isinstance(te, RuntimeError)
    tp = tq.shed_payload("overloaded", retry, reason="queue")
    assert tp == jq.shed_payload("overloaded", retry, reason="queue")
    back_t = tq.shed_error_from_payload(tp, "u1")
    back_j = jq.shed_error_from_payload(tp, "u1")
    assert (str(back_t), back_t.retry_after_s, back_t.reason) == \
        (str(back_j), back_j.retry_after_s, back_j.reason)
    for plain in ({"error": "x"}, {"shed": False}, None, [1]):
        assert tq.shed_error_from_payload(plain, "u") is None
        assert jq.shed_error_from_payload(plain, "u") is None


def test_service_time_ema_matches():
    rng = np.random.default_rng(5)
    t, j = tq.ServiceTimeEMA(alpha=0.3), jq.ServiceTimeEMA(alpha=0.3)
    assert t.value() == j.value() == 0.0
    for v in rng.uniform(-0.01, 0.2, size=100):
        t.observe(float(v))
        j.observe(float(v))
        assert t.value() == j.value()
    assert t.observations() == j.observations() == 100


def test_shed_error_is_a_retry_floor_in_the_port():
    """``RetryTracker`` honours a ShedError's ``retry_after_s`` as the
    backoff floor, in both packages alike."""
    from analytics_zoo_tpu.common import resilience as jres
    from analytics_zoo_tpu_torch.common import resilience as tres

    delays = []
    for res, q in ((tres, tq), (jres, jq)):
        tr = res.RetryPolicy(max_attempts=5, base_delay_s=0.01, seed=3,
                             jitter=0.1).tracker()
        delays.append([tr.record_failure(q.ShedError("x", retry_after_s=r))
                       for r in (0.0, 0.5, 0.02, 2.0)])
    assert delays[0] == delays[1]
    assert delays[0][1] >= 0.5 and delays[0][3] >= 2.0
