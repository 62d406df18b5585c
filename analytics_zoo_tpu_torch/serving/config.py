"""Serving configuration (port of ``analytics_zoo_tpu/serving/config.py``,
which needs no JAX: the same fields, defaults and YAML layout).

Parity: the reference's cluster-serving ``config.yaml`` parsed by its
``ClusterServingHelper`` — model path, batch size, thread/parallelism knobs,
queue endpoint, top-N post-processing.

``graph_checks`` ("off" / "warn" / "raise") and ``hbm_budget_mb`` drive
the analysis tier at engine start: the int8 dispatch checks
(``InferenceModel.check_fused_dispatch``/``check_memory`` from
``ClusterServing._warm_model``) and the decode checks
(``ContinuousBatcher.check_decode_stability`` from ``GenerationEngine``).
"warn" logs each finding and serves; "raise" fails ``start()``.

The fleet fields (``replicas``, ``fleet_*``, ``autoscale*``,
``rollout_*``) drive ``serving/fleet.py``; the ``slo:`` section is checked
by ``observability/slo.py``'s ``parse_objectives`` when the config is read,
so a typo'd objective fails here, not in a running engine.
"""

from __future__ import annotations

import dataclasses
from typing import Optional



@dataclasses.dataclass
class ServingConfig:
    model_path: str = ""
    batch_size: int = 32                 # micro-batch cap (params/batchSize)
    batch_timeout_ms: int = 5            # max wait to fill a micro-batch
                                         # (0 = non-blocking poll, never coerced)
    concurrent_num: int = 4              # inference concurrency (params/coreNum)
    queue_host: str = "127.0.0.1"        # redis/host parity
    queue_port: int = 6380               # redis/port parity
    top_n: Optional[int] = None          # postprocessing topN
    int8: bool = False                   # OpenVINO-int8 capability; packing
                                         # happens at engine start() (warmup),
                                         # never on the first request
    warmup_shape: Optional[tuple] = None # per-record input shape (no batch
                                         # dim): engine start() pre-compiles
                                         # the bucket ladder for it
    graph_checks: str = "warn"           # static analysis of the dispatch
                                         # at warm-up (the fused-int8-
                                         # dispatch rule + the memory tier:
                                         # hbm-budget / peak-temporary, and
                                         # decode-shape-stability /
                                         # cache-alias on the decode
                                         # warm-up): "warn" logs findings,
                                         # "raise" fails start(); "off"
                                         # skips
    hbm_budget_mb: Optional[float] = None  # per-device memory budget for
                                         # the serving dispatch / decode
                                         # step: with graph_checks on, the
                                         # static live-range peak must stay
                                         # under it at warm-up (hbm-budget);
                                         # the memory witness re-checks
                                         # measured bytes
    log_dir: Optional[str] = None        # InferenceSummary TB dir
    # --- autoregressive generation (serving/generation.py) ---
    gen_slots: int = 8                   # concurrent decode sequences (the
                                         # continuous batcher's fixed width)
    gen_page_size: int = 16              # KV-cache tokens per page (pow2)
    gen_max_seq_len: int = 512           # prompt + generated cap per stream
    gen_pages: int = 0                   # KV page-pool size (0 = full
                                         # n_slots x pages_per_slot + scratch)
    gen_top_k: int = 0                   # sampling top-k (0 = full dist;
                                         # static: part of the ONE compiled
                                         # decode executable)
    gen_spec_k: int = 0                  # speculative decode: tokens per
                                         # verify step (0/1 = classic
                                         # single-token decode; >=2 = k-gram
                                         # self-draft + one k-token verify
                                         # executable per (k, slot-count))
    gen_spec_ngram: int = 3              # longest suffix n-gram the
                                         # self-drafting proposer matches on
    gen_prefix_cache_pages: int = 0      # shared-prefix KV cache: HBM
                                         # budget in pool pages the cache
                                         # may hold (0 = sharing disabled;
                                         # held pages are reclaimed under
                                         # pool pressure before any stream
                                         # truncates)
    gen_prefix_block_tokens: int = 0     # tokens per content-hashed prefix
                                         # block (0 = one page; must be a
                                         # positive multiple of page_size)
    gen_prefill_chunk_tokens: int = 0    # chunked prefill: tokens per chunk
                                         # (0 = whole-prompt prefill; must be
                                         # a positive multiple of page_size —
                                         # ONE compiled chunk executable)
    gen_prefill_token_budget: int = 0    # max prefill tokens spent per decode
                                         # loop iteration (0 = one chunk per
                                         # iteration; overridden by an ITL
                                         # SLO objective when one is declared
                                         # — see qos.prefill_budget_from_slo)
    # --- replica fleet (serving/fleet.py) ---
    replicas: int = 1                    # engine replicas behind the router
                                         # (1 = classic single-engine stack)
    fleet_policy: str = "least_pending"  # routing policy: "least_pending"
                                         # (queue-depth-aware) | "round_robin"
    fleet_spawn: str = "thread"          # replica isolation: "thread" (N
                                         # engines in-process) | "process"
                                         # (one subprocess per replica; needs
                                         # model_path — a live model object
                                         # can't cross the fork) | "host"
                                         # (replicas placed on HostAgents;
                                         # see fleet_hosts)
    fleet_heartbeat_s: float = 0.5       # replica -> broker hb cadence
    fleet_failover_timeout_s: float = 3.0  # hb staleness => dead: evict,
                                         # requeue claimed work, respawn
    fleet_spawn_grace_s: float = 30.0    # extra liveness budget for a replica
                                         # that is still loading/compiling its
                                         # model (first heartbeat pending)
    # --- cross-host fleet (serving/hostagent.py) ---
    fleet_hosts: int = 0                 # host failure domains: 0 = single-
                                         # machine fleet (legacy); N > 0 =
                                         # the supervisor manages N local
                                         # HostAgent subprocesses standing in
                                         # for machines (real deployments run
                                         # `python -m ...serving.hostagent`
                                         # per machine and set spawn: host)
    fleet_host_capacity: int = 4         # max replicas placed per host
    fleet_host_skew_tolerance_s: float = 0.25  # deadline slack floor for
                                         # cross-host wall-clock skew; the
                                         # measured per-host offset (from hb
                                         # round trips) is added on top
    # --- model hot-swap / canary rollout (serving/hotswap.py) ---
    hot_swap: bool = True                # consume the trainer's publish
                                         # stream: fleet stacks run the
                                         # canary RolloutController, single
                                         # engines swap directly on publish
    swap_warmup: bool = True             # staged params run a probe forward
                                         # (needs warmup_shape) before the
                                         # swap — NaN/crash checkpoints are
                                         # rejected pre-traffic
    swap_timeout_s: float = 30.0         # command -> heartbeat-confirmed
                                         # version, per replica (covers the
                                         # staging load + validation)
    rollout_canary_fraction: float = 0.25  # traffic share routed to the
                                         # canary during validation
    rollout_window_s: float = 2.0        # canary validation window
    rollout_min_requests: int = 8        # canary must serve this many before
                                         # the window can close (else it
                                         # extends up to 3x window)
    rollout_max_error_delta: float = 0.05  # canary error RATE may exceed the
                                         # stable cohort's by at most this
    rollout_max_latency_ratio: float = 3.0  # canary latency vs stable-cohort
                                         # median; above => rollback
    # --- overload QoS (serving/qos.py; YAML `overload:` section) ---
    default_priority: str = "normal"     # class assumed for requests that
                                         # carry no priority (old clients):
                                         # critical | normal | bulk
    bulk_inflight_fraction: float = 0.5  # frontend watermark: bulk-class
                                         # requests admit only while
                                         # inflight < fraction*max_inflight,
                                         # keeping headroom for critical/
                                         # normal under sustained overload
    # --- queue-driven autoscaling (serving/fleet.py; YAML `autoscale:`) ---
    autoscale: bool = False              # FleetSupervisor grows/shrinks the
                                         # replica set on sustained queue
                                         # pressure / idleness; every scale
                                         # event rides the graceful drain +
                                         # requeue machinery (zero-loss)
    min_replicas: int = 1                # never drain below this
    max_replicas: int = 4                # never spawn above this
    autoscale_up_depth: float = 8.0      # sustained owed-work-per-eligible-
                                         # replica (zoo_fleet_queue_depth)
                                         # above this => scale up; router
                                         # deadline sheds count double (shed
                                         # traffic is demand the fleet
                                         # failed to serve)
    autoscale_sustain_s: float = 1.0     # pressure must persist this long
                                         # (one slow batch must not spawn)
    autoscale_idle_s: float = 3.0        # zero queued work + no dispatch
                                         # activity for this long => drain
                                         # one replica down
    autoscale_cooldown_s: float = 2.0    # min gap between scale events so
                                         # the signal can react to the last
    # --- SLO engine (observability/slo.py; YAML `slo:` section) ---
    slo_objectives: tuple = ()           # declared objectives, each a dict
                                         # {name, type: latency|availability|
                                         # error_ratio|queue_depth, priority,
                                         # target, threshold_ms, max_depth};
                                         # empty = no SLO engine
    slo_fast_window_s: float = 60.0      # burn-rate short window (the
                                         # "is it still happening" proof +
                                         # the resolver)
    slo_slow_window_s: float = 600.0     # burn-rate long window (the
                                         # "sustained budget spend" proof)
    slo_burn_factor: float = 9.0         # fire when burn > factor over BOTH
                                         # windows (SRE-workbook pairing)
    # --- resilience (common.resilience wiring) ---
    infer_workers: int = 1               # model-worker threads; dead ones are
                                         # respawned by the engine supervisor
    heartbeat_timeout_s: float = 60.0    # stage heartbeat staleness => dead in
                                         # /healthz. Beats happen between
                                         # batches, so the floor must exceed
                                         # the longest single predict — first
                                         # XLA compile on a real chip is
                                         # 20-40s; 60 keeps warmup healthy
    http_max_inflight: int = 64          # load shedding: beyond this, /predict
                                         # answers 503 + Retry-After
    breaker_failure_threshold: int = 5   # broker-path failures in the window
                                         # that open the frontend's circuit
    breaker_reset_timeout_s: float = 2.0 # open->half-open probe delay

    @classmethod
    def from_yaml(cls, path: str) -> "ServingConfig":
        """Accepts both this framework's flat keys and the reference's nested
        config.yaml layout (model/path, params/batchSize, redis/host...)."""
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        flat = {}
        model = raw.get("model") or {}
        params = raw.get("params") or {}
        redis = raw.get("redis") or raw.get("queue") or {}
        post = raw.get("postprocessing") or {}
        flat["model_path"] = raw.get("model_path", model.get("path", ""))
        flat["batch_size"] = int(raw.get("batch_size",
                                         params.get("batchSize", 32)))
        flat["concurrent_num"] = int(raw.get("concurrent_num",
                                             params.get("coreNum", 4)))
        if "batch_timeout_ms" in raw:
            flat["batch_timeout_ms"] = int(raw["batch_timeout_ms"])
        flat["queue_host"] = raw.get("queue_host",
                                     redis.get("host", "127.0.0.1"))
        flat["queue_port"] = int(raw.get("queue_port",
                                         redis.get("port", 6380)))
        tn = raw.get("top_n", post.get("topN"))
        flat["top_n"] = int(tn) if tn is not None else None
        flat["int8"] = bool(raw.get("int8", model.get("int8", False)))
        ws = raw.get("warmup_shape", model.get("warmup_shape"))
        flat["warmup_shape"] = tuple(int(d) for d in ws) if ws else None
        flat["log_dir"] = raw.get("log_dir")
        if raw.get("graph_checks") is not None:
            gc = raw["graph_checks"]
            # YAML 1.1 parses bare off/on as booleans; map them back to the
            # policy strings instead of coercing to "False"/"True". A typo'd
            # policy must fail HERE: by warmup time the engine tolerates
            # check failures in warn mode, so a bad value would silently
            # disable the enforcement the operator asked for.
            val = ("off" if gc is False
                   else "warn" if gc is True else str(gc))
            if val not in ("off", "warn", "raise"):
                raise ValueError(f"graph_checks must be 'off'/'warn'/"
                                 f"'raise', got {gc!r}")
            flat["graph_checks"] = val
        mem = raw.get("memory") or {}
        hb = raw.get("hbm_budget_mb", mem.get("hbm_budget_mb"))
        if hb is not None:
            flat["hbm_budget_mb"] = float(hb)
        gen = raw.get("generation") or {}
        gen_aliases = (("gen_slots", "slots"),
                       ("gen_page_size", "page_size"),
                       ("gen_max_seq_len", "max_seq_len"),
                       ("gen_pages", "pages"),
                       ("gen_top_k", "top_k"),
                       ("gen_spec_k", "spec_k"),
                       ("gen_spec_ngram", "spec_ngram"),
                       ("gen_prefix_cache_pages", "prefix_cache_pages"),
                       ("gen_prefix_block_tokens", "prefix_block_tokens"),
                       ("gen_prefill_chunk_tokens", "prefill_chunk_tokens"),
                       ("gen_prefill_token_budget", "prefill_token_budget"))
        # typo rejection (same contract as graph_checks/fleet/overload): a
        # misspelled generation knob must fail at config time, not silently
        # serve with the default (e.g. `prefix_cache_page:` quietly leaving
        # sharing off)
        known_gen = {alias for _, alias in gen_aliases}
        unknown_gen = sorted(set(gen) - known_gen)
        if unknown_gen:
            raise ValueError(
                f"unknown generation key(s) {unknown_gen}; valid keys: "
                f"{sorted(known_gen)}")
        for key, alias in gen_aliases:
            if key in raw:
                flat[key] = int(raw[key])
            elif alias in gen:
                flat[key] = int(gen[alias])
        pcp = flat.get("gen_prefix_cache_pages")
        if pcp is not None and pcp < 0:
            raise ValueError(f"generation prefix_cache_pages must be >= 0, "
                             f"got {pcp}")
        pbt = flat.get("gen_prefix_block_tokens")
        if pbt is not None:
            ps = flat.get("gen_page_size", cls.gen_page_size)
            if pbt < 0 or (pbt and pbt % ps):
                raise ValueError(
                    f"generation prefix_block_tokens must be 0 (= one "
                    f"page) or a positive multiple of page_size {ps}, "
                    f"got {pbt}")
        pct = flat.get("gen_prefill_chunk_tokens")
        if pct is not None:
            ps = flat.get("gen_page_size", cls.gen_page_size)
            if pct < 0 or (pct and pct % ps):
                raise ValueError(
                    f"generation prefill_chunk_tokens must be 0 (= whole-"
                    f"prompt prefill) or a positive multiple of page_size "
                    f"{ps}, got {pct}")
        ptb = flat.get("gen_prefill_token_budget")
        if ptb is not None:
            if ptb < 0:
                raise ValueError(f"generation prefill_token_budget must be "
                                 f">= 0, got {ptb}")
            if ptb and not flat.get("gen_prefill_chunk_tokens"):
                raise ValueError(
                    "generation prefill_token_budget requires "
                    "prefill_chunk_tokens > 0 (the budget is spent in "
                    "whole chunks)")
        fleet = raw.get("fleet") or {}
        for key, alias in (("replicas", "replicas"),
                           ("fleet_policy", "policy"),
                           ("fleet_spawn", "spawn"),
                           ("fleet_heartbeat_s", "heartbeat_s"),
                           ("fleet_failover_timeout_s", "failover_timeout_s"),
                           ("fleet_spawn_grace_s", "spawn_grace_s"),
                           ("fleet_hosts", "hosts"),
                           ("fleet_host_capacity", "host_capacity"),
                           ("fleet_host_skew_tolerance_s",
                            "host_skew_tolerance_s")):
            if key in raw:
                flat[key] = type(getattr(cls, key))(raw[key])
            elif alias in fleet:
                flat[key] = type(getattr(cls, key))(fleet[alias])
        if flat.get("fleet_policy") not in (None, "least_pending",
                                            "round_robin"):
            raise ValueError(f"fleet policy must be 'least_pending'/"
                             f"'round_robin', got {flat['fleet_policy']!r}")
        if flat.get("fleet_spawn") not in (None, "thread", "process", "host"):
            raise ValueError(f"fleet spawn must be 'thread'/'process'/"
                             f"'host', got {flat['fleet_spawn']!r}")
        if flat.get("fleet_hosts", 0) < 0:
            raise ValueError(f"fleet hosts must be >= 0, "
                             f"got {flat['fleet_hosts']!r}")
        if flat.get("fleet_host_capacity", 1) < 1:
            raise ValueError(f"fleet host_capacity must be >= 1, "
                             f"got {flat['fleet_host_capacity']!r}")
        rollout = raw.get("rollout") or {}
        for key, alias in (("hot_swap", "enabled"),
                           ("swap_warmup", "warmup"),
                           ("swap_timeout_s", "swap_timeout_s"),
                           ("rollout_canary_fraction", "canary_fraction"),
                           ("rollout_window_s", "window_s"),
                           ("rollout_min_requests", "min_requests"),
                           ("rollout_max_error_delta", "max_error_delta"),
                           ("rollout_max_latency_ratio",
                            "max_latency_ratio")):
            if key in raw:
                flat[key] = type(getattr(cls, key))(raw[key])
            elif alias in rollout:
                flat[key] = type(getattr(cls, key))(rollout[alias])
        frac = flat.get("rollout_canary_fraction")
        if frac is not None and not (0.0 < frac <= 1.0):
            raise ValueError(f"rollout canary_fraction must be in (0, 1], "
                             f"got {frac!r}")
        overload = raw.get("overload") or {}
        for key, alias in (("default_priority", "priority"),
                           ("bulk_inflight_fraction",
                            "bulk_inflight_fraction")):
            if key in raw:
                flat[key] = type(getattr(cls, key))(raw[key])
            elif alias in overload:
                flat[key] = type(getattr(cls, key))(overload[alias])
        pri = flat.get("default_priority")
        if pri is not None and pri not in ("critical", "normal", "bulk"):
            raise ValueError(f"overload priority must be 'critical'/"
                             f"'normal'/'bulk', got {pri!r}")
        frac = flat.get("bulk_inflight_fraction")
        if frac is not None and not (0.0 < frac <= 1.0):
            raise ValueError(f"overload bulk_inflight_fraction must be in "
                             f"(0, 1], got {frac!r}")
        auto = raw.get("autoscale") or {}
        for key, alias in (("autoscale", "enabled"),
                           ("min_replicas", "min_replicas"),
                           ("max_replicas", "max_replicas"),
                           ("autoscale_up_depth", "up_depth"),
                           ("autoscale_sustain_s", "sustain_s"),
                           ("autoscale_idle_s", "idle_s"),
                           ("autoscale_cooldown_s", "cooldown_s")):
            # the flat `autoscale:` key COLLIDES with the section name: when
            # the value is the nested mapping itself, bool(dict) would read
            # any non-empty section — `enabled: false` included — as True
            if key in raw and not isinstance(raw[key], dict):
                flat[key] = type(getattr(cls, key))(raw[key])
            elif alias in auto:
                flat[key] = type(getattr(cls, key))(auto[alias])
        lo = flat.get("min_replicas")
        hi = flat.get("max_replicas")
        if lo is not None and lo < 1:
            raise ValueError(f"autoscale min_replicas must be >= 1, "
                             f"got {lo!r}")
        if (hi is not None and hi < (lo if lo is not None
                                     else cls.min_replicas)):
            raise ValueError(f"autoscale max_replicas ({hi!r}) must be >= "
                             f"min_replicas")
        slo = raw.get("slo") or {}
        if slo:
            objectives = slo.get("objectives") or []
            if not isinstance(objectives, list) or not all(
                    isinstance(o, dict) for o in objectives):
                raise ValueError("slo objectives must be a list of mappings")
            # validate declaratively at CONFIG time (a typo'd objective must
            # fail here, not wedge the engine at runtime) — parse_objectives
            # raises on unknown type / bad target / duplicate names
            from ..observability.slo import parse_objectives

            parse_objectives(objectives)
            flat["slo_objectives"] = tuple(dict(o) for o in objectives)
            for key, alias in (("slo_fast_window_s", "fast_window_s"),
                               ("slo_slow_window_s", "slow_window_s"),
                               ("slo_burn_factor", "burn_factor")):
                if alias in slo:
                    flat[key] = float(slo[alias])
            fast = flat.get("slo_fast_window_s", cls.slo_fast_window_s)
            slow = flat.get("slo_slow_window_s", cls.slo_slow_window_s)
            if fast >= slow:
                raise ValueError(f"slo fast_window_s ({fast}) must be < "
                                 f"slow_window_s ({slow})")
        for key in ("infer_workers", "heartbeat_timeout_s",
                    "http_max_inflight", "breaker_failure_threshold",
                    "breaker_reset_timeout_s"):
            if key in raw:
                flat[key] = type(getattr(cls, key))(raw[key])
        return cls(**flat)
