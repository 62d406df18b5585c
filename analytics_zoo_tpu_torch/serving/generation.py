"""Autoregressive generation serving: continuous micro-batching + streaming
(port of ``ContinuousBatcher`` in ``analytics_zoo_tpu/serving/generation.py``).

:class:`ContinuousBatcher` runs ``n_slots`` concurrent decode sequences over
one paged KV cache. One daemon loop thread admits pending requests into free
slots in ``(priority, deadline, submission)`` order (whole-prompt prefill
into a power-of-two bucket, or chunked prefill under a per-pass token
budget), runs one decode step over the live slots (single-token, or a
speculative verify of ``spec_k`` tokens), emits per-stream token deltas,
and retires finished sequences — all per step, so aggregate throughput
tracks active tokens instead of the slowest request of a batch
(``admit_policy="batch"`` is the run-to-completion baseline the bench
compares against). With a prefix cache, a prompt's published blocks are
shared (refcounted pages, copy-on-write at the boundary) and only its
suffix is prefilled. Speculation, chunking and prefix sharing change the
cost of a stream, never its tokens.

Overload QoS (``serving/qos.py``): a request whose deadline provably cannot
be met is shed before any page is spent on it (outcome ``shed`` with a
computed ``retry_after_s``); a ``critical`` request on a full batcher
preempts the least urgent ``bulk`` slot, whose stream parks with its KV
pages and resumes later with nothing recomputed. ``swap_params`` lands a
(weights, speculative schedule) pair between decode steps; a supervisor
thread respawns a chaos-killed loop with slot and cache state intact.
Every decision counts in the port's telemetry (the ``zoo_gen_*``
families), emits decision events and, with a flight recorder installed,
records its inputs.

Over the broker (port of the JAX module's ``GenerationEngine`` and
``GenerationClient``): :class:`GenerationEngine` consumes requests from the
``generation_stream``, runs them through a :class:`ContinuousBatcher` built
from the ``ServingConfig``'s ``gen_*`` fields on ``device``, and streams
token deltas as frames on ``genout:<uri>``; :class:`GenerationClient`
submits, cancels and reads them back in ``seq`` order.

Graph checks: ``ContinuousBatcher(graph_checks=, hbm_budget_bytes=)`` runs
:meth:`ContinuousBatcher.check_decode_stability` at construction — the
decode step (or the verify step at ``spec_k``, and the prefill chunk at
``prefill_chunk_tokens``) recorded without running and held to
``decode-shape-stability``, ``cache-alias`` and ``hbm-budget``;
``GenerationEngine`` runs it at ``start`` under ``ServingConfig.
graph_checks`` and ``hbm_budget_mb``. Every decode and verify step samples
the memory witness at site ``serving.decode``.

``GenerationEngine`` arms the SLO-derived prefill budget from the config's
inter-token-latency objective (a latency objective whose name mentions
``itl``), as the JAX engine does; the engine's ``stats()`` report it as
``itl_target_s``. Given a ``stream``, the engine is a fleet replica: it
reads its own routed dispatch stream (``serving/fleet.py``'s
``ReplicaRouter`` forwards there) under a group that starts at ``"0"``.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
import uuid
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..analysis.rules.decode import lint_prefix_write_isolation
from ..bridge import flat_tree, land_tensors, params_from_jax, stage_tensors
from ..common import memwitness as _mw
from ..common import telemetry as _tm
from ..common.chaos import WorkerKilled, chaos_point
from ..common.locks import traced_lock
from ..common.resilience import (HealthRegistry, RetryAbortedError,
                                 RetryPolicy)
from ..nn.module import resolve_device
from ..observability import events as _events
from ..observability import recorder as _flight
from ..ops.kv_cache import (OutOfPages, PagePool, PrefixCache, SCRATCH_PAGE,
                            copy_page, sample_tokens)
from ..ops.speculative import SpecDecodeConfig, propose_kgram
from . import qos as _qos
from .client import _Conn, default_conn_policy
from .config import ServingConfig
from .schema import (DEADLINE_KEY, PRIORITY_KEY, TRACE_KEY, payload_deadline,
                     payload_priority, payload_trace)

logger = logging.getLogger("analytics_zoo_tpu_torch.serving.generation")

GEN_STREAM = "generation_stream"
GEN_OUT_PREFIX = "genout:"
# broker-side stats hash (per consumer group): the engine's source loop
# republishes GenerationEngine.stats() here ~1/s
GEN_STATS_PREFIX = "gen:stats:"

# the JAX package's families, names, labels and buckets: a scrape of either
# package's registry reads the same
_GEN_TOKENS = _tm.counter("zoo_gen_tokens_total",
                          "Tokens processed by generation serving, by phase "
                          "(prefill = prompt tokens, decode = generated)",
                          labels=("phase",))
_GEN_REQS = _tm.counter("zoo_gen_requests_total",
                        "Generation requests finished, by outcome",
                        labels=("outcome",))
_GEN_STEPS = _tm.counter("zoo_gen_decode_steps_total",
                         "Multi-slot decode steps executed")
_GEN_ITL = _tm.histogram("zoo_gen_inter_token_seconds",
                         "Per-stream time between consecutive emitted tokens",
                         buckets=(.001, .0025, .005, .01, .025, .05, .1,
                                  .25, .5, 1.0, 2.5))
_GEN_TTFT = _tm.histogram(
    "zoo_gen_ttft_seconds",
    "Per-stream time from submit to the first emitted token, by priority "
    "class — queue wait + prefill wait + prefill compute",
    labels=("priority",),
    buckets=(.005, .01, .025, .05, .1, .25, .5, 1.0, 2.5, 5.0, 10.0))
_GEN_PREFILL_CHUNKS = _tm.counter(
    "zoo_gen_prefill_chunks_total",
    "Chunked-prefill dispatches executed (each fills at most "
    "prefill_chunk_tokens positions of one stream's prompt)")
_GEN_SHED = _tm.counter("zoo_gen_shed_total",
                        "Generation requests shed by the continuous batcher "
                        "instead of decoded, by overload class",
                        labels=("reason",))
_GEN_PREEMPT = _tm.counter(
    "zoo_gen_preemptions_total",
    "Bulk decode slots preempted for latency-critical requests (the "
    "preempted stream keeps its KV pages and resumes in a later slot)")
_GEN_SPEC_STEPS = _tm.counter(
    "zoo_gen_spec_steps_total",
    "Speculative verify steps executed (each scores spec_k tokens per slot "
    "in one dispatch)")
_GEN_SPEC_TOKENS = _tm.counter(
    "zoo_gen_spec_tokens_total",
    "Speculative-decode draft accounting: drafted = k-1 proposals per slot "
    "per verify step, accepted = drafts the target confirmed (acceptance "
    "rate = accepted/drafted)", labels=("kind",))
_GEN_SPEC_ACCEPT_PROB = _tm.histogram(
    "zoo_gen_spec_accept_prob",
    "Per-draft acceptance probability under the target distribution "
    "(pi(draft) from the verify step — the expected-acceptance signal)",
    buckets=(.01, .05, .1, .25, .5, .75, .9, .99))
_GEN_SWAPS = _tm.counter(
    "zoo_gen_swaps_total",
    "Atomic (target params, draft schedule) hot-swap pairs applied by live "
    "continuous batchers between decode steps")
_GEN_PREFIX_HITS = _tm.counter(
    "zoo_gen_prefix_hits_total",
    "Prefills that matched at least one published prefix block in the "
    "shared-prefix KV cache (matched pages mapped read-only, zero compute)")
_GEN_PREFIX_MISSES = _tm.counter(
    "zoo_gen_prefix_misses_total",
    "Prefills that matched no published prefix block (full cold prefill)")
_GEN_PREFIX_TOKENS_SAVED = _tm.counter(
    "zoo_gen_prefix_tokens_saved_total",
    "Prompt tokens NOT recomputed because their KV pages came from the "
    "shared-prefix cache (per warm prefill: tokens before the divergence "
    "point)")
_GEN_PREFIX_EVICTED = _tm.counter(
    "zoo_gen_prefix_evicted_pages_total",
    "KV pages released by prefix-cache eviction sweeps (LRU over entries "
    "no live stream is matched through: budget overflow + pool-pressure "
    "reclaims)")
_LIVE_GENERATORS: "weakref.WeakSet[ContinuousBatcher]" = weakref.WeakSet()
_tm.collector("zoo_gen_active_slots",
              "Occupied decode slots summed over live continuous batchers",
              lambda: [((), float(sum(g.active_slots()
                                      for g in list(_LIVE_GENERATORS))))])
_tm.collector("zoo_gen_free_pages",
              "Free KV-cache pages summed over live continuous batchers",
              lambda: [((), float(sum(g.pool.free_count()
                                      for g in list(_LIVE_GENERATORS))))])
_tm.collector("zoo_gen_prefix_reclaimable_pages",
              "Prefix-cache pages whose only reference is the cache's own "
              "(no live stream attached) — pages an eviction sweep would "
              "return to the free list",
              lambda: [((), float(sum(
                  g.prefix_cache.reclaimable_pages()
                  for g in list(_LIVE_GENERATORS)
                  if g.prefix_cache is not None)))])


def _same_device(a: torch.device, b: torch.device) -> bool:
    # "cuda" and "cuda:0" name the same card when 0 is the current one
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return a.index == b.index
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == \
        (cur if b.index is None else b.index)


def _next_pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class _Request:
    """One generation request's host-side state."""

    __slots__ = ("uri", "prompt", "max_new_tokens", "temperature", "seed",
                 "eos_id", "on_chunk", "ctx", "submitted_t", "cancelled",
                 "last_emit_t", "priority", "deadline", "seq",
                 "cached_prefix_tokens")

    def __init__(self, uri, prompt, max_new_tokens, temperature, seed,
                 eos_id, on_chunk, ctx=None, priority=None, deadline=None,
                 seq=0):
        self.uri = uri
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.seed = int(seed) & 0xFFFFFFFF
        self.eos_id = eos_id
        self.on_chunk = on_chunk
        self.ctx = ctx
        self.submitted_t = time.perf_counter()
        self.cancelled = False
        self.last_emit_t: Optional[float] = None
        # overload QoS: admission runs in (priority, deadline, seq) order;
        # critical requests may preempt bulk decode slots
        self.priority = _qos.normalize_priority(priority)
        self.deadline = _qos.normalize_deadline(deadline)
        self.seq = seq
        # prompt tokens served from the shared-prefix cache (set at
        # admission)
        self.cached_prefix_tokens = 0

    @property
    def order_key(self) -> Tuple:
        return _qos.order_key(self.priority, self.deadline, self.seq)


class StreamHandle:
    """In-process consumer for one stream: iterate :meth:`tokens` for chunk
    deltas, or :meth:`result` for the whole sequence. ``cancel()`` retires
    the request at the next decode step."""

    def __init__(self, request: _Request):
        self._request = request
        self._q: "queue.Queue[Tuple[List[int], bool, Dict[str, Any]]]" = \
            queue.Queue()
        self.uri = request.uri

    def _push(self, tokens: List[int], final: bool, meta: Dict[str, Any]):
        self._q.put((tokens, final, meta))

    def cancel(self):
        self._request.cancelled = True

    def frames(self, timeout_s: float = 60.0):
        """Yield raw ``(tokens, final, meta)`` frames until (and including)
        the final one. Raises :class:`TimeoutError` when the decode loop
        stalls past ``timeout_s``."""
        while True:
            try:
                tokens, final, meta = self._q.get(timeout=timeout_s)
            except queue.Empty:
                raise TimeoutError(
                    f"no generation frame for {self.uri!r} within "
                    f"{timeout_s}s") from None
            yield tokens, final, meta
            if final:
                return

    def tokens(self, timeout_s: float = 60.0):
        """Yield token-chunk lists until the final frame; raises
        :class:`~.qos.ShedError` on a shed stream and ``RuntimeError`` on an
        errored one."""
        for tokens, final, meta in self.frames(timeout_s=timeout_s):
            if tokens:
                yield tokens
            if final and meta.get("outcome") == "shed":
                raise _qos.ShedError(
                    f"generation request {self.uri!r} shed: "
                    f"{meta.get('error', 'overloaded')}",
                    retry_after_s=float(meta.get("retry_after_s", 1.0)),
                    reason="deadline")
            if final and meta.get("error"):
                raise RuntimeError(
                    f"generation failed for {self.uri!r}: {meta['error']}")

    def result(self, timeout_s: float = 60.0) -> List[int]:
        out: List[int] = []
        for chunk in self.tokens(timeout_s=timeout_s):
            out.extend(chunk)
        return out


class _Slot:
    """One decode slot's host-side state (device state lives in the cache)."""

    __slots__ = ("request", "length", "generated", "last_token", "pages",
                 "history", "pending_drafts", "prefix_keys", "prefilling",
                 "prefill_done", "chunks", "admitted_t")

    def __init__(self, request: _Request, length: int, last_token: int,
                 pages: List[int], history: Optional[List[int]] = None,
                 prefix_keys: Optional[List[str]] = None):
        self.request = request
        self.length = length            # tokens already in the cache
        self.generated = 1              # prefill samples token 0
        self.last_token = last_token    # sampled, not yet cached
        self.pages = pages              # page references (released on retire)
        # chunked prefill: a prefilling slot owns its pages and table row
        # but is masked out of every decode/verify dispatch until
        # _finalize_prefill samples token 0 and flips it live
        self.prefilling = False
        self.prefill_done = 0           # prompt tokens already in the cache
        self.chunks = 0                 # chunk dispatches spent on this slot
        self.admitted_t = time.perf_counter()
        # prompt + emitted tokens: the k-gram proposer's corpus, kept in
        # plain mode too so a swap into speculative mode drafts at once
        self.history: List[int] = history if history is not None else []
        # drafted, not yet verified: proposed right after each step, so a
        # preempted slot parks carrying its pending drafts
        self.pending_drafts: Optional[List[int]] = None
        # prefix-cache entries this stream matched through at admission,
        # released when the slot retires (the page references ride pages)
        self.prefix_keys: List[str] = prefix_keys or []


def _flat_params(params, names: Mapping[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """A swap's params as ``{dotted name: tensor}``: the port's own tree (a
    state dict of tensors, as :meth:`ContinuousBatcher.host_params` gives)
    as it is, a JAX-layout tree of numpy arrays through the bridge. Every
    name, shape and dtype must be the model's: the flip swaps references
    and compiles nothing, so a different tree is refused here."""
    flat = flat_tree(params)
    missing = sorted(set(names) - set(flat))
    extra = sorted(set(flat) - set(names))
    if missing or extra:
        raise ValueError(f"swap params do not match the model: missing "
                         f"{missing[:5]}, unknown {extra[:5]}")
    for n, p in names.items():
        t = flat[n]
        if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
            raise ValueError(f"swap param {n} is {tuple(t.shape)} {t.dtype}, "
                             f"the model's {tuple(p.shape)} {p.dtype}")
    return flat


class ContinuousBatcher:
    """Continuous micro-batching decode loop over a paged KV cache.

    ``model`` is a :class:`~analytics_zoo_tpu_torch.models.transformer.
    TransformerLM` (its own parameters are served). ``device`` must be the
    model's device; it defaults to CUDA and raises when CUDA is absent, as
    every entry point of the port does.

    ``spec_k`` >= 2 decodes speculatively (``spec_k`` tokens scored per
    verify step, ``spec_ngram`` the proposer's longest n-gram; 0 and 1 are
    plain decode). ``prefill_chunk_tokens`` > 0 (a multiple of
    ``page_size``) prefills every prompt in chunks of that many tokens, at
    most ``prefill_token_budget`` tokens a loop pass (or the headroom that
    ``prefill_slo_itl_s`` leaves; one chunk at least) before each decode
    step. ``prefix_cache_pages`` > 0 shares published prompt blocks of
    ``prefix_block_tokens`` (default ``page_size``) tokens between streams,
    the cache holding at most that many pages of the pool.

    ``admit_policy``: ``"continuous"`` (default) admits whenever a slot is
    free; ``"batch"`` is the run-to-completion baseline — admission only
    when EVERY slot is free, and only once a full wave is pending or
    ``batch_window_s`` passed since the first request waited. A supervisor
    thread respawns a loop that a chaos kill ended, with slot and cache
    state intact. ``registry``: a
    :class:`~analytics_zoo_tpu_torch.common.resilience.HealthRegistry`,
    accepted and stored for parity with the JAX batcher's signature;
    nothing reads it, in either package.

    The pool is written in place, so the JAX package's ``donate_cache``
    has no counterpart here: ``cache-alias`` holds the step to writing it
    in place. ``graph_checks`` ("warn"/"raise") runs
    :meth:`check_decode_stability` at construction, with
    ``hbm_budget_bytes`` as its budget.
    """

    def __init__(self, model, *, n_slots: int = 8, page_size: int = 16,
                 max_seq_len: Optional[int] = None,
                 n_pages: Optional[int] = None, top_k: int = 0,
                 spec_k: int = 0, spec_ngram: int = 3,
                 admit_policy: str = "continuous",
                 batch_window_s: float = 0.05,
                 prefix_cache_pages: int = 0,
                 prefix_block_tokens: int = 0,
                 prefill_chunk_tokens: int = 0,
                 prefill_token_budget: int = 0,
                 prefill_slo_itl_s: Optional[float] = None,
                 graph_checks: Optional[str] = None,
                 hbm_budget_bytes: Optional[int] = None,
                 registry: Optional[HealthRegistry] = None,
                 device=None, autostart: bool = True):
        if admit_policy not in ("continuous", "batch"):
            raise ValueError(f"unknown admit_policy {admit_policy!r}")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if page_size & (page_size - 1):
            raise ValueError(f"page_size must be a power of two, got "
                             f"{page_size} (prefill buckets are pow2 and "
                             f"must tile by pages)")
        if prefill_chunk_tokens < 0 or (prefill_chunk_tokens
                                        and prefill_chunk_tokens % page_size):
            raise ValueError(f"prefill_chunk_tokens must be 0 (whole-prompt "
                             f"prefill) or a positive multiple of page_size "
                             f"{page_size}, got {prefill_chunk_tokens}")
        if prefill_token_budget < 0:
            raise ValueError(f"prefill_token_budget must be >= 0, got "
                             f"{prefill_token_budget}")
        if prefill_token_budget and not prefill_chunk_tokens:
            raise ValueError("prefill_token_budget requires "
                             "prefill_chunk_tokens > 0 (the budget is spent "
                             "in whole chunks)")
        self.device = resolve_device(device)
        if not _same_device(torch.device(model.device), self.device):
            raise ValueError(f"model lives on {model.device}, batcher asked "
                             f"for {self.device}")
        self.model = model
        self.n_slots = int(n_slots)
        # clamp to the vocabulary: top-k with k > V has no meaning
        self.top_k = min(int(top_k), int(model.vocab))
        self.admit_policy = admit_policy
        # batch mode only: how long to wait for a full wave before sealing
        # a partial one (a wave of 1 would flatter continuous mode)
        self.batch_window_s = float(batch_window_s)
        self._pending_since: Optional[float] = None
        self.cfg, self.cache = model.init_kv_cache(
            n_slots, page_size=page_size, max_seq_len=max_seq_len,
            n_pages=n_pages)
        self.pool = PagePool(self.cfg)
        # shared-prefix cache: its budget counts cache-held pages inside
        # the one pool, reclaimed under pool pressure before any stream is
        # truncated for pages the cache sits on
        self.prefix_cache: Optional[PrefixCache] = None
        if int(prefix_cache_pages) > 0:
            self.prefix_cache = PrefixCache(
                self.pool,
                block_tokens=int(prefix_block_tokens) or page_size,
                page_size=page_size, max_pages=int(prefix_cache_pages))
        self.prefix_tokens_saved = 0
        self.peak_pages_in_use = 0
        self.registry = registry
        # host-side page tables (fixed shape), copied to the device per step
        self._table = np.full((self.n_slots, self.cfg.pages_per_slot),
                              SCRATCH_PAGE, np.int32)
        self._slots: List[Optional[_Slot]] = [None] * self.n_slots
        self._pending: "queue.Queue[_Request]" = queue.Queue()
        # (priority, deadline, seq)-ordered staging between the submit
        # queue and admission; owned by the loop thread. Preempted bulk
        # slots park on _preempted with their KV pages intact
        self._backlog: List[_Request] = []
        self._preempted: List[_Slot] = []
        self._seq = 0
        # uris cancelled while still queued (bounded: unknown uris age out)
        self._cancelled_uris: "deque[str]" = deque(maxlen=1024)
        self._wake = threading.Event()
        self._stop = threading.Event()
        # guards _slots, _table, _seq and _preempted against stats readers;
        # final-frame callbacks run outside it
        self._lock = traced_lock("ContinuousBatcher._lock")
        # measured decode-step and prefill-chunk service times: the shed
        # proof for queued requests, the Retry-After, and the SLO-derived
        # prefill budget
        self.step_ema = _qos.ServiceTimeEMA()
        self.chunk_ema = _qos.ServiceTimeEMA()
        self.prefill_chunk_tokens = int(prefill_chunk_tokens)
        self.prefill_token_budget = int(prefill_token_budget)
        self.prefill_slo_itl_s = (float(prefill_slo_itl_s)
                                  if prefill_slo_itl_s else None)
        self._last_budget: Optional[Dict[str, Any]] = None
        self.spec_k = 0 if int(spec_k) == 1 else int(spec_k)
        self.spec_ngram = int(spec_ngram)
        # a staged (params, event, version, spec) flip, landed by the loop
        # thread between decode steps
        self._pending_swap: Optional[Tuple] = None
        self.version: Optional[str] = None
        self.swaps = 0
        self.preemptions = 0
        # accounting; steps counts decode and verify dispatches
        self.steps = 0
        self.tokens_generated = 0
        self.requests_finished: Dict[str, int] = {}
        self.loop_respawns = 0
        self.prefill_buckets: set = set()
        self.decode_shapes: set = set()
        self.chunk_shapes: set = set()
        self.prefill_chunks_total = 0
        self.prefills_whole = 0          # whole-prompt prefill dispatches
        self.prefills_from = 0           # suffix prefills from a prefix hit
        self.spec_steps = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self._occupied_slot_steps = 0
        self._decode_tokens = 0          # decode-phase tokens (not prefill)
        self.hbm_budget_bytes = hbm_budget_bytes
        if graph_checks and graph_checks != "off":
            self.check_decode_stability(graph_checks)
        _LIVE_GENERATORS.add(self)
        self._threads: List[threading.Thread] = []
        self._loop_thread: Optional[threading.Thread] = None
        if autostart:
            self.start()

    # ------------------------------------------------------------------ control

    def start(self) -> "ContinuousBatcher":
        running = self._loop_thread
        if running is not None and running.is_alive():
            return self          # idempotent: already running
        self._stop.clear()
        self._loop_thread = self._spawn_loop()
        sup = threading.Thread(target=self._supervise, daemon=True,
                               name="zoo-torch-gen-supervisor")
        sup.start()
        self._threads = [self._loop_thread, sup]
        return self

    def _spawn_loop(self) -> threading.Thread:
        t = threading.Thread(target=self._loop, daemon=True,
                             name="zoo-torch-gen-batcher")
        t.start()
        return t

    def _supervise(self):
        """Respawn a dead decode loop (a chaos kill) with slot and cache
        state intact: in-flight streams continue where they stopped."""
        while not self._stop.is_set():
            if not self._loop_thread.is_alive() and not self._stop.is_set():
                logger.warning("respawning dead generation decode loop")
                self.loop_respawns += 1
                self._loop_thread = self._spawn_loop()
            self._stop.wait(0.05)

    def close(self, timeout_s: float = 30.0):
        """Stop the loop and supervisor threads, join them, fail every
        request still queued, parked or in flight, and drop the prefix
        cache's page references (so a closed batcher's pool sums back to
        capacity)."""
        self._stop.set()
        self._wake.set()
        # the supervisor first: once it has stopped, no loop is respawned
        for t in self._threads[1:] + [self._loop_thread]:
            if t is None:
                continue
            t.join(timeout=timeout_s)
            if t.is_alive():
                raise RuntimeError(f"generation thread {t.name} did not stop "
                                   f"within {timeout_s}s")
        self._threads = []
        while True:
            try:
                self._backlog.append(self._pending.get_nowait())
            except queue.Empty:
                break
        backlog, self._backlog = self._backlog, []
        for req in backlog:
            self._finish_cb(req, [], "error",
                            error="generator closed before admission")
        with self._lock:
            parked, self._preempted = self._preempted, []
            for slot in parked:
                self._release_claim(slot.prefix_keys, slot.pages)
                slot.pages = []
                slot.prefix_keys = []
        for slot in parked:
            self._finish_cb(slot.request, [], "error",
                            error="generator closed mid-stream",
                            n_tokens=slot.generated)
        self._fail_all_active("generator closed mid-stream")
        if self.prefix_cache is not None:
            self.prefix_cache.invalidate()

    # ------------------------------------------------------------------- client

    def submit(self, prompt, max_new_tokens: int = 32,
               temperature: float = 0.0, seed: int = 0,
               eos_id: Optional[int] = None, uri: Optional[str] = None,
               on_chunk: Optional[Callable] = None, ctx=None,
               priority: Optional[str] = None,
               deadline: Optional[float] = None) -> StreamHandle:
        """Enqueue one generation request; returns a :class:`StreamHandle`.
        ``on_chunk(tokens, final, meta)`` additionally mirrors every
        frame. ``priority`` (critical/normal/bulk) and ``deadline``
        (absolute epoch seconds) order admission; a critical request may
        preempt a bulk slot, and a request whose deadline provably cannot
        be met finishes with outcome ``shed``. ``ctx``: a trace wire
        context the request's spans join."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        limit = self.cfg.max_seq_len
        if prompt.size >= limit:
            raise ValueError(f"prompt of {prompt.size} tokens exceeds the "
                             f"cache's max_seq_len {limit}")
        with self._lock:
            self._seq += 1
            seq = self._seq
        req = _Request(uri or uuid.uuid4().hex, prompt, max_new_tokens,
                       temperature, seed, eos_id, on_chunk, ctx,
                       priority=priority, deadline=deadline, seq=seq)
        handle = StreamHandle(req)

        def fanout(tokens, final, meta, _h=handle, _cb=on_chunk):
            _h._push(tokens, final, meta)
            if _cb is not None:
                _cb(tokens, final, meta)

        req.on_chunk = fanout
        if self._pending.empty() and not self._backlog:
            self._pending_since = time.monotonic()
        self._pending.put(req)
        self._wake.set()
        return handle

    def generate(self, prompt, **kw) -> List[int]:
        """Blocking convenience: submit + drain the stream."""
        timeout_s = kw.pop("timeout_s", 120.0)
        return self.submit(prompt, **kw).result(timeout_s=timeout_s)

    def cancel_uri(self, uri: str) -> None:
        """Cancel by stream id: marks an active or parked slot's request
        cancelled, or remembers the uri (bounded) so a still-queued request
        is dropped at admission."""
        with self._lock:
            for slot in self._slots:
                if slot is not None and slot.request.uri == uri:
                    slot.request.cancelled = True
                    return
            for slot in self._preempted:
                if slot.request.uri == uri:
                    slot.request.cancelled = True
                    return
            self._cancelled_uris.append(uri)

    # ------------------------------------------------------------------- loop

    def active_slots(self) -> int:
        with self._lock:
            return sum(s is not None for s in self._slots)

    def _loop(self):
        try:
            with torch.no_grad():
                while not self._stop.is_set():
                    # the kill drill's fault site: the supervisor respawns
                    # the loop with slot and cache state intact
                    chaos_point("serving.generate")
                    try:
                        self._apply_pending_swap()
                        self._admit()
                        if self.prefill_chunk_tokens:
                            # at most one budget of prefill chunks, THEN one
                            # decode step: running streams advance every
                            # pass however deep the prefill backlog
                            self._prefill_chunks()
                        if self.active_slots() == 0:
                            if (self._pending.empty() and not self._backlog
                                    and not self._preempted):
                                self._wake.wait(timeout=0.05)
                                self._wake.clear()
                            continue
                        self._step()
                    except Exception as e:
                        # a failing step fails the in-flight streams instead
                        # of killing the loop (a WorkerKilled, a simulated
                        # crash, still reaches the supervisor)
                        logger.exception("decode step failed; failing the "
                                         "active streams")
                        self._fail_all_active(f"decode step failed: {e}")
        except WorkerKilled:
            logger.warning("generation decode loop killed mid-stream; "
                           "slots and cache intact, awaiting respawn")

    def _fail_all_active(self, error: str):
        with self._lock:
            finishes = [self._retire_locked(i, "error", error=error)
                        for i, s in enumerate(self._slots) if s is not None]
        for fin in finishes:
            self._finish_cb(*fin)

    # admission ---------------------------------------------------------------

    def _take_cancelled(self, req: _Request) -> bool:
        """Whether ``req`` was cancelled, by its handle or by uri."""
        if req.uri in self._cancelled_uris:
            self._cancelled_uris.remove(req.uri)
            req.cancelled = True
        return req.cancelled

    def _drain_pending(self) -> None:
        """Move submitted requests into the ordered backlog, dropping
        cancelled ones and SHEDDING every request whose deadline provably
        cannot be met (the measured decode-step time is the proof) before
        any slot or page is spent on it."""
        while True:
            try:
                self._backlog.append(self._pending.get_nowait())
            except queue.Empty:
                break
        if not self._backlog:
            return
        ema = self.step_ema.value()
        now = time.time()
        keep: List[_Request] = []
        for req in sorted(self._backlog, key=lambda r: r.order_key):
            if self._take_cancelled(req):
                self._finish_cb(req, [], "cancelled")
                continue
            rec = _flight.get()
            # no recorder: the bare predicate on the hot path (every backlog
            # entry is judged again each pass); a recorded decision goes
            # through the full pure function, which agrees by definition
            if rec is None and not _qos.cannot_meet(req.deadline, 0.0, ema,
                                                    now=now):
                keep.append(req)
                continue
            inputs = {"now": now, "deadline": req.deadline,
                      "est_wait_s": 0.0, "service_ema_s": ema,
                      "depth": len(self._backlog),
                      "concurrency": self.n_slots,
                      "priority": req.priority}
            decision = _qos.admission_decision(inputs)
            if rec is not None:
                rec.record("admission.generation", inputs, decision)
            if decision["action"] == "shed":
                chaos_point("overload.shed", tag="generation")
                _GEN_SHED.labels(reason="deadline").inc()
                self._finish_cb(
                    req, [], "shed",
                    error="deadline cannot be met by the decode loop",
                    retry_after_s=decision["retry_after_s"])
                continue
            keep.append(req)
        self._backlog = keep

    def _admission_open(self) -> bool:
        if self.admit_policy == "continuous":
            return any(s is None for s in self._slots) or bool(
                self._backlog and self._backlog[0].priority == "critical")
        # run-to-completion: only between waves, and only once a FULL wave
        # is pending (or the batching window expired)
        if any(s is not None for s in self._slots):
            return False
        if len(self._backlog) >= self.n_slots:
            return True
        since = self._pending_since
        return since is not None and \
            time.monotonic() - since >= self.batch_window_s

    def _preempt_for(self, req: _Request) -> bool:
        """Make room for a critical request by preempting the least urgent
        BULK slot: its host state (pages included: its K/V stays where it
        is) parks on ``_preempted`` and resumes in a later free slot with
        nothing recomputed. Returns whether a slot was freed."""
        if req.priority != "critical":
            return False
        with self._lock:
            victims = [(s.request.order_key, i) for i, s in
                       enumerate(self._slots)
                       if s is not None and s.request.priority == "bulk"]
            if not victims:
                return False
            _, idx = max(victims)
            slot = self._slots[idx]
            self._slots[idx] = None
            self._table[idx, :] = SCRATCH_PAGE
            self._preempted.append(slot)
        self.preemptions += 1
        _GEN_PREEMPT.inc()
        logger.info("generation: preempted bulk stream %s for critical %s",
                    slot.request.uri, req.uri)
        return True

    def _resume_slot(self, parked: _Slot) -> None:
        """Re-install a parked stream into a free slot: its page-table row
        goes back exactly (its pages, then scratch), so decode continues
        with no prefill and no token lost."""
        if parked.request.cancelled:
            with self._lock:
                self._release_claim(parked.prefix_keys, parked.pages)
                parked.pages = []
                parked.prefix_keys = []
            self._finish_cb(parked.request, [], "cancelled")
            return
        self._install(self._slots.index(None), parked)

    def _admit(self):
        self._drain_pending()
        # the policy gate opens ONCE a pass; a wave then fills every free
        # slot (checking it per request would seal a batch wave after its
        # first admission)
        if not self._admission_open():
            return
        while not self._stop.is_set():
            # parked streams compete with the backlog under the same order:
            # a parked bulk stream does not jump a queued critical request
            with self._lock:
                cand_resume = min(self._preempted,
                                  key=lambda s: s.request.order_key,
                                  default=None)
            cand_new = self._backlog[0] if self._backlog else None
            if cand_resume is not None and (
                    cand_new is None
                    or cand_resume.request.order_key <= cand_new.order_key):
                if not any(s is None for s in self._slots):
                    return
                with self._lock:
                    self._preempted.remove(cand_resume)
                self._resume_slot(cand_resume)
                continue
            if cand_new is None:
                return
            if not any(s is None for s in self._slots):
                # full house: a critical head may evict a bulk slot (pages
                # intact); anything else waits for a retirement
                if not self._preempt_for(cand_new):
                    return
            req = self._backlog.pop(0)
            if self._take_cancelled(req):
                self._finish_cb(req, [], "cancelled")
                continue
            try:
                self._prefill_into_slot(req)
            except OutOfPages:
                n_need = -(-req.prompt.size // self.cfg.page_size)
                if n_need > self.pool.capacity:
                    self._finish_cb(req, [], "error",
                                    error=f"prompt needs {n_need} pages, "
                                          f"pool capacity "
                                          f"{self.pool.capacity}")
                    continue
                # pool temporarily dry: back at the head of the backlog
                # (first of its class) to wait for retirements
                self._backlog.insert(0, req)
                if self.active_slots() == 0 and self._preempted:
                    # every page is held by PARKED streams: resume one so
                    # the pool can drain, or the critical head and the
                    # parked bulk streams would wait on each other forever
                    with self._lock:
                        parked = min(self._preempted,
                                     key=lambda s: s.request.order_key)
                        self._preempted.remove(parked)
                    self._resume_slot(parked)
                return
            except WorkerKilled:
                # a kill mid-prefill: every page and reference was handed
                # back, so requeue the request for the respawned loop
                self._backlog.insert(0, req)
                raise
            except Exception as e:   # a bad request must not kill the loop
                logger.exception("prefill failed for %s", req.uri)
                self._finish_cb(req, [], "error", error=str(e))

    def _alloc_pages(self, n: int) -> List[int]:
        """``pool.alloc`` with the prefix cache as a pressure valve: a dry
        pool first evicts cache-held entries no stream uses (LRU) before
        :class:`OutOfPages` reaches a stream."""
        try:
            return self.pool.alloc(n)
        except OutOfPages:
            if self.prefix_cache is None:
                raise
            freed = self.prefix_cache.reclaim_pages(n)
            if not freed:
                raise
            _GEN_PREFIX_EVICTED.inc(freed)
            _events.emit("gen.prefix.evicted", severity="info",
                         reason="pool_pressure", pages=freed)
            return self.pool.alloc(n)

    def _note_pool_peak(self) -> None:
        used = self.pool.capacity - self.pool.free_count()
        if used > self.peak_pages_in_use:
            self.peak_pages_in_use = used

    def _claim_pages(self, req: _Request):
        """Claim a new stream's pages: the prefix cache's match first (the
        lookup takes this stream's references on the shared pages), a
        copy-on-write of the boundary page when the WHOLE prompt is cached
        (token 0 still needs the last position's logits, and its K/V write
        must not land in a shared page), then fresh pages for the rest.
        Returns ``(row, keys, start)``: the page row, the matched entry keys
        and the first position to compute. On failure every page and
        prefix reference taken here is handed back."""
        cfg = self.cfg
        n_prompt = int(req.prompt.size)
        n_pg = -(-n_prompt // cfg.page_size)
        match = None
        if self.prefix_cache is not None:
            match = self.prefix_cache.lookup(req.prompt)
            (_GEN_PREFIX_MISSES if match is None else _GEN_PREFIX_HITS).inc()
        keys: List[str] = [] if match is None else match.keys
        row: List[int] = [] if match is None else list(match.pages)
        held: List[int] = list(row)     # pages this stream holds refs on
        start = 0 if match is None else match.n_tokens
        try:
            if match is not None and start >= n_prompt:
                start = n_prompt - 1
                bp = start // cfg.page_size
                (cow,) = self._alloc_pages(1)
                held.append(cow)
                # in place and in stream order: the copy lands before the
                # suffix writes into the page
                copy_page(self.cache, row[bp], cow)
                self.pool.release([row[bp]])
                held.remove(row[bp])
                row[bp] = cow
            if len(row) < n_pg:
                fresh = self._alloc_pages(n_pg - len(row))
                row.extend(fresh)
                held.extend(fresh)
            self._note_pool_peak()
            if start:
                # every page the suffix can write must be this stream's alone
                findings = lint_prefix_write_isolation(
                    self.pool, row, start, page_size=cfg.page_size)
                if findings:
                    raise RuntimeError(
                        "prefix-share write isolation violated: "
                        + "; ".join(f.message for f in findings))
        except BaseException:
            self._release_claim(keys, held)
            raise
        return row, keys, start

    def _release_claim(self, keys: List[str], pages: List[int]) -> None:
        if keys and self.prefix_cache is not None:
            self.prefix_cache.release_stream(keys)
        self.pool.release(pages)

    def _publish(self, req: _Request, pages: List[int]) -> None:
        if self.prefix_cache is None:
            return
        # the fault site between a stream's prefill and its publish: a kill
        # here hands back every reference the stream took (the callers'
        # handlers), and publish is all-or-nothing under the cache's lock
        chaos_point("prefix.publish")
        self.prefix_cache.publish(req.prompt, int(req.prompt.size), pages)
        sweep = self.prefix_cache.evict_to_budget()
        if sweep["pages"]:
            _GEN_PREFIX_EVICTED.inc(sweep["pages"])
            _events.emit("gen.prefix.evicted", severity="info",
                         reason="budget", entries=sweep["entries"],
                         pages=sweep["pages"],
                         held_pages=sweep["held_pages"])

    def _note_prefix_saved(self, req: _Request, start: int) -> None:
        if start:
            req.cached_prefix_tokens = start
            self.prefix_tokens_saved += start
            _GEN_PREFIX_TOKENS_SAVED.inc(start)

    def _install(self, slot_idx: int, slot: _Slot) -> None:
        with self._lock:
            self._table[slot_idx, :] = SCRATCH_PAGE
            self._table[slot_idx, :len(slot.pages)] = slot.pages
            self._slots[slot_idx] = slot

    def _prefill_into_slot(self, req: _Request):
        if self.prefill_chunk_tokens:
            # chunked mode routes EVERY prefill through chunks (a short
            # prompt takes one): one code path
            return self._begin_chunked_prefill(req)
        t_admit = time.perf_counter()
        slot_idx = self._slots.index(None)
        cfg = self.cfg
        n_prompt = int(req.prompt.size)
        row, keys, start = self._claim_pages(req)
        try:
            n_suffix = n_prompt - start
            bucket = min(max(_next_pow2(n_suffix), cfg.page_size),
                         cfg.max_seq_len)
            if bucket % cfg.page_size:
                bucket = -(-bucket // cfg.page_size) * cfg.page_size
            with _tm.span("serving.gen.prefill", remote=req.ctx, uri=req.uri,
                          bucket=bucket, cached_tokens=start):
                ids = np.zeros((1, bucket), np.int32)
                ids[0, :n_suffix] = req.prompt[start:]
                table = np.full((1, cfg.pages_per_slot), SCRATCH_PAGE,
                                np.int32)
                table[0, :len(row)] = row
                if start:
                    logits, self.cache = self.model.prefill_from(
                        self.cache, ids, np.array([start], np.int32),
                        np.array([n_prompt], np.int32), table,
                        page_size=cfg.page_size)
                    self.prefills_from += 1
                else:
                    logits, self.cache = self.model.prefill(
                        self.cache, ids, np.array([n_prompt], np.int32),
                        table, page_size=cfg.page_size)
                    self.prefills_whole += 1
                tok = int(sample_tokens(logits, [req.seed], [0],
                                        [req.temperature],
                                        top_k=self.top_k)[0])
            self._publish(req, row)
        except BaseException:
            # a failed prefill (a chaos kill too) hands back every page and
            # reference it took
            self._release_claim(keys, row)
            raise
        self.prefill_buckets.add(bucket)
        _GEN_TOKENS.labels(phase="prefill").inc(n_suffix)
        self._note_prefix_saved(req, start)
        slot = _Slot(req, n_prompt, tok, list(row),
                     history=req.prompt.tolist() + [tok], prefix_keys=keys)
        slot.admitted_t = t_admit
        if self.spec_k >= 2:
            slot.pending_drafts = propose_kgram(
                slot.history, self.spec_k - 1, self.spec_ngram)
        self._install(slot_idx, slot)
        self._emit(slot, [tok])
        self._maybe_finish(slot_idx)

    # chunked prefill -----------------------------------------------------------

    def _begin_chunked_prefill(self, req: _Request):
        """Admit a request into the ``prefilling`` phase: claim its pages
        (warm prefix blocks first, so a warm stream starts at its suffix)
        and install the slot masked out of every decode dispatch;
        :meth:`_prefill_chunks` fills the prompt chunk by chunk. Nothing is
        dispatched here. Once installed, :meth:`_retire_locked` owns the
        release of its pages and references."""
        slot_idx = self._slots.index(None)
        row, keys, start = self._claim_pages(req)
        self._note_prefix_saved(req, start)
        slot = _Slot(req, int(req.prompt.size), -1, list(row),
                     prefix_keys=keys)
        slot.generated = 0              # token 0 samples at finalize
        slot.prefilling = True
        slot.prefill_done = start
        self._install(slot_idx, slot)

    def _prefill_budget(self) -> int:
        """Tokens this loop pass may spend on prefill chunks, through the
        pure decision function (recorded on the flight recorder, and
        emitted as an event, whenever the verdict changes)."""
        inputs = {"chunk_tokens": self.prefill_chunk_tokens,
                  "static_budget": self.prefill_token_budget,
                  "itl_target_s": self.prefill_slo_itl_s,
                  "decode_ema_s": round(self.step_ema.value(), 6),
                  "chunk_ema_s": round(self.chunk_ema.value(), 6)}
        decision = _qos.prefill_budget_decision(inputs)
        if decision != self._last_budget:
            rec = _flight.get()
            if rec is not None:
                rec.record("gen.prefill.budget", inputs, decision)
            _events.emit("gen.prefill.budget", severity="info",
                         budget_tokens=decision["budget_tokens"],
                         chunks=decision["chunks"],
                         source=decision["source"])
            self._last_budget = decision
        return int(decision["budget_tokens"])

    def _prefill_chunks(self):
        """Spend at most one token budget on pending chunks, in (priority,
        deadline, seq) order. The FIRST chunk always runs (the progress
        floor), then chunks run while they fit."""
        budget: Optional[int] = None
        spent = 0
        while True:
            with self._lock:
                cands = [(s.request.order_key, i)
                         for i, s in enumerate(self._slots)
                         if s is not None and s.prefilling]
            if not cands:
                return
            if budget is None:
                budget = self._prefill_budget()
            if spent and spent + self.prefill_chunk_tokens > budget:
                return
            spent += self._prefill_one_chunk(min(cands)[1])

    def _prefill_one_chunk(self, idx: int) -> int:
        """Run ONE chunk of slot ``idx``'s prompt; finalize the stream when
        the prompt completes. Returns the chunk tokens spent (0 when the
        slot retired instead)."""
        cfg = self.cfg
        ct = self.prefill_chunk_tokens
        fin = None
        with self._lock:
            slot = self._slots[idx]
            if slot is None or not slot.prefilling:
                return 0
            if slot.request.cancelled:
                fin = self._retire_locked(idx, "cancelled")
        if fin is not None:
            self._finish_cb(*fin)
            return 0
        req = slot.request
        n_prompt = int(req.prompt.size)
        n_done = slot.prefill_done
        n_valid = min(ct, n_prompt - n_done)
        # WIDE table: a chunk ending at n_done + ct - 1 can reach page
        # pages_per_slot - 1 + ct/page_size; entries past the row are scratch
        wide = cfg.pages_per_slot + ct // cfg.page_size
        # the fault site BEFORE the dispatch: a kill here leaves the slot
        # untouched, so the respawned loop runs exactly this chunk again
        # (the same K/V into pages this stream alone owns)
        chaos_point("prefill.chunk")
        try:
            with _tm.span("serving.gen.prefill.chunk", remote=req.ctx,
                          uri=req.uri, n_done=n_done, n_valid=n_valid):
                ids = np.zeros((1, ct), np.int32)
                ids[0, :n_valid] = req.prompt[n_done:n_done + n_valid]
                table = np.full((1, wide), SCRATCH_PAGE, np.int32)
                table[0, :len(slot.pages)] = slot.pages
                t0 = time.monotonic()
                logits, self.cache = self.model.prefill_chunk(
                    self.cache, ids, np.array([n_done], np.int32),
                    np.array([n_valid], np.int32), table,
                    page_size=cfg.page_size)
                self.chunk_ema.observe(time.monotonic() - t0)
        except Exception as e:
            # a chunk failure fails THIS stream, not the loop
            logger.exception("prefill chunk failed for %s", req.uri)
            with self._lock:
                if self._slots[idx] is slot:
                    fin = self._retire_locked(
                        idx, "error", error=f"prefill chunk failed: {e}")
            if fin is not None:
                self._finish_cb(*fin)
            return ct
        slot.prefill_done = n_done + n_valid
        slot.chunks += 1
        self.prefill_chunks_total += 1
        self.chunk_shapes.add((ct, wide))
        _GEN_PREFILL_CHUNKS.inc()
        _GEN_TOKENS.labels(phase="prefill").inc(n_valid)
        if slot.prefill_done >= n_prompt:
            self._finalize_prefill(idx, slot, logits)
        return ct

    def _finalize_prefill(self, idx: int, slot: _Slot, logits) -> None:
        """Flip a fully prefilled slot live: sample token 0 (the ordinal-0
        draw whole-prompt prefill takes, so chunking never changes a
        stream), THEN publish to the prefix cache. The order matters: a
        kill at the publish site leaves a clean decoding slot that merely
        never published."""
        req = slot.request
        tok = int(sample_tokens(logits, [req.seed], [0], [req.temperature],
                                top_k=self.top_k)[0])
        slot.last_token = tok
        slot.generated = 1
        slot.history = req.prompt.tolist() + [tok]
        slot.prefilling = False
        if self.spec_k >= 2:
            slot.pending_drafts = propose_kgram(
                slot.history, self.spec_k - 1, self.spec_ngram)
        self._publish(req, slot.pages)
        self._emit(slot, [tok])
        self._maybe_finish(idx)

    # decode ------------------------------------------------------------------

    def _step(self):
        if self.spec_k >= 2:
            return self._step_spec()
        self._step_plain()

    def _step_plain(self, rows: Optional[List[int]] = None):
        """One single-token decode dispatch. ``rows=None`` steps every
        occupied slot over the fixed (n_slots, pages_per_slot) shape; a
        row subset (speculative mode's tail: slots within k of the cache
        cap, or squeezed out of the k-page lookahead by a dry pool) steps
        only those slots, in a dispatch of just their rows. Prefilling
        slots never take part."""
        cfg = self.cfg
        b = self.n_slots
        ids = np.zeros(b, np.int32)
        lengths = np.zeros(b, np.int32)
        seeds = np.zeros(b, np.int64)
        tok_idx = np.zeros(b, np.int64)
        temps = np.zeros(b, np.float32)
        finishes = []
        live: List[int] = []
        with self._lock:
            for i in (range(b) if rows is None else rows):
                slot = self._slots[i]
                if slot is None:
                    continue
                if slot.request.cancelled:
                    finishes.append(self._retire_locked(i, "cancelled"))
                    continue
                if slot.prefilling:
                    continue
                # grow: the position written this step needs its page
                p = slot.length // cfg.page_size
                if self._table[i, p] == SCRATCH_PAGE:
                    try:
                        (pg,) = self._alloc_pages(1)
                    except OutOfPages:
                        finishes.append(self._retire_locked(
                            i, "truncated", error="kv page pool exhausted"))
                        continue
                    self._table[i, p] = pg
                    slot.pages.append(pg)
                    self._note_pool_peak()
                ids[i] = slot.last_token
                lengths[i] = slot.length
                seeds[i] = slot.request.seed
                tok_idx[i] = slot.generated
                temps[i] = slot.request.temperature
                live.append(i)
            table = self._table.copy()
        for fin in finishes:       # final-frame callbacks OUTSIDE the lock
            self._finish_cb(*fin)
        if not live:
            return
        if rows is None:
            # rows that are not live (empty, prefilling) write to scratch
            for i in set(range(b)) - set(live):
                table[i, :] = SCRATCH_PAGE
            sel = list(range(b))
        else:
            sel = live
        self.decode_shapes.add((len(sel), cfg.pages_per_slot, cfg.page_size))
        t0 = time.monotonic()
        next_ids, _logits, self.cache = self.model.decode_step(
            self.cache, ids[sel], lengths[sel], table[sel], seeds[sel],
            tok_idx[sel], temps[sel], page_size=cfg.page_size,
            top_k=self.top_k)
        next_ids = dict(zip(sel, next_ids.cpu().tolist()))
        self.step_ema.observe(time.monotonic() - t0)
        self.steps += 1
        self._occupied_slot_steps += len(live)
        _GEN_STEPS.inc()
        _mw.sample("serving.decode", self._witness_tensors)
        for i in live:
            with self._lock:
                slot = self._slots[i]
            if slot is None:
                continue
            tok = int(next_ids[i])
            slot.length += 1           # last_token is now cached
            slot.last_token = tok
            slot.generated += 1
            slot.history.append(tok)
            self._decode_tokens += 1
            self._emit(slot, [tok])
            self._maybe_finish(i)

    def _step_spec(self):
        """One speculative verify step: draft k-1 tokens per slot, score all
        k positions in ONE dispatch (K2 at q_len k), and advance each slot
        by its accepted run plus the target's correction or bonus token.

        Slots that cannot take a whole verify step — within k of the cache
        cap, or unable to claim the k-page lookahead from a dry pool — take
        a single-token step instead (:meth:`_step_plain` over just those
        rows), so speculation never changes what a stream emits: not its
        tokens and not its truncation point."""
        cfg = self.cfg
        b = self.n_slots
        k = self.spec_k
        ids = np.zeros((b, k), np.int32)
        lengths = np.zeros(b, np.int32)
        seeds = np.zeros(b, np.int64)
        tok_idx = np.zeros(b, np.int64)
        temps = np.zeros(b, np.float32)
        finishes = []
        tail: List[int] = []
        spec_rows: List[int] = []
        with self._lock:
            for i, slot in enumerate(self._slots):
                if slot is None:
                    continue
                if slot.request.cancelled:
                    finishes.append(self._retire_locked(i, "cancelled"))
                    continue
                if slot.prefilling:
                    continue
                if slot.length + k > cfg.max_seq_len:
                    tail.append(i)      # fewer than k positions remain
                    continue
                # the step writes positions length .. length+k-1: claim
                # every page they span. A dry pool mid-lookahead is not a
                # truncation (plain decode would need only the first page):
                # the slot takes the single-token path this pass, keeping
                # the pages it claimed for later positions
                dry = False
                for p in range(slot.length // cfg.page_size,
                               (slot.length + k - 1) // cfg.page_size + 1):
                    if self._table[i, p] != SCRATCH_PAGE:
                        continue
                    try:
                        (pg,) = self._alloc_pages(1)
                    except OutOfPages:
                        dry = True
                        break
                    self._table[i, p] = pg
                    slot.pages.append(pg)
                    self._note_pool_peak()
                if dry:
                    tail.append(i)
                    continue
                drafts = slot.pending_drafts
                if drafts is None or len(drafts) != k - 1:
                    drafts = propose_kgram(slot.history, k - 1,
                                           self.spec_ngram)
                    slot.pending_drafts = drafts
                ids[i, 0] = slot.last_token
                ids[i, 1:] = drafts
                lengths[i] = slot.length
                seeds[i] = slot.request.seed
                tok_idx[i] = slot.generated
                temps[i] = slot.request.temperature
                spec_rows.append(i)
            table = self._table.copy()
        for i in set(range(b)) - set(spec_rows):
            # rows outside the verify write to scratch: never past a tail
            # row's table, never into a half-prefilled prompt
            table[i, :] = SCRATCH_PAGE
        for fin in finishes:       # final-frame callbacks OUTSIDE the lock
            self._finish_cb(*fin)
        if spec_rows:
            self._verify(spec_rows, ids, lengths, table, seeds, tok_idx,
                         temps)
        if tail:
            self._step_plain(rows=tail)

    def _verify(self, spec_rows, ids, lengths, table, seeds, tok_idx, temps):
        cfg = self.cfg
        k = self.spec_k
        self.decode_shapes.add((self.n_slots, cfg.pages_per_slot,
                                cfg.page_size, k))
        t0 = time.monotonic()
        accepted, tokens, draft_probs, self.cache = self.model.verify_step(
            self.cache, ids, lengths, table, seeds, tok_idx, temps,
            page_size=cfg.page_size, top_k=self.top_k)
        accepted = accepted.cpu().numpy()
        tokens = tokens.cpu().numpy()
        draft_probs = draft_probs.float().cpu().numpy()
        self.step_ema.observe(time.monotonic() - t0)
        self.steps += 1
        self.spec_steps += 1
        self._occupied_slot_steps += len(spec_rows)
        _GEN_STEPS.inc()
        _GEN_SPEC_STEPS.inc()
        _mw.sample("serving.decode", self._witness_tensors)
        for i in spec_rows:
            with self._lock:
                slot = self._slots[i]
            if slot is None:
                continue
            req = slot.request
            a = int(accepted[i])
            # the confirmed run + the correction/bonus, clipped at eos and
            # the budget (a clip also satisfies _maybe_finish)
            emit: List[int] = []
            for tok in (int(tokens[i, j]) for j in range(a + 1)):
                emit.append(tok)
                if req.eos_id is not None and tok == req.eos_id:
                    break
                if slot.generated + len(emit) >= req.max_new_tokens:
                    break
            slot.length += a + 1       # certain token + accepted drafts
            slot.last_token = emit[-1]
            slot.generated += len(emit)
            slot.history.extend(emit)
            slot.pending_drafts = None
            self._decode_tokens += len(emit)
            self.spec_drafted += k - 1
            self.spec_accepted += a
            _GEN_SPEC_TOKENS.labels(kind="drafted").inc(k - 1)
            _GEN_SPEC_TOKENS.labels(kind="accepted").inc(a)
            for j in range(min(a + 1, k - 1)):
                _GEN_SPEC_ACCEPT_PROB.observe(float(draft_probs[i, j]))
            self._emit(slot, emit)
            self._maybe_finish(i)
            with self._lock:
                slot = self._slots[i]
            if slot is not None:
                # draft the next proposals now, while the history is hot
                slot.pending_drafts = propose_kgram(
                    slot.history, k - 1, self.spec_ngram)

    def _emit(self, slot: _Slot, tokens: List[int]):
        now = time.perf_counter()
        req = slot.request
        meta: Dict[str, Any] = {"uri": req.uri}
        if req.last_emit_t is not None:
            _GEN_ITL.observe(now - req.last_emit_t)
        else:
            # first token of the stream: TTFT (submit -> first emit), the
            # chunks its prefill took and its admission -> first-token wait
            _GEN_TTFT.labels(priority=req.priority).observe(
                now - req.submitted_t)
            meta["ttft_s"] = round(now - req.submitted_t, 6)
            meta["chunks"] = slot.chunks
            meta["prefill_wait_ms"] = round((now - slot.admitted_t) * 1e3, 3)
        req.last_emit_t = now
        self.tokens_generated += len(tokens)
        _GEN_TOKENS.labels(phase="decode").inc(len(tokens))
        cb = req.on_chunk
        if cb is not None:
            try:
                cb(tokens, False, meta)
            except Exception:   # a consumer bug must not poison the loop
                logger.exception("token-chunk callback failed for %s",
                                 req.uri)

    def _maybe_finish(self, slot_idx: int):
        fin = None
        with self._lock:
            slot = self._slots[slot_idx]
            if slot is None:
                return
            req = slot.request
            done = (req.cancelled
                    or slot.generated >= req.max_new_tokens
                    or (req.eos_id is not None
                        and slot.last_token == req.eos_id)
                    or slot.length + 1 > self.cfg.max_seq_len)
            if done:
                outcome = ("cancelled" if req.cancelled else
                           "truncated"
                           if (slot.generated < req.max_new_tokens
                               and (req.eos_id is None
                                    or slot.last_token != req.eos_id))
                           else "ok")
                fin = self._retire_locked(slot_idx, outcome)
        if fin is not None:
            self._finish_cb(*fin)

    def _retire_locked(self, slot_idx: int, outcome: str,
                       error: Optional[str] = None):
        """Release the slot's page references (a shared prefix page just
        drops this stream's) and its prefix-cache marks. Caller holds
        ``_lock`` and MUST invoke ``_finish_cb(*returned)`` after releasing
        it."""
        slot = self._slots[slot_idx]
        self._slots[slot_idx] = None
        self._table[slot_idx, :] = SCRATCH_PAGE
        self._release_claim(slot.prefix_keys, slot.pages)
        slot.pages = []
        slot.prefix_keys = []
        return (slot.request, [], outcome, error, slot.generated)

    def _finish_cb(self, req: _Request, tokens: List[int], outcome: str,
                   error: Optional[str] = None, n_tokens: int = 0,
                   retry_after_s: Optional[float] = None):
        self.requests_finished[outcome] = \
            self.requests_finished.get(outcome, 0) + 1
        _GEN_REQS.labels(outcome=outcome).inc()
        meta = {"uri": req.uri, "outcome": outcome, "n_tokens": n_tokens}
        if error:
            meta["error"] = error
        if retry_after_s is not None:
            # shed outcomes: the computed backoff rides the final frame
            meta["retry_after_s"] = round(retry_after_s, 4)
        if req.on_chunk is not None:
            try:
                req.on_chunk(tokens, True, meta)
            except Exception:   # a consumer bug must not poison the loop
                logger.exception("final-frame callback failed for %s",
                                 req.uri)

    # ------------------------------------------------------------- hot swap

    def swap_params(self, params, version: Optional[str] = None,
                    spec=None) -> None:
        """Stage an atomic (target params, draft schedule) flip: ``params``
        (the port's own tree, ``{dotted name: tensor}`` as
        :meth:`host_params` gives it, or a JAX-layout tree of numpy arrays)
        and ``spec`` (a :class:`~analytics_zoo_tpu_torch.ops.speculative.
        SpecDecodeConfig` or its dict form) land as ONE pair between decode
        steps, so no step verifies new-model drafts with old weights or
        the other way round. In-flight streams continue: their pending
        drafts are dropped (the k-gram history survives), the prefix
        cache's index is invalidated (its K/V came from the old weights),
        and the sampler's per-stream seeds are untouched.

        The new tensors are staged here, on the caller's thread: on the
        card, copied on a side stream whose event the serving stream waits
        on before the first step under them. The flip on the loop thread
        then swaps each parameter's reference (``param.data``) and copies
        nothing; the old tensors die with the last step that reads them."""
        if spec is not None:
            if isinstance(spec, dict):
                spec = SpecDecodeConfig(**spec)
            elif not isinstance(spec, SpecDecodeConfig):
                raise TypeError(f"spec must be a SpecDecodeConfig or dict, "
                                f"got {type(spec).__name__}")
        names = dict(self.model.named_parameters())
        staged, ready = stage_tensors(_flat_params(params, names),
                                      self.device)
        self._pending_swap = (staged, ready, version, spec)
        self._wake.set()

    def _apply_pending_swap(self):
        """Land a staged (params, spec schedule) pair between decode steps:
        the loop thread is the only dispatcher, so no step ever sees a
        mixed pair."""
        pend = self._pending_swap
        if pend is None:
            return
        self._pending_swap = None
        staged, ready, version, spec = pend
        land_tensors(staged, ready, self.device)
        for n, p in self.model.named_parameters():
            p.data = staged[n]
        self.version = version
        if spec is not None:
            self.spec_k = 0 if spec.k == 1 else int(spec.k)
            self.spec_ngram = int(spec.max_ngram)
        with self._lock:
            parked = list(self._preempted)
            live = [s for s in self._slots if s is not None]
        for slot in live + parked:
            # drafts proposed under the OLD target die with it; the k-gram
            # corpus (history) is model-independent and survives
            slot.pending_drafts = None
        if self.prefix_cache is not None:
            # published K/V was computed under the OLD weights: one
            # invalidate between steps. In-flight warm streams keep their
            # own page references; only the index dies
            dropped = self.prefix_cache.invalidate()
            if dropped:
                _events.emit("gen.prefix.invalidated", severity="info",
                             reason="hot_swap", pages=dropped,
                             version=str(version))
        self.swaps += 1
        _GEN_SWAPS.inc()
        logger.info("generation batcher swapped to version=%s spec_k=%d",
                    version, self.spec_k)

    def host_params(self) -> Dict[str, torch.Tensor]:
        """The served params as host tensors, ``{dotted name: tensor}`` (a
        state dict: ``swap_params`` takes it back, and
        ``bridge.nest`` of its numpy views gives the JAX tree)."""
        return {n: p.detach().to("cpu", copy=True)
                for n, p in self.model.named_parameters()}

    # ------------------------------------------------------------- diagnostics

    # ------------------------------------------------------------- diagnostics

    def _witness_tensors(self):
        """What the decode step holds on the device: the weights and the
        page pool (the memory witness's CPU reading)."""
        return [self.cache, list(self.model.parameters())]

    def check_decode_stability(self, mode: str = "warn",
                               hbm_budget_bytes: Optional[int] = None):
        """Run the decode graph checks over the recorded decode step (the
        verify step at ``spec_k``; also the prefill chunk at
        ``prefill_chunk_tokens``; nothing runs, no kernel launches):
        ``decode-shape-stability`` (the cache comes back in place, no host
        reads, no per-step growth), ``cache-alias`` (no pool-sized
        allocation in the step) and, under a budget, ``hbm-budget`` over
        the static peak, which is also noted into the memory witness
        (site ``serving.decode``). Returns the findings."""
        import logging as _logging

        from ..analysis import enforce
        from ..analysis.rules.decode import lint_decode_stability

        budget = (hbm_budget_bytes if hbm_budget_bytes is not None
                  else self.hbm_budget_bytes)
        findings = lint_decode_stability(
            self.model, self.cfg, self.cache, top_k=self.top_k,
            spec_k=self.spec_k, chunk_tokens=self.prefill_chunk_tokens,
            where="serving.generation", hbm_budget_bytes=budget,
            note_static_site="serving.decode")
        return enforce(findings, mode,
                       _logging.getLogger("analytics_zoo_tpu_torch.serving"))

    def decode_memory(self) -> Dict[str, Any]:
        """The memory picture of the decode step (the verify step at
        ``spec_k``): its buffer table (``alias_size_in_bytes`` is the page
        pool coming back in place), the pool's bytes and the static peak
        of the recorded step."""
        from ..analysis.memory import memory_fields, profile_trace
        from ..analysis.rules.decode import trace_decode

        trace = trace_decode(self.model, self.cfg, self.cache,
                             top_k=self.top_k, spec_k=self.spec_k)
        prof = profile_trace(trace)
        return {"compiled": memory_fields(trace),
                "cache_bytes": int(sum(t.numel() * t.element_size()
                                       for t in self.cache.values())),
                "static_peak_bytes": prof.peak_live_bytes,
                "resident_bytes": prof.resident_bytes,
                "aliased_bytes": prof.aliased_out_bytes,
                "kernel_sites": trace.kernel_counts()}

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            active = sum(s is not None for s in self._slots)
            prefilling = sum(s is not None and s.prefilling
                             for s in self._slots)
            preempted = len(self._preempted)
        out = {
            "slots": self.n_slots,
            "active_slots": active,
            "prefilling": prefilling,
            "preempted_parked": preempted,
            "backlog": len(self._backlog) + self._pending.qsize(),
            "step_ema_s": round(self.step_ema.value(), 6),
            "free_pages": self.pool.free_count(),
            "page_capacity": self.pool.capacity,
            "peak_pages_in_use": self.peak_pages_in_use,
            "steps": self.steps,
            "tokens_generated": self.tokens_generated,
            "requests": dict(self.requests_finished),
            "loop_respawns": self.loop_respawns,
            "prefill_buckets": sorted(self.prefill_buckets),
            "distinct_decode_shapes": len(self.decode_shapes),
            "slot_occupancy": round(
                self._occupied_slot_steps / (self.steps * self.n_slots), 4)
            if self.steps else 0.0,
            # decode tokens per occupied slot-step: 1.0 for plain decode,
            # ~1 + acceptance * (k-1) for speculative decode
            "tokens_per_slot_step": round(
                self._decode_tokens / self._occupied_slot_steps, 4)
            if self._occupied_slot_steps else 0.0,
            # model dispatches by kind: each runs K2 (decode, verify, chunk,
            # prefill_from) or K1 (prefill) once a layer
            "dispatches": {"decode": self.steps - self.spec_steps,
                           "verify": self.spec_steps,
                           "chunk": self.prefill_chunks_total,
                           "prefill_from": self.prefills_from,
                           "prefill": self.prefills_whole},
            "model_version": self.version,
            "swaps": self.swaps,
            "preemptions": self.preemptions,
        }
        if self.prefix_cache is not None:
            out["prefix"] = dict(self.prefix_cache.stats(),
                                 tokens_saved=self.prefix_tokens_saved,
                                 shared_pages=self.pool.shared_count())
        if self.prefill_chunk_tokens:
            out["prefill"] = {
                "chunk_tokens": self.prefill_chunk_tokens,
                "chunks": self.prefill_chunks_total,
                "distinct_chunk_shapes": len(self.chunk_shapes),
                "chunk_ema_s": round(self.chunk_ema.value(), 6),
                "budget": (dict(self._last_budget)
                           if self._last_budget else None),
            }
        if self.spec_k >= 2 or self.spec_steps:
            out["spec"] = {
                "k": self.spec_k,
                "ngram": self.spec_ngram,
                "steps": self.spec_steps,
                "drafted": self.spec_drafted,
                "accepted": self.spec_accepted,
                "acceptance_rate": round(
                    self.spec_accepted / self.spec_drafted, 4)
                if self.spec_drafted else 0.0,
                "tokens_per_step": round(
                    self.tokens_generated / self.steps, 3)
                if self.steps else 0.0,
            }
        return out


# ---------------------------------------------------------------------------
# broker-facing engine + client
# ---------------------------------------------------------------------------

def _itl_objective_target_s(cfg) -> Optional[float]:
    """The declared inter-token-latency objective's threshold (seconds), if
    any: a latency-type SLO objective whose name mentions ``itl`` arms the
    SLO-derived prefill budget (``qos.prefill_budget_from_slo``)."""
    for obj in getattr(cfg, "slo_objectives", ()) or ():
        if (str(obj.get("type", "")).lower() == "latency"
                and "itl" in str(obj.get("name", "")).lower()):
            return float(obj.get("threshold_ms", 1000.0)) / 1e3
    return None


class GenerationEngine:
    """Streaming generation job over the broker fabric.

    Consumes request payloads from ``generation_stream`` and streams token
    deltas as frame-per-chunk entries on ``genout:<uri>``:

        {"sid": uri, "seq": n, "tokens": int32[...], "final": false}
        ...
        {"sid": uri, "seq": n, "tokens": [], "final": true,
         "outcome": "ok"|"error"|"cancelled"|"truncated", "n_tokens": N}

    Chunk writes ride a sink thread so the decode loop never blocks on a
    broker RTT; a request is XACKed only after its final frame is durably in
    the broker (at-least-once, like the one-shot engine).

    ``model``: a :class:`ContinuousBatcher` (served as it is) or a
    ``TransformerLM``, for which the engine builds one on ``device`` (CUDA
    unless the caller names another; it raises without CUDA) with the
    config's ``gen_*`` fields, as the JAX engine maps them. ``params``: an
    optional JAX-layout tree (numpy leaves) loaded into the model first
    through the bridge. ``stream``: a routed per-replica dispatch stream
    (fleet mode) in place of the shared ``generation_stream``.
    """

    def __init__(self, model, params=None,
                 config: Optional[ServingConfig] = None,
                 group: str = "generation",
                 registry: Optional[HealthRegistry] = None,
                 stream: Optional[str] = None, *,
                 device=None):
        self.config = config or ServingConfig()
        self.group = group
        # fleet mode: a replica consumes its own routed dispatch stream
        # (serving/fleet.py ReplicaRouter) instead of the shared one; the
        # per-request genout:* reply streams are unaffected by routing
        self._routed = stream is not None
        self.stream = stream or GEN_STREAM
        self.registry = registry if registry is not None else HealthRegistry(
            default_timeout_s=self.config.heartbeat_timeout_s)
        cfg = self.config
        if isinstance(model, ContinuousBatcher):
            self.batcher = model
        else:
            if params is not None:
                model.load_state_dict(params_from_jax(params,
                                                      device=model.device))
            self.batcher = ContinuousBatcher(
                model, n_slots=cfg.gen_slots,
                page_size=cfg.gen_page_size, max_seq_len=cfg.gen_max_seq_len,
                n_pages=cfg.gen_pages or None, top_k=cfg.gen_top_k,
                spec_k=getattr(cfg, "gen_spec_k", 0),
                spec_ngram=getattr(cfg, "gen_spec_ngram", 3),
                prefix_cache_pages=getattr(cfg, "gen_prefix_cache_pages", 0),
                prefix_block_tokens=getattr(cfg, "gen_prefix_block_tokens",
                                            0),
                prefill_chunk_tokens=getattr(cfg, "gen_prefill_chunk_tokens",
                                             0),
                prefill_token_budget=getattr(cfg,
                                             "gen_prefill_token_budget", 0),
                prefill_slo_itl_s=_itl_objective_target_s(cfg),
                hbm_budget_bytes=int(cfg.hbm_budget_mb * 2 ** 20)
                if cfg.hbm_budget_mb else None,
                device=device, autostart=False)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._sink_q: "queue.Queue" = queue.Queue(maxsize=1024)
        self.served_streams = 0
        # the findings of the start-up decode check (graph_checks)
        self.graph_findings: list = []

    def _connect(self, tag: str) -> _Conn:
        policy = RetryPolicy(max_attempts=None, base_delay_s=0.05,
                             max_delay_s=0.5, attempt_timeout_s=5.0,
                             retryable=(ConnectionError, OSError))
        return _Conn(self.config.queue_host, self.config.queue_port,
                     policy=policy, abort=self._stop.is_set, tag=tag)

    def _warm(self):
        """Startup decode-graph check (``ServingConfig.graph_checks``): the
        recorded decode step must be shape-stable, free of host reads and
        write its pool in place (plus ``hbm-budget`` under a declared
        ``hbm_budget_mb``) BEFORE the engine takes traffic. In "warn" mode
        a check that fails to run is logged and the engine serves."""
        checks = getattr(self.config, "graph_checks", "warn")
        if not checks or checks == "off":
            return
        try:
            self.graph_findings = self.batcher.check_decode_stability(checks)
        except Exception:
            if checks == "raise":
                raise
            logger.exception("decode-shape-stability check failed; "
                             "serving anyway (graph_checks=warn)")

    def start(self) -> "GenerationEngine":
        self._stop.clear()
        self._warm()
        self.batcher.start()
        conn = self._connect("gen.control")
        try:
            # shared stream: tail semantics (see ClusterServing.start). A
            # routed per-replica stream is private to this engine and the
            # router may have forwarded before this call lands — replay
            # from '0' so nothing dispatched early is skipped
            conn.call("XGROUPCREATE", self.stream, self.group,
                      "0" if self._routed else "$")
        except RetryAbortedError:
            pass
        finally:
            conn.close()
        for name, fn in (("source", self._source_loop),
                         ("sink", self._sink_loop)):
            t = threading.Thread(target=fn, daemon=True,
                                 name=f"zoo-gen-{name}")
            t.start()
            self._threads.append(t)
        return self

    def _source_loop(self):
        conn = self._connect("gen.source")
        hb = self.registry.register("serving.gen.source")
        stats_pub = 0.0
        try:
            while not self._stop.is_set():
                hb.beat()
                now = time.time()
                if now - stats_pub >= 1.0:
                    stats_pub = now
                    try:
                        conn.call("HSET", GEN_STATS_PREFIX + self.group,
                                  dict(self.stats(), ts=now))
                    except RetryAbortedError:
                        break
                try:
                    entries = conn.call("XREADGROUP", self.stream, self.group,
                                        8, 200)
                except RetryAbortedError:
                    break
                for entry_id, payload in entries or ():
                    self._admit_entry(entry_id, payload)
        finally:
            hb.stop()
            conn.close()

    def _admit_entry(self, entry_id: str, payload: Any):
        ctx = payload_trace(payload)
        # resolve the reply stream FIRST: a payload with a good uri but a
        # bad field (max_new_tokens="abc") must get its error frame on the
        # stream the client is actually polling
        uri = (payload.get("uri") if isinstance(payload, dict) else None) \
            or str(payload)[:64]
        if isinstance(payload, dict) and payload.get("cancel"):
            # client-sent cancel frame: stop decoding for an abandoned
            # stream (the stream's own final frame reports "cancelled");
            # the cancel entry itself just needs acking
            self.batcher.cancel_uri(uri)
            self._sink_q.put(("ack", entry_id, uri, 0, [], {}, False, None))
            return
        try:
            prompt = np.asarray(payload["prompt"], np.int32).reshape(-1)
            kw = dict(
                max_new_tokens=int(payload.get("max_new_tokens", 32)),
                temperature=float(payload.get("temperature", 0.0)),
                seed=int(payload.get("seed", 0)),
                eos_id=(int(payload["eos_id"])
                        if payload.get("eos_id") is not None else None),
                # overload QoS rides the payload (durable across AOF replay
                # and failover requeue); absent from old clients
                priority=payload_priority(payload),
                deadline=payload_deadline(payload))
        except Exception as e:
            logger.exception("malformed generation request %s", entry_id)
            self._sink_q.put(("chunk", entry_id, uri, 0, [],
                              {"outcome": "error",
                               "error": f"malformed request: {e}"}, True,
                              ctx))
            return
        seq_counter = [0]
        t0 = time.perf_counter()

        def on_chunk(tokens, final, meta, _uri=uri, _eid=entry_id, _ctx=ctx):
            seq = seq_counter[0]
            seq_counter[0] += 1
            if final:
                meta = dict(meta)
                meta.setdefault("outcome", "ok")
                _tm.record_span("serving.gen.stream", t0, time.perf_counter(),
                                remote=_ctx, uri=_uri,
                                n_tokens=meta.get("n_tokens", 0))
            self._sink_q.put(("chunk", _eid, _uri, seq, list(tokens),
                              meta if final else {}, final, _ctx))

        try:
            self.batcher.submit(prompt, uri=uri, on_chunk=on_chunk,
                                ctx=ctx, **kw)
        except Exception as e:   # invalid prompt (too long, empty)
            self._sink_q.put(("chunk", entry_id, uri, 0, [],
                              {"outcome": "error", "error": str(e)}, True,
                              ctx))

    def _sink_loop(self):
        conn = self._connect("gen.sink")
        hb = self.registry.register("serving.gen.sink")
        try:
            while True:
                hb.beat()
                try:
                    item = self._sink_q.get(timeout=0.1)
                except queue.Empty:
                    if self._stop.is_set():
                        break
                    continue
                kind, entry_id, uri, seq, tokens, meta, final, ctx = item
                try:
                    if kind == "ack":   # cancel frames carry no reply
                        conn.call("XACK", self.stream, self.group, [entry_id])
                        continue
                    frame = {"sid": uri, "seq": seq,
                             "tokens": np.asarray(tokens, np.int32),
                             "final": bool(final)}
                    if final:
                        frame.update({k: v for k, v in meta.items()
                                      if k in ("outcome", "error",
                                               "n_tokens",
                                               "retry_after_s")})
                    if ctx is not None:
                        frame[TRACE_KEY] = ctx
                    conn.call("XADD", GEN_OUT_PREFIX + uri, frame)
                    if final:
                        conn.call("XACK", self.stream, self.group, [entry_id])
                        self.served_streams += 1
                except RetryAbortedError:
                    break
        finally:
            hb.stop()
            conn.close()

    def stats(self) -> Dict[str, Any]:
        """The batcher's stats plus the engine's: ``itl_target_s`` is the
        ITL objective's threshold the prefill budget is derived from
        (``None`` when the config declares none)."""
        out = {"served_streams": self.served_streams,
               "graph_checks": getattr(self.config, "graph_checks", "warn"),
               "graph_findings": len(self.graph_findings),
               "itl_target_s": self.batcher.prefill_slo_itl_s}
        out.update(self.batcher.stats())
        return out

    def stop(self, drain_s: float = 1.0):
        deadline = time.time() + drain_s
        while time.time() < deadline and (self.batcher.active_slots()
                                          or not self._sink_q.empty()):
            time.sleep(0.01)
        # close the batcher BEFORE signalling stop: closing fails whatever is
        # still pending/active, and those final error frames must land on
        # _sink_q while the sink loop is still guaranteed to drain it (the
        # sink only exits on stop-AND-empty)
        self.batcher.close()
        drain2 = time.time() + drain_s
        while time.time() < drain2 and not self._sink_q.empty():
            time.sleep(0.01)
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads.clear()


class GenerationClient:
    """Producer/consumer for broker-backed generation streams."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6380,
                 policy: Optional[RetryPolicy] = None):
        self._conn = _Conn(host, port,
                           policy=policy or default_conn_policy(),
                           tag="client.gen")

    def submit(self, prompt, max_new_tokens: int = 32,
               temperature: float = 0.0, seed: int = 0,
               eos_id: Optional[int] = None,
               uri: Optional[str] = None,
               priority: Optional[str] = None,
               deadline_ms: Optional[float] = None,
               deadline: Optional[float] = None) -> str:
        """Enqueue one generation request; returns its stream id.
        ``priority``/``deadline_ms`` (or absolute ``deadline``) arm
        (priority, deadline)-ordered admission and deadline shedding at the
        decode tier — a shed stream's final frame reports outcome ``shed``
        with a computed ``retry_after_s``."""
        uri = uri or uuid.uuid4().hex
        dl = _qos.normalize_deadline(deadline)
        if dl is None:
            dl = _qos.deadline_from_ms(deadline_ms)
        with _tm.span("serving.gen.send", uri=uri) as sp:
            payload = {"uri": uri, TRACE_KEY: sp.wire_context(),
                       "prompt": np.asarray(prompt, np.int32).reshape(-1),
                       "max_new_tokens": int(max_new_tokens),
                       "temperature": float(temperature), "seed": int(seed),
                       "eos_id": int(eos_id) if eos_id is not None else None}
            if priority is not None:
                payload[PRIORITY_KEY] = _qos.normalize_priority(priority)
            if dl is not None:
                payload[DEADLINE_KEY] = dl
            self._conn.call("XADD", GEN_STREAM, payload)
        return uri

    def cancel(self, uri: str) -> None:
        """Ask the engine to stop decoding ``uri`` (abandoned stream): the
        request's own final frame will report outcome ``cancelled``."""
        self._conn.call("XADD", GEN_STREAM, {"uri": uri, "cancel": True})

    def stream(self, uri: str, timeout_s: float = 60.0):
        """Yield token chunks (int32 ndarrays) for ``uri`` until the final
        frame; raises on an errored stream. Frame-per-chunk over the binary
        wire protocol; chunks reassemble in ``seq`` order (the broker stream
        is ordered). The per-request broker stream is deleted after its
        terminal frame is consumed (the streaming twin of OutputQueue's
        HDEL-after-query), so finished streams don't accumulate broker
        state."""
        cursor = 0
        deadline = time.monotonic() + timeout_s
        stream_key = GEN_OUT_PREFIX + uri
        while True:
            block = max(1, min(500, int((deadline - time.monotonic()) * 1e3)))
            cursor, entries = self._conn.call("XREAD", stream_key, cursor,
                                              64, block)
            for _id, frame in entries:
                toks = np.asarray(frame.get("tokens", ()), np.int32)
                if toks.size:
                    yield toks
                if frame.get("final"):
                    try:
                        self._conn.call("XDELSTREAM", stream_key)
                    except Exception:   # cleanup is best-effort
                        pass
                    if frame.get("outcome") == "shed":
                        raise _qos.ShedError(
                            f"generation request {uri!r} shed: "
                            f"{frame.get('error', 'overloaded')}",
                            retry_after_s=float(
                                frame.get("retry_after_s", 1.0)),
                            reason="deadline")
                    if frame.get("error") or frame.get("outcome") == "error":
                        raise RuntimeError(
                            f"generation failed for {uri!r}: "
                            f"{frame.get('error', 'unknown error')}")
                    return
            if time.monotonic() >= deadline:
                raise TimeoutError(f"no final frame for {uri!r} within "
                                   f"{timeout_s}s")

    def generate(self, prompt, timeout_s: float = 60.0, **kw) -> List[int]:
        uri = self.submit(prompt, **kw)
        out: List[int] = []
        for chunk in self.stream(uri, timeout_s=timeout_s):
            out.extend(chunk.tolist())
        return out

    def close(self):
        self._conn.close()


__all__ = ["ContinuousBatcher", "GenerationClient", "GenerationEngine",
           "GEN_OUT_PREFIX", "GEN_STATS_PREFIX", "GEN_STREAM",
           "StreamHandle"]
