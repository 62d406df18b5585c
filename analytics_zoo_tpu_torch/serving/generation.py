"""Autoregressive generation serving: continuous micro-batching + streaming
(port of the plain serving loop of ``analytics_zoo_tpu/serving/generation.py``).

:class:`ContinuousBatcher` runs ``n_slots`` concurrent decode sequences over
one paged KV cache. One daemon loop thread admits pending requests into free
slots in FIFO order (whole-prompt prefill into a power-of-two bucket), runs
one fixed-shape decode step over all slots, emits per-stream token deltas,
and retires finished sequences — all per step, so aggregate throughput
tracks active tokens instead of the slowest request of a batch.

Not ported yet, and raising ``NotImplementedError`` where a caller asks for
them (ROADMAP Queue 1): speculative decode (``spec_k``), the shared-prefix
cache (``prefix_cache_pages``), chunked prefill (``prefill_chunk_tokens``),
priorities, deadlines and preemption, ``swap_params``, the run-to-completion
``admit_policy="batch"`` baseline, telemetry and chaos hooks, and the
broker-facing ``GenerationEngine``/``GenerationClient``.
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..nn.module import resolve_device
from ..ops.kv_cache import OutOfPages, PagePool, SCRATCH_PAGE, sample_tokens

logger = logging.getLogger("analytics_zoo_tpu_torch.serving.generation")


def _unported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported to the PyTorch package "
                              f"yet (ROADMAP Queue 1: {item})")


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
                 "eos_id", "on_chunk", "submitted_t", "cancelled",
                 "last_emit_t")

    def __init__(self, uri, prompt, max_new_tokens, temperature, seed,
                 eos_id, on_chunk):
        self.uri = uri
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.seed = int(seed) & 0xFFFFFFFF
        self.eos_id = eos_id
        self.on_chunk = on_chunk
        self.submitted_t = time.perf_counter()
        self.cancelled = False
        self.last_emit_t: Optional[float] = None


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
        """Yield token-chunk lists until the final frame; raises on an
        errored stream."""
        for tokens, final, meta in self.frames(timeout_s=timeout_s):
            if tokens:
                yield tokens
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

    __slots__ = ("request", "length", "generated", "last_token", "pages")

    def __init__(self, request: _Request, length: int, last_token: int,
                 pages: List[int]):
        self.request = request
        self.length = length            # tokens already in the cache
        self.generated = 1              # prefill samples token 0
        self.last_token = last_token    # sampled, not yet cached
        self.pages = pages              # owned page ids (freed on retire)


class ContinuousBatcher:
    """Continuous micro-batching decode loop over a paged KV cache.

    ``model`` is a :class:`~analytics_zoo_tpu_torch.models.transformer.
    TransformerLM` (its own parameters are served). ``device`` must be the
    model's device; it defaults to CUDA and raises when CUDA is absent, as
    every entry point of the port does.
    """

    def __init__(self, model, *, n_slots: int = 8, page_size: int = 16,
                 max_seq_len: Optional[int] = None,
                 n_pages: Optional[int] = None, top_k: int = 0,
                 spec_k: int = 0, prefix_cache_pages: int = 0,
                 prefill_chunk_tokens: int = 0,
                 admit_policy: str = "continuous", device=None,
                 autostart: bool = True):
        if spec_k > 0:
            _unported("speculative decode (spec_k > 0)",
                      "speculative verify + chunked prefill")
        if prefix_cache_pages > 0:
            _unported("the shared-prefix KV cache (prefix_cache_pages > 0)",
                      "shared-prefix cache")
        if prefill_chunk_tokens > 0:
            _unported("chunked prefill (prefill_chunk_tokens > 0)",
                      "speculative verify + chunked prefill")
        if admit_policy != "continuous":
            _unported(f"admit_policy={admit_policy!r}", "serving remainder")
        if page_size & (page_size - 1):
            raise ValueError(f"page_size must be a power of two, got "
                             f"{page_size} (prefill buckets are pow2 and "
                             f"must tile by pages)")
        self.device = resolve_device(device)
        if not _same_device(torch.device(model.device), self.device):
            raise ValueError(f"model lives on {model.device}, batcher asked "
                             f"for {self.device}")
        self.model = model
        self.n_slots = int(n_slots)
        # clamp to the vocabulary: top-k with k > V has no meaning
        self.top_k = min(int(top_k), int(model.vocab))
        self.cfg, self.cache = model.init_kv_cache(
            n_slots, page_size=page_size, max_seq_len=max_seq_len,
            n_pages=n_pages)
        self.pool = PagePool(self.cfg)
        self.peak_pages_in_use = 0
        # host-side page tables (fixed shape), copied to the device per step
        self._table = np.full((self.n_slots, self.cfg.pages_per_slot),
                              SCRATCH_PAGE, np.int32)
        self._slots: List[Optional[_Slot]] = [None] * self.n_slots
        self._pending: "queue.Queue[_Request]" = queue.Queue()
        # FIFO staging between the submit queue and admission; owned by the
        # loop thread (a request the dry pool turned away waits at its head)
        self._backlog: "collections.deque[_Request]" = collections.deque()
        self._wake = threading.Event()
        self._stop = threading.Event()
        # guards _slots and _table against stats readers; final-frame
        # callbacks run outside it
        self._lock = threading.Lock()
        self.steps = 0
        self.tokens_generated = 0
        self.requests_finished: Dict[str, int] = {}
        self.prefill_buckets: set = set()
        self.decode_shapes: set = set()
        self._occupied_slot_steps = 0
        self._threads: List[threading.Thread] = []
        if autostart:
            self.start()

    # ------------------------------------------------------------------ control

    def start(self) -> "ContinuousBatcher":
        if any(t.is_alive() for t in self._threads):
            return self          # idempotent: already running
        self._stop.clear()
        t = threading.Thread(target=self._loop, daemon=True,
                             name="zoo-torch-gen-batcher")
        t.start()
        self._threads = [t]
        return self

    def close(self, timeout_s: float = 30.0):
        """Stop the loop thread, join it, and fail every request still
        queued or in flight."""
        self._stop.set()
        self._wake.set()
        for t in self._threads:
            t.join(timeout=timeout_s)
            if t.is_alive():
                raise RuntimeError(f"generation loop thread did not stop "
                                   f"within {timeout_s}s")
        self._threads = []
        self._drain_pending()
        backlog, self._backlog = list(self._backlog), collections.deque()
        for req in backlog:
            self._finish_cb(req, [], "error",
                            error="generator closed before admission")
        self._fail_all_active("generator closed mid-stream")

    def swap_params(self, *args, **kwargs):
        _unported("swap_params (hot swap)", "serving remainder")

    def cancel_uri(self, uri: str):
        _unported("cancel by stream id (the broker-facing cancel)",
                  "serving remainder; StreamHandle.cancel() works")

    # ------------------------------------------------------------------- client

    def submit(self, prompt, max_new_tokens: int = 32,
               temperature: float = 0.0, seed: int = 0,
               eos_id: Optional[int] = None, uri: Optional[str] = None,
               on_chunk: Optional[Callable] = None,
               priority: Optional[str] = None,
               deadline: Optional[float] = None) -> StreamHandle:
        """Enqueue one generation request; returns a :class:`StreamHandle`.
        ``on_chunk(tokens, final, meta)`` additionally mirrors every
        frame."""
        if priority is not None:
            _unported("request priorities and preemption",
                      "serving remainder")
        if deadline is not None:
            _unported("request deadlines", "serving remainder")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        limit = self.cfg.max_seq_len
        if prompt.size >= limit:
            raise ValueError(f"prompt of {prompt.size} tokens exceeds the "
                             f"cache's max_seq_len {limit}")
        req = _Request(uri or uuid.uuid4().hex, prompt, max_new_tokens,
                       temperature, seed, eos_id, on_chunk)
        handle = StreamHandle(req)

        def fanout(tokens, final, meta, _h=handle, _cb=on_chunk):
            _h._push(tokens, final, meta)
            if _cb is not None:
                _cb(tokens, final, meta)

        req.on_chunk = fanout
        self._pending.put(req)
        self._wake.set()
        return handle

    def generate(self, prompt, **kw) -> List[int]:
        """Blocking convenience: submit + drain the stream."""
        timeout_s = kw.pop("timeout_s", 120.0)
        return self.submit(prompt, **kw).result(timeout_s=timeout_s)

    # ------------------------------------------------------------------- loop

    def active_slots(self) -> int:
        with self._lock:
            return sum(s is not None for s in self._slots)

    def _loop(self):
        with torch.no_grad():
            while not self._stop.is_set():
                try:
                    self._admit()
                    if self.active_slots() == 0:
                        if self._pending.empty() and not self._backlog:
                            self._wake.wait(timeout=0.05)
                            self._wake.clear()
                        continue
                    self._step_plain()
                except Exception as e:
                    # a failing step fails the in-flight streams instead of
                    # killing the loop
                    logger.exception("decode step failed; failing the "
                                     "active streams")
                    self._fail_all_active(f"decode step failed: {e}")

    def _fail_all_active(self, error: str):
        with self._lock:
            finishes = [self._retire_locked(i, "error", error=error)
                        for i, s in enumerate(self._slots) if s is not None]
        for fin in finishes:
            self._finish_cb(*fin)

    # admission ---------------------------------------------------------------

    def _drain_pending(self) -> None:
        while True:
            try:
                self._backlog.append(self._pending.get_nowait())
            except queue.Empty:
                return

    def _admit(self):
        self._drain_pending()
        while not self._stop.is_set() and self._backlog:
            if not any(s is None for s in self._slots):
                return
            req = self._backlog.popleft()
            if req.cancelled:
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
                # pool temporarily dry: wait at the head for retirements
                self._backlog.appendleft(req)
                return
            except Exception as e:   # a bad request must not kill the loop
                logger.exception("prefill failed for %s", req.uri)
                self._finish_cb(req, [], "error", error=str(e))

    def _note_pool_peak(self) -> None:
        used = self.pool.capacity - self.pool.free_count()
        if used > self.peak_pages_in_use:
            self.peak_pages_in_use = used

    def _prefill_into_slot(self, req: _Request):
        slot_idx = self._slots.index(None)
        cfg = self.cfg
        n_prompt = int(req.prompt.size)
        n_pg = -(-n_prompt // cfg.page_size)
        row = self.pool.alloc(n_pg)
        try:
            self._note_pool_peak()
            bucket = min(max(_next_pow2(n_prompt), cfg.page_size),
                         cfg.max_seq_len)
            if bucket % cfg.page_size:
                bucket = -(-bucket // cfg.page_size) * cfg.page_size
            ids = np.zeros((1, bucket), np.int32)
            ids[0, :n_prompt] = req.prompt
            table = np.full((1, cfg.pages_per_slot), SCRATCH_PAGE, np.int32)
            table[0, :n_pg] = row
            logits, self.cache = self.model.prefill(
                self.cache, ids, np.array([n_prompt], np.int32), table,
                page_size=cfg.page_size)
            first = sample_tokens(logits, [req.seed], [0], [req.temperature],
                                  top_k=self.top_k)
            tok = int(first[0])
        except BaseException:
            # a failed prefill hands back every page it took
            self.pool.release(row)
            raise
        self.prefill_buckets.add(bucket)
        slot = _Slot(req, n_prompt, tok, list(row))
        with self._lock:
            self._table[slot_idx, :] = SCRATCH_PAGE
            self._table[slot_idx, :n_pg] = row
            self._slots[slot_idx] = slot
        self._emit(slot, [tok])
        self._maybe_finish(slot_idx)

    # decode ------------------------------------------------------------------

    def _step_plain(self):
        """One single-token decode dispatch over every occupied slot."""
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
            for i in range(b):
                slot = self._slots[i]
                if slot is None:
                    continue
                if slot.request.cancelled:
                    finishes.append(self._retire_locked(i, "cancelled"))
                    continue
                # grow: the position written this step needs its page
                p = slot.length // cfg.page_size
                if self._table[i, p] == SCRATCH_PAGE:
                    try:
                        (pg,) = self.pool.alloc(1)
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
        self.decode_shapes.add((b, cfg.pages_per_slot, cfg.page_size))
        next_ids, _logits, self.cache = self.model.decode_step(
            self.cache, ids, lengths, table, seeds, tok_idx, temps,
            page_size=cfg.page_size, top_k=self.top_k)
        next_ids = next_ids.cpu().numpy()
        self.steps += 1
        self._occupied_slot_steps += len(live)
        for i in live:
            with self._lock:
                slot = self._slots[i]
            if slot is None:
                continue
            tok = int(next_ids[i])
            slot.length += 1           # last_token is now cached
            slot.last_token = tok
            slot.generated += 1
            self._emit(slot, [tok])
            self._maybe_finish(i)

    def _emit(self, slot: _Slot, tokens: List[int]):
        now = time.perf_counter()
        req = slot.request
        meta: Dict[str, Any] = {"uri": req.uri}
        if req.last_emit_t is None:
            # first token of the stream: TTFT (submit -> first emit)
            meta["ttft_s"] = round(now - req.submitted_t, 6)
        req.last_emit_t = now
        self.tokens_generated += len(tokens)
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
        """Free the slot's pages. Caller holds ``_lock`` and MUST invoke
        ``_finish_cb(*returned)`` after releasing it."""
        slot = self._slots[slot_idx]
        self._slots[slot_idx] = None
        self._table[slot_idx, :] = SCRATCH_PAGE
        self.pool.release(slot.pages)
        slot.pages = []
        return (slot.request, [], outcome, error, slot.generated)

    def _finish_cb(self, req: _Request, tokens: List[int], outcome: str,
                   error: Optional[str] = None, n_tokens: int = 0):
        self.requests_finished[outcome] = \
            self.requests_finished.get(outcome, 0) + 1
        meta = {"uri": req.uri, "outcome": outcome, "n_tokens": n_tokens}
        if error:
            meta["error"] = error
        if req.on_chunk is not None:
            try:
                req.on_chunk(tokens, True, meta)
            except Exception:   # a consumer bug must not poison the loop
                logger.exception("final-frame callback failed for %s",
                                 req.uri)

    # ------------------------------------------------------------- diagnostics

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            active = sum(s is not None for s in self._slots)
        return {
            "slots": self.n_slots,
            "active_slots": active,
            "backlog": len(self._backlog) + self._pending.qsize(),
            "free_pages": self.pool.free_count(),
            "page_capacity": self.pool.capacity,
            "peak_pages_in_use": self.peak_pages_in_use,
            "steps": self.steps,
            "tokens_generated": self.tokens_generated,
            "requests": dict(self.requests_finished),
            "prefill_buckets": sorted(self.prefill_buckets),
            "distinct_decode_shapes": len(self.decode_shapes),
            "slot_occupancy": round(
                self._occupied_slot_steps / (self.steps * self.n_slots), 4)
            if self.steps else 0.0,
        }


__all__ = ["ContinuousBatcher", "StreamHandle"]
