"""The port's GenerationEngine and GenerationClient against the JAX
package's, on the CPU.

Both engines serve a 2-layer LM with the JAX model's weights over their own
brokers, built from the same ``ServingConfig`` ``gen_*`` fields. Greedy
streams through ``GenerationClient`` are token-identical; frames arrive in
``seq`` order as ``{"sid", "seq", "tokens": int32, "final", ...}`` and a
request is acked only after its final frame. Cancel and deadline shedding
(``ShedError`` with ``retry_after_s``) end with JAX's outcomes, and
``/generate`` streams the same tokens over HTTP.
"""

import json
import time
import urllib.request

import jax
import numpy as np
import pytest

from analytics_zoo_tpu.models.transformer import TransformerLM as JaxLM
from analytics_zoo_tpu.serving import ServingConfig as JaxServingConfig
from analytics_zoo_tpu.serving import start_broker as jax_start_broker
from analytics_zoo_tpu.serving.generation import \
    GenerationClient as JaxGenerationClient
from analytics_zoo_tpu.serving.generation import \
    GenerationEngine as JaxGenerationEngine
from analytics_zoo_tpu_torch.models.transformer import TransformerLM
from analytics_zoo_tpu_torch.serving import (FrontEndApp, ServingConfig,
                                             ShedError, start_broker)
from analytics_zoo_tpu_torch.serving.client import _Conn
from analytics_zoo_tpu_torch.serving.generation import (GenerationClient,
                                                        GenerationEngine)

pytestmark = pytest.mark.generation

VOCAB, HIDDEN, BLOCKS, HEADS, SEQ = 64, 32, 2, 2, 64
GEN = dict(gen_slots=4, gen_page_size=4, gen_max_seq_len=32)


@pytest.fixture(scope="module")
def models():
    jm = JaxLM(vocab=VOCAB, hidden_size=HIDDEN, n_block=BLOCKS, n_head=HEADS,
               seq_len=SEQ)
    params, _ = jm.build(jax.random.PRNGKey(0))
    return jm, params, jax.tree_util.tree_map(np.asarray, params)


def _lm():
    return TransformerLM(vocab=VOCAB, hidden_size=HIDDEN, n_block=BLOCKS,
                         n_head=HEADS, seq_len=SEQ, device="cpu")


def _prompts(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, int(rng.integers(3, 12))).astype(np.int32)
            for _ in range(n)]


class _Engine:
    def __init__(self, side, models):
        jm, params, np_params = models
        if side == "jax":
            self.broker = jax_start_broker()
            cfg = JaxServingConfig(queue_port=self.broker.port, **GEN)
            self.engine = JaxGenerationEngine(jm, params, cfg)
            self.client = JaxGenerationClient(port=self.broker.port)
        else:
            self.broker = start_broker()
            cfg = ServingConfig(queue_port=self.broker.port, **GEN)
            # the JAX weights go in through the engine's own loader
            self.engine = GenerationEngine(_lm(), np_params, cfg,
                                           device="cpu")
            self.client = GenerationClient(port=self.broker.port)
        self.cfg = cfg
        self.engine.start()

    def close(self):
        self.client.close()
        self.engine.stop()
        self.broker.shutdown()
        self.broker.server_close()


@pytest.fixture(scope="module")
def engines(models):
    out = {side: _Engine(side, models) for side in ("jax", "torch")}
    yield out
    for e in out.values():
        e.close()


def test_greedy_streams_are_token_identical(engines):
    prompts = _prompts()
    got = {}
    for side, e in engines.items():
        uris = [e.client.submit(p, max_new_tokens=8) for p in prompts]
        got[side] = [[t for chunk in e.client.stream(u, timeout_s=60)
                      for t in chunk.tolist()] for u in uris]
    assert got["torch"] == got["jax"]
    assert all(len(s) == 8 for s in got["torch"])
    assert engines["torch"].engine.stats()["graph_checks"] == "not_ported"


def _frames(e, uri, timeout_s=60.0):
    """The raw frames of one stream, read off the broker until the final
    one (the client's own reader would delete the stream)."""
    c = _Conn("127.0.0.1", e.broker.port, timeout=30.0)
    frames, cursor = [], 0
    deadline = time.monotonic() + timeout_s
    try:
        while not (frames and frames[-1]["final"]):
            assert time.monotonic() < deadline, "no final frame"
            cursor, entries = c.call("XREAD", "genout:" + uri, cursor, 64,
                                     500)
            frames.extend(f for _, f in entries)
    finally:
        c.close()
    return frames


def test_frames_arrive_in_seq_order_and_are_acked_after_the_final(engines):
    prompt = _prompts(1, seed=3)[0]
    got = {}
    for side, e in engines.items():
        uri = e.client.submit(prompt, max_new_tokens=6)
        frames = _frames(e, uri)
        assert [f["seq"] for f in frames] == list(range(len(frames)))
        assert all(f["sid"] == uri for f in frames)
        assert [f["final"] for f in frames] == [False] * (len(frames) - 1) \
            + [True]
        for f in frames:
            assert f["tokens"].dtype == np.int32
        fin = frames[-1]
        assert fin["outcome"] == "ok" and fin["n_tokens"] == 6
        got[side] = [t for f in frames for t in f["tokens"].tolist()]
    assert got["torch"] == got["jax"]
    e = engines["torch"]
    e.engine.stop()       # drains the sink: every final frame acked
    c = _Conn("127.0.0.1", e.broker.port, timeout=10.0)
    try:
        assert c.call("LEN", "generation_stream", "generation") == 0
    finally:
        c.close()
    e.engine.start()


def test_cancel_and_deadline_shedding_match_jax(engines):
    prompt = _prompts(1, seed=5)[0]
    outcomes = {}
    for side, e in engines.items():
        # a request whose deadline already passed is shed, not served
        uri = e.client.submit(prompt, max_new_tokens=4,
                              deadline=time.time() - 1.0)
        with pytest.raises(Exception) as err:
            list(e.client.stream(uri, timeout_s=60))
        shed = err.value
        assert type(shed).__name__ == "ShedError"
        assert shed.retry_after_s > 0 and shed.reason == "deadline"
        # a cancel of a queued request ends its stream "cancelled": four
        # long streams hold every slot, so the request waits in the backlog
        # when its cancel arrives (a cancel that lands while the loop is
        # admitting the request is lost, in both packages)
        fillers = [e.client.submit(prompt, max_new_tokens=20)
                   for _ in range(GEN["gen_slots"])]
        uri = e.client.submit(prompt, max_new_tokens=20)
        e.client.cancel(uri)
        frames = _frames(e, uri)
        for f in fillers:
            assert _frames(e, f)[-1]["outcome"] == "ok"
        outcomes[side] = (frames[-1]["outcome"], type(shed).__name__)
    assert outcomes["torch"] == outcomes["jax"]
    assert outcomes["torch"][0] == "cancelled"
    assert isinstance(shed, ShedError)


def test_generate_streams_the_same_tokens_over_http(engines):
    prompt = _prompts(1, seed=7)[0]
    e = engines["torch"]
    want = engines["jax"].client.generate(prompt, max_new_tokens=8,
                                          timeout_s=60)
    app = FrontEndApp(e.cfg, port=0).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{app.port}/generate",
            data=json.dumps({"prompt": prompt.tolist(),
                             "max_new_tokens": 8}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.headers["Transfer-Encoding"] == "chunked"
            lines = [json.loads(l) for l in r.read().splitlines() if l]
    finally:
        app.stop()
    assert [l["final"] for l in lines][-1] is True
    assert lines[-1]["outcome"] == "ok" and lines[-1]["n_tokens"] == 8
    assert [t for l in lines for t in l["tokens"]] == want


def test_the_engine_needs_a_device_or_a_card(models):
    with pytest.raises(RuntimeError, match="CUDA"):
        GenerationEngine(_lm(), config=ServingConfig(**GEN))
