"""Seq2seq — RNN encoder + bridge + decoder (port of
``analytics_zoo_tpu/models/seq2seq/seq2seq.py``).

``RNNEncoder``/``RNNDecoder`` stack the port's recurrent layers (lstm,
gru or simplernn, each returning sequences) after an optional embedding;
``Bridge`` maps the encoder's final states to the decoder's initial ones
(dense, densenonlinear, or a custom function); ``Seq2seq`` trains with
teacher forcing and generates greedily, step by step, with ``infer``.

Each layer runs its own time loop with explicit carries in and out (the
JAX ``lax.scan`` chains): the input projection of all steps is one
product before the loop, then ``h @ recurrent_kernel`` and the layer's
gate arithmetic a step, as the layers compute them. The encoder's final
carries flow to the decoder as the JAX package's state tuples: an LSTM's
``(h, c)``, a GRU's or a SimpleRNN's ``h``.

Parameters keep the JAX tree's names: ``encoder.rnn_0.kernel``,
``encoder.embedding.params.embeddings`` (the JAX slot ``{"params",
"state"}`` of an embedding), ``bridge.kernel`` and ``bridge.bias``
(absent for a custom bridge), ``generator.<leaf>``, so
``bridge.params_from_jax`` and the weight bundles load them losslessly.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ...nn.layers.recurrent import GRU, LSTM, SimpleRNN, _RNNBase
from ...nn.module import (Layer, as_compute, call_layer, glorot_uniform,
                          resolve_device, zeros_init)
from ...nn.topology import KerasNet

_RNN_TYPES = {"lstm": LSTM, "gru": GRU, "simplernn": SimpleRNN}


def _create_rnns(rnn_type: str, nlayers: int,
                 hidden_size: int) -> List[_RNNBase]:
    """An lstm | gru | simplernn stack, each returning sequences."""
    try:
        cls = _RNN_TYPES[rnn_type.lower()]
    except KeyError:
        raise Exception("Only support lstm|gru|simplernn")
    return [cls(hidden_size, return_sequences=True) for _ in range(nlayers)]


def _projection(layer: _RNNBase, x: torch.Tensor) -> torch.Tensor:
    """``x @ kernel + bias`` over the last axis, in x's dtype."""
    dt = x.dtype
    lead = x.shape[:-1]
    xw = torch.addmm(layer.bias.to(dt), x.reshape(-1, x.shape[-1]),
                     layer.kernel.to(dt))
    return xw.reshape(tuple(lead) + (-1,))


def _scan_rnn(layer: _RNNBase, x: torch.Tensor, carry0=None):
    """One RNN layer over (B, T, D) with an explicit carry in and out:
    (outputs (B, T, H), final carry)."""
    xw = _projection(layer, x)
    u = layer.recurrent_kernel.to(x.dtype)
    carry = carry0 if carry0 is not None else layer.initial_carry(
        x.new_zeros((x.shape[0], layer.output_dim)))
    outs = []
    for xw_t in xw.unbind(1):
        carry, h = layer.step(xw_t, carry, u)
        outs.append(h)
    return torch.stack(outs, dim=1), carry


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def _unflatten(template, leaves: List[torch.Tensor]):
    it = iter(leaves)

    def build(t):
        if isinstance(t, (list, tuple)):
            return type(t)(build(s) for s in t)
        return next(it)

    return build(template)


class _Slot(nn.Module):
    """The JAX tree's ``{"params": ..., "state": ...}`` slot of a layer
    the stack holds: the layer under ``params``."""

    def __init__(self, layer: Layer):
        super().__init__()
        self.params = layer


class _RNNStack(nn.Module):
    """The encoder's and decoder's shared core: an optional embedding and
    the stacked RNNs (``rnn_0``, ``rnn_1``, ...)."""

    def __init__(self, rnns: Sequence[_RNNBase],
                 embedding: Optional[Layer] = None):
        super().__init__()
        self.rnns = list(rnns)
        for i, rnn in enumerate(self.rnns):
            self.add_module(f"rnn_{i}", rnn)
        self.embedding = _Slot(embedding) if embedding is not None else None

    @property
    def hidden_size(self) -> int:
        return self.rnns[-1].output_dim

    def build(self, input_shape, gen: torch.Generator) -> None:
        shape = tuple(input_shape)
        if self.embedding is not None:
            emb = self.embedding.params
            if not emb.built:
                emb.build(shape, gen)
                emb.built = True
            shape = emb.compute_output_shape(shape)
        for rnn in self.rnns:
            if not rnn.built:
                rnn.build(shape, gen)
                rnn.built = True
            shape = (shape[0], rnn.output_dim)

    def embed(self, x):
        if self.embedding is None:
            return as_compute(x)
        return self.embedding.params(x)

    def run(self, x, carries: Optional[List] = None):
        """(B, T, D) → (outputs (B, T, H), final carries per layer)."""
        h = self.embed(x)
        finals = []
        for i, rnn in enumerate(self.rnns):
            c0 = carries[i] if carries is not None else None
            h, c = _scan_rnn(rnn, h, c0)
            finals.append(c)
        return h, finals

    def step(self, x_t, carries: List):
        """One time step (B, D) (or (B,) ids with an embedding) → (output
        (B, H), new carries): ``infer``'s decode step."""
        if self.embedding is not None:
            h = self.embed(x_t[:, None])[:, 0]
        else:
            h = self.embed(x_t)
        new_carries = []
        for i, rnn in enumerate(self.rnns):
            c, h = rnn.step(_projection(rnn, h), carries[i],
                            rnn.recurrent_kernel.to(h.dtype))
            new_carries.append(c)
        return h, new_carries


class RNNEncoder(_RNNStack):
    """Stacked-RNN encoder."""

    def __init__(self, rnns, embedding=None, input_shape=None):
        super().__init__(rnns, embedding)
        self.input_shape_hint = tuple(input_shape) if input_shape else None
        self.spec = None

    @classmethod
    def initialize(cls, rnn_type: str, nlayers: int, hidden_size: int,
                   embedding=None, input_shape=None) -> "RNNEncoder":
        enc = cls(_create_rnns(rnn_type, nlayers, hidden_size), embedding,
                  input_shape)
        enc.spec = dict(rnn_type=rnn_type, nlayers=nlayers,
                        hidden_size=hidden_size)
        return enc


class RNNDecoder(_RNNStack):
    """Stacked-RNN decoder."""

    def __init__(self, rnns, embedding=None, input_shape=None):
        super().__init__(rnns, embedding)
        self.input_shape_hint = tuple(input_shape) if input_shape else None
        self.spec = None

    @classmethod
    def initialize(cls, rnn_type: str, nlayers: int, hidden_size: int,
                   embedding=None, input_shape=None) -> "RNNDecoder":
        dec = cls(_create_rnns(rnn_type, nlayers, hidden_size), embedding,
                  input_shape)
        dec.spec = dict(rnn_type=rnn_type, nlayers=nlayers,
                        hidden_size=hidden_size)
        return dec


class Bridge(nn.Module):
    """Encoder final states → decoder initial states: ``dense``,
    ``densenonlinear`` (tanh after) or ``customized`` (a function of the
    state tree). The dense bridge concatenates every encoder state tensor,
    applies one ``(B, n·He) @ (n·He, n·Hd)`` product and splits the result
    back into the decoder's states."""

    def __init__(self, bridge_type: str, decoder_hidden_size: int,
                 bridge_fn: Optional[Callable] = None):
        super().__init__()
        self.bridge_type = bridge_type.lower()
        self.decoder_hidden_size = int(decoder_hidden_size)
        self.bridge_fn = bridge_fn
        if self.bridge_type not in ("dense", "densenonlinear",
                                    "customized"):
            raise ValueError(
                "bridge_type must be dense|densenonlinear|customized")

    @classmethod
    def initialize(cls, bridge_type: str,
                   decoder_hidden_size: int) -> "Bridge":
        return cls(bridge_type, decoder_hidden_size)

    @classmethod
    def initialize_from_fn(cls, fn: Callable) -> "Bridge":
        """A custom bridge from a state-tree → state-tree function."""
        return cls("customized", 0, fn)

    def build(self, gen: torch.Generator, enc_template,
              dec_template) -> None:
        if self.bridge_type == "customized":
            return
        in_dim = sum(t.shape[-1] for t in _leaves(enc_template))
        out_dim = sum(t.shape[-1] for t in _leaves(dec_template))
        self.kernel = nn.Parameter(glorot_uniform(gen, (in_dim, out_dim)))
        self.bias = nn.Parameter(zeros_init((out_dim,)))

    def apply(self, enc_states, dec_template):
        if self.bridge_type == "customized":
            return self.bridge_fn(enc_states)
        flat = torch.cat(_leaves(enc_states), dim=-1)
        y = flat @ self.kernel.to(flat.dtype) + self.bias.to(flat.dtype)
        if self.bridge_type == "densenonlinear":
            y = torch.tanh(y)
        dims = [t.shape[-1] for t in _leaves(dec_template)]
        return _unflatten(dec_template, list(y.split(dims, dim=-1)))


class Seq2seq(KerasNet, Layer):
    """Trainable encoder + decoder. Inputs to ``fit``/``apply``:
    ``[encoder_input, decoder_input]`` (teacher forcing). ``generator``
    (a layer applied to the decoder's outputs, e.g.
    ``TimeDistributed(Dense(vocab, activation="softmax"))``) produces the
    output. ``device``: CUDA unless the caller names another (raises with
    no CUDA and no device); ``seed`` draws the weights."""

    def __init__(self, encoder: RNNEncoder, decoder: RNNDecoder,
                 input_shape: Sequence[int], output_shape: Sequence[int],
                 bridge: Optional[Bridge] = None,
                 generator: Optional[Layer] = None, *, device=None,
                 seed: int = 0):
        if input_shape is None or output_shape is None:
            raise TypeError("input_shape and output_shape cannot be None")
        super().__init__(name="seq2seq")
        dev = resolve_device(device)
        self.encoder = encoder
        self.decoder = decoder
        self.enc_input_shape = tuple(input_shape)
        self.dec_input_shape = tuple(output_shape)
        if bridge is not None and bridge.bridge_type != "customized" \
                and bridge.decoder_hidden_size != decoder.hidden_size:
            raise ValueError(
                f"Bridge(decoder_hidden_size={bridge.decoder_hidden_size}) "
                f"does not match the decoder's hidden size "
                f"{decoder.hidden_size}")
        self.bridge = bridge
        self.generator = generator
        gen = torch.Generator().manual_seed(seed)
        self.encoder.build(self.enc_input_shape, gen)
        self.decoder.build(self.dec_input_shape, gen)
        if bridge is not None:
            bridge.build(gen, *self._state_templates())
        if generator is not None and not generator.built:
            generator.build((self.dec_input_shape[0],
                             self.decoder.hidden_size), gen)
            generator.built = True
        self.built = True
        self.device = dev
        self.to(dev)
        self.eval()

    def _state_templates(self):
        def carries(rnns):
            return [r.initial_carry(torch.zeros((1, r.output_dim)))
                    for r in rnns]

        return carries(self.encoder.rnns), carries(self.decoder.rnns)

    def _decoder_init_states(self, enc_finals):
        if self.bridge is not None:
            _, dec_t = self._state_templates()
            return self.bridge.apply(enc_finals, dec_t)
        # no bridge: the encoder's finals pass straight through
        return enc_finals

    def apply(self, x):
        enc_in, dec_in = x
        _, enc_finals = self.encoder.run(enc_in)
        init = self._decoder_init_states(enc_finals)
        dec_out, _ = self.decoder.run(dec_in, init)
        if self.generator is not None:
            dec_out = call_layer(self.generator, dec_out, None)
        return dec_out

    def compute_output_shape(self, input_shape=None):
        out = (self.dec_input_shape[0], self.decoder.hidden_size)
        if self.generator is not None:
            out = self.generator.compute_output_shape(out)
        return out

    # -- inference -----------------------------------------------------------
    def infer(self, input: np.ndarray, start_sign: np.ndarray,
              max_seq_len: int = 30, stop_sign: Optional[np.ndarray] = None,
              build_output: Optional[Callable] = None) -> np.ndarray:
        """Greedy step-wise generation: ``input`` (B, T_in, ...) is the
        encoder input, ``start_sign`` (B, ...) the first decoder input;
        ``build_output`` maps a decoder output (numpy) to the next decoder
        input (default: the output itself). Stops early once an output
        equals ``stop_sign``. Returns (B, steps, ...)."""
        self._require_compiled()
        dev = self.device
        was_training = self.training
        self.eval()
        try:
            with torch.no_grad():
                enc_in = torch.as_tensor(np.asarray(input)).to(dev)
                _, finals = self.encoder.run(enc_in)
                carries = self._decoder_init_states(finals)
                x_t = torch.as_tensor(np.asarray(start_sign)).to(dev)
                outs = []
                for _ in range(max_seq_len):
                    h, carries = self.decoder.step(x_t, carries)
                    y = h
                    if self.generator is not None:
                        y = call_layer(self.generator, h[:, None], None)[:,
                                                                         0]
                    outs.append(y.float().cpu().numpy())
                    if stop_sign is not None and \
                            np.allclose(outs[-1], stop_sign):
                        break
                    x_t = (torch.as_tensor(np.asarray(build_output(
                        outs[-1]))).to(dev) if build_output else y)
        finally:
            self.train(was_training)
        return np.stack(outs, axis=1)

    # -- persistence ---------------------------------------------------------
    def save_model(self, path: str):
        """A weight bundle; its config rebuilds the architecture when it
        has no embedding, generator or custom bridge."""
        from ..common.zoo_model import save_model_bundle

        cfg = None
        if self.encoder.spec and self.decoder.spec and \
                self.generator is None and self.encoder.embedding is None \
                and self.decoder.embedding is None:
            cfg = dict(encoder=self.encoder.spec, decoder=self.decoder.spec,
                       input_shape=list(self.enc_input_shape),
                       output_shape=list(self.dec_input_shape),
                       bridge=(dict(bridge_type=self.bridge.bridge_type,
                                    decoder_hidden_size=(
                                        self.bridge.decoder_hidden_size))
                               if self.bridge and self.bridge.bridge_type
                               != "customized" else None))
        save_model_bundle(path, self, config={"seq2seq": cfg} if cfg else {})

    @classmethod
    def load_model(cls, path: str, *, device=None) -> "Seq2seq":
        """Rebuild a bundle's Seq2seq (on ``device``, CUDA unless given)
        and load its weights."""
        import json
        import os

        with open(os.path.join(path, "config.json")) as f:
            cfg = json.load(f)["config"].get("seq2seq")
        if not cfg:
            raise ValueError(
                "this Seq2seq bundle has a custom architecture "
                "(embedding/generator/custom bridge); rebuild it and call "
                "model.load_weights(path)")
        enc = RNNEncoder.initialize(**cfg["encoder"])
        dec = RNNDecoder.initialize(**cfg["decoder"])
        bridge = Bridge.initialize(**cfg["bridge"]) if cfg.get("bridge") \
            else None
        model = cls(enc, dec, cfg["input_shape"], cfg["output_shape"],
                    bridge, device=device)
        model.load_weights(path)
        return model


__all__ = ["Bridge", "RNNDecoder", "RNNEncoder", "Seq2seq"]
