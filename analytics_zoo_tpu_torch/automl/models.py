"""AutoML time-series models (port of ``automl/models.py``): VanillaLSTM,
TSSeq2Seq and MTNet behind ``TimeSequenceModel``.

Every model keeps the trial protocol the search engine drives:
``fit_eval(x, y, validation_data, **config) -> val_metric``, ``evaluate``,
``predict``, ``predict_with_uncertainty`` (MC dropout on the JAX package's
keys, ``split(PRNGKey(0), n_iter)``, so the masks are JAX's bit for bit),
``save``/``restore`` (the JAX package's weight bundle plus a
``.config.json``).

The custom cores keep the JAX trees' names and layouts, so
``bridge.params_from_jax`` loads them: ``_Seq2SeqCore`` holds ``enc``,
``dec`` and ``head``; ``_MTNetCore`` holds ``conv`` (H, F, C), ``grus``
(one per entry of ``rnn_hid_sizes``), ``att``, ``head_w``, ``head_b`` and
``ar``. The seq2seq decoder's ``lax.scan`` is a Python loop of the LSTM's
``step``; MTNet's NWC valid conv is ``F.conv1d`` over the transposed
blocks, and its ``long_num + 1`` memory blocks share one batched encoder
call. Models are built on ``device`` (CUDA unless given).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..common import prng
from ..nn import layers as L
from ..nn.layers.core import dropout
from ..nn.module import Layer, get_initializer, split_rng, zeros_init
from ..nn.topology import Sequential
from .metrics import Evaluator


class BaseTSModel:
    """Shared trial protocol (the reference's model/abstract.py
    BaseModel)."""

    default_config: Dict = {}

    def __init__(self, future_seq_len: int = 1, *, device=None):
        self.future_seq_len = int(future_seq_len)
        self.device = device
        self.model: Optional[Sequential] = None
        self.config: Dict = {}

    # -- subclass hook ---------------------------------------------------------
    def _build(self, input_shape: Tuple[int, int], config: Dict) -> Sequential:
        raise NotImplementedError

    # -- trial protocol --------------------------------------------------------
    def build(self, input_shape: Tuple[int, int], **config):
        cfg = dict(self.default_config)
        cfg.update(config)
        self.config = cfg
        self.config["input_shape"] = [int(s) for s in input_shape]
        self.model = self._build(tuple(input_shape), cfg)
        self.model.compile(optimizer=self._optimizer(cfg), loss="mse")
        return self

    def _optimizer(self, cfg):
        from ..nn.optimizers import Adam

        return Adam(lr=float(cfg.get("lr", 1e-3)))

    def fit_eval(self, x: np.ndarray, y: np.ndarray, validation_data=None,
                 metric: str = "mse", epochs: Optional[int] = None,
                 batch_size: Optional[int] = None, **config) -> float:
        """Train and return the validation metric (the train set when no
        validation data is given). ``epochs``/``batch_size`` are honoured
        on every call; structural hyperparameters in ``config`` take effect
        at the first build only."""
        if y.ndim == 1:
            y = y[:, None]
        if self.model is None:
            self.build((x.shape[1], x.shape[2]), **config)
        cfg = self.config
        n_epochs = int(epochs if epochs is not None else
                       config.get("epochs", cfg.get("epochs", 1)))
        batch_size = int(batch_size if batch_size is not None else
                         config.get("batch_size", cfg.get("batch_size", 32)))
        batch_size = max(1, min(batch_size, len(x)))
        self.model.fit(x, y, batch_size=batch_size, nb_epoch=n_epochs)
        vx, vy = (x, y) if validation_data is None else validation_data
        if vy.ndim == 1:
            vy = vy[:, None]
        return Evaluator.evaluate(metric, vy, self.predict(vx))

    def evaluate(self, x, y, metrics: List[str] = ("mse",)) -> List[float]:
        y = np.asarray(y)
        if y.ndim == 1:
            y = y[:, None]
        pred = self.predict(x)
        return [Evaluator.evaluate(m, y, pred) for m in metrics]

    def predict(self, x) -> np.ndarray:
        if self.model is None:
            raise RuntimeError("model not built; call fit_eval or restore first")
        return np.asarray(self.model.predict(x))

    def predict_with_uncertainty(self, x, n_iter: int = 20):
        """MC-dropout predictive mean and epistemic std (the reference's
        ``mc=True``): ``n_iter`` forwards in training mode on the keys
        ``split(PRNGKey(0), n_iter)``."""
        if self.model is None:
            raise RuntimeError("model not built; call fit_eval or restore first")
        xt = torch.as_tensor(np.asarray(x, dtype=np.float32)).to(
            self.model.device)
        keys = prng.split(prng.PRNGKey(0), n_iter)
        self.model.train()
        try:
            with torch.no_grad():
                preds = np.stack([self.model.apply(xt, rng=k).float().cpu()
                                  .numpy() for k in keys])
        finally:
            self.model.eval()
        return preds.mean(axis=0), preds.std(axis=0)

    # -- persistence -----------------------------------------------------------
    def save(self, model_path: str, config_path: Optional[str] = None):
        from ..models.common.zoo_model import save_weights

        if self.model is None:
            raise RuntimeError("model has no weights to save — fit or restore "
                               "it first")
        os.makedirs(os.path.dirname(model_path) or ".", exist_ok=True)
        save_weights(model_path, self.model)
        cfg = {k: v for k, v in self.config.items()}
        cfg["future_seq_len"] = self.future_seq_len
        with open(config_path or model_path + ".config.json", "w") as f:
            json.dump(cfg, f)

    def restore(self, model_path: str, config_path: Optional[str] = None,
                **config):
        with open(config_path or model_path + ".config.json") as f:
            cfg = json.load(f)
        cfg.update(config)
        self.future_seq_len = int(cfg.pop("future_seq_len", self.future_seq_len))
        in_shape = tuple(cfg.pop("input_shape"))
        self.build(in_shape, **cfg)          # compiles a fresh estimator
        self.model.load_weights(model_path)
        return self


class VanillaLSTM(BaseTSModel):
    """Two stacked LSTMs + dropout + Dense head (config keys
    lstm_1_units/dropout_1/lstm_2_units/dropout_2/lr/batch_size)."""

    default_config = dict(lstm_1_units=32, dropout_1=0.2, lstm_2_units=32,
                          dropout_2=0.2, lr=1e-3, batch_size=64, epochs=1)

    def _build(self, input_shape, cfg):
        m = Sequential(name="vanilla_lstm", device=self.device)
        m.add(L.InputLayer(input_shape))
        m.add(L.LSTM(int(cfg["lstm_1_units"]), return_sequences=True))
        m.add(L.Dropout(float(cfg["dropout_1"])))
        m.add(L.LSTM(int(cfg["lstm_2_units"]), return_sequences=False))
        m.add(L.Dropout(float(cfg["dropout_2"])))
        m.add(L.Dense(self.future_seq_len))
        return m


class TSSeq2Seq(BaseTSModel):
    """Encoder/decoder LSTM forecaster: the encoder consumes the past
    window; the decoder is unrolled ``future_seq_len`` steps feeding back
    its own output."""

    default_config = dict(latent_dim=64, dropout=0.2, lr=1e-3, batch_size=64,
                          epochs=1)

    def _build(self, input_shape, cfg):
        m = Sequential(name="ts_seq2seq", device=self.device)
        m.add(L.InputLayer(input_shape))
        m.add(_Seq2SeqCore(int(cfg["latent_dim"]), self.future_seq_len,
                           float(cfg["dropout"])))
        return m


class _Seq2SeqCore(Layer):
    takes_rng = True

    def __init__(self, latent_dim: int, future_seq_len: int, dropout: float,
                 name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.latent = latent_dim
        self.future = future_seq_len
        self.dropout = dropout

    def build(self, input_shape, gen: torch.Generator) -> None:
        self.enc = L.LSTM(self.latent, return_sequences=False)
        self.enc.build(input_shape, gen)
        # the decoder cell's input is the previous scalar prediction
        self.dec = L.LSTM(self.latent, return_sequences=False)
        self.dec.build((self.future, 1), gen)
        self.head = L.Dense(1)
        self.head.build((self.latent,), gen)
        for layer in (self.enc, self.dec, self.head):
            layer.built = True
        self.built = True

    def apply(self, x, rng=None):
        _k_enc, k_drop = split_rng(rng, 2)
        h = self.enc.apply(x)
        c = torch.zeros_like(h)
        if self.training and self.dropout > 0 and k_drop is not None:
            h = dropout(h, self.dropout, k_drop)
        dec = self.dec
        kernel, bias = dec.kernel.to(h.dtype), dec.bias.to(h.dtype)
        u = dec.recurrent_kernel.to(h.dtype)
        y = h.new_zeros((x.shape[0], 1))
        ys = []
        for _ in range(self.future):
            (h, c), _out = dec.step(torch.addmm(bias, y, kernel), (h, c), u)
            y = self.head.apply(h)
            ys.append(y)
        return torch.cat(ys, dim=1)  # (B, future)

    def compute_output_shape(self, input_shape):
        return (self.future,)


class MTNet(BaseTSModel):
    """Memory Time-series Network.

    Input ``(B, (long_num + 1) * time_step, F)``: ``long_num`` long-term
    memory blocks plus the short-term block. Encoder = Conv(time,
    cnn_height) + dropout + GRU stack. Attention over the encoded memories
    selects a context; concatenated with the query encoding it feeds the
    head; an autoregressive linear term on the last ``ar_window`` target
    values is added.
    """

    default_config = dict(time_step=4, long_num=3, cnn_height=2, cnn_hid_size=16,
                          rnn_hid_size=16, ar_window=2, cnn_dropout=0.2,
                          rnn_dropout=0.2, lr=1e-3, batch_size=64, epochs=1)

    def _build(self, input_shape, cfg):
        rnn_sizes = cfg.get("rnn_hid_sizes") or [int(cfg["rnn_hid_size"])]
        m = Sequential(name="mtnet", device=self.device)
        m.add(L.InputLayer(input_shape))
        m.add(_MTNetCore(time_step=int(cfg["time_step"]),
                         long_num=int(cfg["long_num"]),
                         cnn_height=int(cfg["cnn_height"]),
                         cnn_hid=int(cfg["cnn_hid_size"]),
                         rnn_hids=[int(s) for s in rnn_sizes],
                         ar_window=int(cfg["ar_window"]),
                         cnn_dropout=float(cfg["cnn_dropout"]),
                         rnn_dropout=float(cfg["rnn_dropout"]),
                         future=self.future_seq_len))
        return m


class _MTNetCore(Layer):
    takes_rng = True

    def __init__(self, *, time_step, long_num, cnn_height, cnn_hid, rnn_hids,
                 ar_window, cnn_dropout, rnn_dropout, future, name=None,
                 input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.time_step = time_step
        self.long_num = long_num
        self.cnn_height = min(cnn_height, time_step)
        self.cnn_hid = cnn_hid
        self.rnn_hids = list(rnn_hids)
        self.rnn_hid = self.rnn_hids[-1]
        self.ar_window = ar_window
        self.cnn_dropout = cnn_dropout
        self.rnn_dropout = rnn_dropout
        self.future = future
        self.grus = nn.ModuleList(
            [L.GRU(h, return_sequences=(i < len(self.rnn_hids) - 1))
             for i, h in enumerate(self.rnn_hids)])

    def build(self, input_shape, gen: torch.Generator) -> None:
        total_t, feat = input_shape
        need = (self.long_num + 1) * self.time_step
        if total_t < need:
            raise ValueError(
                f"MTNet needs past_seq_len >= (long_num+1)*time_step = {need}, "
                f"got {total_t}")
        init = get_initializer("glorot_uniform")
        self.conv = nn.Parameter(init(gen, (self.cnn_height, feat,
                                            self.cnn_hid)))
        t_len = self.time_step - self.cnn_height + 1
        in_dim = self.cnn_hid
        for gru in self.grus:
            gru.build((t_len, in_dim), gen)
            gru.built = True
            in_dim = gru.output_dim
        self.att = nn.Parameter(init(gen, (self.rnn_hid, self.rnn_hid)))
        self.head_w = nn.Parameter(init(gen, (2 * self.rnn_hid, self.future)))
        self.head_b = nn.Parameter(zeros_init((self.future,)))
        self.ar = nn.Parameter(init(gen, (self.ar_window, self.future)))
        self.built = True

    def _encode(self, blocks, rng):
        """blocks: (N, time_step, F) -> (N, rnn_hid), one batched conv +
        GRU stack."""
        ks = split_rng(rng, 1 + len(self.grus))
        # valid 1-D conv over time: (N, T, F) x (H, F, C) -> (N, T-H+1, C)
        w = self.conv.to(blocks.dtype).permute(2, 1, 0)
        z = F.relu(F.conv1d(blocks.transpose(1, 2), w).transpose(1, 2))
        if self.training and self.cnn_dropout > 0 and ks[0] is not None:
            z = dropout(z, self.cnn_dropout, ks[0])
        h = z
        for gru in self.grus:
            h = gru.apply(h)
        return h

    def apply(self, x, rng=None):
        k_mem, k_q, k_drop = split_rng(rng, 3)
        b = x.shape[0]
        need = (self.long_num + 1) * self.time_step
        x = x[:, -need:, :]
        blocks = x.reshape(b, self.long_num + 1, self.time_step, x.shape[-1])
        mem_blocks = blocks[:, :-1].reshape(b * self.long_num,
                                            self.time_step, -1)
        q_block = blocks[:, -1]

        mem = self._encode(mem_blocks, k_mem)
        mem = mem.reshape(b, self.long_num, self.rnn_hid)
        u = self._encode(q_block, k_q)

        # attention over memories: score_i = m_i^T W u
        scores = torch.einsum("bnh,hk,bk->bn", mem, self.att.to(u.dtype), u)
        alpha = torch.softmax(scores.float(), dim=-1).to(u.dtype)
        ctx = torch.einsum("bn,bnh->bh", alpha, mem)

        feat = torch.cat([u, ctx], dim=-1)
        if self.training and self.rnn_dropout > 0 and k_drop is not None:
            feat = dropout(feat, self.rnn_dropout, k_drop)
        y = feat @ self.head_w.to(u.dtype) + self.head_b.to(u.dtype)
        # AR component on the raw target column (col 0) of the last
        # ar_window steps
        ar = x[:, -self.ar_window:, 0] @ self.ar.to(u.dtype)
        return y + ar

    def compute_output_shape(self, input_shape):
        return (self.future,)


MODEL_REGISTRY = {"LSTM": VanillaLSTM, "Seq2Seq": TSSeq2Seq, "MTNet": MTNet}


class TimeSequenceModel:
    """Dispatches to LSTM vs Seq2Seq vs MTNet from the trial config's
    ``model`` key (LSTM for ``future_seq_len == 1``, else Seq2Seq, by
    default); models are built on ``device``."""

    def __init__(self, future_seq_len: int = 1, *, device=None):
        self.future_seq_len = int(future_seq_len)
        self.device = device
        self.inner: Optional[BaseTSModel] = None
        self.model_name: Optional[str] = None

    def _select(self, config) -> str:
        if "model" in config:
            return config["model"]
        return "LSTM" if self.future_seq_len == 1 else "Seq2Seq"

    def fit_eval(self, x, y, validation_data=None, metric="mse", **config):
        name = self._select(config)
        if self.inner is None or name != self.model_name:
            self.model_name = name
            self.inner = MODEL_REGISTRY[name](
                future_seq_len=self.future_seq_len, device=self.device)
        cfg = {k: v for k, v in config.items() if k != "model"}
        return self.inner.fit_eval(x, y, validation_data=validation_data,
                                   metric=metric, **cfg)

    def evaluate(self, x, y, metrics=("mse",)):
        return self.inner.evaluate(x, y, metrics)

    def predict(self, x):
        return self.inner.predict(x)

    def predict_with_uncertainty(self, x, n_iter: int = 20):
        return self.inner.predict_with_uncertainty(x, n_iter)

    def save(self, model_path, config_path=None):
        self.inner.config["model"] = self.model_name
        self.inner.save(model_path, config_path)

    def restore(self, model_path, config_path=None, **config):
        with open(config_path or model_path + ".config.json") as f:
            saved = json.load(f)
        saved.update(config)
        name = saved.pop("model", self._select(saved))
        self.model_name = name
        self.inner = MODEL_REGISTRY[name](
            future_seq_len=saved.get("future_seq_len", self.future_seq_len),
            device=self.device)
        self.inner.restore(model_path, config_path)
        return self


__all__ = ["BaseTSModel", "MODEL_REGISTRY", "MTNet", "TSSeq2Seq",
           "TimeSequenceModel", "VanillaLSTM"]
