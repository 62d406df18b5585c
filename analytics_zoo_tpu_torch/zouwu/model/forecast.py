"""Standalone forecasters (port of ``zouwu/model/forecast.py``).

* ``LSTMForecaster`` / ``MTNetForecaster`` / ``Seq2SeqForecaster``: thin
  constructors over the automl models with fixed hyperparameters;
  fit/evaluate/predict on pre-rolled numpy windows, on ``device`` (CUDA
  unless given).
* ``TCMFForecaster``: temporal matrix factorization for high-dimensional
  series, ``Y (n, T) ≈ F (n, k) · X (k, T)``, trained jointly with the
  port's optax-shaped Adam on torch autograd (initial factors from
  ``prng.normal``, JAX's ``jax.random.normal`` draws), then a ridge AR(p)
  model on the latent rows of X (numpy) rolls the forecast forward.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ...automl.metrics import Evaluator
from ...automl.models import MTNet, TSSeq2Seq, VanillaLSTM
from ...common import prng


class Forecaster:
    """Abstract forecaster (zouwu/model/forecast.py:27)."""

    def fit(self, x, y, **kwargs):
        raise NotImplementedError

    def evaluate(self, x, y, metrics=("mse",)):
        raise NotImplementedError

    def predict(self, x):
        raise NotImplementedError


class _AutomlBackedForecaster(Forecaster):
    """Shared fit/evaluate/predict over a BaseTSModel instance."""

    def __init__(self, model, config: Dict):
        self._model = model
        self._config = dict(config)

    def fit(self, x, y, validation_data=None, epochs: int = 1,
            batch_size: Optional[int] = None, metric: str = "mse"):
        cfg = dict(self._config)
        cfg["epochs"] = epochs
        if batch_size is not None:
            cfg["batch_size"] = batch_size
        return self._model.fit_eval(np.asarray(x), np.asarray(y),
                                    validation_data=validation_data,
                                    metric=metric, **cfg)

    def evaluate(self, x, y, metrics=("mse",)):
        return self._model.evaluate(np.asarray(x), np.asarray(y), metrics)

    def predict(self, x):
        return self._model.predict(np.asarray(x))

    def predict_with_uncertainty(self, x, n_iter: int = 20):
        return self._model.predict_with_uncertainty(np.asarray(x), n_iter)

    def save(self, model_path: str):
        self._model.save(model_path)

    def restore(self, model_path: str):
        self._model.restore(model_path)
        return self


class LSTMForecaster(_AutomlBackedForecaster):
    """Vanilla LSTM forecaster (forecast.py:220-279 constructor parity)."""

    def __init__(self, target_dim: int = 1, feature_dim: int = 1,
                 lstm_1_units: int = 16, dropout_1: float = 0.2,
                 lstm_2_units: int = 8, dropout_2: float = 0.2,
                 lr: float = 1e-3, uncertainty: bool = False, *,
                 device=None):
        del feature_dim, uncertainty  # shape inferred; MC always available
        super().__init__(
            VanillaLSTM(future_seq_len=target_dim, device=device),
            dict(lstm_1_units=lstm_1_units, dropout_1=dropout_1,
                 lstm_2_units=lstm_2_units, dropout_2=dropout_2, lr=lr))


class MTNetForecaster(_AutomlBackedForecaster):
    """MTNet forecaster (forecast.py:282-341 constructor parity).

    Input windows must have length ``(long_series_num + 1) * series_length``;
    no separate ``preprocess_input`` split is needed — the model splits
    internally (one array in, one batched encoder call inside).
    """

    def __init__(self, target_dim: int = 1, feature_dim: int = 1,
                 long_series_num: int = 1, series_length: int = 1,
                 ar_window_size: int = 1, cnn_height: int = 1,
                 cnn_hid_size: int = 32, rnn_hid_sizes: List[int] = (16, 32),
                 lr: float = 1e-3, cnn_dropout: float = 0.2,
                 rnn_dropout: float = 0.2, uncertainty: bool = False, *,
                 device=None):
        del feature_dim, uncertainty
        super().__init__(
            MTNet(future_seq_len=target_dim, device=device),
            dict(time_step=series_length, long_num=long_series_num,
                 ar_window=ar_window_size, cnn_height=cnn_height,
                 cnn_hid_size=cnn_hid_size,
                 rnn_hid_sizes=list(rnn_hid_sizes), lr=lr,
                 cnn_dropout=cnn_dropout, rnn_dropout=rnn_dropout))


class Seq2SeqForecaster(_AutomlBackedForecaster):
    """Multi-step encoder/decoder forecaster."""

    def __init__(self, horizon: int = 1, latent_dim: int = 64,
                 dropout: float = 0.2, lr: float = 1e-3, *, device=None):
        super().__init__(TSSeq2Seq(future_seq_len=horizon, device=device),
                         dict(latent_dim=latent_dim, dropout=dropout, lr=lr))


class TCMFForecaster(Forecaster):
    """Temporal-matrix-factorization forecaster for (n_series, T) panels
    (zouwu/model/forecast.py:41 TCMFForecaster capability parity).

    fit: minimize ``||Y - F·X||² + λ(‖F‖² + ‖X‖²)`` jointly with Adam on
    ``device`` (CUDA unless given), then fit a ridge AR(p) temporal model on
    the latent rows of X. predict: roll the AR model forward ``horizon``
    steps, emit ``F·X_future``.
    """

    def __init__(self, rank: int = 16, lr: float = 0.05, reg: float = 1e-3,
                 max_iter: int = 300, ar_lags: int = 8, seed: int = 0, *,
                 device=None):
        self.device = device
        self.rank = int(rank)
        self.lr = float(lr)
        self.reg = float(reg)
        self.max_iter = int(max_iter)
        self.ar_lags = int(ar_lags)
        self.seed = int(seed)
        self.F: Optional[np.ndarray] = None
        self.X: Optional[np.ndarray] = None
        self.ar_coef: Optional[np.ndarray] = None
        self.y_mean = None
        self.y_std = None

    def fit(self, x, incremental: bool = False):
        """``x``: (n_series, T) array, or dict with key ``"y"`` (reference input
        convention ``{"id": ..., "y": ...}``)."""
        import torch

        from ...nn.module import resolve_device
        from ...nn.optimizers import Adam, apply_updates

        dev = resolve_device(self.device)
        y = np.asarray(x["y"] if isinstance(x, dict) else x, dtype=np.float32)
        if y.ndim != 2:
            raise ValueError(f"TCMF expects (n_series, T), got {y.shape}")
        n, T = y.shape
        k = min(self.rank, n, T)
        self.y_mean = y.mean(axis=1, keepdims=True)
        self.y_std = y.std(axis=1, keepdims=True) + 1e-6
        yn = (y - self.y_mean) / self.y_std

        kf, kx = prng.split(prng.PRNGKey(self.seed))
        if incremental and self.F is not None and self.F.shape == (n, k):
            F0 = torch.from_numpy(np.asarray(self.F, np.float32))
            if self.X is not None and self.X.shape == (k, T):
                X0 = torch.from_numpy(np.asarray(self.X, np.float32))
            else:
                # new series length: warm-start X from the retained basis F
                X0 = torch.from_numpy(np.asarray(
                    np.linalg.pinv(self.F) @ yn, np.float32))
            params = {"F": F0.to(dev), "X": X0.to(dev)}
        else:
            params = {"F": 0.1 * prng.normal(kf, (n, k), device=dev),
                      "X": 0.1 * prng.normal(kx, (k, T), device=dev)}
        tx = Adam(lr=self.lr)
        opt_state = tx.init(params)
        yt = torch.from_numpy(yn).to(dev)
        reg = self.reg

        loss = None
        for _ in range(self.max_iter):
            p = {n_: v.detach().requires_grad_() for n_, v in params.items()}
            err = yt - p["F"] @ p["X"]
            loss = (torch.mean(err ** 2)
                    + reg * (torch.mean(p["F"] ** 2) + torch.mean(p["X"] ** 2)))
            gf, gx = torch.autograd.grad(loss, [p["F"], p["X"]])
            with torch.no_grad():
                updates, opt_state = tx.update({"F": gf, "X": gx},
                                               opt_state, params)
                params = apply_updates(params, updates)
        self.F = params["F"].cpu().numpy()
        self.X = params["X"].cpu().numpy()

        # ridge AR(p) on each latent row (shared coefficients across rows)
        p = min(self.ar_lags, T - 1)
        self.ar_lags_eff = p
        lagged = np.stack([self.X[:, i:T - p + i] for i in range(p)], axis=-1)
        A = lagged.reshape(-1, p)                 # (k*(T-p), p)
        b = self.X[:, p:].reshape(-1)
        gram = A.T @ A + 1e-3 * np.eye(p)
        self.ar_coef = np.linalg.solve(gram, A.T @ b)
        return float(loss.detach())

    def predict(self, x=None, horizon: int = 24) -> np.ndarray:
        if self.F is None:
            raise RuntimeError("TCMF not fitted")
        del x
        p = self.ar_lags_eff
        Xf = self.X.copy()
        for _ in range(int(horizon)):
            nxt = Xf[:, -p:] @ self.ar_coef
            Xf = np.concatenate([Xf, nxt[:, None]], axis=1)
        y_future = self.F @ Xf[:, -int(horizon):]
        return y_future * self.y_std + self.y_mean

    def evaluate(self, target_value, metric: List[str] = ("mae",),
                 x=None) -> List[float]:
        tv = np.asarray(target_value["y"] if isinstance(target_value, dict)
                        else target_value)
        pred = self.predict(x=x, horizon=tv.shape[1])
        return [Evaluator.evaluate(m, tv, pred) for m in metric]

    def save(self, model_path: str):
        """Persist the full fitted state (reference TCMFForecaster.save parity,
        zouwu/model/forecast.py) so a fitted model survives the process."""
        if self.F is None:
            raise RuntimeError("TCMF not fitted — nothing to save")
        np.savez(
            model_path if model_path.endswith(".npz") else model_path + ".npz",
            F=self.F, X=self.X, ar_coef=self.ar_coef,
            y_mean=self.y_mean, y_std=self.y_std,
            meta=np.asarray([self.ar_lags_eff, self.rank, self.lr, self.reg,
                             self.max_iter, self.ar_lags, self.seed],
                            dtype=np.float64))

    def restore(self, model_path: str):
        path = model_path if model_path.endswith(".npz") else model_path + ".npz"
        with np.load(path) as z:
            self.F, self.X = z["F"], z["X"]
            self.ar_coef = z["ar_coef"]
            self.y_mean, self.y_std = z["y_mean"], z["y_std"]
            meta = z["meta"]
        self.ar_lags_eff = int(meta[0])
        self.rank, self.lr, self.reg = int(meta[1]), float(meta[2]), float(meta[3])
        self.max_iter, self.ar_lags, self.seed = (int(meta[4]), int(meta[5]),
                                                  int(meta[6]))
        return self


__all__ = ["Forecaster", "LSTMForecaster", "MTNetForecaster",
           "Seq2SeqForecaster", "TCMFForecaster"]
