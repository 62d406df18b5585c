"""Time-sequence feature engineering (port of ``automl/feature.py``, host
code copied): ``TimeSequenceFeatureTransformer``.

Pipeline: datetime feature generation → feature selection (per trial
config) → standard scaling → rolling windows:
``x: (N, past_seq_len, n_features)``, ``y: (N, future_seq_len)``. The
calendar features are the reference's: HOUR / DAY / WEEKDAY / MONTH /
MINUTE / IS_WEEKEND / IS_AWAKE(6-23) / IS_BUSY_HOURS(7-9,16-19). pandas is
imported inside the methods that read a DataFrame.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

_CAL_FEATURES = ["HOUR", "DAY", "WEEKDAY", "MONTH", "MINUTE",
                 "IS_WEEKEND", "IS_AWAKE", "IS_BUSY_HOURS"]


def _roll(data: np.ndarray, window: int) -> np.ndarray:
    """(T, F) -> (T-window+1, window, F) sliding windows (stride 1)."""
    n = data.shape[0] - window + 1
    if n <= 0:
        raise ValueError(f"series length {data.shape[0]} < window {window}")
    idx = np.arange(window)[None, :] + np.arange(n)[:, None]
    return data[idx]


class TimeSequenceFeatureTransformer:
    def __init__(self, future_seq_len: int = 1, dt_col: str = "datetime",
                 target_col: str = "value", extra_features_col: Optional[List[str]] = None,
                 drop_missing: bool = True):
        self.future_seq_len = int(future_seq_len)
        self.dt_col = dt_col
        self.target_col = target_col
        self.extra_features_col = list(extra_features_col or [])
        self.drop_missing = drop_missing
        self.past_seq_len: Optional[int] = None
        self.selected_features: Optional[List[str]] = None
        self.scale_mean: Optional[np.ndarray] = None
        self.scale_std: Optional[np.ndarray] = None

    # ------------------------------------------------------------------ features
    def get_feature_list(self, input_df) -> List[str]:
        """All candidate feature names (calendar + extra cols) for a recipe."""
        return _CAL_FEATURES + list(self.extra_features_col)

    def _check_input(self, input_df, mode: str = "train"):
        import pandas as pd
        if not isinstance(input_df, pd.DataFrame):
            raise ValueError("input must be a pandas DataFrame")
        if self.dt_col not in input_df.columns:
            raise ValueError(f"missing datetime column {self.dt_col!r}")
        # the target column is required even at predict time: column 0 of every
        # window is the past target history (autoregressive input)
        if self.target_col not in input_df.columns:
            raise ValueError(f"missing target column {self.target_col!r}")

    def _generate_calendar(self, dt) -> Dict[str, np.ndarray]:
        hour = dt.dt.hour.to_numpy()
        weekday = dt.dt.dayofweek.to_numpy()
        return {
            "HOUR": hour.astype(np.float64),
            "DAY": dt.dt.day.to_numpy().astype(np.float64),
            "WEEKDAY": weekday.astype(np.float64),
            "MONTH": dt.dt.month.to_numpy().astype(np.float64),
            "MINUTE": dt.dt.minute.to_numpy().astype(np.float64),
            "IS_WEEKEND": (weekday >= 5).astype(np.float64),
            "IS_AWAKE": ((hour >= 6) & (hour <= 23)).astype(np.float64),
            "IS_BUSY_HOURS": (((hour >= 7) & (hour <= 9)) |
                              ((hour >= 16) & (hour <= 19))).astype(np.float64),
        }

    def _feature_matrix(self, input_df, features: List[str], with_target: bool):
        import pandas as pd
        df = input_df.copy()
        if self.drop_missing:
            df = df.dropna(subset=[c for c in [self.target_col] + self.extra_features_col
                                   if c in df.columns])
        dt = pd.to_datetime(df[self.dt_col])
        cal = self._generate_calendar(dt)
        cols = []
        # column 0 is always the (past) target value — matches the reference's
        # "value plus several features" layout (time_sequence_predictor.py:42-44)
        if with_target:
            cols.append(df[self.target_col].to_numpy(dtype=np.float64))
        for f in features:
            if f in cal:
                cols.append(cal[f])
            elif f in df.columns:
                cols.append(df[f].to_numpy(dtype=np.float64))
            else:
                raise ValueError(f"unknown feature {f!r}")
        return np.stack(cols, axis=1), dt

    # ------------------------------------------------------------------ fit/transform
    def fit_transform(self, input_df, **config) -> Tuple[np.ndarray, np.ndarray]:
        self._check_input(input_df)
        self.past_seq_len = int(config.get("past_seq_len", 2))
        feats = config.get("selected_features", self.get_feature_list(input_df))
        if isinstance(feats, str):
            feats = json.loads(feats)
        self.selected_features = list(feats)
        mat, _ = self._feature_matrix(input_df, self.selected_features, with_target=True)
        self.scale_mean = mat.mean(axis=0)
        self.scale_std = mat.std(axis=0) + 1e-9
        return self._tensorize(mat, train=True)

    def transform(self, input_df, is_train: bool = True):
        if self.selected_features is None:
            raise RuntimeError("transformer not fitted")
        self._check_input(input_df, mode="train" if is_train else "predict")
        mat, _ = self._feature_matrix(input_df, self.selected_features,
                                      with_target=True)
        return self._tensorize(mat, train=is_train)

    def _tensorize(self, mat: np.ndarray, train: bool):
        scaled = (mat - self.scale_mean) / self.scale_std
        if train:
            total = self.past_seq_len + self.future_seq_len
            windows = _roll(scaled, total)
            x = windows[:, :self.past_seq_len, :]
            y = windows[:, self.past_seq_len:, 0]
            return x, y
        x = _roll(scaled, self.past_seq_len)
        return x, None

    # ------------------------------------------------------------------ inverse
    def unscale(self, y: np.ndarray) -> np.ndarray:
        """Inverse-scale predictions back to target units (column 0)."""
        return y * self.scale_std[0] + self.scale_mean[0]

    def unscale_uncertainty(self, y_std: np.ndarray) -> np.ndarray:
        return y_std * self.scale_std[0]

    def post_processing(self, input_df, y_pred: np.ndarray, is_train: bool):
        """Unscale + attach forecast datetimes (reference :230-278 behavior).

        Window i covers rows ``i..i+past_seq_len-1`` and predicts the NEXT step,
        so its timestamp is the window's last datetime plus one series period
        (matching the training alignment in :meth:`_tensorize`). Datetimes come
        from the same NaN-dropped frame the windows were built from.
        """
        import pandas as pd
        y_unscale = self.unscale(y_pred)
        if is_train:
            return y_unscale
        _, dt = self._feature_matrix(input_df, self.selected_features,
                                     with_target=True)
        delta = dt.diff().mode().iloc[0] if len(dt) > 1 else pd.Timedelta(0)
        out_dt = (dt.iloc[self.past_seq_len - 1:] + delta).reset_index(drop=True)
        cols = {self.dt_col: out_dt}
        if y_unscale.ndim == 1:
            y_unscale = y_unscale[:, None]
        for i in range(y_unscale.shape[1]):
            cols[f"{self.target_col}_{i}" if y_unscale.shape[1] > 1
                 else self.target_col] = y_unscale[:, i]
        return pd.DataFrame(cols)

    # ------------------------------------------------------------------ persistence
    def save(self, file_path: str):
        os.makedirs(os.path.dirname(file_path) or ".", exist_ok=True)
        cfg = {
            "future_seq_len": self.future_seq_len, "dt_col": self.dt_col,
            "target_col": self.target_col, "extra_features_col": self.extra_features_col,
            "drop_missing": self.drop_missing, "past_seq_len": self.past_seq_len,
            "selected_features": self.selected_features,
            "scale_mean": None if self.scale_mean is None else self.scale_mean.tolist(),
            "scale_std": None if self.scale_std is None else self.scale_std.tolist(),
        }
        with open(file_path, "w") as f:
            json.dump(cfg, f)

    def restore(self, file_path: str = None, **config):
        if file_path is not None:
            with open(file_path) as f:
                config = json.load(f)
        self.future_seq_len = config["future_seq_len"]
        self.dt_col = config["dt_col"]
        self.target_col = config["target_col"]
        self.extra_features_col = config["extra_features_col"]
        self.drop_missing = config["drop_missing"]
        self.past_seq_len = config["past_seq_len"]
        self.selected_features = config["selected_features"]
        self.scale_mean = np.asarray(config["scale_mean"]) if config["scale_mean"] else None
        self.scale_std = np.asarray(config["scale_std"]) if config["scale_std"] else None
        return self


__all__ = ["TimeSequenceFeatureTransformer"]
