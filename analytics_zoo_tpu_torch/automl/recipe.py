"""Search-space recipes (port of ``automl/recipe.py``, copied): SmokeRecipe,
LSTMRandomGridRecipe, MTNetSmokeRecipe, MTNetRandomGridRecipe,
Seq2SeqRandomRecipe, RandomRecipe.

A Recipe is a search space over trial configs plus runtime parameters
(num_samples, training_iteration / epochs), over the samplers of
:mod:`.space`.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

from .space import Choice, GridSearch, Sampler, Uniform


class Recipe:
    def __init__(self):
        self.training_iteration = 1
        self.num_samples = 1

    def search_space(self, all_available_features: List[str]) -> Dict[str, Any]:
        raise NotImplementedError

    def runtime_params(self) -> Dict[str, Any]:
        return {"training_iteration": self.training_iteration,
                "num_samples": self.num_samples}


class SmokeRecipe(Recipe):
    """One-epoch single-sample sanity recipe (recipe.py SmokeRecipe parity)."""

    def search_space(self, all_available_features):
        return {
            "selected_features": json.dumps(list(all_available_features)),
            "model": "LSTM",
            "lstm_1_units": Choice([16, 32]),
            "dropout_1": Uniform(0.2, 0.5),
            "lstm_2_units": Choice([16, 32]),
            "dropout_2": Uniform(0.2, 0.5),
            "lr": 0.001,
            "batch_size": 256,
            "epochs": 1,
            "past_seq_len": 2,
        }


class LSTMRandomGridRecipe(Recipe):
    """LSTM grid over units × random dropout/lr (LSTMGridRandomRecipe parity)."""

    def __init__(self, num_rand_samples: int = 1, epochs: int = 5,
                 training_iteration: int = 1,
                 past_seq_len: int = 2,
                 lstm_1_units=(16, 32, 64), lstm_2_units=(16, 32, 64),
                 batch_size=(32, 64)):
        super().__init__()
        self.num_samples = num_rand_samples
        self.training_iteration = training_iteration
        self.epochs = epochs
        self.past_seq_len = past_seq_len
        self.lstm_1_units = list(lstm_1_units)
        self.lstm_2_units = list(lstm_2_units)
        self.batch_size = list(batch_size)

    def search_space(self, all_available_features):
        return {
            "selected_features": json.dumps(list(all_available_features)),
            "model": "LSTM",
            "lstm_1_units": GridSearch(self.lstm_1_units),
            "dropout_1": Uniform(0.2, 0.5),
            "lstm_2_units": GridSearch(self.lstm_2_units),
            "dropout_2": Uniform(0.2, 0.5),
            "lr": Uniform(1e-4, 1e-2),
            "batch_size": Choice(self.batch_size),
            "epochs": self.epochs,
            "past_seq_len": self.past_seq_len,
        }


class MTNetSmokeRecipe(Recipe):
    def search_space(self, all_available_features):
        return {
            "selected_features": json.dumps(list(all_available_features)),
            "model": "MTNet",
            "lr": 0.001,
            "batch_size": 16,
            "epochs": 1,
            "cnn_dropout": 0.2,
            "rnn_dropout": 0.2,
            "time_step": Choice([3, 4]),
            "cnn_height": 2,
            "long_num": Choice([3, 4]),
            "ar_window": Choice([2, 3]),
            "cnn_hid_size": Choice([16, 32]),
            "rnn_hid_size": 16,
        }


class MTNetRandomGridRecipe(Recipe):
    def __init__(self, num_rand_samples: int = 1, epochs: int = 5,
                 time_step=(3, 4), long_num=(3, 4), cnn_height=(2, 3),
                 training_iteration: int = 1):
        super().__init__()
        self.num_samples = num_rand_samples
        self.training_iteration = training_iteration
        self.epochs = epochs
        self.time_step = list(time_step)
        self.long_num = list(long_num)
        self.cnn_height = list(cnn_height)

    def search_space(self, all_available_features):
        return {
            "selected_features": json.dumps(list(all_available_features)),
            "model": "MTNet",
            "lr": Uniform(1e-4, 1e-2),
            "batch_size": Choice([32, 64]),
            "epochs": self.epochs,
            "cnn_dropout": Uniform(0.1, 0.4),
            "rnn_dropout": Uniform(0.1, 0.4),
            "time_step": GridSearch(self.time_step),
            "long_num": GridSearch(self.long_num),
            "cnn_height": Choice(self.cnn_height),
            "ar_window": Choice([2, 3]),
            "cnn_hid_size": Choice([16, 32, 64]),
            "rnn_hid_size": Choice([16, 32]),
        }


class Seq2SeqRandomRecipe(Recipe):
    """Random search for the encoder/decoder forecaster (future_seq_len > 1)."""

    def __init__(self, num_rand_samples: int = 2, epochs: int = 5,
                 past_seq_len: int = 8, training_iteration: int = 1):
        super().__init__()
        self.num_samples = num_rand_samples
        self.training_iteration = training_iteration
        self.epochs = epochs
        self.past_seq_len = past_seq_len

    def search_space(self, all_available_features):
        return {
            "selected_features": json.dumps(list(all_available_features)),
            "model": "Seq2Seq",
            "latent_dim": Choice([32, 64, 128]),
            "dropout": Uniform(0.1, 0.4),
            "lr": Uniform(1e-4, 1e-2),
            "batch_size": Choice([32, 64]),
            "epochs": self.epochs,
            "past_seq_len": self.past_seq_len,
        }


class RandomRecipe(Recipe):
    """Pure random search over the LSTM space (recipe.py RandomRecipe parity),
    including random feature-subset selection."""

    def __init__(self, num_rand_samples: int = 1, epochs: int = 5,
                 look_back: int = 2, training_iteration: int = 1):
        super().__init__()
        self.num_samples = num_rand_samples
        self.training_iteration = training_iteration
        self.epochs = epochs
        self.look_back = look_back

    def search_space(self, all_available_features):
        return {
            "selected_features": _FeatureSubset(list(all_available_features)),
            "model": "LSTM",
            "lstm_1_units": Choice([8, 16, 32, 64, 128]),
            "dropout_1": Uniform(0.2, 0.5),
            "lstm_2_units": Choice([8, 16, 32, 64, 128]),
            "dropout_2": Uniform(0.2, 0.5),
            "lr": Uniform(1e-4, 1e-1),
            "batch_size": Choice([32, 64, 1024]),
            "epochs": self.epochs,
            "past_seq_len": self.look_back,
        }


class _FeatureSubset(Sampler):
    """Sampler drawing a random non-empty subset of candidate features."""

    def __init__(self, features: List[str]):
        self.features = features

    def sample(self, rng):
        if not self.features:
            return json.dumps([])
        mask = rng.random(len(self.features)) < 0.5
        if not mask.any():
            mask[int(rng.integers(len(self.features)))] = True
        return json.dumps([f for f, m in zip(self.features, mask) if m])


__all__ = ["LSTMRandomGridRecipe", "MTNetRandomGridRecipe", "MTNetSmokeRecipe",
           "RandomRecipe", "Recipe", "Seq2SeqRandomRecipe", "SmokeRecipe"]
