"""Trial search engine (port of ``automl/search.py``, host code copied):
the rebuild of ``RayTuneSearchEngine``.

Trials run in-process, optionally on a thread pool of ``max_workers``;
each trial's model keeps its own estimator state, so concurrent trials on
one device give what serial trials give. Config sampling uses a seeded
generator and each trial gets a reproducible seed. Median stopping across
reporting rounds replaces Ray Tune's schedulers; ``search_alg="tpe"``
runs trials sequentially on TPE suggestions.
"""

from __future__ import annotations

import concurrent.futures as cf
import copy
import logging
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .metrics import Evaluator
from .space import grid_product, sample_config

log = logging.getLogger("analytics_zoo_tpu_torch.automl")


@dataclass
class TrialResult:
    config: Dict[str, Any]
    metric: float                      # raw metric value (e.g. mse)
    reward: float                      # larger-is-better
    history: List[float] = field(default_factory=list)
    trial_id: int = 0
    stopped_early: bool = False
    error: Optional[str] = None


class Trial:
    """One trial: owns a model instance and reports a metric per round.

    ``trainable(config) -> fn()`` protocol: the factory returns a zero-arg
    callable; each invocation trains one round (``training_iteration`` parity)
    and returns the raw metric value.
    """

    def __init__(self, trial_id: int, config: Dict[str, Any],
                 round_fn: Callable[[], float], metric: str):
        self.trial_id = trial_id
        self.config = config
        self.round_fn = round_fn
        self.metric = metric
        self.history: List[float] = []

    def run_round(self) -> float:
        value = float(self.round_fn())
        self.history.append(value)
        return value


class SearchEngine:
    """Random + grid search with median stopping.

    Args:
        trainable: ``trainable(config, trial_seed) -> round_fn`` where
            ``round_fn()`` trains one round and returns the raw metric.
        metric: metric name (determines reward direction via Evaluator).
        num_samples: random samples per grid point (RayTune ``num_samples``).
        training_iteration: rounds per trial.
        max_workers: concurrent trials (threads).
        grace_rounds: rounds before median stopping can trigger.
    """

    def __init__(self, trainable, metric: str = "mse", num_samples: int = 1,
                 training_iteration: int = 1, max_workers: int = 1,
                 grace_rounds: int = 1, seed: int = 0,
                 search_alg: str = "random", n_initial: int = 4):
        self.trainable = trainable
        self.metric = metric
        self.num_samples = int(num_samples)
        self.training_iteration = max(1, int(training_iteration))
        self.max_workers = max(1, int(max_workers))
        self.grace_rounds = int(grace_rounds)
        self.seed = int(seed)
        if search_alg not in ("random", "tpe"):
            raise ValueError(f"unknown search_alg {search_alg!r}")
        self.search_alg = search_alg
        self.n_initial = int(n_initial)
        self.results: List[TrialResult] = []

    # ------------------------------------------------------------------ configs
    def _draw_configs(self, space: Dict[str, Any],
                      fixed: Optional[Dict[str, Any]]) -> List[Dict[str, Any]]:
        rng = np.random.default_rng(self.seed)
        configs = []
        for grid_part in grid_product(space):
            merged_fixed = dict(fixed or {})
            merged_fixed.update(grid_part)
            for _ in range(self.num_samples):
                configs.append(sample_config(space, rng, fixed=merged_fixed))
        return configs

    # ------------------------------------------------------------------- search
    def run(self, space: Dict[str, Any],
            fixed: Optional[Dict[str, Any]] = None) -> TrialResult:
        """Round-robin over trials with a barrier per reporting round: after each
        round, trials whose reward falls below the round median are pruned
        (median-stopping — the reference's Ray Tune scheduler capability).
        ``search_alg='tpe'`` instead runs trials sequentially, each config
        suggested from the history (HyperOptSearch capability)."""
        if self.search_alg == "tpe":
            return self._run_tpe(space, fixed)
        configs = self._draw_configs(space, fixed)
        n = len(configs)
        failed: List[TrialResult] = []
        trials: List[Trial] = []
        for tid, config in enumerate(configs):
            try:
                round_fn = self.trainable(copy.deepcopy(config),
                                          trial_seed=self.seed * 10007 + tid)
                trials.append(Trial(tid, config, round_fn, self.metric))
            except Exception as e:
                log.warning("trial %d setup failed: %s", tid, e)
                failed.append(TrialResult(config=config, metric=float("inf"),
                                          reward=float("-inf"), trial_id=tid,
                                          error=str(e)))

        alive = list(trials)
        stopped: Dict[int, bool] = {}

        def run_one(trial: Trial):
            try:
                return trial, trial.run_round(), None
            except Exception as e:
                log.warning("trial %d failed: %s", trial.trial_id, e)
                return trial, None, str(e)

        errors: Dict[int, str] = {}
        for rnd in range(self.training_iteration):
            if not alive:
                break
            if self.max_workers > 1 and len(alive) > 1:
                with cf.ThreadPoolExecutor(max_workers=self.max_workers) as pool:
                    outcomes = list(pool.map(run_one, alive))
            else:
                outcomes = [run_one(t) for t in alive]
            survivors, rewards = [], []
            for trial, value, err in outcomes:
                if err is not None:
                    errors[trial.trial_id] = err
                    continue
                survivors.append(trial)
                rewards.append(Evaluator.reward(self.metric, value))
            alive = survivors
            if (rnd + 1 > self.grace_rounds and len(alive) >= 3
                    and rnd + 1 < self.training_iteration):
                med = float(np.median(rewards))
                pruned = [t for t, r in zip(alive, rewards) if r < med]
                alive = [t for t, r in zip(alive, rewards) if r >= med]
                for t in pruned:
                    stopped[t.trial_id] = True

        self.results = list(failed)
        for trial in trials:
            if trial.trial_id in errors:
                self.results.append(TrialResult(
                    config=trial.config, metric=float("inf"),
                    reward=float("-inf"), history=trial.history,
                    trial_id=trial.trial_id, error=errors[trial.trial_id]))
            elif trial.history:
                final = trial.history[-1]
                self.results.append(TrialResult(
                    config=trial.config, metric=final,
                    reward=Evaluator.reward(self.metric, final),
                    history=trial.history, trial_id=trial.trial_id,
                    stopped_early=stopped.get(trial.trial_id, False)))
        self.results.sort(key=lambda r: r.trial_id)

        ok = [r for r in self.results if r.error is None]
        if not ok:
            errs = {r.trial_id: r.error for r in self.results}
            raise RuntimeError(f"all {n} trials failed: {errs}")
        best = max(ok, key=lambda r: r.reward)
        log.info("search done: %d trials, best %s=%.6g (trial %d)",
                 n, self.metric, best.metric, best.trial_id)
        return best

    # --------------------------------------------------------------------- tpe
    def _run_tpe(self, space: Dict[str, Any],
                 fixed: Optional[Dict[str, Any]]) -> TrialResult:
        """Sequential model-based search: the first ``n_initial`` configs are
        random, every later one maximizes the TPE good/bad density ratio over
        completed-trial rewards. Grid dims are expanded as usual; the trial
        budget is ``num_samples`` per grid point."""
        from .tpe import tpe_suggest

        rng = np.random.default_rng(self.seed)
        self.results = []
        tid = 0
        for grid_part in grid_product(space):
            merged_fixed = dict(fixed or {})
            merged_fixed.update(grid_part)
            history: List[tuple] = []
            for i in range(self.num_samples):
                if i < self.n_initial or len(history) < 2:
                    config = sample_config(space, rng, fixed=merged_fixed)
                else:
                    config = tpe_suggest(space, history, rng,
                                         fixed=merged_fixed)
                try:
                    round_fn = self.trainable(
                        copy.deepcopy(config),
                        trial_seed=self.seed * 10007 + tid)
                    trial = Trial(tid, config, round_fn, self.metric)
                    for _ in range(self.training_iteration):
                        value = trial.run_round()
                    reward = Evaluator.reward(self.metric, value)
                    history.append((config, reward))
                    self.results.append(TrialResult(
                        config=config, metric=value, reward=reward,
                        history=trial.history, trial_id=tid))
                except Exception as e:
                    log.warning("tpe trial %d failed: %s", tid, e)
                    self.results.append(TrialResult(
                        config=config, metric=float("inf"),
                        reward=float("-inf"), trial_id=tid, error=str(e)))
                tid += 1
        ok = [r for r in self.results if r.error is None]
        if not ok:
            raise RuntimeError(f"all {tid} tpe trials failed")
        best = max(ok, key=lambda r: r.reward)
        log.info("tpe search done: %d trials, best %s=%.6g (trial %d)",
                 tid, self.metric, best.metric, best.trial_id)
        return best


__all__ = ["SearchEngine", "Trial", "TrialResult"]
