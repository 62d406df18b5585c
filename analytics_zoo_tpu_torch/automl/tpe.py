"""TPE (tree-structured Parzen estimator) suggestion (port of
``automl/tpe.py``, numpy, copied): the search-algorithm capability the
reference gets from Ray Tune's ``HyperOptSearch``.

Past trials split into good/bad by reward quantile ``gamma``; numeric dims
get Parzen windows (log-space for LogUniform), categoricals smoothed
frequency ratios; candidates drawn from the good density are ranked by
``l_good(x) / l_bad(x)`` (Bergstra et al. 2011).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from .space import (Choice, GridSearch, LogUniform, QUniform, RandInt, Sampler,
                    sample_config)


def _split(history: List[Tuple[Dict[str, Any], float]], gamma: float):
    ordered = sorted(history, key=lambda h: -h[1])
    n_good = max(1, int(np.ceil(gamma * len(ordered))))
    good = [c for c, _ in ordered[:n_good]]
    bad = [c for c, _ in ordered[n_good:]] or [ordered[-1][0]]
    return good, bad


def _kde_logpdf(x: float, obs: Sequence[float], lo: float, hi: float) -> float:
    obs = np.asarray(obs, dtype=np.float64)
    span = max(hi - lo, 1e-12)
    bw = max(span / max(np.sqrt(len(obs)), 1.0), 1e-3 * span)
    z = (x - obs) / bw
    dens = np.mean(np.exp(-0.5 * z * z) / (bw * np.sqrt(2 * np.pi)))
    return float(np.log(dens + 1e-300))


def _dim_bounds(dim) -> Tuple[float, float, bool]:
    """(lo, hi, in_log_space) for a numeric sampler."""
    if isinstance(dim, LogUniform):
        return np.log(dim.low), np.log(dim.high), True
    return dim.low, dim.high, False


def _to_axis(dim, v: float) -> float:
    return float(np.log(v)) if isinstance(dim, LogUniform) else float(v)


def _from_axis(dim, t: float):
    if isinstance(dim, LogUniform):
        return float(np.exp(t))
    if isinstance(dim, RandInt):
        return int(np.clip(round(t), dim.low, dim.high - 1))
    if isinstance(dim, QUniform):
        return float(np.clip(np.round(t / dim.q) * dim.q, dim.low, dim.high))
    return float(np.clip(t, dim.low, dim.high))


def tpe_suggest(space: Dict[str, Any],
                history: List[Tuple[Dict[str, Any], float]],
                rng: np.random.Generator, gamma: float = 0.25,
                n_candidates: int = 24,
                fixed: Dict[str, Any] = None) -> Dict[str, Any]:
    """Suggest one config. With fewer than 2 observations (or an empty
    numeric/categorical split) this degrades to a random sample."""
    if len(history) < 2:
        return sample_config(space, rng, fixed=fixed)
    good, bad = _split(history, gamma)
    out = dict(fixed or {})
    for key, dim in space.items():
        if key in out:
            continue
        if isinstance(dim, GridSearch):
            raise ValueError(
                f"grid dim {key!r} must be pre-expanded into `fixed` "
                "(see grid_product)")
        if not isinstance(dim, Sampler):
            out[key] = dim
            continue
        g_obs = [c[key] for c in good if key in c]
        b_obs = [c[key] for c in bad if key in c]
        if not g_obs or not b_obs:
            out[key] = dim.sample(rng)
            continue
        if isinstance(dim, Choice):
            # smoothed frequency ratio over the categorical values
            vals = dim.values
            gc = np.array([g_obs.count(v) + 1.0 for v in vals])
            bc = np.array([b_obs.count(v) + 1.0 for v in vals])
            score = (gc / gc.sum()) / (bc / bc.sum())
            # sample from the good distribution, tilted by the ratio
            p = gc / gc.sum() * score
            p /= p.sum()
            out[key] = vals[int(rng.choice(len(vals), p=p))]
            continue
        lo, hi, _logspace = _dim_bounds(dim)
        g_axis = [_to_axis(dim, v) for v in g_obs]
        b_axis = [_to_axis(dim, v) for v in b_obs]
        # candidates from the good Parzen mixture + a couple of uniform probes
        # so the search never collapses onto one mode
        span = max(hi - lo, 1e-12)
        bw = max(span / max(np.sqrt(len(g_axis)), 1.0), 1e-3 * span)
        centers = rng.choice(g_axis, size=max(n_candidates - 2, 1))
        cands = list(centers + rng.normal(0.0, bw, size=len(centers)))
        cands += list(rng.uniform(lo, hi, size=2))
        best_t, best_score = None, -np.inf
        for t in cands:
            t = float(np.clip(t, lo, hi))
            s = _kde_logpdf(t, g_axis, lo, hi) - _kde_logpdf(t, b_axis, lo, hi)
            if s > best_score:
                best_t, best_score = t, s
        out[key] = _from_axis(dim, best_t)
    return out


__all__ = ["tpe_suggest"]
