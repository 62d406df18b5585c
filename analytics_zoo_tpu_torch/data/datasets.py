"""Built-in datasets (port of ``data/datasets.py``): MovieLens-1M for the
NCF workload.

A copy of the JAX package's numpy-only module, so the port owns it and
imports nothing of that package. ``movielens_1m`` reads a local
``ratings.dat`` (the MovieLens-1M ``user::movie::rating::time`` file) when
a path is given and present, and otherwise generates a synthetic dataset
of the same shape and statistics (6040 users, 3706 movies, 1,000,209
ratings, 1-5 stars). Arrays are host numpy; the same seed gives the same
arrays in both packages.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

ML1M_USERS = 6040
ML1M_ITEMS = 3706
ML1M_RATINGS = 1_000_209


def movielens_1m(path: Optional[str] = None, n_ratings: Optional[int] = None,
                 seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Return (pairs, ratings): pairs int32 (N, 2) of 1-based [user, item] ids,
    ratings int32 (N,) in 1..5."""
    if path and os.path.exists(path):
        rows = []
        with open(path, "r", encoding="latin-1") as f:
            for line in f:
                u, m, r, _ = line.strip().split("::")
                rows.append((int(u), int(m), int(r)))
        arr = np.asarray(rows, dtype="int64")
        # remap movie ids to a dense 1..n range (ML-1M ids are sparse up to 3952)
        _, dense = np.unique(arr[:, 1], return_inverse=True)
        pairs = np.stack([arr[:, 0], dense + 1], axis=1).astype("int32")
        return pairs, arr[:, 2].astype("int32")
    return synthetic_movielens(n_ratings or ML1M_RATINGS, seed=seed)


def synthetic_movielens(n_ratings: int, n_users: int = ML1M_USERS,
                        n_items: int = ML1M_ITEMS, n_classes: int = 5,
                        seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic explicit-feedback data with latent structure (so models can
    actually learn and HR@10/accuracy is meaningful, not noise).

    Users/items get latent vectors; rating = quantized affinity + noise. Zipf-like
    item popularity mimics real interaction skew.
    """
    rng = np.random.default_rng(seed)
    d = 8
    u_lat = rng.normal(size=(n_users + 1, d)).astype("float32")
    i_lat = rng.normal(size=(n_items + 1, d)).astype("float32")
    # popularity-skewed sampling (Zipf-ish)
    item_p = 1.0 / np.arange(1, n_items + 1) ** 0.8
    item_p /= item_p.sum()
    users = rng.integers(1, n_users + 1, size=n_ratings).astype("int32")
    items = (rng.choice(n_items, size=n_ratings, p=item_p) + 1).astype("int32")
    affinity = np.einsum("nd,nd->n", u_lat[users], i_lat[items]) / np.sqrt(d)
    affinity += 0.35 * rng.normal(size=n_ratings).astype("float32")
    # quantize to 1..n_classes by rank so classes are roughly balanced like ML-1M
    qs = np.quantile(affinity, np.linspace(0, 1, n_classes + 1)[1:-1])
    ratings = (np.digitize(affinity, qs) + 1).astype("int32")
    pairs = np.stack([users, items], axis=1)
    return pairs, ratings


def train_test_split_by_user(pairs: np.ndarray, ratings: np.ndarray,
                             test_frac: float = 0.1, seed: int = 0):
    """Random split (the reference notebook uses randomSplit(0.8/0.2))."""
    rng = np.random.default_rng(seed)
    n = len(pairs)
    idx = rng.permutation(n)
    cut = int(n * (1 - test_frac))
    tr, te = idx[:cut], idx[cut:]
    return (pairs[tr], ratings[tr]), (pairs[te], ratings[te])


def leave_one_out_eval_sets(pairs: np.ndarray, n_items: int, n_negatives: int = 99,
                            max_users: int = 1000, seed: int = 0) -> np.ndarray:
    """NCF-paper leave-one-out HR@10 layout: per user, 1 held-out positive +
    ``n_negatives`` sampled negatives. Returns int32 (U, 1+n_negatives, 2) pairs
    with the positive at index 0 (matches metrics.HitRate's expected layout)."""
    rng = np.random.default_rng(seed)
    by_user = {}
    for (u, i) in pairs:
        by_user.setdefault(int(u), []).append(int(i))
    users = sorted(by_user)[:max_users]
    out = np.zeros((len(users), 1 + n_negatives, 2), dtype="int32")
    for k, u in enumerate(users):
        seen = set(by_user[u])
        pos = by_user[u][-1]
        # sample WITHOUT replacement from the unseen pool: duplicates would skew
        # HR@10, and rejection sampling never terminates when seen == all items
        unseen = np.setdiff1d(np.arange(1, n_items + 1, dtype="int64"),
                              np.fromiter(seen, dtype="int64"))
        if len(unseen) >= n_negatives:
            negs = rng.choice(unseen, size=n_negatives, replace=False)
        else:  # degenerate tiny-catalog case: pad by cycling the unseen pool
            reps = int(np.ceil(n_negatives / max(len(unseen), 1)))
            negs = np.tile(unseen, reps)[:n_negatives] if len(unseen) else \
                np.full(n_negatives, pos, dtype="int64")
        out[k, 0] = (u, pos)
        out[k, 1:, 0] = u
        out[k, 1:, 1] = negs
    return out
