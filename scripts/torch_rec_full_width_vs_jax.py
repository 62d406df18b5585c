"""The recommenders' full-width recipes in the port and in the JAX package,
on the CPU, from the same JAX initial weights in f32.

1. ``chip_smoke.py`` phase 14a's Wide & Deep recipe: the synthetic
   MovieLens-1M (1,000,209 ratings, seed 0) with the reference app's
   columns, ``wide_n_deep``, hidden 40-20-10, 5 classes, an 80/20
   ``train_test_split_by_user``, batch 8192, Adam 1e-3, sparse CE,
   streaming epochs.
2. ``bench.py``'s explicit NCF recipe as phase 12 runs it: the same
   ratings, leave-one-out for the first 1000 users (1 positive + 99
   unseen negatives), default widths, batch 8192, Adam 1e-3, device-cached
   epochs of one block; HR@10 and NDCG@10 by expected rating.

After each epoch (4 by default) it prints, per package, the mean step
loss of the epoch and the held-out metric (Top-1 accuracy on the 20%, or
HR@10 and NDCG@10), and the largest parameter gap between the packages.
It gives no times. ``PERF.md`` reads phase 14a's accuracy on the card
against the JAX column here.

Run from the repository root: ``python3 scripts/torch_rec_full_width_vs_jax.py
[--epochs 4] [--only wnd|ncf]`` (a few minutes on a few CPU cores; ~3 GB).
"""

import argparse
import os
import sys

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "tests")]

import conftest  # noqa: E402,F401  (JAX on the CPU, highest matmul precision)
import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import chip_smoke as cs  # noqa: E402
from analytics_zoo_tpu.common import config as jconfig  # noqa: E402
from analytics_zoo_tpu.engine.estimator import \
    Estimator as JEstimator  # noqa: E402
from analytics_zoo_tpu.models.recommendation import \
    ColumnFeatureInfo as JColumns  # noqa: E402
from analytics_zoo_tpu.models.recommendation import \
    NeuralCF as JNCF  # noqa: E402
from analytics_zoo_tpu.models.recommendation import \
    WideAndDeep as JWide  # noqa: E402
from analytics_zoo_tpu.nn import optimizers as jopt  # noqa: E402
from analytics_zoo_tpu_torch.bridge import (params_to_numpy,  # noqa: E402
                                            state_dict_from_jax)
from analytics_zoo_tpu_torch.common.config import TrainConfig  # noqa: E402
from analytics_zoo_tpu_torch.data.datasets import (  # noqa: E402
    ML1M_ITEMS, ML1M_USERS, train_test_split_by_user)
from analytics_zoo_tpu_torch.engine.estimator import Estimator  # noqa: E402
from analytics_zoo_tpu_torch.models.recommendation import (  # noqa: E402
    NeuralCF, WideAndDeep)
from analytics_zoo_tpu_torch.nn import optimizers as topt  # noqa: E402

BATCH = 8192
LOSS = "sparse_categorical_crossentropy"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape((1,) * 6),
                ("dp", "fsdp", "tp", "sp", "pp", "ep"))


class Pair:
    """The JAX and the port Estimator on one model's JAX initial weights,
    each recording its step losses."""

    def __init__(self, jmodel, tmodel, **cfg):
        params, state = jmodel.build(jax.random.PRNGKey(0))
        tmodel.load_state_dict(state_dict_from_jax(_np(params), _np(state)))
        self.jest = JEstimator(jmodel, optimizer=jopt.Adam(lr=1e-3),
                               loss=LOSS, mesh=_mesh(),
                               config=jconfig.TrainConfig(**cfg))
        self.jest.initial_weights = (params, state)
        self.test = Estimator(tmodel, optimizer=topt.Adam(lr=1e-3),
                              loss=LOSS, config=TrainConfig(**cfg))
        self.jlosses, self.tlosses = [], []
        self._wrap()

    def _wrap(self):
        tstep = self.test._step

        def trecord(b):
            out = tstep(b)
            self.tlosses.append(out[0].detach())
            return out

        self.test._step = trecord
        jstep = self.jest._make_train_step()

        def jrecord(s, b):
            s, out = jstep(s, b)
            self.jlosses.append(out[0])
            return s, out

        self.jest._train_step = jrecord
        if self.jest.config.cache_on_device:
            block = self.jest._make_scan_block()

            def jblock(s, data, idx):
                s, out = block(s, data, idx)
                self.jlosses.extend(np.asarray(out[0]))
                return s, out

            self.jest._scan_block = jblock

    def epoch(self, data, epoch):
        """One more epoch in each package; the epoch's mean step losses."""
        nj, nt = len(self.jlosses), len(self.tlosses)
        self.jest.fit(data, batch_size=BATCH, epochs=epoch + 1)
        self.test.fit(data, batch_size=BATCH, epochs=epoch + 1)
        return (float(np.mean([float(v) for v in self.jlosses[nj:]])),
                float(np.mean([float(v) for v in self.tlosses[nt:]])))

    def param_gap(self) -> float:
        jp = _np(self.jest.train_state["params"])
        tp = params_to_numpy(self.test.model)
        return max(float(np.abs(np.asarray(v) - tp[s][l]).max())
                   for s, d in jp.items() for l, v in d.items())


def wide_and_deep(epochs):
    pairs, ratings = cs.rec_ratings()
    xs, y = cs.wnd_data(pairs, ratings)
    n = len(y)
    (tr, _), (te, _) = train_test_split_by_user(np.arange(n), np.arange(n),
                                                test_frac=0.2)
    x_tr = [np.ascontiguousarray(a[tr]) for a in xs]
    x_te = [np.ascontiguousarray(a[te]) for a in xs]
    y_tr, y_te = y[tr], y[te]
    del xs
    ci = cs.wnd_columns()
    pair = Pair(JWide(5, JColumns(**ci.to_dict()), "wide_n_deep"),
                WideAndDeep(5, ci, "wide_n_deep", device="cpu"))
    print(f"[wnd] {len(y_tr)} training rows, {len(y_te)} held out, "
          f"{len(y_tr) // BATCH} steps an epoch; f32, the JAX initial "
          f"weights in both")
    for e in range(epochs):
        jl, tl = pair.epoch((x_tr, y_tr), e)
        jacc = next(iter(pair.jest.evaluate((x_te, y_te), batch_size=BATCH,
                                            metrics=["accuracy"]).values()))
        tacc = next(iter(pair.test.evaluate((x_te, y_te), batch_size=BATCH,
                                            metrics=["accuracy"]).values()))
        print(f"[wnd] epoch {e + 1}: mean loss jax {jl:.6f} port {tl:.6f}; "
              f"Top-1 accuracy jax {float(jacc):.4f} port {float(tacc):.4f};"
              f" largest param gap {pair.param_gap():.3g}", flush=True)


def _hr_ndcg(probs, ev):
    scores = (probs @ np.arange(1, probs.shape[1] + 1, dtype=np.float32)
              ).reshape(ev.shape[0], ev.shape[1])
    rank = (scores[:, 1:] > scores[:, :1]).sum(axis=1)
    hit = rank < 10
    return float(hit.mean()), float(np.where(hit, 1 / np.log2(rank + 2),
                                             0.0).mean())


def ncf(epochs):
    x, y, ev = cs.ncf_data()
    steps = len(x) // BATCH
    pair = Pair(JNCF(ML1M_USERS, ML1M_ITEMS, 5),
                NeuralCF(ML1M_USERS, ML1M_ITEMS, 5, device="cpu"),
                cache_on_device=True, scan_block_steps=steps,
                log_every_n_steps=steps)
    print(f"[ncf] {len(x)} training pairs, {ev.shape[0]} leave-one-out "
          f"users x {ev.shape[1]} candidates, {steps} steps an epoch")
    cands = ev.reshape(-1, 2)
    for e in range(epochs):
        jl, tl = pair.epoch((x, y), e)
        jhr = _hr_ndcg(np.asarray(pair.jest.predict(cands, BATCH)), ev)
        thr = _hr_ndcg(pair.test.predict(cands, BATCH), ev)
        print(f"[ncf] epoch {e + 1}: mean loss jax {jl:.6f} port {tl:.6f}; "
              f"HR@10 jax {jhr[0]:.4f} port {thr[0]:.4f}; NDCG@10 jax "
              f"{jhr[1]:.4f} port {thr[1]:.4f}; largest param gap "
              f"{pair.param_gap():.3g}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--only", choices=("wnd", "ncf"))
    args = ap.parse_args(argv)
    if args.only in (None, "wnd"):
        wide_and_deep(args.epochs)
    if args.only in (None, "ncf"):
        ncf(args.epochs)


if __name__ == "__main__":
    main()
