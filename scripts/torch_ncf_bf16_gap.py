"""Where the bf16 NeuralCF masters of the port and the JAX package part.

``tests/test_torch_ncf.py::test_bf16_fit_matches_jax_within_bf16_tolerance``
holds the port's f32 masters after a bf16, device-cached fit to the JAX
package's by what training moved them: per leaf, ``|dport - djax| /
|djax|`` (L2 norms of master - initial weight). This script prints, at the
test's sizes and on the CPU:

1. that gap per leaf for the port against JAX, worst and median leaf;
2. the same gap for JAX's own bf16 fit against JAX's f32 fit (the drift
   bf16 rounding alone causes in one package) and for the port's f32 fit
   against JAX's f32 fit;
3. the step-0 gradients of the two packages compared directly, per leaf
   (relative L2 difference), in bf16 and in f32;
4. the gap for the port with a planted optimizer fault each, against the
   true JAX fit: no Adam bias correction, Adam run in bf16 (gradients
   not cast up, moments kept in bf16), masters rounded to bf16 after each
   update (no f32 masters), beta1 0.8 for 0.9, the learning rate halved;
5. for the true port and under each planted fault, what
   ``test_bf16_update_matches_jax_on_the_same_gradients`` holds: the
   largest master error after four bf16 steps fed the same gradients in
   both packages (limit 1e-6), and how many bf16 params differ (limit 0).

Run from the repository root: ``python3 scripts/torch_ncf_bf16_gap.py``
(about a minute on a few CPU cores).
"""

import contextlib
import os
import sys

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "tests")]

import conftest  # noqa: E402,F401  (JAX on the CPU, highest matmul precision)
import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_ncf as T  # noqa: E402
from analytics_zoo_tpu.common import config as jconfig  # noqa: E402
from analytics_zoo_tpu.engine.estimator import Estimator as JEstimator  # noqa: E402
from analytics_zoo_tpu.nn import optimizers as jopt  # noqa: E402
from analytics_zoo_tpu_torch.common.config import TrainConfig  # noqa: E402
from analytics_zoo_tpu_torch.engine.estimator import Estimator  # noqa: E402
from analytics_zoo_tpu_torch.nn import optimizers as topt  # noqa: E402
from analytics_zoo_tpu_torch.parallel import update_sharding  # noqa: E402

BF16 = dict(compute_dtype="bfloat16", cache_on_device=True,
            scan_block_steps=15)
F32 = dict(cache_on_device=True, scan_block_steps=15)
LR = 0.01
FAULTS = ("no bias correction", "Adam in bf16", "no f32 masters",
          "beta1 0.8", "lr halved")


def _losses(kind):
    if kind == "implicit":
        return T.j_bce, T.implicit_bce_loss
    return ("sparse_categorical_crossentropy",) * 2


def _moved(master, init):
    return {f"{s}.{l}": np.asarray(v, np.float32) - init[s][l]
            for s, leaves in master.items() for l, v in leaves.items()}


def _gap(moved, ref):
    return {n: float(np.linalg.norm(moved[n] - ref[n])
                     / np.linalg.norm(ref[n])) for n in ref}


def _summary(gap):
    worst = max(gap, key=gap.get)
    return (f"worst {gap[worst]:.4f} ({worst}), "
            f"median {float(np.median(list(gap.values()))):.4f}")


def _port_moved(kind, init, cfg):
    _, _, tm = T._models(kind)
    _, tloss = _losses(kind)
    _, est = T._port_fit(tm, T._data(kind, T_RATINGS), tloss, 2, LR, **cfg)
    if cfg.get("compute_dtype"):
        master = est.train_state["opt_state"].master
    else:
        master = dict(tm.named_parameters())
    out = {}
    for n, v in master.items():
        s, l = n.split(".", 1)
        out[n] = v.detach().float().numpy() - init[s][l]
    return out


def _jax_moved(kind, params, init, cfg):
    jm, _, _ = T._models(kind)
    jloss, _ = _losses(kind)
    _, jparams, _, jest = T._jax_fit(jm, params, T._data(kind, T_RATINGS),
                                     jloss, 2, LR, **cfg)
    if cfg.get("compute_dtype"):
        return _moved(T._np(jest.train_state["opt_state"].master), init)
    return _moved(jparams, init)


def _step0_grads(kind, cfg):
    """Each package's gradient of the first batch of the fit, from the
    same weights, under the same step key."""
    jm, params, tm = T._models(kind)
    jloss, tloss = _losses(kind)
    x, y = (a[:T.BATCH] for a in T._data(kind, T_RATINGS))
    jest = JEstimator(jm, optimizer=jopt.Adam(lr=LR), loss=jloss,
                      mesh=T._one_device_mesh(),
                      config=jconfig.TrainConfig(**cfg))
    jest.initial_weights = (params, {})
    state = jest._init_state((x, y), seed=0)
    key = jax.random.fold_in(state["rng"], 0)
    grads_fn = jest._with_policy(jax.jit(jest._grads_fn()))
    _, _, jg = grads_fn(state["params"], state["model_state"], key, (x, y))
    est = Estimator(tm, optimizer=topt.Adam(lr=LR), loss=tloss,
                    config=TrainConfig(**cfg))
    est._init_state(0)
    tm.train()
    with est._policy():
        _, tg = est._grads((torch.from_numpy(x), torch.from_numpy(y)),
                           est._step_key())
    jg = {f"{s}.{l}": np.asarray(v, np.float32)
          for s, leaves in T._np(jg).items() for l, v in leaves.items()}
    return {n: float(np.linalg.norm(tg[n].float().numpy() - jg[n])
                     / np.linalg.norm(jg[n])) for n in jg}


@contextlib.contextmanager
def _planted(fault):
    """Patch one fault into the port's optimizer for the extent of the
    block."""
    saved = []

    def patch(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    if fault == "no bias correction":
        patch(topt, "_bias_correction", lambda decay, count: 1.0)
    elif fault == "Adam in bf16":
        adam = topt.scale_by_adam

        def bf16_adam(*a, **k):
            inner = adam(*a, **k)

            def update(g, state, params=None):
                g = {n: x.bfloat16() for n, x in g.items()}
                mu = {n: (1 - 0.9) * x + 0.9 * state.mu[n].bfloat16()
                      for n, x in g.items()}
                nu = {n: (1 - 0.999) * (x ** 2) + 0.999
                      * state.nu[n].bfloat16() for n, x in g.items()}
                count = state.count + 1
                c1 = topt._bias_correction(0.9, count)
                c2 = topt._bias_correction(0.999, count)
                out = {n: ((mu[n] / c1) / (torch.sqrt(nu[n] / c2) + 1e-8))
                       .float() for n in g}
                return out, topt.ScaleByAdamState(count, mu, nu)

            return topt.GradientTransformation(inner.init, update)

        patch(topt, "scale_by_adam", bf16_adam)
    elif fault == "no f32 masters":
        wrap = update_sharding.with_master_weights

        def bf16_masters(tx):
            inner = wrap(tx)

            def update(grads, state, params=None):
                new, st = inner.update(grads, state, params)
                master = {n: m.to(torch.bfloat16).float()
                          for n, m in st.master.items()}
                return new, type(st)(st.inner_state, master)

            return topt.GradientTransformation(inner.init, update)

        import analytics_zoo_tpu_torch.engine.estimator as E
        patch(E, "with_master_weights", bf16_masters)
    elif fault == "lr halved":
        adam = topt.Adam
        patch(topt, "Adam", lambda lr=1e-3, *a, **k: adam(lr / 2, *a, **k))
    elif fault == "beta1 0.8":
        adam = topt.scale_by_adam
        patch(topt, "scale_by_adam",
              lambda b1=0.9, *a, **k: adam(0.8, *a, **k))
    try:
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)


def _same_grads(kind):
    (masters, params, _), (jmasters, jparams, _) = \
        T._bf16_steps_on_given_grads(kind)
    err = max(float(np.abs(masters[n] - jmasters[n]).max()) for n in jmasters)
    diff = sum(int((params[n] != jparams[n]).sum()) for n in jparams)
    return f"master err {err:.3g}, bf16 params differing {diff}"


def main():
    global T_RATINGS
    pairs, r = T.tdata.synthetic_movielens(T.N_RATINGS, n_users=T.USERS,
                                           n_items=T.ITEMS, seed=1)
    T_RATINGS = pairs, (r - 1).astype(np.int32)
    torch.set_num_threads(4)
    for kind in ("explicit", "implicit"):
        _, params, _ = T._models(kind)
        init = T._np(params)
        jax_bf16 = _jax_moved(kind, params, init, BF16)
        jax_f32 = _jax_moved(kind, params, init, F32)
        print(f"[{kind}] port bf16 vs JAX bf16: "
              f"{_summary(_gap(_port_moved(kind, init, BF16), jax_bf16))}")
        print(f"[{kind}] JAX bf16 vs JAX f32:   "
              f"{_summary(_gap(jax_bf16, jax_f32))}")
        print(f"[{kind}] port f32 vs JAX f32:   "
              f"{_summary(_gap(_port_moved(kind, init, F32), jax_f32))}")
        print(f"[{kind}] step-0 grads bf16:     "
              f"{_summary(_step0_grads(kind, dict(compute_dtype='bfloat16')))}")
        print(f"[{kind}] step-0 grads f32:      "
              f"{_summary(_step0_grads(kind, {}))}")
        for fault in FAULTS:
            with _planted(fault):
                moved = _port_moved(kind, init, BF16)
            print(f"[{kind}] planted {fault + ':':22s} "
                  f"{_summary(_gap(moved, jax_bf16))}")
        print(f"[{kind}] same grads, true port:          {_same_grads(kind)}")
        for fault in FAULTS:
            with _planted(fault):
                print(f"[{kind}] same grads, planted {fault + ':':22s}"
                      f"{_same_grads(kind)}")


if __name__ == "__main__":
    main()
