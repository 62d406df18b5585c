"""The port's optimizers, schedules, clipping and losses against the JAX
package's (optax underneath), on the CPU.

Every optimizer of the JAX package (SGD, Adam, AdamW, RMSprop, Adagrad,
Adadelta, Adamax, LARS) runs 5 steps on the same params and the same
seeded gradients in both packages; params, and the updates of each step,
must agree within 1e-6 (f32). Schedules are compared value by value, and
every loss of ``nn/losses.py`` on the same inputs within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from analytics_zoo_tpu.nn import losses as jlosses
from analytics_zoo_tpu.nn import optimizers as jopt
from analytics_zoo_tpu_torch.nn import losses as tlosses
from analytics_zoo_tpu_torch.nn import optimizers as topt
from analytics_zoo_tpu_torch.parallel.update_sharding import \
    with_master_weights

TOL = 1e-6
SHAPES = {"w": (3, 4), "b": (4,), "emb": (5, 2)}

OPTIMIZERS = {
    "sgd": lambda m: m.SGD(lr=0.1),
    "sgd-momentum": lambda m: m.SGD(lr=0.1, momentum=0.9),
    "sgd-nesterov": lambda m: m.SGD(lr=0.1, momentum=0.9, nesterov=True),
    "sgd-decay": lambda m: m.SGD(lr=0.1, weight_decay=0.01),
    "adam": lambda m: m.Adam(lr=1e-2),
    "adam-betas": lambda m: m.Adam(lr=3e-3, beta_1=0.8, beta_2=0.99,
                                   epsilon=1e-6),
    "adam-poly": lambda m: m.Adam(lr=m.poly(1e-2, 2.0, 4)),
    "adam-exp": lambda m: m.Adam(lr=m.exponential_decay(1e-2, 0.5, 2)),
    "adam-exp-stair": lambda m: m.Adam(
        lr=m.exponential_decay(1e-2, 0.5, 2, staircase=True)),
    "adam-warmup": lambda m: m.Adam(lr=m.warmup_linear(1e-2, 2, 5)),
    "adam-fixed": lambda m: m.Adam(lr=m.fixed(2e-3)),
    "adamw": lambda m: m.AdamWeightDecay(lr=1e-2, weight_decay=0.1),
    "adamw-warmup": lambda m: m.AdamWeightDecay(lr=1e-2, warmup_portion=0.4,
                                                total=5),
    "clip-norm": lambda m: m.with_clipping(m.Adam(lr=1e-2), clip_norm=0.5),
    "clip-norm-loose": lambda m: m.with_clipping(m.SGD(lr=0.1),
                                                 clip_norm=100.0),
    "clip-range": lambda m: m.with_clipping(m.SGD(lr=0.1),
                                            clip_value=(-0.1, 0.2)),
    "clip-both": lambda m: m.with_clipping(m.Adam(lr=1e-2), clip_norm=0.7,
                                           clip_value=(-0.3, 0.3)),
    "by-name-adam": lambda m: m.get_optimizer("adam"),
    "by-name-sgd": lambda m: m.get_optimizer("sgd"),
    "by-name-adamw": lambda m: m.get_optimizer("adamw"),
    "rmsprop": lambda m: m.RMSprop(lr=1e-2, decay_rate=0.8, epsilon=1e-6),
    "adagrad": lambda m: m.Adagrad(lr=0.1),
    "adadelta": lambda m: m.Adadelta(lr=1.0, rho=0.9),
    "adamax": lambda m: m.Adamax(lr=m.poly(1e-2, 2.0, 4)),
    "lars": lambda m: m.LARS(lr=0.1, momentum=0.8, weight_decay=1e-3),
}


def _run_jax(tx, params, grads):
    state = tx.init(params)
    ups = []
    for g in grads:
        u, state = tx.update(g, state, params)
        params = optax.apply_updates(params, u)
        ups.append(u)
    return params, ups


def _run_port(tx, params, grads):
    state = tx.init(params)
    ups = []
    for g in grads:
        u, state = tx.update(g, state, params)
        params = topt.apply_updates(params, u)
        ups.append(u)
    return params, ups


def _data(seed, steps=5):
    rng = np.random.default_rng(seed)
    params = {n: rng.normal(size=s).astype(np.float32)
              for n, s in SHAPES.items()}
    grads = [{n: rng.normal(size=s).astype(np.float32)
              for n, s in SHAPES.items()} for _ in range(steps)]
    return params, grads


def _j(tree):
    return {n: jnp.asarray(a) for n, a in tree.items()}


def _t(tree):
    return {n: torch.from_numpy(np.array(a)) for n, a in tree.items()}


def _assert_close(want, got, tol=TOL):
    for n in SHAPES:
        assert float(np.abs(np.asarray(want[n]) - got[n].numpy()).max()) \
            <= tol, n


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax_for_five_steps(name):
    params, grads = _data(seed=sorted(OPTIMIZERS).index(name))
    jp, jups = _run_jax(OPTIMIZERS[name](jopt), _j(params),
                        [_j(g) for g in grads])
    tp, tups = _run_port(OPTIMIZERS[name](topt), _t(params),
                         [_t(g) for g in grads])
    for ju, tu in zip(jups, tups):
        _assert_close(ju, tu)
    _assert_close(jp, tp)


def test_master_weights_wrapper_matches_jax():
    """bf16 params, f32 masters in the state: the returned updates ARE the
    new bf16 params, and the masters follow the f32 optimizer."""
    from analytics_zoo_tpu.parallel.update_sharding import \
        with_master_weights as jwith

    params, grads = _data(seed=99)
    jtx, ttx = jwith(jopt.Adam(lr=1e-2)), with_master_weights(topt.Adam(
        lr=1e-2))
    jparams = {n: a.astype(jnp.bfloat16) for n, a in _j(params).items()}
    tparams = {n: a.to(torch.bfloat16) for n, a in _t(params).items()}
    jstate, tstate = jtx.init(_j(params)), ttx.init(_t(params))
    for g in grads:
        jparams, jstate = jtx.update(_j(g), jstate, jparams)
        tparams, tstate = ttx.update(_t(g), tstate, tparams)
        for n in SHAPES:
            assert tparams[n].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                np.asarray(jparams[n], np.float32), tparams[n].float().numpy())
    _assert_close(jstate.master, tstate.master)


@pytest.mark.parametrize("name,make", [
    ("poly", lambda m: m.poly(0.1, 1.5, 7)),
    ("poly-zero-steps", lambda m: m.poly(0.1, 1.5, 0)),
    ("exp", lambda m: m.exponential_decay(0.1, 0.7, 3)),
    ("exp-stair", lambda m: m.exponential_decay(0.1, 0.7, 3, True)),
    ("warmup", lambda m: m.warmup_linear(0.1, 3, 9)),
    ("warmup-short-total", lambda m: m.warmup_linear(0.1, 3, 2)),
])
def test_schedules_match_optax(name, make):
    js, ts = make(jopt), make(topt)
    for count in range(12):
        want = float(js(jnp.int32(count)))
        assert abs(want - ts(count)) <= 1e-7 * max(1.0, abs(want)), count


def test_unknown_optimizer_is_an_error():
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.get_optimizer("nope")


# --------------------------------------------------------------------- losses

def _loss_inputs(name, rng):
    shape = (6, 5)
    if name in ("categorical_crossentropy", "kld",
                "kullback_leibler_divergence"):
        a = rng.uniform(0.05, 1.0, size=shape)
        b = rng.uniform(0.05, 1.0, size=shape)
        return a / a.sum(-1, keepdims=True), b / b.sum(-1, keepdims=True)
    if name == "sparse_categorical_crossentropy":
        p = rng.uniform(0.05, 1.0, size=shape)
        return rng.integers(0, 5, size=(6,)), p / p.sum(-1, keepdims=True)
    if name == "binary_crossentropy":
        return (rng.integers(0, 2, size=shape).astype(np.float64),
                rng.uniform(0.01, 0.99, size=shape))
    if name in ("hinge", "squared_hinge"):
        return rng.choice([-1.0, 1.0], size=shape), rng.normal(size=shape)
    if name in ("msle", "mean_squared_logarithmic_error", "poisson", "mape",
                "mean_absolute_percentage_error"):
        return (rng.uniform(0.1, 3.0, size=shape),
                rng.uniform(0.1, 3.0, size=shape))
    return rng.normal(size=shape), rng.normal(size=shape)


@pytest.mark.parametrize("name", sorted(tlosses.LOSSES))
def test_loss_matches_jax(name):
    assert sorted(tlosses.LOSSES) == sorted(jlosses.LOSSES)
    rng = np.random.default_rng(sorted(tlosses.LOSSES).index(name))
    y_true, y_pred = _loss_inputs(name, rng)
    y_true = y_true.astype(np.int32 if y_true.dtype.kind == "i"
                           else np.float32)
    y_pred = y_pred.astype(np.float32)
    want = float(jlosses.get_loss(name)(jnp.asarray(y_true),
                                        jnp.asarray(y_pred)))
    got = tlosses.get_loss(name)(torch.from_numpy(y_true),
                                 torch.from_numpy(y_pred))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(want - float(got)) <= 1e-5 * max(1.0, abs(want))


@pytest.mark.parametrize("name", ["binary_crossentropy",
                                  "categorical_crossentropy",
                                  "sparse_categorical_crossentropy"])
def test_from_logits_losses_match_jax(name):
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(6, 5)).astype(np.float32) * 2
    if name == "sparse_categorical_crossentropy":
        y = rng.integers(0, 5, size=(6, 1)).astype(np.int32)
    elif name == "categorical_crossentropy":
        y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, size=6)]
    else:
        y = rng.integers(0, 2, size=(6, 5)).astype(np.float32)
    want = float(getattr(jlosses, name)(jnp.asarray(y), jnp.asarray(logits),
                                        from_logits=True))
    got = getattr(tlosses, name)(torch.from_numpy(y),
                                 torch.from_numpy(logits), from_logits=True)
    assert abs(want - float(got)) <= 1e-5 * max(1.0, abs(want))


def test_bf16_predictions_compute_in_f32_and_custom_losses_pass_through():
    y = torch.randn(4, 3)
    got = tlosses.mean_squared_error(y, y.to(torch.bfloat16))
    assert got.dtype == torch.float32
    custom = lambda a, b: (a - b).abs().sum()
    assert tlosses.get_loss(custom) is custom
    with pytest.raises(ValueError, match="unknown loss"):
        tlosses.get_loss("nope")
