"""The rank side of ``tests/test_torch_fsdp_tp.py``: what each of the 8
gloo ranks runs, kept apart from the test module so the rank processes
import torch and the port, not JAX. Every port module is imported inside
the function that uses it."""

import numpy as np
import torch

from analytics_zoo_tpu_torch.parallel import comm

WORLD = 8
LM = dict(vocab=64, hidden_size=32, n_block=2, n_head=8, seq_len=16)
N_SEQS, BATCH = 32, 16


def _tokens(seed=0):
    ids = np.random.default_rng(seed).integers(
        0, LM["vocab"], size=(N_SEQS, LM["seq_len"] + 1)).astype(np.int32)
    return ids[:, :-1], ids[:, 1:]


def _ctx(**axes):
    from analytics_zoo_tpu_torch.common.config import MeshConfig
    from analytics_zoo_tpu_torch.common.context import (init_zoo_context,
                                                        reset_zoo_context)

    reset_zoo_context()
    return init_zoo_context(platform="cpu", mesh=MeshConfig(**axes))


def _port_lm(tree, strategy):
    from analytics_zoo_tpu_torch.bridge import params_from_jax
    from analytics_zoo_tpu_torch.models.transformer import TransformerLM

    tm = TransformerLM(**LM, attn_strategy=strategy, device="cpu")
    tm.load_state_dict(params_from_jax(tree))
    return tm


def _whole(est):
    """Every param gathered whole (the JAX layout) by the Estimator."""
    return {n: est._full(n, p.detach()).numpy()
            for n, p in est.model.named_parameters()}


def _fit_lm(tree, axes, cfg, strategy="full", ckpt_dir=None, remat=False):
    """Rank side: the port's Estimator on ``axes`` with the JAX rules (one
    process without a mesh when ``axes`` is None), one epoch; losses a
    step, the gathered params, and the layout."""
    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.models.transformer import lm_loss
    from analytics_zoo_tpu_torch.nn import optimizers as topt
    from analytics_zoo_tpu_torch.parallel.sharding import make_param_sharding

    rules = None
    if axes is not None:
        rules = make_param_sharding(_ctx(**axes).mesh)
    tm = _port_lm(tree, strategy)
    tm.remat = remat
    est = Estimator(tm, optimizer=topt.Adam(lr=1e-2, epsilon=1e-4),
                    loss=lm_loss, param_sharding=rules,
                    config=TrainConfig(log_every_n_steps=1,
                                       checkpoint_dir=ckpt_dir, **cfg))
    est.fit(_tokens(), batch_size=BATCH, epochs=1)
    return {"losses": [h["loss"] for h in est.history],
            "params": _whole(est),
            "elements": sum(p.numel() for p in tm.parameters()),
            "mode": est._update_mode(),
            "upd_dims": dict(est._upd_dims),
            "tp_modules": sum(getattr(m, "tp_mesh", None) is not None
                              for m in tm.modules())}


def _placement(tree, axes):
    """Rank side: place the LM's leaves on ``axes``; the gathered leaves,
    this rank's QKV block, its compute view and the mesh's groups."""
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.models.transformer import lm_loss
    from analytics_zoo_tpu_torch.parallel import placement
    from analytics_zoo_tpu_torch.parallel.sharding import make_param_sharding

    ctx = _ctx(**axes)
    tm = _port_lm(tree, "full")
    est = Estimator(tm, optimizer="sgd", loss=lm_loss,
                    param_sharding=make_param_sharding(ctx.mesh))
    est._init_state()
    attn = tm.blocks[0].attn
    with placement.gathering():
        view = attn.qkv_kernel.detach().numpy()
        bias = attn.qkv_bias.detach().numpy()
    groups = {a: ctx.mesh.axis(a).ranks for a in ("dp", "fsdp", "tp")}
    return {"whole": _whole(est), "coords": dict(ctx.mesh.coords),
            "groups": groups, "stored": attn.qkv_kernel.detach().numpy(),
            "view": view, "bias_view": bias}


def _saved_blocks(tree, axes):
    """Rank side: a forward and backward of the LM placed on ``axes``
    (remat off) inside ``gathering``. How many leaves gathered whole are
    still alive after the forward while its graph is held (the backward
    saves blocks), the all-gathers of the forward and of the backward (its
    regathers), and whether every gradient is finite."""
    import gc

    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.models.transformer import lm_loss
    from analytics_zoo_tpu_torch.parallel import placement
    from analytics_zoo_tpu_torch.parallel.sharding import make_param_sharding

    ctx = _ctx(**axes)
    tm = _port_lm(tree, "full")
    est = Estimator(tm, optimizer="sgd", loss=lm_loss,
                    param_sharding=make_param_sharding(ctx.mesh))
    est._init_state()
    x, y = _tokens()
    comm.reset_collective_counts()
    with placement.gathering():
        loss = lm_loss(y[:4], tm(torch.from_numpy(x[:4])))
        gc.collect()
        alive = len(placement._WHOLE)
        fwd = comm.collective_counts()["all-gather"]
        loss.backward()
    bwd = comm.collective_counts()["all-gather"] - fwd
    finite = all(bool(torch.isfinite(p.grad).all()) for p in tm.parameters()
                 if p.grad is not None)
    return {"alive": alive, "fwd_gathers": fwd, "bwd_gathers": bwd,
            "finite": finite}


def _vocab_loss(logits, labels):
    """Rank side, tp=8: the vocab-parallel loss over this rank's columns
    and its gradient, beside ``lm_loss`` of the whole logits."""
    from analytics_zoo_tpu_torch.models.transformer import (
        lm_loss, vocab_parallel_lm_loss)

    ctx = _ctx(tp=WORLD)
    t = ctx.mesh.coords["tp"]
    whole = torch.from_numpy(logits).requires_grad_(True)
    ref = lm_loss(labels, whole)
    (gref,) = torch.autograd.grad(ref, whole)
    v = logits.shape[-1] // WORLD
    mine = torch.from_numpy(logits[..., t * v:(t + 1) * v].copy())
    mine.requires_grad_(True)
    loss = vocab_parallel_lm_loss(labels, mine, ctx.mesh)
    (g,) = torch.autograd.grad(loss, mine)
    return (float(loss), float(ref), g.numpy(),
            gref[..., t * v:(t + 1) * v].numpy(), comm.collective_counts())


def _ckpt_roundtrip(tree, ckpt_dir, jax_dir):
    """Rank side: train on dp x fsdp x tp with update sharding, writing a
    checkpoint; the gathered state. Then a fresh sharded Estimator
    restores the JAX package's checkpoint in ``jax_dir``: its state
    gathered."""
    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.engine import checkpoint as ckpt
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.models.transformer import lm_loss
    from analytics_zoo_tpu_torch.nn import optimizers as topt
    from analytics_zoo_tpu_torch.parallel.sharding import make_param_sharding

    axes = dict(dp=2, fsdp=2, tp=2)
    cfg = dict(grad_accum_steps=2, update_sharding=True)
    res = _fit_lm(tree, axes, cfg, ckpt_dir=ckpt_dir)
    ctx = _ctx(**axes)
    est = Estimator(_port_lm(tree, "full"),
                    optimizer=topt.Adam(lr=1e-2, epsilon=1e-4), loss=lm_loss,
                    param_sharding=make_param_sharding(ctx.mesh),
                    config=TrainConfig(**cfg))
    est._init_state()
    est._restore(ckpt.latest_checkpoint(jax_dir))
    state = ckpt.snapshot_state(est.checkpoint_state()).wait()
    return res["params"], state


def _ncf_data(n=256, seed=0):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(1, 64, n), rng.integers(1, 40, n)],
                 1).astype(np.int32)
    return x, rng.integers(0, 5, n).astype(np.int32)


def two_axes_rule(path, leaf):
    """Rows of every 2-D leaf they split 4 ways over ``("fsdp", "tp")``,
    two axes on one dim (fsdp major); anything else replicated."""
    from analytics_zoo_tpu_torch.parallel.sharding import P

    shape = tuple(getattr(leaf, "shape", ()))
    if len(shape) == 2 and shape[0] % 4 == 0:
        return P(("fsdp", "tp"), None)
    return P()


def _fit_other(kind, params, state, widths, axes, two_axes=False):
    """Rank side: NCF or the Dropout MLP under ``axes`` with the JAX rules
    (fsdp defaults), or :func:`two_axes_rule`, one epoch."""
    from analytics_zoo_tpu_torch.bridge import state_dict_from_jax
    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.nn import optimizers as topt
    from analytics_zoo_tpu_torch.parallel.sharding import make_param_sharding

    ctx = _ctx(**axes)
    if kind == "ncf":
        from analytics_zoo_tpu_torch.models.recommendation import NeuralCF

        tm = NeuralCF(63, 39, 5, device="cpu", **widths)
        data, loss = _ncf_data(), "sparse_categorical_crossentropy"
    else:
        tm = _port_mlp()
        data, loss = _mlp_data(), "mse"
    tm.load_state_dict(state_dict_from_jax(params, state))
    est = Estimator(tm, optimizer=topt.Adam(lr=1e-2), loss=loss,
                    param_sharding=(two_axes_rule if two_axes
                                    else make_param_sharding(ctx.mesh)),
                    config=TrainConfig(log_every_n_steps=1))
    est.fit(data, batch_size=64 if kind == "ncf" else 16, epochs=1, seed=3)
    return ([h["loss"] for h in est.history], _whole(est),
            sorted(est._specs))


def _port_mlp():
    from analytics_zoo_tpu_torch.nn import layers as TL
    from analytics_zoo_tpu_torch.nn.topology import Sequential

    return Sequential([TL.Dense(16, activation="relu", input_shape=(8,)),
                       TL.Dropout(0.3), TL.Dense(8, activation="tanh"),
                       TL.Dense(4)], device="cpu")


def _mlp_data(seed=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(64, 8)).astype(np.float32),
            rng.normal(size=(64, 4)).astype(np.float32))


def _port_bn_mlp():
    from analytics_zoo_tpu_torch.nn import layers as TL
    from analytics_zoo_tpu_torch.nn.topology import Sequential

    return Sequential([TL.Dense(16, use_bias=False, input_shape=(8,)),
                       TL.BatchNormalization(), TL.Activation("relu"),
                       TL.Dense(4)], device="cpu")


def _fit_bn(params, state, axes):
    """Rank side: a Dense + BatchNormalization MLP under ``axes`` with the
    JAX rules, one epoch: losses, the gathered params and the moving
    statistics (the global batch's, over dp and fsdp together)."""
    from analytics_zoo_tpu_torch.bridge import model_state, state_dict_from_jax
    from analytics_zoo_tpu_torch.common.config import TrainConfig
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.nn import optimizers as topt
    from analytics_zoo_tpu_torch.parallel.sharding import make_param_sharding

    ctx = _ctx(**axes)
    tm = _port_bn_mlp()
    tm.load_state_dict(state_dict_from_jax(params, state))
    est = Estimator(tm, optimizer=topt.Adam(lr=1e-2), loss="mse",
                    param_sharding=make_param_sharding(ctx.mesh),
                    config=TrainConfig(log_every_n_steps=1))
    est.fit(_mlp_data(), batch_size=16, epochs=1, seed=3)
    return ([h["loss"] for h in est.history], _whole(est),
            {n: b.numpy() for n, b in model_state(tm).items()})

