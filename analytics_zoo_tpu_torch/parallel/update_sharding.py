"""Master weights for mixed-precision training (port of
``with_master_weights`` in ``parallel/update_sharding.py``).

Under ``TrainConfig(compute_dtype="bfloat16")`` the model holds bf16
parameters (the JAX ``cast_params``) and the f32 master weights live only
in the optimizer state. The wrapped transformation takes f32 grads, runs
the inner optimizer against the masters, and returns the NEW
low-precision parameters as its "updates", which the Estimator installs
directly. The ZeRO-1 update sharding of the rest of the JAX module is
multi-GPU work (ROADMAP Queue 1, item 9).
"""

from __future__ import annotations

from typing import Any, NamedTuple

from ..nn.optimizers import GradientTransformation, Params, apply_updates


class MasterWeightsState(NamedTuple):
    inner_state: Any
    master: Params


def with_master_weights(tx: GradientTransformation) -> GradientTransformation:
    """Wrap ``tx`` so f32 masters live in (and only in) its state."""

    def init(params: Params) -> MasterWeightsState:
        master = {n: p.detach().float().clone() if p.is_floating_point()
                  else p for n, p in params.items()}
        return MasterWeightsState(tx.init(master), master)

    def update(grads: Params, state: MasterWeightsState, params=None):
        g32 = {n: g.float() for n, g in grads.items()}
        updates, inner = tx.update(g32, state.inner_state, state.master)
        master = apply_updates(state.master, updates)
        if params is not None:
            new_params = {n: m.to(params[n].dtype) for n, m in master.items()}
        else:
            new_params = master
        return new_params, MasterWeightsState(inner, master)

    return GradientTransformation(init, update)


__all__ = ["MasterWeightsState", "with_master_weights"]
