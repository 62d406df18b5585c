"""LayerNormalization and BatchNormalization (port of
``nn/layers/normalization.py``).

BatchNormalization's moving statistics are buffers (``moving_mean``,
``moving_var``: the JAX state tree, the Estimator's ``model_state``). In
training mode (``train()``, the JAX ``apply(training=True)``) a forward
normalises with the batch's mean and biased variance, in f32 over every
axis but the channel axis, and moves the buffers once:
``moving = m · moving + (1 - m) · batch``. ``F.batch_norm`` is not this:
its running variance is the unbiased one and its momentum the complement.

Two rules keep the buffers' history the JAX one:

* a forward that runs inside a backward pass (the recomputation of
  ``torch.utils.checkpoint``) normalises again but does not move the
  buffers a second time;
* on a rank's block of a global batch (``parallel.comm.batch_shard``) in
  the replicated or per-leaf step, the statistics are the global batch's:
  the sums are all-reduced over the batch axes, and the gradient flows
  back through the all-reduce, as under JAX's GSPMD. The flat (ZeRO-1)
  step keeps each rank's local statistics, and the Estimator averages the
  buffers over dp after the step (``engine/estimator.py``), as the JAX
  flat step's ``pmean`` does.

The moments are summed over the batch axes only, on every mesh: BN's
input is whole on every rank of the model-parallel axes (see
:meth:`BatchNormalization._batch_moments`), and a forward whose input is
not the width the layer was built for raises ``ValueError`` naming the
mesh's model-parallel axes.
"""

from __future__ import annotations

import torch
from torch import nn

from ...parallel import comm
from ..module import Layer, ones_init, zeros_init


class LayerNormalization(Layer):
    """LayerNorm over the last axis: statistics in f32, cast back to the
    input dtype. Parameters keep the JAX names ``gamma``/``beta``.
    ``dim=`` builds it at once (on ``device``): how the transformer
    layers hold theirs."""

    def __init__(self, epsilon: float = 1e-5, name=None, input_shape=None,
                 *, dim=None, device=None):
        super().__init__(name=name, input_shape=input_shape)
        self.epsilon = epsilon
        if dim is not None:
            self.build((int(dim),), None)
            self.to(device)

    def build(self, input_shape, gen) -> None:
        d = input_shape[-1]
        self.gamma = nn.Parameter(ones_init((d,)))
        self.beta = nn.Parameter(zeros_init((d,)))
        self.built = True

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        y = y * self.gamma + self.beta
        return y.to(x.dtype)


def _in_recompute() -> bool:
    """Whether this forward runs inside a backward pass (a checkpointed
    region being recomputed)."""
    return torch._C._current_graph_task_id() != -1


class BatchNormalization(Layer):
    """BatchNorm over the channel (last) axis; ``axis`` picks another.
    Starts in inference mode, as a JAX layer's ``apply`` defaults to
    ``training=False``."""

    def __init__(self, epsilon: float = 1e-3, momentum: float = 0.99,
                 axis: int = -1, scale: bool = True, center: bool = True,
                 name=None, input_shape=None):
        super().__init__(name=name, input_shape=input_shape)
        self.epsilon = epsilon
        self.momentum = momentum
        self.axis = axis
        self.scale = scale
        self.center = center
        self.training = False

    def _axis(self, ndim: int) -> int:
        return self.axis if self.axis >= 0 else ndim + self.axis

    def build(self, input_shape, gen: torch.Generator) -> None:
        full = (None,) + tuple(input_shape)
        shape = (full[self._axis(len(full))],)
        if self.scale:
            self.gamma = nn.Parameter(ones_init(shape))
        if self.center:
            self.beta = nn.Parameter(zeros_init(shape))
        self.register_buffer("moving_mean", torch.zeros(shape))
        self.register_buffer("moving_var", torch.ones(shape))
        self.built = True

    def _batch_moments(self, xf: torch.Tensor, axis: int, bshape):
        """The batch's f32 mean and biased variance per channel: the
        global batch's on a rank's block in a global-statistics step.

        The sums run over the batch axes (dp, fsdp) and no other, because
        the port holds BN's input whole on every rank of the others, as
        JAX's GSPMD step gives BN the global batch on every mesh (no
        ``shard_map`` of the JAX package wraps a BN):

        * sp: attention shards q/k/v along the sequence and gathers its
          output back;
        * ep: the MoE's combine ends in ``comm.reduce_from``;
        * tp: the Megatron layers end in a row-parallel reduction, and the
          vocab-parallel embedding returns whole rows;
        * pp: JAX's stage function carries no state, so no stage holds a
          BN: it runs outside the pipeline, replicated over pp.

        :meth:`apply` checks the width against the built statistics."""
        dims = tuple(i for i in range(xf.dim()) if i != axis)
        n = xf.numel() // xf.shape[axis]
        shard = comm.global_batch_shard()
        if shard is None:
            mean = xf.mean(dim=dims)
            var = (xf - mean.reshape(bshape)).square().mean(dim=dims)
            return mean, var
        n *= shard.count
        mean = comm.batch_psum(xf.sum(dim=dims)) / n
        var = comm.batch_psum(
            (xf - mean.reshape(bshape)).square().sum(dim=dims)) / n
        return mean, var

    def _check_width(self, c: int) -> None:
        """A channel count other than the built one means the input came
        sharded over a model-parallel axis: per-rank moments would be
        wrong there, so it raises."""
        want = self.moving_mean.shape[0]
        if c == want:
            return
        shard = comm.current_batch_shard()
        mesh = shard.mesh if shard is not None else None
        if mesh is None:
            from ...common.context import get_zoo_context

            try:
                mesh = get_zoo_context(auto_init=False).mesh
            except RuntimeError:
                mesh = None
        shape = getattr(mesh, "shape", None) or {}
        axes = [a for a in ("sp", "pp", "ep", "tp") if shape.get(a, 1) > 1]
        where = (f"sharded over {'/'.join(axes)}" if axes
                 else "not the width it was built for")
        raise ValueError(
            f"BatchNormalization {self.name} built for {want} channels got "
            f"{c}: its input is {where}; BN needs the whole channel width "
            f"on every rank")

    def apply(self, x):
        axis = self._axis(x.dim())
        self._check_width(x.shape[axis])
        bshape = [1] * x.dim()
        bshape[axis] = x.shape[axis]
        xf = x.float()
        if self.training:
            mean, var = self._batch_moments(xf, axis, bshape)
            if not _in_recompute():
                m = self.momentum
                with torch.no_grad():
                    self.moving_mean.copy_(m * self.moving_mean
                                           + (1 - m) * mean.detach())
                    self.moving_var.copy_(m * self.moving_var
                                          + (1 - m) * var.detach())
            inv = torch.rsqrt(var + self.epsilon)
        else:
            mean = self.moving_mean
            # the per-channel 1/sqrt in float64, rounded once, where JAX
            # has an f32 rsqrt: the card's and the CPU's f32 versions
            # differ by an ulp on some channels, and in an int8 network
            # that one ulp flips codes that cascade (measured: 1.65e-3 in
            # the probabilities of ResNet-50); the elementwise steps below
            # are exact IEEE on both
            inv = torch.reciprocal(torch.sqrt(
                (self.moving_var + self.epsilon).double())).float()
        y = (xf - mean.reshape(bshape)) * inv.reshape(bshape)
        if self.scale:
            y = y * self.gamma.reshape(bshape)
        if self.center:
            y = y + self.beta.reshape(bshape)
        return y.to(x.dtype)


LayerNorm = LayerNormalization

__all__ = ["BatchNormalization", "LayerNorm", "LayerNormalization"]
