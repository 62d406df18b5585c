"""GANEstimator — alternating generator/discriminator training (port of
``analytics_zoo_tpu/engine/gan.py``): ``d_steps`` discriminator updates,
then one generator update, a training step; losses default to the
non-saturating GAN objective.

Both nets stay in training mode throughout, and their BatchNorm state is
threaded as the JAX step threads it: a discriminator update moves D's
statistics (its real pass, then its fake pass) and leaves G's as they
were; the generator update moves G's and leaves D's as they were. The
optimizers are the port's optax-shaped transformations over each net's
parameters by name.

The noise and the step keys are JAX's threefry bits (``common/prng.py``):
the training key is the third of ``split(PRNGKey(seed), 3)``, a
discriminator sub-step ``i`` draws from ``fold_in(key, step·(d_steps+1) +
i)`` split in four (noise, G, D-real, D-fake), the generator update from
``fold_in(key, step·(d_steps+1) + d_steps)`` split in three (noise, G, D);
the noise is ``normal(k, (batch, noise_dim))``. ``generate(n, seed)``
draws ``normal(PRNGKey(seed), (n, noise_dim))``. So the same weights and
data give the JAX package's noise bit for bit.

The generator and the discriminator are the port's modules (a
``Sequential`` or a graph), already built: their weights are where they
live, and training updates them in place. The Estimator runs on their
device.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..common import prng
from ..nn.module import call_layer
from ..nn.optimizers import apply_updates, get_optimizer


def default_disc_loss(real_logits, fake_logits):
    """-(log D(x) + log(1 - D(G(z)))) via stable softplus forms."""
    return (torch.mean(F.softplus(-real_logits))
            + torch.mean(F.softplus(fake_logits)))


def default_gen_loss(fake_logits):
    """Non-saturating generator loss: -log D(G(z))."""
    return torch.mean(F.softplus(-fake_logits))


def _device_of(module) -> torch.device:
    for t in list(module.parameters()) + list(module.buffers()):
        return t.device
    return getattr(module, "device", torch.device("cpu"))


class GANEstimator:
    """Alternating GAN trainer.

    Args:
        generator: a built module mapping noise → samples.
        discriminator: a built module mapping samples → logits.
        noise_dim: latent dimension (noise drawn N(0,1) per step).
        gen_optimizer / disc_optimizer: optimizer spec (name, factory or
            transformation).
        gen_loss_fn(fake_logits) / disc_loss_fn(real_logits, fake_logits).
        d_steps: discriminator updates per generator update.
    """

    def __init__(self, generator, discriminator, noise_dim: int,
                 gen_optimizer="adam", disc_optimizer="adam",
                 gen_loss_fn: Callable = default_gen_loss,
                 disc_loss_fn: Callable = default_disc_loss,
                 d_steps: int = 1, seed: int = 0):
        self.generator = generator
        self.discriminator = discriminator
        self.noise_dim = int(noise_dim)
        self.gen_tx = get_optimizer(gen_optimizer)
        self.disc_tx = get_optimizer(disc_optimizer)
        self.gen_loss_fn = gen_loss_fn
        self.disc_loss_fn = disc_loss_fn
        self.d_steps = int(d_steps)
        self.seed = int(seed)
        self.device = _device_of(generator)
        self.state = None

    # -- state ---------------------------------------------------------------
    @staticmethod
    def _params(module) -> Dict[str, torch.nn.Parameter]:
        return dict(module.named_parameters())

    def _init(self) -> None:
        _kg, _kd, kt = prng.split(prng.PRNGKey(self.seed), 3)
        g = {n: p.detach() for n, p in self._params(self.generator).items()}
        d = {n: p.detach()
             for n, p in self._params(self.discriminator).items()}
        self.state = {"g_opt": self.gen_tx.init(g),
                      "d_opt": self.disc_tx.init(d), "rng": kt, "step": 0}

    def _noise(self, key, n: int) -> torch.Tensor:
        return prng.normal(key, (n, self.noise_dim), device=self.device)

    @staticmethod
    def _update(module, tx, opt_state, grads):
        params = {n: p.detach() for n, p in module.named_parameters()}
        upd, opt_state = tx.update(grads, opt_state, params)
        new = apply_updates(params, upd)
        with torch.no_grad():
            for n, p in module.named_parameters():
                p.copy_(new[n])
        return opt_state

    @staticmethod
    def _buffers(module):
        return {n: b.detach().clone() for n, b in module.named_buffers()}

    @staticmethod
    def _restore(module, saved) -> None:
        with torch.no_grad():
            for n, b in module.named_buffers():
                b.copy_(saved[n])

    # -- the step ------------------------------------------------------------
    def _d_update(self, real: torch.Tensor, d_idx: int) -> torch.Tensor:
        st = self.state
        gen, disc = self.generator, self.discriminator
        k = prng.fold_in(st["rng"], st["step"] * (self.d_steps + 1) + d_idx)
        kz, kg, kd1, kd2 = prng.split(k, 4)
        z = self._noise(kz, real.shape[0])
        # G runs in training mode against D, but its statistics stay
        g_saved = self._buffers(gen)
        with torch.no_grad():
            fake = call_layer(gen, z, kg)
        self._restore(gen, g_saved)
        d_params = self._params(disc)
        real_logits = call_layer(disc, real, kd1)
        fake_logits = call_layer(disc, fake.detach(), kd2)
        loss = self.disc_loss_fn(real_logits, fake_logits)
        grads = torch.autograd.grad(loss, list(d_params.values()),
                                    allow_unused=True)
        grads = {n: (g if g is not None else torch.zeros_like(p))
                 for (n, p), g in zip(d_params.items(), grads)}
        st["d_opt"] = self._update(disc, self.disc_tx, st["d_opt"], grads)
        return loss.detach()

    def _g_update(self, real: torch.Tensor) -> torch.Tensor:
        st = self.state
        gen, disc = self.generator, self.discriminator
        k = prng.fold_in(st["rng"],
                         st["step"] * (self.d_steps + 1) + self.d_steps)
        kz, kg, kd = prng.split(k, 3)
        z = self._noise(kz, real.shape[0])
        g_params = self._params(gen)
        fake = call_layer(gen, z, kg)
        # D runs in training mode, as G is optimized against the function
        # D was just trained as, and its statistics stay
        d_saved = self._buffers(disc)
        fake_logits = call_layer(disc, fake, kd)
        self._restore(disc, d_saved)
        loss = self.gen_loss_fn(fake_logits)
        grads = torch.autograd.grad(loss, list(g_params.values()),
                                    allow_unused=True)
        grads = {n: (g if g is not None else torch.zeros_like(p))
                 for (n, p), g in zip(g_params.items(), grads)}
        st["g_opt"] = self._update(gen, self.gen_tx, st["g_opt"], grads)
        return loss.detach()

    def _train_step(self, real: torch.Tensor):
        d_loss = torch.zeros((), device=self.device)
        for i in range(self.d_steps):
            d_loss = self._d_update(real, i)
        g_loss = self._g_update(real)
        self.state["step"] += 1
        return d_loss, g_loss

    def fit(self, real_data: np.ndarray, batch_size: int = 64,
            epochs: int = 1, log_every: int = 0):
        """Train on ``real_data`` in shuffled batches (numpy's
        ``default_rng(seed)`` permutation each epoch, the last partial
        batch dropped)."""
        real_data = np.asarray(real_data, dtype="float32")
        if self.state is None:
            self._init()
        n = len(real_data)
        rng = np.random.default_rng(self.seed)
        self.generator.train()
        self.discriminator.train()
        try:
            for _ in range(epochs):
                perm = rng.permutation(n)
                for i in range(n // batch_size):
                    batch = torch.from_numpy(real_data[
                        perm[i * batch_size:(i + 1) * batch_size]]).to(
                            self.device)
                    d_l, g_l = self._train_step(batch)
                    if log_every and self.state["step"] % log_every == 0:
                        print(f"step {self.state['step']}: "
                              f"d_loss={float(d_l):.4f} "
                              f"g_loss={float(g_l):.4f}")
        finally:
            self.generator.eval()
            self.discriminator.eval()
        return self

    def generate(self, n: int, seed: int = 0) -> np.ndarray:
        """``n`` samples of the generator in inference mode from
        ``normal(PRNGKey(seed), (n, noise_dim))``."""
        if self.state is None:
            raise RuntimeError("GANEstimator not fitted")
        z = self._noise(prng.PRNGKey(seed), n)
        with torch.no_grad():
            fake = self.generator.apply(z)
        return fake.float().cpu().numpy()


__all__ = ["GANEstimator", "default_disc_loss", "default_gen_loss"]
