"""Port of ``analytics_zoo_tpu.engine``: the Estimator, checkpoints and
the GAN trainer."""

from .gan import GANEstimator

__all__ = ["GANEstimator"]
