"""PyTorch/CUDA port of ``analytics_zoo_tpu``.

The JAX package stays the reference; this package mirrors its module paths
and public names so each counterpart is easy to find
(``analytics_zoo_tpu_torch.models.transformer.TransformerLM`` ports
``analytics_zoo_tpu.models.transformer.TransformerLM``, and so on).

What is ported so far: the autoregressive LM serving path (``TransformerLM``
over the paged KV cache, driven by ``serving.generation.ContinuousBatcher``)
the LM training path (``engine.estimator.Estimator``, or
``compile``/``fit`` on the model, with the optimizers, losses and
mixed-precision master weights), int8 inference
(``inference.inference_model.InferenceModel``) and the NCF recommender
(``models.recommendation``: ``fit``/``evaluate``/``predict``, top-K
recommendation, device-cached epochs). Their six kernels (flash
forward and backward, paged attention) are CUDA C++ for Hopper
(``csrc/``), built with ``nvcc`` at first use (``ops/_build.py``). Plain
PyTorch versions sit beside them; a wrapper takes the plain version only
for CPU tensors.

This package imports ``torch`` and never ``jax`` or ``analytics_zoo_tpu``.
Importing it starts no thread and builds nothing.
"""

__version__ = "0.1.0"
