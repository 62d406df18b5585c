"""Inference (port of ``analytics_zoo_tpu/inference``)."""
