"""Port of ``analytics_zoo_tpu.parallel``."""
