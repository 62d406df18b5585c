"""Port of ``analytics_zoo_tpu.common``."""
