"""Port of ``analytics_zoo_tpu.engine``."""
