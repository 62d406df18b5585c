"""Static checks of the port (part of ``analytics_zoo_tpu/analysis``)."""
