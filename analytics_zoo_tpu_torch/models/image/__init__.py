"""Image models (port of ``analytics_zoo_tpu/models/image``)."""
