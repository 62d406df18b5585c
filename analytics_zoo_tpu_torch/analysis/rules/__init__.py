"""Rules of the port's checks (part of ``analytics_zoo_tpu/analysis/rules``)."""
