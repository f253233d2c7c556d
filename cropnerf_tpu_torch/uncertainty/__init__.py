"""BayesRays spatial uncertainty (counterpart of ``cropnerf_tpu/uncertainty``)."""
