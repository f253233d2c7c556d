"""Interactive web viewer (counterpart of ``cropnerf_tpu/viewer``)."""
