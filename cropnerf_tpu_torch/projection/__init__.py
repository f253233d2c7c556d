"""Per-subcluster semantic projections (counterpart of
``cropnerf_tpu/projection``)."""
