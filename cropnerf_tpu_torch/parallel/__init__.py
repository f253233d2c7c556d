"""Data parallelism over ranks (counterpart of ``cropnerf_tpu/parallel``)."""
