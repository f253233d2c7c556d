"""Native point-cloud ops of the counting stage (counterpart of
``cropnerf_tpu/native``), built at first use."""
