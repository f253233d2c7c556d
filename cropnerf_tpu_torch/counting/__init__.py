"""Host-side point-cloud primitives of the counting stage (counterpart of
``cropnerf_tpu/counting``)."""
