"""The benchmark of tpu_blosc_torch: see README.md."""
