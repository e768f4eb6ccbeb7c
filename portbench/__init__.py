"""The benchmark of density_tpu_torch: see README.md."""
