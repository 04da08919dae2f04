"""Port of tpu_sgp/kernels."""
