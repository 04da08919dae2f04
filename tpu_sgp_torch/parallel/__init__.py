"""Port of tpu_sgp/parallel."""
