"""Port of tpu_sgp/ops."""
