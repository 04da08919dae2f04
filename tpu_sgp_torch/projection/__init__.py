"""Port of tpu_sgp/projection."""
