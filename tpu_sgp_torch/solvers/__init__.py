"""Port of tpu_sgp/solvers."""
