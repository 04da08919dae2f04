"""Port of tpu_sgp/experimental: the whole-solver path
(``pallas_batch.solve_stamps_pallas``), reached by a direct import only, as
in the JAX package."""
