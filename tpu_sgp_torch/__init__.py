"""PyTorch/CUDA port of tpu_sgp: batched KL- and beta-SGP star-stamp
restoration.

The JAX package ``tpu_sgp`` is the reference; this package mirrors its
layout, names each ported function's counterpart by file and line, and
never imports JAX. With ``projection_method='pallas'`` the flux projection
runs in a CUDA kernel (``csrc/flux_projection.cu``) on CUDA tensors and in
its plain PyTorch version on CPU tensors; the other methods are plain
PyTorch. Importing the package builds nothing and touches no device.
"""
from .config import DEFAULT_PARAMS, SGPConfig, parity_config
from .parallel.batch import (BETA_SEEDS, beta_init_search,
                             default_beta_candidates, restore_stamps)
from .solvers.sgp import (SGPResult, SGPState, resume_from_state, solve,
                          solve_with_state)

__all__ = [
    'SGPConfig', 'DEFAULT_PARAMS', 'parity_config', 'restore_stamps',
    'beta_init_search', 'default_beta_candidates', 'BETA_SEEDS', 'solve',
    'solve_with_state', 'resume_from_state', 'SGPResult', 'SGPState',
]
