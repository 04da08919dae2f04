"""PyTorch/CUDA port of tpu_sgp: batched KL-SGP star-stamp restoration.

The JAX package ``tpu_sgp`` is the reference; this package mirrors its
layout, names each ported function's counterpart by file and line, and
never imports JAX. On CUDA tensors the flux projection runs in a CUDA
kernel (``csrc/flux_projection.cu``); on CPU tensors in its plain PyTorch
version. Importing the package builds nothing and touches no device.
"""
from .config import DEFAULT_PARAMS, SGPConfig, parity_config
from .parallel.batch import restore_stamps
from .solvers.sgp import (SGPResult, SGPState, resume_from_state, solve,
                          solve_with_state)

__all__ = [
    'SGPConfig', 'DEFAULT_PARAMS', 'parity_config', 'restore_stamps',
    'solve', 'solve_with_state', 'resume_from_state', 'SGPResult',
    'SGPState',
]
