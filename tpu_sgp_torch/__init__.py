"""PyTorch/CUDA port of tpu_sgp: KL- and beta-SGP restoration of one image
(``sgp``, ``sgp_beta_div``) or of a batch of star stamps
(``restore_stamps``).

The JAX package ``tpu_sgp`` is the reference; this package mirrors its
layout, names each ported function's counterpart by file and line, and
never imports JAX. With ``projection_method='pallas'`` the flux projection
runs in a CUDA kernel (``csrc/flux_projection.cu``) on CUDA tensors and in
its plain PyTorch version on CPU tensors; the other methods are plain
PyTorch. Importing the package builds nothing and touches no device.
"""
from .api import check_psf_normalized, sgp, sgp_beta_div, sgp_betaDiv
from .config import DEFAULT_PARAMS, SGPConfig, parity_config
from .parallel.batch import (BETA_SEEDS, beta_init_search,
                             default_beta_candidates, restore_stamps)
from .solvers.classic import richardson_lucy, wiener
from .solvers.sgp import (SGPResult, SGPState, resume_from_state, solve,
                          solve_with_state)

__all__ = [
    'sgp', 'sgp_beta_div', 'sgp_betaDiv', 'check_psf_normalized',
    'richardson_lucy', 'wiener',
    'SGPConfig', 'DEFAULT_PARAMS', 'parity_config', 'restore_stamps',
    'beta_init_search', 'default_beta_candidates', 'BETA_SEEDS', 'solve',
    'solve_with_state', 'resume_from_state', 'SGPResult', 'SGPState',
]
