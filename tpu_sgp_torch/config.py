"""Solver configuration for the PyTorch port.

Port of ``tpu_sgp/config.py:31-202``: the same frozen dataclass, with the
same field names, defaults and validation. It is a copy rather than an
import because importing anything under ``tpu_sgp`` imports JAX
(``tpu_sgp/__init__.py:10-91``), and this package never does; the tests
pin the two classes field for field.
"""
from __future__ import annotations

import dataclasses
import math

import torch

# Reference DEFAULT_PARAMS tuple, unpacked as
# (max_projs, gamma, beta, alpha_min, alpha_max, alpha, M_alpha, tau, M)
# (tpu_sgp/config.py:18).
DEFAULT_PARAMS = (1000, 1e-4, 0.4, 1e-5, 1e5, 1e1, 3, 0.5, 1)


@dataclasses.dataclass(frozen=True)
class SGPConfig:
    """Static solver configuration (``tpu_sgp/config.py:31-195``).

    Field meanings are those of the JAX package; the port raises
    ``NotImplementedError`` for mesh axes and ``save``.
    """

    # Iteration / stopping
    max_iter: int = 500            # MAXIT
    stop_criterion: int = 0        # 0/1 fixed iters, 2 rel step, 3 rel f decrease, 4 discrepancy
    tol_convergence: float = 1e-4  # used by criteria 2 and 3
    # Initialization
    init_recon: int = 0            # 0 zeros | 1 caller-provided x0 | 2 copy gn | 3 flat flux
    # Projection
    proj_type: int = 0             # 0 clip at 0 | 1 flux-conserving projection
    max_projs: int = 1000          # iteration cap inside the flux projection
    projection_method: str = 'bisect'  # 'pallas' runs the CUDA kernel here
    warm_projection: bool = False  # bisect path only
    stable_sums: bool | str = 'auto'   # compensated sums for stop-rule scalars
    # Line search
    gamma: float = 1e-4            # Armijo penalty
    bt_factor: float = 0.4         # backtracking shrink factor
    m_mem: int = 1                 # non-monotone memory M (1 = monotone)
    max_backtracks: int = 60       # hard cap on backtracking steps
    # Barzilai-Borwein steplength
    alpha_init: float = 1.3
    alpha_min: float = 1e-5
    alpha_max: float = 1e5
    m_alpha: int = 3               # memory for alpha2 values
    tau_init: float = 0.5          # BB alternation threshold
    # Data conditioning
    scale_data: bool = True
    # Divergence
    divergence: str = 'kl'         # 'kl' | 'beta'
    adapt_beta: bool = True
    schedule_lr: bool = False
    lr_exp_param: float = 0.1
    # Misc
    errflag: bool = False          # track ||x - obj|| / ||obj|| per iteration
    track_discr: bool = True       # record the per-iteration discrepancy
    save: bool = False             # per-iteration FITS dump
    verbose: bool = True           # criterion-2 tol is squared only when verbose
    has_flux: bool = True          # whether a precomputed flux is supplied
    has_sat_level: bool = False    # enforce a CCD saturation ceiling
    dtype: str = 'float32'         # compute dtype
    operator: str = 'auto'         # 'auto' | 'otf' | 'matmul' | 'matmul_flat'
                                   # | 'matmul_split' | 'linear' | 'halo'
    axis_names: tuple = ()
    sync_axes: tuple = ()

    def __post_init__(self):
        if self.divergence not in ('kl', 'beta'):
            raise ValueError(f"divergence must be 'kl' or 'beta', got "
                             f"{self.divergence!r}")
        if self.operator not in ('auto', 'otf', 'matmul', 'matmul_flat',
                                 'matmul_split', 'linear', 'halo'):
            raise ValueError(f'unknown operator {self.operator!r}')
        if self.projection_method not in ('bisect', 'section', 'pallas',
                                          'sort', 'secant'):
            raise ValueError(
                f'unknown projection_method {self.projection_method!r}')
        if self.stable_sums not in ('auto', True, False):
            raise ValueError(f"stable_sums must be 'auto', True or False, "
                             f'got {self.stable_sums!r}')
        if self.stop_criterion not in (0, 1, 2, 3, 4):
            raise ValueError('stop_criterion must be 0..4')
        if self.init_recon not in (0, 1, 2, 3):
            raise ValueError('init_recon must be 0..3')
        if self.proj_type not in (0, 1):
            raise ValueError('proj_type must be 0 or 1')
        if self.max_iter < 1:
            raise ValueError('max_iter must be >= 1')
        if not 0.0 < self.bt_factor < 1.0:
            raise ValueError(f'bt_factor={self.bt_factor} must be in (0, 1) '
                             f'(backtracking must shrink the steplength)')
        if (self.max_backtracks > 0
                and self.bt_factor ** (self.max_backtracks - 1) >= 1e-12):
            # the last trial steplength must sit below the 1e-12 accept
            # floor, or a capped exit would adopt a non-Armijo step
            # (tpu_sgp/config.py:167-188)
            need = max(self.max_backtracks,
                       1 + math.ceil(-12.0 / math.log10(self.bt_factor)))
            while self.bt_factor ** (need - 1) >= 1e-12:
                need += 1
            raise ValueError(
                f'max_backtracks={self.max_backtracks} with '
                f'bt_factor={self.bt_factor} caps the line search at '
                f'steplength '
                f'{self.bt_factor ** (self.max_backtracks - 1):.2e} >= '
                f'1e-12, so a capped exit would adopt a non-Armijo step. '
                f'Use max_backtracks >= {need}, or 0 to disable the line '
                f'search explicitly.')

    @property
    def torch_dtype(self) -> torch.dtype:
        try:
            return {'float32': torch.float32,
                    'float64': torch.float64}[self.dtype]
        except KeyError:
            raise ValueError(f'unsupported dtype {self.dtype!r}: the port '
                             f"computes in 'float32' or 'float64'") from None

    def replace(self, **kw) -> 'SGPConfig':
        return dataclasses.replace(self, **kw)


def parity_config(**kw) -> SGPConfig:
    """Config preset for float64 parity work (``tpu_sgp/config.py:198``)."""
    base = dict(dtype='float64')
    base.update(kw)
    return SGPConfig(**base)
