"""Divergence objectives and gradients over a (B, N) batch.

Port of ``tpu_sgp/ops/divergence.py``: the KL pair and the beta-divergence
family, one value per row. ``beta`` is a (B,) tensor (one parameter a row)
or a Python scalar; ``den`` is the model A(x) + bkg, ``gn`` the observed
image, both (B, N).
"""
from __future__ import annotations

import math

import torch

from ..kernels import beta_divergence
from .reduce import gsum, gsum_ff


def kl_objective(x_tf: torch.Tensor, den: torch.Tensor, gn: torch.Tensor,
                 flux: torch.Tensor, axes=(), stable: bool = False
                 ) -> torch.Tensor:
    """fv = sum(gn * log(gn/den)) + sum(A(x)) - flux, per row
    (``divergence.py:23-38``). ``flux`` is (B,); ``stable`` selects the
    compensated tree sum (``reduce.gsum_ff``)."""
    red = gsum_ff if stable else gsum
    return red(gn * torch.log(gn / den), axes) + red(x_tf, axes) - flux


def _col(beta, like: torch.Tensor) -> torch.Tensor:
    """beta as a (B, 1) column (or a 0-d tensor) in ``like``'s dtype."""
    beta = torch.as_tensor(beta, dtype=like.dtype, device=like.device)
    return beta[:, None] if beta.dim() == 1 else beta


def _t_small(dtype: torch.dtype) -> float:
    """The singular-point switch |t| < eps/512 (``divergence.py:79-94``):
    the limit form is exact to machine precision there."""
    return torch.finfo(dtype).eps / 512.0


def beta_div(den: torch.Tensor, gn: torch.Tensor, beta, axes=(),
             log_gn: torch.Tensor | None = None,
             stable: bool = False) -> torch.Tensor:
    """beta-divergence D_beta(gn || den) per row, generic-beta branch
    (``divergence.py:41-97``), in the expm1 form that stays exact through
    beta = 1 and den = gn; gn == 0 pixels contribute den^b / b."""
    b = _col(beta, den)
    e = b - 1.0
    pos = gn > 0
    gn_safe = torch.where(pos, gn, 1.0)
    d = torch.log(den / gn_safe)
    lg = torch.log(gn_safe) if log_gn is None else log_gn
    gn_b = torch.exp(b * lg)
    t_small = _t_small(den.dtype)
    e_sing = e.abs() < t_small
    safe_e = torch.where(e_sing, 1.0, e)
    r1 = torch.where(e_sing, d, torch.expm1(e * d) / safe_e)
    b_sing = b.abs() < t_small
    safe_b = torch.where(b_sing, 1.0, b)
    r2 = torch.where(b_sing, d, torch.expm1(b * d) / safe_b)
    elem = torch.where(pos, gn_b * (r2 - r1), r2 + 1.0 / safe_b)
    return (gsum_ff if stable else gsum)(elem, axes)


# Taylor coefficients of E2(s) = (s*exp(s) - expm1(s)) / s**2
#   = sum_{m>=0} (m+1)/(m+2)! * s**m  (``divergence.py:181-183``)
_E2_COEFFS = tuple((m + 1) / float(math.factorial(m + 2)) for m in range(11))


def _e2_from_expm1(s: torch.Tensor, em: torch.Tensor) -> torch.Tensor:
    """E2(s) given em = expm1(s), series-switched for |s| < 0.25
    (``divergence.py:100-110``)."""
    small = s.abs() < 0.25
    safe_s = torch.where(small, 1.0, s)
    e2_closed = (safe_s * (em + 1.0) - em) / (safe_s * safe_s)
    e2_series = torch.zeros_like(s) + _E2_COEFFS[-1]
    for c in _E2_COEFFS[-2::-1]:
        e2_series = e2_series * s + c
    return torch.where(small, e2_series, e2_closed)


def beta_div_with_dbeta(den: torch.Tensor, gn: torch.Tensor, beta,
                        log_gn: torch.Tensor, axes=(), stable: bool = False):
    """(beta_div per row, per-row sum of d betaDiv / d beta) in one pass
    (``divergence.py:113-161``); assumes gn > 0, as the solver floors it.
    On a CUDA tensor one launch of
    ``kernels.beta_divergence.beta_div_rows``, on a CPU tensor
    ``beta_div_with_dbeta_plain``. Under mesh axes the objective is
    all-reduced and the d/dbeta sums stay local, as in the plain
    version."""
    if not den.is_cuda:
        return beta_div_with_dbeta_plain(den, gn, beta, log_gn, axes, stable)
    fv, dsum = beta_divergence.beta_div_rows(den, gn, beta, log_gn, stable)
    return (axes.all_reduce(fv, 'sum') if axes else fv), dsum


def beta_div_with_dbeta_plain(den: torch.Tensor, gn: torch.Tensor, beta,
                              log_gn: torch.Tensor, axes=(),
                              stable: bool = False):
    """``beta_div_with_dbeta`` in plain PyTorch, on any device: the CUDA
    kernel's plain version."""
    b = _col(beta, den)
    e = b - 1.0
    d = torch.log(den / gn)
    gn_b = torch.exp(b * log_gn)
    t_small = _t_small(den.dtype)
    e_sing = e.abs() < t_small
    safe_e = torch.where(e_sing, 1.0, e)
    em_e = torch.expm1(e * d)
    r1 = torch.where(e_sing, d, em_e / safe_e)
    b_sing = b.abs() < t_small
    safe_b = torch.where(b_sing, 1.0, b)
    em_b = torch.expm1(b * d)
    r2 = torch.where(b_sing, d, em_b / safe_b)
    diff = r2 - r1
    fv = (gsum_ff if stable else gsum)(gn_b * diff, axes)
    e2b = _e2_from_expm1(b * d, em_b)
    e2e = _e2_from_expm1(e * d, em_e)
    dphi = gn_b * (log_gn * diff + (d * d) * (e2b - e2e))
    return fv, dphi.sum(-1)


def beta_div_special(den: torch.Tensor, gn: torch.Tensor,
                     beta: float) -> torch.Tensor:
    """The exact beta in {0, 1} branches of the reference betaDiv, per row
    (``divergence.py:164-170``)."""
    if beta == 0:
        return ((gn / den).sum(-1) - torch.log(gn / den).sum(-1)
                - gn.shape[-1])
    if beta == 1:
        return (gn * torch.log(gn / den)).sum(-1) - gn.sum(-1) + den.sum(-1)
    raise ValueError('only beta 0 or 1')


def beta_div_value(den, gn, beta):
    """Dispatch as the reference betaDiv does (``divergence.py:173-178``):
    a Python float 0.0 or 1.0 takes the exact branch."""
    if isinstance(beta, float) and beta in (0.0, 1.0):
        return beta_div_special(den, gn, beta)
    return beta_div(den, gn, beta)


def _dpow_kernel(t: torch.Tensor, v: torch.Tensor,
                 delta: torch.Tensor) -> torch.Tensor:
    """d/dt [(e^{t*u} - e^{t*v}) / t] with u = v + delta, free of
    cancellation at small t (``divergence.py:186-207``)."""
    s = t * delta
    em = torch.expm1(s)
    s_sing = s.abs() < torch.finfo(s.dtype).tiny
    safe_s = torch.where(s_sing, 1.0, s)
    e1 = torch.where(s_sing, 1.0, em / safe_s)
    e2 = _e2_from_expm1(s, em)
    return torch.exp(t * v) * delta * (v * e1 + delta * e2)


def beta_div_dbeta(den: torch.Tensor, gn: torch.Tensor, beta,
                   log_den: torch.Tensor | None = None,
                   log_ratio: torch.Tensor | None = None) -> torch.Tensor:
    """Elementwise d betaDiv / d beta (``divergence.py:210-234``):
    gn * K(beta - 1) - K(beta), K = ``_dpow_kernel``."""
    b = _col(beta, den)
    v = torch.log(den) if log_den is None else log_den
    delta = torch.log(gn / den) if log_ratio is None else log_ratio
    return gn * _dpow_kernel(b - 1.0, v, delta) - _dpow_kernel(b, v, delta)


def beta_grad_wrt_recon(AT, den: torch.Tensor, gn: torch.Tensor,
                        beta) -> torch.Tensor:
    """g = den^(beta-1) - AT(gn * den^(beta-2)) (``divergence.py:237-249``),
    den^(beta-1) taken as den^(beta-2) * den."""
    p2 = den ** (_col(beta, den) - 2.0)
    return p2 * den - AT(gn * p2)


def kl_grad_wrt_recon(AT, den: torch.Tensor, gn: torch.Tensor
                      ) -> torch.Tensor:
    """KL gradient g = 1 - AT(gn/den) (``divergence.py:252-254``)."""
    return 1.0 - AT(gn / den)


def lr_schedule(init_lr, k, epoch: torch.Tensor) -> torch.Tensor:
    """Exponentially decayed beta learning rate init_lr * exp(-k * epoch)
    (``divergence.py:257-260``); ``epoch`` is a tensor in the compute
    dtype."""
    return init_lr * torch.exp(-k * epoch)
