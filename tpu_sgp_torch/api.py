"""NumPy-facing API on one image.

Port of ``tpu_sgp/api.py``: ``sgp`` and ``sgp_beta_div`` keep the
reference's argument names and its return tuple
``(x, iters, discr, times, err)``, as numpy values, and add one keyword,
``device``: the image is restored on the card unless the caller passes
``device='cpu'``. They are thin hosts around the batch-first solver in
``solvers.sgp``: the facade adds the batch axis and strips it again.

Kept on the host, as in the JAX package:
  * the PSF normalization check and the input checks (``ValueError``);
  * the ``init_recon=1`` start, Gaussian noise from ``np.random.seed(42)``;
  * the wall clock: the total time of the solve, synchronized with the
    card, in the last slot of ``times``, zeros elsewhere.
"""
from __future__ import annotations

from timeit import default_timer as timer

import numpy as np
import torch

from .config import SGPConfig
from .device import resolve_device
from .solvers.sgp import SGPResult, solve

PSF_NORM_TOL_FACTOR = 1e4  # * eps (api.py:26)


def check_psf_normalized(psf: np.ndarray) -> None:
    """|sum(psf) - 1| <= 1e4*eps, with eps at the PSF's own precision
    (``api.py:29-45``)."""
    psf = np.asarray(psf)
    eps = np.finfo(psf.dtype if np.issubdtype(psf.dtype, np.floating)
                   else np.float64).eps
    check = abs(float(np.sum(psf, dtype=np.float64)) - 1.0)
    tol = PSF_NORM_TOL_FACTOR * eps
    # `check > tol` is False for a NaN sum: a PSF with non-finite entries
    # must fail this check, not slide through a NaN comparison
    if not (check <= tol):
        raise ValueError(
            f'PSF is not normalized! Provide a normalized PSF! '
            f'\n\tsum(psf) - 1. = {check}, tolerance = {tol}')


def _validate_inputs(gn, bkg, flux, proj_type) -> None:
    """Reject degenerate inputs that the solver would turn into silent
    NaNs (``api.py:52-74``)."""
    if not np.isfinite(gn).all():
        raise ValueError('gn contains non-finite pixels; mask or repair '
                         'them before deconvolution.')
    bkg = np.asarray(bkg, np.float64)
    if not np.isfinite(bkg).all():
        raise ValueError('bkg contains non-finite values.')
    if not gn.any():
        raise ValueError('gn is identically zero — nothing to restore.')
    if proj_type == 1:
        resolved = (float(np.sum(gn - np.broadcast_to(bkg, gn.shape)))
                    if flux is None else float(flux))
        if not resolved > 0.0:
            hint = ' (computed as sum(gn - bkg))' if flux is None else ''
            raise ValueError(
                'flux-conserving projection (proj_type=1) needs a positive '
                f'total flux, got {resolved!r}{hint}.')


def _run(gn, psf, bkg, cfg: SGPConfig, flux, obj, beta0, lr0, sat_level,
         device=None):
    """``_run`` (``api.py:77-116``) around the batched solver: every image
    argument gains a leading batch axis of 1 and every result loses it."""
    # contiguous copies of views with negative strides (np.fliplr), which
    # torch.as_tensor refuses
    gn = np.ascontiguousarray(gn)
    psf = np.ascontiguousarray(psf)
    check_psf_normalized(psf)
    _validate_inputs(gn, bkg, flux, cfg.proj_type)
    if cfg.save:
        # the observed image in working units (api.py:82-89)
        import os

        from .image import write_fits
        from .solvers.sgp import SAVE_DIR
        os.makedirs(SAVE_DIR, exist_ok=True)
        scaled = gn / np.max(gn) if cfg.scale_data else gn
        write_fits(os.path.join(SAVE_DIR, 'orig.fits'), scaled)
    dev = resolve_device(device)
    bkg_arr = np.broadcast_to(np.asarray(bkg, dtype=np.float64),
                              gn.shape).copy()
    if cfg.init_recon == 1:
        np.random.seed(42)
        x0 = np.random.randn(*gn.shape)
    else:
        x0 = np.zeros(gn.shape)
    flux_in = 0.0 if flux is None else float(np.sum(flux))
    obj_in = np.zeros(gn.shape) if obj is None else np.asarray(obj)
    sat_in = 0.0 if sat_level is None else float(sat_level)

    def sync():
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)

    sync()
    t0 = timer()
    res: SGPResult = solve(gn[None], psf, bkg_arr[None], x0[None], flux_in,
                           obj_in[None], beta0, lr0, sat_in, cfg, device=dev)
    res = SGPResult(*(a[0].cpu().numpy() for a in res))
    sync()
    wall = timer() - t0

    iters = int(res.iters)
    discr = res.discr[:iters + 1]
    times = np.zeros(iters + 1)
    times[-1] = wall
    err = res.err[:iters + 1] if cfg.errflag else None
    return res.x, iters, discr, times, err, res


def _operator_for(gn, psf, operator, use_original_SGP_Afunction) -> str:
    """The operator remaps of ``api.py:129-132``."""
    if not use_original_SGP_Afunction and operator == 'auto':
        operator = 'linear'
    if tuple(np.shape(psf)) != tuple(gn.shape):
        operator = 'linear'
    return operator


def sgp(gn, psf, bkg, init_recon=0, proj_type=0, stop_criterion=0, MAXIT=500,
        gamma=1e-4, beta=0.4, alpha=1.3, alpha_min=1e-5, alpha_max=1e5,
        M_alpha=3, tau=0.5, M=1, max_projs=1000, save=False, obj=None,
        verbose=True, flux=None, ccd_sat_level=None, scale_data=True,
        errflag=False, tol_convergence=1e-4, use_original_SGP_Afunction=True,
        dtype=None, operator='auto', device=None):
    """KL-SGP restoration of one image (``api.py:119-145``); drop-in for
    the reference ``sgp``. ``dtype=None`` means ``'float32'``."""
    if errflag and obj is None:
        raise ValueError(
            'errflag was set to True but no ground-truth was passed.')
    gn = np.asarray(gn)
    cfg = SGPConfig(
        max_iter=MAXIT, stop_criterion=stop_criterion,
        tol_convergence=tol_convergence, init_recon=init_recon,
        proj_type=proj_type, max_projs=max_projs, gamma=gamma,
        bt_factor=beta, m_mem=M, alpha_init=alpha, alpha_min=alpha_min,
        alpha_max=alpha_max, m_alpha=M_alpha, tau_init=tau,
        scale_data=scale_data, divergence='kl', errflag=errflag,
        save=save, verbose=verbose, has_flux=flux is not None,
        has_sat_level=ccd_sat_level is not None,
        dtype=dtype or 'float32',
        operator=_operator_for(gn, psf, operator,
                               use_original_SGP_Afunction))
    x, iters, discr, times, err, _ = _run(
        gn, psf, bkg, cfg, flux, obj, 1.0, 1e-3, ccd_sat_level, device)
    return x, iters, discr, times, err


def sgp_beta_div(gn, psf, bkg, init_recon=0, proj_type=0, stop_criterion=0,
                 MAXIT=500, gamma=1e-4, beta=0.4, alpha=1.3, alpha_min=1e-5,
                 alpha_max=1e5, M_alpha=3, tau=0.5, M=1, max_projs=1000,
                 save=False, obj=None, verbose=True, flux=None,
                 ccd_sat_level=None, scale_data=True, errflag=False,
                 adapt_beta=True, betaParam=1.005, lr=1e-3, lr_exp_param=0.1,
                 schedule_lr=False, tol_convergence=1e-4,
                 use_original_SGP_Afunction=True, dtype=None,
                 operator='auto', device=None):
    """beta-SGP restoration of one image (``api.py:148-186``); drop-in for
    the reference ``sgp_betaDiv``. As in the JAX package, ``errflag=True``
    returns the relative-error series against ``obj`` as the fifth
    element."""
    if errflag and obj is None:
        raise ValueError(
            'errflag was set to True but no ground-truth was passed.')
    gn = np.asarray(gn)
    cfg = SGPConfig(
        max_iter=MAXIT, stop_criterion=stop_criterion,
        tol_convergence=tol_convergence, init_recon=init_recon,
        proj_type=proj_type, max_projs=max_projs, gamma=gamma,
        bt_factor=beta, m_mem=M, alpha_init=alpha, alpha_min=alpha_min,
        alpha_max=alpha_max, m_alpha=M_alpha, tau_init=tau,
        scale_data=scale_data, divergence='beta', adapt_beta=adapt_beta,
        schedule_lr=schedule_lr, lr_exp_param=lr_exp_param, errflag=errflag,
        save=save, verbose=verbose, has_flux=flux is not None,
        has_sat_level=ccd_sat_level is not None,
        dtype=dtype or 'float32',
        operator=_operator_for(gn, psf, operator,
                               use_original_SGP_Afunction))
    x, iters, discr, times, err, _ = _run(
        gn, psf, bkg, cfg, flux, obj, betaParam, lr, ccd_sat_level, device)
    return x, iters, discr, times, err


# Alias matching the reference spelling.
sgp_betaDiv = sgp_beta_div
