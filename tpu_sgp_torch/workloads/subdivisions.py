"""Subdivision workload: whole-frame deconvolution of a 410x410 subframe.

Port of ``tpu_sgp/workloads/subdivisions.py:1``, the equivalent of the
reference's application_sgp_subdivisions.py: detect sources on the frame,
deconvolve it whole with the linear-convolution operator (31x31 PSF !=
frame shape), tol 1e-5, optional beta-init search over the reference's
five seeded candidates, then persist iteration/time/flux artifacts with
the reference's SUBDIV_* names. ``run`` takes a ``device`` (the card
unless the caller passes ``'cpu'``) for every solve; ``sgp`` and
``sgp_beta_div`` return numpy and synchronise their own timer.
"""
from __future__ import annotations

import os
from timeit import default_timer as timer
from typing import Optional

import numpy as np

from ..api import sgp, sgp_beta_div
from ..catalog import source_info
from ..config import DEFAULT_COLUMNS, DEFAULT_PARAMS
from ..device import resolve_device
from ..image import getdata, write_fits
from ..simulate import synthetic_star_field
from .star_stamps import _beta_candidates

TOL_CONVERGENCE = 1e-5
CCD_SAT_LEVEL = 65000.0


# tpu_sgp/workloads/subdivisions.py:28
def run(image_path: Optional[str] = None, psf_path: Optional[str] = None,
        use_beta_div: bool = True, crowded: bool = True,
        out_dir: str = '.', save: bool = True, dtype: str = 'float32',
        maxit: int = 500, warm: bool = True, device=None) -> dict:
    device = resolve_device(device)
    if save:
        os.makedirs(out_dir, exist_ok=True)
    if image_path:
        if not psf_path:
            raise ValueError('image_path requires psf_path (a rendered '
                             'PSF FITS, e.g. psf*_img.fits)')
        image = getdata(image_path)
        psf = getdata(psf_path)
    else:
        n_stars = 400 if crowded else 60
        image, psf, _ = synthetic_star_field(410, 410, n_stars=n_stars,
                                             seed=42)
    psf = psf / psf.sum()

    # reference source_info parameters: box_size=60 for both catalogs,
    # n_pixels=5 on the original image, n_pixels=1 on reconstructions
    # (application_sgp_subdivisions.py:62,92,118)
    scat, bkg = source_info(image, box_size=(60, 60), n_pixels=5)
    if scat is None or len(scat) == 0:
        raise RuntimeError('no sources detected on the input frame; the '
                           'subdivision workload needs a catalog flux')
    table = scat.to_table(DEFAULT_COLUMNS)
    flux = float(np.sum(table['segment_flux'].value))
    n_orig = len(table)

    # solver hyperparameters exactly as the reference script passes them:
    # the DEFAULT_PARAMS tuple (incl. alpha=10, not the sgp() default 1.3)
    # and adapt_beta=False (application_sgp_subdivisions.py:85-112 — the
    # STAR-STAMPS script adapts beta; this one does not)
    max_projs, gamma, bt, a_min, a_max, alpha, m_alpha, tau, m = \
        DEFAULT_PARAMS
    common = dict(init_recon=2, proj_type=1, stop_criterion=3,
                  flux=flux, scale_data=True, ccd_sat_level=CCD_SAT_LEVEL,
                  tol_convergence=TOL_CONVERGENCE, MAXIT=maxit,
                  max_projs=max_projs, gamma=gamma, beta=bt,
                  alpha_min=a_min, alpha_max=a_max, alpha=alpha,
                  M_alpha=m_alpha, tau=tau, M=m,
                  use_original_SGP_Afunction=False, dtype=dtype,
                  device=device)

    best_beta = None
    if use_beta_div:
        cands = _beta_candidates()
        best_beta, best_ffd = None, np.inf
        for cand in cands:
            x, iters, _, times, _ = sgp_beta_div(
                image, psf, bkg.background, betaParam=float(cand), lr=1e-3,
                lr_exp_param=0.1, schedule_lr=True, adapt_beta=False,
                **common)
            rscat, _ = source_info(x, box_size=(60, 60), n_pixels=1)
            if rscat is None or len(rscat) == 0:
                continue
            rt = rscat.to_table(['segment_flux'])
            ffd = 1.0 - float(np.sum(rt['segment_flux'].value)) / flux
            if ffd < best_ffd:
                best_ffd, best_beta = ffd, float(cand)
        if best_beta is None:
            raise RuntimeError(
                'no beta candidate produced a detectable restoration '
                '(all candidate reconstructions yielded empty catalogs) — '
                'cannot select a beta init')
        t0 = timer()
        x, iters, _, times, _ = sgp_beta_div(
            image, psf, bkg.background, betaParam=best_beta, lr=1e-3,
            lr_exp_param=0.1, schedule_lr=True, adapt_beta=False, **common)
        wall = timer() - t0
    else:
        if warm:  # compile outside the timed window
            sgp(image, psf, bkg.background, **common)
        t0 = timer()
        x, iters, _, times, _ = sgp(image, psf, bkg.background, **common)
        wall = timer() - t0

    rscat, _ = source_info(x, box_size=(60, 60), n_pixels=1)
    rt = (rscat.to_table(DEFAULT_COLUMNS)
          if rscat is not None and len(rscat) else None)
    restored_fluxes = (np.asarray(rt['segment_flux'].value)
                       if rt is not None else np.zeros(0))

    out = {
        'iters': iters, 'wall': wall, 'best_beta': best_beta,
        'n_orig_detections': n_orig,
        'n_restored_detections': 0 if rt is None else len(rt),
        'orig_fluxes': np.asarray(table['segment_flux'].value),
        'restored_fluxes': restored_fluxes,
        'restored': x, 'original': image,
    }
    if save:
        prefix = 'CROWDED_SUBDIV_' if crowded else 'SUBDIV_'
        suffix = '_BETA' if use_beta_div else ''
        np.save(os.path.join(out_dir, f'{prefix}NUM_ITERS{suffix}.npy'),
                np.array([iters]))
        np.save(os.path.join(out_dir, f'{prefix}EXEC_TIME{suffix}.npy'),
                np.array([wall]))
        np.save(os.path.join(out_dir,
                             f'{prefix}ORIG_FLUX{suffix}.npy'),
                out['orig_fluxes'])
        np.save(os.path.join(out_dir,
                             f'{prefix}RESTORED_FLUX{suffix}.npy'),
                restored_fluxes)
        if use_beta_div:
            np.save(os.path.join(out_dir,
                                 f'{prefix}BEST_BETA_INIT.npy'),
                    np.array([best_beta]))
        write_fits(os.path.join(out_dir, f'{prefix.lower()}orig.fits'),
                   image)
        write_fits(os.path.join(out_dir, f'{prefix.lower()}restored{suffix}.fits'),
                   x)
    return out


# tpu_sgp/workloads/subdivisions.py:142
def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description='Whole-frame subdivision restoration workload')
    ap.add_argument('--image', default=None)
    ap.add_argument('--psf', default=None)
    ap.add_argument('--use_beta_div', action='store_true')
    ap.add_argument('--sparse', action='store_true')
    ap.add_argument('--out_dir', default='.')
    ap.add_argument('--device', default=None,
                    help="where to restore: the card by default, 'cpu' for "
                         'the CPU')
    opt = ap.parse_args(argv)
    out = run(image_path=opt.image, psf_path=opt.psf,
              use_beta_div=opt.use_beta_div, crowded=not opt.sparse,
              out_dir=opt.out_dir, device=opt.device)
    print(f"iters={out['iters']} wall={out['wall']:.3f}s "
          f"detections {out['n_orig_detections']}->"
          f"{out['n_restored_detections']} best_beta={out['best_beta']}")
    return out


if __name__ == '__main__':
    main()
