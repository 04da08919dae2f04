"""Star-stamps workload: batched restoration of single-star cutouts.

Port of ``tpu_sgp/workloads/star_stamps.py:1``, the equivalent of the
reference's application_sgp_star_stamps.py: instead of a serial loop
running up to 6 solver calls per stamp, the workload gathers all
qualifying stamps on the host, then restores them as device batches (the
beta-init search runs the whole stamp x candidate grid at once). Produces
the same eight metric arrays with the reference's file names.

It differs from the JAX module in three places only: ``run`` takes a
``device`` (the card unless the caller passes ``'cpu'``; ``--device`` on
the command line) and hands it to every solve; results come back through
``.cpu().numpy()``; and the solve timer ends in a synchronisation with the
card.

Data modes:
  * real: a directory of frames ``ccfb*.fits`` with DIAPL ``.coo`` star
    lists and ``psf*_img.fits`` PSF matrices (the reference's M13 layout)
  * synthetic: deterministic generated stamps (no external data needed)
"""
from __future__ import annotations

import glob
import os
import random
from dataclasses import dataclass
from timeit import default_timer as timer
from typing import List, Optional

import numpy as np
import torch

from ..catalog import source_info, source_info_batch
from ..config import DEFAULT_COLUMNS, DEFAULT_PARAMS, SGPConfig
from ..device import resolve_device
from ..image import Cutout2D, getdata
from ..metrics import (fit_radprof, radial_profile, wasserstein_distance_norm)
from ..parallel.batch import (BETA_SEEDS, beta_init_search,
                              default_beta_candidates, restore_stamps)
from ..psf import read_coo
from ..simulate import synthetic_star_stamps

CUTOUT_SIZE = 31
CCD_SAT_LEVEL = 65000.0


# tpu_sgp/workloads/star_stamps.py:39
@dataclass
class StampSet:
    stamps: np.ndarray        # (B, 31, 31)
    psfs: np.ndarray          # (B, 31, 31) per-stamp PSF
    bkgs: np.ndarray          # (B,) background medians
    fluxes: np.ndarray        # (B,) catalog segment fluxes
    orig_tables: list         # per-stamp catalog tables (original)
    orig_bkg_maps: list       # per-stamp Background2D objects


# tpu_sgp/workloads/star_stamps.py:49
def _brightest(table) -> int:
    """Index of the brightest catalog row. The reference reads row 0 of the
    restored catalog (application_sgp_star_stamps.py:92), which is only
    correct when the deconvolved stamp yields exactly one segment; with a
    near-zero background the detection threshold collapses and low-flux
    ripple segments appear, so the brightest row is the star."""
    return int(np.argmax(np.asarray(table['segment_flux'].value)))


# the candidate grid lives in the library layer (ONE definition shared
# with beta_init_search); kept importable here for the workloads' callers
_beta_candidates = default_beta_candidates


def _sync(device: torch.device) -> None:
    """Wait for the card, so that a host timer measures its work."""
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


# tpu_sgp/workloads/star_stamps.py:63
def gather_real(data_dir: str, n_images: int = 100,
                seed: int = 42) -> StampSet:
    """Collect qualifying 31x31 single-source stamps from an M13-layout
    directory (same frame sampling, same filters as the reference)."""
    pats = (['ccfb*[!m]c1_*.fits', 'ccfb*[!m]c4_*.fits']
            + [f'ccfb*[!m]c2_{i}.fits' for i in (1, 2, 4, 5)]
            + [f'ccfb*[!m]c3_{i}.fits' for i in (1, 2, 4, 5)])
    image_list: List[str] = []
    for p in pats:
        image_list += glob.glob(os.path.join(data_dir, p))
    random.seed(seed)
    chosen = random.sample(image_list, min(n_images, len(image_list)))

    stamps, psfs, bkgs, fluxes, tables, bkg_maps = [], [], [], [], [], []
    for image_path in chosen:
        base = os.path.basename(image_path)
        subdivision = base.split('.fits')[0][-3:]
        coo_path = image_path.replace('.fits', '.coo')
        psf_path = os.path.join(
            data_dir, ('psf' + base).replace(f'c{subdivision}',
                                             f'_{subdivision}_img'))
        try:
            coords = read_coo(coo_path)
            img = getdata(image_path)
            psf = getdata(psf_path)
        except (OSError, ValueError):
            continue
        psf = psf / psf.sum()   # DIAPL-rendered PSFs are normalized, but
                                # roundoff-normalize defensively (the solver
                                # core asserts nothing; api-level callers get
                                # check_psf_normalized)
        for _, row in coords.iterrows():
            try:
                cut = Cutout2D(img, (row['x'], row['y']), size=CUTOUT_SIZE)
            except ValueError:
                continue
            if cut.data.shape != (CUTOUT_SIZE, CUTOUT_SIZE):
                continue
            scat, bkg = source_info(cut.data, localbkg_width=5)
            if scat is None or len(scat) != 1:
                continue
            t = scat.to_table(DEFAULT_COLUMNS)
            stamps.append(np.asarray(cut.data, np.float64))
            psfs.append(psf)
            bkgs.append(bkg.background_median)
            fluxes.append(float(t['segment_flux'].value[0]))
            tables.append(t)
            bkg_maps.append(bkg)
    if not stamps:
        raise RuntimeError(
            f'no qualifying stamps gathered from {data_dir!r}: check the '
            f'M13 layout (ccfb*.fits frames + .coo lists + psf*_img.fits) '
            f'and the exactly-one-source cutout filter')
    return StampSet(np.stack(stamps), np.stack(psfs), np.array(bkgs),
                    np.array(fluxes), tables, bkg_maps)


# tpu_sgp/workloads/star_stamps.py:120
def gather_synthetic(n: int = 256, seed: int = 42) -> StampSet:
    raw, psf, _, _ = synthetic_star_stamps(n, size=CUTOUT_SIZE, seed=seed)
    stamps, psfs, bkgs, fluxes, tables, bkg_maps = [], [], [], [], [], []
    for i in range(n):
        scat, bkg = source_info(raw[i], localbkg_width=5)
        if scat is None or len(scat) != 1:
            continue
        t = scat.to_table(DEFAULT_COLUMNS)
        stamps.append(raw[i])
        psfs.append(psf)
        bkgs.append(bkg.background_median)
        fluxes.append(float(t['segment_flux'].value[0]))
        tables.append(t)
        bkg_maps.append(bkg)
    if not stamps:
        raise RuntimeError(
            'no qualifying synthetic stamps (every cutout failed the '
            'exactly-one-source filter)')
    return StampSet(np.stack(stamps), np.stack(psfs), np.array(bkgs),
                    np.array(fluxes), tables, bkg_maps)


# tpu_sgp/workloads/star_stamps.py:142
def _workload_cfg(use_beta: bool, adapt: bool = True,
                  operator: str = 'auto') -> SGPConfig:
    max_projs, gamma, bt, a_min, a_max, alpha, m_alpha, tau, m = DEFAULT_PARAMS
    return SGPConfig(
        # MAXIT 500 = the reference solver default its script inherits
        # (application_sgp_star_stamps.py passes no MAXIT); an earlier 200
        # cap silently truncated slow-converging stamps
        max_iter=500, stop_criterion=3, tol_convergence=1e-4, init_recon=2,
        proj_type=1, max_projs=max_projs, gamma=gamma, bt_factor=bt,
        alpha_init=alpha, alpha_min=a_min, alpha_max=a_max, m_alpha=m_alpha,
        tau_init=tau, m_mem=m, has_flux=True, has_sat_level=True,
        divergence='beta' if use_beta else 'kl', adapt_beta=adapt,
        schedule_lr=use_beta, dtype='float32', operator=operator,
        # the workload reads x/iters only; with MAXIT=500 the tracked
        # series would be a (B, 501) buffer scattered every iteration
        track_discr=False)


# tpu_sgp/workloads/star_stamps.py:160
def run(data_dir: Optional[str] = None, use_beta_div: bool = True,
        n_images: int = 100, n_synthetic: int = 256, seed: int = 42,
        out_dir: str = '.', mesh=None, save: bool = True,
        device=None) -> dict:
    """Run the full workload; returns (and optionally saves) the metric
    arrays under the reference's file names. ``device``: where the stamps
    are restored, the card unless the caller passes ``'cpu'``."""
    device = resolve_device(device)
    if save:
        os.makedirs(out_dir, exist_ok=True)
    sset = (gather_real(data_dir, n_images, seed) if data_dir
            else gather_synthetic(n_synthetic, seed))
    b = sset.stamps.shape[0]
    # identical per-stamp PSFs collapse to one shared PSF, which selects the
    # dense-matmul operator instead of per-stamp FFTs
    psfs = sset.psfs
    if np.ptp(psfs, axis=0).max() == 0.0:
        psfs = psfs[0]

    # per-stamp PSFs must use the FFT operator ('auto' would materialize one
    # dense 961x961 matrix PER stamp — gigabytes at workload scale)
    cfg = _workload_cfg(use_beta_div,
                        operator='auto' if psfs.ndim == 2 else 'otf')
    if use_beta_div:
        # stage 1: candidate grid through the library's beta_init_search —
        # all five seeded inits per stamp in one batch, selected by the
        # reference's catalog flux-fractional-difference criterion
        # (application_sgp_star_stamps.py:90-97) via the batched catalog
        # pipeline (one vectorized pass over the B*K restorations instead
        # of B*K serial source_info calls — the round-2 host wall)
        best_betas, _, _grid = beta_init_search(
            sset.stamps, psfs, sset.bkgs, cfg, fluxes=sset.fluxes,
            sat_level=CCD_SAT_LEVEL, mesh=mesh, scorer='catalog',
            phase1_iters=32, bucket=True, device=device)
        best_betas = best_betas.cpu().numpy()
        _sync(device)
        t0 = timer()
        res = restore_stamps(sset.stamps, psfs, sset.bkgs, cfg,
                             fluxes=sset.fluxes, beta0=best_betas,
                             sat_level=CCD_SAT_LEVEL, mesh=mesh,
                             bucket=True, phase1_iters=32, device=device)
        _sync(device)
        solve_wall = timer() - t0
    else:
        _sync(device)
        t0 = timer()
        res = restore_stamps(sset.stamps, psfs, sset.bkgs, cfg,
                             fluxes=sset.fluxes, sat_level=CCD_SAT_LEVEL,
                             mesh=mesh, bucket=True, phase1_iters=32,
                             device=device)
        _sync(device)
        solve_wall = timer() - t0

    restored = res.x.cpu().numpy()
    iters = res.iters.cpu().numpy()

    metrics = {k: [] for k in (
        'FLUX_FRACTIONAL_DIFFERENCE', 'FWHM_RATIO', 'ELLIPTICITY_RATIO',
        'WD_RADIAL_PROFILE_DISTANCE', 'WD_FIT_OK', 'NUM_ITERS', 'EXEC_TIME',
        'ORIG_FLUX', 'RESTORED_FLUX')}
    # ONE threaded pass over all restored stamps (GIL-releasing natives;
    # result-identical to the serial loop) — a per-stamp serial
    # source_info here was the same host wall the batched candidate
    # scorer already removed from the search stage
    restored_cats = source_info_batch(list(restored), localbkg_width=5)
    for i in range(b):
        scat, rbkg = restored_cats[i]
        if scat is None or len(scat) == 0:
            continue
        rt = scat.to_table(DEFAULT_COLUMNS)
        ri = _brightest(rt)
        ot = sset.orig_tables[i]
        obkg = sset.orig_bkg_maps[i]
        orig_prof = radial_profile(
            sset.stamps[i] - obkg.background,
            (ot['xcentroid'].value[0], ot['ycentroid'].value[0]))
        rest_prof = radial_profile(
            restored[i] - rbkg.background,
            (rt['xcentroid'].value[ri], rt['ycentroid'].value[ri]))
        fo, _, fo_ok = fit_radprof(orig_prof, ot)
        fr, _, fr_ok = fit_radprof(rest_prof,
                                   {'fwhm': rt['fwhm'].value[ri:ri + 1]})

        metrics['ORIG_FLUX'].append(ot['segment_flux'].value[0])
        metrics['RESTORED_FLUX'].append(rt['segment_flux'].value[ri])
        metrics['FLUX_FRACTIONAL_DIFFERENCE'].append(
            1.0 - rt['segment_flux'].value[ri] / ot['segment_flux'].value[0])
        metrics['FWHM_RATIO'].append(
            rt['fwhm'].value[ri] / ot['fwhm'].value[0])
        metrics['ELLIPTICITY_RATIO'].append(
            rt['ellipticity'].value[ri] / max(ot['ellipticity'].value[0],
                                              1e-12))
        metrics['WD_RADIAL_PROFILE_DISTANCE'].append(
            wasserstein_distance_norm(fo, fr))
        # both profile fits converged (False => WD computed on a seed curve)
        metrics['WD_FIT_OK'].append(bool(fo_ok and fr_ok))
        metrics['NUM_ITERS'].append(int(iters[i]))
        # amortized per-stamp device wall for the batched solve
        metrics['EXEC_TIME'].append(solve_wall / b)

    if save:
        suffix = '_BETA' if use_beta_div else ''
        for name, vals in metrics.items():
            np.save(os.path.join(out_dir, f'{name}{suffix}.npy'),
                    np.asarray(vals))
    return metrics


# tpu_sgp/workloads/star_stamps.py:263
def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description='Batched star-stamp restoration workload')
    ap.add_argument('--data_dir', default=None,
                    help='M13-layout directory (frames + .coo + PSF FITS); '
                         'synthetic stamps when omitted')
    ap.add_argument('--n_images', type=int, default=100)
    ap.add_argument('--n_synthetic', type=int, default=256)
    ap.add_argument('--use_beta_div', action='store_true')
    ap.add_argument('--out_dir', default='.')
    ap.add_argument('--seed', type=int, default=42)
    ap.add_argument('--device', default=None,
                    help="where to restore: the card by default, 'cpu' for "
                         'the CPU')
    opt = ap.parse_args(argv)
    metrics = run(data_dir=opt.data_dir, use_beta_div=opt.use_beta_div,
                  n_images=opt.n_images, n_synthetic=opt.n_synthetic,
                  seed=opt.seed, out_dir=opt.out_dir, device=opt.device)
    for name in ('FLUX_FRACTIONAL_DIFFERENCE', 'FWHM_RATIO',
                 'ELLIPTICITY_RATIO', 'WD_RADIAL_PROFILE_DISTANCE',
                 'NUM_ITERS'):
        vals = np.asarray(metrics[name], float)
        if vals.size:
            print(f'{name}: median={np.median(vals):.4g} '
                  f'mean={np.nanmean(vals):.4g} n={vals.size}')
    return metrics


if __name__ == '__main__':
    main()
