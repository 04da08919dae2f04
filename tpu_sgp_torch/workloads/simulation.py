"""Simulation ground-truth workload (SGP-dec fixtures).

Port of ``tpu_sgp/workloads/simulation.py:1``, the equivalent of the
reference's simulation_test_sgp.py: deconvolve the NGC7027 / satellite
fixtures with known truth and report rel_err; beta variants run the frozen
best beta-inits or a seeded 30-draw search. The search here is vectorized:
all 30 candidate solves run as one batch instead of a serial loop. Every
run takes a ``device`` (the card unless the caller passes ``'cpu'``;
``--device`` on the command line). ``dtype=None`` means float32, as in the
port's ``sgp``.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..api import sgp, sgp_beta_div
from ..config import SGPConfig
from ..device import resolve_device
from ..metrics import relative_error
from ..parallel.batch import restore_stamps

# the SGP-dec fixtures inside a checkout of the reference repository,
# relative to the working directory; they are not in this repository, so
# callers pass data_dir
DEFAULT_DATA_DIR = os.path.join('reference', 'restoration', 'simulated_test',
                                'data')

# Canonical SGP-dec iteration counts and frozen beta inits
NGC_MAXIT = 27
SAT_MAXIT = 332
NGC_BEST_BETA = 0.9887296104546054
SAT_BEST_BETA = 1.0001


# tpu_sgp/workloads/simulation.py:30
def load_fixture(name: str, data_dir: Optional[str] = None):
    """Load one SGP-dec .mat fixture -> (gn, psf, bkg_scalar, obj)."""
    from scipy.io import loadmat
    path = os.path.join(data_dir or DEFAULT_DATA_DIR, name)
    mat = loadmat(path)
    return (mat['gn'], mat['psf'], float(mat['bg'][0][0]), mat['obj'])


# tpu_sgp/workloads/simulation.py:38
def run_kl(fixture: str = 'NGC7027_255.mat', maxit: Optional[int] = None,
           data_dir: Optional[str] = None, dtype: Optional[str] = None,
           device=None):
    """KL-SGP on a fixture. Returns (deconv, rel_err, image, obj)."""
    device = resolve_device(device)
    gn, psf, bkg, obj = load_fixture(fixture, data_dir)
    if maxit is None:
        maxit = NGC_MAXIT if 'NGC' in fixture else SAT_MAXIT
    x, *_ = sgp(gn, psf, bkg, init_recon=3, stop_criterion=1, MAXIT=maxit,
                dtype=dtype, device=device)
    return x, relative_error(x, obj), gn, obj


# tpu_sgp/workloads/simulation.py:49
def run_beta(fixture: str = 'NGC7027_255.mat', maxit: Optional[int] = None,
             beta_init: Optional[float] = None, do_sampling: bool = False,
             n_draws: int = 30, data_dir: Optional[str] = None,
             dtype: Optional[str] = None, device=None):
    """beta-SGP on a fixture, optionally with the seeded beta-init search.

    With do_sampling, the reference's 30 serial candidate solves
    (simulation_test_sgp.py:65-96) become one batch.
    Returns (deconv, rel_err, image, obj, best_beta_init).
    """
    device = resolve_device(device)
    gn, psf, bkg, obj = load_fixture(fixture, data_dir)
    is_ngc = 'NGC' in fixture
    if maxit is None:
        maxit = NGC_MAXIT if is_ngc else SAT_MAXIT

    if do_sampling:
        np.random.seed(42)
        scale = 0.05 if is_ngc else 0.01
        draws = np.array([np.random.normal(loc=1.0, scale=scale)
                          for _ in range(n_draws)])
        cfg = SGPConfig(max_iter=maxit, stop_criterion=1, init_recon=3,
                        divergence='beta', adapt_beta=True, schedule_lr=True,
                        dtype=dtype or 'float32', has_flux=False)
        stamps = np.broadcast_to(gn, (n_draws,) + gn.shape)
        res = restore_stamps(stamps, psf, float(bkg), cfg, beta0=draws,
                             lr0=1e-3, device=device)
        restored = res.x.cpu().numpy()
        errs = [relative_error(restored[i], obj)
                for i in range(n_draws)]
        beta_init = float(draws[int(np.argmin(errs))])
    elif beta_init is None:
        beta_init = NGC_BEST_BETA if is_ngc else SAT_BEST_BETA

    x, *_ = sgp_beta_div(gn, psf, bkg, init_recon=3, stop_criterion=1,
                         MAXIT=maxit, betaParam=beta_init, lr=1e-3,
                         lr_exp_param=0.1, schedule_lr=True,
                         adapt_beta=False, dtype=dtype, device=device)
    return x, relative_error(x, obj), gn, obj, beta_init


# tpu_sgp/workloads/simulation.py:88
def run_all(data_dir: Optional[str] = None, device=None):
    """Run all four fixture/divergence combinations; return name->rel_err."""
    device = resolve_device(device)
    results = {}
    for name, fn in [
            ('ngc_kl', lambda: run_kl('NGC7027_255.mat', data_dir=data_dir,
                                      device=device)),
            ('sat_kl', lambda: run_kl('satellite_25500.mat',
                                      data_dir=data_dir, device=device)),
            ('ngc_beta', lambda: run_beta('NGC7027_255.mat',
                                          data_dir=data_dir, device=device)),
            ('sat_beta', lambda: run_beta('satellite_25500.mat',
                                          data_dir=data_dir, device=device))]:
        out = fn()
        results[name] = out[1]
        print(f'{name}: rel_err = {out[1]:.6f}')
    return results


# tpu_sgp/workloads/simulation.py:105
def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        description='SGP-dec simulation ground-truth workload '
                    '(NGC7027 + satellite fixtures, KL and beta).')
    p.add_argument('--data_dir', default=None,
                   help=f'directory with the .mat fixtures '
                        f'(default {DEFAULT_DATA_DIR})')
    p.add_argument('--device', default=None,
                   help="where to restore: the card by default, 'cpu' for "
                        'the CPU')
    args = p.parse_args(argv)
    return run_all(args.data_dir, device=args.device)


if __name__ == '__main__':
    main()
