"""End-to-end demo: simulate a star field, deconvolve it three ways, and
report restoration quality (the port of ``examples/deconvolve_demo.py``).

Run from the repo root:  python examples_torch/deconvolve_demo.py
[--device cpu] (computes on the card unless given ``--device cpu``, and
raises without a card; writes demo outputs to ./demo_out). The facade
computes in float32, the port's default (the JAX facade's dtype follows
JAX's x64 flag).
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu_sgp_torch import SGPConfig, sgp, sgp_beta_div  # noqa: E402
from tpu_sgp_torch.catalog import source_info  # noqa: E402
from tpu_sgp_torch.device import resolve_device  # noqa: E402
from tpu_sgp_torch.image import write_fits  # noqa: E402
from tpu_sgp_torch.metrics import relative_error  # noqa: E402
from tpu_sgp_torch.parallel.batch import restore_stamps  # noqa: E402
from tpu_sgp_torch.simulate import (synthetic_star_field,  # noqa: E402
                                    synthetic_star_stamps)


def run(device=None, out_dir='demo_out') -> dict:
    """The demo's three restorations on ``device`` (the card when None):
    returns every number ``main`` prints, and the largest flux error and
    the finiteness of the restorations, for a caller to check."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)

    # 1. whole-image KL and beta deconvolution ------------------------------
    image, psf, truth = synthetic_star_field(256, 256, n_stars=60, seed=7)
    scat, bkg = source_info(image)
    flux = float(np.sum(scat.to_table(['segment_flux'])['segment_flux'].value))

    x_kl, it_kl, _, _, _ = sgp(image, psf, bkg.background, init_recon=2,
                               proj_type=1, stop_criterion=3, flux=flux,
                               ccd_sat_level=65000.0, MAXIT=200,
                               use_original_SGP_Afunction=False, device=dev)
    x_b, it_b, _, _, _ = sgp_beta_div(image, psf, bkg.background,
                                      init_recon=2, proj_type=1,
                                      stop_criterion=3, flux=flux,
                                      ccd_sat_level=65000.0, MAXIT=200,
                                      betaParam=1.005, schedule_lr=True,
                                      use_original_SGP_Afunction=False,
                                      device=dev)
    write_fits(os.path.join(out_dir, 'field_orig.fits'), image)
    write_fits(os.path.join(out_dir, 'field_kl.fits'), x_kl)
    write_fits(os.path.join(out_dir, 'field_beta.fits'), x_b)

    # 2. a batch of star stamps in one solve --------------------------------
    stamps, spsf, bkgs, _ = synthetic_star_stamps(128, seed=11)
    fluxes = stamps.sum(axis=(1, 2)) - 31 * 31 * bkgs
    cfg = SGPConfig(max_iter=100, stop_criterion=3, init_recon=2,
                    proj_type=1, has_flux=True, has_sat_level=True,
                    dtype='float32')
    t0 = time.perf_counter()
    res = restore_stamps(stamps, spsf, bkgs, cfg, fluxes=fluxes,
                         sat_level=65000.0, device=dev)
    iters = res.iters.cpu().numpy()  # waits for the card: inside the window
    wall = time.perf_counter() - t0
    x = res.x.double().cpu().numpy()
    return {'device': dev, 'n_sources': len(scat), 'flux': flux,
            # what the flux-conserving projection holds: sum(x) = flux
            'flux_err': max(abs(float(np.sum(x_kl)) / flux - 1),
                            abs(float(np.sum(x_b)) / flux - 1),
                            float(np.abs(x.sum((1, 2)) / fluxes - 1).max())),
            'finite': bool(np.isfinite(x_kl).all() and np.isfinite(x_b).all()
                           and np.isfinite(x).all()),
            'kl_iters': it_kl,
            'kl_rel_err': relative_error(np.maximum(x_kl, 0), truth + 150),
            'beta_iters': it_b,
            'beta_rel_err': relative_error(np.maximum(x_b, 0), truth + 150),
            'stamps': len(stamps), 'stamps_wall_s': wall,
            'stamps_median_iters': int(np.median(iters))}


def device_name(dev: torch.device) -> str:
    return (f'{dev} ({torch.cuda.get_device_name(dev)})'
            if dev.type == 'cuda' else str(dev))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--device', default=None,
                    help="where to compute: the card unless 'cpu'")
    r = run(ap.parse_args(argv).device)
    print(f'device: {device_name(r["device"])}')
    print(f'simulated field: {r["n_sources"]} detected sources, flux '
          f'{r["flux"]:.0f}')
    print(f'KL-SGP:   {r["kl_iters"]} iters, rel_err vs truth '
          f'{r["kl_rel_err"]:.4f}')
    print(f'beta-SGP: {r["beta_iters"]} iters, rel_err vs truth '
          f'{r["beta_rel_err"]:.4f}')
    print(f'batched stamps: {r["stamps"]} restorations in '
          f'{r["stamps_wall_s"] * 1e3:.0f}ms (median '
          f'{r["stamps_median_iters"]} iters) incl. first use')


if __name__ == '__main__':
    main()
