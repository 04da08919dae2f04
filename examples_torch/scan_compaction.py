"""Scan of the convergence-compaction settings (p1, tail_bucket) for the
bench's KL and beta stamp batches (the port of
``examples/scan_compaction.py``). A record of method, not part of the
shipping API: it prints findings and changes no constant.

Every grid point restores the same B=12288 stamps through
``restore_stamps(..., flatten=True, phase1_iters=p1, tail_bucket=tail)``
and prints stamps/s from the best of ``repeats`` walls (each ending in the
iteration counts on the host, which waits for the card) and the lanes
still running after phase 1. PyTorch compiles nothing per grid point, so
one untimed call before the grid takes the first-use costs (the JAX script
compiles, and warms, each point).

Usage: python examples_torch/scan_compaction.py [kl|beta] [repeats]
[--device cpu] [--stamps N] [--grid P1:TAIL,...] (the card unless given
``--device cpu``; raises without a card; ``--stamps`` and ``--grid``
shrink the scan for a quick check on the CPU)
"""
import argparse
import functools
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu_sgp_torch import SGPConfig  # noqa: E402
from tpu_sgp_torch.device import resolve_device  # noqa: E402
from tpu_sgp_torch.parallel.batch import restore_stamps  # noqa: E402
from tpu_sgp_torch.simulate import synthetic_star_stamps  # noqa: E402

B, SIZE = 12288, 31
# bench.py:630-633, the default projection ('bisect', the guided secant)
KL_CFG = dict(max_iter=100, stop_criterion=3, tol_convergence=1e-4,
              init_recon=2, proj_type=1, has_flux=True, has_sat_level=True,
              dtype='float32', divergence='kl', track_discr=False)
KL_GRID = [(26, 2048), (25, 4096), (24, 4096), (25, 3072), (26, 3072)]
# bench.py:215-241: the beta workload keeps the cold sectioning
BETA_CFG = dict(KL_CFG, divergence='beta', adapt_beta=True,
                schedule_lr=True, projection_method='section')
BETA_EXTRA = dict(beta0=1.005, lr0=1e-3)
BETA_GRID = [(28, 2048), (29, 2048), (30, 2048), (28, 3072), (30, 1024),
             (26, 2048), (27, 3072)]


@functools.lru_cache(maxsize=1)
def stamps_of(n: int):
    """The scan's seeded stamps, PSF, backgrounds and bench fluxes (made
    once a process: the KL and beta scans restore the same stamps)."""
    stamps, psf, bkgs, _ = synthetic_star_stamps(n, size=SIZE, seed=42)
    # bench.py's flux convention: background-subtracted sum (the catalog-
    # flux analog), NOT the generator's noise-free truth fluxes
    return stamps, psf, bkgs, stamps.sum(axis=(1, 2)) - SIZE * SIZE * bkgs


def run(which: str = 'kl', repeats: int = 8, device=None, n: int = B,
        grid=None) -> list:
    """Scan ``grid`` (the JAX script's grid of ``which`` when None) on
    ``n`` stamps on ``device`` (the card when None). Returns one dict a
    grid point: p1, tail, wall (best of ``repeats``), stamps/s and the
    lanes unconverged at p1."""
    dev = resolve_device(device)
    stamps, psf, bkgs, fluxes = (
        torch.as_tensor(a, dtype=torch.float32, device=dev)
        for a in stamps_of(n))
    if which == 'kl':
        cfg, extra = SGPConfig(**KL_CFG), {}
        grid = KL_GRID if grid is None else grid
    elif which == 'beta':
        cfg, extra = SGPConfig(**BETA_CFG), BETA_EXTRA
        grid = BETA_GRID if grid is None else grid
    else:
        raise ValueError(f"which must be 'kl' or 'beta', got {which!r}")

    def restore(p1, tail):
        res = restore_stamps(stamps, psf, bkgs, cfg, fluxes=fluxes,
                             sat_level=65000.0, flatten=True,
                             phase1_iters=p1, tail_bucket=tail, **extra)
        return res.iters.cpu().numpy()     # waits for the card

    restore(*grid[0])
    points = []
    for p1, tail in grid:
        walls = []
        for i in range(repeats):
            t0 = time.perf_counter()
            iters = restore(p1, tail)
            walls.append(time.perf_counter() - t0)
            if i == 0:
                unconv = int((iters >= p1).sum())
        wall = min(walls)
        points.append({'which': which, 'p1': p1, 'tail': tail, 'n': n,
                       'wall_s': wall, 'stamps_s': n / wall,
                       'unconverged': unconv,
                       'iters_median': float(np.median(iters)),
                       'iters_max': int(iters.max())})
    return points


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('which', nargs='?', default='kl', choices=('kl', 'beta'))
    ap.add_argument('repeats', nargs='?', type=int, default=8)
    ap.add_argument('--device', default=None,
                    help="where to compute: the card unless 'cpu'")
    ap.add_argument('--stamps', type=int, default=B,
                    help=f'stamps in the batch (the JAX script: {B})')
    ap.add_argument('--grid', default=None,
                    help="'p1:tail,...' (default: the JAX script's grid)")
    args = ap.parse_args(argv)
    grid = (None if args.grid is None else
            [tuple(int(v) for v in point.split(':'))
             for point in args.grid.split(',')])
    dev = resolve_device(args.device)
    print('device: ' + (f'{dev} ({torch.cuda.get_device_name(dev)})'
                        if dev.type == 'cuda' else str(dev)))
    for p in run(args.which, args.repeats, dev, args.stamps, grid):
        print(f'{p["which"]} p1={p["p1"]} tail={p["tail"]}: '
              f'{p["stamps_s"]:,.0f} stamps/s (wall {p["wall_s"] * 1e3:.1f} '
              f'ms, unconverged@p1={p["unconverged"]})', flush=True)


if __name__ == '__main__':
    main()
