"""Timing of the halo operator's LOCAL apply against the single-device
linear operator (the port of ``examples/time_halo_operator.py``).

The halo operator (``ops/psf_operator.make_halo_operator``) applies a
local rFFT valid-convolution to the halo-extended tile: the semantics of
the padded-rFFT linear operator, plus the halo exchange with the mesh
neighbours. On a 1x1 mesh the exchange degenerates to zero halos with no
communication, so timing it there isolates the local apply's cost; the
JAX package's criterion is the local apply within ~2x of the linear
operator at the same tile size.

Each timed run chains the A+AT apply ``chain`` times in a Python loop
with one synchronisation at its end (the JAX script chains them inside
one jit), so the per-apply cost is wall / chain. float32, as the JAX
script.

Usage: python examples_torch/time_halo_operator.py [tile_h] [repeats]
[chain] [--device cpu]. It starts a world of one rank itself (NCCL on the
card, gloo with ``--device cpu``; raises without a card unless given
``--device cpu``). From a running world, call ``run`` with a 1x1 mesh of
the calling rank.
"""
import argparse
import os
import socket
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu_sgp_torch.device import resolve_device  # noqa: E402
from tpu_sgp_torch.ops.mesh import MeshAxes  # noqa: E402
from tpu_sgp_torch.ops.psf_operator import (make_halo_operator,  # noqa: E402
                                            make_linear_operator)
from tpu_sgp_torch.parallel.distributed import make_image_mesh  # noqa: E402
from tpu_sgp_torch.parallel.multiprocess import init_distributed  # noqa: E402
from tpu_sgp_torch.simulate import gaussian_psf  # noqa: E402


def _min_wall(fn, repeats):
    fn()
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return min(walls)


def run(mesh, tile: int = 410, repeats: int = 30, chain: int = 50) -> dict:
    """Time A+AT of both operators on a ``tile`` x ``tile`` float32 image
    on ``mesh``, a 1x1 ('ty', 'tx') mesh of the calling rank: returns
    every number ``main`` prints."""
    dev = (torch.device('cuda', torch.cuda.current_device())
           if mesh.device_type == 'cuda' else torch.device(mesh.device_type))
    axes = MeshAxes(mesh, ('ty', 'tx'))
    if axes.size != 1:
        raise ValueError(f'the local apply is timed on a 1x1 mesh, got '
                         f'{axes.shape}')
    rng = np.random.default_rng(7)
    img = torch.as_tensor(rng.uniform(10, 1000, (1, tile, tile)),
                          dtype=torch.float32, device=dev)
    psf = torch.as_tensor(gaussian_psf(31, fwhm=3.0), dtype=torch.float32,
                          device=dev)

    def chained(apply):
        # AT(A(x)) with a unit-sum PSF preserves the image sum, so the
        # chain stays numerically bounded without rescaling
        def run_chain():
            x = img
            for _ in range(chain):
                x = apply(x)
            if dev.type == 'cuda':
                torch.cuda.synchronize(dev)
            return x
        return run_chain

    # -- linear operator (single-device reference) -------------------------
    A_lin, AT_lin = make_linear_operator(psf, (tile, tile))
    w_lin = _min_wall(chained(lambda x: AT_lin(A_lin(x))), repeats)

    # -- halo operator local apply on the 1x1 mesh -------------------------
    A_h, AT_h = make_halo_operator(psf, (tile, tile), axes)
    w_halo = _min_wall(chained(lambda x: AT_h(A_h(x))), repeats)

    # -- agreement check (single apply) -------------------------------------
    a = AT_lin(A_lin(img)).cpu().numpy()
    b = AT_h(A_h(img)).cpu().numpy()
    rel = float(np.abs(a - b).max() / np.abs(a).max())
    return {'device': dev, 'tile': tile, 'repeats': repeats, 'chain': chain,
            'linear_wall_s': w_lin, 'halo_wall_s': w_halo,
            'ratio': w_halo / w_lin, 'max_rel_diff': rel}


def world_of_one(device=None):
    """Join a process group of this process alone (NCCL on the card, gloo
    on the CPU) and return its 1x1 ('ty', 'tx') mesh."""
    dev = resolve_device(device)
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    cuda = dev.type == 'cuda'
    init_distributed(f'127.0.0.1:{port}', 1, 0,
                     local_device_ids=[dev.index or 0] if cuda else None,
                     backend='nccl' if cuda else 'gloo')
    return make_image_mesh(device_type=dev.type)


def device_name(dev: torch.device) -> str:
    return (f'{dev} ({torch.cuda.get_device_name(dev)})'
            if dev.type == 'cuda' else str(dev))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('tile', nargs='?', type=int, default=410)
    ap.add_argument('repeats', nargs='?', type=int, default=30)
    ap.add_argument('chain', nargs='?', type=int, default=50)
    ap.add_argument('--device', default=None,
                    help="where to compute: the card unless 'cpu'")
    args = ap.parse_args(argv)
    mesh = world_of_one(args.device)
    try:
        r = run(mesh, args.tile, args.repeats, args.chain)
    finally:
        dist.destroy_process_group()
    chain, w_lin, w_halo = r['chain'], r['linear_wall_s'], r['halo_wall_s']
    print(f'device: {device_name(r["device"])}, a one-rank '
          f'{"nccl" if r["device"].type == "cuda" else "gloo"} world')
    print(f'tile={r["tile"]} repeats={r["repeats"]} chain={chain}')
    print(f'linear A+AT: {w_lin * 1e3 / chain:.3f} ms/apply '
          f'(min wall {w_lin * 1e3:.1f} ms / {chain})')
    print(f'halo   A+AT: {w_halo * 1e3 / chain:.3f} ms/apply '
          f'(min wall {w_halo * 1e3:.1f} ms / {chain})  '
          f'ratio={r["ratio"]:.2f}x')
    print(f'max rel diff (single apply): {r["max_rel_diff"]:.2e}')


if __name__ == '__main__':
    main()
