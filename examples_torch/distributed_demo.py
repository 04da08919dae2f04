"""Multi-device demo: shard one large image (and a batch of them) over a
device mesh and deconvolve with halo-exchange convolution (the port of
``examples/distributed_demo.py``).

The port runs SPMD over ``torch.distributed``: one process a rank, every
rank running this script with the same inputs and getting the whole
result. Launch it with ``torchrun``, one rank a card (NCCL):

  torchrun --nproc-per-node=<cards> examples_torch/distributed_demo.py

or as gloo ranks on the CPU, the counterpart of the JAX demo's virtual CPU
mesh:

  torchrun --nproc-per-node=8 examples_torch/distributed_demo.py --device cpu

Run with plain ``python`` it is a world of one rank (NCCL on the card,
gloo with ``--device cpu``). Without a card it raises unless given
``--device cpu``. From a running world (``parallel.multiprocess.
init_distributed``), call ``run`` on every rank.
"""
import argparse
import os
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu_sgp_torch import SGPConfig  # noqa: E402
from tpu_sgp_torch.device import resolve_device  # noqa: E402
from tpu_sgp_torch.metrics import relative_error  # noqa: E402
from tpu_sgp_torch.parallel.distributed import (  # noqa: E402
    make_batch_image_mesh, make_image_mesh, solve_distributed,
    solve_distributed_batch)
from tpu_sgp_torch.parallel.multiprocess import init_distributed  # noqa: E402
from tpu_sgp_torch.simulate import synthetic_star_field  # noqa: E402

CFG = dict(max_iter=60, stop_criterion=3, tol_convergence=1e-5,
           init_recon=2, proj_type=1, has_flux=False, has_sat_level=False,
           dtype='float32')


def run(device=None) -> dict:
    """Both solves over the world's ranks, on the card unless ``device``
    is 'cpu'; every rank calls it. Returns every number ``main`` prints,
    and the inputs and results (numpy), the same on every rank."""
    dev_type = resolve_device(device).type
    n = dist.get_world_size()
    every = [None] * n
    dist.all_gather_object(every, str(
        torch.device('cuda', torch.cuda.current_device())
        if dev_type == 'cuda' else torch.device('cpu')))
    cfg = SGPConfig(**CFG)

    # 1. one large image over a 2-D (ty, tx) mesh ---------------------------
    mesh = make_image_mesh(device_type=dev_type)
    ty, tx = mesh.shape
    h, w = 128 * ty, 128 * tx
    image, psf, truth = synthetic_star_field(h, w, n_stars=40, psf_size=31,
                                             fwhm=2.5, seed=3)
    res = solve_distributed(image, psf, 150.0, cfg, mesh)
    x = res.x.cpu().numpy()

    # 2. a batch of images over a 3-D (batch, ty, tx) mesh ------------------
    mesh3 = make_batch_image_mesh(device_type=dev_type)
    nb, ty3, tx3 = mesh3.shape
    h3, w3 = 64 * ty3, 64 * tx3
    fields = [synthetic_star_field(h3, w3, n_stars=12, psf_size=15,
                                   fwhm=2.2, seed=10 + i)
              for i in range(2 * nb)]
    imgs = np.stack([f[0] for f in fields])
    psf3 = fields[0][1]
    bres = solve_distributed_batch(imgs, psf3, 150.0, cfg, mesh3)
    return {'ranks': n, 'devices': every, 'mesh': (ty, tx),
            'shape': (h, w), 'image': image, 'psf': psf, 'x': x,
            'iters': int(res.iters),
            'rel_err': relative_error(np.maximum(x, 0), truth + 150.0),
            'mesh3': (nb, ty3, tx3), 'shape3': (h3, w3), 'imgs': imgs,
            'psf3': psf3, 'batch_x': bres.x.cpu().numpy(),
            'batch_iters': bres.iters.cpu().numpy()}


def join_world(device=None) -> None:
    """Join torchrun's world (``env://``), or a world of this process alone
    when torchrun did not start it; NCCL on the card, gloo on the CPU."""
    dev = resolve_device(device)
    cuda = dev.type == 'cuda'
    backend = 'nccl' if cuda else 'gloo'
    if 'RANK' in os.environ:
        local = int(os.environ.get('LOCAL_RANK', 0))
        init_distributed(local_device_ids=[local] if cuda else None,
                         backend=backend)
        return
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    init_distributed(f'127.0.0.1:{port}', 1, 0,
                     local_device_ids=[dev.index or 0] if cuda else None,
                     backend=backend)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--device', default=None,
                    help="where to compute: the card unless 'cpu'")
    args = ap.parse_args(argv)
    join_world(args.device)
    try:
        r = run(args.device)
    finally:
        dist.destroy_process_group()
    if int(os.environ.get('RANK', 0)) != 0:
        return                         # every rank holds the same result
    (ty, tx), (h, w) = r['mesh'], r['shape']
    (nb, ty3, tx3), (h3, w3) = r['mesh3'], r['shape3']
    print(f'{r["ranks"]} ranks: {r["devices"]}')
    print(f'sharded {h}x{w} solve on {ty}x{tx} mesh: {r["iters"]} iters, '
          f'rel_err vs truth {r["rel_err"]:.4f} (no tiles, no seams, no '
          f'mosaic)')
    print(f'batch of {len(r["imgs"])} images of {h3}x{w3} on '
          f'{nb}x{ty3}x{tx3} mesh: per-image iters '
          f'{r["batch_iters"].tolist()} (independent schedules, lockstep '
          f'collectives)')


if __name__ == '__main__':
    main()
