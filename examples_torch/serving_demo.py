"""Serving demo: bucketed stamp restoration with ``RestorationSession``
(the port of ``examples/serving_demo.py``): warm up the canonical batch
shapes once, then serve variable-size batches, an async stream and many
concurrent clients.

Run from the repo root:  python examples_torch/serving_demo.py
[--device cpu] (the card unless given ``--device cpu``; raises without a
card).
"""
import argparse
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu_sgp_torch.parallel.session import (MicroBatchServer,  # noqa: E402
                                            RestorationSession)
from tpu_sgp_torch.simulate import synthetic_star_stamps  # noqa: E402

REQUEST_SIZES = (17, 50, 64, 200, 256)


def run(device=None) -> dict:
    """The demo on ``device`` (the card when None): returns every number
    ``main`` prints, and the largest flux error and the finiteness of the
    five requests' restorations, for a caller to check. Each timed window
    ends in a result on the host, which waits for the card."""
    stamps, psf, bkgs, _ = synthetic_star_stamps(1024, size=31, seed=1)
    fluxes = stamps.sum(axis=(1, 2)) - 31 * 31 * bkgs

    session = RestorationSession(psf, device=device)
    out = {'device': session.device}
    t0 = time.perf_counter()
    session.warmup(buckets=(32, 64, 256))
    out['warmup_s'] = time.perf_counter() - t0

    # variable-size requests land in warmed buckets
    out['batches'] = []
    flux_err, finite = 0.0, True
    for n in REQUEST_SIZES:
        t0 = time.perf_counter()
        res = session.restore(stamps[:n], bkgs[:n], fluxes=fluxes[:n])
        wall = time.perf_counter() - t0
        out['batches'].append((len(res.x), wall, int(np.median(res.iters))))
        # what the session's flux-conserving projection holds
        sums = res.x.astype(np.float64).sum((1, 2))
        flux_err = max(flux_err, float(np.abs(sums / fluxes[:n] - 1).max()))
        finite = finite and bool(np.isfinite(res.x).all())
    out['flux_err'], out['finite'] = flux_err, finite

    # streaming: dispatch of batch k+1 overlaps consumption of batch k;
    # coalesce=4 folds 4 queued requests into one device call (lanes are
    # independent; results re-split per request)
    chunks = [(stamps[i:i + 64], bkgs[i:i + 64], fluxes[i:i + 64])
              for i in range(0, 512, 64)]
    out['streams'] = []
    for coalesce in (1, 4):
        t0 = time.perf_counter()
        total = 0
        for res in session.restore_stream(chunks, coalesce=coalesce):
            total += res.x.shape[0]
        out['streams'].append((coalesce, total, time.perf_counter() - t0))

    # micro-batching: many concurrent client threads, one device call per
    # max_delay_s window; each caller's Future gets its own slice
    def client(i, srv):
        k = i * 32
        r = srv.restore(stamps[k:k + 32], bkgs[k:k + 32],
                        fluxes=fluxes[k:k + 32])
        if not np.isfinite(r.x).all():
            raise FloatingPointError(f'client {i}: non-finite restoration')

    t0 = time.perf_counter()
    with MicroBatchServer(session, max_batch=256,
                          max_delay_s=0.01) as srv, \
            ThreadPoolExecutor(max_workers=8) as pool:
        for f in [pool.submit(client, i, srv) for i in range(8)]:
            f.result()
    out['server_s'] = time.perf_counter() - t0
    out['server_calls'] = srv.batches_served
    return out


def device_name(dev: torch.device) -> str:
    return (f'{dev} ({torch.cuda.get_device_name(dev)})'
            if dev.type == 'cuda' else str(dev))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--device', default=None,
                    help="where to compute: the card unless 'cpu'")
    r = run(ap.parse_args(argv).device)
    print(f'device: {device_name(r["device"])}')
    print(f'warmup (3 bucket shapes): {r["warmup_s"]:.1f}s')
    for n, wall, med in r['batches']:
        print(f'batch {n:4d}: {wall * 1e3:6.1f} ms ({med} median iters)')
    for coalesce, total, wall in r['streams']:
        print(f'streamed {total} stamps (coalesce={coalesce}) in '
              f'{wall * 1e3:.0f} ms')
    print(f'micro-batched 8 concurrent 32-stamp clients in '
          f'{r["server_s"] * 1e3:.0f} ms ({r["server_calls"]} device calls)')


if __name__ == '__main__':
    main()
