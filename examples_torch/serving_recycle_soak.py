"""Serving soak with live process recycling (the port of
``examples/serving_recycle_soak.py``).

Drives the ``MicroBatchServer`` watchdog end to end: a supervisor loop
runs serving SUBPROCESSES (the ``docs/DEPLOYMENT.md`` "Serving process
recycling" pattern); each subprocess serves six concurrent client threads
until the watchdog fires, then stops its clients, drains the queue (every
already-submitted request completes), waits for the card, closes its
server and exits for the supervisor to restart. The soak records the
requests submitted against those completed (equal: zero loss across
recycles), each process's RSS curve, and the number of recycles.

The watchdog is armed twice: by the growth of the process's RSS over its
level after warm-up (``rss_delta_mb``, the JAX soak's limit) and by a count
of device calls (``batches_per_process``). The leak that the JAX soak
recycled was its TPU plugin's (``docs/DEPLOYMENT.md``); a CUDA process's
host RSS may stay flat, and then the batch limit does the recycling. The
RSS curve is printed either way.

Usage:
  python examples_torch/serving_recycle_soak.py [minutes] [rss_delta_mb]
      [batches_per_process] [--device cpu]
  python examples_torch/serving_recycle_soak.py --worker <rss_delta_mb>
      <batches_per_process> [--device cpu]        # internal
The card unless given ``--device cpu``; raises without a card.
"""
import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def worker(rss_delta_mb: float, batches_per_process: int,
           device=None) -> dict:
    """One serving process: serve until the watchdog fires, drain, close,
    and return the report the supervisor reads."""
    import torch

    from tpu_sgp_torch.parallel.session import (MicroBatchServer,
                                                RestorationSession)
    from tpu_sgp_torch.simulate import synthetic_star_stamps

    stamps, psf, bkgs, _ = synthetic_star_stamps(64, size=31, seed=42)
    fluxes = stamps.sum(axis=(1, 2)) - 31 * 31 * bkgs
    sess = RestorationSession(psf.astype(np.float32), device=device)
    sess.warmup(buckets=(64, 256, 1024))
    base_rss = MicroBatchServer.process_rss_mb()
    srv = MicroBatchServer(sess, max_batch=1024,
                           max_batches_per_process=batches_per_process,
                           rss_limit_mb=base_rss + rss_delta_mb,
                           on_limit=lambda stats: None)  # supervisor decides

    submitted = completed = 0
    errors = []
    rss_curve = []
    stop = threading.Event()
    lock = threading.Lock()

    def client(i):
        nonlocal submitted, completed
        rng = np.random.default_rng(i)
        try:
            while not stop.is_set():
                k = int(rng.integers(8, 65))
                with lock:
                    submitted += 1
                fut = srv.submit(stamps[:k].astype(np.float32), bkgs[:k],
                                 fluxes=fluxes[:k])
                res = fut.result(timeout=600)   # an SGPResult slice
                if not np.isfinite(res.x).all():
                    raise FloatingPointError('non-finite restoration')
                with lock:
                    completed += 1
        except BaseException as exc:  # noqa: BLE001 — a dead client must
            with lock:                # be visible in the report, not a
                errors.append(repr(exc))   # silent thread exit
            stop.set()

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(6)]
    for t in threads:
        t.start()
    t0 = time.monotonic()
    while not srv.recycle_recommended and not stop.is_set():
        time.sleep(2.0)
        rss_curve.append(round(MicroBatchServer.process_rss_mb(), 1))
        if time.monotonic() - t0 > 900:   # safety: never soak one process
            break                          # longer than the whole budget
    stop.set()                 # pause producers (no NEW requests)...
    for t in threads:
        t.join(timeout=600)
    srv.drain(timeout=120.0)   # ...then serve everything already queued
    stats = srv.watchdog_stats()
    srv.close()
    if sess.device.type == 'cuda':
        torch.cuda.synchronize(sess.device)
    return {'submitted': submitted, 'completed': completed,
            'errors': errors,
            'recycled': bool(stats['recycle_recommended']),
            'batches': stats['batches_served'],
            'requests': stats['requests_served'],
            'base_rss_mb': round(base_rss, 1),
            'end_rss_mb': round(MicroBatchServer.process_rss_mb(), 1),
            'rss_curve_mb': rss_curve,
            'wall_s': round(time.monotonic() - t0, 1)}


def supervise(minutes: float = 16.0, rss_delta_mb: float = 250.0,
              batches_per_process: int = 500, device=None) -> dict:
    """Start worker processes one after another until ``minutes`` have
    passed. Returns each cycle's report, the totals and the exit code (0:
    zero loss and at least one recycle; 1: a worker died without a report;
    2: lost requests or no recycle; 3: a client raised)."""
    from tpu_sgp_torch.device import resolve_device
    dev = resolve_device(device)
    deadline = time.monotonic() + minutes * 60
    cycles = []
    code = None
    while time.monotonic() < deadline:
        args = [sys.executable, os.path.abspath(__file__), '--worker',
                str(rss_delta_mb), str(batches_per_process)]
        if device is not None:
            args += ['--device', str(device)]
        r = subprocess.run(args, capture_output=True, text=True, cwd=_REPO,
                           timeout=1800)
        marker = [ln for ln in r.stdout.splitlines()
                  if ln.startswith('WORKER ')]
        if r.returncode != 0 or not marker:
            cycles.append({'died': f'{r.stdout}\n{r.stderr[-2000:]}'})
            code = 1
            break
        rep = json.loads(marker[0][7:])
        cycles.append(rep)
        if rep['errors']:
            code = 3
            break
    done = [c for c in cycles if 'died' not in c]
    submitted = sum(c['submitted'] for c in done)
    completed = sum(c['completed'] for c in done)
    recycles = sum(bool(c['recycled']) for c in done)
    ok = code is None and completed == submitted and recycles >= 1
    return {'device': dev, 'cycles': cycles, 'submitted': submitted,
            'completed': completed, 'recycles': recycles, 'ok': ok,
            'code': 0 if ok else (code or 2)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--worker', nargs=2, metavar=('RSS_DELTA_MB', 'BATCHES'))
    ap.add_argument('minutes', nargs='?', type=float, default=16.0)
    ap.add_argument('rss_delta_mb', nargs='?', type=float, default=250.0)
    ap.add_argument('batches_per_process', nargs='?', type=int, default=500)
    ap.add_argument('--device', default=None,
                    help="where to compute: the card unless 'cpu'")
    args = ap.parse_args(argv)
    if args.worker:
        rep = worker(float(args.worker[0]), int(args.worker[1]), args.device)
        print('WORKER ' + json.dumps(rep))
        return 0
    r = supervise(args.minutes, args.rss_delta_mb, args.batches_per_process,
                  args.device)
    dev = r['device']
    if dev.type == 'cuda':
        import torch
        print(f'device: {dev} ({torch.cuda.get_device_name(dev)})')
    else:
        print(f'device: {dev}')
    for i, rep in enumerate(r['cycles'], 1):
        if 'died' in rep:
            print(f'worker died without report:\n{rep["died"]}')
            continue
        print(f"cycle {i}: {rep['completed']}/{rep['submitted']} "
              f"requests, {rep['batches']} device calls, recycled="
              f"{rep['recycled']}, rss {rep['base_rss_mb']} -> "
              f"{rep['end_rss_mb']} MB in {rep['wall_s']}s; rss curve "
              f"(every 2 s) {rep['rss_curve_mb']}")
        if rep['errors']:
            print(f"  client errors: {rep['errors']}")
    if r['code'] in (0, 2):
        print(f'SOAK {"OK" if r["ok"] else "FAIL"}: {len(r["cycles"])} '
              f'process cycles, {r["recycles"]} watchdog recycles, '
              f'{r["completed"]}/{r["submitted"]} requests completed (zero '
              f'loss={r["completed"] == r["submitted"]})')
    return r['code']


if __name__ == '__main__':
    sys.exit(main())
