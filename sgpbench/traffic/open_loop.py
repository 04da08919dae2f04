"""Open loop: requests of star stamps arrive on a schedule, whether or not
earlier ones have been answered, at ``tpu_sgp_torch``'s micro-batching
server (``MicroBatchServer`` over a ``RestorationSession``); each is timed
from when it was due.

Workload parameters (``sgpbench/workloads/<cell>.json``):

- ``inputs``: ``pool`` stamps made from the run's seed; a request is a
  slice of it at an offset drawn from the seed.
- ``arrivals``: ``rate_per_s`` requests a second over the window;
  ``mix_seed`` draws the set of request sizes (log-uniform from
  ``sizes.min`` to ``sizes.max`` stamps) and of the gaps between arrivals
  (exponential), the same for every run seed, which only orders them; an
  optional ``burst`` (``factor``, ``on_s``, ``period_s``) raises the rate
  ``factor``-fold for ``on_s`` seconds of every ``period_s`` at the same
  mean rate.
- ``session``: keyword arguments of ``RestorationSession`` besides the
  configuration's (as the closed loop's ``call``); ``server``:
  ``max_batch``, ``max_delay_s`` of the server and ``warm_max_batch``, the
  largest batch whose bucket set-up warms.
- ``grace_s``: how long past the window's close answers are waited for; a
  request still unanswered then counts as failed, its latency the wait so
  far.
- ``check``: ``requests`` answered requests drawn from the seed, and the
  largest, are compared with the reference.
- ``trace``: the profiled stretch, ``start_s`` to ``start_s + span_s``
  seconds into the window.
"""
from __future__ import annotations

import time

import numpy as np

import profiling
from traffic import data
from traffic.closed_loop import deployment, sgp_config


def mix(cell: dict, seconds: float, rng, rate=None):
    """(arrival seconds from the window's start, sizes) of every request
    due in the window, the set fixed by ``mix_seed`` and ordered by
    ``rng``."""
    arr, sz = cell['arrivals'], cell['sizes']
    rate = float(arr['rate_per_s'] if rate is None else rate)
    n = max(1, int(round(rate * seconds)))
    base = np.random.default_rng(int(arr['mix_seed']))
    lo, hi = np.log(sz['min']), np.log(sz['max'] + 1)
    sizes = np.floor(np.exp(base.uniform(lo, hi, n))).astype(int)
    sizes = np.clip(sizes, sz['min'], sz['max'])
    gaps = base.exponential(1.0, n)
    sizes, gaps = rng.permutation(sizes), rng.permutation(gaps)
    # arrivals in [0, seconds) at the mean rate, then warped by the bursts
    v = np.concatenate([[0.0], np.cumsum(gaps)[:-1]]) / gaps.sum() * seconds
    burst = arr.get('burst')
    if burst:
        f, on, per = (float(burst[k]) for k in ('factor', 'on_s',
                                                'period_s'))
        off = (per - f * on) / (per - on)
        edges = np.arange(0.0, seconds + per, per)
        t = np.sort(np.concatenate([edges, edges + on]))
        lam = np.concatenate([[0.0], np.cumsum(np.diff(t) * np.where(
            (t[:-1] % per) < on - 1e-12, f, off))])
        v = np.interp(v, lam, t)
    return v, sizes


class Service:
    """The program's serving stack, built and warmed once."""

    def __init__(self, run):
        from tpu_sgp_torch.parallel.session import (MicroBatchServer,
                                                    RestorationSession)
        cell, cfg = run.cell, run.config
        self.run = run
        size = int(cfg['stamp_size'])
        self.stamps, self.psf, self.bkgs, flux = data.star_stamps(
            int(cell['inputs']['pool']), size, cfg['psf_fwhm'],
            cfg['background'], seed=run.rng(1).integers(2 ** 63))
        self.flux = flux if cfg['has_flux'] else None
        self.target = flux if cfg['has_flux'] else (
            self.stamps - self.bkgs[:, None, None]).sum(axis=(1, 2))
        self.wire = self.stamps.astype(np.float32)
        run.part('inputs')
        self.session = RestorationSession(
            self.psf, sgp_config(cfg), stamp_shape=(size, size),
            sat_level=float(cfg['sat_level']), device=run.device,
            **deployment(cfg), **cell.get('session', {}))
        srv = cell['server']
        self.session.warmup(max_batch=int(srv['warm_max_batch']))
        self.server = MicroBatchServer(self.session,
                                       max_batch=int(srv['max_batch']),
                                       max_delay_s=float(srv['max_delay_s']))
        run.part('warm-up')

    def window(self, seconds: float, rng, rate=None, stretch=None,
               start=None) -> dict:
        """Offer one window of requests; wait for the answers up to
        ``grace_s`` past its close."""
        cell = self.run.cell
        arrivals, sizes = mix(cell, seconds, rng, rate)
        offsets = rng.integers(0, len(self.wire) - sizes + 1)
        n = len(sizes)
        done = np.full(n, np.nan)
        futs = [None] * n
        late = 0.0
        traced = cell.get('trace', {})
        t0 = start() if start else time.perf_counter()
        for i in range(n):
            wait = t0 + arrivals[i] - time.perf_counter()
            if wait > 0:
                with profiling.span('wait'):
                    time.sleep(wait)
            now = time.perf_counter() - t0
            late = max(late, now - arrivals[i])
            if stretch is not None:
                if stretch.state == 'before' and now >= traced['start_s']:
                    stretch.start()
                elif stretch.elapsed() >= traced['span_s']:
                    stretch.stop()
            lanes = slice(offsets[i], offsets[i] + sizes[i])
            with profiling.span('submit'):
                futs[i] = self.server.submit(
                    self.wire[lanes], self.bkgs[lanes],
                    fluxes=None if self.flux is None else self.flux[lanes])
            futs[i].add_done_callback(
                lambda f, i=i: done.__setitem__(i, time.perf_counter()))
        closing = t0 + seconds
        with profiling.span('wait'):
            time.sleep(max(0.0, closing - time.perf_counter()))
        if stretch is not None:
            stretch.stop()
        backlog = sum(not f.done() for f in futs)
        give_up = closing + float(cell['grace_s'])
        for f in futs:
            left = give_up - time.perf_counter()
            if left > 0:
                try:
                    f.exception(timeout=left)
                except TimeoutError:
                    pass
        end = time.perf_counter()
        ok = np.array([f.done() and f.exception() is None for f in futs])
        lat = np.where(ok, done - (t0 + arrivals), end - (t0 + arrivals))
        return dict(arrivals=arrivals, sizes=sizes, offsets=offsets,
                    futs=futs, ok=ok, latency_s=lat, backlog=backlog,
                    late_s=late, window_s=seconds)

    def close(self) -> None:
        self.server.close()


def run(run) -> dict:
    svc = Service(run)
    stretch = profiling.Stretch(run.trace, run.device)
    calls0 = svc.server.batches_served
    try:
        w = svc.window(run.seconds, run.rng(2), stretch=stretch,
                       start=run.window_start)
    finally:
        svc.close()
    ok, sizes = w['ok'], w['sizes']
    results = [f.result() if good else None
               for f, good in zip(w['futs'], ok)]
    batches = svc.server.batches_served - calls0
    sums, fluxes = [], []
    for i in np.flatnonzero(ok):
        lanes = slice(w['offsets'][i], w['offsets'][i] + sizes[i])
        sums.append(results[i].x.astype(np.float64).sum(axis=(1, 2)))
        fluxes.append(svc.target[lanes])

    chk = run.cell['check']
    good = np.flatnonzero(ok)
    pick = set(run.rng(3).choice(good, min(len(good), int(chk['requests'])),
                                 replace=False).tolist()) if len(good) else set()
    if len(good):
        pick.add(int(good[np.argmax(sizes[good])]))
    lanes = [np.arange(w['offsets'][i], w['offsets'][i] + sizes[i])
             for i in sorted(pick)]
    samples = []
    if lanes:
        idx = np.concatenate(lanes)
        samples.append(dict(
            gn=svc.stamps[idx], psf=svc.psf, bkg=svc.bkgs[idx],
            flux=None if svc.flux is None else svc.flux[idx],
            x=np.concatenate([results[i].x for i in sorted(pick)])))
    return {'window_s': w['window_s'],
            'latencies_ms': w['latency_s'] * 1e3,
            'late_ms': w['late_s'] * 1e3,
            'backlog': w['backlog'],
            'stamps_served': int(sizes[ok].sum()),
            'batches_served': batches,
            'attempted': len(sizes), 'failed': int((~ok).sum()),
            'profile': stretch.summary(),
            'answers': {'missing': int((~ok).sum()),
                        'sums': (np.concatenate(sums) if sums
                                 else np.zeros(0)),
                        'fluxes': (np.concatenate(fluxes) if fluxes
                                   else np.zeros(0)),
                        'samples': samples}}
