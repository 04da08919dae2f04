"""Closed loop: one caller makes back-to-back calls of the program's entry,
cycling over a pool of inputs made in set-up, until the window's seconds
have passed; the window ends with the last call.

Workload parameters (``sgpbench/workloads/<cell>.json``):

- ``entry``: ``restore_stamps`` (a batch of stamps or frames that share one
  PSF, ``tpu_sgp_torch.parallel.batch.restore_stamps``) or ``sgp`` (one
  image through the reference-compatible facade ``tpu_sgp_torch.sgp``).
- ``call``: keyword arguments of the entry besides the configuration's
  (``flatten``, ``phase1_iters``, ``tail_bucket``).
- ``inputs``: ``kind`` ``stamps`` (``batch`` stamps a call, ``pool``
  batches) or ``fields`` (``lanes`` fields a call, ``calls`` calls' worth).
  Each input comes from the run's seed, or, with ``family_seed``, from a
  fixed family, cycled in a fixed order, so that every seed sets the same
  work (the run's seed then draws the order of a batch's stamps): a
  field's iterations to the stop rule vary by tens of percent from field
  to field, and with them the time.
- ``check``: the first answers to ``calls`` inputs drawn from the seed,
  and to the input whose lanes ran longest, are compared with the
  reference: ``lanes`` lanes of each drawn from the seed and the
  ``longest`` lanes by iterations.
- ``trace``: the profiled stretch, from the first call that starts after
  ``start_s`` seconds of the window to the end of the call in progress
  after ``span_s`` more.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

import profiling
from traffic import data

# the facade's keyword for each configuration key it takes
FACADE = {'max_iter': 'MAXIT', 'stop_criterion': 'stop_criterion',
          'tol_convergence': 'tol_convergence', 'init_recon': 'init_recon',
          'proj_type': 'proj_type', 'alpha_init': 'alpha',
          'dtype': 'dtype'}


def sgp_config(config: dict):
    """The program's solver configuration from the configuration file."""
    import dataclasses

    from tpu_sgp_torch import SGPConfig
    names = {f.name for f in dataclasses.fields(SGPConfig)}
    return SGPConfig(**{k: v for k, v in config.items() if k in names})


def family(run, inp: dict, k: int) -> int:
    """The seed of the k-th input: from ``family_seed`` where the workload
    fixes a family, else from the run's seed."""
    if 'family_seed' in inp:
        return int(np.random.default_rng([int(inp['family_seed']), k])
                   .integers(2 ** 63))
    return int(run.rng(1, k).integers(2 ** 63))


def make_pool(run) -> list:
    """The inputs of the calls, each a dict of ``gn`` (B, H, W) float32,
    ``psf``, ``bkg`` (B,), ``flux`` (B,) or None, and ``target`` (B,), the
    flux each answer must hold."""
    inp, cfg = run.cell['inputs'], run.config
    pool = []
    if inp['kind'] == 'stamps':
        for p in range(int(inp['pool'])):
            gn, psf, bkg, flux = data.star_stamps(
                int(inp['batch']), cfg['stamp_size'], cfg['psf_fwhm'],
                cfg['background'], seed=family(run, inp, p))
            if 'family_seed' in inp:
                lanes = run.rng(1, p).permutation(len(gn))
                gn, bkg, flux = gn[lanes], bkg[lanes], flux[lanes]
            pool.append(dict(gn=gn, psf=psf, bkg=bkg,
                             flux=flux if cfg['has_flux'] else None))
    elif inp['kind'] == 'fields':
        lanes, calls = int(inp['lanes']), int(inp['calls'])
        fields = [data.star_field(cfg['height'], cfg['width'],
                                  cfg['n_stars'], cfg['psf_fwhm'],
                                  cfg['psf_size'], cfg['background'],
                                  seed=family(run, inp, i))
                  for i in range(lanes * calls)]
        psf = fields[0][1]
        for c in range(calls):
            gn = np.stack([f[0] for f in fields[c * lanes:(c + 1) * lanes]])
            pool.append(dict(gn=gn, psf=psf,
                             bkg=np.full(lanes, float(cfg['background'])),
                             flux=None))
    for item in pool:
        item['target'] = (item['flux'] if item['flux'] is not None else
                          (item['gn'] - item['bkg'][:, None, None]).sum(
                              axis=(1, 2)))
        item['gn'] = item['gn'].astype(np.float32)
    return pool


def make_entry(run):
    """The timed call: inputs -> (x (B, H, W), iters (B,)), tensors on the
    device for ``restore_stamps``, NumPy for ``sgp``."""
    cfg, cell, dev = run.config, run.cell, run.device
    if cell['entry'] == 'restore_stamps':
        from tpu_sgp_torch.parallel.batch import restore_stamps
        sc = sgp_config(cfg)
        sat = float(cfg['sat_level']) if cfg['has_sat_level'] else 0.0

        def call(item):
            res = restore_stamps(item['gn'], item['psf'], item['bkg'], sc,
                                 fluxes=item['flux'], sat_level=sat,
                                 device=dev, **cell.get('call', {}))
            return res.x, res.iters
        return call
    if cell['entry'] == 'sgp':
        import tpu_sgp_torch
        if cfg['has_flux'] or cfg['has_sat_level']:
            raise ValueError('the sgp entry here passes no flux and no '
                             'saturation level')
        kw = {FACADE[k]: cfg[k] for k in FACADE if k in cfg}

        def call(item):
            x, iters, *_ = tpu_sgp_torch.sgp(item['gn'][0], item['psf'],
                                             float(item['bkg'][0]), **kw,
                                             device=dev)
            return x[None], np.array([iters])
        return call
    raise ValueError(f'unknown entry {cell["entry"]!r}')


def sync(device: str) -> None:
    if device == 'cuda':
        torch.cuda.synchronize()


def run(run) -> dict:
    cell = run.cell
    pool = make_pool(run)
    run.part('inputs')
    call = make_entry(run)
    # a family's inputs in their own order, so that every window sets the
    # same work; inputs from the seed in an order drawn from it
    order = (np.arange(len(pool)) if 'family_seed' in run.cell['inputs']
             else run.rng(2).permutation(len(pool)))
    # warm-up: the window's own shapes, once each
    call(pool[order[0]])
    sync(run.device)
    run.part('warm-up')

    chk = cell['check']
    b = pool[0]['gn'].shape[0]
    lanes_drawn = run.rng(3).choice(b, min(b, int(chk['lanes'])),
                                    replace=False)
    traced = cell.get('trace', {})
    stretch = profiling.Stretch(run.trace, run.device)
    kept, sums, targets = {}, [], []
    iters_sum = lanes_done = calls = failed = 0
    t0 = run.window_start()
    while True:
        now = time.perf_counter() - t0
        if now >= run.seconds:
            break
        if (stretch.state == 'before'
                and now >= float(traced.get('start_s', 0.0))):
            stretch.start()
        item = pool[order[calls % len(pool)]]
        try:
            with profiling.span('call'):
                x, iters = call(item)
                sync(run.device)
        except Exception as exc:  # noqa: BLE001 -- counted, the run goes on
            print(f'sgpbench: call {calls} failed: {exc!r}',
                  file=sys.stderr, flush=True)
            failed += b
            calls += 1
            continue
        it = torch.as_tensor(iters)
        iters_sum += it.sum()
        lanes_done += b
        stretch.count(calls=1, iters=it.max())
        xt = torch.as_tensor(x)
        sums.append(xt.sum(dim=(1, 2), dtype=torch.float64))
        targets.append(item['target'])
        p = int(order[calls % len(pool)])
        if p not in kept:       # every input's first answer
            longest = torch.topk(it.to(torch.int64),
                                 min(b, int(chk['longest']))).indices
            idx = np.union1d(lanes_drawn, longest.cpu().numpy())
            kept[p] = (idx, xt[torch.as_tensor(idx, device=xt.device)],
                       int(it.max()))
        calls += 1
        if stretch.elapsed() >= float(traced.get('span_s', 0.0)):
            stretch.stop()
    window_s = time.perf_counter() - t0
    stretch.stop()

    # inputs drawn from the seed, and the one whose lanes ran longest
    done = sorted(kept)
    draw = set(run.rng(4).choice(done, min(len(done), int(chk['calls'])),
                                 replace=False).tolist()) if done else set()
    if done:
        draw.add(max(done, key=lambda p: kept[p][2]))
    samples = []
    for p in sorted(draw):
        idx, x, _ = kept[p]
        item = pool[p]
        samples.append(dict(gn=item['gn'][idx], psf=item['psf'],
                            bkg=item['bkg'][idx],
                            flux=None if item['flux'] is None
                            else item['flux'][idx],
                            x=torch.as_tensor(x).cpu().numpy()))
    stamps = cell['inputs']['kind'] == 'stamps'
    rec = {'window_s': window_s, 'calls': calls,
           'iters_sum': float(iters_sum),
           ('stamps_done' if stamps else 'frames_done'): lanes_done,
           'attempted': lanes_done + failed, 'failed': failed,
           'profile': stretch.summary(),
           'answers': {
               'missing': failed,
               'sums': (torch.cat([torch.as_tensor(s).reshape(-1).cpu()
                                   for s in sums]).numpy()
                        if sums else np.zeros(0)),
               'fluxes': (np.concatenate(targets) if targets
                          else np.zeros(0)),
               'samples': samples}}
    return rec
