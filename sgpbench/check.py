"""Whether the answers of a window are correct.

Three numbers, each beside its limit (``correct`` needs every one at or
under it; a number that is not finite is over):

- ``missing``: answers that never came (a request unanswered a minute past
  the window's close, a call that raised). Limit 0.
- ``flux_gap_max``: over every answer of the window, the largest
  |sum(x) - flux| / flux, where flux is the one the configuration holds
  the restoration to (the given fluxes, else sum(gn - bkg)). The limit is
  the configuration's own, ``flux_rtol``: the flux-conserving projection
  is its guarantee.
- ``x_gap_p90``: over a sample of the answers drawn from the seed (with the
  lanes that took the most iterations in it), the 90th percentile of each
  lane's ||x - x_ref|| / ||x_ref||, where x_ref is the plain reference's
  answer for the same inputs, solved in float64 to its own stop rule. The
  limit is the cell's, set between the program's readings and the
  control's (``PERF.md``).

The reference is ``sgpbench/reference/<stem>.py``, the stem named by the
configuration's ``reference`` key, ``sgp_plain`` where it has none. A
reference module keeps this contract:

- ``KNOWN``: the settings it solves at one value only (a configuration
  that gives another value is refused by ``solve``);
- ``DEFAULTS``: the settings it takes, each with its default;
- ``TAKES`` (optional): the other configuration keys it reads, by default
  ``('max_iter', 'tol_convergence')``;
- ``solve(gn, psf, bkg, settings, *, flux, sat, control) -> (x, iters)``
  on a (B, H, W) batch that shares one PSF, ``settings`` the
  configuration's values of the keys above, in float64 unless a
  ``control`` asks for a lower precision.
"""
from __future__ import annotations

import importlib.util
import os
import re

import numpy as np
import torch

REFERENCES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          'reference')
TAKES = ('max_iter', 'tol_convergence')
STEM = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')

# the lanes the reference solves at once
BLOCK_PIXELS = 1 << 20


def reference_module(config: dict):
    """The module of the reference that ``config`` names, loaded by its
    path (a stem with no file is an error, never ``sgp_plain``)."""
    stem = config.get('reference', 'sgp_plain')
    if not STEM.match(stem):
        raise ValueError(f'the reference {stem!r} is not a file name')
    path = os.path.join(REFERENCES, stem + '.py')
    if not os.path.isfile(path):
        raise FileNotFoundError(f'the configuration names the reference '
                                f'{stem!r}: no file {path}')
    spec = importlib.util.spec_from_file_location(
        'sgpbench_reference_' + stem.replace('.', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def settings(config: dict, ref) -> dict:
    """The solver settings the reference ``ref`` takes from a
    configuration."""
    keys = (set(ref.KNOWN) | set(ref.DEFAULTS)
            | set(getattr(ref, 'TAKES', TAKES)))
    return {k: config[k] for k in keys if k in config}


def reference(ref, sample: dict, config: dict, device: str, control=None):
    """The answers (a float64 array) of the reference ``ref`` for the
    lanes of one sample, in blocks of lanes."""
    gn = np.asarray(sample['gn'], np.float64)
    lanes, h, w = gn.shape
    step = max(1, BLOCK_PIXELS // (h * w))
    xs = []
    for i in range(0, lanes, step):
        blk = slice(i, i + step)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float64)[blk],
                                      device=device)
        x, _ = ref.solve(
            t(gn), torch.as_tensor(sample['psf'], dtype=torch.float64),
            t(sample['bkg']), settings(config, ref),
            flux=None if sample['flux'] is None else t(sample['flux']),
            sat=config['sat_level'] if config['has_sat_level'] else None,
            control=control)
        xs.append(x.cpu().numpy())
    return np.concatenate(xs)


def x_gaps(x, x_ref) -> np.ndarray:
    """||x - x_ref|| / ||x_ref|| a lane; inf where x is not finite."""
    x = np.asarray(x, np.float64).reshape(len(x_ref), -1)
    x_ref = np.asarray(x_ref, np.float64).reshape(len(x_ref), -1)
    gap = np.linalg.norm(x - x_ref, axis=1) / np.linalg.norm(x_ref, axis=1)
    return np.where(np.isfinite(gap), gap, np.inf)


def flux_gap_max(sums, fluxes) -> float:
    sums = np.asarray(sums, np.float64)
    fluxes = np.asarray(fluxes, np.float64)
    if sums.size == 0:
        return float('inf')
    gap = np.abs(sums - fluxes) / np.abs(fluxes)
    return float(np.max(np.where(np.isfinite(gap), gap, np.inf)))


def target_flux(sample: dict) -> np.ndarray:
    """The flux each lane of a sample is held to."""
    if sample['flux'] is not None:
        return np.asarray(sample['flux'], np.float64)
    gn = np.asarray(sample['gn'], np.float64)
    bkg = np.asarray(sample['bkg'], np.float64)
    return (gn - bkg[:, None, None]).sum(axis=(1, 2))


def compare(cell: dict, config: dict, answers: dict, device: str,
            control=None) -> dict:
    """The compared numbers of a run, each ``{'value', 'limit'}``.

    ``answers`` holds ``missing`` (a count), ``sums`` and ``fluxes`` (a
    value a lane for every answer of the window) and ``samples``: a list
    of dicts, each with the lanes' inputs ``gn`` (L, H, W), ``bkg`` (L,),
    ``flux`` (L,) or None, the shared ``psf``, and the program's ``x``
    (L, H, W). ``control`` replaces the program's ``x`` by the reference
    computed in that lower precision (the control of ``PERF.md``), whose
    fluxes are then those of the sample's lanes."""
    ref = reference_module(config)
    gaps = []
    sums, fluxes = answers['sums'], answers['fluxes']
    if control is not None:
        sums, fluxes = [], []
    for sample in answers['samples']:
        x_ref = reference(ref, sample, config, device)
        x = sample['x']
        if control is not None:
            x = reference(ref, sample, config, device, control)
            sums.append(x.sum(axis=(1, 2)))
            fluxes.append(target_flux(sample))
        gaps.append(x_gaps(x, x_ref))
    if control is not None:
        sums, fluxes = np.concatenate(sums), np.concatenate(fluxes)
    gaps = np.concatenate(gaps) if gaps else np.array([np.inf])
    return {
        'missing': {'value': int(answers['missing']), 'limit': 0},
        'flux_gap_max': {'value': flux_gap_max(sums, fluxes),
                         'limit': float(config['flux_rtol'])},
        'x_gap_p90': {'value': float(np.quantile(gaps, 0.9)),
                      'limit': float(cell['limits']['x_gap_p90'])},
    }
