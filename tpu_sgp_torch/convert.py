"""What a JAX run hands to the port: its configuration and its state.

The solver has no learned weights. A JAX solve is fully described by its
``SGPConfig`` and, mid-solve, by its checkpointable ``SGPState``; with the
same inputs, these two let a JAX checkpoint resume in the port
(``tpu_sgp/solvers/checkpoint.py:48-55`` writes and reads the npz layout
taken here).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import SGPConfig
from .device import resolve_device
from .solvers.sgp import SGPState


def config_from_jax(fields: dict) -> SGPConfig:
    """The port's config from ``dataclasses.asdict`` of a JAX
    ``SGPConfig``. Unknown fields raise ``TypeError``."""
    names = {f.name for f in dataclasses.fields(SGPConfig)}
    unknown = set(fields) - names
    if unknown:
        raise TypeError(f'fields the port does not know: {sorted(unknown)}')
    return SGPConfig(**fields)


# Fields added after a release default on load so that older checkpoints
# keep resuming (checkpoint.py:22-32): the warm projection's carry starts
# cold. Defaults take fv's shape.
_FIELD_DEFAULTS = {
    'lam_dual': lambda st: np.full(np.shape(st['fv']), np.nan,
                                   np.asarray(st['fv']).dtype),
    'dlam_dual': lambda st: np.full(np.shape(st['fv']), np.inf,
                                    np.asarray(st['fv']).dtype),
}


def fill_missing(items: dict) -> dict:
    """A checkpoint's arrays by field name, in the state's order, absent
    fields defaulted (``_fill_missing``, ``checkpoint.py:35-45``)."""
    out = {}
    for k in SGPState._fields:
        if k in items:
            out[k] = items[k]
        elif k in _FIELD_DEFAULTS:
            out[k] = _FIELD_DEFAULTS[k](items)
        else:
            raise KeyError(f'checkpoint missing field {k!r} and no '
                           'default exists')
    return out


def state_from_numpy(arrays: dict, device=None,
                     dtype: torch.dtype = torch.float64) -> SGPState:
    """An ``SGPState`` from the field name -> numpy array layout of
    ``checkpoint.save_state_npz`` (``checkpoint.py:48-50``), batched: every
    field has a leading B axis, on ``device`` (the card when None).
    Floating fields become ``dtype``; the flags
    stay bool and the iteration counter int32. ``lam_dual`` and
    ``dlam_dual``, absent from older checkpoints, default as
    ``checkpoint.py:27-32`` defaults them."""
    device = resolve_device(device)
    arrays = fill_missing(arrays)
    fv = np.asarray(arrays['fv'])
    if fv.ndim != 1:
        raise ValueError(f'expected a batched state (fv of shape (B,)), got '
                         f'fv of shape {fv.shape}')

    def field(name):
        a = np.asarray(arrays[name])
        if name in ('keep', 'converged'):
            return torch.tensor(a, dtype=torch.bool, device=device)
        if name == 'it':
            return torch.tensor(a, dtype=torch.int32, device=device)
        return torch.tensor(a, dtype=dtype, device=device)

    return SGPState(*(field(k) for k in SGPState._fields))
