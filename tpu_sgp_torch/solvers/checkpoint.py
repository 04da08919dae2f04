"""Solver checkpoint / resume.

Port of ``tpu_sgp/solvers/checkpoint.py:20-134``. The full loop state is an
``SGPState``, so a checkpoint is exact: save the state, reload it, and
``resume_from_state`` with the original inputs continues the same
trajectory. The ``.npz`` layout is the JAX package's, field for field, so a
checkpoint written by either package resumes in the other: the port's
state is batched (a leading B axis on every field), as a vmapped JAX
state is, and a single-image JAX state gains that axis on load. The orbax
backend is JAX-only and raises here.
"""
from __future__ import annotations

import numpy as np
import torch

from ..convert import state_from_numpy
from .sgp import IMAGE_FIELDS, SGPState

_FIELDS = SGPState._fields


def save_state_npz(path: str, state: SGPState, image_shape=None) -> None:
    """Write every field as a numpy array under its name
    (``checkpoint.py:48-50``). The solver keeps images as (B, N) rows;
    with ``image_shape`` the per-pixel fields are written as
    (B, *image_shape), the layout of a vmapped JAX solve on images of that
    shape, which the JAX package needs to resume any operator but the flat
    dense one. The port resumes from either."""
    arrays = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
              else np.asarray(v) for k, v in zip(_FIELDS, state)}
    if image_shape is not None:
        for k in IMAGE_FIELDS:
            arrays[k] = arrays[k].reshape((arrays[k].shape[0],)
                                          + tuple(image_shape))
    np.savez(path, **arrays)


def load_state_npz(path: str, *, device=None) -> SGPState:
    """Read a checkpoint as a batched state on ``device`` (the card when
    None), floating fields in the dtype they were saved in
    (``checkpoint.py:53-55``); fields that older checkpoints lack are
    defaulted (``convert.fill_missing``). A single-image state (0-d
    ``fv``), as the JAX package writes for an unbatched solve, gains the
    batch axis."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    if np.ndim(arrays['fv']) == 0:
        arrays = {k: np.asarray(v)[None] for k, v in arrays.items()}
    dtype = {np.dtype('float32'): torch.float32,
             np.dtype('float64'): torch.float64}[arrays['fv'].dtype]
    return state_from_numpy(arrays, device=device, dtype=dtype)


def _npz_path(path: str) -> str:
    return path if path.endswith('.npz') else path + '.npz'


def _check_backend(backend: str) -> None:
    if backend == 'orbax':
        raise NotImplementedError(
            "backend='orbax' is JAX-only; the port writes and reads the "
            "'npz' layout, which the JAX package reads and writes too")
    if backend != 'npz':
        raise ValueError(f'unknown checkpoint backend {backend}')


def save_state(path: str, state: SGPState, backend: str = 'npz',
               image_shape=None) -> None:
    """``checkpoint.py:77-85``; ``image_shape`` as in ``save_state_npz``."""
    _check_backend(backend)
    save_state_npz(_npz_path(path), state, image_shape)


def load_state(path: str, backend: str = 'npz', *, device=None) -> SGPState:
    """``checkpoint.py:88-94``."""
    _check_backend(backend)
    return load_state_npz(_npz_path(path), device=device)


def solve_checkpointed(gn, psf, bkg, x0, flux_in, obj, beta0, lr0,
                       sat_level, cfg, *, path: str, every: int,
                       backend: str = 'npz', device=None):
    """A solve that saves a checkpoint every ``every`` iterations
    (``checkpoint.py:97-134``): ``solve_with_state`` under a budget of
    ``every`` iterations, then ``resume_from_state`` under growing budgets
    up to ``cfg.max_iter``, saving to ``path`` between chunks. Chunked
    equals uninterrupted, because the whole loop state rides in the
    ``SGPState``. If the process dies, ``load_state(path)`` and
    ``resume_from_state`` with the original inputs and config lose at most
    ``every`` iterations. The arguments are ``solve``'s (batch-first); the
    chunks go on while any lane can still work, and the checkpoints hold
    the per-pixel fields in the images' shape. Returns
    ``(result, state)``."""
    from .sgp import resume_from_state, solve_with_state

    if every < 1:
        raise ValueError('every must be >= 1')
    _check_backend(backend)
    total = cfg.max_iter
    budget = min(every, total)
    image_shape = tuple(np.shape(gn)[1:])
    res, state = solve_with_state(gn, psf, bkg, x0, flux_in, obj, beta0,
                                  lr0, sat_level,
                                  cfg.replace(max_iter=budget),
                                  device=device)
    save_state(path, state, backend=backend, image_shape=image_shape)
    while (bool(((~state.converged) & (state.it <= total)).any())
           and budget < total):
        budget = min(budget + every, total)
        res, state = resume_from_state(gn, psf, bkg, x0, flux_in, obj,
                                       beta0, lr0, sat_level, state,
                                       cfg.replace(max_iter=budget),
                                       device=device)
        save_state(path, state, backend=backend, image_shape=image_shape)
    return res, state
