"""Batched small-stamp restoration with the whole solve in one kernel.

Port of ``solve_stamps_pallas`` (``tpu_sgp/experimental/pallas_batch.py:
317-399``). The JAX version pads the batch to its 64-stamp tile and the
pixels to 128 lanes, the TPU's tiling; here a row is one thread block of
``csrc/stamp_solver.cu``, on the route its launch plan picks from the
stamp's shape (``kernels.stamp_solver.stamp_solver_plan``), and no padding
is needed. CPU tensors run the kernel's plain PyTorch version.
"""
from __future__ import annotations

import torch

from ..config import SGPConfig
from ..device import resolve_device
from ..kernels.stamp_solver import solve_rows


def stamp_rows(gn, psf, bkgs, fluxes, sat_level, dtype: torch.dtype,
               device):
    """The kernel's operands (``pallas_batch.py:330-360``): (B, N) stamps
    and backgrounds, (B,) fluxes and saturation levels, and the (H, W)
    taps fftshift(psf), contiguous on ``device``."""
    gn = torch.as_tensor(gn, dtype=dtype, device=device)
    if gn.dim() != 3:
        raise ValueError(f'gn must be (B, H, W), got {tuple(gn.shape)}')
    b = gn.shape[0]
    gn = gn.reshape(b, -1)
    bkgs = torch.as_tensor(bkgs, dtype=dtype, device=device)
    bkg = (bkgs[:, None].expand_as(gn) if bkgs.dim() == 1
           else bkgs.reshape(gn.shape))
    flux = torch.as_tensor(fluxes, dtype=dtype, device=device).reshape(b)
    sat = torch.as_tensor(sat_level, dtype=dtype, device=device).expand(b)
    taps = torch.fft.fftshift(torch.as_tensor(psf, dtype=dtype,
                                              device=device))
    return tuple(t.contiguous() for t in (gn, bkg, flux, sat, taps))


def solve_stamps_pallas(gn, psf, bkgs, fluxes, sat_level, cfg: SGPConfig,
                        *, device=None):
    """One-kernel batched KL-SGP solve. ``gn`` (B, H, W); shared ``psf``
    (H, W); ``bkgs`` (B,) or (B, H, W); ``fluxes`` (B,); ``sat_level`` a
    scalar or (B,). A tensor ``gn`` computes on its own device, an array on
    ``device`` (the card unless the caller passes ``'cpu'``).

    Returns ``(x (B, H, W), iters (B,) int32)`` on that device. Raises
    ``ValueError`` for a configuration outside the kernel's scope
    (``pallas_batch.py:325-328``), for stamps above 4096 pixels, and on
    the card for the float64 shapes whose block fits in neither
    orientation (a side of 5 pixels or less, e.g. 4x1024), before any
    launch."""
    rows = stamp_rows(gn, psf, bkgs, fluxes, sat_level, cfg.torch_dtype,
                      resolve_device(device, gn))
    x, iters = solve_rows(*rows, cfg)
    return x.reshape((x.shape[0],) + tuple(rows[4].shape)), iters
