"""Synthetic star stamps for tests and the chip smoke run.

A numpy copy of ``gaussian_psf``, ``_circular_degrade`` and
``synthetic_star_stamps`` (``tpu_sgp/simulate/__init__.py:21-99``): the JAX
package's module cannot be imported without importing JAX. The tests hold
the copy bit-equal to the original.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def gaussian_psf(size: int = 31, fwhm: float = 2.8,
                 ellip: float = 0.0, theta: float = 0.0) -> np.ndarray:
    """Normalized (sum=1) elliptical Gaussian PSF on a size x size grid."""
    sig = fwhm / 2.354820045030949  # FWHM -> sigma
    c = (size - 1) / 2.0
    y, x = np.mgrid[0:size, 0:size]
    xr = (x - c) * np.cos(theta) + (y - c) * np.sin(theta)
    yr = -(x - c) * np.sin(theta) + (y - c) * np.cos(theta)
    sx, sy = sig, sig * (1.0 - ellip)
    p = np.exp(-0.5 * ((xr / sx) ** 2 + (yr / sy) ** 2))
    return p / p.sum()


def _circular_degrade(image: np.ndarray, psf: np.ndarray) -> np.ndarray:
    """Circular-convolution blur matching the same-shape solver operator."""
    tf = np.fft.fftn(np.fft.fftshift(psf))
    return np.real(np.fft.ifftn(tf * np.fft.fftn(image)))


def synthetic_star_stamps(n: int, size: int = 31, fwhm: float = 2.8,
                          flux_range: Tuple[float, float] = (2e3, 5e4),
                          bkg: float = 120.0, seed: int = 42,
                          jitter: float = 1.5):
    """Deterministic batch of single-star stamps + shared PSF: one
    Poisson-noised blurred point source per stamp over a flat background.
    Returns float64 arrays (stamps (n,size,size), psf (size,size),
    bkgs (n,), fluxes (n,))."""
    rng = np.random.default_rng(seed)
    psf = gaussian_psf(size, fwhm)
    c = (size - 1) / 2.0
    stamps = np.empty((n, size, size))
    fluxes = rng.uniform(*flux_range, n)
    dx = rng.uniform(-jitter, jitter, n)
    dy = rng.uniform(-jitter, jitter, n)
    for i in range(n):
        truth = np.zeros((size, size))
        iy = int(round(c + dy[i])) % size
        ix = int(round(c + dx[i])) % size
        truth[iy, ix] = fluxes[i]
        blurred = _circular_degrade(truth, psf) + bkg
        stamps[i] = rng.poisson(np.maximum(blurred, 0.0))
    bkgs = np.full(n, float(bkg))
    return stamps, psf, bkgs, fluxes
