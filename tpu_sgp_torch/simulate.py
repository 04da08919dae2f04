"""Simulation helpers: PSFs, degradation, synthetic skies, star stamps and
star fields, for tests and the chip smoke run.

A numpy copy of ``tpu_sgp/simulate/__init__.py:21-119``: the JAX package's
module cannot be imported without importing JAX. The tests hold the copy
bit-equal to the original.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

# the environment variable that seeds artificial_sky_background, as in the
# JAX package and the reference
SEED_ENV = 'GUIDE_RANDOM_SEED'

__all__ = [
    'gaussian_psf', 'moffat_psf', 'degrade', 'artificial_sky_background',
    'synthetic_star_stamps', 'synthetic_star_field',
]


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


def moffat_psf(size: int = 31, fwhm: float = 2.8,
               beta: float = 2.5) -> np.ndarray:
    """Normalized Moffat PSF (heavier wings than a Gaussian)."""
    gamma = fwhm / (2.0 * np.sqrt(2.0 ** (1.0 / beta) - 1.0))
    c = (size - 1) / 2.0
    y, x = np.mgrid[0:size, 0:size]
    rr = ((x - c) ** 2 + (y - c) ** 2) / gamma ** 2
    p = (1.0 + rr) ** (-beta)
    return p / p.sum()


def degrade(image: np.ndarray, psf: np.ndarray) -> np.ndarray:
    """Blur a truth image by the PSF: 'same' convolution with the kernel
    normalized to unit sum."""
    from scipy.signal import fftconvolve
    k = psf / psf.sum()
    return fftconvolve(image, k, mode='same')


def _circular_degrade(image: np.ndarray, psf: np.ndarray) -> np.ndarray:
    """Circular-convolution blur matching the same-shape solver operator."""
    tf = np.fft.fftn(np.fft.fftshift(psf))
    return np.real(np.fft.ifftn(tf * np.fft.fftn(image)))


def artificial_sky_background(image: np.ndarray, sky_counts: float,
                              gain: float = 1.0,
                              seed: Optional[int] = None) -> np.ndarray:
    """Poisson sky background in counts. The seed is the argument, else
    the environment variable ``SEED_ENV``, else OS entropy."""
    if seed is None:
        env = os.getenv(SEED_ENV, None)
        seed = int(env) if env is not None else None
    rng = np.random.default_rng(seed)
    return rng.poisson(sky_counts * gain, size=image.shape) / gain


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


def synthetic_star_field(height: int, width: int, n_stars: int = 200,
                         fwhm: float = 2.8, psf_size: int = 31,
                         flux_range: Tuple[float, float] = (2e3, 8e4),
                         bkg: float = 150.0, seed: int = 42):
    """Deterministic crowded field + PSF for whole-image workloads.
    Returns (image, psf, truth) with Poisson noise on (truth*psf + bkg)."""
    rng = np.random.default_rng(seed)
    psf = gaussian_psf(psf_size, fwhm)
    truth = np.zeros((height, width))
    ys = rng.integers(2, height - 2, n_stars)
    xs = rng.integers(2, width - 2, n_stars)
    fl = rng.uniform(*flux_range, n_stars)
    np.add.at(truth, (ys, xs), fl)
    blurred = degrade(truth, psf) + bkg
    image = rng.poisson(np.maximum(blurred, 0.0)).astype(np.float64)
    return image, psf, truth
