"""Seeded inputs: star stamps that share one PSF, and crowded star fields.

The benchmark's own copies of the program's simulation helpers (the
star-stamp and star-field models of ``tpu_sgp_torch/simulate.py``), so that
what the benchmark feeds the program does not come from the program. The
stamps are made for the whole batch at once; for one seed they equal the
original's, which draws the same numbers one stamp at a time.
"""
from __future__ import annotations

import numpy as np


def gaussian_psf(size: int, fwhm: float) -> np.ndarray:
    """A circular Gaussian PSF of unit sum on a size x size grid."""
    sig = fwhm / 2.354820045030949
    c = (size - 1) / 2.0
    y, x = np.mgrid[0:size, 0:size]
    p = np.exp(-0.5 * (((x - c) / sig) ** 2 + ((y - c) / sig) ** 2))
    return p / p.sum()


def star_stamps(n: int, size: int, fwhm: float, bkg: float, seed: int,
                flux_range=(2e3, 5e4), jitter: float = 1.5):
    """n stamps of one Poisson-noised star each, blurred circularly by the
    shared PSF over a flat background. Returns float64 ``(stamps (n, size,
    size), psf, bkgs (n,), fluxes (n,))``, the fluxes being each stamp's sum
    less its background, as the star-stamp driver measures them."""
    rng = np.random.default_rng(seed)
    psf = gaussian_psf(size, fwhm)
    c = (size - 1) / 2.0
    star = rng.uniform(*flux_range, n)
    dx = rng.uniform(-jitter, jitter, n)
    dy = rng.uniform(-jitter, jitter, n)
    iy = np.round(c + dy).astype(int) % size
    ix = np.round(c + dx).astype(int) % size
    # a point source blurred circularly by the PSF rolled forward by half
    # its size (NumPy's fftshift) is that roll shifted to the source
    k = np.fft.fftshift(psf)
    r = np.arange(size)
    rows = (r[None, :] - iy[:, None]) % size
    cols = (r[None, :] - ix[:, None]) % size
    blurred = star[:, None, None] * k[rows[:, :, None], cols[:, None, :]]
    stamps = rng.poisson(blurred + bkg).astype(np.float64)
    bkgs = np.full(n, float(bkg))
    return stamps, psf, bkgs, stamps.sum(axis=(1, 2)) - size * size * bkgs


def convolve_same(image: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Linear convolution cropped to the image, centred on the kernel (as
    scipy.signal.fftconvolve's 'same' mode, whose import alone takes
    seconds), through NumPy's real FFT on the full linear grid."""
    (h, w), (kh, kw) = image.shape, kernel.shape
    grid = (h + kh - 1, w + kw - 1)
    full = np.fft.irfft2(np.fft.rfft2(image, grid) * np.fft.rfft2(kernel, grid),
                         grid)
    oy, ox = (kh - 1) // 2, (kw - 1) // 2
    return full[oy:oy + h, ox:ox + w]


def star_field(height: int, width: int, n_stars: int, fwhm: float,
               psf_size: int, bkg: float, seed: int,
               flux_range=(2e3, 8e4)):
    """A crowded field: n_stars point sources, blurred linearly by the PSF
    ('same' convolution), a flat background and Poisson noise. Returns
    ``(image (height, width) float64, psf)``."""
    rng = np.random.default_rng(seed)
    psf = gaussian_psf(psf_size, fwhm)
    truth = np.zeros((height, width))
    ys = rng.integers(2, height - 2, n_stars)
    xs = rng.integers(2, width - 2, n_stars)
    fl = rng.uniform(*flux_range, n_stars)
    np.add.at(truth, (ys, xs), fl)
    blurred = convolve_same(truth, psf / psf.sum()) + bkg
    image = rng.poisson(np.maximum(blurred, 0.0)).astype(np.float64)
    return image, psf
