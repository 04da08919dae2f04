"""PSF manipulation: FWHM scaling and normalization checks."""
# Host code (NumPy/SciPy), kept equal to tpu_sgp/psf/kernels.py:1
from __future__ import annotations

import numpy as np

from ..utils import convolve2d_fill, make_2dgaussian_kernel


# tpu_sgp/psf/kernels.py:9
def scale_psf(psf: np.ndarray, gaussian_fwhm: float = 1.2,
              size=None) -> np.ndarray:
    """Broaden a PSF by convolving with a 2D Gaussian of the given FWHM and
    renormalize to sum 1 (reference utils.py:249-272)."""
    if size is None:
        size = psf.shape
    if np.isscalar(size):
        size = (int(size), int(size))
    kernel = make_2dgaussian_kernel(gaussian_fwhm, size=size[0])
    scaled = convolve2d_fill(psf, kernel)
    return scaled / scaled.sum()


# tpu_sgp/psf/kernels.py:22
def normalize_psf(psf: np.ndarray) -> np.ndarray:
    return np.asarray(psf, np.float64) / np.sum(psf)
