"""Restoration-quality metrics.

Covers the reference metric utilities: azimuthal radial profiles
(utils.py:81-92), LevMar Gaussian profile fits (utils.py:180-202),
1-Wasserstein profile distance (utils.py:276-291), spurious-detection
validation (utils.py:313-329), and the rel-err figure used by the
simulation tests.
"""
# Host code (NumPy/SciPy), kept equal to tpu_sgp/metrics/__init__.py:1
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

__all__ = ['radial_profile', 'fit_radprof', 'RadProfFit',
           'wasserstein_distance_norm', 'relative_error',
           'validation_source', 'flux_fractional_difference']


# tpu_sgp/metrics/__init__.py:20
def radial_profile(data: np.ndarray, center: Tuple[float, float]) -> list:
    """Integer-radius azimuthal average via bincount.

    NOTE (faithful to the reference, utils.py:86): the radius is computed as
    sqrt((row - center[0])^2 + (col - center[1])^2) — the reference passes
    (xcentroid, ycentroid) as ``center`` while np.indices yields (row, col),
    an x/y swap. For the (near-circular) star stamps this is harmless, and
    workload parity requires reproducing it.
    """
    h, w = data.shape
    dr2 = (np.arange(h, dtype=np.float64) - center[0]) ** 2
    dc2 = (np.arange(w, dtype=np.float64) - center[1]) ** 2
    rbin = np.sqrt(dr2[:, None] + dc2[None, :]).astype(int).ravel()
    counts = np.bincount(rbin)
    sums = np.bincount(rbin, np.asarray(data, np.float64).ravel())
    return (sums / counts).tolist()


# tpu_sgp/metrics/__init__.py:38
def _gauss1d(x, amplitude, mean, stddev):
    return amplitude * np.exp(-0.5 * ((x - mean) / stddev) ** 2)


# tpu_sgp/metrics/__init__.py:42
class RadProfFit(NamedTuple):
    """Result of ``fit_radprof``: the historical fitted curve and parameter
    errors at indices [0]/[1], plus an explicit ``ok`` flag so callers can
    tell a converged fit from the seed-curve fallback. NOTE: 2-target
    unpacking (``fitted, perr = fit_radprof(...)``) no longer works — use
    3-target unpacking or field access."""
    fitted: np.ndarray
    perr: np.ndarray
    ok: bool


# tpu_sgp/metrics/__init__.py:53
def fit_radprof(radprof, table) -> RadProfFit:
    """Least-squares Gaussian1D fit to a radial profile, seeded from the
    catalog FWHM (reference utils.py:180-202). Returns
    ``RadProfFit(fitted, perr, ok)``; ``ok=False`` means the optimizer
    failed and ``fitted`` is the seed curve (perr all-NaN)."""
    from scipy.optimize import curve_fit
    from ..utils import GAUSSIAN_FWHM_TO_SIGMA

    radprof = np.asarray(radprof, np.float64)
    x = np.arange(len(radprof), dtype=np.float64)
    fwhm = float(np.asarray(table['fwhm'])[0]) if table is not None else 3.0
    p0 = (0.8 * float(np.max(radprof)), 0.0,
          max(GAUSSIAN_FWHM_TO_SIGMA * fwhm, 1e-3))
    try:
        import warnings
        with warnings.catch_warnings():
            # degenerate profiles (flat/deconvolved spikes) legitimately
            # yield singular covariance; the reference returns NaN errors
            # in that case too
            warnings.simplefilter('ignore')
            popt, pcov = curve_fit(_gauss1d, x, radprof, p0=p0, maxfev=5000)
        fitted = _gauss1d(x, *popt)
        perr = np.sqrt(np.abs(np.diag(pcov)))
        ok = True
    except Exception:
        fitted = _gauss1d(x, *p0)
        perr = np.full(3, np.nan)
        ok = False
    return RadProfFit(fitted, perr, ok)


# tpu_sgp/metrics/__init__.py:84
def wasserstein_distance_norm(p, q) -> float:
    """1-Wasserstein distance between two radial profiles
    (reference utils.py:276-291)."""
    from scipy.stats import wasserstein_distance
    return float(wasserstein_distance(np.asarray(p), np.asarray(q)))


# tpu_sgp/metrics/__init__.py:91
def relative_error(x: np.ndarray, obj: np.ndarray) -> float:
    """||x - obj|| / ||obj|| (the simulation-test figure of merit)."""
    e = np.asarray(x) - np.asarray(obj)
    return float(np.sqrt(np.sum(e * e) / np.sum(np.asarray(obj) ** 2)))


# tpu_sgp/metrics/__init__.py:97
def flux_fractional_difference(restored_flux: float,
                               original_flux: float) -> float:
    """1 - F_restored / F_original (star-stamps workload metric)."""
    return 1.0 - restored_flux / original_flux


# tpu_sgp/metrics/__init__.py:103
def validation_source(image: np.ndarray, coord, bkgmap: np.ndarray,
                      rmsmap: np.ndarray, size: int = 100) -> bool:
    """Spurious-detection guard: mean of the 3 brightest cutout pixels must
    exceed bkg + 3*rms (reference utils.py:313-329)."""
    from ..image.cutout import Cutout2D
    src = Cutout2D(image, coord, size=size, mode='partial',
                   fill_value=0.0).data
    bkg = np.median(Cutout2D(bkgmap, coord, size=size, mode='partial',
                             fill_value=0.0).data)
    rms = np.mean(Cutout2D(rmsmap, coord, size=size, mode='partial',
                           fill_value=0.0).data)
    source_pixs = np.sort(src.ravel())[-3:].mean()
    return bool(source_pixs > bkg + 3.0 * rms)
