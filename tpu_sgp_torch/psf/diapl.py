"""DIAPL PSF model: coefficient-file parsing + vectorized evaluation.

The reference renders PSF matrices from DIAPL ``getpsf`` coefficient files
with a pure-Python triple loop over 961 pixels
(the reference's psf/psf_calculate.py:52-111; file format documented at
the reference's psf/README.md:1-19). Here the anisotropic multi-Gaussian x
local-polynomial model (DIAPL ``psf_core.c`` semantics) is evaluated in one
vectorized pass over the whole pixel grid, with an optional C++ fast path
(tpu_sgp.psf.native) for bulk spatially-varying evaluation.

Model, per pixel (x, y) in local coordinates:
    x1 = cos*x - sin*y ; y1 = sin*x + cos*y
    rr_0 = ax*x1^2 + ay*y1^2 ;  rr_{g+1} = rr_g * sigma_inc^2
    psf(x, y) = sum_g exp(rr_g) * sum_{m+n<=ldeg} c[g,m,n] x^m y^n
with coefficient order c iterated as (gaussian, m, n<=ldeg-m).
"""
# Host code (NumPy/SciPy), kept equal to tpu_sgp/psf/diapl.py:1
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


# tpu_sgp/psf/diapl.py:25
@dataclass
class DiaplPSFModel:
    hw: int
    ndeg_spat: int
    ndeg_local: int
    ngauss: int
    recenter: float
    cos: float
    sin: float
    ax: float
    ay: float
    sigma_inc: float
    sigma_mscale: float
    fitrad: float
    x_orig: float
    y_orig: float
    vec_coeffs: np.ndarray = field(default_factory=lambda: np.zeros(0))
    # The reference evaluates with a hardcoded local degree of 2
    # (psf_calculate.py:23) regardless of ndeg_local; preserved.
    ldeg: int = 2

    # tpu_sgp/psf/diapl.py:46
    @classmethod
    def from_txt(cls, path: str) -> 'DiaplPSFModel':
        with open(path) as f:
            data = [float(line.strip()) for line in f if line.strip()]
        return cls(hw=int(data[0]), ndeg_spat=int(data[1]),
                   ndeg_local=int(data[2]), ngauss=int(data[3]),
                   recenter=data[4], cos=data[5], sin=data[6], ax=data[7],
                   ay=data[8], sigma_inc=data[9], sigma_mscale=data[10],
                   fitrad=data[11], x_orig=data[12], y_orig=data[13],
                   vec_coeffs=np.asarray(data[14:], np.float64))

    # tpu_sgp/psf/diapl.py:57
    def to_txt(self, path: str) -> None:
        """Write the ``.bin.txt`` coefficient layout (one value per line:
        14 header fields then vec_coeffs; the reference's psf/README.md:1-19)
        so fitted models round-trip through ``from_txt``."""
        with open(path, 'w') as f:
            for v in (self.hw, self.ndeg_spat, self.ndeg_local, self.ngauss):
                f.write(f'{int(v)}\n')
            for v in (self.recenter, self.cos, self.sin, self.ax, self.ay,
                      self.sigma_inc, self.sigma_mscale, self.fitrad,
                      self.x_orig, self.y_orig):
                f.write(f'{v:.17g}\n')
            for v in self.vec_coeffs:
                f.write(f'{v:.17g}\n')

    # tpu_sgp/psf/diapl.py:71
    @property
    def n_local(self) -> int:
        """Coefficients per spatial term: ngauss * #monomials(ldeg)."""
        return self.ngauss * (self.ldeg + 1) * (self.ldeg + 2) // 2

    # tpu_sgp/psf/diapl.py:76
    @property
    def n_spatial(self) -> int:
        return (self.ndeg_spat + 1) * (self.ndeg_spat + 2) // 2

    # tpu_sgp/psf/diapl.py:80
    def evaluate(self, x: np.ndarray, y: np.ndarray,
                 coeffs: Optional[np.ndarray] = None) -> np.ndarray:
        """Vectorized psf(x, y) for arrays of local coordinates."""
        if coeffs is None:
            coeffs = self.vec_coeffs
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        x1 = self.cos * x - self.sin * y
        y1 = self.sin * x + self.cos * y
        rr = self.ax * x1 * x1 + self.ay * y1 * y1

        out = np.zeros_like(x, dtype=np.float64)
        icomp = 0
        scale = 1.0
        for _ in range(self.ngauss):
            f = np.exp(rr * scale)
            a1 = np.ones_like(x)
            for m in range(self.ldeg + 1):
                a2 = np.ones_like(y)
                for n in range(self.ldeg - m + 1):
                    out += float(coeffs[icomp]) * f * a1 * a2
                    icomp += 1
                    a2 = a2 * y
                a1 = a1 * x
            scale *= self.sigma_inc * self.sigma_inc
        return out

    # tpu_sgp/psf/diapl.py:107
    def local_coeffs(self, xpsf: float, ypsf: float) -> np.ndarray:
        """Spatially-varying local coefficients at frame position
        (xpsf, ypsf): the spatial polynomial of degree ndeg_spat collapses
        the full coefficient vector to one local set (DIAPL init_psf;
        the reference's port is present but unused, psf_calculate.py:141-166).
        """
        ncomp = self.n_local
        local = np.zeros(ncomp)
        itot = 0
        a1 = 1.0
        for m in range(self.ndeg_spat + 1):
            a2 = 1.0
            for n in range(self.ndeg_spat - m + 1):
                local += self.vec_coeffs[itot:itot + ncomp] * a1 * a2
                itot += ncomp
                a2 *= ypsf - self.y_orig
            a1 *= xpsf - self.x_orig
        return local

    # tpu_sgp/psf/diapl.py:126
    def matrix(self, size: int = 31, coeffs: Optional[np.ndarray] = None
               ) -> np.ndarray:
        """Render the (size x size) PSF matrix over integer offsets
        -size//2 .. -size//2 + size - 1 (odd size: the reference's
        symmetric [-h, h]; even size: [-h, h-1] — exactly ``size`` samples
        either way, never size+1); matrix[i+h, j+h] = psf(x=j, y=i)
        matching the reference's index layout (psf_calculate.py:101-109)."""
        h = size // 2
        i = np.arange(size) - h           # rows <- y
        j = np.arange(size) - h           # cols <- x
        yy, xx = np.meshgrid(i, j, indexing='ij')
        return self.evaluate(xx, yy, coeffs)

    # tpu_sgp/psf/diapl.py:139
    def normalized_matrix(self, size: int = 31,
                          coeffs: Optional[np.ndarray] = None) -> np.ndarray:
        mat = self.matrix(size, coeffs)
        return mat / mat.sum()


# Reference-API shim (psf_calculate.PSF)
# tpu_sgp/psf/diapl.py:146
class PSF:
    # tpu_sgp/psf/diapl.py:147
    def __init__(self, txt_file: str):
        self.model = DiaplPSFModel.from_txt(txt_file)
        for k in ('hw', 'ndeg_spat', 'ndeg_local', 'ngauss', 'cos', 'sin',
                  'ax', 'ay', 'sigma_inc', 'x_orig', 'y_orig'):
            setattr(self, k, getattr(self.model, k))
        self.vec_coeffs = self.model.vec_coeffs

    # tpu_sgp/psf/diapl.py:154
    def get_psf_mat(self) -> np.ndarray:
        self.psf_mat = self.model.matrix(31)
        return self.psf_mat

    # tpu_sgp/psf/diapl.py:158
    def normalize_psf_mat(self) -> np.ndarray:
        return self.model.normalized_matrix(31)

    # tpu_sgp/psf/diapl.py:161
    def calc_psf_pix(self, coeffs, x, y) -> float:
        """Single-pixel evaluation (reference psf_calculate.py:52-90)."""
        return float(self.model.evaluate(np.float64(x), np.float64(y),
                                         np.asarray(coeffs, np.float64)))

    # tpu_sgp/psf/diapl.py:166
    @staticmethod
    def check_symmetric(coeffs, rtol=1e-05, atol=1e-08) -> bool:
        coeffs = np.asarray(coeffs)
        return bool(np.allclose(coeffs, coeffs.T, rtol=rtol, atol=atol))


# tpu_sgp/psf/diapl.py:172
def read_coo(path: str):
    """Read a DIAPL ``sfind`` star list (.coo): 3 comment rows then
    whitespace columns x, y, approx_flux, local_bkg_level,
    num_saturated_pixels (reference application_sgp_star_stamps.py:39-44).
    Returns a pandas DataFrame with those column names."""
    import pandas as pd
    df = pd.read_csv(path, skiprows=3, header=None, sep=r'\s+')
    df.columns = ['x', 'y', 'approx_flux', 'local_bkg_level',
                  'num_saturated_pixels_in_aperture'][:df.shape[1]]
    return df
