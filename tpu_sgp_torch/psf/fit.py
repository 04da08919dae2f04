"""Native PSF coefficient fitting — the DIAPL ``getpsf`` equivalent.

The reference pipeline obtains PSF model coefficients by shelling out to
the external DIAPL ``getpsf`` C binary
(the reference's psf/psf_estimation.bash:126); the model format is
documented at the reference's psf/README.md:1-19 and its parameters at
the reference's psf/psf_steps_and_params.MD (getpsf.par: NGAUSS=2,
NDEG_LOCAL=2, NDEG_SPAT=1, FITRAD=3.0, SIGMA_INC/SIGMA_MSCALE fixed,
PSF_COS/PSF_SIN/PSF_AX/PSF_AY fitted). This module closes that gap: it fits
the anisotropic multi-Gaussian x local-polynomial x spatial-polynomial model
to detected star cutouts with no external binaries.

Structure of the fit (variable projection):
  * the model is LINEAR in the full coefficient vector given the shape
    parameters theta = (phi, ax, ay) — for fixed theta the optimal
    coefficients are an exact least-squares solve over all stars at once
    (every spatial x local term is one design column);
  * the outer problem optimizes only the 3 nonlinear shape parameters on
    the projected residual (scipy.optimize.least_squares, tiny);
  * optional per-star scale alternation absorbs flux-estimate errors
    (DIAPL's NITER re-weighting analog).

cos/sin are emitted as (cos phi, sin phi) — the reference's own fitted
values are unit-norm to 5 digits, confirming DIAPL's rotation is likewise a
pure angle. sigma_inc / sigma_mscale are fixed inputs exactly as in
getpsf.par.
"""
# Host code (NumPy/SciPy), kept equal to tpu_sgp/psf/fit.py:1
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .diapl import DiaplPSFModel

__all__ = ['fit_psf_model', 'FitStar']


# tpu_sgp/psf/fit.py:39
class FitStar:
    """One star entering the PSF fit: a background-subtracted,
    flux-normalized cutout plus its frame position and (sub-pixel) center
    inside the cutout."""

    # tpu_sgp/psf/fit.py:44
    def __init__(self, data: np.ndarray, x_frame: float, y_frame: float,
                 cx: Optional[float] = None, cy: Optional[float] = None):
        self.data = np.asarray(data, np.float64)
        self.x_frame = float(x_frame)
        self.y_frame = float(y_frame)
        h, w = self.data.shape
        self.cx = (w - 1) / 2.0 if cx is None else float(cx)
        self.cy = (h - 1) / 2.0 if cy is None else float(cy)


# tpu_sgp/psf/fit.py:54
def _local_coords(star: FitStar, fitrad: float):
    """(x, y, z) arrays of local pixel coordinates within the fit radius
    and the corresponding data values (reference pixel layout: x = column
    offset, y = row offset, psf_calculate.py:101-109)."""
    h, w = star.data.shape
    yy, xx = np.mgrid[0:h, 0:w]
    x = xx - star.cx
    y = yy - star.cy
    m = x * x + y * y <= fitrad * fitrad
    return x[m], y[m], star.data[m]


# tpu_sgp/psf/fit.py:66
def _local_basis(x, y, theta, ngauss: int, ldeg: int, sigma_inc: float):
    """(npix, ncomp) local design block: exp(rr_g) * x^m * y^n in the
    coefficient order of DiaplPSFModel.evaluate (gaussian outer, then m,
    then n <= ldeg - m)."""
    phi, ax, ay = theta
    c, s = np.cos(phi), np.sin(phi)
    x1 = c * x - s * y
    y1 = s * x + c * y
    rr = ax * x1 * x1 + ay * y1 * y1
    cols = []
    scale = 1.0
    for _ in range(ngauss):
        f = np.exp(rr * scale)
        a1 = np.ones_like(x)
        for m in range(ldeg + 1):
            a2 = np.ones_like(y)
            for n in range(ldeg - m + 1):
                cols.append(f * a1 * a2)
                a2 = a2 * y
            a1 = a1 * x
        scale *= sigma_inc * sigma_inc
    return np.stack(cols, axis=1)


# tpu_sgp/psf/fit.py:90
def _spatial_basis(xf, yf, ndeg_spat: int, x_orig: float, y_orig: float):
    """(npix, nspat) spatial monomials (x-x_orig)^m (y-y_orig)^n in the
    block order of DiaplPSFModel.local_coeffs (m outer, n <= ndeg-m)."""
    dx = xf - x_orig
    dy = yf - y_orig
    cols = []
    a1 = np.ones_like(dx)
    for m in range(ndeg_spat + 1):
        a2 = np.ones_like(dy)
        for n in range(ndeg_spat - m + 1):
            cols.append(a1 * a2)
            a2 = a2 * dy
        a1 = a1 * dx
    return np.stack(cols, axis=1)


# tpu_sgp/psf/fit.py:106
def _design(theta, xs, ys, xfs, yfs, ngauss, ldeg, sigma_inc, ndeg_spat,
            x_orig, y_orig):
    """Full (npix, nspat*ncomp) design matrix; column s*ncomp + c matches
    vec_coeffs index itot = spatial_block*ncomp + local_index exactly as
    consumed by DiaplPSFModel.local_coeffs/evaluate."""
    L = _local_basis(xs, ys, theta, ngauss, ldeg, sigma_inc)
    S = _spatial_basis(xfs, yfs, ndeg_spat, x_orig, y_orig)
    return (S[:, :, None] * L[:, None, :]).reshape(L.shape[0], -1)


# tpu_sgp/psf/fit.py:116
def fit_psf_model(stars: Sequence[FitStar], *,
                  ngauss: int = 2, ndeg_local: int = 2, ndeg_spat: int = 1,
                  sigma_inc: float = 0.548, sigma_mscale: float = 1.582,
                  fitrad: float = 3.0, hw: int = 15,
                  x_orig: Optional[float] = None,
                  y_orig: Optional[float] = None,
                  theta0: Optional[Tuple[float, float, float]] = None,
                  scale_iters: int = 3,
                  recenter: bool = False) -> DiaplPSFModel:
    """Fit DIAPL PSF model coefficients to star cutouts (getpsf equivalent).

    Args:
      stars: FitStar sequence (background-subtracted, roughly
        flux-normalized cutouts). At least enough stars to constrain the
        spatial polynomial (>= (ndeg_spat+1)(ndeg_spat+2)/2, spread over
        the frame).
      ngauss/ndeg_local/ndeg_spat/sigma_inc/sigma_mscale/fitrad/hw: model
        hyperparameters, defaults = the reference getpsf.par values.
      x_orig/y_orig: spatial-polynomial origin; defaults to the mean star
        position (DIAPL uses the sub-frame center).
      theta0: optional (phi, ax, ay) init; default from image moments.
      scale_iters: per-star scale refinement rounds (absorbs flux errors).
      recenter: fit per-star subpixel center offsets jointly with the
        shape parameters, seeded from a windowed moment centroid
        (DIAPL RECENTER analog).
    Returns: DiaplPSFModel with fitted cos/sin/ax/ay + vec_coeffs, ready
      for .matrix()/.local_coeffs()/.to_txt().
    """
    from scipy.optimize import least_squares

    if len(stars) == 0:
        raise ValueError('no stars to fit')
    if ndeg_local != 2:
        # the evaluator hardcodes local degree 2 (see DiaplPSFModel);
        # accepting another value would stamp a header that disagrees with
        # the coefficient layout actually fitted, silently mis-slicing
        # vec_coeffs downstream
        raise ValueError('ndeg_local must be 2 (DiaplPSFModel evaluates a '
                         'fixed local design of degree 2); got '
                         f'{ndeg_local}')
    ldeg = 2

    if recenter:
        stars = [_recentered(s) for s in stars]

    if x_orig is None:
        x_orig = float(np.mean([s.x_frame for s in stars]))
    if y_orig is None:
        y_orig = float(np.mean([s.y_frame for s in stars]))

    def gather(stars):
        xs, ys, zs, xfs, yfs, six = [], [], [], [], [], []
        for i, st in enumerate(stars):
            x, y, z = _local_coords(st, fitrad)
            xs.append(x); ys.append(y); zs.append(z)
            xfs.append(np.full(x.shape, st.x_frame))
            yfs.append(np.full(x.shape, st.y_frame))
            six.append(np.full(x.shape, i, np.int64))
        return (np.concatenate(xs), np.concatenate(ys), np.concatenate(zs),
                np.concatenate(xfs), np.concatenate(yfs),
                np.concatenate(six))

    xs, ys, zs, xfs, yfs, star_ix = gather(stars)

    ncomp = ngauss * (ldeg + 1) * (ldeg + 2) // 2
    nspat = (ndeg_spat + 1) * (ndeg_spat + 2) // 2
    if zs.size < ncomp * nspat:
        raise ValueError(
            f'{zs.size} fit pixels cannot constrain {ncomp * nspat} '
            f'coefficients; add stars or raise fitrad')

    if theta0 is None:
        theta0 = _moment_init(stars, fitrad)

    scales = np.ones(len(stars))

    def make_model(theta, coef):
        phi, ax, ay = theta
        return DiaplPSFModel(
            hw=hw, ndeg_spat=ndeg_spat, ndeg_local=ndeg_local,
            ngauss=ngauss, recenter=float(bool(recenter)),
            cos=float(np.cos(phi)), sin=float(np.sin(phi)), ax=float(ax),
            ay=float(ay), sigma_inc=sigma_inc, sigma_mscale=sigma_mscale,
            fitrad=fitrad, x_orig=x_orig, y_orig=y_orig,
            vec_coeffs=np.asarray(coef, np.float64))

    # When recentering, per-star subpixel center offsets (dcx_i, dcy_i)
    # join the nonlinear parameter vector: [phi, ax, ay, dc_1x, dc_1y, ...].
    # The fit-pixel SET stays fixed (chosen at the initial centers); only
    # the local coordinates shift — a joint optimization, not an
    # alternation, so center/shape cross-talk cannot stall convergence.
    nstars = len(stars)
    n_center = 2 * nstars if recenter else 0

    def split(params):
        theta = params[:3]
        if n_center:
            off = params[3:].reshape(nstars, 2)
            x = xs - off[star_ix, 0]
            y = ys - off[star_ix, 1]
        else:
            x, y = xs, ys
        return theta, x, y

    def projected_residual(params, target):
        theta, x, y = split(params)
        A = _design(theta, x, y, xfs, yfs, ngauss, ldeg, sigma_inc,
                    ndeg_spat, x_orig, y_orig)
        c, *_ = np.linalg.lstsq(A, target, rcond=None)
        return A @ c - target, c, A

    params = np.concatenate([np.asarray(theta0, np.float64),
                             np.zeros(n_center)])
    coef = None
    for _ in range(max(1, scale_iters)):
        target = zs / scales[star_ix]
        sol = least_squares(lambda p: projected_residual(p, target)[0],
                            params, method='lm', xtol=1e-14, ftol=1e-14)
        params = sol.x
        # one evaluation at the converged params yields coefficients AND
        # the design matrix for the scale update below
        _, coef, A = projected_residual(params, target)
        # per-star scale: <model, z> / <model, model> on the original data
        model = A @ coef
        num = np.bincount(star_ix, model * zs, minlength=nstars)
        den = np.bincount(star_ix, model * model, minlength=nstars)
        new_scales = np.where(den > 0, num / np.maximum(den, 1e-300), 1.0)
        converged = np.allclose(new_scales, scales, rtol=1e-12, atol=1e-15)
        scales = new_scales
        if converged:
            break

    return make_model(params[:3], coef)


# tpu_sgp/psf/fit.py:251
def _moment_init(stars: Sequence[FitStar], fitrad: float):
    """(phi, ax, ay) init from intensity second moments of the stacked
    normalized cutouts."""
    sxx = sxy = syy = wsum = 0.0
    for st in stars:
        x, y, z = _local_coords(st, max(fitrad, 3.0))
        w = np.maximum(z, 0.0)
        wsum += w.sum()
        sxx += (w * x * x).sum()
        sxy += (w * x * y).sum()
        syy += (w * y * y).sum()
    if wsum <= 0:
        return (0.0, -0.8, -0.8)    # getpsf.par PSF_AX/PSF_AY defaults
    cxx, cxy, cyy = sxx / wsum, sxy / wsum, syy / wsum
    phi = 0.5 * np.arctan2(2 * cxy, cxx - cyy)
    c, s = np.cos(phi), np.sin(phi)
    v1 = c * c * cxx + 2 * c * s * cxy + s * s * cyy
    v2 = s * s * cxx - 2 * c * s * cxy + c * c * cyy
    ax = -0.5 / max(v1, 0.25)
    ay = -0.5 / max(v2, 0.25)
    return (float(phi), float(ax), float(ay))


# tpu_sgp/psf/fit.py:274
def _recentered(st: FitStar, radius: float = 3.0,
                iters: int = 3) -> FitStar:
    """Centroid refinement: intensity-weighted mean within ``radius`` of
    the current center, seeded at the peak pixel and iterated (a windowed
    moment is unbiased for subpixel shifts where the full-stamp moment is
    pulled by the polynomial wings)."""
    h, w = st.data.shape
    yy, xx = np.mgrid[0:h, 0:w]
    z = np.maximum(st.data, 0.0)
    if z.sum() <= 0:
        return st
    cy, cx = np.unravel_index(np.argmax(z), z.shape)
    cx, cy = float(cx), float(cy)
    for _ in range(iters):
        m = (xx - cx) ** 2 + (yy - cy) ** 2 <= radius * radius
        tot = z[m].sum()
        if tot <= 0:
            break
        cx = float((z * xx)[m].sum() / tot)
        cy = float((z * yy)[m].sum() / tot)
    return FitStar(st.data, st.x_frame, st.y_frame, cx=cx, cy=cy)
