"""Native equivalents of the DIAPL PSF-pipeline binaries' functions.

The reference's PSF estimation shells out to four external C programs
(the reference's psf/psf_estimation.bash:84-131): ``cutfitsim`` (sub-frame
cutting), ``fwhmm`` (sky + FWHM), ``sfind`` (star list), ``getpsf``
(coefficient fitting; its *outputs* are what the workloads consume).
This module provides the same functions natively on the framework's own
stacks, including writing ``.coo`` star lists in the DIAPL column layout the
star-stamps workload reads (application_sgp_star_stamps.py:42-44).
"""
# Host code (NumPy/SciPy), kept equal to tpu_sgp/psf/pipeline.py:1
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from ..catalog import source_info
from ..image import Cutout2D
from ..utils import sigma_clipped_stats


# tpu_sgp/psf/pipeline.py:23
def cut_subframes(image: np.ndarray, nx: int = 2, ny: int = 5,
                  margin: int = 20) -> List[Tuple[Cutout2D, Tuple[int, int]]]:
    """Cut an nx x ny grid of overlapping sub-frames with a margin
    (cutfitsim equivalent; grid geometry per psf_steps_and_params.MD:100-107).
    Returns [(cutout, (ix, iy)), ...]."""
    h, w = image.shape
    sub_h = h // ny
    sub_w = w // nx
    out = []
    for iy in range(ny):
        for ix in range(nx):
            x0 = max(0, ix * sub_w - margin)
            x1 = min(w, (ix + 1) * sub_w + margin)
            y0 = max(0, iy * sub_h - margin)
            y1 = min(h, (iy + 1) * sub_h + margin)
            cut = Cutout2D(image, ((x0 + x1) / 2, (y0 + y1) / 2),
                           size=(y1 - y0, x1 - x0))
            out.append((cut, (ix + 1, iy + 1)))
    return out


# tpu_sgp/psf/pipeline.py:44
def estimate_sky_and_fwhm(image: np.ndarray,
                          max_stars: int = 50) -> Tuple[float, float]:
    """Sky level + representative stellar FWHM (fwhmm equivalent).

    Sky: sigma-clipped median. FWHM: median catalog FWHM of the brightest
    detected point sources.
    """
    _, sky, _ = sigma_clipped_stats(image)
    scat, _ = source_info(image, box_size=(64, 64))
    if scat is None or len(scat) == 0:
        return sky, np.nan
    t = scat.to_table(['segment_flux', 'fwhm', 'ellipticity'])
    flux = np.asarray(t['segment_flux'].value)
    fwhm = np.asarray(t['fwhm'].value)
    ellip = np.asarray(t['ellipticity'].value)
    # point-like: moderately round sources, brightest first
    ok = np.isfinite(fwhm) & (ellip < 0.5)
    if not ok.any():
        return sky, np.nan
    order = np.argsort(-flux[ok])[:max_stars]
    return sky, float(np.median(fwhm[ok][order]))


# tpu_sgp/psf/pipeline.py:67
def find_stars(image: np.ndarray, sat_level: float = 65000.0,
               n_pixels: int = 5,
               sigma_threshold: float = 1.5) -> np.ndarray:
    """Star finding (sfind equivalent): structured array with the DIAPL
    .coo columns x, y, approx_flux, local_bkg_level,
    num_saturated_pixels_in_aperture."""
    scat, bkg = source_info(image, n_pixels=n_pixels,
                            sigma_threshold=sigma_threshold,
                            localbkg_width=5)
    if scat is None or len(scat) == 0:
        return np.zeros(0, dtype=[('x', 'f8'), ('y', 'f8'),
                                  ('approx_flux', 'f8'),
                                  ('local_bkg_level', 'f8'),
                                  ('num_saturated_pixels_in_aperture', 'i8')])
    t = scat.to_table(['xcentroid', 'ycentroid', 'segment_flux',
                       'local_background', 'bbox_xmin', 'bbox_xmax',
                       'bbox_ymin', 'bbox_ymax'])
    n = len(t)
    out = np.zeros(n, dtype=[('x', 'f8'), ('y', 'f8'), ('approx_flux', 'f8'),
                             ('local_bkg_level', 'f8'),
                             ('num_saturated_pixels_in_aperture', 'i8')])
    out['x'] = t['xcentroid'].value
    out['y'] = t['ycentroid'].value
    out['approx_flux'] = t['segment_flux'].value
    # total sky at each star = global background median + the residual
    # annulus level on the subtracted image. Using the Background2D value
    # AT the star position instead was tried and measured WORSE: with this
    # pipeline's small (5, 5) boxes the local mesh is contaminated by the
    # star itself at star positions (synthetic end-to-end PSF recovery
    # degraded 0.4 rel vs 0.03), while the annulus residual already picks
    # up genuine local sky deviations without sitting on the star.
    out['local_bkg_level'] = (t['local_background'].value
                              + bkg.background_median)
    for i in range(n):
        y0, y1 = int(t['bbox_ymin'].value[i]), int(t['bbox_ymax'].value[i])
        x0, x1 = int(t['bbox_xmin'].value[i]), int(t['bbox_xmax'].value[i])
        out['num_saturated_pixels_in_aperture'][i] = int(
            (image[y0:y1 + 1, x0:x1 + 1] >= sat_level).sum())
    return out


# tpu_sgp/psf/pipeline.py:108
def select_psf_stars(image: np.ndarray, stars: np.ndarray, *,
                     hw: int = 15, max_stars: int = 100,
                     min_flux: float = 100.0,
                     min_sep: Optional[float] = None) -> np.ndarray:
    """Pick PSF-fit candidates from an sfind-equivalent star list
    (getpsf.par NPSF_MAX/MIN_FLUX analog): unsaturated, above min_flux,
    fully inside the frame, isolated by min_sep (default 2*hw), brightest
    first."""
    if min_sep is None:
        min_sep = 2.0 * hw
    h, w = image.shape
    x, y, f = stars['x'], stars['y'], stars['approx_flux']
    ok = ((stars['num_saturated_pixels_in_aperture'] == 0)
          & (f >= min_flux)
          & (x >= hw) & (x < w - hw) & (y >= hw) & (y < h - hw))
    idx = np.flatnonzero(ok)[np.argsort(-f[ok])]
    picked: List[int] = []
    for i in idx:
        if len(picked) >= max_stars:
            break
        # any neighbor within min_sep above 20% of the candidate's flux
        # contaminates the cutout. (This subsumes separation from already-
        # picked stars: candidates arrive brightest-first, so an earlier
        # pick inside min_sep always trips this test.)
        near = np.flatnonzero(((x - x[i]) ** 2 + (y - y[i]) ** 2
                               < min_sep ** 2) & (np.arange(len(x)) != i))
        if near.size and (f[near] > 0.2 * f[i]).any():
            continue
        picked.append(int(i))
    return stars[picked]


# tpu_sgp/psf/pipeline.py:140
def estimate_psf_model(image: np.ndarray, *,
                       hw: int = 15, sat_level: float = 65000.0,
                       max_stars: int = 100, min_flux: float = 100.0,
                       x_orig: Optional[float] = None,
                       y_orig: Optional[float] = None,
                       **fit_kwargs):
    """Fit a DIAPL-format PSF model to one (sub-)frame with no external
    binaries: sfind-equivalent detection -> candidate selection ->
    background-subtracted flux-normalized cutouts -> ``fit_psf_model``
    (the reference's getpsf step, psf_estimation.bash:126).

    Returns (DiaplPSFModel, stars_used) or (None, empty) when no usable
    stars are found.

    Deliberate deviation: the default fit radius is 5.0 px rather than
    getpsf.par's FITRAD=3.0 — rendering a 31x31 matrix extrapolates the
    fit into the wings, and a radius of 3 was measured to leave the wings
    unconstrained under noise (24% matrix error vs 0.4% at radius 5 on the
    synthetic round-trip). Pass fitrad=3.0 for strict DIAPL parity."""
    from .fit import FitStar, fit_psf_model

    fit_kwargs.setdefault('fitrad', 5.0)

    found = find_stars(image, sat_level=sat_level)
    picked = select_psf_stars(image, found, hw=hw, max_stars=max_stars,
                              min_flux=min_flux)
    fit_stars = []
    for row in picked:
        x0, y0 = float(row['x']), float(row['y'])
        cut = Cutout2D(image, (x0, y0), size=2 * hw + 1)
        if cut.data.shape != (2 * hw + 1, 2 * hw + 1):
            continue
        data = (cut.data - row['local_bkg_level']) / max(row['approx_flux'],
                                                         1e-12)
        ox, oy = cut.origin_original
        fit_stars.append(FitStar(data, x0, y0, cx=x0 - ox, cy=y0 - oy))
    if not fit_stars:
        return None, picked
    if x_orig is None:
        x_orig = image.shape[1] / 2.0
    if y_orig is None:
        y_orig = image.shape[0] / 2.0
    fit_kwargs.setdefault('recenter', True)
    model = fit_psf_model(fit_stars, hw=hw, x_orig=x_orig, y_orig=y_orig,
                          **fit_kwargs)
    return model, picked


# tpu_sgp/psf/pipeline.py:188
def psf_estimation(image: np.ndarray, *, nx: int = 2, ny: int = 5,
                   margin: int = 20, hw: int = 15,
                   sat_level: float = 65000.0,
                   out_dir: Optional[str] = None,
                   name: str = 'frame', **fit_kwargs) -> dict:
    """End-to-end PSF estimation over an nx x ny sub-frame grid — the
    native equivalent of the reference's psf_estimation.bash +
    get_psf_coeffs.bash (cutfitsim -> fwhmm -> sfind -> getpsf -> tmpsf),
    with every stage in-process.

    Returns {(ix, iy): DiaplPSFModel} for sub-frames with enough stars.
    With ``out_dir`` set, also writes per-sub-frame artifacts in the
    reference layout: ``psf{name}_{ix}_{iy}.bin.txt`` coefficient files,
    rendered+normalized ``psf{name}_{ix}_{iy}_img.fits`` matrices, and
    ``{name}_{ix}_{iy}.coo`` star lists."""
    models = {}
    for cut, (ix, iy) in cut_subframes(image, nx=nx, ny=ny, margin=margin):
        sub = np.asarray(cut.data, np.float64)
        model, stars = estimate_psf_model(sub, hw=hw, sat_level=sat_level,
                                          **fit_kwargs)
        if model is None:
            continue
        models[(ix, iy)] = model
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            stem = f'{name}_{ix}_{iy}'
            model.to_txt(os.path.join(out_dir, f'psf{stem}.bin.txt'))
            from ..image import writeto
            writeto(os.path.join(out_dir, f'psf{stem}_img.fits'),
                    model.normalized_matrix(2 * hw + 1), overwrite=True)
            write_coo(os.path.join(out_dir, f'{stem}.coo'), stars)
    return models


# tpu_sgp/psf/pipeline.py:222
def write_coo(path: str, stars: np.ndarray,
              header_lines: Optional[List[str]] = None) -> None:
    """Write a DIAPL-layout .coo list (3 header lines then whitespace
    columns), readable by ``tpu_sgp_torch.psf.read_coo``."""
    lines = list(header_lines or
                 ['# tpu_sgp sfind-equivalent star list',
                  '# columns: x y approx_flux local_bkg_level '
                  'num_saturated_pixels_in_aperture', '#'])
    # read_coo skips EXACTLY 3 rows (the DIAPL layout): pad short custom
    # headers so data rows are never silently swallowed
    lines = (lines + ['#'] * 3)[:3]
    with open(path, 'w') as f:
        for ln in lines:
            f.write(ln.rstrip('\n') + '\n')
        for row in stars:
            f.write(f"{row['x']:.3f} {row['y']:.3f} "
                    f"{row['approx_flux']:.2f} "
                    f"{row['local_bkg_level']:.3f} "
                    f"{row['num_saturated_pixels_in_aperture']}\n")
