"""Mosaicking: overlap-blend co-addition with background matching.

The reference reassembles deconvolved tiles by writing temp FITS files and
running ``reproject_and_coadd(..., reproject_exact, match_background=True)``
(the reference's utils.py:392-397). Its pipeline tiles live on
the SAME pixel grid as the parent image (Cutout2D), so exact reprojection
reduces to placement — what remains is (a) the least-squares
background-offset match between overlapping tiles and (b)
footprint-weighted averaging. Both are implemented here directly on arrays
(no disk round-trip); a file-level wrapper preserves the reference
workflow for the CLI. For tiles on DIFFERENT WCS grids (the general
capability of the reference's reproject_exact path),
:func:`reproject_to_grid` / :func:`reproject_and_coadd` resample through
the exact WCS chain with subpixel area sampling.
"""
# Host code (NumPy/SciPy), kept equal to tpu_sgp/image/mosaic.py:1
from __future__ import annotations

import glob
import os
import re
from typing import Sequence, Tuple

import numpy as np


# tpu_sgp/image/mosaic.py:26
def _bbox(origin, shape):
    x0, y0 = int(origin[0]), int(origin[1])
    return x0, y0, x0 + shape[1], y0 + shape[0]


# tpu_sgp/image/mosaic.py:31
def match_backgrounds(tiles: Sequence[np.ndarray],
                      origins: Sequence[Tuple[int, int]]) -> np.ndarray:
    """Additive per-tile offsets o_i (to subtract) minimizing the pairwise
    overlap mean differences, with mean(o) = 0 — the same model as
    reproject's match_background."""
    n = len(tiles)
    rows, rhs = [], []
    for i in range(n):
        xi0, yi0, xi1, yi1 = _bbox(origins[i], tiles[i].shape)
        for j in range(i + 1, n):
            xj0, yj0, xj1, yj1 = _bbox(origins[j], tiles[j].shape)
            ox0, oy0 = max(xi0, xj0), max(yi0, yj0)
            ox1, oy1 = min(xi1, xj1), min(yi1, yj1)
            if ox0 >= ox1 or oy0 >= oy1:
                continue
            pi = tiles[i][oy0 - yi0:oy1 - yi0, ox0 - xi0:ox1 - xi0]
            pj = tiles[j][oy0 - yj0:oy1 - yj0, ox0 - xj0:ox1 - xj0]
            diff = float(np.mean(pi - pj))
            row = np.zeros(n)
            row[i], row[j] = 1.0, -1.0
            rows.append(row)
            rhs.append(diff)
    if not rows:
        return np.zeros(n)
    rows.append(np.ones(n))   # gauge: zero-mean offsets
    rhs.append(0.0)
    sol, *_ = np.linalg.lstsq(np.asarray(rows), np.asarray(rhs), rcond=None)
    return sol


# tpu_sgp/image/mosaic.py:61
def coadd_tiles(tiles: Sequence[np.ndarray],
                origins: Sequence[Tuple[int, int]],
                out_shape: Tuple[int, int],
                match_background: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Blend same-grid tiles into (mosaic, footprint).

    Pixels covered by no tile are NaN in the mosaic and 0 in the footprint.
    """
    offsets = (match_backgrounds(tiles, origins)
               if match_background and len(tiles) > 1
               else np.zeros(len(tiles)))
    acc = np.zeros(out_shape)
    w = np.zeros(out_shape)
    for tile, origin, off in zip(tiles, origins, offsets):
        x0, y0, x1, y1 = _bbox(origin, tile.shape)
        acc[y0:y1, x0:x1] += tile - off
        w[y0:y1, x0:x1] += 1.0
    with np.errstate(invalid='ignore'):
        mosaic = np.where(w > 0, acc / np.where(w > 0, w, 1.0), np.nan)
    return mosaic, w


# tpu_sgp/image/mosaic.py:83
def _bilinear_sample(data: np.ndarray, x: np.ndarray,
                     y: np.ndarray) -> np.ndarray:
    """Bilinear sample at fractional (x, y); NaN outside the frame.

    The WCS round trip (out pixel -> world -> in pixel) carries ~1e-9 px
    of float64 noise, so the boundary test uses a small tolerance —
    otherwise identity reprojections lose their edge pixels."""
    h, w = data.shape
    eps = 1e-6
    valid = ((x >= -eps) & (x <= w - 1 + eps)
             & (y >= -eps) & (y <= h - 1 + eps))
    xc = np.clip(x, 0, w - 1)
    yc = np.clip(y, 0, h - 1)
    x0 = np.clip(np.floor(xc).astype(int), 0, w - 2) if w > 1 else \
        np.zeros_like(xc, int)
    y0 = np.clip(np.floor(yc).astype(int), 0, h - 2) if h > 1 else \
        np.zeros_like(yc, int)
    fx, fy = xc - x0, yc - y0
    v = ((1 - fy) * ((1 - fx) * data[y0, x0] + fx * data[y0, x0 + 1])
         + fy * ((1 - fx) * data[y0 + 1, x0] + fx * data[y0 + 1, x0 + 1])) \
        if (h > 1 and w > 1) else data[y0, x0]
    return np.where(valid, v, np.nan)


# tpu_sgp/image/mosaic.py:107
def reproject_to_grid(data: np.ndarray, in_wcs, out_wcs,
                      out_shape: Tuple[int, int], oversample: int = 3,
                      conserve_flux: bool = True
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Reproject ``data`` from its own WCS onto a DIFFERENT output grid.

    The reference handles cross-grid tiles through
    ``reproject_and_coadd(..., reproject_exact)``
    (the reference's utils.py:392-397). This native equivalent
    area-samples each output pixel on an ``oversample``x``oversample``
    subgrid through the exact WCS chain (out pixel -> world -> in pixel)
    and bilinearly interpolates the input — converging on the exact
    pixel-overlap integral as O(1/oversample^2); ``conserve_flux``
    rescales by the LOCAL pixel-area ratio |d(in pixel)/d(out pixel)|
    (the Jacobian of the composed pixel map, central-differenced per
    output pixel) so total flux (not surface brightness) is preserved,
    matching reproject_exact's convention for the per-pixel-flux images
    this pipeline produces. A global |det CD| ratio would be exact only
    at the fiducials — on an all-sky CAR/HPX output grid the true pixel
    solid angle varies as cos(dec) across the map, a ~2x flux error by
    dec 60 (pinned by the flux-conservation test).

    Returns ``(projected, footprint)`` where footprint is the covered
    fraction of each output pixel (0..1); uncovered pixels are NaN.
    """
    h, w = out_shape
    k = max(1, int(oversample))
    # subpixel centers: p + (i + 0.5)/k - 0.5 for i in 0..k-1
    sub = (np.arange(k) + 0.5) / k - 0.5
    acc = np.zeros(out_shape)
    cnt = np.zeros(out_shape)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    for dy in sub:
        for dx in sub:
            ra, dec = out_wcs.pixel_to_world(xx + dx, yy + dy)
            xi, yi = in_wcs.world_to_pixel(ra, dec)
            v = _bilinear_sample(np.asarray(data, np.float64), xi, yi)
            good = np.isfinite(v)
            acc[good] += v[good]
            cnt += good
    with np.errstate(invalid='ignore'):
        proj = np.where(cnt > 0, acc / np.where(cnt > 0, cnt, 1), np.nan)
    if conserve_flux:
        proj = proj * _local_pixel_jacobian(in_wcs, out_wcs, out_shape,
                                            cnt > 0)
    return proj, cnt / (k * k)


# tpu_sgp/image/mosaic.py:155
def _local_pixel_jacobian(in_wcs, out_wcs, out_shape, covered):
    """|d(in pixel)/d(out pixel)| on the COVERED bounding box of the
    output grid (the uncovered remainder is NaN in the projection and
    would discard the value anyway), by central differences of the
    composed out -> world -> in pixel map with half-pixel probes.
    Output pixels whose probes leave either projection (facet seams,
    footprint edges) fall back to the global |det CD| ratio — only ever
    a thin boundary set, and those pixels carry partial footprints."""
    jac = np.full(out_shape, np.nan)
    if covered.any():
        rows = np.nonzero(covered.any(axis=1))[0]
        cols = np.nonzero(covered.any(axis=0))[0]
        r0, r1 = rows[0], rows[-1] + 1
        c0, c1 = cols[0], cols[-1] + 1
        yy, xx = np.mgrid[r0:r1, c0:c1].astype(np.float64)
        hs = 0.5
        x1, y1 = in_wcs.world_to_pixel(
            *out_wcs.pixel_to_world(xx + hs, yy))
        x2, y2 = in_wcs.world_to_pixel(
            *out_wcs.pixel_to_world(xx - hs, yy))
        x3, y3 = in_wcs.world_to_pixel(
            *out_wcs.pixel_to_world(xx, yy + hs))
        x4, y4 = in_wcs.world_to_pixel(
            *out_wcs.pixel_to_world(xx, yy - hs))
        jac[r0:r1, c0:c1] = np.abs(
            (x1 - x2) * (y3 - y4) - (x3 - x4) * (y1 - y2)) / (4 * hs * hs)
    return np.where(np.isfinite(jac), jac,
                    abs(float(np.linalg.det(out_wcs.cd)))
                    / abs(float(np.linalg.det(in_wcs.cd))))


# tpu_sgp/image/mosaic.py:186
def _match_backgrounds_masked(projs: Sequence[np.ndarray]) -> np.ndarray:
    """Additive offsets (mean 0) from pairwise overlap means, for tiles
    already on a COMMON grid with NaN outside their footprints."""
    n = len(projs)
    rows, rhs = [], []
    for i in range(n):
        fi = np.isfinite(projs[i])
        for j in range(i + 1, n):
            both = fi & np.isfinite(projs[j])
            if not both.any():
                continue
            row = np.zeros(n)
            row[i], row[j] = 1.0, -1.0
            rows.append(row)
            rhs.append(float(np.mean(projs[i][both] - projs[j][both])))
    if not rows:
        return np.zeros(n)
    rows.append(np.ones(n))
    rhs.append(0.0)
    sol, *_ = np.linalg.lstsq(np.asarray(rows), np.asarray(rhs), rcond=None)
    return sol


# tpu_sgp/image/mosaic.py:209
def reproject_and_coadd(tiles: Sequence[np.ndarray], wcs_list: Sequence,
                        out_wcs, out_shape: Tuple[int, int],
                        match_background: bool = True, oversample: int = 3
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Coadd tiles that live on DIFFERENT WCS grids (the general form of
    the reference's ``reconstruct_full_image_from_patches``; same-grid
    tiles should use the cheaper :func:`coadd_tiles`).

    Each tile is reprojected onto the output grid (footprint-weighted),
    backgrounds are least-squares matched on the common grid, and the
    footprint-weighted mean is returned with its total footprint.

    Matching happens in SURFACE-BRIGHTNESS space (before the flux
    Jacobian): a per-tile additive background error is constant there,
    which is exactly the model the constant-offset least-squares fit
    assumes — applying the spatially-varying flux scale first would
    modulate a constant offset into an unmatchable jac(x, y) pattern on
    an all-sky output grid. Each tile's local Jacobian is applied after
    its offset is removed.
    """
    pairs = [reproject_to_grid(t, w_in, out_wcs, out_shape,
                               oversample=oversample, conserve_flux=False)
             for t, w_in in zip(tiles, wcs_list)]
    projs = [p for p, _f in pairs]
    foots = [f for _p, f in pairs]
    offsets = (_match_backgrounds_masked(projs)
               if match_background and len(projs) > 1
               else np.zeros(len(projs)))
    acc = np.zeros(out_shape)
    wsum = np.zeros(out_shape)
    for proj, foot, off, w_in in zip(projs, foots, offsets, wcs_list):
        good = np.isfinite(proj)
        jac = _local_pixel_jacobian(w_in, out_wcs, out_shape, good)
        acc[good] += (proj[good] - off) * jac[good] * foot[good]
        wsum[good] += foot[good]
    with np.errstate(invalid='ignore'):
        mosaic = np.where(wsum > 0, acc / np.where(wsum > 0, wsum, 1),
                          np.nan)
    return mosaic, wsum


_IDX_RE = re.compile(r'_(\d+)\.fits$')


# tpu_sgp/image/mosaic.py:253
def reconstruct_full_image_from_patches(out_shape: Tuple[int, int],
                                        string_key: str = 'image',
                                        dirname: str = 'sgp_reconstruction_results',
                                        match_background: bool = True):
    """File-level reassembly mirroring the reference workflow
    (utils.py:392-397): reads ``temp_deconvolved_{key}_*.fits`` tiles whose
    headers carry TILEX0/TILEY0 origins, blends, returns (mosaic, footprint).
    """
    from .fitsio import read_fits
    candidates = glob.glob(os.path.join(
        dirname, f'temp_deconvolved_{string_key}_*.fits'))
    # only numbered tiles participate; a stray non-numbered file matching
    # the glob must not crash the sort
    paths = sorted((p for p in candidates if _IDX_RE.search(p)),
                   key=lambda p: int(_IDX_RE.search(p).group(1)))
    tiles, origins = [], []
    for p in paths:
        data, hdr = read_fits(p)
        tiles.append(data)
        origins.append((int(hdr.get('TILEX0', 0)), int(hdr.get('TILEY0', 0))))
    return coadd_tiles(tiles, origins, out_shape,
                       match_background=match_background)
