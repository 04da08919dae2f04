"""Source measurement (photutils SourceCatalog equivalent).

Computes, per labeled segment, the quantities the reference workloads read
through ``SourceCatalog(...).to_table(columns=DEFAULT_COLUMNS)``
(the reference's sgp.py:35-39,
application_sgp_star_stamps.py:63-66, 90-94): centroids and shape moments
(from the convolved data when provided, as photutils does), segment flux,
local background from a rectangular annulus, ellipticity and circularized
FWHM.

All per-segment quantities are computed from the in-segment pixels gathered
in ONE pass over the label image (``np.flatnonzero`` + ``bincount``/
``ufunc.at`` on the gathered vectors), not a Python loop over sources and
not repeated full-image passes — catalog extraction is a host hot path in
the batched workloads.

Non-finite pixels in ``data`` or ``convolved_data`` are automatically
masked out of every measurement (photutils SourceCatalog semantics);
fully-masked sources report NaN statistics, and segment bboxes keep all
pixels (photutils derives them from the segmentation image alone).
"""
# Host code (NumPy/SciPy), kept equal to tpu_sgp/catalog/properties.py:1
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils import sigma_clipped_stats
from .segmentation import SegmentationImage


# tpu_sgp/catalog/properties.py:32
class Column(np.ndarray):
    """ndarray with a ``.value`` attribute (astropy Quantity-column shim)."""

    # tpu_sgp/catalog/properties.py:35
    def __new__(cls, arr):
        return np.asarray(arr).view(cls)

    # tpu_sgp/catalog/properties.py:38
    @property
    def value(self):
        return np.asarray(self)


# tpu_sgp/catalog/properties.py:43
class Table:
    """Minimal column-indexed table compatible with the reference's usage
    (``table['fwhm'].value[0]``, len(), iteration)."""

    # tpu_sgp/catalog/properties.py:47
    def __init__(self, columns: Dict[str, np.ndarray]):
        self._cols = {k: Column(v) for k, v in columns.items()}

    # tpu_sgp/catalog/properties.py:50
    def __getitem__(self, key):
        return self._cols[key]

    # tpu_sgp/catalog/properties.py:53
    def __setitem__(self, key, val):
        self._cols[key] = Column(val)

    # tpu_sgp/catalog/properties.py:56
    def __len__(self):
        first = next(iter(self._cols.values()), np.empty(0))
        return len(first)

    # tpu_sgp/catalog/properties.py:60
    @property
    def colnames(self) -> List[str]:
        return list(self._cols)

    # tpu_sgp/catalog/properties.py:64
    def to_pandas(self):
        import pandas as pd
        return pd.DataFrame({k: np.asarray(v) for k, v in self._cols.items()})

    # tpu_sgp/catalog/properties.py:68
    def __repr__(self):
        return f'<Table rows={len(self)} cols={self.colnames}>'


# tpu_sgp/catalog/properties.py:72
class SourceCatalog:
    # tpu_sgp/catalog/properties.py:73
    def __init__(self, data: np.ndarray, segment_img: SegmentationImage,
                 background: Optional[np.ndarray] = None,
                 convolved_data: Optional[np.ndarray] = None,
                 error: Optional[np.ndarray] = None,
                 localbkg_width: int = 0, wcs=None):
        self.data = np.asarray(data, np.float64)
        self.segm = segment_img
        self.background = background
        self.conv = (np.asarray(convolved_data, np.float64)
                     if convolved_data is not None else self.data)
        self.error = error
        self.localbkg_width = localbkg_width
        self.wcs = wcs
        self._measure()

    # tpu_sgp/catalog/properties.py:88
    def _measure(self):
        labels = self.segm.labels
        n = labels.size
        h, w = self.data.shape
        seg = self.segm.data
        if n and int(labels[-1]) != n:
            remap = np.zeros(int(labels.max()) + 1, np.int32)
            remap[labels] = np.arange(1, n + 1, dtype=np.int32)
            seg = remap[seg]
        m = n + 1

        # Every per-segment statistic only involves in-segment pixels, which
        # are typically a few percent of a survey frame: gather them ONCE and
        # run all accumulations on the gathered vectors (one full-image pass
        # total, instead of one per moment) — catalog extraction is a host
        # hot path at megapixel scale.
        nz_all = np.flatnonzero(seg.ravel())
        lab_all = seg.ravel()[nz_all]
        yi_all = (nz_all // w).astype(np.int32)
        xi_all = (nz_all % w).astype(np.int32)

        # photutils automatically masks non-finite values in data OR
        # convolved_data and excludes them from every measurement (area,
        # fluxes, min/max, moments); the segment bbox alone comes from the
        # segmentation image itself and keeps all pixels
        dval_all = self.data.ravel()[nz_all]
        cval_all = self.conv.ravel()[nz_all]
        fin = np.isfinite(dval_all) & np.isfinite(cval_all)
        if fin.all():
            nz, lab, dval, cval = nz_all, lab_all, dval_all, cval_all
            yi, xi = yi_all, xi_all
        else:
            nz, lab = nz_all[fin], lab_all[fin]
            dval, cval = dval_all[fin], cval_all[fin]
            yi, xi = yi_all[fin], xi_all[fin]
        yf = yi.astype(np.float64)
        xf = xi.astype(np.float64)

        out = {}
        out['label'] = labels.astype(float)

        out['area'] = np.bincount(lab, minlength=m)[1:].astype(float)
        out['segment_flux'] = np.bincount(lab, weights=dval,
                                          minlength=m)[1:]
        # photutils: fully-masked sources get NaN-valued photometry
        out['segment_flux'][out['area'] == 0] = np.nan
        if self.error is not None:
            e2 = np.asarray(self.error, np.float64).ravel()[nz] ** 2
            out['segment_fluxerr'] = np.sqrt(
                np.bincount(lab, weights=e2, minlength=m)[1:])
            out['segment_fluxerr'][out['area'] == 0] = np.nan
        else:
            out['segment_fluxerr'] = np.full(n, np.nan)

        if n:
            minv = np.full(m, np.inf)
            maxv = np.full(m, -np.inf)
            np.minimum.at(minv, lab, dval)
            np.maximum.at(maxv, lab, dval)
            # a fully-masked segment has no finite pixel: NaN stats
            empty = minv == np.inf
            minv[empty] = np.nan
            maxv[empty] = np.nan
            out['min_value'] = minv[1:]
            out['max_value'] = maxv[1:]
            # first raster-order pixel attaining the segment max (photutils
            # maxval_{x,y}index semantics: np.argmax over the unmasked
            # segment pixels)
            with np.errstate(invalid='ignore'):
                is_max = dval == maxv[lab]
            first = np.full(m, np.iinfo(np.int64).max)
            np.minimum.at(first, lab[is_max], nz[is_max])
            unset = first == np.iinfo(np.int64).max  # fully-masked segment
            xidx = (first % w).astype(float)
            yidx = (first // w).astype(float)
            xidx[unset] = np.nan
            yidx[unset] = np.nan
            out['maxval_xindex'] = xidx[1:]
            out['maxval_yindex'] = yidx[1:]
        else:
            out['min_value'] = out['max_value'] = np.empty(0)
            out['maxval_xindex'] = out['maxval_yindex'] = np.empty(0)

        # moments on the convolved data, negative values zeroed; labels
        # whose positive-flux total is zero fall back to uniform weights
        wgt = np.maximum(cval, 0.0)
        tot = np.bincount(lab, weights=wgt, minlength=m)[1:]
        bad = tot <= 0
        if bad.any():
            wgt = np.where(bad[lab - 1], 1.0, wgt)
            tot = np.bincount(lab, weights=wgt, minlength=m)[1:]
        sx = np.bincount(lab, weights=wgt * xf, minlength=m)[1:]
        sy = np.bincount(lab, weights=wgt * yf, minlength=m)[1:]
        with np.errstate(invalid='ignore'):  # fully-masked: 0/0 -> NaN
            xc, yc = sx / tot, sy / tot
            sxx = np.bincount(lab, weights=wgt * xf * xf, minlength=m)[1:]
            syy = np.bincount(lab, weights=wgt * yf * yf, minlength=m)[1:]
            sxy = np.bincount(lab, weights=wgt * xf * yf, minlength=m)[1:]
            mxx = sxx / tot - xc * xc
            myy = syy / tot - yc * yc
            mxy = sxy / tot - xc * yc
        out['xcentroid'], out['ycentroid'] = xc, yc

        t1 = 0.5 * (mxx + myy)
        t2 = np.sqrt(np.maximum(0.25 * (mxx - myy) ** 2 + mxy ** 2, 0.0))
        lam1 = np.maximum(t1 + t2, 1e-12)
        lam2 = np.maximum(t1 - t2, 1e-12)
        a, b = np.sqrt(lam1), np.sqrt(lam2)
        out['semimajor_sigma'] = a
        out['semiminor_sigma'] = b
        out['orientation'] = np.degrees(
            0.5 * np.arctan2(2.0 * mxy, mxx - myy))
        out['eccentricity'] = np.sqrt(1.0 - lam2 / lam1)
        out['ellipticity'] = 1.0 - b / a
        # circularized FWHM (photutils): 2*sqrt(2 ln2 * (a^2+b^2)/2)
        out['fwhm'] = 2.0 * np.sqrt(np.log(2.0) * (lam1 + lam2))

        # bounding boxes from the gathered pixel coordinates (after the
        # remap every label 1..n is populated, so no None slices exist);
        # photutils bboxes come from the segmentation image, so they keep
        # ALL segment pixels including non-finite-masked ones
        bx0 = np.full(m, w, np.int32)
        bx1 = np.full(m, -1, np.int32)
        by0 = np.full(m, h, np.int32)
        by1 = np.full(m, -1, np.int32)
        np.minimum.at(bx0, lab_all, xi_all)
        np.maximum.at(bx1, lab_all, xi_all)
        np.minimum.at(by0, lab_all, yi_all)
        np.maximum.at(by1, lab_all, yi_all)
        out['bbox_xmin'] = bx0[1:].astype(float)
        out['bbox_xmax'] = bx1[1:].astype(float)
        out['bbox_ymin'] = by0[1:].astype(float)
        out['bbox_ymax'] = by1[1:].astype(float)
        out['local_background'] = np.zeros(n)
        boxes = np.stack([bx0[1:], bx1[1:], by0[1:], by1[1:]],
                         axis=1) if n else np.zeros((0, 4), np.int32)
        if self.localbkg_width > 0 and n:
            out['local_background'] = self._local_bkg_all(boxes)

        sky = np.full((n, 2), np.nan)
        if self.wcs is not None and n:
            world = self.wcs.pixel_to_world(xc, yc)
            if isinstance(world, tuple):
                ra, dec = world
            else:
                # an astropy WCS returns one SkyCoord array, not a tuple.
                # Equatorial frames (ICRS/FK5/FK4) expose .ra/.dec directly
                # and must be reported in their own frame (photutils
                # semantics); only non-equatorial frames (galactic,
                # ecliptic) lack those attributes — convert them to ICRS.
                if not hasattr(world, 'ra'):
                    world = world.icrs
                ra = np.atleast_1d(world.ra.deg)
                dec = np.atleast_1d(world.dec.deg)
            sky[:, 0], sky[:, 1] = ra, dec

        self._props = out
        self._sky = sky

    # tpu_sgp/catalog/properties.py:247
    def _local_bkg_all(self, boxes: np.ndarray) -> np.ndarray:
        """Sigma-clipped annulus medians for every source; one native call
        when the C++ library is built, Python loop otherwise."""
        try:
            from . import native
            if native.available():
                return native.local_background_batch(
                    self.data, boxes, self.localbkg_width)
        except Exception:
            pass
        return np.array([self._local_bkg(x0, x1, y0, y1)
                         for x0, x1, y0, y1 in boxes])

    # tpu_sgp/catalog/properties.py:260
    def _local_bkg(self, x0, x1, y0, y1) -> float:
        wdt = self.localbkg_width
        h, w = self.data.shape
        yy0, yy1 = max(0, y0 - wdt), min(h, y1 + 1 + wdt)
        xx0, xx1 = max(0, x0 - wdt), min(w, x1 + 1 + wdt)
        region = self.data[yy0:yy1, xx0:xx1]
        inner = np.zeros(region.shape, bool)
        inner[y0 - yy0:y1 + 1 - yy0, x0 - xx0:x1 + 1 - xx0] = True
        ann = region[~inner]
        # match the native path (localbkg.cpp): non-finite pixels are
        # dropped BEFORE the emptiness check, so an all-NaN annulus yields
        # 0.0 (no correction) on both paths rather than NaN here only
        ann = ann[np.isfinite(ann)]
        if ann.size == 0:
            return 0.0
        _, med, _ = sigma_clipped_stats(ann)
        return med

    # tpu_sgp/catalog/properties.py:278
    def __len__(self):
        return self.segm.nlabels

    # tpu_sgp/catalog/properties.py:281
    def to_table(self, columns: Optional[Sequence[str]] = None) -> Table:
        cols = {}
        names = columns or list(self._props)
        for name in names:
            if name == 'sky_centroid':
                cols[name] = self._sky[:, 0]  # RA (deg); NaN without WCS
            elif name in self._props:
                cols[name] = self._props[name]
            else:
                cols[name] = np.full(len(self), np.nan)
        return Table(cols)
