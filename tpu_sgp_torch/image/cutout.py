"""Cutout2D equivalent (astropy.nddata.Cutout2D semantics).

The reference cuts star stamps and subdivisions with Cutout2D
(application_sgp_star_stamps.py:58, utils.py:378-389, utils.py:313-329).
This implementation reproduces astropy's index arithmetic:
slice bounds per axis are [ceil(pos - size/2), ceil(pos + size/2)), with
'trim' (clip to the image) and 'partial' (pad with fill_value) modes.
"""
# Host code (NumPy/SciPy), kept equal to tpu_sgp/image/cutout.py:1
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .wcs import WCS


# tpu_sgp/image/cutout.py:18
class Cutout2D:
    # tpu_sgp/image/cutout.py:19
    def __init__(self, data: np.ndarray, position: Tuple[float, float],
                 size, mode: str = 'trim', fill_value=np.nan,
                 wcs: Optional[WCS] = None, copy: bool = False):
        """position is (x, y); size is scalar or (ny, nx) — astropy order."""
        if np.isscalar(size):
            size = (int(size), int(size))
        ny, nx = int(size[0]), int(size[1])
        x, y = float(position[0]), float(position[1])
        h, w = data.shape

        # astropy overlap_slices arithmetic, per axis
        ymin = int(np.ceil(y - ny / 2.0))
        ymax = int(np.ceil(y + ny / 2.0))
        xmin = int(np.ceil(x - nx / 2.0))
        xmax = int(np.ceil(x + nx / 2.0))

        self.position_original = (x, y)
        self.mode = mode
        cy0, cy1 = max(0, ymin), min(h, ymax)
        cx0, cx1 = max(0, xmin), min(w, xmax)
        if cy0 >= cy1 or cx0 >= cx1:
            raise ValueError('cutout does not overlap the image')

        if mode == 'trim':
            self.data = data[cy0:cy1, cx0:cx1]
            if copy:
                self.data = self.data.copy()
            self.origin_original = (cx0, cy0)
        elif mode == 'partial':
            out = np.full((ny, nx), fill_value, dtype=np.result_type(
                data.dtype, type(fill_value) if not np.isnan(fill_value)
                else np.float64))
            out[cy0 - ymin:cy1 - ymin, cx0 - xmin:cx1 - xmin] = (
                data[cy0:cy1, cx0:cx1])
            self.data = out
            self.origin_original = (xmin, ymin)
        else:
            raise ValueError("mode must be 'trim' or 'partial'")

        self.shape = self.data.shape
        self.slices_original = (slice(cy0, cy1), slice(cx0, cx1))
        self.wcs = wcs.shifted(*self.origin_original) if wcs else None

    # tpu_sgp/image/cutout.py:62
    def to_original_position(self, cutout_position):
        """Map (x, y) in the cutout to (x, y) in the original image
        (astropy Cutout2D.to_original_position)."""
        cx, cy = cutout_position
        ox, oy = self.origin_original
        return (cx + ox, cy + oy)

    # tpu_sgp/image/cutout.py:69
    def to_cutout_position(self, original_position):
        px, py = original_position
        ox, oy = self.origin_original
        return (px - ox, py - oy)
