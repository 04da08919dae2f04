"""Overlapping spatial tiling (the reference's subdivision machinery).

``calculate_slice_bboxes`` reproduces the reference tiling exactly
(the reference's utils.py:332-375): xyxy boxes of fixed tile
size marching with overlap, edge boxes pulled back inside the frame.
``create_subdivisions`` cuts Cutout2D tiles carrying shifted WCS
(utils.py:378-389). These feed both the host-side mosaic path and the
device-side batched tile solver.
"""
# Host code (NumPy/SciPy), kept equal to tpu_sgp/image/tiling.py:1
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .cutout import Cutout2D
from .wcs import WCS


# tpu_sgp/image/tiling.py:20
def _axis_spans(dim: int, size: int, overlap: int) -> np.ndarray:
    """(n, 2) array of (start, end) tile spans along one axis: stride
    ``size - overlap``, last span pulled back inside ``[0, dim]``."""
    stride = size - overlap
    if stride <= 0:
        raise ValueError(f'tile size {size} must exceed overlap {overlap}')
    n = 1 + max(0, -(-(dim - size) // stride))   # ceil((dim-size)/stride)
    ends = np.minimum(np.arange(n, dtype=np.int64) * stride + size, dim)
    starts = np.maximum(ends - size, 0)
    return np.stack([starts, ends], axis=1)


# tpu_sgp/image/tiling.py:32
def calculate_slice_bboxes(image_height: int, image_width: int,
                           slice_height: int = 512, slice_width: int = 512,
                           overlap_height_ratio: float = 0.2,
                           overlap_width_ratio: float = 0.2) -> List[List[int]]:
    """Overlapping tile bounding boxes in xyxy — same tile set and row-major
    order as the reference (a closed-form grid rather than a marching loop):
    stride = size - int(ratio*size), edge tiles shifted inward so every box
    is full-size whenever the image allows it."""
    ys = _axis_spans(image_height, slice_height,
                     int(overlap_height_ratio * slice_height))
    xs = _axis_spans(image_width, slice_width,
                     int(overlap_width_ratio * slice_width))
    return [[int(x0), int(y0), int(x1), int(y1)]
            for y0, y1 in ys for x0, x1 in xs]


# tpu_sgp/image/tiling.py:48
def create_subdivisions(image: np.ndarray,
                        subdiv_shape: Tuple[int, int] = (100, 100),
                        overlap: int = 10,
                        wcs: Optional[WCS] = None) -> List[Cutout2D]:
    """Cut overlapping Cutout2D tiles (reference utils.py:378-389)."""
    boxes = calculate_slice_bboxes(
        image.shape[0], image.shape[1], subdiv_shape[0], subdiv_shape[1],
        overlap / subdiv_shape[0], overlap / subdiv_shape[1])
    subdivs = []
    for x0, y0, x1, y1 in boxes:
        cut = Cutout2D(image, ((x0 + x1) / 2.0, (y0 + y1) / 2.0),
                       size=subdiv_shape, wcs=wcs)
        subdivs.append(cut)
    return subdivs


# tpu_sgp/image/tiling.py:64
def tile_origins(subdivs: List[Cutout2D]) -> np.ndarray:
    """(n, 2) array of (x0, y0) origins for a list of tiles."""
    return np.array([s.origin_original for s in subdivs], dtype=np.int64)
