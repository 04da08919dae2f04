"""``source_info``: the reference's one-call detection+measurement pipeline.

Mirrors the reference's utils.py:219-247: Background2D (median,
3x3 mesh filter) -> subtract -> threshold = sigma * rms -> convolve with a
FWHM-1.2 Gaussian -> find + deblend -> SourceCatalog with localbkg_width=5.
Returns (catalog, background) like the live reference path.
"""
# Host code (NumPy/SciPy), kept equal to tpu_sgp/catalog/source_info.py:1
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..utils import convolve2d_fill, make_2dgaussian_kernel
from .background import Background2D
from .properties import SourceCatalog
from .segmentation import SourceFinder


# tpu_sgp/catalog/source_info.py:20
def source_info(data: np.ndarray, box_size=(5, 5), n_pixels: int = 5,
                sigma_threshold: float = 1.5, localbkg_width: int = 5,
                deblend: bool = True, wcs=None, threshold_floor: float = 0.0
                ) -> Tuple[Optional[SourceCatalog], Background2D]:
    """Detect and measure sources. ``data`` must NOT be background
    subtracted. Returns (SourceCatalog | None, Background2D).

    ``threshold_floor`` sets an absolute lower bound on the detection
    threshold. Deconvolved images have near-zero background RMS, so the
    sigma threshold collapses and ripple pixels register as sources; the
    caller can anchor the floor to the ORIGINAL image's noise (the
    reference's workaround is adding an artificial sky,
    --add_bkg_to_deconvolved)."""
    data = np.asarray(data, np.float64)
    bkg = Background2D(data, box_size, filter_size=(3, 3))
    data_sub = data - bkg.background
    threshold = np.maximum(sigma_threshold * bkg.background_rms,
                           threshold_floor)
    kernel = make_2dgaussian_kernel(1.2, size=3)
    convolved = convolve2d_fill(data_sub, kernel)
    finder = SourceFinder(npixels=n_pixels, deblend=deblend)
    segm = finder(convolved, threshold)
    if segm is None:
        return None, bkg
    scat = SourceCatalog(data_sub, segm, background=bkg.background,
                         convolved_data=convolved,
                         localbkg_width=localbkg_width, wcs=wcs)
    return scat, bkg


# tpu_sgp/catalog/source_info.py:50
def source_info_batch(frames, per_frame_kwargs=None, n_workers=None, **kw):
    """Run :func:`source_info` over a sequence of frames, optionally on a
    thread pool. Order-preserving and result-identical to the serial loop
    (``source_info`` is a pure function of its arguments).

    The reference exposes the same knob as photutils' ``nproc`` (left at 1
    in the reference's utils.py:235 — its tile loop is serial,
    sgp.py:983). Here the hot kernels are NumPy ufuncs and the ctypes
    deblend/localbkg natives, all of which release the GIL, so threads
    realize a near-linear multi-core speedup on real hosts without the
    fork-after-JAX hazards of a process pool.

    ``n_workers``: ``None`` → ``os.cpu_count()`` capped at ``len(frames)``;
    ``<= 1`` → plain serial loop.
    ``per_frame_kwargs``: optional list of dicts merged over ``kw`` per
    frame (e.g. per-tile ``threshold_floor``).
    """
    import os as _os

    frames = list(frames)
    pf = per_frame_kwargs or [{}] * len(frames)
    if len(pf) != len(frames):
        raise ValueError(f'per_frame_kwargs has {len(pf)} entries '
                         f'for {len(frames)} frames')
    if n_workers is None:
        n_workers = min(_os.cpu_count() or 1, len(frames))
    if n_workers <= 1 or len(frames) <= 1:
        return [source_info(f, **{**kw, **p}) for f, p in zip(frames, pf)]
    from concurrent.futures import ThreadPoolExecutor

    from . import native as _native

    # divide the cores between pool workers: each worker's native calls
    # (deblend_all / local_background_batch) would otherwise spawn a
    # full-size OpenMP team, oversubscribing the host ~cores^2 threads
    omp_cap = max(1, (_os.cpu_count() or 1) // n_workers)

    def _run(f, p):
        _native.set_omp_threads(omp_cap)  # per-thread ICV; cheap, idempotent
        return source_info(f, **{**kw, **p})

    with ThreadPoolExecutor(max_workers=n_workers) as ex:
        futs = [ex.submit(_run, f, p) for f, p in zip(frames, pf)]
        return [f.result() for f in futs]
