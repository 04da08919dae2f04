"""ctypes bindings for the native (C++) DIAPL PSF evaluator.

Port of ``tpu_sgp/psf/native.py:1``. Builds ``native/psf_core.cpp`` of this
package with g++ on first use into ``build/tpu_sgp_torch/`` at the root of
the checkout, under a name that carries the hash of the source, as
``catalog/native.py`` builds the deblender. Falls back cleanly:
``available()`` reports False if no toolchain is present, and callers use
the vectorized NumPy path in ``diapl.py`` instead. Host code: the card is
not involved.
"""
from __future__ import annotations

import ctypes
import hashlib
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..kernels._build import BUILD_DIR
from .diapl import DiaplPSFModel

_NATIVE_DIR = Path(__file__).resolve().parent.parent / 'native'
_SRC = _NATIVE_DIR / 'psf_core.cpp'

_lib = None
_load_error: Optional[str] = None
_load_lock = threading.Lock()


# tpu_sgp/psf/native.py:28
class _Params(ctypes.Structure):
    _fields_ = [
        ('hw', ctypes.c_int32), ('ndeg_spat', ctypes.c_int32),
        ('ndeg_local', ctypes.c_int32), ('ngauss', ctypes.c_int32),
        ('ldeg', ctypes.c_int32),
        ('cos_t', ctypes.c_double), ('sin_t', ctypes.c_double),
        ('ax', ctypes.c_double), ('ay', ctypes.c_double),
        ('sigma_inc', ctypes.c_double),
        ('x_orig', ctypes.c_double), ('y_orig', ctypes.c_double),
    ]


def _library_path() -> Path:
    """The library's path under the build directory, named by the hash of
    its source."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f'libpsf-{digest}.so'


# tpu_sgp/psf/native.py:40
def _build(so_path: Path) -> None:
    # OpenMP threads the bulk renderer on multi-core hosts; atomic
    # temp-file + rename build with a serial fallback (shared helper)
    from ..catalog.native import _build_shared
    _build_shared([_SRC], so_path)


# tpu_sgp/psf/native.py:47
def _load():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    with _load_lock:
        return _load_locked()


# tpu_sgp/psf/native.py:55
def _load_locked():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        so = _library_path()
        if not so.exists():
            _build(so)
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            # corrupt/stale cached .so: force one rebuild, don't brick
            _build(so)
            lib = ctypes.CDLL(str(so))
        dptr = np.ctypeslib.ndpointer(np.float64, flags='C_CONTIGUOUS')
        lib.diapl_local_coeffs.argtypes = [
            ctypes.POINTER(_Params), dptr, ctypes.c_double, ctypes.c_double,
            dptr]
        lib.diapl_eval_grid.argtypes = [
            ctypes.POINTER(_Params), dptr, ctypes.c_int32, ctypes.c_int32,
            dptr]
        lib.diapl_render_many.argtypes = [
            ctypes.POINTER(_Params), dptr, dptr, dptr, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, dptr]
        _lib = lib
    except Exception as exc:  # toolchain missing / build failure
        _load_error = str(exc)
        _lib = None
    return _lib


# tpu_sgp/psf/native.py:86
def available() -> bool:
    return _load() is not None


# tpu_sgp/psf/native.py:90
def _params(model: DiaplPSFModel) -> _Params:
    return _Params(model.hw, model.ndeg_spat, model.ndeg_local,
                   model.ngauss, model.ldeg, model.cos, model.sin,
                   model.ax, model.ay, model.sigma_inc, model.x_orig,
                   model.y_orig)


# tpu_sgp/psf/native.py:97
def render_matrix(model: DiaplPSFModel, size: int = 31,
                  coeffs: Optional[np.ndarray] = None,
                  normalize: bool = False) -> np.ndarray:
    """Native render of one PSF matrix from a local coefficient set."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f'native PSF library unavailable: {_load_error}')
    local = np.ascontiguousarray(
        model.vec_coeffs[:model.n_local] if coeffs is None else coeffs,
        np.float64)
    out = np.empty(size * size)
    lib.diapl_eval_grid(ctypes.byref(_params(model)), local, size,
                        int(normalize), out)
    return out.reshape(size, size)


# tpu_sgp/psf/native.py:113
def render_grid(model: DiaplPSFModel, xs: np.ndarray, ys: np.ndarray,
                size: int = 31, normalize: bool = True) -> np.ndarray:
    """Bulk-render spatially-varying PSF matrices at frame positions
    (xs[k], ys[k]) -> (n, size, size). This is the capability the reference
    leaves on the floor (its spatial-variation hook is unused,
    psf_calculate.py:141-166)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f'native PSF library unavailable: {_load_error}')
    xs = np.ascontiguousarray(xs, np.float64)
    ys = np.ascontiguousarray(ys, np.float64)
    n = xs.size
    out = np.empty(n * size * size)
    lib.diapl_render_many(ctypes.byref(_params(model)),
                          np.ascontiguousarray(model.vec_coeffs, np.float64),
                          xs, ys, n, size, int(normalize), out)
    return out.reshape(n, size, size)


# tpu_sgp/psf/native.py:132
def local_coeffs(model: DiaplPSFModel, xpsf: float, ypsf: float) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError(f'native PSF library unavailable: {_load_error}')
    out = np.empty(model.n_local)
    lib.diapl_local_coeffs(ctypes.byref(_params(model)),
                           np.ascontiguousarray(model.vec_coeffs, np.float64),
                           float(xpsf), float(ypsf), out)
    return out
