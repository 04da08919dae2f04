"""Batched flux-conserving projection: CUDA kernel wrapper and plain twin.

Replaces the Pallas kernel ``_kernel`` / ``project_df_pallas``
(``tpu_sgp/experimental/pallas_projection.py:40-122``). For each row of a
(B, N) batch it returns

    x = min(max((c + lam) * (1/dia), 0), cap)        (cap only with has_sat)

where lam is the root of sum(x) = b, found by 7-point sectioning (3 bits a
step) for ``n_steps`` steps from the bracket lo = min(-c),
hi = max(max(b*dia - c), lo + 1) (``pallas_projection.py:104-108``).

``project_rows`` launches ``csrc/flux_projection.cu`` for CUDA tensors and
calls ``project_rows_plain`` for CPU tensors; a CUDA call that cannot
launch raises, it never falls back. The batched solver gives it (B, 961)
stamps, one warp a row; a whole-frame solve gives it one row of H * W
pixels, which the kernel splits over the card's SMs.
"""
from __future__ import annotations

import ctypes
import functools

import torch

_K = 7  # interior section points per step (pallas_projection.py:35)


def project_rows_plain(b: torch.Tensor, c: torch.Tensor, dia: torch.Tensor,
                       cap: torch.Tensor, n_steps: int,
                       has_sat: bool) -> torch.Tensor:
    """The projection in plain PyTorch over (B, N) rows, with per-row
    b and cap of shape (B,) (``pallas_projection.py:40-65, 100-108``)."""
    inv = 1.0 / dia
    cap = cap[:, None]

    def xval(lam):
        x = torch.clamp_min((c + lam[:, None]) * inv, 0.0)
        if has_sat:
            x = torch.minimum(x, cap)
        return x

    lo = (-c).amin(-1)
    hi = torch.maximum((b[:, None] * dia - c).amax(-1), lo + 1.0)
    for _ in range(n_steps):
        seg = (hi - lo) / (_K + 1)
        nbelow = torch.zeros_like(lo)
        for k in range(1, _K + 1):
            r = xval(lo + seg * k).sum(-1)
            nbelow = nbelow + (r - b < 0).to(lo.dtype)
        lo = lo + nbelow * seg
        hi = lo + seg
    return xval(0.5 * (lo + hi))


_ENTRY = {torch.float32: 'tpu_sgp_project_rows_f32',
          torch.float64: 'tpu_sgp_project_rows_f64'}
# which kernel serves a launch: the launcher's own rule, or one path forced
# for a measurement ('rows': one warp or one block a row; 'grid': a long
# row split over many blocks)
_PATHS = {'auto': 0, 'rows': 1, 'grid': 2}


@functools.cache
def _entry(dtype: torch.dtype):
    from ._build import load_library
    fn = getattr(load_library('flux_projection'), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def launch_plan(rows: int, n: int, dtype: torch.dtype, path: str = 'auto',
                device: int = 0) -> tuple:
    """What the launcher does with a (rows, n) batch on ``device``:
    ``(path, scratch elements, blocks)``, where path is ``'rows'`` (one
    warp or one block a row) or ``'grid'`` (each row split over many
    blocks, all resident at once). ``'auto'`` takes the grid path for rows
    above 2048 pixels whose blocks all fit on the card together."""
    from ._build import load_library
    fn = load_library('flux_projection').tpu_sgp_project_rows_plan
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int),
                                        ctypes.POINTER(ctypes.c_longlong),
                                        ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    chosen, scratch, blocks = ctypes.c_int(), ctypes.c_longlong(), \
        ctypes.c_int()
    err = fn(rows, n, int(dtype == torch.float64), _PATHS[path], device,
             ctypes.byref(chosen), ctypes.byref(scratch),
             ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f'flux projection launch plan failed: CUDA '
                           f'error {err}')
    return ('rows', 'grid')[chosen.value - 1], scratch.value, blocks.value


def project_rows(b: torch.Tensor, c: torch.Tensor, dia: torch.Tensor,
                 cap: torch.Tensor, n_steps: int,
                 has_sat: bool, path: str = 'auto') -> torch.Tensor:
    """Project every row of ``c`` (B, N) under the metric ``dia`` (B, N)
    onto {x : sum(x) = b, 0 <= x <= cap}. ``b`` and ``cap`` are (B,).

    CPU tensors take ``project_rows_plain``. CUDA tensors launch the
    kernel: one warp or one block a row, or, for a few rows longer than
    2048 pixels (one whole frame), each row split over many blocks
    (``launch_plan``). ``path`` forces one of the two for a measurement;
    a grid path that does not fit on the card raises.
    ``project_rows.launches`` counts the launches and
    ``project_rows.grid_launches`` those that took the grid path."""
    if not c.is_cuda:
        return project_rows_plain(b, c, dia, cap, n_steps, has_sat)
    if c.dim() != 2:
        raise ValueError(f'c must be (B, N), got shape {tuple(c.shape)}')
    rows, n = c.shape
    if c.dtype not in _ENTRY:
        raise TypeError(f'the kernel takes float32 or float64, got {c.dtype}')
    for name, t, shape in (('dia', dia, (rows, n)), ('b', b, (rows,)),
                           ('cap', cap, (rows,))):
        if t.device != c.device or t.dtype != c.dtype:
            raise TypeError(f'{name} is {t.dtype} on {t.device}; c is '
                            f'{c.dtype} on {c.device}')
        if tuple(t.shape) != shape:
            raise ValueError(f'{name} must have shape {shape}, got '
                             f'{tuple(t.shape)}')
    for name, t in (('c', c), ('dia', dia), ('b', b), ('cap', cap)):
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    if not 0 < n < 2 ** 31 or not 0 <= n_steps < 2 ** 31:
        raise ValueError(f'unsupported size n={n}, n_steps={n_steps}')
    out = torch.empty_like(c)
    if rows == 0:
        return out
    chosen, scratch_len, _ = launch_plan(rows, n, c.dtype, path,
                                         c.device.index)
    scratch = torch.empty(scratch_len, dtype=c.dtype, device=c.device)
    stream = torch.cuda.current_stream(c.device)
    err = _entry(c.dtype)(b.data_ptr(), c.data_ptr(), dia.data_ptr(),
                          cap.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                          rows, n, n_steps, int(has_sat), _PATHS[chosen],
                          c.device.index, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f'flux projection kernel launch failed ({chosen} '
                           f'path, {rows} rows of {n}): CUDA error {err}')
    project_rows.launches += 1
    project_rows.grid_launches += chosen == 'grid'
    return out


project_rows.launches = 0
project_rows.grid_launches = 0
