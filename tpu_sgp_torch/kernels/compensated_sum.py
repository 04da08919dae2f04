"""Compensated (float-float) row sums: CUDA kernel wrapper and its plan.

Replaces no Pallas kernel: ``ops.reduce.gsum_ff``'s fixed-order pairwise
tree (the JAX package's XLA tree, ``tpu_sgp/ops/reduce.py:39-75``) on a
CUDA tensor, as one launch of ``csrc/compensated_sum.cu`` that gives the
same scalar bit for bit. ``ops.reduce.tree_sum_ff`` is its plain version.

One block a row. After k levels of the tree slot j holds the tree over the
strided column {j + m p / 2^k}, so a row padded to p = 2^ceil(log2 N) is
cut into ``cols`` = p / 2^k columns, one a thread, which a thread reads in
bit-reversed order, chunk by chunk, folding as it reads; the block's
columns then run the last log2(cols) levels. The C entry takes the plan
from N alone; ``ff_sum_plan`` asks it.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import observability

_ENTRY = {torch.float32: 'tpu_sgp_ff_sum_f32',
          torch.float64: 'tpu_sgp_ff_sum_f64'}


def ff_sum_plan(n: int, dtype: torch.dtype = torch.float32) -> tuple:
    """``(cols, levels, chunk)`` of a row of ``n`` pixels, from the C
    entry (so a card with the toolkit only): ``cols`` columns of
    ``2**levels`` values, ``cols << levels`` being the power of two the
    tree pads the row to, read ``2**chunk`` values at a time. Raises on a
    length the kernel does not take."""
    if not 0 < n < 2 ** 31:
        raise ValueError(f'unsupported row length n={n}')
    from ._build import load_library
    fn = load_library('compensated_sum').tpu_sgp_ff_sum_plan
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    cols, levels, chunk = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = fn(n, int(dtype == torch.float64), ctypes.byref(cols),
             ctypes.byref(levels), ctypes.byref(chunk))
    if err != 0:
        raise RuntimeError(f'compensated sum plan failed for n={n}: CUDA '
                           f'error {err}')
    return cols.value, levels.value, chunk.value


@functools.cache
def _entry(dtype: torch.dtype):
    from ._build import load_library
    fn = getattr(load_library('compensated_sum'), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 \
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ff_sum_rows(x: torch.Tensor) -> torch.Tensor:
    """The compensated tree sum of each row (the last axis) of a CUDA
    tensor ``x`` in float32 or float64, one launch: ``x.shape[:-1]`` sums,
    bit-equal to ``ops.reduce.tree_sum_ff``. The leading axes are flattened
    (a view where the strides allow). Raises on a CPU tensor, another
    dtype, a row that is empty or not of unit stride, or sizes beyond a C
    int. ``ff_sum_rows.launches`` counts the launches; under tracing each
    adds 1 to the counter ``ff_sum.launches`` of the innermost span."""
    if not x.is_cuda:
        raise ValueError(f'the kernel takes CUDA tensors, got one on '
                         f'{x.device}; CPU tensors take the plain tree')
    if x.dtype not in _ENTRY:
        raise TypeError(f'the kernel takes float32 or float64, got {x.dtype}')
    if x.dim() == 0:
        raise ValueError('x must have a last axis to sum')
    n, rows = x.shape[-1], math.prod(x.shape[:-1])
    if not 0 < n < 2 ** 31 or rows >= 2 ** 31:
        raise ValueError(f'unsupported size: {rows} rows of {n}')
    if n > 1 and x.stride(-1) != 1:
        raise ValueError(f'the rows must have unit stride, got stride '
                         f'{x.stride(-1)}')
    rows2 = x.reshape(rows, n)
    out = torch.empty(rows, dtype=x.dtype, device=x.device)
    if rows == 0:
        return out.reshape(x.shape[:-1])
    err = _entry(x.dtype)(rows2.data_ptr(), out.data_ptr(), rows, n,
                          rows2.stride(0), x.device.index,
                          torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'compensated sum kernel launch failed ({rows} '
                           f'rows of {n}): CUDA error {err}')
    ff_sum_rows.launches += 1
    observability.count('ff_sum.launches', 1)
    return out.reshape(x.shape[:-1])


ff_sum_rows.launches = 0
