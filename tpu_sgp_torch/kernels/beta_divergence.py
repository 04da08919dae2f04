"""The beta-divergence of each row and the row sums of its d/dbeta: CUDA
kernel wrapper and its plan.

Replaces no Pallas kernel: ``ops.divergence.beta_div_with_dbeta``'s eager
code (the JAX package's XLA function,
``tpu_sgp/ops/divergence.py:113-161``, which XLA fuses into one pass) on a
CUDA tensor, as one launch of ``csrc/beta_divergence.cu``.
``ops.divergence.beta_div_with_dbeta_plain`` is its plain version.

One block a row computes each pixel's terms in registers, with the plain
version's operations in its order, and sums them as it goes: with
``stable`` the terms of the objective fold into the compensated row sum's
tree (``csrc/ff_tree.cuh``), so the objective is the plain version's
``gsum_ff`` bit for bit where the terms agree; otherwise, and for the d/dbeta
sums always, a plain block sum. The C entry takes the plan from N alone;
``beta_div_plan`` asks it.
"""
from __future__ import annotations

import ctypes

import torch

from .. import observability
from . import _build

_ARGS = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 2
         + (ctypes.c_longlong,) * 3 + (ctypes.c_int,))


def beta_div_plan(n: int) -> tuple:
    """``(cols, levels, chunk)`` of a row of ``n`` pixels in either type,
    from the C entry (so a card with the toolkit only): ``cols`` columns of
    ``2**levels`` values, ``cols << levels`` being the power of two the
    compensated tree pads the row to, read ``2**chunk`` values at a time;
    at most 256 columns, so a stamp's row takes
    ``compensated_sum.ff_sum_plan``'s own. Raises on a length the kernel
    does not take."""
    if not 0 < n < 2 ** 31:
        raise ValueError(f'unsupported row length n={n}')
    return _build.query('beta_divergence', 'tpu_sgp_beta_div_plan', n,
                        outs=(ctypes.c_int,) * 3,
                        what=f'beta divergence plan failed for n={n}')


def beta_div_rows(den: torch.Tensor, gn: torch.Tensor, beta,
                  log_gn: torch.Tensor, stable: bool = False) -> tuple:
    """``(fv, dsum)``, each (B,), of CUDA tensors ``den``, ``gn`` and
    ``log_gn`` (B, N) in float32 or float64, each of unit stride along its
    rows, and ``beta`` (B,) or a scalar (expanded here), in one launch: fv
    the beta-divergence of each row, dsum the row sum of its d/dbeta, as
    ``ops.divergence.beta_div_with_dbeta_plain`` computes them on one
    device (``stable``: fv by the compensated tree). Raises on a CPU
    tensor, another dtype, shapes that disagree, an empty row, a row not
    of unit stride, or sizes beyond a C int. ``launches['beta_div_rows']``
    counts the launches; under tracing each adds 1 to the counter
    ``beta_div.launches`` of the innermost span and rows x N to its
    ``beta_div.pixels``, the pixels whose den, gn and log gn it read."""
    if not den.is_cuda:
        raise ValueError(f'the kernel takes CUDA tensors, got one on '
                         f'{den.device}; CPU tensors take the plain version')
    b = torch.as_tensor(beta, dtype=den.dtype, device=den.device)
    if b.dim() == 0:
        b = b.expand(den.shape[:1]).contiguous()
    dims = _build.check_operands(
        'den', den=(den, 'BN'), gn=(gn, 'BN'), log_gn=(log_gn, 'BN'),
        beta=(b, 'B'), unit_stride=True,
        sizes=(('rows', 'B', 0), ('row length', 'N', 1)))
    rows, n = dims['B'], dims['N']
    fv = torch.empty(rows, dtype=den.dtype, device=den.device)
    dsum = torch.empty_like(fv)
    if rows:
        _build.launch(
            _build.kernel('beta_divergence', 'tpu_sgp_beta_div', den.dtype,
                          _ARGS), den.device,
            den.data_ptr(), gn.data_ptr(), log_gn.data_ptr(), b.data_ptr(),
            fv.data_ptr(), dsum.data_ptr(), rows, n, den.stride(0),
            gn.stride(0), log_gn.stride(0), int(stable),
            what=f'beta divergence kernel launch failed ({rows} rows of '
                 f'{n})',
            count=('beta_div_rows',))
        observability.count('beta_div.launches', 1)
        observability.count('beta_div.pixels', rows * n)
    return fv, dsum
