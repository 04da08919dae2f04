"""Row-wise reductions over a (B, N) batch.

Port of ``tpu_sgp/ops/reduce.py:16-75``. The JAX functions reduce one image
inside ``vmap``; these reduce the last axis of a batch, one scalar per row.
The ``axes`` argument of the JAX versions names mesh axes for collectives;
those wait for multi-device support (ROADMAP A13).
"""
from __future__ import annotations

import torch


def _no_axes(axes) -> None:
    if axes:
        raise NotImplementedError(
            'mesh-axis collectives are not ported yet (ROADMAP A13)')


def gsum(x: torch.Tensor, axes=()) -> torch.Tensor:
    """Row sums (``reduce.py:16-18``)."""
    _no_axes(axes)
    return x.sum(-1)


def gmax(x: torch.Tensor, axes=()) -> torch.Tensor:
    """Row maxima (``reduce.py:21-23``)."""
    _no_axes(axes)
    return x.amax(-1)


def gmin(x: torch.Tensor, axes=()) -> torch.Tensor:
    """Row minima (``reduce.py:26-28``)."""
    _no_axes(axes)
    return x.amin(-1)


def gmean(x: torch.Tensor, axes=()) -> torch.Tensor:
    """Row means (``reduce.py:31-36``)."""
    _no_axes(axes)
    return x.mean(-1)


def gsum_ff(x: torch.Tensor, axes=()) -> torch.Tensor:
    """Compensated (float-float) pairwise-tree row sums with a fixed order
    (``reduce.py:39-75``): the row is zero-padded to a power of two and
    halved level by level, each pair combined with an exact two-sum whose
    rounding error rides in a parallel accumulator. The pairing is the JAX
    version's, so both give the same scalar."""
    _no_axes(axes)
    n = x.shape[-1]
    p = 1 << max(0, int(n - 1).bit_length())
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    hi, lo = x, torch.zeros_like(x)
    while p > 1:
        h = p // 2
        a, b = hi[..., :h], hi[..., h:]
        s = a + b
        bb = s - a
        err = (a - (s - bb)) + (b - bb)
        lo = lo[..., :h] + lo[..., h:] + err
        hi = s
        p = h
    if n == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    return (hi + lo)[..., 0]
