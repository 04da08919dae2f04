"""Row-wise reductions over a (B, N) batch, local or over mesh axes.

Port of ``tpu_sgp/ops/reduce.py:16-75``. The JAX functions reduce one image
inside ``vmap``; these reduce the last axis of a batch, one scalar per row.
``axes`` is ``()`` for a single-device reduction, or a
``ops.mesh.MeshAxes``: each rank reduces its own pixels and one collective
over the axes' process group combines the (B,) vector, as ``psum`` /
``pmax`` / ``pmin`` do in the JAX versions.
"""
from __future__ import annotations

import torch

from ..kernels import compensated_sum


def gsum(x: torch.Tensor, axes=()) -> torch.Tensor:
    """Row sums (``reduce.py:16-18``)."""
    s = x.sum(-1)
    return axes.all_reduce(s, 'sum') if axes else s


def gmax(x: torch.Tensor, axes=()) -> torch.Tensor:
    """Row maxima (``reduce.py:21-23``)."""
    m = x.amax(-1)
    return axes.all_reduce(m, 'max') if axes else m


def gmin(x: torch.Tensor, axes=()) -> torch.Tensor:
    """Row minima (``reduce.py:26-28``)."""
    m = x.amin(-1)
    return axes.all_reduce(m, 'min') if axes else m


def gmean(x: torch.Tensor, axes=()) -> torch.Tensor:
    """Row means (``reduce.py:31-36``): under mesh axes the global sum over
    the global pixel count, both reduced in one collective."""
    if not axes:
        return x.mean(-1)
    count = torch.full(x.shape[:-1] + (1,), x.shape[-1], dtype=x.dtype,
                       device=x.device)
    both = axes.all_reduce(torch.cat([x.sum(-1, keepdim=True), count], -1))
    return both[..., 0] / both[..., 1]


def tree_sum_ff(x: torch.Tensor) -> torch.Tensor:
    """Compensated (float-float) pairwise-tree row sums with a fixed order
    (``reduce.py:39-75``), in plain PyTorch: the row is zero-padded to a
    power of two and halved level by level, each pair combined with an
    exact two-sum whose rounding error rides in a parallel accumulator. The
    pairing is the JAX version's, so both give the same scalar."""
    n = x.shape[-1]
    if n == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    p = 1 << (n - 1).bit_length()
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
    return (hi + lo)[..., 0]


def gsum_ff(x: torch.Tensor, axes=()) -> torch.Tensor:
    """Compensated row sums (``reduce.py:39-75``): on a CUDA tensor one
    launch of ``kernels.compensated_sum.ff_sum_rows``, on a CPU tensor (or
    an empty row) ``tree_sum_ff``; the two give the same bits. Under mesh
    axes each rank's compensated sum is then combined by a plain all-reduce
    (``:75``)."""
    if x.is_cuda and x.shape[-1]:
        s = compensated_sum.ff_sum_rows(
            x if x.stride(-1) == 1 else x.contiguous())
    else:
        s = tree_sum_ff(x)
    return axes.all_reduce(s, 'sum') if axes else s
