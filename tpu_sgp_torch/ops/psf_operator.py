"""PSF forward/adjoint operators on a batch of stamps that share one PSF.

Port of the dense-circulant subset of ``tpu_sgp/ops/psf_operator.py``
(``:43-95`` and the dispatch at ``:310-345``). A 31x31 stamp gives a 961x961
matrix; the operator on a (B, N) batch of raveled stamps is one matrix
product, left to ``torch.matmul`` as the JAX package leaves it to XLA.

The products must run in full float32, as ``Precision.HIGHEST`` pins them
in JAX (``psf_operator.py:63-65``): on a CUDA tensor the operators refuse to
run while ``torch.backends.cuda.matmul.allow_tf32`` is set.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

Operator = Callable[[torch.Tensor], torch.Tensor]

# Largest stamp pixel count for which 'auto' picks the dense matrix
# (psf_operator.py:38-40).
_MATMUL_MAX_PIXELS = 4096


def build_circulant_matrix(psf: torch.Tensor) -> torch.Tensor:
    """Dense C with C @ vec(x) == vec(circular_conv(fftshift(psf), x)),
    C[(i,j),(p,q)] = k[(i-p) mod H, (j-q) mod W] with k = fftshift(psf)
    (``psf_operator.py:43-55``)."""
    h, w = psf.shape
    k = torch.fft.fftshift(psf)
    ar_h = torch.arange(h, device=psf.device)
    ar_w = torch.arange(w, device=psf.device)
    di = (ar_h[:, None] - ar_h[None, :]) % h
    dj = (ar_w[:, None] - ar_w[None, :]) % w
    c = k[di[:, None, :, None], dj[None, :, None, :]]
    return c.reshape(h * w, h * w)


def _check_full_f32(x: torch.Tensor) -> None:
    if (x.is_cuda and x.dtype == torch.float32
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            'torch.backends.cuda.matmul.allow_tf32 is True: the PSF operator '
            'must run in full float32 (Precision.HIGHEST in the JAX '
            'package); set it to False')


def make_matmul_flat_operator(psf: torch.Tensor
                              ) -> Tuple[Operator, Operator]:
    """Dense circulant operator on raveled stamps
    (``psf_operator.py:76-95``): A(X) = X @ C^T and AT(X) = X @ C for a
    (B, H*W) batch X, row i being C @ X[i] and C^T @ X[i]."""
    c = build_circulant_matrix(psf)

    def A(x):
        _check_full_f32(x)
        return torch.matmul(x, c.T)

    def AT(x):
        _check_full_f32(x)
        return torch.matmul(x, c)

    return A, AT


def make_matmul_operator(psf: torch.Tensor) -> Tuple[Operator, Operator]:
    """Dense circulant operator on (B, H, W) stamps
    (``psf_operator.py:58-73``): the flat operator between reshapes, so it
    takes (B, H*W) rows as well."""
    A_flat, AT_flat = make_matmul_flat_operator(psf)

    def A(x):
        return A_flat(x.reshape(x.shape[0], -1)).reshape(x.shape)

    def AT(x):
        return AT_flat(x.reshape(x.shape[0], -1)).reshape(x.shape)

    return A, AT


def make_operator(psf: torch.Tensor, image_shape: Tuple[int, ...],
                  method: str = 'auto') -> Tuple[Operator, Operator]:
    """Build (A, AT) on a (B, *image_shape) batch
    (``psf_operator.py:310-345``). Only the dense-matrix operators are
    ported; the others raise naming the ROADMAP item that ports them."""
    same = tuple(psf.shape) == tuple(image_shape)
    if method == 'auto':
        if same:
            method = 'matmul' if psf.numel() <= _MATMUL_MAX_PIXELS else 'otf'
        else:
            method = 'linear'
    if method == 'matmul':
        if not same:
            raise ValueError(
                'matmul operator requires PSF.shape == image.shape')
        return make_matmul_operator(psf)
    if method == 'matmul_flat':
        if len(image_shape) != 1 or psf.numel() != image_shape[0]:
            raise ValueError(f'{method} operates on (H*W,) raveled images '
                             f'(psf {tuple(psf.shape)}, image {image_shape})')
        return make_matmul_flat_operator(psf)
    if method == 'matmul_split':
        raise NotImplementedError(
            "operator='matmul_split' is not ported yet (ROADMAP A11)")
    if method in ('otf', 'linear'):
        raise NotImplementedError(
            f"operator={method!r} is not ported yet (ROADMAP A10)")
    if method == 'halo':
        raise NotImplementedError(
            "operator='halo' is not ported yet (ROADMAP A13)")
    raise ValueError(f'unknown operator method: {method}')
