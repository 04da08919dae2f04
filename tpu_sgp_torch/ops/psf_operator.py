"""PSF forward/adjoint operators on a batch of images.

Port of ``tpu_sgp/ops/psf_operator.py`` (``:43-217`` and the dispatch at
``:310-345``); the mesh operator ``'halo'`` waits for multi-device support.
The JAX functions return closures on one (H, W) image and are batched by
``vmap``; here every operator takes a (B, H, W) batch or its raveled
(B, H*W) rows, as the solver keeps them, and returns what it was given.

- ``'matmul'``, ``'matmul_flat'``: the dense circulant. A 31x31 stamp gives
  a 961x961 matrix; the operator on a (B, N) batch is one matrix product,
  left to ``torch.matmul`` as the JAX package leaves it to XLA.
- ``'matmul_split'``: the same product from two-term bfloat16 splits.
- ``'otf'``: circular convolution through the real FFT of the whole batch.
- ``'linear'``: zero-padded linear convolution through the real FFT on a
  padded grid, cropped to the image.

A PSF of shape (B, H, W) gives every image of the batch its own operator
(``tpu_sgp/parallel/batch.py:38-42`` vmaps the operators' construction
over it).

The matrix products must run in full float32, as ``Precision.HIGHEST`` pins
them in JAX (``psf_operator.py:63-65``): on a CUDA tensor the operators
refuse to run while ``torch.backends.cuda.matmul.allow_tf32`` is set.
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
    (``psf_operator.py:43-55``). A (B, H, W) stack of PSFs gives a
    (B, H*W, H*W) stack of matrices."""
    h, w = psf.shape[-2:]
    k = torch.fft.fftshift(psf, dim=(-2, -1))
    ar_h = torch.arange(h, device=psf.device)
    ar_w = torch.arange(w, device=psf.device)
    di = (ar_h[:, None] - ar_h[None, :]) % h
    dj = (ar_w[:, None] - ar_w[None, :]) % w
    c = k[..., di[:, None, :, None], dj[None, :, None, :]]
    return c.reshape(psf.shape[:-2] + (h * w, h * w))


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
    (B, H*W) batch X, row i being C @ X[i] and C^T @ X[i]. With per-stamp
    PSFs (B, H, W) row i takes its own matrix C[i], one batched product."""
    c = build_circulant_matrix(psf)
    if c.dim() == 3:
        def A(x):
            _check_full_f32(x)
            return torch.matmul(c, x[:, :, None])[:, :, 0]

        def AT(x):
            _check_full_f32(x)
            return torch.matmul(x[:, None, :], c)[:, 0, :]

        return A, AT

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


def _split_bf16(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-term bfloat16 decomposition m ~ hi + lo, hi = bf16(m) and
    lo = bf16(m - hi) (``psf_operator.py:98-103``), each term returned in
    float32, where it is exact."""
    hi = m.to(torch.bfloat16).float()
    lo = (m - hi).to(torch.bfloat16).float()
    return hi, lo


def make_matmul_flat_split_operator(psf: torch.Tensor
                                    ) -> Tuple[Operator, Operator]:
    """Split-bfloat16 circulant operator on raveled stamps
    (``psf_operator.py:106-142``): matrix and iterate are each split into
    two bfloat16 terms and the product keeps hi*hi + hi*lo + lo*hi.

    The JAX version multiplies bfloat16 operands with float32 accumulation
    (``preferred_element_type``, ``:131-133``). ``torch.matmul`` on
    bfloat16 inputs returns bfloat16, which would round every partial sum;
    so the three products here are float32 products of the bfloat16-rounded
    terms. A product of two bfloat16 values is exact in float32, so this
    computes the same function, at the speed of three full float32
    products: it is slower than ``'matmul_flat'`` until a bfloat16
    tensor-core product with float32 accumulation takes its place."""
    c_hi, c_lo = _split_bf16(build_circulant_matrix(psf).float())

    def apply(mh, ml, x):
        _check_full_f32(mh)
        xh, xl = _split_bf16(x.float())
        y = (torch.matmul(xh, mh) + torch.matmul(xl, mh)
             + torch.matmul(xh, ml))
        return y.to(x.dtype)

    def A(x):
        return apply(c_hi.T, c_lo.T, x)

    def AT(x):
        return apply(c_hi, c_lo, x)

    return A, AT


def _on_images(fn, shape):
    """``fn`` on (B, H, W) images as an operator that also takes their
    raveled (B, H*W) rows and returns what it was given."""
    def op(x):
        return fn(x.reshape((x.shape[0],) + tuple(shape))).reshape(x.shape)
    return op


def make_otf_operator(psf: torch.Tensor) -> Tuple[Operator, Operator]:
    """Circular convolution through the real FFT, PSF and image of one
    shape (``psf_operator.py:145-157``): the transform runs over the last
    two axes of the whole batch at once. ``s`` is always passed to the
    inverse, which could not tell an odd width from the even one below
    it."""
    shape = tuple(psf.shape[-2:])
    rtf = torch.fft.rfft2(torch.fft.fftshift(psf, dim=(-2, -1)))
    rctf = torch.conj(rtf)

    def apply(tf):
        return _on_images(
            lambda x: torch.fft.irfft2(tf * torch.fft.rfft2(x), s=shape),
            shape)

    return apply(rtf), apply(rctf)


def _good_fft_size(n: int) -> int:
    """Smallest even 7-smooth integer >= n (``psf_operator.py:160-180``).
    Zero-padding past the linear-convolution length leaves the cropped
    result unchanged, so the padded grid may be rounded up to a size whose
    FFT has small radices only."""
    if n <= 0:
        raise ValueError(f'FFT size must be positive, got {n}')
    s = n + (n & 1)
    while True:
        m = s
        for p in (2, 3, 5, 7):
            while m % p == 0:
                m //= p
        if m == 1:
            return s
        s += 2


def _linear_conv_same(kern: torch.Tensor, image_shape, pad_to=None
                      ) -> Operator:
    """Zero-padded linear convolution with ``kern``, cropped to the image
    at the kernel's centre (``psf_operator.py:183-197``), on (B, H, W).
    The kernel's transform is taken once, here. ``pad_to`` overrides the
    7-smooth padded grid (any size >= H + kh - 1 gives the same result)."""
    h, w = image_shape
    kh, kw = kern.shape[-2:]
    if pad_to is None:
        pad_to = (_good_fft_size(h + kh - 1), _good_fft_size(w + kw - 1))
    elif pad_to[0] < h + kh - 1 or pad_to[1] < w + kw - 1:
        raise ValueError(f'padded grid {tuple(pad_to)} is smaller than the '
                         f'linear convolution {(h + kh - 1, w + kw - 1)}')
    pad_to = tuple(pad_to)
    fk = torch.fft.rfft2(kern, s=pad_to)
    oy, ox = kh // 2, kw // 2

    def conv(x):
        full = torch.fft.irfft2(torch.fft.rfft2(x, s=pad_to) * fk, s=pad_to)
        return full[..., oy:oy + h, ox:ox + w].to(x.dtype)

    return conv


def make_linear_operator(psf: torch.Tensor, image_shape: Tuple[int, int],
                         pad_to=None) -> Tuple[Operator, Operator]:
    """Linear-convolution operator for PSF.shape != image.shape
    (``psf_operator.py:200-217``). The kernel is normalized to unit sum;
    the adjoint convolves with the axis transpose of the PSF, not its
    flip: the reference's own choice (``:209``), kept so that a solve
    follows the same path."""
    kern = psf / psf.sum(dim=(-2, -1), keepdim=True)
    kern_t = torch.conj(kern).transpose(-2, -1)
    return (_on_images(_linear_conv_same(kern, image_shape, pad_to),
                       image_shape),
            _on_images(_linear_conv_same(kern_t, image_shape, pad_to),
                       image_shape))


def make_operator(psf: torch.Tensor, image_shape: Tuple[int, ...],
                  method: str = 'auto') -> Tuple[Operator, Operator]:
    """Build (A, AT) on a (B, *image_shape) batch or its (B, N) rows
    (``psf_operator.py:310-345``). ``psf`` is (H, W), shared by the batch,
    or (B, H, W), one a batch member. ``'halo'`` raises naming the ROADMAP
    item that ports it."""
    psf_shape = tuple(psf.shape[-2:])
    same = psf_shape == tuple(image_shape)
    if method == 'auto':
        if same:
            method = ('matmul' if psf_shape[0] * psf_shape[1]
                      <= _MATMUL_MAX_PIXELS else 'otf')
        else:
            method = 'linear'
    if method == 'matmul':
        if not same:
            raise ValueError(
                'matmul operator requires PSF.shape == image.shape')
        return make_matmul_operator(psf)
    if method in ('matmul_flat', 'matmul_split'):
        if (len(image_shape) != 1 or psf.dim() != 2
                or psf.numel() != image_shape[0]):
            raise ValueError(f'{method} operates on (H*W,) raveled images '
                             f'with a shared PSF (psf {tuple(psf.shape)}, '
                             f'image {image_shape})')
        if method == 'matmul_split':
            return make_matmul_flat_split_operator(psf)
        return make_matmul_flat_operator(psf)
    if method == 'otf':
        if not same:
            raise ValueError('otf operator requires PSF.shape == image.shape')
        return make_otf_operator(psf)
    if method == 'linear':
        return make_linear_operator(psf, image_shape)
    if method == 'halo':
        raise NotImplementedError(
            "operator='halo' is not ported yet (ROADMAP A13)")
    raise ValueError(f'unknown operator method: {method}')
