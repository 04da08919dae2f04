"""Classic restoration baselines on the same operator stack.

Port of ``tpu_sgp/solvers/classic.py:27-63``: Richardson-Lucy, the EM
iteration of the Poisson/KL model that SGP minimizes, and the Wiener
filter, one closed-form pass through the frequency domain. Both take one
(H, W) image or a (B, H, W) batch (the JAX functions are vmapped for that),
compute on the card unless the caller passes ``device='cpu'``, and return
a tensor of the input's shape.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..ops.psf_operator import make_operator


def _batched(gn, psf, dtype, device):
    """``gn`` as a (B, H, W) tensor on its device, ``psf`` beside it, and
    whether the caller gave one image."""
    dev = resolve_device(device, gn)
    gn = torch.as_tensor(gn, device=dev)
    if dtype is not None:
        gn = gn.to(dtype)
    elif not gn.is_floating_point():
        gn = gn.to(torch.float32)
    single = gn.dim() == 2
    if single:
        gn = gn[None]
    psf = torch.as_tensor(psf, dtype=gn.dtype, device=dev)
    return gn, psf, single


def richardson_lucy(gn, psf, bkg, n_iters: int = 30, operator: str = 'auto',
                    *, dtype=None, device=None) -> torch.Tensor:
    """Richardson-Lucy deconvolution (``classic.py:27-51``):
    x <- x * AT(gn / (A(x) + bkg)) / AT(1) for ``n_iters`` updates from the
    flat background-subtracted flux. ``bkg`` is a scalar, (B,) or an array
    of the images' shape; a floating ``gn`` keeps its dtype unless
    ``dtype`` says otherwise."""
    gn, psf, single = _batched(gn, psf, dtype, device)
    nb = gn.shape[0]
    shape = tuple(gn.shape[1:])
    bkg = torch.as_tensor(bkg, dtype=gn.dtype, device=gn.device)
    if bkg.dim() == 1 and not single:
        bkg = bkg[:, None, None]
    bkg = bkg.expand(gn.shape)
    A, AT = make_operator(psf, shape, operator)
    tiny = torch.finfo(gn.dtype).tiny

    at_one = AT(torch.ones_like(gn))
    # the flat start is floored at the data's scale, not at float tiny:
    # with an over-subtracted background mean(gn - bkg) <= 0, and a few
    # O(1) multiplicative updates cannot grow 1e-38 into a physical flux
    floor = torch.clamp_min(torch.finfo(gn.dtype).eps
                            * gn.abs().amax((1, 2)), tiny)
    start = torch.maximum((gn - bkg).mean((1, 2)), floor)
    x = start[:, None, None].expand(nb, *shape).contiguous()
    for _ in range(n_iters):
        den = A(x) + bkg
        ratio = gn / torch.clamp_min(den, tiny)
        x = x * AT(ratio) / torch.clamp_min(at_one, tiny)
    return x[0] if single else x


def wiener(gn, psf, nsr=1e-3, *, dtype=None, device=None) -> torch.Tensor:
    """Wiener deconvolution X = conj(H) / (|H|^2 + nsr) * G with a scalar
    or per-frequency noise-to-signal ratio, for the circular PSF model of
    the ``'otf'`` operator, H = rfft2(fftshift(psf))
    (``classic.py:54-63``)."""
    gn, psf, single = _batched(gn, psf, dtype, device)
    h = torch.fft.rfft2(torch.fft.fftshift(psf, dim=(-2, -1)))
    g = torch.fft.rfft2(gn)
    nsr = torch.as_tensor(nsr, dtype=gn.dtype, device=gn.device)
    filt = torch.conj(h) / (h.abs() ** 2 + nsr)
    x = torch.fft.irfft2(filt * g, s=tuple(gn.shape[-2:]))
    return x[0] if single else x
