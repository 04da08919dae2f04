"""KL objective and gradient over a (B, N) batch.

Port of ``kl_objective`` (``tpu_sgp/ops/divergence.py:23-38``) and
``kl_grad_wrt_recon`` (``:252-254``), one value per row. The beta-divergence
family of that module waits for ROADMAP A9.
"""
from __future__ import annotations

import torch

from .reduce import gsum, gsum_ff


def kl_objective(x_tf: torch.Tensor, den: torch.Tensor, gn: torch.Tensor,
                 flux: torch.Tensor, axes=(), stable: bool = False
                 ) -> torch.Tensor:
    """fv = sum(gn * log(gn/den)) + sum(A(x)) - flux, per row
    (``divergence.py:23-38``). ``flux`` is (B,); ``stable`` selects the
    compensated tree sum (``reduce.gsum_ff``)."""
    red = gsum_ff if stable else gsum
    return red(gn * torch.log(gn / den), axes) + red(x_tf, axes) - flux


def kl_grad_wrt_recon(AT, den: torch.Tensor, gn: torch.Tensor
                      ) -> torch.Tensor:
    """KL gradient g = 1 - AT(gn/den) (``divergence.py:252-254``)."""
    return 1.0 - AT(gn / den)


def beta_div(*args, **kwargs):
    """The beta-divergence (``divergence.py:41``) is not ported yet."""
    raise NotImplementedError(
        "divergence='beta' is not ported yet (ROADMAP A9)")


def beta_grad_wrt_recon(*args, **kwargs):
    """The beta-divergence gradient (``divergence.py:237``) is not ported
    yet."""
    raise NotImplementedError(
        "divergence='beta' is not ported yet (ROADMAP A9)")
