"""Flux-conserving projection for a (B, N) batch: policy and dispatch.

Ports ``bracket_bits`` (``tpu_sgp/projection/flux_projection.py:244-252``)
and the per-row arithmetic around the Pallas kernel's call
(``tpu_sgp/experimental/pallas_projection.py:68-108``): the section-step
count and the saturation cap. The projection itself runs in
``kernels.flux_projection.project_rows``. The XLA projections of the JAX
package are not ported yet: ``'bisect'`` (the JAX default) is next, then
``'section'``, ``'sort'`` and ``'secant'`` (ROADMAP A5 and A11).
"""
from __future__ import annotations

import math

import torch

from ..kernels.flux_projection import project_rows

_K = 7  # section points per step of the kernel (pallas_projection.py:35)

_NOT_PORTED = {'bisect': 'A5', 'section': 'A5', 'sort': 'A11',
               'secant': 'A11'}


def bracket_bits(dtype: torch.dtype) -> int:
    """Bracket-narrowing budget in bits (``flux_projection.py:244-252``):
    enough to push the bracket below the dtype's resolution."""
    return 54 if dtype == torch.float64 else 28


def section_steps(dtype: torch.dtype) -> int:
    """Sectioning steps of 3 bits each (``pallas_projection.py:80-82``):
    10 in float32, 18 in float64."""
    return int(math.ceil(bracket_bits(dtype) / math.log2(_K + 1)))


def check_method(method: str) -> None:
    """Raise for a projection method the port does not have yet."""
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f'projection_method={method!r} is not ported yet (ROADMAP '
            f"{_NOT_PORTED[method]}); use projection_method='pallas'")
    if method != 'pallas':
        raise ValueError(f'unknown projection_method {method!r}')


def project_df_pallas(b: torch.Tensor, c: torch.Tensor, dia: torch.Tensor,
                      scaling: torch.Tensor,
                      sat_level: torch.Tensor | None = None,
                      has_sat: bool | None = None) -> torch.Tensor:
    """Batched ``project_df_pallas`` (``pallas_projection.py:68-122``).

    ``c`` and ``dia`` are (B, N); ``b``, ``scaling`` and ``sat_level`` are
    (B,). The cap is sat/scaling - eps per row (``:101-103``)."""
    if has_sat is None:
        has_sat = sat_level is not None
    if has_sat:
        cap = sat_level / scaling - torch.finfo(c.dtype).eps
    else:
        cap = torch.zeros_like(b)
    return project_rows(b.contiguous(), c.contiguous(),
                        dia.expand_as(c).contiguous(), cap.contiguous(),
                        section_steps(c.dtype), has_sat)
