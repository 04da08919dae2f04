"""Port of ``tpu_sgp/experimental/pallas_projection.py``: the flux
projection of ONE image through the kernel K1.

The JAX module's ``project_df_pallas`` takes one image of any shape and a
scalar flux, lays the pixels out in (rows, 128) lane tiles padded with
pixels that add nothing to a sum, and runs its Pallas kernel over them.
Here the image's pixels are one row of the batched (B, N) form that the
solver calls, ``projection.flux_projection.project_df_pallas``, which runs
K1 (``kernels/flux_projection.py::project_rows``): on a CUDA tensor the
kernel (an image above 2048 pixels takes its grid path, split over the
card's SMs), on a CPU tensor its plain version.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..kernels.flux_projection import section_steps
from ..projection import flux_projection


def project_df_pallas(b, c, dia, scaling, sat_level=None,
                      has_sat: bool | None = None,
                      n_iters: int | None = None) -> torch.Tensor:
    """Project the image ``c`` (any shape) under the metric ``dia``
    (broadcast to ``c``'s shape) onto {x : sum(x) = b, 0 <= x <= cap},
    cap = sat_level / scaling - eps (``pallas_projection.py:68-122``).

    ``b``, ``scaling`` and ``sat_level`` are scalars. ``n_iters`` bits of
    bracket narrowing take ceil(n_iters / 3) sectioning steps of 7 points
    (default: the dtype's ``bracket_bits``, 10 steps in float32, 18 in
    float64). The result has ``c``'s shape and dtype and lies where ``c``
    lies: a tensor stays on its device, anything else goes to the card."""
    c = torch.as_tensor(c, device=resolve_device(None, c))
    if has_sat is None:
        has_sat = sat_level is not None

    def row(v):
        return torch.as_tensor(v, dtype=c.dtype, device=c.device).reshape(1)

    x = flux_projection.project_df_pallas(
        row(b), c.reshape(1, -1),
        torch.as_tensor(dia, dtype=c.dtype, device=c.device).expand(
            c.shape).reshape(1, -1),
        row(scaling), row(sat_level) if has_sat else None, has_sat,
        section_steps(c.dtype, n_iters))
    return x.reshape(c.shape)
