"""Where the port's entry points compute.

A torch tensor computes on the device it lies on. Anything else (numpy
arrays, lists, scalars) goes to ``device``, which defaults to the card: the
CPU runs only when the caller names it. Without a card, a call that names
no device raises instead of carrying on on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None, like=None) -> torch.device:
    """The device of ``like`` if it is a tensor, else ``device``
    (``'cuda'`` when None). Raises ``RuntimeError`` for a CUDA device when
    no card is present."""
    if isinstance(like, torch.Tensor):
        return like.device
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device is available: the port computes on the card '
            "unless the caller passes device='cpu'")
    return dev
