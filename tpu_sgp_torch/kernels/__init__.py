"""Port of tpu_sgp/kernels. ``launches`` counts the successful launches of
the port's CUDA kernels by key (``kernels/_build.py``)."""
from ._build import launches

__all__ = ['launches']
