"""The applications of ``tpu_sgp/workloads/``: star stamps, subdivisions,
simulation and spatial PSFs, on the card unless the caller passes
``device='cpu'``."""
from . import simulation, spatial_psf, star_stamps, subdivisions

__all__ = ['simulation', 'spatial_psf', 'star_stamps', 'subdivisions']
