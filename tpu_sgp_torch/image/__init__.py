"""FITS input and output with fpack tile compression (RICE_1 through
``native/rice.cpp``, GZIP_1, GZIP_2), WCS, cutouts, tiling and mosaics
(NumPy host code, copies of ``tpu_sgp/image/``)."""
from .fitsio import (Header, getdata, getheader, read_fits, set_header_card,
                     write_fits, writeto)
from .tile_compression import write_fits_compressed
from .wcs import WCS, pixel_to_skycoord
from .cutout import Cutout2D
from .tiling import calculate_slice_bboxes, create_subdivisions, tile_origins
from .mosaic import (coadd_tiles, match_backgrounds,
                     reconstruct_full_image_from_patches,
                     reproject_and_coadd, reproject_to_grid)

__all__ = [
    'read_fits', 'write_fits', 'writeto', 'getdata', 'getheader', 'Header',
    'set_header_card', 'write_fits_compressed',
    'WCS', 'pixel_to_skycoord', 'Cutout2D',
    'calculate_slice_bboxes', 'create_subdivisions', 'tile_origins',
    'coadd_tiles', 'match_backgrounds', 'reconstruct_full_image_from_patches',
    'reproject_and_coadd', 'reproject_to_grid',
]
