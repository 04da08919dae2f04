"""FITS input and output, WCS, cutouts, tiling and mosaics (NumPy host
code, copies of ``tpu_sgp/image/``). ``write_fits_compressed`` is not
exported: it waits for the port of ``image/tile_compression.py`` and
``native/rice.cpp``, and until then ``read_fits`` raises ImportError on a
tile-compressed HDU."""
from .fitsio import (Header, getdata, getheader, read_fits, set_header_card,
                     write_fits, writeto)
from .wcs import WCS, pixel_to_skycoord
from .cutout import Cutout2D
from .tiling import calculate_slice_bboxes, create_subdivisions, tile_origins
from .mosaic import (coadd_tiles, match_backgrounds,
                     reconstruct_full_image_from_patches,
                     reproject_and_coadd, reproject_to_grid)

__all__ = [
    'read_fits', 'write_fits', 'writeto', 'getdata', 'getheader', 'Header',
    'set_header_card',
    'WCS', 'pixel_to_skycoord', 'Cutout2D',
    'calculate_slice_bboxes', 'create_subdivisions', 'tile_origins',
    'coadd_tiles', 'match_backgrounds', 'reconstruct_full_image_from_patches',
    'reproject_and_coadd', 'reproject_to_grid',
]
