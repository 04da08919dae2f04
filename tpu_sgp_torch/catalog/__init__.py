"""Host catalog pipeline (NumPy/SciPy copies of ``tpu_sgp/catalog/``):
background, detection and deblending, source properties, ``source_info``,
and ``beta_init_search``'s batched scorer. ``catalog/plotting.py`` is not
ported yet."""
from .background import Background2D
from .batched import brightest_catalog_fluxes
from .segmentation import (SegmentationImage, SourceFinder, deblend_sources,
                           detect_sources)
from .properties import Column, SourceCatalog, Table
from .source_info import source_info, source_info_batch

__all__ = [
    'Background2D', 'SegmentationImage', 'SourceFinder', 'deblend_sources',
    'detect_sources', 'Column', 'SourceCatalog', 'Table', 'source_info',
    'source_info_batch', 'brightest_catalog_fluxes',
]
