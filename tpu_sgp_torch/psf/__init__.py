"""DIAPL PSF models, the PSF fit and PSF kernels (NumPy/SciPy host code,
copies of ``tpu_sgp/psf/``). ``psf/pipeline.py`` is not ported yet."""
from .diapl import PSF, DiaplPSFModel, read_coo
from .fit import FitStar, fit_psf_model
from .kernels import normalize_psf, scale_psf

__all__ = ['PSF', 'DiaplPSFModel', 'read_coo', 'normalize_psf', 'scale_psf',
           'FitStar', 'fit_psf_model']
