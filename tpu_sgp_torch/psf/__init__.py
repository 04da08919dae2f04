"""DIAPL PSF models, the PSF fit, PSF kernels and the PSF-estimation
pipeline of ``psf.pipeline`` (NumPy/SciPy host code, copies of
``tpu_sgp/psf/``)."""
from .diapl import PSF, DiaplPSFModel, read_coo
from .fit import FitStar, fit_psf_model
from .kernels import normalize_psf, scale_psf

__all__ = ['PSF', 'DiaplPSFModel', 'read_coo', 'normalize_psf', 'scale_psf',
           'FitStar', 'fit_psf_model']
