"""The port's single-image API (``sgp``, ``sgp_beta_div``) and its solver
on whole frames against the JAX package's, float64 on the CPU: a 64x48
frame with a 15x15 PSF (the 'linear' operator) and an 80x80 frame with a
PSF of its own shape ('otf'). Equal iteration counts, x within 1e-9 of
max|x|, the discrepancy and error series within 1e-9."""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_sgp
from tpu_sgp import SGPConfig as JaxConfig
from tpu_sgp import simulate as jsim
from tpu_sgp.solvers import sgp as jsgp
import tpu_sgp_torch as tsgp
from tpu_sgp_torch import simulate as tsim

BKG = 150.0


def _frame(kind):
    """(image, psf, truth): 'linear' is a 64x48 star field under a 15x15
    PSF, 'otf' an 80x80 field blurred circularly by an 80x80 PSF."""
    if kind == 'linear':
        return tsim.synthetic_star_field(64, 48, n_stars=8, psf_size=15,
                                         fwhm=3.0, seed=7)
    rng = np.random.default_rng(8)
    psf = tsim.gaussian_psf(80, 3.0)
    truth = np.zeros((80, 80))
    truth[rng.integers(2, 78, 10), rng.integers(2, 78, 10)] = rng.uniform(
        2e3, 8e4, 10)
    blurred = tsim._circular_degrade(truth, psf) + BKG
    return rng.poisson(np.maximum(blurred, 0.0)).astype(np.float64), psf, truth


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


def _same_tuple(got, want):
    x, iters, discr, times, err = got
    xj, iters_j, discr_j, times_j, err_j = want
    assert iters == iters_j
    assert x.shape == xj.shape and isinstance(x, np.ndarray)
    assert _rel(x, xj) <= 1e-9
    assert discr.shape == discr_j.shape
    np.testing.assert_allclose(discr, discr_j, rtol=1e-9, atol=1e-12)
    assert times.shape == times_j.shape == (iters + 1,)
    assert times[-1] > 0 and not times[:-1].any()
    if err_j is None:
        assert err is None
    else:
        assert err.shape == err_j.shape
        np.testing.assert_allclose(err, err_j, rtol=1e-9, atol=1e-12)


API_CASES = [('linear', 'kl', 0), ('linear', 'kl', 1), ('linear', 'beta', 2),
             ('linear', 'beta', 3), ('otf', 'kl', 2), ('otf', 'kl', 3),
             ('otf', 'beta', 0), ('otf', 'beta', 1)]


@pytest.mark.parametrize('kind,div,init', API_CASES)
def test_api_matches_jax(kind, div, init):
    """``sgp`` / ``sgp_beta_div`` with the flux projection and stop rule
    3, every init mode on either frame."""
    img, psf, _ = _frame(kind)
    kw = dict(init_recon=init, proj_type=1, stop_criterion=3, MAXIT=15,
              tol_convergence=1e-5, dtype='float64')
    if div == 'kl':
        want = tpu_sgp.sgp(img, psf, BKG, **kw)
        got = tsgp.sgp(img, psf, BKG, device='cpu', **kw)
    else:
        kw.update(schedule_lr=True)
        want = tpu_sgp.sgp_beta_div(img, psf, BKG, **kw)
        got = tsgp.sgp_beta_div(img, psf, BKG, device='cpu', **kw)
    _same_tuple(got, want)
    np.testing.assert_allclose(got[0].sum(), (img - BKG).sum(), rtol=1e-9)


@pytest.mark.parametrize('kind', ['linear', 'otf'])
def test_api_errflag_flux_and_saturation(kind):
    """``errflag`` returns the error series; ``flux`` and
    ``ccd_sat_level`` reach the projection; the clip projection
    (``proj_type=0``) and a background map go through too."""
    img, psf, truth = _frame(kind)
    flux = float((img - BKG).sum()) * 1.01
    kw = dict(init_recon=2, proj_type=1, stop_criterion=1, MAXIT=12,
              errflag=True, obj=truth, flux=flux,
              ccd_sat_level=float(img.max()) * 0.9, dtype='float64')
    got = tsgp.sgp(img, psf, BKG, device='cpu', **kw)
    _same_tuple(got, tpu_sgp.sgp(img, psf, BKG, **kw))
    np.testing.assert_allclose(got[0].sum(), flux, rtol=1e-9)
    assert got[4] is not None and got[4].shape == (13,)
    if kind == 'otf':
        return
    bkg_map = np.full(img.shape, BKG) + np.arange(img.shape[1]) * 0.1
    kw = dict(proj_type=0, stop_criterion=2, MAXIT=12, dtype='float64',
              errflag=True, obj=truth)
    _same_tuple(tsgp.sgp_betaDiv(img, psf, bkg_map, device='cpu', **kw),
                tpu_sgp.sgp_betaDiv(img, psf, bkg_map, **kw))


def test_api_operator_remaps():
    """A PSF smaller than its image, or ``use_original_SGP_Afunction=
    False``, takes 'linear' (api.py:129-132): on a same-shape frame the
    latter gives the 'linear' result, not the 'otf' one."""
    img, psf, _ = _frame('otf')
    kw = dict(init_recon=2, proj_type=1, stop_criterion=1, MAXIT=5,
              dtype='float64')
    lin = tsgp.sgp(img, psf, BKG, use_original_SGP_Afunction=False,
                   device='cpu', **kw)
    explicit = tsgp.sgp(img, psf, BKG, operator='linear', device='cpu', **kw)
    otf = tsgp.sgp(img, psf, BKG, device='cpu', **kw)
    np.testing.assert_array_equal(lin[0], explicit[0])
    assert _rel(lin[0], otf[0]) > 1e-6
    _same_tuple(lin, tpu_sgp.sgp(img, psf, BKG,
                                 use_original_SGP_Afunction=False, **kw))


def test_api_default_dtype_is_float32():
    img, psf, _ = _frame('linear')
    x, iters, discr, times, err = tsgp.sgp(img, psf, BKG, init_recon=2,
                                           proj_type=1, MAXIT=3,
                                           stop_criterion=1, device='cpu')
    assert x.dtype == np.float32 and iters == 3 and err is None
    assert discr.shape == times.shape == (4,)


SOLVE_CASES = {
    'bisect_warm': dict(projection_method='bisect', warm_projection=True),
    'section': dict(projection_method='section'),
    'pallas': dict(projection_method='pallas'),
    'bisect_warm_series': dict(projection_method='bisect',
                               warm_projection=True, track_discr=True,
                               errflag=True),
    'pallas_flux_sat': dict(projection_method='pallas', has_flux=True,
                            has_sat_level=True),
}


@pytest.mark.parametrize('kind', ['linear', 'otf'])
@pytest.mark.parametrize('name', list(SOLVE_CASES))
def test_solve_matches_jax_solve(kind, name):
    """``solve`` with an ``SGPConfig``, as the whole-frame bench calls it
    (stop rule 3, init 2, no flux given): the warm bisection, 'section'
    and 'pallas' (JAX's kernel in interpret mode)."""
    img, psf, truth = _frame(kind)
    cfg = dict(max_iter=20, stop_criterion=3, tol_convergence=1e-5,
               init_recon=2, proj_type=1, has_flux=False,
               has_sat_level=False, dtype='float64', track_discr=False)
    cfg.update(SOLVE_CASES[name])
    flux = float((img - BKG).sum()) * 0.99
    sat = float(img.max()) * 0.9
    bkg = np.full(img.shape, BKG)
    z = np.zeros(img.shape)
    want = jsgp.solve(jnp.asarray(img), jnp.asarray(psf), jnp.asarray(bkg),
                      jnp.asarray(z), flux, jnp.asarray(truth), 1.0, 1e-3,
                      sat, JaxConfig(**cfg))
    got = tsgp.solve(img[None], psf, bkg[None], z[None], flux, truth[None],
                     1.0, 1e-3, sat, tsgp.SGPConfig(**cfg), device='cpu')
    assert int(got.iters[0]) == int(want.iters)
    assert _rel(got.x[0].numpy(), want.x) <= 1e-9
    for field in ('discr', 'err'):
        np.testing.assert_allclose(getattr(got, field)[0].numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=1e-9, atol=1e-12, err_msg=field)
    target = flux if cfg['has_flux'] else (img - BKG).sum()
    np.testing.assert_allclose(got.x[0].numpy().sum(), target, rtol=1e-9)


def test_check_psf_normalized():
    psf = tsim.gaussian_psf(15, 3.0)
    tsgp.check_psf_normalized(psf)
    tsgp.check_psf_normalized(psf.astype(np.float32))
    for bad in (psf * 1.001, np.where(np.arange(15) == 3, np.nan, psf)):
        with pytest.raises(ValueError, match='PSF is not normalized'):
            tsgp.check_psf_normalized(bad)
        with pytest.raises(ValueError, match='PSF is not normalized'):
            tpu_sgp.check_psf_normalized(bad)
    assert tsgp.api.PSF_NORM_TOL_FACTOR == tpu_sgp.api.PSF_NORM_TOL_FACTOR


@pytest.mark.parametrize('case,match', [
    ('nan_psf', 'PSF is not normalized'), ('zero_image', 'identically zero'),
    ('nan_image', 'non-finite pixels'), ('nan_bkg', 'bkg contains'),
    ('negative_flux', 'positive total flux'),
    ('oversubtracted', 'computed as sum'), ('errflag', 'no ground-truth'),
    ('errflag_beta', 'no ground-truth')])
def test_api_rejects_degenerate_inputs(case, match):
    """The ``ValueError``s of ``check_psf_normalized`` and
    ``_validate_inputs``, raised before any device is asked for, as the JAX
    package raises them."""
    img, psf, _ = _frame('linear')
    bkg, kw, fn = BKG, dict(proj_type=1), 'sgp'
    if case == 'nan_psf':
        psf = psf.copy()
        psf[0, 0] = np.nan
    elif case == 'zero_image':
        img = np.zeros_like(img)
    elif case == 'nan_image':
        img = img.copy()
        img[3, 3] = np.inf
    elif case == 'nan_bkg':
        bkg = np.nan
    elif case == 'negative_flux':
        kw['flux'] = -1.0
    elif case == 'oversubtracted':
        bkg = float(img.max())
    else:
        kw['errflag'] = True
        fn = 'sgp' if case == 'errflag' else 'sgp_beta_div'
    with pytest.raises(ValueError, match=match):
        getattr(tsgp, fn)(img, psf, bkg, **kw)
    with pytest.raises(ValueError, match=match):
        getattr(tpu_sgp, fn)(img, psf, bkg, **kw)


def test_api_save_raises_naming_the_roadmap_item():
    img, psf, _ = _frame('linear')
    with pytest.raises(NotImplementedError, match='A11'):
        tsgp.sgp(img, psf, BKG, save=True, device='cpu')


def test_api_without_a_card_raises_instead_of_using_the_cpu():
    """A numpy call naming no device computes on the card; where there is
    none it raises."""
    if torch.cuda.is_available():
        pytest.skip('this host has a CUDA device')
    img, psf, _ = _frame('linear')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tsgp.sgp(img, psf, BKG, MAXIT=2)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tsgp.richardson_lucy(img, psf, BKG, n_iters=2)


def test_simulate_copies_equal_the_originals():
    """Equal arrays for equal seeds."""
    for kw in (dict(size=31, fwhm=2.8, beta=2.5), dict(size=16, fwhm=4.0,
                                                       beta=4.0)):
        np.testing.assert_array_equal(tsim.moffat_psf(**kw),
                                      jsim.moffat_psf(**kw))
    rng = np.random.default_rng(3)
    image = rng.uniform(0, 100, (40, 36))
    psf = tsim.moffat_psf(9, 3.0) * 2.0
    np.testing.assert_array_equal(tsim.degrade(image, psf),
                                  jsim.degrade(image, psf))
    np.testing.assert_array_equal(
        tsim.artificial_sky_background(image, 50.0, gain=2.0, seed=5),
        jsim.artificial_sky_background(image, 50.0, gain=2.0, seed=5))
    for kw in (dict(height=64, width=48, n_stars=8, psf_size=15, fwhm=3.0,
                    seed=7), dict(height=50, width=70)):
        for a, b in zip(tsim.synthetic_star_field(**kw),
                        jsim.synthetic_star_field(**kw)):
            np.testing.assert_array_equal(a, b)
    assert set(tsim.__all__) == set(jsim.__all__)


def test_sky_background_seed_from_environment(monkeypatch):
    monkeypatch.setenv(tsim.SEED_ENV, '11')
    image = np.zeros((8, 8))
    np.testing.assert_array_equal(
        tsim.artificial_sky_background(image, 30.0),
        jsim.artificial_sky_background(image, 30.0))


def test_package_exports_and_imports_no_jax():
    """The port's surface, and: importing it imports neither JAX nor the
    JAX package."""
    import subprocess
    for name in ('sgp', 'sgp_beta_div', 'sgp_betaDiv', 'check_psf_normalized',
                 'richardson_lucy', 'wiener', 'restore_stamps', 'solve'):
        assert name in tsgp.__all__ and callable(getattr(tsgp, name))
    assert tsgp.sgp_betaDiv is tsgp.sgp_beta_div
    code = ('import sys, tpu_sgp_torch, tpu_sgp_torch.solvers.checkpoint, '
            'tpu_sgp_torch.solvers.classic, tpu_sgp_torch.simulate; '
            "assert 'jax' not in sys.modules and 'tpu_sgp' not in sys.modules")
    subprocess.run([sys.executable, '-c', code], check=True)
