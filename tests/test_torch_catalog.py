"""The port's host catalog (NumPy/SciPy copies of the JAX package's modules)
and ``beta_init_search``'s default ``'catalog'`` scorer: each copied source
pinned line for line, one behavioural check a module, equal arrays from both
packages on raw and restored stamps through the C++ deblender and through
the NumPy path, and the same beta per stamp as the JAX function in float64.
"""
import numpy as np
import pytest

import tpu_sgp_torch as tsgp
from tpu_sgp_torch import catalog as tcat
from tpu_sgp_torch import utils as tutils
from tpu_sgp_torch.catalog import _clip as tclip
from tpu_sgp_torch.catalog import native as tnative
from tpu_sgp_torch.simulate import synthetic_star_stamps

from _torch_source_pin import REPO, assert_copy_equal, normalised

COPIES = ['utils.py', 'catalog/_clip.py', 'catalog/background.py',
          'catalog/segmentation.py', 'catalog/batched.py',
          'native/deblend.cpp', 'native/localbkg.cpp']
BETA = dict(max_iter=8, stop_criterion=3, tol_convergence=1e-4, init_recon=2,
            proj_type=1, has_flux=True, has_sat_level=True, dtype='float64',
            divergence='beta', adapt_beta=True, schedule_lr=True,
            projection_method='section', track_discr=False)


def _stamps(b, size=16, seed=5, blended=True):
    """Seeded star stamps; every third one gets a second, fainter star a
    few pixels away so that the deblender has work."""
    stamps, psf, bkgs, _ = synthetic_star_stamps(b, size=size, seed=seed)
    if blended:
        other = synthetic_star_stamps(b, size=size, seed=seed + 100)[0]
        extra = np.roll(other - bkgs[:, None, None], (4, -3), axis=(1, 2))
        stamps[::3] += 0.6 * extra[::3]
    return stamps, psf, bkgs


@pytest.mark.parametrize('name', COPIES)
def test_copied_source_equals_the_jax_package(name):
    assert_copy_equal(f'tpu_sgp_torch/{name}', f'tpu_sgp/{name}')


def test_native_bindings_equal_the_jax_package_below_the_loader():
    """``native.py`` differs where it must (the library is built under
    ``build/``, named by its sources' hash); the ctypes signatures and the
    three entry points below the loader are the original's."""
    def tail(path):
        lines = normalised(path)
        return lines[next(i for i, line in enumerate(lines)
                          if 'lib.local_background_batch.restype' in line):]
    assert tail('tpu_sgp_torch/catalog/native.py') == tail(
        'tpu_sgp/catalog/native.py')


def test_native_library_builds_under_the_build_directory():
    if not tnative.available():
        pytest.skip('no C++ toolchain: the NumPy deblender runs instead')
    path = tnative._library_path()
    assert path.exists() and REPO / 'build' in path.parents
    assert not list((REPO / 'tpu_sgp_torch').rglob('*.so'))
    assert 'tpu_sgp/native' not in str(path)


def test_catalog_package_exports_what_is_ported():
    assert sorted(tcat.__all__) == sorted(
        ['Background2D', 'SegmentationImage', 'SourceFinder',
         'detect_sources', 'deblend_sources', 'brightest_catalog_fluxes',
         'Column', 'SourceCatalog', 'Table', 'source_info',
         'source_info_batch'])


def test_utils_sigma_clipped_stats_and_kernel():
    rng = np.random.default_rng(0)
    data = rng.normal(10.0, 2.0, 4000)
    data[:20] = 500.0
    mean, med, std = tutils.sigma_clipped_stats(data, sigma=3.0)
    assert abs(mean - 10.0) < 0.2 and abs(med - 10.0) < 0.2
    assert abs(std - 2.0) < 0.2
    kern = tutils.make_2dgaussian_kernel(1.2, size=3)
    assert kern.shape == (3, 3) and abs(kern.sum() - 1.0) < 1e-12
    assert kern[1, 1] == kern.max()


def test_clipped_box_stats_ignores_an_outlier():
    from tpu_sgp.catalog import _clip as jclip
    rng = np.random.default_rng(1)
    boxes = rng.normal(50.0, 1.0, (6, 25))
    boxes[2, 3] = 1e4
    got = tclip.clipped_box_stats(boxes, 3.0, 5)
    want = jclip.clipped_box_stats(boxes, 3.0, 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert abs(got[0][2] - 50.0) < 1.0


def test_background2d_recovers_a_flat_sky():
    from tpu_sgp.catalog import Background2D as JaxBackground2D
    rng = np.random.default_rng(2)
    data = rng.normal(120.0, 3.0, (40, 40))
    data[18:22, 18:22] += 900.0
    got = tcat.Background2D(data, 8)
    want = JaxBackground2D(data, 8)
    np.testing.assert_array_equal(got.background, want.background)
    np.testing.assert_array_equal(got.background_rms, want.background_rms)
    assert abs(np.median(got.background) - 120.0) < 2.0


@pytest.mark.parametrize('use_native', [True, False])
def test_detect_and_deblend_split_two_stars(use_native):
    from tpu_sgp import catalog as jcat
    if use_native and not tnative.available():
        pytest.skip('no C++ toolchain')
    yy, xx = np.mgrid[:32, :32]
    star = lambda y, x, a: a * np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / 4.0)
    data = star(14, 12, 100.0) + star(16, 19, 70.0)
    out = []
    for mod in (tcat, jcat):
        segm = mod.detect_sources(data, 1.0, npixels=5)
        assert segm.nlabels == 1
        out.append(mod.deblend_sources(data, segm, npixels=5,
                                       use_native=use_native))
    assert out[0].nlabels == 2
    np.testing.assert_array_equal(out[0].data, out[1].data)
    finder = tcat.SourceFinder(npixels=5)
    assert finder(data, 1.0).nlabels == 2


@pytest.mark.parametrize('use_native', [True, False])
@pytest.mark.parametrize('restored', [False, True])
def test_brightest_catalog_fluxes_equal_the_jax_package(
        monkeypatch, use_native, restored):
    """Equal arrays, NaNs in the same places, on raw stamps (three of them
    blank sky, which detect nothing) and on restorations, through the C++
    deblender and with both packages forced onto the NumPy path."""
    from tpu_sgp.catalog import native as jnative
    from tpu_sgp.catalog.batched import brightest_catalog_fluxes as jfluxes
    if use_native and not tnative.available():
        pytest.skip('no C++ toolchain')
    if not use_native:
        monkeypatch.setattr(tnative, 'available', lambda: False)
        monkeypatch.setattr(jnative, 'available', lambda: False)
    stamps, psf, bkgs = _stamps(15, seed=8)
    if restored:
        cfg = tsgp.SGPConfig(**dict(BETA, divergence='kl',
                                    projection_method='bisect'))
        fluxes = stamps.sum(axis=(1, 2)) - 256 * bkgs
        cutouts = tsgp.restore_stamps(stamps, psf, bkgs, cfg, fluxes=fluxes,
                                      sat_level=65000.0,
                                      device='cpu').x.numpy()
    else:
        cutouts = stamps.copy()
        cutouts[12:] = np.random.default_rng(4).poisson(
            120.0, (3, 16, 16)).astype(float)
    got = tcat.brightest_catalog_fluxes(cutouts)
    want = jfluxes(cutouts)
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).sum() >= 10


@pytest.mark.parametrize('case', ['fluxes', 'background_maps', 'per_lane'])
def test_beta_init_search_default_scorer_picks_jax_beta(case):
    """``beta_init_search`` with no ``scorer``, float64: the same beta for
    every stamp as the JAX function, the winner's x within 1e-9 of its
    maximum; also with per-pixel background maps and no fluxes
    (F_orig is then the map's pixel sum), and with (B,) backgrounds."""
    from tpu_sgp import SGPConfig as JaxConfig
    from tpu_sgp.parallel.batch import beta_init_search as jsearch
    stamps, psf, bkgs = _stamps(6, seed=11)
    kw = dict(sat_level=65000.0)
    cfg = dict(BETA)
    if case == 'fluxes':
        kw['fluxes'] = stamps.sum(axis=(1, 2)) - 256 * bkgs
    else:
        cfg.update(has_flux=False)
        if case == 'background_maps':
            bkgs = np.broadcast_to(bkgs[:, None, None], stamps.shape).copy()
    wb, wx, _ = jsearch(stamps, psf, bkgs, JaxConfig(**cfg), **kw)
    gb, gx, _ = tsgp.beta_init_search(stamps, psf, bkgs,
                                      tsgp.SGPConfig(**cfg), device='cpu',
                                      **kw)
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    assert np.isin(gb.numpy(), tsgp.default_beta_candidates()).all()
    wx = np.asarray(wx)
    assert np.abs(gx.numpy() - wx).max() <= 1e-9 * np.abs(wx).max()


def test_beta_init_search_nonfinite_catalog_score_never_wins():
    """A stamp in which nothing is detected scores NaN for every candidate
    and falls back to the first one."""
    stamps, psf, bkgs = _stamps(3, seed=12, blended=False)
    stamps[1] = bkgs[1]
    cfg = tsgp.SGPConfig(**dict(BETA, has_flux=False, has_sat_level=False,
                                proj_type=0, max_iter=4))
    cands = np.array([0.99, 1.01])
    best, _, _ = tsgp.beta_init_search(stamps, psf, bkgs, cfg,
                                       beta_candidates=cands, device='cpu')
    assert float(best[1]) == cands[0]
