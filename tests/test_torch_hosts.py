"""The host modules the applications need (NumPy/SciPy copies of the JAX
package's ``catalog/{properties,source_info}``, ``image/{wcs,cutout,
tiling,mosaic}``, ``psf/{kernels,diapl,fit,native}`` and ``metrics``):
each copied source pinned line for line, the C++ PSF evaluator byte for
byte and built under ``build/``, and one behavioural check a module with
equal results from both packages on seeded inputs.
"""
import subprocess
import sys

import numpy as np
import pytest

from tpu_sgp_torch import catalog as tcat
from tpu_sgp_torch import image as timage
from tpu_sgp_torch import metrics as tmetrics
from tpu_sgp_torch import psf as tpsf
from tpu_sgp_torch import workloads as tworkloads
from tpu_sgp_torch.config import DEFAULT_COLUMNS
from tpu_sgp_torch.psf import native as tnative
from tpu_sgp_torch.simulate import synthetic_star_field

from _torch_source_pin import REPO, assert_copy_equal, normalised
from test_torch_workloads import (  # noqa: F401
    _one_torch_thread, seeded_diapl_model)

COPIES = ['catalog/properties.py', 'catalog/source_info.py', 'image/wcs.py',
          'image/cutout.py', 'image/tiling.py', 'image/mosaic.py',
          'psf/kernels.py', 'psf/diapl.py', 'psf/fit.py',
          'metrics/__init__.py']


@pytest.mark.parametrize('name', COPIES)
def test_copied_source_equals_the_jax_package(name):
    assert_copy_equal(f'tpu_sgp_torch/{name}', f'tpu_sgp/{name}',
                      min_lines=10)


def test_psf_core_is_a_byte_for_byte_copy():
    assert ((REPO / 'tpu_sgp_torch/native/psf_core.cpp').read_bytes() ==
            (REPO / 'tpu_sgp/native/psf_core.cpp').read_bytes())


def test_psf_native_bindings_equal_the_jax_package_below_the_loader():
    """``psf/native.py`` builds its library under ``build/`` (named by
    the source's hash); the ctypes signatures and the entry points below
    the loader are the original's."""
    def tail(path):
        lines = normalised(path)
        return lines[next(i for i, line in enumerate(lines)
                          if 'dptr = np.ctypeslib.ndpointer' in line):]
    assert tail('tpu_sgp_torch/psf/native.py') == tail(
        'tpu_sgp/psf/native.py')


def test_psf_native_library_builds_under_the_build_directory():
    if not tnative.available():
        pytest.skip('no C++ toolchain: the NumPy renderer runs instead')
    path = tnative._library_path()
    assert path.exists() and REPO / 'build' in path.parents
    assert not list((REPO / 'tpu_sgp_torch').rglob('*.so'))
    assert 'tpu_sgp/native' not in str(path)


def test_packages_export_the_jax_names():
    from tpu_sgp import catalog, image, metrics, psf, workloads
    assert set(tcat.__all__) == set(catalog.__all__) | {
        'brightest_catalog_fluxes'}
    assert set(timage.__all__) == set(image.__all__) - {
        'write_fits_compressed'}
    assert set(tpsf.__all__) == set(psf.__all__)
    assert tworkloads.__all__ == workloads.__all__
    for pkg, jpkg in ((tcat, catalog), (timage, image), (tpsf, psf),
                      (tworkloads, workloads)):
        for name in pkg.__all__:
            assert hasattr(pkg, name), name
    for name in dir(metrics):
        if not name.startswith('_') and callable(getattr(metrics, name)):
            assert callable(getattr(tmetrics, name, None)), name


def test_applications_import_no_jax():
    """Importing every module of this slice, and building the PSF
    library, leaves ``jax`` and the JAX package out of ``sys.modules`` (a
    fresh interpreter)."""
    code = ("import sys, tpu_sgp_torch.cli, tpu_sgp_torch.workloads, "
            "tpu_sgp_torch.workloads.star_stamps, "
            "tpu_sgp_torch.workloads.subdivisions, "
            "tpu_sgp_torch.workloads.simulation, "
            "tpu_sgp_torch.workloads.spatial_psf, tpu_sgp_torch.metrics, "
            "tpu_sgp_torch.psf.native, tpu_sgp_torch.image.wcs, "
            "tpu_sgp_torch.image.mosaic, tpu_sgp_torch.catalog.source_info; "
            "tpu_sgp_torch.psf.native.available(); "
            "sys.exit('jax' in sys.modules or any("
            "m == 'tpu_sgp' or m.startswith('tpu_sgp.') "
            "for m in sys.modules))")
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ---- catalog/properties.py, catalog/source_info.py -----------------------------

def test_source_info_tables_equal_the_jax_package():
    from tpu_sgp.catalog import source_info, source_info_batch
    image, _, _ = synthetic_star_field(96, 80, n_stars=10, seed=4)
    scat, bkg = tcat.source_info(image, box_size=(32, 32), localbkg_width=5)
    jscat, jbkg = source_info(image, box_size=(32, 32), localbkg_width=5)
    got, want = scat.to_table(DEFAULT_COLUMNS), jscat.to_table(DEFAULT_COLUMNS)
    assert len(got) == len(want) >= 5
    for col in DEFAULT_COLUMNS:
        if col != 'sky_centroid':
            np.testing.assert_array_equal(np.asarray(got[col].value),
                                          np.asarray(want[col].value), col)
    np.testing.assert_array_equal(bkg.background, jbkg.background)
    frame = got.to_pandas()
    assert list(frame.columns) == list(want.to_pandas().columns)
    frames = [image[:48], image[40:]]
    batch = tcat.source_info_batch(frames, n_workers=2, localbkg_width=5)
    jbatch = source_info_batch(frames, n_workers=2, localbkg_width=5)
    for (s, b), (js, jb) in zip(batch, jbatch):
        np.testing.assert_array_equal(s.to_table(['segment_flux'])[
            'segment_flux'].value, js.to_table(['segment_flux'])[
            'segment_flux'].value)
        np.testing.assert_array_equal(b.background_rms, jb.background_rms)


# ---- image/{wcs,cutout,tiling,mosaic}.py --------------------------------------

CODES = ['TAN', 'SIN', 'ARC', 'STG', 'ZEA', 'ZPN', 'AZP', 'SZP', 'TPV', 'CAR',
         'CEA', 'MER', 'CYP', 'SFL', 'AIT', 'MOL', 'PAR', 'BON', 'PCO', 'HPX',
         'TSC', 'COP', 'COE', 'COD', 'COO']
PV = {'ZPN': {'PV2_1': 1.1, 'PV2_3': 0.1}, 'AZP': {'PV2_1': 2.0},
      'SZP': {'PV2_1': 1.5, 'PV2_2': 40.0, 'PV2_3': 60.0},
      'TPV': {'PV1_1': 1.02, 'PV2_1': 0.98, 'PV1_7': 1e-3, 'PV2_11': -1e-3},
      'CEA': {'PV2_1': 0.7}, 'CYP': {'PV2_1': 1.5, 'PV2_2': 0.8},
      'BON': {'PV2_1': 45.0}, 'COP': {'PV2_1': 40.0, 'PV2_2': 10.0},
      'COE': {'PV2_1': -35.0, 'PV2_2': 5.0},
      'COD': {'PV2_1': 30.0, 'PV2_2': 10.0},
      'COO': {'PV2_1': 50.0, 'PV2_2': 8.0}}


def _equal_nan(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize('scale', ['field', 'allsky'])
def test_wcs_equals_the_jax_package_on_every_projection(scale):
    """Every projection code of ``tests/test_image.py``, on a rotated
    field and on a 1 deg/px grid that overhangs the map: equal world
    coordinates (NaN where the JAX package gives NaN), equal pixels back,
    equal headers. On the all-sky grid the pixels beyond the pole of
    CAR, SFL and PAR come back finite in both packages: the JAX package
    folds them onto the sky instead of returning NaN (the known failure of
    ``test_wcs_fuzz_all_codes_roundtrip_or_nan``), and the copy keeps that
    behaviour."""
    from tpu_sgp.image import WCS as JaxWCS
    rng = np.random.default_rng(11)
    folded = []
    for code in CODES:
        if scale == 'field':
            hdr = {'CRPIX1': 150.0, 'CRPIX2': 140.0, 'CRVAL1': 250.0,
                   'CRVAL2': 36.0, 'CD1_1': -2e-3, 'CD1_2': 2e-4,
                   'CD2_1': -1e-4, 'CD2_2': 2e-3}
            xs, ys = rng.uniform(-10, 310, 60), rng.uniform(-10, 310, 60)
        else:
            if code in ('TPV', 'ZPN', 'AZP', 'SZP', 'COP', 'COE', 'COD',
                        'COO'):
                continue
            hdr = {'CRPIX1': 200.0, 'CRPIX2': 100.0, 'CRVAL1': 120.0,
                   'CRVAL2': 0.0, 'CDELT1': -1.0, 'CDELT2': 1.0}
            xs, ys = rng.uniform(-10, 410, 300), rng.uniform(-10, 210, 300)
        hdr.update({'CTYPE1': f'RA---{code}', 'CTYPE2': f'DEC--{code}'},
                   **PV.get(code, {}))
        got, want = timage.WCS(hdr), JaxWCS(hdr)
        ra, dec = got.pixel_to_world(xs, ys)
        jra, jdec = want.pixel_to_world(xs, ys)
        _equal_nan(ra, jra)
        _equal_nan(dec, jdec)
        ok = np.isfinite(ra) & np.isfinite(dec)
        assert ok.sum() >= 15, code
        for a, b in zip(got.world_to_pixel(ra[ok], dec[ok]),
                        want.world_to_pixel(ra[ok], dec[ok])):
            _equal_nan(a, b)
        assert dict(got.to_header().items()) == dict(
            want.to_header().items())
        beyond = np.abs(ys - 99.0) > 90.5
        if code in ('CAR', 'SFL', 'PAR') and scale == 'allsky':
            folded.append(bool(np.isfinite(ra[beyond]).any()))
    assert folded == ([True, True, True] if scale == 'allsky' else [])


def test_cutout_tiling_and_mosaic_equal_the_jax_package():
    from tpu_sgp import image as jimage
    rng = np.random.default_rng(5)
    image = rng.normal(100.0, 5.0, (130, 150))
    hdr = {'CTYPE1': 'RA---TAN', 'CTYPE2': 'DEC--TAN', 'CRPIX1': 75.0,
           'CRPIX2': 65.0, 'CRVAL1': 250.0, 'CRVAL2': 36.0,
           'CD1_1': -2.8e-4, 'CD2_2': 2.8e-4}
    got = timage.create_subdivisions(image, (64, 64), overlap=8,
                                     wcs=timage.WCS(hdr))
    want = jimage.create_subdivisions(image, (64, 64), overlap=8,
                                      wcs=jimage.WCS(hdr))
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert g.origin_original == w.origin_original
        np.testing.assert_array_equal(g.data, w.data)
        _equal_nan(g.wcs.pixel_to_world(3.0, 4.0),
                   w.wcs.pixel_to_world(3.0, 4.0))
    _equal_nan(timage.tile_origins(got), jimage.tile_origins(want))
    assert timage.calculate_slice_bboxes(130, 150, 64, 64, 0.1, 0.1) == \
        jimage.calculate_slice_bboxes(130, 150, 64, 64, 0.1, 0.1)
    tiles = [g.data + 3.0 * i for i, g in enumerate(got)]
    origins = [g.origin_original for g in got]
    for a, b in zip(timage.coadd_tiles(tiles, origins, image.shape),
                    jimage.coadd_tiles(tiles, origins, image.shape)):
        np.testing.assert_array_equal(a, b)
    cut = timage.Cutout2D(image, (20.5, 10.0), 15, mode='partial',
                          fill_value=0.0)
    jcut = jimage.Cutout2D(image, (20.5, 10.0), 15, mode='partial',
                           fill_value=0.0)
    np.testing.assert_array_equal(cut.data, jcut.data)
    assert cut.origin_original == jcut.origin_original


# ---- psf/{kernels,diapl,fit,native}.py ----------------------------------------

def test_psf_kernels_and_diapl_model_equal_the_jax_package(tmp_path):
    from tpu_sgp import psf as jpsf
    from tpu_sgp.psf.diapl import DiaplPSFModel as JaxModel
    model = seeded_diapl_model(3)
    model.to_txt(str(tmp_path / 'model.bin.txt'))
    back = tpsf.DiaplPSFModel.from_txt(str(tmp_path / 'model.bin.txt'))
    jback = JaxModel.from_txt(str(tmp_path / 'model.bin.txt'))
    np.testing.assert_array_equal(back.vec_coeffs, model.vec_coeffs)
    local = back.local_coeffs(300.0, -40.0)
    np.testing.assert_array_equal(local, jback.local_coeffs(300.0, -40.0))
    mat = back.normalized_matrix(31, local)
    np.testing.assert_array_equal(mat, jback.normalized_matrix(31, local))
    np.testing.assert_array_equal(
        tpsf.scale_psf(mat, gaussian_fwhm=2.0, size=mat.shape),
        jpsf.scale_psf(mat, gaussian_fwhm=2.0, size=mat.shape))
    np.testing.assert_array_equal(tpsf.normalize_psf(3.0 * mat),
                                  jpsf.normalize_psf(3.0 * mat))
    (tmp_path / 'stars.coo').write_text(
        '# x y\n#\n#\n10.5 20.25 900.0 110.0 0\n40.0 7.5 1200.0 101.0 1\n')
    got, want = tpsf.read_coo(str(tmp_path / 'stars.coo')), jpsf.read_coo(
        str(tmp_path / 'stars.coo'))
    assert got.equals(want) and list(got.columns)[:2] == ['x', 'y']
    if tnative.available():
        assert np.abs(tnative.render_matrix(back, 31, local) -
                      back.matrix(31, local)).max() <= 1e-12
        assert np.abs(tnative.local_coeffs(back, 300.0, -40.0) -
                      local).max() <= 1e-12


def test_fit_psf_model_equals_the_jax_package():
    """Stars rendered from a seeded model on a 3x3 grid: both packages fit
    the same coefficients, and the fit renders the truth's PSF."""
    from tpu_sgp.psf import FitStar as JaxStar
    from tpu_sgp.psf import fit_psf_model as jfit
    truth = seeded_diapl_model(1)
    stars = []
    for dy in (-100.0, 0.0, 100.0):
        for dx in (-100.0, 0.0, 100.0):
            xf, yf = truth.x_orig + dx, truth.y_orig + dy
            stars.append((truth.matrix(31, truth.local_coeffs(xf, yf)), xf,
                          yf))
    kw = dict(sigma_inc=truth.sigma_inc, scale_iters=1)
    got = tpsf.fit_psf_model([tpsf.FitStar(*s) for s in stars], **kw)
    want = jfit([JaxStar(*s) for s in stars], **kw)
    np.testing.assert_array_equal(got.vec_coeffs, want.vec_coeffs)
    assert (got.ax, got.ay, got.cos) == (want.ax, want.ay, want.cos)
    at = truth.local_coeffs(truth.x_orig + 50.0, truth.y_orig - 50.0)
    fit_at = got.local_coeffs(truth.x_orig + 50.0, truth.y_orig - 50.0)
    ref = truth.normalized_matrix(31, at)
    assert np.abs(got.normalized_matrix(31, fit_at) - ref).max() <= \
        1e-3 * ref.max()


# ---- metrics/__init__.py ------------------------------------------------------

def test_metrics_equal_the_jax_package():
    from tpu_sgp import metrics as jm
    image, _, _ = synthetic_star_field(64, 64, n_stars=3, seed=9)
    prof = tmetrics.radial_profile(image - 100.0, (31.5, 30.0))
    assert prof == jm.radial_profile(image - 100.0, (31.5, 30.0))
    got = tmetrics.fit_radprof(prof, {'fwhm': np.array([2.8])})
    want = jm.fit_radprof(prof, {'fwhm': np.array([2.8])})
    np.testing.assert_array_equal(got.fitted, want.fitted)
    assert got.ok == want.ok
    assert tmetrics.wasserstein_distance_norm(got.fitted, prof) == \
        jm.wasserstein_distance_norm(want.fitted, prof)
    assert tmetrics.relative_error(image, image + 1.0) == jm.relative_error(
        image, image + 1.0)
    rms = np.full(image.shape, 2.0)
    assert tmetrics.validation_source(image, (20, 20), image * 0 + 100.0,
                                      rms, size=16) == jm.validation_source(
        image, (20, 20), image * 0 + 100.0, rms, size=16)
