"""The port's PSF-estimation pipeline (``psf/pipeline.py``), calibration-
frame culling (``preprocess.py``) and ``plot_positions``
(``catalog/plotting.py``) against the JAX package on the seeded inputs of
``tests/test_pipeline_preprocess.py``, ``tests/test_psf_fit.py`` and
``tests/test_api_surface.py``: equal star lists, PSF models and written
files, equal culling reports and headers, equal ellipses. The copied
sources are pinned in ``tests/test_torch_tile_compression.py``.
"""
import os
import shutil

import numpy as np
import pytest

from tpu_sgp_torch import preprocess as tpre
from tpu_sgp_torch.image import Header, write_fits
from tpu_sgp_torch.psf import pipeline as tpipe
from tpu_sgp_torch.simulate import synthetic_star_field


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """The PSF fit makes thousands of small least-squares solves: with
    several test workers on a few cores, a multi-threaded BLAS makes each
    wait on its threads (a test ten times slower). One thread here."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(limits=1, user_api='blas'):
        yield


def _equal_stars(got, want):
    assert got.dtype == want.dtype and len(got) == len(want)
    for name in want.dtype.names:
        np.testing.assert_array_equal(got[name], want[name], name)


def test_sky_fwhm_and_star_lists_equal_the_jax_package():
    from tpu_sgp.psf import pipeline as jpipe
    img, _, _ = synthetic_star_field(256, 256, n_stars=25, fwhm=3.0, seed=3,
                                     bkg=200.0, flux_range=(3e4, 9e4))
    got, want = (tpipe.estimate_sky_and_fwhm(img),
                 jpipe.estimate_sky_and_fwhm(img))
    assert got == want and abs(got[0] - 200.0) < 10.0
    img, _, _ = synthetic_star_field(200, 200, n_stars=20, seed=8,
                                     flux_range=(3e4, 9e4))
    stars = tpipe.find_stars(img)
    assert 12 <= len(stars) <= 25
    _equal_stars(stars, jpipe.find_stars(img))
    _equal_stars(tpipe.select_psf_stars(img, stars, hw=15),
                 jpipe.select_psf_stars(img, stars, hw=15))

    hand = np.array(
        [(50.0, 50.0, 5000.0, 40.0, 0), (20.0, 20.0, 1000.0, 40.0, 0),
         (80.0, 20.0, 3000.0, 40.0, 1), (5.0, 50.0, 2000.0, 40.0, 0),
         (80.0, 80.0, 50.0, 40.0, 0), (48.0, 52.0, 4000.0, 40.0, 0)],
        dtype=stars.dtype)
    for rows in (hand, hand[:5]):
        sel = tpipe.select_psf_stars(np.zeros((100, 100)), rows, hw=15,
                                     min_flux=100.0)
        _equal_stars(sel, jpipe.select_psf_stars(np.zeros((100, 100)), rows,
                                                 hw=15, min_flux=100.0))
    assert list(sel['approx_flux']) == [5000.0, 1000.0]
    assert [len(c.data) for c, _ in tpipe.cut_subframes(img, nx=2, ny=5)] \
        == [len(c.data) for c, _ in jpipe.cut_subframes(img, nx=2, ny=5)]


def test_psf_estimation_equals_the_jax_package(tmp_path):
    """``psf_estimation`` over a 2x2 grid of a seeded 256x512 field: the
    same sub-frames, coefficients within 1e-12, byte-equal ``.bin.txt`` and
    ``.coo`` files, ``_img.fits`` matrices within 1e-12; the port's files
    read back through its own ``read_coo`` and ``read_fits``."""
    from tpu_sgp.psf import pipeline as jpipe
    from tpu_sgp_torch.image import read_fits
    from tpu_sgp_torch.psf import read_coo
    img, _, _ = synthetic_star_field(256, 512, n_stars=48, fwhm=2.8,
                                     flux_range=(2e4, 8e4), seed=21)
    kw = dict(nx=2, ny=2, max_stars=4, scale_iters=1, name='f')
    got = tpipe.psf_estimation(img, out_dir=str(tmp_path / 'port'), **kw)
    want = jpipe.psf_estimation(img, out_dir=str(tmp_path / 'jax'), **kw)
    assert sorted(got) == sorted(want) and len(got) >= 3
    for key, model in got.items():
        np.testing.assert_allclose(model.vec_coeffs, want[key].vec_coeffs,
                                   rtol=1e-12, atol=0)
    names = sorted(os.listdir(tmp_path / 'port'))
    assert names == sorted(os.listdir(tmp_path / 'jax'))
    assert len(names) == 3 * len(got)
    for name in names:
        port, jax = tmp_path / 'port' / name, tmp_path / 'jax' / name
        if name.endswith('_img.fits'):
            psf, _ = read_fits(str(port))
            assert psf.shape == (31, 31) and abs(psf.sum() - 1) < 1e-9
            np.testing.assert_allclose(psf, read_fits(str(jax))[0],
                                       rtol=0, atol=1e-12)
        else:
            assert port.read_bytes() == jax.read_bytes(), name
        if name.endswith('.coo'):
            assert len(read_coo(str(port))) >= 1


def _calibration_frames(directory):
    """The JAX tests' culling inputs in one directory: four biases (one
    with 3x the noise), two flats (one nearly saturated), a science frame
    without FILTER and one with a HISTORY card."""
    rng = np.random.default_rng(42)
    for i, scale in enumerate([1.0, 1.1, 0.9, 3.0]):
        write_fits(os.path.join(directory, f'bias_{i}.fits'),
                   rng.normal(100, 5 * scale, (32, 32)),
                   Header({'EXPTIME': 0.0}))
    for name, level in (('flat_good', 30000), ('flat_bad', 60000)):
        write_fits(os.path.join(directory, f'{name}.fits'),
                   rng.normal(level, 100, (32, 32)),
                   Header({'EXPTIME': 2.0, 'IMAGETYP': 'flat'}))
    write_fits(os.path.join(directory, 'sci_1.fits'),
               rng.normal(500, 10, (16, 16)).astype(np.float32),
               Header({'EXPTIME': 30.0}))
    path = os.path.join(directory, 'sci_2.fits')
    write_fits(path, rng.normal(500, 10, (16, 16)), Header({'EXPTIME': 30.0}))
    raw = open(path, 'rb').read()
    end_at = raw.index(b'END     ')
    card = 'HISTORY archival provenance'.ljust(80).encode()
    open(path, 'wb').write(raw[:end_at] + card + raw[end_at:end_at + 80]
                           + raw[end_at + 2 * 80:])


def _report(rep, directory):
    rel = lambda ps: [os.path.relpath(p, directory) for p in ps]
    return (rel(rep.biases), rel(rep.flats), rel(rep.bad_biases),
            rel(rep.bad_flats),
            {os.path.relpath(p, directory): f
             for p, f in rep.filter_fixed.items()})


def _tree(directory):
    return {os.path.relpath(os.path.join(root, f), directory):
            open(os.path.join(root, f), 'rb').read()
            for root, _, files in os.walk(directory) for f in files}


def test_cull_frames_equals_the_jax_package(tmp_path):
    """Two copies of one seeded directory: equal reports, the same files
    moved into ``BadFrames/``, and every file byte-equal afterwards (the
    FILTER cards spliced into the same headers)."""
    from tpu_sgp.preprocess import cull_frames
    base = tmp_path / 'base'
    base.mkdir()
    _calibration_frames(str(base))
    port, jax = str(tmp_path / 'port'), str(tmp_path / 'jax')
    shutil.copytree(base, port)
    shutil.copytree(base, jax)
    got = tpre.cull_frames(port, default_filter='R')
    want = cull_frames(jax, default_filter='R')
    assert _report(got, port) == _report(want, jax)
    assert _report(got, port)[2:4] == (['bias_3.fits'], ['flat_bad.fits'])
    assert _tree(port) == _tree(jax)
    assert sorted(os.listdir(os.path.join(port, 'BadFrames'))) == [
        'bias_3.fits', 'flat_bad.fits']
    after = open(os.path.join(port, 'sci_2.fits'), 'rb').read()
    assert b'HISTORY archival provenance' in after and b'FILTER' in after


def test_preprocess_main_prints_the_jax_packages_lines(tmp_path, capsys):
    from tpu_sgp.preprocess import main
    base = tmp_path / 'base'
    base.mkdir()
    _calibration_frames(str(base))
    lines = []
    for name, entry in (('port', tpre.main), ('jax', main)):
        directory = str(tmp_path / name)
        shutil.copytree(base, directory)
        entry([directory, '--default-filter', 'V'])
        lines.append(capsys.readouterr().out.replace(directory, '<dir>'))
    assert lines[0] == lines[1]
    assert 'biases: 4 (rejected 1)' in lines[0]
    assert 'flats: 2 (rejected 1)' in lines[0]
    assert 'FILTER fixed on 4 frames' in lines[0]


def _ellipses(fig):
    return [(tuple(a.center), a.width, a.height, a.angle)
            for a in fig.axes[0].get_children()
            if type(a).__name__ == 'Ellipse']


def test_plot_positions_equals_the_jax_package():
    """The same ellipses (centres, axes, angles in degrees) in both
    packages, on a catalog table and on a sep-style dict (theta in
    radians)."""
    pytest.importorskip('matplotlib')
    import matplotlib.pyplot as plt

    from tpu_sgp.catalog import source_info as jsource_info
    from tpu_sgp.catalog.plotting import plot_positions as jplot
    from tpu_sgp_torch.catalog import source_info
    from tpu_sgp_torch.catalog.plotting import plot_positions

    rng = np.random.default_rng(11)
    img = rng.normal(100.0, 3.0, (64, 64))
    yy, xx = np.mgrid[:64, :64]
    for cx, cy in [(20, 20), (44, 30)]:
        img += 300.0 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 4.0)
    scat, bkg = source_info(img, box_size=(16, 16))
    jscat, jbkg = jsource_info(img, box_size=(16, 16))
    objs = {'x': np.array([10.0, 20.0]), 'y': np.array([12.0, 8.0]),
            'a': np.array([2.0, 1.5]), 'b': np.array([1.0, 1.2]),
            'theta': np.array([np.pi / 4, 0.0])}
    for args, jargs in (((img - bkg.background, scat.to_table()),
                         (img - jbkg.background, jscat.to_table())),
                        ((img, objs), (img, objs))):
        fig, jfig = plot_positions(*args), jplot(*jargs)
        got, want = _ellipses(fig), _ellipses(jfig)
        assert len(got) == len(want) == 2 and got == want
        plt.close(fig)
        plt.close(jfig)
    assert got[0][3] == pytest.approx(45.0)
