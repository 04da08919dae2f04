"""The port's command line (``tpu_sgp_torch/cli.py``) against the JAX
package's on the CPU: the same FITS inputs, whole-image mode in float64
with each of its flags, and subdivision mode; the same files written,
byte-equal CSV headers, equal iterations, restorations within 1e-9 and
catalogs within 1e-6.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_sgp_torch import cli as tcli
from tpu_sgp_torch.image import Header, write_fits
from tpu_sgp_torch.simulate import synthetic_star_field

# torch on one thread a test (the fixture says why)
from test_torch_workloads import _one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = {'plain': [], 'beta': ['--use_beta_div', '--initial_beta', '1.01'],
         'add_bkg': ['--add_bkg_to_deconvolved'],
         'scale_psf': ['--scale_psf', '--psf_scale_fwhm', '2.0'],
         'flip': ['--flip_image']}


def _inputs(tmp_path, size=96, n_stars=8, seed=14, wcs=False):
    image, psf, _ = synthetic_star_field(size, size, n_stars=n_stars,
                                         seed=seed)
    cards = {'GAIN': 1.0, 'SATURATE': 65000.0}
    if wcs:
        c = size / 2.0
        cards.update({'CRPIX1': c, 'CRPIX2': c, 'CRVAL1': 250.0,
                      'CRVAL2': 36.0, 'CD1_1': -2.8e-4, 'CD2_2': 2.8e-4,
                      'CTYPE1': 'RA---TAN', 'CTYPE2': 'DEC--TAN'})
    img_path, psf_path = str(tmp_path / 'sci.fits'), str(tmp_path / 'psf.fits')
    write_fits(img_path, image, Header(cards))
    write_fits(psf_path, psf, Header({'FWHM': 2.8}))
    return ['--data_path_sciimg', img_path, '--data_path_psf', psf_path,
            '--dtype', 'float64']


def _both(tmp_path, args):
    from tpu_sgp import cli as jcli
    want = jcli.main(args + ['--output_dir', str(tmp_path / 'jax')])
    got = tcli.main(args + ['--output_dir', str(tmp_path / 'port'),
                            '--device', 'cpu'])
    names = sorted(os.listdir(tmp_path / 'port'))
    assert names == sorted(os.listdir(tmp_path / 'jax'))
    for name in names:
        if name.endswith('.csv'):
            heads = [(tmp_path / d / name).read_bytes().split(b'\n')[0]
                     for d in ('port', 'jax')]
            assert heads[0] == heads[1], name
    return got, want


# second-moment shape columns: on a segment of one or two pixels (the
# deconvolved catalog detects at n_pixels=1) or a round one, the moments
# are degenerate and these follow rounding (orientation of a round spike
# flips by 90 degrees on a 1e-13 change of the image), so they are held on
# the rows whose moments are well conditioned
SHAPE = ('semimajor_sigma', 'semiminor_sigma', 'orientation', 'eccentricity',
         'ellipticity', 'fwhm')


def _catalogs_equal(got, want):
    """The original catalogs (same input image, host code) equal; the
    deconvolved ones with equal rows and columns within 1e-6 of each
    column's largest value."""
    g, w = got['orig_catalog'], want['orig_catalog']
    assert len(w) > 0 and list(g.columns) == list(w.columns)
    for col in w.columns:
        np.testing.assert_array_equal(g[col].to_numpy(np.float64),
                                      w[col].to_numpy(np.float64))
    g, w = got['deconv_catalog'], want['deconv_catalog']
    assert len(g) == len(w) > 0 and list(g.columns) == list(w.columns)
    major = w['semimajor_sigma'].to_numpy(np.float64)
    minor = w['semiminor_sigma'].to_numpy(np.float64)
    conditioned = (minor > 0.1) & (major - minor > 1e-2 * major)
    for col in w.columns:
        a = g[col].to_numpy(np.float64)
        b = w[col].to_numpy(np.float64)
        rows = ~np.isnan(b) & (conditioned if col in SHAPE else True)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        scale = np.abs(b[rows]).max(initial=1.0)
        assert np.abs(a[rows] - b[rows]).max(initial=0.0) <= 1e-6 * scale, col


@pytest.mark.parametrize('flag', list(FLAGS))
def test_whole_image_matches_jax(tmp_path, monkeypatch, flag):
    # the artificial sky of --add_bkg_to_deconvolved is drawn from this seed
    monkeypatch.setenv('GUIDE_RANDOM_SEED', '3')
    got, want = _both(tmp_path, _inputs(tmp_path) + FLAGS[flag])
    assert got['iters'] == want['iters'] >= 1
    d, w = got['deconvolved'], np.asarray(want['deconvolved'])
    assert d.shape == w.shape == (96, 96)
    assert np.abs(d - w).max() <= 1e-9 * np.abs(w).max()
    _catalogs_equal(got, want)


def test_subdivision_mode_matches_jax(tmp_path):
    """``--use_subdiv``: one batch of per-tile restorations, coadded; the
    world coordinates come from each tile's WCS."""
    args = _inputs(tmp_path, size=128, n_stars=16, seed=11, wcs=True)
    got, want = _both(tmp_path, args + ['--use_subdiv', '--subdivision_size',
                                        '64', '--subdiv_overlap', '8'])
    assert got['iters'] == want['iters'] >= 1
    d, w = got['deconvolved'], np.asarray(want['deconvolved'])
    assert np.abs(d - w).max() <= 1e-9 * np.abs(w).max()
    assert (tmp_path / 'port' / 'subdiv_deconvolved_sci.fits').exists()
    _catalogs_equal(got, want)
    assert np.isfinite(got['deconv_catalog']['X_WORLD']).all()


def test_python_dash_m_runs_the_cli(tmp_path):
    args = _inputs(tmp_path, size=48, n_stars=3, seed=5)
    proc = subprocess.run(
        [sys.executable, '-m', 'tpu_sgp_torch.cli', *args, '--device', 'cpu',
         '--output_dir', str(tmp_path / 'out')],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS='1'))
    assert proc.returncode == 0, proc.stderr
    assert 'No. of objects (deconvolved)' in proc.stdout
    assert (tmp_path / 'out' / 'deconvolved_sci.fits').exists()


def test_port_console_scripts_resolve():
    """``pyproject.toml`` names the port's CLI, frame culling and four
    workloads beside the JAX package's scripts, each the JAX one's
    counterpart."""
    import importlib
    import tomllib
    with open(os.path.join(REPO, 'pyproject.toml'), 'rb') as f:
        scripts = tomllib.load(f)['project']['scripts']
    port = {k: v for k, v in scripts.items() if v.startswith('tpu_sgp_torch')}
    assert sorted(port) == ['tpu-sgp-torch', 'tpu-sgp-torch-cull',
                            'tpu-sgp-torch-simulate',
                            'tpu-sgp-torch-spatial', 'tpu-sgp-torch-stamps',
                            'tpu-sgp-torch-subdiv']
    for name, target in port.items():
        module, attr = target.split(':')
        assert callable(getattr(importlib.import_module(module), attr)), name
        jax_name = name.replace('-torch', '')
        assert scripts[jax_name] == target.replace('tpu_sgp_torch', 'tpu_sgp')


def test_cli_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('this host has a CUDA device')
    args = _inputs(tmp_path, size=48, n_stars=3, seed=5)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tcli.main(args + ['--output_dir', str(tmp_path / 'out')])
