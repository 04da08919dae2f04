"""The port's FITS module and ``save=True`` against the JAX package: the
copied source pinned line for line, files that cross between the packages
in both directions, and the per-iteration dump pixel for pixel in float64.
"""
import numpy as np
import pytest

import tpu_sgp_torch as tsgp
from tpu_sgp_torch import image as timage
from tpu_sgp_torch.simulate import synthetic_star_field

from _torch_source_pin import assert_copy_equal

BKG = 150.0


def test_fitsio_source_equals_the_jax_package():
    assert_copy_equal('tpu_sgp_torch/image/fitsio.py',
                      'tpu_sgp/image/fitsio.py')


def test_image_package_exports_what_is_ported():
    assert sorted(timage.__all__) == sorted(
        ['read_fits', 'write_fits', 'writeto', 'getdata', 'getheader',
         'Header', 'set_header_card', 'WCS', 'pixel_to_skycoord',
         'Cutout2D', 'calculate_slice_bboxes', 'create_subdivisions',
         'tile_origins', 'coadd_tiles', 'match_backgrounds',
         'reconstruct_full_image_from_patches', 'reproject_and_coadd',
         'reproject_to_grid'])
    from tpu_sgp import image as jimage
    assert set(timage.__all__) <= set(jimage.__all__)


@pytest.mark.parametrize('dtype', ['uint8', 'int16', 'uint16', 'int32',
                                   'int64', 'float32', 'float64'])
@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_fits_files_cross_between_the_packages(tmp_path, dtype, writer):
    """A file written by either package reads back bit-equal, with its
    header cards, in the other (and in itself)."""
    from tpu_sgp import image as jimage
    rng = np.random.default_rng(3)
    data = (rng.uniform(0, 200, (9, 13)).astype(dtype) if dtype != 'uint16'
            else rng.integers(0, 65535, (9, 13)).astype(dtype))
    path = str(tmp_path / 'a.fits')
    wmod, rmod = ((timage, jimage) if writer == 'port'
                  else (jimage, timage))
    wmod.write_fits(path, data, header={'EXPTIME': 30.5, 'OBJECT': 'M13',
                                        'NCOMBINE': 4})
    for mod in (rmod, wmod):
        back, hdr = mod.read_fits(path)
        assert back.dtype == data.dtype
        np.testing.assert_array_equal(back, data)
        assert (hdr['EXPTIME'], hdr['OBJECT'], hdr['NCOMBINE']) == (
            30.5, 'M13', 4)


def test_set_header_card_edits_in_place(tmp_path):
    path = str(tmp_path / 'b.fits')
    data = np.arange(12.0).reshape(3, 4)
    timage.writeto(path, data, header={'GAIN': 1.5})
    timage.set_header_card(path, 'GAIN', 2.0, comment='e-/ADU')
    assert timage.getheader(path)['GAIN'] == 2.0
    np.testing.assert_array_equal(timage.getdata(path), data)
    with pytest.raises(OSError, match='overwrite=False'):
        timage.writeto(path, data, overwrite=False)


@pytest.mark.parametrize('entry,kw', [
    ('sgp', {}),
    ('sgp_beta_div', dict(adapt_beta=True, schedule_lr=True))])
def test_save_writes_the_jax_packages_files(tmp_path, monkeypatch, entry, kw):
    """``save=True`` in float64 on a 32x24 frame, three iterations: the
    same file names as the JAX package writes, pixels within 1e-9 of
    max|pixel| (the two solvers agree to roundoff, not bit for bit), and
    the last reconstruction in working units is the returned x."""
    import tpu_sgp
    img, psf, _ = synthetic_star_field(32, 24, n_stars=6, psf_size=9,
                                       fwhm=2.5, seed=4)
    args = dict(init_recon=2, proj_type=1, stop_criterion=1, MAXIT=3,
                save=True, dtype='float64', verbose=False, **kw)
    dirs = {}
    for name, mod, extra in (('jax', tpu_sgp, {}),
                             ('port', tsgp, dict(device='cpu'))):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        x, iters, *_ = getattr(mod, entry)(img, psf, BKG, **args, **extra)
        assert iters == 3
        dirs[name] = tmp_path / name / 'SGP_reconstructed_images'
    names = sorted(f.name for f in dirs['jax'].iterdir())
    assert names == sorted(f.name for f in dirs['port'].iterdir())
    assert names == ['orig.fits'] + [f'{k}_{i}.fits' for k in ('rec', 'res')
                                     for i in (1, 2, 3)]
    for name in names:
        want = timage.getdata(str(dirs['jax'] / name))
        got = timage.getdata(str(dirs['port'] / name))
        assert got.dtype == want.dtype and got.shape == img.shape
        assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max(), name
    # the solver returns the iterate before the last, unscaled
    rec = timage.getdata(str(dirs['port'] / 'rec_2.fits'))
    np.testing.assert_allclose(rec * img.max(), x, rtol=1e-12)


def test_save_on_a_batch_leaves_the_last_running_lanes_images(
        tmp_path, monkeypatch):
    """More than one image with ``save=True``: every running lane writes
    the same names in lane order, so the files hold the last lane."""
    from tpu_sgp_torch.simulate import synthetic_star_stamps
    monkeypatch.chdir(tmp_path)
    stamps, psf, bkgs, _ = synthetic_star_stamps(3, size=16, seed=2)
    cfg = tsgp.SGPConfig(max_iter=2, stop_criterion=1, init_recon=2,
                         dtype='float64', has_flux=False, save=True)
    res = tsgp.restore_stamps(stamps, psf, bkgs, cfg, device='cpu')
    rec = timage.getdata(str(tmp_path / 'SGP_reconstructed_images'
                             / 'rec_1.fits'))
    np.testing.assert_allclose(rec * stamps[2].max(), res.x[2].numpy(),
                               rtol=1e-12)
