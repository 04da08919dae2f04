"""The port's fpack tile compression (``image/tile_compression.py`` with
the RICE_1 codec ``native/rice.cpp``) against the JAX package: the copied
source pinned line for line below its loader, the C++ codec byte for byte
(but for one comment's path) and built under ``build/``, files written by the two packages byte-equal
for every supported compression, and each package reading the other's
files bit for bit. The inputs are those of ``tests/test_tile_compression.py``.
"""
import numpy as np
import pytest

from tpu_sgp_torch import image as timage
from tpu_sgp_torch.image import tile_compression as ttc

from _torch_source_pin import _REFERENCE, REPO, normalised


def _outside_loader(path):
    """The normalised lines of ``path`` without the codec's loader (from
    ``_NATIVE_DIR`` to ``rice_native_available``), which differs: the port
    builds the library under ``build/``."""
    lines = normalised(path)
    start = next(i for i, s in enumerate(lines) if s.startswith('_NATIVE_DIR'))
    end = next(i for i, s in enumerate(lines)
               if s.startswith('def rice_native_available'))
    fs = [s for s in lines[start:end] if s.startswith('_FS_PARAMS')]
    return lines[:start] + fs + lines[end:]


@pytest.mark.parametrize('name', ['image/tile_compression.py',
                                  'psf/pipeline.py', 'preprocess.py',
                                  'catalog/plotting.py'])
def test_copied_source_equals_the_jax_package(name):
    got = _outside_loader if name.startswith('image/') else normalised
    want = got(f'tpu_sgp/{name}')
    assert len(want) > 20
    assert got(f'tpu_sgp_torch/{name}') == want, name


def test_rice_codec_is_a_byte_for_byte_copy():
    """Byte for byte, but for the spelling of the one path into the
    reference's checkout, which the copy names as "the reference's"."""
    copy, original = ((REPO / f'tpu_sgp{pkg}/native/rice.cpp').read_text()
                      for pkg in ('_torch', ''))
    assert copy != original
    assert _REFERENCE.sub('', copy) == _REFERENCE.sub('', original)


def test_rice_library_builds_under_the_build_directory():
    if not ttc.rice_native_available():
        pytest.skip('no C++ toolchain: the pure-Python codec runs instead')
    path = ttc._library_path()
    assert path.exists() and REPO / 'build' in path.parents
    assert 'tpu_sgp/native' not in str(path)
    assert path.name != 'libtpusgp_rice.so'
    assert not list((REPO / 'tpu_sgp_torch').rglob('*.so'))


def test_rice_codecs_agree_on_the_hand_made_bitstreams():
    """The JAX test's hand-derived anchors, through the port's native and
    pure-Python codecs, and a smooth, a noisy and an extreme stream of
    each width: equal bytes, equal decodes."""
    const = np.full(70, 1000, np.int16)
    pair = np.array([0, 1], np.int16)
    for arr, want in ((const, b'\x03\xe8\x00\x00'), (pair, b'\x00\x00\x19')):
        assert ttc._rice_encode_py(arr, 32) == want
        np.testing.assert_array_equal(
            ttc._rice_decode_py(want, arr.size, 2, 32).view(np.int16), arr)
        if ttc.rice_native_available():
            assert ttc.rice_encode(arr, blocksize=32) == want
            np.testing.assert_array_equal(
                ttc.rice_decode(want, arr.size, 2, 32).view(np.int16), arr)
    if not ttc.rice_native_available():
        return
    rng = np.random.default_rng(42)
    for dtype, bytepix in ((np.int16, 2), (np.int32, 4), (np.uint8, 1)):
        info = np.iinfo(dtype)
        for arr in (np.cumsum(rng.integers(-3, 4, 1000)).astype(dtype),
                    rng.integers(info.min, int(info.max) + 1,
                                 777).astype(dtype),
                    np.array([info.min, info.max] * 40, dtype)):
            enc = ttc.rice_encode(arr, blocksize=32)
            assert enc == ttc._rice_encode_py(arr, 32)
            np.testing.assert_array_equal(
                ttc.rice_decode(enc, arr.size, bytepix, 32),
                ttc._rice_decode_py(enc, arr.size, bytepix, 32))
    with pytest.raises(ValueError):
        ttc.rice_decode(b'', 10, bytepix=2)


def _image(kind, rng):
    if kind == 'int16':
        return rng.normal(1000, 50, (37, 23)).astype(np.int16)
    if kind == 'uint16':
        return rng.integers(0, 65536, (16, 31)).astype(np.uint16)
    if kind == 'int32':
        return rng.normal(800, 30, (12, 18)).astype(np.int32)
    if kind == 'uint8':
        return rng.integers(0, 256, (19, 27)).astype(np.uint8)
    return rng.normal(500.0, 60.0, (40, 40)).astype(np.float32)


CASES = ([('RICE_1', k, None) for k in ('int16', 'uint16', 'int32',
                                         'uint8')]
         + [(c, k, None) for c in ('GZIP_1', 'GZIP_2')
            for k in ('int16', 'uint16', 'int32')]
         + [('GZIP_1', 'float32', None), ('GZIP_2', 'float32', None),
            ('RICE_1', 'float32', 0.05)])


@pytest.mark.parametrize('comp,kind,q', CASES)
def test_files_are_byte_equal_and_cross_between_the_packages(
        tmp_path, comp, kind, q):
    """``write_fits_compressed`` of either package writes the same bytes;
    each ``read_fits`` reads both files with the header's cards, bit for
    bit (within ``q / 2`` for quantised floats)."""
    from tpu_sgp import image as jimage
    data = _image(kind, np.random.default_rng(42))
    hdr = {'GAIN': 1.22, 'OBJECT': 'M13'}
    paths = {}
    for name, mod in (('port', timage), ('jax', jimage)):
        paths[name] = str(tmp_path / f'{name}.fits')
        mod.write_fits_compressed(paths[name], data, mod.Header(hdr),
                                  compression=comp, tile_rows=5,
                                  quantize_scale=q)
    assert (open(paths['port'], 'rb').read() ==
            open(paths['jax'], 'rb').read())
    jback, _ = jimage.read_fits(paths['port'])
    for path in paths.values():
        back, h = timage.read_fits(path)
        assert back.dtype == jback.dtype
        np.testing.assert_array_equal(back, jback)
        assert (h['GAIN'], h['OBJECT']) == (1.22, 'M13')
        if q is None:
            assert back.dtype == data.dtype
            np.testing.assert_array_equal(back, data)
        else:
            assert np.abs(back - data).max() <= q / 2 + 1e-6


def test_explicit_hdu_and_wcs_carry_between_the_packages(tmp_path):
    from tpu_sgp import image as jimage
    rng = np.random.default_rng(42)
    img = rng.normal(800, 30, (12, 18)).astype(np.int32)
    hdr = {'CRPIX1': 5.0, 'CRPIX2': 6.0, 'CRVAL1': 150.0, 'CRVAL2': 2.25,
           'CD1_1': -2.8e-4, 'CD2_2': 2.8e-4, 'CTYPE1': 'RA---TAN',
           'CTYPE2': 'DEC--TAN'}
    for writer, reader in ((timage, jimage), (jimage, timage)):
        path = str(tmp_path / f'{writer.__name__}.fits')
        writer.write_fits_compressed(path, img, writer.Header(hdr),
                                     tile_rows=12)
        back, h = reader.read_fits(path, hdu=1)
        np.testing.assert_array_equal(back, img)
        ra, dec = reader.WCS(h).pixel_to_world(4.0, 5.0)
        np.testing.assert_allclose((ra, dec), (150.0, 2.25), atol=1e-12)


def test_dither_and_plio_raise_as_in_the_jax_package(tmp_path):
    """Subtractive dithering and PLIO_1 raise the same exception, with the
    same message, in both readers; lossless float RICE in both writers."""
    from tpu_sgp import image as jimage
    from tpu_sgp_torch.image.fitsio import _format_card
    rng = np.random.default_rng(42)
    img = rng.normal(0, 1, (8, 8)).astype(np.float32)
    path = str(tmp_path / 'd.fits')
    timage.write_fits_compressed(path, img, compression='RICE_1',
                                 quantize_scale=0.1)
    raw = open(path, 'rb').read()

    def patched(key, value):
        at = raw.index(key.ljust(8).encode())
        return raw[:at] + _format_card(key, value) + raw[at + 80:]

    for key, value in (('ZQUANTIZ', 'SUBTRACTIVE_DITHER_1'),
                       ('ZCMPTYPE', 'PLIO_1')):
        open(path, 'wb').write(patched(key, value))
        errors = []
        for mod in (timage, jimage):
            with pytest.raises(Exception) as info:
                mod.read_fits(path)
            errors.append((type(info.value), str(info.value)))
        assert errors[0] == errors[1] and errors[0][0] is ValueError
    errors = []
    for mod in (timage, jimage):
        with pytest.raises(ValueError) as info:
            mod.write_fits_compressed(str(tmp_path / 'x.fits'), img,
                                      compression='RICE_1')
        errors.append(str(info.value))
    assert errors[0] == errors[1]
