"""FITS tiled-image compression (the fpack convention): native read + write.

The reference reads fpack-compressed survey frames for free through
astropy/cfitsio (the reference's sgp.py:944-958). This module
provides the dependency-free equivalent for the compressed-HDU layout
registered as the FITS Tiled Image Compression convention (White et al.):
a ``BINTABLE`` extension with ``ZIMAGE = T`` whose rows are independently
compressed tiles of the image, with variable-length ``COMPRESSED_DATA``
columns pointing into the heap.

Supported on read:
  * ``RICE_1`` (the fpack default) via the native C++ codec
    (``native/rice.cpp``; pure-Python fallback when no toolchain exists)
  * ``GZIP_1`` and ``GZIP_2`` (byte-shuffled gzip)
  * ``NOCOMPRESS``
  * integer images (BITPIX 8/16/32, including the uint16 BZERO=32768
    convention) and float images, both lossless (``ZQUANTIZ='NONE'`` /
    gzip of raw IEEE bytes) and linearly quantized with per-tile
    ``ZSCALE``/``ZZERO`` columns and ``ZQUANTIZ='NO_DITHER'``.
    Subtractive-dither quantization is rejected loudly (it needs
    cfitsio's exact portable RNG sequence to invert), as are
    ``PLIO_1``/``HCOMPRESS_1``.

Supported on write (:func:`write_fits_compressed`): RICE_1 / GZIP_1 /
GZIP_2 for integer data (lossless), GZIP for float data (lossless), and
RICE_1 for float data with an explicit ``quantize_scale`` (lossy,
``NO_DITHER``, error bounded by ``quantize_scale / 2``).
"""
# Host code (NumPy), kept equal to tpu_sgp/image/tile_compression.py:1
from __future__ import annotations

import ctypes
import hashlib
import threading
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

from ..kernels._build import BUILD_DIR

__all__ = ['decompress_tiled_hdu', 'write_fits_compressed', 'rice_encode',
           'rice_decode', 'rice_native_available']

# ---------------------------------------------------------------------------
# RICE_1 codec: native loader + pure-Python fallback
# ---------------------------------------------------------------------------

_NATIVE_DIR = Path(__file__).resolve().parent.parent / 'native'
# the loader builds native/rice.cpp of this package with g++ on first use
# into build/tpu_sgp_torch/ at the root of the checkout, as catalog/native.py
# builds the deblender; below it the module is the JAX package's
_SRC = _NATIVE_DIR / 'rice.cpp'

_lib = None
_load_error: Optional[str] = None
_load_lock = threading.Lock()

_FS_PARAMS = {1: (3, 6), 2: (4, 14), 4: (5, 25)}  # bytepix -> (fsbits, fsmax)


def _library_path() -> Path:
    """The codec's library under the build directory, named by the hash of
    its source (never the JAX package's ``native/libtpusgp_rice.so``)."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f'librice-{digest}.so'


# tpu_sgp/image/tile_compression.py:71
def _load():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    with _load_lock:
        if _lib is not None or _load_error is not None:
            return _lib
        try:
            # the deblender's atomic g++ build (temp file + rename)
            from ..catalog.native import _build_shared
            so = _library_path()
            if not so.exists():
                _build_shared([_SRC], so)
            try:
                lib = ctypes.CDLL(str(so))
            except OSError:
                # a corrupt cached library (an interrupted build): rebuild
                _build_shared([_SRC], so)
                lib = ctypes.CDLL(str(so))
            lib.tpusgp_rice_decode.restype = ctypes.c_int32
            lib.tpusgp_rice_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p,
                ctypes.c_long, ctypes.c_int32, ctypes.c_int32]
            lib.tpusgp_rice_encode.restype = ctypes.c_long
            lib.tpusgp_rice_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_char_p,
                ctypes.c_long, ctypes.c_int32, ctypes.c_int32]
            _lib = lib
        except Exception as exc:  # pragma: no cover - toolchain-dependent
            _load_error = str(exc)
            _lib = None
        return _lib


# tpu_sgp/image/tile_compression.py:101
def rice_native_available() -> bool:
    return _load() is not None


# tpu_sgp/image/tile_compression.py:105
def _zigzag_unmap(d: np.ndarray | int):
    """Rice difference unmapping: even -> d/2, odd -> -(d//2) - 1."""
    return np.where(d & 1, -((d >> 1) + 1), d >> 1)


# tpu_sgp/image/tile_compression.py:110
def _rice_decode_py(buf: bytes, npix: int, bytepix: int,
                    blocksize: int) -> np.ndarray:
    """Bit-serial reference decoder (fallback; the native codec is the
    production path). Returns unsigned integers of width ``bytepix``."""
    fsbits, fsmax = _FS_PARAMS[bytepix]
    bbits = 8 * bytepix
    mask = (1 << bbits) - 1
    if len(buf) < bytepix:
        raise ValueError('RICE stream shorter than its pixel header')
    lastpix = int.from_bytes(buf[:bytepix], 'big')
    # bit cursor over the remaining bytes
    data = int.from_bytes(buf[bytepix:], 'big')
    total_bits = 8 * (len(buf) - bytepix)
    pos = 0

    def get(n):
        nonlocal pos
        if pos + n > total_bits:
            raise ValueError('truncated RICE stream')
        v = (data >> (total_bits - pos - n)) & ((1 << n) - 1)
        pos += n
        return v

    def unary():
        nonlocal pos
        count = 0
        while True:
            if pos >= total_bits:
                raise ValueError('truncated RICE stream')
            if (data >> (total_bits - pos - 1)) & 1:
                pos += 1
                return count
            pos += 1
            count += 1

    out = np.empty(npix, np.uint32)
    i = 0
    while i < npix:
        thisblock = min(blocksize, npix - i)
        fs = get(fsbits) - 1
        if fs < 0:
            out[i:i + thisblock] = lastpix
            i += thisblock
        elif fs >= fsmax:
            for _ in range(thisblock):
                d = get(bbits)
                lastpix = (lastpix + int(_zigzag_unmap(d))) & mask
                out[i] = lastpix
                i += 1
        else:
            for _ in range(thisblock):
                d = (unary() << fs) | (get(fs) if fs else 0)
                lastpix = (lastpix + int(_zigzag_unmap(d))) & mask
                out[i] = lastpix
                i += 1
    return out.astype({1: np.uint8, 2: np.uint16, 4: np.uint32}[bytepix])


# tpu_sgp/image/tile_compression.py:168
def _rice_encode_py(arr: np.ndarray, blocksize: int) -> bytes:
    """Bit-serial reference encoder (fallback)."""
    bytepix = arr.dtype.itemsize
    fsbits, fsmax = _FS_PARAMS[bytepix]
    bbits = 8 * bytepix
    mask = (1 << bbits) - 1
    vals = arr.astype(np.int64) & mask
    out = bytearray(int(vals[0]).to_bytes(bytepix, 'big'))
    acc, nbits = 0, 0

    def put(v, n):
        nonlocal acc, nbits
        acc = (acc << n) | (v & ((1 << n) - 1))
        nbits += n
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xff)
        acc &= (1 << nbits) - 1

    lastpix = int(vals[0])
    i = 0
    npix = len(vals)
    while i < npix:
        block = vals[i:i + blocksize]
        # running delta: each pixel differences against its predecessor
        diffs = np.diff(np.concatenate(([lastpix], block))) % (mask + 1)
        lastpix = int(block[-1])
        signed = np.where(diffs >= (mask + 1) // 2, diffs - (mask + 1),
                          diffs)
        zz = np.where(signed >= 0, signed << 1, (-signed << 1) - 1)
        pixelsum = int(zz.sum())
        dpsum = (pixelsum - len(block) // 2 - 1) // len(block)
        fs = 0
        while dpsum > 0:
            fs += 1
            dpsum >>= 1
        if pixelsum == 0:
            put(0, fsbits)
        elif fs >= fsmax:
            put(fsmax + 1, fsbits)
            for z in zz:
                put(int(z), bbits)
        else:
            put(fs + 1, fsbits)
            for z in zz:
                top = int(z) >> fs
                put(1, top + 1)           # `top` zeros then the 1
                if fs:
                    put(int(z) & ((1 << fs) - 1), fs)
        i += len(block)
    if nbits:
        out.append((acc << (8 - nbits)) & 0xff)
    return bytes(out)


# tpu_sgp/image/tile_compression.py:223
def rice_decode(buf: bytes, npix: int, bytepix: int = 4,
                blocksize: int = 32) -> np.ndarray:
    """Decode a RICE_1 tile into unsigned ints of width ``bytepix``."""
    if bytepix not in _FS_PARAMS:
        raise ValueError(f'RICE BYTEPIX must be 1/2/4, got {bytepix}')
    lib = _load()
    if lib is None:
        return _rice_decode_py(buf, npix, bytepix, blocksize)
    out = np.empty(npix, {1: np.uint8, 2: np.uint16, 4: np.uint32}[bytepix])
    rc = lib.tpusgp_rice_decode(buf, len(buf),
                                out.ctypes.data_as(ctypes.c_void_p),
                                npix, bytepix, blocksize)
    if rc != 0:
        raise ValueError(f'corrupt RICE_1 stream (native rc={rc})')
    return out


# tpu_sgp/image/tile_compression.py:240
def rice_encode(arr: np.ndarray, blocksize: int = 32) -> bytes:
    """Encode integers (any signedness; width 1/2/4 bytes) as RICE_1."""
    arr = np.ascontiguousarray(arr).ravel()
    bytepix = arr.dtype.itemsize
    if bytepix not in _FS_PARAMS:
        raise ValueError(f'RICE needs 1/2/4-byte integers, got {arr.dtype}')
    lib = _load()
    if lib is None or blocksize > 4096:
        return _rice_encode_py(arr, blocksize)
    cap = arr.size * bytepix + arr.size // blocksize + 16
    out = ctypes.create_string_buffer(cap)
    n = lib.tpusgp_rice_encode(arr.ctypes.data_as(ctypes.c_void_p),
                               arr.size, out, cap, bytepix, blocksize)
    if n < 0:
        raise ValueError(f'RICE encode failed (native rc={n})')
    return out.raw[:n]


# ---------------------------------------------------------------------------
# BINTABLE parsing
# ---------------------------------------------------------------------------

_TFORM_SIZES = {'L': 1, 'X': 1, 'B': 1, 'A': 1, 'I': 2, 'J': 4, 'E': 4,
                'K': 8, 'D': 8, 'C': 8, 'M': 16, 'P': 8, 'Q': 16}


# tpu_sgp/image/tile_compression.py:266
def _parse_columns(hdr):
    """Column layout: name -> (byte offset in row, repeat, type code)."""
    cols = {}
    off = 0
    for i in range(1, int(hdr.get('TFIELDS', 0)) + 1):
        tform = str(hdr[f'TFORM{i}']).strip()
        j = 0
        while j < len(tform) and tform[j].isdigit():
            j += 1
        repeat = int(tform[:j]) if j else 1
        code = tform[j].upper()
        name = str(hdr.get(f'TTYPE{i}', f'COL{i}')).strip().upper()
        cols[name] = (off, repeat, code)
        off += repeat * _TFORM_SIZES[code]
    return cols, off


# tpu_sgp/image/tile_compression.py:283
def _descriptor(row: bytes, col) -> tuple:
    """(count, heap offset) of a variable-length P/Q column in a row."""
    off, _repeat, code = col
    if code == 'P':
        return tuple(np.frombuffer(row[off:off + 8], '>i4'))
    if code == 'Q':
        return tuple(np.frombuffer(row[off:off + 16], '>i8'))
    raise ValueError(f'column is not variable-length (TFORM code {code})')


# tpu_sgp/image/tile_compression.py:293
def _scalar(row: bytes, col) -> float:
    off, _repeat, code = col
    dt = {'D': '>f8', 'E': '>f4', 'J': '>i4', 'K': '>i8', 'I': '>i2'}[code]
    return float(np.frombuffer(row, dt, count=1, offset=off)[0])


# tpu_sgp/image/tile_compression.py:299
def _zname_params(hdr) -> dict:
    out = {}
    for i in range(1, 10):
        name = hdr.get(f'ZNAME{i}')
        if name is None:
            break
        out[str(name).strip().upper()] = hdr.get(f'ZVAL{i}')
    return out


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------

# tpu_sgp/image/tile_compression.py:313
def _inflate_tile(comp: bytes, gzip_comp: bytes, cmptype: str, npix: int,
                  bytepix: int, blocksize: int, stored_dtype) -> np.ndarray:
    """One tile's stored (pre-dequantization) values, native byte order."""
    if not comp and gzip_comp:
        # fpack's fallback column for tiles that did not compress: gzip of
        # the raw big-endian pixels
        raw = zlib.decompress(gzip_comp, 47)
        return np.frombuffer(raw, stored_dtype.newbyteorder('>'),
                             count=npix).astype(stored_dtype)
    if cmptype == 'RICE_1':
        u = rice_decode(comp, npix, bytepix, blocksize)
        return u.view(np.dtype(f'i{bytepix}')).astype(stored_dtype)
    if cmptype in ('GZIP_1', 'GZIP_2'):
        raw = zlib.decompress(comp, 47)
        itemsize = stored_dtype.itemsize
        if cmptype == 'GZIP_2':
            # byte-shuffled: all most-significant bytes first
            shuf = np.frombuffer(raw, np.uint8, count=npix * itemsize)
            raw = shuf.reshape(itemsize, npix).T.tobytes()
        return np.frombuffer(raw, stored_dtype.newbyteorder('>'),
                             count=npix).astype(stored_dtype)
    if cmptype == 'NOCOMPRESS':
        return np.frombuffer(comp, stored_dtype.newbyteorder('>'),
                             count=npix).astype(stored_dtype)
    raise ValueError(f'unsupported ZCMPTYPE {cmptype!r} (RICE_1, GZIP_1, '
                     f'GZIP_2 and NOCOMPRESS are implemented)')


# tpu_sgp/image/tile_compression.py:341
def decompress_tiled_hdu(f, hdr):
    """Decompress a ZIMAGE BINTABLE HDU; ``f`` is positioned at its data.

    Returns ``(data, header)`` where ``header`` is the reconstructed image
    header (Z-keys and table keys stripped, BITPIX/NAXISn restored) —
    matching what :func:`read_fits` returns for a plain image HDU,
    including the uint16 BZERO convention and BSCALE/BZERO scaling.
    """
    from .fitsio import Header

    cmptype = str(hdr.get('ZCMPTYPE', 'RICE_1')).strip().upper()
    zbitpix = int(hdr['ZBITPIX'])
    znaxis = int(hdr['ZNAXIS'])
    if znaxis != 2:
        raise ValueError(f'only 2-D tiled images supported (ZNAXIS={znaxis})')
    n1 = int(hdr['ZNAXIS1'])
    n2 = int(hdr['ZNAXIS2'])
    t1 = int(hdr.get('ZTILE1', n1))
    t2 = int(hdr.get('ZTILE2', 1))
    quantiz = str(hdr.get('ZQUANTIZ', 'NO_DITHER')).strip().upper()
    if quantiz.startswith('SUBTRACTIVE_DITHER'):
        raise ValueError(
            f'ZQUANTIZ={quantiz!r} (dithered quantization) is not '
            'supported by the native reader — it requires cfitsio\'s '
            'exact dither RNG sequence; funpack the file first')
    params = _zname_params(hdr)
    blocksize = int(params.get('BLOCKSIZE', 32) or 32)
    bytepix = int(params.get('BYTEPIX', 4) or 4)

    nrows = int(hdr['NAXIS2'])
    row_w = int(hdr['NAXIS1'])
    pcount = int(hdr.get('PCOUNT', 0))
    theap = int(hdr.get('THEAP', row_w * nrows))
    blob = f.read(-(-(row_w * nrows + pcount) // 2880) * 2880)
    table, heap = blob[:row_w * nrows], blob[theap:theap + pcount]

    cols, _w = _parse_columns(hdr)
    if 'COMPRESSED_DATA' not in cols:
        raise ValueError('ZIMAGE table has no COMPRESSED_DATA column')

    ntx, nty = -(-n1 // t1), -(-n2 // t2)
    if nrows != ntx * nty:
        raise ValueError(f'tile table has {nrows} rows, expected '
                         f'{ntx}x{nty} tiles')

    # stored (pre-dequantization) element type
    float_img = zbitpix < 0
    quantized = float_img and ('ZSCALE' in cols or 'ZSCALE' in hdr)
    if float_img and not quantized:
        stored = np.dtype(f'f{abs(zbitpix) // 8}')
    elif float_img:
        stored = np.dtype('i4')
    else:
        stored = np.dtype(f'i{zbitpix // 8}') if zbitpix > 8 \
            else np.dtype('u1')
    if cmptype == 'RICE_1' and float_img and not quantized:
        raise ValueError('RICE_1 tiles of float data require ZSCALE/ZZERO '
                         'quantization columns')

    out = np.empty((n2, n1),
                   np.float64 if quantized else stored)
    zblank_hdr = hdr.get('ZBLANK')
    for ty in range(nty):
        for tx in range(ntx):
            r = ty * ntx + tx
            row = table[r * row_w:(r + 1) * row_w]
            cnt, offs = _descriptor(row, cols['COMPRESSED_DATA'])
            comp = heap[offs:offs + cnt]
            gz = b''
            if 'GZIP_COMPRESSED_DATA' in cols:
                gcnt, goffs = _descriptor(row, cols['GZIP_COMPRESSED_DATA'])
                gz = heap[goffs:goffs + gcnt]
            th = min(t2, n2 - ty * t2)
            tw = min(t1, n1 - tx * t1)
            tile = _inflate_tile(comp, gz, cmptype, th * tw, bytepix,
                                 blocksize, stored).reshape(th, tw)
            if quantized:
                zscale = (_scalar(row, cols['ZSCALE'])
                          if 'ZSCALE' in cols else float(hdr['ZSCALE']))
                zzero = (_scalar(row, cols['ZZERO'])
                         if 'ZZERO' in cols else float(hdr.get('ZZERO', 0.0)))
                ftile = tile * zscale + zzero
                zb = zblank_hdr
                if 'ZBLANK' in cols:
                    zb = int(_scalar(row, cols['ZBLANK']))
                if zb is not None:
                    ftile = np.where(tile == int(zb), np.nan, ftile)
                tile = ftile
            out[ty * t2:ty * t2 + th, tx * t1:tx * t1 + tw] = tile

    # reconstructed image header: strip table + Z keys, restore geometry
    img_hdr = Header()
    img_hdr['BITPIX'] = zbitpix
    img_hdr['NAXIS'] = 2
    img_hdr['NAXIS1'], img_hdr['NAXIS2'] = n1, n2
    drop_prefixes = ('Z', 'TTYPE', 'TFORM', 'TUNIT', 'TDIM', 'TSCAL',
                     'TZERO', 'TNULL')
    drop = {'XTENSION', 'BITPIX', 'NAXIS', 'NAXIS1', 'NAXIS2', 'PCOUNT',
            'GCOUNT', 'TFIELDS', 'THEAP', 'EXTNAME', 'CHECKSUM', 'DATASUM'}
    for k, v in hdr.items():
        if k in drop or any(k.startswith(p) for p in drop_prefixes):
            continue
        img_hdr[k] = v
        c = getattr(hdr, 'comments', {}).get(k)
        if c:
            img_hdr.comments[k] = c

    if quantized or float_img:
        data = np.asarray(out, np.float64 if quantized else stored)
        bscale = float(img_hdr.get('BSCALE', 1.0))
        bzero = float(img_hdr.get('BZERO', 0.0))
        if bscale != 1.0 or bzero != 0.0:
            data = data * bscale + bzero
        return data, img_hdr
    # integer path: reuse the plain reader's BSCALE/BZERO semantics,
    # including the exact uint16 convention
    bscale = float(img_hdr.get('BSCALE', 1.0))
    bzero = float(img_hdr.get('BZERO', 0.0))
    if bscale == 1.0 and bzero == 32768.0 and zbitpix == 16:
        data = (out.astype(np.int32) + 32768).astype(np.uint16)
    elif bscale != 1.0 or bzero != 0.0:
        data = out.astype(np.float64) * bscale + bzero
    else:
        data = out
    return data, img_hdr


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

# tpu_sgp/image/tile_compression.py:472
def _compress_tile(vals: np.ndarray, cmptype: str, blocksize: int) -> bytes:
    if cmptype == 'RICE_1':
        return rice_encode(vals, blocksize)
    be = np.ascontiguousarray(vals).astype(vals.dtype.newbyteorder('>'))
    raw = be.tobytes()
    if cmptype == 'GZIP_2':
        itemsize = vals.dtype.itemsize
        raw = np.frombuffer(raw, np.uint8).reshape(
            vals.size, itemsize).T.tobytes()
    if cmptype in ('GZIP_1', 'GZIP_2'):
        co = zlib.compressobj(6, zlib.DEFLATED, 31)  # gzip container
        return co.compress(raw) + co.flush()
    if cmptype == 'NOCOMPRESS':
        return raw
    raise ValueError(f'unsupported ZCMPTYPE {cmptype!r}')


# tpu_sgp/image/tile_compression.py:489
def write_fits_compressed(path: str, data: np.ndarray, header=None,
                          compression: str = 'RICE_1', tile_rows: int = 1,
                          quantize_scale: Optional[float] = None,
                          blocksize: int = 32) -> None:
    """Write ``data`` as a tile-compressed FITS file (fpack layout).

    Integer data (int16/int32/uint8/uint16) is compressed losslessly;
    uint16 uses the standard BZERO=32768 convention so CCD frames
    round-trip exactly. Float data needs either a gzip ``compression``
    (lossless) or an explicit ``quantize_scale`` for RICE (lossy linear
    quantization, ``NO_DITHER``, per-tile ZSCALE/ZZERO; max error
    ``quantize_scale / 2``).
    """
    from .fitsio import BLOCK, Header, _format_card

    data = np.asarray(data)
    if data.ndim != 2:
        raise ValueError('write_fits_compressed supports 2-D images')
    compression = compression.upper()
    n2, n1 = data.shape
    t2 = max(1, min(int(tile_rows), n2))
    float_img = data.dtype.kind == 'f'
    quantized = False
    extra_cards = []

    if float_img:
        zbitpix = -32 if data.dtype.itemsize == 4 else -64
        if compression == 'RICE_1':
            if quantize_scale is None:
                raise ValueError('RICE_1 float compression requires '
                                 'quantize_scale (lossy); use GZIP_1 for '
                                 'lossless float')
            quantized = True
        store_dtype = np.dtype('i4') if quantized else data.dtype
    elif data.dtype == np.uint16:
        zbitpix = 16
        store_dtype = np.dtype('i2')
        data = (data.astype(np.int32) - 32768)
        extra_cards += [('BSCALE', 1, 'unsigned 16-bit convention'),
                        ('BZERO', 32768, '')]
    elif data.dtype == np.uint8:
        zbitpix, store_dtype = 8, np.dtype('u1')
    elif data.dtype in (np.dtype(np.int16), np.dtype(np.int32)):
        zbitpix = 8 * data.dtype.itemsize
        store_dtype = data.dtype
    else:
        raise ValueError(f'unsupported dtype {data.dtype} for tile '
                         'compression')

    nty = -(-n2 // t2)
    tiles, zscales, zzeros = [], [], []
    for ty in range(nty):
        tile = data[ty * t2:(ty + 1) * t2, :]
        if quantized:
            zzero = float(np.nanmin(tile))
            q = np.rint((tile - zzero) / float(quantize_scale))
            tiles.append(_compress_tile(q.astype(np.int32).ravel(),
                                        compression, blocksize))
            zscales.append(float(quantize_scale))
            zzeros.append(zzero)
        else:
            tiles.append(_compress_tile(
                tile.astype(store_dtype).ravel(), compression, blocksize))

    # table layout: COMPRESSED_DATA 1PB(max) [+ ZSCALE 1D + ZZERO 1D]
    maxlen = max(len(t) for t in tiles)
    row_w = 8 + (16 if quantized else 0)
    heap = b''.join(tiles)
    rows = bytearray()
    off = 0
    for i, t in enumerate(tiles):
        rows += np.array([len(t), off], '>i4').tobytes()
        if quantized:
            rows += np.array([zscales[i], zzeros[i]], '>f8').tobytes()
        off += len(t)

    bytepix = store_dtype.itemsize
    cards = [
        _format_card('SIMPLE', True, 'conforms to FITS standard'),
        _format_card('BITPIX', 8),
        _format_card('NAXIS', 0),
        _format_card('EXTEND', True),
        b'END'.ljust(80),
    ]
    primary = b''.join(cards)
    primary += b' ' * (-len(primary) % BLOCK)

    ext = [
        _format_card('XTENSION', 'BINTABLE', 'binary table extension'),
        _format_card('BITPIX', 8),
        _format_card('NAXIS', 2),
        _format_card('NAXIS1', row_w),
        _format_card('NAXIS2', len(tiles)),
        _format_card('PCOUNT', len(heap)),
        _format_card('GCOUNT', 1),
        _format_card('TFIELDS', 3 if quantized else 1),
        _format_card('TTYPE1', 'COMPRESSED_DATA'),
        _format_card('TFORM1', f'1PB({maxlen})'),
    ]
    if quantized:
        ext += [_format_card('TTYPE2', 'ZSCALE'),
                _format_card('TFORM2', '1D'),
                _format_card('TTYPE3', 'ZZERO'),
                _format_card('TFORM3', '1D')]
    ext += [
        _format_card('ZIMAGE', True, 'tile-compressed image'),
        _format_card('ZCMPTYPE', compression),
        _format_card('ZBITPIX', zbitpix),
        _format_card('ZNAXIS', 2),
        _format_card('ZNAXIS1', n1),
        _format_card('ZNAXIS2', n2),
        _format_card('ZTILE1', n1),
        _format_card('ZTILE2', t2),
    ]
    if compression == 'RICE_1':
        ext += [_format_card('ZNAME1', 'BLOCKSIZE'),
                _format_card('ZVAL1', blocksize),
                _format_card('ZNAME2', 'BYTEPIX'),
                _format_card('ZVAL2', bytepix)]
    if quantized:
        ext.append(_format_card('ZQUANTIZ', 'NO_DITHER'))
    for key, val, cmt in extra_cards:
        ext.append(_format_card(key, val, cmt))
    if header:
        reserved = {'SIMPLE', 'BITPIX', 'NAXIS', 'NAXIS1', 'NAXIS2', 'END',
                    'BSCALE', 'BZERO', 'EXTEND', 'XTENSION', 'PCOUNT',
                    'GCOUNT', 'TFIELDS'}
        comments = getattr(header, 'comments', {})
        for k, v in header.items():
            if k.upper() in reserved or k.upper().startswith(
                    ('Z', 'TTYPE', 'TFORM')):
                continue
            ext.append(_format_card(k, v, comments.get(k, '')))
    ext.append(b'END'.ljust(80))
    ext_hdr = b''.join(ext)
    ext_hdr += b' ' * (-len(ext_hdr) % BLOCK)

    payload = bytes(rows) + heap
    payload += b'\x00' * (-len(payload) % BLOCK)
    with open(path, 'wb') as fo:
        fo.write(primary)
        fo.write(ext_hdr)
        fo.write(payload)
