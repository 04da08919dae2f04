"""Minimal native FITS reader/writer (single image HDUs + headers).

The reference leans on astropy.io.fits for every artifact (PSF matrices,
science frames, per-tile temporaries, reconstructions). astropy is not part
of this stack, so the framework carries its own small, dependency-free FITS
implementation: image HDUs (primary AND ``XTENSION = 'IMAGE'`` extensions —
real survey frames are often multi-extension, reference sgp.py:944-958 gets
that for free from astropy), BITPIX 8/16/32/64/-32/-64, BSCALE/BZERO
(including the exact unsigned-16-bit convention BZERO=32768 used by raw CCD
frames, which round-trips as uint16 rather than degrading to float64),
keyword/value/comment round-trip (COMMENT and HISTORY cards are NOT carried
by the in-memory Header — use ``set_header_card`` to edit a file's header
without disturbing them). Tile-compressed HDUs (fpack ZIMAGE binary tables)
are inflated natively (RICE_1 / GZIP_1 / GZIP_2 — see tile_compression.py);
only dithered quantization and PLIO/HCOMPRESS raise.
"""
# Host code (NumPy/SciPy), kept equal to tpu_sgp/image/fitsio.py:1
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

BLOCK = 2880
CARD = 80

_BITPIX_DTYPES = {
    8: np.dtype('>u1'),
    16: np.dtype('>i2'),
    32: np.dtype('>i4'),
    64: np.dtype('>i8'),
    -32: np.dtype('>f4'),
    -64: np.dtype('>f8'),
}
_DTYPE_BITPIX = {
    np.dtype(np.uint8): 8,
    np.dtype(np.int16): 16,
    np.dtype(np.int32): 32,
    np.dtype(np.int64): 64,
    np.dtype(np.float32): -32,
    np.dtype(np.float64): -64,
}


# tpu_sgp/image/fitsio.py:45
def _parse_value(raw: str):
    raw = raw.strip()
    if raw.startswith("'"):
        # FITS string: doubled quotes are escapes; value ends at the
        # unescaped closing quote.
        out, i = [], 1
        while i < len(raw):
            if raw[i] == "'":
                if i + 1 < len(raw) and raw[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            out.append(raw[i])
            i += 1
        return ''.join(out).rstrip()
    if raw in ('T', 'F'):
        return raw == 'T'
    if raw == '':
        return None
    try:
        if any(ch in raw for ch in '.eEdD') and not raw.lstrip('+-').isdigit():
            return float(raw.replace('D', 'E').replace('d', 'e'))
        return int(raw)
    except ValueError:
        return raw


# tpu_sgp/image/fitsio.py:73
def _format_card(key: str, value, comment: str = '') -> bytes:
    key = key.upper()[:8]
    if key in ('COMMENT', 'HISTORY', ''):
        card = f'{key:<8}{str(value)[:72]}'
    else:
        if isinstance(value, bool):
            sval = 'T' if value else 'F'
            body = f'= {sval:>20}'
        elif isinstance(value, (int, np.integer)):
            body = f'= {int(value):>20}'
        elif isinstance(value, (float, np.floating)):
            # repr is the SHORTEST exact round-trip decimal for a float64;
            # a fixed %.13G silently lost the last ~4 significant digits of
            # WCS-grade values (CD matrices, CRVAL) on every write/read
            # cycle. FITS fixed format right-justifies to column 30 when it
            # fits; longer exact values use free format (standard-legal).
            sval = repr(float(value)).upper()
            body = f'= {sval:>20}' if len(sval) <= 20 else f'= {sval}'
        elif value is None:
            body = '=' + ' ' * 21
        else:
            esc = str(value).replace("'", "''")
            if len(esc) > 67:
                # warn — astropy would use CONTINUE cards here, which this
                # minimal writer does not implement
                import warnings
                warnings.warn(
                    f'FITS header value for {key!r} exceeds one card '
                    f'({len(esc)} chars); truncated',
                    stacklevel=2)
                esc = esc[:67]
                # never cut mid doubled-quote escape (the reparse would end
                # the string early): a trailing quote run must stay even
                if (len(esc) - len(esc.rstrip("'"))) % 2:
                    esc = esc[:-1]
            sval = "'" + esc + "'"
            body = f'= {sval:<20}'
        card = f'{key:<8}{body}'
        if comment:
            card += f' / {comment}'
    return card[:CARD].ljust(CARD).encode('ascii')


# tpu_sgp/image/fitsio.py:116
class Header(dict):
    """Ordered FITS header with attribute-free dict access (header['GAIN'])."""

    # tpu_sgp/image/fitsio.py:119
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.comments: Dict[str, str] = {}

    # tpu_sgp/image/fitsio.py:123
    def copy(self) -> 'Header':
        h = Header(self)
        h.comments = dict(self.comments)
        return h


# tpu_sgp/image/fitsio.py:129
def _read_header(f) -> Header:
    hdr = Header()
    while True:
        block = f.read(BLOCK)
        if len(block) < BLOCK:
            raise ValueError('truncated FITS header')
        for i in range(0, BLOCK, CARD):
            card = block[i:i + CARD].decode('ascii', errors='replace')
            key = card[:8].strip()
            if key == 'END':
                return hdr
            if key in ('COMMENT', 'HISTORY') or '=' not in card[8:10]:
                continue
            rest = card[10:]
            # strip inline comment (only outside strings)
            if rest.lstrip().startswith("'"):
                q = rest.find("'")
                j = q + 1
                while j < len(rest):
                    if rest[j] == "'":
                        if j + 1 < len(rest) and rest[j + 1] == "'":
                            j += 2
                            continue
                        break
                    j += 1
                value_part = rest[:j + 1]
                comment = rest[j + 1:].split('/', 1)
                comment = comment[1].strip() if len(comment) > 1 else ''
            else:
                parts = rest.split('/', 1)
                value_part = parts[0]
                comment = parts[1].strip() if len(parts) > 1 else ''
            hdr[key] = _parse_value(value_part)
            if comment:
                hdr.comments[key] = comment


# tpu_sgp/image/fitsio.py:166
def _hdu_data_bytes(hdr: Header) -> int:
    """Byte length of an HDU's data block (before 2880 padding), per the
    FITS standard: |BITPIX|/8 * GCOUNT * (PCOUNT + prod(NAXISn))."""
    naxis = int(hdr.get('NAXIS', 0))
    if naxis == 0:
        return 0
    n = 1
    for i in range(1, naxis + 1):
        n *= int(hdr[f'NAXIS{i}'])
    n = int(hdr.get('GCOUNT', 1)) * (int(hdr.get('PCOUNT', 0)) + n)
    return abs(int(hdr['BITPIX'])) // 8 * n


# tpu_sgp/image/fitsio.py:179
def _decode_data(f, hdr: Header) -> np.ndarray:
    naxis = int(hdr.get('NAXIS', 0))
    if naxis == 0:
        return np.empty(0)
    shape = tuple(int(hdr[f'NAXIS{i}']) for i in range(naxis, 0, -1))
    bitpix = int(hdr['BITPIX'])
    dtype = _BITPIX_DTYPES[bitpix]
    count = int(np.prod(shape))
    raw = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype,
                        count=count).reshape(shape)
    bscale = float(hdr.get('BSCALE', 1.0))
    bzero = float(hdr.get('BZERO', 0.0))
    if bscale == 1.0 and bzero == 32768.0 and bitpix == 16:
        # THE unsigned-16-bit convention (raw CCD ADUs): exact uint16,
        # not a float64 blow-up of the whole frame
        return (raw.astype(np.int32) + 32768).astype(np.uint16)
    if bscale != 1.0 or bzero != 0.0:
        return raw.astype(np.float64) * bscale + bzero
    return raw.astype(dtype.newbyteorder('='))


# tpu_sgp/image/fitsio.py:200
def read_fits(path: str, hdu: Optional[int] = None) -> Tuple[np.ndarray,
                                                             Header]:
    """Read an image HDU and its header.

    ``hdu=None`` (default) returns the FIRST HDU carrying image data: the
    primary when it has NAXIS > 0, otherwise the first ``IMAGE``
    extension — the layout of multi-extension survey files whose primary
    holds only metadata. An explicit ``hdu=k`` (0 = primary) selects by
    index. Tile-compressed images (fpack: a BINTABLE with ZIMAGE=T) raise
    a clear error instead of being misread as a table."""
    with open(path, 'rb') as f:
        index = 0
        while True:
            try:
                hdr = _read_header(f)
            except ValueError:
                raise ValueError(
                    f'{path}: no image HDU found (read {index} HDUs)')
            xt = str(hdr.get('XTENSION', '')).strip().upper()
            compressed = bool(hdr.get('ZIMAGE')) and xt == 'BINTABLE'
            is_image = index == 0 or xt == 'IMAGE' or compressed
            has_data = int(hdr.get('NAXIS', 0)) > 0
            if hdu is not None:
                if index == hdu:
                    if not is_image:
                        raise ValueError(
                            f'{path} HDU {index}: not an image HDU '
                            f'(XTENSION={xt!r})')
                    if compressed:
                        from .tile_compression import decompress_tiled_hdu
                        return decompress_tiled_hdu(f, hdr)
                    return _decode_data(f, hdr), hdr
            elif compressed:
                # fpack tile-compressed image: inflate natively (RICE_1 /
                # GZIP_1 / GZIP_2; see tile_compression.py)
                from .tile_compression import decompress_tiled_hdu
                return decompress_tiled_hdu(f, hdr)
            elif is_image and has_data:
                return _decode_data(f, hdr), hdr
            elif index == 0 and not hdr.get('EXTEND', False) \
                    and hdu is None:
                return np.empty(0), hdr   # headerless primary, no extensions
            # skip this HDU's (padded) data block
            nbytes = _hdu_data_bytes(hdr)
            f.seek(-(-nbytes // BLOCK) * BLOCK, 1)
            index += 1


# tpu_sgp/image/fitsio.py:248
def getdata(path: str) -> np.ndarray:
    return read_fits(path)[0]


# tpu_sgp/image/fitsio.py:252
def getheader(path: str) -> Header:
    return read_fits(path)[1]


# tpu_sgp/image/fitsio.py:256
def write_fits(path: str, data: np.ndarray, header: Optional[Header] = None,
               overwrite: bool = True) -> None:
    """Write a 2D (or nD) array as a primary-HDU FITS file. uint16 data is
    written with the standard BZERO=32768 convention (BITPIX 16), so raw
    CCD frames round-trip bit-exactly at half the bytes of float32."""
    if os.path.exists(path) and not overwrite:
        raise OSError(f'{path} exists and overwrite=False')
    data = np.asarray(data)
    u16 = data.dtype == np.uint16
    if not u16 and data.dtype not in _DTYPE_BITPIX:
        data = data.astype(np.float64)
    bitpix = 16 if u16 else _DTYPE_BITPIX[data.dtype]
    cards = [
        _format_card('SIMPLE', True, 'conforms to FITS standard'),
        _format_card('BITPIX', bitpix),
        _format_card('NAXIS', data.ndim),
    ]
    for i, n in enumerate(reversed(data.shape), start=1):
        cards.append(_format_card(f'NAXIS{i}', int(n)))
    if u16:
        cards.append(_format_card('BSCALE', 1,
                                  'unsigned 16-bit convention'))
        cards.append(_format_card('BZERO', 32768))
    reserved = {'SIMPLE', 'BITPIX', 'NAXIS', 'END', 'BSCALE', 'BZERO',
                'EXTEND'} | {f'NAXIS{i}' for i in range(1, 10)}
    if header:
        comments = getattr(header, 'comments', {})
        for k, v in header.items():
            if k.upper() in reserved:
                continue
            cards.append(_format_card(k, v, comments.get(k, '')))
    cards.append('END'.ljust(CARD).encode('ascii'))
    hdr_bytes = b''.join(cards)
    hdr_bytes += b' ' * (-len(hdr_bytes) % BLOCK)

    if u16:
        payload = (data.astype(np.int32) - 32768).astype('>i2').tobytes()
    else:
        payload = data.astype(_BITPIX_DTYPES[bitpix]).tobytes()
    payload += b'\x00' * (-len(payload) % BLOCK)
    with open(path, 'wb') as f:
        f.write(hdr_bytes)
        f.write(payload)


writeto = write_fits  # astropy-style alias


# tpu_sgp/image/fitsio.py:304
def set_header_card(path: str, key: str, value, comment: str = '') -> None:
    """Insert or replace ONE card in a file's primary header by raw-byte
    splicing (the native equivalent of IRAF ``hedit`` /
    ``fits.setval``).

    Unlike a read_fits/write_fits round-trip this preserves the file
    verbatim: COMMENT/HISTORY cards (which the in-memory Header drops),
    BSCALE/BZERO-scaled integer encodings (which write_fits would re-encode
    as float64), any extensions after the primary HDU, and all padding
    survive byte-for-byte. Only the one card changes; if the header block
    is full, one 2880-byte block is added. The write is atomic
    (temp file + rename)."""
    key_u = key.upper()[:8]
    new_card = _format_card(key, value, comment)
    with open(path, 'rb') as f:
        raw = f.read()
    end_off = None
    key_off = None
    off = 0
    while off + CARD <= len(raw):
        k = raw[off:off + 8].decode('ascii', errors='replace').strip()
        if k == 'END':
            end_off = off
            break
        if k == key_u and key_off is None:
            key_off = off
        off += CARD
    if end_off is None:
        raise ValueError(f'{path}: no END card in primary header')
    if key_off is not None:
        out = raw[:key_off] + new_card + raw[key_off + CARD:]
    else:
        hdr_end = -(-(end_off + CARD) // BLOCK) * BLOCK  # data start
        cards = raw[:end_off] + new_card + b'END'.ljust(CARD)
        out = cards + b' ' * (-len(cards) % BLOCK) + raw[hdr_end:]
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        f.write(out)
    os.replace(tmp, path)
