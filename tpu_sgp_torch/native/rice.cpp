// RICE_1 codec for FITS tiled-image compression (the fpack convention).
//
// Semantics follow the registered FITS Tiled Image Compression convention
// (White et al. 2013) as implemented by cfitsio/fpack, reimplemented from
// the published algorithm description:
//   * stream starts with the first pixel value, big-endian, BYTEPIX bytes
//   * every pixel (including the first, whose difference is zero) is
//     delta-coded against the previous one; differences are zigzag-mapped
//     to non-negative integers (d >= 0 -> 2d, d < 0 -> -2d-1)
//   * pixels are processed in blocks of BLOCKSIZE (default 32); each block
//     carries an FSBITS-wide code k: k == 0 means every difference in the
//     block is zero; k == FSMAX+1 means differences follow as raw
//     8*BYTEPIX-bit values; otherwise fs = k-1 and each difference is
//     Golomb-Rice coded (unary top bits terminated by a 1, then fs low
//     bits), MSB-first
//   * (FSBITS, FSMAX) = (3, 6) / (4, 14) / (5, 25) for BYTEPIX 1 / 2 / 4
//
// All arithmetic is unsigned with wraparound modulo 2^(8*BYTEPIX), so the
// codec is lossless for the raw two's-complement bit patterns regardless
// of the signedness of the FITS integer type stored in them.
//
// The reference reads compressed survey files through astropy/cfitsio for
// free (the reference's sgp.py:944-958); this provides the
// native-equivalent decode (and encode) path.
#include <cstdint>
#include <cstring>

namespace {

struct Params { int fsbits, fsmax; };

inline bool params_for(int bytepix, Params* p) {
    switch (bytepix) {
        case 1: *p = {3, 6}; return true;
        case 2: *p = {4, 14}; return true;
        case 4: *p = {5, 25}; return true;
        default: return false;
    }
}

struct BitReader {
    const uint8_t* in;
    long nin;
    long pos;      // next byte index
    uint32_t buf;  // current bits, MSB-aligned in the low `nbits` bits
    int nbits;
    bool overrun;

    explicit BitReader(const uint8_t* data, long n)
        : in(data), nin(n), pos(0), buf(0), nbits(0), overrun(false) {}

    // read n (<= 25) bits MSB-first
    uint32_t get(int n) {
        while (nbits < n) {
            buf = (buf << 8) | (pos < nin ? in[pos] : (overrun = true, 0));
            ++pos;
            nbits += 8;
        }
        nbits -= n;
        uint32_t v = (buf >> nbits) & ((n == 32) ? 0xffffffffu
                                                 : ((1u << n) - 1u));
        return v;
    }

    // count zero bits until (and consuming) the terminating 1 bit
    uint32_t unary() {
        uint32_t count = 0;
        for (;;) {
            if (nbits == 0) {
                if (pos >= nin) { overrun = true; return count; }
                buf = in[pos++];
                nbits = 8;
                if (buf == 0) { count += 8; nbits = 0; continue; }
            }
            uint32_t window = buf & ((1u << nbits) - 1u);
            if (window == 0) { count += nbits; nbits = 0; continue; }
            // index of highest set bit in window
            int top = 31 - __builtin_clz(window);
            count += nbits - 1 - top;
            nbits = top;  // consume through the 1 bit
            return count;
        }
    }
};

struct BitWriter {
    uint8_t* out;
    long cap;
    long nbytes;
    uint32_t buf;
    int nbits;
    bool overflow;

    BitWriter(uint8_t* o, long c)
        : out(o), cap(c), nbytes(0), buf(0), nbits(0), overflow(false) {}

    void put(uint32_t v, int n) {  // n <= 32, MSB-first
        while (n > 0) {
            int take = n > 24 ? 24 : n;  // keep buf within 32 bits
            buf = (buf << take) | ((take == 32) ? v
                                                : (v >> (n - take))
                                                      & ((1u << take) - 1u));
            nbits += take;
            n -= take;
            while (nbits >= 8) {
                nbits -= 8;
                if (nbytes < cap) out[nbytes] = (buf >> nbits) & 0xffu;
                else overflow = true;
                ++nbytes;
            }
        }
    }

    void put_unary(uint32_t zeros) {
        while (zeros >= 24) { put(0, 24); zeros -= 24; }
        put(1u, (int)zeros + 1);  // `zeros` 0-bits then the terminating 1
    }

    void flush() {
        if (nbits > 0) {
            if (nbytes < cap) out[nbytes] = (buf << (8 - nbits)) & 0xffu;
            else overflow = true;
            ++nbytes;
            nbits = 0;
        }
    }
};

inline uint32_t load_pixel(const uint8_t* p, int bytepix) {
    uint32_t v = 0;
    for (int b = 0; b < bytepix; ++b) v = (v << 8) | p[b];
    return v;
}

inline void store_pixel(uint8_t* p, uint32_t v, int bytepix) {
    for (int b = bytepix - 1; b >= 0; --b) { p[b] = v & 0xffu; v >>= 8; }
}

}  // namespace

extern "C" {

// Decode `nin` compressed bytes into `npix` pixels of width `bytepix`
// (native byte order on output). Returns 0 on success, -1 on bad
// parameters, -2 on a truncated/corrupt stream.
int32_t tpusgp_rice_decode(const uint8_t* in, long nin, void* out_v,
                           long npix, int32_t bytepix, int32_t nblock) {
    Params prm;
    if (!params_for(bytepix, &prm) || nblock <= 0 || npix < 0) return -1;
    if (npix == 0) return 0;
    if (nin < bytepix) return -2;
    const uint32_t mask =
        bytepix == 4 ? 0xffffffffu : ((1u << (8 * bytepix)) - 1u);
    uint32_t lastpix = load_pixel(in, bytepix);
    BitReader br(in + bytepix, nin - bytepix);
    uint8_t* out = static_cast<uint8_t*>(out_v);
    const int bbits = 8 * bytepix;

    long i = 0;
    while (i < npix) {
        long thisblock = npix - i < nblock ? npix - i : nblock;
        int32_t fs = (int32_t)br.get(prm.fsbits) - 1;
        if (fs < 0) {
            for (long k = 0; k < thisblock; ++k, ++i)
                store_pixel(out + i * bytepix, lastpix, bytepix);
        } else if (fs >= prm.fsmax) {
            for (long k = 0; k < thisblock; ++k, ++i) {
                // chunked: BitReader::get holds at most 31 bits
                uint32_t d = bbits > 24
                                 ? (br.get(bbits - 16) << 16) | br.get(16)
                                 : br.get(bbits);
                lastpix = (lastpix
                           + ((d & 1u) ? ~(d >> 1) : (d >> 1))) & mask;
                store_pixel(out + i * bytepix, lastpix, bytepix);
            }
        } else {
            for (long k = 0; k < thisblock; ++k, ++i) {
                uint32_t top = br.unary();
                uint32_t d = (top << fs) | (fs ? br.get(fs) : 0u);
                lastpix = (lastpix
                           + ((d & 1u) ? ~(d >> 1) : (d >> 1))) & mask;
                store_pixel(out + i * bytepix, lastpix, bytepix);
            }
        }
        if (br.overrun) return -2;
    }
    // convert big-endian scratch to native order in place
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
    if (bytepix > 1) {
        for (long k = 0; k < npix; ++k) {
            uint8_t* p = out + k * bytepix;
            for (int a = 0, b = bytepix - 1; a < b; ++a, --b) {
                uint8_t t = p[a]; p[a] = p[b]; p[b] = t;
            }
        }
    }
#endif
    return 0;
}

// Encode `npix` pixels (native byte order) of width `bytepix` into `out`
// (capacity `outcap` bytes). Returns the number of compressed bytes, or
// -1 on bad parameters, -3 when the output buffer is too small (callers
// should budget ~npix*bytepix + npix/nblock + 8 bytes: the raw-copy mode
// bounds every block).
long tpusgp_rice_encode(const void* in_v, long npix, uint8_t* out,
                        long outcap, int32_t bytepix, int32_t nblock) {
    Params prm;
    if (!params_for(bytepix, &prm) || nblock <= 0 || npix <= 0) return -1;
    const uint8_t* in = static_cast<const uint8_t*>(in_v);
    const uint32_t mask =
        bytepix == 4 ? 0xffffffffu : ((1u << (8 * bytepix)) - 1u);
    const int bbits = 8 * bytepix;

    auto pixel_at = [&](long k) -> uint32_t {
        uint32_t v = 0;
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
        for (int b = bytepix - 1; b >= 0; --b)
            v = (v << 8) | in[k * bytepix + b];
#else
        for (int b = 0; b < bytepix; ++b) v = (v << 8) | in[k * bytepix + b];
#endif
        return v;
    };

    if (outcap < bytepix) return -3;
    uint32_t lastpix = pixel_at(0);
    store_pixel(out, lastpix, bytepix);  // header is big-endian
    BitWriter bw(out + bytepix, outcap - bytepix);

    uint32_t diffs[4096];
    if (nblock > 4096) return -1;
    long i = 0;
    while (i < npix) {
        long thisblock = npix - i < nblock ? npix - i : nblock;
        uint64_t pixelsum = 0;
        for (long k = 0; k < thisblock; ++k) {
            uint32_t pix = pixel_at(i + k);
            uint32_t d = (pix - lastpix) & mask;  // wraparound difference
            // zigzag: interpret d as signed in `bytepix` width, then map
            uint32_t sign_bit = 1u << (bbits - 1);
            uint32_t zz = (d & sign_bit) ? ((~d & mask) << 1) | 1u
                                         : d << 1;
            // values with magnitude >= 2^(bbits-1) overflow the zigzag in
            // `bbits` bits — they only arise at d == -2^(bbits-1), whose
            // zigzag is 2^bbits - 1 (all ones); keep full 32-bit zz for
            // bytepix 4 (natural wraparound already handles it)
            diffs[k] = zz;
            pixelsum += zz;
            lastpix = pix;
        }
        int64_t dpsum = ((int64_t)pixelsum - thisblock / 2 - 1) / thisblock;
        int fs = 0;
        for (int64_t t = dpsum; t > 0; t >>= 1) ++fs;
        if (pixelsum == 0) {
            bw.put(0, prm.fsbits);
        } else if (fs >= prm.fsmax) {
            bw.put((uint32_t)prm.fsmax + 1, prm.fsbits);
            for (long k = 0; k < thisblock; ++k) bw.put(diffs[k], bbits);
        } else {
            bw.put((uint32_t)fs + 1, prm.fsbits);
            for (long k = 0; k < thisblock; ++k) {
                bw.put_unary(diffs[k] >> fs);
                if (fs) bw.put(diffs[k] & ((1u << fs) - 1u), fs);
            }
        }
        i += thisblock;
        if (bw.overflow) return -3;
    }
    bw.flush();
    if (bw.overflow) return -3;
    return bytepix + bw.nbytes;
}

}  // extern "C"
