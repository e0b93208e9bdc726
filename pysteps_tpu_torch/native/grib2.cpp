// GRIB2 payload decoders for the pysteps_tpu_torch data plane.
//
// The reference imports NCEP MRMS GRIB2 products through pygrib (C/ecCodes,
// reference: pysteps/io/importers.py:244).  These kernels provide the
// equivalent native decode path: section parsing stays in Python
// (io/_grib2.py); the byte-crunching — bit-stream unpacking
// (template 5.0), complex packing with spatial differencing (5.2/5.3) and
// PNG code streams (5.41, the MRMS default) — runs here.
//
// C ABI via ctypes.  All return codes: 0 = ok, negative = format error.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include <zlib.h>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// Read `nbits` (<= 32) starting at absolute bit offset `pos` (big-endian).
inline uint32_t read_bits(const uint8_t* buf, uint64_t pos, int nbits) {
    uint32_t out = 0;
    for (int i = 0; i < nbits; ++i, ++pos) {
        out = (out << 1) | ((buf[pos >> 3] >> (7 - (pos & 7))) & 1u);
    }
    return out;
}

inline float scale_value(double x, float R, double two_E, double ten_D) {
    return static_cast<float>((R + x * two_E) / ten_D);
}

inline int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return a;
    if (pb <= pc) return b;
    return c;
}

}  // namespace

extern "C" {

// Template 5.0 (simple packing): out[i] = (R + X_i * 2^E) / 10^D with X_i a
// big-endian nbits field.  Each value's bit offset is independent -> OpenMP.
int grib_unpack_simple(const uint8_t* src, int64_t n, int nbits, float R,
                       int E, int D, float* out) {
    const double two_E = std::pow(2.0, E);
    const double ten_D = std::pow(10.0, D);
    if (nbits == 0) {
        const float v = scale_value(0.0, R, two_E, ten_D);
        for (int64_t i = 0; i < n; ++i) out[i] = v;
        return 0;
    }
    if (nbits > 32) return -1;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        out[i] = scale_value(read_bits(src, (uint64_t)i * nbits, nbits), R,
                             two_E, ten_D);
    }
    return 0;
}

// Templates 5.2 / 5.3 (complex packing [+ spatial differencing]).
//
//   src        section-7 payload *after* the spatial-differencing extra
//              descriptors (the Python layer parses those: ival1, ival2,
//              gmin — sign-magnitude ints of `extra_octets` bytes)
//   ng         number of groups;  nbits  bits per group reference
//   width_ref/width_bits, len_ref/len_inc/last_len/len_bits: group
//              width/length encodings (template octets 36-47)
//   mvm        missing-value management (0 = none, 1 = primary missing)
//   order      spatial differencing order (0 for template 5.2)
//
// Layout of src: group references (ng x nbits), byte-padded; group widths
// (ng x width_bits), byte-padded; group lengths (ng x len_bits),
// byte-padded; then the per-group packed values.
int grib_unpack_complex(const uint8_t* src, int64_t src_len, int64_t n,
                        int nbits, float R, int E, int D, int64_t ng,
                        int width_ref, int width_bits, int64_t len_ref,
                        int len_inc, int64_t last_len, int len_bits, int mvm,
                        int order, int64_t ival1, int64_t ival2, int64_t gmin,
                        float* out) {
    if (nbits > 32 || width_bits > 32 || len_bits > 32) return -1;
    std::vector<uint32_t> refs(ng), widths(ng);
    std::vector<int64_t> lens(ng);

    uint64_t pos = 0;
    for (int64_t g = 0; g < ng; ++g, pos += nbits)
        refs[g] = nbits ? read_bits(src, pos, nbits) : 0;
    pos = (pos + 7) & ~7ull;
    for (int64_t g = 0; g < ng; ++g, pos += width_bits)
        widths[g] = (width_bits ? read_bits(src, pos, width_bits) : 0) + width_ref;
    pos = (pos + 7) & ~7ull;
    for (int64_t g = 0; g < ng; ++g, pos += len_bits)
        lens[g] = (int64_t)(len_bits ? read_bits(src, pos, len_bits) : 0) *
                      len_inc + len_ref;
    if (ng > 0) lens[ng - 1] = last_len;
    pos = (pos + 7) & ~7ull;

    // prefix sums: value index and bit offset of each group's packed block
    std::vector<int64_t> val_off(ng + 1, 0);
    std::vector<uint64_t> bit_off(ng + 1, pos);
    for (int64_t g = 0; g < ng; ++g) {
        val_off[g + 1] = val_off[g] + lens[g];
        bit_off[g + 1] = bit_off[g] + (uint64_t)lens[g] * widths[g];
    }
    if (val_off[ng] != n) return -2;
    if ((bit_off[ng] + 7) / 8 > (uint64_t)src_len) return -3;

    // first pass: integer values (differences when order > 0) + missing mask
    std::vector<int64_t> vals(n);
    std::vector<uint8_t> miss(n, 0);
    const uint32_t ref_missing = nbits ? ((nbits >= 32 ? 0xFFFFFFFFu
                                                       : ((1u << nbits) - 1u)))
                                       : 0;
#pragma omp parallel for schedule(dynamic, 64)
    for (int64_t g = 0; g < ng; ++g) {
        const int w = widths[g];
        const uint32_t w_missing = w ? ((w >= 32 ? 0xFFFFFFFFu
                                                 : ((1u << w) - 1u)))
                                     : 0;
        uint64_t p = bit_off[g];
        for (int64_t k = 0; k < lens[g]; ++k, p += w) {
            const int64_t i = val_off[g] + k;
            if (w == 0) {
                if (mvm == 1 && nbits && refs[g] == ref_missing) miss[i] = 1;
                else vals[i] = refs[g];
            } else {
                const uint32_t x = read_bits(src, p, w);
                if (mvm == 1 && x == w_missing) miss[i] = 1;
                else vals[i] = (int64_t)refs[g] + x;
            }
        }
    }

    // undo spatial differencing (sequential by construction)
    if (order > 0) {
        int64_t seen = 0, prev1 = 0, prev2 = 0;
        for (int64_t i = 0; i < n; ++i) {
            if (miss[i]) continue;
            if (seen == 0) vals[i] = ival1;
            else if (order == 2 && seen == 1) vals[i] = ival2;
            else vals[i] += gmin + (order == 1 ? prev1 : 2 * prev1 - prev2);
            prev2 = prev1;
            prev1 = vals[i];
            ++seen;
        }
    }

    const double two_E = std::pow(2.0, E);
    const double ten_D = std::pow(10.0, D);
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        out[i] = miss[i] ? NAN
                         : scale_value((double)vals[i], R, two_E, ten_D);
    }
    return 0;
}

// Template 5.41: the section-7 payload is a PNG code stream whose pixel
// samples are the packed integers (gray 8/16-bit, or RGB/RGBA carrying a
// 24/32-bit big-endian value).  Full decoder: zlib inflate + per-row
// defilter + sample extraction, then the simple-packing scale.
int grib_png_unpack(const uint8_t* png, int64_t len, int64_t n, float R,
                    int E, int D, float* out) {
    static const uint8_t SIG[8] = {0x89, 'P', 'N', 'G', 0x0D, 0x0A, 0x1A, 0x0A};
    if (len < 8 + 25 || std::memcmp(png, SIG, 8) != 0) return -1;

    // chunks: IHDR first, concatenate IDAT
    int64_t off = 8;
    uint32_t width = 0, height = 0;
    int bit_depth = 0, color_type = 0;
    std::vector<uint8_t> idat;
    while (off + 12 <= len) {
        const uint32_t clen = ((uint32_t)png[off] << 24) |
                              ((uint32_t)png[off + 1] << 16) |
                              ((uint32_t)png[off + 2] << 8) | png[off + 3];
        const uint8_t* type = png + off + 4;
        const uint8_t* data = png + off + 8;
        if (off + 12 + (int64_t)clen > len) return -2;
        if (!std::memcmp(type, "IHDR", 4)) {
            if (clen < 13) return -2;
            width = ((uint32_t)data[0] << 24) | (data[1] << 16) |
                    (data[2] << 8) | data[3];
            height = ((uint32_t)data[4] << 24) | (data[5] << 16) |
                     (data[6] << 8) | data[7];
            bit_depth = data[8];
            color_type = data[9];
            if (data[10] || data[11] || data[12]) return -4;  // non-default
        } else if (!std::memcmp(type, "IDAT", 4)) {
            idat.insert(idat.end(), data, data + clen);
        } else if (!std::memcmp(type, "IEND", 4)) {
            break;
        }
        off += 12 + clen;
    }
    if (!width || !height || idat.empty()) return -2;

    int channels;
    switch (color_type) {
        case 0: channels = 1; break;  // gray
        case 2: channels = 3; break;  // RGB
        case 4: channels = 2; break;  // gray+alpha
        case 6: channels = 4; break;  // RGBA
        default: return -4;           // palette unsupported
    }
    if (bit_depth != 8 && bit_depth != 16) return -4;
    const int bpp = channels * (bit_depth / 8);       // bytes per pixel
    const int64_t stride = (int64_t)width * bpp;      // bytes per row
    if ((int64_t)width * height != n) return -5;

    std::vector<uint8_t> raw(height * (stride + 1));
    uLongf raw_len = raw.size();
    if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
        raw_len != raw.size())
        return -3;

    // defilter in place (sequential across rows: Up/Paeth reference the
    // previous row), then extract big-endian samples row-parallel
    std::vector<uint8_t> img(height * stride);
    for (uint32_t r = 0; r < height; ++r) {
        const uint8_t filter = raw[r * (stride + 1)];
        const uint8_t* srcrow = raw.data() + r * (stride + 1) + 1;
        uint8_t* dst = img.data() + (int64_t)r * stride;
        const uint8_t* up = r ? dst - stride : nullptr;
        for (int64_t i = 0; i < stride; ++i) {
            const int a = i >= bpp ? dst[i - bpp] : 0;
            const int b = up ? up[i] : 0;
            const int c = (up && i >= bpp) ? up[i - bpp] : 0;
            int v = srcrow[i];
            switch (filter) {
                case 0: break;
                case 1: v += a; break;
                case 2: v += b; break;
                case 3: v += (a + b) / 2; break;
                case 4: v += paeth(a, b, c); break;
                default: return -6;
            }
            dst[i] = (uint8_t)v;
        }
    }

    const double two_E = std::pow(2.0, E);
    const double ten_D = std::pow(10.0, D);
#pragma omp parallel for schedule(static)
    for (int64_t px = 0; px < (int64_t)width * height; ++px) {
        const uint8_t* p = img.data() + px * bpp;
        uint64_t x = 0;
        for (int b = 0; b < bpp; ++b) x = (x << 8) | p[b];
        out[px] = scale_value((double)x, R, two_E, ten_D);
    }
    return 0;
}

}  // extern "C"
