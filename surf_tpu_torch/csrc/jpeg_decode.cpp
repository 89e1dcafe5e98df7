// JPEG (ITU T.81) for the port's JPEG reader, io/jpeg.py: baseline and
// extended sequential (SOF0/SOF1) and progressive (SOF2) frames, 8-bit
// samples, Huffman coding.  The pixels equal libjpeg-turbo's as Pillow
// calls it (`np.array(PIL.Image.open(path))`): its arithmetic is copied
// step for step, integer only, so the result does not depend on compiler
// flags.
//
// * entropy decoding as jdhuff.c (derived tables, HUFF_EXTEND, the DC
//   prediction kept in an int and stored in a 16-bit coefficient, AC runs
//   past coefficient 63 land on 63 as jpeg_natural_order's extra entries
//   make them), restart intervals (DRI / RSTn), 0xFF00 stuffing and
//   0xFF fill bytes;
// * progressive scans as jdphuff.c (Annex G): DC first and refinement, AC
//   first (EOB runs, ZRL) and AC refinement (correction bits), into one
//   16-bit coefficient buffer a component for the whole image, scans
//   checked as start_pass_phuff_decoder and jdinput.c check them (a
//   progression libjpeg warns about as JWRN_BOGUS_PROGRESSION raises
//   here), each component's quantization table latched at its first scan
//   (latch_quant_tables), the IDCT run once at EOI.  A progression that
//   leaves any coefficient short of its last refinement (Al = 0) raises:
//   libjpeg smooths such blocks (jdcoefct.c), which this decoder does not
//   repeat; once every coefficient is complete libjpeg does not smooth, so
//   the pixels are those of the baseline file with the same coefficients;
// * jidctint.c's jpeg_idct_islow (CONST_BITS 13, PASS1_BITS 2, its DC-only
//   column shortcut) with the final descale through jdmaster.c's
//   range-limit table;
// * jdsample.c's upsamplers: fancy (triangle) h2v1, h2v2 and h1v2, box
//   h2v1 / h2v2 where the component's downsampled width is 2 or less, and
//   int_upsample for other integral factors; the edges as jdmainct.c's
//   context rows give them (the first and last real rows and columns
//   repeated).  Pillow leaves do_fancy_upsampling on, so the merged
//   upsampler (jdmerge.c) is not used;
// * jdcolor.c's YCbCr -> RGB tables (SCALEBITS 16), the colour space
//   chosen as jdapimin.c's default_decompress_parms chooses it (JFIF,
//   Adobe APP14 transform, component ids).
//
// Everything else raises (returns -1 with a message): lossless,
// hierarchical and arithmetic-coded files, sample precisions other than 8,
// 2- and 4-component images (CMYK, YCCK), DNL, bad or incomplete
// progressions, corrupt Huffman codes and truncated data.  Nothing is
// guessed.
//
// The same file holds an encoder with the Annex K tables at 4:4:4, 4:2:2
// and 4:2:0, baseline or progressive (libjpeg's jpeg_simple_progression
// script), a test and scene-writing fixture: the port's loaders only
// decode.
//
// C ABI for ctypes:
//   jpeg_header(buf, len, dims[3], err, errlen) -> 0 | -1: height, width,
//       channels (1 or 3) of the output
//   jpeg_decode(buf, len, out, out_size, err, errlen) -> 0 | -1: the
//       (H, W, channels) uint8 pixels into out
//   jpeg_encode(px, h, w, c, quality, subsampling, progressive, size, err,
//       errlen) -> malloc'd bytes (free with jpeg_free) | null: c is 1 or
//       3, subsampling 0 (4:4:4), 1 (4:2:2) or 2 (4:2:0), progressive 0
//       or 1

#include <algorithm>
#include <cmath>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Failure {
    std::string msg;
};

[[noreturn]] void fail(const char* fmt, ...) {
    char buf[256];
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(buf, sizeof(buf), fmt, ap);
    va_end(ap);
    throw Failure{buf};
}

// zigzag position -> natural (row-major) index, with libjpeg's 16 extra
// entries so that a corrupt run past 63 stores into 63
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// Annex K.3 tables: code counts for lengths 1..16, then the symbols
const uint8_t kDcLumBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// Annex K.1 quantization tables, natural order
const int kLumQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// ---------------------------------------------------------------------------
// decoding
// ---------------------------------------------------------------------------

constexpr int kLookBits = 9;

// jdhuff.c's d_derived_tbl
struct HuffTable {
    bool defined = false;
    uint8_t bits[17] = {};
    uint8_t vals[256] = {};
    int64_t maxcode[18] = {};
    int64_t valoffset[18] = {};
    // (code length << 8) | symbol for every 9-bit prefix; 0: longer code
    uint16_t look[1 << kLookBits] = {};
};

void derive(HuffTable& t, bool is_dc) {
    char huffsize[257];
    unsigned huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
        int i = t.bits[l];
        if (p + i > 256) fail("bad Huffman table: more than 256 codes");
        while (i--) huffsize[p++] = (char)l;
    }
    huffsize[p] = 0;
    const int numsymbols = p;
    unsigned code = 0;
    int si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
        while ((int)huffsize[p] == si) huffcode[p++] = code++;
        if ((int64_t)code >= ((int64_t)1 << si)) fail("bad Huffman table: code lengths overflow");
        code <<= 1;
        ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
        if (t.bits[l]) {
            t.valoffset[l] = (int64_t)p - (int64_t)huffcode[p];
            p += t.bits[l];
            t.maxcode[l] = huffcode[p - 1];
        } else {
            t.maxcode[l] = -1;
        }
    }
    t.valoffset[17] = 0;
    t.maxcode[17] = 0xFFFFF;
    std::memset(t.look, 0, sizeof(t.look));
    p = 0;
    for (int l = 1; l <= kLookBits; ++l) {
        for (int i = 1; i <= (int)t.bits[l]; ++i, ++p) {
            int look = (int)huffcode[p] << (kLookBits - l);
            for (int ctr = 1 << (kLookBits - l); ctr > 0; --ctr)
                t.look[look++] = (uint16_t)((l << 8) | t.vals[p]);
        }
    }
    if (is_dc) {
        for (int i = 0; i < numsymbols; ++i)
            if (t.vals[i] > 15) fail("bad Huffman table: DC symbol %d above 15", t.vals[i]);
    }
    t.defined = true;
}

void std_table(HuffTable& t, const uint8_t* bits, const uint8_t* vals, int n, bool is_dc) {
    t.bits[0] = 0;
    std::memcpy(t.bits + 1, bits, 16);
    std::memcpy(t.vals, vals, n);
    derive(t, is_dc);
}

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int td = 0, ta = 0;             // the scan's DC / AC table
    int width_in_blocks = 0, height_in_blocks = 0;
    int dw = 0, dh = 0;             // downsampled width and height
    int bw = 0, bh = 0;             // blocks allocated (whole MCUs)
    int64_t stride = 0;
    std::vector<uint8_t> plane;
    int pred = 0;                   // last DC value
    bool scanned = false;
    // progressive frames: the whole image's coefficients (bw x bh blocks
    // of 64, natural order; at ETH3D's 4141x6212 about 77 MB over the
    // three components at 4:2:0, 154 MB at 4:4:4), each coefficient's
    // current Al (-1: no scan yet, as jdinput.c's coef_bits) and the
    // quantization table latched at the component's first scan
    std::vector<int16_t> coef;
    int coef_bits[64];
    int16_t qt[64] = {};
    Component() { std::fill(coef_bits, coef_bits + 64, -1); }
};

// entropy-coded bytes with 0xFF00 unstuffed, stopping at the first marker;
// past it (or past the end of the file) zeros are supplied, and their count
// says whether a decode used them
struct BitReader {
    const uint8_t* p;
    const uint8_t* end;
    uint64_t acc = 0;
    int nbits = 0;
    int64_t pad = 0;                // zero bits appended after the data ended
    bool stopped = false;           // at a marker or the end of the file
    const uint8_t* marker = nullptr;  // the 0xFF that starts that marker

    void fill() {
        while (nbits <= 56) {
            unsigned b = 0;
            if (stopped) {
                pad += 8;
            } else if (p >= end) {
                stopped = true;
                pad += 8;
            } else if (*p != 0xFF) {
                b = *p++;
            } else {
                const uint8_t* q = p + 1;
                while (q < end && *q == 0xFF) ++q;        // fill bytes
                if (q < end && *q == 0) {
                    b = 0xFF;
                    p = q + 1;
                } else {
                    stopped = true;
                    marker = q < end ? q - 1 : nullptr;
                    p = q < end ? q - 1 : end;
                    pad += 8;
                }
            }
            acc = (acc << 8) | b;
            nbits += 8;
        }
    }
    unsigned peek(int n) {
        if (nbits < n) fill();
        return (unsigned)(acc >> (nbits - n)) & ((1u << n) - 1);
    }
    void skip(int n) { nbits -= n; }
    unsigned get(int n) {
        unsigned v = peek(n);
        nbits -= n;
        return v;
    }
    bool overran() const { return pad > nbits; }
    // drop the rest of the current byte-aligned segment (a restart)
    void reset() {
        acc = 0;
        nbits = 0;
        pad = 0;
    }
};

// the scan's data ran out: the file's end, or a marker before its last block
[[noreturn]] void fail_data_end(const BitReader& br) {
    if (br.stopped && br.marker == nullptr) fail("truncated data: the file ends inside the scan");
    fail("corrupt data: the scan's data ends before its last block");
}

inline int decode_huff(BitReader& br, const HuffTable& t) {
    const unsigned look = br.peek(kLookBits);
    const unsigned e = t.look[look];
    if (e) {
        br.skip((int)(e >> 8));
        return e & 0xFF;
    }
    const unsigned code16 = br.peek(16);
    for (int l = kLookBits + 1; l <= 16; ++l) {
        const int64_t code = code16 >> (16 - l);
        if (code <= t.maxcode[l]) {
            br.skip(l);
            return t.vals[(int)(code + t.valoffset[l])];
        }
    }
    if (br.pad > br.nbits - 16) fail_data_end(br);    // a code read from past the data
    fail("corrupt data: bad Huffman code");
}

inline int extend(unsigned r, int s) {
    return (int)r < (1 << (s - 1)) ? (int)r + (int)((~0u) << s) + 1 : (int)r;
}

// jdmaster.c's post-IDCT range limit: the descaled value's low 10 bits,
// read as signed, plus 128, clamped to [0, 255]
uint8_t kIdctLimit[1024];

void init_limit() {
    for (int x = 0; x < 1024; ++x)
        kIdctLimit[x] = (uint8_t)(x < 128 ? x + 128 : x < 512 ? 255 : x < 896 ? 0 : x - 896);
}

// jidctint.c: jpeg_idct_islow
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

void idct_islow(const int16_t* coef, const int16_t* quant, uint8_t* out, int64_t stride) {
    int ws[64];
    for (int c = 0; c < 8; ++c) {
        const int16_t* in = coef + c;
        const int16_t* q = quant + c;
        int* w = ws + c;
        if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 &&
            in[48] == 0 && in[56] == 0) {
            const int dc = (int)(((int64_t)in[0] * q[0]) * (1 << kPass1Bits));
            for (int r = 0; r < 8; ++r) w[8 * r] = dc;
            continue;
        }
        int64_t z2 = (int64_t)in[16] * q[16], z3 = (int64_t)in[48] * q[48];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = (int64_t)in[0] * q[0];
        z3 = (int64_t)in[32] * q[32];
        int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
        int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
        const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = (int64_t)in[56] * q[56];
        tmp1 = (int64_t)in[40] * q[40];
        tmp2 = (int64_t)in[24] * q[24];
        tmp3 = (int64_t)in[8] * q[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        const int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        constexpr int n = kConstBits - kPass1Bits;
        w[0] = (int)descale(tmp10 + tmp3, n);
        w[56] = (int)descale(tmp10 - tmp3, n);
        w[8] = (int)descale(tmp11 + tmp2, n);
        w[48] = (int)descale(tmp11 - tmp2, n);
        w[16] = (int)descale(tmp12 + tmp1, n);
        w[40] = (int)descale(tmp12 - tmp1, n);
        w[24] = (int)descale(tmp13 + tmp0, n);
        w[32] = (int)descale(tmp13 - tmp0, n);
    }
    constexpr int n2 = kConstBits + kPass1Bits + 3;
    for (int r = 0; r < 8; ++r) {
        const int* w = ws + 8 * r;
        uint8_t* o = out + r * stride;
        if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 &&
            w[7] == 0) {
            const uint8_t dc = kIdctLimit[(int)descale(w[0], kPass1Bits + 3) & 1023];
            std::memset(o, dc, 8);
            continue;
        }
        int64_t z2 = w[2], z3 = w[6];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << kConstBits);
        int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << kConstBits);
        const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = w[7];
        tmp1 = w[5];
        tmp2 = w[3];
        tmp3 = w[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        const int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        o[0] = kIdctLimit[(int)descale(tmp10 + tmp3, n2) & 1023];
        o[7] = kIdctLimit[(int)descale(tmp10 - tmp3, n2) & 1023];
        o[1] = kIdctLimit[(int)descale(tmp11 + tmp2, n2) & 1023];
        o[6] = kIdctLimit[(int)descale(tmp11 - tmp2, n2) & 1023];
        o[2] = kIdctLimit[(int)descale(tmp12 + tmp1, n2) & 1023];
        o[5] = kIdctLimit[(int)descale(tmp12 - tmp1, n2) & 1023];
        o[3] = kIdctLimit[(int)descale(tmp13 + tmp0, n2) & 1023];
        o[4] = kIdctLimit[(int)descale(tmp13 - tmp0, n2) & 1023];
    }
}

enum class ColorSpace { kGray, kYCbCr, kRGB };

struct Decoder {
    const uint8_t* buf;
    const uint8_t* end;
    const uint8_t* pos;
    int width = 0, height = 0, ncomp = 0;
    int max_h = 1, max_v = 1;
    bool have_frame = false, saw_jfif = false, saw_adobe = false, progressive = false;
    int adobe_transform = 0;
    ColorSpace space = ColorSpace::kGray;   // fixed at the first scan, as libjpeg's
    int restart_interval = 0;
    std::vector<Component> comps;
    int16_t quant[4][64] = {};
    bool quant_defined[4] = {};
    HuffTable dc[4], ac[4];

    Decoder(const uint8_t* b, int64_t len) : buf(b), end(b + len), pos(b) {}

    unsigned byte() {
        if (pos >= end) fail("truncated file: it ends inside a marker segment");
        return *pos++;
    }
    unsigned word() {
        unsigned hi = byte();
        return (hi << 8) | byte();
    }
    // the next marker code: fill bytes skipped; anything else before the
    // 0xFF is garbage, which libjpeg skips with a warning
    int next_marker() {
        while (pos < end && *pos != 0xFF) ++pos;
        while (pos < end && *pos == 0xFF) ++pos;
        if (pos >= end) return -1;
        return *pos++;
    }
    // a segment's bytes after its 2-byte length
    const uint8_t* segment(unsigned& n) {
        const unsigned len = word();
        if (len < 2) fail("bad marker segment length %u", len);
        n = len - 2;
        if ((int64_t)n > end - pos) fail("truncated file: a marker segment runs past its end");
        const uint8_t* s = pos;
        pos += n;
        return s;
    }

    void read_sof(int code) {
        unsigned n;
        const uint8_t* s = segment(n);
        if (have_frame) fail("a second SOF marker");
        if (n < 6) fail("bad SOF segment");
        const int precision = s[0];
        height = (s[1] << 8) | s[2];
        width = (s[3] << 8) | s[4];
        ncomp = s[5];
        if (precision != 8)
            fail("%d-bit samples (SOF%d) are not supported: only 8-bit", precision, code - 0xC0);
        if (height == 0)
            fail("image height 0: a height defined by a DNL marker is not supported");
        if (width == 0) fail("image width 0");
        if (ncomp == 4) fail("4-component (CMYK/YCCK) JPEG is not supported");
        if (ncomp != 1 && ncomp != 3) fail("%d-component JPEG is not supported", ncomp);
        if (n != 6u + 3u * ncomp) fail("bad SOF segment length");
        progressive = code == 0xC2;
        comps.resize(ncomp);
        for (int i = 0; i < ncomp; ++i) {
            Component& c = comps[i];
            c.id = s[6 + 3 * i];
            c.h = s[7 + 3 * i] >> 4;
            c.v = s[7 + 3 * i] & 15;
            c.tq = s[8 + 3 * i];
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail("bad sampling factors");
            if (c.tq > 3) fail("bad quantization table id %d", c.tq);
            max_h = c.h > max_h ? c.h : max_h;
            max_v = c.v > max_v ? c.v : max_v;
        }
        const int mcux = (width + 8 * max_h - 1) / (8 * max_h);
        const int mcuy = (height + 8 * max_v - 1) / (8 * max_v);
        for (Component& c : comps) {
            c.width_in_blocks = (int)(((int64_t)width * c.h + 8 * max_h - 1) / (8 * max_h));
            c.height_in_blocks = (int)(((int64_t)height * c.v + 8 * max_v - 1) / (8 * max_v));
            c.dw = (int)(((int64_t)width * c.h + max_h - 1) / max_h);
            c.dh = (int)(((int64_t)height * c.v + max_v - 1) / max_v);
            c.bw = mcux * c.h;
            c.bh = mcuy * c.v;
            c.stride = (int64_t)c.bw * 8;
        }
        have_frame = true;
    }

    void read_dqt() {
        unsigned n;
        const uint8_t* s = segment(n);
        unsigned i = 0;
        while (i < n) {
            const int pq = s[i] >> 4, tq = s[i] & 15;
            ++i;
            if (tq > 3) fail("bad quantization table id %d", tq);
            if (pq > 1) fail("bad quantization table precision %d", pq);
            if (i + (pq ? 128u : 64u) > n) fail("bad DQT segment length");
            for (int k = 0; k < 64; ++k) {
                unsigned q = pq ? (s[i] << 8) | s[i + 1] : s[i];
                i += pq ? 2 : 1;
                // libjpeg-turbo's (SIMD build's) 16-bit multiplier type
                quant[tq][kNatural[k]] = (int16_t)q;
            }
            quant_defined[tq] = true;
        }
    }

    void read_dht() {
        unsigned n;
        const uint8_t* s = segment(n);
        unsigned i = 0;
        while (i < n) {
            if (i + 17 > n) fail("bad DHT segment length");
            const int tc = s[i] >> 4, th = s[i] & 15;
            if (tc > 1 || th > 3) fail("bad Huffman table class %d / id %d", tc, th);
            HuffTable& t = tc ? ac[th] : dc[th];
            t.bits[0] = 0;
            int count = 0;
            for (int l = 1; l <= 16; ++l) {
                t.bits[l] = s[i + l];
                count += t.bits[l];
            }
            i += 17;
            if (count > 256 || i + count > n) fail("bad Huffman table: %d codes", count);
            std::memset(t.vals, 0, sizeof(t.vals));
            std::memcpy(t.vals, s + i, count);
            i += count;
            derive(t, tc == 0);
        }
    }

    void read_app(int code) {
        unsigned n;
        const uint8_t* s = segment(n);
        if (code == 0xE0 && n >= 14 && std::memcmp(s, "JFIF\0", 5) == 0) saw_jfif = true;
        if (code == 0xEE && n >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
            saw_adobe = true;
            adobe_transform = s[11];
        }
    }

    ColorSpace color_space() const {
        if (ncomp == 1) return ColorSpace::kGray;
        if (saw_jfif) return ColorSpace::kYCbCr;
        if (saw_adobe) return adobe_transform == 0 ? ColorSpace::kRGB : ColorSpace::kYCbCr;
        if (comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66) return ColorSpace::kRGB;
        return ColorSpace::kYCbCr;
    }

    // parse up to the frame header; for jpeg_header
    void header() {
        init_frame();
        for (;;) {
            const int code = next_marker();
            if (code < 0) fail("truncated file: no SOF marker");
            if (dispatch(code)) return;
        }
    }

    void init_frame() {
        if (end - buf < 2 || buf[0] != 0xFF || buf[1] != 0xD8) fail("not a JPEG file (no SOI)");
        pos = buf + 2;
    }

    // one marker; true once the frame header is read (header()) or at
    // SOS (decode())
    bool dispatch(int code) {
        switch (code) {
        case 0xC0: case 0xC1: case 0xC2:
            read_sof(code);
            return true;
        case 0xC3:
            fail("lossless JPEG (SOF3) is not supported");
        case 0xC5: case 0xC6: case 0xC7: case 0xDE: case 0xDF:
            fail("hierarchical JPEG (marker 0x%02X) is not supported", code);
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF: case 0xCC:
            fail("arithmetic-coded JPEG (marker 0x%02X) is not supported", code);
        case 0xC8:
            fail("reserved JPG marker 0xC8");
        case 0xC4:
            read_dht();
            return false;
        case 0xDB:
            read_dqt();
            return false;
        case 0xDD: {
            unsigned n;
            const uint8_t* s = segment(n);
            if (n != 2) fail("bad DRI segment length");
            restart_interval = (s[0] << 8) | s[1];
            return false;
        }
        case 0xDC:
            fail("DNL marker: a height defined after the scan is not supported");
        case 0xD8:
            fail("a second SOI marker");
        case 0xD9:
            fail("truncated file: EOI before the image data");
        case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5: case 0xD6:
        case 0xD7: case 0x01:
            return false;                         // parameterless, ignored
        case 0xDA:
            if (!have_frame) fail("SOS before SOF");
            return true;
        default:
            if ((code >= 0xE0 && code <= 0xEF) || code == 0xFE) {
                read_app(code);
                return false;
            }
            fail("unknown marker 0x%02X", code);
        }
    }

    void decode_block(BitReader& br, Component& c, int16_t* blk) {
        std::memset(blk, 0, 64 * sizeof(int16_t));
        const HuffTable& dt = dc[c.td];
        const HuffTable& at = ac[c.ta];
        int s = decode_huff(br, dt);
        if (s) s = extend(br.get(s), s);
        s += c.pred;
        c.pred = s;
        blk[0] = (int16_t)s;
        for (int k = 1; k < 64; ++k) {
            int rs = decode_huff(br, at);
            const int r = rs >> 4;
            s = rs & 15;
            if (s) {
                k += r;
                blk[kNatural[k]] = (int16_t)extend(br.get(s), s);
            } else {
                if (r != 15) break;
                k += 15;
            }
        }
    }

    // the Huffman table a scan uses; jstdhuff.c: a missing table 0 or 1 is
    // Annex K's (Motion-JPEG)
    void need_table(bool is_ac, int id) {
        HuffTable& t = is_ac ? ac[id] : dc[id];
        if (t.defined) return;
        if (id > 1) fail("Huffman table %d is not defined", id);
        if (!is_ac)
            std_table(t, id ? kDcChromBits : kDcLumBits, kDcVals, 12, true);
        else
            std_table(t, id ? kAcChromBits : kAcLumBits, id ? kAcChromVals : kAcLumVals, 162,
                      false);
    }

    // at the start of each restart interval but the first: the RSTn that
    // must end the last one, and the bit reader started after it
    void restart(BitReader& br, int& next_rst) {
        const uint8_t* q = br.marker;
        if (q == nullptr) {
            q = br.p;
            while (q < end && !(q[0] == 0xFF && q + 1 < end && q[1] != 0 && q[1] != 0xFF))
                ++q;
        }
        if (q + 1 >= end) fail("truncated data: the file ends inside the scan");
        if (q[1] != 0xD0 + next_rst)
            fail("corrupt data: marker 0x%02X where RST%d was due", q[1], next_rst);
        next_rst = (next_rst + 1) & 7;
        br = BitReader{q + 2, end};
    }

    static void check_overrun(const BitReader& br) {
        if (br.overran()) fail_data_end(br);
    }

    void read_scan() {
        unsigned n;
        const uint8_t* s = segment(n);
        if (n < 1) fail("bad SOS segment");
        const int ns = s[0];
        if (ns < 1 || ns > 4 || n != 4u + 2u * ns) fail("bad SOS segment");
        // spectral selection and successive approximation (progressive only)
        const int Ss = s[1 + 2 * ns], Se = s[2 + 2 * ns];
        const int Ah = s[3 + 2 * ns] >> 4, Al = s[3 + 2 * ns] & 15;
        if (progressive) {
            // jdphuff.c start_pass_phuff_decoder's JERR_BAD_PROGRESSION
            const bool bad = (Ss == 0 ? Se != 0 : (Ss > Se || Se > 63 || ns != 1)) ||
                             (Ah != 0 && Al != Ah - 1) || Al > 13;
            if (bad)
                fail("bad progression: a scan of %d components with Ss %d, Se %d, Ah %d, Al %d",
                     ns, Ss, Se, Ah, Al);
        }
        if (std::none_of(comps.begin(), comps.end(),
                         [](const Component& c) { return c.scanned; }))
            space = color_space();
        std::vector<Component*> in_scan;
        int blocks_per_mcu = 0;
        for (int i = 0; i < ns; ++i) {
            const int id = s[1 + 2 * i];
            Component* c = nullptr;
            for (Component& cc : comps)
                if (cc.id == id) c = &cc;
            if (c == nullptr) fail("SOS names component %d, which the frame lacks", id);
            if (std::find(in_scan.begin(), in_scan.end(), c) != in_scan.end())
                fail("SOS names component %d twice", id);
            if (!progressive && c->scanned) fail("component %d in a second scan", id);
            c->td = s[2 + 2 * i] >> 4;
            c->ta = s[2 + 2 * i] & 15;
            if (c->td > 3 || c->ta > 3) fail("bad Huffman table id in SOS");
            if (!c->scanned) {
                // jdinput.c latch_quant_tables: the table in force now
                if (!quant_defined[c->tq]) fail("quantization table %d is not defined", c->tq);
                std::memcpy(c->qt, quant[c->tq], sizeof(c->qt));
            }
            if (!progressive || (Ss == 0 && Ah == 0)) need_table(false, c->td);
            if (!progressive || Ss > 0) need_table(true, c->ta);
            c->scanned = true;
            c->pred = 0;
            in_scan.push_back(c);
            blocks_per_mcu += ns > 1 ? c->h * c->v : 1;
        }
        if (blocks_per_mcu > 10) fail("bad MCU: %d blocks", blocks_per_mcu);
        if (progressive) {
            progressive_scan(in_scan, Ss, Se, Ah, Al);
            return;
        }

        int mcux, mcuy;
        if (ns == 1) {
            mcux = in_scan[0]->width_in_blocks;
            mcuy = in_scan[0]->height_in_blocks;
        } else {
            mcux = (width + 8 * max_h - 1) / (8 * max_h);
            mcuy = (height + 8 * max_v - 1) / (8 * max_v);
        }
        for (Component* c : in_scan)
            if (c->plane.empty()) c->plane.assign((size_t)c->stride * c->bh * 8, 0);

        BitReader br{pos, end};
        int16_t blk[64];
        int next_rst = 0;
        const int64_t total = (int64_t)mcux * mcuy;
        for (int64_t m = 0; m < total; ++m) {
            if (restart_interval && m > 0 && m % restart_interval == 0) {
                restart(br, next_rst);
                for (Component* c : in_scan) c->pred = 0;
            }
            const int my = (int)(m / mcux), mx = (int)(m % mcux);
            for (Component* c : in_scan) {
                const int nh = ns > 1 ? c->h : 1, nv = ns > 1 ? c->v : 1;
                for (int bv = 0; bv < nv; ++bv) {
                    for (int bh = 0; bh < nh; ++bh) {
                        decode_block(br, *c, blk);
                        const int64_t by = (int64_t)my * nv + bv, bx = (int64_t)mx * nh + bh;
                        idct_islow(blk, quant[c->tq], c->plane.data() + by * 8 * c->stride + bx * 8,
                                   c->stride);
                    }
                }
            }
            check_overrun(br);
        }
        // on to the marker after the scan's data
        pos = br.marker ? br.marker : br.p;
    }

    // -- progressive scans (jdphuff.c), into the components' coefficients --

    void dc_first(BitReader& br, Component& c, int16_t* blk, int Al) {
        int s = decode_huff(br, dc[c.td]);
        if (s) s = extend(br.get(s), s);
        s += c.pred;
        c.pred = s;
        blk[0] = (int16_t)((unsigned)s << Al);
    }

    static void dc_refine(BitReader& br, int16_t* blk, int Al) {
        if (br.get(1)) blk[0] = (int16_t)(blk[0] | (1 << Al));
    }

    void ac_first(BitReader& br, const Component& c, int16_t* blk, int Ss, int Se, int Al,
                  int& eobrun) {
        if (eobrun > 0) {
            --eobrun;
            return;
        }
        const HuffTable& t = ac[c.ta];
        for (int k = Ss; k <= Se; ++k) {
            int s = decode_huff(br, t);
            const int r = s >> 4;
            s &= 15;
            if (s) {
                k += r;
                blk[kNatural[k]] = (int16_t)((unsigned)extend(br.get(s), s) << Al);
            } else if (r == 15) {
                k += 15;                           // ZRL
            } else {
                eobrun = 1 << r;                   // EOBr: 2^r + r bits blocks
                if (r) eobrun += (int)br.get(r);
                --eobrun;                          // this block is one of them
                break;
            }
        }
    }

    // decode_mcu_AC_refine: a correction bit for each coefficient already
    // nonzero that a run passes, and for those past the band's last new one
    // in an EOB run
    void ac_refine(BitReader& br, const Component& c, int16_t* blk, int Ss, int Se, int Al,
                   int& eobrun) {
        const int p1 = 1 << Al, m1 = -(1 << Al);
        auto correct = [&](int16_t& co) {
            if (br.get(1) && (co & p1) == 0) co = (int16_t)(co >= 0 ? co + p1 : co + m1);
        };
        int k = Ss;
        if (eobrun == 0) {
            const HuffTable& t = ac[c.ta];
            for (; k <= Se; ++k) {
                int s = decode_huff(br, t);
                int r = s >> 4;
                s &= 15;
                if (s) {
                    if (s != 1) {
                        check_overrun(br);
                        fail("corrupt data: a refinement's new coefficient of size %d", s);
                    }
                    s = br.get(1) ? p1 : m1;
                } else if (r != 15) {
                    eobrun = 1 << r;
                    if (r) eobrun += (int)br.get(r);
                    break;
                }
                // past the coefficients already nonzero and r zero ones
                do {
                    int16_t& co = blk[kNatural[k]];
                    if (co != 0)
                        correct(co);
                    else if (--r < 0)
                        break;
                    ++k;
                } while (k <= Se);
                if (s) blk[kNatural[k]] = (int16_t)s;
            }
        }
        if (eobrun > 0) {
            for (; k <= Se; ++k) {
                int16_t& co = blk[kNatural[k]];
                if (co != 0) correct(co);
            }
            --eobrun;
        }
    }

    void progressive_scan(const std::vector<Component*>& in_scan, int Ss, int Se, int Ah,
                          int Al) {
        // jdinput.c's coef_bits: libjpeg warns (JWRN_BOGUS_PROGRESSION) and
        // goes on; here it raises
        for (Component* c : in_scan) {
            if (Ss > 0 && c->coef_bits[0] < 0)
                fail("bogus progression: an AC scan of component %d before its first DC scan",
                     c->id);
            for (int k = Ss; k <= Se; ++k) {
                const int expected = c->coef_bits[k] < 0 ? 0 : c->coef_bits[k];
                if (Ah != expected)
                    fail("bogus progression: component %d, coefficient %d: a scan with Ah %d "
                         "where its bits stand at %d", c->id, k, Ah, c->coef_bits[k]);
                c->coef_bits[k] = Al;
            }
            if (c->coef.empty()) c->coef.assign((size_t)c->bw * c->bh * 64, 0);
        }
        const int ns = (int)in_scan.size();
        int mcux, mcuy;
        if (ns == 1) {
            mcux = in_scan[0]->width_in_blocks;
            mcuy = in_scan[0]->height_in_blocks;
        } else {
            mcux = (width + 8 * max_h - 1) / (8 * max_h);
            mcuy = (height + 8 * max_v - 1) / (8 * max_v);
        }
        BitReader br{pos, end};
        int next_rst = 0, eobrun = 0;
        const int64_t total = (int64_t)mcux * mcuy;
        for (int64_t m = 0; m < total; ++m) {
            if (restart_interval && m > 0 && m % restart_interval == 0) {
                restart(br, next_rst);
                for (Component* c : in_scan) c->pred = 0;
                eobrun = 0;
            }
            const int64_t my = m / mcux, mx = m % mcux;
            if (ns > 1) {                          // interleaved: DC only
                for (Component* c : in_scan)
                    for (int bv = 0; bv < c->v; ++bv)
                        for (int bh = 0; bh < c->h; ++bh) {
                            int16_t* blk = c->coef.data() +
                                           ((my * c->v + bv) * c->bw + mx * c->h + bh) * 64;
                            if (Ah == 0)
                                dc_first(br, *c, blk, Al);
                            else
                                dc_refine(br, blk, Al);
                        }
            } else {
                Component& c = *in_scan[0];
                int16_t* blk = c.coef.data() + (my * c.bw + mx) * 64;
                if (Ss == 0)
                    Ah == 0 ? dc_first(br, c, blk, Al) : dc_refine(br, blk, Al);
                else if (Ah == 0)
                    ac_first(br, c, blk, Ss, Se, Al, eobrun);
                else
                    ac_refine(br, c, blk, Ss, Se, Al, eobrun);
            }
            check_overrun(br);
        }
        pos = br.marker ? br.marker : br.p;
    }

    // at EOI: every coefficient at its last refinement, then the IDCT of
    // every block of the image with the latched tables
    void finish_progressive() {
        for (Component& c : comps) {
            for (int k = 0; k < 64; ++k)
                if (c.coef_bits[k] != 0)
                    fail("incomplete progression: component %d, coefficient %d ends at bit %d, "
                         "not 0", c.id, k, c.coef_bits[k]);
        }
        for (Component& c : comps) {
            c.plane.assign((size_t)c.stride * c.bh * 8, 0);
            for (int64_t by = 0; by < c.height_in_blocks; ++by)
                for (int64_t bx = 0; bx < c.width_in_blocks; ++bx)
                    idct_islow(c.coef.data() + (by * c.bw + bx) * 64, c.qt,
                               c.plane.data() + by * 8 * c.stride + bx * 8, c.stride);
            std::vector<int16_t>().swap(c.coef);
        }
    }

    void decode(uint8_t* out, int64_t out_size) {
        init_frame();
        for (;;) {
            const int code = next_marker();
            if (code < 0 || code == 0xD9) break;
            if (code == 0xDA) {
                if (!have_frame) fail("SOS before SOF");
                read_scan();
                continue;
            }
            dispatch(code);
        }
        if (!have_frame) fail("truncated file: no SOF marker");
        if (out_size != (int64_t)height * width * (ncomp == 1 ? 1 : 3))
            fail("output buffer of %lld bytes for a %dx%dx%d image", (long long)out_size, height,
                 width, ncomp == 1 ? 1 : 3);
        for (const Component& c : comps)
            if (!c.scanned) fail("truncated file: component %d has no scan", c.id);
        if (progressive) finish_progressive();
        convert(out);
    }

    // one upsampled row of component c for output row y, W samples
    void upsample_row(const Component& c, int y, uint8_t* row, std::vector<int>& colsum) const {
        const int W = width;
        const uint8_t* P = c.plane.data();
        const int64_t st = c.stride;
        const int hx = max_h / c.h, vx = max_v / c.v;
        if (hx == 1 && vx == 1) {
            std::memcpy(row, P + (int64_t)y * st, W);
            return;
        }
        const int dw = c.dw, dh = c.dh;
        if (hx == 2 && vx == 1 && c.h * 2 == max_h) {
            const uint8_t* in = P + (int64_t)y * st;
            if (dw > 2) {
                for (int j = 0; j < dw && 2 * j < W; ++j) {
                    const int t = in[j] * 3;
                    const int l = in[j > 0 ? j - 1 : 0], r = in[j + 1 < dw ? j + 1 : dw - 1];
                    row[2 * j] = (uint8_t)((t + l + 1) >> 2);
                    if (2 * j + 1 < W) row[2 * j + 1] = (uint8_t)((t + r + 2) >> 2);
                }
            } else {
                for (int x = 0; x < W; ++x) row[x] = in[x >> 1];
            }
            return;
        }
        if (hx == 1 && vx == 2 && c.v * 2 == max_v) {
            const int i = y >> 1;
            const int far = (y & 1) ? (i + 1 < dh ? i + 1 : dh - 1) : (i > 0 ? i - 1 : 0);
            const int bias = (y & 1) ? 2 : 1;
            const uint8_t* in0 = P + (int64_t)i * st;
            const uint8_t* in1 = P + (int64_t)far * st;
            for (int x = 0; x < W; ++x) row[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
            return;
        }
        if (hx == 2 && vx == 2 && c.h * 2 == max_h && c.v * 2 == max_v) {
            const int i = y >> 1;
            if (dw > 2) {
                const int far = (y & 1) ? (i + 1 < dh ? i + 1 : dh - 1) : (i > 0 ? i - 1 : 0);
                const uint8_t* in0 = P + (int64_t)i * st;
                const uint8_t* in1 = P + (int64_t)far * st;
                colsum.resize(dw);
                for (int j = 0; j < dw; ++j) colsum[j] = in0[j] * 3 + in1[j];
                for (int j = 0; j < dw && 2 * j < W; ++j) {
                    const int t = colsum[j] * 3;
                    const int l = colsum[j > 0 ? j - 1 : 0], r = colsum[j + 1 < dw ? j + 1 : dw - 1];
                    row[2 * j] = (uint8_t)((t + l + 8) >> 4);
                    if (2 * j + 1 < W) row[2 * j + 1] = (uint8_t)((t + r + 7) >> 4);
                }
            } else {
                const uint8_t* in = P + (int64_t)i * st;
                for (int x = 0; x < W; ++x) row[x] = in[x >> 1];
            }
            return;
        }
        if (max_h % c.h || max_v % c.v) fail("fractional sampling factors are not supported");
        const uint8_t* in = P + (int64_t)(y / vx) * st;
        for (int x = 0; x < W; ++x) row[x] = in[x / hx];
    }

    void convert(uint8_t* out) const {
        const int W = width;
        const ColorSpace cs = space;
        std::vector<std::vector<uint8_t>> rows(ncomp, std::vector<uint8_t>(W));
        std::vector<int> colsum;
        // jdcolor.c build_ycc_rgb_table: SCALEBITS 16
        int cr_r[256], cb_b[256];
        int64_t cr_g[256], cb_g[256];
        constexpr int kScale = 16;
        constexpr int64_t kHalf = (int64_t)1 << (kScale - 1);
        auto fix = [](double x) { return (int64_t)(x * (1 << kScale) + 0.5); };
        for (int i = 0, x = -128; i < 256; ++i, ++x) {
            cr_r[i] = (int)((fix(1.40200) * x + kHalf) >> kScale);
            cb_b[i] = (int)((fix(1.77200) * x + kHalf) >> kScale);
            cr_g[i] = -fix(0.71414) * x;
            cb_g[i] = -fix(0.34414) * x + kHalf;
        }
        auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
        for (int y = 0; y < height; ++y) {
            for (int ci = 0; ci < ncomp; ++ci) upsample_row(comps[ci], y, rows[ci].data(), colsum);
            uint8_t* o = out + (int64_t)y * W * (ncomp == 1 ? 1 : 3);
            if (cs == ColorSpace::kGray) {
                std::memcpy(o, rows[0].data(), W);
            } else if (cs == ColorSpace::kRGB) {
                for (int x = 0; x < W; ++x) {
                    o[3 * x] = rows[0][x];
                    o[3 * x + 1] = rows[1][x];
                    o[3 * x + 2] = rows[2][x];
                }
            } else {
                const uint8_t *Y = rows[0].data(), *Cb = rows[1].data(), *Cr = rows[2].data();
                for (int x = 0; x < W; ++x) {
                    const int yy = Y[x], cb = Cb[x], cr = Cr[x];
                    o[3 * x] = clamp(yy + cr_r[cr]);
                    o[3 * x + 1] = clamp(yy + (int)((cb_g[cb] + cr_g[cr]) >> kScale));
                    o[3 * x + 2] = clamp(yy + cb_b[cb]);
                }
            }
        }
    }
};

void set_error(char* err, int64_t errlen, const std::string& msg) {
    if (err && errlen > 0) {
        std::strncpy(err, msg.c_str(), (size_t)errlen - 1);
        err[errlen - 1] = 0;
    }
}

// ---------------------------------------------------------------------------
// encoding (a fixture: Annex K tables, float DCT; baseline or progressive)
// ---------------------------------------------------------------------------

struct HuffCode {
    uint16_t code[256] = {};
    uint8_t len[256] = {};
};

HuffCode make_codes(const uint8_t* bits, const uint8_t* vals) {
    HuffCode h;
    unsigned code = 0;
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
        for (int i = 0; i < bits[l - 1]; ++i, ++p) {
            h.code[vals[p]] = (uint16_t)code++;
            h.len[vals[p]] = (uint8_t)l;
        }
        code <<= 1;
    }
    return h;
}

struct BitWriter {
    std::vector<uint8_t>& out;
    uint64_t acc = 0;
    int n = 0;
    void put(unsigned code, int len) {
        acc = (acc << len) | (code & ((1u << len) - 1));
        n += len;
        while (n >= 8) {
            const uint8_t b = (uint8_t)(acc >> (n - 8));
            out.push_back(b);
            if (b == 0xFF) out.push_back(0);
            n -= 8;
        }
    }
    void flush() {
        if (n > 0) put((1u << (8 - n)) - 1, 8 - n);
    }
};

void put_marker(std::vector<uint8_t>& out, int code, const std::vector<uint8_t>& body) {
    out.push_back(0xFF);
    out.push_back((uint8_t)code);
    const size_t len = body.size() + 2;
    out.push_back((uint8_t)(len >> 8));
    out.push_back((uint8_t)(len & 0xFF));
    out.insert(out.end(), body.begin(), body.end());
}

struct EncComponent {
    int id, h, v, tq, tbl;
    int pw, ph;                     // plane size: whole MCUs
    std::vector<float> plane;       // samples - 128
    std::vector<int16_t> coef;      // (ph / 8) x (pw / 8) blocks, natural order
    int pred = 0;
};

// the quantized coefficients (natural order) of one 8x8 block of samples
void quantize_block(const float* src, int64_t stride, const float* qdiv, const double (*cosv)[8],
                    int16_t* q) {
    double tmp[64], co[64];
    for (int y = 0; y < 8; ++y)
        for (int u = 0; u < 8; ++u) {
            double s = 0;
            for (int x = 0; x < 8; ++x) s += src[y * stride + x] * cosv[u][x];
            tmp[y * 8 + u] = s;
        }
    for (int v = 0; v < 8; ++v)
        for (int u = 0; u < 8; ++u) {
            double s = 0;
            for (int y = 0; y < 8; ++y) s += tmp[y * 8 + u] * cosv[v][y];
            co[v * 8 + u] = s;
        }
    for (int k = 0; k < 64; ++k) q[k] = (int16_t)std::lround(co[k] / qdiv[k]);
}

int nbits(int v) {
    int a = v < 0 ? -v : v, n = 0;
    while (a) {
        ++n;
        a >>= 1;
    }
    return n;
}

void emit_dc(BitWriter& bw, int diff, const HuffCode& dch) {
    const int s = nbits(diff);
    bw.put(dch.code[s], dch.len[s]);
    if (s) bw.put((unsigned)(diff < 0 ? diff - 1 : diff), s);
}

// one block of a sequential scan
void emit_sequential(BitWriter& bw, const int16_t* q, int& pred, const HuffCode& dch,
                     const HuffCode& ach) {
    emit_dc(bw, q[0] - pred, dch);
    pred = q[0];
    int run = 0;
    for (int k = 1; k < 64; ++k) {
        const int v = q[kNatural[k]];
        if (v == 0) {
            ++run;
            continue;
        }
        while (run > 15) {
            bw.put(ach.code[0xF0], ach.len[0xF0]);
            run -= 16;
        }
        const int s = nbits(v);
        const int rs = (run << 4) | s;
        bw.put(ach.code[rs], ach.len[rs]);
        bw.put((unsigned)(v < 0 ? v - 1 : v), s);
        run = 0;
    }
    if (run > 0) bw.put(ach.code[0], ach.len[0]);
}

// jcphuff.c's encoders for one block of a progressive scan.  Each band
// that ends in zeros ends in an EOB run of one block (EOB0): Annex K's AC
// tables have no longer EOBn symbols.
void emit_ac_first(BitWriter& bw, const int16_t* q, int Ss, int Se, int Al, const HuffCode& ach) {
    int run = 0;
    for (int k = Ss; k <= Se; ++k) {
        const int v = q[kNatural[k]];
        const int t = (v < 0 ? -v : v) >> Al;   // the magnitude's point transform
        if (t == 0) {
            ++run;
            continue;
        }
        while (run > 15) {
            bw.put(ach.code[0xF0], ach.len[0xF0]);
            run -= 16;
        }
        const int s = nbits(t);
        const int rs = (run << 4) | s;
        bw.put(ach.code[rs], ach.len[rs]);
        bw.put((unsigned)(v < 0 ? ~t : t), s);
        run = 0;
    }
    if (run > 0) bw.put(ach.code[0], ach.len[0]);
}

// a refinement: each coefficient new at bit Al as a run of zeros and a
// sign; one correction bit (bit Al) for each coefficient nonzero before,
// sent after the next symbol
void emit_ac_refine(BitWriter& bw, const int16_t* q, int Ss, int Se, int Al,
                    const HuffCode& ach) {
    int mag[64], last_new = 0;
    for (int k = Ss; k <= Se; ++k) {
        const int v = q[kNatural[k]];
        mag[k] = (v < 0 ? -v : v) >> Al;
        if (mag[k] == 1) last_new = k;
    }
    uint8_t corr[64];
    int run = 0, ncorr = 0;
    auto flush_corr = [&]() {
        for (int i = 0; i < ncorr; ++i) bw.put(corr[i], 1);
        ncorr = 0;
    };
    for (int k = Ss; k <= Se; ++k) {
        if (mag[k] == 0) {
            ++run;
            continue;
        }
        while (run > 15 && k <= last_new) {
            bw.put(ach.code[0xF0], ach.len[0xF0]);
            run -= 16;
            flush_corr();
        }
        if (mag[k] > 1) {
            corr[ncorr++] = (uint8_t)(mag[k] & 1);
            continue;
        }
        const int rs = (run << 4) | 1;
        bw.put(ach.code[rs], ach.len[rs]);
        bw.put(q[kNatural[k]] < 0 ? 0u : 1u, 1);
        flush_corr();
        run = 0;
    }
    if (run > 0 || ncorr > 0) {
        bw.put(ach.code[0], ach.len[0]);
        flush_corr();
    }
}

// libjpeg's jpeg_simple_progression: (component or -1 for all, Ss, Se, Ah, Al)
struct ScanSpec {
    int comp, ss, se, ah, al;
};
const ScanSpec kColourScript[10] = {{-1, 0, 0, 0, 1}, {0, 1, 5, 0, 2},  {2, 1, 63, 0, 1},
                                    {1, 1, 63, 0, 1}, {0, 6, 63, 0, 2}, {0, 1, 63, 2, 1},
                                    {-1, 0, 0, 1, 0}, {2, 1, 63, 1, 0}, {1, 1, 63, 1, 0},
                                    {0, 1, 63, 1, 0}};
const ScanSpec kGreyScript[6] = {{-1, 0, 0, 0, 1}, {0, 1, 5, 0, 2},  {0, 6, 63, 0, 2},
                                 {0, 1, 63, 2, 1}, {-1, 0, 0, 1, 0}, {0, 1, 63, 1, 0}};

std::vector<uint8_t> encode(const uint8_t* px, int h, int w, int c, int quality, int sub,
                            bool progressive) {
    if (h < 1 || w < 1 || h > 65535 || w > 65535) fail("image size %dx%d out of range", h, w);
    if (c != 1 && c != 3) fail("%d channels: only 1 or 3", c);
    if (sub < 0 || sub > 2) fail("subsampling %d: only 0 (4:4:4), 1 (4:2:2), 2 (4:2:0)", sub);
    quality = quality < 1 ? 1 : quality > 100 ? 100 : quality;
    const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    uint8_t qt[2][64];
    for (int k = 0; k < 64; ++k) {
        for (int t = 0; t < 2; ++t) {
            long v = ((long)(t ? kChromQuant[k] : kLumQuant[k]) * scale + 50) / 100;
            qt[t][k] = (uint8_t)(v < 1 ? 1 : v > 255 ? 255 : v);
        }
    }
    const int mh = c == 1 ? 1 : (sub >= 1 ? 2 : 1), mv = c == 1 ? 1 : (sub == 2 ? 2 : 1);
    const int mcux = (w + 8 * mh - 1) / (8 * mh), mcuy = (h + 8 * mv - 1) / (8 * mv);
    const int fw = mcux * 8 * mh, fh = mcuy * 8 * mv;     // padded full size
    std::vector<EncComponent> comps;
    comps.push_back({1, mh, mv, 0, 0, fw, fh, {}, {}});
    if (c == 3) {
        comps.push_back({2, 1, 1, 1, 1, fw / mh, fh / mv, {}, {}});
        comps.push_back({3, 1, 1, 1, 1, fw / mh, fh / mv, {}, {}});
    }
    {
        // colour conversion (JFIF) on the edge-replicated padded image
        std::vector<float> full[3];
        for (int ci = 0; ci < c; ++ci) full[ci].resize((size_t)fw * fh);
        for (int y = 0; y < fh; ++y) {
            const int sy = y < h ? y : h - 1;
            for (int x = 0; x < fw; ++x) {
                const int sx = x < w ? x : w - 1;
                const uint8_t* p = px + ((int64_t)sy * w + sx) * c;
                const size_t o = (size_t)y * fw + x;
                if (c == 1) {
                    full[0][o] = p[0];
                } else {
                    const float r = p[0], g = p[1], b = p[2];
                    full[0][o] = 0.299f * r + 0.587f * g + 0.114f * b;
                    full[1][o] = -0.168736f * r - 0.331264f * g + 0.5f * b + 128.0f;
                    full[2][o] = 0.5f * r - 0.418688f * g - 0.081312f * b + 128.0f;
                }
            }
        }
        for (int ci = 0; ci < c; ++ci) {
            EncComponent& e = comps[ci];
            const int fx = ci == 0 ? 1 : mh, fy = ci == 0 ? 1 : mv;
            e.plane.resize((size_t)e.pw * e.ph);
            for (int y = 0; y < e.ph; ++y)
                for (int x = 0; x < e.pw; ++x) {
                    float s = 0;
                    for (int dy = 0; dy < fy; ++dy)
                        for (int dx = 0; dx < fx; ++dx)
                            s += full[ci][(size_t)(y * fy + dy) * fw + x * fx + dx];
                    e.plane[(size_t)y * e.pw + x] = s / (fx * fy) - 128.0f;
                }
        }
    }
    double cosv[8][8];
    for (int u = 0; u < 8; ++u)
        for (int x = 0; x < 8; ++x)
            cosv[u][x] = (u == 0 ? std::sqrt(0.125) : 0.5) * std::cos((2 * x + 1) * u * M_PI / 16);
    float qdiv[2][64];
    for (int t = 0; t < 2; ++t)
        for (int k = 0; k < 64; ++k) qdiv[t][k] = qt[t][k];
    for (EncComponent& e : comps) {
        const int bw = e.pw / 8, bh = e.ph / 8;
        e.coef.resize((size_t)bw * bh * 64);
        for (int64_t by = 0; by < bh; ++by)
            for (int64_t bx = 0; bx < bw; ++bx)
                quantize_block(e.plane.data() + by * 8 * e.pw + bx * 8, e.pw, qdiv[e.tbl], cosv,
                               e.coef.data() + (by * bw + bx) * 64);
        std::vector<float>().swap(e.plane);
    }
    auto block = [](EncComponent& e, int64_t by, int64_t bx) {
        return e.coef.data() + (by * (e.pw / 8) + bx) * 64;
    };

    std::vector<uint8_t> out = {0xFF, 0xD8};
    put_marker(out, 0xE0, {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0});
    for (int t = 0; t < (c == 3 ? 2 : 1); ++t) {
        std::vector<uint8_t> body = {(uint8_t)t};
        for (int k = 0; k < 64; ++k) body.push_back(qt[t][kNatural[k]]);
        put_marker(out, 0xDB, body);
    }
    std::vector<uint8_t> sof = {8, (uint8_t)(h >> 8), (uint8_t)h, (uint8_t)(w >> 8), (uint8_t)w,
                                (uint8_t)c};
    for (const EncComponent& e : comps) {
        sof.push_back((uint8_t)e.id);
        sof.push_back((uint8_t)((e.h << 4) | e.v));
        sof.push_back((uint8_t)e.tq);
    }
    put_marker(out, progressive ? 0xC2 : 0xC0, sof);
    const uint8_t* bits[4] = {kDcLumBits, kAcLumBits, kDcChromBits, kAcChromBits};
    const uint8_t* vals[4] = {kDcVals, kAcLumVals, kDcVals, kAcChromVals};
    const int nvals[4] = {12, 162, 12, 162};
    for (int t = 0; t < (c == 3 ? 4 : 2); ++t) {
        std::vector<uint8_t> body = {(uint8_t)(((t & 1) << 4) | (t >> 1))};
        body.insert(body.end(), bits[t], bits[t] + 16);
        body.insert(body.end(), vals[t], vals[t] + nvals[t]);
        put_marker(out, 0xC4, body);
    }
    const HuffCode dch[2] = {make_codes(kDcLumBits, kDcVals), make_codes(kDcChromBits, kDcVals)};
    const HuffCode ach[2] = {make_codes(kAcLumBits, kAcLumVals),
                             make_codes(kAcChromBits, kAcChromVals)};
    if (!progressive) {
        std::vector<uint8_t> sos = {(uint8_t)c};
        for (const EncComponent& e : comps) {
            sos.push_back((uint8_t)e.id);
            sos.push_back((uint8_t)((e.tbl << 4) | e.tbl));
        }
        sos.insert(sos.end(), {0, 63, 0});
        put_marker(out, 0xDA, sos);
        BitWriter bw{out};
        for (int my = 0; my < mcuy; ++my)
            for (int mx = 0; mx < mcux; ++mx)
                for (EncComponent& e : comps)
                    for (int bv = 0; bv < e.v; ++bv)
                        for (int bh = 0; bh < e.h; ++bh)
                            emit_sequential(bw, block(e, (int64_t)my * e.v + bv,
                                                      (int64_t)mx * e.h + bh),
                                            e.pred, dch[e.tbl], ach[e.tbl]);
        bw.flush();
    } else {
        const ScanSpec* script = c == 3 ? kColourScript : kGreyScript;
        for (int si = 0; si < (c == 3 ? 10 : 6); ++si) {
            const ScanSpec& sc = script[si];
            std::vector<EncComponent*> in_scan;
            for (int ci = 0; ci < c; ++ci)
                if (sc.comp < 0 || sc.comp == ci) in_scan.push_back(&comps[ci]);
            // jcmarker.c write_sos: 0 for the tables a scan does not use
            std::vector<uint8_t> sos = {(uint8_t)in_scan.size()};
            for (EncComponent* e : in_scan) {
                sos.push_back((uint8_t)e->id);
                const int td = sc.ss == 0 && sc.ah == 0 ? e->tbl : 0;
                sos.push_back((uint8_t)(sc.ss == 0 ? td << 4 : e->tbl));
                e->pred = 0;
            }
            sos.insert(sos.end(), {(uint8_t)sc.ss, (uint8_t)sc.se,
                                   (uint8_t)((sc.ah << 4) | sc.al)});
            put_marker(out, 0xDA, sos);
            BitWriter bw{out};
            auto emit = [&](EncComponent& e, const int16_t* q) {
                if (sc.ss == 0 && sc.ah == 0) {
                    const int dcv = q[0] >> sc.al;      // arithmetic shift, as jcphuff.c
                    emit_dc(bw, dcv - e.pred, dch[e.tbl]);
                    e.pred = dcv;
                } else if (sc.ss == 0) {
                    bw.put((unsigned)(q[0] >> sc.al) & 1u, 1);
                } else if (sc.ah == 0) {
                    emit_ac_first(bw, q, sc.ss, sc.se, sc.al, ach[e.tbl]);
                } else {
                    emit_ac_refine(bw, q, sc.ss, sc.se, sc.al, ach[e.tbl]);
                }
            };
            if (in_scan.size() > 1) {               // interleaved DC: whole MCUs
                for (int my = 0; my < mcuy; ++my)
                    for (int mx = 0; mx < mcux; ++mx)
                        for (EncComponent* e : in_scan)
                            for (int bv = 0; bv < e->v; ++bv)
                                for (int bh = 0; bh < e->h; ++bh)
                                    emit(*e, block(*e, (int64_t)my * e->v + bv,
                                                   (int64_t)mx * e->h + bh));
            } else {                                // the component's own blocks
                EncComponent& e = *in_scan[0];
                const int wib = (int)(((int64_t)w * e.h + 8 * mh - 1) / (8 * mh));
                const int hib = (int)(((int64_t)h * e.v + 8 * mv - 1) / (8 * mv));
                for (int by = 0; by < hib; ++by)
                    for (int bx = 0; bx < wib; ++bx) emit(e, block(e, by, bx));
            }
            bw.flush();
        }
    }
    out.push_back(0xFF);
    out.push_back(0xD9);
    return out;
}

}  // namespace

extern "C" {

int64_t jpeg_header(const uint8_t* buf, int64_t len, int64_t* dims, char* err, int64_t errlen) {
    try {
        Decoder d(buf, len);
        d.header();
        dims[0] = d.height;
        dims[1] = d.width;
        dims[2] = d.ncomp == 1 ? 1 : 3;
        return 0;
    } catch (const Failure& f) {
        set_error(err, errlen, f.msg);
        return -1;
    }
}

int64_t jpeg_decode(const uint8_t* buf, int64_t len, uint8_t* out, int64_t out_size, char* err,
                    int64_t errlen) {
    try {
        static const bool limit_ready = (init_limit(), true);
        (void)limit_ready;
        Decoder d(buf, len);
        d.decode(out, out_size);
        return 0;
    } catch (const Failure& f) {
        set_error(err, errlen, f.msg);
        return -1;
    }
}

uint8_t* jpeg_encode(const uint8_t* px, int64_t h, int64_t w, int64_t c, int64_t quality,
                     int64_t subsampling, int64_t progressive, int64_t* size, char* err,
                     int64_t errlen) {
    try {
        std::vector<uint8_t> out = encode(px, (int)h, (int)w, (int)c, (int)quality,
                                          (int)subsampling, progressive != 0);
        uint8_t* p = (uint8_t*)std::malloc(out.size());
        if (p == nullptr) fail("out of memory");
        std::memcpy(p, out.data(), out.size());
        *size = (int64_t)out.size();
        return p;
    } catch (const Failure& f) {
        set_error(err, errlen, f.msg);
        return nullptr;
    }
}

void jpeg_free(uint8_t* p) { std::free(p); }

}  // extern "C"
