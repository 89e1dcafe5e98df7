// PNG scanline unfiltering (PNG specification, section 9: filter method 0)
// for the port's PNG reader, io/image.py.  Row by row, every one of the
// five filter types: none, sub, up, average, Paeth.
//
// C ABI for ctypes:
//   png_unfilter(raw, h, row_bytes, bpp, out) -> 0, or 1 + the index of
//   the first row whose filter byte is not 0-4 (rows before it are done)
//
// raw: h rows of 1 + row_bytes bytes, each a filter byte and the filtered
// row, as zlib inflates them; out: h * row_bytes bytes; bpp: bytes per
// pixel, at least 1 (1-8 at depths 8 and 16; 1 below 8, where a pixel
// has fewer bits than a byte), the distance to the "left" byte; row_bytes:
// at least one, whole pixels at depths 8 and 16, the last byte padded
// below 8.  An Adam7 pass is unfiltered as an image of its own.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return (uint8_t)a;
    return (uint8_t)(pb <= pc ? b : c);
}

}  // namespace

extern "C" int64_t png_unfilter(const uint8_t* raw, int64_t h, int64_t row_bytes,
                                int64_t bpp, uint8_t* out) {
    for (int64_t y = 0; y < h; ++y) {
        const uint8_t* f = raw + y * (row_bytes + 1) + 1;
        const uint8_t type = f[-1];
        uint8_t* cur = out + y * row_bytes;
        // the row above; the first row's is all zero
        const uint8_t* up = y > 0 ? cur - row_bytes : nullptr;
        switch (type) {
        case 0:
            std::memcpy(cur, f, row_bytes);
            break;
        case 1:
            std::memcpy(cur, f, bpp);
            for (int64_t i = bpp; i < row_bytes; ++i) cur[i] = f[i] + cur[i - bpp];
            break;
        case 2:
            if (up == nullptr) {
                std::memcpy(cur, f, row_bytes);
            } else {
                for (int64_t i = 0; i < row_bytes; ++i) cur[i] = f[i] + up[i];
            }
            break;
        case 3:
            for (int64_t i = 0; i < row_bytes; ++i) {
                int a = i >= bpp ? cur[i - bpp] : 0;
                int b = up ? up[i] : 0;
                cur[i] = f[i] + (uint8_t)((a + b) >> 1);
            }
            break;
        case 4:
            for (int64_t i = 0; i < row_bytes; ++i) {
                int a = i >= bpp ? cur[i - bpp] : 0;
                int b = up ? up[i] : 0;
                int c = (up && i >= bpp) ? up[i - bpp] : 0;
                cur[i] = f[i] + paeth(a, b, c);
            }
            break;
        default:
            return y + 1;
        }
    }
    return 0;
}
