// PNG scanline unfiltering (RFC 2083 section 6): the per-row filter types
// None, Sub, Up, Average and Paeth, undone in place of the inflated IDAT
// stream. Sub, Average and Paeth depend on the pixel to the left, so the
// loop runs byte by byte; this is the part of PNG decoding that numpy
// cannot vectorize.
#include <cstdint>
#include <cstdlib>
#include <cstring>

static inline uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return (uint8_t)a;
    if (pb <= pc) return (uint8_t)b;
    return (uint8_t)c;
}

// in: height rows of (1 filter byte + rowbytes); out: height * rowbytes.
// bpp: bytes per complete pixel (at least 1). Returns 0, or the 1-based
// row of the first unknown filter type.
extern "C" int png_unfilter(const uint8_t* in, int height, int rowbytes,
                            int bpp, uint8_t* out) {
    for (int y = 0; y < height; ++y) {
        const uint8_t* src = in + (size_t)y * (size_t)(rowbytes + 1);
        const int ft = src[0];
        ++src;
        uint8_t* cur = out + (size_t)y * (size_t)rowbytes;
        const uint8_t* up = y ? cur - rowbytes : nullptr;
        switch (ft) {
        case 0:
            std::memcpy(cur, src, rowbytes);
            break;
        case 1:
            for (int i = 0; i < rowbytes; ++i)
                cur[i] = (uint8_t)(src[i] + (i >= bpp ? cur[i - bpp] : 0));
            break;
        case 2:
            for (int i = 0; i < rowbytes; ++i)
                cur[i] = (uint8_t)(src[i] + (up ? up[i] : 0));
            break;
        case 3:
            for (int i = 0; i < rowbytes; ++i) {
                int a = i >= bpp ? cur[i - bpp] : 0, b = up ? up[i] : 0;
                cur[i] = (uint8_t)(src[i] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (int i = 0; i < rowbytes; ++i) {
                int a = i >= bpp ? cur[i - bpp] : 0, b = up ? up[i] : 0;
                int c = (up && i >= bpp) ? up[i - bpp] : 0;
                cur[i] = (uint8_t)(src[i] + paeth(a, b, c));
            }
            break;
        default:
            return y + 1;
        }
    }
    return 0;
}
