// PNG row filters undone on the host: the C pass of
// gaussianavatars_torch/utils/png.py::_unfilter, which keeps its numpy
// pass as the reference the tests hold this one against and for hosts
// without a C compiler.
//
// Why C: a byte of an average or Paeth row depends on its left, upper and
// upper-left neighbours after they are rebuilt, so numpy can only sweep
// the image's anti-diagonals, H + W - 1 steps of a dozen small calls each,
// all of them holding the interpreter's lock. A camera loader decodes on
// several threads beside the training loop, whose every PyTorch call
// gives that lock up and then waits for it again; with numpy decoding
// beside it a train step of the avatar took about a second on the H100's
// host. Called through ctypes, this pass runs without the lock, one
// sequential walk over the bytes.
//
// rows: h rows of one filter byte (0 none, 1 sub, 2 up, 3 average,
// 4 Paeth; the caller has rejected any other) and w * ch bytes each.
// out: h * w * ch bytes, the image.

#include <stdint.h>
#include <stdlib.h>

static uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc) return (uint8_t)a;
    return (uint8_t)(pb <= pc ? b : c);
}

void png_unfilter(const uint8_t *rows, uint8_t *out, int h, int w, int ch) {
    const long n = (long)w * ch;
    for (int r = 0; r < h; ++r) {
        const uint8_t f = rows[r * (n + 1)];
        const uint8_t *src = rows + r * (n + 1) + 1;
        uint8_t *dst = out + r * n;
        const uint8_t *up = r > 0 ? dst - n : NULL;
        long i = 0;
        if (f == 0 || (f == 2 && !up)) {            // none; up on row 0
            for (; i < n; ++i) dst[i] = src[i];
        } else if (f == 1) {                        // sub
            for (; i < ch; ++i) dst[i] = src[i];
            for (; i < n; ++i) dst[i] = (uint8_t)(src[i] + dst[i - ch]);
        } else if (f == 2) {                        // up
            for (; i < n; ++i) dst[i] = (uint8_t)(src[i] + up[i]);
        } else if (f == 3) {                        // average
            for (; i < ch; ++i) dst[i] = (uint8_t)(src[i] + (up ? up[i] : 0) / 2);
            for (; i < n; ++i)
                dst[i] = (uint8_t)(src[i] + ((dst[i - ch] + (up ? up[i] : 0)) >> 1));
        } else {                                    // Paeth
            for (; i < ch; ++i) dst[i] = (uint8_t)(src[i] + (up ? up[i] : 0));
            for (; i < n; ++i)
                dst[i] = (uint8_t)(src[i] + (up ? paeth(dst[i - ch], up[i], up[i - ch])
                                                : dst[i - ch]));
        }
    }
}
