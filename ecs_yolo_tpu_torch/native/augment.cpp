// Native kernels of the host input pipeline: the inverse-mapped bilinear
// warp and the HSV jitter of an RGB u8 image, behind a plain C interface for
// ctypes.  Single-threaded: the loader runs one sample a thread.
//
// A copy of the JAX package's native/augment.cpp (the event painter left
// out), built by native/__init__.py at first use into the port's _build/.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>

extern "C" {

// Inverse-mapped bilinear warp of an RGB u8 image.
// minv: row-major 3x3 matrix mapping OUTPUT (x, y, 1) -> INPUT coords.
// Covers both affine (last row 0,0,1) and perspective warps.
void warp_perspective_u8(const uint8_t* src, int sh, int sw,
                         const double* minv, uint8_t* dst, int dh, int dw,
                         uint8_t fill_r, uint8_t fill_g, uint8_t fill_b) {
    const double m00 = minv[0], m01 = minv[1], m02 = minv[2];
    const double m10 = minv[3], m11 = minv[4], m12 = minv[5];
    const double m20 = minv[6], m21 = minv[7], m22 = minv[8];
    const uint8_t fill[3] = {fill_r, fill_g, fill_b};
    for (int y = 0; y < dh; ++y) {
        uint8_t* row = dst + (size_t)y * dw * 3;
        for (int x = 0; x < dw; ++x) {
            const double wq = m20 * x + m21 * y + m22;
            const double sx = (m00 * x + m01 * y + m02) / wq;
            const double sy = (m10 * x + m11 * y + m12) / wq;
            uint8_t* px = row + x * 3;
            if (sx < 0.0 || sy < 0.0 || sx > sw - 1.0 || sy > sh - 1.0) {
                px[0] = fill[0]; px[1] = fill[1]; px[2] = fill[2];
                continue;
            }
            const int x0 = (int)sx, y0 = (int)sy;
            const int x1 = std::min(x0 + 1, sw - 1);
            const int y1 = std::min(y0 + 1, sh - 1);
            const double fx = sx - x0, fy = sy - y0;
            const uint8_t* p00 = src + ((size_t)y0 * sw + x0) * 3;
            const uint8_t* p01 = src + ((size_t)y0 * sw + x1) * 3;
            const uint8_t* p10 = src + ((size_t)y1 * sw + x0) * 3;
            const uint8_t* p11 = src + ((size_t)y1 * sw + x1) * 3;
            for (int c = 0; c < 3; ++c) {
                const double v =
                    p00[c] * (1 - fx) * (1 - fy) + p01[c] * fx * (1 - fy) +
                    p10[c] * (1 - fx) * fy + p11[c] * fx * fy;
                px[c] = (uint8_t)(v + 0.5);
            }
        }
    }
}

// In-place HSV jitter of an RGB u8 image with OpenCV-convention gains
// (h in [0,180)).
void hsv_jitter_u8(uint8_t* img, int h, int w,
                   double rh, double rs, double rv) {
    for (int y = 0; y < h; ++y) {
        uint8_t* row = img + (size_t)y * w * 3;
        for (int x = 0; x < w; ++x) {
            uint8_t* px = row + x * 3;
            const double r = px[0] / 255.0, g = px[1] / 255.0,
                         b = px[2] / 255.0;
            const double maxc = std::max({r, g, b});
            const double minc = std::min({r, g, b});
            const double d = maxc - minc;
            double hh = 0.0;
            if (d > 0) {
                if (maxc == r) hh = std::fmod((g - b) / d, 6.0);
                else if (maxc == g) hh = (b - r) / d + 2.0;
                else hh = (r - g) / d + 4.0;
                if (hh < 0) hh += 6.0;
            }
            double hs = (maxc > 0) ? d / maxc : 0.0;
            double hv = maxc;
            // jitter
            hh = std::fmod(hh * 30.0 * rh, 180.0) / 30.0;  // 0..6
            if (hh < 0) hh += 6.0;
            hs = std::min(1.0, std::max(0.0, hs * rs));
            hv = std::min(1.0, std::max(0.0, hv * rv));
            // back to rgb
            const int i = ((int)hh) % 6;
            const double f = hh - std::floor(hh);
            const double p = hv * (1 - hs);
            const double q = hv * (1 - hs * f);
            const double t = hv * (1 - hs * (1 - f));
            double rr, gg, bb;
            switch (i) {
                case 0: rr = hv; gg = t;  bb = p;  break;
                case 1: rr = q;  gg = hv; bb = p;  break;
                case 2: rr = p;  gg = hv; bb = t;  break;
                case 3: rr = p;  gg = q;  bb = hv; break;
                case 4: rr = t;  gg = p;  bb = hv; break;
                default: rr = hv; gg = p; bb = q;  break;
            }
            px[0] = (uint8_t)(rr * 255.0 + 0.5);
            px[1] = (uint8_t)(gg * 255.0 + 0.5);
            px[2] = (uint8_t)(bb * 255.0 + 0.5);
        }
    }
}

}  // extern "C"
