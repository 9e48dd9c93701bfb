// Native host-side augmentation kernels for the input pipeline.
//
// The hot per-item tail of the OfficeHome dual-view pipeline
// (reference: resnet50_dwt_mec_officehome.py:481-492,535-543) is, per
// image: uint8 HWC -> float [0,1] -> (affine warp) -> normalize.  Done
// with PIL/numpy/cv2 that is 3-4 full passes over the pixels plus two
// float32 temporaries; fused here it is ONE pass reading uint8 and
// writing the final normalized float32 — the fewest possible bytes
// touched.  Pure C (no CPython API): called through ctypes, which
// releases the GIL for the duration, so batch_iterator's worker threads
// parallelize for real on multi-core TPU hosts.
//
// Semantics:
//  * dwt_norm_u8: out[i*c+k] = (src[i*c+k]/255 - mean[k]) / std[k]
//    == transforms.ToArray() followed by transforms.Normalize(mean, std).
//  * dwt_warp_affine_norm_u8: cv2.warpAffine(a, M, (w, h)) default flags
//    (bilinear, BORDER_CONSTANT 0, M inverted internally) fused with the
//    /255 + normalize above.  Out-of-border taps contribute value 0
//    *before* normalization, matching warp-then-normalize order.
//    Coordinates are exact float (cv2 quantizes to 1/32 px fixed point;
//    parity tests use tolerances sized for that).

#include <cstdint>

extern "C" {

void dwt_norm_u8(const uint8_t* src, long long n_pixels, int c,
                 const float* mean, const float* stdv, float* out) {
    // Per-channel fused scale/bias: (v/255 - mean)/std = v*scale + bias.
    float scale[16];
    float bias[16];
    if (c > 16) return;  // caller guarantees small channel counts
    for (int k = 0; k < c; ++k) {
        scale[k] = 1.0f / (255.0f * stdv[k]);
        bias[k] = -mean[k] / stdv[k];
    }
    const long long total = n_pixels * c;
    for (long long i = 0; i < total; i += c) {
        for (int k = 0; k < c; ++k) {
            out[i + k] = (float)src[i + k] * scale[k] + bias[k];
        }
    }
}

void dwt_warp_affine_norm_u8(const uint8_t* src, int h, int w, int c,
                             const float* M /* 2x3, forward, row-major */,
                             const float* mean, const float* stdv,
                             float* out /* h*w*c */) {
    if (c > 16) return;
    float scale[16];
    float bias[16];
    for (int k = 0; k < c; ++k) {
        scale[k] = 1.0f / (255.0f * stdv[k]);
        bias[k] = -mean[k] / stdv[k];
    }

    // cv2.warpAffine without WARP_INVERSE_MAP inverts M, then samples
    // src at inv(M) * (x, y, 1) for every destination (x, y).
    const double a00 = M[0], a01 = M[1], b0 = M[2];
    const double a10 = M[3], a11 = M[4], b1 = M[5];
    const double det = a00 * a11 - a01 * a10;
    const double idet = det != 0.0 ? 1.0 / det : 0.0;
    const float i00 = (float)(a11 * idet);
    const float i01 = (float)(-a01 * idet);
    const float i10 = (float)(-a10 * idet);
    const float i11 = (float)(a00 * idet);
    const float ib0 = (float)(-(a11 * b0 - a01 * b1) * idet);
    const float ib1 = (float)(-(-a10 * b0 + a00 * b1) * idet);

    for (int y = 0; y < h; ++y) {
        const float sx0 = i01 * (float)y + ib0;  // x=0 column start
        const float sy0 = i11 * (float)y + ib1;
        float* orow = out + (long long)y * w * c;

        // Interior fast interval: destination x for which ALL four
        // bilinear taps are in-bounds, i.e. sx in [0, w-1) and
        // sy in [0, h-1).  sx/sy are affine in x, so this is one
        // interval per row; inside it the per-tap border checks (the
        // dominant cost of the naive loop) vanish.
        //
        // Safety margin: the loop accumulates sx/sy by repeated float32
        // addition, which drifts from the exact line by at most
        // n_adds * ulp(max |coord|) = w * maxmag * 2^-23.  The interval
        // is shrunk by that bound (plus slack) ON BOTH SIDES — drift
        // below 0 would read before the buffer just as surely as drift
        // past w-1 reads after it — so the unchecked loop can never
        // dereference out of bounds no matter how the rounding falls.
        double lo = 0.0, hi = (double)w - 1.0;
        {
            const double maxmag_x =
                (sx0 >= 0 ? sx0 : -sx0) + (i00 >= 0 ? i00 : -i00) * w;
            const double maxmag_y =
                (sy0 >= 0 ? sy0 : -sy0) + (i10 >= 0 ? i10 : -i10) * w;
            const double drift_x = (double)w * maxmag_x * 1.2e-7;
            const double drift_y = (double)w * maxmag_y * 1.2e-7;
            const double pairs[2][3] = {
                {(double)i00, (double)sx0, drift_x + 1e-3},
                {(double)i10, (double)sy0, drift_y + 1e-3},
            };
            const double vhi[2] = {(double)w - 1.0, (double)h - 1.0};
            for (int p = 0; p < 2; ++p) {
                const double a = pairs[p][0], b = pairs[p][1];
                const double vmin = pairs[p][2];          // margin above 0
                const double vmax = vhi[p] - pairs[p][2];  // margin below
                if (a > 1e-12) {
                    const double l = (vmin - b) / a, r = (vmax - b) / a;
                    if (l > lo) lo = l;
                    if (r < hi) hi = r;
                } else if (a < -1e-12) {
                    const double l = (vmax - b) / a, r = (vmin - b) / a;
                    if (l > lo) lo = l;
                    if (r < hi) hi = r;
                } else if (b < vmin || b > vmax) {
                    hi = lo - 1.0;  // empty
                }
            }
        }
        // Clamp in double BEFORE the int casts: a near-singular matrix
        // (tiny slope above the 1e-12 guard, huge intercept) can push
        // lo/hi far past INT_MAX, where (int)lo is undefined behavior
        // and a ceil-by-increment loop would spin ~2^31 times.
        if (lo < 0.0) lo = 0.0;
        if (hi > (double)w - 1.0) hi = (double)w - 1.0;
        int xfast0, xfast1;
        if (hi < lo) {
            xfast0 = w;  // empty fast interval: all-checked row
            xfast1 = w - 1;
        } else {
            xfast0 = (int)lo;
            if ((double)xfast0 < lo) ++xfast0;  // ceil, at most one step
            xfast1 = (int)hi;  // floor for non-negative hi
            if (xfast1 >= w) xfast1 = w - 1;
            if (xfast1 < xfast0) {
                xfast0 = w;
                xfast1 = w - 1;
            }
        }

        float sx = sx0, sy = sy0;
        int x = 0;
        for (int seg = 0; seg < 3; ++seg) {
            const int xend = seg == 0 ? xfast0 : (seg == 1 ? xfast1 + 1 : w);
            if (seg == 1 && c == 3) {
                // Fast interior, 3-channel unrolled: no border checks.
                for (; x < xend; ++x, sx += i00, sy += i10) {
                    const int x0 = (int)sx;
                    const int y0 = (int)sy;
                    const float fx = sx - (float)x0;
                    const float fy = sy - (float)y0;
                    const float w00 = (1.0f - fx) * (1.0f - fy);
                    const float w01 = fx * (1.0f - fy);
                    const float w10 = (1.0f - fx) * fy;
                    const float w11 = fx * fy;
                    const uint8_t* r0 = src + ((long long)y0 * w + x0) * 3;
                    const uint8_t* r1 = r0 + (long long)w * 3;
                    float* opix = orow + (long long)x * 3;
                    opix[0] = (w00 * r0[0] + w01 * r0[3] + w10 * r1[0] +
                               w11 * r1[3]) * scale[0] + bias[0];
                    opix[1] = (w00 * r0[1] + w01 * r0[4] + w10 * r1[1] +
                               w11 * r1[4]) * scale[1] + bias[1];
                    opix[2] = (w00 * r0[2] + w01 * r0[5] + w10 * r1[2] +
                               w11 * r1[5]) * scale[2] + bias[2];
                }
                continue;
            }
            if (seg == 1) {
                // Fast interior, generic channel count.
                for (; x < xend; ++x, sx += i00, sy += i10) {
                    const int x0 = (int)sx;
                    const int y0 = (int)sy;
                    const float fx = sx - (float)x0;
                    const float fy = sy - (float)y0;
                    const float w00 = (1.0f - fx) * (1.0f - fy);
                    const float w01 = fx * (1.0f - fy);
                    const float w10 = (1.0f - fx) * fy;
                    const float w11 = fx * fy;
                    const uint8_t* r0 = src + ((long long)y0 * w + x0) * c;
                    const uint8_t* r1 = r0 + (long long)w * c;
                    float* opix = orow + (long long)x * c;
                    for (int k = 0; k < c; ++k) {
                        opix[k] = (w00 * r0[k] + w01 * r0[c + k] +
                                   w10 * r1[k] + w11 * r1[c + k]) *
                                      scale[k] + bias[k];
                    }
                }
                continue;
            }
            // Border segments: per-tap checks, zero outside.
            for (; x < xend; ++x, sx += i00, sy += i10) {
                // All four taps miss the source (also catches NaN and the
                // huge coordinates a near-singular matrix produces, whose
                // float->int cast below would be undefined behavior).
                if (!(sx > -1.0f && sx < (float)w &&
                      sy > -1.0f && sy < (float)h)) {
                    float* opix = orow + (long long)x * c;
                    for (int k = 0; k < c; ++k) opix[k] = bias[k];
                    continue;
                }
                const int x0 = (int)(sx >= 0.0f ? sx : sx - 1.0f);  // floor
                const int y0 = (int)(sy >= 0.0f ? sy : sy - 1.0f);
                const float fx = sx - (float)x0;
                const float fy = sy - (float)y0;
                const float w00 = (1.0f - fx) * (1.0f - fy);
                const float w01 = fx * (1.0f - fy);
                const float w10 = (1.0f - fx) * fy;
                const float w11 = fx * fy;
                const bool in_x0 = (unsigned)x0 < (unsigned)w;
                const bool in_x1 = (unsigned)(x0 + 1) < (unsigned)w;
                const bool in_y0 = (unsigned)y0 < (unsigned)h;
                const bool in_y1 = (unsigned)(y0 + 1) < (unsigned)h;
                const uint8_t* r0 = src + ((long long)y0 * w + x0) * c;
                const uint8_t* r1 = r0 + (long long)w * c;
                float* opix = orow + (long long)x * c;
                for (int k = 0; k < c; ++k) {
                    float v = 0.0f;
                    if (in_y0) {
                        if (in_x0) v += w00 * (float)r0[k];
                        if (in_x1) v += w01 * (float)r0[c + k];
                    }
                    if (in_y1) {
                        if (in_x0) v += w10 * (float)r1[k];
                        if (in_x1) v += w11 * (float)r1[c + k];
                    }
                    opix[k] = v * scale[k] + bias[k];
                }
            }
        }
    }
}

}  // extern "C"
