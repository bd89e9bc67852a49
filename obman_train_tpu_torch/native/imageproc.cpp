// Host C++ bilinear warp of the input pipeline: the port's own copy of the
// JAX package's native/imageproc.cpp, built by native/build.py with g++ and
// called through ctypes from the loader threads (ctypes releases the GIL
// for the whole call, so the threads scale).
//
// Output pixel (x, y) samples the source at inv(A) @ (x, y, 1);
// out-of-bounds taps contribute zero (PIL AFFINE black fill). The numpy
// warp in data/transforms.py (use_native=False) is its plain version: the
// same taps and weights, summed in another order.
//
// Build: g++ -O3 -march=native -shared -fPIC imageproc.cpp -o lib.so

#include <cstdint>
#include <cstring>

extern "C" {

// Warp one HxWxC image (float32, any C) into out_h x out_w.
// inv: row-major 3x3 inverse affine (crop pixel -> source pixel).
void warp_affine_f32(
    const float* src, int h, int w, int c,
    const double* inv,
    float* dst, int out_h, int out_w) {
  const double a00 = inv[0], a01 = inv[1], a02 = inv[2];
  const double a10 = inv[3], a11 = inv[4], a12 = inv[5];
  for (int oy = 0; oy < out_h; ++oy) {
    for (int ox = 0; ox < out_w; ++ox) {
      const double sx = a00 * ox + a01 * oy + a02;
      const double sy = a10 * ox + a11 * oy + a12;
      const int x0 = (int)__builtin_floor(sx);
      const int y0 = (int)__builtin_floor(sy);
      const float wx = (float)(sx - x0);
      const float wy = (float)(sy - y0);
      float* out = dst + ((long)oy * out_w + ox) * c;
      for (int ch = 0; ch < c; ++ch) out[ch] = 0.f;

      const float w00 = (1 - wx) * (1 - wy);
      const float w01 = wx * (1 - wy);
      const float w10 = (1 - wx) * wy;
      const float w11 = wx * wy;
      // accumulate only valid taps (invalid taps contribute 0)
      const bool v00 = x0 >= 0 && x0 < w && y0 >= 0 && y0 < h;
      const bool v01 = x0 + 1 >= 0 && x0 + 1 < w && y0 >= 0 && y0 < h;
      const bool v10 = x0 >= 0 && x0 < w && y0 + 1 >= 0 && y0 + 1 < h;
      const bool v11 = x0 + 1 >= 0 && x0 + 1 < w && y0 + 1 >= 0 && y0 + 1 < h;
      if (v00) {
        const float* p = src + ((long)y0 * w + x0) * c;
        for (int ch = 0; ch < c; ++ch) out[ch] += w00 * p[ch];
      }
      if (v01) {
        const float* p = src + ((long)y0 * w + x0 + 1) * c;
        for (int ch = 0; ch < c; ++ch) out[ch] += w01 * p[ch];
      }
      if (v10) {
        const float* p = src + ((long)(y0 + 1) * w + x0) * c;
        for (int ch = 0; ch < c; ++ch) out[ch] += w10 * p[ch];
      }
      if (v11) {
        const float* p = src + ((long)(y0 + 1) * w + x0 + 1) * c;
        for (int ch = 0; ch < c; ++ch) out[ch] += w11 * p[ch];
      }
    }
  }
}

}  // extern "C"
