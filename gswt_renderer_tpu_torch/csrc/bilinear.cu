// 4-tap bilinear sampling of a [C, Ht, Wt] f32 texture of any size (each
// axis under 2^24 texels) at P fractional texel coordinates, Repeat or
// ClampToEdge per axis:
//
//   x0 = floor(x), tx = x - x0, taps x0 and x0 + 1 wrapped or clamped (y alike)
//   A0 = i00 (1-tx) + i10 tx ;  A1 = i01 (1-tx) + i11 tx
//   out[c, p] = A0 (1-ty) + A1 ty
//
// Replaces the Pallas kernel _kernel of gswt_renderer_tpu/ops/texsample.py:39
// (pallas_call at :119, reached through factored_bilinear :70). That kernel
// builds one-hot weight matrices and multiplies them with the texture because
// its machine has no vector gather, which limits it to a small texture; here
// a thread reads its four taps.
//
// Bound: bytes. Per sample 8 B of coordinates in and 4 C bytes out; the
// texture (C Ht Wt 4 bytes, read once) stays in L1/L2 while it is small
// (an equirect of 64 x 128 texels is 96 KB). About 12 FP32
// operations per channel are far below the ratio at which arithmetic binds.
// Design: one thread per sample, neighbouring threads on neighbouring
// samples, so the coordinate loads and the C output stores are full lines;
// the taps go through the read-only cache. Multiplies and adds are rounded
// one by one (no FMA contraction) in the order of the plain PyTorch version,
// so both give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// The two tap indices of one axis from the floor c0f of its coordinate.
// Both are formed in float, where any finite coordinate is safe: fmodf is
// exact, and the clamp comes before the conversion to int, which would
// saturate on a coordinate past 2^31.
__device__ __forceinline__ void axis_taps(float c0f, int n, int wrap,
                                          int* i0, int* i1) {
  if (wrap) {
    float r = fmodf(c0f, (float)n);  // C remainder: sign of the dividend
    if (r < 0.0f) r += (float)n;
    *i0 = (int)r;
    *i1 = *i0 + 1 == n ? 0 : *i0 + 1;
  } else {
    const int c = (int)fminf(fmaxf(c0f, -1.0f), (float)(n - 1));
    *i0 = c < 0 ? 0 : c;
    *i1 = c + 1 > n - 1 ? n - 1 : c + 1;
  }
}

__device__ __forceinline__ float lerp_rn(float a, float b, float t, float omt) {
  return __fadd_rn(__fmul_rn(a, omt), __fmul_rn(b, t));
}

__global__ void __launch_bounds__(kThreads)
bilinear_kernel(const float* __restrict__ tex, int n_ch, int ht, int wt,
                const float* __restrict__ xs, const float* __restrict__ ys,
                long long p_n, int wrap_x, int wrap_y,
                float* __restrict__ out) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= p_n) return;
  const float x = xs[p];
  const float y = ys[p];
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float tx = __fsub_rn(x, x0f);
  const float ty = __fsub_rn(y, y0f);
  const float omtx = __fsub_rn(1.0f, tx);
  const float omty = __fsub_rn(1.0f, ty);
  int x0, x1, y0, y1;
  axis_taps(x0f, wt, wrap_x, &x0, &x1);
  axis_taps(y0f, ht, wrap_y, &y0, &y1);
  for (int c = 0; c < n_ch; ++c) {
    const float* row0 = tex + ((long long)c * ht + y0) * wt;
    const float* row1 = tex + ((long long)c * ht + y1) * wt;
    const float a0 = lerp_rn(__ldg(row0 + x0), __ldg(row0 + x1), tx, omtx);
    const float a1 = lerp_rn(__ldg(row1 + x0), __ldg(row1 + x1), tx, omtx);
    out[(long long)c * p_n + p] = lerp_rn(a0, a1, ty, omty);
  }
}

}  // namespace

extern "C" int gswt_bilinear(const void* tex, int n_ch, int ht, int wt,
                             const void* xs, const void* ys, long long p_n,
                             int wrap_x, int wrap_y, void* out, void* stream) {
  if (n_ch <= 0 || ht <= 0 || wt <= 0) return (int)cudaErrorInvalidValue;
  if (p_n > 0) {
    const unsigned blocks = (unsigned)((p_n + kThreads - 1) / kThreads);
    bilinear_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)tex, n_ch, ht, wt, (const float*)xs, (const float*)ys,
        p_n, wrap_x, wrap_y, (float*)out);
  }
  return (int)cudaGetLastError();
}
