// Trilinear Repeat sampling of a whole mip chain packed block-diagonally into
// one bf16 plane per channel (ops/texsample.py pack_pyramid: kept level k at
// rows [ro_k, ro_k + h_k), cols [co_k, co_k + w_k), zeros elsewhere; texels
// are the integers 0..255). Per sample (u, v, rho):
//
//   lvl  = clamp(log2(max(rho, 1e-6)) - l_min, 0, n_kept - 1)
//   l0   = floor(lvl), f = lvl - l0, l1 = min(l0 + 1, n_kept - 1)
//   each level gives two column taps (weights (1-tx) lw, tx lw with the level
//   weight lw = 1-f or f folded in) and two row taps (weights 1-ty, ty);
//   out[c] = sum_rows wy[row] * sum_cols plane[c][row][col] * bf16(wx[col]) / 255
//
// where wx[col] / wy[row] is the f32 sum of every tap weight that lands on
// that column / row. Replaces the Pallas kernel _mip_kernel of
// gswt_renderer_tpu/ops/texsample.py:204 (pallas_call at :322, reached through
// factored_mip_trilinear :273), which builds 4-hot weight matrices and
// multiplies them with the planes because its machine has no vector gather;
// here a thread reads its taps.
//
// What the sums must keep from that kernel:
// - coinciding column taps (the coarsest level, where l0 == l1, and a 1-wide
//   level, where x0 == x1) add their weights in f32 BEFORE the rounding to
//   bf16;
// - when l0 == l1 the second level's ROW weights are zeroed, or the row sums
//   would double the output (its column weights are already 0, f being 0);
// - a texel times a bf16 weight is exact in f32; sums are f32; the division
//   by 255 is one multiply at the end.
//
// The kernel reads the texel-interleaved copy of the planes
// (ops/texsample.py interleave_pyramid: [Hp, Wp, 4] bf16, channels side by
// side, zero-padded), so one 8-byte load per tap fetches every channel.
//
// Bound: bytes. 12 B of (u, v, rho) in and 4 C bytes out per sample; the
// texels (8 Hp Wp bytes, read once) stay in L1/L2. What the first kernel
// paid above that was per-sample work: 48 two-byte loads (4 rows x 4
// columns x 3 channel planes) and four IEEE divisions for the wrap. Design:
// one thread per sample, coalesced coordinate loads and output stores, one
// 8-byte load per distinct tap through the read-only cache (16 at most), the
// level table passed by value, the channel count a template parameter, the
// tap merges short-cut when the four taps are distinct (the usual case). The Repeat wrap floor(x0f / n) is taken in
// integers where that is provably the float result (|x0f| < 2^24 and
// n <= 2^12: the quotient's rounding cannot cross an integer), and in
// floats otherwise. Every multiply and add is rounded on its own in the
// order of the plain PyTorch version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 16;
constexpr int kMaxCh = 4;  // bf16 channels per texel: 8 bytes
// the integer wrap is exact below these (see the header)
constexpr float kIntWrapCoord = 16777216.0f;  // 2^24
constexpr int kIntWrapSize = 4096;           // 2^12

struct Levels {
  int w[kMaxLevels], h[kMaxLevels], ro[kMaxLevels], co[kMaxLevels];
  float inv_w[kMaxLevels], inv_h[kMaxLevels];  // 1/w, 1/h (estimates)
};

// one axis of one level: the two wrapped tap positions (offset included) and
// the fraction
__device__ __forceinline__ void axis_taps(float coord, int size, float inv,
                                          int off, int* i0, int* i1,
                                          float* t) {
  const float n = (float)size;
  const float x = __fsub_rn(__fmul_rn(coord, n), 0.5f);
  const float x0f = floorf(x);
  *t = __fsub_rn(x, x0f);
  int x0;
  if (fabsf(x0f) < kIntWrapCoord && size <= kIntWrapSize) {
    // exact: the float modulo's value. The quotient from the reciprocal is
    // off by at most one (|x0f / n| < 2^23 for n >= 2; 1/1 is exact), which
    // one correction of the remainder undoes
    const int xi = (int)x0f;
    int r = xi - (int)floorf(x0f * inv) * size;
    if (r < 0) r += size;
    else if (r >= size) r -= size;
    x0 = r;
  } else {  // float modulo wrap (Repeat)
    x0 = (int)__fsub_rn(x0f, __fmul_rn(floorf(__fdiv_rn(x0f, n)), n));
  }
  const int x1 = x0 + 1 >= size ? 0 : x0 + 1;
  *i0 = off + x0;
  *i1 = off + x1;
}

// for each of 4 taps: the f32 sum, in tap order, of every tap weight at its
// index, and whether it is the first tap at that index
__device__ __forceinline__ void merge_taps(const int* idx, const float* w,
                                           float* summed, bool* first) {
  if (idx[0] != idx[1] && idx[0] != idx[2] && idx[0] != idx[3] &&
      idx[1] != idx[2] && idx[1] != idx[3] && idx[2] != idx[3]) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // four distinct taps: nothing to merge
      summed[k] = __fadd_rn(0.0f, w[k]);
      first[k] = true;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float s = 0.0f;
    bool f = true;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (idx[j] == idx[k]) {
        s = __fadd_rn(s, w[j]);
        if (j < k) f = false;
      }
    }
    summed[k] = s;
    first[k] = f;
  }
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// kCh: the channels sampled (the texel holds kMaxCh)
template <int kCh>
__global__ void __launch_bounds__(kThreads)
mip_trilinear_kernel(const uint2* __restrict__ texels, int hp,
                     int wp, Levels lv, int n_kept, int l_min,
                     const float* __restrict__ us, const float* __restrict__ vs,
                     const float* __restrict__ rhos, long long p_n,
                     float* __restrict__ out) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= p_n) return;
  const float u = us[p];
  const float v = vs[p];
  float lvl = __fsub_rn(log2f(fmaxf(rhos[p], 1e-6f)), (float)l_min);
  lvl = fminf(fmaxf(lvl, 0.0f), (float)(n_kept - 1));
  const int l0 = (int)floorf(lvl);
  const float frac = __fsub_rn(lvl, (float)l0);
  const int l1 = l0 + 1 < n_kept - 1 ? l0 + 1 : n_kept - 1;

  int cols[4], rows[4];
  float wc[4], wr[4];
  float tx, ty;
  axis_taps(u, lv.w[l0], lv.inv_w[l0], lv.co[l0], &cols[0], &cols[1], &tx);
  axis_taps(v, lv.h[l0], lv.inv_h[l0], lv.ro[l0], &rows[0], &rows[1], &ty);
  const float lw0 = __fsub_rn(1.0f, frac);
  wc[0] = __fmul_rn(__fsub_rn(1.0f, tx), lw0);
  wc[1] = __fmul_rn(tx, lw0);
  wr[0] = __fsub_rn(1.0f, ty);
  wr[1] = ty;
  axis_taps(u, lv.w[l1], lv.inv_w[l1], lv.co[l1], &cols[2], &cols[3], &tx);
  axis_taps(v, lv.h[l1], lv.inv_h[l1], lv.ro[l1], &rows[2], &rows[3], &ty);
  const float keep = l0 == l1 ? 0.0f : 1.0f;  // the duplicate-level fix
  wc[2] = __fmul_rn(__fsub_rn(1.0f, tx), frac);
  wc[3] = __fmul_rn(tx, frac);
  wr[2] = __fmul_rn(__fsub_rn(1.0f, ty), keep);
  wr[3] = __fmul_rn(ty, keep);

  float wx[4], wy[4];
  bool cfirst[4], rfirst[4];
  merge_taps(cols, wc, wx, cfirst);
  merge_taps(rows, wr, wy, rfirst);
  // a non-finite or astronomically large uv (where the float modulo loses
  // its integer) must not read outside the texels
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    cols[k] = min(max(cols[k], 0), wp - 1);
    rows[k] = min(max(rows[k], 0), hp - 1);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) wx[k] = bf16_round(wx[k]);

  float o[kCh];
#pragma unroll
  for (int c = 0; c < kCh; ++c) o[c] = 0.0f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (!rfirst[r]) continue;
    const uint2* row = texels + rows[r] * wp;  // hp wp < 2^31
    float acc[kCh];
#pragma unroll
    for (int c = 0; c < kCh; ++c) acc[c] = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!cfirst[k]) continue;
      const uint2 t = __ldg(row + cols[k]);  // every channel of the texel
      const float texel[kMaxCh] = {bf16_lo(t.x), bf16_hi(t.x), bf16_lo(t.y),
                                   bf16_hi(t.y)};
#pragma unroll
      for (int c = 0; c < kCh; ++c)
        acc[c] = __fadd_rn(acc[c], __fmul_rn(texel[c], wx[k]));
    }
#pragma unroll
    for (int c = 0; c < kCh; ++c)
      o[c] = __fadd_rn(o[c], __fmul_rn(wy[r], acc[c]));
  }
  const float inv255 = (float)(1.0 / 255.0);
#pragma unroll
  for (int c = 0; c < kCh; ++c)
    out[(long long)c * p_n + p] = __fmul_rn(o[c], inv255);
}

}  // namespace

// texels: [hp, wp, 4] bf16 (8-byte aligned), the first n_ch channels of
// each texel sampled
extern "C" int gswt_mip_trilinear(const void* texels, int n_ch, int hp, int wp,
                                  const int* meta, int n_kept, int l_min,
                                  const void* us, const void* vs,
                                  const void* rhos, long long p_n, void* out,
                                  void* stream) {
  if (n_ch <= 0 || n_ch > kMaxCh || n_kept <= 0 || n_kept > kMaxLevels ||
      (uintptr_t)texels % 8 || hp <= 0 || wp <= 0 ||
      (long long)hp * wp >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int k = 0; k < kMaxLevels; ++k) {
    const int s = k < n_kept ? k : n_kept - 1;
    lv.w[k] = meta[4 * s];
    lv.h[k] = meta[4 * s + 1];
    lv.ro[k] = meta[4 * s + 2];
    lv.co[k] = meta[4 * s + 3];
    lv.inv_w[k] = 1.0f / (float)(lv.w[k] > 0 ? lv.w[k] : 1);
    lv.inv_h[k] = 1.0f / (float)(lv.h[k] > 0 ? lv.h[k] : 1);
  }
  if (p_n > 0) {
    const unsigned blocks = (unsigned)((p_n + kThreads - 1) / kThreads);
    auto kernel = n_ch == 1   ? mip_trilinear_kernel<1>
                  : n_ch == 2 ? mip_trilinear_kernel<2>
                  : n_ch == 3 ? mip_trilinear_kernel<3>
                              : mip_trilinear_kernel<4>;
    kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint2*)texels, hp, wp, lv, n_kept, l_min, (const float*)us,
        (const float*)vs, (const float*)rhos, p_n, (float*)out);
  }
  return (int)cudaGetLastError();
}
