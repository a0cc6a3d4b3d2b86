// Ordered front-to-back alpha compositor over the tile-sorted pair table.
//
// Replaces the Pallas kernels _raster_kernel_blocked
// (gswt_renderer_tpu/ops/raster.py:516, pallas_call at :735) and its
// per-entry twin _raster_kernel (:463, pallas_call at :677); the spec is
// rasterize_reference (:777) with _entry_body (:380). For every image tile t
// and every pair j of its run [range_start[t], range_end[t]) of the table
// (rows k0..k5 of the tile-local exponent quadratic, z, r, g, b, ln alpha):
//
//   e   = k0 u^2 + k1 uv + k2 v^2 + k3 u + k4 v + k5   (u, v pixel centres)
//   g   = exp(e + ln alpha)  if e >= CUTOFF (and z < depth when use_depth)
//   acc += (r, g, b, 1) * g * T;   T *= 1 - g
//
// and a tile stops once max T < MIN_T, tested only where a global multiple
// of `chunk` begins (where the TPU kernel's worklist entries begin), so the
// skipped work is the same as there.
//
// Bound: operations. Per pair-pixel the loop does 22 FP32 operations (10 for
// e, 1 for e + ln alpha, 1 for g*T, 4 FMAs, 1 for 1-g, 1 for T*) and one
// exp on the SFU; the table bytes (11 rows of 4 B per pair) and the output
// (16 B per pixel) are a minor term. Design: one CTA per image tile, 256
// threads, each owning 8 pixels whose T and acc[4] stay in registers for the
// whole run; the run is staged through shared memory one chunk at a time
// (11 rows x 256 x 4 B) and every thread reads each pair's coefficients as a
// shared-memory broadcast. The exponent is evaluated with explicitly rounded
// multiplies and adds (no FMA contraction) in the same order as the plain
// PyTorch version, so the e >= CUTOFF mask decides identically in both.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 8;             // pixels per thread: tiles up to 2048 px
constexpr int kMaxChunk = 256;
constexpr float kCutoff = -4.0f;    // fragment discard (gswt.wgsl:427-430)
constexpr float kMinT = 0.5f / 255.0f;
constexpr int kRows = 11;           // k0..k5, z, r, g, b, ln alpha

__device__ __forceinline__ int table_row(int r) { return r < 7 ? r : r + 1; }

__global__ void __launch_bounds__(kThreads)
raster_kernel(const float* __restrict__ table, long long dom,
              const int* __restrict__ range_start,
              const int* __restrict__ range_end,
              const float* __restrict__ depth, int use_depth,
              float* __restrict__ out, int tw, int th, int chunk) {
  __shared__ float s_tab[kRows][kMaxChunk];
  __shared__ float s_red[kThreads / 32];

  const int tile = blockIdx.x;
  const int n_pix = tw * th;
  const long long rs = range_start[tile];
  const long long re = range_end[tile];

  float u[kPix], v[kPix], uu[kPix], uv[kPix], vv[kPix], d[kPix];
  float T[kPix], ar[kPix], ag[kPix], ab[kPix], aa[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int p = threadIdx.x + i * kThreads;
    u[i] = (float)(p % tw) + 0.5f;
    v[i] = (float)(p / tw) + 0.5f;
    uu[i] = u[i] * u[i];
    uv[i] = u[i] * v[i];
    vv[i] = v[i] * v[i];
    d[i] = (use_depth && p < n_pix) ? depth[(long long)tile * n_pix + p] : 1.0f;
    T[i] = 1.0f;
    ar[i] = ag[i] = ab[i] = aa[i] = 0.0f;
  }

  if (rs < re) {
    const long long first = (rs / chunk) * chunk;
    for (long long c0 = first; c0 < re; c0 += chunk) {
      if (c0 != first) {
        // early exit at a chunk boundary: block-wide max of T
        float m = 0.0f;
#pragma unroll
        for (int i = 0; i < kPix; ++i)
          if (threadIdx.x + i * kThreads < n_pix) m = fmaxf(m, T[i]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        __syncthreads();  // every thread is done with s_tab and s_red
        if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = m;
        __syncthreads();
        m = s_red[0];
#pragma unroll
        for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, s_red[w]);
        if (m < kMinT) break;
      }
      const long long lo = rs > c0 ? rs : c0;
      const long long hi = re < c0 + chunk ? re : c0 + chunk;
      const int n = (int)(hi - lo);
      __syncthreads();
      for (int idx = threadIdx.x; idx < kRows * n; idx += kThreads) {
        const int r = idx / n;
        const int j = idx - r * n;
        s_tab[r][j] = table[table_row(r) * dom + lo + j];
      }
      __syncthreads();
      for (int j = 0; j < n; ++j) {
        const float k0 = s_tab[0][j], k1 = s_tab[1][j], k2 = s_tab[2][j];
        const float k3 = s_tab[3][j], k4 = s_tab[4][j], k5 = s_tab[5][j];
        const float z = s_tab[6][j];
        const float cr = s_tab[7][j], cg = s_tab[8][j], cb = s_tab[9][j];
        const float la = s_tab[10][j];
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          float e = __fmul_rn(k0, uu[i]);
          e = __fadd_rn(e, __fmul_rn(k1, uv[i]));
          e = __fadd_rn(e, __fmul_rn(k2, vv[i]));
          e = __fadd_rn(e, __fmul_rn(k3, u[i]));
          e = __fadd_rn(e, __fmul_rn(k4, v[i]));
          e = __fadd_rn(e, k5);
          const bool keep = e >= kCutoff && (!use_depth || z < d[i]);
          const float g = keep ? expf(__fadd_rn(e, la)) : 0.0f;
          const float w = g * T[i];
          ar[i] = fmaf(cr, w, ar[i]);
          ag[i] = fmaf(cg, w, ag[i]);
          ab[i] = fmaf(cb, w, ab[i]);
          aa[i] += w;
          T[i] *= 1.0f - g;
        }
      }
    }
  }

  float* o = out + (long long)tile * 4 * n_pix;
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int p = threadIdx.x + i * kThreads;
    if (p < n_pix) {
      o[p] = ar[i];
      o[n_pix + p] = ag[i];
      o[2 * n_pix + p] = ab[i];
      o[3 * n_pix + p] = aa[i];
    }
  }
}

}  // namespace

extern "C" int gswt_raster(const void* table, long long dom,
                           const void* range_start, const void* range_end,
                           const void* depth, int use_depth, void* out,
                           int n_tiles, int tw, int th, int chunk,
                           void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk || tw * th > kThreads * kPix)
    return (int)cudaErrorInvalidValue;
  if (n_tiles > 0) {
    raster_kernel<<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)table, dom, (const int*)range_start,
        (const int*)range_end, (const float*)depth, use_depth, (float*)out,
        tw, th, chunk);
  }
  return (int)cudaGetLastError();
}
