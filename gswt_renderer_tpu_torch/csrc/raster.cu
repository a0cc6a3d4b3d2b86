// Ordered front-to-back alpha compositor over the tile-sorted pair table.
//
// Replaces the Pallas kernels _raster_kernel_blocked
// (gswt_renderer_tpu/ops/raster.py:516, pallas_call at :735) and its
// per-entry twin _raster_kernel (:463, pallas_call at :677), in every
// (exact, emit_zcut) specialisation; the spec is rasterize_reference (:777)
// with _entry_body (:380). For every image tile t
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
// Two compile-time variants on top of that, as the Pallas kernels are
// specialised on `exact` and `emit_zcut`:
//
// kFast (the fast profile, _entry_body's exact=False fork): the TPU forms
//   the colour sums as one bf16 MXU product, bf16(r, g, b, 1) x bf16(g T),
//   accumulated in f32, with T carried in f32 from the un-rounded weights.
//   Here each pair's colours are rounded to bf16 once, where the chunk is
//   staged, and each weight w = g T is rounded to bf16 before the f32
//   accumulate (alpha is the sum of the rounded weights). The exponent
//   stays the f32 evaluation below: the TPU's bf16 hi/lo split is its way
//   to an f32 product on the MXU, not part of the result.
// kZcut (emit_zcut, _sat_update / _sat_flush): the saturation-SLOT record.
//   Row 12 of the table (the pair's stream slot) is staged too. Per
//   composited chunk, smax = the max slot over the chunk's in-run pairs,
//   and every pixel whose T where the chunk STARTS is >= MIN_T raises its
//   record to smax; chunks the early exit skips update nothing. At the end,
//   per band b = min(row / max(th/4, 1), 3), cut[b] = max over the band's
//   pixels of (T < MIN_T ? record + 0.5 : 2^25): one unsaturated pixel makes
//   its band uncuttable. zcut is [n_tiles, 4].
//
// Bound: operations. Per pair-pixel the loop does 22 FP32 operations (10 for
// e, 1 for e + ln alpha, 1 for g*T, 4 FMAs, 1 for 1-g, 1 for T*) and one
// exp on the SFU; kFast adds 2 (the weight's round to bf16 and back); kZcut
// adds nothing per pair-pixel (one max per pair, one select per pixel and
// chunk). The table bytes (11 or 12 rows of 4 B per pair) and the output
// (16 B per pixel) are a minor term. Design: one CTA per image tile, 256
// threads, each owning 8 pixels whose T and acc[4] stay in registers for the
// whole run; the run is staged through shared memory one chunk at a time
// (11 rows x 256 x 4 B) and every thread reads each pair's coefficients as a
// shared-memory broadcast. The exponent is evaluated with explicitly rounded
// multiplies and adds (no FMA contraction) in the same order as the plain
// PyTorch version, so the e >= CUTOFF mask decides identically in both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 8;             // pixels per thread: tiles up to 2048 px
constexpr int kMaxChunk = 256;
constexpr float kCutoff = -4.0f;    // fragment discard (gswt.wgsl:427-430)
constexpr float kMinT = 0.5f / 255.0f;
constexpr int kRows = 11;           // k0..k5, z, r, g, b, ln alpha
constexpr int kSlotRow = 11;        // staged after them when kZcut: the slot
constexpr int kBands = 4;           // SAT_BANDS
constexpr float kSatNoCut = 33554432.0f;  // SAT_NOCUT = 2^25
constexpr float kCutBump = 0.5f;

__device__ __forceinline__ int table_row(int r) { return r < 7 ? r : r + 1; }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool kFast, bool kZcut>
__global__ void __launch_bounds__(kThreads)
raster_kernel(const float* __restrict__ table, long long dom,
              const int* __restrict__ range_start,
              const int* __restrict__ range_end,
              const float* __restrict__ depth, int use_depth,
              float* __restrict__ out, float* __restrict__ zcut,
              int tw, int th, int chunk) {
  constexpr int kStaged = kZcut ? kRows + 1 : kRows;
  __shared__ float s_tab[kStaged][kMaxChunk];
  __shared__ float s_red[kThreads / 32];
  __shared__ int s_band[kBands];

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
  float rec[kZcut ? kPix : 1];
  if constexpr (kZcut) {
#pragma unroll
    for (int i = 0; i < kPix; ++i) rec[i] = 0.0f;
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
      for (int idx = threadIdx.x; idx < kStaged * n; idx += kThreads) {
        const int r = idx / n;
        const int j = idx - r * n;
        float x = table[table_row(r) * dom + lo + j];
        if constexpr (kFast) {
          if (r >= 7 && r <= 9) x = round_bf16(x);  // r, g, b
        }
        s_tab[r][j] = x;
      }
      __syncthreads();
      unsigned vis = 0;   // pixels still visible where this chunk starts
      float smax = -1.0f;
      if constexpr (kZcut) {
#pragma unroll
        for (int i = 0; i < kPix; ++i)
          if (T[i] >= kMinT) vis |= 1u << i;
      }
      for (int j = 0; j < n; ++j) {
        if constexpr (kZcut) smax = fmaxf(smax, s_tab[kSlotRow][j]);
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
          float w = g * T[i];
          if constexpr (kFast) w = round_bf16(w);
          ar[i] = fmaf(cr, w, ar[i]);
          ag[i] = fmaf(cg, w, ag[i]);
          ab[i] = fmaf(cb, w, ab[i]);
          aa[i] += w;
          T[i] *= 1.0f - g;  // from the un-rounded g in every variant
        }
      }
      if constexpr (kZcut) {
#pragma unroll
        for (int i = 0; i < kPix; ++i)
          if (vis & (1u << i)) rec[i] = fmaxf(rec[i], smax);
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

  if constexpr (kZcut) {
    // band cuts: the values are >= 0.5, so their bit patterns order as
    // ints; -1.0f (a band without pixels) is below all of them
    __syncthreads();
    if (threadIdx.x < kBands) s_band[threadIdx.x] = __float_as_int(-1.0f);
    __syncthreads();
    const int band_px = (th / kBands > 1 ? th / kBands : 1) * tw;
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      const int p = threadIdx.x + i * kThreads;
      if (p < n_pix) {
        const int b = p / band_px < kBands - 1 ? p / band_px : kBands - 1;
        const float cut = T[i] < kMinT ? rec[i] + kCutBump : kSatNoCut;
        atomicMax(&s_band[b], __float_as_int(cut));
      }
    }
    __syncthreads();
    if (threadIdx.x < kBands)
      zcut[(long long)tile * kBands + threadIdx.x] =
          __int_as_float(s_band[threadIdx.x]);
  }
}

}  // namespace

// fast: 0 the exact variant, 1 the fast profile's. zcut: null, or the
// [n_tiles, 4] saturation-slot record to write.
extern "C" int gswt_raster(const void* table, long long dom,
                           const void* range_start, const void* range_end,
                           const void* depth, int use_depth, int fast,
                           void* out, void* zcut, int n_tiles, int tw, int th,
                           int chunk, void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk || tw * th > kThreads * kPix)
    return (int)cudaErrorInvalidValue;
  if (n_tiles > 0) {
    auto kernel = fast ? (zcut ? raster_kernel<true, true>
                               : raster_kernel<true, false>)
                       : (zcut ? raster_kernel<false, true>
                               : raster_kernel<false, false>);
    kernel<<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)table, dom, (const int*)range_start,
        (const int*)range_end, (const float*)depth, use_depth, (float*)out,
        (float*)zcut, tw, th, chunk);
  }
  return (int)cudaGetLastError();
}
