// The micro-benchmark's compositor variants over a tile-sorted pair table.
//
// Replaces the Pallas kernel _kernel (benchmarks/micro_raster.py:57,
// pallas_call at :189, reached through run_variant :140), which A/Bs the
// production compositor's precision choices. For every image tile t and every
// pair j of its run [range_start[t], range_end[t]) of the table (rows k0..k5
// of the exponent quadratic, z, unused, r, g, b, alpha):
//
//   e   = k . (x^2, xy, y^2, x, y, 1)        x, y pixel centres, global, or
//                                            tile-local when kLocal (the
//                                            caller recentres k3, k4, k5)
//   g   = exp(e) * alpha   if e >= CUTOFF and z < depth, else 0
//   w   = (g * Tl) * Tc;   acc += (r, g, b, 1) * w;   Tl *= 1 - g
//
// with Tl the transmittance since the chunk began and Tc the one carried in;
// where a global multiple of `chunk` ends, Tc *= Tl and Tl = 1. A tile stops
// once max Tc < MIN_T, tested where a global chunk begins (where the TPU
// kernel's worklist entries begin). Unlike the production compositor
// (raster.cu), alpha multiplies g instead of ln(alpha) joining the exponent.
//
// Compile-time variants, the value semantics of the TPU kernel's matmul
// precisions rather than its MXU passes:
//   kPrec 0 ("highest"): e in f32, every multiply and add rounded on its own
//     (no FMA contraction), summed left to right in the order above, as the
//     plain PyTorch version does: e >= CUTOFF must decide alike in both.
//   kPrec 1 ("split2"): each coefficient and each monomial split into
//     hi = bf16(x), lo = bf16(x - hi);
//     e = S(k_hi, f_hi) + (S(k_hi, f_lo) + S(k_lo, f_hi)), every S summed
//     left to right in f32 (a product of two bf16 values is exact in f32).
//   kPrec 2 ("default"): e = S(k_hi, f_hi), both operands rounded once.
//   kBf2: colours rounded to bf16 where the chunk is staged and each weight w
//     rounded to bf16 before the f32 accumulate; Tl and Tc stay f32 from the
//     un-rounded g.
//
// Bound: operations. Every pixel of a composited pair needs e (10 FP32
// operations, 31 when split2) and its compare with the cutoff; only one that
// passes the cutoff and the depth test needs the rest (13, FMAs counted
// twice; 2 more for kBf2's rounding) and one exp on the SFU. This kernel
// runs the rest for every pair-pixel, with g = 0 where the tests fail.
// Design: as raster.cu. One CTA per image tile, 256 threads with 8 pixels
// each, Tc, Tl and the four sums in registers for the whole run; a chunk of
// the table is staged through shared memory (the hi and lo parts of the
// coefficients are split there, once per pair) and read as broadcasts; the
// monomials, or their hi and lo parts, are per-thread registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 8;             // pixels per thread: tiles up to 2048 px
constexpr int kMaxChunk = 256;
constexpr float kCutoff = -4.0f;
constexpr float kMinT = 0.5f / 255.0f;
constexpr int kFeat = 5;            // x^2, xy, y^2, x, y (the sixth is 1)

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// sum_i k[i] * f[i] over n terms, left to right, each operation rounded
template <int n>
__device__ __forceinline__ float dot_rn(const float* k, const float* f) {
  float e = __fmul_rn(k[0], f[0]);
#pragma unroll
  for (int i = 1; i < n; ++i) e = __fadd_rn(e, __fmul_rn(k[i], f[i]));
  return e;
}

template <bool kLocal, int kPrec, bool kBf2>
__global__ void __launch_bounds__(kThreads)
micro_raster_kernel(const float* __restrict__ table, long long dom,
                    const int* __restrict__ range_start,
                    const int* __restrict__ range_end,
                    const float* __restrict__ depth, float* __restrict__ out,
                    int ntx, int tw, int th, int chunk) {
  __shared__ float s_k[6][kMaxChunk];                       // k, or its hi
  __shared__ float s_kl[kPrec == 1 ? 6 : 1][kMaxChunk];     // its lo
  __shared__ float s_p[5][kMaxChunk];                       // z, r, g, b, alpha
  __shared__ float s_red[kThreads / 32];

  const int tile = blockIdx.x;
  const int n_pix = tw * th;
  const long long rs = range_start[tile];
  const long long re = range_end[tile];
  const float ox = kLocal ? 0.0f : (float)((tile % ntx) * tw);
  const float oy = kLocal ? 0.0f : (float)((tile / ntx) * th);

  float f[kPix][kFeat];                       // monomials, or their hi
  float fl[kPrec == 1 ? kPix : 1][kFeat];     // their lo
  float d[kPix], Tc[kPix], Tl[kPix], ar[kPix], ag[kPix], ab[kPix], aa[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int p = threadIdx.x + i * kThreads;
    // integer pixel index first, then the half: exact in f32 either way
    const float x = (ox + (float)(p % tw)) + 0.5f;
    const float y = (oy + (float)(p / tw)) + 0.5f;
    const float m[kFeat] = {x * x, x * y, y * y, x, y};
#pragma unroll
    for (int c = 0; c < kFeat; ++c) {
      if constexpr (kPrec == 0) {
        f[i][c] = m[c];
      } else {
        f[i][c] = round_bf16(m[c]);
        if constexpr (kPrec == 1) fl[i][c] = round_bf16(m[c] - f[i][c]);
      }
    }
    d[i] = p < n_pix ? depth[(long long)tile * n_pix + p] : 1.0f;
    Tc[i] = Tl[i] = 1.0f;
    ar[i] = ag[i] = ab[i] = aa[i] = 0.0f;
  }

  if (rs < re) {
    const long long first = (rs / chunk) * chunk;
    for (long long c0 = first; c0 < re; c0 += chunk) {
      if (c0 != first) {
        // a chunk ended: fold its transmittance into the carried one, then
        // the early exit on the block-wide max of Tc
        float m = 0.0f;
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          Tc[i] *= Tl[i];
          Tl[i] = 1.0f;
          if (threadIdx.x + i * kThreads < n_pix) m = fmaxf(m, Tc[i]);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        __syncthreads();  // every thread is done with the staged chunk
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
      for (int idx = threadIdx.x; idx < 11 * n; idx += kThreads) {
        const int r = idx / n;
        const int j = idx - r * n;
        if (r < 6) {
          const float x = table[r * dom + lo + j];
          if constexpr (kPrec == 0) {
            s_k[r][j] = x;
          } else {
            const float h = round_bf16(x);
            s_k[r][j] = h;
            if constexpr (kPrec == 1) s_kl[r][j] = round_bf16(x - h);
          }
        } else {
          // staged rows 6..10 = table rows 6 (z), 8, 9, 10 (r, g, b), 11
          const int tr = r == 6 ? 6 : r + 1;
          float x = table[tr * dom + lo + j];
          if constexpr (kBf2) {
            if (r >= 7 && r <= 9) x = round_bf16(x);
          }
          s_p[r - 6][j] = x;
        }
      }
      __syncthreads();
      for (int j = 0; j < n; ++j) {
        float k[6], kl[6];
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          k[c] = s_k[c][j];
          if constexpr (kPrec == 1) kl[c] = s_kl[c][j];
        }
        const float z = s_p[0][j];
        const float cr = s_p[1][j], cg = s_p[2][j], cb = s_p[3][j];
        const float alpha = s_p[4][j];
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          // the sixth monomial is 1: its hi is 1 and its lo is 0
          float e = __fadd_rn(dot_rn<kFeat>(k, f[i]), k[5]);
          if constexpr (kPrec == 1) {
            const float hl = dot_rn<kFeat>(k, fl[i]);
            const float lh = __fadd_rn(dot_rn<kFeat>(kl, f[i]), kl[5]);
            e = __fadd_rn(e, __fadd_rn(hl, lh));
          }
          const bool keep = e >= kCutoff && z < d[i];
          const float g = keep ? __fmul_rn(expf(e), alpha) : 0.0f;
          float w = __fmul_rn(__fmul_rn(g, Tl[i]), Tc[i]);
          if constexpr (kBf2) w = round_bf16(w);
          ar[i] = fmaf(cr, w, ar[i]);
          ag[i] = fmaf(cg, w, ag[i]);
          ab[i] = fmaf(cb, w, ab[i]);
          aa[i] += w;
          Tl[i] *= 1.0f - g;  // from the un-rounded g in every variant
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

template <bool kLocal, int kPrec>
auto pick_bf2(int bf2) {
  return bf2 ? micro_raster_kernel<kLocal, kPrec, true>
             : micro_raster_kernel<kLocal, kPrec, false>;
}

template <bool kLocal>
auto pick_prec(int prec, int bf2) {
  return prec == 0 ? pick_bf2<kLocal, 0>(bf2)
         : prec == 1 ? pick_bf2<kLocal, 1>(bf2)
                     : pick_bf2<kLocal, 2>(bf2);
}

}  // namespace

// local: 0 global pixel monomials, 1 tile-local (k3, k4, k5 recentred by the
// caller). prec: 0 highest, 1 split2, 2 default. bf2: colours and weights
// rounded to bf16. depth [n_tiles, tw*th]; out [n_tiles, 4, tw*th].
extern "C" int gswt_micro_raster(const void* table, long long dom,
                                 const void* range_start,
                                 const void* range_end, const void* depth,
                                 void* out, int n_tiles, int ntx, int tw,
                                 int th, int chunk, int local, int prec,
                                 int bf2, void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk || tw * th > kThreads * kPix ||
      prec < 0 || prec > 2 || ntx < 1)
    return (int)cudaErrorInvalidValue;
  if (n_tiles > 0) {
    auto kernel = local ? pick_prec<true>(prec, bf2)
                        : pick_prec<false>(prec, bf2);
    kernel<<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)table, dom, (const int*)range_start,
        (const int*)range_end, (const float*)depth, (float*)out, ntx, tw, th,
        chunk);
  }
  return (int)cudaGetLastError();
}
