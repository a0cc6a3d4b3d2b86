// Min-z triangle rasterizer over tile-sorted (tile, triangle) pairs.
//
// Replaces the Pallas kernel _tri_kernel / _tri_body of
// gswt_renderer_tpu/ops/trirast.py:90 and :126 (pallas_call at :221, reached
// through rasterize_triangles :168); the per-pixel spec is
// rasterize_triangles_reference (:253). Every pair carries 8 screen-space
// planes f(x, y) = a x + b y + c (rows 3k, 3k+1, 3k+2 of the [24, n_pairs]
// table): barycentrics b0, b1 (b2 = 1 - b0 - b1), depth z, 1/w and three
// attributes over w. For image tile t and its run [range_start[t],
// range_end[t]) of the table, per pixel centre:
//
//   inside = b0 >= 0 and b1 >= 0 and b2 >= 0 and z >= 0   (near-plane clip)
//   the run is taken in chunks that begin at GLOBAL multiples of `chunk`;
//   within a chunk the nearest inside pair wins and the attributes of all
//   pairs of the chunk at exactly that z are averaged (z ties happen along
//   shared edges, where the values coincide); a chunk replaces the pixel only
//   if its z is below 1 and strictly below the pixel's z so far.
//
// Output [n_tiles, 5, P]: z (1 where nothing hit: the far plane), then 1/w
// and the three attributes over w of the winner (0 where nothing hit). A tile
// with an empty run is written far-plane by the kernel itself.
//
// Bound: 14 FP32 operations per pair-pixel (three plane evaluations of two
// multiplies and two adds, two subtractions for b2) against 96 B per pair in
// and 20 B per pixel out; for the proxy grid (tens of pairs per tile) the
// output bytes bind. The attribute planes are evaluated only for a pair that
// is the nearest of its pixel so far.
// Design: one CTA per image tile, 256 threads, each owning up to 8 pixels
// whose running z and attributes stay in registers; the run is staged through
// shared memory a chunk at a time and every thread reads a pair's
// coefficients as a broadcast. The inside test flips a pixel between
// triangles (or into a hole) on one ulp, so every plane is evaluated with
// explicitly rounded multiplies and adds, (a*px + b*py) + c, as the plain
// PyTorch version does: no FMA contraction.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 8;        // pixels per thread: tiles up to 2048 px
constexpr int kMaxChunk = 256;
constexpr int kRows = 24;

__device__ __forceinline__ float plane_rn(const float* s, int k, int stride,
                                          int j, float px, float py) {
  const float a = s[(3 * k) * stride + j];
  const float b = s[(3 * k + 1) * stride + j];
  const float c = s[(3 * k + 2) * stride + j];
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

__global__ void __launch_bounds__(kThreads)
trirast_kernel(const float* __restrict__ rows, long long n_pairs,
               const int* __restrict__ range_start,
               const int* __restrict__ range_end, float* __restrict__ out,
               int ntx, int tw, int th, int chunk) {
  __shared__ float s_tab[kRows * kMaxChunk];

  const int tile = blockIdx.x;
  const int n_pix = tw * th;
  const int ox = (tile % ntx) * tw;
  const int oy = (tile / ntx) * th;
  const long long rs = range_start[tile];
  const long long re = range_end[tile];

  float px[kPix], py[kPix], zcur[kPix], at[kPix][4];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int p = threadIdx.x + i * kThreads;
    px[i] = (float)(ox + p % tw) + 0.5f;
    py[i] = (float)(oy + p / tw) + 0.5f;
    zcur[i] = 1.0f;  // far plane
    at[i][0] = at[i][1] = at[i][2] = at[i][3] = 0.0f;
  }

  if (rs < re) {
    for (long long c0 = (rs / chunk) * chunk; c0 < re; c0 += chunk) {
      const long long lo = rs > c0 ? rs : c0;
      const long long hi = re < c0 + chunk ? re : c0 + chunk;
      const int n = (int)(hi - lo);
      __syncthreads();  // every thread is done with the previous chunk
      for (int idx = threadIdx.x; idx < kRows * n; idx += kThreads) {
        const int r = idx / n;
        const int j = idx - r * n;
        s_tab[r * kMaxChunk + j] = rows[r * n_pairs + lo + j];
      }
      __syncthreads();

      // the chunk's nearest hit per pixel, ties counted and summed
      float zmin[kPix], cnt[kPix], sum[kPix][4];
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        zmin[i] = 1.0f;  // only z < 1 can replace a pixel
        cnt[i] = 0.0f;
        sum[i][0] = sum[i][1] = sum[i][2] = sum[i][3] = 0.0f;
      }
      for (int j = 0; j < n; ++j) {
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          const float b0 = plane_rn(s_tab, 0, kMaxChunk, j, px[i], py[i]);
          const float b1 = plane_rn(s_tab, 1, kMaxChunk, j, px[i], py[i]);
          const float b2 = __fsub_rn(__fsub_rn(1.0f, b0), b1);
          const float z = plane_rn(s_tab, 3, kMaxChunk, j, px[i], py[i]);
          const bool inside = b0 >= 0.0f && b1 >= 0.0f && b2 >= 0.0f &&
                              z >= 0.0f;
          if (inside && (z < zmin[i] || (z == zmin[i] && cnt[i] > 0.0f))) {
            if (z < zmin[i]) {
              zmin[i] = z;
              cnt[i] = 0.0f;
              sum[i][0] = sum[i][1] = sum[i][2] = sum[i][3] = 0.0f;
            }
            cnt[i] += 1.0f;
#pragma unroll
            for (int k = 0; k < 4; ++k)
              sum[i][k] = __fadd_rn(
                  sum[i][k],
                  plane_rn(s_tab, 4 + k, kMaxChunk, j, px[i], py[i]));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        if (cnt[i] > 0.0f && zmin[i] < zcur[i]) {
          zcur[i] = zmin[i];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            at[i][k] = __fdiv_rn(sum[i][k], cnt[i]);
        }
      }
    }
  }

  float* o = out + (long long)tile * 5 * n_pix;
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int p = threadIdx.x + i * kThreads;
    if (p < n_pix) {
      o[p] = zcur[i];
#pragma unroll
      for (int k = 0; k < 4; ++k) o[(1 + k) * n_pix + p] = at[i][k];
    }
  }
}

}  // namespace

extern "C" int gswt_trirast(const void* rows, long long n_pairs,
                            const void* range_start, const void* range_end,
                            void* out, int n_tiles, int ntx, int tw, int th,
                            int chunk, void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk || tw <= 0 || th <= 0 || ntx <= 0 ||
      tw * th > kThreads * kPix)
    return (int)cudaErrorInvalidValue;
  if (n_tiles > 0) {
    trirast_kernel<<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)rows, n_pairs, (const int*)range_start,
        (const int*)range_end, (float*)out, ntx, tw, th, chunk);
  }
  return (int)cudaGetLastError();
}
