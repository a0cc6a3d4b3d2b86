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
// and the three attributes over w of the winner (0 where nothing hit).
//
// Bound: 14 FP32 operations per pair-pixel (three plane evaluations of two
// multiplies and two adds, two subtractions for b2) against 96 B per pair in
// and 20 B per pixel out; the attribute planes are evaluated only for a pair
// that is the nearest of its pixel so far. Of those pair-pixels few matter:
// on the proxy grid a triangle's bbox covers about a twentieth of its tile.
// What the card paid instead, in a kernel with one thread block per tile,
// was the longest run (hundreds of pairs of one tile, walked in order on one
// SM, every pair at every pixel).
//
// Design: the run is split at the chunk boundaries, exactly. Chunk by chunk
// the rule above keeps the lexicographic minimum of (the chunk's z, the
// chunk's index) over the chunks that hit, with that chunk's own mean: a
// chunk evaluated whole, in pair order, by any one thread block gives the
// same bits, and a fold in chunk order that takes a chunk only where its z
// is strictly below the running one finishes the tile.
// - Entries. One thread block per (tile, chunk) entry, with no worklist and
//   no host sync: block t < n_tiles takes tile t's first chunk; block
//   n_tiles + c - 1 takes global chunk c (c >= 1) of the one tile whose run
//   holds pair c * chunk past its start (runs are disjoint, so there is at
//   most one). So the grid is n_tiles + ceil(n_pairs / chunk) - 1, sized
//   from what the host knows; a block without an entry returns at once.
//   A tile with an empty run is written far plane by its block t, a tile of
//   one chunk writes its output; the entries of a tile of more write their
//   partial (z, 1 where nothing hit, and the tie means) to a
//   scratch slot: 2c + 1 for the tile's first chunk c (the one tile that
//   starts in chunk c and crosses its end), 2c for a later one (the one tile
//   that crosses the chunk's start).
// - Warp blocks. 32 warps of 2 pixels per thread, each warp one compact
//   block of the tile (16x4 pixels where ceil(tw/16) * ceil(th/4) <= 32,
//   else 64 consecutive pixels), as csrc/raster.cu lays them out. Once the
//   chunk is staged, warp j tests pair j against the 32 blocks, one per
//   lane, and a ballot gives the pair's block mask. (16 warps of 16x8
//   blocks at two thread blocks per SM took 1.35x as long: PERF.md.) A pair cannot cover a
//   pixel centre of a block where one of b0, b1, b2 is below 0 at every
//   centre, or z below 0 or at least 1 (a chunk's z >= 1 never hits and is
//   never tied with a hit): the planes are affine, so their extremes lie at
//   the block's corners, bounded in f64 from the exact products with a
//   margin of 2^-20 of the summed magnitudes over the f32 evaluation's
//   rounding (ops/trirast.py tri_block_mask). A warp walks only its pairs
//   (ballot over the mask words, then their set bits in order) and tests
//   them exactly as before, so a skipped pair-pixel is one that the plain
//   version finds outside, and the bits do not change.
// - Staging. An entry stages its segment of the run (<= chunk columns of
//   the 24 rows) once, with coalesced loads, warp r loading row r:
//   a thread block handles one chunk, so there is no second chunk to
//   overlap with; the card overlaps entries across thread blocks instead.
// - Fold (trirast_fold_kernel), launched when the table has more than one
//   chunk. One thread block per tile; a tile of several chunks takes, per
//   pixel, the first of its slots at the smallest z (the slots' z loaded
//   first, independently), then that slot's means. No atomics: a tie's
//   additions keep their order.
// The inside test flips a pixel between triangles (or into a hole) on one
// ulp, so every plane is evaluated with explicitly rounded multiplies and
// adds, (a*px + b*py) + c, as the plain PyTorch version does: no FMA
// contraction.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPix = 2;        // pixels per thread: tiles up to 2048 px
constexpr int kBlockW = 16;    // warp block: 16 columns x 2 * kPix rows
constexpr int kBlockH = 2 * kPix;
constexpr int kMaxChunk = 256;
constexpr int kRows = 24;
constexpr int kFoldThreads = 1024;
constexpr double kMaskRel = 9.5367431640625e-07;  // 2^-20
constexpr unsigned kFull = 0xffffffffu;

// pixel i of lane `lane` in warp `warp` (ops/raster.py warp_layout)
template <bool kBlock>
__device__ __forceinline__ void pixel_xy(int warp, int lane, int i, int tw,
                                         int& x, int& y) {
  if constexpr (kBlock) {
    const int nbx = (tw + kBlockW - 1) / kBlockW;
    x = (warp % nbx) * kBlockW + (lane & 15);
    y = (warp / nbx) * kBlockH + (lane >> 4) + 2 * i;
  } else {
    const int p = warp * 32 * kPix + lane + 32 * i;
    x = p % tw;
    y = p / tw;
  }
}

__device__ __forceinline__ float plane_rn(const float (*s)[kMaxChunk], int k,
                                          int j, float px, float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(s[3 * k][j], px),
                             __fmul_rn(s[3 * k + 1][j], py)),
                   s[3 * k + 2][j]);
}

// ---- the pair-block mask, in f64 with every operation rounded on its own
// (ops/trirast.py tri_block_mask does the same operations in the same
// order) ----

__device__ __forceinline__ double dmul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double dadd(double a, double b) {
  return __dadd_rn(a, b);
}

struct Rect {
  double u0, u1, v0, v1;
};

// max over the rectangle of a u + b v + c
__device__ __forceinline__ double plane_max(double a, double b, double c,
                                            const Rect& r) {
  return dadd(dadd(c, a > 0.0 ? dmul(a, r.u1) : dmul(a, r.u0)),
              b > 0.0 ? dmul(b, r.v1) : dmul(b, r.v0));
}
// min over the rectangle of a u + b v + c
__device__ __forceinline__ double plane_min(double a, double b, double c,
                                            const Rect& r) {
  return dadd(dadd(c, a > 0.0 ? dmul(a, r.u0) : dmul(a, r.u1)),
              b > 0.0 ? dmul(b, r.v0) : dmul(b, r.v1));
}
// the largest |a u| + |b v| + |c| over the rectangle (u, v > 0)
__device__ __forceinline__ double plane_mag(double a, double b, double c,
                                            const Rect& r) {
  return dadd(dadd(dmul(fabs(a), r.u1), dmul(fabs(b), r.v1)), fabs(c));
}

// false only if no pixel centre of the block can pass b0, b1, b2 >= 0 and
// 0 <= z < 1 in the kernel's f32 evaluation; NaN keeps the block
__device__ bool pair_reaches_block(const float (*tab)[kMaxChunk], int j,
                                   const float* rect) {
  const Rect r{rect[0], rect[1], rect[2], rect[3]};
  if (!(r.u0 <= r.u1)) return false;  // a block without pixels
  const double a0 = tab[0][j], b0 = tab[1][j], c0 = tab[2][j];
  const double a1 = tab[3][j], b1 = tab[4][j], c1 = tab[5][j];
  const double az = tab[9][j], bz = tab[10][j], cz = tab[11][j];
  const double a2 = -dadd(a0, a1), b2 = -dadd(b0, b1);
  const double c2 = dadd(1.0, -dadd(c0, c1));
  const double mb = dmul(
      kMaskRel, dadd(dadd(plane_mag(a0, b0, c0, r), plane_mag(a1, b1, c1, r)),
                     1.0));
  const double mz = dmul(kMaskRel, dadd(plane_mag(az, bz, cz, r), 1.0));
  if (dadd(plane_max(a0, b0, c0, r), mb) < 0.0) return false;
  if (dadd(plane_max(a1, b1, c1, r), mb) < 0.0) return false;
  if (dadd(plane_max(a2, b2, c2, r), mb) < 0.0) return false;
  if (dadd(plane_max(az, bz, cz, r), mz) < 0.0) return false;
  if (dadd(plane_min(az, bz, cz, r), -mz) >= 1.0) return false;
  return true;
}

// the tile's output far plane: z = 1, attributes 0
__device__ __forceinline__ void write_far(float* o, int n_pix) {
  for (int p = threadIdx.x; p < n_pix; p += blockDim.x) {
    o[p] = 1.0f;
#pragma unroll
    for (int k = 1; k < 5; ++k) o[k * n_pix + p] = 0.0f;
  }
}

template <bool kBlock>
__global__ void __launch_bounds__(kThreads, 1)
trirast_kernel(const float* __restrict__ rows, long long n_pairs,
               const int* __restrict__ range_start,
               const int* __restrict__ range_end, float* __restrict__ out,
               float* __restrict__ scratch, int n_tiles, int ntx, int tw,
               int th, int chunk) {
  __shared__ float s_tab[kRows][kMaxChunk];
  __shared__ uint32_t s_mask[kMaxChunk];
  __shared__ float s_rect[kWarps][4];
  __shared__ int s_tile;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // this block's entry: (tile, global chunk c)
  int tile;
  long long c;
  if ((int)blockIdx.x < n_tiles) {
    tile = blockIdx.x;
    const long long rs = range_start[tile];
    if (rs >= range_end[tile]) {  // an empty run: far plane
      write_far(out + (long long)tile * 5 * tw * th, tw * th);
      return;
    }
    c = rs / chunk;
  } else {
    c = (long long)blockIdx.x - n_tiles + 1;
    const long long at = c * chunk;
    if (threadIdx.x == 0) s_tile = -1;
    __syncthreads();
    for (int t = threadIdx.x; t < n_tiles; t += kThreads)
      if (range_start[t] < at && at < range_end[t]) s_tile = t;
    __syncthreads();
    tile = s_tile;
    if (tile < 0) return;
  }
  const long long rs = range_start[tile];
  const long long re = range_end[tile];
  const long long c0 = rs / chunk;
  const bool single = c0 == (re - 1) / chunk;
  const long long lo = rs > c * chunk ? rs : c * chunk;
  const long long hi = re < (c + 1) * chunk ? re : (c + 1) * chunk;
  const int n = (int)(hi - lo);
  const int n_pix = tw * th;
  const int ox = (tile % ntx) * tw;
  const int oy = (tile / ntx) * th;

  // stage the entry's columns of the 24 rows
  for (int r = warp; r < kRows; r += kWarps)
    for (int j = lane; j < n; j += 32)
      s_tab[r][j] = __ldg(rows + r * n_pairs + lo + j);
  if (lane == 0) {
    // the warp block: the rectangle of its pixel centres in image
    // coordinates (u0 > u1: none)
    int x0, x1, y0, y1;
    if constexpr (kBlock) {
      const int nbx = (tw + kBlockW - 1) / kBlockW;
      x0 = (warp % nbx) * kBlockW;
      y0 = (warp / nbx) * kBlockH;
      x1 = min(x0 + kBlockW - 1, tw - 1);
      y1 = min(y0 + kBlockH - 1, th - 1);
    } else {
      const int p0 = warp * 32 * kPix, p1 = min(p0 + 32 * kPix - 1, n_pix - 1);
      y0 = p0 / tw;
      y1 = p1 / tw;
      x0 = y0 == y1 ? p0 % tw : 0;
      x1 = y0 == y1 ? p1 % tw : tw - 1;
    }
    const bool none = y0 >= th;
    s_rect[warp][0] = none ? 1.0f : (float)(ox + x0) + 0.5f;
    s_rect[warp][1] = none ? 0.0f : (float)(ox + x1) + 0.5f;
    s_rect[warp][2] = (float)(oy + y0) + 0.5f;
    s_rect[warp][3] = (float)(oy + y1) + 0.5f;
  }
  __syncthreads();

  // pair j's block mask: warp j % 32 tests it, lane w against block w
  for (int j = warp; j < n; j += kWarps) {
    const unsigned m = __ballot_sync(kFull, pair_reaches_block(s_tab, j,
                                                               s_rect[lane]));
    if (lane == 0) s_mask[j] = m;
  }
  __syncthreads();

  // this thread's pixel centres: in the block layout one column (px[0])
  // and the rows py[0] + 2i; in the flat layout one (px, py) per pixel
  float px[kBlock ? 1 : kPix], py[kBlock ? 1 : kPix];
  float zmin[kPix], cnt[kPix], sum[kPix][4];
  unsigned valid = 0;
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    int x, y;
    pixel_xy<kBlock>(warp, lane, i, tw, x, y);
    if (x < tw && y < th) valid |= 1u << i;
    if (!kBlock || i == 0) {
      px[kBlock ? 0 : i] = (float)(ox + x) + 0.5f;
      py[kBlock ? 0 : i] = (float)(oy + y) + 0.5f;
    }
    zmin[i] = 1.0f;  // only z < 1 can hit
    cnt[i] = 0.0f;
    sum[i][0] = sum[i][1] = sum[i][2] = sum[i][3] = 0.0f;
  }

  // this warp's pairs, in order: the chunk's nearest hit per pixel, ties
  // counted and summed
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int jl = j0 + lane;
    unsigned todo =
        __ballot_sync(kFull, jl < n && ((s_mask[jl] >> warp) & 1u));
    while (todo) {
      const int j = j0 + __ffs(todo) - 1;
      todo &= todo - 1;
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        const float pu = kBlock ? px[0] : px[i];
        const float pv = kBlock ? py[0] + (float)(2 * i) : py[i];
        const float b0 = plane_rn(s_tab, 0, j, pu, pv);
        const float b1 = plane_rn(s_tab, 1, j, pu, pv);
        const float b2 = __fsub_rn(__fsub_rn(1.0f, b0), b1);
        const float z = plane_rn(s_tab, 3, j, pu, pv);
        const bool inside =
            b0 >= 0.0f && b1 >= 0.0f && b2 >= 0.0f && z >= 0.0f;
        if (inside && (z < zmin[i] || (z == zmin[i] && cnt[i] > 0.0f))) {
          if (z < zmin[i]) {
            zmin[i] = z;
            cnt[i] = 0.0f;
            sum[i][0] = sum[i][1] = sum[i][2] = sum[i][3] = 0.0f;
          }
          cnt[i] += 1.0f;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            sum[i][k] =
                __fadd_rn(sum[i][k], plane_rn(s_tab, 4 + k, j, pu, pv));
        }
      }
    }
  }

  // a one-chunk tile is done; a longer one leaves its partial for the fold
  float* o = single ? out + (long long)tile * 5 * n_pix
                    : scratch + (2 * c + (c == c0 ? 1 : 0)) * 5 * n_pix;
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    if (valid & (1u << i)) {
      int x, y;
      pixel_xy<kBlock>(warp, lane, i, tw, x, y);
      const int p = y * tw + x;
      o[p] = zmin[i];  // 1 where nothing hit
#pragma unroll
      for (int k = 0; k < 4; ++k)
        o[(1 + k) * n_pix + p] =
            cnt[i] > 0.0f ? __fdiv_rn(sum[i][k], cnt[i]) : 0.0f;
    }
  }
}

__global__ void __launch_bounds__(kFoldThreads)
trirast_fold_kernel(const int* __restrict__ range_start,
                    const int* __restrict__ range_end,
                    const float* __restrict__ scratch, float* __restrict__ out,
                    int n_pix, int chunk) {
  const int tile = blockIdx.x;
  const long long rs = range_start[tile];
  const long long re = range_end[tile];
  if (rs >= re) return;  // written far plane by its entry
  const long long c0 = rs / chunk, c1 = (re - 1) / chunk;
  if (c0 == c1) return;  // written by its entry
  const int n_c = (int)(c1 - c0 + 1);
  float* o = out + (long long)tile * 5 * n_pix;
  for (int p = threadIdx.x; p < n_pix; p += kFoldThreads) {
    // the chunks' z first (independent loads), then the winner's means
    float z = 1.0f;
    int best = -1;
#pragma unroll 4
    for (int k = 0; k < n_c; ++k) {
      const long long slot = 2 * (c0 + k) + (k == 0 ? 1 : 0);
      const float zc = scratch[slot * 5 * n_pix + p];
      if (zc < z) {  // strictly nearer: the earliest chunk at a z wins
        z = zc;
        best = k;
      }
    }
    o[p] = z;
    const long long slot = 2 * (c0 + best) + (best == 0 ? 1 : 0);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      o[(1 + k) * n_pix + p] =
          best < 0 ? 0.0f : scratch[(slot * 5 + 1 + k) * n_pix + p];
  }
}

}  // namespace

// mode: 1 the entries, 2 the fold, 3 both (the raster). scratch: [2 *
// ceil(n_pairs / chunk), 5, tw * th] f32 (ops/trirast.py fold_scratch).
extern "C" int gswt_trirast(const void* rows, long long n_pairs,
                            const void* range_start, const void* range_end,
                            void* out, void* scratch, int n_tiles, int ntx,
                            int tw, int th, int chunk, int mode,
                            void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk || tw <= 0 || th <= 0 || ntx <= 0 ||
      tw * th > kThreads * kPix || n_pairs < 0 ||
      (n_pairs > chunk && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long n_chunks = (n_pairs + chunk - 1) / chunk;
  cudaStream_t s = (cudaStream_t)stream;
  if ((mode & 1) && n_tiles > 0) {
    const unsigned grid =
        (unsigned)(n_tiles + (n_chunks > 1 ? n_chunks - 1 : 0));
    const bool block =
        ((tw + kBlockW - 1) / kBlockW) * ((th + kBlockH - 1) / kBlockH) <=
        kWarps;
    auto kernel = block ? trirast_kernel<true> : trirast_kernel<false>;
    kernel<<<grid, kThreads, 0, s>>>(
        (const float*)rows, n_pairs, (const int*)range_start,
        (const int*)range_end, (float*)out, (float*)scratch, n_tiles, ntx, tw,
        th, chunk);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  if ((mode & 2) && n_chunks > 1 && n_tiles > 0) {
    trirast_fold_kernel<<<n_tiles, kFoldThreads, 0, s>>>(
        (const int*)range_start, (const int*)range_end,
        (const float*)scratch, (float*)out, tw * th, chunk);
  }
  return (int)cudaGetLastError();
}
