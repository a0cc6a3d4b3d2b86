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
//   Here each pair's colours are rounded to bf16 where they are read, and
//   each weight w = g T is rounded to bf16 before the f32 accumulate (alpha
//   is the sum of the rounded weights). The exponent stays the f32
//   evaluation below: the TPU's bf16 hi/lo split is its way to an f32
//   product on the MXU, not part of the result.
// kZcut (emit_zcut, _sat_update / _sat_flush): the saturation-SLOT record.
//   Row 12 of the table (the pair's stream slot) is staged too. Per
//   composited chunk, smax = the max slot over the chunk's in-run pairs,
//   and every pixel whose T where the chunk STARTS is >= MIN_T raises its
//   record to smax; chunks the early exit skips update nothing. At the end,
//   per band b = min(row / max(th/4, 1), 3), cut[b] = max over the band's
//   pixels of (T < MIN_T ? record + 0.5 : 2^25): one unsaturated pixel makes
//   its band uncuttable. zcut is [n_tiles, 4].
//
// Bound: operations. A pair-pixel that passes the cutoff and the depth test
// needs 22 FP32 operations (10 for e, 1 for e + ln alpha, 1 for g*T, 4 FMAs,
// 1 for 1-g, 1 for T*; kFast 2 more for the weight's bf16 round trip) and
// one exp on the SFU; one that fails needs nothing, since its g is 0. On a
// 1080p frame about a tenth of the composited pair-pixels pass, so the
// least work is that of the kept ones; the table (11 or 12 rows of 4 B per
// pair) and the output (16 B per pixel) are a minor term. What the card
// pays instead is the longest run: a tile's pairs are walked in order, and
// on the 1080p frames the tile with the longest run (32K pairs, none
// saturating) took nearly the whole kernel time when one SM walked it.
//
// Design: one cluster of four CTAs per image tile, 256 threads each, so a
// tile's walk is spread over four SMs. The tile's pixels are owned as by
// one CTA of 32 warps, each thread owning 2 pixels whose T and colour sums
// stay in registers for the whole run, so every pixel sees the same pairs
// in the same order through the same explicitly rounded operations
// whatever the cluster does. CTA rank r holds, of each group g of four
// consecutive warps (a row of four 16x4 blocks in a 64x32 tile), warp
// 4g + (r - g) mod 4: the blocks in a checkerboard of four colours, so that
// pairs crowding one part of the tile load the four SMs alike (a rank of
// 8 consecutive warps, a 64x8 strip, left one SM with up to 25 times the
// pairs of another on the 1080p frames). Four CTAs of different tiles share
// an SM, so one CTA's barrier or mask phase does not idle it (PERF.md has
// the layouts tried and their times).
// - Warp blocks. Each warp owns one compact block of the tile: 16x4 pixels
//   when ceil(tw/16) * ceil(th/4) <= 32 (64x32 tiles: 4 x 8 blocks; lane l
//   owns column l % 16 and rows l / 16 + 2i, i < 2), else the flat layout
//   (warp w owns pixels 64w .. 64w + 63 of the row-major tile, lane l
//   pixels 64w + l + 32i). The block is the rectangle of its pixel centres
//   (rows spanned, and the columns spanned when they lie in one row). A
//   tile of fewer than 32 warps of pixels may leave ranks without pixels;
//   they join every barrier all the same.
// - Pair-block mask. Once a chunk is staged, each CTA computes, one thread
//   per pair, an 8-bit mask of its own warp blocks the pair can reach: the
//   max of its exponent over the block's rectangle, the max of a concave
//   quadratic over a rectangle (the shape of ops/binning.py _rect_min_q),
//   from the centre and peak recovered in f64 (products of f32 values are
//   exact in f64, so only the last subtraction and the division round),
//   tested against CUTOFF - 1 - 2^-20 S, where S bounds the magnitude of the
//   terms the kernel's f32 evaluation sums (its rounding is below 6 * 2^-24
//   S). A pair whose quadratic is not negative definite gets every block
//   whose trivial bound (k5 + the sum of |k_i| times the block's largest
//   monomials) reaches the limit; a dead pair (k5 = -1e30) gets none. With
//   use_depth, a block whose largest depth is <= z is left out too: no pixel
//   of it passes z < depth. The same thread packs the pair's walk data into
//   three float4s (the colours already rounded in the fast variant).
// - Warp-uniform skip. A warp walks only the pairs whose bit it owns (a
//   ballot over 32 mask words, then their set bits in order). Inside a pair
//   every lane evaluates e for its 2 pixels (explicitly rounded multiplies
//   and adds in the plain version's order); the exp and the accumulate run
//   only when __any_sync says a lane keeps a pixel, and then for both
//   pixels at once without a branch, a pixel not kept taking expf(-inf) =
//   0 (branches around each exp had serialised the two and doubled the
//   walk's time). A skipped pair-pixel had g = 0, so w = 0 and T *= 1: the
//   output, T, the early exit and the saturation record are bit for bit
//   those of a kernel that walks every pair-pixel.
// - Early exit across the cluster. Where a global multiple of `chunk`
//   begins, each CTA reduces its pixels' max T and stores it into its slot
//   of every CTA's shared memory with st.async, which completes on that
//   CTA's mbarrier for the boundary's parity (two slots and barriers: a CTA
//   that runs ahead writes the other ones); it computes the chunk's masks
//   while the others' values arrive, then waits on its own barrier and
//   reads the four slots, so every CTA takes the same decision a single
//   CTA's reduction over the whole tile takes. (A cluster barrier there
//   costs each thread a GPU-scope fence and an L1 invalidation.)
// - Staging ring. The whole aligned chunk [c0, c0 + chunk) is staged (dom
//   is a multiple of chunk, so every row segment is 16-B aligned) into a
//   2-stage ring in each CTA's shared memory: rank q issues the rows r with
//   r % 4 == q as 1-D bulk copies multicast to all four CTAs, each landing
//   at the same offset and completing on each CTA's mbarrier of the stage,
//   so the table crosses L2 once per tile. A CTA expects the whole chunk's
//   bytes on its own barrier. The next chunk is issued once every CTA's
//   value for this boundary has arrived (each sent it after its last read
//   of the stage it overwrites) and loads while this one composites.
//   Columns outside the run are masked.
// - Saturation record. Each pixel raises its band's cut in its CTA's
//   shared memory; the other ranks fold their four bands into rank 0's
//   through distributed shared memory, and rank 0 writes zcut after the
//   last cluster barrier (which also keeps every CTA's shared memory alive
//   while another may read it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "torch_semantics.cuh"

namespace {

constexpr int kCluster = 4;         // CTAs per tile
constexpr int kThreads = 256;       // per CTA
constexpr int kCtasPerSm = 4;       // as many threads an SM as 32 warps
constexpr int kWarps = kThreads / 32;          // a CTA's warps
constexpr int kTileWarps = kCluster * kWarps;  // a tile's: 32
constexpr int kPix = 2;             // pixels per thread: tiles up to 2048 px
constexpr int kBlockW = 16;         // warp block: 16 columns x 2 * kPix rows
constexpr int kBlockH = 2 * kPix;
constexpr int kMaxChunk = kThreads;  // one thread per pair computes its mask
constexpr int kStages = 2;
constexpr float kCutoff = -4.0f;    // fragment discard (gswt.wgsl:427-430)
constexpr float kMinT = 0.5f / 255.0f;
constexpr int kRows = 11;           // k0..k5, z, r, g, b, ln alpha
constexpr int kSlotRow = 11;        // staged after them when kZcut: the slot
constexpr int kBands = 4;           // SAT_BANDS
constexpr float kSatNoCut = 33554432.0f;  // SAT_NOCUT = 2^25
constexpr float kCutBump = 0.5f;
// the mask's limit: CUTOFF - kMaskMargin - kMaskRel * S
constexpr double kMaskMargin = 1.0;
constexpr double kMaskRel = 9.5367431640625e-07;  // 2^-20
constexpr unsigned kFull = 0xffffffffu;
constexpr uint16_t kAllRanks = (1u << kCluster) - 1;
static_assert(kTileWarps == 32 && (kCluster & (kCluster - 1)) == 0,
              "the ranks' checkerboard takes 32 warps and a power of 2");

__device__ __forceinline__ int table_row(int r) { return r < 7 ? r : r + 1; }

// pixel i of lane `lane` in warp `warp` of the tile's 32 (ops/raster.py
// warp_layout)
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

// ---- the pair-block mask, in f64 with every operation rounded on its own
// (ops/raster.py pair_block_mask does the same operations in the same
// order) ----

__device__ __forceinline__ double dmul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double dadd(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double dclamp(double x, double lo, double hi) {
  return fmin(fmax(x, lo), hi);
}

// min over the rectangle [lx0, lx1] x [ly0, ly1] (relative to the centre)
// of Q = a x^2 + 2 b xy + c y^2, positive definite (binning._rect_min_q)
__device__ __forceinline__ double rect_min_q(double a, double b, double c,
                                             double rba, double rbc,
                                             double lx0, double lx1,
                                             double ly0, double ly1) {
  if (lx0 <= 0.0 && 0.0 <= lx1 && ly0 <= 0.0 && 0.0 <= ly1) return 0.0;
  auto edge_x = [&](double dx) {  // x fixed at dx, y in [ly0, ly1]
    const double t = dclamp(-dmul(rbc, dx), ly0, ly1);
    return dadd(dadd(dmul(dmul(a, dx), dx), dmul(dmul(2.0 * b, dx), t)),
                dmul(dmul(c, t), t));
  };
  auto edge_y = [&](double dy) {  // y fixed at dy, x in [lx0, lx1]
    const double t = dclamp(-dmul(rba, dy), lx0, lx1);
    return dadd(dadd(dmul(dmul(c, dy), dy), dmul(dmul(2.0 * b, dy), t)),
                dmul(dmul(a, t), t));
  };
  return fmin(fmin(edge_x(lx0), edge_x(lx1)), fmin(edge_y(ly0), edge_y(ly1)));
}

// bit w set unless no pixel centre of this CTA's warp block w can give e >=
// CUTOFF in the kernel's f32 evaluation (or, with use_depth, pass z < depth)
__device__ unsigned pair_block_mask(const float (*tab)[kMaxChunk], int j,
                                    int use_depth, const float (*rect)[4],
                                    const float* dmax) {
  const double k0 = tab[0][j], k1 = tab[1][j], k2 = tab[2][j],
               k3 = tab[3][j], k4 = tab[4][j], k5 = tab[5][j];
  const float z = tab[6][j];
  const double a = -k0, b = -0.5 * k1, c = -k2;
  const double det = dadd(dmul(a, c), -dmul(b, b));
  const bool definite = a > 0.0 && det > 0.0;
  double uc = 0.0, vc = 0.0, ec = 0.0, mc = 0.0, rba = 0.0, rbc = 0.0;
  if (definite) {
    const double half_inv = 0.5 / det;
    uc = dmul(dadd(dmul(c, k3), -dmul(b, k4)), half_inv);
    vc = dmul(dadd(dmul(a, k4), -dmul(b, k3)), half_inv);
    const double tu = dmul(k3, uc), tv = dmul(k4, vc);
    ec = dadd(k5, dmul(0.5, dadd(tu, tv)));
    mc = dadd(fabs(tu), fabs(tv));
    rba = b / a;
    rbc = b / c;
  }
  unsigned bits = 0;
#pragma unroll 2  // two blocks' f64 chains at once
  for (int w = 0; w < kWarps; ++w) {
    const double u0 = rect[w][0], u1 = rect[w][1];
    const double v0 = rect[w][2], v1 = rect[w][3];
    if (u0 > u1) continue;                           // no pixels
    if (use_depth && !(z < dmax[w])) continue;       // all behind the depth
    // the largest |term| of e over the block: every monomial is positive
    // and grows with u and v, so it peaks at the far corner
    const double s5 = dadd(dadd(dadd(dadd(
        dmul(fabs(k0), dmul(u1, u1)), dmul(fabs(k1), dmul(u1, v1))),
        dmul(fabs(k2), dmul(v1, v1))), dmul(fabs(k3), u1)),
        dmul(fabs(k4), v1));
    const double lim = dadd(
        (double)kCutoff,
        -dadd(kMaskMargin, dmul(kMaskRel, dadd(dadd(s5, fabs(k5)), mc))));
    if (dadd(k5, s5) < lim) continue;                // trivially below
    if (!definite) {
      bits |= 1u << w;
      continue;
    }
    const double rmin = rect_min_q(a, b, c, rba, rbc, dadd(u0, -uc),
                                   dadd(u1, -uc), dadd(v0, -vc),
                                   dadd(v1, -vc));
    if (!(dadd(ec, -rmin) < lim)) bits |= 1u << w;
  }
  return bits;
}

// ---- the cluster: its barrier and its distributed shared memory ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of the cluster arrives (releasing its writes) and later
// waits (acquiring the others')
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// the address of `p` in the shared memory of the cluster's CTA `rank`
__device__ __forceinline__ uint32_t remote(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_addr(p)), "r"(rank));
  return a;
}

// store v at p in CTA `rank`, completing 4 bytes on its mbarrier at bar:
// the value travels with the barrier's phase, so no fence is needed
__device__ __forceinline__ void store_remote(float* p, float v, uint64_t* bar,
                                             uint32_t rank) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" ::"r"(remote(p, rank)),
      "f"(v), "r"(remote(bar, rank))
      : "memory");
}

__device__ __forceinline__ void max_remote(int* p, uint32_t rank, int v) {
  asm volatile("red.shared::cluster.max.s32 [%0], %1;\n" ::"r"(
                   remote(p, rank)),
               "r"(v)
               : "memory");
}

// ---- the staging ring: 1-D bulk copies completing on an mbarrier ----

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// stage the chunk at column c0 of `rows` table rows into s[rows][kMaxChunk]
// of every CTA of the cluster: this CTA expects all of it on its own
// barrier and issues the rows r % kCluster == rank, each multicast to the
// same offset of every CTA and completing on each one's barrier there
template <int kStaged>
__device__ __forceinline__ void stage_chunk(float (*s)[kMaxChunk],
                                            uint64_t* bar, uint32_t rank,
                                            const float* table, long long dom,
                                            long long c0, int chunk) {
  const uint32_t bytes = (uint32_t)chunk * 4u;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  bar_expect(bar, bytes * kStaged);
  for (int r = (int)rank; r < kStaged; r += kCluster) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(
            smem_addr(s[r])),
        "l"(table + table_row(r) * dom + c0), "r"(bytes), "r"(smem_addr(bar)),
        "h"(kAllRanks)
        : "memory");
  }
}

template <bool kFast, bool kZcut, bool kBlock>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, kCtasPerSm)
raster_kernel(const float* __restrict__ table, long long dom,
              const int* __restrict__ range_start,
              const int* __restrict__ range_end,
              const float* __restrict__ depth, int use_depth,
              float* __restrict__ out, float* __restrict__ zcut,
              int tw, int th, int chunk) {
  constexpr int kStaged = kZcut ? kRows + 1 : kRows;
  __shared__ __align__(128) float s_tab[kStages][kStaged][kMaxChunk];
  __shared__ uint32_t s_mask[kMaxChunk];
  // each in-run pair's walk data: (k0, k1, k2, k3), (k4, k5, z, ln a),
  // its colours as the variant reads them
  __shared__ float4 s_pair[kMaxChunk][3];
  __shared__ float s_rect[kWarps][4];
  __shared__ float s_dmax[kWarps];
  __shared__ float s_red[kWarps];
  __shared__ float s_smax[kWarps];
  // every CTA's max T at a boundary, by the boundary's parity, and the
  // barriers their stores complete on
  __shared__ float s_tmax[2][kCluster];
  __shared__ int s_band[kBands];
  __shared__ __align__(8) uint64_t s_bar[kStages];
  __shared__ __align__(8) uint64_t s_xbar[2];

  const int tile = blockIdx.x / kCluster;
  const uint32_t rank = cluster_rank();
  const int n_pix = tw * th;
  const int lw = threadIdx.x >> 5;          // the warp in this CTA
  // and in the tile: the checkerboard of the ranks
  const int warp = kCluster * lw + (((int)rank - lw) & (kCluster - 1));
  const int lane = threadIdx.x & 31;
  const long long rs = range_start[tile];
  const long long re = range_end[tile];

  // this thread's pixels: in the block layout one column (u) and the rows
  // v0 + 2i; in the flat layout one (u, v) per pixel
  float u[kBlock ? 1 : kPix], v[kBlock ? 1 : kPix];
  float d[kPix], T[kPix], ar[kPix], ag[kPix], ab[kPix], aa[kPix];
  unsigned valid = 0;
  float dm = -INFINITY;  // the largest depth of this thread's pixels
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    int x, y;
    pixel_xy<kBlock>(warp, lane, i, tw, x, y);
    const bool ok = x < tw && y < th;
    if (ok) valid |= 1u << i;
    if (!kBlock || i == 0) {
      u[kBlock ? 0 : i] = (float)x + 0.5f;
      v[kBlock ? 0 : i] = (float)y + 0.5f;
    }
    d[i] = (use_depth && ok) ? depth[(long long)tile * n_pix + y * tw + x]
                             : 1.0f;
    if (ok) dm = fmaxf(dm, d[i]);
    T[i] = 1.0f;
    ar[i] = ag[i] = ab[i] = aa[i] = 0.0f;
  }
  float rec[kZcut ? kPix : 1];
  if constexpr (kZcut) {
#pragma unroll
    for (int i = 0; i < kPix; ++i) rec[i] = 0.0f;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    dm = fmaxf(dm, __shfl_xor_sync(kFull, dm, off));
  if (lane == 0) {
    // the warp block: the rectangle of its pixel centres (u0 > u1: none)
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
    s_rect[lw][0] = none ? 1.0f : (float)x0 + 0.5f;
    s_rect[lw][1] = none ? 0.0f : (float)x1 + 0.5f;
    s_rect[lw][2] = (float)y0 + 0.5f;
    s_rect[lw][3] = (float)y1 + 0.5f;
    s_dmax[lw] = dm;
  }
  if (kZcut && threadIdx.x < kBands)
    s_band[threadIdx.x] = __float_as_int(-1.0f);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) bar_init(&s_bar[s]);
    for (int s = 0; s < 2; ++s) bar_init(&s_xbar[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every CTA's barriers are set up before any copy signals them
  cluster_arrive();
  cluster_wait();

  if (rs < re) {
    const long long first = (rs / chunk) * chunk;
    if (threadIdx.x == 0)
      stage_chunk<kStaged>(s_tab[0], &s_bar[0], rank, table, dom, first,
                           chunk);
    int k = 0;
    for (long long c0 = first; c0 < re; c0 += chunk, ++k) {
      const int st = k & 1;
      if (k > 0) {
        // early exit at a chunk boundary: this CTA's max of T, for the
        // cluster's
        float m = 0.0f;
#pragma unroll
        for (int i = 0; i < kPix; ++i)
          if (valid & (1u << i)) m = fmaxf(m, T[i]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
        __syncthreads();  // every thread is done with the last chunk
        if (lane == 0) s_red[lw] = m;
        __syncthreads();
        if (threadIdx.x == 0) {
#pragma unroll
          for (int w = 1; w < kWarps; ++w) m = fmaxf(m, s_red[w]);
          m = fmaxf(m, s_red[0]);
          bar_expect(&s_xbar[st], 4u * kCluster);
#pragma unroll
          for (uint32_t q = 0; q < kCluster; ++q)
            store_remote(&s_tmax[st][rank], m, &s_xbar[st], q);
        }
      }
      bar_wait(&s_bar[st], (k >> 1) & 1);
      const float(*tab)[kMaxChunk] = s_tab[st];

      // the pair-block masks of the in-run columns (and the chunk's max
      // slot over them), one thread per pair, while the other CTAs' values
      // arrive
      const int j_lo = (int)((rs > c0 ? rs : c0) - c0);
      const int j_hi = (int)((re < c0 + chunk ? re : c0 + chunk) - c0);
      float smax = -1.0f;
      {
        const int j = threadIdx.x;
        unsigned m = 0;
        if (j >= j_lo && j < j_hi) {
          m = pair_block_mask(tab, j, use_depth, s_rect, s_dmax);
          if constexpr (kZcut) smax = fmaxf(smax, tab[kSlotRow][j]);
          float cr = tab[7][j], cg = tab[8][j], cb = tab[9][j];
          if constexpr (kFast) {
            cr = round_bf16(cr);
            cg = round_bf16(cg);
            cb = round_bf16(cb);
          }
          s_pair[j][0] = make_float4(tab[0][j], tab[1][j], tab[2][j],
                                     tab[3][j]);
          s_pair[j][1] = make_float4(tab[4][j], tab[5][j], tab[6][j],
                                     tab[10][j]);
          s_pair[j][2] = make_float4(cr, cg, cb, 0.0f);
        }
        if (j < chunk) s_mask[j] = m;
      }
      if constexpr (kZcut) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          smax = fmaxf(smax, __shfl_xor_sync(kFull, smax, off));
        if (lane == 0) s_smax[lw] = smax;
      }
      if (k > 0) {
        bar_wait(&s_xbar[st], ((k - 1) >> 1) & 1);
        float m = s_tmax[st][0];
#pragma unroll
        for (int q = 1; q < kCluster; ++q) m = fmaxf(m, s_tmax[st][q]);
        if (m < kMinT) break;  // the same decision in every CTA
      }
      // the next chunk into the other stage, which every CTA of the
      // cluster last read before it sent its value above, while this one
      // composites
      if (threadIdx.x == 0 && c0 + chunk < re)
        stage_chunk<kStaged>(s_tab[st ^ 1], &s_bar[st ^ 1], rank, table, dom,
                             c0 + chunk, chunk);
      __syncthreads();
      unsigned vis = 0;  // pixels still visible where this chunk starts
      if constexpr (kZcut) {
        smax = s_smax[0];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) smax = fmaxf(smax, s_smax[w]);
#pragma unroll
        for (int i = 0; i < kPix; ++i)
          if (T[i] >= kMinT) vis |= 1u << i;
      }

      // this warp's pairs, in order: a pair's data in three loads, the
      // exps of both pixels without a branch (expf(-inf) is 0)
      for (int j0 = j_lo & ~31; j0 < j_hi; j0 += 32) {
        const int jl = j0 + lane;
        unsigned todo = __ballot_sync(
            kFull, jl < j_hi && ((s_mask[jl] >> lw) & 1u));
#pragma unroll 1
        while (todo) {
          const int j = j0 + __ffs(todo) - 1;
          todo &= todo - 1;
          const float4 p0 = s_pair[j][0], p1 = s_pair[j][1], c = s_pair[j][2];
          float x[kPix];
          bool any = false;
#pragma unroll
          for (int i = 0; i < kPix; ++i) {
            float pu, pv;  // the pixel centre
            if constexpr (kBlock) {
              pu = u[0];
              pv = v[0] + (float)(2 * i);
            } else {
              pu = u[i];
              pv = v[i];
            }
            float e = __fmul_rn(p0.x, __fmul_rn(pu, pu));
            e = __fadd_rn(e, __fmul_rn(p0.y, __fmul_rn(pu, pv)));
            e = __fadd_rn(e, __fmul_rn(p0.z, __fmul_rn(pv, pv)));
            e = __fadd_rn(e, __fmul_rn(p0.w, pu));
            e = __fadd_rn(e, __fmul_rn(p1.x, pv));
            e = __fadd_rn(e, p1.y);
            const bool keep = e >= kCutoff && (!use_depth || p1.z < d[i]);
            any |= keep;
            x[i] = keep ? __fadd_rn(e, p1.w) : -INFINITY;
          }
          if (!__any_sync(kFull, any)) continue;  // uniform over the warp
#pragma unroll
          for (int i = 0; i < kPix; ++i) {
            const float g = expf(x[i]);
            float w = __fmul_rn(g, T[i]);
            if constexpr (kFast) w = round_bf16(w);
            ar[i] = fmaf(c.x, w, ar[i]);
            ag[i] = fmaf(c.y, w, ag[i]);
            ab[i] = fmaf(c.z, w, ab[i]);
            aa[i] = __fadd_rn(aa[i], w);
            // from the un-rounded g in every variant
            T[i] = __fmul_rn(T[i], __fsub_rn(1.0f, g));
          }
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
    if (valid & (1u << i)) {
      int x, y;
      pixel_xy<kBlock>(warp, lane, i, tw, x, y);
      const int p = y * tw + x;
      o[p] = ar[i];
      o[n_pix + p] = ag[i];
      o[2 * n_pix + p] = ab[i];
      o[3 * n_pix + p] = aa[i];
    }
  }

  if constexpr (kZcut) {
    // band cuts: the values are >= 0.5, so their bit patterns order as
    // ints; -1.0f (a band without pixels) is below all of them
    const int band_rows = th / kBands > 1 ? th / kBands : 1;
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      if (valid & (1u << i)) {
        int x, y;
        pixel_xy<kBlock>(warp, lane, i, tw, x, y);
        const int b = min(y / band_rows, kBands - 1);
        const float cut = T[i] < kMinT ? rec[i] + kCutBump : kSatNoCut;
        atomicMax(&s_band[b], __float_as_int(cut));
      }
    }
    __syncthreads();
    if (rank != 0 && threadIdx.x < kBands)
      max_remote(&s_band[threadIdx.x], 0, s_band[threadIdx.x]);
  }
  // no CTA leaves while another may still read or fold into its shared
  // memory
  cluster_arrive();
  cluster_wait();
  if (kZcut && rank == 0 && threadIdx.x < kBands)
    zcut[(long long)tile * kBands + threadIdx.x] =
        __int_as_float(s_band[threadIdx.x]);
}

using Kernel = void (*)(const float*, long long, const int*, const int*,
                       const float*, int, float*, float*, int, int, int);

template <bool kFast, bool kZcut>
Kernel pick(bool block) {
  return block ? raster_kernel<kFast, kZcut, true>
               : raster_kernel<kFast, kZcut, false>;
}

Kernel pick(int fast, bool zcut, bool block) {
  return fast ? (zcut ? pick<true, true>(block) : pick<true, false>(block))
              : (zcut ? pick<false, true>(block) : pick<false, false>(block));
}

bool block_layout(int tw, int th) {
  return ((tw + kBlockW - 1) / kBlockW) * ((th + kBlockH - 1) / kBlockH) <=
         kTileWarps;
}

}  // namespace

// fast: 0 the exact variant, 1 the fast profile's. zcut: null, or the
// [n_tiles, 4] saturation-slot record to write. The table must be 16-B
// aligned with dom a multiple of chunk and chunk a multiple of 4 (the
// staging copies move whole 16-B aligned row segments).
extern "C" int gswt_raster(const void* table, long long dom,
                           const void* range_start, const void* range_end,
                           const void* depth, int use_depth, int fast,
                           void* out, void* zcut, int n_tiles, int tw, int th,
                           int chunk, void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk || chunk % 4 || dom % chunk ||
      (uintptr_t)table % 16 || tw < 1 || th < 1 ||
      tw * th > kTileWarps * 32 * kPix)
    return (int)cudaErrorInvalidValue;
  if (n_tiles > 0) {
    const Kernel kernel = pick(fast, zcut != nullptr, block_layout(tw, th));
    kernel<<<(unsigned)n_tiles * kCluster, kThreads, 0,
             (cudaStream_t)stream>>>(
        (const float*)table, dom, (const int*)range_start,
        (const int*)range_end, (const float*)depth, use_depth, (float*)out,
        (float*)zcut, tw, th, chunk);
  }
  return (int)cudaGetLastError();
}

// What the card makes of the variant for a tw x th tile: out[0] its
// registers a thread, out[1] its local memory a thread in bytes, out[2] its
// CTAs resident on an SM, out[3] its clusters resident on the card at once.
extern "C" int gswt_raster_occupancy(int fast, int zcut, int tw, int th,
                                     int* out) {
  const Kernel kernel = pick(fast, zcut != 0, block_layout(tw, th));
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, kernel);
  if (rc != cudaSuccess) return (int)rc;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                     kThreads, 0);
  if (rc != cudaSuccess) return (int)rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * 1024);
  cfg.blockDim = dim3(kThreads);
  return (int)cudaOccupancyMaxActiveClusters(&out[3], kernel, &cfg);
}
