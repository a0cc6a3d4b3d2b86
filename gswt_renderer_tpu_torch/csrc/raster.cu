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
// pays instead is the longest run: a tile is one CTA that walks its run in
// order, and on the bench frame the tile with the longest run (32K pairs,
// none saturating under the proxy depth) alone takes nearly the whole
// kernel time, on one SM, while the others idle.
//
// Design: one CTA per image tile, 1024 threads (32 warps, the most a CTA
// may have), each owning 2 pixels whose T and colour sums stay in registers
// for the whole run: the more warps a tile has, the more of its one SM's
// issue slots the longest run can fill, and the smaller each warp's block,
// the more pairs it can skip (PERF.md has the layouts tried and their
// times).
// - Warp blocks. Each warp owns one compact block of the tile: 16x4 pixels
//   when ceil(tw/16) * ceil(th/4) <= 32 (64x32 tiles: 4 x 8 blocks; lane l
//   owns column l % 16 and rows l / 16 + 2i, i < 2), else the flat layout
//   (warp w owns pixels 64w .. 64w + 63 of the row-major tile, lane l
//   pixels 64w + l + 32i). The block is the rectangle of its pixel centres
//   (rows spanned, and the columns spanned when they lie in one row).
// - Pair-block mask. Once a chunk is staged, four threads per pair compute
//   a 32-bit mask of the warp blocks the pair can reach: the max of its
//   exponent over the block's rectangle, the max of a concave quadratic over
//   a rectangle (the shape of ops/binning.py _rect_min_q), from the centre
//   and peak recovered in f64 (products of f32 values are exact in f64, so
//   only the last subtraction and the division round), tested against
//   CUTOFF - 1 - 2^-20 S, where S bounds the magnitude of the terms the
//   kernel's f32 evaluation sums (its rounding is below 6 * 2^-24 S). A
//   pair whose quadratic is not negative definite gets every block whose
//   trivial bound (k5 + the sum of |k_i| times the block's largest
//   monomials) reaches the limit; a dead pair (k5 = -1e30) gets none. With
//   use_depth, a block whose largest depth is <= z is left out too: no pixel
//   of it passes z < depth.
// - Warp-uniform skip. A warp walks only the pairs whose bit it owns (a
//   ballot over 32 mask words, then their set bits in order). Inside a pair
//   every lane evaluates e for its 2 pixels exactly as before (explicitly
//   rounded multiplies and adds in the plain version's order); the exp and
//   the accumulate run only when __any_sync says a lane keeps a pixel, and
//   then for both pixels at once (g = 0 where not kept), which keeps their
//   exps independent. A skipped pair-pixel had g = 0, so w = 0 and T *= 1:
//   the output, T, the early exit and the saturation record are bit for bit
//   those of a kernel that walks every pair-pixel.
// - Staging ring. The whole aligned chunk [c0, c0 + chunk) is staged (dom
//   is a multiple of chunk, so every row segment is 16-B aligned) into a
//   2-stage ring in shared memory by cp.async.bulk (one 1-D TMA copy per
//   row, completion on an mbarrier), issued by one thread; columns outside
//   the run are masked. The next chunk loads while this one composites.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "torch_semantics.cuh"

namespace {

constexpr int kThreads = 1024;      // the most a CTA may have
constexpr int kWarps = kThreads / 32;
constexpr int kPix = 2;             // pixels per thread: tiles up to 2048 px
constexpr int kBlockW = 16;         // warp block: 16 columns x 2 * kPix rows
constexpr int kBlockH = 2 * kPix;
constexpr int kMaxChunk = 256;
// threads per pair computing its mask, each for kWarps / kParts blocks
constexpr int kParts = kThreads / kMaxChunk;
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

__device__ __forceinline__ int table_row(int r) { return r < 7 ? r : r + 1; }

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

// bit w set unless no pixel centre of warp block w (w0 <= w < w0 +
// kWarps / kParts) can give e >= CUTOFF in the kernel's f32 evaluation (or,
// with use_depth, pass z < depth)
__device__ unsigned pair_block_mask(const float (*tab)[kMaxChunk], int j,
                                    int w0, int use_depth,
                                    const float (*rect)[4],
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
#pragma unroll 1
  for (int w = w0; w < w0 + kWarps / kParts; ++w) {
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

// ---- the staging ring: 1-D bulk copies completing on an mbarrier ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
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
template <int kStaged>
__device__ __forceinline__ void stage_chunk(float (*s)[kMaxChunk],
                                            uint64_t* bar,
                                            const float* table, long long dom,
                                            long long c0, int chunk) {
  const uint32_t bytes = (uint32_t)chunk * 4u;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes * kStaged)
      : "memory");
#pragma unroll
  for (int r = 0; r < kStaged; ++r) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(s[r])),
        "l"(table + table_row(r) * dom + c0), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
  }
}

template <bool kFast, bool kZcut, bool kBlock>
__global__ void __launch_bounds__(kThreads, 1)
raster_kernel(const float* __restrict__ table, long long dom,
              const int* __restrict__ range_start,
              const int* __restrict__ range_end,
              const float* __restrict__ depth, int use_depth,
              float* __restrict__ out, float* __restrict__ zcut,
              int tw, int th, int chunk) {
  constexpr int kStaged = kZcut ? kRows + 1 : kRows;
  __shared__ __align__(128) float s_tab[kStages][kStaged][kMaxChunk];
  __shared__ uint32_t s_mask[kMaxChunk];
  __shared__ float s_rect[kWarps][4];
  __shared__ float s_dmax[kWarps];
  __shared__ float s_red[kWarps];
  __shared__ float s_smax[kWarps];
  __shared__ int s_band[kBands];
  __shared__ __align__(8) uint64_t s_bar[kStages];

  const int tile = blockIdx.x;
  const int n_pix = tw * th;
  const int warp = threadIdx.x >> 5;
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
    s_rect[warp][0] = none ? 1.0f : (float)x0 + 0.5f;
    s_rect[warp][1] = none ? 0.0f : (float)x1 + 0.5f;
    s_rect[warp][2] = (float)y0 + 0.5f;
    s_rect[warp][3] = (float)y1 + 0.5f;
    s_dmax[warp] = dm;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) bar_init(&s_bar[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (rs < re) {
    const long long first = (rs / chunk) * chunk;
    if (threadIdx.x == 0)
      stage_chunk<kStaged>(s_tab[0], &s_bar[0], table, dom, first, chunk);
    int k = 0;
    bool drained = true;
    for (long long c0 = first; c0 < re; c0 += chunk, ++k) {
      const int st = k & 1;
      if (k > 0) {
        // early exit at a chunk boundary: block-wide max of T
        float m = 0.0f;
#pragma unroll
        for (int i = 0; i < kPix; ++i)
          if (valid & (1u << i)) m = fmaxf(m, T[i]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
        __syncthreads();  // every thread is done with the last chunk
        if (lane == 0) s_red[warp] = m;
        __syncthreads();
        m = s_red[0];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) m = fmaxf(m, s_red[w]);
        if (m < kMinT) {
          drained = false;  // chunk k is in flight
          break;
        }
      }
      // the next chunk into the other stage, last read before the barrier
      // above, while this one composites
      if (threadIdx.x == 0 && c0 + chunk < re)
        stage_chunk<kStaged>(s_tab[st ^ 1], &s_bar[st ^ 1], table, dom,
                             c0 + chunk, chunk);
      bar_wait(&s_bar[st], (k >> 1) & 1);
      const float(*tab)[kMaxChunk] = s_tab[st];

      // the pair-block masks of the in-run columns (and the chunk's max
      // slot over them): kParts neighbouring threads per pair, each
      // testing kWarps / kParts of the warp blocks
      const int j_lo = (int)((rs > c0 ? rs : c0) - c0);
      const int j_hi = (int)((re < c0 + chunk ? re : c0 + chunk) - c0);
      float smax = -1.0f;
      {
        const int j = threadIdx.x / kParts, part = threadIdx.x % kParts;
        unsigned m = 0;
        if (j >= j_lo && j < j_hi) {
          m = pair_block_mask(tab, j, part * (kWarps / kParts), use_depth,
                              s_rect, s_dmax);
          if constexpr (kZcut) smax = fmaxf(smax, tab[kSlotRow][j]);
        }
#pragma unroll
        for (int off = 1; off < kParts; off <<= 1)
          m |= __shfl_xor_sync(kFull, m, off);
        if (part == 0 && j < chunk) s_mask[j] = m;
      }
      if constexpr (kZcut) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          smax = fmaxf(smax, __shfl_xor_sync(kFull, smax, off));
        if (lane == 0) s_smax[warp] = smax;
      }
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

      // this warp's pairs, in order
      for (int j0 = j_lo & ~31; j0 < j_hi; j0 += 32) {
        const int jl = j0 + lane;
        unsigned todo = __ballot_sync(
            kFull, jl < j_hi && ((s_mask[jl] >> warp) & 1u));
        while (todo) {
          const int j = j0 + __ffs(todo) - 1;
          todo &= todo - 1;
          const float k0 = tab[0][j], k1 = tab[1][j], k2 = tab[2][j];
          const float k3 = tab[3][j], k4 = tab[4][j], k5 = tab[5][j];
          const float z = tab[6][j];
          float e[kPix];
          unsigned keep = 0;
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
            float x = __fmul_rn(k0, __fmul_rn(pu, pu));
            x = __fadd_rn(x, __fmul_rn(k1, __fmul_rn(pu, pv)));
            x = __fadd_rn(x, __fmul_rn(k2, __fmul_rn(pv, pv)));
            x = __fadd_rn(x, __fmul_rn(k3, pu));
            x = __fadd_rn(x, __fmul_rn(k4, pv));
            e[i] = __fadd_rn(x, k5);
            if (e[i] >= kCutoff && (!use_depth || z < d[i])) keep |= 1u << i;
          }
          if (!__any_sync(kFull, keep)) continue;  // uniform over the warp
          const float la = tab[10][j];
          float cr = tab[7][j], cg = tab[8][j], cb = tab[9][j];
          if constexpr (kFast) {
            cr = round_bf16(cr);
            cg = round_bf16(cg);
            cb = round_bf16(cb);
          }
#pragma unroll
          for (int i = 0; i < kPix; ++i) {
            const float g = (keep >> i) & 1u ? expf(__fadd_rn(e[i], la)) : 0.0f;
            float w = g * T[i];
            if constexpr (kFast) w = round_bf16(w);
            ar[i] = fmaf(cr, w, ar[i]);
            ag[i] = fmaf(cg, w, ag[i]);
            ab[i] = fmaf(cb, w, ab[i]);
            aa[i] += w;
            T[i] *= 1.0f - g;  // from the un-rounded g in every variant
          }
        }
      }
      if constexpr (kZcut) {
#pragma unroll
        for (int i = 0; i < kPix; ++i)
          if (vis & (1u << i)) rec[i] = fmaxf(rec[i], smax);
      }
    }
    // a chunk staged for a tile that stopped early must land before the
    // shared memory it writes goes away
    if (!drained) bar_wait(&s_bar[k & 1], (k >> 1) & 1);
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
    __syncthreads();
    if (threadIdx.x < kBands) s_band[threadIdx.x] = __float_as_int(-1.0f);
    __syncthreads();
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
    if (threadIdx.x < kBands)
      zcut[(long long)tile * kBands + threadIdx.x] =
          __int_as_float(s_band[threadIdx.x]);
  }
}

using Kernel = void (*)(const float*, long long, const int*, const int*,
                       const float*, int, float*, float*, int, int, int);

template <bool kFast, bool kZcut>
Kernel pick(bool block) {
  return block ? raster_kernel<kFast, kZcut, true>
               : raster_kernel<kFast, kZcut, false>;
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
      tw * th > kThreads * kPix)
    return (int)cudaErrorInvalidValue;
  if (n_tiles > 0) {
    const bool block =
        ((tw + kBlockW - 1) / kBlockW) * ((th + kBlockH - 1) / kBlockH) <=
        kWarps;
    const Kernel kernel = fast ? (zcut ? pick<true, true>(block)
                                       : pick<true, false>(block))
                               : (zcut ? pick<false, true>(block)
                                       : pick<false, false>(block));
    kernel<<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)table, dom, (const int*)range_start,
        (const int*)range_end, (const float*)depth, use_depth, (float*)out,
        (float*)zcut, tw, th, chunk);
  }
  return (int)cudaGetLastError();
}
