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
// operations, 31 when split2) and its compare with the cutoff only where it
// can pass; one that passes the cutoff and the depth test needs the rest (13,
// FMAs counted twice; 2 more for kBf2's rounding) and one exp on the SFU. A
// pair-pixel that fails has g = 0 and changes nothing, so the least work is
// that of the kept pair-pixels (about 6% at the script's shape), beside the
// 11 table rows of the composited pairs, the depth and the output moved once.
//
// Design: the production compositor's (raster.cu), adapted to this kernel.
// - Layout. One CTA per image tile, 1024 threads (32 warps), each owning 2
//   pixels whose Tc, Tl and four sums stay in registers for the whole run,
//   beside their monomials (and split2's hi and lo parts of them). Each warp
//   owns one block of the tile: 16x4 pixels when ceil(tw/16) * ceil(th/4)
//   <= 32 (64x32 tiles: 4 x 8 blocks; lane l owns column l % 16 and rows
//   l / 16 + 2i, i < 2), else the flat layout (warp w owns pixels 64w ..
//   64w + 63 of the row-major tile, lane l pixels 64w + l + 32i), as
//   ops/raster.py warp_layout. The block is the rectangle of its pixel
//   centres, in global coordinates unless kLocal.
// - Pair-block mask, in f64. Once a chunk is staged, a 32-bit mask of the
//   warp blocks each pair can reach: the max of the exact quadratic of its
//   f32 coefficients over the block's rectangle (the peak less the min of a
//   positive definite quadratic over the rectangle shifted to the centre,
//   as raster.cu), tested against CUTOFF - 1 - rel S. S bounds the sum of
//   the magnitudes of the terms the variant sums (s5 + |k5| at the block's
//   far corner, where every monomial peaks, plus the terms of the f64
//   peak); the margin bounds how far the VARIANT'S OWN evaluation can fall
//   from the exact quadratic, which differs by precision. With u = 2^-24
//   (f32) and b = 2^-8 (bf16: 8 significant bits, round to nearest, so
//   |bf16(x) - x| <= b |x|); the monomials are exact in f32 for pixel
//   coordinates below 2048 (quarter-integers below 2^22; beyond, their
//   rounding adds u S, which every margin below covers):
//   * highest (A, B, C2): six f32 products and five adds of partial sums
//     bounded by S: |error| <= 6 u S (1 + 6u) < 2^-21.4 S. rel = 2^-20, the
//     compositor's, with 2.7x room.
//   * default (D): each k_i and f_i rounded to bf16 once, their product
//     exact in f32: k_i f_i (1 + d)(1 + d') off by (2b + b^2) |k_i f_i|,
//     k5 by b |k5|, the f32 sum by 6 u (1 + 2b) S. Together <= (2^-7 +
//     2^-16 + 2^-21.3) S: the first-order term alone is 2^-7 S, so rel =
//     2^-6, about twice the bound. D's exponent can come out positive where the
//     exact quadratic is not; the f32 margin (2^-20) misses kept pixels on
//     the adversarial tables (tests/test_torch_micro_design.py).
//   * split2 (C): with x = hi + lo + r, |lo| <= b (1 + b) |x| and |r| =
//     |(x - hi) - bf16(x - hi)| <= b^2 |x| (x - hi is exact in f32), the
//     dropped terms are lo_k lo_f, hi_k r_f, r_k hi_f (each <= b^2 (1 +
//     b)^2 |k_i f_i|) and smaller ones of order b^3, and r of k5: together
//     <= 3.1 * 2^-16 S. The three products of bf16 values are exact; the
//     f32 sums of S(hi, hi) and of the two cross sums (each <= 1.01 b S)
//     and the last add round by < 2^-21 S. rel = 2^-13 (8 * 2^-16), 2.5x
//     the bound.
//   The plain form (benchmarks/micro_raster.py MASK_REL, through
//   ops/raster.py pair_block_mask) uses the same constants and the same
//   f64 operations in the same order. A quadratic that is not negative
//   definite keeps every block its trivial bound (k5 + the sum of |k_i|
//   times the block's largest monomials) reaches; a dead pair (k5 = -1e30)
//   keeps none; a block whose largest depth is <= z is left out. A block is
//   thus skipped only where the variant's own e < CUTOFF at every pixel (or
//   z < depth fails): a skipped pair-pixel had g = 0, w = 0 and Tl *= 1, so
//   the output, both T's and the early exit are bit for bit those of a
//   kernel that walks every pair-pixel.
//   Three steps per chunk, because the f64 pipe and its latency, not the
//   issue slots, are what the mask spends (benchmarks/micro_raster_ab.py
//   times each): (1) one thread per pair computes its set-up (centre, peak,
//   b / a, b / c) and a box, the bounding box of the ellipse on which e
//   reaches the tile's lowest limit (its far corner's), into shared memory;
//   (2) four threads per pair test their blocks against the box (and the
//   depth) and append the candidates, (pair, block), to a list in shared
//   memory, warp by warp; (3) every thread takes list entries and runs the
//   exact test, OR-ing the mask word. The box keeps about 17% of the (pair,
//   block) visits at the script's shape, the exact test about 12%; on the
//   list the exact test costs what the candidates need, where four threads
//   looping over their own blocks would each wait for the busiest lane (the
//   set-up thread testing all 32 blocks itself was measured slower).
// - Warp-uniform skip. A warp walks only the pairs whose bit it owns (a
//   ballot over 32 mask words, then their set bits in order). Inside a pair
//   every lane evaluates e for its 2 pixels in the variant's precision
//   (explicitly rounded multiplies and adds in the plain version's order);
//   the exp and the accumulate run only when __any_sync finds a kept pixel,
//   then for both pixels (g = 0 where not kept), in the order w = (g Tl) Tc.
// - Staging ring. The whole aligned chunk [c0, c0 + chunk) of the 11 rows
//   read (k0..k5, z, r, g, b, alpha) is staged into a 2-stage ring in shared
//   memory by cp.async.bulk (one 1-D copy per row, completion on an
//   mbarrier), issued by one thread; columns outside the run are masked. The
//   next chunk loads while this one composites. In the mask's first step
//   the threads that compute no set-up pack each pair as the walk reads it,
//   into three float4s (k or its bf16 hi part, z, alpha, the colours, bf16
//   for kBf2) and, for split2, two more of the lo parts: three 16-B shared
//   loads per pair where the walk read eleven words. The wrapper takes only
//   what it can stage: chunk a multiple of 4, dom a multiple of chunk, the
//   table 16-B aligned.
// - Registers. 1024 threads leave 64 registers each; every instantiation
//   spills some (48-104 B of stack, in the mask's f64 steps, not in the
//   walk), which kernels.build_all's -Xptxas -v report shows and
//   chip_smoke.py prints. Walking two pairs at a time for more independent
//   work per warp was measured no faster (PERF.md).

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
// threads per pair in the mask's candidate step, each for every kParts-th
// block
constexpr int kParts = kThreads / kMaxChunk;
constexpr int kPairVals = 6;        // uc, vc, ec, mc, b / a, b / c
// dynamic shared memory: the pairs' set-up and box, the candidate list (at
// most every (pair, block) of a chunk, (j << 5) | w each)
constexpr int kDynSmem =
    (int)(sizeof(double) * (kPairVals + 4) * kMaxChunk) +
    2 * kMaxChunk * kWarps;
constexpr int kStages = 2;
constexpr float kCutoff = -4.0f;
constexpr float kMinT = 0.5f / 255.0f;
constexpr int kFeat = 5;            // x^2, xy, y^2, x, y (the sixth is 1)
constexpr int kRows = 11;           // k0..k5, z, r, g, b, alpha
constexpr int kZRow = 6, kColRow = 7, kAlphaRow = 10;
// the mask's limit: CUTOFF - kMaskMargin - mask_rel<kPrec>() * S
constexpr double kMaskMargin = 1.0;
constexpr unsigned kFull = 0xffffffffu;

template <int kPrec>
__device__ __forceinline__ constexpr double mask_rel() {
  return kPrec == 0   ? 9.5367431640625e-07  // 2^-20, highest
         : kPrec == 1 ? 1.220703125e-04      // 2^-13, split2
                      : 1.5625e-02;          // 2^-6, default
}

// staged row r -> table row: k0..k5, z, then r, g, b, alpha past row 7
__device__ __forceinline__ int table_row(int r) { return r < 7 ? r : r + 1; }

// sum_i k[i] * f[i] over n terms, left to right, each operation rounded
template <int n>
__device__ __forceinline__ float dot_rn(const float* k, const float* f) {
  float e = __fmul_rn(k[0], f[0]);
#pragma unroll
  for (int i = 1; i < n; ++i) e = __fadd_rn(e, __fmul_rn(k[i], f[i]));
  return e;
}

// pixel i of lane `lane` in warp `warp` (ops/raster.py warp_layout)
__device__ __forceinline__ void pixel_xy(bool block, int warp, int lane,
                                         int i, int tw, int& x, int& y) {
  if (block) {
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

// s5, the sum of |k_i| times the largest monomials of a rectangle whose far
// corner is (u1, v1), and the mask's limit there (ops/raster.py mask_limit)
template <int kPrec>
__device__ __forceinline__ double mask_limit(double k0, double k1, double k2,
                                             double k3, double k4, double k5,
                                             double mc, double u1, double v1,
                                             double& s5) {
  s5 = dadd(dadd(dadd(dadd(
      dmul(fabs(k0), dmul(u1, u1)), dmul(fabs(k1), dmul(u1, v1))),
      dmul(fabs(k2), dmul(v1, v1))), dmul(fabs(k3), u1)),
      dmul(fabs(k4), v1));
  return dadd((double)kCutoff,
              -dadd(kMaskMargin,
                    dmul(mask_rel<kPrec>(), dadd(dadd(s5, fabs(k5)), mc))));
}

// The mask of a chunk's pairs takes three steps, so that the costly exact
// test runs only on the (pair, block) candidates that the cheap tests leave,
// spread over every thread, and the f64 set-up runs once per pair (the f64
// and conversion pipes, not the issue slots, are what the mask spends).
//
// Step 1, one thread per pair: the set-up (the centre, the peak ec, the
// magnitude mc of its terms, b / a and b / c: ops/raster.py pair_peak's
// operations) into pv, and into box the box around the ellipse on which e
// reaches the tile's lowest limit (its far corner's, (u1t, v1t)), the box's
// radius widened by 2^-30 and 1 against the f64 rounding; the box is empty
// where the peak is below that limit and unbounded where the quadratic is
// not definite.
template <int kPrec>
__device__ void pair_setup(const float (*tab)[kMaxChunk], int j, double u1t,
                           double v1t, double (*pv)[kMaxChunk],
                           double (*box)[kMaxChunk]) {
  const double k0 = tab[0][j], k1 = tab[1][j], k2 = tab[2][j],
               k3 = tab[3][j], k4 = tab[4][j], k5 = tab[5][j];
  const double a = -k0, b = -0.5 * k1, c = -k2;
  const double det = dadd(dmul(a, c), -dmul(b, b));
  double uc = 0.0, vc = 0.0, ec = 0.0, mc = 0.0, rba = 0.0, rbc = 0.0;
  double xl = -INFINITY, xr = INFINITY, yl = -INFINITY, yr = INFINITY;
  if (a > 0.0 && det > 0.0) {
    const double half_inv = 0.5 / det;
    uc = dmul(dadd(dmul(c, k3), -dmul(b, k4)), half_inv);
    vc = dmul(dadd(dmul(a, k4), -dmul(b, k3)), half_inv);
    const double tu = dmul(k3, uc), tv = dmul(k4, vc);
    ec = dadd(k5, dmul(0.5, dadd(tu, tv)));
    mc = dadd(fabs(tu), fabs(tv));
    rba = b / a;
    rbc = b / c;
    double s5t;
    const double r =
        dadd(ec, -mask_limit<kPrec>(k0, k1, k2, k3, k4, k5, mc, u1t, v1t,
                                    s5t));
    if (r > 0.0) {
      const double rp = dadd(dmul(r, 1.0 + 0x1p-30), 1.0);
      const double inv = dmul(2.0, half_inv);
      const double hx = __dsqrt_rn(dmul(dmul(rp, c), inv));
      const double hy = __dsqrt_rn(dmul(dmul(rp, a), inv));
      xl = dadd(uc, -hx);
      xr = dadd(uc, hx);
      yl = dadd(vc, -hy);
      yr = dadd(vc, hy);
    } else {
      xl = yl = INFINITY;
      xr = yr = -INFINITY;
    }
  }
  pv[0][j] = uc;
  pv[1][j] = vc;
  pv[2][j] = ec;
  pv[3][j] = mc;
  pv[4][j] = rba;
  pv[5][j] = rbc;
  box[0][j] = xl;
  box[1][j] = xr;
  box[2][j] = yl;
  box[3][j] = yr;
}

// Step 2, kParts threads per pair: the candidates among the blocks w =
// part, part + kParts, ...: blocks with pixels, not all behind the depth,
// meeting the pair's box. rect: the blocks' rectangles in f64.
__device__ __forceinline__ unsigned pair_candidates(
    const float (*tab)[kMaxChunk], int j, int part, const double (*rect)[4],
    const float* dmax, const double (*box)[kMaxChunk]) {
  const float z = tab[kZRow][j];
  const double xl = box[0][j], xr = box[1][j], yl = box[2][j],
               yr = box[3][j];
  unsigned cand = 0;
#pragma unroll
  for (int w = part; w < kWarps; w += kParts) {
    const double u0 = rect[w][0], u1 = rect[w][1];
    const double v0 = rect[w][2], v1 = rect[w][3];
    if (u0 > u1) continue;                  // no pixels
    if (!(z < dmax[w])) continue;           // all behind the depth
    if (!(u0 <= xr && u1 >= xl && v0 <= yr && v1 >= yl)) continue;  // box
    cand |= 1u << w;
  }
  return cand;
}

// Step 3, one thread per candidate: false only where no pixel centre of the
// block `rc` can give e >= CUTOFF in the variant's own evaluation (the exact
// max of the quadratic over the block against the block's own limit, as
// raster.cu; a quadratic that is not negative definite, only its trivial
// bound k5 + s5)
template <int kPrec>
__device__ bool block_reaches(const float (*tab)[kMaxChunk], int j,
                              const double (*pv)[kMaxChunk],
                              const double* rc) {
  const double k0 = tab[0][j], k1 = tab[1][j], k2 = tab[2][j],
               k3 = tab[3][j], k4 = tab[4][j], k5 = tab[5][j];
  const double a = -k0, b = -0.5 * k1, c = -k2;
  const double det = dadd(dmul(a, c), -dmul(b, b));
  const double u0 = rc[0], u1 = rc[1], v0 = rc[2], v1 = rc[3];
  const double mc = pv[3][j];
  double s5;
  const double lim =
      mask_limit<kPrec>(k0, k1, k2, k3, k4, k5, mc, u1, v1, s5);
  if (dadd(k5, s5) < lim) return false;     // trivially below
  if (!(a > 0.0 && det > 0.0)) return true;
  const double uc = pv[0][j], vc = pv[1][j];
  const double rmin = rect_min_q(a, b, c, pv[4][j], pv[5][j], dadd(u0, -uc),
                                 dadd(u1, -uc), dadd(v0, -vc),
                                 dadd(v1, -vc));
  return !(dadd(pv[2][j], -rmin) < lim);
}

// ---- the walk: one pair's exponents at this thread's pixels, then its
// composite ----

// e at this thread's pixels in the variant's precision (explicitly rounded
// multiplies and adds in the plain version's order); returns the pixels that
// pass the cutoff and z < depth
template <int kPrec>
__device__ __forceinline__ unsigned pair_exponents(
    const float4 (*pk)[kMaxChunk], const float4 (*pkl)[kMaxChunk], int j,
    const float (*f)[kFeat], const float (*fl)[kFeat], const float* d,
    unsigned valid, float* e) {
  const float4 p0 = pk[0][j], p1 = pk[1][j];
  const float kc[6] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y};
  const float z = p1.z;
  float kl[kPrec == 1 ? 6 : 1];
  if constexpr (kPrec == 1) {
    const float4 l0 = pkl[0][j], l1 = pkl[1][j];
    kl[0] = l0.x;
    kl[1] = l0.y;
    kl[2] = l0.z;
    kl[3] = l0.w;
    kl[4] = l1.x;
    kl[5] = l1.y;
  }
  unsigned keep = 0;
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    // the sixth monomial is 1: its hi is 1 and its lo is 0
    float x = __fadd_rn(dot_rn<kFeat>(kc, f[i]), kc[5]);
    if constexpr (kPrec == 1) {
      const float hl = dot_rn<kFeat>(kc, fl[i]);
      const float lh = __fadd_rn(dot_rn<kFeat>(kl, f[i]), kl[5]);
      x = __fadd_rn(x, __fadd_rn(hl, lh));
    }
    e[i] = x;
    if (((valid >> i) & 1u) && x >= kCutoff && z < d[i]) keep |= 1u << i;
  }
  return keep;
}

// g = exp(e) alpha where kept (0 elsewhere: w = 0 and Tl *= 1), w = (g Tl)
// Tc, the four sums and Tl, from the un-rounded g in every variant
template <bool kBf2>
__device__ __forceinline__ void pair_composite(
    const float4 (*pk)[kMaxChunk], int j, const float* e, unsigned keep,
    const float* Tc, float* Tl, float* ar, float* ag, float* ab, float* aa) {
  const float alpha = pk[1][j].w;
  const float4 col = pk[2][j];
  const float cr = col.x, cg = col.y, cb = col.z;
  float ex[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) ex[i] = expf(e[i]);  // both, unbranched
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const float g = (keep >> i) & 1u ? __fmul_rn(ex[i], alpha) : 0.0f;
    float w = __fmul_rn(__fmul_rn(g, Tl[i]), Tc[i]);
    if constexpr (kBf2) w = round_bf16(w);
    ar[i] = fmaf(cr, w, ar[i]);
    ag[i] = fmaf(cg, w, ag[i]);
    ab[i] = fmaf(cb, w, ab[i]);
    aa[i] += w;
    Tl[i] *= 1.0f - g;
  }
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

// stage the chunk at column c0 of the kRows table rows into s
__device__ __forceinline__ void stage_chunk(float (*s)[kMaxChunk],
                                            uint64_t* bar,
                                            const float* table, long long dom,
                                            long long c0, int chunk) {
  const uint32_t bytes = (uint32_t)chunk * 4u;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes * kRows)
      : "memory");
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(s[r])),
        "l"(table + table_row(r) * dom + c0), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
  }
}

template <bool kLocal, int kPrec, bool kBf2>
__global__ void __launch_bounds__(kThreads, 1)
micro_raster_kernel(const float* __restrict__ table, long long dom,
                    const int* __restrict__ range_start,
                    const int* __restrict__ range_end,
                    const float* __restrict__ depth, float* __restrict__ out,
                    int ntx, int tw, int th, int chunk, int block) {
  __shared__ __align__(128) float s_tab[kStages][kRows][kMaxChunk];
  // each pair as the walk reads it: (k0..k3), (k4, k5, z, alpha), (r, g, b)
  // with k (hi, bf16(k), when kPrec != 0) and the colours (bf16, when
  // kBf2) in the variant's form, and split2's lo parts, bf16(k - hi)
  __shared__ float4 s_pk[3][kMaxChunk];
  __shared__ float4 s_pkl[kPrec == 1 ? 2 : 1][kMaxChunk];
  __shared__ uint32_t s_mask[kMaxChunk];
  __shared__ int s_nitems[2];  // candidates in the list, by chunk parity
  __shared__ double s_rect[kWarps][4];
  __shared__ float s_dmax[kWarps];
  __shared__ float s_red[kWarps];
  __shared__ __align__(8) uint64_t s_bar[kStages];
  // dynamic: each pair's set-up and box, then the chunk's (pair, block)
  // candidates
  extern __shared__ __align__(16) unsigned char s_dyn[];
  double(*s_pv)[kMaxChunk] = reinterpret_cast<double(*)[kMaxChunk]>(s_dyn);
  double(*s_box)[kMaxChunk] = s_pv + kPairVals;
  uint16_t* s_items = reinterpret_cast<uint16_t*>(s_box + 4);

  const int tile = blockIdx.x;
  const int n_pix = tw * th;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long rs = range_start[tile];
  const long long re = range_end[tile];
  const float ox = kLocal ? 0.0f : (float)((tile % ntx) * tw);
  const float oy = kLocal ? 0.0f : (float)((tile / ntx) * th);
  // the tile's far corner: where the mask's limit is lowest
  const double u1t = ((float)(tw - 1) + 0.5f) + ox;
  const double v1t = ((float)(th - 1) + 0.5f) + oy;

  float f[kPix][kFeat];                       // monomials, or their hi
  float fl[kPrec == 1 ? kPix : 1][kFeat];     // their lo
  float d[kPix], Tc[kPix], Tl[kPix], ar[kPix], ag[kPix], ab[kPix], aa[kPix];
  unsigned valid = 0;
  float dm = -INFINITY;  // the largest depth of this thread's pixels
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    int px, py;
    pixel_xy(block, warp, lane, i, tw, px, py);
    const bool ok = px < tw && py < th;
    if (ok) valid |= 1u << i;
    // integer pixel index first, then the half: exact in f32 either way
    const float x = (ox + (float)px) + 0.5f;
    const float y = (oy + (float)py) + 0.5f;
    const float m[kFeat] = {__fmul_rn(x, x), __fmul_rn(x, y),
                            __fmul_rn(y, y), x, y};
#pragma unroll
    for (int c = 0; c < kFeat; ++c) {
      if constexpr (kPrec == 0) {
        f[i][c] = m[c];
      } else {
        f[i][c] = round_bf16(m[c]);
        if constexpr (kPrec == 1)
          fl[i][c] = round_bf16(__fsub_rn(m[c], f[i][c]));
      }
    }
    d[i] = ok ? depth[(long long)tile * n_pix + py * tw + px] : 1.0f;
    if (ok) dm = fmaxf(dm, d[i]);
    Tc[i] = Tl[i] = 1.0f;
    ar[i] = ag[i] = ab[i] = aa[i] = 0.0f;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    dm = fmaxf(dm, __shfl_xor_sync(kFull, dm, off));
  if (lane == 0) {
    // the warp block: the rectangle of its pixel centres (u0 > u1: none)
    int x0, x1, y0, y1;
    if (block) {
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
    // f32 sums as the plain form's (exact: quarter-integers below 2^24)
    s_rect[warp][0] = (none ? 1.0f : (float)x0 + 0.5f) + ox;
    s_rect[warp][1] = (none ? 0.0f : (float)x1 + 0.5f) + ox;
    s_rect[warp][2] = ((float)y0 + 0.5f) + oy;
    s_rect[warp][3] = ((float)y1 + 0.5f) + oy;
    s_dmax[warp] = dm;
  }
  if (threadIdx.x == 0) {
    s_nitems[0] = s_nitems[1] = 0;
    for (int s = 0; s < kStages; ++s) bar_init(&s_bar[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (rs < re) {
    const long long first = (rs / chunk) * chunk;
    if (threadIdx.x == 0)
      stage_chunk(s_tab[0], &s_bar[0], table, dom, first, chunk);
    int k = 0;
    bool drained = true;
    for (long long c0 = first; c0 < re; c0 += chunk, ++k) {
      const int st = k & 1;
      if (k > 0) {
        // a chunk ended: fold its transmittance into the carried one, then
        // the early exit on the block-wide max of Tc
        float m = 0.0f;
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          Tc[i] *= Tl[i];
          Tl[i] = 1.0f;
          if (valid & (1u << i)) m = fmaxf(m, Tc[i]);
        }
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
        stage_chunk(s_tab[st ^ 1], &s_bar[st ^ 1], table, dom, c0 + chunk,
                    chunk);
      bar_wait(&s_bar[st], (k >> 1) & 1);
      const float(*tab)[kMaxChunk] = s_tab[st];

      // the pair-block masks of the in-run columns: the set-up, one thread
      // per pair
      const int j_lo = (int)((rs > c0 ? rs : c0) - c0);
      const int j_hi = (int)((re < c0 + chunk ? re : c0 + chunk) - c0);
      if (threadIdx.x < chunk) {
        s_mask[threadIdx.x] = 0u;
        if (threadIdx.x >= j_lo && threadIdx.x < j_hi)
          pair_setup<kPrec>(tab, threadIdx.x, u1t, v1t, s_pv, s_box);
      }
      // each pair as the walk reads it, packed, once per pair, by the
      // threads that take no part in the set-up
      if (threadIdx.x >= kMaxChunk && threadIdx.x < kMaxChunk + chunk) {
        const int j = threadIdx.x - kMaxChunk;
        float k[6], lo[6];
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          k[c] = tab[c][j];
          if constexpr (kPrec != 0) {
            const float h = round_bf16(k[c]);
            lo[c] = round_bf16(__fsub_rn(k[c], h));
            k[c] = h;
          }
        }
        float col[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          col[c] = tab[kColRow + c][j];
          if constexpr (kBf2) col[c] = round_bf16(col[c]);
        }
        s_pk[0][j] = make_float4(k[0], k[1], k[2], k[3]);
        s_pk[1][j] = make_float4(k[4], k[5], tab[kZRow][j], tab[kAlphaRow][j]);
        s_pk[2][j] = make_float4(col[0], col[1], col[2], 0.0f);
        if constexpr (kPrec == 1) {
          s_pkl[0][j] = make_float4(lo[0], lo[1], lo[2], lo[3]);
          s_pkl[1][j] = make_float4(lo[4], lo[5], 0.0f, 0.0f);
        }
      }
      __syncthreads();
      // the candidates, appended to the chunk's list warp by warp
      {
        const int j = threadIdx.x / kParts, part = threadIdx.x % kParts;
        unsigned cand = 0;
        if (j >= j_lo && j < j_hi)
          cand = pair_candidates(tab, j, part, s_rect, s_dmax, s_box);
        const int n = __popc(cand);
        int incl = n;  // inclusive prefix sum of n over the warp's lanes
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int y = __shfl_up_sync(kFull, incl, off);
          if (lane >= off) incl += y;
        }
        int base = 0;
        if (lane == 31 && incl > 0) base = atomicAdd(&s_nitems[st], incl);
        base = __shfl_sync(kFull, base, 31) + incl - n;
        while (cand) {
          const int w = __ffs(cand) - 1;
          cand &= cand - 1;
          s_items[base++] = (uint16_t)((j << 5) | w);
        }
      }
      __syncthreads();
      // the exact test on the chunk's candidates, over every thread
      {
        const int n_items = s_nitems[st];
        if (threadIdx.x == 0) s_nitems[st ^ 1] = 0;  // the next chunk's list
        for (int i = threadIdx.x; i < n_items; i += kThreads) {
          const int j = s_items[i] >> 5, w = s_items[i] & 31;
          if (block_reaches<kPrec>(tab, j, s_pv, s_rect[w]))
            atomicOr(&s_mask[j], 1u << w);
        }
      }
      __syncthreads();

      // this warp's pairs, in order
      for (int j0 = j_lo & ~31; j0 < j_hi; j0 += 32) {
        const int jl = j0 + lane;
        unsigned todo = __ballot_sync(
            kFull, jl < j_hi && ((s_mask[jl] >> warp) & 1u));
        while (todo) {
          const int j = j0 + __ffs(todo) - 1;
          todo &= todo - 1;
          float e[kPix];
          const unsigned keep =
              pair_exponents<kPrec>(s_pk, s_pkl, j, f, fl, d, valid, e);
          if (__any_sync(kFull, keep))  // uniform over the warp
            pair_composite<kBf2>(s_pk, j, e, keep, Tc, Tl, ar, ag, ab, aa);
        }
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
      int px, py;
      pixel_xy(block, warp, lane, i, tw, px, py);
      const int p = py * tw + px;
      o[p] = ar[i];
      o[n_pix + p] = ag[i];
      o[2 * n_pix + p] = ab[i];
      o[3 * n_pix + p] = aa[i];
    }
  }
}

using Kernel = void (*)(const float*, long long, const int*, const int*,
                       const float*, float*, int, int, int, int, int);

template <bool kLocal, int kPrec>
Kernel pick_bf2(int bf2) {
  return bf2 ? micro_raster_kernel<kLocal, kPrec, true>
             : micro_raster_kernel<kLocal, kPrec, false>;
}

template <bool kLocal>
Kernel pick_prec(int prec, int bf2) {
  return prec == 0 ? pick_bf2<kLocal, 0>(bf2)
         : prec == 1 ? pick_bf2<kLocal, 1>(bf2)
                     : pick_bf2<kLocal, 2>(bf2);
}

}  // namespace

// local: 0 global pixel monomials, 1 tile-local (k3, k4, k5 recentred by the
// caller). prec: 0 highest, 1 split2, 2 default. bf2: colours and weights
// rounded to bf16. depth [n_tiles, tw*th]; out [n_tiles, 4, tw*th]. The
// table must be 16-B aligned with dom a multiple of chunk and chunk a
// multiple of 4 (the staging copies move whole 16-B aligned row segments).
extern "C" int gswt_micro_raster(const void* table, long long dom,
                                 const void* range_start,
                                 const void* range_end, const void* depth,
                                 void* out, int n_tiles, int ntx, int tw,
                                 int th, int chunk, int local, int prec,
                                 int bf2, void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk || chunk % 4 || dom % chunk ||
      (uintptr_t)table % 16 || tw < 1 || th < 1 ||
      tw * th > kThreads * kPix || prec < 0 || prec > 2 || ntx < 1)
    return (int)cudaErrorInvalidValue;
  if (n_tiles > 0) {
    const int block =
        ((tw + kBlockW - 1) / kBlockW) * ((th + kBlockH - 1) / kBlockH) <=
        kWarps;
    const Kernel kernel = local ? pick_prec<true>(prec, bf2)
                                : pick_prec<false>(prec, bf2);
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDynSmem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<n_tiles, kThreads, kDynSmem, (cudaStream_t)stream>>>(
        (const float*)table, dom, (const int*)range_start,
        (const int*)range_end, (const float*)depth, (float*)out, ntx, tw, th,
        chunk, block);
  }
  return (int)cudaGetLastError();
}
