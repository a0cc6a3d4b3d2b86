// Tile binning of one frame's projected stream: the (image tile, splat)
// pairs of every splat's tile bbox, culled, in the joint (tile, stream slot)
// order, written straight into the compositor's pair table
// (ops/binning.py bin_pairs; bin_pairs_plain is the same function in
// PyTorch, the CPU path and this kernel's oracle).
//
// Replaces no Pallas kernel: the JAX package bins with XLA ops (a 64-bit
// stable sort by tile, gathers and a stack of the table). On the card it
// replaces the plain path's chain of about 250 ATen kernels, whose sort
// alone makes 8 radix passes over 64-bit keys that hold at most 16 bits.
//
// Bound: bytes. Each lane's 12 projected rows and its mask are read once
// (49 B), each kept pair's 13 table rows written once (52 B), and the dead
// code in rows 5 and 11 of every slot past the runs (8 B). At the dense
// cell's 4.19M lanes and ~10M kept pairs that is under 1 GB, ~0.3 ms at
// 3.35 TB/s. The arithmetic (a quantized payload per lane, a rectangle test
// per pair) stays under that line.
//
// Design: a stable counting sort by tile, in six launches on the caller's
// stream and no read on the host.
// 1. count (one thread a lane, 256 a block): the clipped tile bbox, the
//    on-screen and valid tests, the fast profile's quantized payload, the
//    lane-level occlusion and saturation culls; writes the lane's pair count
//    nx * ny and, for a live lane, one 48-byte record of its box and table
//    values, and per 256-lane block the pair and live-lane sums (the pair
//    sums are block_demand).
// 2. scan_blocks (one block): the first pair slot of every 256-lane block,
//    n_pairs, overflow, n_live.
// 3. hist: one warp per segment of 2048 pair slots walks the segment's pairs
//    in slot order (the lanes from the one holding its first slot, 32 at a
//    time: a warp scan of their counts, then 32 pairs per step, each thread
//    finding its lane by a binary search of the scan), so a warp's work is
//    the same wherever the large splats lie. Slots at or past the capacity
//    are never reached (the front-most pairs are kept, as the plain path's
//    enumeration keeps them). The walk applies the per-pair occlusion test
//    and the exact ellipse-tile cull and records each slot's tile (or that
//    it is dead) and lane. A block's four segments count their survivors per
//    tile in one shared-memory histogram: hist[tile][block].
// 4. scan_rows (one block a tile): each tile's row of hist scanned in place;
//    the last block to finish scans the tiles' totals into each tile's first
//    column, range_start / range_end, n_pairs_kept and max_run (the longest
//    tile run).
// 5. place: the same blocks over their recorded slots. Each warp counts its
//    segment's survivors per tile; the block lays its kept pairs out in
//    shared memory tile by tile, each tile's warps in order, and a kept
//    pair's lane goes to its tile's next position there (its rank among the
//    step's pairs of that tile from __match_any_sync). The block then
//    writes the lanes to lane_of, each tile's run of them to consecutive
//    columns from the tile's first column plus the block's offset in hist.
// 6. gather (one thread a slot, in order): a kept slot finds its tile by a
//    binary search of the tiles' first columns, reads its lane's record and
//    writes its column recentred to the tile's origin (build_pair_table);
//    a slot past n_pairs_kept writes the dead code (k5 = -1e30, ln a =
//    -inf), and zeros in the other rows 0-12 up to the end of the chunk
//    that holds n_pairs_kept, which a consumer staging whole chunks reads.
//    Rows 13-15 are never written: the compositor does not stage them.
// Shared memory bounds the tile grid: a place block of W warps holds
// 4 * n_tiles * (W + 1) bytes of counts and positions and 12 KB of staged
// lanes and tiles a warp. Walk blocks take 4 warps while that fits 64 KB,
// fewer above, one warp up to the device's opt-in limit (27,392 tiles on an
// H100: 6.7 times the 4K frame's 4,080 at 64x32), and at most 65,535 tiles
// (a slot's tile is 16 bits); past that the wrapper raises
// (gswt_binning_max_tiles).
//
// Specialisations: count<kFast> (the fast profile's quantize_payload and
// quantize_z, or the exact profile's values as they are). The occlusion and
// saturation culls, cull_exact and block_demand are runtime branches.
//
// Precision: float32 with IEEE sqrt and division, built with -fmad=false
// (ops/kernels.py) and written in the plain path's order of operations, so
// every cull decision, every table value but ln a (the library's logf) and
// so every run is bit-equal to the plain path on the card. A division by a
// Python number is done as PyTorch does it on the card, a multiply by the
// float reciprocal (divc); a Python constant is rounded to float from its
// double, as PyTorch rounds it.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "torch_semantics.cuh"

namespace {

constexpr int kBlock = 256;      // count: lanes per block, block_demand's grain
constexpr int kSegPairs = 2048;  // pair slots per warp segment of the walks
constexpr int kScan = 1024;      // threads of the one-block scans
constexpr int kRowScan = 256;    // threads of a tile's row scan
constexpr int kWalkWarps = 4;    // warps (segments) per walk block
constexpr int kSmemSoft = 64 * 1024;  // a place block's shared memory cap
constexpr int kSatK = 4;         // ops/binning.py _SAT_K
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDead = 0xffff;    // slot_tile of a culled pair

// the inputs, in this order
enum In { IN_CX, IN_CY, IN_EX, IN_EY, IN_QA, IN_QB, IN_QC, IN_Z, IN_R, IN_G,
          IN_B, IN_A, kIn };
// floats in a live lane's record, three float4: (cx, cy, qa, qb), (qc, z,
// box bits, ln a), (r, g, b, 0)
constexpr int kRec = 12;

}  // namespace

// Mirrored by ops/binning.py _BinArgs.
struct BinArgs {
  const float* in[kIn];        // [s] f32 each
  const unsigned char* valid;  // [s] bool
  const float* occ;            // [nty, ntx] f32, or null
  const float* sat;            // [n_br, ntx] f32, or null
  void* scratch;               // gswt_binning_scratch_bytes(s, n_tiles, cap) B
  float* table;                // [16, cap] f32
  int* range_start;            // [n_tiles] i32
  int* range_end;              // [n_tiles] i32
  long long* counts;           // [4] i64: n_pairs, n_pairs_kept, n_live,
                               // max_run
  unsigned char* overflow;     // 0-d bool
  long long* block_demand;     // [ceil(s / 256)] i64, or null
  long long s, cap;
  int img_w, img_h, tw, th, ntx, nty, n_tiles, n_br, bh_px, chunk;
  int cull_exact, fast;
};

namespace {

struct Scratch {
  int* cnt;             // [s] pair count nx * ny (0 for a culled lane)
  float4* rec;          // [s, 3] records (live lanes); box x0 | y0 << 8 |
                        // (nx - 1) << 16
  int* blk_cnt;         // [n_blk] pairs per 256-lane block
  int* blk_live;        // [n_blk] live lanes per block
  long long* blk_base;  // [n_blk] first pair slot of each block
  int* hist;            // [n_tiles, n_bseg] kept pairs per (tile, walk block)
  int* tile_base;       // [n_tiles] totals, then first table column
  unsigned short* slot_tile;  // [cap] each slot's tile, kDead if culled
  int* slot_lane;       // [cap] each slot's lane
  int* lane_of;         // [cap] the lane of each kept pair, in table order
  unsigned* ticket;     // scan_rows' blocks done
  // constants of the call
  float tw_end, th_end; // tw - 0.5 and th - 0.5, rounded from double
};

__host__ __device__ long long n_blocks_of(long long s) {
  return (s + kBlock - 1) / kBlock;
}

// shared memory of a place block of n_w warps: the tiles' starts, each
// warp's next positions and its segment's staged lanes and their tiles
size_t place_smem(int n_w, int n_tiles) {
  return (size_t)4 * n_tiles * (n_w + 1) + (size_t)6 * n_w * kSegPairs;
}

// warps per walk block: 4 while a place block's shared memory fits
// kSmemSoft, else as many as fit it, at least one
int place_warps(int n_tiles) {
  int w = kWalkWarps;
  while (w > 1 && place_smem(w, n_tiles) > (size_t)kSmemSoft) --w;
  return w;
}

// the walk blocks of a capacity (n_w warp segments each), rounded up to a
// multiple of 4 so that each tile's row of hist is 16-byte aligned (the
// extra blocks hold no slot)
long long n_bsegs_of(long long cap, int n_w) {
  const long long slots = 4LL * n_w * kSegPairs;
  return (cap + slots - 1) / slots * 4;
}

// carves `base` (null: only sizes); returns the bytes used
long long layout(char* base, long long s, int n_tiles, long long cap,
                 Scratch* sc) {
  long long off = 0;
  auto take = [&](long long bytes) {
    char* p = base ? base + off : nullptr;
    off += (bytes + 255) / 256 * 256;
    return p;
  };
  const long long nb = n_blocks_of(s);
  const long long ns = n_bsegs_of(cap, place_warps(n_tiles));
  sc->cnt = (int*)take(4 * s);
  sc->rec = (float4*)take(4 * kRec * s);
  sc->blk_cnt = (int*)take(4 * nb);
  sc->blk_live = (int*)take(4 * nb);
  sc->blk_base = (long long*)take(8 * nb);
  sc->hist = (int*)take(4 * (long long)n_tiles * ns);
  sc->tile_base = (int*)take(4 * (long long)n_tiles);
  sc->slot_tile = (unsigned short*)take(2 * cap);
  sc->slot_lane = (int*)take(4 * cap);
  sc->lane_of = (int*)take(4 * cap);
  sc->ticket = (unsigned*)take(4);
  return off;
}

// ------------------------------------------------------------------------
// PyTorch's elementwise semantics on the card beyond torch_semantics.cuh

// torch.maximum / torch.minimum: NaN wins
__device__ __forceinline__ float nanmax(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? b : a;
}

__device__ __forceinline__ float nanmin(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}

// quantize_payload's u8: nan_to_num, clamp to [0, 1], round to 1/255 steps
__device__ __forceinline__ float u8(float x) {
  if (x != x) x = 0.0f;
  else if (x == INFINITY) x = FLT_MAX;
  else if (x == -INFINITY) x = -FLT_MAX;
  return rintf(clampf(x, 0.0f, 1.0f) * 255.0f) * (float)(1.0 / 255.0);
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

template <typename T>
__device__ __forceinline__ T warp_incl_scan(T v) {
  const int lane = lane_id();
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// exclusive scan of one value per thread over the block (blockDim a
// multiple of 32); *total gets the block's sum. Every thread must call it.
template <typename T>
__device__ T block_excl_scan(T v, T* total) {
  __shared__ T warp_sum[32];
  const int lane = lane_id(), warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const T incl = warp_incl_scan(v);
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const T s = warp_incl_scan(lane < n_warps ? warp_sum[lane] : (T)0);
    warp_sum[lane] = s;
  }
  __syncthreads();
  const T prefix = warp ? warp_sum[warp - 1] : (T)0;
  *total = warp_sum[n_warps - 1];
  __syncthreads();
  return prefix + incl - v;
}

// ------------------------------------------------------------------------
// 1. count: one thread per lane (bin_pairs_plain up to count0)
template <bool kFast>
__global__ void __launch_bounds__(kBlock)
count_kernel(const BinArgs a, const Scratch sc) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  int c = 0, live = 0;
  if (i < a.s && a.valid[i]) {  // an invalid lane reads nothing more
    const float cx = a.in[IN_CX][i], cy = a.in[IN_CY][i];
    const float ex = a.in[IN_EX][i], ey = a.in[IN_EY][i];
    const float tw = (float)a.tw, th = (float)a.th;
    const float xm = (float)(a.ntx - 1), ym = (float)(a.nty - 1);
    const int x0 = (int)clampf(floorf(divc(cx - ex, tw)), 0.0f, xm);
    const int x1 = (int)clampf(floorf(divc(cx + ex, tw)), 0.0f, xm);
    const int y0 = (int)clampf(floorf(divc(cy - ey, th)), 0.0f, ym);
    const int y1 = (int)clampf(floorf(divc(cy + ey, th)), 0.0f, ym);
    bool ok = cx + ex >= 0.0f && cx - ex < (float)a.img_w &&
              cy + ey >= 0.0f && cy - ey < (float)a.img_h;
    float qa = a.in[IN_QA][i], qb = a.in[IN_QB][i], qc = a.in[IN_QC][i];
    float z = a.in[IN_Z][i];
    float r = a.in[IN_R][i], g = a.in[IN_G][i], b = a.in[IN_B][i];
    float al = a.in[IN_A][i];
    if (kFast) {
      // quantize_payload: bf16 Cholesky factors, u8 colours; quantize_z
      float l11 = sqrtf(clamp_min(qa, (float)1e-12));
      float l21 = qb / l11;
      float l22 = sqrtf(clamp_min(qc - l21 * l21, 0.0f));
      l11 = round_bf16(l11);
      l21 = round_bf16(l21);
      l22 = round_bf16(l22);
      qa = l11 * l11;
      qb = l11 * l21;
      qc = l21 * l21 + l22 * l22;
      r = u8(r);
      g = u8(g);
      b = u8(b);
      al = u8(al);
      z = floorf(clampf(z, 0.0f, 1.0f) * 65535.0f) * (float)(1.0 / 65535.0);
    }
    if (ok && a.occ != nullptr && x1 - x0 <= 1 && y1 - y0 <= 1) {
      // the 2x2-dilated max image at (x0, y0) (_dilate_max2, _zmax_lookup)
      const float* o = a.occ + y0 * a.ntx;
      const bool right = x0 + 1 < a.ntx, down = y0 + 1 < a.nty;
      float m = o[x0];
      if (right) m = nanmax(m, o[x0 + 1]);
      if (down) {
        float d = o[a.ntx + x0];
        if (right) d = nanmax(d, o[a.ntx + x0 + 1]);
        m = nanmax(m, d);
      }
      if (z >= m) ok = false;
    }
    if (ok && a.sat != nullptr) {
      // _sat_cullable: the cut image dilated over the splat's own row and
      // column span, one lookup
      const float bh = (float)a.bh_px, top = (float)(a.n_br - 1);
      const int gb0 = (int)clampf(floorf(divc(cy - ey, bh)), 0.0f, top);
      const int gb1 = (int)clampf(floorf(divc(cy + ey, bh)), 0.0f, top);
      if (x1 - x0 <= 1 && gb1 - gb0 <= kSatK - 1) {
        const int span_y = gb1 - gb0 < 0 ? 0 : gb1 - gb0;
        const int span_x = x1 - x0 < 0 ? 0 : x1 - x0;
        float m = a.sat[gb0 * a.ntx + x0];
        for (int dy = 0; dy <= span_y; ++dy) {
          const int row = gb0 + dy < a.n_br ? gb0 + dy : a.n_br - 1;
          for (int dx = 0; dx <= span_x; ++dx)
            m = nanmax(m, a.sat[row * a.ntx + x0 + dx]);
        }
        if ((float)i >= m) ok = false;
      }
    }
    if (ok) {
      const int nx = x1 - x0 + 1;
      c = nx * (y1 - y0 + 1);
      live = 1;
      const float box = __int_as_float(x0 | (y0 << 8) | ((nx - 1) << 16));
      float4* rec = sc.rec + 3 * i;
      rec[0] = make_float4(cx, cy, qa, qb);
      rec[1] = make_float4(qc, z, box, logf(al));
      rec[2] = make_float4(r, g, b, 0.0f);
    }
  }
  if (i < a.s) sc.cnt[i] = c;
  int n, n_live;
  block_excl_scan(c, &n);
  block_excl_scan(live, &n_live);
  if (threadIdx.x == 0) {
    sc.blk_cnt[blockIdx.x] = n;
    sc.blk_live[blockIdx.x] = n_live;
  }
}

// ------------------------------------------------------------------------
// 2. scan_blocks: first slot of every block, n_pairs, overflow, n_live
__global__ void __launch_bounds__(kScan)
scan_blocks_kernel(const BinArgs a, const Scratch sc, long long n_blk) {
  long long total = 0, live = 0;
  for (long long b = 0; b < n_blk; b += kScan) {
    const long long k = b + threadIdx.x;
    const long long v = k < n_blk ? sc.blk_cnt[k] : 0;
    live += k < n_blk ? sc.blk_live[k] : 0;
    long long sum;
    const long long excl = block_excl_scan(v, &sum);
    if (k < n_blk) {
      sc.blk_base[k] = total + excl;
      if (a.block_demand != nullptr) a.block_demand[k] = v;
    }
    total += sum;
  }
  long long n_live;
  block_excl_scan(live, &n_live);
  if (threadIdx.x == 0) {
    a.counts[0] = total;
    a.counts[2] = n_live;
    *a.overflow = total > a.cap;
    *sc.ticket = 0;
  }
}

// ------------------------------------------------------------------------
// the exact ellipse-tile cull of one pair (_cull_pair_tiles, _rect_min_q):
// true when the quadratic cannot reach the exp(-4) cutoff at any pixel
// centre of the tile
__device__ __forceinline__ bool culled(const BinArgs& a, const Scratch& sc,
                                       int tx, int ty, float cx, float cy,
                                       float qa, float qb, float qc) {
  const float ox = (float)(tx * a.tw);
  const float oy = (float)(ty * a.th);
  const float lx0 = (ox + 0.5f) - cx;
  const float lx1 = (ox + sc.tw_end) - cx;
  const float ly0 = (oy + 0.5f) - cy;
  const float ly1 = (oy + sc.th_end) - cy;
  if (lx0 <= 0.0f && 0.0f <= lx1 && ly0 <= 0.0f && 0.0f <= ly1)
    return false;  // the centre is inside: the minimum is 0
  const float tiny = (float)1e-20;
  const float rc = clamp_min(qc, tiny), ra = clamp_min(qa, tiny);
  auto edge_x = [&](float dx) {  // x fixed at dx, y in [ly0, ly1]
    const float t = clampf(-qb * dx / rc, ly0, ly1);
    return qa * dx * dx + 2.0f * qb * dx * t + qc * t * t;
  };
  auto edge_y = [&](float dy) {  // y fixed at dy, x in [lx0, lx1]
    const float t = clampf(-qb * dy / ra, lx0, lx1);
    return qc * dy * dy + 2.0f * qb * dy * t + qa * t * t;
  };
  const float m = nanmin(nanmin(edge_x(lx0), edge_x(lx1)),
                         nanmin(edge_y(ly0), edge_y(ly1)));
  return m > (float)(4.0 + 0.05);  // 4 + _CULL_MARGIN
}

// the 256-lane block in [lo, hi] holding pair slot `slot`: the last whose
// first slot is <= slot (an empty block shares its first slot with the next)
__device__ long long block_of(const Scratch& sc, long long slot, long long lo,
                              long long hi) {
  while (lo < hi) {
    const long long mid = (lo + hi + 1) >> 1;
    if (sc.blk_base[mid] <= slot) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// the pair slots [s0, s1) of walk segment `seg`: 2048 of them, below the
// capacity and the demand
__device__ __forceinline__ void seg_slots(const BinArgs& a, long long seg,
                                          long long* s0, long long* s1) {
  const long long n_pairs = a.counts[0];
  *s0 = seg * kSegPairs;
  long long e = *s0 + kSegPairs;
  e = e < a.cap ? e : a.cap;
  *s1 = e < n_pairs ? e : n_pairs;
}

// The pairs of walk segment `seg`, in slot order: each slot's tile (kDead
// if a cull drops it) and lane into slot_tile / slot_lane, and the
// survivors counted per tile into the block's `ctr` of n_tiles counters.
__device__ void walk(const BinArgs& a, const Scratch& sc, long long seg,
                     int* ctr) {
  const int lane = lane_id();
  long long s0, s1;
  seg_slots(a, seg, &s0, &s1);
  if (s0 >= s1) return;
  long long b = block_of(sc, s0, 0, n_blocks_of(a.s) - 1);
  long long g0 = b * kBlock;        // the group's first lane
  long long off = sc.blk_base[b];   // the group's first slot
  while (g0 < a.s && off < s1) {
    b = g0 / kBlock;
    if (g0 % kBlock == 0 && sc.blk_cnt[b] == 0) {
      // past every empty block at once: the one holding slot `off`
      g0 = block_of(sc, off, b, n_blocks_of(a.s) - 1) * kBlock;
      continue;
    }
    const long long i = g0 + lane;
    const int c = i < a.s ? sc.cnt[i] : 0;
    const int incl = warp_incl_scan(c);
    const int total = __shfl_sync(kFull, incl, 31);
    if (off + total <= s0) {  // the group lies before the segment
      off += total;
      g0 += 32;
      continue;
    }
    const int excl = incl - c;
    float4 r0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), r1 = r0;
    if (c > 0) {
      r0 = sc.rec[3 * i];
      r1 = sc.rec[3 * i + 1];
    }
    // the group's pairs j in [j_lo, j_hi) have their slots in the segment
    const int j_lo = s0 > off ? (int)(s0 - off) : 0;
    const int j_hi = s1 - off < total ? (int)(s1 - off) : total;
    for (int j0 = j_lo; j0 < j_hi; j0 += 32) {
      const int j = j0 + lane;
      // the lane of pair j: the number of lanes whose inclusive count is <= j
      int t = 0;
#pragma unroll
      for (int st = 16; st > 0; st >>= 1)
        if (__shfl_sync(kFull, incl, t + st - 1) <= j) t += st;
      const int k = j - __shfl_sync(kFull, excl, t);
      const int bx = __float_as_int(__shfl_sync(kFull, r1.z, t));
      const float cx = __shfl_sync(kFull, r0.x, t);
      const float cy = __shfl_sync(kFull, r0.y, t);
      const float qa = __shfl_sync(kFull, r0.z, t);
      const float qb = __shfl_sync(kFull, r0.w, t);
      const float qc = __shfl_sync(kFull, r1.x, t);
      const float z = __shfl_sync(kFull, r1.y, t);
      bool alive = false;
      int tile = 0;
      if (j < j_hi) {
        const int nx = ((bx >> 16) & 255) + 1;
        const int q = k / nx;
        const int tx = (bx & 255) + (k - q * nx), ty = ((bx >> 8) & 255) + q;
        tile = ty * a.ntx + tx;
        alive = a.occ == nullptr || !(z >= a.occ[tile]);
        if (alive && a.cull_exact && culled(a, sc, tx, ty, cx, cy, qa, qb, qc))
          alive = false;
        const long long slot = off + j;
        sc.slot_tile[slot] = (unsigned short)(alive ? tile : kDead);
        sc.slot_lane[slot] = (int)(g0 + t);
      }
      if (alive) atomicAdd(ctr + tile, 1);
    }
    off += total;
    g0 += 32;
  }
}

// ------------------------------------------------------------------------
// 3. hist: one warp per segment, the block's survivors per tile into
// hist[tile][block]
__global__ void hist_kernel(const BinArgs a, const Scratch sc,
                            long long n_bseg) {
  extern __shared__ int ctr[];  // [n_tiles]
  const int n_w = blockDim.x >> 5, w = threadIdx.x >> 5;
  const int nt = a.n_tiles;
  for (int t = threadIdx.x; t < nt; t += blockDim.x) ctr[t] = 0;
  __syncthreads();
  walk(a, sc, (long long)blockIdx.x * n_w + w, ctr);
  __syncthreads();
  for (int t = threadIdx.x; t < nt; t += blockDim.x)
    sc.hist[t * n_bseg + blockIdx.x] = ctr[t];
}

// 4. scan_rows: one block per tile, its row of hist scanned in place; the
// last block scans the tiles' totals: each tile's first column, its range,
// n_pairs_kept and the longest run (max_run)
__global__ void __launch_bounds__(kRowScan)
scan_rows_kernel(const BinArgs a, const Scratch sc, long long n_bseg) {
  __shared__ bool last;
  __shared__ int longest;
  int4* row = reinterpret_cast<int4*>(sc.hist + blockIdx.x * n_bseg);
  int carry = 0;
  for (long long b = 0; b < n_bseg / 4; b += kRowScan) {
    const long long k = b + threadIdx.x;
    int4 v = make_int4(0, 0, 0, 0);
    if (k < n_bseg / 4) v = row[k];
    int total;
    const int excl = carry + block_excl_scan(v.x + v.y + v.z + v.w, &total);
    if (k < n_bseg / 4)
      row[k] = make_int4(excl, excl + v.x, excl + v.x + v.y,
                         excl + v.x + v.y + v.z);
    carry += total;
  }
  if (threadIdx.x == 0) {
    longest = 0;
    sc.tile_base[blockIdx.x] = carry;
    __threadfence();
    last = atomicAdd(sc.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int nt = a.n_tiles;
  const int per = (nt + kRowScan - 1) / kRowScan;
  const int b = threadIdx.x * per;
  const int e = b + per < nt ? b + per : nt;
  int s = 0, m = 0;
  for (int k = b; k < e; ++k) {
    const int v = __ldcg(sc.tile_base + k);
    s += v;
    m = max(m, v);
  }
  atomicMax(&longest, m);
  int total;
  int run = block_excl_scan(s, &total);  // its barriers order `longest`
  for (int k = b; k < e; ++k) {
    const int v = __ldcg(sc.tile_base + k);
    sc.tile_base[k] = run;
    a.range_start[k] = v ? run : 0;
    a.range_end[k] = v ? run + v : 0;
    run += v;
  }
  if (threadIdx.x == 0) {
    a.counts[1] = total;
    a.counts[3] = longest;
  }
}

// 5. place: the blocks and segments of hist again, each kept pair's lane
// into its column, through the block's shared memory: the block's kept pairs
// are laid out there tile by tile as they lie in the table, so that they
// leave in runs of consecutive columns
__global__ void place_kernel(const BinArgs a, const Scratch sc,
                             long long n_bseg) {
  extern __shared__ int smem[];
  const int n_w = blockDim.x >> 5, w = threadIdx.x >> 5, lane = lane_id();
  const int nt = a.n_tiles;
  int* start = smem;               // [nt] each tile's first staged position,
                                   // then its column less that position
  int* next = smem + nt;           // [n_w, nt] counts, then next positions
  int* staged = next + n_w * nt;   // [n_w * kSegPairs] lanes
  unsigned short* staged_tile =    // [n_w * kSegPairs] their tiles
      reinterpret_cast<unsigned short*>(staged + n_w * kSegPairs);
  __shared__ int n_staged;
  for (int e = threadIdx.x; e < nt * n_w; e += blockDim.x) next[e] = 0;
  __syncthreads();
  long long s0, s1;
  seg_slots(a, (long long)blockIdx.x * n_w + w, &s0, &s1);
  int* nxt = next + w * nt;
  for (long long jb = s0; jb < s1; jb += 8 * 32) {  // the warp's counts
    int tiles[8];  // eight steps' slots, loaded at once
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const long long j = jb + 32 * u + lane;
      tiles[u] = j < s1 ? sc.slot_tile[j] : kDead;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (tiles[u] != kDead) atomicAdd(nxt + tiles[u], 1);
  }
  __syncthreads();
  // each tile's staged run: its warps' shares in order, the tiles in order
  int carry = 0;
  for (int t0 = 0; t0 < nt; t0 += blockDim.x) {
    const int t = t0 + threadIdx.x;
    int c = 0;
    if (t < nt) {
      for (int ww = 0; ww < n_w; ++ww) {
        const int v = next[ww * nt + t];
        next[ww * nt + t] = c;
        c += v;
      }
    }
    int total;
    const int excl = carry + block_excl_scan(c, &total);
    if (t < nt) {
      start[t] = sc.tile_base[t] + sc.hist[t * n_bseg + blockIdx.x] - excl;
      for (int ww = 0; ww < n_w; ++ww) next[ww * nt + t] += excl;
    }
    carry += total;
  }
  if (threadIdx.x == 0) n_staged = carry;
  __syncthreads();
  for (long long jb = s0; jb < s1; jb += 8 * 32) {
    int tiles[8], lanes[8];  // eight steps' slots, loaded at once
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const long long j = jb + 32 * u + lane;
      tiles[u] = j < s1 ? sc.slot_tile[j] : kDead;
      lanes[u] = j < s1 ? sc.slot_lane[j] : 0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int tile = tiles[u];
      const bool alive = tile != kDead;
      // the step's live pairs of the same tile
      const unsigned peers =
          __match_any_sync(kFull, tile) & __ballot_sync(kFull, alive);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      const int pos = alive ? nxt[tile] + rank : 0;
      __syncwarp();
      if (alive && rank == 0) nxt[tile] = pos + __popc(peers);
      if (alive) {
        staged[pos] = lanes[u];
        staged_tile[pos] = (unsigned short)tile;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  // out in table order: staged position e of tile t is column tile_base[t]
  // + the block's offset in the tile's run + e less the tile's first
  // position in the block
  for (int e = threadIdx.x; e < n_staged; e += blockDim.x)
    sc.lane_of[start[staged_tile[e]] + e] = staged[e];
}

// 6. gather: one thread a table column, in order
__global__ void __launch_bounds__(kBlock)
gather_kernel(const BinArgs a, const Scratch sc) {
  const long long j = (long long)blockIdx.x * kBlock + threadIdx.x;
  const long long cap = a.cap;
  if (j >= cap) return;
  const long long kept = a.counts[1];
  float* col = a.table + j;
  if (j >= kept) {
    col[5 * cap] = (float)-1e30;
    col[11 * cap] = -INFINITY;
    if (j < (kept + a.chunk - 1) / a.chunk * a.chunk) {
#pragma unroll
      for (int row = 0; row < 13; ++row)
        if (row != 5 && row != 11) col[row * cap] = 0.0f;
    }
    return;
  }
  // the tile: the last whose first column is <= j (an empty tile shares its
  // first column with the next, so the last such tile is never empty)
  int lo = 0, hi = a.n_tiles - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(sc.tile_base + mid) <= j) lo = mid; else hi = mid - 1;
  }
  const int tile = lo;
  const long long i = sc.lane_of[j];
  const float4 r0 = sc.rec[3 * i], r1 = sc.rec[3 * i + 1];
  const float4 r2 = sc.rec[3 * i + 2];
  const float qa = r0.z, qb = r0.w, qc = r1.x;
  // build_pair_table: the quadratic recentred to the tile's origin
  const float ox = (float)(tile % a.ntx * a.tw);
  const float oy = (float)(tile / a.ntx * a.th);
  const float dx = r0.x - ox, dy = r0.y - oy;
  const float av = qa * dx + qb * dy;
  const float bv = qb * dx + qc * dy;
  col[0] = -qa;
  col[cap] = -2.0f * qb;
  col[2 * cap] = -qc;
  col[3 * cap] = 2.0f * av;
  col[4 * cap] = 2.0f * bv;
  col[5 * cap] = -(dx * av + dy * bv);
  col[6 * cap] = r1.y;
  col[7 * cap] = 0.0f;
  col[8 * cap] = r2.x;
  col[9 * cap] = r2.y;
  col[10 * cap] = r2.z;
  col[11 * cap] = r1.w;
  col[12 * cap] = (float)i;
}

}  // namespace

extern "C" long long gswt_binning_scratch_bytes(long long s, int n_tiles,
                                                long long cap) {
  Scratch sc;
  return layout(nullptr, s, n_tiles, cap, &sc);
}

// the largest tile grid whose one-warp histogram fits a block's opt-in
// shared memory on `device` (the place kernel's, with one warp, is the
// larger) and whose tile indices fit 16 bits below kDead; -1 if the device
// cannot be asked
extern "C" long long gswt_binning_max_tiles(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  // a one-warp place block: 8 bytes a tile and its staged lanes and tiles,
  // with 1 KB left for the static shared memory
  const long long n = (bytes - 1024 - 6LL * kSegPairs) / 8;
  return n < kDead ? n : kDead;
}

extern "C" int gswt_binning(const BinArgs* args, void* stream) {
  const BinArgs a = *args;
  cudaStream_t st = (cudaStream_t)stream;
  Scratch sc;
  layout((char*)a.scratch, a.s, a.n_tiles, a.cap, &sc);
  sc.tw_end = (float)((double)a.tw - 0.5);
  sc.th_end = (float)((double)a.th - 0.5);
  const long long n_blk = n_blocks_of(a.s);
  // one block of n_w warps (segments) per row entry of hist, in both walks
  const int n_w = place_warps(a.n_tiles);
  const long long n_bseg = n_bsegs_of(a.cap, n_w);
  const size_t smem = (size_t)4 * a.n_tiles;
  const size_t smem_p = place_smem(n_w, a.n_tiles);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(hist_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  if (smem_p > 48 * 1024)
    cudaFuncSetAttribute(place_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem_p);
  if (n_blk > 0) {
    if (a.fast)
      count_kernel<true><<<(unsigned)n_blk, kBlock, 0, st>>>(a, sc);
    else
      count_kernel<false><<<(unsigned)n_blk, kBlock, 0, st>>>(a, sc);
  }
  scan_blocks_kernel<<<1, kScan, 0, st>>>(a, sc, n_blk);
  if (n_bseg > 0)
    hist_kernel<<<(unsigned)n_bseg, 32 * n_w, smem, st>>>(a, sc, n_bseg);
  scan_rows_kernel<<<(unsigned)a.n_tiles, kRowScan, 0, st>>>(a, sc, n_bseg);
  if (n_bseg > 0)
    place_kernel<<<(unsigned)n_bseg, 32 * n_w, smem_p, st>>>(a, sc, n_bseg);
  if (a.cap > 0)
    gather_kernel<<<(unsigned)((a.cap + kBlock - 1) / kBlock), kBlock, 0, st>>>(
        a, sc);
  return (int)cudaGetLastError();
}
