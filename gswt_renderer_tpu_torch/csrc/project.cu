// Stream assembly and splat projection of one frame in one launch: panel
// gather, surface warp, LOD blend, EWA projection, debug colours and the
// valid mask (ops/project.py assemble_and_project; the vertex shader
// vs_main, gswt.wgsl:27-422).
//
// Replaces no Pallas kernel: the JAX package leaves projection to XLA's
// fusion. On the card it replaces the plain path's chain of several hundred
// ATen kernels over the whole stream (ops/project.py
// assemble_and_project_plain), and on the main path it absorbs the panel
// copy of csrc/blockgather.cu, which stays for its own callers.
//
// Bound: bytes. Per live lane 12 float32 panel rows in (48 B; a merged lane
// reads its store index and map id, 8 B, and its 10 store rows, 40 B) and
// 12 float32 outputs plus a mask byte out (49 B): about 97 B a lane, 0.12 ms
// for 4M lanes at 3.35 TB/s. The arithmetic, a few hundred FP32 operations
// a lane, stays under that line.
// Design: one thread block per 256-lane block of the plan, one thread per
// lane. A block reads its plan column (src, bits1, bits2, nvalid, draw and,
// for a 6-row plan, lo) and its draw's keep_draw entry once, so every
// per-draw uniform is block-uniform; a culled draw's block writes zeros and
// reads nothing else. A panel block reads its 12 rows where they lie, the
// warp's loads coalesced along the row; a merged block reads the store index
// and map id from `merged` and then the 10 store rows, so neither the merged
// scratch nor a gathered copy of the stream is ever written. The frame's
// uniform block is read whole from the device (one word per thread into
// shared memory), so the host reads nothing. The fast profile's small
// source height map (at most 4096 texels) is staged in shared memory, and
// each lane takes its separable Catmull-Rom and bilinear taps from there.
// Outputs: [12, S] float32 (rows ROW_* below) and valid [S] bool; a dead
// lane writes zeros.
//
// Specialisations: <kSurface, kHeight> — flat (0), height map (1) with the
// exact 5-tap gradient (kHeight 0), the fast patch gradient (1) or the fast
// small-map surface (2), sphere (2). draw_mode 0-4, the point cloud and
// gs_enable are block-uniform runtime branches.
//
// Precision: float32 with IEEE sqrt and division, built with -fmad=false
// (ops/kernels.py) and written in the plain path's order of operations, so
// each multiply and add is rounded on its own as the plain path's separate
// ATen kernels round it and the mask's decisions (t_ratio at 0 or 1, the
// clip tests, lam2 < 0, the z range, isfinite) fall as the plain path's do.
// Clamps propagate NaN as torch.clamp does. A division by a Python number
// is done as PyTorch does it on the card, a multiply by the float reciprocal
// (divc), so the kernel repeats the plain path's arithmetic on the card; the
// plain path on the CPU divides, an ulp apart there.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "torch_semantics.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kGsMask = (1 << 26) - 1;
constexpr int kSmapMax = 4096;  // source height-map texels staged in shared memory
constexpr double kPi = 3.141592653589793;  // Python's math.pi

// output rows: the order binning stacks them in (ops/binning.py), then ext
enum Row { ROW_CX, ROW_CY, ROW_QA, ROW_QB, ROW_QC, ROW_Z, ROW_R, ROW_G,
           ROW_B, ROW_A, ROW_EXT_X, ROW_EXT_Y, kRows };

}  // namespace

// The first word of each field the kernel reads in the frame's uniform
// block; ops/project.py UNIFORMS holds the layout. Mirrored by ops/project.py
// _UniformWords.
struct UniformWords {
  int view, proj_wgpu, focal, htan_fov, cam_pos, splat_scale, tile_width,
      use_clip, clip_height, sphere_radius, point_cloud_radius,
      transition_width_ratio, num_lod, map_half_wh, center_coord,
      transition_dist_vec, height_map_scale, scene_scale, gs_enable;
};

// Mirrored by ops/project.py _ProjectArgs.
struct ProjectArgs {
  const int* blocks;              // [plan_rows, nb] i32
  long long nb;
  const int* merged;              // [2, merged_cols] i32
  long long merged_cols;
  const float* panels;            // [>= 12, panel_cols] f32
  long long panel_cols;
  const float* store;             // [10, store_cols] f32
  long long store_cols;
  const unsigned char* keep_draw; // [n_draws] bool
  long long n_draws;
  const float* hm4;               // [4, hm_w * hm_h] f32
  const float* hm_src;            // [src_h, src_w] f32 (kHeight 2)
  const float* uniforms;          // [n_uniforms] f32, the frame's uniform block
  UniformWords words;
  float* out;                     // [kRows, nb * 256] f32
  unsigned char* valid;           // [nb * 256] bool
  int n_uniforms;                 // at most kBlock
  int plan_rows, hm_w, hm_h, src_w, src_h;
  int draw_mode, point_cloud, img_w, img_h;
};

namespace {

// ------------------------------------------------------------------------
// Python's integer semantics (torch.div(..., rounding_mode="floor"), %)
__device__ __forceinline__ int floordiv(int a, int b) {
  if (b == 0) return 0;
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ int pymod(int a, int b) {
  if (b == 0) return 0;
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

__device__ __forceinline__ long long pymod64(long long a, long long n) {
  long long r = a % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ float clamp_max(float v, float hi) {
  if (v != v) return v;
  return hi < v ? hi : v;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// torch.remainder(x, 1.0)
__device__ __forceinline__ float rem1(float a) {
  float m = fmodf(a, 1.0f);
  if (m != 0.0f && m < 0.0f) m += 1.0f;
  return m;
}

// the uniform block in shared memory: f(k) the float at word k, i(k) the
// int field there (the integral word, truncated as .to(torch.int32) does)
struct Uni {
  const float* v;
  __device__ float f(int k) const { return v[k]; }
  __device__ int i(int k) const { return __float2int_rz(v[k]); }
};

// ------------------------------------------------------------------------
// surface mapping (ops/project.py surface_mapping): the mapped point and the
// local frame (lx, ly, lz) columns
struct Frame {
  float mx, my, mz;
  float xx, xy, xz, yx, yy, yz, zx, zy, zz;
};

// the four texels around uv (u, v) of a pack_tex4 texture, Repeat
// addressing, and the fractions between them
struct Patch {
  float i00, i10, i01, i11, tx, ty;
};

__device__ __forceinline__ Patch patch4(const float* hm4, int w, int h,
                                        float u, float v) {
  Patch p;
  const float x = u * (float)w - 0.5f;
  const float y = v * (float)h - 0.5f;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  p.tx = x - x0;
  p.ty = y - y0;
  const long long wh = (long long)w * h;
  const long long base =
      pymod64((long long)y0, h) * w + pymod64((long long)x0, w);
  p.i00 = __ldg(hm4 + base);
  p.i10 = __ldg(hm4 + wh + base);
  p.i01 = __ldg(hm4 + 2 * wh + base);
  p.i11 = __ldg(hm4 + 3 * wh + base);
  return p;
}

// textureSampleLevel, Repeat + Linear, from a pack_tex4 texture
__device__ __forceinline__ float bilinear(const Patch& p) {
  return (p.i00 * (1.0f - p.tx) + p.i10 * p.tx) * (1.0f - p.ty) +
         (p.i01 * (1.0f - p.tx) + p.i11 * p.tx) * p.ty;
}

// wrapped Catmull-Rom taps of the source surface at uv u (n texels)
struct Taps {
  int pos[4];
  float w[4];
};

__device__ __forceinline__ Taps cr_taps(float u, int n) {
  Taps t;
  const float x = u * (float)n - 0.5f;
  const float x0 = floorf(x);
  const float s = x - x0;
  t.w[0] = ((-0.5f * s + 1.0f) * s - 0.5f) * s;
  t.w[1] = ((1.5f * s - 2.5f) * s) * s + 1.0f;
  t.w[2] = ((-1.5f * s + 2.0f) * s + 0.5f) * s;
  t.w[3] = ((0.5f * s - 0.5f) * s) * s;
  const long long r = pymod64((long long)x0, n);
  for (int i = 0; i < 4; ++i) t.pos[i] = (int)((r + i - 1 + n) % n);
  return t;
}

// the source row h sampled at the two snapped columns: (t0, dtx) of
// _smallmap_resized_bilinear's along_x
__device__ __forceinline__ void along_x(const float* map, int src_w, int h,
                                        const Taps& a, const Taps& b, float tx,
                                        float* tmp, float* dtx) {
  const float* row = map + h * src_w;
  float t0 = 0.0f, t1 = 0.0f;
  for (int i = 0; i < 4; ++i) t0 = t0 + row[a.pos[i]] * a.w[i];
  for (int i = 0; i < 4; ++i) t1 = t1 + row[b.pos[i]] * b.w[i];
  *dtx = t1 - t0;
  *tmp = t0 + tx * *dtx;
}

template <int kSurface, int kHeight>
__device__ __forceinline__ Frame surface_mapping(
    const Uni& u, const ProjectArgs& a, const float* smap, float px, float py,
    int map_id, int single, int mc_x, int mc_y) {
  const UniformWords& word = a.words;
  Frame fr;
  if constexpr (kSurface == 0) {
    fr.mx = px; fr.my = py; fr.mz = 0.0f;
    fr.xx = 1.0f; fr.xy = 0.0f; fr.xz = 0.0f;
    fr.yx = 0.0f; fr.yy = 1.0f; fr.yz = 0.0f;
    fr.zx = 0.0f; fr.zy = 0.0f; fr.zz = 1.0f;
    return fr;
  } else if constexpr (kSurface == 1) {
    const float half0 = (float)u.i(word.map_half_wh);
    const float half1 = (float)u.i(word.map_half_wh + 1);
    const float tw = u.f(word.tile_width);
    const float hx = (2.0f * half0 + 1.0f) * tw * u.f(word.height_map_scale);
    const float hy =
        (2.0f * half1 + 1.0f) * tw * u.f(word.height_map_scale + 1);
    const float hu = (px + half0 * tw) / hx;
    const float hv = (py + half1 * tw) / hy;
    const int w = a.hm_w, h = a.hm_h;
    const float z = u.f(word.height_map_scale + 2);
    float height, gx, gy;
    if constexpr (kHeight == 0) {
      const float dt = 0.001f;
      height = bilinear(patch4(a.hm4, w, h, hu, hv)) * z;
      const float h_r = bilinear(patch4(a.hm4, w, h, hu + dt, hv)) * z;
      const float h_l = bilinear(patch4(a.hm4, w, h, hu - dt, hv)) * z;
      const float h_u = bilinear(patch4(a.hm4, w, h, hu, hv + dt)) * z;
      const float h_d = bilinear(patch4(a.hm4, w, h, hu, hv - dt)) * z;
      gx = (h_r - h_l) / ((float)(2.0 * 0.001) * hx);
      gy = (h_u - h_d) / ((float)(2.0 * 0.001) * hy);
    } else {
      float dhdx, dhdy;
      if constexpr (kHeight == 2) {
        // _smallmap_resized_bilinear: snap to the resize grid, take the
        // source map's Catmull-Rom taps at the four grid points, lerp
        const float xs = hu * (float)w - 0.5f;
        const float xs0 = floorf(xs);
        const float u0 = divc(xs0, (float)w), u1 = divc(xs0 + 1.0f, (float)w);
        const float tx = xs - xs0;
        const float ys = hv * (float)h - 0.5f;
        const float ys0 = floorf(ys);
        const float v0 = divc(ys0, (float)h), v1 = divc(ys0 + 1.0f, (float)h);
        const float ty = ys - ys0;
        const Taps ax = cr_taps(u0, a.src_w), bx = cr_taps(u1, a.src_w);
        const Taps ay = cr_taps(v0, a.src_h), by = cr_taps(v1, a.src_h);
        float r0 = 0.0f, r1 = 0.0f, d0 = 0.0f, d1 = 0.0f;
        for (int j = 0; j < 4; ++j) {
          float tmp, dtx;
          along_x(smap, a.src_w, ay.pos[j], ax, bx, tx, &tmp, &dtx);
          r0 = r0 + tmp * ay.w[j];
          d0 = d0 + dtx * ay.w[j];
        }
        for (int j = 0; j < 4; ++j) {
          float tmp, dtx;
          along_x(smap, a.src_w, by.pos[j], ax, bx, tx, &tmp, &dtx);
          r1 = r1 + tmp * by.w[j];
          d1 = d1 + dtx * by.w[j];
        }
        dhdy = r1 - r0;
        height = r0 + ty * dhdy;
        dhdx = d0 + ty * (d1 - d0);
      } else {
        // the bilinear patch of the height tap's own four texels
        const Patch p = patch4(a.hm4, w, h, hu, hv);
        height = bilinear(p);
        dhdx = (p.i10 - p.i00) * (1.0f - p.ty) + (p.i11 - p.i01) * p.ty;
        dhdy = (p.i01 - p.i00) * (1.0f - p.tx) + (p.i11 - p.i10) * p.tx;
      }
      height = height * z;
      gx = dhdx * z * (float)w / hx;
      gy = dhdy * z * (float)h / hy;
    }
    const float n = sqrtf(gx * gx + gy * gy + 1.0f);
    fr.mx = px; fr.my = py; fr.mz = height;
    fr.xx = 1.0f; fr.xy = 0.0f; fr.xz = gx;
    fr.yx = 0.0f; fr.yy = 1.0f; fr.yz = gy;
    fr.zx = -gx / n; fr.zy = -gy / n; fr.zz = 1.0f / n;
    return fr;
  } else {
    // sphere (gswt.wgsl:590-623)
    const int half_i0 = u.i(word.map_half_wh);
    const int half_i1 = u.i(word.map_half_wh + 1);
    const float half0 = (float)half_i0, half1 = (float)half_i1;
    const float tw = u.f(word.tile_width);
    const float cc0 = (float)u.i(word.center_coord);
    const float cc1 = (float)u.i(word.center_coord + 1);
    const float ymax = half1 * 2.0f * tw;
    const float block_w = divc(half0 * 2.0f * tw, 5.0f);
    const float wx = px - (cc0 - half0) * tw;
    const float wy = py - (cc1 - half1) * tw;
    const int map_h = 2 * half_i1;
    const int mi = single == 1 ? floordiv(map_id, map_h) : mc_x;
    const int mj = single == 1 ? pymod(map_id, map_h) : mc_y;
    const float bidx = (float)floordiv(5 * mi, 2 * half_i0);
    const float bidy = (float)floordiv(2 * mj, 2 * half_i1);
    const float bx = wx - bidx * block_w;
    const float by = wy - bidy * block_w;
    const float r = u.f(word.sphere_radius);

    // _sphere_get_uv then _sphere_uv_to_pos
    auto pos_at = [&](float bxx, float byy, float* ox, float* oy, float* oz) {
      const float bw = divc(half0 * 2.0f * tw, 5.0f);
      const bool top = bidy == 0.0f;
      const bool lower = byy < bxx;
      const float den1 = bw - (bxx - byy);
      const float den2 = bw - (byy - bxx);
      float uu, vv;
      if (top && lower) {
        const float safe1 = fabsf(den1) < 1e-20f ? 1.0f : den1;
        uu = bxx - byy == bw ? 0.0f : divc(byy / safe1 + bidx, 5.0f);
        vv = divc(den1 / bw, 3.0f);
      } else if (top) {
        uu = divc(bxx / bw + bidx, 5.0f) + (byy - bxx) / bw * 0.1f;
        vv = divc((byy - bxx) / bw, 3.0f) + (float)(1.0 / 3.0);
      } else if (lower) {
        uu = divc(bxx / bw + bidx, 5.0f) + den1 / bw * 0.1f;
        vv = divc(den1 / bw, 3.0f) + (float)(1.0 / 3.0);
      } else {
        const float safe2 = fabsf(den2) < 1e-20f ? 1.0f : den2;
        uu = byy - bxx == bw ? 0.0f : divc(bxx / safe2 + bidx, 5.0f) + 0.1f;
        vv = divc((byy - bxx) / bw, 3.0f) + (float)(2.0 / 3.0);
      }
      uu = (uu + 0.5f * floorf(vv)) * (float)(2.0 * kPi);
      vv = (vv - 0.5f) * (float)kPi;
      *ox = cosf(vv) * cosf(uu);
      *oy = cosf(vv) * sinf(uu);
      *oz = sinf(vv);
    };
    float lzx, lzy, lzz;
    pos_at(bx, by, &lzx, &lzy, &lzz);
    const float dt = 0.001f * ymax;
    float prx, pry, prz, plx, ply, plz, pux, puy, puz, pdx, pdy, pdz;
    pos_at(bx + dt, by + 0.0f, &prx, &pry, &prz);
    pos_at(bx + (-dt), by + 0.0f, &plx, &ply, &plz);
    pos_at(bx + 0.0f, by + dt, &pux, &puy, &puz);
    pos_at(bx + 0.0f, by + (-dt), &pdx, &pdy, &pdz);
    const float sc = r / (2.0f * dt);
    fr.mx = lzx * r; fr.my = lzy * r; fr.mz = lzz * r;
    fr.xx = (prx - plx) * sc; fr.xy = (pry - ply) * sc; fr.xz = (prz - plz) * sc;
    fr.yx = (pux - pdx) * sc; fr.yy = (puy - pdy) * sc; fr.yz = (puz - pdz) * sc;
    fr.zx = lzx; fr.zy = lzy; fr.zz = lzz;
    return fr;
  }
}

// ------------------------------------------------------------------------
// the debug draw modes (ops/project.py _apply_draw_mode)
__device__ __forceinline__ float wgsl_rand(float x, float y) {
  return rem1(sinf(x * 12.9898f + y * 78.233f) * 43758.5453f);
}

__device__ __forceinline__ void draw_mode_colour(
    int mode, bool on_sphere, float tw, float* cr, float* cg, float* cb,
    float pos_x, float pos_y, float off_x, float off_y, int tile_lod,
    int lod_id, int single, bool is_changing, float t_ratio, int view_id,
    int single_lod, int tile_id) {
  if (mode == 1) {  // TileID
    const float gray = clampf(divc(*cr + *cg + *cb, 0.6f), 0.0f, 1.0f);
    float r = gray, g = gray, b = gray;
    const float margin = 0.05f * tw;
    const bool west = pos_x < margin;
    const bool east = pos_x > tw - margin;
    const bool south = pos_y < margin;
    const bool north = pos_y > tw - margin;
    const bool ym = south || north;
    auto set = [&](float x, float y, float z) { r = x; g = y; b = z; };
    auto bit = [&](int k) { return pymod(floordiv(tile_id, k), 2); };
    auto set_a = [&]() {
      if (on_sphere) set(1.0f, 0.0f, 0.0f); else set(1.0f, 0.85f, 0.0f);
    };
    auto set_b = [&]() {
      if (on_sphere) set(0.0f, 1.0f, 0.13f); else set(0.0f, 0.58f, 1.0f);
    };
    if (west) {
      if (ym) set(0.5f, 0.5f, 0.5f);
      else if (bit(8) == 0) set(1.0f, 0.0f, 0.0f);
      else set(0.0f, 1.0f, 0.13f);
    } else if (east) {
      if (ym) set(0.5f, 0.5f, 0.5f);
      else if (bit(2) == 0) set(1.0f, 0.0f, 0.0f);
      else set(0.0f, 1.0f, 0.13f);
    } else if (south) {
      if (bit(1) == 0) set_a(); else set_b();
    } else if (north) {
      if (bit(4) == 0) set_a(); else set_b();
    }
    if (single == 1) {
      r = gray * wgsl_rand(off_x, off_y);
      g = gray * wgsl_rand(off_x + 23.45f, off_y + 23.45f);
      b = gray * wgsl_rand(off_x + 67.89f, off_y + 67.89f);
    }
    *cr = r; *cg = g; *cb = b;
  } else if (mode == 2) {  // TileLOD
    const bool mid_t = t_ratio > 0.0f && t_ratio < 1.0f;
    const float lodv = (float)tile_lod;
    float r = 0.5f;
    float g = tile_lod < 3 ? divc(3.0f - lodv, 3.0f) : 0.0f;
    float b = tile_lod >= 3 ? divc(6.0f - lodv, 3.0f) : 1.0f;
    if (!mid_t && is_changing) { r = 0.0f; g = 1.0f; b = 0.0f; }
    if (mid_t) { r = 0.0f; g = 0.0f; b = 0.0f; }
    *cr = r; *cg = g; *cb = b;
  } else if (mode == 3) {  // LOD
    const bool mid_t = t_ratio > 0.0f && t_ratio < 1.0f;
    const float eff = (float)(single_lod >= 0 ? single_lod : lod_id);
    const float cx = eff < 3.0f ? divc(3.0f - eff, 3.0f) : 0.0f;
    const float cy = eff >= 3.0f ? divc(6.0f - eff, 3.0f) : 1.0f;
    *cr = mid_t ? 0.0f : 0.5f;
    *cg = mid_t ? 0.0f : cx;
    *cb = mid_t ? 0.0f : cy;
  } else {  // View
    const float vid = (float)view_id;
    float cx = vid < 4.0f ? divc(4.0f - vid, 4.0f) : 0.0f;
    float cy = vid >= 4.0f ? divc(8.0f - vid, 4.0f) : 0.0f;
    if (vid >= 8.0f) { cx = 1.0f; cy = 1.0f; }
    *cr = 0.5f; *cg = cx; *cb = cy;
  }
}

// ------------------------------------------------------------------------
template <int kSurface, int kHeight>
__global__ void __launch_bounds__(kBlock)
    project_kernel(const __grid_constant__ ProjectArgs a) {
  __shared__ float su[kBlock];
  extern __shared__ float smap[];
  const int lane = threadIdx.x;
  if (lane < a.n_uniforms) su[lane] = __ldg(a.uniforms + lane);
  const float* map = a.hm_src;
  if constexpr (kHeight == 2) {
    const int n = a.src_w * a.src_h;
    if (n <= kSmapMax) {
      for (int i = lane; i < n; i += kBlock) smap[i] = __ldg(a.hm_src + i);
      map = smap;
    }
  }
  __syncthreads();
  const Uni u{su};
  const UniformWords& word = a.words;

  const long long nb = a.nb;
  const long long b = blockIdx.x;
  const long long s_n = nb * kBlock;
  const long long s = b * kBlock + lane;
  auto dead = [&]() {
    for (int r = 0; r < kRows; ++r) a.out[r * s_n + s] = 0.0f;
    a.valid[s] = 0;
  };

  // the block's plan column: per-draw uniforms
  const int src = a.blocks[b];
  const int bits1 = a.blocks[nb + b];
  const int bits2 = a.blocks[2 * nb + b];
  const int nvalid = a.blocks[3 * nb + b];
  const int draw = a.blocks[4 * nb + b];
  const int lo = a.plan_rows >= 6 ? a.blocks[5 * nb + b] : 0;
  const int keep_blk =
      draw >= 0 && draw < a.n_draws ? (int)a.keep_draw[draw] : 0;
  const int keep = keep_blk & ((bits1 >> 28) & 1) & u.i(word.gs_enable);
  if (keep != 1 || lane >= nvalid || lane < lo) {
    dead();
    return;
  }
  const int single = bits1 & 1;
  const int changing = (bits1 >> 1) & 1;
  const int to_lower = ((bits1 >> 2) & 3) - 1;
  const int tile_lod = (bits1 >> 4) & 31;
  const int valid_lod = ((bits1 >> 9) & 31) - 1;
  const int view_id = (bits1 >> 14) & 15;
  const int tile_id = (bits1 >> 18) & 1023;
  const int map_index = bits2 & ((1 << 22) - 1);
  const int single_lod = ((bits2 >> 22) & 31) - 1;

  // the lane's splat: a panel column, or a merged lane's store column
  float row[10];
  int packed = 0, mid = 0;
  const long long npb = a.panel_cols / kBlock;
  if (src >= 0 && src < npb) {
    const float* col = a.panels + (long long)src * kBlock + lane;
    for (int r = 0; r < 10; ++r) row[r] = __ldg(col + r * a.panel_cols);
    packed = __float_as_int(__ldg(col + 10 * a.panel_cols));
    mid = __float_as_int(__ldg(col + 11 * a.panel_cols));
  } else {
    const long long m = ((long long)src - npb) * kBlock + lane;
    long long g = -1;
    if (src >= npb && m < a.merged_cols) {
      packed = __ldg(a.merged + m);
      mid = __ldg(a.merged + a.merged_cols + m);
      g = packed & kGsMask;
    }
    // an id out of range reads a zero splat, as the block gather does
    const bool ok = g >= 0 && g < a.store_cols;
    for (int r = 0; r < 10; ++r)
      row[r] = ok ? __ldg(a.store + r * a.store_cols + g) : 0.0f;
  }
  const float pos_x = row[0], pos_y = row[1], pos_z = row[2];
  const int rgba = __float_as_int(row[9]);
  const int lod_id = (packed >> 26) & 0xF;

  // early discard: wrong lod id (gswt.wgsl:39-42)
  if (valid_lod >= 0 && valid_lod != lod_id) {
    dead();
    return;
  }
  bool valid = true;

  float cr = divc((float)(rgba & 0xFF), 255.0f);
  float cg = divc((float)((rgba >> 8) & 0xFF), 255.0f);
  float cb = divc((float)((rgba >> 16) & 0xFF), 255.0f);
  float ca = divc((float)((rgba >> 24) & 0xFF), 255.0f);

  const int half_i0 = u.i(word.map_half_wh);
  const int half_i1 = u.i(word.map_half_wh + 1);
  const int cc_i0 = u.i(word.center_coord), cc_i1 = u.i(word.center_coord + 1);
  const float tw = u.f(word.tile_width);
  const int map_h = 2 * half_i1 + (kSurface == 2 ? 0 : 1);
  const int mc_x = floordiv(map_index, map_h);
  const int mc_y = pymod(map_index, map_h);

  // offsets (gswt.wgsl:52-64): merged draws use the per-splat map id
  const int om = single == 1 ? mid : map_index;
  const float off_x = (float)(floordiv(om, map_h) - half_i0 + cc_i0) * tw;
  const float off_y = (float)(pymod(om, map_h) - half_i1 + cc_i1) * tw;
  // the draw's own offset, which seeds the TileID tint
  const float doff_x = (float)(mc_x - half_i0 + cc_i0) * tw;
  const float doff_y = (float)(mc_y - half_i1 + cc_i1) * tw;
  const float ssc0 = u.f(word.scene_scale), ssc1 = u.f(word.scene_scale + 1);
  const float ssc2 = u.f(word.scene_scale + 2);
  const float cx_w = (pos_x + off_x) * ssc0;
  const float cy_w = (pos_y + off_y) * ssc1;
  const float cz_w = (pos_z + 0.0f) * ssc2;

  // surface mapping (gswt.wgsl:74-82)
  const Frame fr = surface_mapping<kSurface, kHeight>(
      u, a, map, cx_w, cy_w, mid, single, mc_x, mc_y);
  float cx_n = cx_w, cy_n = cy_w, cz_n = cz_w;
  if constexpr (kSurface > 0) {
    cx_n = fr.mx + fr.zx * cz_w;
    cy_n = fr.my + fr.zy * cz_w;
    cz_n = fr.mz + fr.zz * cz_w;
  }

  // z clip (gswt.wgsl:84-87)
  if (u.i(word.use_clip) == 1 && fr.mz < u.f(word.clip_height)) valid = false;

  // LOD transition (gswt.wgsl:89-150)
  const float dxc = cx_n - u.f(word.cam_pos);
  const float dyc = cy_n - u.f(word.cam_pos + 1);
  const float dzc = cz_n - u.f(word.cam_pos + 2);
  const float cam_dist = sqrtf(dxc * dxc + dyc * dyc + dzc * dzc);
  const int num_lod = u.i(word.num_lod);
  auto lut16 = [&](int idx) {
    return u.f(word.transition_dist_vec + clampi(idx, 0, 15));
  };
  int hl_single;
  if (lod_id == 0) hl_single = 0;
  else if (lod_id == num_lod - 1) hl_single = lod_id - 1;
  else hl_single = (cam_dist - lut16(lod_id - 1)) < (lut16(lod_id) - cam_dist)
                       ? lod_id - 1 : lod_id;
  const int hl_tile = to_lower == 1 ? tile_lod : tile_lod - 1;
  const int higher_lod = clampi(single == 1 ? hl_single : hl_tile, 0, 15);
  const float t_dist = lut16(higher_lod);
  const float half_w = u.f(word.transition_width_ratio) * t_dist;
  float t_ratio = clampf((cam_dist - t_dist) / half_w + 0.5f, 0.0f, 1.0f);
  if (t_ratio != t_ratio) t_ratio = 1.0f;  // nan_to_num(nan=1.0)
  const bool is_changing = changing == 1;
  if (is_changing && ((lod_id == higher_lod + 1 && t_ratio == 0.0f) ||
                      (lod_id == higher_lod && t_ratio == 1.0f)))
    valid = false;
  const float alpha_mul =
      is_changing ? (lod_id != higher_lod ? t_ratio : 1.0f - t_ratio) : 1.0f;

  // projection (gswt.wgsl:152-167)
  auto apply = [&](int m, int r, float x, float y, float z) {
    return u.f(m + 4 * r) * x + u.f(m + 4 * r + 1) * y +
           u.f(m + 4 * r + 2) * z + u.f(m + 4 * r + 3);
  };
  const float vx = apply(word.view, 0, cx_n, cy_n, cz_n);
  const float vy = apply(word.view, 1, cx_n, cy_n, cz_n);
  const float vz = apply(word.view, 2, cx_n, cy_n, cz_n);
  const float p0 = apply(word.proj_wgpu, 0, vx, vy, vz);
  const float p1 = apply(word.proj_wgpu, 1, vx, vy, vz);
  const float p2 = apply(word.proj_wgpu, 2, vx, vy, vz);
  const float p3 = apply(word.proj_wgpu, 3, vx, vy, vz);
  const float clip = 1.2f * p3;
  if (p2 < -clip || p0 < -clip || p0 > clip || p1 < -clip || p1 > clip)
    valid = false;

  // covariance (gswt.wgsl:169-205)
  float va, vb, vc2, vd, ve, vf;
  if (a.point_cloud) {
    float p_r = 1.0f * u.f(word.point_cloud_radius);
    if (a.draw_mode > 0) p_r = p_r * ldexpf(1.0f, tile_lod);
    va = p_r; vb = 0.0f * p_r; vc2 = 0.0f * p_r;
    vd = p_r; ve = 0.0f * p_r; vf = p_r;
  } else {
    va = row[3]; vb = row[4]; vc2 = row[5];
    vd = row[6]; ve = row[7]; vf = row[8];
  }
  if constexpr (kSurface > 0) {
    const float f00 = fr.xx, f01 = fr.yx, f02 = fr.zx;
    const float f10 = fr.xy, f11 = fr.yy, f12 = fr.zy;
    const float f20 = fr.xz, f21 = fr.yz, f22 = fr.zz;
    const float w00 = f00 * va + f01 * vb + f02 * vc2;
    const float w01 = f00 * vb + f01 * vd + f02 * ve;
    const float w02 = f00 * vc2 + f01 * ve + f02 * vf;
    const float w10 = f10 * va + f11 * vb + f12 * vc2;
    const float w11 = f10 * vb + f11 * vd + f12 * ve;
    const float w12 = f10 * vc2 + f11 * ve + f12 * vf;
    const float w20 = f20 * va + f21 * vb + f22 * vc2;
    const float w21 = f20 * vb + f21 * vd + f22 * ve;
    const float w22 = f20 * vc2 + f21 * ve + f22 * vf;
    va = w00 * f00 + w01 * f01 + w02 * f02;
    vb = w00 * f10 + w01 * f11 + w02 * f12;
    vc2 = w00 * f20 + w01 * f21 + w02 * f22;
    vd = w10 * f10 + w11 * f11 + w12 * f12;
    ve = w10 * f20 + w11 * f21 + w12 * f22;
    vf = w20 * f20 + w21 * f21 + w22 * f22;
  }
  va = va * ssc0 * ssc0;
  vb = vb * ssc0 * ssc1;
  vc2 = vc2 * ssc0 * ssc2;
  vd = vd * ssc1 * ssc1;
  ve = ve * ssc1 * ssc2;
  vf = vf * ssc2 * ssc2;

  // EWA Jacobian (gswt.wgsl:207-245)
  auto r3 = [&](int r, int c) { return u.f(word.view + 4 * r + c); };
  const float tx3 = r3(0, 0) * dxc + r3(0, 1) * dyc + r3(0, 2) * dzc;
  const float ty3 = r3(1, 0) * dxc + r3(1, 1) * dyc + r3(1, 2) * dzc;
  const float tz3 = r3(2, 0) * dxc + r3(2, 1) * dyc + r3(2, 2) * dzc;
  const float limx = 1.3f * u.f(word.htan_fov);
  const float limy = 1.3f * u.f(word.htan_fov + 1);
  const float txc = clampf(tx3 / tz3, -limx, limx) * tz3;
  const float tyc = clampf(ty3 / tz3, -limy, limy) * tz3;
  const float tz2 = tz3 * tz3;
  const float fx = u.f(word.focal), fy = u.f(word.focal + 1);
  const float j00 = fx / tz3;
  const float j20 = -fx * txc / tz2;
  const float j11 = fy / tz3;
  const float j21 = -fy * tyc / tz2;
  const float t0x = r3(0, 0) * j00 + r3(2, 0) * j20;
  const float t0y = r3(0, 1) * j00 + r3(2, 1) * j20;
  const float t0z = r3(0, 2) * j00 + r3(2, 2) * j20;
  const float t1x = r3(1, 0) * j11 + r3(2, 0) * j21;
  const float t1y = r3(1, 1) * j11 + r3(2, 1) * j21;
  const float t1z = r3(1, 2) * j11 + r3(2, 2) * j21;
  auto quad = [&](float ax, float ay, float az, float bx, float by, float bz) {
    return ax * (va * bx + vb * by + vc2 * bz) +
           ay * (vb * bx + vd * by + ve * bz) +
           az * (vc2 * bx + ve * by + vf * bz);
  };
  const float c00 = quad(t0x, t0y, t0z, t0x, t0y, t0z);
  const float c01 = quad(t0x, t0y, t0z, t1x, t1y, t1z);
  const float c11 = quad(t1x, t1y, t1z, t1x, t1y, t1z);

  const float mid2 = 0.5f * (c00 + c11);
  const float hd = 0.5f * (c00 - c11);
  const float radius = sqrtf(hd * hd + c01 * c01);
  const float lam1 = mid2 + radius;
  const float lam2 = mid2 - radius;
  if (lam2 < 0.0f) valid = false;
  float dgx = c01;
  float dgy = lam1 - c00;
  const float dn = sqrtf(dgx * dgx + dgy * dgy);
  const float dns = dn == 0.0f ? 1.0f : dn;
  if (dn > 0.0f) {
    dgx = dgx / dns;
    dgy = dgy / dns;
  }
  const float len1 = clamp_max(sqrtf(2.0f * clamp_min(lam1, 0.0f)), 1024.0f);
  const float len2 = clamp_max(sqrtf(2.0f * clamp_min(lam2, 0.0f)), 1024.0f);
  const float sscale = u.f(word.splat_scale);
  const float maj_x = len1 * dgx * sscale;
  const float maj_y = len1 * dgy * sscale;
  const float min_x = len2 * dgy * sscale;
  const float min_y = -len2 * dgx * sscale;

  // colour + debug modes + lod alpha + near fade
  if (a.draw_mode != 0)
    draw_mode_colour(a.draw_mode, kSurface == 2, tw, &cr, &cg, &cb, pos_x,
                     pos_y, doff_x, doff_y, tile_lod, lod_id, single,
                     is_changing, t_ratio, view_id, single_lod, tile_id);
  ca = ca * alpha_mul;
  const float fade = clampf(p2 / p3 + 1.0f, 0.0f, 1.0f);
  cr = cr * fade;
  cg = cg * fade;
  cb = cb * fade;
  ca = ca * fade;

  // NDC -> pixel space
  const float z_ndc = p2 / p3;
  const float cx_px = (p0 / p3 * 0.5f + 0.5f) * (float)a.img_w;
  const float cy_px = (0.5f - p1 / p3 * 0.5f) * (float)a.img_h;
  if (!(z_ndc >= 0.0f && z_ndc <= 1.0f)) valid = false;

  // exponent coefficients over pixel coords (y-down: flip axis y)
  const float mjx = maj_x, mjy = -maj_y;
  const float mnx = min_x, mny = -min_y;
  const float m2 = mjx * mjx + mjy * mjy;
  const float n2 = mnx * mnx + mny * mny;
  if (!(m2 > 0.0f && n2 > 0.0f)) valid = false;
  const float m2s = m2 == 0.0f ? 1.0f : m2;
  const float n2s = n2 == 0.0f ? 1.0f : n2;
  const float m4 = m2s * m2s, n4 = n2s * n2s;
  const float q_a = 4.0f * (mjx * mjx / m4 + mnx * mnx / n4);
  const float q_b = 4.0f * (mjx * mjy / m4 + mnx * mny / n4);
  const float q_c = 4.0f * (mjy * mjy / m4 + mny * mny / n4);
  const float ext_x = sqrtf(mjx * mjx + mnx * mnx);
  const float ext_y = sqrtf(mjy * mjy + mny * mny);
  if (!(isfinite(cx_px) && isfinite(cy_px) && isfinite(q_a) &&
        isfinite(q_b) && isfinite(q_c)))
    valid = false;

  if (!valid) {
    dead();
    return;
  }
  float* o = a.out + s;
  o[ROW_CX * s_n] = cx_px;
  o[ROW_CY * s_n] = cy_px;
  o[ROW_QA * s_n] = q_a;
  o[ROW_QB * s_n] = q_b;
  o[ROW_QC * s_n] = q_c;
  o[ROW_Z * s_n] = z_ndc;
  o[ROW_R * s_n] = cr;
  o[ROW_G * s_n] = cg;
  o[ROW_B * s_n] = cb;
  o[ROW_A * s_n] = ca;
  o[ROW_EXT_X * s_n] = ext_x;
  o[ROW_EXT_Y * s_n] = ext_y;
  a.valid[s] = 1;
}

template <int kSurface, int kHeight>
cudaError_t launch(const ProjectArgs& a, size_t smem, cudaStream_t stream) {
  project_kernel<kSurface, kHeight>
      <<<(unsigned)a.nb, kBlock, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// surface: 0 flat, 1 height map, 2 sphere; height_path (surface 1): 0 exact
// 5-tap, 1 fast patch, 2 fast small source map
extern "C" int gswt_project(const ProjectArgs* args, int surface,
                            int height_path, void* stream) {
  if (args->nb <= 0) return (int)cudaGetLastError();
  if (args->n_uniforms > kBlock) return (int)cudaErrorInvalidValue;
  const ProjectArgs& p = *args;
  const cudaStream_t st = (cudaStream_t)stream;
  if (surface == 0) return (int)launch<0, 0>(p, 0, st);
  if (surface == 2) return (int)launch<2, 0>(p, 0, st);
  if (surface != 1) return (int)cudaErrorInvalidValue;
  if (height_path == 0) return (int)launch<1, 0>(p, 0, st);
  if (height_path == 1) return (int)launch<1, 1>(p, 0, st);
  if (height_path != 2) return (int)cudaErrorInvalidValue;
  const int n = args->src_w * args->src_h;
  const size_t smem = n <= kSmapMax ? (size_t)n * sizeof(float) : 0;
  return (int)launch<1, 2>(p, smem, st);
}
