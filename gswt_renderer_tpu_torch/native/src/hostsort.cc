// Native host runtime for gswt_renderer_tpu: the per-frame host-side hot
// paths of the reference renderer, re-implemented in C++ and exposed through
// a C ABI consumed via ctypes.
//
// - depth_keys + counting_sort_self: scene.rs:514-584 (16-bit single-pass
//   counting sort over 65,536 buckets; depth key = (vp_z . pos) * 4096 as i32,
//   stable ascending scatter then reversed for back-to-front order)
// - counting_sort_merge: scene.rs:655-698 (k-way merge of precomputed per-view
//   raw depth vectors into one globally sorted (segment, index) list) — the
//   per-frame hot path for merged tile groups.
//
// Rust `as i32` float casts saturate and map NaN to 0; replicated here.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

namespace {

constexpr int kBuckets = 256 * 256;  // scene.rs:557

inline int32_t f32_to_i32_saturate(float v) {
  if (std::isnan(v)) return 0;
  if (v >= 2147483647.0f) return INT32_MAX;
  if (v <= -2147483648.0f) return INT32_MIN;
  return static_cast<int32_t>(v);  // trunc toward zero, as Rust `as i32`
}

}  // namespace

extern "C" {

// Compute raw depth keys for n splats with packed 32-byte rows (stride 8 f32).
// vp_z = {vp[2], vp[6], vp[10]} — the z row of the view-projection matrix.
void gswt_depth_keys(const float* f_buffer, int64_t n, const float* vp_z,
                     int32_t* raw_depth_out) {
  const float zx = vp_z[0], zy = vp_z[1], zz = vp_z[2];
  for (int64_t i = 0; i < n; ++i) {
    const float* p = f_buffer + 8 * i;
    float d = (zx * p[0] + zy * p[1] + zz * p[2]) * 4096.0f;
    raw_depth_out[i] = f32_to_i32_saturate(d);
  }
}

// Stable 16-bit counting sort of raw depths, reversed (back-to-front).
// Writes sorted original indices to depth_index_out. scene.rs:537-583.
void gswt_counting_sort(const int32_t* raw_depth, int64_t n,
                        uint32_t* depth_index_out) {
  if (n <= 0) return;
  int32_t min_d = raw_depth[0], max_d = raw_depth[0];
  for (int64_t i = 1; i < n; ++i) {
    int32_t d = raw_depth[i];
    if (d < min_d) min_d = d;
    if (d > max_d) max_d = d;
  }
  // depth_inv = 65535 / (max - min); if max == min every key lands in
  // bucket 0 (Rust: 0 * inf = NaN -> floor -> `as i32` -> 0).
  const float range = static_cast<float>(max_d - min_d);
  const float inv = (max_d == min_d) ? 0.0f : (kBuckets - 1) / range;

  std::vector<uint32_t> counts(kBuckets, 0);
  std::vector<int32_t> bucket(n);
  for (int64_t i = 0; i < n; ++i) {
    int32_t b = f32_to_i32_saturate(
        std::floor(static_cast<float>(raw_depth[i] - min_d) * inv));
    if (b < 0) b = 0;
    if (b >= kBuckets) b = kBuckets - 1;
    bucket[i] = b;
    counts[b]++;
  }
  std::vector<uint32_t> starts(kBuckets, 0);
  for (int b = 1; b < kBuckets; ++b) starts[b] = starts[b - 1] + counts[b - 1];
  for (int64_t i = 0; i < n; ++i) {
    depth_index_out[starts[bucket[i]]++] = static_cast<uint32_t>(i);
  }
  // reverse for back-to-front (scene.rs:581)
  for (int64_t i = 0, j = n - 1; i < j; ++i, --j) {
    uint32_t t = depth_index_out[i];
    depth_index_out[i] = depth_index_out[j];
    depth_index_out[j] = t;
  }
}

// k-way merge sort of concatenated per-segment raw depths (scene.rs:655-698).
// raw_depth: concatenation of all segments; seg_displ: k+1 prefix offsets.
// Outputs, back-to-front: seg_id_out[i] (which segment) and idx_out[i]
// (index within that segment).
void gswt_counting_sort_merge(const int32_t* raw_depth, const int64_t* seg_displ,
                              int64_t n_segs, uint32_t* seg_id_out,
                              uint32_t* idx_out) {
  const int64_t n = seg_displ[n_segs];
  if (n <= 0) return;
  int32_t min_d = raw_depth[0], max_d = raw_depth[0];
  for (int64_t i = 1; i < n; ++i) {
    int32_t d = raw_depth[i];
    if (d < min_d) min_d = d;
    if (d > max_d) max_d = d;
  }
  const float range = static_cast<float>(max_d - min_d);
  const float inv = (max_d == min_d) ? 0.0f : (kBuckets - 1) / range;

  std::vector<uint32_t> counts(kBuckets, 0);
  std::vector<int32_t> bucket(n);
  for (int64_t i = 0; i < n; ++i) {
    int32_t b = f32_to_i32_saturate(
        std::floor(static_cast<float>(raw_depth[i] - min_d) * inv));
    if (b < 0) b = 0;
    if (b >= kBuckets) b = kBuckets - 1;
    bucket[i] = b;
    counts[b]++;
  }
  std::vector<uint32_t> starts(kBuckets, 0);
  for (int b = 1; b < kBuckets; ++b) starts[b] = starts[b - 1] + counts[b - 1];

  // scatter in segment-major input order (stable), like the reference's
  // nested loop over (scene_id, i) (scene.rs:686-694)
  for (int64_t s = 0; s < n_segs; ++s) {
    for (int64_t i = seg_displ[s]; i < seg_displ[s + 1]; ++i) {
      uint32_t j = starts[bucket[i]]++;
      seg_id_out[j] = static_cast<uint32_t>(s);
      idx_out[j] = static_cast<uint32_t>(i - seg_displ[s]);
    }
  }
  // reverse (scene.rs:695)
  for (int64_t i = 0, j = n - 1; i < j; ++i, --j) {
    uint32_t t = seg_id_out[i];
    seg_id_out[i] = seg_id_out[j];
    seg_id_out[j] = t;
    t = idx_out[i];
    idx_out[i] = idx_out[j];
    idx_out[j] = t;
  }
}

// Gather u32 rows: out[i] = base[offsets[seg_id[i]] + idx[i]]; used to turn
// merge-sort results into flat gs_index streams (wangtile.rs:651-657).
void gswt_gather_offset_u32(const uint32_t* base, const uint32_t* seg_id,
                            const uint32_t* idx, const uint32_t* offsets,
                            int64_t n, uint32_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = base[offsets[seg_id[i]] + idx[i]];
  }
}

// Lookup per-pair values: out[i] = table[seg_id[i]]; for gs_lod_id/gs_map_id.
void gswt_lookup_u32(const uint32_t* table, const uint32_t* seg_id, int64_t n,
                     uint32_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = table[seg_id[i]];
}

// Painter's-order toposort (wangtile.rs:1115-1218): Kahn over the tile DAG
// with deterministic cycle removal (lowest-index remaining node). Emits, in
// FINAL order (already reversed, back-to-front): removed cycle nodes first,
// then the reversed topological order of nodes that have at least one edge.
// edge_a/edge_b: directed edges a->b (deduplicated or not; duplicates are
// handled). nodes: the active node ids. Returns number of entries in out.
int64_t gswt_toposort(const int32_t* edge_a, const int32_t* edge_b,
                      int64_t n_edges, const int32_t* nodes, int64_t n_nodes,
                      int32_t max_index, int32_t* out) {
  std::vector<int32_t> node_pos(max_index + 1, -1);
  for (int64_t i = 0; i < n_nodes; ++i) node_pos[nodes[i]] = (int32_t)i;

  // dedupe edges with a hash-free pass: CSR by source, then unique per row
  std::vector<int32_t> out_deg(n_nodes, 0);
  std::vector<int64_t> keep_edge;
  keep_edge.reserve(n_edges);
  {
    // mark duplicates via sort of (a,b)
    std::vector<int64_t> idx(n_edges);
    for (int64_t i = 0; i < n_edges; ++i) idx[i] = i;
    std::sort(idx.begin(), idx.end(), [&](int64_t x, int64_t y) {
      if (edge_a[x] != edge_a[y]) return edge_a[x] < edge_a[y];
      return edge_b[x] < edge_b[y];
    });
    for (int64_t k = 0; k < n_edges; ++k) {
      int64_t i = idx[k];
      if (k > 0) {
        int64_t p = idx[k - 1];
        if (edge_a[p] == edge_a[i] && edge_b[p] == edge_b[i]) continue;
      }
      keep_edge.push_back(i);
    }
  }
  std::vector<int32_t> indeg(n_nodes, 0);
  std::vector<bool> has_edge(n_nodes, false);
  for (int64_t e : keep_edge) {
    int32_t pa = node_pos[edge_a[e]];
    int32_t pb = node_pos[edge_b[e]];
    if (pa < 0 || pb < 0) continue;
    out_deg[pa]++;
    indeg[pb]++;
    has_edge[pa] = has_edge[pb] = true;
  }
  std::vector<int64_t> row(n_nodes + 1, 0);
  for (int64_t i = 0; i < n_nodes; ++i) row[i + 1] = row[i] + out_deg[i];
  std::vector<int32_t> adj(keep_edge.size());
  std::vector<int64_t> fill(row.begin(), row.end() - 1);
  for (int64_t e : keep_edge) {
    int32_t pa = node_pos[edge_a[e]];
    int32_t pb = node_pos[edge_b[e]];
    if (pa < 0 || pb < 0) continue;
    adj[fill[pa]++] = pb;
  }

  std::vector<char> alive(n_nodes, 1);
  std::vector<int32_t> order;
  order.reserve(n_nodes);
  std::vector<int32_t> removed;
  std::vector<int32_t> queue;
  queue.reserve(n_nodes);
  for (int64_t i = 0; i < n_nodes; ++i)
    if (indeg[i] == 0) queue.push_back((int32_t)i);
  size_t qh = 0;
  int64_t emitted = 0;
  int64_t scan_from = 0;
  while (emitted < n_nodes) {
    while (qh < queue.size()) {
      int32_t u = queue[qh++];
      if (!alive[u]) continue;
      alive[u] = 0;
      ++emitted;
      order.push_back(u);
      for (int64_t k = row[u]; k < row[u + 1]; ++k) {
        int32_t v = adj[k];
        if (alive[v] && --indeg[v] == 0) queue.push_back(v);
      }
    }
    if (emitted < n_nodes) {
      // cycle: remove the lowest-index remaining node
      while (scan_from < n_nodes && !alive[scan_from]) ++scan_from;
      int32_t victim = (int32_t)scan_from;
      alive[victim] = 0;
      ++emitted;
      removed.push_back(victim);
      for (int64_t k = row[victim]; k < row[victim + 1]; ++k) {
        int32_t v = adj[k];
        if (alive[v] && --indeg[v] == 0) queue.push_back(v);
      }
    }
  }
  // final order: removed (in removal order, reversed among themselves by the
  // global reverse) then reversed topo order of edged nodes
  int64_t n_out = 0;
  for (int64_t i = (int64_t)removed.size() - 1; i >= 0; --i)
    out[n_out++] = nodes[removed[i]];
  for (int64_t i = (int64_t)order.size() - 1; i >= 0; --i)
    if (has_edge[order[i]]) out[n_out++] = nodes[order[i]];
  return n_out;
}

}  // extern "C"
