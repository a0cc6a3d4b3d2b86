// The micro-benchmark's two block gathers: a strided one from a [K, NP]
// table and a block-contiguous one from a [NPB, K * B] panel table.
//
// Replaces the Pallas kernels of benchmarks/micro_blockgather.py:
// pallas_blockgather (:68, pallas_call at :80), a (K, B) block copy per grid
// step through a scalar-prefetched index map, and pallas_bc (:94, pallas_call
// at :115), `group` whole-panel DMAs in flight per grid step.
//
//   strided: out[:, b*256:(b+1)*256] = table[:, s*256:(s+1)*256], s = src[b]
//   contig:  out[b, :] = table[src[b], :]      (one panel = K * B words,
//                                               contiguous: 16 KiB at K = 16)
//
// Bound: bytes, every output word read once and written once, plus the index
// list, over the card's 3.35 TB/s.
// Design, shared with blockgather.cu: raw 16-byte words (uint4), never float
// arithmetic; neighbouring threads on neighbouring addresses. Strided: one
// CTA per output block moves K rows of 64 vectors, a row being a separate
// 1 KiB run in both tables. Contiguous: one CTA per `group` output panels;
// its threads issue all the loads of up to four vectors before the first
// store, so several 16-byte requests are in flight per thread, and a panel is
// one run of K * B / 4 vectors on both sides. `group` only sets how many
// panels a CTA walks (the TPU kernel's copies in flight per grid step); it
// need not divide the panel count.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlock = 256;       // block width in columns
constexpr int kVec = kBlock / 4;  // 16-byte vectors per block row
constexpr int kInFlight = 4;      // vectors a thread loads before it stores

__global__ void __launch_bounds__(kThreads)
strided_kernel(const uint4* __restrict__ table, long long table_cols,
               const int* __restrict__ src, uint4* __restrict__ out,
               long long out_cols, int rows) {
  const long long b = blockIdx.x;
  const long long s = src[b];
  const bool in_range = s >= 0 && s < table_cols / kBlock;
  const long long ld = table_cols / 4;
  const long long out_ld = out_cols / 4;
  for (int i = threadIdx.x; i < rows * kVec; i += kThreads) {
    const int r = i / kVec;
    const int c = i % kVec;
    // an id outside the table writes zeros instead of reading out of bounds
    out[r * out_ld + b * kVec + c] =
        in_range ? table[r * ld + s * kVec + c] : make_uint4(0u, 0u, 0u, 0u);
  }
}

__global__ void __launch_bounds__(kThreads)
contig_kernel(const uint4* __restrict__ table, long long n_panels,
              const int* __restrict__ src, uint4* __restrict__ out,
              long long n_out, int panel_vec, int group) {
  const long long first = (long long)blockIdx.x * group;
  const long long last = first + group < n_out ? first + group : n_out;
  for (long long b = first; b < last; ++b) {
    const long long s = src[b];
    const bool in_range = s >= 0 && s < n_panels;
    const uint4* p = table + s * panel_vec;
    uint4* o = out + b * panel_vec;
    for (int i0 = 0; i0 < panel_vec; i0 += kThreads * kInFlight) {
      uint4 v[kInFlight];
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const int i = i0 + k * kThreads + threadIdx.x;
        v[k] = (in_range && i < panel_vec) ? p[i] : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const int i = i0 + k * kThreads + threadIdx.x;
        if (i < panel_vec) o[i] = v[k];
      }
    }
  }
}

}  // namespace

// table [rows, table_cols] f32, src [n_blocks] i32, out [rows, n_blocks*256]
extern "C" int gswt_micro_gather_strided(const void* table,
                                         long long table_cols, const void* src,
                                         long long n_blocks, void* out,
                                         int rows, void* stream) {
  if (table_cols % kBlock || rows < 1) return (int)cudaErrorInvalidValue;
  if (n_blocks > 0) {
    strided_kernel<<<(unsigned)n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint4*)table, table_cols, (const int*)src, (uint4*)out,
        n_blocks * kBlock, rows);
  }
  return (int)cudaGetLastError();
}

// table [n_panels, panel_words] f32, src [n_out] i32, out [n_out, panel_words]
extern "C" int gswt_micro_gather_contig(const void* table, long long n_panels,
                                        const void* src, long long n_out,
                                        void* out, int panel_words, int group,
                                        void* stream) {
  if (panel_words < 4 || panel_words % 4 || group < 1)
    return (int)cudaErrorInvalidValue;
  if (n_out > 0) {
    const long long grid = (n_out + group - 1) / group;
    contig_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint4*)table, n_panels, (const int*)src, (uint4*)out, n_out,
        panel_words / 4, group);
  }
  return (int)cudaGetLastError();
}
