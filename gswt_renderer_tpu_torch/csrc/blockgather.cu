// Block-panel gather: out[:, b*256:(b+1)*256] = src_table(b)[:, s*256:(s+1)*256]
// where s = src[b] indexes the concatenation [panels | scratch].
//
// Replaces the Pallas kernel gswt_renderer_tpu/ops/blockgather.py:25
// (block_gather; its pallas_call sites are :87 on the TPU and :50 in
// interpret mode), which copies 256-column panels of a [16, N] table by DMA.
//
// Bound: pure data movement, 2 * 16 rows * 4 B * NB * 256 bytes (every
// output panel read once and written once) over the card's 3.35 TB/s.
// Design: one thread block per output panel; its 256 threads move the
// panel's 16 x 256 words as 1024 16-byte vectors, neighbouring threads on
// neighbouring addresses, so every load and store is a full 128-byte line.
// The words are copied raw (uint4), never through float arithmetic: rows 9-11
// hold bit-cast u32/i32 payload (rgba, gs|lod<<26, map id) whose patterns may
// be NaNs or denormals. Taking the merged scratch as a second source removes
// the per-frame concatenation [panels | scratch], which would copy the whole
// panel table every frame.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;            // panel width in columns
constexpr int kVec = kBlock / 4;       // 16-byte vectors per panel row

__global__ void block_gather_kernel(const uint4* __restrict__ panels,
                                    long long panel_cols,
                                    const uint4* __restrict__ scratch,
                                    long long scratch_cols,
                                    const int* __restrict__ src,
                                    uint4* __restrict__ out, long long out_cols,
                                    int rows) {
  const long long b = blockIdx.x;
  const long long s = src[b];
  const long long n_panel_blocks = panel_cols / kBlock;
  const uint4* base;
  long long ld, col;
  if (s < n_panel_blocks) {
    base = panels;
    ld = panel_cols / 4;
    col = s * kVec;
  } else {
    base = scratch;
    ld = scratch_cols / 4;
    col = (s - n_panel_blocks) * kVec;
  }
  const bool in_range = s >= 0 && s < n_panel_blocks + scratch_cols / kBlock;
  const long long out_ld = out_cols / 4;
  for (int i = threadIdx.x; i < rows * kVec; i += blockDim.x) {
    const int r = i / kVec;
    const int c = i % kVec;
    // the stager guarantees ids in range; an id outside writes zeros
    // instead of reading out of bounds
    out[r * out_ld + b * kVec + c] =
        in_range ? base[r * ld + col + c] : make_uint4(0u, 0u, 0u, 0u);
  }
}

}  // namespace

extern "C" int gswt_block_gather(const void* panels, long long panel_cols,
                                 const void* scratch, long long scratch_cols,
                                 const void* src, long long n_blocks,
                                 void* out, int rows, void* stream) {
  if (n_blocks > 0) {
    block_gather_kernel<<<(unsigned)n_blocks, 256, 0, (cudaStream_t)stream>>>(
        (const uint4*)panels, panel_cols, (const uint4*)scratch, scratch_cols,
        (const int*)src, (uint4*)out, n_blocks * kBlock, rows);
  }
  return (int)cudaGetLastError();
}
