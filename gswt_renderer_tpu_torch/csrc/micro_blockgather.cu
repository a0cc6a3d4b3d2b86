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
// Strided, shared with blockgather.cu: raw 16-byte words (uint4), never float
// arithmetic; neighbouring threads on neighbouring addresses; one CTA per
// output block moves K rows of 64 vectors, a row being a separate 1 KiB run
// in both tables.
// Contiguous: the copy never passes through registers. A panel (K * B words,
// 16 KiB at K = 16) is moved in pieces of up to 16 KiB by the Tensor Memory
// Accelerator: one thread issues a 1-D bulk copy (cp.async.bulk) of a piece
// into a ring of S stages of shared memory, completing on the stage's
// mbarrier, then a bulk copy of the stage back out to the output, and reuses
// the stage only once that store has finished reading it
// (cp.async.bulk.wait_group.read). The ring keeps S - 1 loads and one store
// in flight per CTA. One CTA walks `group` output panels (the TPU kernel's
// copies in flight per grid step); it need not divide the panel count. An
// id outside the table skips the copies: the CTA's threads write that
// panel's zeros themselves, before the ring starts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlock = 256;       // block width in columns
constexpr int kVec = kBlock / 4;  // 16-byte vectors per block row

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

constexpr int kCopyThreads = 32;           // one warp: its lane 0 drives the ring
constexpr int kPieceBytes = 16 << 10;      // largest bulk copy
constexpr int kMaxStages = 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// the output panels [first, last) of this CTA, as a sequence of pieces of
// the panels whose id is in the table
struct Pieces {
  const int* src;
  long long n_panels, b, last;
  int piece, per_panel;
  __device__ void skip() {  // to the next piece of an in-range panel
    while (b < last && (src[b] < 0 || src[b] >= n_panels)) ++b;
  }
  __device__ bool more() const { return b < last; }
  __device__ void next() {
    if (++piece == per_panel) {
      piece = 0;
      ++b;
      skip();
    }
  }
};

__global__ void __launch_bounds__(kCopyThreads)
contig_kernel(const char* __restrict__ table, long long n_panels,
              const int* __restrict__ src, char* __restrict__ out,
              long long n_out, long long panel_bytes, int piece_bytes,
              int stages, int group) {
  extern __shared__ __align__(128) char s_ring[];
  __shared__ __align__(8) uint64_t s_bar[kMaxStages];
  const long long first = (long long)blockIdx.x * group;
  const long long last = first + group < n_out ? first + group : n_out;

  // ids outside the table: zeros, written by the threads
  for (long long b = first; b < last; ++b) {
    if (src[b] >= 0 && src[b] < n_panels) continue;
    uint4* o = (uint4*)(out + b * panel_bytes);
    for (long long i = threadIdx.x; i < panel_bytes / 16; i += kCopyThreads)
      o[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (threadIdx.x != 0) return;

  const int per_panel = (int)((panel_bytes + piece_bytes - 1) / piece_bytes);
  for (int s = 0; s < stages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_addr(&s_bar[s]))
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  auto load = [&](const Pieces& c, int s) {
    const long long off = (long long)c.piece * piece_bytes;
    const uint32_t bytes = (uint32_t)min((long long)piece_bytes,
                                         panel_bytes - off);
    const uint32_t bar = smem_addr(&s_bar[s]);
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(bytes)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(s_ring + s * piece_bytes)),
        "l"(table + (long long)c.src[c.b] * panel_bytes + off), "r"(bytes),
        "r"(bar)
        : "memory");
  };

  Pieces ld{src, n_panels, first, last, 0, per_panel};
  ld.skip();
  Pieces st = ld;
  // the prologue fills the ring; piece q then goes out of stage q % S, and
  // the stage the store before it read is refilled with piece q - 1 + S (S
  // = 1: the stage just stored from is refilled with piece q + 1)
  const int lag = stages > 1 ? 1 : 0;
  for (int s = 0; s < stages && ld.more(); ++s, ld.next()) load(ld, s);
  for (int q = 0; st.more(); ++q, st.next()) {
    const int s = q % stages;
    bar_wait(smem_addr(&s_bar[s]), (uint32_t)((q / stages) & 1));
    const long long off = (long long)st.piece * piece_bytes;
    const uint32_t bytes = (uint32_t)min((long long)piece_bytes,
                                         panel_bytes - off);
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
            out + st.b * panel_bytes + off),
        "r"(smem_addr(s_ring + s * piece_bytes)), "r"(bytes)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    if (q >= lag && ld.more()) {
      if (lag)
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      else
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      load(ld, (q - lag) % stages);
      ld.next();
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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

// table [n_panels, panel_words] f32, src [n_out] i32, out [n_out, panel_words];
// table and out 16-B aligned (the bulk copies move 16-B aligned runs)
extern "C" int gswt_micro_gather_contig(const void* table, long long n_panels,
                                        const void* src, long long n_out,
                                        void* out, int panel_words, int group,
                                        void* stream) {
  if (panel_words < 4 || panel_words % 4 || group < 1 ||
      (uintptr_t)table % 16 || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  if (n_out > 0) {
    const long long panel_bytes = 4LL * panel_words;
    const int piece = (int)(panel_bytes < kPieceBytes ? panel_bytes
                                                       : kPieceBytes);
    const long long per_cta =
        (long long)group * ((panel_bytes + piece - 1) / piece);
    const int stages = (int)(per_cta < kMaxStages ? per_cta : kMaxStages);
    const int smem = stages * piece;
    cudaError_t err = cudaFuncSetAttribute(
        contig_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const long long grid = (n_out + group - 1) / group;
    contig_kernel<<<(unsigned)grid, kCopyThreads, smem,
                    (cudaStream_t)stream>>>(
        (const char*)table, n_panels, (const int*)src, (char*)out, n_out,
        panel_bytes, piece, stages, group);
  }
  return (int)cudaGetLastError();
}
