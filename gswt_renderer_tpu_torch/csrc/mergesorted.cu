// Merge of two ascending key + payload tables, one thread block per output
// block, and the merge-path split that cuts the work into those blocks.
//
// Replaces the Pallas kernel _merge_kernel
// (benchmarks/mergesorted.py:88, pallas_call at :227, reached through
// merge_sorted_pair :146 and merge_sorted :236) and the XLA-level binary
// search merge_path_splits (:52). Tables are [R, N] 32-bit words, row-major;
// row 0 holds i32 keys (they travel bit-cast as f32), ascending; the other
// rows are payload that follows its key. INT32_MAX is the padding sentinel.
//
//   out[:, m] = the m-th column of the merge of A and B,  m < Na + Nb
//   out[0, m] = INT32_MAX, out[1:, m] = 0                 m >= Na + Nb
//
// with No = ceil((Na + Nb) / block) * block output columns. Equal keys (only
// sentinels of an earlier round's tail, whose payload is zero) order B first,
// the rule merge_path_splits' strict comparison implies.
//
// What does not cross from the TPU kernel: its 128-lane aligned and widened
// windows, the pre-flipped copy of B, the power-of-two bitonic window with a
// sentinel gap, the rotate that excises the block, payload rows padded to 8.
// A thread block here reads exactly the `block` columns it merges.
//
// Bound: bytes. Every input word is read once and every output word written
// once: 4 B * R * (Na + Nb + No) over the card's 3.35 TB/s; the compares
// (log2(block) per key) are a minor term.
// Design: split kernel, one thread per block boundary m = b * block: the
// count of A columns among the first m merged, by binary search over the
// diagonal (log2(Na) dependent loads per thread, n_blocks + 1 threads).
// Merge kernel, one CTA per output block: it stages its A range and its B
// range (together at most `block` keys) in shared memory; each thread ranks
// its keys by a binary search in the OTHER range (rank = own index + count of
// the other range's keys that go first) and writes the staged index to that
// rank; then every row is written in rank order, neighbouring threads on
// neighbouring output words, reading the source column through the index.
// Consecutive ranks read ascending columns of A or of B, so a warp's loads
// fall into two short contiguous runs. Payload rows are gathered from global
// memory rather than staged: keys + indices are 8 B per column of shared
// memory (16 KiB at block 2048), whatever R is. Words move raw (unsigned), so
// payload bit patterns (NaNs included) survive.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSentinel = 0x7FFFFFFF;

__device__ __forceinline__ long long min_ll(long long a, long long b) {
  return a < b ? a : b;
}

// A columns among the first m merged columns: the largest ia in
// [max(0, m - nb), min(m, na)] with ka[ia - 1] < kb[m - ia].
__device__ long long merge_split(const int* __restrict__ ka, long long na,
                                 const int* __restrict__ kb, long long nb,
                                 long long m) {
  long long lo = m > nb ? m - nb : 0;
  long long hi = min_ll(m, na);
  while (lo < hi) {
    const long long mid = (lo + hi + 1) / 2;
    // taking `mid` columns from A is feasible iff the last of them is below
    // the first column left in B (or B is used up)
    const bool feasible = m - mid >= nb || ka[mid - 1] < kb[m - mid];
    if (feasible) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__global__ void merge_splits_kernel(const int* __restrict__ ka, long long na,
                                    const int* __restrict__ kb, long long nb,
                                    long long block, int n_bounds,
                                    int* __restrict__ splits) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_bounds) return;
  splits[b] = (int)merge_split(ka, na, kb, nb, min_ll(b * block, na + nb));
}

// splits: [n_blocks + 1], the A count at every block boundary (the last one
// at min(n_blocks * block, na + nb)).
__global__ void __launch_bounds__(kThreads)
merge_kernel(const uint32_t* __restrict__ ta, long long na,
             const uint32_t* __restrict__ tb, long long nb,
             const int* __restrict__ splits, uint32_t* __restrict__ out,
             long long no, int rows, int block) {
  extern __shared__ int s_mem[];
  int* s_key = s_mem;          // [block] the A range's keys, then the B range's
  int* s_src = s_mem + block;  // [block] staged index of the column at a rank

  const long long g = blockIdx.x;
  const long long m0 = g * block;
  const long long m1 = min_ll(m0 + block, na + nb);
  const long long a0 = splits[g];
  const long long b0 = m0 - a0;
  const int n_a = (int)(splits[g + 1] - a0);
  const int n = (int)(m1 - m0);  // columns merged here; the rest is tail

  for (int i = threadIdx.x; i < n; i += kThreads)
    s_key[i] = i < n_a ? (int)ta[a0 + i] : (int)tb[b0 + (i - n_a)];
  __syncthreads();

  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int key = s_key[i];
    int lo, hi;
    if (i < n_a) {
      // an A column: B columns with key <= this one go first
      lo = n_a; hi = n;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_key[mid] <= key) lo = mid + 1; else hi = mid;
      }
      s_src[i + (lo - n_a)] = i;
    } else {
      // a B column: A columns with key < this one go first
      lo = 0; hi = n_a;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_key[mid] < key) lo = mid + 1; else hi = mid;
      }
      s_src[(i - n_a) + lo] = i;
    }
  }
  __syncthreads();

  for (int j = threadIdx.x; j < block; j += kThreads) {
    uint32_t* o = out + m0 + j;
    if (j >= n) {
      o[0] = (uint32_t)kSentinel;
      for (int r = 1; r < rows; ++r) o[r * no] = 0u;
      continue;
    }
    const int i = s_src[j];
    o[0] = (uint32_t)s_key[i];
    const uint32_t* src;
    long long ld;
    if (i < n_a) { src = ta + a0 + i; ld = na; }
    else { src = tb + b0 + (i - n_a); ld = nb; }
    for (int r = 1; r < rows; ++r) o[r * no] = src[r * ld];
  }
}

}  // namespace

// splits[b] for b in [0, n_bounds): A columns among the first
// min(b * block, na + nb) merged columns.
extern "C" int gswt_merge_splits(const void* ka, long long na, const void* kb,
                                 long long nb, long long block, int n_bounds,
                                 void* splits, void* stream) {
  if (block <= 0) return (int)cudaErrorInvalidValue;
  if (n_bounds > 0) {
    merge_splits_kernel<<<(n_bounds + 127) / 128, 128, 0,
                          (cudaStream_t)stream>>>(
        (const int*)ka, na, (const int*)kb, nb, block, n_bounds, (int*)splits);
  }
  return (int)cudaGetLastError();
}

// ta [rows, na], tb [rows, nb], splits [no / block + 1], out [rows, no] with
// no a multiple of block.
extern "C" int gswt_merge_pair(const void* ta, long long na, const void* tb,
                               long long nb, const void* splits, void* out,
                               long long no, int rows, int block,
                               void* stream) {
  const size_t smem = (size_t)block * 2 * sizeof(int);
  if (block <= 0 || smem > 48 * 1024 || rows < 1 || no % block)
    return (int)cudaErrorInvalidValue;
  if (no > 0) {
    merge_kernel<<<(unsigned)(no / block), kThreads, smem,
                   (cudaStream_t)stream>>>(
        (const uint32_t*)ta, na, (const uint32_t*)tb, nb, (const int*)splits,
        (uint32_t*)out, no, rows, block);
  }
  return (int)cudaGetLastError();
}
