// Banded pair scoring of one position stream, for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (lime_tpu_torch/ops/
// banded_kernels.py builds and binds this file).
//
// It replaces the Pallas TPU kernel lime_tpu/ops/pallas_kernels.py
// _kernel (called through banded_pair_matrix) together with the
// segment-sum its caller runs on the kernel's output
// (lime_tpu/parallel/sharded.py _scatter_sim).
//
// Input: one byte per position (bit 6 m = the position continues the
// previous one's cluster, bit 5 emit gate, bits 0-3 symbol rank) and an
// int32 document id per position (ids < num_reads are reads, the rest
// genomes).  For every emitting read position i (emit bit set and
// 0 <= doc[i] < num_reads) and every genome partner j in its cluster
// band, within `window` positions before or after it, with the same
// symbol and the same occurrence index, the kernel adds 1 to
// sim[doc[i], doc[j] - num_reads].  occ[i] counts the earlier positions
// of i's cluster, at most `window` back, with i's (doc, symbol).  "Same
// cluster" for i and j = i - o is the AND of m over (i - o, i]; for
// j = i + o it is the AND of m over (i, i + o].  These are the XLA
// formulation's sums (sharded.py banded_partial_sim).
//
// Invariant: within a cluster no longer than the window, occ is unique
// per (document, symbol), so position i has at most one matching partner
// per genome; the Pallas kernel's 0/1 V[i, g] (an OR over offsets) and
// this kernel's per-partner sum agree.  Clusters longer than the window
// are routed to the host scorer by every caller.
//
// What bounds it on the card: each position moves 5 bytes of device
// memory in, and its work is a walk over its cluster band (O(cluster
// length), not O(window) or O(genomes)); the only other traffic is one
// atomic add per matching (read position, genome) pair.  The TPU kernel
// materialised V (n, G_pad) as int8 and its caller scatter-added it by
// read id; here V never exists: the segment-sum is fused as atomics into
// the accumulator, which is what device memory would otherwise carry
// (n x G_pad bytes each way).
// Design: one block scores a TILE of positions from shared memory that
// holds the tile plus a left halo of 2 x 256 (a backward partner's own
// occ needs one more window of history) and a right halo of 256;
// positions outside the stream carry m = 0 and a document id that
// matches nothing, so no state crosses blocks.
//
// int8 accumulators (the reference's uchar counters, wrapping mod 256):
// CUDA has no 8-bit atomicAdd, and adding 1 << 8b to the containing word
// would carry into the neighbouring byte, so the byte wraps inside a
// 32-bit compare-and-swap loop.  The wrapper checks that the accumulator
// is 4-byte aligned with a row stride that is a multiple of 4.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWMax = 256;             // window <= 255
constexpr int kHaloL = 2 * kWMax;      // backward partner's occ lookback
constexpr int kHaloR = kWMax;          // forward partners
constexpr int kTile = 1024;            // positions scored per block
constexpr int kExt = kHaloL + kTile + kHaloR;
constexpr int kThreads = 256;
constexpr int32_t kPadDoc = -0x7FFFFFFF;
constexpr int kMBit = 6;
constexpr int kEmitBit = 5;

__device__ __forceinline__ bool pk_m(uint8_t c) { return (c >> kMBit) & 1; }
__device__ __forceinline__ bool pk_emit(uint8_t c) {
  return (c >> kEmitBit) & 1;
}
__device__ __forceinline__ int pk_sym(uint8_t c) { return c & 15; }

__device__ __forceinline__ void add_one(int32_t* p) { atomicAdd(p, 1); }

__device__ __forceinline__ void add_one(int8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  unsigned int* word = reinterpret_cast<unsigned int*>(a & ~uintptr_t(3));
  const unsigned int shift = (unsigned int)(a & 3) * 8u;
  const unsigned int mask = 0xFFu << shift;
  unsigned int old = *word, assumed;
  do {
    assumed = old;
    const unsigned int byte = (((assumed & mask) >> shift) + 1u) & 0xFFu;
    old = atomicCAS(word, assumed, (assumed & ~mask) | (byte << shift));
  } while (old != assumed);
}

template <typename Acc>
__global__ void __launch_bounds__(kThreads)
banded_sim_kernel(const uint8_t* __restrict__ packed,
                  const int32_t* __restrict__ doc, long long n, int window,
                  int num_reads, int g_cols, Acc* __restrict__ sim,
                  long long row_stride) {
  __shared__ uint8_t s_pk[kExt];
  __shared__ int32_t s_doc[kExt];
  __shared__ uint8_t s_occ[kExt];  // occ <= window <= 255

  const long long t0 = (long long)blockIdx.x * kTile;
  const long long base = t0 - kHaloL;
  for (int k = threadIdx.x; k < kExt; k += kThreads) {
    const long long p = base + k;
    const bool in = p >= 0 && p < n;
    s_pk[k] = in ? packed[p] : 0;
    s_doc[k] = in ? doc[p] : kPadDoc;
  }
  __syncthreads();

  // occ of every position a tile position can pair with: ext [kWMax, kExt)
  for (int k = kWMax + threadIdx.x; k < kExt; k += kThreads) {
    const uint8_t c = s_pk[k];
    const int d = s_doc[k], s = pk_sym(c);
    int occ = 0;
    bool chain = pk_m(c);  // AND of m over (k - o, k]
    for (int o = 1; o <= window && chain; ++o) {
      const uint8_t q = s_pk[k - o];
      occ += (s_doc[k - o] == d) & (pk_sym(q) == s);
      chain = pk_m(q);
    }
    s_occ[k] = (uint8_t)occ;
  }
  __syncthreads();

  for (int t = threadIdx.x; t < kTile; t += kThreads) {
    const int k = kHaloL + t;
    const uint8_t c = s_pk[k];
    const int d = s_doc[k];
    if (!pk_emit(c) || d < 0 || d >= num_reads) continue;
    const int s = pk_sym(c);
    const uint8_t occ = s_occ[k];
    Acc* row = sim + (long long)d * row_stride;
    // backward partners k - o: same cluster while m holds over (k-o, k]
    bool chain = pk_m(c);
    for (int o = 1; o <= window && chain; ++o) {
      const uint8_t q = s_pk[k - o];
      const int dj = s_doc[k - o];
      if (pk_sym(q) == s && s_occ[k - o] == occ && dj >= num_reads &&
          dj - num_reads < g_cols)
        add_one(row + (dj - num_reads));
      chain = pk_m(q);
    }
    // forward partners k + o: same cluster while m holds over (k, k+o]
    for (int o = 1; o <= window; ++o) {
      const uint8_t q = s_pk[k + o];
      if (!pk_m(q)) break;
      const int dj = s_doc[k + o];
      if (pk_sym(q) == s && s_occ[k + o] == occ && dj >= num_reads &&
          dj - num_reads < g_cols)
        add_one(row + (dj - num_reads));
    }
  }
}

template <typename Acc>
int launch(const void* packed, const void* doc, long long n, int window,
           int num_reads, int g_cols, void* sim, long long row_stride,
           void* stream) {
  const long long blocks = (n + kTile - 1) / kTile;
  banded_sim_kernel<Acc><<<(unsigned)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const int32_t*)doc, n, window, num_reads,
      g_cols, (Acc*)sim, row_stride);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point adds the stream's pair counts into the row-major
// accumulator `sim` (rows = read ids, `row_stride` elements apart;
// columns 0 .. g_cols-1 = genome ids), launches on `stream` and returns
// cudaGetLastError() (0 = launched).  n > 0; window <= 255.

int lime_banded_sim_i8(const void* packed, const void* doc, long long n,
                       int window, int num_reads, int g_cols, void* sim,
                       long long row_stride, void* stream) {
  return launch<int8_t>(packed, doc, n, window, num_reads, g_cols, sim,
                        row_stride, stream);
}

int lime_banded_sim_i32(const void* packed, const void* doc, long long n,
                        int window, int num_reads, int g_cols, void* sim,
                        long long row_stride, void* stream) {
  return launch<int32_t>(packed, doc, n, window, num_reads, g_cols, sim,
                         row_stride, stream);
}

}  // extern "C"
