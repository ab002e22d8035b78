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
// sim[doc[i], doc[j] - num_reads] (partners at or past column g_cols are
// not counted).  occ[i] counts the earlier positions of i's cluster, at
// most `window` back, with i's (doc, symbol).  These are the XLA
// formulation's sums (sharded.py banded_partial_sim), which
// banded_sim_plain computes.
//
// What bounds it on the card: bytes.  Each position is read once (1 B
// code + 4 B document id) and each (read, genome) cell it touches is read
// and written once (8 B for the int32 accumulator).  The positions' bytes
// dominate: on the paper shape's staged streams 1.08e8 positions against
// about 6.2e5 touched cells (chip_smoke.py, "[kernels] banded").  The
// pair counts (3.6e7 on such a stream) reach the accumulator as one
// atomic add each (int8 inside a byte-wrapping 32-bit compare-and-swap:
// CUDA has no 8-bit atomicAdd), which the L2 cache serves; V (n x G_pad)
// never exists.
//
// The rule the design rests on.  A RUN is a position with m = 0 (or the
// stream's first position) and every m = 1 position after it.  In a run
// of length L <= window + 1 the band covers the whole run and the
// occurrence lookback covers every earlier position of it, so occ is the
// position's rank among its run's positions of the same (document,
// symbol), and an emitting read position of symbol s and rank k adds 1
// for each genome position of the run with symbol s and rank k (at most
// one per genome).  The work per run is then its length plus, per
// emitting read position, the run's genome positions: no walk over the
// band.  A run longer than window + 1 keeps the band semantics and takes
// the band walk below; no caller's main path has one that holds both an
// emitting read and a genome position (tests/test_torch_banded.py).
//
// Design: a block owns the short runs that START in its tile of kTile =
// 1,792 positions and the long-run positions that lie in it.  It holds
// the tile with 256 positions on each side in shared memory (1.29x the
// positions' bytes, loaded as 16-byte vectors): the right halo holds
// every short run that starts in the tile, the left one tells the tile's
// first positions whether their run is long.  A warp takes 32 consecutive
// positions at a time (a chunk), and the block meets two barriers:
//   A. the warp loads its chunks; per position a (document, symbol) key;
//      run starts as one ballot per chunk;
//   C. per position its run's start and end from the chunk ballots, and
//      for an emitting read or genome position of an owned short run its
//      occ, counted over the run's earlier keys (runs are mostly a few
//      positions long); genome positions as one ballot per chunk;
//   F. each emitting read position visits its run's genome positions
//      (the set bits of those ballots over the run) and adds 1 to (its
//      read, the genome's column) where occ and symbol match.
// Long runs: in F the lane at each long run's first position in shared
// memory ORs two more ballots over the run (emitting reads in the tile,
// genome positions); only runs with both are walked (G), by the whole
// block, in steps of kSlow positions loaded with two windows of history
// and one of lookahead: the band walk of the earlier kernel, restricted
// to the run's tile positions.  So no block scans a long run serially.
// Positions outside the stream load as m = 0 with a document id that
// matches nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWMax = 256;               // window <= 255: a short run <= 256
constexpr int kExt = 2304;               // positions in shared memory
constexpr int kTile = kExt - 2 * kWMax;  // the block's own positions
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunks = kExt / 32;       // 32-position chunks
constexpr int kChunksPerWarp = kChunks / kWarps;
constexpr int kSlow = kExt - 3 * kWMax;  // positions per long-run step
constexpr int kMaxLong = kExt / 3 + 2;   // long pieces (>= 3 positions)
constexpr int32_t kPadDoc = -0x7FFFFFFF;
constexpr int kMBit = 6;
constexpr int kEmitBit = 5;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kChunks % kWarps == 0, "chunks split evenly over warps");
static_assert(kTile % 16 == 0 && kWMax % 16 == 0, "16-byte loads");
static_assert(kSlow >= kTile / 2, "a tile's long piece takes <= 2 steps");
static_assert(kMaxLong <= kExt, "the long pieces fit in half of s_key");

// s_info per position: for an emitting read of an owned short run
// kRead | (occ << 4 | symbol) << 1 | run start << 13 | (run length - 1)
// << 24; kLongStart where a long run's piece in shared memory starts;
// else 0
constexpr uint32_t kRead = 1, kLongStart = 2;

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

// bits of a chunk mask at or above / strictly above lane position b
__device__ __forceinline__ unsigned bits_from(int b) { return ~0u << b; }
__device__ __forceinline__ unsigned bits_after(int b) {
  return b == 31 ? 0u : ~0u << (b + 1);
}

// The band walk of the emitting reads of one long run's positions
// [lo, hi) (global; at most one tile), by the whole block (block-uniform
// call): kSlow positions a step in shared memory with two windows of
// history and one of lookahead.
template <typename Acc>
__device__ void walk_long_piece(const uint8_t* __restrict__ packed,
                                const int32_t* __restrict__ doc,
                                long long n, int window, int num_reads,
                                int g_cols, Acc* __restrict__ sim,
                                long long row_stride, long long lo,
                                long long hi, uint8_t* s_pk, int32_t* s_doc,
                                uint8_t* s_occ) {
  for (long long c0 = lo; c0 < hi; c0 += kSlow) {
    const long long base = c0 - 2 * kWMax;
    for (int k = threadIdx.x; k < kExt; k += kThreads) {
      const long long p = base + k;
      const bool in = p >= 0 && p < n;
      s_pk[k] = in ? packed[p] : 0;
      s_doc[k] = in ? doc[p] : kPadDoc;
    }
    __syncthreads();
    // occ of every position a step position can pair with: [kWMax, kExt)
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
    const int stop = 2 * kWMax + (int)(hi - c0 < kSlow ? hi - c0 : kSlow);
    for (int k = 2 * kWMax + threadIdx.x; k < stop; k += kThreads) {
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
    __syncthreads();  // the next step overwrites the shared arrays
  }
}

template <typename Acc>
__global__ void __launch_bounds__(kThreads)
banded_sim_kernel(const uint8_t* __restrict__ packed,
                  const int32_t* __restrict__ doc, long long n, int window,
                  int num_reads, int g_cols, Acc* __restrict__ sim,
                  long long row_stride) {
  __shared__ __align__(16) uint8_t s_pk[kExt];
  __shared__ __align__(16) int32_t s_doc[kExt];
  // each position's (document << 4) | symbol, read in C; after C its
  // second half holds the long pieces (first << 16 | end), and the
  // long-run walk reuses its first bytes for occ
  __shared__ __align__(16) unsigned long long s_key[kExt];
  int* s_long = reinterpret_cast<int*>(s_key + kExt / 2);
  // occ << 4 | symbol of the genome positions of owned short runs
  __shared__ uint16_t s_gkey[kExt];
  __shared__ uint32_t s_info[kExt];      // see kRead
  __shared__ uint32_t s_smask[kChunks];  // run starts
  __shared__ uint32_t s_gmask[kChunks];  // genome positions of owned runs
  __shared__ uint32_t s_lread[kChunks];  // emitting reads of long runs
  __shared__ uint32_t s_lgen[kChunks];   // genome positions of long runs
  __shared__ int s_nlong;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;  // lanes before this one
  const long long p0 = (long long)blockIdx.x * kTile - kWMax;  // index 0

  // A. Each warp loads its own chunks (each lane up to three 16-byte
  // vectors of codes or document ids, all in flight at once; position by
  // position at the stream's edges), then per position a (document,
  // symbol) key, and run starts as one ballot per chunk.
  if (tid == 0) s_nlong = 0;
  const bool full = ((reinterpret_cast<uintptr_t>(packed) |
                      reinterpret_cast<uintptr_t>(doc)) & 15) == 0 &&
                    p0 >= 0 && p0 + kExt <= n;  // block-uniform
  if (full) {
    constexpr int kCodeVecs = 2 * kChunksPerWarp;  // 16 codes a vector
    constexpr int kVecs = 10 * kChunksPerWarp;     // and 4 document ids
    uint4 v[(kVecs + 31) / 32];
#pragma unroll
    for (int i = 0; i < (kVecs + 31) / 32; ++i) {
      const int t = lane + 32 * i;
      const int j = t < kCodeVecs ? t >> 1 : (t - kCodeVecs) >> 3;
      const long long k = 32 * (warp + kWarps * j) +
                          (t < kCodeVecs ? 16 * (t & 1)
                                         : 4 * ((t - kCodeVecs) & 7));
      if (t < kCodeVecs)
        v[i] = *reinterpret_cast<const uint4*>(packed + p0 + k);
      else if (t < kVecs)
        v[i] = *reinterpret_cast<const uint4*>(doc + p0 + k);
    }
#pragma unroll
    for (int i = 0; i < (kVecs + 31) / 32; ++i) {
      const int t = lane + 32 * i;
      const int j = t < kCodeVecs ? t >> 1 : (t - kCodeVecs) >> 3;
      const int k = 32 * (warp + kWarps * j) +
                    (t < kCodeVecs ? 16 * (t & 1)
                                   : 4 * ((t - kCodeVecs) & 7));
      if (t < kCodeVecs)
        *reinterpret_cast<uint4*>(s_pk + k) = v[i];
      else if (t < kVecs)
        *reinterpret_cast<uint4*>(s_doc + k) = v[i];
    }
  } else {
#pragma unroll
    for (int j = 0; j < kChunksPerWarp; ++j) {
      const int k = 32 * (warp + kWarps * j) + lane;
      const long long p = p0 + k;
      const bool in = p >= 0 && p < n;
      s_pk[k] = in ? packed[p] : 0;
      s_doc[k] = in ? doc[p] : kPadDoc;
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kChunksPerWarp; ++j) {
    const int c = warp + kWarps * j;
    const int k = 32 * c + lane;
    const uint8_t code = s_pk[k];
    s_key[k] = ((unsigned long long)(uint32_t)s_doc[k] << 4) | pk_sym(code);
    const unsigned b = __ballot_sync(kFull, !pk_m(code) || p0 + k == 0);
    if (lane == 0) s_smask[c] = b;
  }
  __syncthreads();

  // C. Per position: its run, occ, and whether it is an emitting read or
  // a genome position of an owned short run, or an emitting read (in the
  // tile) or a genome position of a long run.
#pragma unroll 3
  for (int j = 0; j < kChunksPerWarp; ++j) {
    const int c = warp + kWarps * j;
    const int k = 32 * c + lane;
    // the last start before the chunk and the first after it, within 9
    // chunks either way, found by the warp at once
    const unsigned wb =
        lane < 9 && c - 1 - lane >= 0 ? s_smask[c - 1 - lane] : 0u;
    const unsigned wa =
        lane < 9 && c + 1 + lane < kChunks ? s_smask[c + 1 + lane] : 0u;
    const unsigned bb = __ballot_sync(kFull, wb != 0);
    const unsigned ba = __ballot_sync(kFull, wa != 0);
    const int lb = __ffs(bb) - 1, la = __ffs(ba) - 1;
    const unsigned vb = __shfl_sync(kFull, wb, lb & 31);
    const unsigned va = __shfl_sync(kFull, wa, la & 31);
    // the run's start (the last start at or before k) and end (the first
    // start after k); -1 when out of reach
    const unsigned sm = s_smask[c];
    const unsigned le = sm & (lt | (1u << lane));
    const unsigned gt = sm & bits_after(lane);
    const int rs = le   ? 32 * c + 31 - __clz(le)
                   : bb ? 32 * (c - 1 - lb) + 31 - __clz(vb)
                        : -1;
    const int re = gt   ? 32 * c + __ffs(gt) - 1
                   : ba ? 32 * (c + 1 + la) + __ffs(va) - 1
                        : -1;
    // a short run lies whole in shared memory; a run whose start or end
    // is out of reach is longer than 256 positions, or not this block's
    const bool shortrun = rs >= 0 && re >= 0 && re - rs <= window + 1;
    const bool fast = shortrun && rs >= kWMax && rs < kWMax + kTile;
    const bool tile = k >= kWMax && k < kWMax + kTile;
    const uint8_t code = s_pk[k];
    const int d = s_doc[k];
    const bool read = pk_emit(code) && d >= 0 && d < num_reads;
    const bool genome = d >= num_reads && d - num_reads < g_cols;
    // occ: the run's earlier positions with this (document, symbol); runs
    // are mostly a few positions long
    int occ = 0;
    if (fast && (read || genome)) {
      const unsigned long long key = s_key[k];
#pragma unroll 1
      for (int q = rs; q < k; ++q) occ += s_key[q] == key;
    }
    const uint32_t want = (uint32_t)occ << 4 | pk_sym(code);
    if (fast && genome) s_gkey[k] = (uint16_t)want;
    s_info[k] = fast && read ? kRead | want << 1 | (uint32_t)rs << 13 |
                                   (uint32_t)(re - rs - 1) << 24
                : !shortrun && (k == rs || k == 0) ? kLongStart
                                                    : 0u;
    const unsigned gm = __ballot_sync(kFull, fast && genome);
    const unsigned lr = __ballot_sync(kFull, !shortrun && tile && read);
    const unsigned lg = __ballot_sync(kFull, !shortrun && genome);
    if (lane == 0) {
      s_gmask[c] = gm;
      s_lread[c] = lr;
      s_lgen[c] = lg;
    }
  }
  __syncthreads();

  // F. Each emitting read position of an owned short run visits the run's
  // genome positions (the set bits of their ballots over the run) and
  // adds 1 to (its read, the genome's column) where occ and symbol match;
  // the long pieces that hold an emitting read in the tile and a genome
  // position (the lane at a piece's first position ORs the chunk masks
  // over the piece) are listed for G.
#pragma unroll 3
  for (int j = 0; j < kChunksPerWarp; ++j) {
    const int c = warp + kWarps * j;
    const int k = 32 * c + lane;
    const uint32_t w = s_info[k];
    if (w & kRead) {
      const int rs = (int)(w >> 13) & 2047;
      const int re = rs + (int)(w >> 24) + 1;
      const uint32_t want = (w >> 1) & 4095u;
      const int c1 = (re - 1) >> 5;
      int cc = rs >> 5;
      unsigned bits = s_gmask[cc] & bits_from(rs & 31);
      for (;;) {
        if (cc == c1 && re - 32 * cc < 32)
          bits &= (1u << (re - 32 * cc)) - 1u;
        for (; bits; bits &= bits - 1) {
          const int g = 32 * cc + __ffs(bits) - 1;
          if (s_gkey[g] == want)
            add_one(sim + (long long)s_doc[k] * row_stride +
                    (s_doc[g] - num_reads));
        }
        if (cc == c1) break;
        bits = s_gmask[++cc];
      }
    }
    if (w == kLongStart) {
      unsigned any_read = 0, any_genome = 0;
      int end = kExt;
      for (int cc = c; cc < kChunks; ++cc) {
        const unsigned st =
            s_smask[cc] & (cc == c ? bits_after(lane) : ~0u);
        unsigned piece = cc == c ? bits_from(lane) : ~0u;
        if (st) piece &= (1u << (__ffs(st) - 1)) - 1u;
        any_read |= s_lread[cc] & piece;
        any_genome |= s_lgen[cc] & piece;
        if (st) {
          end = 32 * cc + __ffs(st) - 1;
          break;
        }
      }
      if (any_read && any_genome)
        s_long[atomicAdd(&s_nlong, 1)] =
            max(k, kWMax) << 16 | min(end, kWMax + kTile);
    }
  }

  // G. The long pieces that can score, walked by the whole block.
  __syncthreads();
  const int nlong = s_nlong;
  if (nlong == 0) return;
  uint8_t* s_occ = reinterpret_cast<uint8_t*>(s_key);
  for (int i = 0; i < nlong; ++i)
    walk_long_piece(packed, doc, n, window, num_reads, g_cols, sim,
                    row_stride, p0 + (s_long[i] >> 16),
                    p0 + (s_long[i] & 0xFFFF), s_pk, s_doc, s_occ);
}

template <typename Acc>
int launch(const void* packed, const void* doc, long long n, int window,
           int num_reads, int g_cols, void* sim, long long row_stride,
           void* stream) {
  if (n <= 0 || window <= 0) return 0;  // no band, no pairs
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
// cudaGetLastError() (0 = launched; nothing is launched when n or window
// is 0).  window <= 255.

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
