// Scores of genome-dense clusters, for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (lime_tpu_torch/ops/dense_kernels.py
// builds and binds this file).
//
// It replaces no Pallas kernel: lime_tpu scores these clusters with XLA
// ops outside any kernel (lime_tpu/ops/dense_score.py _dense_chunk: two
// feature scatters, a batched matmul over the whole plane width and a
// row scatter-add), which the port's plain version repeats in torch for
// CPU tensors (ops/dense_score.py _dense_rows).  On the card that chain
// computed every (read lane, genome column) cell of a chunk, and at
// 24,832 genome columns about 0.07% of those cells are a cluster's own.
//
// The identity.  The native planner (lime_plan_dense) gives each read
// lane r of a cluster the features phi_r[s,k] = [count_r(s) > k] and each
// of the cluster's genomes g the features psi_g[s,k] = [count_g(s) > k],
// F = nsym * K <= 32 of them, so each is one 32-bit mask, and the score
// sum_s min(count_r(s), count_g(s)) is popc(phi_r & psi_g).
//
// Input: one chunk of host.pack_chunks, unchanged:
//   ridx  read triples, entry * pr * f + lane * f + feature, strictly
//         ascending, padded at the end with b_blk * pr * f;
//   gidx  genome triples, cluster * g_pad * f + genome * f + feature;
//         the clusters ascend, a (cluster, genome) pair's triples are
//         contiguous with ascending features (genomes in the order the
//         planner met them), padded at the end with c_blk * g_pad * f;
//   cmap  each entry's cluster (b_blk), rid each lane's read row
//         (b_blk * pr; pad lanes carry the drop row and no triple).
// For every lane that carries a read and every genome of its cluster
// with a nonzero score the kernel adds the score at plane[rid - row_base,
// genome]; a zero score adds nothing, so pad lanes touch nothing.  With
// row_base >= 0 (a row block of the row-blocked mode) lanes whose row
// falls outside [0, rows) are dropped; with row_base < 0 every lane's row
// must lie in [0, rows).  int8 planes wrap mod 256 (the reference's uchar
// counters) inside a 32-bit compare-and-swap, with no carry into the
// neighbouring byte; int32 planes take atomicAdd.  Adds commute, so the
// bytes do not depend on their order.
//
// Design: one warp per entry, four entries a block, and no buffer beyond
// the plane.  The warp finds its entry's read triples and its cluster's
// genome triples by a 32-way search of the ascending arrays (4-5 steps
// at 2^19 triples), ORs its pr lane masks with warp reductions, then
// walks the cluster's genome triples 32 at a time: a segmented OR over
// each (cluster, genome) run gives the genome's mask at the run's last
// triple, carried across windows, and that thread scores the pr lanes
// against it.  Work follows the lanes that carry a read and their
// cluster's genomes, never the plane's width.
//
// What bounds it on the card: the plane's atomic read-modify-writes, one
// per (lane, genome) cell with a nonzero score, against the triples read
// once (4 B each) and each useful cell read and written once.
//
// Guards: every plane address is checked against rows and g_pad before
// it is written.  Extra blocks check every index the torch version would
// refuse (a triple past its buffer, a cluster or row out of range) and
// the order the search relies on, and set a bit of status[1]; the
// wrapper raises on it at the job's next synchronisation.  A genome met
// twice in one cluster but not contiguously is not detected (the
// planner never emits one).  status[0] counts the cells scored: lanes
// that carry a read (in the row block) times their cluster's genomes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // entries a block
constexpr int kThreads = kWarps * 32;
constexpr int kCheckBlocks = 64;
constexpr unsigned kFull = 0xffffffffu;

// status[1] bits
constexpr unsigned long long kBadRead = 1, kReadOrder = 2, kBadGenome = 4,
                             kGenomeOrder = 8, kBadCluster = 16,
                             kBadRow = 32;

struct Chunk {
  const int32_t* ridx;
  long long n_r;
  const int32_t* gidx;
  long long n_g;
  const int32_t* cmap;
  const int32_t* rid;
  int b_blk, c_blk, pr, f, g_pad;
  long long rows, row_stride, row_base;  // row_base < 0: whole plane
  unsigned long long* status;
};

__device__ __forceinline__ void add(int32_t* p, int s) { atomicAdd(p, s); }

__device__ __forceinline__ void add(int8_t* p, int s) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  unsigned int* word = reinterpret_cast<unsigned int*>(a & ~uintptr_t(3));
  const unsigned int shift = (unsigned int)(a & 3) * 8u;
  const unsigned int mask = 0xFFu << shift;
  unsigned int old = *word, assumed;
  do {
    assumed = old;
    const unsigned int byte =
        (((assumed & mask) >> shift) + (unsigned int)s) & 0xFFu;
    old = atomicCAS(word, assumed, (assumed & ~mask) | (byte << shift));
  } while (old != assumed);
}

// First index of [lo, hi) whose value is >= v (or hi), for arrays that
// ascend in that predicate; the whole warp calls it with the same
// arguments and gets the same answer.
__device__ long long warp_lower_bound(const int32_t* a, long long lo,
                                      long long hi, long long v, int lane) {
  while (hi > lo) {
    const long long step = (hi - lo + 31) / 32;
    const long long p = lo + lane * step;
    const bool below = p < hi && (long long)a[p] < v;
    const int c = __popc(__ballot_sync(kFull, below));
    if (c == 0) return lo;
    const long long next_hi = lo + (long long)c * step;
    lo += (long long)(c - 1) * step + 1;
    hi = next_hi < hi ? next_hi : hi;
  }
  return lo;
}

// One entry (one warp): returns the cells it scored.
template <typename T>
__device__ unsigned long long score_entry(const Chunk& k, T* plane, int e,
                                          int lane) {
  const long long span = (long long)k.pr * k.f;
  const long long r_lo = (long long)e * span;
  const long long r0 = warp_lower_bound(k.ridx, 0, k.n_r, r_lo, lane);
  const long long r1 = warp_lower_bound(k.ridx, r0, k.n_r, r_lo + span, lane);
  // lane p's mask lives in thread p
  uint32_t my_mask = 0;
  for (long long i0 = r0; i0 < r1; i0 += 32) {
    const long long i = i0 + lane;
    int which = -1;
    uint32_t bit = 0;
    if (i < r1) {
      const long long v = (long long)k.ridx[i] - r_lo;
      if (v >= 0 && v < span) {  // else out of order: flagged
        which = (int)(v / k.f);
        bit = 1u << (int)(v % k.f);
      }
    }
    for (int p = 0; p < k.pr; p++) {
      const uint32_t m = __reduce_or_sync(kFull, which == p ? bit : 0u);
      if (lane == p) my_mask |= m;
    }
  }
  if (!__any_sync(kFull, my_mask != 0)) return 0;  // a pad entry
  const int c = k.cmap[e];
  if (c < 0 || c >= k.c_blk) return 0;  // flagged by the checks
  long long my_row = -1;  // the lane's row in the plane, -1: not scored
  if (lane < k.pr && my_mask != 0) {
    const long long r = (long long)k.rid[(long long)e * k.pr + lane] -
                        (k.row_base < 0 ? 0 : k.row_base);
    if (r >= 0 && r < k.rows) my_row = r;
  }
  const unsigned active = __ballot_sync(kFull, my_row >= 0);
  if (!active) return 0;

  const long long cspan = (long long)k.g_pad * k.f;
  const long long cbase = (long long)c * cspan;
  // a genome triple's column in the cluster, -3 outside it
  auto column = [&](long long v) { return v >= 0 && v < cspan ? v / k.f
                                                                : -3LL; };
  const long long g0 = warp_lower_bound(k.gidx, 0, k.n_g, cbase, lane);
  const long long g1 = warp_lower_bound(k.gidx, g0, k.n_g, cbase + cspan,
                                        lane);
  unsigned long long genomes = 0;
  uint32_t carry = 0;  // the OR of the run left open by the last window
  for (long long j0 = g0; j0 < g1; j0 += 32) {
    const long long j = j0 + lane;
    const bool in = j < g1;
    long long key = -1;  // the genome column; -3 flagged out of order
    uint32_t m = 0;
    if (in) {
      const long long v = k.gidx[j] - cbase;
      key = column(v);
      if (key >= 0) m = 1u << (int)(v % k.f);
    }
    long long prev = __shfl_up_sync(kFull, key, 1);
    long long next = __shfl_down_sync(kFull, key, 1);
    if (lane == 0) prev = j0 > g0 ? column(k.gidx[j - 1] - cbase) : -2;
    if (lane == 31 && in)
      next = j + 1 < g1 ? column(k.gidx[j + 1] - cbase) : -2;
    const bool head = in && key != prev;
    const bool tail = in && key != next;
    if (lane == 0 && in && !head) m |= carry;
    // segmented inclusive OR: from the run's first triple in the window
    const unsigned heads = __ballot_sync(kFull, head);
    const unsigned upto = heads & (0xffffffffu >> (31 - lane));
    const int seg = upto ? 31 - __clz(upto) : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t o = __shfl_up_sync(kFull, m, d);
      if (lane - d >= seg) m |= o;
    }
    const uint32_t last = __shfl_sync(kFull, m, 31);
    carry = (__ballot_sync(kFull, lane == 31 && in && !tail)) ? last : 0u;
    const bool rec = tail && key >= 0;
    genomes += __popc(__ballot_sync(kFull, rec));
    for (int p = 0; p < k.pr; p++) {
      if (!((active >> p) & 1)) continue;
      const uint32_t lm = __shfl_sync(kFull, my_mask, p);
      const long long row = __shfl_sync(kFull, my_row, p);
      if (rec) {
        const int s = __popc(lm & m);
        if (s) add(plane + row * k.row_stride + key, s);
      }
    }
  }
  return (unsigned long long)__popc(active) * genomes;
}

// The checks of the extra blocks: what the torch version would refuse,
// and the order the search relies on.
__device__ void check_chunk(const Chunk& k, long long t, long long nt) {
  unsigned long long bad = 0;
  const long long r_pad = (long long)k.b_blk * k.pr * k.f;
  for (long long i = t; i < k.n_r; i += nt) {
    const long long v = k.ridx[i];
    if (v < 0 || v > r_pad) bad |= kBadRead;
    if (i + 1 < k.n_r) {
      const long long w = k.ridx[i + 1];
      if (!(v < w || (v == r_pad && w == r_pad))) bad |= kReadOrder;
    }
  }
  const long long cspan = (long long)k.g_pad * k.f;
  const long long g_pad_v = (long long)k.c_blk * cspan;
  for (long long i = t; i < k.n_g; i += nt) {
    const long long v = k.gidx[i];
    if (v < 0 || v > g_pad_v) bad |= kBadGenome;
    if (i + 1 < k.n_g) {
      const long long w = k.gidx[i + 1];
      if (w / cspan < v / cspan ||
          (v != g_pad_v && w / k.f == v / k.f && w <= v))
        bad |= kGenomeOrder;
    }
  }
  for (long long i = t; i < k.b_blk; i += nt) {
    const int c = k.cmap[i];
    if (c < 0 || c >= k.c_blk) bad |= kBadCluster;
  }
  if (k.row_base < 0) {
    for (long long i = t; i < (long long)k.b_blk * k.pr; i += nt) {
      const long long r = k.rid[i];
      if (r < 0 || r >= k.rows) bad |= kBadRow;
    }
  }
  if (bad) atomicOr(k.status + 1, bad);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dense_pairs_kernel(Chunk k, T* plane, int score_blocks) {
  if ((int)blockIdx.x >= score_blocks) {
    check_chunk(k, (long long)(blockIdx.x - score_blocks) * kThreads +
                       threadIdx.x,
                (long long)(gridDim.x - score_blocks) * kThreads);
    return;
  }
  __shared__ unsigned long long s_cells[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = blockIdx.x * kWarps + warp;
  unsigned long long cells = 0;
  if (e < k.b_blk) cells = score_entry<T>(k, plane, e, lane);
  if (lane == 0) s_cells[warp] = cells;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sum = 0;
    for (int w = 0; w < kWarps; w++) sum += s_cells[w];
    if (sum) atomicAdd(k.status, sum);
  }
}

template <typename T>
int launch(const void* ridx, long long n_r, const void* gidx, long long n_g,
           const void* cmap, const void* rid, int b_blk, int c_blk, int pr,
           int f, int g_pad, void* plane, long long rows,
           long long row_stride, long long row_base, void* status,
           void* stream) {
  Chunk k{static_cast<const int32_t*>(ridx), n_r,
          static_cast<const int32_t*>(gidx), n_g,
          static_cast<const int32_t*>(cmap), static_cast<const int32_t*>(rid),
          b_blk, c_blk, pr, f, g_pad, rows, row_stride, row_base,
          static_cast<unsigned long long*>(status)};
  const int score_blocks = (b_blk + kWarps - 1) / kWarps;
  dense_pairs_kernel<T><<<score_blocks + kCheckBlocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      k, static_cast<T*>(plane), score_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point adds one chunk's scores into the row-major plane
// (`rows` rows, `row_stride` elements apart, g_pad <= row_stride columns
// used), launches on `stream` and returns cudaGetLastError() (0 =
// launched).  row_base < 0 scores every lane into the whole plane; >= 0
// only the lanes whose row lies in [row_base, row_base + rows).  status:
// two uint64, [0] += cells scored, [1] |= check bits.  pr and f <= 32.

int lime_dense_pairs_i8(const void* ridx, long long n_r, const void* gidx,
                        long long n_g, const void* cmap, const void* rid,
                        int b_blk, int c_blk, int pr, int f, int g_pad,
                        void* plane, long long rows, long long row_stride,
                        long long row_base, void* status, void* stream) {
  return launch<int8_t>(ridx, n_r, gidx, n_g, cmap, rid, b_blk, c_blk, pr, f,
                        g_pad, plane, rows, row_stride, row_base, status,
                        stream);
}

int lime_dense_pairs_i32(const void* ridx, long long n_r, const void* gidx,
                         long long n_g, const void* cmap, const void* rid,
                         int b_blk, int c_blk, int pr, int f, int g_pad,
                         void* plane, long long rows, long long row_stride,
                         long long row_base, void* status, void* stream) {
  return launch<int32_t>(ridx, n_r, gidx, n_g, cmap, rid, b_blk, c_blk, pr,
                         f, g_pad, plane, rows, row_stride, row_base, status,
                         stream);
}

}  // extern "C"
