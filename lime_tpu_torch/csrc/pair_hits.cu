// Pair-hit kernels of the packed pair-stream scoring path, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes
// (lime_tpu_torch/ops/pair_kernels.py builds and binds this file).
//
// They replace the two Pallas TPU kernels on the fused serving path:
//
//   pair_hits_scan<16|64>  <- lime_tpu/ops/pallas_kernels.py
//                             _pair_kernel_scan (buckets 0 and 1)
//   pair_hits_band         <- lime_tpu/ops/pallas_kernels.py
//                             _pair_kernel (bucket 2, copies of 65-255 rows)
//
// Input: one byte per stream row, the unpacked 5-bit planner code
//   bits 0-1 sym, bit 2 m (row continues its copy), bit 3 docrun (row
//   continues its document run), bit 4 side (1 = genome row).
// Output: int32 per row, the number of genome rows in the same copy with
// the same (symbol, occurrence index); occ = the row's exclusive count of
// its own symbol within its document run.  Read rows are exact; the scan
// kernels leave don't-care values on genome rows (the caller's scatter
// drops them), the band kernel computes every row exactly.
//
// What bounds them on the card: each row moves about 5 bytes of device
// memory (1 B code in, 4 B hit out), while its work is O(log CAP)
// shared-memory scan steps (scan) or an O(copy length) walk (band).
// Both are bound by integer work and shared-memory latency, not by
// device-memory bandwidth (PERF.md has the measured rates).
// Design: one block scores a TILE of rows from a shared-memory copy of
// the tile plus a halo on each side, so every neighbour a row reads is a
// shared-memory load; no state carries between blocks (copies never
// cross a stream chunk, and the halo covers the longest copy).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;    // rows scored per block
constexpr int kThreads = 256;

__device__ __forceinline__ int code_sym(uint8_t c) { return c & 3; }
__device__ __forceinline__ int code_m(uint8_t c) { return (c >> 2) & 1; }
__device__ __forceinline__ int code_dr(uint8_t c) { return (c >> 3) & 1; }
__device__ __forceinline__ int code_gs(uint8_t c) { return (c >> 4) & 1; }

// ---------------------------------------------------------------------
// K1: log-step segmented scans (copy-length cap 16 or 64).
//
// occ comes from a segmented inclusive prefix count of the row's own
// symbol (four byte-packed counters in one u32, Hillis-Steele over
// log2(CAP) steps; document runs never exceed CAP, so no byte carries).
// A genome row sets bit (sym, occ) of a per-symbol occurrence bitmask;
// a backward segmented OR over the copy gives every row the union of the
// masks of the genome rows after it.  Genome rows trail each copy and
// (sym, occ) is unique within a document run, so a read row has at most
// one matching genome row: its hit is that one bit.
// ---------------------------------------------------------------------

template <int CAP>
struct ScanTraits;

template <>
struct ScanTraits<16> {
  typedef uint32_t Mask;  // 2 symbols x 16 occurrence bits per register
  static constexpr int kRegs = 2;
  static constexpr int kLog = 4;
  __device__ static int reg(int sym, int occ) { return sym >> 1; }
  __device__ static int bit(int sym, int occ) {
    return (occ & 15) + ((sym & 1) << 4);
  }
};

template <>
struct ScanTraits<64> {
  typedef uint64_t Mask;  // 1 symbol x 64 occurrence bits per register
  static constexpr int kRegs = 4;
  static constexpr int kLog = 6;
  __device__ static int reg(int sym, int occ) { return sym; }
  __device__ static int bit(int sym, int occ) { return occ & 63; }
};

template <int CAP>
__global__ void __launch_bounds__(kThreads)
pair_hits_scan_kernel(const uint8_t* __restrict__ codes, long long n,
                      int32_t* __restrict__ out) {
  typedef ScanTraits<CAP> T;
  typedef typename T::Mask Mask;
  constexpr int kHalo = CAP;
  constexpr int kExt = kTile + 2 * kHalo;
  constexpr int kPer = (kExt + kThreads - 1) / kThreads;

  __shared__ uint8_t s_code[kExt];
  __shared__ uint32_t s_x[kExt];
  __shared__ uint8_t s_f[kExt];
  __shared__ Mask s_gm[T::kRegs][kExt];

  const long long base = (long long)blockIdx.x * kTile - kHalo;
  const int tid = threadIdx.x;

  // rows outside the chunk read as code 0 (read row, no chain bits)
  for (int e = tid; e < kExt; e += kThreads) {
    const long long p = base + e;
    const uint8_t c = (p >= 0 && p < n) ? codes[p] : (uint8_t)0;
    s_code[e] = c;
    s_x[e] = 1u << (8 * code_sym(c));
    s_f[e] = (uint8_t)code_dr(c);
  }
  __syncthreads();

  // segmented inclusive prefix count; s_f[e] = rows (e-2^k, e] share
  // row e's document run
#pragma unroll
  for (int k = 0; k < T::kLog; ++k) {
    const int d = 1 << k;
    uint32_t nx[kPer];
    uint8_t nf[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = tid + j * kThreads;
      if (e < kExt) {
        uint32_t x = s_x[e];
        uint8_t f = s_f[e];
        if (e >= d) {
          if (f) x += s_x[e - d];
          f &= s_f[e - d];
        } else {
          f = 0;
        }
        nx[j] = x;
        nf[j] = f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = tid + j * kThreads;
      if (e < kExt) {
        s_x[e] = nx[j];
        s_f[e] = nf[j];
      }
    }
    __syncthreads();
  }

  // genome-key masks, and the forward segment flag: row e+1 continues
  // row e's copy
  for (int e = tid; e < kExt; e += kThreads) {
    const uint8_t c = s_code[e];
    const int sym = code_sym(c);
    const int occ = (int)((s_x[e] >> (8 * sym)) & 255u) - 1;
    const int r = T::reg(sym, occ);
    const Mask b = code_gs(c) ? ((Mask)1 << T::bit(sym, occ)) : (Mask)0;
#pragma unroll
    for (int q = 0; q < T::kRegs; ++q) s_gm[q][e] = (q == r) ? b : (Mask)0;
    s_f[e] = (e + 1 < kExt) ? (uint8_t)code_m(s_code[e + 1]) : (uint8_t)0;
  }
  __syncthreads();

  // backward segmented OR over the copy
#pragma unroll
  for (int k = 0; k < T::kLog; ++k) {
    const int d = 1 << k;
    Mask ng[kPer][T::kRegs];
    uint8_t nf[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = tid + j * kThreads;
      if (e < kExt) {
        uint8_t f = s_f[e];
#pragma unroll
        for (int q = 0; q < T::kRegs; ++q) ng[j][q] = s_gm[q][e];
        if (e + d < kExt) {
          if (f) {
#pragma unroll
            for (int q = 0; q < T::kRegs; ++q) ng[j][q] |= s_gm[q][e + d];
          }
          f &= s_f[e + d];
        } else {
          f = 0;
        }
        nf[j] = f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = tid + j * kThreads;
      if (e < kExt) {
#pragma unroll
        for (int q = 0; q < T::kRegs; ++q) s_gm[q][e] = ng[j][q];
        s_f[e] = nf[j];
      }
    }
    __syncthreads();
  }

  for (int e = kHalo + tid; e < kHalo + kTile; e += kThreads) {
    const long long p = base + e;
    if (p >= n) break;
    const uint8_t c = s_code[e];
    const int sym = code_sym(c);
    const int occ = (int)((s_x[e] >> (8 * sym)) & 255u) - 1;
    const Mask a = s_gm[T::reg(sym, occ)][e];
    out[p] = (int32_t)((a >> T::bit(sym, occ)) & (Mask)1);
  }
}

// ---------------------------------------------------------------------
// K2: bounded band walks (copy-length cap 255, runtime window <= 255).
//
// Per row: occ by walking back along the document-run chain (at most
// `window` rows), then the hit count by walking both ways along the copy
// chain, counting genome rows with equal (sym, occ).  This is
// _pair_hits_core of lime_tpu/ops/pair_score.py row by row: rows outside
// the chunk never match (sym -1, no chain bits).  The left halo holds two
// windows (a backward partner's own occ looks back one more window), the
// right halo one.
// ---------------------------------------------------------------------

constexpr int kBandHaloL = 512;
constexpr int kBandHaloR = 256;
constexpr uint8_t kPad = 0x80;  // outside the chunk: matches nothing

__device__ __forceinline__ int band_sym(uint8_t c) {
  return (c & kPad) ? -1 : (c & 3);
}

__global__ void __launch_bounds__(kThreads)
pair_hits_band_kernel(const uint8_t* __restrict__ codes, long long n,
                      int window, int32_t* __restrict__ out) {
  constexpr int kExt = kTile + kBandHaloL + kBandHaloR;
  __shared__ uint8_t s_code[kExt];
  __shared__ uint8_t s_occ[kExt];

  const long long base = (long long)blockIdx.x * kTile - kBandHaloL;
  const int tid = threadIdx.x;

  for (int e = tid; e < kExt; e += kThreads) {
    const long long p = base + e;
    s_code[e] = (p >= 0 && p < n) ? codes[p] : kPad;
  }
  __syncthreads();

  // occ: same-symbol rows back along the document-run chain
  for (int e = tid; e < kExt; e += kThreads) {
    const uint8_t c = s_code[e];
    const int sym = band_sym(c);
    int occ = 0;
    bool chain = code_dr(c);
    for (int o = 1; o <= window && chain; ++o) {
      const int q = e - o;
      if (q < 0) break;
      const uint8_t cq = s_code[q];
      occ += (band_sym(cq) == sym);
      chain = code_dr(cq);
    }
    s_occ[e] = (uint8_t)occ;
  }
  __syncthreads();

  for (int e = kBandHaloL + tid; e < kBandHaloL + kTile; e += kThreads) {
    const long long p = base + e;
    if (p >= n) break;
    const uint8_t c = s_code[e];
    const int sym = band_sym(c);
    const uint8_t occ = s_occ[e];
    int hits = 0;
    // backward partner e-o: rows (e-o, e] all continue the copy
    bool chain = code_m(c);
    for (int o = 1; o <= window && chain; ++o) {
      const uint8_t cq = s_code[e - o];
      hits += code_gs(cq) && band_sym(cq) == sym && s_occ[e - o] == occ;
      chain = code_m(cq);
    }
    // forward partner e+o: rows (e, e+o] all continue the copy
    for (int o = 1; o <= window; ++o) {
      const uint8_t cq = s_code[e + o];
      if (!code_m(cq)) break;
      hits += code_gs(cq) && band_sym(cq) == sym && s_occ[e + o] == occ;
    }
    out[p] = hits;
  }
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 = launched).  n must be a positive multiple of the 1024-row tile.

int lime_pair_hits_scan16(const void* codes, long long n, void* out,
                          void* stream) {
  pair_hits_scan_kernel<16><<<(unsigned)(n / kTile), kThreads, 0,
                              (cudaStream_t)stream>>>(
      (const uint8_t*)codes, n, (int32_t*)out);
  return (int)cudaGetLastError();
}

int lime_pair_hits_scan64(const void* codes, long long n, void* out,
                          void* stream) {
  pair_hits_scan_kernel<64><<<(unsigned)(n / kTile), kThreads, 0,
                              (cudaStream_t)stream>>>(
      (const uint8_t*)codes, n, (int32_t*)out);
  return (int)cudaGetLastError();
}

int lime_pair_hits_band(const void* codes, long long n, int window,
                        void* out, void* stream) {
  pair_hits_band_kernel<<<(unsigned)(n / kTile), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const uint8_t*)codes, n, window, (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
