// ADC scans: every code row against a batch of query LUTs, or one query's.
//
// Replaces repro/kernels/adc_scan.py::adc_scan_batch (Pallas,
// _adc_scan_batch_kernel).
//   out[q, n] = sum_j luts[q, j, codes[n, j]]
// The TPU kernel ran this as a bf16 one-hot GEMM on the MXU; this one sums
// the f32 LUT entries exactly as the plain version does (j order, f32).
//
// Bound on the H100: bytes, by the (Q, N) f32 output (4 GB at 1000 x 1M,
// 1.20 ms at 3.35 TB/s); the codes (N*M bytes) and LUTs are small next to
// it. Above that sits a shared-memory floor: any f32 gather design reads
// Q*N*M four-byte entries from shared memory (64 GB at 1000 x 1M x 16),
// at most 128 bytes per clock per SM: 1.9 ms on 132 SMs at 1.98 GHz with
// no bank conflict at all.
//
// Design: persistent blocks over (query tile, row) work. A block holds the
// LUTs of TQ queries (TQ = 8 at M=16, K=256: 128 KB) in shared memory,
// INTERLEAVED BY QUERY, tab[j][c][t] = luts[q0 + t, j, c], so one 16-byte
// shared load returns one row's entry for 4 queries. A row of codes is
// scored by TQ / 4 lanes (2 at TQ = 8), each summing 4 queries in
// registers; a quarter-warp (8 lanes x 16 bytes, one shared wavefront at
// best) then meets only 4 rows, each on 8 consecutive banks, so a load
// costs ~2.1 wavefronts per 32 lookups instead of ~3.5 with one lookup per
// lane (the birthday bound over 4 and over 32 bank groups), and 4x fewer
// load instructions. The flat (tile, row) space is cut into one contiguous
// range per block (gridDim.x = SMs x resident blocks), so a block stages a
// tile's LUT once per long row span (once or twice per launch at 1000 x
// 1M), and no block waits on another; the stage is one 4-byte cp.async per
// entry, many in flight per thread. A lane reads its row's uint8 codes as
// one 16-byte load per 16 sub-codes when M % 16 == 0 and the codes are
// 16-byte aligned (byte loads otherwise), and loads its next row's first 16
// codes while it scores this one. Outputs go out as runs of 16 rows (64
// bytes) per query with streaming stores, so the 4 GB output does not evict
// the codes from L2. Blocks of 768 threads (one per SM at 128 KB) beat 512
// and 1024 on the H100. Sums stay in j order from 0.f, so every output
// equals the plain version bit for bit. The plan (TQ, the grid, each
// block's range, the row loads) is mirrored in adc_scan.py.
//
// int32 codes (K > 256): at K=512 a query's LUT is 32 KB, so a tile holds 4
// queries, each lane scores a row alone, and a quarter-warp meets 8 rows
// (~2.6 wavefronts a 16-byte lookup, the birthday bound over 8 slots). Each
// tile re-reads every row, so the codes cross from L2 once per 4 queries.
// Read as 16 four-byte loads a row, or as four 16-byte loads (one row a
// lane, 32 rows over 16 cache lines a load), they cost more than the
// lookups (13.0 and 7.5 ms at 1000 x 1M on an H100, against 4.4 ms for
// uint8 at K=256: chip_smoke.py --adc-batch). So a first kernel (pack_u16_kernel) packs the int32
// codes into uint16 (the wrapper accepts no K of 2^16 or more: one
// subspace's LUT would pass shared memory), vector-major in groups of 32
// rows, and the scan reads a warp's 32 rows as one contiguous 512-byte run
// per 16-byte vector, 2 vectors a row at M=16, with the next row's loaded
// ahead: 5.4 ms, the lookups' own floor at 4 queries a tile. Ordering the
// work by row chunks, so that the 64 MB table is read from HBM about once,
// measured no faster: the table's re-reads hit L2 already.

// adc_scan_kernel (one query) replaces repro/kernels/adc_scan.py::adc_scan
// (Pallas, _adc_scan_kernel), the retrieval scorer's scan:
//   out[n] = sum_j lut[j, codes[n, j]]
// Bound: bytes, the N*M code bytes and the N f32 outputs (20 MB at 1M x 16).
// Beside it sits a shared-memory floor: N*M random f32 lookups, a warp's 32
// in one LUT row taking as many wavefronts as the fullest bank holds
// distinct words (~3.15 for uniform codes at K=256; a word several lanes
// read is broadcast), 6.0 us at 1M x 16 on 132 SMs at 1.98 GHz
// (chip_smoke.lookup_floor_ms counts it on the timed codes).
// Design: a persistent grid (blocks of kScanThreads, as many as stay
// resident, no more than the rows need), each block staging the (M, K) LUT
// in shared memory once, by cp.async that runs under the threads' first
// code loads. A thread owns the rows t, t + T, t +
// 2T, ... (T threads in all, so a warp's loads and stores coalesce), reads
// each row as 16-byte loads into registers when every row starts on 16 bytes
// (uint8 and int32 rows alike; one load per code otherwise, kPre = 0), and
// keeps kU rows in flight in a ring: a slot's next row is requested as soon
// as its row is summed. Two one-vector rows (32 bytes) a thread in flight,
// at 256 threads a block, beat 64 or 128 bytes and blocks of 128 or 512 on
// the H100. Sums go in j order from 0.f (csrc/lut_rows.cuh), bit-equal to
// the plain version, and out as streaming stores, so the 4 MB output does
// not evict the codes from L2. The wrapper (adc_scan.py) picks kPre; the
// grid's cap (SMs x resident blocks) is queried once per kernel instance,
// device and LUT size (resident_blocks), not on every launch.

// Both kernels take uint8 codes (K <= 256) or int32 codes (any K, the
// reference's canonical dtype for K > 256): the one-query scan as one
// template over the code type, the batch scan over uint8 rows or the
// uint16 rows packed from int32 ones. A launch covers
// the subspaces [j0, j0 + mc) of rows of ldc codes: the wrapper
// (adc_scan.py) splits M into chunks whose f32 LUT slice fits in shared
// memory and launches once per chunk, each launch after the first starting
// its sums from the partial sums in `out`, so every sum stays one f32 chain
// in j order.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "lut_rows.cuh"

namespace {

// Starts copying the n floats at src into shared memory at dst (16-byte
// aligned) and returns without waiting: 16 bytes per cp.async when src is
// 16-byte aligned and n % 4 == 0, else 4. The block meets the copy at
// wait_staged().
__device__ __forceinline__ void stage_async(const float* __restrict__ src, int n,
                                            float* dst) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = threadIdx.x; i < (n >> 2); i += blockDim.x)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(d + 16u * i), "l"(src + 4 * i) : "memory");
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                   :: "r"(d + 4u * i), "l"(src + i) : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for this thread's copies, then for the whole block's.
__device__ __forceinline__ void wait_staged() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

constexpr int kBatchThreads = 768;  // adc_scan_batch_kernel: 24 warps per SM
constexpr int kScanThreads = 256;   // adc_scan_kernel

template <int V> struct FloatVec;
template <> struct FloatVec<1> { using T = float; };
template <> struct FloatVec<2> { using T = float2; };
template <> struct FloatVec<4> { using T = float4; };

__device__ __forceinline__ float lane_of(float v, int) { return v; }
__device__ __forceinline__ float lane_of(float2 v, int i) { return i ? v.y : v.x; }
__device__ __forceinline__ float lane_of(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Copies the f32 LUTs of queries q0 .. q0 + nq - 1 (mk entries each, ldl
// apart) into tab interleaved by query, tab[e * TQ + t] = luts[q0 + t][e],
// zeros past nq, by 4-byte cp.async: a warp reads 8 entries of 4 queries
// (four 32-byte sectors) and writes 128 consecutive bytes. Returns without
// waiting; the block meets the copy at wait_staged().
template <int TQ>
__device__ __forceinline__ void stage_tile(const float* __restrict__ luts, int64_t ldl,
                                           int q0, int nq, int mk, float* tab) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(tab));
  for (int i = threadIdx.x; i < mk * TQ; i += blockDim.x) {
    const int t = i % TQ;
    const float* src = t < nq ? luts + static_cast<int64_t>(q0 + t) * ldl + i / TQ : luts;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d + 4u * i), "l"(src), "r"(t < nq ? 4 : 0) : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// int32 codes reach the batch kernel packed as uint16 (any K the wrapper
// accepts is below 2^16), vector-major in groups of kGroup rows: the 16-byte
// vector v (codes 8v .. 8v + 7) of row r sits at uint4 index
// ((r / kGroup) * nv + v) * kGroup + r % kGroup, zeros past m and past n. A
// warp's 32 consecutive rows then read each vector as 512 contiguous bytes.
constexpr int kGroup = 32;
constexpr int kPackThreads = 256;

__global__ void __launch_bounds__(kPackThreads)
pack_u16_kernel(const int32_t* __restrict__ codes, int64_t n, int ldc, int m, int nv,
                uint4* __restrict__ packed) {
  const int64_t total = (n + kGroup - 1) / kGroup * kGroup * nv;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t g = i / (kGroup * nv);
    const int rem = static_cast<int>(i - g * kGroup * nv);
    const int v = rem / kGroup;
    const int64_t row = g * kGroup + rem % kGroup;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (row < n) {
      const int32_t* c = codes + row * ldc + 8 * v;
#pragma unroll
      for (int b = 0; b < 8; ++b)
        if (8 * v + b < m)
          w[b >> 1] |= (static_cast<uint32_t>(__ldg(c + b)) & 0xFFFFu) << (16 * (b & 1));
    }
    packed[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The 16-byte vector v of code row `row`: uint8 rows of ldc codes, or
// uint16 rows packed by pack_u16_kernel (nv vectors a row).
template <typename CodeT>
__device__ __forceinline__ uint4 row_vec(const CodeT* codes, int64_t row, int ldc, int nv,
                                         int v) {
  if constexpr (sizeof(CodeT) == 1)
    return __ldg(reinterpret_cast<const uint4*>(codes + row * ldc) + v);
  else
    return __ldg(reinterpret_cast<const uint4*>(codes) +
                 ((row / kGroup) * nv + v) * kGroup + row % kGroup);
}

// acc[i] += the tile's entry of query i for each code of one 16-byte vector
// w (16 uint8 or 8 uint16 codes of subspaces j0, j0 + 1, ...; uint16 ones
// at or past m are padding), in j order; tb: the lane's first query in the
// interleaved table.
template <typename CodeT, int TQ, int kVec>
__device__ __forceinline__ void add_codes(float (&acc)[kVec], uint4 w, int j0, int m,
                                          const float* tb, int k) {
  using Vec = typename FloatVec<kVec>::T;
  const uint32_t x[4] = {w.x, w.y, w.z, w.w};
  constexpr int kPer = 16 / sizeof(CodeT);
#pragma unroll
  for (int b = 0; b < kPer; ++b) {
    if (sizeof(CodeT) == 1 || j0 + b < m) {  // uint8 rows fill whole vectors
      const int code = sizeof(CodeT) == 1
                           ? static_cast<int>((x[b >> 2] >> (8 * (b & 3))) & 0xFFu)
                           : static_cast<int>((x[b >> 1] >> (16 * (b & 1))) & 0xFFFFu);
      const Vec e = *reinterpret_cast<const Vec*>(tb + ((j0 + b) * k + code) * TQ);
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] += lane_of(e, i);
    }
  }
}

// TQ queries per tile (1, 2, 4 or 8). CodeT uint8_t: rows of ldc codes,
// read as 16-byte vectors with the first of a lane's next row loaded while
// it scores this one (kPre = 1; rows on 16 bytes, m % 16 == 0), or code by
// code (kPre = 0). CodeT uint16_t: rows packed by pack_u16_kernel, the
// first kPre (1, 2 or 4) vectors of the next row loaded ahead, the rest
// during the sum. kAccumulate: a chunk of subspaces after the first,
// starting from the sums in `out` (a template parameter, so the one-chunk
// launch of the main path carries no trace of it).
template <int TQ, int kPre, bool kAccumulate, typename CodeT>
__global__ void __launch_bounds__(kBatchThreads)
adc_scan_batch_kernel(const CodeT* __restrict__ codes, int64_t n, int ldc,
                      int m, const float* __restrict__ luts, int64_t ldl,
                      int q, int k, float* __restrict__ out) {
  constexpr int kVec = TQ < 4 ? TQ : 4;      // queries per shared load
  constexpr int kLanesPerRow = TQ / kVec;    // 2 at TQ = 8, else 1
  constexpr int kPer = 16 / sizeof(CodeT);   // codes per 16-byte vector
  constexpr int kRing = kPre > 0 ? kPre : 1;
  extern __shared__ float4 tab_raw[];        // [j][c][TQ]
  float* tab = reinterpret_cast<float*>(tab_raw);
  const int64_t work = static_cast<int64_t>((q + TQ - 1) / TQ) * n;
  const int64_t lo = work * blockIdx.x / gridDim.x;
  const int64_t hi = work * (blockIdx.x + 1) / gridDim.x;
  const int rows_per_pass = blockDim.x / kLanesPerRow;
  const int slot = threadIdx.x / kLanesPerRow;
  const int t0 = (threadIdx.x % kLanesPerRow) * kVec;  // the lane's first query
  const float* tb = tab + t0;
  const int nv = (m + kPer - 1) / kPer;                // vectors a row
  int64_t staged = -1;

  for (int64_t f = lo; f < hi;) {
    const int64_t tile = f / n;
    const int64_t r0 = f - tile * n;
    const int64_t r1 = r0 + (hi - f) < n ? r0 + (hi - f) : n;
    const int q0 = static_cast<int>(tile) * TQ;
    const int nq = q - q0 < TQ ? q - q0 : TQ;
    if (tile != staged) {  // uniform across the block: f, lo, hi are
      __syncthreads();     // every lane is done with the previous table
      stage_tile<TQ>(luts, ldl, q0, nq, m * k, tab);
      wait_staged();
      staged = tile;
    }
    uint4 nxt[kRing];
#pragma unroll
    for (int v = 0; v < kPre; ++v)
      nxt[v] = r0 + slot < r1 && v < nv ? row_vec(codes, r0 + slot, ldc, nv, v)
                                        : make_uint4(0u, 0u, 0u, 0u);
    for (int64_t row = r0 + slot; row < r1; row += rows_per_pass) {
      uint4 cur[kRing];
      const int64_t next = row + rows_per_pass;
#pragma unroll
      for (int v = 0; v < kPre; ++v) {
        cur[v] = nxt[v];
        nxt[v] = next < r1 && v < nv ? row_vec(codes, next, ldc, nv, v)
                                     : make_uint4(0u, 0u, 0u, 0u);
      }
      float acc[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        acc[i] = kAccumulate && t0 + i < nq
                     ? out[static_cast<int64_t>(q0 + t0 + i) * n + row] : 0.f;
      if constexpr (kPre > 0) {
#pragma unroll
        for (int v = 0; v < kPre; ++v)
          if (v < nv) add_codes<CodeT, TQ>(acc, cur[v], v * kPer, m, tb, k);
        for (int v = kPre; v < nv; ++v)
          add_codes<CodeT, TQ>(acc, row_vec(codes, row, ldc, nv, v), v * kPer, m, tb, k);
      } else {
        const CodeT* c = codes + row * ldc;
        for (int j = 0; j < m; ++j) {
          const auto e = *reinterpret_cast<const typename FloatVec<kVec>::T*>(
              tb + (j * k + static_cast<int>(__ldg(c + j))) * TQ);
#pragma unroll
          for (int i = 0; i < kVec; ++i) acc[i] += lane_of(e, i);
        }
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        if (t0 + i < nq) __stcs(out + static_cast<int64_t>(q0 + t0 + i) * n + row, acc[i]);
    }
    f += r1 - r0;
  }
}

// kPre: 16-byte vectors of a row held in registers (1, 2 or 4; rows on 16
// bytes), kU rows of a thread in flight (two one-vector rows, else one row);
// 0: one load per code, a row at a time.
template <typename CodeT, int kPre>
__global__ void __launch_bounds__(kScanThreads)
adc_scan_kernel(const CodeT* __restrict__ codes, int64_t n, int ldc, int mc,
                const float* __restrict__ lut, int k, bool accumulate,
                float* __restrict__ out) {
  constexpr int kU = kPre == 1 ? 2 : 1;
  extern __shared__ float4 lut_raw[];  // (mc, k)
  float* lut_s = reinterpret_cast<float*>(lut_raw);
  const int nv = (mc * static_cast<int>(sizeof(CodeT)) + 15) / 16;
  const int64_t threads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t rows = t < n ? (n - 1 - t) / threads + 1 : 0;  // t, t + T, ...
  uint4 v[kU][kPre > 0 ? kPre : 1];  // a ring of the next kU rows
  const auto load = [&](int u, int64_t i) {  // the thread's i-th row into slot u
    if constexpr (kPre > 0)
      lut_rows::load_row(codes + (t + i * threads) * ldc, i < rows ? nv : 0, v[u]);
  };
#pragma unroll
  for (int u = 0; u < kU; ++u) load(u, u);  // before the LUT copy is waited for
  stage_async(lut, mc * k, lut_s);
  wait_staged();
  for (int64_t i0 = 0; i0 < rows; i0 += kU) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int64_t i = i0 + u;
      if (i >= rows) break;
      const int64_t row = t + i * threads;
      float acc = accumulate ? out[row] : 0.f;
      if constexpr (kPre > 0)
        acc = lut_rows::sum_row<CodeT, kPre>(acc, v[u], codes + row * ldc, mc, lut_s, k);
      else
        acc = lut_rows::sum_row_scalar(acc, codes + row * ldc, mc, lut_s, k);
      __stcs(out + row, acc);
      load(u, i + kU);  // the slot's next row, kU rows ahead
    }
  }
}

template <int TQ, int kPre, typename CodeT>
cudaError_t launch_batch(const CodeT* codes, int64_t n, int ldc, int m,
                         const float* luts, int64_t ldl, int q, int k,
                         bool accumulate, float* out, cudaStream_t stream) {
  const auto kernel = accumulate ? adc_scan_batch_kernel<TQ, kPre, true, CodeT>
                                 : adc_scan_batch_kernel<TQ, kPre, false, CodeT>;
  const size_t smem = static_cast<size_t>(TQ) * m * k * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBatchThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // as many blocks as stay resident, but no more than one per pass of rows
  // or, for short N, one per query tile (adc_scan.py: grid_blocks)
  const int64_t tiles = (q + TQ - 1) / TQ;
  const int64_t rows_per_pass = kBatchThreads / (TQ < 4 ? 1 : TQ / 4);
  int64_t need = (tiles * n + rows_per_pass - 1) / rows_per_pass;
  need = need > tiles ? need : tiles;
  const int64_t cap = static_cast<int64_t>(sms) * per_sm;
  const unsigned blocks = static_cast<unsigned>(need < cap ? need : cap);
  kernel<<<blocks, kBatchThreads, smem, stream>>>(codes, n, ldc, m, luts, ldl, q, k, out);
  return cudaGetLastError();
}

template <int TQ, typename CodeT>
cudaError_t launch_batch_pre(const CodeT* c, int64_t n, int ldc, int m, const float* l,
                             int64_t ldl, int q, int k, int pre, bool acc, float* o,
                             cudaStream_t s) {
  if constexpr (sizeof(CodeT) == 1) {  // a uint8 row holds one vector ahead
    switch (pre) {
      case 0: return launch_batch<TQ, 0>(c, n, ldc, m, l, ldl, q, k, acc, o, s);
      case 1: return launch_batch<TQ, 1>(c, n, ldc, m, l, ldl, q, k, acc, o, s);
    }
  } else {  // packed rows: always vectors
    switch (pre) {
      case 1: return launch_batch<TQ, 1>(c, n, ldc, m, l, ldl, q, k, acc, o, s);
      case 2: return launch_batch<TQ, 2>(c, n, ldc, m, l, ldl, q, k, acc, o, s);
      case 4: return launch_batch<TQ, 4>(c, n, ldc, m, l, ldl, q, k, acc, o, s);
    }
  }
  return cudaErrorInvalidValue;
}

template <typename CodeT>
cudaError_t launch_batch_tq(const CodeT* c, int64_t n, int ldc, int m, const float* l,
                            int64_t ldl, int q, int k, int tq, int pre, bool acc, float* o,
                            cudaStream_t s) {
  switch (tq) {
    case 1: return launch_batch_pre<1>(c, n, ldc, m, l, ldl, q, k, pre, acc, o, s);
    case 2: return launch_batch_pre<2>(c, n, ldc, m, l, ldl, q, k, pre, acc, o, s);
    case 4: return launch_batch_pre<4>(c, n, ldc, m, l, ldl, q, k, pre, acc, o, s);
    case 8: return launch_batch_pre<8>(c, n, ldc, m, l, ldl, q, k, pre, acc, o, s);
    default: return cudaErrorInvalidValue;
  }
}

// int32 codes: packs them (pack_u16_kernel) into `packed`, then scans the
// packed rows; both on `stream`.
cudaError_t launch_batch_i32(const int32_t* codes, int64_t n, int ldc, int m,
                             const float* luts, int64_t ldl, int q, int k, int tq, int pre,
                             bool acc, uint16_t* packed, float* out, cudaStream_t s) {
  const int nv = (m + 7) / 8;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t vectors = (n + kGroup - 1) / kGroup * kGroup * nv;
  const int64_t need = (vectors + kPackThreads - 1) / kPackThreads;
  const int64_t cap = static_cast<int64_t>(sms) * (2048 / kPackThreads);
  pack_u16_kernel<<<static_cast<unsigned>(need < cap ? need : cap), kPackThreads, 0, s>>>(
      codes, n, ldc, m, nv, reinterpret_cast<uint4*>(packed));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_batch_tq<uint16_t>(packed, n, 0, m, luts, ldl, q, k, tq, pre, acc, out, s);
}

// SMs x blocks of adc_scan_kernel<CodeT, kPre> (kScanThreads, smem bytes of
// shared memory) that stay resident on the current device, into *cap. The
// shared-memory attribute and the occupancy query run once per kernel
// instance, device and LUT size; the one-query scan is launched once per
// retrieval query, so they would otherwise sit on its host path every time.
template <typename CodeT, int kPre>
cudaError_t resident_blocks(size_t smem, int64_t* cap) {
  const auto kernel = adc_scan_kernel<CodeT, kPre>;
  struct Plan { int dev; size_t smem; int64_t cap; };
  static std::mutex lock;
  static Plan plan = {-1, 0, 0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> hold(lock);
  if (plan.dev != dev || plan.smem != smem) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kScanThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    plan = {dev, smem, static_cast<int64_t>(sms) * per_sm};
  }
  *cap = plan.cap;
  return cudaSuccess;
}

template <typename CodeT, int kPre>
cudaError_t launch_query(const CodeT* codes, int64_t n, int ldc, int m, const float* lut,
                         int k, bool accumulate, float* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(m) * k * sizeof(float);
  int64_t cap = 0;
  const cudaError_t err = resident_blocks<CodeT, kPre>(smem, &cap);
  if (err != cudaSuccess) return err;
  // as many blocks as stay resident, but no more than one per kU rows a
  // thread in flight
  constexpr int64_t kRowsPerBlock = kScanThreads * (kPre == 1 ? 2 : 1);
  const int64_t need = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  const unsigned blocks = static_cast<unsigned>(need < cap ? need : cap);
  adc_scan_kernel<CodeT, kPre><<<blocks, kScanThreads, smem, stream>>>(codes, n, ldc, m, lut,
                                                                     k, accumulate, out);
  return cudaGetLastError();
}

template <typename CodeT>
cudaError_t launch_query_pre(int pre, const void* codes, int64_t n, int ldc, int m,
                             const void* lut, int k, int accumulate, void* out,
                             cudaStream_t s) {
  const auto* c = static_cast<const CodeT*>(codes);
  const auto* l = static_cast<const float*>(lut);
  auto* o = static_cast<float*>(out);
  const bool acc = accumulate != 0;
  switch (pre) {
    case 0: return launch_query<CodeT, 0>(c, n, ldc, m, l, k, acc, o, s);
    case 1: return launch_query<CodeT, 1>(c, n, ldc, m, l, k, acc, o, s);
    case 2: return launch_query<CodeT, 2>(c, n, ldc, m, l, k, acc, o, s);
    case 4: return launch_query<CodeT, 4>(c, n, ldc, m, l, k, acc, o, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// codes: rows of ldc codes offset to subspace j0 (uint8 when code_bytes == 1,
// int32 when 4), m = this chunk's subspaces; luts: offset to row j0 of
// query 0's LUT, ldl floats apart; tq: queries per tile; pre: 16-byte row
// vectors a lane loads ahead (uint8: 1 for rows on 16 bytes with m % 16 ==
// 0, else 0; int32: 1, 2 or 4 of the packed rows); packed: 16-byte aligned
// scratch of ceil(n / 32) * 32 * ceil(m / 8) * 16 bytes for int32 codes
// (adc_scan.py picks tq and pre and allocates packed).
int adc_scan_batch_launch(const void* codes, int code_bytes, int64_t n, int ldc,
                          int m, const void* luts, int64_t ldl, int q, int k,
                          int tq, int pre, int accumulate, void* packed, void* out,
                          void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const float*>(luts);
  auto* o = static_cast<float*>(out);
  const bool acc = accumulate != 0;
  switch (code_bytes) {
    case 1:
      if (pre && (reinterpret_cast<uintptr_t>(codes) % 16 || ldc % 16 || m % 16))
        return static_cast<int>(cudaErrorMisalignedAddress);
      return static_cast<int>(launch_batch_tq(static_cast<const uint8_t*>(codes), n, ldc, m,
                                              l, ldl, q, k, tq, pre, acc, o, s));
    case 4:
      if (packed == nullptr || reinterpret_cast<uintptr_t>(packed) % 16)
        return static_cast<int>(cudaErrorMisalignedAddress);
      return static_cast<int>(launch_batch_i32(static_cast<const int32_t*>(codes), n, ldc,
                                               m, l, ldl, q, k, tq, pre, acc,
                                               static_cast<uint16_t*>(packed), o, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// pre: 16-byte row vectors held in registers (1, 2 or 4, rows on 16
// bytes), or 0 (one load per code).
int adc_scan_launch(const void* codes, int code_bytes, int64_t n, int ldc, int m,
                    const void* lut, int k, int accumulate, int pre, void* out,
                    void* stream) {
  if (pre && (reinterpret_cast<uintptr_t>(codes) % 16 ||
              static_cast<int64_t>(ldc) * code_bytes % 16))
    return cudaErrorMisalignedAddress;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (code_bytes) {
    case 1: return static_cast<int>(launch_query_pre<uint8_t>(
        pre, codes, n, ldc, m, lut, k, accumulate, out, s));
    case 4: return static_cast<int>(launch_query_pre<int32_t>(
        pre, codes, n, ldc, m, lut, k, accumulate, out, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* adc_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
