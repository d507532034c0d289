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
// 1M), and no block waits on another. A lane reads its row's codes as one
// 16-byte load per 16 sub-codes when M % 16 == 0 and the codes are 16-byte
// aligned (byte loads otherwise), and loads its next row's first 16 codes
// while it scores this one. Outputs go out as runs of 16 rows (64 bytes)
// per query with streaming stores, so the 4 GB output does not evict the
// codes from L2. Blocks of 768 threads (one per SM at 128 KB) beat 512 and
// 1024 on the H100. Sums stay in j order from 0.f, so every output equals
// the plain version bit for bit. The plan (TQ, the grid, each block's
// range) is mirrored in adc_scan.py.

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
// reference's canonical dtype for K > 256): one template over the code type,
// with the batch kernel's 16-byte row loads for uint8 only. A launch covers
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

// TQ queries per tile (1, 2, 4 or 8); kVec16: uint8 codes, mc and ldc
// multiples of 16, 16-byte aligned rows; kAccumulate: a chunk after the
// first, starting from the sums in `out` (a template parameter, so the
// one-chunk launch of the main path carries no trace of it).
template <int TQ, bool kVec16, bool kAccumulate, typename CodeT>
__global__ void __launch_bounds__(kBatchThreads)
adc_scan_batch_kernel(const CodeT* __restrict__ codes, int64_t n, int ldc,
                      int m, const float* __restrict__ luts, int64_t ldl,
                      int q, int k, float* __restrict__ out) {
  constexpr int kVec = TQ < 4 ? TQ : 4;      // queries per shared load
  constexpr int kLanesPerRow = TQ / kVec;    // 2 at TQ = 8, else 1
  using Vec = typename FloatVec<kVec>::T;
  extern __shared__ float4 tab_raw[];        // [j][c][TQ]
  float* tab = reinterpret_cast<float*>(tab_raw);
  const int mk = m * k;
  const int64_t work = static_cast<int64_t>((q + TQ - 1) / TQ) * n;
  const int64_t lo = work * blockIdx.x / gridDim.x;
  const int64_t hi = work * (blockIdx.x + 1) / gridDim.x;
  const int rows_per_pass = blockDim.x / kLanesPerRow;
  const int slot = threadIdx.x / kLanesPerRow;
  const int half = threadIdx.x % kLanesPerRow;
  int64_t staged = -1;

  for (int64_t f = lo; f < hi;) {
    const int64_t tile = f / n;
    const int64_t r0 = f - tile * n;
    const int64_t r1 = r0 + (hi - f) < n ? r0 + (hi - f) : n;
    const int q0 = static_cast<int>(tile) * TQ;
    const int nq = q - q0 < TQ ? q - q0 : TQ;
    if (tile != staged) {  // uniform across the block: f, lo, hi are
      __syncthreads();     // every lane is done with the previous table
      for (int e = threadIdx.x; e < mk; e += blockDim.x) {
        float v[TQ];
#pragma unroll
        for (int t = 0; t < TQ; ++t)
          v[t] = t < nq ? luts[static_cast<int64_t>(q0 + t) * ldl + e] : 0.f;
#pragma unroll
        for (int h = 0; h < kLanesPerRow; ++h) {
          Vec w;
          float* wf = reinterpret_cast<float*>(&w);
#pragma unroll
          for (int i = 0; i < kVec; ++i) wf[i] = v[h * kVec + i];
          *reinterpret_cast<Vec*>(tab + e * TQ + h * kVec) = w;
        }
      }
      __syncthreads();
      staged = tile;
    }
    const float* tb = tab + half * kVec;
    // the lane's next row's first 16 codes are loaded while this one is scored
    uint4 nxt = make_uint4(0, 0, 0, 0);
    if (kVec16 && r0 + slot < r1)
      nxt = __ldg(reinterpret_cast<const uint4*>(codes + (r0 + slot) * ldc));
    for (int64_t row = r0 + slot; row < r1; row += rows_per_pass) {
      const CodeT* c = codes + row * ldc;
      const uint4 cur = nxt;
      if (kVec16 && row + rows_per_pass < r1)
        nxt = __ldg(reinterpret_cast<const uint4*>(codes + (row + rows_per_pass) * ldc));
      float acc[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const int t = half * kVec + i;
        acc[i] = kAccumulate && t < nq ? out[static_cast<int64_t>(q0 + t) * n + row] : 0.f;
      }
      if constexpr (kVec16) {
        for (int j0 = 0; j0 < m; j0 += 16) {
          const uint4 cv = j0 ? __ldg(reinterpret_cast<const uint4*>(c + j0)) : cur;
          const uint32_t w[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
          for (int b = 0; b < 16; ++b) {
            const int code = (w[b >> 2] >> (8 * (b & 3))) & 0xFF;
            const Vec e = *reinterpret_cast<const Vec*>(tb + ((j0 + b) * k + code) * TQ);
#pragma unroll
            for (int i = 0; i < kVec; ++i) acc[i] += lane_of(e, i);
          }
        }
      } else {
        for (int j = 0; j < m; ++j) {
          const Vec e = *reinterpret_cast<const Vec*>(
              tb + (j * k + static_cast<int>(__ldg(c + j))) * TQ);
#pragma unroll
          for (int i = 0; i < kVec; ++i) acc[i] += lane_of(e, i);
        }
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const int t = half * kVec + i;
        if (t < nq) __stcs(out + static_cast<int64_t>(q0 + t) * n + row, acc[i]);
      }
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

template <int TQ, typename CodeT>
cudaError_t launch_batch(const CodeT* codes, int64_t n, int ldc, int m,
                         const float* luts, int64_t ldl, int q, int k,
                         bool accumulate, float* out, cudaStream_t stream) {
  const bool vec16 = sizeof(CodeT) == 1 && m % 16 == 0 && ldc % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  constexpr bool kU8 = sizeof(CodeT) == 1;
  const auto kernel =
      accumulate ? (vec16 ? adc_scan_batch_kernel<TQ, kU8, true, CodeT>
                          : adc_scan_batch_kernel<TQ, false, true, CodeT>)
                 : (vec16 ? adc_scan_batch_kernel<TQ, kU8, false, CodeT>
                          : adc_scan_batch_kernel<TQ, false, false, CodeT>);
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
  kernel<<<blocks, kBatchThreads, smem, stream>>>(codes, n, ldc, m, luts, ldl, q, k,
                                                  out);
  return cudaGetLastError();
}

template <typename CodeT>
cudaError_t launch_batch_tq(const void* codes, int64_t n, int ldc, int m,
                            const void* luts, int64_t ldl, int q, int k, int tq,
                            int accumulate, void* out, cudaStream_t s) {
  const auto* c = static_cast<const CodeT*>(codes);
  const auto* l = static_cast<const float*>(luts);
  auto* o = static_cast<float*>(out);
  const bool acc = accumulate != 0;
  switch (tq) {
    case 1: return launch_batch<1>(c, n, ldc, m, l, ldl, q, k, acc, o, s);
    case 2: return launch_batch<2>(c, n, ldc, m, l, ldl, q, k, acc, o, s);
    case 4: return launch_batch<4>(c, n, ldc, m, l, ldl, q, k, acc, o, s);
    case 8: return launch_batch<8>(c, n, ldc, m, l, ldl, q, k, acc, o, s);
    default: return cudaErrorInvalidValue;
  }
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
// query 0's LUT, ldl floats apart.
int adc_scan_batch_launch(const void* codes, int code_bytes, int64_t n, int ldc,
                          int m, const void* luts, int64_t ldl, int q, int k,
                          int tq, int accumulate, void* out, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (code_bytes) {
    case 1: return static_cast<int>(launch_batch_tq<uint8_t>(
        codes, n, ldc, m, luts, ldl, q, k, tq, accumulate, out, s));
    case 4: return static_cast<int>(launch_batch_tq<int32_t>(
        codes, n, ldc, m, luts, ldl, q, k, tq, accumulate, out, s));
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
