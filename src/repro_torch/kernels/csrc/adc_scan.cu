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
// A grid-stride loop over a few blocks per SM, so each block stages the
// (M, K) LUT in shared memory ONCE (a block per 256 rows would re-read the
// 16 KB LUT ~3900 times, 3x the kernel's own bytes in L2 traffic). One
// thread per row reads its codes with 16-byte loads when M % 16 == 0 and the
// rows are 16-byte aligned (byte loads otherwise) and sums the M lookups in
// j order, as the plain version does; writes along N coalesce.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBatchThreads = 768;  // adc_scan_batch_kernel: 24 warps per SM
constexpr int kScanThreads = 256;   // adc_scan_kernel
constexpr int kScanBlocksPerSm = 4;

template <int V> struct FloatVec;
template <> struct FloatVec<1> { using T = float; };
template <> struct FloatVec<2> { using T = float2; };
template <> struct FloatVec<4> { using T = float4; };

__device__ __forceinline__ float lane_of(float v, int) { return v; }
__device__ __forceinline__ float lane_of(float2 v, int i) { return i ? v.y : v.x; }
__device__ __forceinline__ float lane_of(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// TQ queries per tile (1, 2, 4 or 8); kVec16: M % 16 == 0, 16-byte codes.
template <int TQ, bool kVec16>
__global__ void __launch_bounds__(kBatchThreads)
adc_scan_batch_kernel(const uint8_t* __restrict__ codes, int64_t n, int m,
                      const float* __restrict__ luts, int q, int k,
                      float* __restrict__ out) {
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
          v[t] = t < nq ? luts[static_cast<int64_t>(q0 + t) * mk + e] : 0.f;
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
      nxt = __ldg(reinterpret_cast<const uint4*>(codes + (r0 + slot) * m));
    for (int64_t row = r0 + slot; row < r1; row += rows_per_pass) {
      const uint8_t* c = codes + row * m;
      const uint4 cur = nxt;
      if (kVec16 && row + rows_per_pass < r1)
        nxt = __ldg(reinterpret_cast<const uint4*>(codes + (row + rows_per_pass) * m));
      float acc[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
      if (kVec16) {
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
          const Vec e = *reinterpret_cast<const Vec*>(tb + (j * k + __ldg(c + j)) * TQ);
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

__global__ void adc_scan_kernel(const uint8_t* __restrict__ codes, int64_t n,
                                int m, const float* __restrict__ lut, int k,
                                bool vec16, float* __restrict__ out) {
  extern __shared__ float lut_one[];  // (m, k)
  const int mk = m * k;
  for (int i = threadIdx.x; i < mk; i += blockDim.x) lut_one[i] = lut[i];
  __syncthreads();

  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       row < n; row += stride) {
    const uint8_t* c = codes + row * m;
    float acc = 0.f;
    if (vec16) {
      for (int j0 = 0; j0 < m; j0 += 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(c + j0);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int b = 0; b < 16; ++b) {
          const int code = (w[b >> 2] >> (8 * (b & 3))) & 0xFF;
          acc += lut_one[(j0 + b) * k + code];
        }
      }
    } else {
      for (int j = 0; j < m; ++j) acc += lut_one[j * k + c[j]];
    }
    out[row] = acc;
  }
}

template <int TQ>
cudaError_t launch_batch(const uint8_t* codes, int64_t n, int m, const float* luts,
                         int q, int k, float* out, cudaStream_t stream) {
  const bool vec16 = (m % 16 == 0) && (reinterpret_cast<uintptr_t>(codes) % 16 == 0);
  const auto kernel = vec16 ? adc_scan_batch_kernel<TQ, true>
                            : adc_scan_batch_kernel<TQ, false>;
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
  kernel<<<blocks, kBatchThreads, smem, stream>>>(codes, n, m, luts, q, k, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int adc_scan_batch_launch(const void* codes, int64_t n, int m,
                          const void* luts, int q, int k, int tq, void* out,
                          void* stream) {
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* l = static_cast<const float*>(luts);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (tq) {
    case 1: return static_cast<int>(launch_batch<1>(c, n, m, l, q, k, o, s));
    case 2: return static_cast<int>(launch_batch<2>(c, n, m, l, q, k, o, s));
    case 4: return static_cast<int>(launch_batch<4>(c, n, m, l, q, k, o, s));
    case 8: return static_cast<int>(launch_batch<8>(c, n, m, l, q, k, o, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int adc_scan_launch(const void* codes, int64_t n, int m, const void* lut, int k,
                    void* out, void* stream) {
  const size_t smem = static_cast<size_t>(m) * k * sizeof(float);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(adc_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t need = (n + kScanThreads - 1) / kScanThreads;
  const int64_t cap = static_cast<int64_t>(sms) * kScanBlocksPerSm;
  const unsigned blocks = static_cast<unsigned>(need < cap ? need : cap);
  const bool vec16 = (m % 16 == 0) && (reinterpret_cast<uintptr_t>(codes) % 16 == 0);
  adc_scan_kernel<<<blocks, kScanThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), n, m, static_cast<const float*>(lut), k,
      vec16, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* adc_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
