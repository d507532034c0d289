// ADC scans: every code row against a batch of query LUTs, or one query's.
//
// Replaces repro/kernels/adc_scan.py::adc_scan_batch (Pallas,
// _adc_scan_batch_kernel).
//   out[q, n] = sum_j luts[q, j, codes[n, j]]
// The TPU kernel ran this as a bf16 one-hot GEMM on the MXU; this one sums
// the f32 LUT entries exactly as the plain version does (j order, f32).
//
// Bound on the H100: bytes, by the (Q, N) f32 output (4 GB at 1000 x 1M);
// the codes (N*M bytes) and LUTs are small next to it.
//
// Design: grid (row tiles, query tiles). A block stages the LUTs of its
// `tq` queries (tq * M * K floats) in shared memory once, then walks
// kRowIters tiles of blockDim rows, so each staged LUT serves many rows.
// One thread per row reads the row's codes once and keeps one accumulator
// per query of the tile in registers; out[q, n] writes are coalesced
// across the threads of a warp.

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

constexpr int kThreads = 256;
constexpr int kRowIters = 16;
constexpr int kMaxQueryTile = 8;
constexpr int kScanThreads = 256;   // adc_scan_kernel
constexpr int kScanBlocksPerSm = 4;

__global__ void adc_scan_batch_kernel(const uint8_t* __restrict__ codes,
                                      int64_t n, int m,
                                      const float* __restrict__ luts, int q,
                                      int k, int tq, float* __restrict__ out) {
  extern __shared__ float lut_s[];  // (tq, m, k)
  const int q0 = blockIdx.y * tq;
  const int nq = q - q0 < tq ? q - q0 : tq;
  const int mk = m * k;
  const float* src = luts + static_cast<int64_t>(q0) * mk;
  for (int i = threadIdx.x; i < nq * mk; i += blockDim.x) lut_s[i] = src[i];
  __syncthreads();

  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kRowIters * blockDim.x;
  for (int it = 0; it < kRowIters; ++it) {
    const int64_t row = tile0 + static_cast<int64_t>(it) * blockDim.x + threadIdx.x;
    if (row >= n) break;
    const uint8_t* c = codes + row * m;
    float acc[kMaxQueryTile];
#pragma unroll
    for (int t = 0; t < kMaxQueryTile; ++t) acc[t] = 0.f;
    for (int j = 0; j < m; ++j) {
      const int off = j * k + c[j];
#pragma unroll
      for (int t = 0; t < kMaxQueryTile; ++t)
        if (t < nq) acc[t] += lut_s[t * mk + off];
    }
#pragma unroll
    for (int t = 0; t < kMaxQueryTile; ++t)
      if (t < nq) out[static_cast<int64_t>(q0 + t) * n + row] = acc[t];
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

}  // namespace

extern "C" {

int adc_scan_batch_launch(const void* codes, int64_t n, int m,
                          const void* luts, int q, int k, int tq, void* out,
                          void* stream) {
  if (tq < 1 || tq > kMaxQueryTile) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(tq) * m * k * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      adc_scan_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows_per_block = static_cast<int64_t>(kRowIters) * kThreads;
  const dim3 grid(static_cast<unsigned>((n + rows_per_block - 1) / rows_per_block),
                  static_cast<unsigned>((q + tq - 1) / tq));
  adc_scan_batch_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), n, m, static_cast<const float*>(luts),
      q, k, tq, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
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
