// Batched ADC scan: every code row against a batch of query LUTs.
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowIters = 16;
constexpr int kMaxQueryTile = 8;

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

const char* adc_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
