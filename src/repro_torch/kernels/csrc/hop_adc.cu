// Fused per-hop ADC for the beam search: gather + LUT reduce in one kernel.
//
// Replaces repro/kernels/hop_adc.py::hop_adc (Pallas, _hop_adc_kernel).
//   out[q, i] = sum_{j < m_eff} luts[q, j, codes[ids[q, i], j]]
//
// Bound on the H100: bytes. Per round it reads each query's (M, K) f32 LUT
// (16 KB at M=16, K=256), R' ids and R' code rows of M bytes, and writes R'
// floats; the adds are negligible. The TPU kernel kept the shard's codes
// resident in VMEM; here the corpus codes stay uint8 in device memory and
// only the gathered rows are read.
//
// Design: one block per query. The block stages the first m_eff rows of its
// LUT in shared memory with coalesced loads, then one thread per frontier
// lane reads its row's codes and sums the m_eff shared-memory lookups in j
// order (the order of the plain version). m_prefix is the loop bound
// m_eff. An id outside [0, n_rows) is never read: its lane gets NaN (the
// wrapper's asynchronous assert fails the stream on such ids).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void hop_adc_kernel(const uint8_t* __restrict__ codes,
                               int64_t n_rows, int m,
                               const int32_t* __restrict__ ids, int r,
                               const float* __restrict__ luts, int k,
                               int m_eff, float* __restrict__ out) {
  extern __shared__ float lut_s[];  // (m_eff, k): this block's query
  const int64_t q = blockIdx.x;
  const float* lut_q = luts + q * m * k;
  const int n_lut = m_eff * k;
  for (int i = threadIdx.x; i < n_lut; i += blockDim.x) lut_s[i] = lut_q[i];
  __syncthreads();

  const int32_t* ids_q = ids + q * r;
  float* out_q = out + q * r;
  for (int i = threadIdx.x; i < r; i += blockDim.x) {
    const int64_t row = ids_q[i];
    if (row < 0 || row >= n_rows) {
      out_q[i] = __int_as_float(0x7fc00000);  // NaN
      continue;
    }
    const uint8_t* c = codes + row * m;
    float acc = 0.f;
    for (int j = 0; j < m_eff; ++j) acc += lut_s[j * k + c[j]];
    out_q[i] = acc;
  }
}

}  // namespace

extern "C" {

int hop_adc_launch(const void* codes, int64_t n_rows, int m, const void* ids,
                   int q, int r, const void* luts, int k, int m_eff,
                   void* out, void* stream) {
  const size_t smem = static_cast<size_t>(m_eff) * k * sizeof(float);
  if (smem > 48 * 1024) {  // beyond the default limit: opt in (M*K > 12288)
    cudaError_t err = cudaFuncSetAttribute(
        hop_adc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  hop_adc_kernel<<<q, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), n_rows, m,
      static_cast<const int32_t*>(ids), r, static_cast<const float*>(luts),
      k, m_eff, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* hop_adc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
