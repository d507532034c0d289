// Per-hop ADC on pre-gathered code rows: LUT reduce only.
//
// Replaces repro/kernels/hop_gather.py::hop_gather (Pallas,
// _hop_gather_kernel), the pre-fusion beam round that hop_adc superseded.
//   out[q, r] = sum_j luts[q, j, codes[q, r, j]]
//
// Bound on the H100: bytes. Each query's (M, K) f32 LUT (16 KB at M=16,
// K=256) dominates the reads; the (Q, R, M) code bytes and the (Q, R)
// outputs are small next to it.
//
// Design: hop_adc.cu without the id indirection. One block per query
// stages its LUT in shared memory with coalesced loads; one thread per lane
// reads that lane's M code bytes and sums the M shared-memory lookups in j
// order, the order of hop_adc, so hop_gather(codes[ids], luts) equals
// hop_adc(codes, ids, luts) bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void hop_gather_kernel(const uint8_t* __restrict__ codes, int r,
                                  int m, const float* __restrict__ luts, int k,
                                  float* __restrict__ out) {
  extern __shared__ float lut_s[];  // (m, k): this block's query
  const int64_t q = blockIdx.x;
  const int mk = m * k;
  const float* lut_q = luts + q * mk;
  for (int i = threadIdx.x; i < mk; i += blockDim.x) lut_s[i] = lut_q[i];
  __syncthreads();

  const uint8_t* codes_q = codes + q * r * m;
  float* out_q = out + q * r;
  for (int i = threadIdx.x; i < r; i += blockDim.x) {
    const uint8_t* c = codes_q + static_cast<int64_t>(i) * m;
    float acc = 0.f;
    for (int j = 0; j < m; ++j) acc += lut_s[j * k + c[j]];
    out_q[i] = acc;
  }
}

}  // namespace

extern "C" {

int hop_gather_launch(const void* codes, int q, int r, int m, const void* luts,
                      int k, void* out, void* stream) {
  const size_t smem = static_cast<size_t>(m) * k * sizeof(float);
  if (smem > 48 * 1024) {  // beyond the default limit: opt in (M*K > 12288)
    cudaError_t err = cudaFuncSetAttribute(
        hop_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  hop_gather_kernel<<<q, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), r, m, static_cast<const float*>(luts),
      k, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* hop_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
