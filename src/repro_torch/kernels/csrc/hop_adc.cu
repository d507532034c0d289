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
// LUT in shared memory with coalesced 16-byte loads, then one thread per frontier
// lane reads its row's codes and sums the m_eff shared-memory lookups in j
// order (the order of the plain version). m_prefix is the loop bound
// m_eff. An id outside [0, n_rows) is never read: its lane gets NaN (the
// wrapper's asynchronous assert fails the stream on such ids).
//
// Codes are uint8 (K <= 256) or int32 (any K, the reference's canonical
// dtype for K > 256): one template, the code type of the row. A launch
// covers the subspaces [j0, j0 + mc) of a row of ldc codes; the wrapper
// splits [0, m_eff) into chunks whose (mc, K) f32 LUT slice fits in shared
// memory (hop_adc.py) and launches once per chunk, each launch after the
// first starting its sums from the partial sums in `out`, so the sum stays
// one f32 chain in j order across chunk borders.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// Copies a query's LUT slice into shared memory, 16 bytes per load when
// the slice is 16-byte aligned (K % 4 == 0 and an aligned base), else one
// float per load.
__device__ __forceinline__ void stage_lut(const float* __restrict__ src, int n,
                                          float* __restrict__ dst) {
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < (n >> 2); i += blockDim.x) d4[i] = __ldg(s4 + i);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(src + i);
  }
}

template <typename CodeT>
__global__ void hop_adc_kernel(const CodeT* __restrict__ codes,
                               int64_t n_rows, int ldc,
                               const int32_t* __restrict__ ids, int r,
                               const float* __restrict__ luts, int64_t ldl,
                               int k, int mc, bool accumulate,
                               float* __restrict__ out) {
  extern __shared__ float4 lut_raw[];  // (mc, k): this block's query, this chunk
  float* lut_s = reinterpret_cast<float*>(lut_raw);
  const int64_t q = blockIdx.x;
  stage_lut(luts + q * ldl, mc * k, lut_s);
  __syncthreads();

  const int32_t* ids_q = ids + q * r;
  float* out_q = out + q * r;
  for (int i = threadIdx.x; i < r; i += blockDim.x) {
    const int64_t row = ids_q[i];
    if (row < 0 || row >= n_rows) {
      out_q[i] = __int_as_float(0x7fc00000);  // NaN
      continue;
    }
    const CodeT* c = codes + row * ldc;
    float acc = accumulate ? out_q[i] : 0.f;
    for (int j = 0; j < mc; ++j) acc += lut_s[j * k + static_cast<int>(c[j])];
    out_q[i] = acc;
  }
}

template <typename CodeT>
cudaError_t launch(const void* codes, int64_t n_rows, int ldc, const void* ids,
                   int q, int r, const void* luts, int64_t ldl, int k, int mc,
                   int accumulate, void* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(mc) * k * sizeof(float);
  if (smem > 48 * 1024) {  // beyond the default limit: opt in
    cudaError_t err = cudaFuncSetAttribute(
        hop_adc_kernel<CodeT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  hop_adc_kernel<CodeT><<<q, kThreads, smem, stream>>>(
      static_cast<const CodeT*>(codes), n_rows, ldc,
      static_cast<const int32_t*>(ids), r, static_cast<const float*>(luts),
      ldl, k, mc, accumulate != 0, static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// codes: the row array offset to subspace j0 (uint8 when code_bytes == 1,
// int32 when 4); luts: offset to row j0 of query 0's LUT, ldl floats apart.
int hop_adc_launch(const void* codes, int code_bytes, int64_t n_rows, int ldc,
                   const void* ids, int q, int r, const void* luts, int64_t ldl,
                   int k, int mc, int accumulate, void* out, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (code_bytes) {
    case 1: return static_cast<int>(launch<uint8_t>(
        codes, n_rows, ldc, ids, q, r, luts, ldl, k, mc, accumulate, out, s));
    case 4: return static_cast<int>(launch<int32_t>(
        codes, n_rows, ldc, ids, q, r, luts, ldl, k, mc, accumulate, out, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* hop_adc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
