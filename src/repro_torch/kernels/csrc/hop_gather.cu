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
// stages its LUT in shared memory with coalesced 16-byte loads; one thread per lane
// reads that lane's M code bytes and sums the M shared-memory lookups in j
// order, the order of hop_adc, so hop_gather(codes[ids], luts) equals
// hop_adc(codes, ids, luts) bit for bit. Codes are uint8 or int32 (one
// template), and a launch covers the subspaces [j0, j0 + mc), chunked and
// chained through `out` as in hop_adc.cu.

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
__global__ void hop_gather_kernel(const CodeT* __restrict__ codes, int r,
                                  int ldc, const float* __restrict__ luts,
                                  int64_t ldl, int k, int mc, bool accumulate,
                                  float* __restrict__ out) {
  extern __shared__ float4 lut_raw[];  // (mc, k): this block's query, this chunk
  float* lut_s = reinterpret_cast<float*>(lut_raw);
  const int64_t q = blockIdx.x;
  stage_lut(luts + q * ldl, mc * k, lut_s);
  __syncthreads();

  const CodeT* codes_q = codes + q * r * ldc;
  float* out_q = out + q * r;
  for (int i = threadIdx.x; i < r; i += blockDim.x) {
    const CodeT* c = codes_q + static_cast<int64_t>(i) * ldc;
    float acc = accumulate ? out_q[i] : 0.f;
    for (int j = 0; j < mc; ++j) acc += lut_s[j * k + static_cast<int>(c[j])];
    out_q[i] = acc;
  }
}

template <typename CodeT>
cudaError_t launch(const void* codes, int q, int r, int ldc, const void* luts,
                   int64_t ldl, int k, int mc, int accumulate, void* out,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(mc) * k * sizeof(float);
  if (smem > 48 * 1024) {  // beyond the default limit: opt in
    cudaError_t err = cudaFuncSetAttribute(
        hop_gather_kernel<CodeT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  hop_gather_kernel<CodeT><<<q, kThreads, smem, stream>>>(
      static_cast<const CodeT*>(codes), r, ldc, static_cast<const float*>(luts),
      ldl, k, mc, accumulate != 0, static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// codes: (Q, R, ldc) rows offset to subspace j0 (uint8 when code_bytes == 1,
// int32 when 4); luts: offset to row j0 of query 0's LUT, ldl floats apart.
int hop_gather_launch(const void* codes, int code_bytes, int q, int r, int ldc,
                      const void* luts, int64_t ldl, int k, int mc,
                      int accumulate, void* out, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (code_bytes) {
    case 1: return static_cast<int>(launch<uint8_t>(
        codes, q, r, ldc, luts, ldl, k, mc, accumulate, out, s));
    case 4: return static_cast<int>(launch<int32_t>(
        codes, q, r, ldc, luts, ldl, k, mc, accumulate, out, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* hop_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
