// Fused per-hop fast-scan ADC for the beam search: gather + LUT reduce.
//
// Replaces repro/kernels/hop_adc.py::hop_adc_fs (Pallas, _hop_adc_fs_kernel).
//   out[q, i] = sum_{j < m_eff} luts[q, j, code_j(codes[ids[q, i]])]   (int32)
// where code_j is the low nibble of packed byte j/2 for even j and the high
// nibble for odd j (repro_torch/pq/pack.py). The sum is exact; the wrapper's
// caller (ops.hop_adc_fs) applies the per-query dequant affine, so the float
// op order matches the plain version.
//
// Bound on the H100: bytes, and at the main path's size (Q=1000, R'=64,
// M=16) launch latency in practice. Per round it reads R' ids, R' packed
// rows of ceil(M/2) bytes and each query's (M, 16) u8 LUT (256 bytes), and
// writes R' int32; about 1 MB in all, a third of a microsecond at HBM
// rate. The TPU kernel kept the shard's packed codes resident in VMEM; here
// they stay in device memory and only the gathered rows are read.
//
// Design: one block per query. The block stages the first m_eff rows of its
// u8 LUT (16 bytes each) in shared memory, then one thread per frontier lane
// loads its row's packed bytes, splits each byte into its two nibbles and
// sums the m_eff lookups in int32. Staging the 256-byte LUT costs less than
// building a paired (ceil(M/2), 256) table at R'=64, so the lookups stay
// per nibble. An id outside [0, n_rows) is never read: its lane gets -1 (the
// wrapper's asynchronous assert fails the stream on such ids).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

__global__ void hop_adc_fs_kernel(const uint8_t* __restrict__ codes,
                                  int64_t n_rows, int mb,
                                  const int32_t* __restrict__ ids, int r,
                                  const uint8_t* __restrict__ luts, int m,
                                  int m_eff, int32_t* __restrict__ out) {
  extern __shared__ uint8_t lut_s[];  // (m_eff, 16): this block's query
  const int64_t q = blockIdx.x;
  const uint8_t* lut_q = luts + q * m * 16;
  for (int i = threadIdx.x; i < m_eff * 16; i += blockDim.x) lut_s[i] = lut_q[i];
  __syncthreads();

  const int32_t* ids_q = ids + q * r;
  int32_t* out_q = out + q * r;
  const int full = m_eff >> 1;  // bytes whose two nibbles both count
  for (int i = threadIdx.x; i < r; i += blockDim.x) {
    const int64_t row = ids_q[i];
    if (row < 0 || row >= n_rows) {
      out_q[i] = -1;
      continue;
    }
    const uint8_t* c = codes + row * mb;
    int32_t acc = 0;
    for (int b = 0; b < full; ++b) {
      const uint32_t byte = c[b];
      acc += lut_s[(2 * b) * 16 + (byte & 15u)] + lut_s[(2 * b + 1) * 16 + (byte >> 4)];
    }
    if (m_eff & 1) acc += lut_s[(m_eff - 1) * 16 + (c[full] & 15u)];
    out_q[i] = acc;
  }
}

}  // namespace

extern "C" {

int hop_adc_fs_launch(const void* codes, int64_t n_rows, int mb, const void* ids,
                      int q, int r, const void* luts, int m, int m_eff,
                      void* out, void* stream) {
  if (m_eff < 1 || m_eff > m || (m_eff + 1) / 2 > mb)
    return static_cast<int>(cudaErrorInvalidValue);
  int threads = (r + 31) / 32 * 32;
  threads = threads > kMaxThreads ? kMaxThreads : threads;
  const size_t smem = static_cast<size_t>(m_eff) * 16;
  if (smem > 48 * 1024) {  // beyond the default limit: opt in (M > 3072)
    cudaError_t err = cudaFuncSetAttribute(
        hop_adc_fs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  hop_adc_fs_kernel<<<q, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), n_rows, mb,
      static_cast<const int32_t*>(ids), r, static_cast<const uint8_t*>(luts),
      m, m_eff, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* hop_adc_fs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
