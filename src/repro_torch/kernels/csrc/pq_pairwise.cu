// Per-subspace squared distances between sub-vectors and codewords.
//
// Replaces repro/kernels/pq_pairwise.py::pq_pairwise (Pallas,
// _pq_pairwise_kernel).
//   out[n, j, k] = x2[n, j] - 2 * <x[n, j], c[j, k]> + c2[j, k]
// in that formula, as the plain version (ref.pq_pairwise_ref) computes it.
//
// Bound on the H100: bytes, by the output writes. Each output costs
// 2*dsub + 3 flops for 4 bytes written (19 flops / 4 B at dsub = 8), far
// under the card's 20 flops per byte in f32. The TPU kernel ran the cross
// term as an MXU matmul; here the (N, M, K) table is what costs, so the
// design keeps every write coalesced and every read on chip.
//
// Design: grid (N / kRows, M). A block stages kRows sub-vectors of subspace
// j and their norms in shared memory. Each thread owns codewords
// t, t + blockDim, ...: it keeps the codeword in registers (DSUB known at
// compile time) or reads it through L1 (any other dsub), and writes the
// row's K outputs, which neighbouring threads place at neighbouring
// addresses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;

template <int DSUB>
__global__ void pq_pairwise_kernel(const float* __restrict__ x,
                                   const float* __restrict__ cb,
                                   float* __restrict__ out, int64_t n, int m,
                                   int k, int dsub_rt) {
  const int dsub = DSUB > 0 ? DSUB : dsub_rt;
  extern __shared__ float smem[];
  float* xs = smem;                // (kRows, dsub)
  float* x2s = smem + kRows * dsub;  // (kRows,)
  const int j = blockIdx.y;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(n - n0 < kRows ? n - n0 : kRows);

  for (int i = threadIdx.x; i < rows * dsub; i += blockDim.x) {
    const int rr = i / dsub;
    const int d = i - rr * dsub;
    xs[i] = x[((n0 + rr) * m + j) * dsub + d];
  }
  __syncthreads();
  for (int rr = threadIdx.x; rr < rows; rr += blockDim.x) {
    float s = 0.f;
    for (int d = 0; d < dsub; ++d) s += xs[rr * dsub + d] * xs[rr * dsub + d];
    x2s[rr] = s;
  }
  __syncthreads();

  const float* cbj = cb + static_cast<int64_t>(j) * k * dsub;
  for (int kk = threadIdx.x; kk < k; kk += blockDim.x) {
    const float* c = cbj + static_cast<int64_t>(kk) * dsub;
    float* o = out + (n0 * m + j) * k + kk;
    const int64_t row_stride = static_cast<int64_t>(m) * k;
    if constexpr (DSUB > 0) {
      float creg[DSUB];
      float c2 = 0.f;
#pragma unroll
      for (int d = 0; d < DSUB; ++d) {
        creg[d] = c[d];
        c2 += creg[d] * creg[d];
      }
      for (int rr = 0; rr < rows; ++rr) {
        const float* xr = xs + rr * DSUB;
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < DSUB; ++d) acc += xr[d] * creg[d];
        o[rr * row_stride] = x2s[rr] - 2.f * acc + c2;
      }
    } else {
      float c2 = 0.f;
      for (int d = 0; d < dsub; ++d) c2 += c[d] * c[d];
      for (int rr = 0; rr < rows; ++rr) {
        const float* xr = xs + rr * dsub;
        float acc = 0.f;
        for (int d = 0; d < dsub; ++d) acc += xr[d] * c[d];
        o[rr * row_stride] = x2s[rr] - 2.f * acc + c2;
      }
    }
  }
}

template <int DSUB>
cudaError_t launch(const float* x, const float* cb, float* out, int64_t n,
                   int m, int k, int dsub, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(kRows) * dsub + kRows) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      pq_pairwise_kernel<DSUB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((n + kRows - 1) / kRows), m);
  pq_pairwise_kernel<DSUB><<<grid, kThreads, smem, stream>>>(x, cb, out, n, m,
                                                             k, dsub);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int pq_pairwise_launch(const void* x, const void* cb, void* out, int64_t n,
                       int m, int k, int dsub, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* cf = static_cast<const float*>(cb);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dsub) {
    case 2: err = launch<2>(xf, cf, of, n, m, k, dsub, s); break;
    case 4: err = launch<4>(xf, cf, of, n, m, k, dsub, s); break;
    case 8: err = launch<8>(xf, cf, of, n, m, k, dsub, s); break;
    case 16: err = launch<16>(xf, cf, of, n, m, k, dsub, s); break;
    case 32: err = launch<32>(xf, cf, of, n, m, k, dsub, s); break;
    default: err = launch<0>(xf, cf, of, n, m, k, dsub, s); break;
  }
  return static_cast<int>(err);
}

const char* pq_pairwise_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
