// Fused per-hop ADC for the beam search: gather + LUT reduce in one kernel.
//
// Replaces repro/kernels/hop_adc.py::hop_adc (Pallas, _hop_adc_kernel).
//   out[q, i] = sum_{j < m_eff} luts[q, j, codes[ids[q, i], j]]
//
// Bound on the H100: bytes. Per round it reads each query's (M, K) f32 LUT
// (16 KB at M=16, K=256), R' ids and R' code rows of M bytes, and writes R'
// floats; the adds are negligible. The TPU kernel kept the shard's codes
// resident in VMEM; here the corpus codes stay in device memory and only the
// gathered rows are read.
//
// Design: one thread per (query, frontier lane), kThreads to a block, so no
// thread idles whatever R' is. A thread loads its id, then its code row into
// registers (16-byte loads where every row starts on 16 bytes, else one load
// per code), then reads the m_eff LUT entries its codes name straight from
// global memory (L2, where a search's LUTs stay from round to round), and
// sums them in j order from 0.f, the order of the plain version, so every
// output equals it bit for bit (csrc/lut_rows.cuh). The critical path is
// three dependent trips (id, row, LUT entries) and the launch. Staging each
// query's whole LUT in shared memory instead, by cp.async under the id and
// row trips, was slower on the H100 both L2-cold and L2-warm, and so was
// prefetching it into L2 by one bulk copy per query: either moves all of the
// LUT, 16 MB a round, while the random lookups touch ~87% of its 32-byte
// sectors, and the bulk traffic queues the id and row loads behind it.
// m_prefix is the loop bound m_eff. An id outside [0, n_rows) fails a
// device-side assert (the next synchronization raises) and is never read;
// built with NDEBUG, its lane would get NaN.
//
// Codes are uint8 (K <= 256) or int32 (any K, the reference's canonical
// dtype for K > 256): one template, the code type of the row. One launch
// covers the subspaces [0, m_eff) of rows of ldc codes, whatever the LUT's
// size: nothing is staged, so the 200 KB subspace chunks of the
// shared-memory kernels do not apply. The wrapper (hop_adc.py) picks how
// many 16-byte vectors of a row a thread holds in registers (kPre: 1, 2 or
// 4; 0 for rows off 16 bytes).

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lut_rows.cuh"

namespace {

constexpr int kThreads = 128;

template <typename CodeT, int kPre>  // kPre 0: one load per code
__global__ void hop_adc_kernel(const CodeT* __restrict__ codes, int64_t n_rows, int ldc,
                               const int32_t* __restrict__ ids, int q, int r,
                               const float* __restrict__ luts, int64_t ldl, int k,
                               int mc, float* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<int64_t>(q) * r) return;
  const int64_t id = __ldg(ids + t);
  const bool ok = id >= 0 && id < n_rows;
  assert(ok && "hop_adc: id outside [0, n_rows)");
  if (!ok) {
    out[t] = __int_as_float(0x7fc00000);  // NaN
    return;
  }
  const CodeT* row = codes + id * ldc;
  const float* lut = luts + (t / r) * ldl;
  if constexpr (kPre > 0) {
    uint4 pre[kPre];
    lut_rows::load_row(row, (mc * static_cast<int>(sizeof(CodeT)) + 15) / 16, pre);
    out[t] = lut_rows::sum_row<CodeT, kPre>(0.f, pre, row, mc, lut, k);
  } else {
    out[t] = lut_rows::sum_row_scalar(0.f, row, mc, lut, k);
  }
}

template <typename CodeT, int kPre>
cudaError_t launch(const void* codes, int64_t n_rows, int ldc, const void* ids, int q,
                   int r, const void* luts, int64_t ldl, int k, int mc, void* out,
                   cudaStream_t stream) {
  const int64_t lanes = static_cast<int64_t>(q) * r;
  const auto blocks = static_cast<unsigned>((lanes + kThreads - 1) / kThreads);
  hop_adc_kernel<CodeT, kPre><<<blocks, kThreads, 0, stream>>>(
      static_cast<const CodeT*>(codes), n_rows, ldc, static_cast<const int32_t*>(ids), q, r,
      static_cast<const float*>(luts), ldl, k, mc, static_cast<float*>(out));
  return cudaGetLastError();
}

template <typename CodeT>
cudaError_t launch_pre(int pre, const void* codes, int64_t n_rows, int ldc,
                       const void* ids, int q, int r, const void* luts, int64_t ldl,
                       int k, int mc, void* out, cudaStream_t s) {
  switch (pre) {
    case 0: return launch<CodeT, 0>(codes, n_rows, ldc, ids, q, r, luts, ldl, k, mc,
                                    out, s);
    case 1: return launch<CodeT, 1>(codes, n_rows, ldc, ids, q, r, luts, ldl, k, mc,
                                    out, s);
    case 2: return launch<CodeT, 2>(codes, n_rows, ldc, ids, q, r, luts, ldl, k, mc,
                                    out, s);
    case 4: return launch<CodeT, 4>(codes, n_rows, ldc, ids, q, r, luts, ldl, k, mc,
                                    out, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// codes: rows of ldc codes (uint8 when code_bytes == 1, int32 when 4), of
// which the first mc are summed; luts: query 0's (M, K) LUT, the next
// query's ldl floats on; pre: 16-byte row vectors a thread holds in
// registers (1, 2 or 4, rows on 16 bytes), or 0 (one load per code).
int hop_adc_launch(const void* codes, int code_bytes, int64_t n_rows, int ldc,
                   const void* ids, int q, int r, const void* luts, int64_t ldl,
                   int k, int mc, int pre, void* out, void* stream) {
  if (pre && (reinterpret_cast<uintptr_t>(codes) % 16 ||
              static_cast<int64_t>(ldc) * code_bytes % 16))
    return cudaErrorMisalignedAddress;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (code_bytes) {
    case 1: return static_cast<int>(launch_pre<uint8_t>(
        pre, codes, n_rows, ldc, ids, q, r, luts, ldl, k, mc, out, s));
    case 4: return static_cast<int>(launch_pre<int32_t>(
        pre, codes, n_rows, ldc, ids, q, r, luts, ldl, k, mc, out, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* hop_adc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
