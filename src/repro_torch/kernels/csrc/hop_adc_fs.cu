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
// Design: one thread per (query, frontier lane), kThreads to a block. When
// R' is a multiple of 32, so that a warp serves one query (every beam round
// of the main path), the rows are 8 bytes (M = 15 or 16) on an aligned base
// and the LUTs are 16-byte aligned, each warp stages its own query's LUT:
// lane j < m_eff first issues a 16-byte load of LUT row j, then every lane
// its id, then its packed row as one 8-byte load; only then does the LUT
// row go to shared memory and the warp meet its barrier, so the LUT's round
// trip runs beside the id -> row chain instead of before it, and no warp
// waits on another. A nibble is then one shared byte load. Otherwise (other
// R' such as the entry call's 1, other M, sliced tensors) a thread reads its
// row and the LUT entries byte by byte from global memory. An id outside
// [0, n_rows) is never read: its lane gets -1 (the wrapper's asynchronous
// assert fails the stream on such ids).
//
// What is left is latency: the launch, then two dependent round trips (the
// id, then the row) and the store. hop_adc_fs_empty_launch puts an empty
// kernel on the same grid, the floor no design of this kernel goes below.
// On the H100, holding each thread's 16 LUT rows in registers (16 loads of
// 16 bytes a thread), splitting a row over 2 or 4 lanes, one LUT copy per
// block behind a block barrier, warps that span queries (index arithmetic
// before the loads), and blocks of 64 to 512 threads were all slower.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// r % 32 == 0 (a warp serves one query), q * r < 2^31, 8-byte rows
// (mb == 8) on an 8-byte-aligned base, 16-byte-aligned LUTs, m_eff <= 16
__global__ void hop_adc_fs_warp_kernel(const uint8_t* __restrict__ codes,
                                       int64_t n_rows,
                                       const int32_t* __restrict__ ids, int q,
                                       int r, const uint8_t* __restrict__ luts,
                                       int m, int m_eff,
                                       int32_t* __restrict__ out) {
  __shared__ uint4 lut_s[kThreads / 32][16];  // each warp's query's LUT
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool live = t < q * r;
  uint4* ls = lut_s[threadIdx.x >> 5];
  uint4 lv = make_uint4(0, 0, 0, 0);
  if (live && lane < m_eff)
    lv = __ldg(reinterpret_cast<const uint4*>(luts) + static_cast<int64_t>(t / r) * m + lane);
  bool bad = true;
  uint2 c = make_uint2(0, 0);
  if (live) {
    const int64_t row = __ldg(ids + t);
    bad = row < 0 || row >= n_rows;
    if (!bad) c = __ldg(reinterpret_cast<const uint2*>(codes + row * 8));
  }
  if (lane < 16) ls[lane] = lv;
  __syncwarp();
  if (!live) return;
  if (bad) {
    out[t] = -1;
    return;
  }
  const uint8_t* lq = reinterpret_cast<const uint8_t*>(ls);
  int32_t acc = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (j < m_eff) {
      const uint32_t word = j < 8 ? c.x : c.y;
      acc += lq[j * 16 + ((word >> (4 * (j & 7))) & 15u)];
    }
  }
  out[t] = acc;
}

__global__ void hop_adc_fs_kernel(const uint8_t* __restrict__ codes,
                                  int64_t n_rows, int mb,
                                  const int32_t* __restrict__ ids, int q, int r,
                                  const uint8_t* __restrict__ luts, int m,
                                  int m_eff, int32_t* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<int64_t>(q) * r) return;
  const int64_t row = __ldg(ids + t);
  if (row < 0 || row >= n_rows) {
    out[t] = -1;
    return;
  }
  const uint8_t* lut = luts + (t / r) * m * 16;
  const uint8_t* c = codes + row * mb;
  int32_t acc = 0;
  const int full = m_eff >> 1;  // bytes whose two nibbles both count
  for (int b = 0; b < full; ++b) {
    const uint32_t byte = __ldg(c + b);
    acc += __ldg(lut + (2 * b) * 16 + (byte & 15u)) +
           __ldg(lut + (2 * b + 1) * 16 + (byte >> 4));
  }
  if (m_eff & 1) acc += __ldg(lut + (m_eff - 1) * 16 + (__ldg(c + full) & 15u));
  out[t] = acc;
}

__global__ void empty_kernel() {}

unsigned grid_for(int q, int r) {
  return static_cast<unsigned>((static_cast<int64_t>(q) * r + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int hop_adc_fs_launch(const void* codes, int64_t n_rows, int mb, const void* ids,
                      int q, int r, const void* luts, int m, int m_eff,
                      void* out, void* stream) {
  if (m_eff < 1 || m_eff > m || (m_eff + 1) / 2 > mb)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool warp = r % 32 == 0 && static_cast<int64_t>(q) * r < (int64_t{1} << 31) &&
                    mb == 8 && m_eff <= 16 && reinterpret_cast<uintptr_t>(codes) % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(luts) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* i = static_cast<const int32_t*>(ids);
  const auto* l = static_cast<const uint8_t*>(luts);
  auto* o = static_cast<int32_t*>(out);
  if (warp)
    hop_adc_fs_warp_kernel<<<grid_for(q, r), kThreads, 0, s>>>(c, n_rows, i, q, r, l, m,
                                                               m_eff, o);
  else
    hop_adc_fs_kernel<<<grid_for(q, r), kThreads, 0, s>>>(c, n_rows, mb, i, q, r, l, m,
                                                          m_eff, o);
  return static_cast<int>(cudaGetLastError());
}

int hop_adc_fs_empty_launch(int q, int r, void* stream) {
  empty_kernel<<<grid_for(q, r), kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* hop_adc_fs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
