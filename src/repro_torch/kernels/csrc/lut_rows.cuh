// Pieces shared by the f32-LUT kernels of hop_adc.cu and of adc_scan.cu's
// one-query scan: one code row's sum of LUT entries in j order, from 16-byte
// row loads held in registers or from one load per code. The LUT may be in
// shared or in global memory.
//
// Every sum here is one f32 chain in j order from the value it is given (0.f,
// or the partial sum of an earlier subspace chunk), so it equals the plain
// versions (repro_torch/kernels/ref.py) bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lut_rows {

// The first kPre 16-byte vectors of a row that starts on 16 bytes, into
// registers; only the first nv exist (nv = 0 loads nothing).
template <int kPre>
__device__ __forceinline__ void load_row(const void* row, int nv, uint4 (&v)[kPre]) {
#pragma unroll
  for (int i = 0; i < kPre; ++i)
    v[i] = i < nv ? __ldg(static_cast<const uint4*>(row) + i) : make_uint4(0, 0, 0, 0);
}

// acc plus the LUT entries of the codes that one 16-byte vector holds for
// subspaces j0, j0 + 1, ... below mc, in j order.
template <typename CodeT>
__device__ __forceinline__ float add_vec(float acc, uint4 w, int j0, int mc,
                                         const float* lut, int k) {
  const uint32_t x[4] = {w.x, w.y, w.z, w.w};
  if constexpr (sizeof(CodeT) == 1) {
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (j0 + b < mc) acc += lut[(j0 + b) * k + ((x[b >> 2] >> (8 * (b & 3))) & 0xFF)];
  } else {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (j0 + b < mc) acc += lut[(j0 + b) * k + static_cast<int>(x[b])];
  }
  return acc;
}

// acc + sum_{j < mc} lut[j * k + row[j]] in j order, for a row that starts
// on 16 bytes: its first kPre vectors from registers (load_row), the rest
// loaded here.
template <typename CodeT, int kPre>
__device__ __forceinline__ float sum_row(float acc, const uint4 (&pre)[kPre],
                                         const CodeT* row, int mc, const float* lut,
                                         int k) {
  constexpr int kPer = 16 / sizeof(CodeT);  // codes per vector
  const int nv = (mc + kPer - 1) / kPer;
#pragma unroll
  for (int v = 0; v < kPre; ++v)
    if (v < nv) acc = add_vec<CodeT>(acc, pre[v], v * kPer, mc, lut, k);
  for (int v = kPre; v < nv; ++v)
    acc = add_vec<CodeT>(acc, __ldg(reinterpret_cast<const uint4*>(row) + v), v * kPer,
                         mc, lut, k);
  return acc;
}

// The same sum with one load per code, for rows off 16 bytes.
template <typename CodeT>
__device__ __forceinline__ float sum_row_scalar(float acc, const CodeT* row, int mc,
                                                const float* lut, int k) {
  for (int j = 0; j < mc; ++j) acc += lut[j * k + static_cast<int>(__ldg(row + j))];
  return acc;
}

}  // namespace lut_rows
