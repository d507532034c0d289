// Batched fast-scan ADC: every packed code row against a batch of u8 LUTs.
//
// Replaces repro/kernels/adc_scan_fs.py::adc_scan_fs (Pallas,
// _adc_scan_fs_kernel).
//   out[q, n] = sum_j luts[q, j, code_j(codes[n])]   (int32, exact)
// with code_j the low nibble of packed byte j/2 for even j, the high nibble
// for odd j (repro_torch/pq/pack.py). The TPU kernel ran this as a bf16
// one-hot GEMM on the MXU; here the sums are integer lookups. The dequant
// affine stays in ops.adc_scan_fs, so the float op order matches the plain
// version.
//
// Bound on the H100: bytes, by the (Q, N) int32 output (4 GB at 1000 x 1M,
// 1.19 ms at 3.35 TB/s); the packed codes (N * ceil(M/2) bytes) and the u8
// LUTs are small next to it. Below that, shared-memory lookups: the f32
// adc_scan_batch kernel, with one lookup per sub-code and query, stopped at
// ~11x its bound on bank conflicts.
//
// Design: grid (row tiles, query tiles of kTileQ = 8). A block builds, in
// shared memory, the PAIRED table of its 8 queries, interleaved by query:
//   tab[b][byte] = 8 u16 values lut[q, 2b, byte & 15] + lut[q, 2b+1, byte >> 4]
// (sums <= 510), one 16-byte entry per (b, byte). One thread per code row
// then reads ceil(M/2) packed bytes and, per byte, ONE 16-byte shared load
// that scores two sub-codes for all 8 queries at once: 16x fewer lookups
// than one per (sub-code, query). The 8 sums live as u16 pairs in four
// 32-bit registers (a sum is <= M * 255 < 2^16 for M <= 256, so halves
// never carry into each other), and the 8 int32 outputs are written along
// N, coalesced across the warp. Odd M: the last byte's high nibble is 0 and
// its table half is zero, as the plain version's padded LUT row.
//
// A launch covers the packed bytes [b0, b0 + mbc) of rows of ldc bytes (the
// sub-codes [2 b0, 2 b0 + m)): the wrapper (adc_scan_fs.py) splits a row
// whose paired table would pass its shared-memory budget (M > 100) into
// chunks and launches once per chunk, each launch after the first adding
// its exact int32 sums to those in `out`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowIters = 32;
constexpr int kTileQ = 8;

template <bool kVec4>
__global__ void adc_scan_fs_kernel(const uint8_t* __restrict__ codes,
                                   int64_t n, int ldc, int mb,
                                   const uint8_t* __restrict__ luts,
                                   int64_t ldl, int q, int m, bool accumulate,
                                   int32_t* __restrict__ out) {
  extern __shared__ uint4 tab[];  // (mb, 256): 8 u16 per entry
  uint32_t* tab_w = reinterpret_cast<uint32_t*>(tab);
  const int q0 = blockIdx.y * kTileQ;
  const int nq = q - q0 < kTileQ ? q - q0 : kTileQ;

  // word i = (b, byte, w): queries 2w (low half) and 2w+1 (high half)
  for (int i = threadIdx.x; i < mb * 256 * 4; i += blockDim.x) {
    const int w = i & 3, byte = (i >> 2) & 255, b = i >> 10;
    uint32_t word = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = 2 * w + h;
      if (t < nq) {
        const uint8_t* l = luts + static_cast<int64_t>(q0 + t) * ldl;
        uint32_t v = l[(2 * b) * 16 + (byte & 15)];
        if (2 * b + 1 < m) v += l[(2 * b + 1) * 16 + (byte >> 4)];
        word |= v << (16 * h);
      }
    }
    tab_w[i] = word;
  }
  __syncthreads();

  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kRowIters * blockDim.x;
  for (int it = 0; it < kRowIters; ++it) {
    const int64_t row = tile0 + static_cast<int64_t>(it) * blockDim.x + threadIdx.x;
    if (row >= n) break;
    const uint8_t* c = codes + row * ldc;
    uint32_t a0 = 0, a1 = 0, a2 = 0, a3 = 0;
    for (int b0 = 0; b0 < mb; b0 += 4) {
      uint32_t word;
      if (kVec4) {
        word = *reinterpret_cast<const uint32_t*>(c + b0);
      } else {
        word = 0;
        for (int k = 0; k < 4 && b0 + k < mb; ++k)
          word |= static_cast<uint32_t>(c[b0 + k]) << (8 * k);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (b0 + k < mb) {
          const uint4 v = tab[(b0 + k) * 256 + ((word >> (8 * k)) & 255u)];
          a0 += v.x; a1 += v.y; a2 += v.z; a3 += v.w;
        }
      }
    }
    const uint32_t acc[4] = {a0, a1, a2, a3};
#pragma unroll
    for (int t = 0; t < kTileQ; ++t) {
      if (t < nq) {
        const uint32_t s = (t & 1) ? (acc[t >> 1] >> 16) : (acc[t >> 1] & 0xFFFFu);
        int32_t* o = out + static_cast<int64_t>(q0 + t) * n + row;
        *o = accumulate ? *o + static_cast<int32_t>(s) : static_cast<int32_t>(s);
      }
    }
  }
}

}  // namespace

extern "C" {

// codes: rows of ldc bytes offset to packed byte b0; luts: offset to
// sub-code 2 b0 of query 0's LUT, ldl bytes apart; m: this chunk's sub-codes.
int adc_scan_fs_launch(const void* codes, int64_t n, int ldc, int mb,
                       const void* luts, int64_t ldl, int q, int m,
                       int accumulate, void* out, void* stream) {
  if (m < 1 || m > 256 || mb != (m + 1) / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(mb) * 256 * sizeof(uint4);
  const bool vec4 = mb % 4 == 0 && ldc % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(codes) % 4 == 0;
  const auto kernel = vec4 ? adc_scan_fs_kernel<true> : adc_scan_fs_kernel<false>;
  if (smem > 48 * 1024) {  // beyond the default limit: opt in (M > 24)
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t rows_per_block = static_cast<int64_t>(kRowIters) * kThreads;
  const dim3 grid(static_cast<unsigned>((n + rows_per_block - 1) / rows_per_block),
                  static_cast<unsigned>((q + kTileQ - 1) / kTileQ));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), n, ldc, mb,
      static_cast<const uint8_t*>(luts), ldl, q, m, accumulate != 0,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* adc_scan_fs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
