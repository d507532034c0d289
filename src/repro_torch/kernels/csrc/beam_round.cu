// The classic beam round (expand = 1, no hop pruning) in two kernels, one
// on each side of the round's distance call (search/beam.py).
//
// Replaces no TPU kernel: the JAX package runs the round as XLA ops inside
// one vmapped while_loop (repro/search/beam.py::_beam). The port's lockstep
// loop ran the same ops eagerly, about 40 of them and three stable sorts a
// round, 96 launches; these two kernels take their place. Their plain
// versions (kernels/ref.py: beam_expand_ref, beam_merge_ref) are that op
// chain, and every output equals it bit for bit: no float arithmetic is done
// here, only comparisons and moves.
//
// Bound on the H100: bytes, on paper. Per round and lane they read the beam
// (h ids, dists and expanded flags: 13 bytes a slot), one adjacency row (R
// int32), a visited word per neighbor and R frontier entries, and write the
// frontier and the beam back: about 3 KB a lane at h = 96, R = 64, 30 MB
// at 10,000 lanes, or 9 us at HBM rate. In practice a lane is a chain of
// dependent loads (beam, id, row, visited words) and the merge a few
// hundred comparisons a thread; at 10,000 lanes on the H100 the pair takes
// 0.04 ms a round of the benchmark's offline cell (PERF.md section 6).
//
// Design: one warp per lane (the beam of one query, or of one shard of one
// query), kWarps lanes to a block, the beam and the frontier in registers
// (slot i of a chunk on thread i % 32).
//
// beam_expand: the beam is kept sorted, ties to the lower slot, so the
//   stable sort's pick of the best unexpanded finite entry is the FIRST slot
//   with !exp && d < inf: a ballot over the slots, whose loads all issue at
//   once. The lane's adjacency row is read coalesced; every slot is tested
//   against the lane's visited bitset before any bit is set (__syncwarp
//   between), then the bits are set with atomicOr. OR is idempotent, so the
//   bitset ends as the op chain's scatter-add of first occurrences, and an
//   id twice in the row stays fresh twice and is scored twice, as the
//   classic semantics want. The frontier goes out as int32 ids (0 where not
//   fresh, the distance call's canonical dtype) and a fresh mask. Block 0
//   clears the live count that beam_merge fills.
// beam_merge: the frontier ranks +inf where not fresh or tombstoned and
//   carries the sentinel id n where not fresh. Each entry's place in the
//   stable sort of beam ++ frontier is counted: a frontier slot lands after
//   the frontier keys below it or equal at a lower slot (the frontier's
//   keys go round the warp by shuffle) and after the beam keys at or below
//   it (an upper bound in the sorted beam, whose keys the warp keeps in
//   shared memory); the beam slots keep their order and fill the places
//   left, slot i the i-th (a bitmap of the places taken, in shared
//   memory). The places are a permutation, so the first h of them are
//   written back, each once, after every thread has read the beam
//   (__syncwarp). Keys order floats as the sort does: -0 as +0, NaN above
//   +inf. Then the lane's loop condition is evaluated on the new beam (the
//   cap on rounds, max_rounds, the cap on distance evaluations), and the
//   block adds its live lanes to one device int: the host reads it once a
//   round, the round's only wait. Counting places gives torch.sort's
//   permutation with no sort network; a first version also counted each
//   beam slot's place by shuffling every frontier key past it, and took
//   0.033 ms a round in the offline cell against 0.025 for this one.
//
// The kernels' names do not contain "hop_adc": the benchmark pairs each
// recorded distance call with the device kernel of that name.

#include <assert.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;           // lanes (warps) to a block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxFront = 4;        // frontier chunks of 32: R <= 128
constexpr int kMaxBeam = 8;         // beam chunks of 32: h <= 256

// A float's place in torch.sort's ascending order as an unsigned key: -0
// ranks as +0, every NaN above +inf and equal to every other NaN.
__device__ __forceinline__ uint32_t order_key(float x) {
  if (x != x) return 0xffffffffu;
  const uint32_t b = __float_as_uint(x == 0.f ? 0.f : x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The position of the k-th (from 0) set bit of m, which has more than k.
__device__ __forceinline__ int select_bit(uint32_t m, int k) {
  int pos = 0;
#pragma unroll
  for (int width = 16; width > 0; width >>= 1) {
    const int below = __popc(m & ((1u << width) - 1u));
    if (k >= below) {
      k -= below;
      m >>= width;
      pos += width;
    }
  }
  return pos;
}

__device__ __forceinline__ bool bit_set(const int32_t* words, int64_t id) {
  return (static_cast<uint32_t>(words[id >> 5]) >> (id & 31)) & 1u;
}

__global__ void __launch_bounds__(kThreads) beam_expand_kernel(
    const int32_t* __restrict__ nbrs, int64_t n, int r,
    const int64_t* __restrict__ ids, const float* __restrict__ dists,
    uint8_t* __restrict__ exp, const uint8_t* __restrict__ live,
    int32_t* __restrict__ visited, int64_t nwords, int32_t* __restrict__ hops,
    int32_t* __restrict__ ndist, int q, int h, int32_t* __restrict__ front,
    uint8_t* __restrict__ fresh_out, int32_t* __restrict__ count) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *count = 0;
  const int lane = threadIdx.x & 31;
  const int64_t qi = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (qi >= q) return;  // the whole warp
  const bool lv = live[qi];
  const float* d = dists + qi * h;
  uint8_t* e = exp + qi * h;
  bool cand[kMaxBeam];
#pragma unroll
  for (int c = 0; c < kMaxBeam; ++c) {  // every chunk's loads at once
    const int i = c * 32 + lane;
    cand[c] = i < h && !e[i] && d[i] < CUDART_INF_F;
  }
  int sel = -1;
#pragma unroll
  for (int c = kMaxBeam - 1; c >= 0; --c) {
    const unsigned b = __ballot_sync(kFull, cand[c]);
    if (b) sel = c * 32 + __ffs(b) - 1;
  }
  int32_t* out = front + qi * r;
  uint8_t* fo = fresh_out + qi * r;
  if (sel < 0 || !lv) {
    for (int j = lane; j < r; j += 32) {
      out[j] = 0;
      fo[j] = 0;
    }
    return;
  }
  const int64_t src = ids[qi * h + sel];
  assert(src >= 0 && src < n && "beam_expand: beam id outside [0, n)");
  const int32_t* row = nbrs + src * r;
  int32_t* vis = visited + qi * nwords;
  int32_t nb[kMaxFront];
  bool fr[kMaxFront];
#pragma unroll
  for (int c = 0; c < kMaxFront; ++c) {
    const int j = c * 32 + lane;
    nb[c] = j < r ? row[j] : 0;
    assert(nb[c] >= 0 && "beam_expand: negative neighbor id");
    fr[c] = j < r && nb[c] < n && !bit_set(vis, nb[c]);
  }
  __syncwarp();
  int found = 0;
#pragma unroll
  for (int c = 0; c < kMaxFront; ++c) {
    const int j = c * 32 + lane;
    if (fr[c])
      atomicOr(reinterpret_cast<unsigned*>(vis + (nb[c] >> 5)), 1u << (nb[c] & 31));
    if (j < r) {
      out[j] = fr[c] ? nb[c] : 0;
      fo[j] = fr[c];
    }
    found += __popc(__ballot_sync(kFull, fr[c]));
  }
  if (lane == 0) {
    e[sel] = 1;
    hops[qi] += 1;
    ndist[qi] += found;
  }
}

template <int kCB, int kCF>  // beam and frontier chunks held per thread
__global__ void __launch_bounds__(kThreads) beam_merge_kernel(
    int64_t* __restrict__ ids, float* __restrict__ dists, uint8_t* __restrict__ exp,
    const int32_t* __restrict__ front, const uint8_t* __restrict__ fresh,
    const float* __restrict__ front_d, const int32_t* __restrict__ tomb, int64_t n,
    int q, int h, int r, uint8_t* __restrict__ live, int32_t* __restrict__ step,
    const int32_t* __restrict__ ndist, int64_t max_steps, int64_t max_rounds,
    int64_t nd_cap, int32_t* __restrict__ count) {
  __shared__ uint32_t keys_s[kWarps][32 * kCB];  // each warp's beam keys
  __shared__ uint32_t taken_s[kWarps][kCB];      // places the frontier took
  const int lane = threadIdx.x & 31;
  const int64_t qi = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  bool live_new = false;
  if (qi < q) {
    const bool lv = live[qi];
    int64_t* bid = ids + qi * h;
    float* bd = dists + qi * h;
    uint8_t* be = exp + qi * h;
    float db[kCB];
    int64_t ib[kCB];
    bool eb[kCB];
    uint32_t kb[kCB];
#pragma unroll
    for (int c = 0; c < kCB; ++c) {
      const int i = c * 32 + lane;
      const bool in = i < h;
      db[c] = in ? bd[i] : CUDART_INF_F;
      ib[c] = in ? bid[i] : n;
      eb[c] = in ? be[i] != 0 : true;
      kb[c] = order_key(db[c]);
    }
    bool pend = false;
    if (lv) {
      uint32_t* ks = keys_s[threadIdx.x >> 5];
      uint32_t* taken = taken_s[threadIdx.x >> 5];
#pragma unroll
      for (int c = 0; c < kCB; ++c) ks[c * 32 + lane] = kb[c];
      if (lane < kCB) taken[lane] = 0;
      float df[kCF];
      int64_t idf[kCF];
      uint32_t kf[kCF];
      int rf[kCF];
#pragma unroll
      for (int c = 0; c < kCF; ++c) {
        const int j = c * 32 + lane;
        const int64_t o = qi * r + j;
        const bool f = j < r && fresh[o];
        const int32_t v = j < r ? front[o] : 0;
        const bool dead = f && tomb != nullptr && v < n && bit_set(tomb, v);
        df[c] = f && !dead ? front_d[o] : CUDART_INF_F;
        idf[c] = f ? v : n;
        kf[c] = order_key(df[c]);
        rf[c] = 0;
      }
      // a frontier slot's place: the frontier keys before it (below it, or
      // equal and at a lower slot), round the warp by shuffle ...
#pragma unroll
      for (int c2 = 0; c2 < kCF; ++c2) {
        for (int s = 0; s < 32 && c2 * 32 + s < r; ++s) {
          const uint32_t v = __shfl_sync(kFull, kf[c2], s);
          const int k = c2 * 32 + s;
#pragma unroll
          for (int c = 0; c < kCF; ++c)
            rf[c] += v < kf[c] || (v == kf[c] && k < c * 32 + lane);
        }
      }
      __syncwarp();
      // ... plus the beam keys at or below it (the beam wins ties): an
      // upper bound in the sorted beam
#pragma unroll
      for (int c = 0; c < kCF; ++c) {
        int lo = 0, hi = h;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (ks[mid] <= kf[c]) lo = mid + 1;
          else hi = mid;
        }
        rf[c] += lo;
        if (c * 32 + lane < r && rf[c] < h)
          atomicOr(taken + (rf[c] >> 5), 1u << (rf[c] & 31));
      }
      __syncwarp();
      // beam slot i keeps its order: it takes the i-th place no frontier
      // slot took
      uint32_t free_w[kCB];
#pragma unroll
      for (int w = 0; w < kCB; ++w) free_w[w] = ~taken[w];
      int rb[kCB];
#pragma unroll
      for (int c = 0; c < kCB; ++c) {
        const int i = c * 32 + lane;
        rb[c] = -1;
        int acc = 0;
#pragma unroll
        for (int w = 0; w < kCB; ++w) {
          const int z = __popc(free_w[w]);
          if (rb[c] < 0 && i < acc + z) rb[c] = 32 * w + select_bit(free_w[w], i - acc);
          acc += z;
        }
      }
#pragma unroll
      for (int c = 0; c < kCB; ++c) {
        if (c * 32 + lane < h && rb[c] >= 0 && rb[c] < h) {
          const bool en = eb[c] || db[c] == CUDART_INF_F;
          bid[rb[c]] = ib[c];
          bd[rb[c]] = db[c];
          be[rb[c]] = en;
          pend |= !en && db[c] < CUDART_INF_F;
        }
      }
#pragma unroll
      for (int c = 0; c < kCF; ++c) {
        if (c * 32 + lane < r && rf[c] < h) {
          const bool en = df[c] == CUDART_INF_F;
          bid[rf[c]] = idf[c];
          bd[rf[c]] = df[c];
          be[rf[c]] = en;
          pend |= !en && df[c] < CUDART_INF_F;
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < kCB; ++c) pend |= !eb[c] && db[c] < CUDART_INF_F;
    }
    const int64_t st = static_cast<int64_t>(step[qi]) + lv;
    live_new = __any_sync(kFull, pend) && st < max_steps && st < max_rounds &&
               ndist[qi] < nd_cap;
    if (lane == 0) {
      step[qi] = static_cast<int32_t>(st);
      live[qi] = live_new;
    }
  }
  const int n_live = __syncthreads_count(lane == 0 && live_new);
  if (threadIdx.x == 0 && n_live) atomicAdd(count, n_live);
}

template <int kCB>
cudaError_t launch_merge(int cf, dim3 grid, cudaStream_t s, int64_t* ids, float* dists,
                         uint8_t* exp, const int32_t* front, const uint8_t* fresh,
                         const float* front_d, const int32_t* tomb, int64_t n, int q,
                         int h, int r, uint8_t* live, int32_t* step,
                         const int32_t* ndist, int64_t max_steps, int64_t max_rounds,
                         int64_t nd_cap, int32_t* count) {
#define BEAM_MERGE(CF)                                                              \
  beam_merge_kernel<kCB, CF><<<grid, kThreads, 0, s>>>(                             \
      ids, dists, exp, front, fresh, front_d, tomb, n, q, h, r, live, step, ndist,  \
      max_steps, max_rounds, nd_cap, count)
  switch (cf) {
    case 1: BEAM_MERGE(1); break;
    case 2: BEAM_MERGE(2); break;
    case 4: BEAM_MERGE(4); break;
    default: return cudaErrorInvalidValue;
  }
#undef BEAM_MERGE
  return cudaGetLastError();
}

// chunks of 32 a thread holds for w slots: 1, 2, 4 or 8 (or 3 for the beam)
int chunks(int w, bool beam) {
  const int c = (w + 31) / 32;
  if (c <= 2 || (beam && c == 3)) return c;
  return c <= 4 ? 4 : 8;
}

}  // namespace

extern "C" {

// nbrs: (n, r) int32 adjacency; ids (q, h) int64, dists (q, h) f32, exp
// (q, h) bool: the sorted beam; live (q,) bool; visited (q, nwords) int32;
// hops, ndist (q,) int32; front (q, r) int32 and fresh (q, r) bool are
// written; count: one int32, cleared.
int beam_expand_launch(const void* nbrs, int64_t n, int r, const void* ids,
                       const void* dists, void* exp, const void* live, void* visited,
                       int64_t nwords, void* hops, void* ndist, int q, int h,
                       void* front, void* fresh, void* count, void* stream) {
  if (r < 1 || r > 32 * kMaxFront || h < 1 || h > 32 * kMaxBeam || q < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(q > 0 ? (q + kWarps - 1) / kWarps : 1);
  beam_expand_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(nbrs), n, r, static_cast<const int64_t*>(ids),
      static_cast<const float*>(dists), static_cast<uint8_t*>(exp),
      static_cast<const uint8_t*>(live), static_cast<int32_t*>(visited), nwords,
      static_cast<int32_t*>(hops), static_cast<int32_t*>(ndist), q, h,
      static_cast<int32_t*>(front), static_cast<uint8_t*>(fresh),
      static_cast<int32_t*>(count));
  return static_cast<int>(cudaGetLastError());
}

// ids, dists, exp: the beam, rewritten for live lanes; front, fresh: from
// beam_expand; front_d (q, r) f32: the distance call's output; tomb: a
// bitset of int32 words over [0, n), or null; live, step (q,): updated;
// ndist (q,) int32; the caps as int64 (INT64_MAX for none); count: summed.
int beam_merge_launch(void* ids, void* dists, void* exp, const void* front,
                      const void* fresh, const void* front_d, const void* tomb,
                      int64_t n, int q, int h, int r, void* live, void* step,
                      const void* ndist, int64_t max_steps, int64_t max_rounds,
                      int64_t nd_cap, void* count, void* stream) {
  if (r < 1 || r > 32 * kMaxFront || h < 1 || h > 32 * kMaxBeam || q < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(q > 0 ? (q + kWarps - 1) / kWarps : 1);
  const auto s = static_cast<cudaStream_t>(stream);
  const int cf = chunks(r, false);
#define LAUNCH(CB)                                                                  \
  launch_merge<CB>(cf, grid, s, static_cast<int64_t*>(ids), static_cast<float*>(dists), \
                   static_cast<uint8_t*>(exp), static_cast<const int32_t*>(front),  \
                   static_cast<const uint8_t*>(fresh),                              \
                   static_cast<const float*>(front_d),                              \
                   static_cast<const int32_t*>(tomb), n, q, h, r,                   \
                   static_cast<uint8_t*>(live), static_cast<int32_t*>(step),        \
                   static_cast<const int32_t*>(ndist), max_steps, max_rounds,       \
                   nd_cap, static_cast<int32_t*>(count))
  cudaError_t err;
  switch (chunks(h, true)) {
    case 1: err = LAUNCH(1); break;
    case 2: err = LAUNCH(2); break;
    case 3: err = LAUNCH(3); break;
    case 4: err = LAUNCH(4); break;
    case 8: err = LAUNCH(8); break;
    default: err = cudaErrorInvalidValue;
  }
#undef LAUNCH
  return static_cast<int>(err);
}

const char* beam_round_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
