// Chunk sort, with or without run detection, for the counting pipeline.
//
// Replaces km_tpu/ops/pallas_sort.py::_sort_runs_kernel (entry
// sort_chunks_runs) and, as the mode without runs,
// km_tpu/ops/pallas_sort.py::_sort_kernel (entry sort_chunks). The keys
// are sorted ascending within independent `chunk`-sized chunks; then, in
// the same residency, every run of equal keys gets its length written at
// its first position (0 elsewhere), and runs of the sentinel 2^63-1 get
// 0. Without runs, the sorted chunk is written out and nothing else. A
// ragged last chunk is padded with the sentinel and only its real
// positions are written.
//
// What bounds it on an H100: the compare-exchange work of the bitonic
// network, log2(c)(log2(c)+1)/2 = 105 stages of 2^13 compare-exchanges
// for a chunk of 2^14 keys. Device memory sees the chunk once in and once
// out (20 B per key with the run lengths), which is a sixth of the kernel's
// time. So the design keeps the stages out of shared memory.
//
// Design: one block of chunk/16 threads per chunk; a thread keeps 16 keys
// in registers through the whole network, in one of three layouts.
// - Layout A: thread t holds elements 16t..16t+15. Strides 1..8 are
//   compare-exchanges between a thread's own registers. In the merges of
//   up to 512 elements, which lie inside a warp, strides 16..256 are
//   exchanges between lanes (__shfl_xor_sync): no shared memory, no barrier.
// - Layout B, for the strides of 512 and more of a larger merge (elements
//   held by different warps): the chunk goes through shared memory and each
//   thread takes the 16 elements that differ in the top four index bits, so
//   those strides are register exchanges too; for a 2^14 chunk the lane's
//   top bit carries index bit 9, so stride 512 is one shuffle.
// - Layout C, for the strides 16..256 of a larger merge: through shared
//   memory again, each thread takes the 16 elements that differ in index
//   bits 4..7 (register exchanges) and the lane's top bit carries bit 8 (one
//   shuffle). Then back to layout A for strides 8..1. A merge of 2^10 and
//   more so takes three trips through shared memory, two block barriers and
//   a warp barrier, and two shuffle stages, where the first version took a
//   barrier and a shared-memory round trip per stage.
// - Shared-memory index e is stored at e ^ (((e >> 4) & 7) << 1): layout
//   A moves 16-byte pairs, layouts B and C and the staging loops 8- and
//   16-byte words, all free of bank conflicts.
// - The chunk is staged in and out with coalesced 16-byte accesses when
//   the block is whole and the pointers are 16-byte aligned, else key by
//   key with a bounds check.
// - Run lengths come from the sorted keys in registers: the neighbour key
//   by one shuffle (one shared word per warp), a bit mask of run starts
//   per thread, a block-wide suffix minimum for the next run start after
//   the thread's segment, then a backward walk.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMinLog = 9;
constexpr int kMaxLog = 14;
// A thread holds 16 keys: a 2^14 chunk is a block of 1024 threads, held to
// 64 registers each, and a few keys spill. 32 keys (512 threads of up to 128
// registers, no spill in the network) measured 2% slower on an H100.
constexpr int kSegLog = 4;
constexpr int kSeg = 1 << kSegLog;
constexpr int kWarpBit = kSegLog + 5;  // lowest index bit that crosses warps
constexpr long long kSentinel = 0x7FFFFFFFFFFFFFFFLL;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int phys(int e) {
  return e ^ (((e >> kSegLog) & 7) << 1);
}

// compare-exchange of two registers; `a` is the element of lower index
__device__ __forceinline__ void ce(long long& a, long long& b, bool asc) {
  const bool sw = (a > b) == asc;
  const long long x = sw ? b : a;
  const long long y = sw ? a : b;
  a = x;
  b = y;
}

// exchange with the lane whose id differs in `mask`; the lane whose bit is
// clear holds the element of lower index (on equal keys either may be
// kept)
__device__ __forceinline__ void shfl_ce(long long& k, int mask,
                                        bool keep_min) {
  const long long other = __shfl_xor_sync(kFull, k, mask);
  k = ((other < k) == keep_min) ? other : k;
}

// the strides 2^top .. 1 of a merge between a thread's own registers
template <int kTop>
__device__ __forceinline__ void reg_strides(long long (&k)[kSeg], bool asc) {
#pragma unroll
  for (int sb = kTop; sb >= 0; --sb) {
#pragma unroll
    for (int r = 0; r < kSeg; ++r) {
      if (((r >> sb) & 1) == 0) ce(k[r], k[r | (1 << sb)], asc);
    }
  }
}

// the strides of one merge inside a warp, in layout A: lane bits top..0,
// then the register strides
__device__ __forceinline__ void warp_merge(long long (&k)[kSeg],
                                           int top, int lane, bool asc) {
  for (int b = top; b >= 0; --b) {
    const bool keep_min = ((lane & (1 << b)) == 0) == asc;
#pragma unroll
    for (int r = 0; r < kSeg; ++r) shfl_ce(k[r], 1 << b, keep_min);
  }
  reg_strides<kSegLog - 1>(k, asc);
}

__device__ __forceinline__ void load_a(const long long* s, int tid,
                                       long long (&k)[kSeg]) {
  const int sw = (tid & 7) << 1;  // phys() of this thread's elements
#pragma unroll
  for (int p = 0; p < kSeg / 2; ++p) {
    const longlong2 x = *reinterpret_cast<const longlong2*>(
        &s[tid * kSeg + ((2 * p) ^ sw)]);
    k[2 * p] = x.x;
    k[2 * p + 1] = x.y;
  }
}

__device__ __forceinline__ void store_a(long long* s, int tid,
                                        const long long (&k)[kSeg]) {
  const int sw = (tid & 7) << 1;
#pragma unroll
  for (int p = 0; p < kSeg / 2; ++p) {
    longlong2 x;
    x.x = k[2 * p];
    x.y = k[2 * p + 1];
    *reinterpret_cast<longlong2*>(&s[tid * kSeg + ((2 * p) ^ sw)]) = x;
  }
}

// Layout B exchanges the index bits from b_low up: b_low is its lowest
// register bit, or the lowest bit that crosses warps if that is lower.
// Layouts C and A take the bits below it.
template <int kLog>
struct BLow {
  static constexpr int value =
      kLog - kSegLog < kWarpBit ? kLog - kSegLog : kWarpBit;
};

// The strides 2^(M-1) .. 2^b_low of the merge of size 2^M, in layout B:
// register j of a thread holds element base_b + (j << (kLog - kSegLog)).
template <int kLog, int M>
__device__ __forceinline__ void merge_b(long long* s, int base_b, int lane,
                                        long long (&k)[kSeg]) {
  constexpr int RB = kLog - kSegLog;  // lowest index bit held in registers
#pragma unroll
  for (int j = 0; j < kSeg; ++j) k[j] = s[phys(base_b + (j << RB))];
#pragma unroll
  for (int sb = M - 1; sb >= BLow<kLog>::value; --sb) {
    if (sb >= RB) {
#pragma unroll
      for (int j = 0; j < kSeg; ++j) {
        if (((j >> (sb - RB)) & 1) == 0) {
          const bool asc = (M == kLog) || (((j >> (M - RB)) & 1) == 0);
          ce(k[j], k[j | (1 << (sb - RB))], asc);
        }
      }
    } else {
      // chunk 2^14, stride 512: index bit 9 is the lane's top bit in this
      // layout
      const bool lower = (lane & 16) == 0;
#pragma unroll
      for (int j = 0; j < kSeg; ++j) {
        const bool asc = (M == kLog) || (((j >> (M - RB)) & 1) == 0);
        shfl_ce(k[j], 16, lower == asc);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kSeg; ++j) s[phys(base_b + (j << RB))] = k[j];
}

// The strides 2^(b_low - 1) .. 2^4 of a merge, which layout B leaves, in
// layout C: register j of a thread holds element base_c + (j << 4), so index
// bits 4..7 are register bits, and the lane's top bit carries index bit 8.
// A warp holds the same 512 elements as in layout A, so the way back to A
// needs no block barrier.
template <int kLog>
__device__ __forceinline__ void merge_c(long long* s, int base_c, int lane,
                                        bool asc, long long (&k)[kSeg]) {
  constexpr int kTop = BLow<kLog>::value - 1;  // highest index bit left
  constexpr int kRegTop = 2 * kSegLog - 1;     // highest register bit here
#pragma unroll
  for (int j = 0; j < kSeg; ++j) k[j] = s[phys(base_c + (j << kSegLog))];
  if constexpr (kTop > kRegTop) {
    const bool keep_min = ((lane & 16) == 0) == asc;
#pragma unroll
    for (int j = 0; j < kSeg; ++j) shfl_ce(k[j], 16, keep_min);
  }
  reg_strides<(kTop < kRegTop ? kTop : kRegTop) - kSegLog>(k, asc);
#pragma unroll
  for (int j = 0; j < kSeg; ++j) s[phys(base_c + (j << kSegLog))] = k[j];
}

// merges of size 2^M .. 2^kLog: layout B for the strides across warps,
// layout C for the strides across lanes, layout A for those in a thread
template <int kLog, int M>
__device__ __forceinline__ void big_merges(long long* s, int tid, int lane,
                                           int base_b, int base_c,
                                           long long (&k)[kSeg]) {
  if constexpr (M <= kLog) {
    store_a(s, tid, k);
    __syncthreads();
    merge_b<kLog, M>(s, base_b, lane, k);
    __syncthreads();
    const bool asc = (M == kLog) || (((tid >> (M - kSegLog)) & 1) == 0);
    merge_c<kLog>(s, base_c, lane, asc, k);
    __syncwarp();
    load_a(s, tid, k);
    reg_strides<kSegLog - 1>(k, asc);
    big_merges<kLog, M + 1>(s, tid, lane, base_b, base_c, k);
  }
}

template <int kLog, bool kRuns>
__global__ void __launch_bounds__(1 << (kLog - kSegLog))
sort_runs_kernel(const long long* __restrict__ keys, long long n, int aligned,
                 long long* __restrict__ out_keys, int* __restrict__ out_len) {
  constexpr int C = 1 << kLog;
  constexpr int T = C / kSeg;
  static_assert(T >= 32, "a block is whole warps");
  extern __shared__ __align__(16) long long s[];
  __shared__ int s_warp_min[32];
  __shared__ long long s_warp_last[32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * C;
  const bool vec = aligned != 0 && base + C <= n;

  if (vec) {
    const longlong2* src = reinterpret_cast<const longlong2*>(keys + base);
#pragma unroll
    for (int i = 0; i < kSeg / 2; ++i) {
      const int v = i * T + tid;
      *reinterpret_cast<longlong2*>(&s[phys(2 * v)]) = src[v];
    }
  } else {
    for (int i = 0; i < kSeg; ++i) {
      const int e = i * T + tid;
      const long long p = base + e;
      s[phys(e)] = p < n ? keys[p] : kSentinel;
    }
  }
  __syncthreads();

  long long k[kSeg];
  load_a(s, tid, k);

  // merges inside a thread's registers, but for the last of them: the
  // direction is a bit of the register index
#pragma unroll
  for (int m = 1; m < kSegLog; ++m) {
#pragma unroll
    for (int sb = m - 1; sb >= 0; --sb) {
#pragma unroll
      for (int r = 0; r < kSeg; ++r) {
        if (((r >> sb) & 1) == 0)
          ce(k[r], k[r | (1 << sb)], ((r >> m) & 1) == 0);
      }
    }
  }
  // merges up to a warp's elements: the direction is a bit of the thread
  // index
  constexpr int kWarpTop = kLog < kWarpBit ? kLog : kWarpBit;
  for (int m = kSegLog; m <= kWarpTop; ++m) {
    const bool asc = (m == kLog) || (((tid >> (m - kSegLog)) & 1) == 0);
    warp_merge(k, m - kSegLog - 1, lane, asc);
  }
  // the larger merges
  const int base_b = kLog == 14
      ? ((lane & 15) | (warp << 4) | ((lane >> 4) << 9))
      : tid;
  const int base_c = (lane & 15) | ((lane >> 4) << 8) | (warp << 9);
  big_merges<kLog, kWarpBit + 1>(s, tid, lane, base_b, base_c, k);

  int* s_len = reinterpret_cast<int*>(s + C);
  if constexpr (kRuns) {
    const int seg = tid * kSeg;
    long long prev = __shfl_up_sync(kFull, k[kSeg - 1], 1);
    if (lane == 31) s_warp_last[warp] = k[kSeg - 1];
    // run starts after the segment's first key, and sentinel positions, as
    // bit masks: the keys can then leave the registers
    unsigned starts = 0;
    unsigned sentinels = k[0] == kSentinel ? 1u : 0u;
#pragma unroll
    for (int j = 1; j < kSeg; ++j) {
      if (k[j] != k[j - 1]) starts |= 1u << j;
      if (k[j] == kSentinel) sentinels |= 1u << j;
    }
    const long long k0 = k[0];
    store_a(s, tid, k);
    __syncthreads();
    if (lane == 0 && warp > 0) prev = s_warp_last[warp - 1];
    if (tid == 0 || k0 != prev) starts |= 1u;
    // first run start in this thread's segment (C if none)
    const int first = starts != 0 ? seg + __ffs(starts) - 1 : C;
    // inclusive suffix minimum within the warp
    int v = first;
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_down_sync(kFull, v, d);
      if (lane + d < 32) v = min(v, o);
    }
    if (lane == 0) s_warp_min[warp] = v;
    __syncthreads();
    int later = C;  // minimum over the warps after this one
    for (int w = warp + 1; w < T / 32; ++w) later = min(later, s_warp_min[w]);
    const int next_in_warp = __shfl_down_sync(kFull, v, 1);
    int next_start = lane == 31 ? later : min(next_in_warp, later);

    int len[kSeg];
#pragma unroll
    for (int j = kSeg - 1; j >= 0; --j) {
      len[j] = 0;
      if ((starts >> j) & 1u) {
        len[j] = ((sentinels >> j) & 1u) ? 0 : next_start - (seg + j);
        next_start = seg + j;
      }
    }
#pragma unroll
    for (int q = 0; q < kSeg / 4; ++q) {
      reinterpret_cast<int4*>(s_len)[tid * (kSeg / 4) + q] =
          make_int4(len[4 * q], len[4 * q + 1], len[4 * q + 2],
                    len[4 * q + 3]);
    }
  } else {
    store_a(s, tid, k);
  }
  __syncthreads();
  if (vec) {
    longlong2* dst = reinterpret_cast<longlong2*>(out_keys + base);
#pragma unroll
    for (int i = 0; i < kSeg / 2; ++i) {
      const int v = i * T + tid;
      dst[v] = *reinterpret_cast<const longlong2*>(&s[phys(2 * v)]);
    }
    if constexpr (kRuns) {
      int4* dst_len = reinterpret_cast<int4*>(out_len + base);
#pragma unroll
      for (int i = 0; i < kSeg / 4; ++i) {
        const int w = i * T + tid;
        dst_len[w] = reinterpret_cast<const int4*>(s_len)[w];
      }
    }
  } else {
    for (int i = 0; i < kSeg; ++i) {
      const int e = i * T + tid;
      const long long p = base + e;
      if (p < n) {
        out_keys[p] = s[phys(e)];
        if constexpr (kRuns) out_len[p] = s_len[e];
      }
    }
  }
}

template <int kLog, bool kRuns>
int launch_log(const void* keys, int64_t n, void* out_keys, void* out_len,
               void* stream) {
  constexpr int C = 1 << kLog;
  const size_t smem = static_cast<size_t>(C) * (kRuns ? 12 : 8);
  cudaError_t err = cudaFuncSetAttribute(
      sort_runs_kernel<kLog, kRuns>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(keys) |
                         reinterpret_cast<uintptr_t>(out_keys) |
                         reinterpret_cast<uintptr_t>(out_len);
  const long long grid = (n + C - 1) / C;
  sort_runs_kernel<kLog, kRuns>
      <<<static_cast<unsigned>(grid), C >> kSegLog, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const long long*>(keys), n, (bits & 15) == 0 ? 1 : 0,
          static_cast<long long*>(out_keys), static_cast<int*>(out_len));
  return static_cast<int>(cudaGetLastError());
}

template <bool kRuns>
int launch(const void* keys, int64_t n, int chunk, void* out_keys,
           void* out_len, void* stream) {
  if (chunk < (1 << kMinLog) || chunk > (1 << kMaxLog) ||
      (chunk & (chunk - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  switch (chunk) {
    case 1 << 9:
      return launch_log<9, kRuns>(keys, n, out_keys, out_len, stream);
    case 1 << 10:
      return launch_log<10, kRuns>(keys, n, out_keys, out_len, stream);
    case 1 << 11:
      return launch_log<11, kRuns>(keys, n, out_keys, out_len, stream);
    case 1 << 12:
      return launch_log<12, kRuns>(keys, n, out_keys, out_len, stream);
    case 1 << 13:
      return launch_log<13, kRuns>(keys, n, out_keys, out_len, stream);
    default:
      return launch_log<14, kRuns>(keys, n, out_keys, out_len, stream);
  }
}

}  // namespace

extern "C" int km_sort_runs(const void* keys, int64_t n, int chunk,
                            void* out_keys, void* out_len, void* stream) {
  return launch<true>(keys, n, chunk, out_keys, out_len, stream);
}

extern "C" int km_sort_chunks(const void* keys, int64_t n, int chunk,
                              void* out_keys, void* stream) {
  return launch<false>(keys, n, chunk, out_keys, nullptr, stream);
}
