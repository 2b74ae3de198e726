// Chunk sort, with or without run detection, for the counting pipeline.
//
// Replaces km_tpu/ops/pallas_sort.py::_sort_runs_kernel (entry
// sort_chunks_runs) and, as the mode without runs,
// km_tpu/ops/pallas_sort.py::_sort_kernel (entry sort_chunks). The keys
// are sorted ascending within independent `chunk`-sized chunks; then, in
// the same residency, every run of equal keys gets its length written at
// its first position (0 elsewhere), and runs of the sentinel 2^63-1 get
// 0. Without runs, the sorted chunk is written out and nothing else. A
// ragged last chunk is padded with the sentinel in shared memory and
// only its real positions are written.
//
// What bounds it on an H100: shared-memory compare-exchange work. A chunk
// of 2^14 keys takes log2(c)(log2(c)+1)/2 = 105 bitonic stages of 2^13
// compare-exchanges each, every one a pair of 8-byte shared loads and
// stores; device memory sees the chunk once in and once out.
//
// Design: one block of chunk/16 threads per chunk, the whole chunk in
// dynamic shared memory (2^14 int64 keys = 128 KB of the 227 KB a block
// may use), a bitonic network with one barrier per stage. Run detection
// needs no second pass over device memory and no long serial scan: each
// thread owns 16 consecutive sorted keys, finds the first run start in
// them, and a block-wide suffix minimum of those (warp shuffles, then the
// 32 warp minima) gives every thread the next run start after its
// segment; the thread then walks its segment backwards.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kSeg = 16;  // keys per thread
constexpr int kMinChunk = 32 * kSeg;
constexpr int kMaxChunk = 1 << 14;
constexpr long long kSentinel = 0x7FFFFFFFFFFFFFFFLL;

template <bool kRuns>
__global__ void sort_runs_kernel(const long long* __restrict__ keys,
                                 long long n, int chunk,
                                 long long* __restrict__ out_keys,
                                 int* __restrict__ out_len) {
  extern __shared__ long long s[];
  __shared__ int s_warp_min[32];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const long long base = static_cast<long long>(blockIdx.x) * chunk;

  for (int i = tid; i < chunk; i += nthreads) {
    const long long p = base + i;
    s[i] = p < n ? keys[p] : kSentinel;
  }
  __syncthreads();

  // bitonic network, ascending overall
  const int half = chunk >> 1;
  for (int size = 2; size <= chunk; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int idx = tid; idx < half; idx += nthreads) {
        const int lo = 2 * idx - (idx & (stride - 1));
        const int hi = lo + stride;
        const long long a = s[lo];
        const long long b = s[hi];
        const bool ascending = (lo & size) == 0;
        if ((a > b) == ascending) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  if constexpr (!kRuns) {
    for (int i = tid; i < chunk; i += nthreads) {
      const long long p = base + i;
      if (p < n) out_keys[p] = s[i];
    }
    return;
  }

  // first run start in this thread's segment (chunk if none)
  const int seg = tid * kSeg;
  int first = chunk;
  for (int j = 0; j < kSeg; ++j) {
    const int i = seg + j;
    if (i == 0 || s[i] != s[i - 1]) {
      first = i;
      break;
    }
  }
  // inclusive suffix minimum within the warp
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int v = first;
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_down_sync(0xffffffffu, v, d);
    if (lane + d < 32) v = min(v, o);
  }
  if (lane == 0) s_warp_min[warp] = v;
  __syncthreads();
  int later = chunk;  // minimum over the warps after this one
  for (int w = warp + 1; w < (nthreads >> 5); ++w) later = min(later, s_warp_min[w]);
  const int next_in_warp = __shfl_down_sync(0xffffffffu, v, 1);
  int next_start = lane == 31 ? later : min(next_in_warp, later);

  for (int j = kSeg - 1; j >= 0; --j) {
    const int i = seg + j;
    const long long key = s[i];
    int len = 0;
    if (i == 0 || key != s[i - 1]) {
      len = key == kSentinel ? 0 : next_start - i;
      next_start = i;
    }
    const long long p = base + i;
    if (p < n) {
      out_keys[p] = key;
      out_len[p] = len;
    }
  }
}

template <bool kRuns>
int launch(const void* keys, int64_t n, int chunk, void* out_keys,
           void* out_len, void* stream) {
  if (chunk < kMinChunk || chunk > kMaxChunk || (chunk & (chunk - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const size_t smem = static_cast<size_t>(chunk) * sizeof(long long);
    cudaError_t err = cudaFuncSetAttribute(
        sort_runs_kernel<kRuns>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long grid = (n + chunk - 1) / chunk;
    sort_runs_kernel<kRuns><<<static_cast<unsigned>(grid), chunk / kSeg, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(keys), n, chunk,
        static_cast<long long*>(out_keys), static_cast<int*>(out_len));
  }
  return static_cast<int>(cudaGetLastError());
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
