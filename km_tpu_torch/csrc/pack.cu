// Sliding-window k-mer pack + canonicalize + validity sentinel.
//
// Replaces km_tpu/ops/pallas_pack.py::_pack_kernel (entry
// pack_canonical_windows). For every base position p it packs bases
// p..p+k-1 at 2 bits each, leftmost base highest, into one int64 key;
// takes min(key, reverse complement) when `canonical`; and writes the
// sentinel 2^63-1 where a base of the window is invalid or the window runs
// off the end. Any n is accepted: the ragged last block is masked.
//
// What bounds it on an H100: bytes. Each base is read once (1 B code +
// 1 B validity) and one 8-byte key is written, 10 B per base; at 3.35 TB/s
// that is about 3 ns per thousand bases. The arithmetic (k shared-memory
// byte reads, a 64-bit pair reversal) is small beside it.
//
// Design: one thread per window. A block stages its 256 codes and flags
// plus a (k-1)-base halo in shared memory with coalesced byte loads, so
// each base leaves device memory once although k windows read it. The
// key is one 64-bit word for every k <= 31, so there is no hi/lo split
// (and none of the split's k = 16 shift edge). The reverse complement is
// complement, reverse the 32 two-bit pairs, shift right by 64 - 2k.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kMaxHalo = 30;  // k - 1 for k <= 31
constexpr long long kSentinel = 0x7FFFFFFFFFFFFFFFLL;

__device__ __forceinline__ unsigned long long revcomp64(unsigned long long x,
                                                        int k) {
  x = ~x;
  x = ((x >> 2) & 0x3333333333333333ULL) | ((x & 0x3333333333333333ULL) << 2);
  x = ((x >> 4) & 0x0F0F0F0F0F0F0F0FULL) | ((x & 0x0F0F0F0F0F0F0F0FULL) << 4);
  x = ((x >> 8) & 0x00FF00FF00FF00FFULL) | ((x & 0x00FF00FF00FF00FFULL) << 8);
  x = ((x >> 16) & 0x0000FFFF0000FFFFULL) |
      ((x & 0x0000FFFF0000FFFFULL) << 16);
  x = (x >> 32) | (x << 32);
  return x >> (64 - 2 * k);
}

__global__ void pack_windows_kernel(const uint8_t* __restrict__ codes,
                                    const uint8_t* __restrict__ valid,
                                    long long n, int k, int canonical,
                                    long long* __restrict__ out) {
  __shared__ uint8_t s_codes[kBlock + kMaxHalo];
  __shared__ uint8_t s_valid[kBlock + kMaxHalo];
  const long long base = static_cast<long long>(blockIdx.x) * kBlock;
  for (int i = threadIdx.x; i < kBlock + k - 1; i += kBlock) {
    const long long p = base + i;
    const bool in = p < n;
    s_codes[i] = in ? (codes[p] & 3) : 0;
    s_valid[i] = in ? (valid[p] != 0) : 0;  // past the end counts invalid
  }
  __syncthreads();

  const long long p = base + threadIdx.x;
  if (p >= n) return;
  unsigned long long key = 0;
  int ok = 1;
  for (int j = 0; j < k; ++j) {
    key = (key << 2) | s_codes[threadIdx.x + j];
    ok &= s_valid[threadIdx.x + j];
  }
  if (canonical) {
    const unsigned long long rc = revcomp64(key, k);
    key = rc < key ? rc : key;
  }
  out[p] = ok ? static_cast<long long>(key) : kSentinel;
}

}  // namespace

extern "C" int km_pack_windows(const void* codes, const void* valid,
                               int64_t n, int k, int canonical, void* out,
                               void* stream) {
  if (k < 1 || k > kMaxHalo + 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const long long grid = (n + kBlock - 1) / kBlock;
    pack_windows_kernel<<<static_cast<unsigned>(grid), kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(codes), static_cast<const uint8_t*>(valid),
        n, k, canonical, static_cast<long long*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
