// Sliding-window k-mer pack + canonicalize + validity sentinel.
//
// Replaces km_tpu/ops/pallas_pack.py::_pack_kernel (entry
// pack_canonical_windows). For every base position p it packs bases
// p..p+k-1 at 2 bits each, leftmost base highest, into one int64 key;
// takes min(key, reverse complement) when `canonical`; and writes the
// sentinel 2^63-1 where a base of the window is invalid or the window runs
// off the end. Any n is accepted: the ragged last tile is masked.
//
// What bounds it on an H100: bytes. Each base is read once (1 B code +
// 1 B validity) and one 8-byte key is written, 10 B per base; at 3.35 TB/s
// that is about 3 ns per thousand bases. The first version spent its time
// elsewhere: one thread per window read k code bytes and k flag bytes
// from shared memory, 62 byte loads per key at k = 31.
//
// Design: a thread computes 16 consecutive windows with rolling keys, so
// a base is touched once per thread and not once per window.
// - A block of 256 threads takes a tile of 4096 windows. It stages the
//   tile's codes and flags plus a 32-byte halo with coalesced 16-byte
//   loads (byte by byte at a ragged end or for unaligned pointers), and
//   folds each pair into one byte on the way: bits 0-1 the code, bit 2 set
//   when the base is invalid or past the end.
// - A thread reads its 48 staged bytes as three 16-byte words (its
//   region starts 16-byte aligned, so a warp's loads are conflict-free)
//   and walks them once: key = ((key << 2) | c) & mask; the reverse
//   complement rolls the other way in a top-aligned register,
//   rc = (rc >> 2) | ((3 - c) << 62), read as rc >> (64 - 2k); a window is
//   valid when the count of valid bases since the last invalid one
//   reaches k. The walk is unrolled, so every byte is a static register
//   field.
// - Keys go to shared memory (index XOR-swizzled within groups of 16 so
//   the strided writes are conflict-free) and leave it as coalesced
//   8-byte stores.
// The key is one 64-bit word for every k <= 31, so there is no hi/lo
// split (and none of the split's k = 16 shift edge).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kRun = 16;               // windows per thread
constexpr int kTile = kBlock * kRun;   // windows per block
constexpr int kMaxK = 31;
constexpr int kSteps = kMaxK + kRun - 1;   // bases a thread walks at most
constexpr int kStageVec = kTile / 16 + 2;  // 16-byte words: tile + halo
constexpr long long kSentinel = 0x7FFFFFFFFFFFFFFFLL;

// four codes and four flags -> four bytes of (code & 3) | (flag == 0) << 2
__device__ __forceinline__ uint32_t fold4(uint32_t c, uint32_t v) {
  const uint32_t t = (v & 0x7F7F7F7Fu) + 0x7F7F7F7Fu;
  const uint32_t nonzero = ((t | v) >> 7) & 0x01010101u;
  return (c & 0x03030303u) | ((nonzero ^ 0x01010101u) << 2);
}

__global__ void __launch_bounds__(kBlock)
pack_windows_kernel(const uint8_t* __restrict__ codes,
                    const uint8_t* __restrict__ valid, long long n, int k,
                    int canonical, int aligned, long long* __restrict__ out) {
  __shared__ uint4 s_bases[kStageVec];
  __shared__ long long s_keys[kTile];
  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;

  for (int q = tid; q < kStageVec; q += kBlock) {
    const long long p = base + 16LL * q;
    uint4 r;
    if (aligned != 0 && p + 16 <= n) {
      const uint4 c = *reinterpret_cast<const uint4*>(codes + p);
      const uint4 v = *reinterpret_cast<const uint4*>(valid + p);
      r = make_uint4(fold4(c.x, v.x), fold4(c.y, v.y), fold4(c.z, v.z),
                     fold4(c.w, v.w));
    } else {
      uint32_t w[4];
      for (int h = 0; h < 4; ++h) {
        uint32_t acc = 0;
        for (int b = 0; b < 4; ++b) {
          const long long pp = p + 4 * h + b;
          uint32_t byte = 4;  // past the end counts invalid
          if (pp < n) byte = (codes[pp] & 3u) | (valid[pp] != 0 ? 0u : 4u);
          acc |= byte << (8 * b);
        }
        w[h] = acc;
      }
      r = make_uint4(w[0], w[1], w[2], w[3]);
    }
    s_bases[q] = r;
  }
  __syncthreads();

  uint32_t w[12];
  {
    const uint4 a = s_bases[tid];
    const uint4 b = s_bases[tid + 1];
    const uint4 c = s_bases[tid + 2];
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
    w[8] = c.x; w[9] = c.y; w[10] = c.z; w[11] = c.w;
  }
  const unsigned long long mask = (1ULL << (2 * k)) - 1ULL;
  const int rc_shift = 64 - 2 * k;
  const int steps = k + kRun - 1;
  const int swz = tid & 15;
  unsigned long long fwd = 0;
  unsigned long long rc = 0;
  int run = 0;  // valid bases since the last invalid one
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    if (i < steps) {
      const uint32_t byte = (w[i >> 2] >> (8 * (i & 3))) & 0xFFu;
      const unsigned long long c = byte & 3u;
      fwd = (fwd << 2) | c;
      rc = (rc >> 2) | ((3ULL - c) << 62);
      run = (byte & 4u) != 0 ? 0 : run + 1;
      const int win = i - (k - 1);
      if (win >= 0) {
        unsigned long long key = fwd & mask;
        if (canonical != 0) {
          const unsigned long long r = rc >> rc_shift;
          key = r < key ? r : key;
        }
        s_keys[tid * kRun + (win ^ swz)] =
            run >= k ? static_cast<long long>(key) : kSentinel;
      }
    }
  }
  __syncthreads();

  for (int i = 0; i < kRun; ++i) {
    const int e = i * kBlock + tid;
    const long long p = base + e;
    if (p < n) out[p] = s_keys[e ^ ((e >> 4) & 15)];
  }
}

}  // namespace

extern "C" int km_pack_windows(const void* codes, const void* valid,
                               int64_t n, int k, int canonical, void* out,
                               void* stream) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const long long grid = (n + kTile - 1) / kTile;
    const uintptr_t bits = reinterpret_cast<uintptr_t>(codes) |
                           reinterpret_cast<uintptr_t>(valid);
    pack_windows_kernel<<<static_cast<unsigned>(grid), kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(codes), static_cast<const uint8_t*>(valid),
        n, k, canonical, (bits & 15) == 0 ? 1 : 0,
        static_cast<long long*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
