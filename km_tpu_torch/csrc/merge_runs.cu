// Merges of sorted (key, count) runs for the counting pipeline, with the
// counts of equal keys summed.
//
// Replaces km_tpu/ops/count.py's XLA merge programs (no Pallas there):
// - km_chunk_runs (M1) takes the chunk sort's output (keys sorted within
//   `piece`-sized pieces, run lengths at run starts, 0 elsewhere) to the
//   chunk's runs in global key order: the chunk half of
//   merge_accum_device (:369) and of _jitted_count_merge (:408), whose
//   sum_runs_device (:195) re-sorted every record, and the port's
//   chunk_runs_device.
// - km_merge_accum (M2) merges those runs into the device-resident
//   accumulator (ascending distinct keys, counts > 0): the accumulator
//   half of merge_accum_device, which concatenated, re-sorted and
//   compacted the whole padded accumulator every chunk.
// - km_cut (C1) cuts the final accumulator at min_count on the card: the
//   kept keys as uint64 words and their counts as uint32 into the spare
//   accumulator's buffers, and (kept, the counts' sum, the live length)
//   into three int64. It replaces no device code of km_tpu: there the
//   stream read the whole accumulator back and cut it on the host (the
//   end of count_batches_device_stream, :503), as the port did. On the
//   card only the kept records cross to the host, and no buffer the size
//   of the output is allocated.
//
// What bounds them on an H100: device memory. M2's least traffic is its
// live inputs read once and its live output written once, 16 bytes a
// record; M1's is the chunk read once (12 bytes a key) and its runs
// written once (16 bytes); C1's the live records read once (16 bytes)
// and the kept written once (12 bytes). Padding is never read, no count
// is summed with an atomic, and results are deterministic and equal to
// the plain versions bit for bit. Lengths are read from device memory,
// so nothing is read back to size a launch: grids are sized for the most
// a merge can hold, and blocks past the live total exit.
//
// M1 is a sample sort over the pieces, so each run crosses device memory
// about twice (a pairwise merge tree over 1,024 pieces moved it ten
// times):
// 1. sample_sort_kernel / sample_rank_kernel: 32 keys per bucket, one
//    from each equal stride of the input at a hashed offset (so they do
//    not line up at the same quantiles of every piece), sorted in blocks
//    of 8,192 and ranked across the blocks; every 32nd is a splitter.
//    Bucket b holds the keys in (splitter b - 1, splitter b], so all
//    copies of one key (up to one per piece) land in one bucket.
// 2. compact_kernel: one block per piece moves the piece's live run
//    starts, in order, to the front of its region (uint16 lengths), and
//    writes the piece's column of the cut matrix: cut[b][p] is the number
//    of the piece's live keys <= splitter b.
// 3. bucket_kernel: one block per bucket gathers its slice of every piece
//    into shared memory (asynchronous copies), sorts it (a block merge
//    sort: a 16-key sorting network per thread, then merge-path levels),
//    sums equal keys, and writes each run at its rank, which a decoupled
//    look-back across buckets supplies (buckets take tickets in order; a
//    status word per bucket carries its run count, then its inclusive
//    prefix). A bucket larger than the tile (8,192 records) is taken in
//    rounds of keys <= v, v the least q-th key left of the slices, q the
//    largest share of a slice that keeps the round within the tile; a
//    round whose least key alone exceeds the tile is that key, summed
//    over the slices. Where samples fell on invalid windows, the
//    splitters end in SENTINEL: the first such bucket takes every key
//    left and writes the run count, and the buckets after it exit at
//    once (their cut rows are not written).
// Buckets hold about 4,096 input keys each; an input whose keys dodge the
// samples can still overfill one, and the rounds keep it right. With more
// slices left than the tile holds (pieces of 2^10 or less at 2^23 keys)
// a round takes the least key left: right, and slow; no path of the port
// runs it. A launch given a tally adds to it, with two atomics on the
// device, its run count and the rounds its buckets took beyond one each,
// so a caller sees how often the rounds ran without a wait.
//
// M2 is one pass in tile order, after a small kernel that finds where
// every tile of 4,096 merged positions cuts the accumulator and the runs
// (a warp-wide search on the merge path each). Each block takes a ticket
// for the next tile, stages both slices in shared memory, merges 16
// positions a thread, flags key changes (the keys just outside the tile
// come from the cut) and scans (runs begun, count since the last run
// start) over the tile. The tile's exclusive prefix of those comes from a
// decoupled look-back, so a run that spans tiles takes its carry from
// there; runs that end in the tile go out through shared memory,
// contiguous, at their ranks. A run spans at most two tiles: the
// accumulator's keys are distinct, and so are the chunk's runs. Only
// ranks below `cap` are written; the tile that holds the last position
// writes the true number of runs and restores SENTINEL/0 over the output
// slots that were live before and are not now.
//
// C1 is one pass in ticket order, a tile of 4,096 records a block, its
// output rank from the same decoupled look-back as M2's tiles, carrying
// (records kept, counts summed).
//
// Neither M1 nor M2 reaches its bytes bound on an H100 (PERF.md has the
// times): a bucket's sort moves its records through shared memory once a
// merge level and takes 150 KB, so one bucket runs per SM; M2's tiles
// wait on their loads and on the look-back, two to an SM.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

using i64 = long long;
using u64 = unsigned long long;
using u16 = unsigned short;

constexpr i64 kSentinel = 0x7FFFFFFFFFFFFFFFLL;
constexpr i64 kNone = -1;  // below every key
constexpr unsigned kFull = 0xffffffffu;

// the block sort of M1 (samples and buckets)
constexpr int kSortThreads = 512;
constexpr int kSortItems = 16;
constexpr int kSortCap = kSortThreads * kSortItems;  // records per round
constexpr int kSamplesPerBucket = 32;
constexpr i64 kBucketWant = 4096;  // input keys per bucket
constexpr i64 kMaxBuckets = 8192;
constexpr i64 kMaxCuts = 1 << 23;  // cut matrix entries
constexpr int kCompactThreads = 256;
constexpr int kCompactItems = 8;
constexpr u64 kValueMask = (1ull << 62) - 1;
constexpr u64 kAggregate = 1ull << 62;
constexpr u64 kInclusive = 2ull << 62;

// M2
constexpr int kMergeThreads = 256;
constexpr int kMergeItems = 16;
constexpr int kMergeTile = kMergeThreads * kMergeItems;

// A shared-memory slot for position p: one pad word per 16 keeps the
// 8-byte accesses of threads 8 or 16 positions apart free of bank
// conflicts.
__host__ __device__ constexpr int padded(int p) { return p + (p >> 4); }

i64 cdiv(i64 a, i64 b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// scans and searches

// (runs begun, count since the last run start) of a stretch of records;
// combine(L, R) is that of L followed by R. A look-back carries its two
// words as v[0], v[1].
struct Runs {
  i64 starts;
  i64 tail;
  __device__ i64 operator[](int i) const { return i ? tail : starts; }
};

__device__ __forceinline__ Runs combine(Runs l, Runs r) {
  return Runs{l.starts + r.starts, r.starts > 0 ? r.tail : l.tail + r.tail};
}

// (records kept, counts summed) of a stretch of records: C1's carry.
struct Kept {
  i64 kept;
  i64 total;
  __device__ i64 operator[](int i) const { return i ? total : kept; }
};

__device__ __forceinline__ Kept combine(Kept l, Kept r) {
  return Kept{l.kept + r.kept, l.total + r.total};
}

// Exclusive scan of one Runs per thread over a block of kBlock threads;
// `total` gets the block's. s_warp holds 2 * kBlock / 32 values.
template <int kBlock>
__device__ __forceinline__ Runs scan_runs(Runs v, i64* s_warp, Runs& total) {
  constexpr int kWarpsB = kBlock / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Runs incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    Runs o{__shfl_up_sync(kFull, incl.starts, d),
           __shfl_up_sync(kFull, incl.tail, d)};
    if (lane >= d) incl = combine(o, incl);
  }
  Runs up{__shfl_up_sync(kFull, incl.starts, 1),
          __shfl_up_sync(kFull, incl.tail, 1)};
  if (lane == 31) {
    s_warp[warp] = incl.starts;
    s_warp[kWarpsB + warp] = incl.tail;
  }
  __syncthreads();
  Runs before{0, 0};
  total = Runs{0, 0};
  for (int w = 0; w < kWarpsB; ++w) {
    const Runs x{s_warp[w], s_warp[kWarpsB + w]};
    if (w < warp) before = combine(before, x);
    total = combine(total, x);
  }
  __syncthreads();
  return lane == 0 ? before : combine(before, up);
}

// Exclusive sum of one value per thread; `total` gets the block's.
template <int kBlock>
__device__ __forceinline__ i64 scan_sum(i64 v, i64* s_warp, i64& total) {
  constexpr int kWarpsB = kBlock / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  i64 incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const i64 o = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  i64 before = 0;
  total = 0;
  for (int w = 0; w < kWarpsB; ++w) {
    const i64 x = s_warp[w];
    if (w < warp) before += x;
    total += x;
  }
  __syncthreads();
  return before + incl - v;
}

// The block's least value.
template <int kBlock>
__device__ __forceinline__ i64 block_min(i64 v, i64* s_warp) {
  constexpr int kWarpsB = kBlock / 32;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const i64 o = __shfl_down_sync(kFull, v, d);
    v = o < v ? o : v;
  }
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  i64 m = s_warp[0];
  for (int w = 1; w < kWarpsB; ++w) m = s_warp[w] < m ? s_warp[w] : m;
  __syncthreads();
  return m;
}

// The first index in [lo, hi) whose key is > v (hi if none).
__device__ __forceinline__ i64 upper_bound(const i64* k, i64 lo, i64 hi,
                                           i64 v) {
  while (lo < hi) {
    const i64 mid = (lo + hi) >> 1;
    if (k[mid] <= v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The first index in [0, n) whose key is >= v (n if none).
__device__ __forceinline__ int lower_bound(const i64* k, int n, i64 v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (k[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Positions d .. d + kN - 1 (those below `real`) of the stable merge of
// A (la keys at padded slots from a) and B (lb keys from b) in shared
// memory, into registers; on equal keys A comes first. The cut at d is a
// binary search on the diagonal; then the heads of both lists ride in
// registers, so each position costs one key and one value load (a slot
// past a list's end is read, and never taken).
template <int kN, typename V>
__device__ __forceinline__ void merge_items(const i64* s_k, const V* s_v,
                                            int a, int la, int b, int lb,
                                            int d, int real, i64 (&k)[kN],
                                            V (&v)[kN]) {
  d = min(d, la + lb);
  int lo = d > lb ? d - lb : 0;
  int hi = d < la ? d : la;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_k[padded(a + mid)] <= s_k[padded(b + d - 1 - mid)]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int ia = lo;
  int ib = d - lo;
  i64 ka = s_k[padded(a + ia)];
  i64 kb = s_k[padded(b + ib)];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    if (j < real) {
      const bool take_a = ib >= lb || (ia < la && ka <= kb);
      k[j] = take_a ? ka : kb;
      v[j] = s_v[padded(take_a ? a + ia : b + ib)];
      ia += take_a ? 1 : 0;
      ib += take_a ? 0 : 1;
      const i64 x = s_k[padded(take_a ? a + ia : b + ib)];
      ka = take_a ? x : ka;
      kb = take_a ? kb : x;
    }
  }
}

// The same cut in device memory, by one warp: each round the 32 lanes
// probe 32 evenly spaced points of the range, so a range of 2^25 closes
// in 5 rounds of loads instead of 25 dependent ones. All lanes return it.
__device__ __forceinline__ i64 merge_path_warp(const i64* a, i64 la,
                                               const i64* b, i64 lb, i64 d) {
  const int lane = threadIdx.x & 31;
  i64 lo = d > lb ? d - lb : 0;
  i64 hi = d < la ? d : la;
  while (lo < hi) {
    const i64 step = (hi - lo + 31) / 32;
    const i64 i = lo + lane * step;
    // true from the first index whose A element follows B's at d - 1 - i
    const bool past = i >= hi || a[i] > b[d - 1 - i];
    const unsigned ball = __ballot_sync(kFull, past);
    const int f = ball ? __ffs(ball) - 1 : 32;
    const i64 top = lo + f * step;
    if (f > 0) lo += (f - 1) * step + 1;
    if (top < hi) hi = top;
  }
  return lo;
}

// ---------------------------------------------------------------------------
// M1

// Sorts the n <= kSortCap records at padded slots of s_k (keys) and s_v
// (uint16 values) by key, in place; the order of equal keys is not kept.
// Each thread sorts kSortItems records in registers (a bitonic network),
// then merge-path levels double the sorted lists up to N, the least power
// of two >= n, with SENTINEL padding past n. Starts and ends with a
// barrier.
__device__ void block_sort(i64* s_k, u16* s_v, int n) {
  int N = kSortItems;
  while (N < n) N <<= 1;
  const int first = threadIdx.x * kSortItems;
  const bool active = first < N;
  i64 k[kSortItems];
  u16 v[kSortItems];
  __syncthreads();
  if (active) {
#pragma unroll
    for (int j = 0; j < kSortItems; ++j) {
      const int p = first + j;
      k[j] = p < n ? s_k[padded(p)] : kSentinel;
      v[j] = p < n ? s_v[padded(p)] : 0;
    }
#pragma unroll
    for (int size = 2; size <= kSortItems; size <<= 1) {
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
        for (int i = 0; i < kSortItems; ++i) {
          const int j = i ^ stride;
          if (j > i && (k[i] > k[j]) == ((i & size) == 0)) {
            const i64 tk = k[i];
            k[i] = k[j];
            k[j] = tk;
            const u16 tv = v[i];
            v[i] = v[j];
            v[j] = tv;
          }
        }
      }
    }
  }
  __syncthreads();  // the staged records are read
  for (int w = kSortItems; w < N; w <<= 1) {
    if (active) {
#pragma unroll
      for (int j = 0; j < kSortItems; ++j) {
        s_k[padded(first + j)] = k[j];
        s_v[padded(first + j)] = v[j];
      }
    }
    __syncthreads();
    if (active) {
      // this thread's positions of the merge of the two lists of w
      const int a = first & ~(2 * w - 1);
      const int d = first - a;
      merge_items<kSortItems>(s_k, s_v, a, w, a + w, w, d, kSortItems, k,
                              v);
    }
    __syncthreads();
  }
  if (active) {
#pragma unroll
    for (int j = 0; j < kSortItems; ++j) {
      s_k[padded(first + j)] = k[j];
      s_v[padded(first + j)] = v[j];
    }
  }
  __syncthreads();
}

// The shared memory of the block sort: keys and uint16 values at padded
// slots, and int64 totals (bucket_kernel's staged output).
constexpr int kSortSlots = padded(kSortCap) + 1;
constexpr size_t kSortSmem =
    kSortSlots * sizeof(i64) + kSortCap * sizeof(i64) +
    kSortSlots * sizeof(u16);

struct SortSmem {
  i64* k;
  i64* t;
  u16* v;
};

__device__ __forceinline__ SortSmem sort_smem(i64* base) {
  return SortSmem{base, base + kSortSlots,
                  reinterpret_cast<u16*>(base + kSortSlots + kSortCap)};
}

// Sample t of `total` is the key at a position drawn from the t-th of
// `total` equal strides of the input (a multiplicative hash of t), so the
// samples do not line up at the same quantiles of every piece; each
// block sorts kSortCap consecutive samples into samples[].
__device__ __forceinline__ i64 sample_position(i64 t, i64 n, i64 total) {
  const i64 stride = n / total > 1 ? n / total : 1;
  const i64 jitter = static_cast<i64>(
      (static_cast<u64>(t) * 0x9E3779B97F4A7C15ull) >> 33);
  return t * n / total + jitter % stride;
}

__global__ void __launch_bounds__(kSortThreads, 1)
sample_sort_kernel(const i64* __restrict__ keys, i64 n, i64 total,
                   i64* __restrict__ samples) {
  extern __shared__ i64 smem[];
  const SortSmem s = sort_smem(smem);
  const i64 t0 = static_cast<i64>(blockIdx.x) * kSortCap;
  const int cnt = static_cast<int>(
      total - t0 < kSortCap ? total - t0 : kSortCap);
  for (int i = threadIdx.x; i < cnt; i += kSortThreads) {
    const i64 t = t0 + i;
    s.k[padded(i)] = keys[sample_position(t, n, total)];
    s.v[padded(i)] = 0;
  }
  block_sort(s.k, s.v, cnt);
  for (int i = threadIdx.x; i < cnt; i += kSortThreads) {
    samples[t0 + i] = s.k[padded(i)];
  }
}

// Each sample's rank in the union of the sorted blocks (ties by block);
// the sample of rank 32 (b + 1) - 1 is splitter b, for b < buckets - 1.
__global__ void __launch_bounds__(256)
sample_rank_kernel(const i64* __restrict__ samples, i64 total,
                   i64* __restrict__ splitters) {
  const i64 i = static_cast<i64>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= total) return;
  const i64 x = samples[i];
  const i64 own = i / kSortCap;
  const i64 lists = (total + kSortCap - 1) / kSortCap;
  i64 rank = i - own * kSortCap;
  for (i64 l = 0; l < lists; ++l) {
    const i64 lo = l * kSortCap;
    const i64 hi = lo + kSortCap < total ? lo + kSortCap : total;
    if (l < own) {
      rank += upper_bound(samples, lo, hi, x) - lo;
    } else if (l > own) {
      rank += lower_bound(samples + lo, static_cast<int>(hi - lo), x);
    }
  }
  const i64 b = rank / kSamplesPerBucket;
  if (rank % kSamplesPerBucket == kSamplesPerBucket - 1 &&
      b < total / kSamplesPerBucket - 1) {
    splitters[b] = x;
  }
}

// Where the cut matrix keeps cut[b][p]: by bucket, so a bucket's block
// reads its two rows whole.
__device__ __forceinline__ i64 cut_slot(int b, i64 p, i64 pieces,
                                        int buckets) {
  return static_cast<i64>(b) * pieces + p;
}

// One block per piece: the piece's live run starts (length > 0: real
// keys, SENTINEL runs are 0) go, in order, to the front of the piece's
// own region, lengths as uint16. Thread t takes elements t, t +
// kCompactThreads, ... of a tile, so loads and the stores of each warp's
// live lanes are contiguous; a warp's ballot gives each lane its place.
// Then the piece's column of the cut matrix: cut[b][p], the number of
// live keys <= splitter b, from a walk over the compacted keys (a
// stretch a thread); the last row is the piece's live count.
__global__ void __launch_bounds__(kCompactThreads)
compact_kernel(const i64* __restrict__ keys, const int* __restrict__ lengths,
               i64 n, int piece, const i64* __restrict__ splitters,
               int buckets,
               i64* out_k, u16* __restrict__ out_len, int* __restrict__ cut) {
  constexpr int kCompactWarps = kCompactThreads / 32;
  extern __shared__ i64 s_split[];  // buckets - 1
  __shared__ int s_live[kCompactItems][kCompactWarps];
  const int nsplit = buckets - 1;
  for (int b = threadIdx.x; b < nsplit; b += kCompactThreads) {
    s_split[b] = splitters[b];
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const i64 pieces = gridDim.x;
  const i64 p = blockIdx.x;
  const i64 p0 = p * piece;
  const int len = static_cast<int>(n - p0 < piece ? n - p0 : piece);
  int written = 0;
  for (int base = 0; base < len; base += kCompactThreads * kCompactItems) {
    i64 k[kCompactItems];
    int c[kCompactItems];
    unsigned live[kCompactItems];
#pragma unroll
    for (int j = 0; j < kCompactItems; ++j) {
      const int e = base + j * kCompactThreads + static_cast<int>(threadIdx.x);
      k[j] = 0;
      c[j] = 0;
      if (e < len) {
        k[j] = keys[p0 + e];
        c[j] = lengths[p0 + e];
      }
      live[j] = __ballot_sync(kFull, c[j] > 0);
      if (lane == 0) s_live[j][warp] = __popc(live[j]);
    }
    __syncthreads();
    // the tile's order is (j, warp, lane): live records before this
    // warp's j-th group, and in all
    int at[kCompactItems];
    int total = 0;
#pragma unroll
    for (int j = 0; j < kCompactItems; ++j) {
      int before = 0, in_j = 0;
      for (int w = 0; w < kCompactWarps; ++w) {
        const int v = s_live[j][w];
        before += w < warp ? v : 0;
        in_j += v;
      }
      at[j] = total + before;
      total += in_j;
    }
#pragma unroll
    for (int j = 0; j < kCompactItems; ++j) {
      if ((live[j] >> lane) & 1u) {
        const i64 to = p0 + written + at[j] + __popc(live[j] & below);
        out_k[to] = k[j];
        out_len[to] = static_cast<u16>(c[j]);
      }
    }
    written += total;
    __syncthreads();  // s_live is read before the next tile writes it;
                      // the compacted keys are seen by the whole block
  }
  if (len <= 0) __syncthreads();  // s_split is complete
  // each thread walks its own stretch of the compacted keys, whose
  // buckets only grow: a key past the current splitter advances a few
  // steps, then by binary search
  const int per = (written + kCompactThreads - 1) / kCompactThreads;
  const int c0 = min(static_cast<int>(threadIdx.x) * per, written);
  const int c1 = min(c0 + per, written);
  int bucket = c0 > 0 ? lower_bound(s_split, nsplit, out_k[p0 + c0 - 1]) : 0;
  for (int i = c0; i < c1; ++i) {
    const i64 x = out_k[p0 + i];
    int next = bucket;
    for (int step = 0; step < 8 && next < nsplit && s_split[next] < x; ++step) {
      ++next;
    }
    if (next < nsplit && s_split[next] < x) {
      next += 1 + lower_bound(s_split + next + 1, nsplit - next - 1, x);
    }
    for (int b = bucket; b < next; ++b) {
      cut[cut_slot(b, p, pieces, buckets)] = i;
    }
    bucket = next;
  }
  // rows past the first SENTINEL splitter belong to buckets that hold no
  // key (bucket_kernel), so they are not written
  const int top = lower_bound(s_split, nsplit, kSentinel);
  const int last =
      written > 0 ? lower_bound(s_split, nsplit, out_k[p0 + written - 1]) : 0;
  for (int b = last + threadIdx.x; b <= top; b += kCompactThreads) {
    cut[cut_slot(b, p, pieces, buckets)] = written;
  }
}

// The runs before bucket b: the sum of the run counts published by the
// buckets before it, back to the nearest that published its inclusive
// prefix. One warp reads 32 status words a round (lane 0 the nearest);
// buckets take tickets in order, so each one waited for has started. All
// lanes return it.
__device__ i64 look_back_runs(const u64* status, int b) {
  const int lane = threadIdx.x & 31;
  i64 sum = 0;
  for (int end = b; end > 0; end -= 32) {
    const int j = end - 1 - lane;
    u64 s = 0;
    if (j >= 0) {
      do {
        s = *reinterpret_cast<const volatile u64*>(status + j);
      } while (s == 0);
    }
    const unsigned incl = __ballot_sync(kFull, j >= 0 && s >= kInclusive);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    i64 v = j >= 0 && lane <= stop ? static_cast<i64>(s & kValueMask) : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
    sum += v;
    if (incl) break;
  }
  return sum;
}

__device__ __forceinline__ void publish(u64* status, int b, u64 flag,
                                        i64 v) {
  *reinterpret_cast<volatile u64*>(status + b) = flag | static_cast<u64>(v);
}

// Sorts the n records staged in s, sums the lengths of equal keys and
// stages the runs in order (keys at padded slots of s.k, int64 totals in
// s.t); returns their number. Starts and ends with a barrier.
__device__ int sort_reduce(const SortSmem& s, int n, i64* s_warp) {
  block_sort(s.k, s.v, n);
  const int first = threadIdx.x * kSortItems;
  i64 k[kSortItems];
  int v[kSortItems];
  unsigned starts = 0, ends = 0;
  Runs mine{0, 0};
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    const int p = first + j;
    k[j] = kSentinel;
    v[j] = 0;
    if (p < n) {
      k[j] = s.k[padded(p)];
      v[j] = s.v[padded(p)];
      if (p == 0 || s.k[padded(p - 1)] != k[j]) starts |= 1u << j;
      if (p + 1 == n || s.k[padded(p + 1)] != k[j]) ends |= 1u << j;
      mine = combine(mine, Runs{static_cast<i64>((starts >> j) & 1u), v[j]});
    }
  }
  Runs total;
  Runs run = scan_runs<kSortThreads>(mine, s_warp, total);
  // every read of s.k precedes the scan's barriers
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    if (first + j < n) {
      run = combine(run, Runs{static_cast<i64>((starts >> j) & 1u), v[j]});
      if ((ends >> j) & 1u) {
        s.k[padded(static_cast<int>(run.starts) - 1)] = k[j];
        s.t[run.starts - 1] = run.tail;
      }
    }
  }
  __syncthreads();
  return static_cast<int>(total.starts);
}

// Asynchronous copies of 8 and 4 bytes from device to shared memory,
// and the wait for all of this thread's.
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(to),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to),
                 "l"(src));
  }
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A bucket's view of the compacted pieces: its slice of piece p is
// [cut[b - 1][p], cut[b][p]) of the piece's region (from 0 for the first
// bucket). This thread's pieces are threadIdx.x + j kSortThreads.
struct Bucket {
  const i64* ck;
  const u16* clen;
  const int* cut;
  int piece;
  i64 pieces;
  int buckets;
  int b;

  // the part of piece p's slice with keys in (v_lo, v_hi]: [f, g)
  __device__ __forceinline__ void slice(i64 p, i64 v_lo, i64 v_hi, i64& f,
                                        i64& g) const {
    const i64 at = p * piece;
    const i64 lo = at + (b > 0 ? cut[cut_slot(b - 1, p, pieces, buckets)] : 0);
    const i64 hi = at + cut[cut_slot(b, p, pieces, buckets)];
    f = v_lo == kNone ? lo : upper_bound(ck, lo, hi, v_lo);
    g = v_hi == kSentinel ? hi : upper_bound(ck, f, hi, v_hi);
  }

  // the records in (v_lo, v_hi] of every slice: this thread's first
  // staging slot, and (in total) their number
  __device__ __forceinline__ i64 count(i64 v_lo, i64 v_hi, i64* s_warp,
                                       i64& total) const {
    i64 mine = 0;
    for (i64 p = threadIdx.x; p < pieces; p += kSortThreads) {
      i64 f, g;
      slice(p, v_lo, v_hi, f, g);
      mine += g - f;
    }
    return scan_sum<kSortThreads>(mine, s_warp, total);
  }

  // stages them from slot `at` on, every copy in flight at once; ends
  // with a barrier
  __device__ __forceinline__ void gather(i64 v_lo, i64 v_hi, i64 at,
                                         const SortSmem& s) const {
    for (i64 p = threadIdx.x; p < pieces; p += kSortThreads) {
      i64 f, g;
      slice(p, v_lo, v_hi, f, g);
      for (i64 i = f; i < g; ++i, ++at) {
        cp_async(s.k + padded(static_cast<int>(at)), ck + i, 8);
        s.v[padded(static_cast<int>(at))] = clen[i];
      }
    }
    cp_async_wait();
    __syncthreads();
  }

  // the staged runs out at `base`; ends with a barrier
  __device__ __forceinline__ void write(const SortSmem& s, int runs, i64 base,
                                        i64* out_k, i64* out_c) const {
    for (int i = threadIdx.x; i < runs; i += kSortThreads) {
      out_k[base + i] = s.k[padded(i)];
      out_c[base + i] = s.t[i];
    }
    __syncthreads();
  }
};

// A bucket larger than the tile, from output rank `base` on: rounds of
// the keys in (v_lo, v_hi], each within the tile unless its least key
// alone fills it. q is the most keys a slice may give, the largest with
// the sum over slices of min(q, left) within the tile (0 when more slices
// are left than the tile holds); v_hi is the least q-th key of the slices
// with more than q left (their least head for q = 0). Returns the rank
// after its runs, and the rounds it took in `rounds`. Apart from the
// common path, so its registers do not weigh on it.
__device__ __noinline__ i64 bucket_rounds(const Bucket& bk, const SortSmem& s,
                                          i64* s_warp, i64 base, i64* out_k,
                                          i64* out_c, i64& rounds) {
  i64 v_lo = kNone;
  rounds = 0;
  for (;;) {
    i64 rest = 0, live = 0;
    for (i64 p = threadIdx.x; p < bk.pieces; p += kSortThreads) {
      i64 f, g;
      bk.slice(p, v_lo, kSentinel, f, g);
      rest += g - f;
      live += g > f ? 1 : 0;
    }
    i64 all_rest, all_live;
    scan_sum<kSortThreads>(rest, s_warp, all_rest);
    if (all_rest == 0) break;
    scan_sum<kSortThreads>(live, s_warp, all_live);
    i64 v_hi = kSentinel;
    if (all_rest > kSortCap) {
      i64 q = 0;
      if (all_live <= kSortCap) {
        i64 lo = 1, hi = kSortCap;
        while (lo < hi) {
          const i64 mid = (lo + hi + 1) >> 1;
          i64 take = 0;
          for (i64 p = threadIdx.x; p < bk.pieces; p += kSortThreads) {
            i64 f, g;
            bk.slice(p, v_lo, kSentinel, f, g);
            take += g - f < mid ? g - f : mid;
          }
          i64 all_take;
          scan_sum<kSortThreads>(take, s_warp, all_take);
          if (all_take <= kSortCap) {
            lo = mid;
          } else {
            hi = mid - 1;
          }
        }
        q = lo;
      }
      i64 least = kSentinel;
      for (i64 p = threadIdx.x; p < bk.pieces; p += kSortThreads) {
        i64 f, g;
        bk.slice(p, v_lo, kSentinel, f, g);
        if (g - f > q) {
          const i64 x = bk.ck[f + (q > 0 ? q - 1 : 0)];
          least = x < least ? x : least;
        }
      }
      v_hi = block_min<kSortThreads>(least, s_warp);
    }
    i64 all_in;
    const i64 at = bk.count(v_lo, v_hi, s_warp, all_in);
    if (all_in <= kSortCap) {
      bk.gather(v_lo, v_hi, at, s);
      const int runs = sort_reduce(s, static_cast<int>(all_in), s_warp);
      bk.write(s, runs, base, out_k, out_c);
      base += runs;
    } else {
      // more slices begin with v_hi, the least key left, than the tile
      // holds (q = 0): the round is that key alone
      i64 sum = 0;
      for (i64 p = threadIdx.x; p < bk.pieces; p += kSortThreads) {
        i64 f, g;
        bk.slice(p, v_lo, v_hi, f, g);
        sum += g > f ? bk.clen[f] : 0;
      }
      i64 all_sum;
      scan_sum<kSortThreads>(sum, s_warp, all_sum);
      if (threadIdx.x == 0) {
        out_k[base] = v_hi;
        out_c[base] = all_sum;
      }
      base += 1;
    }
    v_lo = v_hi;
    ++rounds;
  }
  return base;
}

// Adds x to a 64-bit counter in device memory.
__device__ __forceinline__ void tally_add(i64* at, i64 x) {
  atomicAdd(reinterpret_cast<u64*>(at), static_cast<u64>(x));
}

// One block per bucket, in ticket order. Runs go to out at the bucket's
// rank; the last bucket writes their number to *m. With a `tally`, the
// last bucket adds that number to tally[0], and a bucket taken in rounds
// adds the rounds it took beyond one to tally[1].
__global__ void __launch_bounds__(kSortThreads, 1)
bucket_kernel(const i64* __restrict__ ck, const u16* __restrict__ clen,
              int piece, i64 pieces, const int* __restrict__ cut,
              const i64* __restrict__ splitters, int buckets,
              i64* __restrict__ out_k, i64* __restrict__ out_c,
              i64* __restrict__ m, i64* tally, u64* status,
              unsigned* ticket) {
  extern __shared__ i64 smem[];
  const SortSmem s = sort_smem(smem);
  __shared__ i64 s_warp[2 * kSortThreads / 32];
  __shared__ int s_b;
  __shared__ i64 s_base;
  if (threadIdx.x == 0) s_b = static_cast<int>(atomicAdd(ticket, 1u));
  __syncthreads();
  const Bucket bk{ck, clen, cut, piece, pieces, buckets, s_b};
  const int b = bk.b;
  // The first bucket whose splitter is SENTINEL (invalid windows were
  // sampled) holds every key left, and is the last to write: the ones
  // after it hold no key, and no look-back reaches them.
  if (b > 0 && splitters[b - 1] == kSentinel) return;
  const bool last = b == buckets - 1 || splitters[b] == kSentinel;
  i64 total;
  const i64 at = bk.count(kNone, kSentinel, s_warp, total);
  if (total <= kSortCap) {
    // the bucket in one round: its run count is published before the
    // look-back, so the buckets after it need not wait for its prefix
    bk.gather(kNone, kSentinel, at, s);
    const int runs = sort_reduce(s, static_cast<int>(total), s_warp);
    if (threadIdx.x < 32) {
      i64 base = 0;
      if (b > 0) {
        if (threadIdx.x == 0) publish(status, b, kAggregate, runs);
        base = look_back_runs(status, b);
      }
      if (threadIdx.x == 0) {
        publish(status, b, kInclusive, base + runs);
        if (last) {
          *m = base + runs;
          if (tally) tally_add(tally, base + runs);
        }
        s_base = base;
      }
    }
    __syncthreads();
    bk.write(s, runs, s_base, out_k, out_c);
    return;
  }
  if (threadIdx.x < 32) {
    const i64 base = b > 0 ? look_back_runs(status, b) : 0;
    if (threadIdx.x == 0) s_base = base;
  }
  __syncthreads();
  i64 rounds;
  const i64 end = bucket_rounds(bk, s, s_warp, s_base, out_k, out_c, rounds);
  if (threadIdx.x == 0) {
    publish(status, b, kInclusive, end);
    if (last) *m = end;
    if (tally) {
      tally_add(tally + 1, rounds - 1);
      if (last) tally_add(tally, end);
    }
  }
}

// M1's buckets for n keys in pieces of `piece`: a power of two near n /
// kBucketWant, at most kMaxBuckets, with at most kMaxCuts cut entries.
i64 buckets_for(i64 n, int piece) {
  const i64 pieces = cdiv(n, piece);
  i64 b = 1;
  while (b < kMaxBuckets && b * kBucketWant < n) b <<= 1;
  while (b > 1 && b * pieces > kMaxCuts) b >>= 1;
  return b;
}

i64 align_up(i64 bytes) { return (bytes + 255) & ~static_cast<i64>(255); }

// M1's scratch, carved in this order: the compacted keys (n int64) and
// lengths (n uint16: a run of a piece is at most 2^14 long), the samples
// (32 per bucket, int64), the splitters (int64), the cut matrix (buckets
// x pieces int32), and the zeroed status words (one per bucket) and
// ticket.
struct ChunkScratch {
  i64* keys;
  u16* lengths;
  i64* samples;
  i64* splitters;
  int* cut;
  u64* status;
  unsigned* ticket;
  i64 zeroed;  // bytes from status on
  i64 bytes;
};

ChunkScratch chunk_scratch(char* base, i64 n, int piece) {
  const i64 pieces = cdiv(n, piece);
  const i64 buckets = buckets_for(n, piece);
  const i64 samples = kSamplesPerBucket * buckets;
  ChunkScratch s;
  i64 at = 0;
  s.keys = reinterpret_cast<i64*>(base + at);
  at += align_up(n * 8);
  s.lengths = reinterpret_cast<u16*>(base + at);
  at += align_up(n * 2);
  s.samples = reinterpret_cast<i64*>(base + at);
  at += align_up(samples * 8);
  s.splitters = reinterpret_cast<i64*>(base + at);
  at += align_up(buckets * 8);
  s.cut = reinterpret_cast<int*>(base + at);
  at += align_up(buckets * pieces * 4);
  const i64 zero_from = at;
  s.status = reinterpret_cast<u64*>(base + at);
  at += align_up(buckets * 8);
  s.ticket = reinterpret_cast<unsigned*>(base + at);
  at += align_up(8);
  s.zeroed = at - zero_from;
  s.bytes = at;
  return s;
}

// ---------------------------------------------------------------------------
// M2

constexpr int kMergeSlots = padded(kMergeTile) + 1;
constexpr size_t kMergeSmem = 2 * kMergeSlots * sizeof(i64);

// The tile's exclusive carry (a Runs for M2, a Kept for C1): the
// aggregates published by the tiles before it, combined back to the
// nearest that published its inclusive value. Values are written before
// their flag (1: aggregate, 2: inclusive) behind a fence, and read after
// it. One warp reads 32 tiles a round (lane 0 the nearest) and combines
// them in order; all lanes return it.
template <typename V>
__device__ V look_back_tiles(const int* flags, const i64* agg,
                             const i64* incl, i64 tile) {
  const int lane = threadIdx.x & 31;
  V acc{0, 0};
  for (i64 end = tile; end > 0; end -= 32) {
    const i64 j = end - 1 - lane;
    int f = 0;
    if (j >= 0) {
      do {
        f = *reinterpret_cast<const volatile int*>(flags + j);
      } while (f == 0);
    }
    __threadfence();
    const unsigned done = __ballot_sync(kFull, f == 2);
    const int stop = done ? __ffs(done) - 1 : 31;
    V x{0, 0};
    if (j >= 0 && lane <= stop) {
      const volatile i64* src = (f == 2 ? incl : agg) + 2 * j;
      x = V{src[0], src[1]};
    }
    // lanes further back are older: lane i takes lanes i .. i + 2d - 1
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const V o{__shfl_down_sync(kFull, x[0], d),
                __shfl_down_sync(kFull, x[1], d)};
      if (lane + d < 32) x = combine(o, x);
    }
    const V window{__shfl_sync(kFull, x[0], 0), __shfl_sync(kFull, x[1], 0)};
    acc = combine(window, acc);
    if (done) break;
  }
  return acc;
}

template <typename V>
__device__ __forceinline__ void publish_tile(int* flags, i64* vals, i64 tile,
                                             V v, int flag) {
  volatile i64* dst = vals + 2 * tile;
  dst[0] = v[0];
  dst[1] = v[1];
  __threadfence();
  *reinterpret_cast<volatile int*>(flags + tile) = flag;
}

// Where the merged order's position t kMergeTile cuts A (min(*la_p,
// cap_a) keys) and B (*lb_p), for every t <= tiles (clamped to the
// merged length): one warp a cut, all before the merge, so no tile waits
// on a search in device memory.
__global__ void __launch_bounds__(256)
merge_cuts_kernel(const i64* __restrict__ ak, const i64* __restrict__ la_p,
                  i64 cap_a, const i64* __restrict__ bk,
                  const i64* __restrict__ lb_p, i64 tiles,
                  i64* __restrict__ cuts) {
  const i64 t = (static_cast<i64>(blockIdx.x) * 256 + threadIdx.x) / 32;
  if (t > tiles) return;
  const i64 la_raw = *la_p;
  const i64 la = la_raw < cap_a ? la_raw : cap_a;
  const i64 lb = *lb_p;
  const i64 d = t * kMergeTile < la + lb ? t * kMergeTile : la + lb;
  const i64 cut = merge_path_warp(ak, la, bk, lb, d);
  if ((threadIdx.x & 31) == 0) cuts[t] = cut;
}

// A has min(*la_p, cap_a) live keys, B *lb_p. Blocks take tiles in ticket
// order; those past the last tile (one tile when both are empty) exit.
// Runs of rank >= cap are counted, not written.
__global__ void __launch_bounds__(kMergeThreads)
merge_accum_kernel(const i64* __restrict__ ak, const i64* __restrict__ ac,
                   const i64* __restrict__ la_p, i64 cap_a,
                   const i64* __restrict__ bk, const i64* __restrict__ bc,
                   const i64* __restrict__ lb_p, i64* __restrict__ out_k,
                   i64* __restrict__ out_c, i64* __restrict__ out_n, i64 cap,
                   const i64* __restrict__ cuts, int* flags, i64* agg,
                   i64* incl, unsigned* ticket) {
  extern __shared__ i64 smem[];
  i64* s_k = smem;
  i64* s_c = smem + kMergeSlots;
  __shared__ i64 s_warp[2 * kMergeThreads / 32];
  __shared__ i64 s_tile;
  __shared__ i64 s_edge[2];
  __shared__ Runs s_ex;
  __shared__ int s_first_starts;
  __shared__ int s_last_ends;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1u);
  __syncthreads();
  const i64 tile = s_tile;
  const i64 la_raw = *la_p;
  const i64 la = la_raw < cap_a ? la_raw : cap_a;
  const i64 lb = *lb_p;
  const i64 n = la + lb;
  const i64 tiles = n > 0 ? (n + kMergeTile - 1) / kMergeTile : 1;
  if (tile >= tiles) return;
  const i64 d0 = tile * kMergeTile;
  const i64 d1 = d0 + kMergeTile < n ? d0 + kMergeTile : n;
  const int m = static_cast<int>(d1 - d0);
  const i64 a0 = cuts[tile];
  const i64 b0 = d0 - a0;
  const int na = static_cast<int>(cuts[tile + 1] - a0);
  // both slices staged with every copy in flight at once
  for (int i = threadIdx.x; i < m; i += kMergeThreads) {
    if (i < na) {
      cp_async(s_k + padded(i), ak + a0 + i, 8);
      cp_async(s_c + padded(i), ac + a0 + i, 8);
    } else {
      cp_async(s_k + padded(i), bk + b0 + i - na, 8);
      cp_async(s_c + padded(i), bc + b0 + i - na, 8);
    }
  }
  cp_async_wait();
  if (threadIdx.x == 0) {
    // the merged order's key before the tile is the larger of the last
    // ones taken from A and B, the key after it the smaller of the next
    const i64 a1 = a0 + na;
    const i64 b1 = d1 - a1;
    i64 before = kNone;
    if (a0 > 0) before = ak[a0 - 1];
    if (b0 > 0 && bk[b0 - 1] > before) before = bk[b0 - 1];
    i64 after = kNone;
    if (a1 < la) after = ak[a1];
    if (b1 < lb && (after == kNone || bk[b1] < after)) after = bk[b1];
    s_edge[0] = before;
    s_edge[1] = after;
  }
  __syncthreads();
  // this thread's kMergeItems positions, merged into registers
  const int nb = m - na;
  const int first = static_cast<int>(threadIdx.x) * kMergeItems;
  const int d = first < m ? first : m;
  const int real = m - d < kMergeItems ? m - d : kMergeItems;
  i64 k[kMergeItems], c[kMergeItems];
#pragma unroll
  for (int j = 0; j < kMergeItems; ++j) {
    k[j] = kSentinel;
    c[j] = 0;
  }
  merge_items<kMergeItems>(s_k, s_c, 0, na, na, nb, d, real, k, c);
  __syncthreads();  // the staged slices are read; the merged keys replace
#pragma unroll
  for (int j = 0; j < kMergeItems; ++j) {
    if (j < real) s_k[padded(first + j)] = k[j];
  }
  __syncthreads();
  unsigned starts = 0, ends = 0;
  Runs mine{0, 0};
#pragma unroll
  for (int j = 0; j < kMergeItems; ++j) {
    if (j < real) {
      const int p = first + j;
      const i64 before = p > 0 ? s_k[padded(p - 1)] : s_edge[0];
      const i64 after = p + 1 < m ? s_k[padded(p + 1)] : s_edge[1];
      if (k[j] != before) starts |= 1u << j;
      if (k[j] != after) ends |= 1u << j;
      mine = combine(mine, Runs{static_cast<i64>((starts >> j) & 1u), c[j]});
      if (p == 0) s_first_starts = (starts >> j) & 1u;
      if (p + 1 == m) s_last_ends = (ends >> j) & 1u;
    }
  }
  Runs total;
  Runs run = scan_runs<kMergeThreads>(mine, s_warp, total);
  if (threadIdx.x < 32) {
    Runs ex{0, 0};
    if (tile == 0) {
      if (threadIdx.x == 0) publish_tile(flags, incl, tile, total, 2);
    } else {
      if (threadIdx.x == 0) publish_tile(flags, agg, tile, total, 1);
      ex = look_back_tiles<Runs>(flags, agg, incl, tile);
      if (threadIdx.x == 0) {
        publish_tile(flags, incl, tile, combine(ex, total), 2);
      }
    }
    if (threadIdx.x == 0) s_ex = ex;
  }
  __syncthreads();
  const Runs ex = s_ex;
  const i64 runs_after = ex.starts + total.starts;
  // the runs that end in the tile have consecutive ranks from r_first:
  // that of the run in progress at its start, or the next if it starts
  // one; staged by rank - r_first, then written out in order
  const i64 r_first = m > 0 ? ex.starts - 1 + s_first_starts : 0;
  const int ends_here =
      m > 0 ? static_cast<int>(runs_after - 1 + s_last_ends - r_first) : 0;
  run = combine(ex, run);
#pragma unroll
  for (int j = 0; j < kMergeItems; ++j) {
    if (j < real) {
      run = combine(run, Runs{static_cast<i64>((starts >> j) & 1u), c[j]});
      if ((ends >> j) & 1u) {
        const int slot = static_cast<int>(run.starts - 1 - r_first);
        s_k[padded(slot)] = k[j];
        s_c[padded(slot)] = run.tail;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ends_here; i += kMergeThreads) {
    const i64 rank = r_first + i;
    if (rank < cap) {
      out_k[rank] = s_k[padded(i)];
      out_c[rank] = s_c[padded(i)];
    }
  }
  if (tile == tiles - 1) {
    // the number of runs, after keeping the output's previous length;
    // SENTINEL/0 over the slots live before and not now
    const i64 prev = *out_n;
    __syncthreads();
    if (threadIdx.x == 0) *out_n = runs_after;
    const i64 lo = runs_after < cap ? runs_after : cap;
    const i64 hi = prev < cap ? prev : cap;
    for (i64 i = lo + threadIdx.x; i < hi; i += kMergeThreads) {
      out_k[i] = kSentinel;
      out_c[i] = 0;
    }
  }
}

// M2's scratch: the tiles' flags (zeroed), the ticket (zeroed), then
// their aggregates and inclusive values (two int64 a tile each).
struct MergeScratch {
  int* flags;
  unsigned* ticket;
  i64* agg;
  i64* incl;
  i64* cuts;
  i64 tiles;
  i64 zeroed;
  i64 bytes;
};

MergeScratch merge_scratch(char* base, i64 cap, i64 max_runs) {
  MergeScratch s;
  s.tiles = cdiv(cap + max_runs, kMergeTile);
  if (s.tiles < 1) s.tiles = 1;
  i64 at = 0;
  s.flags = reinterpret_cast<int*>(base + at);
  at += align_up(s.tiles * 4);
  s.ticket = reinterpret_cast<unsigned*>(base + at);
  at += align_up(8);
  s.zeroed = at;
  s.agg = reinterpret_cast<i64*>(base + at);
  at += align_up(s.tiles * 16);
  s.incl = reinterpret_cast<i64*>(base + at);
  at += align_up(s.tiles * 16);
  s.cuts = reinterpret_cast<i64*>(base + at);
  at += align_up((s.tiles + 1) * 8);
  s.bytes = at;
  return s;
}

// ---------------------------------------------------------------------------
// C1

constexpr int kCutThreads = 256;
constexpr int kCutItems = 16;
constexpr int kCutTile = kCutThreads * kCutItems;
// C1 takes M2's scratch for a merge of the accumulator with no runs: its
// tiles, of the same size (the cuts go unread)
static_assert(kCutTile == kMergeTile, "C1 tiles as M2 does");

// The live records (min(*n_p, cap) of keys/counts) in tiles of kCutTile,
// taken in ticket order; blocks past the last tile (one tile when none is
// live) exit. Warp w of a tile holds its records w * 512 .. w * 512 + 511,
// 32 consecutive a round, so a round's kept records go out contiguous in
// key order: at the tile's rank from the look-back, plus the warps before
// it, the rounds before and the lanes before. Kept keys go out as their
// uint64 words (SENTINEL as all ones), counts as their low 32 bits. The
// tile that holds the last record writes (kept, the sum of every live
// count, *n_p) to result.
__global__ void __launch_bounds__(kCutThreads)
cut_kernel(const i64* __restrict__ keys, const i64* __restrict__ counts,
           const i64* __restrict__ n_p, i64 cap, i64 min_count,
           u64* __restrict__ out_k, unsigned* __restrict__ out_c,
           i64* __restrict__ result, int* flags, i64* agg, i64* incl,
           unsigned* ticket) {
  constexpr int kWarps = kCutThreads / 32;
  __shared__ i64 s_warp[2 * kWarps];
  __shared__ i64 s_tile;
  __shared__ Kept s_ex;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1u);
  __syncthreads();
  const i64 tile = s_tile;
  const i64 n_raw = *n_p;
  const i64 n = n_raw < cap ? n_raw : cap;
  const i64 tiles = n > 0 ? (n + kCutTile - 1) / kCutTile : 1;
  if (tile >= tiles) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const i64 first = tile * kCutTile + warp * (32 * kCutItems) + lane;
  // every load in flight before any is used
  i64 k[kCutItems], c[kCutItems];
#pragma unroll
  for (int j = 0; j < kCutItems; ++j) {
    const i64 i = first + 32 * j;
    k[j] = i < n ? keys[i] : kSentinel;
    c[j] = i < n ? counts[i] : 0;
  }
  unsigned keep[kCutItems];
  i64 kept = 0;
  i64 sum = 0;
#pragma unroll
  for (int j = 0; j < kCutItems; ++j) {
    keep[j] = __ballot_sync(kFull, first + 32 * j < n && c[j] >= min_count);
    kept += __popc(keep[j]);
    sum += c[j];
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) sum += __shfl_down_sync(kFull, sum, d);
  if (lane == 0) {
    s_warp[warp] = kept;
    s_warp[kWarps + warp] = sum;
  }
  __syncthreads();
  i64 before = 0;
  Kept total{0, 0};
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += s_warp[w];
    total = combine(total, Kept{s_warp[w], s_warp[kWarps + w]});
  }
  if (threadIdx.x < 32) {
    Kept ex{0, 0};
    if (tile == 0) {
      if (threadIdx.x == 0) publish_tile(flags, incl, tile, total, 2);
    } else {
      if (threadIdx.x == 0) publish_tile(flags, agg, tile, total, 1);
      ex = look_back_tiles<Kept>(flags, agg, incl, tile);
      if (threadIdx.x == 0) {
        publish_tile(flags, incl, tile, combine(ex, total), 2);
      }
    }
    if (threadIdx.x == 0) s_ex = ex;
  }
  __syncthreads();
  const Kept ex = s_ex;
  i64 at = ex.kept + before;
  const unsigned lanes_below = (1u << lane) - 1;
#pragma unroll
  for (int j = 0; j < kCutItems; ++j) {
    if ((keep[j] >> lane) & 1u) {
      const i64 o = at + __popc(keep[j] & lanes_below);
      out_k[o] = k[j] == kSentinel ? ~0ull : static_cast<u64>(k[j]);
      out_c[o] = static_cast<unsigned>(c[j]);
    }
    at += __popc(keep[j]);
  }
  if (tile == tiles - 1 && threadIdx.x == 0) {
    const Kept all = combine(ex, total);
    result[0] = all.kept;
    result[1] = all.total;
    result[2] = n_raw;
  }
}

int set_smem(const void* kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

bool bad_piece(int piece) {
  return piece < 512 || piece > (1 << 14) || (piece & (piece - 1)) != 0;
}

}  // namespace

// The bytes of scratch km_chunk_runs needs for n keys in pieces of
// `piece` (0 if it does not take them).
extern "C" int64_t km_chunk_runs_scratch(int64_t n, int piece) {
  if (n <= 0 || bad_piece(piece)) return 0;
  return chunk_scratch(nullptr, n, piece).bytes;
}

// M1. keys/lengths: the chunk sort's output, n records in pieces of
// `piece` (a power of two, 512..2^14; the last piece may be ragged).
// Writes the runs to out_keys/out_cnt (n slots each; the first *m are
// live) and their number to *m. scratch: km_chunk_runs_scratch(n, piece)
// bytes, 256-byte aligned. tally: null, or two int64 to which the launch
// adds *m and the rounds its buckets took beyond one each (bucket_kernel).
extern "C" int km_chunk_runs(const void* keys, const void* lengths,
                             int64_t n, int piece, void* out_keys,
                             void* out_cnt, void* scratch,
                             int64_t scratch_bytes, void* m, void* tally,
                             void* stream) {
  if (n <= 0 || bad_piece(piece)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ChunkScratch s = chunk_scratch(static_cast<char*>(scratch), n, piece);
  if (scratch_bytes < s.bytes) return static_cast<int>(cudaErrorInvalidValue);
  const i64 pieces = cdiv(n, piece);
  const int buckets = static_cast<int>(buckets_for(n, piece));
  const i64 samples = static_cast<i64>(kSamplesPerBucket) * buckets;
  int err = set_smem(reinterpret_cast<const void*>(&sample_sort_kernel),
                     kSortSmem);
  if (!err) {
    err = set_smem(reinterpret_cast<const void*>(&bucket_kernel), kSortSmem);
  }
  const size_t split_smem = (buckets > 1 ? buckets - 1 : 1) * sizeof(i64);
  if (!err) {
    err = set_smem(reinterpret_cast<const void*>(&compact_kernel),
                   split_smem);
  }
  if (!err) {
    err = static_cast<int>(cudaMemsetAsync(s.status, 0, s.zeroed, st));
  }
  if (err) return err;
  if (buckets > 1) {
    sample_sort_kernel<<<static_cast<unsigned>(cdiv(samples, kSortCap)),
                         kSortThreads, kSortSmem, st>>>(
        static_cast<const i64*>(keys), n, samples, s.samples);
    sample_rank_kernel<<<static_cast<unsigned>(cdiv(samples, 256)), 256, 0,
                         st>>>(s.samples, samples, s.splitters);
  }
  compact_kernel<<<static_cast<unsigned>(pieces), kCompactThreads,
                   split_smem, st>>>(
      static_cast<const i64*>(keys), static_cast<const int*>(lengths), n,
      piece, s.splitters, buckets, s.keys, s.lengths, s.cut);
  bucket_kernel<<<static_cast<unsigned>(buckets), kSortThreads, kSortSmem,
                  st>>>(s.keys, s.lengths, piece, pieces, s.cut, s.splitters,
                        buckets,
                        static_cast<i64*>(out_keys),
                        static_cast<i64*>(out_cnt), static_cast<i64*>(m),
                        static_cast<i64*>(tally), s.status, s.ticket);
  return static_cast<int>(cudaGetLastError());
}

// The bytes of scratch km_merge_accum needs.
extern "C" int64_t km_merge_accum_scratch(int64_t cap, int64_t max_runs) {
  if (cap <= 0 || max_runs < 0) return 0;
  return merge_scratch(nullptr, cap, max_runs).bytes;
}

// M2. The accumulator (acc_keys/acc_cnt, `cap` slots, min(*acc_n, cap)
// live) and the runs (run_keys/run_cnt, *run_n live of at most max_runs)
// merge into out_keys/out_cnt (`cap` slots, which must hold SENTINEL and 0
// past min(*out_n, cap)); *out_n gets the number of distinct keys, which
// may exceed cap. scratch: km_merge_accum_scratch(cap, max_runs) bytes,
// 256-byte aligned.
extern "C" int km_merge_accum(const void* acc_keys, const void* acc_cnt,
                              const void* acc_n, int64_t cap,
                              const void* run_keys, const void* run_cnt,
                              const void* run_n, int64_t max_runs,
                              void* out_keys, void* out_cnt, void* out_n,
                              void* scratch, int64_t scratch_bytes,
                              void* stream) {
  if (cap <= 0 || max_runs < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const MergeScratch s =
      merge_scratch(static_cast<char*>(scratch), cap, max_runs);
  if (scratch_bytes < s.bytes) return static_cast<int>(cudaErrorInvalidValue);
  int err = set_smem(reinterpret_cast<const void*>(&merge_accum_kernel),
                     kMergeSmem);
  if (!err) err = static_cast<int>(cudaMemsetAsync(s.flags, 0, s.zeroed, st));
  if (err) return err;
  merge_cuts_kernel<<<static_cast<unsigned>(cdiv((s.tiles + 1) * 32, 256)),
                      256, 0, st>>>(
      static_cast<const i64*>(acc_keys), static_cast<const i64*>(acc_n), cap,
      static_cast<const i64*>(run_keys), static_cast<const i64*>(run_n),
      s.tiles, s.cuts);
  merge_accum_kernel<<<static_cast<unsigned>(s.tiles), kMergeThreads,
                       kMergeSmem, st>>>(
      static_cast<const i64*>(acc_keys), static_cast<const i64*>(acc_cnt),
      static_cast<const i64*>(acc_n), cap, static_cast<const i64*>(run_keys),
      static_cast<const i64*>(run_cnt), static_cast<const i64*>(run_n),
      static_cast<i64*>(out_keys), static_cast<i64*>(out_cnt),
      static_cast<i64*>(out_n), cap, s.cuts, s.flags, s.agg, s.incl,
      s.ticket);
  return static_cast<int>(cudaGetLastError());
}

// The bytes of scratch km_cut needs.
extern "C" int64_t km_cut_scratch(int64_t cap) {
  if (cap <= 0) return 0;
  return merge_scratch(nullptr, cap, 0).bytes;
}

// C1. The accumulator (keys/counts, `cap` slots, min(*n, cap) live) cut at
// min_count: the kept keys as uint64 words into out_keys, their counts'
// low 32 bits into out_cnt (each of `cap` slots at least; the first kept
// are written, in key order), and (kept, the sum of every live count, *n)
// into result, three int64. out_keys/out_cnt must not overlap the inputs.
// scratch: km_cut_scratch(cap) bytes, 256-byte aligned.
extern "C" int km_cut(const void* keys, const void* counts, const void* n,
                      int64_t cap, int64_t min_count, void* out_keys,
                      void* out_cnt, void* result, void* scratch,
                      int64_t scratch_bytes, void* stream) {
  if (cap <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const MergeScratch s = merge_scratch(static_cast<char*>(scratch), cap, 0);
  if (scratch_bytes < s.bytes) return static_cast<int>(cudaErrorInvalidValue);
  const int err =
      static_cast<int>(cudaMemsetAsync(s.flags, 0, s.zeroed, st));
  if (err) return err;
  cut_kernel<<<static_cast<unsigned>(s.tiles), kCutThreads, 0, st>>>(
      static_cast<const i64*>(keys), static_cast<const i64*>(counts),
      static_cast<const i64*>(n), cap, min_count, static_cast<u64*>(out_keys),
      static_cast<unsigned*>(out_cnt), static_cast<i64*>(result), s.flags,
      s.agg, s.incl, s.ticket);
  return static_cast<int>(cudaGetLastError());
}
