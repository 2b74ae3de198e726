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
//
// What bounds them on an H100: device memory. Each moves its records a
// few times and does a few compares per record. M2's least traffic is
// its live inputs read once and its live output written once, 16 bytes
// a record; M1's is the chunk read once (12 bytes a key) and its runs
// written once (16 bytes). The XLA formulation moved the padded
// accumulator and sorted it; here the accumulator is never sorted
// again, padding is never read, and no count is summed with an atomic
// (results are deterministic and equal to the plain versions bit for
// bit).
//
// Design:
// - Both inputs of every merge are sorted, so the merge is a merge path:
//   a block takes kTile consecutive positions of the merged order, finds
//   where its first and last position cut A and B by a search on the
//   diagonal, stages those slices in shared memory, and each thread
//   merges kItems positions from there (ties take A first). A cut is
//   searched by a whole warp, 32 probes a round, since one thread's
//   binary search over device memory (25 dependent loads at 2^25) held
//   the first version's blocks. Results go back through shared memory
//   (one pad word per 16, so the threads' 8-byte stores kItems apart
//   meet no bank conflict) and leave in contiguous stores. Lengths are
//   read from device memory, so nothing is read back to size a launch:
//   grids are sized for the most the merge can hold and blocks past the
//   live total exit.
// - M1 compacts each piece's live run starts in place (a block a piece,
//   a warp ballot for each lane's place, loads and stores contiguous),
//   then merges the pieces pairwise, one launch per level, ping-ponging
//   between two buffers; each segment's live length lives in device
//   memory. Equal keys stay adjacent through the tree. A torch.sort of
//   the live run starts alone takes about as long as the whole tree on
//   an H100, before the compaction, gathers and reduction it would need
//   (PERF.md), so the tree stays.
// - The last merge of M1, and M2's only merge, are fused with the
//   reduction: the merged order is never written. Pass 1 merges a tile,
//   flags key changes (the key before and after the tile come from the
//   merge path's cut) and writes the tile's count sum, run starts and
//   the count prefix at its last run start. Pass 2 (one block) scans
//   those of the tiles that hold merged positions into each tile's
//   offsets and the number of runs. Pass 3 merges
//   the tile again and writes each run at its rank, its total the
//   difference of the int64 count prefix at its end and at its start
//   (km_tpu's exact formulation). A run that spans tiles takes its start
//   prefix from the carry of pass 2. Reading the inputs twice costs less
//   than writing the merged order once and reading it twice.
// - M2 writes only the first `cap` runs (the capacity C) but reports the
//   true number; past its live output it restores the sentinel only over
//   the slots the output buffer held live before (its previous length is
//   read from device memory), so a stream that swaps two buffers never
//   rewrites the padding.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

using i64 = long long;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // merged positions per block
constexpr int kCompactThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;
constexpr i64 kSentinel = 0x7FFFFFFFFFFFFFFFLL;
constexpr i64 kNone = -1;  // below every key and every count prefix
constexpr unsigned kFull = 0xffffffffu;

struct Sum {
  __device__ __forceinline__ i64 operator()(i64 a, i64 b) const {
    return a + b;
  }
};

struct Max {
  __device__ __forceinline__ i64 operator()(i64 a, i64 b) const {
    return a > b ? a : b;
  }
};

// Exclusive scan of one value per thread over a block of kBlock threads;
// `total` receives the block's reduction. Starts and ends with a barrier's
// worth of ordering on s_warp, so it may be called back to back.
template <int kBlock, typename Op>
__device__ __forceinline__ i64 block_scan(i64 v, i64 identity, Op op,
                                          i64* s_warp, i64& total) {
  constexpr int kBlockWarps = kBlock / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  i64 incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const i64 o = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl = op(incl, o);
  }
  const i64 up = __shfl_up_sync(kFull, incl, 1);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  i64 before = identity;
  total = identity;
#pragma unroll
  for (int w = 0; w < kBlockWarps; ++w) {
    const i64 x = s_warp[w];
    if (w < warp) before = op(before, x);
    total = op(total, x);
  }
  __syncthreads();
  return lane == 0 ? before : op(before, up);
}

// The number of A's elements among the first d positions of the stable
// merge of A (la keys) and B (lb keys); on equal keys A comes first.
__device__ __forceinline__ i64 merge_path(const i64* a, i64 la,
                                          const i64* b, i64 lb, i64 d) {
  i64 lo = d > lb ? d - lb : 0;
  i64 hi = d < la ? d : la;
  while (lo < hi) {
    const i64 mid = (lo + hi) >> 1;
    if (a[mid] <= b[d - 1 - mid]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// merge_path by one warp: each round the 32 lanes probe 32 evenly spaced
// points of the range, so a range of 2^25 closes in 5 rounds of loads
// from device memory instead of 25 dependent ones. All lanes return it.
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

// A shared-memory slot for merged position p: one pad word per 16 keeps
// the 8-byte stores of threads kItems apart free of bank conflicts.
__device__ __forceinline__ int padded(int p) { return p + (p >> 4); }

constexpr int kStage = kTile + kTile / 16 + 1;  // padded(kTile) + 1 slots

// One tile of a merge: positions [d0, d1) of the merged order of A and B.
// Finds the cuts (warp 0 and warp 1), stages the keys and counts of both
// slices in shared memory (A's first) and returns the number taken from
// A; a0 gets A's first index. Ends with a barrier.
__device__ __forceinline__ int stage_tile(const i64* ak, const i64* ac,
                                          i64 la, const i64* bk,
                                          const i64* bc, i64 lb, i64 d0,
                                          i64 d1, i64* s_k, i64* s_c,
                                          i64* s_cut, i64& a0) {
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const i64 cut = merge_path_warp(ak, la, bk, lb, warp == 0 ? d0 : d1);
    if ((threadIdx.x & 31) == 0) s_cut[warp] = cut;
  }
  __syncthreads();
  a0 = s_cut[0];
  const i64 b0 = d0 - a0;
  const int na = static_cast<int>(s_cut[1] - a0);
  const int n = static_cast<int>(d1 - d0);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    if (i < na) {
      s_k[i] = ak[a0 + i];
      s_c[i] = ac[a0 + i];
    } else {
      s_k[i] = bk[b0 + i - na];
      s_c[i] = bc[b0 + i - na];
    }
  }
  __syncthreads();
  return na;
}

// This thread's kItems positions of the staged tile (na from A, n in
// all), merged into registers; returns how many are real.
__device__ __forceinline__ int merge_items(const i64* s_k, const i64* s_c,
                                           int na, int n, i64 (&k)[kItems],
                                           i64 (&c)[kItems]) {
  const int nb = n - na;
  const int d = min(static_cast<int>(threadIdx.x) * kItems, n);
  int ia = static_cast<int>(merge_path(s_k, na, s_k + na, nb, d));
  int ib = d - ia;
  const int real = min(kItems, n - d);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    k[j] = kSentinel;
    c[j] = 0;
    if (j < real) {
      const bool take_a = ib >= nb || (ia < na && s_k[ia] <= s_k[na + ib]);
      const int src = take_a ? ia : na + ib;
      k[j] = s_k[src];
      c[j] = s_c[src];
      ia += take_a ? 1 : 0;
      ib += take_a ? 0 : 1;
    }
  }
  return real;
}

// M1, step 1: one block per piece; the piece's live run starts (length >
// 0: real keys, SENTINEL runs are 0) go, in order, to the front of the
// piece's own region, counts widened to int64; seglen gets their number.
// Thread t takes elements t, t + kCompactThreads, ... of a tile, so loads
// and the stores of each warp's live lanes are contiguous; a warp's
// ballot gives each lane its place.
__global__ void __launch_bounds__(kCompactThreads)
compact_pieces_kernel(const i64* __restrict__ keys,
                      const int* __restrict__ lengths, i64 n, int piece,
                      i64* __restrict__ out_k, i64* __restrict__ out_c,
                      i64* __restrict__ seglen) {
  constexpr int kCompactWarps = kCompactThreads / 32;
  __shared__ int s_live[kItems][kCompactWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const i64 p0 = static_cast<i64>(blockIdx.x) * piece;
  const int len = static_cast<int>(n - p0 < piece ? n - p0 : piece);
  i64 written = 0;
  for (int base = 0; base < len; base += kCompactThreads * kItems) {
    i64 k[kItems];
    int c[kItems];
    unsigned live[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
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
    int at[kItems];
    int total = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
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
    for (int j = 0; j < kItems; ++j) {
      if ((live[j] >> lane) & 1u) {
        const i64 to = p0 + written + at[j] + __popc(live[j] & below);
        out_k[to] = k[j];
        out_c[to] = c[j];
      }
    }
    written += total;
    __syncthreads();  // s_live is read before the next tile writes it
  }
  if (threadIdx.x == 0) seglen[blockIdx.x] = written;
}

// M1, one level of the merge tree: segment 2p (at 2pR) and 2p + 1 (at
// (2p + 1)R) of the input, with live lengths in seg_in, merge into the
// output at 2pR; seg_out[p] gets the sum. 2R is a multiple of kTile.
__global__ void __launch_bounds__(kThreads)
merge_level_kernel(const i64* __restrict__ in_k, const i64* __restrict__ in_c,
                   const i64* __restrict__ seg_in, i64 segments, i64 region,
                   i64* __restrict__ out_k, i64* __restrict__ out_c,
                   i64* __restrict__ seg_out) {
  __shared__ i64 s_k[kStage];
  __shared__ i64 s_c[kStage];
  __shared__ i64 s_cut[2];
  const i64 tiles = 2 * region / kTile;
  const i64 pair = blockIdx.x / tiles;
  const i64 d0 = (blockIdx.x % tiles) * kTile;
  const i64 off = 2 * pair * region;
  const i64 la = seg_in[2 * pair];
  const i64 lb = 2 * pair + 1 < segments ? seg_in[2 * pair + 1] : 0;
  const i64 n = la + lb;
  if (d0 == 0 && threadIdx.x == 0) seg_out[pair] = n;
  if (d0 >= n) return;
  const i64 d1 = d0 + kTile < n ? d0 + kTile : n;
  i64 a0;
  const int na = stage_tile(in_k + off, in_c + off, la, in_k + off + region,
                            in_c + off + region, lb, d0, d1, s_k, s_c,
                            s_cut, a0);
  const int m = static_cast<int>(d1 - d0);
  i64 k[kItems], c[kItems];
  const int real = merge_items(s_k, s_c, na, m, k, c);
  __syncthreads();  // the staged tile is read; the merged one replaces it
  const int first = static_cast<int>(threadIdx.x) * kItems;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (j < real) {
      s_k[padded(first + j)] = k[j];
      s_c[padded(first + j)] = c[j];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += kThreads) {
    out_k[off + d0 + i] = s_k[padded(i)];
    out_c[off + d0 + i] = s_c[padded(i)];
  }
}

// The fused merge and reduction, pass 1 (kWrite false) and pass 3 (kWrite
// true). A has min(*la_p, cap_a) live keys, B *lb_p. stats holds, per
// tile, [0, nt) the count sum, [nt, 2nt) the run starts and [2nt, 3nt)
// the tile's count prefix at its last run start (kNone if it has none);
// pass 2 turns them into the tile's exclusive offsets and the global
// count prefix at the last run start before the tile. stats[3nt] holds
// the output's previous length. Runs of rank >= cap are counted, not
// written. With pad, pass 3 restores SENTINEL and 0 over the output slots
// [min(runs, cap), min(previous length, cap)).
template <bool kWrite>
__global__ void __launch_bounds__(kThreads)
merge_reduce_kernel(const i64* __restrict__ ak, const i64* __restrict__ ac,
                    const i64* __restrict__ la_p, i64 cap_a,
                    const i64* __restrict__ bk, const i64* __restrict__ bc,
                    const i64* __restrict__ lb_p, i64* __restrict__ stats,
                    i64 nt, i64* __restrict__ out_k, i64* __restrict__ out_c,
                    const i64* __restrict__ n_out, i64 cap, int pad) {
  __shared__ i64 s_k[kStage];
  __shared__ i64 s_c[kStage];
  __shared__ i64 s_cut[2];
  __shared__ i64 s_edge[2];
  __shared__ i64 s_warp[kWarps];
  __shared__ int s_first_starts;
  const i64 tile = blockIdx.x;
  if (kWrite && pad) {
    const i64 runs = *n_out;
    const i64 prev = stats[3 * nt];
    const i64 lo = runs < cap ? runs : cap;
    const i64 hi = prev < cap ? prev : cap;
    for (i64 i = lo + tile * kThreads + threadIdx.x; i < hi;
         i += static_cast<i64>(gridDim.x) * kThreads) {
      out_k[i] = kSentinel;
      out_c[i] = 0;
    }
  }
  const i64 la_raw = *la_p;
  const i64 la = la_raw < cap_a ? la_raw : cap_a;
  const i64 lb = *lb_p;
  const i64 n = la + lb;
  const i64 d0 = tile * kTile;
  if (d0 >= n) {
    if (!kWrite && threadIdx.x == 0) {
      stats[tile] = 0;
      stats[nt + tile] = 0;
      stats[2 * nt + tile] = kNone;
    }
    return;
  }
  const i64 d1 = d0 + kTile < n ? d0 + kTile : n;
  i64 a0;
  const int m = static_cast<int>(d1 - d0);
  const int na = stage_tile(ak, ac, la, bk, bc, lb, d0, d1, s_k, s_c, s_cut,
                            a0);
  if (threadIdx.x == 0) {
    // the merged order's key before the tile is the larger of the last
    // ones taken from A and B, the key after it the smaller of the next
    const i64 a1 = a0 + na;
    const i64 b0 = d0 - a0;
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
  i64 k[kItems], c[kItems];
  const int real = merge_items(s_k, s_c, na, m, k, c);
  __syncthreads();  // the staged tile is read; its keys are replaced
  const int first = static_cast<int>(threadIdx.x) * kItems;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (j < real) s_k[padded(first + j)] = k[j];
  }
  __syncthreads();
  unsigned starts = 0, ends = 0;
  i64 t_cnt = 0;
  i64 t_last = kNone;  // this thread's count prefix at its last run start
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (j < real) {
      const int p = first + j;
      const i64 before = p > 0 ? s_k[padded(p - 1)] : s_edge[0];
      const i64 after = p + 1 < m ? s_k[padded(p + 1)] : s_edge[1];
      if (k[j] != before) {
        starts |= 1u << j;
        t_last = t_cnt;
      }
      if (k[j] != after) ends |= 1u << j;
      t_cnt += c[j];
    }
  }
  i64 tot_cnt, tot_starts, tot_last;
  const i64 ex_cnt = block_scan<kThreads>(t_cnt, 0, Sum(), s_warp, tot_cnt);
  const i64 ex_starts =
      block_scan<kThreads>(__popc(starts), 0, Sum(), s_warp, tot_starts);
  const i64 mine = t_last == kNone ? kNone : ex_cnt + t_last;
  const i64 ex_last = block_scan<kThreads>(mine, kNone, Max(), s_warp,
                                           tot_last);
  if constexpr (!kWrite) {
    if (threadIdx.x == 0) {
      stats[tile] = tot_cnt;
      stats[nt + tile] = tot_starts;
      stats[2 * nt + tile] = tot_last;
    }
  } else {
    // The tile's runs that end in it have consecutive ranks, from that of
    // the run in progress at its start (slot 0; slot 1 if the tile starts
    // a run): staged by slot, then written out in order.
    if (threadIdx.x == 0) s_first_starts = starts & 1u;
    i64 tot_ends;
    block_scan<kThreads>(__popc(ends), 0, Sum(), s_warp, tot_ends);
    const i64 base = stats[tile];
    const i64 rank0 = stats[nt + tile] - 1;
    // the count prefix at the start of the run this thread begins in
    i64 run_start = ex_last == kNone ? stats[2 * nt + tile] : base + ex_last;
    i64 prefix = base + ex_cnt;
    int slot = static_cast<int>(ex_starts);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (j < real) {
        if ((starts >> j) & 1u) {
          run_start = prefix;
          ++slot;
        }
        prefix += c[j];
        if ((ends >> j) & 1u) {
          s_k[padded(slot)] = k[j];
          s_c[padded(slot)] = prefix - run_start;
        }
      }
    }
    __syncthreads();
    const int first_slot = s_first_starts;
    for (int i = threadIdx.x; i < tot_ends; i += kThreads) {
      const i64 rank = rank0 + first_slot + i;
      if (rank < cap) {
        out_k[rank] = s_k[padded(first_slot + i)];
        out_c[rank] = s_c[padded(first_slot + i)];
      }
    }
  }
}

// Pass 2: one block scans the tiles' sums into exclusive offsets, and
// the tiles' last run starts into the global count prefix at the last run
// start before each tile: only the tiles that hold merged positions (the
// lengths are read as pass 1 reads them); the others hold none and are
// not read again. Writes the number of runs to *n_out, after keeping its
// previous value in stats[3nt].
__global__ void __launch_bounds__(kScanThreads)
scan_tiles_kernel(i64* __restrict__ stats, i64 nt,
                  const i64* __restrict__ la_p, i64 cap_a,
                  const i64* __restrict__ lb_p, i64* __restrict__ n_out) {
  __shared__ i64 s_warp[kScanThreads / 32];
  const i64 la = *la_p < cap_a ? *la_p : cap_a;
  const i64 live = (la + *lb_p + kTile - 1) / kTile;
  const i64 used = live < nt ? live : nt;
  i64 carry_cnt = 0, carry_runs = 0, carry_last = kNone;
  for (i64 base = 0; base < used; base += kScanThreads * kScanItems) {
    const i64 first = base + static_cast<i64>(threadIdx.x) * kScanItems;
    i64 cnt[kScanItems], runs[kScanItems], last[kScanItems];
    i64 t_cnt = 0, t_runs = 0;
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      const i64 t = first + j;
      cnt[j] = t < used ? stats[t] : 0;
      runs[j] = t < used ? stats[nt + t] : 0;
      last[j] = t < used ? stats[2 * nt + t] : kNone;
      t_cnt += cnt[j];
      t_runs += runs[j];
    }
    i64 tot_cnt, tot_runs, tot_last;
    const i64 ex_cnt =
        carry_cnt + block_scan<kScanThreads>(t_cnt, 0, Sum(), s_warp,
                                             tot_cnt);
    const i64 ex_runs =
        carry_runs + block_scan<kScanThreads>(t_runs, 0, Sum(), s_warp,
                                              tot_runs);
    // each tile's last run start as a global count prefix
    i64 t_last = kNone;
    i64 prefix = ex_cnt;
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      if (last[j] != kNone) {
        last[j] += prefix;
        t_last = last[j];
      }
      prefix += cnt[j];
    }
    i64 ex_last = block_scan<kScanThreads>(t_last, kNone, Max(), s_warp,
                                           tot_last);
    if (carry_last > ex_last) ex_last = carry_last;
    i64 r = ex_runs;
    prefix = ex_cnt;
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      const i64 t = first + j;
      if (t < used) {
        stats[t] = prefix;
        stats[nt + t] = r;
        stats[2 * nt + t] = ex_last;
      }
      prefix += cnt[j];
      r += runs[j];
      if (last[j] != kNone) ex_last = last[j];
    }
    carry_cnt += tot_cnt;
    carry_runs += tot_runs;
    if (tot_last > carry_last) carry_last = tot_last;
  }
  if (threadIdx.x == 0) {
    stats[3 * nt] = *n_out;
    *n_out = carry_runs;
  }
}

i64 cdiv(i64 a, i64 b) { return (a + b - 1) / b; }

// the fused merge of (ak, ac; min(*la_p, cap_a)) and (bk, bc; *lb_p) into
// out, with the number of runs in *n_out
int merge_reduce(const i64* ak, const i64* ac, const i64* la_p, i64 cap_a,
                 const i64* bk, const i64* bc, const i64* lb_p, i64 most,
                 i64* out_k, i64* out_c, i64* n_out, i64 cap, int pad,
                 i64* stats, i64 stats_len, cudaStream_t stream) {
  const i64 nt = cdiv(most, kTile);
  if (nt < 1 || stats_len < 3 * nt + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned grid = static_cast<unsigned>(nt);
  merge_reduce_kernel<false><<<grid, kThreads, 0, stream>>>(
      ak, ac, la_p, cap_a, bk, bc, lb_p, stats, nt, out_k, out_c, n_out, cap,
      pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_tiles_kernel<<<1, kScanThreads, 0, stream>>>(stats, nt, la_p, cap_a,
                                                    lb_p, n_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_reduce_kernel<true><<<grid, kThreads, 0, stream>>>(
      ak, ac, la_p, cap_a, bk, bc, lb_p, stats, nt, out_k, out_c, n_out, cap,
      pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// M1. keys/lengths: the chunk sort's output, n records in pieces of
// `piece` (a power of two, 512..2^14; the last piece may be ragged).
// Writes the runs to out_keys/out_cnt (n slots each; the first *m are
// live) and their number to *m. tmp_keys/tmp_cnt: n slots of scratch
// each; seglen0 and seglen1: zeroed scratch of max(pieces, 2) and
// max(ceil(pieces / 2), 2) slots; stats: 3 ceil(n / 1024) + 1 slots.
extern "C" int km_chunk_runs(const void* keys, const void* lengths,
                             int64_t n, int piece, void* out_keys,
                             void* out_cnt, void* tmp_keys, void* tmp_cnt,
                             void* seglen0, void* seglen1, void* stats,
                             int64_t stats_len, void* m, void* stream) {
  if (n <= 0 || piece < 512 || piece > (1 << 14) ||
      (piece & (piece - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const i64 pieces = cdiv(n, piece);
  int levels = 0;
  for (i64 s = pieces; s > 2; s = cdiv(s, 2)) ++levels;
  // the compacted pieces start in the buffer that leaves the last level's
  // segments in tmp, so the fused last merge writes out
  i64* buf_k[2] = {static_cast<i64*>(tmp_keys), static_cast<i64*>(out_keys)};
  i64* buf_c[2] = {static_cast<i64*>(tmp_cnt), static_cast<i64*>(out_cnt)};
  i64* seg[2] = {static_cast<i64*>(seglen0), static_cast<i64*>(seglen1)};
  int cur = levels % 2;
  compact_pieces_kernel<<<static_cast<unsigned>(pieces), kCompactThreads, 0,
                          st>>>(
      static_cast<const i64*>(keys), static_cast<const int*>(lengths), n,
      piece, buf_k[cur], buf_c[cur], seg[0]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  i64 segments = pieces;
  i64 region = piece;
  for (int level = 0; level < levels; ++level) {
    const i64 pairs = cdiv(segments, 2);
    const i64 grid = pairs * (2 * region / kTile);
    merge_level_kernel<<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
        buf_k[cur], buf_c[cur], seg[level % 2], segments, region,
        buf_k[1 - cur], buf_c[1 - cur], seg[1 - level % 2]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cur = 1 - cur;
    segments = pairs;
    region *= 2;
  }
  const i64* fseg = seg[levels % 2];
  return merge_reduce(buf_k[0], buf_c[0], fseg, n, buf_k[0] + region,
                      buf_c[0] + region, fseg + 1, n,
                      static_cast<i64*>(out_keys), static_cast<i64*>(out_cnt),
                      static_cast<i64*>(m), n, 0, static_cast<i64*>(stats),
                      stats_len, st);
}

// M2. The accumulator (acc_keys/acc_cnt, `cap` slots, min(*acc_n, cap)
// live) and the runs (run_keys/run_cnt, *run_n live of at most max_runs)
// merge into out_keys/out_cnt (`cap` slots, which must hold SENTINEL and 0
// past min(*out_n, cap)); *out_n gets the number of distinct keys, which
// may exceed cap. stats: 3 ceil((cap + max_runs) / 1024) + 1 slots.
extern "C" int km_merge_accum(const void* acc_keys, const void* acc_cnt,
                              const void* acc_n, int64_t cap,
                              const void* run_keys, const void* run_cnt,
                              const void* run_n, int64_t max_runs,
                              void* out_keys, void* out_cnt, void* out_n,
                              void* stats, int64_t stats_len, void* stream) {
  if (cap <= 0 || max_runs < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return merge_reduce(
      static_cast<const i64*>(acc_keys), static_cast<const i64*>(acc_cnt),
      static_cast<const i64*>(acc_n), cap, static_cast<const i64*>(run_keys),
      static_cast<const i64*>(run_cnt), static_cast<const i64*>(run_n),
      cap + max_runs, static_cast<i64*>(out_keys),
      static_cast<i64*>(out_cnt), static_cast<i64*>(out_n), cap, 1,
      static_cast<i64*>(stats), stats_len, static_cast<cudaStream_t>(stream));
}
