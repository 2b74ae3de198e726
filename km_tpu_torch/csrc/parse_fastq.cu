// P1. FASTQ text on the card -> one chunk's base codes and validity flags.
//
// Replaces no TPU kernel. km_tpu parses on the host
// (native/kmio.cpp::km_parse_fastq) and uploads codes and flags, and so did
// the port until its stream count moved the parse here: the host now reads
// whole records into pinned memory, the text goes up as it is, and this
// kernel writes what K1 takes. Its output equals km_parse_fastq's on every
// record: the same code table (A, C, G, T either case; N, IUPAC letters, a
// CR and everything else invalid), a base under `qmin` invalid, one invalid
// separator after each read, and the rest of the chunk invalid padding.
//
// Records are read by lines: a line starting '@', the sequence, a line
// starting '+', a quality line as long as the sequence, each ended by '\n'
// (the host ends a file's last line when the file does not). Anything else,
// or more positions than the chunk holds, sets `*bad` and is never counted:
// the host reads the flag in the wait it already has and raises.
//
// What bounds it on an H100: bytes, the text read once and 2 B a position
// of the chunk written (a code, a flag): 0.02 ms for a 2^25-byte block of
// 216-byte records and a 2^24-position chunk at 3.35 TB/s. The design
// reads the text three times and writes the chunk twice (the fill, then
// the records' positions), about 160 MB, 0.05 ms. Everything is done by
// tile of 8,192 bytes, so the scratch is 24 B a tile (96 KiB for a
// 2^25-byte block): nothing is kept a line or a record, and the scratch
// does not grow with the number of reads. Five launches after a fill of
// the chunk's codes and flags:
// 1. fastq_lines_kernel: each block counts the newlines of its tile
//    (16-byte loads, four bytes compared at once) and keeps the offsets
//    of its last four.
// 2. fastq_scan_kernel: one block turns the tiles' counts into each
//    tile's first line number, and the total.
// 3. fastq_records_kernel: each block puts its tile's newlines in shared
//    memory by their line; the thread that holds a record's last newline
//    (every fourth line) checks the record and counts its positions (the
//    sequence length plus the separator, 0 for a broken record). A
//    record's first newlines may lie in earlier tiles: they are among
//    the last four of the tile a binary search over the first line
//    numbers finds. The block sums its records' positions.
// 4. fastq_scan_kernel again, over those sums: each tile's first position.
// 5. fastq_bases_kernel: each block finds its records again, scans their
//    positions to output offsets and lists them in shared memory; then a
//    warp a record writes its codes and flags, the warp's 32 lanes on 32
//    neighbouring bytes of the sequence and of the quality line, four
//    such loads in flight a lane before any store. Separators and
//    padding stay 0 from the fill.
// Counts are read from device memory, so nothing is read back to size a
// launch. The two scans across tiles are one block each: a 2^25-byte
// block of text has 4,096 tiles, and a look-back across blocks would save
// microseconds of a chunk's milliseconds.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileBytes = kThreads * 32;  // 32 bytes a thread
// whole records ending in a tile: each takes at least 6 bytes
// ("@\n\n+\n\n"), and only the first may begin before the tile
constexpr int kTileRecords = kTileBytes / 6 + 1;
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 16;  // a thread's run in a scan pass

struct Scratch {
  int* tile_lines;      // [tiles]: newlines of a tile, then its first line
  int* tile_last;       // [4 * tiles]: a tile's last four newlines
  int* tile_positions;  // [tiles]: positions of the records ending in a
                        // tile, then the tile's first position
  int* counts;          // [2]: lines, positions
  int64_t tiles, bytes;
};

int64_t align256(int64_t b) { return (b + 255) & ~int64_t(255); }

Scratch scratch_of(char* base, int64_t n) {
  Scratch s{};
  s.tiles = (n + kTileBytes - 1) / kTileBytes;
  int64_t at = 0;
  auto take = [&](int64_t elems) {
    char* p = base == nullptr ? nullptr : base + at;
    at += align256(elems * static_cast<int64_t>(sizeof(int)));
    return reinterpret_cast<int*>(p);
  };
  s.tile_lines = take(s.tiles);
  s.tile_last = take(4 * s.tiles);
  s.tile_positions = take(s.tiles);
  s.counts = take(2);
  s.bytes = at;
  return s;
}

// a mask of the newlines among four bytes, one bit a byte
__device__ __forceinline__ uint32_t nl4(uint32_t w) {
  const uint32_t eq = __vcmpeq4(w, 0x0A0A0A0Au);  // 0xFF where '\n'
  return ((eq >> 7) & 1u) | ((eq >> 14) & 2u) | ((eq >> 21) & 4u) |
         ((eq >> 28) & 8u);
}

// the thread's 32 bytes from `p` (16-byte aligned when `aligned`), as a
// mask of their newlines; bytes at or past `n` are none
__device__ __forceinline__ uint32_t newline_mask(const uint8_t* text,
                                                 int64_t p, int64_t n,
                                                 int aligned) {
  uint32_t mask = 0;
  if (aligned != 0 && p + 32 <= n) {
    const uint4 a = *reinterpret_cast<const uint4*>(text + p);
    const uint4 b = *reinterpret_cast<const uint4*>(text + p + 16);
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) mask |= nl4(w[i]) << (4 * i);
  } else {
    for (int i = 0; i < 32; ++i) {
      if (p + i < n && text[p + i] == '\n') mask |= 1u << i;
    }
  }
  return mask;
}

// exclusive prefix of v over the block (blockDim.x a multiple of 32, at
// most 1024); *total gets the block's sum. Two barriers.
__device__ __forceinline__ int block_exclusive(int v, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = lane < warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xFFFFFFFFu, s, d);
      if (lane >= d) s += o;
    }
    warp_sums[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  const int before = warp == 0 ? 0 : warp_sums[warp - 1];
  *total = warp_sums[warps - 1];
  return before + incl - v;
}

__global__ void __launch_bounds__(kThreads)
fastq_lines_kernel(const uint8_t* __restrict__ text, int64_t n, int aligned,
                   int* __restrict__ tile_lines, int* __restrict__ tile_last) {
  const int64_t p =
      static_cast<int64_t>(blockIdx.x) * kTileBytes + 32LL * threadIdx.x;
  uint32_t mask = newline_mask(text, p, n, aligned);
  int total;
  int line = block_exclusive(__popc(mask), &total);
  if (threadIdx.x == 0) tile_lines[blockIdx.x] = total;
  // the last four, the last in slot 3
  while (mask != 0) {
    const int bit = __ffs(mask) - 1;
    mask &= mask - 1;
    const int rank = total - 1 - line;
    if (rank < 4) {
      tile_last[4 * static_cast<int64_t>(blockIdx.x) + 3 - rank] =
          static_cast<int>(p + bit);
    }
    ++line;
  }
}

// Exclusive scan in place of data[0, n); *total gets the sum.
__global__ void __launch_bounds__(kScanThreads)
fastq_scan_kernel(int* __restrict__ data, int64_t n, int* __restrict__ total) {
  int running = 0;
  for (int64_t seg = 0; seg < n; seg += kScanThreads * kScanItems) {
    const int64_t first = seg + static_cast<int64_t>(threadIdx.x) * kScanItems;
    int v[kScanItems];
    int sum = 0;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      v[i] = first + i < n ? data[first + i] : 0;
      sum += v[i];
    }
    int seg_total;
    int at = running + block_exclusive(sum, &seg_total);
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      if (first + i < n) data[first + i] = at;
      at += v[i];
    }
    running += seg_total;
    __syncthreads();  // warp_sums is read again by the next segment
  }
  if (threadIdx.x == 0) *total = running;
}

// A tile's newlines in shared memory, by their line in the tile, and the
// lookup of any newline a record ending in the tile needs.
struct TileLines {
  const uint8_t* text;
  const int* tile_lines;  // first line of each tile (scanned)
  const int* tile_last;
  const uint16_t* nl;     // offsets in the tile
  int64_t tile_at;        // the tile's first byte
  int tile, first;        // the tile, its first line

  // the offset of line L's newline; L >= first - 4
  __device__ __forceinline__ int64_t end_of(int L) const {
    if (L >= first) return tile_at + nl[L - first];
    int lo = 0, hi = tile - 1;  // the last earlier tile whose lines reach L
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (tile_lines[mid] <= L) lo = mid; else hi = mid - 1;
    }
    // L is among its last four: at most three lines follow it up to here
    return tile_last[4 * lo + 3 - (tile_lines[lo + 1] - 1 - L)];
  }

  // the record whose last newline, of line R, is at e3: the first bytes
  // of its sequence and quality lines, and the sequence's length; false
  // where it breaks the structure
  __device__ __forceinline__ bool record(int R, int64_t e3, int64_t* seq_at,
                                         int64_t* qual_at, int* len) const {
    const int64_t e2 = end_of(R - 1), e1 = end_of(R - 2), e0 = end_of(R - 3);
    const int64_t head = R == 3 ? 0 : end_of(R - 4) + 1;
    *seq_at = e0 + 1;
    *qual_at = e2 + 1;
    *len = static_cast<int>(e1 - e0 - 1);
    return text[head] == '@' && text[e1 + 1] == '+' && e3 - e2 == e1 - e0;
  }
};

// the block's tile: its newlines into nl, this thread's mask and the
// line of its first newline
__device__ __forceinline__ TileLines stage_tile(
    const uint8_t* text, int64_t n, int aligned, const int* tile_lines,
    const int* tile_last, uint16_t* nl, uint32_t* mask_out, int* line_out) {
  TileLines t;
  t.text = text;
  t.tile_lines = tile_lines;
  t.tile_last = tile_last;
  t.nl = nl;
  t.tile = blockIdx.x;
  t.tile_at = static_cast<int64_t>(blockIdx.x) * kTileBytes;
  t.first = tile_lines[blockIdx.x];
  const int off = 32 * threadIdx.x;
  const uint32_t mask0 = newline_mask(text, t.tile_at + off, n, aligned);
  int total;
  const int in_tile = block_exclusive(__popc(mask0), &total);
  uint32_t mask = mask0;
  for (int i = in_tile; mask != 0; ++i) {
    nl[i] = static_cast<uint16_t>(off + __ffs(mask) - 1);
    mask &= mask - 1;
  }
  __syncthreads();
  *mask_out = mask0;
  *line_out = t.first + in_tile;
  return t;
}

__global__ void __launch_bounds__(kThreads)
fastq_records_kernel(const uint8_t* __restrict__ text, int64_t n, int aligned,
                     const int* __restrict__ tile_lines,
                     const int* __restrict__ tile_last,
                     const int* __restrict__ counts,
                     int* __restrict__ tile_positions,
                     long long* __restrict__ bad) {
  __shared__ uint16_t nl[kTileBytes];
  if (blockIdx.x == 0 && threadIdx.x == 0 &&
      (counts[0] % 4 != 0 || text[n - 1] != '\n')) {
    *bad = 1;
  }
  uint32_t mask;
  int line;
  const TileLines t = stage_tile(text, n, aligned, tile_lines, tile_last, nl,
                                 &mask, &line);
  int positions = 0;
  for (; mask != 0; ++line) {
    const int64_t e3 = t.tile_at + 32 * threadIdx.x + __ffs(mask) - 1;
    mask &= mask - 1;
    if ((line & 3) != 3) continue;
    int64_t seq_at, qual_at;
    int len;
    if (t.record(line, e3, &seq_at, &qual_at, &len)) {
      positions += len + 1;
    } else {
      *bad = 1;
    }
  }
  int total;
  block_exclusive(positions, &total);
  if (threadIdx.x == 0) tile_positions[blockIdx.x] = total;
}

__device__ __forceinline__ uint8_t code_of(uint8_t b) {
  switch (b | 0x20) {  // 'A' -> 'a', ...; no other byte becomes a letter
    case 'a': return 0;
    case 'c': return 1;
    case 'g': return 2;
    case 't': return 3;
    default: return 255;
  }
}

__global__ void __launch_bounds__(kThreads)
fastq_bases_kernel(const uint8_t* __restrict__ text, int64_t n, int aligned,
                   const int* __restrict__ tile_lines,
                   const int* __restrict__ tile_last,
                   const int* __restrict__ counts,
                   const int* __restrict__ tile_positions, int qmin,
                   int64_t chunk, uint8_t* __restrict__ codes,
                   uint8_t* __restrict__ valid, long long* __restrict__ bad) {
  constexpr int kUnroll = 4;  // bytes a lane loads before it stores
  __shared__ uint16_t nl[kTileBytes];
  __shared__ int rec_seq[kTileRecords];  // the sequence's first byte
  __shared__ int rec_qual[kTileRecords];  // the quality line's
  __shared__ int rec_len[kTileRecords];
  __shared__ int rec_at[kTileRecords];    // first position in the chunk
  if (blockIdx.x == 0 && threadIdx.x == 0 && counts[1] > chunk) *bad = 1;
  uint32_t mask;
  int line;
  const TileLines t = stage_tile(text, n, aligned, tile_lines, tile_last, nl,
                                 &mask, &line);
  // this thread's whole records: their positions and how many
  int positions = 0, whole = 0;
  {
    uint32_t m = mask;
    for (int l = line; m != 0; ++l) {
      const int64_t e3 = t.tile_at + 32 * threadIdx.x + __ffs(m) - 1;
      m &= m - 1;
      int64_t seq_at, qual_at;
      int len;
      if ((l & 3) == 3 && t.record(l, e3, &seq_at, &qual_at, &len)) {
        positions += len + 1;
        ++whole;
      }
    }
  }
  int n_rec;
  int at = tile_positions[blockIdx.x] + block_exclusive(positions, &n_rec);
  __syncthreads();  // warp_sums is read again below
  int slot = block_exclusive(whole, &n_rec);
  for (; mask != 0; ++line) {
    const int64_t e3 = t.tile_at + 32 * threadIdx.x + __ffs(mask) - 1;
    mask &= mask - 1;
    int64_t seq_at, qual_at;
    int len;
    if ((line & 3) == 3 && t.record(line, e3, &seq_at, &qual_at, &len)) {
      rec_seq[slot] = static_cast<int>(seq_at);
      rec_qual[slot] = static_cast<int>(qual_at);
      rec_len[slot] = len;
      rec_at[slot] = at;
      at += len + 1;
      ++slot;
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < n_rec; r += kThreads / 32) {
    const int64_t out = rec_at[r];
    const int64_t len = rec_len[r];
    if (out + len + 1 > chunk) continue;  // past the chunk: not written
    const uint8_t* seq = text + rec_seq[r];
    const uint8_t* qual = text + rec_qual[r];
    for (int64_t i0 = 0; i0 < len; i0 += 32 * kUnroll) {
      uint8_t b[kUnroll], q[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = i0 + 32 * u + lane;
        b[u] = i < len ? seq[i] : 0;
        q[u] = i < len ? qual[i] : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = i0 + 32 * u + lane;
        if (i < len) {
          const uint8_t c = code_of(b[u]);
          const bool ok = c != 255 && static_cast<int>(q[u]) >= qmin;
          codes[out + i] = ok ? c : 0;
          valid[out + i] = ok ? 1 : 0;
        }
      }
    }
  }
}

}  // namespace

extern "C" int64_t km_parse_fastq_scratch(int64_t n) {
  if (n <= 0 || n > (int64_t(1) << 30)) return 0;
  return scratch_of(nullptr, n).bytes;
}

// P1. text: n bytes of whole FASTQ records (1 <= n <= 2^30); qmin: the
// least quality byte of a valid base, or a negative number for none.
// codes/valid: `chunk` bytes each, filled here (codes 0..3, valid 0/1);
// bad: one int64 set to 1 where the text is not whole records or holds
// more than `chunk` positions, and left as it was otherwise.
// scratch: km_parse_fastq_scratch(n) bytes, 256-byte aligned.
extern "C" int km_parse_fastq_device(const void* text, int64_t n, int qmin,
                                     int64_t chunk, void* codes, void* valid,
                                     void* bad, void* scratch,
                                     int64_t scratch_bytes, void* stream) {
  if (n <= 0 || n > (int64_t(1) << 30) || chunk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Scratch s = scratch_of(static_cast<char*>(scratch), n);
  if (scratch_bytes < s.bytes) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* t = static_cast<const uint8_t*>(text);
  long long* flag = static_cast<long long*>(bad);
  const int aligned = (reinterpret_cast<uintptr_t>(text) & 15) == 0 ? 1 : 0;
  int err = static_cast<int>(cudaMemsetAsync(codes, 0, chunk, st));
  if (!err) err = static_cast<int>(cudaMemsetAsync(valid, 0, chunk, st));
  if (err) return err;
  const unsigned tiles = static_cast<unsigned>(s.tiles);
  fastq_lines_kernel<<<tiles, kThreads, 0, st>>>(t, n, aligned, s.tile_lines,
                                                 s.tile_last);
  fastq_scan_kernel<<<1, kScanThreads, 0, st>>>(s.tile_lines, s.tiles,
                                                s.counts);
  fastq_records_kernel<<<tiles, kThreads, 0, st>>>(
      t, n, aligned, s.tile_lines, s.tile_last, s.counts, s.tile_positions,
      flag);
  fastq_scan_kernel<<<1, kScanThreads, 0, st>>>(s.tile_positions, s.tiles,
                                                s.counts + 1);
  fastq_bases_kernel<<<tiles, kThreads, 0, st>>>(
      t, n, aligned, s.tile_lines, s.tile_last, s.counts, s.tile_positions,
      qmin, chunk, static_cast<uint8_t*>(codes), static_cast<uint8_t*>(valid),
      flag);
  return static_cast<int>(cudaGetLastError());
}
