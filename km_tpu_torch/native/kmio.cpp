// kmio.cpp — native host-side IO for km_tpu_torch (km_tpu/native/kmio.cpp's
// functions, unchanged, and the port's own km_merge_pieces, the chunked
// count's host merge).
//
// The throughput-critical feed of the counting pipeline: FASTQ/FASTA text
// -> 2-bit base codes + validity mask, ready for the device pack/sort
// kernels. Replaces the capability of Jellyfish's C++ reader front-end
// (the reference reaches it via `jellyfish count`;
// example/run_leucegene.sh:22) — the port parses on the host and counts
// on the card.
//
// Layout contract (shared with km_tpu_torch/io/fastq.py): reads are
// concatenated into one code stream, one invalid separator position
// between reads so no k-mer window spans two reads; non-ACGT bases and
// bases under the quality threshold are invalid.
//
// Build: km_tpu_torch/_build.py::build_native, at first use, into
// km_tpu_torch/build/libkmio.so (the Python wrapper says why when it
// cannot).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

// base -> 2-bit code; 255 = invalid
struct CodeTable {
  uint8_t t[256];
  CodeTable() {
    memset(t, 255, sizeof(t));
    t[(unsigned)'A'] = t[(unsigned)'a'] = 0;
    t[(unsigned)'C'] = t[(unsigned)'c'] = 1;
    t[(unsigned)'G'] = t[(unsigned)'g'] = 2;
    t[(unsigned)'T'] = t[(unsigned)'t'] = 3;
  }
};
const CodeTable kCodes;

inline const char* find_nl(const char* p, const char* end) {
  const void* nl = memchr(p, '\n', end - p);
  return nl ? static_cast<const char*>(nl) : end;
}

}  // namespace

extern "C" {

// Parse FASTQ text. Returns the number of output positions written, or
// -1 if `cap` is too small, -2 on malformed input. `consumed_out`
// receives the number of input bytes of *complete records* consumed —
// callers carry the tail over to the next buffer.
long km_parse_fastq(const char* buf, long len, int qmin, uint8_t* codes,
                    uint8_t* valid, long cap, long* consumed_out) {
  const char* p = buf;
  const char* end = buf + len;
  long w = 0;
  long consumed = 0;
  while (p < end) {
    const char* rec = p;
    if (*p != '@') return -2;
    const char* h_end = find_nl(p, end);
    if (h_end == end) break;
    const char* seq = h_end + 1;
    const char* seq_end = find_nl(seq, end);
    if (seq_end == end) break;
    const char* plus = seq_end + 1;
    const char* plus_end = find_nl(plus, end);
    if (plus_end == end) break;
    const char* qual = plus_end + 1;
    long n = seq_end - seq;
    if (end - qual < n) break;  // incomplete quality line
    const char* qual_end = qual + n;
    // advance past trailing newline if present
    const char* next = qual_end < end && *qual_end == '\n' ? qual_end + 1
                                                          : qual_end;
    if (w + n + 1 > cap) return -1;
    for (long i = 0; i < n; i++) {
      uint8_t c = kCodes.t[(uint8_t)seq[i]];
      uint8_t ok = c != 255;
      if (qmin >= 0 && (uint8_t)qual[i] < (uint8_t)qmin) ok = 0;
      codes[w + i] = ok ? c : 0;
      valid[w + i] = ok;
    }
    codes[w + n] = 0;  // read separator
    valid[w + n] = 0;
    w += n + 1;
    consumed = next - buf;
    p = next;
    (void)rec;
  }
  *consumed_out = consumed;
  return w;
}

// Parse FASTA text (no qualities). Same contract as km_parse_fastq.
long km_parse_fasta(const char* buf, long len, uint8_t* codes,
                    uint8_t* valid, long cap, long* consumed_out) {
  const char* p = buf;
  const char* end = buf + len;
  long w = 0;
  long consumed = 0;
  bool in_seq = false;
  const char* line = p;
  while (line < end) {
    const char* nl = find_nl(line, end);
    bool complete = nl < end;
    long n = nl - line;
    if (n > 0 && line[0] == '>') {
      if (in_seq) {
        if (w + 1 > cap) return -1;
        codes[w] = 0;
        valid[w] = 0;
        w += 1;
      }
      in_seq = true;
      if (!complete) break;
    } else {
      if (!complete) break;  // sequence tails carry to the next buffer
      if (w + n > cap) return -1;
      for (long i = 0; i < n; i++) {
        uint8_t c = kCodes.t[(uint8_t)line[i]];
        codes[w + i] = c != 255 ? c : 0;
        valid[w + i] = c != 255;
      }
      w += n;
    }
    line = nl + 1;
    consumed = line - buf;
  }
  // close the final record separator
  if (in_seq && consumed == len) {
    if (w + 1 > cap) return -1;
    codes[w] = 0;
    valid[w] = 0;
    w += 1;
  }
  *consumed_out = consumed;
  return w;
}

// Count k-mers on the host: pack windows, canonicalize, sort, run-length
// encode. Returns the number of distinct keys (<= n_windows), with keys
// and counts written to the output arrays (caller sizes them to the
// window count). Multithreaded sort for large inputs.
long km_count_host(const uint8_t* codes, const uint8_t* valid, long n,
                   int k, int canonical, uint64_t* keys_out,
                   uint32_t* counts_out) {
  if (n < k) return 0;
  long n_win = n - k + 1;
  std::vector<uint64_t> keys;
  keys.reserve(n_win);
  const uint64_t mask = k < 32 ? ((1ULL << (2 * k)) - 1) : ~0ULL;
  uint64_t cur = 0;
  long run = 0;  // valid bases accumulated
  for (long i = 0; i < n; i++) {
    if (!valid[i]) {
      run = 0;
      cur = 0;
      continue;
    }
    cur = ((cur << 2) | codes[i]) & mask;
    if (++run >= k) {
      uint64_t key = cur;
      if (canonical) {
        // reverse complement
        uint64_t v = ~key;
        v = ((v >> 2) & 0x3333333333333333ULL) |
            ((v & 0x3333333333333333ULL) << 2);
        v = ((v >> 4) & 0x0F0F0F0F0F0F0F0FULL) |
            ((v & 0x0F0F0F0F0F0F0F0FULL) << 4);
        v = __builtin_bswap64(v);
        v >>= (64 - 2 * k);
        if (v < key) key = v;
      }
      keys.push_back(key);
    }
  }
  if (keys.empty()) return 0;
  std::sort(keys.begin(), keys.end());
  long out = 0;
  uint64_t prev = keys[0];
  uint32_t cnt = 0;
  for (uint64_t key : keys) {
    if (key != prev) {
      keys_out[out] = prev;
      counts_out[out] = cnt;
      out++;
      prev = key;
      cnt = 0;
    }
    cnt++;
  }
  keys_out[out] = prev;
  counts_out[out] = cnt;
  return out + 1;
}

// K-way merge of sorted (key, count) runs, summing duplicate keys —
// the host-side combine step behind device chunk counting (capability
// of Jellyfish's hash merge; the reference reaches it via `jellyfish
// count`). runs are concatenated in keys/counts with offsets[s+1]
// boundaries; each run must be ascending by key. Returns the number of
// merged records written (<= total input records).
long km_merge_runs(const uint64_t* keys, const int64_t* counts,
                   const int64_t* offsets, long s, uint64_t* out_keys,
                   int64_t* out_counts) {
  // binary min-heap of (key, run) with the run's cursor advancing
  struct Entry {
    uint64_t key;
    long run;
  };
  std::vector<Entry> heap;
  std::vector<int64_t> cur(s);
  heap.reserve(s);
  for (long r = 0; r < s; r++) {
    cur[r] = offsets[r];
    if (offsets[r] < offsets[r + 1])
      heap.push_back({keys[offsets[r]], r});
  }
  auto gt = [](const Entry& a, const Entry& b) { return a.key > b.key; };
  std::make_heap(heap.begin(), heap.end(), gt);

  long out = -1;
  uint64_t prev_key = 0;
  while (!heap.empty()) {
    std::pop_heap(heap.begin(), heap.end(), gt);
    Entry e = heap.back();
    heap.pop_back();
    long i = cur[e.run]++;
    if (out >= 0 && e.key == prev_key) {
      out_counts[out] += counts[i];
    } else {
      out++;
      out_keys[out] = e.key;
      out_counts[out] = counts[i];
      prev_key = e.key;
    }
    if (cur[e.run] < offsets[e.run + 1]) {
      heap.push_back({keys[cur[e.run]], e.run});
      std::push_heap(heap.begin(), heap.end(), gt);
    }
  }
  return out + 1;
}

// The end of a capped stream count (jellyfish's --disk merge): s sorted
// pieces of distinct keys, piece r at keys[r]/counts[r] with lens[r]
// records, merged with the counts of equal keys summed in 64 bits. The
// keys whose sum reaches min_count go to out_keys/out_counts (the sum's
// low 32 bits) in key order; *unique gets the number of distinct keys.
// The key range is split at quantiles of the largest piece into one
// range a thread (up to 8, fewer for small inputs); each thread merges
// its slices of the pieces into the outputs at the offset of their first
// records, taking the least of the pieces' heads by a scan of them, and
// the kept records are then moved together. Returns the number kept.
long km_merge_pieces(const uint64_t* const* keys,
                     const uint32_t* const* counts, const int64_t* lens,
                     long s, int64_t min_count, uint64_t* out_keys,
                     uint32_t* out_counts, int64_t* unique) {
  int64_t total = 0;
  long big = 0;
  for (long r = 0; r < s; r++) {
    total += lens[r];
    if (lens[r] > lens[big]) big = r;
  }
  const long hw = std::max(1u, std::thread::hardware_concurrency());
  const long n_threads =
      std::min({8L, hw, std::max(1L, static_cast<long>(total >> 20))});
  // bounds[t * s + r]: the first record of piece r in range t
  std::vector<int64_t> bounds((n_threads + 1) * s);
  for (long r = 0; r < s; r++) {
    bounds[r] = 0;
    bounds[n_threads * s + r] = lens[r];
  }
  for (long t = 1; t < n_threads; t++) {
    const uint64_t split = keys[big][lens[big] * t / n_threads];
    for (long r = 0; r < s; r++)
      bounds[t * s + r] =
          std::lower_bound(keys[r], keys[r] + lens[r], split) - keys[r];
  }
  std::vector<int64_t> base(n_threads, 0), kept(n_threads), distinct(
                                                                n_threads);
  auto merge = [&](long t) {
    const uint64_t kEnd = std::numeric_limits<uint64_t>::max();
    std::vector<int64_t> cur(bounds.begin() + t * s,
                             bounds.begin() + (t + 1) * s);
    const int64_t* end = bounds.data() + (t + 1) * s;
    std::vector<uint64_t> head(s);
    for (long r = 0; r < s; r++)
      head[r] = cur[r] < end[r] ? keys[r][cur[r]] : kEnd;
    uint64_t* ok = out_keys + base[t];
    uint32_t* oc = out_counts + base[t];
    int64_t n_kept = 0, n_distinct = 0;
    for (;;) {
      uint64_t key = kEnd;
      for (long r = 0; r < s; r++) key = std::min(key, head[r]);
      if (key == kEnd) break;  // real keys lie below 2^62
      int64_t sum = 0;
      for (long r = 0; r < s; r++) {
        if (head[r] == key) {
          sum += counts[r][cur[r]++];
          head[r] = cur[r] < end[r] ? keys[r][cur[r]] : kEnd;
        }
      }
      n_distinct++;
      if (sum >= min_count) {
        ok[n_kept] = key;
        oc[n_kept] = static_cast<uint32_t>(sum);
        n_kept++;
      }
    }
    kept[t] = n_kept;
    distinct[t] = n_distinct;
  };
  std::vector<std::thread> threads;
  for (long t = 0; t < n_threads; t++) {
    for (long r = 0; r < s; r++) base[t] += bounds[t * s + r];
    if (t) threads.emplace_back(merge, t);
  }
  merge(0);
  for (auto& th : threads) th.join();
  int64_t at = 0;
  *unique = 0;
  for (long t = 0; t < n_threads; t++) {
    // at <= base[t]: each range keeps at most its records
    memmove(out_keys + at, out_keys + base[t], kept[t] * sizeof(uint64_t));
    memmove(out_counts + at, out_counts + base[t],
            kept[t] * sizeof(uint32_t));
    at += kept[t];
    *unique += distinct[t];
  }
  return at;
}

// Scan-min Dijkstra over a CSR digraph — the host-side inner loop of
// alternative-path enumeration (capability of km/utils/Graph.py:63-119:
// argmin over unvisited distances, lowest index on ties, float32
// accumulation). Visited nodes are parked at +inf in a working copy of
// the distance array; with strictly positive weights a re-scan of a
// parked node relaxes nothing, so the loop runs exactly n iterations
// like the reference. Writes the predecessor array to prev_out.
void km_dijkstra_scanmin(const int64_t* ptr, const int64_t* ids,
                         const float* w, long n, long start,
                         int32_t* prev_out) {
  const float inf = std::numeric_limits<float>::infinity();
  std::vector<float> dist(n, inf), work(n, inf);
  dist[start] = 0.0f;
  work[start] = 0.0f;
  for (long step = 0; step < n; step++) {
    long i = 0;
    float best = work[0];
    for (long j = 1; j < n; j++) {
      if (work[j] < best) {
        best = work[j];
        i = j;
      }
    }
    work[i] = inf;
    const float di = dist[i];
    for (int64_t e = ptr[i]; e < ptr[i + 1]; e++) {
      const int64_t j = ids[e];
      const float nd = w[e] + di;  // float32, matches km's numerics
      if (nd < dist[j]) {
        dist[j] = nd;
        work[j] = nd;
        prev_out[j] = (int32_t)i;
      }
    }
  }
}

}  // extern "C"
