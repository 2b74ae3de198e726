"""Inputs for the checks of the merge kernels (``ops/merge.py``): the edge
cases (an accumulator and one chunk's window keys, made from a seed with
numpy) and the inputs at the shape of a 2^30-base sample's final counting
pass (made on the device from a seed); and accumulators for the
``min_count`` cut (``cut_accumulator``, ``CUT_CASES``). The CPU tests hold
the plain versions against km_tpu (the cut: against the stream's old
numpy cut) with them; the card tests and chip_smoke.py hold the kernels
against the plain versions."""

from __future__ import annotations

import numpy as np
import torch

from ..device import SENTINEL
from ..ops import sort_runs

SORT_CHUNK = 1024
SORT_CHUNKS = [1 << b for b in range(9, 15)]  # every accepted piece size
CASES = ["empty_accumulator", "chunk_all_sentinel", "all_present", "all_new",
         "one_key_every_piece", "n_unique_C", "n_unique_C_plus_1",
         "n_unique_3C", "ragged", "long_run",
         # 64 pieces: several of chunk_runs' buckets, several of
         # merge_accum's tiles
         "bucket_over_tile", "key_at_splitter_every_piece", "k16_keys",
         "ragged_last_piece", "runs_across_tiles"]
# more pieces than chunk_runs' tile holds records (8,192), each with one
# key: too large for the CPU tests' chain of numpy merges
CARD_CASES = ["key_in_more_pieces_than_tile"]
# the cut's edge cases: (live records, slots, min_count); "count_2_32"
# has every live count at 3 * 2^32 or more, "sentinel_live" SENTINEL as
# its last live key, kept
CUT_CASES = {"min_count_1": (3000, 5000, 1), "min_count_2": (3000, 5000, 2),
             "min_count_3": (3000, 5000, 3), "empty": (0, 5000, 2),
             "none_kept": (3000, 5000, 1 << 40), "all_kept": (5000, 5000, 1),
             "sentinel_padding": (1, 5000, 1), "count_2_32": (3000, 5000, 2),
             "sentinel_live": (3000, 5000, 2)}
LONG_RUN_KEY = 12345
MANY_PIECES = 64
MERGE_TILE = 4096  # merged positions of one merge_accum block


def _keys(rng, n: int, odd: bool = False) -> np.ndarray:
    """n distinct ascending keys below 2^62, all even or all odd."""
    keys = np.unique(rng.integers(0, 1 << 61, 2 * n + 16)) * 2 + odd
    return np.sort(rng.permutation(keys)[:n]).astype(np.int64)


def _draw(rng, pool: np.ndarray, n: int, invalid: float = 0.1) -> np.ndarray:
    """n window keys drawn from pool (repeats within and across pieces),
    a share of them invalid (SENTINEL)."""
    keys = pool[rng.integers(0, len(pool), n)] if len(pool) else \
        np.full(n, SENTINEL, np.int64)
    keys[rng.random(n) < invalid] = SENTINEL
    return keys


def make_case(name: str, seed: int = 0, sort_chunk: int = SORT_CHUNK):
    """-> (acc keys int64 ascending distinct, acc counts int64 > 0, the
    chunk's window keys int64 with SENTINEL for invalid windows, the
    capacity C)."""
    rng = np.random.default_rng([seed, (CASES + CARD_CASES).index(name),
                                 sort_chunk])
    n = 4 * sort_chunk
    acc = _keys(rng, 1500)
    pool = _keys(rng, n // 3, odd=True)
    C = 4 * n
    if name == "empty_accumulator":
        acc = acc[:0]
        chunk = _draw(rng, pool, n)
    elif name == "chunk_all_sentinel":
        chunk = np.full(n, SENTINEL, np.int64)
    elif name == "all_present":
        chunk = _draw(rng, acc, n)
    elif name == "all_new":
        chunk = _draw(rng, pool, n)
    elif name == "one_key_every_piece":
        chunk = _draw(rng, pool, n)
        key = acc[len(acc) // 2]
        chunk[np.arange(0, n, sort_chunk) + rng.integers(0, sort_chunk)] = key
    elif name.startswith("n_unique"):
        acc = acc[:200]
        chunk = _draw(rng, pool, n)
        distinct = len(np.union1d(acc, chunk[chunk != SENTINEL]))
        C = {"n_unique_C": distinct, "n_unique_C_plus_1": distinct - 1,
             "n_unique_3C": distinct // 3}[name]
    elif name == "ragged":
        chunk = _draw(rng, np.concatenate([pool, acc]), 3 * sort_chunk + 77)
    elif name == "long_run":
        # one key in about 40% of the windows: a run in every piece, and
        # in the accumulator, longer than any bound derived from pieces
        acc = np.union1d(acc, [LONG_RUN_KEY]).astype(np.int64)
        chunk = _draw(rng, pool, n)
        chunk[rng.random(n) < 0.4] = LONG_RUN_KEY
    elif name == "bucket_over_tile":
        # the same 100 keys in each of 128 pieces, between two of the
        # piece's samples: no sample falls among them, so one bucket holds
        # 12,800 records, more than chunk_runs' tile
        pieces = 2 * MANY_PIECES
        n = pieces * sort_chunk
        C = 4 * n
        low = _keys(rng, n, odd=True) >> 3  # below 2^59
        band = (1 << 60) + (_keys(rng, 100, odd=True) >> 22)
        high = (1 << 61) + low
        chunk = []
        at = sample_positions(n, sort_chunk)
        for p in range(pieces):
            mine = np.sort(at[(at >= p * sort_chunk)
                              & (at < (p + 1) * sort_chunk)] - p * sort_chunk)
            edges = np.concatenate([[-1], mine, [sort_chunk]])
            gap = int(np.argmax(np.diff(edges)))
            if edges[gap + 1] - edges[gap] - 1 < len(band):
                raise AssertionError("no gap between samples holds the band")
            below = int(edges[gap]) + 1
            piece = np.concatenate([
                low[p * sort_chunk:p * sort_chunk + below], band,
                high[p * sort_chunk:
                     p * sort_chunk + sort_chunk - below - len(band)]])
            chunk.append(rng.permutation(piece))
        chunk = np.concatenate(chunk)
    elif name == "key_at_splitter_every_piece":
        # a third of every piece is one key of the accumulator: it is
        # sampled often enough to be a splitter, and is in every piece
        n = MANY_PIECES * sort_chunk
        C = 4 * n
        chunk = _draw(rng, _keys(rng, n // 3, odd=True), n)
        key = acc[len(acc) // 2]
        chunk[rng.random(n) < 0.3] = key
        chunk[np.arange(0, n, sort_chunk)] = key
    elif name == "k16_keys":
        # k = 16: every key below 2^32
        n = MANY_PIECES * sort_chunk
        C = 4 * n
        keys = np.unique(rng.integers(0, 1 << 32, 2 * n)).astype(np.int64)
        acc = np.sort(rng.permutation(keys)[:1500])
        chunk = _draw(rng, rng.permutation(keys)[:n // 3], n)
    elif name == "ragged_last_piece":
        n = MANY_PIECES * sort_chunk + 333
        C = 4 * n
        chunk = _draw(rng, np.concatenate([_keys(rng, n // 3, odd=True),
                                           acc]), n)
    elif name == "runs_across_tiles":
        # every accumulator key but the first is in the chunk, so the
        # merged order is that key, then pairs: every merge tile of 4,096
        # positions ends inside a pair, whose count carries to the next
        acc = _keys(rng, 3 * MERGE_TILE)
        n = MANY_PIECES * sort_chunk
        C = 4 * n
        rest = acc[1:]
        chunk = np.concatenate([rest, rest[rng.integers(0, len(rest),
                                                        n - len(rest))]])
        chunk = rng.permutation(chunk)
    elif name == "key_in_more_pieces_than_tile":
        # 8,200 pieces of 512 (sort_chunk is ignored), the least key in
        # each: its bucket cannot be staged at once
        sort_chunk = 512
        n = 8200 * sort_chunk
        chunk = _draw(rng, _keys(rng, n // 2, odd=True), n)
        chunk[np.arange(0, n, sort_chunk)] = 1
        C = 2 * n
    else:
        raise ValueError(name)
    counts = rng.integers(1, 50, len(acc)).astype(np.int64)
    return acc, counts, chunk, C


def sample_positions(n: int, piece: int) -> np.ndarray:
    """Where chunk_runs samples n keys in pieces of `piece`: its bucket
    count (buckets_for) and sample positions (sample_position) in
    csrc/merge_runs.cu, repeated here to build an input that no sample
    falls in."""
    pieces = -(-n // piece)
    buckets = 1
    while buckets < 8192 and buckets * 4096 < n:
        buckets *= 2
    while buckets > 1 and buckets * pieces > 1 << 23:
        buckets //= 2
    total = 32 * buckets
    t = np.arange(total, dtype=np.uint64)
    with np.errstate(over="ignore"):
        jitter = ((t * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(33))
    t = t.astype(np.int64)
    return t * n // total + jitter.astype(np.int64) % max(n // total, 1)


def piece_size(name: str, sort_chunk: int = SORT_CHUNK) -> int:
    """The piece size a case's chunk is sorted with."""
    return 512 if name == "key_in_more_pieces_than_tile" else sort_chunk


def sorted_chunk(chunk: np.ndarray, sort_chunk: int, device="cpu"):
    """The chunk sort's output for the window keys: (int64 keys sorted
    within pieces, int32 run lengths at run starts)."""
    return sort_runs.sort_chunks_runs_plain(
        torch.from_numpy(chunk).to(device), sort_chunk)


def accumulator(acc: np.ndarray, counts: np.ndarray, C: int, device="cpu"):
    """(keys [C], counts [C], live length) with SENTINEL and 0 past the
    live prefix; the prefix is cut to C."""
    live = min(len(acc), C)
    keys = np.full(C, SENTINEL, np.int64)
    cnt = np.zeros(C, np.int64)
    keys[:live], cnt[:live] = acc[:live], counts[:live]
    return (torch.from_numpy(keys).to(device),
            torch.from_numpy(cnt).to(device),
            torch.tensor(len(acc), dtype=torch.int64, device=device))


def sample_shape(device, live: int = 26_000_000, slots: int = 1 << 26,
                 windows: int = (1 << 24) - 30, seed: int = 8):
    """The merge's inputs at the shape of the smoke's sample (2^30 bases,
    k = 31) in its final pass, made on the device from a seed: an
    accumulator of `live` keys in `slots` slots (counts 1..49), and the
    chunk sort's output (sort_chunks_runs) for one chunk of `windows`
    windows, 70% of them valid, drawn from windows / 2 keys (so a key
    is in 1.4 windows on average), half of which are in the accumulator.
    Returns ((acc keys, acc counts, live length), (keys, lengths))."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rand_keys(n):
        return torch.randint(0, 1 << 62, (n,), generator=g, device=device)

    acc = torch.unique(rand_keys(live + live // 64))[:live]
    keys = torch.full((slots,), SENTINEL, dtype=torch.int64, device=device)
    counts = torch.zeros(slots, dtype=torch.int64, device=device)
    keys[:live] = acc
    counts[:live] = torch.randint(1, 50, (live,), generator=g, device=device)
    valid = torch.rand(windows, generator=g, device=device) < 0.7
    distinct = windows // 2
    old = acc[torch.randint(0, live, (distinct // 2,), generator=g,
                            device=device)]
    pool = torch.cat([old, rand_keys(distinct - distinct // 2)])
    window = pool[torch.randint(0, pool.numel(), (windows,), generator=g,
                                device=device)]
    window = torch.where(valid, window, torch.full_like(window, SENTINEL))
    acc_n = torch.tensor(live, dtype=torch.int64, device=device)
    return (keys, counts, acc_n), sort_runs.sort_chunks_runs(window)


def scale_shape(device, capacity: int = 1 << 23):
    """The merge's inputs at the shape of ``scale_count``'s chunks, made on
    the device: chunk 1 of its synthesized stream (2^24 bases of a
    2^21-base reference tiled 8 times, so nearly every window of a piece
    is distinct: ~1.67e7 runs of ~2.1e6 keys) through the pack and the
    chunk sort, and the accumulator after chunk 0 in `capacity` slots,
    merged by the plain versions. Returns ((acc keys, acc counts, live
    length), (keys, lengths))."""
    from ..ops import merge
    from ..ops.count import count_chunk_device, empty_accumulator
    from .scale_count import CHUNK, K, ChunkSynthesizer, reference_chunk

    synth = ChunkSynthesizer(torch.from_numpy(reference_chunk()).to(device))
    valid = torch.ones(CHUNK, dtype=torch.bool, device=device)

    def chunk(idx):
        return count_chunk_device(synth(idx), valid, K, canonical=True)

    acc = empty_accumulator(capacity, device)
    merge.merge_accum_plain(*empty_accumulator(capacity, device),
                            *merge.chunk_runs_plain(*chunk(0)), *acc)
    return acc, chunk(1)


def zipf_chunk(device, windows: int = 1 << 24, s: float = 1.2,
               transcripts: int = 1 << 18, transcript_bases: int = 2048,
               read_len: int = 100, k: int = 31, seed: int = 5
               ) -> torch.Tensor:
    """One chunk's window keys as K1 packs them (its plain version), made
    on the device from a seed: reads whose transcripts are expressed by
    Zipf's law (the transcript of rank r drawn with weight r^-s, a
    uniform start in it), each followed by one invalid base as the
    parser gives them, so hot keys are in most pieces of the chunk.
    Returns int64 keys [windows], SENTINEL for windows that span two
    reads."""
    from ..ops.pack import pack_canonical_windows_plain

    g = torch.Generator(device=device).manual_seed(seed)
    tx = torch.randint(0, 4, (transcripts, transcript_bases), generator=g,
                       device=device, dtype=torch.uint8)
    weight = torch.arange(1, transcripts + 1, dtype=torch.float64,
                          device=device) ** -s
    n = -(-windows // (read_len + 1))
    which = torch.multinomial(weight, n, replacement=True, generator=g)
    start = torch.randint(0, transcript_bases - read_len + 1, (n,),
                          generator=g, device=device)
    reads = tx[which[:, None],
               start[:, None] + torch.arange(read_len, device=device)]
    sep = torch.zeros((n, 1), dtype=torch.uint8, device=device)
    codes = torch.cat((reads, sep), 1).reshape(-1)[:windows]
    valid = torch.cat((torch.ones_like(reads, dtype=torch.bool),
                       sep.bool()), 1).reshape(-1)[:windows]
    return pack_canonical_windows_plain(codes, valid, k)


def cut_accumulator(live: int, slots: int, device="cpu", seed: int = 0,
                    kept_share: float = 0.41):
    """An accumulator for the ``min_count`` cut, made on the device from a
    seed: `live` ascending distinct keys below 2^62 in `slots` slots,
    SENTINEL and 0 past them; counts 1, or 2..49 for a `kept_share` of
    the records, and every 97th count 2^32 more (the uint32 table keeps
    its low 32 bits). Returns (keys, counts, live length)."""
    g = torch.Generator(device=device).manual_seed(seed)
    keys = torch.full((slots,), SENTINEL, dtype=torch.int64, device=device)
    counts = torch.zeros(slots, dtype=torch.int64, device=device)
    gaps = torch.randint(1, 1 << 30, (live,), generator=g, device=device)
    keys[:live] = torch.cumsum(gaps, 0)
    many = torch.rand(live, generator=g, device=device) < kept_share
    cnt = torch.where(many, torch.randint(2, 50, (live,), generator=g,
                                          device=device), 1)
    cnt[::97] += 1 << 32
    counts[:live] = cnt
    return keys, counts, torch.tensor(live, dtype=torch.int64, device=device)


def cut_case(name: str, device="cpu"):
    """-> (accumulator, min_count) of the cut's edge case `name`."""
    live, slots, min_count = CUT_CASES[name]
    keys, counts, n = cut_accumulator(live, slots, device,
                                      seed=list(CUT_CASES).index(name))
    if name == "count_2_32":
        counts[:live] += 3 << 32
    elif name == "sentinel_live":
        keys[live - 1], counts[live - 1] = SENTINEL, min_count
    return (keys, counts, n), min_count
