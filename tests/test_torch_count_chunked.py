"""``count --mode chunked`` as jellyfish's ``--disk`` count, on CPU tensors
(the kernels' plain versions), with small chunks: the stream's
accumulator under a ceiling, dumped to the host as a sorted piece when a
merge overflows it, the pieces merged and cut on the host at the end.

Every table is held against a plain torch reference written here (every
valid window packed, made canonical and counted by ``torch.unique``),
which uses nothing of the port."""

import numpy as np
import pytest

import torch

from km_tpu_torch import cli
from km_tpu_torch.models.table import CountTable
from km_tpu_torch.ops import count as ops_count
from km_tpu_torch.tools import count as tools_count

torch.set_num_threads(1)

K = 21
CHUNK = 1 << 12
STRIDE = CHUNK - K + 1  # windows a chunk
N_CHUNKS = 7


def reference(batches, k: int, min_count: int):
    """(keys uint64, counts uint32) of the canonical k-mers of (codes,
    valid) batches, in plain torch: every window inside a batch whose
    bases are all valid, its key two bits a base with the first base
    highest, the smaller of it and its reverse complement's."""
    found = [torch.empty(0, dtype=torch.int64)]
    shifts = 2 * torch.arange(k - 1, -1, -1)
    for codes, valid in batches:
        n = len(codes) - k + 1
        if n <= 0:
            continue
        at = torch.arange(n)[:, None] + torch.arange(k)[None, :]
        windows = torch.from_numpy(codes).to(torch.int64)[at]
        windows = windows[torch.from_numpy(valid)[at].all(1)]
        forward = (windows << shifts).sum(1)
        reverse = ((3 - windows.flip(1)) << shifts).sum(1)
        found.append(torch.minimum(forward, reverse))
    keys, counts = torch.unique(torch.cat(found), return_counts=True)
    keep = counts >= min_count
    return (keys[keep].numpy().astype(np.uint64),
            counts[keep].numpy().astype(np.uint32))


def _equal(got, want):
    assert got[0].dtype == np.uint64 and got[1].dtype == np.uint32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def sample(seed: int = 5):
    """One batch of N_CHUNKS chunks of random bases, so each chunk brings
    about STRIDE new keys, with two planted segments: ``once`` in the
    first chunk and the last (its keys at count 1 in the first piece and
    in the last whenever the count dumps), ``every`` in every chunk."""
    rng = np.random.default_rng(seed)
    n = N_CHUNKS * STRIDE + K - 1
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    once = rng.integers(0, 4, 40, dtype=np.uint8)
    every = rng.integers(0, 4, 40, dtype=np.uint8)
    for at in (100, (N_CHUNKS - 1) * STRIDE + 100):
        codes[at:at + 40] = once
    for c in range(N_CHUNKS):
        codes[c * STRIDE + 2000:c * STRIDE + 2040] = every
    return [(codes, np.ones(n, bool))], once, every


def segment_keys(segment):
    return reference([(segment, np.ones(len(segment), bool))], K, 1)[0]


def chunked(batches, ceiling, min_count=2):
    stats = {}
    out = ops_count.count_batches_device_compact(
        iter(batches), K, min_count=min_count, chunk=CHUNK, device="cpu",
        sort_chunk=1 << 10, stats=stats, ceiling=ceiling)
    return out, stats


# the chunks' keys accumulate by ~STRIDE a chunk: 2^15 holds all seven,
# 2^14 four (a dump at the fifth), 2^13 two (dumps at the 3rd, 5th, 7th)
@pytest.mark.parametrize("ceiling, dumps", [(1 << 15, 0), (1 << 14, 1),
                                            (1 << 13, 3)])
@pytest.mark.parametrize("min_count", [1, 2])
def test_a_ceiling_forces_its_dumps_and_the_table_stays(ceiling, dumps,
                                                        min_count):
    batches, _, _ = sample()
    out, stats = chunked(batches, ceiling, min_count)
    _equal(out, reference(batches, K, min_count))
    assert stats["chunks"] == N_CHUNKS
    assert stats["dumps"] == dumps and stats["ceiling"] == ceiling
    assert stats["capacity"] == ceiling and stats["grows"] == 0
    assert stats["kept"] == len(out[0])
    windows = N_CHUNKS * STRIDE
    assert stats["total"] == windows
    assert stats["unique"] == len(reference(batches, K, 1)[0])
    # M1's runs: each chunk's distinct keys (here its every window), a
    # chunk counted again by a dump once
    assert stats["runs"] == windows


@pytest.mark.parametrize("ceiling", [1 << 13, CHUNK])
def test_the_cut_is_made_on_the_merged_counts(ceiling):
    """A key at count 1 in the first piece and in the last is kept at
    min_count 2; a key in every piece carries every piece's count."""
    batches, once, every = sample()
    (keys, counts), stats = chunked(batches, ceiling)
    assert stats["dumps"] >= 3
    table = dict(zip(keys.tolist(), counts.tolist()))
    for key in segment_keys(once).tolist():
        assert table[key] == 2
    for key in segment_keys(every).tolist():
        assert table[key] == N_CHUNKS
    _equal((keys, counts), reference(batches, K, 2))


def test_a_ceiling_equal_to_the_chunk_dumps_every_chunk_but_the_first():
    batches, _, _ = sample()
    out, stats = chunked(batches, CHUNK)
    _equal(out, reference(batches, K, 2))
    assert stats["dumps"] == N_CHUNKS - 1 and stats["capacity"] == CHUNK


def test_dumps_and_their_spans():
    """``dumps`` and ``dumped`` (the records read back in dumps: every
    piece but the last), and the spans ``count.dump`` and
    ``count.host_merge`` present exactly when a dump ran."""
    batches, _, _ = sample()
    _, none = chunked(batches, 1 << 15)
    assert none["dumps"] == none["dumped"] == 0
    assert "count.dump" not in none["span_s"]
    assert "count.host_merge" not in none["span_s"]
    _, some = chunked(batches, 1 << 13)
    # the pieces hold the first six chunks, two a piece, less the key
    # of ``every`` that repeats in a piece
    assert some["dumped"] == 6 * STRIDE - 3 * 20
    assert {"count.dump", "count.host_merge"} <= set(some["span_s"])
    assert all(some["span_s"][s] > 0 for s in ("count.dump",
                                               "count.host_merge"))


def test_ceiling_below_the_chunk_is_refused():
    batches, _, _ = sample()
    with pytest.raises(ValueError, match="below the chunk"):
        chunked(batches, CHUNK - 1)


def test_without_the_native_merge_the_table_is_the_same(monkeypatch):
    batches, _, _ = sample()
    monkeypatch.setattr(ops_count.native, "available", lambda: False)
    out, stats = chunked(batches, 1 << 13)
    assert stats["dumps"] == 3
    _equal(out, reference(batches, K, 2))


def _fastq(path, reads):
    bases = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            seq = bases[r].tobytes().decode()
            f.write("@r%05d\n%s\n+\n%s\n" % (i, seq, "I" * len(seq)))
    return str(path)


def test_growth_then_a_dump_past_the_ceiling_on_the_fastq_entry(tmp_path):
    """The FASTQ entry (the card's path, the plain parse on CPU tensors):
    from 2^11 slots the first block (19 reads each twice, ~1,520 keys)
    fits; the second (38 new reads, ~3,040 keys) overflows the 2^12
    ceiling before any growth, so the dump leaves a pair of the ceiling;
    later blocks grow nothing. The table equals the reference."""
    rng = np.random.default_rng(8)
    twice = rng.integers(0, 4, (19, 100), dtype=np.uint8)
    reads = np.concatenate([np.repeat(twice, 2, axis=0),
                            rng.integers(0, 4, (200, 100), dtype=np.uint8)])
    path = _fastq(tmp_path / "r.fq", reads)
    stats = {}
    out = ops_count.count_fastq_device_stream(
        [path], K, min_count=1, chunk=CHUNK, capacity=1 << 11, device="cpu",
        stats=stats, ceiling=CHUNK)
    _equal(out, reference([(r, np.ones(100, bool)) for r in reads], K, 1))
    assert stats["grows"] == 0 and stats["dumps"] >= 2
    assert stats["capacity"] == CHUNK
    assert stats["input_bytes"] == stats["card_parsed_bytes"]


def test_size_is_rounded_up_to_a_power_of_two():
    dev = torch.device("cpu")
    assert tools_count.chunked_ceiling(5000, CHUNK, dev) == 1 << 13
    assert tools_count.chunked_ceiling(CHUNK, CHUNK, dev) == CHUNK
    assert tools_count.chunked_ceiling(799063683, 1 << 24, dev) == 1 << 30
    with pytest.raises(ValueError, match="below the chunk"):
        tools_count.chunked_ceiling(CHUNK - 1, CHUNK, dev)
    # without a size: a power of two that holds at least the chunk
    free = tools_count.chunked_ceiling(None, CHUNK, dev)
    assert free >= CHUNK and free & (free - 1) == 0


def test_count_read_files_refuses_a_size_below_the_chunk(tmp_path):
    rng = np.random.default_rng(2)
    path = _fastq(tmp_path / "r.fq", rng.integers(0, 4, (20, 100),
                                                  dtype=np.uint8))
    with pytest.raises(ValueError, match="below the chunk"):
        tools_count.count_read_files([path], K, device="cpu",
                                     mode="chunked", size=1000)


def test_count_size_through_the_cli_writes_the_stream_table(tmp_path,
                                                            monkeypatch):
    """``count --mode chunked -s`` with a size that dumps writes the
    table ``--mode stream`` writes; the size is rounded up."""
    monkeypatch.setitem(tools_count.CHUNK, "cpu", CHUNK)
    rng = np.random.default_rng(4)
    ref = rng.integers(0, 4, 20000, dtype=np.uint8)
    reads = ref[rng.integers(0, len(ref) - 100, 600)[:, None]
                + np.arange(100)]
    path = _fastq(tmp_path / "r.fq", reads)
    argv = ["count", "--device", "cpu", "-k", str(K), "-L", "2"]
    chunked_stats = cli.main(argv + ["--mode", "chunked", "-s", "5000",
                                     "-o", str(tmp_path / "c.npz"), path])
    cli.main(argv + ["--mode", "stream", "-o", str(tmp_path / "s.npz"),
                     path])
    assert chunked_stats["ceiling"] == 1 << 13
    assert chunked_stats["dumps"] >= 1
    got, want = (CountTable.load(str(tmp_path / n)) for n in ("c.npz",
                                                               "s.npz"))
    np.testing.assert_array_equal(got.keys, want.keys)
    np.testing.assert_array_equal(got.counts, want.counts)
    _equal((got.keys, got.counts),
           reference([(r, np.ones(100, bool)) for r in reads], K, 2))


@pytest.mark.parametrize("n_pieces", [1, 3, 9])
def test_the_native_merge_of_pieces_is_exact_on_every_thread(n_pieces):
    """``native.merge_pieces`` over enough records (2^23) that it splits
    the key range among its threads, one piece empty: the keys and
    summed counts numpy finds, cut at 2 on the sums, and every distinct
    key counted."""
    from km_tpu_torch import native

    rng = np.random.default_rng(n_pieces)
    universe = np.unique(rng.integers(0, 1 << 62, 1 << 23, dtype=np.uint64))
    pieces = [(np.empty(0, np.uint64), np.empty(0, np.uint32))]
    for _ in range(n_pieces):
        keys = universe[rng.random(len(universe)) < 1.5 / n_pieces]
        pieces.append((keys, rng.integers(1, 3, len(keys)).astype(np.uint32)))
    keys, at = np.unique(np.concatenate([k for k, _ in pieces]),
                         return_inverse=True)
    sums = np.bincount(at, weights=np.concatenate([c for _, c in pieces]))
    got_keys, got_counts, unique = native.merge_pieces(pieces, 2)
    assert unique == len(keys)
    np.testing.assert_array_equal(got_keys, keys[sums >= 2])
    np.testing.assert_array_equal(got_counts,
                                  sums[sums >= 2].astype(np.uint32))
