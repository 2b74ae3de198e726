"""The stream count (``tools.count.count_read_files``) on reads whose
transcripts are expressed by Zipf's law, as in real RNA-seq, against a
plain torch count: keys and counts after ``min_count``, over several
chunks and growths of the accumulator, with hot keys in every piece of a
chunk. M1's run count summed over the chunks (``stats["runs"]``) is the
sum of each chunk's distinct keys, a chunk counted again by a growth
once; the plain merge takes every bucket at once, so
``stats["m1_rounds"]`` is 0 on the CPU."""

import numpy as np
import pytest
import torch

from km_tpu_torch.ops import count as ops_count
from km_tpu_torch.ops import merge
from km_tpu_torch.scripts.merge_cases import (SORT_CHUNK, make_case,
                                              sorted_chunk)
from km_tpu_torch.tools import count as tools_count

K = 31
TRANSCRIPTS, TRANSCRIPT_BASES, READ_LEN = 1 << 10, 256, 100
READ_BASES = 1 << 18
CHUNK = 1 << 14  # about 19 chunks
START_CAPACITY = 1 << 12  # several growths


def zipf_reads(s: float, seed: int) -> torch.Tensor:
    """uint8 codes [reads, READ_LEN]: each read from a transcript drawn
    with weight 1 / rank^s, at a uniform start in it."""
    g = torch.Generator().manual_seed(seed)
    tx = torch.randint(0, 4, (TRANSCRIPTS, TRANSCRIPT_BASES), generator=g,
                       dtype=torch.uint8)
    weight = torch.arange(1, TRANSCRIPTS + 1, dtype=torch.float64) ** -s
    n = READ_BASES // READ_LEN
    which = torch.multinomial(weight, n, replacement=True, generator=g)
    start = torch.randint(0, TRANSCRIPT_BASES - READ_LEN + 1, (n,),
                          generator=g)
    return tx[which[:, None], start[:, None] + torch.arange(READ_LEN)]


def write_fastq(path, reads: torch.Tensor) -> None:
    acgt = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "wb") as f:
        for i, read in enumerate(reads.numpy()):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, acgt[read].tobytes(),
                                            b"I" * len(read)))


def window_keys(codes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The canonical key of every window of K valid bases, plainly: the
    leftmost base in the highest bits; its reverse complement's key the
    other way round, each base complemented (3 - code)."""
    w = codes.numel() - K + 1
    if w <= 0:
        return torch.empty(0, dtype=torch.int64)
    c = codes.to(torch.int64)
    fw = torch.zeros(w, dtype=torch.int64)
    rc = torch.zeros(w, dtype=torch.int64)
    for j in range(K):
        fw = (fw << 2) | c[j:j + w]
        rc = rc | ((3 - c[j:j + w]) << (2 * j))
    ok = valid.unfold(0, K, 1).all(dim=1)
    return torch.minimum(fw, rc)[ok]


@pytest.mark.parametrize("s", [0.8, 1.0, 1.2])
def test_skewed_count_matches_plain_count(tmp_path, monkeypatch, s):
    reads = zipf_reads(s, seed=int(s * 10))
    fq = tmp_path / "reads.fq"
    write_fastq(fq, reads)

    chunks = []
    real = ops_count.chunk_stream

    def recorded(*a, **kw):
        for item in real(*a, **kw):
            chunks.append(item)
            yield item

    monkeypatch.setattr(ops_count, "chunk_stream", recorded)
    monkeypatch.setattr(tools_count, "CHUNK", {"cpu": CHUNK})
    monkeypatch.setattr(tools_count, "START_CAPACITY", START_CAPACITY)
    stats = {}
    keys, counts = tools_count.count_read_files(
        [str(fq)], K, min_count=2, min_quality="+", device="cpu",
        stats=stats, mode="stream")

    sep = torch.zeros((reads.shape[0], 1), dtype=torch.uint8)
    every = window_keys(torch.cat((reads, sep), 1).reshape(-1),
                        torch.cat((torch.ones_like(reads, dtype=torch.bool),
                                   sep.bool()), 1).reshape(-1))
    want_k, want_c = torch.unique(every, return_counts=True)
    kept = want_c >= 2
    np.testing.assert_array_equal(keys, want_k[kept].numpy().view(np.uint64))
    np.testing.assert_array_equal(counts, want_c[kept].numpy())
    assert want_c.max() > 50  # hot keys: the skew is there

    per_chunk = [torch.unique(window_keys(torch.from_numpy(c),
                                          torch.from_numpy(v))).numel()
                 for c, v in chunks]
    assert stats["retries"] == 0 and stats["grows"] >= 1
    assert stats["chunks"] == len(chunks) > 4  # the file parsed once
    assert stats["total"] == every.numel()
    assert stats["unique"] == want_k.numel()
    assert stats["runs"] == sum(per_chunk)
    assert stats["m1_rounds"] == 0


@pytest.mark.parametrize("case", ["all_new", "long_run", "bucket_over_tile"])
def test_the_tally_adds_each_chunks_runs_while_open(case):
    """Every ``chunk_runs`` inside a tally adds its run count to the
    first counter; the plain version adds no round to the second; after
    the tally closes nothing is added."""
    _, _, chunk, _ = make_case(case)
    runs = sorted_chunk(chunk, SORT_CHUNK)
    counters = torch.zeros(2, dtype=torch.int64)
    with merge.tally(counters):
        m = [int(merge.chunk_runs(*runs, SORT_CHUNK)[2]) for _ in range(2)]
    merge.chunk_runs(*runs, SORT_CHUNK)
    assert counters.tolist() == [sum(m), 0] and m[0] > 0
    with pytest.raises(ValueError):
        with merge.tally(torch.zeros(3, dtype=torch.int64)):
            pass
