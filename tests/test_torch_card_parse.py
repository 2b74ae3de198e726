"""P1 (``ops/parse.py``) and the stream count's card path
(``ops/count.py::count_fastq_device_stream``) on CPU tensors, where P1's
plain version runs in the kernel's place.

P1's plain version is held against km_tpu's native host parser
(``km_tpu.native.parse_chunk``) on the edge cases of
``km_tpu_torch/scripts/fastq_cases.py``; the card path against km_tpu's
host count (``count_batches_host`` over ``read_batches``) of the same
files, whole and in blocks cut small, plain and gzip, with a growth at
the last chunk. A file whose last record is cut short loses that record
on the card path, on the port's host path and in km_tpu alike; broken
files and a read longer than a block raise."""

import gzip

import numpy as np
import pytest
import torch

from km_tpu_torch.io.fastq import is_fastq
from km_tpu_torch.ops import count as ops_count
from km_tpu_torch.ops.count import count_fastq_device_stream
from km_tpu_torch.ops.parse import parse_fastq, parse_fastq_plain
from km_tpu_torch.scripts.fastq_cases import (CASES, case_text, reads_block,
                                              records)
from km_tpu_torch.tools.count import count_read_files

from test_torch_count_modes import _load_km_native


def _km_parse_chunk(text: bytes, min_quality):
    """km_tpu's native FASTQ parser: (codes, valid, bytes consumed)."""
    _load_km_native()
    from km_tpu import native as km_native

    return km_native.parse_chunk(text, fastq=True, min_quality=min_quality)


def _km_count(paths, k: int, min_count: int = 1, min_quality=None):
    """km_tpu's host count of FASTQ files, through its native parser."""
    _load_km_native()
    from km_tpu.io.fastq import read_batches
    from km_tpu.ops.count import count_batches_host

    return count_batches_host(read_batches(paths, min_quality=min_quality),
                              k, min_count=min_count)


def _parse(text: bytes, chunk: int, min_quality=None):
    bad = torch.zeros(1, dtype=torch.int64)
    text = torch.tensor(list(text), dtype=torch.uint8)
    codes, valid = parse_fastq(text, chunk, min_quality, bad)
    return codes.numpy(), valid.numpy(), int(bad)


@pytest.mark.parametrize("min_quality", [None, "+", "5"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_parse_matches_the_host_parser(case, min_quality):
    text = case_text(case)
    want_c, want_v, consumed = _km_parse_chunk(text, min_quality)
    assert consumed == len(text)
    if not text.endswith(b"\n"):
        text += b"\n"  # the card path ends a file's last line
    chunk = len(want_c) + 37
    codes, valid, bad = _parse(text, chunk, min_quality)
    assert bad == 0
    n = len(want_c)
    np.testing.assert_array_equal(codes[:n], want_c)
    np.testing.assert_array_equal(valid[:n], want_v)
    assert not codes[n:].any() and not valid[n:].any()
    assert valid.dtype == np.bool_ and codes.dtype == np.uint8


@pytest.mark.parametrize("text", [
    b"@r\nACGT\n-\nIIII\n",            # third line without '+'
    b"@r\nACGT\n+\nIII\n",             # quality shorter than the read
    b"@r\nACGT\n+\nIIIII\n",           # and longer
    b"r\nACGT\n+\nIIII\n",             # header without '@'
    b"@r\nACGT\n+\nIIII\n@r2\nAC\n",   # a record cut short
    b"@r\nACGT\n+\nIIII",              # no final newline
    b"@r\nACGT\n+\nIIII\n\n",          # a blank line
])
def test_plain_parse_flags_broken_text(text):
    codes, valid, bad = _parse(text, 64)
    assert bad == 1


def test_plain_parse_flags_text_past_its_chunk():
    text = records(seed=3, n=20, lengths=(10, 10))
    assert _parse(text, 20 * 11)[2] == 0
    codes, valid, bad = _parse(text, 20 * 11 - 1)
    assert bad == 1
    # the records that fit are written, the one past the chunk is not
    want = _parse(text, 20 * 11)
    np.testing.assert_array_equal(codes[:19 * 11], want[0][:19 * 11])
    assert not valid[19 * 11:].any()


def test_plain_parse_of_nothing():
    codes, valid, bad = _parse(b"", 16)
    assert bad == 0 and not codes.any() and not valid.any()
    with pytest.raises(ValueError):
        parse_fastq(torch.zeros(4, dtype=torch.int32), 16, None,
                    torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError):
        parse_fastq(torch.zeros(4, dtype=torch.uint8), 16, None,
                    torch.zeros(1, dtype=torch.int32))


def _write(path, text: bytes) -> str:
    if str(path).endswith(".gz"):
        with gzip.open(path, "wb") as f:
            f.write(text)
    else:
        path.write_bytes(text)
    return str(path)


def _files(tmp_path, spec):
    """spec: (name, text) pairs -> paths, total text bytes, the newlines
    the card path adds at files' ends."""
    paths = [_write(tmp_path / name, text) for name, text in spec]
    return (paths, sum(len(text) for _, text in spec),
            sum(not text.endswith(b"\n") for _, text in spec))


def _mixed(seed, n):
    return records(seed=seed, n=n, lengths=(20, 150),
                   alphabet="ACGTACGTACGTNacgt", quality=(35, 75))


FILE_SETS = {
    "one_plain": lambda: [("a.fq", _mixed(1, 1500))],
    "gzip": lambda: [("a.fq.gz", _mixed(2, 1500))],
    "several": lambda: [("a.fq", _mixed(3, 900)), ("b.fq.gz", _mixed(4, 700)),
                        ("c.fq", _mixed(5, 40)[:-1])],
    "crlf_and_empty_reads": lambda: [
        ("a.fq", records(seed=6, n=600, crlf=True, alphabet="ACGTN")),
        ("b.fq", records(seed=7, n=300, lengths=(0, 40)))],
}


@pytest.mark.parametrize("min_count", [1, 2])
@pytest.mark.parametrize("chunk", [1 << 10, 1 << 12, 1 << 20])
@pytest.mark.parametrize("files", list(FILE_SETS))
def test_card_path_matches_the_host_count(tmp_path, files, chunk, min_count):
    """Whole in one block (2^20), and cut into many blocks whose records
    straddle block and file boundaries (2^10, 2^12), from a small
    accumulator that grows."""
    paths, size, added = _files(tmp_path, FILE_SETS[files]())
    want = _km_count(paths, 21, min_count=min_count, min_quality="+")
    stats = {}
    got = count_fastq_device_stream(paths, 21, min_count=min_count,
                                    min_quality="+", chunk=chunk,
                                    capacity=1 << 9, device="cpu",
                                    stats=stats)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert stats["input_bytes"] == size
    assert stats["card_parsed_bytes"] == size + added
    assert stats["chunks"] >= size // (2 * chunk)
    assert {"count.read", "count.upload", "count.cut", "count.readback"} \
        <= set(stats["span_s"])
    assert "count.input" not in stats["span_s"]


def test_card_path_grows_at_the_last_chunk(tmp_path, monkeypatch):
    """Blocks of a few keys, then one of many: the last chunk's merge
    overflows and is counted again, from its block still in its buffer,
    parsed again but counted in ``card_parsed_bytes`` once."""
    rng = np.random.default_rng(11)
    # 37 records of 216 bytes fill a block of 2 * 2^12 bytes: eight blocks
    # of the same 37 reads (2,590 keys), then a block of 30 new reads
    few = reads_block(37 * 216, seed=1)
    many = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (30, 100))]
    tail = b"".join(b"@n%d\n%s\n+\n%s\n" % (i, r.tobytes(), b"I" * 100)
                    for i, r in enumerate(many))
    path = _write(tmp_path / "a.fq", few * 8 + tail)
    chunk = 1 << 12
    parses = []
    real = ops_count.parse.parse_fastq

    def counted(text, *a):
        parses.append(text.numel())
        return real(text, *a)

    monkeypatch.setattr(ops_count.parse, "parse_fastq", counted)
    stats = {}
    got = count_fastq_device_stream([path], 31, min_count=1, chunk=chunk,
                                    capacity=1 << 12, device="cpu",
                                    stats=stats)
    want = _km_count([path], 31)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert stats["grows"] == 1
    assert len(parses) == stats["chunks"] + 1
    assert parses[-1] == parses[-2]  # the last block, parsed again
    assert stats["card_parsed_bytes"] == stats["input_bytes"] \
        == len(few) * 8 + len(tail)


BROKEN = {
    "no_plus": b"@a\nACGTA\n+\nIIIII\n@b\nACGTA\nx\nIIIII\n",
    "short_quality": b"@a\nACGTA\n+\nIIII\n@b\nACGTA\n+\nIIIII\n",
    "no_header_mark": b"@a\nACGTA\n+\nIIIII\nb\nACGTA\n+\nIIIII\n",
    # within the file: a record cut short and another after it
    "cut_short": b"@a\nACGTA\n+\nIIIII\n@b\nACGTA\n+\n@c\nACGTA\n+\nIIIII\n",
    "blank_line": b"@a\nACGTA\n+\nIIIII\n\n",
}


@pytest.mark.parametrize("chunk", [1 << 6, 1 << 12])
@pytest.mark.parametrize("case", list(BROKEN))
def test_card_path_raises_on_a_broken_file(tmp_path, case, chunk):
    good = records(seed=9, n=40, lengths=(5, 12))
    path = _write(tmp_path / "a.fq", good + BROKEN[case])
    with pytest.raises(ValueError, match="malformed FASTQ record"):
        count_fastq_device_stream([path], 5, chunk=chunk, capacity=1 << 10,
                                  device="cpu")


TRUNCATED = {
    "header": b"@b",
    "header_line": b"@b\n",
    "read": b"@b\nACG",
    "plus": b"@b\nACGTA\n+",
    "plus_line": b"@b\nACGTA\n+\n",
    "short_quality": b"@b\nACGTA\n+\nIII",
    "whole_without_newline": b"@b\nACGTA\n+\nIIIII",
}


@pytest.mark.parametrize("chunk", [1 << 6, 1 << 12])
@pytest.mark.parametrize("where", ["one_file", "first_of_two"])
@pytest.mark.parametrize("case", list(TRUNCATED))
def test_a_truncated_last_record_is_dropped_on_every_path(tmp_path, case,
                                                         where, chunk):
    """A file that ends inside a record: km_tpu's host count drops the
    record, and so do the card path (blocks whole and cut small) and the
    port's host path; a whole last record without its newline counts."""
    good = records(seed=9, n=40, lengths=(5, 12))
    paths = [_write(tmp_path / "a.fq", good + TRUNCATED[case])]
    if where == "first_of_two":
        paths.append(_write(tmp_path / "b.fq.gz",
                            records(seed=10, n=30, lengths=(5, 12))))
    want = _km_count(paths, 5)
    stats = {}
    card = count_fastq_device_stream(paths, 5, chunk=chunk, capacity=1 << 10,
                                     device="cpu", stats=stats)
    host = count_read_files(paths, 5, min_count=1, device="cpu",
                            mode="stream")
    for got in (card, host):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    dropped = 0 if case == "whole_without_newline" else len(TRUNCATED[case])
    assert stats["card_parsed_bytes"] == stats["input_bytes"] - dropped \
        + (case == "whole_without_newline")


def test_a_cut_in_the_wrong_place_is_never_counted(tmp_path, monkeypatch):
    """A block cut one line short of its last record's end reads as a
    broken record, and nothing is returned."""
    path = _write(tmp_path / "a.fq", reads_block(40 * 216, seed=2))
    real = ops_count._last_record_end

    def one_line_short(a, n):
        end = real(a, n)
        return int(np.flatnonzero(a[:end - 1] == 10)[-1]) + 1

    monkeypatch.setattr(ops_count, "_last_record_end", one_line_short)
    with pytest.raises(ValueError, match="malformed FASTQ record"):
        count_fastq_device_stream([path], 21, chunk=1 << 10, capacity=1 << 12,
                                  device="cpu")


def test_a_read_longer_than_a_block_raises(tmp_path):
    chunk = 1 << 10
    # "@\n", the read, "\n+\n", the qualities, "\n": 2 * chunk bytes
    fits = b"@\n%s\n+\n%s\n" % (b"A" * (chunk - 3), b"I" * (chunk - 3))
    path = _write(tmp_path / "a.fq", fits * 2)
    stats = {}
    keys, counts = count_fastq_device_stream([path], 21, chunk=chunk,
                                             capacity=1 << 10, device="cpu",
                                             stats=stats)
    assert stats["total"] == 2 * (chunk - 3 - 21 + 1)
    over = b"@a\n%s\n+\n%s\n" % (b"A" * chunk, b"I" * chunk)
    path = _write(tmp_path / "b.fq", fits + over + fits)
    with pytest.raises(ValueError, match="at most %d bases" % (chunk - 3)):
        count_fastq_device_stream([path], 21, chunk=chunk, capacity=1 << 10,
                                  device="cpu")


def test_only_fastq_files_take_the_card_path(tmp_path):
    """``count_read_files`` takes the card path only for CUDA tensors; on
    the CPU it keeps the host parser, and ``is_fastq`` reads the first
    byte after gzip."""
    fq = _write(tmp_path / "a.fq.gz", _mixed(12, 50))
    fa = _write(tmp_path / "b.fa", b">t\nACGTACGTAC\n")
    assert is_fastq(fq) and not is_fastq(fa)
    stats = {}
    count_read_files([fq], 21, device="cpu", stats=stats, mode="stream")
    assert "input_bytes" not in stats and "count.input" in stats["span_s"]
