"""FASTQ/FASTA read ingestion (host side).

Yields fixed-size batches of 2-bit-coded read bases plus validity masks,
ready to feed the device counting kernels. A C++ fast path for parsing
and packing lives in km_tpu_torch/native (used when it builds; the
loader warns with the reason when it does not).
"""

from __future__ import annotations

import gzip
from typing import Iterator

import numpy as np

from ..ops.encode import seq_to_codes


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def iter_reads(path: str, min_quality: str | None = None
               ) -> Iterator[tuple[str, str | None]]:
    """Yield (sequence, quality_or_None) per read; autodetects FASTA/FASTQ."""
    with _open(path) as f:
        first = f.read(1)
        if not first:
            return
        if first == ">":
            # FASTA
            seq_parts: list[str] = []
            for line in f:
                line = line.strip()
                if line.startswith(">"):
                    if seq_parts:
                        yield "".join(seq_parts), None
                    seq_parts = []
                elif line:
                    seq_parts.append(line)
            if seq_parts:
                yield "".join(seq_parts), None
            return
        if first != "@":
            raise ValueError(f"{path}: not FASTA/FASTQ (starts with {first!r})")
        # FASTQ
        f.readline()  # rest of first header
        while True:
            seq = f.readline().strip()
            plus = f.readline()
            qual = f.readline().strip()
            if not seq or not plus:
                break
            yield seq, qual
            header = f.readline()
            if not header:
                break


def read_batches_native(paths, batch_bases: int = 1 << 26,
                        min_quality: str | None = None
                        ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Native (C++) parsing path: ~GB/s FASTQ -> codes+valid batches.
    Same stream contract as read_batches."""
    from .. import native

    for path in paths:
        f = _open_binary(path)
        first = f.peek(1)[:1] if hasattr(f, "peek") else None
        if first is None:
            head = f.read(1)
            fastq = head == b"@"
            tail = head
        else:
            fastq = first == b"@"
            tail = b""
        while True:
            data = f.read(batch_bases)
            if not data and not tail:
                break
            buf = tail + data
            codes, valid, consumed = native.parse_chunk(
                buf, fastq=fastq, min_quality=min_quality)
            if consumed == 0 and not data:
                # trailing garbage / record without newline: stop
                break
            tail = buf[consumed:]
            if len(codes):
                yield codes, valid
            if not data:
                break
        f.close()


def _open_binary(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def is_fastq(path: str) -> bool:
    """Whether the file's first byte, after gzip, is a FASTQ header's."""
    with _open_binary(path) as f:
        return f.read(1) == b"@"


def read_batches(paths, batch_bases: int = 1 << 22,
                 min_quality: str | None = None,
                 prefer_native: bool = True
                 ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Concatenate reads into (codes uint8, valid bool) batches.

    Reads are separated by a single invalid position so no k-mer spans two
    reads. Low-quality bases (< min_quality) are marked invalid, matching
    jellyfish count -Q semantics of breaking k-mers. Uses the native C++
    parser when available.
    """
    if prefer_native:
        from .. import native

        if native.available():
            yield from read_batches_native(paths, max(batch_bases, 1 << 22),
                                           min_quality=min_quality)
            return
    qmin = ord(min_quality) if min_quality else None
    buf_codes = np.empty(batch_bases, dtype=np.uint8)
    buf_valid = np.empty(batch_bases, dtype=bool)
    fill = 0
    for path in paths:
        for seq, qual in iter_reads(path):
            n = len(seq)
            if n + 1 > batch_bases - fill:
                yield buf_codes[:fill].copy(), buf_valid[:fill].copy()
                fill = 0
                if n + 1 > batch_bases:
                    # oversized read: truncate (pathological for RNA-seq)
                    seq = seq[: batch_bases - 1]
                    qual = qual[: batch_bases - 1] if qual else None
                    n = len(seq)
            codes = seq_to_codes(seq)
            valid = codes != 255
            if qmin is not None and qual is not None:
                q = np.frombuffer(qual.encode("ascii"), dtype=np.uint8)
                valid &= q >= qmin
            buf_codes[fill:fill + n] = np.where(valid, codes, 0)
            buf_valid[fill:fill + n] = valid
            buf_codes[fill + n] = 0
            buf_valid[fill + n] = False
            fill += n + 1
    if fill:
        yield buf_codes[:fill].copy(), buf_valid[:fill].copy()
