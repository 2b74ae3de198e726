"""FASTQ texts for P1 (``ops/parse.py``) and the card path of the stream
count: the CPU tests hold P1's plain version against the native host
parser on them, and the card tests and ``chip_smoke.py`` hold the kernel
against the plain version.

``records`` draws whole records of mixed length from a seed; ``CASES``
names the edges (N, IUPAC and lowercase bases, qualities under ``-Q``, a
quality line starting '@', CRLF line ends, empty reads, one long read);
``reads_block`` is a block of fixed-width 100-bp records, 216 bytes each,
as the benchmark's FASTQ cells write them.
"""

from __future__ import annotations

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)


def records(seed: int, n: int, lengths=(0, 150), alphabet: str = "ACGT",
            quality=(33, 75), crlf: bool = False, at_quality: float = 0.0,
            final_newline: bool = True) -> bytes:
    """n records "@r<i>", a read of a length drawn from ``lengths`` (low,
    high inclusive) over ``alphabet``, "+", qualities drawn from
    ``quality``; a share ``at_quality`` of the quality lines start '@'."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet.encode(), np.uint8)
    nl = b"\r\n" if crlf else b"\n"
    out = []
    for i in range(n):
        m = int(rng.integers(lengths[0], lengths[1] + 1))
        seq = letters[rng.integers(0, len(letters), m)].tobytes()
        qual = bytearray(rng.integers(quality[0], quality[1], m,
                                      dtype=np.uint8).tobytes())
        if m and rng.random() < at_quality:
            qual[0] = ord("@")
        out.append(b"@r%d%s%s%s+%s%s%s" % (i, nl, seq, nl, nl, bytes(qual), nl))
    text = b"".join(out)
    return text if final_newline or not text else text[:-len(nl)]


CASES = {
    "acgt": dict(seed=1, n=400),
    "n_iupac_lower": dict(seed=2, n=400, alphabet="ACGTNacgtnRYKMSWBDHV"),
    "low_quality": dict(seed=3, n=400, quality=(33, 48)),
    "quality_at": dict(seed=4, n=400, at_quality=0.5),
    "crlf": dict(seed=5, n=300, crlf=True, alphabet="ACGTN"),
    "no_final_newline": dict(seed=6, n=50, final_newline=False),
    "empty_reads": dict(seed=7, n=200, lengths=(0, 3)),
    "long_read": dict(seed=8, n=3, lengths=(3000, 5000)),
}


def case_text(name: str) -> bytes:
    return records(**CASES[name])


def reads_block(n_bytes: int, seed: int = 0, read_len: int = 100) -> bytes:
    """Whole fixed-width records "@r%09d", a read of uniform ACGT with one
    N in 64 reads, "+", qualities 'I' with one '#' in 128 bases, as many
    as fit ``n_bytes``."""
    rng = np.random.default_rng(seed)
    head, width = 12, 12 + read_len + 3 + read_len + 1
    n = n_bytes // width
    rec = np.empty((n, width), np.uint8)
    rec[:, 0] = ord("@")
    rec[:, 1] = ord("r")
    digits = (np.arange(n)[:, None] // 10 ** np.arange(8, -1, -1)) % 10
    rec[:, 2:11] = digits + ord("0")
    rec[:, 11] = ord("\n")
    seq = BASES[rng.integers(0, 4, (n, read_len))]
    seq[rng.random(n) < 1 / 64, read_len // 2] = ord("N")
    rec[:, head:head + read_len] = seq
    s = head + read_len
    rec[:, s:s + 3] = np.frombuffer(b"\n+\n", np.uint8)
    qual = np.full((n, read_len), ord("I"), np.uint8)
    qual[rng.random((n, read_len)) < 1 / 128] = ord("#")
    rec[:, s + 3:s + 3 + read_len] = qual
    rec[:, -1] = ord("\n")
    return rec.tobytes()
