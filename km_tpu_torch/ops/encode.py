"""2-bit k-mer packing / canonicalization (host, numpy); the port's copy
of km_tpu/ops/encode.py.

A k-mer (k <= 32) is packed into a uint64 with A=0, C=1, G=2, T=3, the
*leftmost* base occupying the highest-order bit pair (bits 2(k-1)..2(k-1)+1).
With this layout, lexicographic order over the DNA alphabet equals numeric
order of the packed word, so Jellyfish-style canonicalization
(min(mer, revcomp(mer))) is a numeric ``minimum``.

This matches the on-disk key layout of Jellyfish ``binary/sorted`` files
(empirically verified against the 5 bundled fixtures under data/jf;
see km_tpu_torch.io.jf). Reference behavior being reproduced:
km/utils/Jellyfish.py:47-53 (query + canonicalize).
"""

from __future__ import annotations

import numpy as np

# Code tables. 255 marks an invalid character.
_CODE = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _CODE[ord(_c)] = _i
    _CODE[ord(_c.lower())] = _i

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)

_M2 = np.uint64(0x3333333333333333)
_M4 = np.uint64(0x0F0F0F0F0F0F0F0F)


def seq_to_codes(seq: str) -> np.ndarray:
    """ASCII sequence -> uint8 base codes (255 for non-ACGT)."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _CODE[raw]


def codes_to_seq(codes: np.ndarray) -> str:
    return _BASES[codes].tobytes().decode("ascii")


def pack_kmers(seq: str, k: int) -> np.ndarray:
    """All len(seq)-k+1 sliding-window k-mers of ``seq`` as packed uint64.

    Raises ValueError on non-ACGT characters (targets must be clean; reads
    with N are handled by the masked FASTQ path in ops.count).
    """
    codes = seq_to_codes(seq)
    if codes.size < k:
        return np.empty(0, dtype=np.uint64)
    if (codes == 255).any():
        bad = int(np.argmax(codes == 255))
        raise ValueError(f"non-ACGT base {seq[bad]!r} at position {bad}")
    return pack_code_windows(codes, k)


def pack_code_windows(codes: np.ndarray, k: int) -> np.ndarray:
    """Sliding-window pack of a uint8 code vector into uint64 keys."""
    n = codes.size - k + 1
    if n <= 0:
        return np.empty(0, dtype=np.uint64)
    out = np.zeros(n, dtype=np.uint64)
    c64 = codes.astype(np.uint64)
    for i in range(k):
        out = (out << np.uint64(2)) | c64[i : i + n]
    return out


def pack_kmer(seq: str) -> int:
    """Pack a single k-mer string into an int."""
    arr = pack_kmers(seq, len(seq))
    return int(arr[0])


def unpack_kmer(key: int, k: int) -> str:
    """Packed uint64 -> k-mer string."""
    key = int(key)
    return "".join("ACGT"[(key >> (2 * (k - 1 - i))) & 3] for i in range(k))


def revcomp(keys: np.ndarray, k: int) -> np.ndarray:
    """Vectorized reverse complement of packed uint64 k-mers.

    Complement: per-base XOR 0b11 (A<->T, C<->G). Reverse: bit-pair
    reversal of the 64-bit word (pair swap, nibble swap, byte swap) then a
    right shift to re-align the k used base pairs.
    """
    v = (~keys).astype(np.uint64)  # complement every 2-bit lane
    v = ((v >> np.uint64(2)) & _M2) | ((v & _M2) << np.uint64(2))
    v = ((v >> np.uint64(4)) & _M4) | ((v & _M4) << np.uint64(4))
    v = v.byteswap()
    return v >> np.uint64(64 - 2 * k)


def canonical(keys: np.ndarray, k: int) -> np.ndarray:
    """Jellyfish canonical form: numeric (== lexicographic) min of a
    k-mer and its reverse complement."""
    return np.minimum(keys, revcomp(keys, k))


def child_keys_forward(keys: np.ndarray, k: int) -> np.ndarray:
    """The 4 forward extensions seq[1:]+c for c in ACGT, shape (..., 4).

    Mirrors the candidate generation of km/utils/Jellyfish.py:55-72
    (get_child with forward=True), in A,C,G,T order.
    """
    mask = np.uint64((1 << (2 * (k - 1))) - 1)
    base = (keys & mask) << np.uint64(2)
    ext = np.arange(4, dtype=np.uint64)
    return base[..., None] | ext


def child_keys_backward(keys: np.ndarray, k: int) -> np.ndarray:
    """The 4 backward extensions c+seq[:-1] for c in ACGT, shape (..., 4)."""
    base = keys >> np.uint64(2)
    ext = np.arange(4, dtype=np.uint64) << np.uint64(2 * (k - 1))
    return base[..., None] | ext
