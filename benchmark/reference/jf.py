"""Native reader for Jellyfish ``.jf`` count-table files.

km reaches these files only through the external C++ ``dna_jellyfish``
bindings (reference: km/utils/Jellyfish.py:24-53). This module (the
port's copy of km_tpu/io/jf.py) decodes the format directly so existing
tables keep working with zero native deps.

On-disk format (verified against the five bundled fixtures in
data/jf):

- bytes 0..8: 9 ASCII digits, the padded JSON header length ``H``
- bytes 9..9+H: a JSON object (possibly followed by padding so that
  ``9+H`` is 8-byte aligned) with at least ``key_len`` (bits; k = key_len/2),
  ``counter_len`` (bytes), ``canonical`` (bool), ``format`` ("binary/sorted")
- records from offset ``9+H``: ``(key_len+63)//64*8`` bytes of little-endian
  2-bit packed k-mer (leftmost base in the highest bit pair) followed by
  ``counter_len`` bytes of little-endian count.

Records are ordered by Jellyfish's internal matrix hash, NOT
lexicographically; callers should re-sort (CountTable does). The hash
is emulated exactly here (:func:`jf_hash`): ``hash(key) = XOR of
matrix1.columns[j] over set key bits, column j paired with key bit
c-1-j (leftmost base first)``, hash width ``r = log2(size)``; all five
bundled fixtures' record orders are ascending under it
(tests/test_encode_and_jf.py), which is the validating evidence that
:func:`write_jf`'s files follow Jellyfish's own sorted-layout
geometry.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np


@dataclass
class JFData:
    """Decoded contents of a .jf file."""

    k: int
    canonical: bool
    keys: np.ndarray  # uint64, packed k-mers, file order
    counts: np.ndarray  # uint32
    header: dict = field(repr=False, default_factory=dict)


def read_header(path: str) -> dict:
    """Parse the JSON header of a .jf file leniently (the declared header
    length includes alignment padding after the JSON object)."""
    with open(path, "rb") as f:
        hlen = int(f.read(9).decode("ascii"))
        raw = f.read(hlen).decode("ascii", errors="ignore")
    obj, _ = json.JSONDecoder().raw_decode(raw)
    obj["_data_offset"] = 9 + hlen
    return obj


def jf_hash(keys: np.ndarray, columns, c: int) -> np.ndarray:
    """Jellyfish's GF(2) matrix hash, emulated: ``matrix1.columns[j]``
    (an r-bit column vector) is XORed in when key bit ``c-1-j`` is set
    — leftmost base pairs with the first column. Record order in every
    ``binary/sorted`` file is ascending under this hash; verified
    against all five bundled fixtures (tests/test_encode_and_jf.py)."""
    keys = np.asarray(keys, dtype=np.uint64)
    cols = np.asarray(columns, dtype=np.uint64)
    out = np.zeros(len(keys), np.uint64)
    for j in range(c):
        bit = (keys >> np.uint64(c - 1 - j)) & np.uint64(1)
        out ^= np.where(bit == 1, cols[j], np.uint64(0))
    return out


def _jf_matrix(key_len: int, r: int, seed: int = 0x6a66) -> list[int]:
    """A deterministic full-entropy r-bit column set for write_jf's
    matrix1 (Jellyfish draws its matrix randomly; files only require
    that records sort by the resulting hash)."""
    rng = np.random.default_rng(seed)
    return [int(x) for x in
            rng.integers(0, 1 << r, key_len, dtype=np.uint64)]


# Jellyfish's quadratic reprobe schedule (triangular numbers), constant
# across the bundled fixtures; carried verbatim for header parity
_MAX_REPROBE = 126
_REPROBES = [1] + [i * (i + 1) // 2 for i in range(1, _MAX_REPROBE + 1)]


def write_jf(path: str, keys: np.ndarray, counts: np.ndarray, k: int,
             canonical: bool, cmdline=None) -> None:
    """Write a ``.jf`` count table (binary/sorted layout).

    Produces the record layout Jellyfish emits (9-digit ASCII header
    length, JSON header, then 8-byte LE packed key + ``counter_len``-byte
    LE count per record; see module docstring) with Jellyfish's own
    ordering/size geometry: ``r = log2(size)`` hash bits, an r-by-key_len
    GF(2) ``matrix1``, and records ascending by :func:`jf_hash` — the
    invariant the binary search of Jellyfish's query path walks, and the
    one all five bundled fixtures verifiably follow (the validating
    emulation asked for by the parity review). No Jellyfish binary exists
    in this environment, so consumption by Jellyfish's own C++ tools is
    emulation-validated rather than integration-tested. Replaces the
    persistence side of ``jellyfish count -o``
    (reference: example/run_leucegene.sh:22) for ``km-tpu count`` tables.
    """
    keys = np.asarray(keys, dtype=np.uint64)
    counts = np.asarray(counts, dtype=np.uint64)
    if len(keys) != len(counts):
        raise ValueError("keys and counts must have equal length")
    if k > 32:
        raise ValueError(f"k={k} > 32 not supported by the 64-bit key path")

    counter_len = 4
    maxc = int(counts.max()) if len(counts) else 0
    while maxc >= 1 << (8 * counter_len):
        counter_len += 1
    val_len = max(1, maxc.bit_length())  # in bits, like jellyfish's -c
    key_len = 2 * k
    # hash-table size: a power of two, like jellyfish sizes its hash;
    # r = log2(size) hash bits, the fixtures' geometry
    size = 1 << max(1, (2 * max(len(keys), 1) - 1).bit_length())
    r = size.bit_length() - 1
    columns = _jf_matrix(key_len, r)
    order = np.argsort(jf_hash(keys, columns, key_len), kind="stable")
    keys, counts = keys[order], counts[order]
    header = {
        "alignment": 8,
        "canonical": bool(canonical),
        "cmdline": list(cmdline) if cmdline else ["km-tpu", "count"],
        "counter_len": counter_len,
        "format": "binary/sorted",
        "key_len": key_len,
        "matrix1": {"c": key_len, "r": r, "columns": columns},
        "max_reprobe": _MAX_REPROBE,
        "reprobes": _REPROBES,
        "size": size,
        "val_len": val_len,
    }
    blob = json.dumps(header, sort_keys=True).encode("ascii")
    # pad the declared header length so data starts 8-byte aligned
    hlen = -(-(len(blob) + 9) // 8) * 8 - 9
    pad = hlen - len(blob)

    n = len(keys)
    rec = 8 + counter_len
    raw = np.zeros((n, rec), dtype=np.uint8)
    raw[:, :8] = keys.view(np.uint8).reshape(n, 8)
    for b in range(counter_len):
        raw[:, 8 + b] = ((counts >> np.uint64(8 * b))
                         & np.uint64(0xFF)).astype(np.uint8)

    with open(path, "wb") as f:
        f.write(b"%09d" % hlen)
        f.write(blob)
        f.write(b" " * pad)
        f.write(raw.tobytes())


def read_jf(path: str) -> JFData:
    """Decode all records of a .jf file into packed-key/count arrays."""
    header = read_header(path)
    if header.get("format") != "binary/sorted":
        raise ValueError(
            f"{path}: unsupported .jf format {header.get('format')!r} "
            "(only binary/sorted is supported)"
        )
    key_len = int(header["key_len"])  # bits
    counter_len = int(header["counter_len"])  # bytes
    k = key_len // 2
    if k > 32:
        raise ValueError(f"{path}: k={k} > 32 not supported by the 64-bit key path")
    key_bytes = (key_len + 63) // 64 * 8
    rec = key_bytes + counter_len
    offset = header.pop("_data_offset")

    with open(path, "rb") as f:
        f.seek(offset)
        data = f.read()
    n = len(data) // rec
    if n * rec != len(data):
        raise ValueError(f"{path}: trailing {len(data) - n * rec} bytes after {n} records")

    raw = np.frombuffer(data[: n * rec], dtype=np.uint8).reshape(n, rec)
    # key: little-endian uint64 (key_bytes == 8 for all k <= 32)
    keys = raw[:, :8].copy().view("<u8").reshape(n)
    counts = np.zeros(n, dtype=np.uint64)
    for b in range(counter_len):
        counts |= raw[:, key_bytes + b].astype(np.uint64) << np.uint64(8 * b)
    if counter_len <= 4 or (len(counts) and counts.max() < 1 << 32):
        counts = counts.astype(np.uint32)

    return JFData(k=k, canonical=bool(header["canonical"]), keys=keys,
                  counts=counts, header=header)
