"""ctypes wrapper for the native host IO library (libkmio.so).

``kmio.cpp`` is built by the host C++ compiler at first use into the
git-ignored ``km_tpu_torch/build/`` (``_build.build_native``), never
into the source tree. Where it cannot be built or loaded, the reason is
kept (:func:`unavailable_reason`) and logged once as a warning; callers
that ask :func:`available` then take their pure-Python paths, and
:func:`require` raises with the reason for callers that must not.
"""

from __future__ import annotations

import ctypes
import logging as log

import numpy as np

from .. import _build

_lib = None
_reason: str | None = None


def _load():
    global _lib, _reason
    if _lib is not None or _reason is not None:
        return _lib
    try:
        if _build.native_stale():
            _build.build_native()
        lib = ctypes.CDLL(_build.NATIVE_LIB_PATH)
    except (_build.NativeLibraryError, OSError) as exc:
        _reason = "%s: %s" % (type(exc).__name__, exc)
        log.warning("native host library unavailable, falling back to "
                    "Python (slow): %s", _reason)
        return None

    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.km_parse_fastq.restype = ctypes.c_long
    lib.km_parse_fastq.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int, u8p, u8p,
        ctypes.c_long, ctypes.POINTER(ctypes.c_long)]
    lib.km_parse_fasta.restype = ctypes.c_long
    lib.km_parse_fasta.argtypes = [
        ctypes.c_char_p, ctypes.c_long, u8p, u8p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_long)]
    lib.km_count_host.restype = ctypes.c_long
    lib.km_count_host.argtypes = [
        u8p, u8p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint32)]
    lib.km_merge_runs.restype = ctypes.c_long
    lib.km_merge_runs.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64)]
    lib.km_merge_pieces.restype = ctypes.c_long
    lib.km_merge_pieces.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_long, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_int64)]
    lib.km_dijkstra_scanmin.restype = None
    lib.km_dijkstra_scanmin.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int32)]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> str | None:
    """Why the library could not be built or loaded (None if it was)."""
    _load()
    return _reason


def require():
    """The loaded library; raises, with the reason, when there is none."""
    lib = _load()
    if lib is None:
        raise _build.NativeLibraryError(_reason)
    return lib


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def parse_chunk(data: bytes, fastq: bool, min_quality: str | None = None
                ) -> tuple[np.ndarray, np.ndarray, int]:
    """Parse a text chunk of complete-ish records.

    Returns (codes, valid, consumed_bytes); the caller re-feeds
    data[consumed:] prepended to the next chunk.
    """
    lib = require()
    cap = len(data) + 2
    codes = np.empty(cap, dtype=np.uint8)
    valid = np.empty(cap, dtype=np.uint8)
    consumed = ctypes.c_long(0)
    qmin = ord(min_quality) if min_quality else -1
    if fastq:
        n = lib.km_parse_fastq(data, len(data), qmin, _u8ptr(codes),
                               _u8ptr(valid), cap, ctypes.byref(consumed))
    else:
        n = lib.km_parse_fasta(data, len(data), _u8ptr(codes),
                               _u8ptr(valid), cap, ctypes.byref(consumed))
    if n == -2:
        raise ValueError("malformed FASTQ record")
    assert n >= 0, "parse capacity bug"
    return codes[:n], valid[:n].astype(bool), consumed.value


def merge_sorted_runs(runs) -> tuple[np.ndarray, np.ndarray]:
    """K-way merge of sorted (keys uint64, counts int64) runs, summing
    duplicate keys. One pass over all records in C."""
    lib = require()
    runs = [(np.ascontiguousarray(k, dtype=np.uint64),
             np.ascontiguousarray(c, dtype=np.int64)) for k, c in runs]
    offsets = np.zeros(len(runs) + 1, dtype=np.int64)
    offsets[1:] = np.cumsum([len(k) for k, _ in runs])
    total = int(offsets[-1])
    keys = np.empty(total, dtype=np.uint64)
    counts = np.empty(total, dtype=np.int64)
    for (k, c), a, b in zip(runs, offsets[:-1], offsets[1:]):
        keys[a:b] = k
        counts[a:b] = c
    out_keys = np.empty(total, dtype=np.uint64)
    out_counts = np.empty(total, dtype=np.int64)
    m = lib.km_merge_runs(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(runs),
        out_keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out_keys[:m].copy(), out_counts[:m].copy()


def merge_pieces(pieces, min_count: int
                 ) -> tuple[np.ndarray, np.ndarray, int]:
    """K-way merge of sorted pieces of distinct keys, (keys uint64,
    counts uint32) each, with the counts of equal keys summed and cut at
    ``min_count`` on the merged sums: (kept keys uint64, their counts
    uint32, the number of distinct keys). The pieces are read where they
    lie; the outputs are sized for every record and shrunk to the kept
    ones, so memory holds the pieces and what is kept."""
    lib = require()
    pieces = [(np.ascontiguousarray(k, dtype=np.uint64),
               np.ascontiguousarray(c, dtype=np.uint32)) for k, c in pieces]
    s = len(pieces)
    key_ptrs = (ctypes.c_void_p * max(s, 1))(
        *[k.ctypes.data for k, _ in pieces])
    count_ptrs = (ctypes.c_void_p * max(s, 1))(
        *[c.ctypes.data for _, c in pieces])
    lens = np.array([len(k) for k, _ in pieces] or [0], dtype=np.int64)
    total = int(lens.sum())
    out_keys = np.empty(total, dtype=np.uint64)
    out_counts = np.empty(total, dtype=np.uint32)
    unique = ctypes.c_int64(0)
    kept = lib.km_merge_pieces(
        key_ptrs, count_ptrs,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), s, min_count,
        out_keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.byref(unique))
    # shrunk in place: the tail the threads wrote before the kept records
    # were moved together is given back
    out_keys.resize(kept, refcheck=False)
    out_counts.resize(kept, refcheck=False)
    return out_keys, out_counts, unique.value


def dijkstra_scanmin(ptr: np.ndarray, ids: np.ndarray, w: np.ndarray,
                     n: int, start: int) -> np.ndarray:
    """Native scan-min Dijkstra over CSR; returns the predecessor array
    (int32, -1 where unreached)."""
    lib = require()
    prev = np.full(n, -1, dtype=np.int32)
    lib.km_dijkstra_scanmin(
        ptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, start,
        prev.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return prev


def count_host(codes: np.ndarray, valid: np.ndarray, k: int,
               canonical: bool = True
               ) -> tuple[np.ndarray, np.ndarray]:
    """Native host k-mer counter (sorted keys + counts)."""
    lib = require()
    n = len(codes)
    n_win = max(n - k + 1, 0)
    keys = np.empty(n_win, dtype=np.uint64)
    counts = np.empty(n_win, dtype=np.uint32)
    valid_u8 = valid.astype(np.uint8)
    m = lib.km_count_host(
        _u8ptr(codes), _u8ptr(valid_u8), n, k, int(canonical),
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return keys[:m].copy(), counts[:m].copy()
