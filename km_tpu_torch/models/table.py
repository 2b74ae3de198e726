"""Host-side count table: sorted packed keys + counts, batched lookups.

This is the exact-semantics spec backend (numpy). The device variant with
the same data layout lives in km_tpu_torch.ops.device_table. This is the
port's copy of km_tpu/models/table.py; the npz and .jf files are shared
between the two packages. Replaces the Jellyfish query façade (reference:
km/utils/Jellyfish.py:23-72) — but vectorized: any number of k-mers can
be resolved in one call.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.jf import read_jf
from ..ops import encode
from ..utils import profiling


@dataclass
class CountTable:
    """Sorted k-mer count table.

    Attributes
    ----------
    k : k-mer length (<= 32)
    canonical : whether keys are canonicalized (query canonicalizes too)
    keys : uint64 sorted ascending
    counts : uint32 aligned with keys
    name : provenance string used in report rows (the .jf path for
        tables loaded from disk, mirroring km's Database column)
    """

    k: int
    canonical: bool
    keys: np.ndarray
    counts: np.ndarray
    name: str = ""

    # -- construction ------------------------------------------------------

    @classmethod
    def from_arrays(cls, keys, counts, k, canonical, name="", presorted=False):
        keys = np.asarray(keys, dtype=np.uint64)
        counts = np.asarray(counts)
        # keep uint64 when counts genuinely exceed 32 bits (wide-counter
        # .jf tables); never wrap silently
        if counts.dtype != np.uint32:
            wide = len(counts) and int(counts.max()) >= 1 << 32
            counts = counts.astype(np.uint64 if wide else np.uint32)
        if not presorted:
            # a .jf lists its records in jellyfish's hash order: the span
            # ``table.sort``; ``CountTable.host_sorted`` counts the records
            with profiling.phase("table.sort"):
                order = np.argsort(keys, kind="stable")
                keys, counts = keys[order], counts[order]
            CountTable.host_sorted += len(keys)
        return cls(k=int(k), canonical=bool(canonical), keys=keys,
                   counts=counts, name=name)

    @classmethod
    def from_jf(cls, path: str) -> "CountTable":
        data = read_jf(path)
        return cls.from_arrays(data.keys, data.counts, data.k,
                               data.canonical, name=path)

    @classmethod
    def from_sequences(cls, seqs, k, canonical=True, min_count=1, name=""):
        """Count k-mers of in-memory sequences (host path, mainly for tests
        and tiny inputs; the scalable FASTQ path is ops.count)."""
        chunks = []
        for s in seqs:
            km = encode.pack_kmers(s, k)
            if canonical:
                km = encode.canonical(km, k)
            chunks.append(km)
        allk = np.concatenate(chunks) if chunks else np.empty(0, np.uint64)
        keys, counts = np.unique(allk, return_counts=True)
        keep = counts >= min_count
        return cls.from_arrays(keys[keep], counts[keep].astype(np.uint32),
                               k, canonical, name=name, presorted=True)

    def save(self, path: str) -> None:
        """Persist (the checkpoint of the expensive counting phase).

        ``.jf`` paths write Jellyfish's binary/sorted layout (so tables
        produced here remain consumable by km's toolchain); anything else
        writes the native .npz form.
        """
        if path.endswith(".jf"):
            from ..io.jf import write_jf

            write_jf(path, self.keys, self.counts, self.k, self.canonical)
        else:
            np.savez(path, keys=self.keys, counts=self.counts,
                     k=np.int64(self.k), canonical=np.bool_(self.canonical))

    @classmethod
    def load(cls, path: str) -> "CountTable":
        """Inverse of save(): dispatches on extension like save() does."""
        if path.endswith(".jf"):
            return cls.from_jf(path)
        with np.load(path) as z:
            return cls(k=int(z["k"]), canonical=bool(z["canonical"]),
                       keys=z["keys"], counts=z["counts"], name=path)

    # -- queries -----------------------------------------------------------

    def query_packed(self, qkeys: np.ndarray) -> np.ndarray:
        """Counts for packed (not yet canonicalized) query keys; 0 if absent."""
        qkeys = np.asarray(qkeys, dtype=np.uint64)
        shape = qkeys.shape
        q = qkeys.reshape(-1)
        if self.canonical:
            q = encode.canonical(q, self.k)
        pos = np.searchsorted(self.keys, q)
        pos_c = np.minimum(pos, max(len(self.keys) - 1, 0))
        if len(self.keys):
            hit = self.keys[pos_c] == q
            out = np.where(hit, self.counts[pos_c], 0).astype(np.int64)
        else:
            out = np.zeros(q.shape, dtype=np.int64)
        return out.reshape(shape)

    def query(self, seq: str) -> int:
        """Count of one k-mer given as a string (0 if absent)."""
        return int(self.query_packed(np.array([encode.pack_kmer(seq)],
                                              dtype=np.uint64))[0])

    def cover(self, seq: str) -> np.ndarray:
        """Counts of every sliding k-mer of ``seq``."""
        return self.query_packed(encode.pack_kmers(seq, self.k))

    def children_packed(self, keys: np.ndarray, forward: bool = True):
        """4-way extension candidates and their counts.

        Returns (child_keys (...,4) uint64, child_counts (...,4) int64) in
        A,C,G,T order — the candidate set of km's get_child
        (reference: km/utils/Jellyfish.py:55-72).
        """
        keys = np.asarray(keys, dtype=np.uint64)
        ck = (encode.child_keys_forward(keys, self.k) if forward
              else encode.child_keys_backward(keys, self.k))
        return ck, self.query_packed(ck)

    def get_child_keys(self, key: int, cutoff: float, n_cutoff: int,
                       forward: bool = True) -> list[int]:
        """Thresholded children of one k-mer, as packed keys.

        Threshold = max(sum_of_4_candidate_counts * cutoff, n_cutoff),
        computed per parent (reference: km/utils/Jellyfish.py:70).
        """
        ck, cc = self.children_packed(np.array([key], dtype=np.uint64),
                                      forward=forward)
        ck, cc = ck[0], cc[0]
        threshold = max(float(cc.sum()) * cutoff, n_cutoff)
        return [int(ck[i]) for i in range(4) if cc[i] >= threshold]

    @property
    def n_kmers(self) -> int:
        return len(self.keys)


CountTable.host_sorted = 0
