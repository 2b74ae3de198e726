"""Target sequences as ordered packed k-mer lists.

Equivalent capability to km's RefSeq/AltSeq (reference:
km/utils/Sequence.py:10-82, km/utils/common.py:48-63) but built on packed
uint64 keys — the engine's native currency — rather than strings.
"""

from __future__ import annotations

import numpy as np

from ..ops import encode


def target_kmers(seq: str, name: str, k: int) -> np.ndarray:
    """Ordered unique k-mers of a target as packed keys.

    Raises ValueError if a k-mer occurs twice — a target whose de Bruijn
    decomposition is not unique cannot anchor the walk (same contract as
    km/utils/common.py:48-63; km's linear_kmin tool finds a usable k).
    """
    mers = encode.pack_kmers(seq, k)
    seen: set[int] = set()
    for i, m in enumerate(mers):
        m = int(m)
        if m in seen:
            raise ValueError(
                "%s found multiple times in reference %s, at pos. %d"
                % (encode.unpack_kmer(m, k), name, i)
            )
        seen.add(m)
    return mers


class TargetSeq:
    """A catalog target: sequence, name, and its ordered k-mer walk anchors."""

    def __init__(self, seq: str, name: str, k: int):
        self.seq = seq
        self.name = name
        self.k = k
        self.ref_mer = target_kmers(seq, name, k)  # uint64, target order
        if not len(self.ref_mer):
            raise ValueError(f"target {name} shorter than k={k}")
        self.first_kmer = int(self.ref_mer[0])
        self.last_kmer = int(self.ref_mer[-1])
        self.seq_index: tuple[int, ...] | None = None  # node ids, set later

    def set_index(self, node_index: dict[int, int]) -> None:
        """Resolve k-mers to node ids once the graph node list is final."""
        self.seq_index = tuple(node_index[int(m)] for m in self.ref_mer)
