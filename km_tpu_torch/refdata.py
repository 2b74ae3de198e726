"""Bundled acceptance-fixture locations.

The repo vendors the reference's in-tree test data (`data/` — 9 catalog
FASTAs per genome build and 5 mini Jellyfish `.jf` count tables; MIT
licensed, see data/README.md) so the golden suite and the smoke run
stand alone, mirroring the reference's own in-tree `data/` precedent
(reference: data/README.rst:26-55). This is the port's copy of
km_tpu/refdata.py. The
``KM_TPU_REFDATA`` environment variable points everything at a
different data tree (e.g. the original reference checkout).

``catalog_sequences`` and ``catalog_targets`` are the port's own: the
bundled catalog cycled to any number of targets, for the smoke run and
the scale scripts.
"""

from __future__ import annotations

import os

DATA_DIR = os.environ.get(
    "KM_TPU_REFDATA",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "data"))


def catalog_dir(build: str = "GRCh38") -> str:
    """Directory of target FASTAs for a genome build."""
    return os.path.join(DATA_DIR, "catalog", build)


def catalog_fa(name: str, build: str = "GRCh38") -> str:
    """Path of one catalog target FASTA (name without extension)."""
    return os.path.join(DATA_DIR, "catalog", build, name + ".fa")


def jf_path(sample: str) -> str:
    """Path of one bundled `.jf` count table (name without extension)."""
    return os.path.join(DATA_DIR, "jf", sample + ".jf")


def catalog_sequences(n_targets: int) -> list[tuple[str, str]]:
    """The 9 GRCh38 catalog targets cycled to ``n_targets``, as
    (sequence, name) with each name <target>_<i>."""
    from .io.fasta import read_target

    cat = catalog_dir("GRCh38")
    base = []
    for fn in sorted(os.listdir(cat)):
        seqs, _ = read_target(os.path.join(cat, fn))
        base.append(("".join(seqs), os.path.splitext(fn)[0]))
    return [(base[i % len(base)][0], "%s_%d" % (base[i % len(base)][1], i))
            for i in range(n_targets)]


def catalog_targets(n_targets: int, k: int):
    """``catalog_sequences`` as TargetSeq objects for k-mer length k."""
    from .models.sequence import TargetSeq

    return [TargetSeq(seq, name, k)
            for seq, name in catalog_sequences(n_targets)]
