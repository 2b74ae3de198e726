"""Synthetic RNA-seq reads from a seed: the count cells' traffic.

The generator of the port's smoke run (``chip_smoke.py::write_fastq``),
copied so that it stays fixed, with its sizes as parameters and its
random numbers drawn on the device: 100-bp reads at uniform positions of
a random transcriptome, plus reads of the NPM1 target and of the target
with its 4-base insertion, 50/50 at ``npm1_coverage``-fold (in random
flanks, so whole reads cover it), then substitutions at ``sub_rate``.
Every seed gives the same number of reads and of substitutions; only
where they fall changes. Bases are codes A=0, C=1, G=2, T=3, all valid.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from reference.fasta import read_target

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data")
BLOCK = 1 << 20  # reads gathered at a time
QUALITY = ord("I")  # above every -Q the configurations use
ACGT = np.frombuffer(b"ACGT", np.uint8)
_CODE = np.full(256, 255, np.uint8)
_CODE[ACGT] = np.arange(4)


def seq_to_codes(seq: str) -> np.ndarray:
    """ASCII bases -> codes A=0, C=1, G=2, T=3 (255 for any other)."""
    return _CODE[np.frombuffer(seq.upper().encode("ascii"), np.uint8)]


def npm1_alleles(p: dict) -> tuple[np.ndarray, np.ndarray]:
    seqs, _ = read_target(os.path.join(DATA, "catalog",
                                       p["npm1_target"] + ".fa"))
    ref = "".join(seqs)
    pos, ins = p["npm1_insert"]
    return seq_to_codes(ref), seq_to_codes(ref[:pos] + ins + ref[pos:])


def n_reads(p: dict) -> int:
    return p["bases"] // p["read_len"]


def make_reads(p: dict, seed: int, device) -> torch.Tensor:
    """uint8 codes [reads, read_len] on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    L, T = p["read_len"], p["transcriptome"]
    n = n_reads(p)

    def randint(lo, hi, size, dtype=torch.int64):
        return torch.randint(lo, hi, size, generator=g, device=device,
                             dtype=dtype)

    flank = p["npm1_flank"]
    alleles = [np.concatenate([np.zeros(flank, np.uint8), a,
                               np.zeros(flank, np.uint8)])
               for a in npm1_alleles(p)]
    n_npm1 = p["npm1_coverage"] * len(alleles[0]) // L
    n_bg = n - n_npm1
    reads = torch.empty((n, L), dtype=torch.uint8, device=device)
    ar = torch.arange(L, device=device)

    tx = randint(0, 4, (T,), torch.uint8)
    starts = randint(0, T - L + 1, (n_bg,))
    for lo in range(0, n_bg, BLOCK):
        hi = min(lo + BLOCK, n_bg)
        reads[lo:hi] = tx[starts[lo:hi, None] + ar]
    del tx, starts

    if n_npm1:
        width = max(len(a) for a in alleles)
        mat = torch.zeros((2, width), dtype=torch.uint8, device=device)
        flanks = randint(0, 4, (2, flank), torch.uint8)
        for i, a in enumerate(alleles):
            mat[i, :len(a)] = torch.from_numpy(a).to(device)
            mat[i, :flank] = flanks[0]
            mat[i, len(a) - flank:len(a)] = flanks[1]
        which = torch.arange(n_npm1, device=device) % 2
        spans = torch.tensor([len(a) - L + 1 for a in alleles],
                             device=device)
        off = (torch.rand(n_npm1, generator=g, device=device)
               * spans[which]).long()
        reads[n_bg:] = mat[which[:, None], off[:, None] + ar]

    flat = reads.view(-1)
    n_sub = round(flat.numel() * p["sub_rate"])
    at = torch.unique(randint(0, flat.numel(), (n_sub,)))
    flat[at] = (flat[at] + randint(1, 4, (at.numel(),), torch.uint8)) % 4
    return reads


def write_fastq(path: str, reads: np.ndarray) -> int:
    """FASTQ of the reads (codes [reads, length] on the host) in fixed
    width records "@r%09d", the read, "+", a quality of 'I' per base,
    synced to disk; returns the bytes written."""
    n, L = reads.shape
    head, sep = 12, 3
    width = head + L + sep + L + 1
    block = 1 << 18
    with open(path, "wb") as f:
        for lo in range(0, n, block):
            ids = np.arange(lo, min(lo + block, n))
            rec = np.empty((len(ids), width), np.uint8)
            rec[:, 0] = ord("@")
            rec[:, 1] = ord("r")
            digits = (ids[:, None] // 10 ** np.arange(8, -1, -1)) % 10
            rec[:, 2:11] = digits + ord("0")
            rec[:, 11] = ord("\n")
            rec[:, head:head + L] = ACGT[reads[lo:lo + len(ids)]]
            s = head + L
            rec[:, s:s + sep] = np.frombuffer(b"\n+\n", np.uint8)
            rec[:, s + sep:s + sep + L] = QUALITY
            rec[:, -1] = ord("\n")
            f.write(rec.tobytes())
        # on disk before the window, so that no writeback runs inside it
        f.flush()
        os.fsync(f.fileno())
    return n * width


def resident_batches(reads: np.ndarray, batch_reads: int):
    """The reads as the parser hands them on: (codes uint8, valid bool)
    batches of ``batch_reads`` reads, each read followed by one invalid
    position, so that no window spans two reads."""
    n, L = reads.shape
    out = []
    for lo in range(0, n, batch_reads):
        r = reads[lo:lo + batch_reads]
        codes = np.zeros((len(r), L + 1), np.uint8)
        codes[:, :L] = r
        valid = np.zeros((len(r), L + 1), bool)
        valid[:, :L] = True
        out.append((codes.reshape(-1), valid.reshape(-1)))
    return out
