"""Synthetic RNA-seq reads whose transcripts are expressed by Zipf's law:
the traffic of the skewed count cells.

Expression in a real sample follows a power law over transcripts
(Furusawa & Kaneko, "Zipf's law in gene expression", Phys. Rev. Lett.
90, 088102, 2003): the transcript of rank r takes a share of the reads
proportional to r^-s. The transcriptome is ``transcripts`` random
transcripts of ``transcript_bases`` each; their order of rank is a
permutation from the seed, so hot transcripts do not lie side by side.
Each background read takes its transcript by the inverse of the
cumulative weights (``torch.searchsorted``), then a uniform start in it.
The NPM1 reads are ``reads.make_reads``' own, and the substitutions are
drawn over every read as it draws them. Random numbers are drawn on the
device from the seed; every seed gives the same number of reads and of
substitutions.
"""

from __future__ import annotations

import torch

from . import reads as gen


def zipf_transcripts(expression: dict, n: int, g: torch.Generator,
                     device) -> torch.Tensor:
    """The transcript (0 .. transcripts - 1) of each of n reads: the
    transcript of rank r (from 1) with weight r^-zipf_s."""
    t, s = expression["transcripts"], expression["zipf_s"]
    weight = torch.arange(1, t + 1, dtype=torch.float64, device=device) ** -s
    cdf = torch.cumsum(weight, 0)
    cdf /= cdf[-1].clone()
    by_rank = torch.randperm(t, generator=g, device=device)
    u = torch.rand(n, generator=g, dtype=torch.float64, device=device)
    rank = torch.searchsorted(cdf, u, right=True).clamp_(max=t - 1)
    return by_rank[rank]


def make_reads_zipf(p: dict, expression: dict, seed: int,
                    device) -> torch.Tensor:
    """uint8 codes [reads, read_len] on ``device``; ``p`` as
    ``reads.make_reads`` takes it, less ``transcriptome``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    L = p["read_len"]
    n = gen.n_reads(p)
    # as reads.make_reads sizes them: the allele in its two flanks
    n_npm1 = (p["npm1_coverage"]
              * (len(gen.npm1_alleles(p)[0]) + 2 * p["npm1_flank"]) // L)
    n_bg = n - n_npm1
    reads = torch.empty((n, L), dtype=torch.uint8, device=device)
    ar = torch.arange(L, device=device)

    bases = expression["transcript_bases"]
    tx = torch.randint(0, 4, (expression["transcripts"] * bases,),
                       generator=g, device=device, dtype=torch.uint8)
    starts = (zipf_transcripts(expression, n_bg, g, device) * bases
              + torch.randint(0, bases - L + 1, (n_bg,), generator=g,
                              device=device))
    for lo in range(0, n_bg, gen.BLOCK):
        hi = min(lo + gen.BLOCK, n_bg)
        reads[lo:hi] = tx[starts[lo:hi, None] + ar]
    del tx, starts

    if n_npm1:
        # reads.make_reads with no background read and no substitution,
        # on a stream of its own (seed + 1), so that its flanks are not
        # the transcriptome's first bases
        reads[n_bg:] = gen.make_reads(
            dict(p, transcriptome=L, bases=n_npm1 * L, sub_rate=0.0),
            seed + 1, device)

    flat = reads.view(-1)
    n_sub = round(flat.numel() * p["sub_rate"])
    at = torch.unique(torch.randint(0, flat.numel(), (n_sub,), generator=g,
                                    device=device))
    flat[at] = (flat[at] + torch.randint(1, 4, (at.numel(),), generator=g,
                                         device=device,
                                         dtype=torch.uint8)) % 4
    return reads
