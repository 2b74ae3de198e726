"""The skewed count cell (count.fastq_skewed, reads expressed by Zipf's
law) and the whole-sample FASTQ cell (count.fastq_deploy): the
generator repeats from its seed and gives the top transcript its share,
a small run of each cell on the CPU is correct, and a planted fault or
the control is not."""

import contextlib
import types

import pytest
import torch

import control
import small
from kmbench import reads as gen, reads_zipf
from kmbench.drivers import count

EXPRESSION = {"transcripts": 1 << 10, "transcript_bases": 256,
              "zipf_s": 1.0}
P = dict(small.READS, bases=1 << 18)
del P["transcriptome"]


class ZipfSpec(small.SmallSpec):
    """SmallSpec with the new cells cut to a size the CPU runs."""

    def config(self, name):
        c = super().config(name)
        if name == "leucegene_count_zipf":
            c.update(read_bases=1 << 18, chunk=1 << 16,
                     expression=EXPRESSION)
        return c

    def traffic(self, name):
        t = super().traffic(name)
        if name in ("fastq_skewed", "fastq_deploy"):
            t["warm_capacity"] = 1 << 16
            if name == "fastq_deploy":
                t["reads"] = small.READS
        return t


def test_reads_repeat_from_the_seed_and_differ_between_seeds():
    a = reads_zipf.make_reads_zipf(P, EXPRESSION, small.SEED, "cpu")
    b = reads_zipf.make_reads_zipf(P, EXPRESSION, small.SEED, "cpu")
    c = reads_zipf.make_reads_zipf(P, EXPRESSION, small.SEED + 1, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (gen.n_reads(P), 100) and int(a.max()) <= 3
    # the last reads are reads.make_reads' NPM1 reads, but for the
    # substitutions drawn over every read
    n_npm1 = (P["npm1_coverage"]
              * (len(gen.npm1_alleles(P)[0]) + 2 * P["npm1_flank"]) // 100)
    npm1 = gen.make_reads(dict(P, transcriptome=100, bases=n_npm1 * 100,
                               sub_rate=0.0), small.SEED + 1, "cpu")
    assert npm1.shape[0] == n_npm1 > 0
    differ = int((a[-n_npm1:] != npm1).sum())
    assert differ <= round(a.numel() * P["sub_rate"])


def test_the_top_transcript_takes_its_share():
    """At exponent 1 over 2^18 transcripts the transcript of rank 1
    takes 1/H(2^18) of the reads, ~7.66%."""
    expression = {"transcripts": 1 << 18, "transcript_bases": 2048,
                  "zipf_s": 1.0}
    n = 1 << 21
    g = torch.Generator().manual_seed(small.SEED)
    ids = reads_zipf.zipf_transcripts(expression, n, g, "cpu")
    counts = torch.bincount(ids, minlength=1 << 18)
    harmonic = sum(1 / r for r in range(1, (1 << 18) + 1))
    share = int(counts.max()) / n
    assert share == pytest.approx(1 / harmonic, rel=0.05)
    top = torch.sort(counts, descending=True).values
    assert 0.6 < int(top[:(1 << 18) // 100].sum()) / n < 0.7
    # hot transcripts do not lie side by side
    assert int(torch.argmax(counts)) != 0


@pytest.mark.parametrize("cell", ["count.fastq_skewed",
                                  "count.fastq_deploy"])
def test_a_small_run_is_correct_and_reports_its_counters(cell):
    line, obs = small.run_small(cell, spec=ZipfSpec())
    assert line["correct"] and line["failed"] == 0
    assert "count_kmers_per_s" in line["metrics"]
    stats = obs["count_stats"]
    assert all(s["runs"] > 0 and s["m1_rounds"] == 0 for s in stats)
    traced, _ = small.run_small(cell, spec=ZipfSpec(), traced=True)
    assert traced["correct"]
    assert 0 < traced["metrics"]["count.chunk_runs_pct"]["value"] <= 100
    assert traced["metrics"]["count.m1_rounds"]["value"] == 0


def test_a_count_off_by_one_is_caught():
    real = count.Driver.call

    def altered(self):
        (keys, counts), work = real(self)
        counts = counts.copy()
        counts[len(counts) // 2] += 1
        return (keys, counts), work

    with contextlib.ExitStack() as stack:
        count.Driver.call = altered
        stack.callback(setattr, count.Driver, "call", real)
        line, _ = small.run_small("count.fastq_skewed", spec=ZipfSpec())
    assert not line["correct"]
    assert line["compared"]["table_mismatches"]["value"] == 1


def test_the_control_fails_on_skewed_reads(monkeypatch):
    """control.count_control draws its reads with reads.make_reads; given
    the skewed generator in its place, the control (chunks cut with no
    k-1 overlap) is caught."""
    spec = ZipfSpec()
    w = spec.workload("count.fastq_skewed")
    config, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    monkeypatch.setattr(control, "gen", types.SimpleNamespace(
        make_reads=lambda p, seed, device: reads_zipf.make_reads_zipf(
            p, config["expression"], seed, device)))
    got = control.count_control(config, traffic, small.SEED, "cpu")
    assert got["windows_gap"] > 0 and got["table_mismatches"] > 0
