"""The traffic generators: the same seed gives the same inputs, every
seed the same sizes."""

import numpy as np
import torch

import small
from kmbench import reads as gen
from kmbench.drivers import catalog

P = dict(small.READS, bases=1 << 16)


def test_reads_repeat_from_the_seed_and_differ_between_seeds():
    a = gen.make_reads(P, small.SEED, "cpu")
    b = gen.make_reads(P, small.SEED, "cpu")
    c = gen.make_reads(P, small.SEED + 1, "cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert a.dtype == torch.uint8 and int(a.max()) <= 3


def test_read_sizes():
    r = gen.make_reads(P, small.SEED, "cpu")
    assert r.shape == ((1 << 16) // 100, 100)
    assert gen.n_reads(P) == r.shape[0]
    # the NPM1 reads carry the insertion's k-mers in half of them
    ins = "".join("ACGT"[c] for c in r[-1].tolist())
    assert len(ins) == 100


def test_fastq_bytes_and_records(tmp_path):
    r = gen.make_reads(P, small.SEED, "cpu").numpy()
    path = str(tmp_path / "s.fastq")
    n_bytes = gen.write_fastq(path, r)
    data = open(path, "rb").read()
    assert len(data) == n_bytes == r.shape[0] * (12 + 100 + 3 + 100 + 1)
    lines = data.split(b"\n")
    assert lines[0] == b"@r000000000"
    assert lines[1] == bytes(np.frombuffer(b"ACGT", np.uint8)[r[0]])
    assert lines[2] == b"+" and lines[3] == b"I" * 100


def test_resident_batches_separate_reads():
    r = gen.make_reads(P, small.SEED, "cpu").numpy()
    batches = gen.resident_batches(r, 100)
    assert sum(len(c) for c, _ in batches) == r.shape[0] * 101
    codes, valid = batches[0]
    assert not valid[100] and valid[:100].all()
    assert np.array_equal(codes[:100], r[0])


def test_windows_of_a_count_sample():
    # the count cells' sizes: 2^30 bases, 100-bp reads, k = 31
    p = dict(small.READS, bases=1 << 30)
    assert gen.n_reads(p) == 10_737_418
    assert gen.n_reads(p) * (100 - 31 + 1) == 751_619_260


def test_catalog_table_repeats_and_keeps_the_fixtures():
    fk, fc, k, canon = catalog.fixture_union(
        ["02H025_NPM1", "03H116_ITD"])
    assert k == 31 and canon
    a = catalog.big_table(fk, fc, 5000, 4, small.SEED, "cpu")
    b = catalog.big_table(fk, fc, 5000, 4, small.SEED, "cpu")
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    keys, counts = a
    assert len(keys) == len(fk) + 5000  # no random key met another here
    assert (keys[1:] > keys[:-1]).all()
    at = np.searchsorted(keys, fk)
    assert np.array_equal(keys[at], fk) and np.array_equal(counts[at], fc)
    rand = np.setdiff1d(np.arange(len(keys)), at)
    assert counts[rand].min() >= 1 and counts[rand].max() <= 4


def test_fixture_union_sums_counts_of_shared_keys():
    fk, fc, _, _ = catalog.fixture_union(["03H116_ITD", "03H116_ITD"])
    one, c1, _, _ = catalog.fixture_union(["03H116_ITD"])
    assert np.array_equal(fk, one) and np.array_equal(fc, 2 * c1)


def test_catalog_targets_cycle():
    seqs = catalog.catalog_sequences(400)
    assert len(seqs) == 400 and len({s for s, _ in seqs}) == 9
    assert seqs[9][0] == seqs[0][0] and seqs[9][1].endswith("_9")
