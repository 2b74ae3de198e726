"""The port's cohort subcommand against km_tpu's: the same report files,
byte for byte, for count tables and for a raw-read sample, in the
default and VCF formats; one pair against the find_mutation |
find_report pipe; and the count and cohort commands in two gloo
processes (the sharded count's table equals host counting; processes
split the samples).

km_tpu is imported inside the tests only: the spawned processes import
this module, run the port's CLI and must end with nothing of km_tpu (and
so no JAX) loaded.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from km_tpu_torch import cli as tcli
from km_tpu_torch.io.fasta import read_target
from km_tpu_torch.refdata import DATA_DIR as REFDATA

from test_torch_parallel import foreign_modules, spawn

torch.set_num_threads(1)

CAT = f"{REFDATA}/catalog/GRCh38"
NPM1_FA = f"{CAT}/NPM1_4ins_exons_10-11utr.fa"
SAMPLES = [f"{REFDATA}/jf/02H025_NPM1.jf", f"{REFDATA}/jf/03H116_ITD.jf"]


def _tree(root):
    """{relative path: bytes} of every file under root."""
    files = {}
    for base, _dirs, names in os.walk(root):
        for name in names:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                files[os.path.relpath(path, root)] = f.read()
    return files


def _km_tpu_cohort(outdir, argv):
    from km_tpu import cli as jcli

    jcli.main(["cohort", "-o", str(outdir)] + argv)
    return _tree(outdir)


@pytest.fixture(scope="module")
def km_tpu_reports(tmp_path_factory):
    return _km_tpu_cohort(tmp_path_factory.mktemp("km_tpu_cohort"),
                          ["-t", CAT] + SAMPLES)


@pytest.mark.parametrize("device", ["cpu", "host"])
def test_cohort_matches_km_tpu_cohort(tmp_path, km_tpu_reports, device):
    tcli.main(["cohort", "-t", CAT, "-o", str(tmp_path), "--device", device]
              + SAMPLES)
    got = _tree(tmp_path)
    assert len(got) == len(SAMPLES) * len(os.listdir(CAT))
    assert got == km_tpu_reports


def test_cohort_pair_matches_the_pipe(tmp_path, monkeypatch, capsys):
    """Also: the launches cohort reports are its own, not the process's
    running totals (a table sample launches no counting kernel)."""
    from test_cohort import _reference_report

    from km_tpu_torch.ops import merge, pack, sort_runs

    for fn in (pack.pack_canonical_windows, sort_runs.sort_chunks_runs,
               merge.chunk_runs, merge.merge_accum, merge.cut):
        monkeypatch.setattr(fn, "launches", 39)
    tcli.main(["cohort", "-t", f"{CAT}/FLT3-ITD_exons_13-15.fa", "-o",
               str(tmp_path), "--device", "cpu", SAMPLES[1]])
    last = capsys.readouterr().err.strip().splitlines()[-1]
    assert last.endswith("kernel launches: pack 0, sort_runs 0, "
                         "chunk_runs 0, merge_accum 0, cut 0)"), last
    got = (tmp_path / "03H116_ITD" / "FLT3-ITD_exons_13-15.tsv").read_text()
    assert got == _reference_report(f"{CAT}/FLT3-ITD_exons_13-15.fa",
                                    SAMPLES[1])


def test_cohort_vcf_format(tmp_path):
    from test_cohort import _reference_report

    tcli.main(["cohort", "-t", NPM1_FA, "-o", str(tmp_path), "-f", "vcf",
               "--device", "cpu", SAMPLES[0]])
    got = (tmp_path / "02H025_NPM1" / "NPM1_4ins_exons_10-11utr.tsv"
           ).read_text()
    assert got == _reference_report(NPM1_FA, SAMPLES[0], fmt="vcf")
    assert got.startswith("##fileformat=VCFv4.1")


def _npm1_reads(path):
    """400 reads of 60 bases from the NPM1 target (as test_cohort.py)."""
    rng = np.random.default_rng(0)
    seqs, _ = read_target(NPM1_FA)
    ref = "".join(seqs)
    with open(path, "w") as f:
        for i in range(400):
            off = int(rng.integers(0, max(len(ref) - 60, 1)))
            read = ref[off:off + 60]
            f.write("@r%d\n%s\n+\n%s\n" % (i, read, "I" * len(read)))
    return str(path)


def test_cohort_counts_a_raw_read_sample(tmp_path):
    fq = _npm1_reads(tmp_path / "sample_reads.fastq")
    want = _km_tpu_cohort(tmp_path / "km_tpu", ["-t", NPM1_FA, "-L", "1",
                                                fq])
    tcli.main(["cohort", "-t", NPM1_FA, "-o", str(tmp_path / "port"),
               "-L", "1", "--device", "cpu", fq])
    got = _tree(tmp_path / "port")
    assert list(got) == ["sample_reads/NPM1_4ins_exons_10-11utr.tsv"]
    assert got == want
    assert b"Reference" in got["sample_reads/NPM1_4ins_exons_10-11utr.tsv"]


def _count_and_cohort(rank, world, tmp, kind="cpu"):
    """count and cohort through cli.main in a live group: gloo for
    'cpu', NCCL with one card per rank (LOCAL_RANK set as torchrun sets
    it) for 'cuda'."""
    torch.set_num_threads(1)
    if kind == "cuda":
        os.environ["LOCAL_RANK"] = str(rank)
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                            init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world)
    tcli.main(["count", "--device", kind, "-k", "31", "-L", "1",
               "-o", f"{tmp}/table_rank{rank}.npz", f"{tmp}/reads.fastq"])
    tcli.main(["cohort", "-t", CAT, "-o", f"{tmp}/cohort", "--device",
               kind] + SAMPLES)
    assert foreign_modules() == []
    dist.destroy_process_group()


def _check_count_and_cohort(tmp, world, want_reports):
    """Only the first rank wrote the table, which equals host counting;
    the processes split the samples and wrote ``want_reports``."""
    from km_tpu.io.fastq import read_batches
    from km_tpu.models.table import CountTable
    from km_tpu.ops.count import count_batches_host

    for r in range(1, world):
        assert not (tmp / ("table_rank%d.npz" % r)).exists()
    table = CountTable.load(str(tmp / "table_rank0.npz"))
    hk, hc = count_batches_host(
        read_batches([str(tmp / "reads.fastq")], min_quality=None), 31,
        canonical=True, min_count=1)
    np.testing.assert_array_equal(table.keys, hk)
    np.testing.assert_array_equal(table.counts, hc)
    assert _tree(tmp / "cohort") == want_reports


def test_count_and_cohort_in_two_gloo_processes(tmp_path, km_tpu_reports):
    _npm1_reads(tmp_path / "reads.fastq")
    spawn(_count_and_cohort, 2, tmp_path)
    # each process ran its own sample; together, km_tpu's files
    _check_count_and_cohort(tmp_path, 2, km_tpu_reports)


@pytest.mark.cuda
def test_count_and_cohort_on_several_cards(tmp_path):
    """The same under NCCL, one card per rank (four, or two): the table
    equals host counting and the reports equal a --device host cohort.
    Run where the cards are: python -m pytest --noconftest -m cuda
    tests/test_torch_cohort.py"""
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards < 2:
        pytest.skip("needs two or more CUDA devices")
    tcli.main(["cohort", "-t", CAT, "-o", str(tmp_path / "host"),
               "--device", "host"] + SAMPLES)
    run = tmp_path / "cards"
    run.mkdir()
    _npm1_reads(run / "reads.fastq")
    world = 4 if n_cards >= 4 else 2
    spawn(_count_and_cohort, world, run, "cuda")
    _check_count_and_cohort(run, world, _tree(tmp_path / "host"))
