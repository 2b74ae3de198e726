"""The port's slice end to end on CPU tensors: the batched catalog over
the torch table against km_tpu and the golden files, the reads-to-report
flow through the port's CLI against km_tpu's CLI, the no-JAX guarantee,
and the explicit-device and input checks."""

import io
import os
import subprocess
import sys
from contextlib import redirect_stdout
from io import StringIO

import numpy as np
import pytest

import torch

from km_tpu import cli as jcli
from km_tpu.io.fasta import read_target
from km_tpu.models.batch import run_catalog as jax_run_catalog
from km_tpu.models.sequence import TargetSeq
from km_tpu.models.table import CountTable
from km_tpu.tools.find_report import main_find_report

from km_tpu_torch import cli as tcli
from km_tpu_torch.models.batch import run_catalog
from km_tpu_torch.ops import pack, sort_runs
from km_tpu_torch.ops.device_table import DeviceCountTable

from helpers import REFDATA, find_mutation_args, find_report_args, run_tool
from test_golden_files import CASES, _read
from test_reads_to_variant_e2e import _random_linear_seq, _reads

# the device path on CPU tensors is thousands of small ops: one intra-op
# thread each, so that parallel test workers do not oversubscribe the
# cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAT = f"{REFDATA}/catalog/GRCh38"
SAMPLES = ["02H025_NPM1", "02H033_DNMT3A_sub", "03H112_IandI", "03H116_ITD",
           "05H094_FLT3-TKD_del"]


def _catalog(k):
    targets = []
    for fn in sorted(os.listdir(CAT)):
        seqs, _ = read_target(os.path.join(CAT, fn))
        targets.append(TargetSeq("".join(seqs), os.path.splitext(fn)[0], k))
    return targets


@pytest.mark.parametrize("sample", SAMPLES)
def test_catalog_rows_match_km_tpu(sample):
    host = CountTable.from_jf(f"{REFDATA}/jf/{sample}.jf")
    want = jax_run_catalog(_catalog(host.k), host, walk="host")
    got = run_catalog(_catalog(host.k),
                      DeviceCountTable.from_host(host, device="cpu"))
    assert [[str(r) for r in rows] for rows in got] == \
        [[str(r) for r in rows] for rows in want]
    # the host table through the port's pipeline gives the same rows
    got_host = run_catalog(_catalog(host.k), host)
    assert [[str(r) for r in rows] for rows in got_host] == \
        [[str(r) for r in rows] for rows in want]


@pytest.mark.parametrize("case", sorted(c for c in CASES if "/" not in c))
def test_batch_cli_matches_golden(case):
    target, jf = CASES[case]
    from km_tpu_torch.tools.find_mutation import main_find_mut

    fm, _ = run_tool(main_find_mut, find_mutation_args(
        target, jf, batch=True, device="cpu", profile=None))
    stable = "\n".join(l for l in fm.split("\n") if not l.startswith("#"))
    assert stable == _read(f"{case}.find_mutation.tsv")
    rep, _ = run_tool(main_find_report,
                      find_report_args(target, StringIO(fm)))
    assert rep == _read(f"{case}.find_report.tsv")


def _fastq(tmp_path):
    rng = np.random.default_rng(42)
    ref = _random_linear_seq(rng, 200)
    alt = ref[:100] + "TGCA" + ref[100:]
    fq = tmp_path / "reads.fastq"
    with open(fq, "w") as f:
        for i, seq in enumerate(_reads(rng, ref, 400) + _reads(rng, alt, 400)):
            f.write("@r%d\n%s\n+\n%s\n" % (i, seq, "I" * len(seq)))
    target = tmp_path / "target.fa"
    with open(target, "w") as f:
        f.write(">chr1:1000-%d\n%s\n" % (1000 + len(ref) - 1, ref))
    return str(fq), str(target), alt


def _flow(cli, table, fq, target, count_args, fm_args):
    """count -> find_mutation -> find_report through one CLI; returns
    (table arrays, find_mutation rows without '#' lines, report)."""
    cli.main(["count", *count_args, "-k", "31", "-L", "2", "-o", table, fq])
    t = CountTable.load(table)
    out = io.StringIO()
    with redirect_stdout(out):
        cli.main(["find_mutation", *fm_args, target, table])
    fm = out.getvalue()
    fm_path = table + ".tsv"
    with open(fm_path, "w") as f:
        f.write(fm)
    rep = io.StringIO()
    with redirect_stdout(rep):
        cli.main(["find_report", "-t", target, fm_path])
    rows = "\n".join(l for l in fm.split("\n") if not l.startswith("#"))
    return (t.keys, t.counts), rows, rep.getvalue()


def test_reads_to_report_matches_km_tpu_cli(tmp_path):
    fq, target, alt = _fastq(tmp_path)
    table = str(tmp_path / "sample.npz")
    (jk, jc), jrows, jrep = _flow(jcli, table, fq, target, [], [])
    (tk, tc), trows, trep = _flow(tcli, table, fq, target,
                                  ["--device", "cpu"],
                                  ["--batch", "--device", "cpu"])
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tc, jc)
    assert trows == jrows
    assert trep == jrep
    ins = [r.split("\t") for r in trows.split("\n")[1:] if "Insertion" in r]
    assert ins and ins[0][8] == alt


def test_port_main_path_never_loads_jax(tmp_path):
    fq, target, _alt = _fastq(tmp_path)
    table = str(tmp_path / "sample.npz")
    code = (
        "import sys\n"
        "from km_tpu_torch import cli\n"
        "import km_tpu_torch.parallel.distributed\n"
        "import km_tpu_torch.parallel.sharded_table\n"
        "import km_tpu_torch.parallel.pipeline_step\n"
        "import km_tpu_torch.tools.cohort\n"
        "cli.main(['count', '--device', 'cpu', '-k', '31', '-o', %r, %r])\n"
        "cli.main(['find_mutation', '--batch', '--device', 'cpu', %r, %r])\n"
        "cli.main(['cohort', '--device', 'cpu', '-t', %r, '-o', %r, %r])\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
        "if m.startswith('jax'))\n"
        "print('NO_JAX')\n" % (table, fq, target, table, target,
                                str(tmp_path / "cohort"), table))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX" in proc.stdout
    assert "Insertion" in proc.stdout
    # find_report names the planted insertion I&I (it sits in a repeat)
    assert "\tI&I\t" in (tmp_path / "cohort" / "sample" /
                         "target.tsv").read_text()


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    fq, target, _alt = _fastq(tmp_path)
    table = str(tmp_path / "sample.npz")
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(["count", "-o", table, fq])  # --device defaults to cuda
    assert not os.path.exists(table)
    tcli.main(["count", "--device", "host", "-o", table, fq])
    with pytest.raises(RuntimeError, match="cuda"):
        with redirect_stdout(io.StringIO()):
            tcli.main(["find_mutation", "--batch", target, table])


@pytest.mark.parametrize("option", ["walk", "pathing", "quant"])
def test_device_walk_not_ported_raises(option):
    """Each device stage alone, the other two on the host, gives km_tpu's
    rows; a device stage on a host table raises. (The name predates the
    device path and is kept so that the case keeps its history.)"""
    host = CountTable.from_jf(f"{REFDATA}/jf/03H116_ITD.jf")
    table = DeviceCountTable.from_host(host, device="cpu")
    want = jax_run_catalog(_catalog(host.k), host, walk="host")
    choice = dict(walk="host", pathing="host", quant="host")
    choice[option] = "device"
    got = run_catalog(_catalog(host.k), table, **choice)
    assert [[str(r) for r in rows] for rows in got] == \
        [[str(r) for r in rows] for rows in want]
    with pytest.raises(ValueError, match="torch DeviceCountTable"):
        run_catalog(_catalog(host.k)[:1], host, **{option: "device"})


def test_kernel_wrappers_check_their_inputs():
    codes = torch.zeros(64, dtype=torch.uint8)
    valid = torch.ones(64, dtype=torch.bool)
    with pytest.raises(TypeError):
        pack.pack_canonical_windows(codes.to(torch.int32), valid, 31)
    with pytest.raises(TypeError):
        pack.pack_canonical_windows(codes, valid.to(torch.float32), 31)
    with pytest.raises(ValueError, match="contiguous"):
        pack.pack_canonical_windows(torch.zeros(128, dtype=torch.uint8)[::2],
                                    valid, 31)
    with pytest.raises(ValueError):
        pack.pack_canonical_windows(codes, valid[:10], 31)
    with pytest.raises(ValueError):
        pack.pack_canonical_windows(codes, valid, 32)  # k > 31

    keys = torch.zeros(4096, dtype=torch.int64)
    with pytest.raises(TypeError):
        sort_runs.sort_chunks_runs(keys.to(torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        sort_runs.sort_chunks_runs(torch.zeros(8192, dtype=torch.int64)[::2])
    with pytest.raises(ValueError):
        sort_runs.sort_chunks_runs(keys, chunk=3000)  # not a power of two
    with pytest.raises(ValueError):
        sort_runs.sort_chunks_runs(keys, chunk=1 << 15)  # beyond shared mem
    with pytest.raises(TypeError):
        sort_runs.sort_chunks(keys.to(torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        sort_runs.sort_chunks(torch.zeros(8192, dtype=torch.int64)[::2])
    with pytest.raises(ValueError, match="contiguous"):
        sort_runs.sort_chunks(keys.view(64, 64))  # not 1-D
    with pytest.raises(ValueError):
        sort_runs.sort_chunks(keys, chunk=3000)
    with pytest.raises(ValueError):
        sort_runs.sort_chunks(keys, chunk=1 << 8)  # below one warp
    with pytest.raises(ValueError):
        sort_runs.sort_chunks(keys, chunk=1 << 15)
    launches = sort_runs.sort_chunks.launches
    sort_runs.sort_chunks(keys)  # a CPU tensor runs the plain version
    assert sort_runs.sort_chunks.launches == launches
