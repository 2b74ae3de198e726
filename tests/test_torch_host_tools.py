"""The port's host tools against km_tpu's and the golden files:
find_report in its TSV, VCF and table modes (equal bytes), linear_kmin,
min_cov, load_table, the argument schema (the same options and defaults,
plus the port's --device), the golden outputs through the port alone,
and the rule that nothing of the port imports km_tpu: in its sources,
and in a fresh process after each subcommand."""

import argparse
import os
import re
import subprocess
import sys
from argparse import Namespace
from io import StringIO

import numpy as np
import pytest

import km_tpu.argparsing.schemas as km_schemas
from km_tpu.tools.find_mutation import load_table as km_load_table
from km_tpu.tools.find_mutation import main_find_mut as km_find_mut
from km_tpu.tools.find_report import main_find_report as km_find_report
from km_tpu.tools.linear_kmin import find_kmin as km_find_kmin
from km_tpu.tools.linear_kmin import main_linear_kmin as km_linear_kmin
from km_tpu.tools.min_cov import coverage_stats as km_coverage_stats
from km_tpu.tools.min_cov import main_min_cov as km_min_cov

import km_tpu_torch.argparsing.schemas as schemas
from km_tpu_torch.tools.find_mutation import load_table, main_find_mut
from km_tpu_torch.tools.find_report import main_find_report
from km_tpu_torch.tools.linear_kmin import find_kmin, main_linear_kmin
from km_tpu_torch.tools.min_cov import coverage_stats, main_min_cov

from helpers import REFDATA, find_mutation_args, find_report_args, run_tool
from test_golden_files import CASES, _read

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CATALOG = f"{REFDATA}/catalog/GRCh38"
GOLDEN_CASES = sorted(c for c in CASES if "/" not in c)


def _golden_fm(case):
    """A find_mutation output as find_report reads it: the golden rows
    under a provenance line."""
    return "#func:golden\n" + _read(f"{case}.find_mutation.tsv")


# -- find_report -------------------------------------------------------------


@pytest.mark.parametrize("fmt", [None, "vcf", "table"])
@pytest.mark.parametrize("case", GOLDEN_CASES)
def test_find_report_matches_km_tpu(case, fmt):
    target, _jf = CASES[case]
    fm = _golden_fm(case)
    got, _ = run_tool(main_find_report,
                      find_report_args(target, StringIO(fm), format=fmt))
    want, _ = run_tool(km_find_report,
                       find_report_args(target, StringIO(fm), format=fmt))
    assert got == want
    assert len(got.splitlines()) > 1
    if fmt is None:
        assert got == _read(f"{case}.find_report.tsv")
    elif fmt == "vcf":
        assert got == _read(f"{case}.vcf")


@pytest.mark.parametrize("options", [
    dict(info="cluster"), dict(min_cov=2400), dict(min_cov=10 ** 6),
    dict(exclu=f"{REFDATA}/jf/02H025_NPM1.jf"),
    dict(exclu=f"{REFDATA}/jf/02H033_DNMT3A_sub.jf", format="table")],
    ids=["cluster", "min_cov", "min_cov_all", "exclu", "exclu_table"])
def test_find_report_options_match_km_tpu(options):
    target, jf = CASES["NPM1"]
    fm, _ = run_tool(main_find_mut, find_mutation_args(target, jf))
    got, _ = run_tool(main_find_report,
                      find_report_args(target, StringIO(fm), **options))
    want, _ = run_tool(km_find_report,
                       find_report_args(target, StringIO(fm), **options))
    assert got == want and got
    for main in (main_find_report, km_find_report):
        with pytest.raises(SystemExit, match="options are incompatible"):
            run_tool(main, find_report_args(target, StringIO(fm),
                                            info="cluster", format="vcf"))


# -- the goldens through the port alone -------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_golden_outputs_through_the_port_alone(case):
    """find_mutation (one target at a time, the host engine), find_report
    and the VCF: the frozen bytes, with nothing of km_tpu in the way."""
    target, jf = CASES[case]
    fm, _ = run_tool(main_find_mut, find_mutation_args(target, jf))
    stable = "\n".join(line for line in fm.split("\n")
                       if not line.startswith("#"))
    assert stable == _read(f"{case}.find_mutation.tsv")
    rep, _ = run_tool(main_find_report,
                      find_report_args(target, StringIO(fm)))
    assert rep == _read(f"{case}.find_report.tsv")
    vcf, _ = run_tool(main_find_report,
                      find_report_args(target, StringIO(fm), format="vcf"))
    assert vcf == _read(f"{case}.vcf")


def test_find_mutation_output_shape_matches_km_tpu():
    """The provenance block, header, rows and footer, line for line."""
    target, jf = CASES["FLT3_ITD"]
    outs = []
    for main in (main_find_mut, km_find_mut):
        args = find_mutation_args(target, jf)
        args.func = "main_find_mut"
        args.profile = None
        args.batch = False
        outs.append(run_tool(main, args)[0].splitlines())
    got, want = outs
    assert got[:-1] == want[:-1]
    assert got[0] == "#func:main_find_mut" and got[1] == "#count:5"
    assert got[-1].startswith("#Elapsed time:")


# -- linear_kmin, min_cov, load_table ---------------------------------------


@pytest.mark.parametrize("start", [5, 10, 31])
def test_linear_kmin_matches_km_tpu(start):
    args = Namespace(start=start, target_fn=[CATALOG])
    got, _ = run_tool(main_linear_kmin, args)
    want, _ = run_tool(km_linear_kmin, args)
    assert got == want
    assert len(got.splitlines()) == 10
    if start == 5:
        one = Namespace(start=5,
                        target_fn=[f"{CATALOG}/FLT3-ITD_exons_13-15.fa"])
        assert run_tool(main_linear_kmin, one)[0].split("\n")[1] \
            .split("\t")[1] == "10"


def test_find_kmin_on_repeats_matches_km_tpu():
    rng = np.random.default_rng(3)
    unit = "".join(rng.choice(list("ACGT"), 40))
    for seq in (unit + unit[:12] + "ACGTTGCA", "ACGT" * 4 + unit):
        assert find_kmin("r", seq, 3) == km_find_kmin("r", seq, 3) > 3


@pytest.mark.parametrize("target", ["FLT3-ITD_exons_13-15",
                                    "NPM1_4ins_exons_10-11utr",
                                    "DNMT3A_R882_exon_23"])
def test_min_cov_matches_km_tpu(target):
    args = Namespace(jellyfish_fn=[f"{REFDATA}/jf/"],
                     target_fn=f"{CATALOG}/{target}.fa")
    got, _ = run_tool(main_min_cov, args)
    want, _ = run_tool(km_min_cov, args)
    assert got == want
    rows = {line.split("\t")[0].split("/")[-1]: line.split("\t")[1:]
            for line in got.split("\n")[1:] if line}
    assert len(rows) == 5
    if target.startswith("FLT3-ITD"):
        assert rows["03H112_IandI.jf"] == ["275596", "345", "618", "1368",
                                           "874.91", "315", "0"]
    # a sequence given on the command line instead of a file
    seq = Namespace(jellyfish_fn=[f"{REFDATA}/jf/03H116_ITD.jf"],
                    target_fn="ACGT" * 12)
    assert run_tool(main_min_cov, seq)[0] == run_tool(km_min_cov, seq)[0]


def test_load_table_reads_both_formats_like_km_tpu(tmp_path):
    jf = f"{REFDATA}/jf/03H116_ITD.jf"
    mine, theirs = load_table(jf), km_load_table(jf)
    npz = str(tmp_path / "t.npz")
    theirs.save(npz)
    for table in (mine, load_table(npz)):
        np.testing.assert_array_equal(table.keys, theirs.keys)
        np.testing.assert_array_equal(table.counts, theirs.counts)
    assert (mine.name, load_table(npz).name) == (jf, npz)
    assert km_load_table(npz).name == npz
    seq = "ACGT" * 12
    assert coverage_stats(mine, seq) == km_coverage_stats(theirs, seq)


# -- the argument schema -----------------------------------------------------


def _options(add_args):
    parser = argparse.ArgumentParser()
    add_args(parser)
    return {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.choices
                     and tuple(a.choices), a.type and a.type.__name__
                     if not isinstance(a.type, argparse.FileType)
                     else "FileType", type(a).__name__)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("name", ["find_mutation", "find_report",
                                  "linear_kmin", "min_cov", "count",
                                  "cohort"])
def test_schema_matches_km_tpu(name):
    """The same options with the same flags, defaults, arities and
    types, count's --mode among them. The port's own: --device is
    cuda/cpu/host with cuda the default, on count and cohort, cohort
    takes count's --mode for the samples it counts, and count takes
    jellyfish's -s/--size, the chunked mode's ceiling."""
    mine = _options(getattr(schemas, "add_%s_args" % name))
    theirs = _options(getattr(km_schemas, "add_%s_args" % name))
    device = mine.pop("device", None)
    theirs_device = theirs.pop("device", None)
    if name == "count":
        assert mine["mode"] == theirs["mode"] == (
            ("--mode",), "auto", None, ("auto", "stream", "chunked"), None,
            "_StoreAction")
        assert theirs_device[3] == ("auto", "tpu", "cpu", "host")
        assert mine.pop("size") == (("-s", "--size"), None, None, None,
                                    "int", "_StoreAction")
        assert "size" not in theirs
    if name == "cohort":
        assert mine.pop("mode") == _options(schemas.add_count_args)["mode"]
    assert list(mine) == list(theirs)
    for dest in mine:
        a, b = mine[dest], theirs[dest]
        if a[4] == "<lambda>":
            a, b = a[:1] + a[2:4], b[:1] + b[2:4]  # default: an open file
        assert a == b, dest
    if name in ("count", "cohort"):
        assert device == (("--device",), "cuda", None,
                          ("cuda", "cpu", "host"), None, "_StoreAction")
    else:
        assert device is None and theirs_device is None


def test_schema_parses_a_command_line_like_km_tpu(tmp_path):
    target = f"{CATALOG}/FLT3-TKD_exon_20.fa"
    jf = f"{REFDATA}/jf/03H116_ITD.jf"
    argv = ["-c", "7", "-p", "0.1", "-s", "40", "--batch", target, jf]
    got, want = argparse.ArgumentParser(), argparse.ArgumentParser()
    schemas.add_find_mutation_args(got)
    km_schemas.add_find_mutation_args(want)
    assert vars(got.parse_args(argv)) == vars(want.parse_args(argv))
    # find_report's -t must name a file: both parsers exit on one that
    # does not exist
    for mod in (schemas, km_schemas):
        parser = argparse.ArgumentParser()
        mod.add_find_report_args(parser)
        assert parser.parse_args(["-t", target]).target == target
        with pytest.raises(SystemExit):
            parser.parse_args(["-t", str(tmp_path / "missing.fa")])


# -- nothing of the port imports km_tpu --------------------------------------


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for base, _dirs, names in os.walk(os.path.join(REPO, "km_tpu_torch")):
        paths += [os.path.join(base, n) for n in names if n.endswith(".py")]
    return sorted(paths)


def test_no_source_of_the_port_imports_km_tpu():
    pattern = re.compile(
        r"^\s*(from|import)\s+(km_tpu|jax)(\.|\s|$)|"
        r"import_module\(\s*['\"](km_tpu|jax)['\".]|"
        r"__import__\(\s*['\"](km_tpu|jax)['\".]", re.M)
    paths = _port_sources()
    assert len(paths) > 40
    bad = []
    for path in paths:
        with open(path) as f:
            for m in pattern.finditer(f.read()):
                bad.append((os.path.relpath(path, REPO), m.group(0).strip()))
    assert bad == []


def _small_fastq(path):
    rng = np.random.default_rng(9)
    with open(path, "w") as f:
        for i in range(60):
            seq = "".join(rng.choice(list("ACGT"), 80))
            f.write("@r%d\n%s\n+\n%s\n" % (i, seq, "I" * 80))


SUBCOMMANDS = {
    "count": lambda tmp: ["count", "--device", "cpu", "-k", "31", "-o",
                          f"{tmp}/t.npz", f"{tmp}/reads.fq"],
    "count_chunked": lambda tmp: ["count", "--device", "cpu", "--mode",
                                  "chunked", "-k", "31", "-o",
                                  f"{tmp}/t.npz", f"{tmp}/reads.fq"],
    "count_host": lambda tmp: ["count", "--device", "host", "-o",
                               f"{tmp}/t.jf", f"{tmp}/reads.fq"],
    "find_mutation": lambda tmp: [
        "find_mutation", f"{CATALOG}/FLT3-TKD_exon_20.fa",
        f"{REFDATA}/jf/05H094_FLT3-TKD_del.jf"],
    "find_mutation_batch": lambda tmp: [
        "find_mutation", "--batch", "--device", "cpu",
        f"{CATALOG}/FLT3-TKD_exon_20.fa",
        f"{REFDATA}/jf/05H094_FLT3-TKD_del.jf"],
    "find_report": lambda tmp: [
        "find_report", "-t", f"{CATALOG}/FLT3-TKD_exon_20.fa",
        f"{tmp}/fm.tsv"],
    "cohort": lambda tmp: [
        "cohort", "--device", "cpu", "-t", f"{CATALOG}/FLT3-TKD_exon_20.fa",
        "-o", f"{tmp}/cohort", f"{REFDATA}/jf/05H094_FLT3-TKD_del.jf"],
    "linear_kmin": lambda tmp: ["linear_kmin", CATALOG],
    "min_cov": lambda tmp: ["min_cov", f"{CATALOG}/FLT3-TKD_exon_20.fa",
                            f"{REFDATA}/jf/"],
}


@pytest.mark.parametrize("name", sorted(SUBCOMMANDS))
def test_subcommand_loads_nothing_of_km_tpu(name, tmp_path):
    """``python -m km_tpu_torch <subcommand>`` as a user runs it, in a
    fresh process: at its end no module named km_tpu, km_tpu.* or jax is
    loaded."""
    _small_fastq(tmp_path / "reads.fq")
    (tmp_path / "fm.tsv").write_text(_golden_fm("FLT3_TKD"))
    code = (
        "import runpy, sys\n"
        "sys.argv = ['km_tpu_torch'] + %r\n"
        "try:\n"
        "    runpy.run_module('km_tpu_torch', run_name='__main__')\n"
        "except SystemExit as exc:\n"
        "    assert not exc.code, exc.code\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('km_tpu', 'jax'))\n"
        "assert not bad, bad\n"
        "assert 'km_tpu_torch.cli' in sys.modules\n"
        "print('NO_KM_TPU')\n" % (SUBCOMMANDS[name](str(tmp_path)),))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.rstrip().endswith("NO_KM_TPU")
    assert len(proc.stdout.splitlines()) > 1 or name.startswith("co")


def test_packaging_names_the_new_subpackages_and_sources():
    """pyproject.toml finds km_tpu_torch.io and km_tpu_torch.native, and
    ships the sources that are built at first use as package data."""
    import glob
    import tomllib

    from setuptools import find_packages

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        tool = tomllib.load(f)["tool"]["setuptools"]
    found = find_packages(REPO, include=tool["packages"]["find"]["include"])
    for name in ("io", "native", "models", "ops", "tools", "parallel",
                 "argparsing", "utils", "scripts"):
        assert "km_tpu_torch." + name in found
    shipped = [os.path.relpath(p, os.path.join(REPO, "km_tpu_torch"))
               for pattern in tool["package-data"]["km_tpu_torch"]
               for p in glob.glob(os.path.join(REPO, "km_tpu_torch", pattern))]
    assert sorted(shipped) == ["csrc/merge_runs.cu", "csrc/pack.cu",
                               "csrc/parse_fastq.cu", "csrc/sort_runs.cu",
                               "native/kmio.cpp"]
