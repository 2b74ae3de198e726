#!/usr/bin/env python3
"""Smoke run of km_tpu_torch on one CUDA card, from the repo root:

    python3 chip_smoke.py

Builds the two CUDA kernels from km_tpu_torch/csrc, holds each against
its plain torch version at the main path's shapes, then drives the
user's workflow through the port's CLI at the size of one RNA-seq
sample: ``count`` a synthetic FASTQ of 2^30 bases on the card,
``find_mutation --batch`` with the table resident on the card, then
``find_report``; then the five bundled golden cases with a CUDA table.
Every phase prints one line; any failure raises and the exit code is
non-zero. Needs no JAX. The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

``--log2-bases`` cuts the sample (default 30), for a short first run
after a kernel change.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
K = 31
READ_LEN = 100
SUB_RATE = 1e-3
TRANSCRIPTOME = 1 << 24
NPM1_TARGET = "NPM1_4ins_exons_10-11utr"
NPM1_INSERT = (44, "TCTG")  # the NPM1 type-A duplication of the fixture
NPM1_COVERAGE = 200
FLANK = 100
GOLDEN = {
    "NPM1": ("NPM1_4ins_exons_10-11utr", "02H025_NPM1"),
    "FLT3_ITD": ("FLT3-ITD_exons_13-15", "03H116_ITD"),
    "FLT3_IandI": ("FLT3-ITD_exons_13-15", "03H112_IandI"),
    "FLT3_TKD": ("FLT3-TKD_exon_20", "05H094_FLT3-TKD_del"),
    "DNMT3A": ("DNMT3A_R882_exon_23", "02H033_DNMT3A_sub"),
}


def say(phase: str, **fields) -> None:
    print("phase %s: %s" % (phase, json.dumps(fields)), flush=True)


def cuda_time_ms(fn, iters: int = 10) -> float:
    """Mean device time of fn() over iters launches, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


# ---------------------------------------------------------------------------
# kernels against their plain versions


def kernel_pack(device, n: int = 1 << 24) -> dict:
    import torch

    from km_tpu_torch.ops import pack

    rng = np.random.default_rng(1)
    codes = torch.from_numpy(rng.integers(0, 4, n, dtype=np.uint8)).to(device)
    valid = torch.from_numpy(rng.random(n) > 0.02).to(device)
    err = 0.0
    for k in (2, 16, 21, 31):
        for canonical in (True, False):
            got = pack.pack_canonical_windows(codes, valid, k, canonical)
            want = pack.pack_canonical_windows_plain(codes, valid, k,
                                                     canonical)
            if not torch.equal(got, want):
                raise AssertionError(
                    "pack kernel != plain at k=%d canonical=%s: %d of %d "
                    "keys differ" % (k, canonical,
                                     int((got != want).sum()), n))
            err = max(err, max_abs_err(got, want))
    ms = cuda_time_ms(lambda: pack.pack_canonical_windows(codes, valid, K))
    plain_ms = cuda_time_ms(
        lambda: pack.pack_canonical_windows_plain(codes, valid, K))
    return dict(n=n, max_abs_err=err, ms=ms, plain_ms=plain_ms)


def kernel_sort_runs(device, n: int = 1 << 24) -> dict:
    import torch

    from km_tpu_torch.device import SENTINEL
    from km_tpu_torch.ops import sort_runs

    rng = np.random.default_rng(2)
    keys = rng.integers(0, 1 << 10, n).astype(np.int64) << 40  # heavy ties
    keys[rng.random(n) < 0.05] = SENTINEL
    keys = torch.from_numpy(keys).to(device)
    got_k, got_l = sort_runs.sort_chunks_runs(keys)
    want_k, want_l = sort_runs.sort_chunks_runs_plain(keys)
    if not (torch.equal(got_k, want_k) and torch.equal(got_l, want_l)):
        raise AssertionError(
            "sort_runs kernel != plain: %d keys, %d lengths differ"
            % (int((got_k != want_k).sum()), int((got_l != want_l).sum())))
    err = max(max_abs_err(got_k, want_k), max_abs_err(got_l, want_l))
    ms = cuda_time_ms(lambda: sort_runs.sort_chunks_runs(keys))
    plain_ms = cuda_time_ms(lambda: sort_runs.sort_chunks_runs_plain(keys))
    return dict(n=n, chunk=sort_runs.CHUNK, max_abs_err=err, ms=ms,
                plain_ms=plain_ms)


# ---------------------------------------------------------------------------
# the synthetic sample


def npm1_sequences():
    from km_tpu.io.fasta import read_target
    from km_tpu.refdata import catalog_fa

    path = catalog_fa(NPM1_TARGET)
    seqs, _ = read_target(path)
    ref = "".join(seqs)
    pos, ins = NPM1_INSERT
    return path, ref, ref[:pos] + ins + ref[pos:]


def write_fastq(path: str, n_bases: int, seed: int) -> int:
    """FASTQ of 100-bp reads, about n_bases in all: reads from a random
    2^24-base transcriptome, plus reads of the NPM1 target and of the
    target with a 4-base insertion, 50/50, at about 200x (each in random
    100-bp flanks so whole reads cover it); every base substituted at
    rate 1e-3. Records are assembled as fixed-width byte rows. Returns
    the number of reads."""
    from km_tpu.ops.encode import seq_to_codes

    rng = np.random.default_rng(seed)
    transcriptome = rng.integers(0, 4, TRANSCRIPTOME, dtype=np.uint8)
    _path, ref, alt = npm1_sequences()
    flank_l = rng.integers(0, 4, FLANK, dtype=np.uint8)
    flank_r = rng.integers(0, 4, FLANK, dtype=np.uint8)
    alleles = [np.concatenate([flank_l, seq_to_codes(s), flank_r])
               for s in (ref, alt)]
    n_npm1 = NPM1_COVERAGE * len(alleles[0]) // READ_LEN
    n_bg = n_bases // READ_LEN - n_npm1
    n_reads = n_bg + n_npm1

    bases = np.frombuffer(b"ACGT", np.uint8)
    head, sep, tail = 12, 3, 1  # "@r%09d\n", "\n+\n", "\n"
    width = head + READ_LEN + sep + READ_LEN + tail
    qual = np.frombuffer(b"I" * READ_LEN, np.uint8)
    block = 1 << 18
    with open(path, "wb") as f:
        for lo in range(0, n_reads, block):
            ids = np.arange(lo, min(lo + block, n_reads))
            seqs = np.empty((len(ids), READ_LEN), np.uint8)
            bg = ids < n_bg
            offs = rng.integers(0, TRANSCRIPTOME - READ_LEN, int(bg.sum()))
            seqs[bg] = transcriptome[offs[:, None] + np.arange(READ_LEN)]
            for idx in np.flatnonzero(~bg):
                allele = alleles[(ids[idx] - n_bg) % 2]
                o = int(rng.integers(0, len(allele) - READ_LEN + 1))
                seqs[idx] = allele[o:o + READ_LEN]
            flat = seqs.reshape(-1)
            n_sub = rng.binomial(flat.size, SUB_RATE)
            at = rng.integers(0, flat.size, n_sub)
            flat[at] = (flat[at] + rng.integers(1, 4, n_sub)) % 4

            rec = np.empty((len(ids), width), np.uint8)
            rec[:, 0] = ord("@")
            rec[:, 1] = ord("r")
            digits = (ids[:, None] // 10 ** np.arange(8, -1, -1)) % 10
            rec[:, 2:11] = digits + ord("0")
            rec[:, 11] = ord("\n")
            rec[:, head:head + READ_LEN] = bases[seqs]
            s = head + READ_LEN
            rec[:, s:s + sep] = np.frombuffer(b"\n+\n", np.uint8)
            rec[:, s + sep:s + sep + READ_LEN] = qual
            rec[:, -1] = ord("\n")
            f.write(rec.tobytes())
    return n_reads


# ---------------------------------------------------------------------------
# the main path through the CLI


def run_cli(argv) -> tuple[str, object]:
    from km_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = cli.main(argv)
    return out.getvalue(), ret


def rows_of(text: str):
    return [line.split("\t") for line in text.splitlines()
            if line and not line.startswith("#")][1:]


def phase_count(device, workdir: str, log2_bases: int, seed: int) -> dict:
    import torch

    fq = os.path.join(workdir, "sample.fastq")
    npz = os.path.join(workdir, "sample.npz")
    t0 = time.perf_counter()
    n_reads = write_fastq(fq, 1 << log2_bases, seed)
    synth_s = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _, stats = run_cli(["count", "--device", device.type, "-k", str(K),
                        "-L", "2", "-Q", "+", "-o", npz, fq])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    windows = n_reads * (READ_LEN - K + 1)
    if stats["total"] != windows:
        raise AssertionError("counts sum to %d, expected %d valid windows"
                             % (stats["total"], windows))
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    return dict(fastq=fq, table=npz, reads=n_reads,
                bases=n_reads * READ_LEN, fastq_bytes=os.path.getsize(fq),
                synth_s=synth_s, count_s=stats["seconds"],
                kmers_per_s=windows / stats["seconds"],
                distinct_before_L=stats["unique"],
                distinct=stats["distinct"], slots=stats["capacity"],
                retries=stats["retries"], chunks=stats["chunks"],
                input_s=stats["input_s"],
                peak_device_bytes=peak)


def phase_find_mutation(device, workdir: str, table: str) -> dict:
    target, _ref, alt = npm1_sequences()
    t0 = time.perf_counter()
    fm, _ = run_cli(["find_mutation", "--batch", "--device", device.type,
                     target, table])
    fm_s = time.perf_counter() - t0
    fm_path = os.path.join(workdir, "npm1.find_mutation.tsv")
    with open(fm_path, "w") as f:
        f.write(fm)
    report, _ = run_cli(["find_report", "-t", target, fm_path])
    total_s = time.perf_counter() - t0
    hits = [r for r in rows_of(fm) if r[2] == "Insertion" and r[8] == alt
            and r[11] == "vs_ref"]
    if not hits:
        raise AssertionError("planted insertion not found:\n" + fm)
    rvaf = float(hits[0][4])
    if not 0.3 < rvaf < 0.7:
        raise AssertionError("rVAF %.3f outside 0.3-0.7" % rvaf)
    reported = [r for r in (line.split("\t")
                            for line in report.splitlines()[1:])
                if len(r) > 3 and r[3] != "Reference"]
    if not reported:
        raise AssertionError("find_report produced no row:\n" + report)
    return dict(variant=hits[0][3], rvaf=rvaf, report_type=reported[0][3],
                find_mutation_s=fm_s, with_report_s=total_s)


def phase_count_slice(device, fastq: str) -> dict:
    """A 2^24-base slice of the sample counted by the port and by
    km_tpu's numpy spec: identical keys and counts."""
    from km_tpu.io.fastq import read_batches
    from km_tpu.ops.count import count_batches_host

    from km_tpu_torch.ops.count import count_batches_device_stream

    batches, total = [], 0
    for codes, valid in read_batches([fastq], min_quality="+"):
        take = min(len(codes), (1 << 24) - total)
        batches.append((codes[:take], valid[:take]))
        total += take
        if total >= 1 << 24:
            break
    hk, hc = count_batches_host(iter(batches), K, min_count=1)
    dk, dc = count_batches_device_stream(iter(batches), K, min_count=1,
                                         capacity=1 << 25, device=device)
    if not (np.array_equal(hk, dk) and np.array_equal(hc, dc)):
        raise AssertionError("slice counts differ from count_batches_host")
    return dict(bases=total, distinct=len(hk))


def phase_golden(device) -> dict:
    from km_tpu.refdata import DATA_DIR, catalog_fa, jf_path

    matched = []
    for case, (target, sample) in GOLDEN.items():
        fm, _ = run_cli(["find_mutation", "--batch", "--device",
                         device.type, catalog_fa(target), jf_path(sample)])
        stable = "\n".join(line for line in fm.split("\n")
                           if not line.startswith("#"))
        with open(os.path.join(REPO, "tests", "golden",
                               case + ".find_mutation.tsv")) as f:
            want = f.read().replace("/root/reference/data", DATA_DIR)
        if stable != want:
            raise AssertionError("golden %s differs:\n%s" % (case, stable))
        matched.append(case)
    return dict(matched=matched)


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log2-bases", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    opts = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from km_tpu import native
    from km_tpu_torch import _build
    from km_tpu_torch.device import resolve_device
    from km_tpu_torch.ops import pack, sort_runs

    device = resolve_device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    say("device", kind=kind, count=torch.cuda.device_count(), smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)

    secs, log = _build.build(ptxas_verbose=True)
    _build.lib()
    say("build", seconds=secs,
        ptxas=[line for line in log.splitlines() if "Used" in line])
    kernels = {"pack": kernel_pack(device)}
    say("kernel_pack", **kernels["pack"])
    kernels["sort_runs"] = kernel_sort_runs(device)
    say("kernel_sort_runs", **kernels["sort_runs"])

    if not native.available():
        raise RuntimeError("km_tpu.native (libkmio.so) did not build: "
                           "FASTQ parsing would crawl")
    workdir = tempfile.mkdtemp(prefix="km_tpu_torch_smoke_")
    try:
        # the main path: count, then find_mutation --batch | find_report
        pack.pack_canonical_windows.launches = 0
        sort_runs.sort_chunks_runs.launches = 0
        counted = phase_count(device, workdir, opts.log2_bases, opts.seed)
        say("count", **counted)
        say("find_mutation",
            **phase_find_mutation(device, workdir, counted["table"]))
        launches = {"pack": pack.pack_canonical_windows.launches,
                    "sort_runs": sort_runs.sort_chunks_runs.launches}
        say("launches", **launches)
        if min(launches.values()) == 0:
            raise AssertionError("a kernel of the path was not launched: "
                                 "%s" % launches)
        say("count_slice", **phase_count_slice(device, counted["fastq"]))
        say("golden", **phase_golden(device))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    jax_modules = sorted(m for m in sys.modules if m.split(".")[0] == "jax")
    if jax_modules:
        raise AssertionError("JAX was imported: %s" % jax_modules[:5])
    say("no_jax", modules=len(sys.modules))

    replaces = {"pack": "km_tpu/ops/pallas_pack.py:77",
                "sort_runs": "km_tpu/ops/pallas_sort.py:102"}
    report = [dict(name=name, route="cuda",
                   source="km_tpu_torch/csrc/%s.cu" % name,
                   replaces=replaces[name],
                   launches=launches[name],
                   max_abs_err=m["max_abs_err"], ms=m["ms"],
                   plain_ms=m["plain_ms"])
              for name, m in kernels.items()]
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
