#!/usr/bin/env python3
"""Smoke run of km_tpu_torch on one CUDA card, from the repo root:

    python3 chip_smoke.py

Builds the CUDA kernels from km_tpu_torch/csrc and the native host
library from km_tpu_torch/native, and holds each kernel against its
plain torch version at 2^24 keys (the window pack and the chunk sort
with runs at the main path's shapes; the chunk sort without runs, which
no path calls, in its own phase) and on the edge shapes a kernel is most
likely to get wrong (every chunk size, ragged and unaligned inputs, all
keys equal, all sentinels, sorted and reverse sorted; every k of
1, 2, 15, 16, 17, 31, n below k, invalid bases at tile and thread-run
boundaries). The two merge kernels (the chunk's runs, the accumulator
merge) are held against theirs at the sample's shape (2.6e7 keys in 2^26
slots, one chunk of 2^24 windows), at scale_count's (a chunk whose
windows are nearly all distinct) and on the cases of
km_tpu_torch/scripts/merge_cases.py, and timed beside the torch merge
they replace (the chunk's runs also beside torch.unique). The
``min_count`` cut (C1) is held against its plain version on its edge
cases and on an accumulator of 2^26 slots, 41% of the live records
kept, and timed against its bytes bound. Then drives the user's workflow
through the port's CLI at the size of one RNA-seq sample: ``count`` a
synthetic FASTQ of 2^30 bases on the card, ``find_mutation --batch``
with the table resident on the card (the walk, the Dijkstra sweeps and
the NNLS refinement on the card), then ``find_report``, each timed
beside the port's host path (``--device host``). Then a 400-target
catalog on the card against the host path, warm through ``run_catalog``
and cold through the CLI (table load and upload included). Then the
entry points for counting and walking at scale: ``count --mode chunked``
through the CLI on the sample's first 2^28 bases (its table equal to
``--mode stream``'s), ``scripts.scale_count`` (2^30 bases synthesized and
counted on the card, every window accounted for) and
``scripts.bigtable_walk`` (the 400-target catalog against the fixture
united with 1e8 random below-threshold k-mers, host and device rows equal
to the fixture-only rows). Then the
scale-out layer on an NCCL group of one process (``sharded``: the
sharded count of a 2^28-base prefix against the single-device stream,
the sharded table's routed and broadcast lookups against the resident
table, one full step on a 1x1 mesh against its host recomputation),
``cohort`` under torchrun on the 9 catalog targets against the FASTQ,
its counted table and a fixture (reports equal to the port's pipe and to
a ``--device host`` cohort), and the five bundled golden cases with a
CUDA table. Every phase prints one
line; any failure raises and the exit code is non-zero. Needs no JAX and
nothing of km_tpu: the run fails if a module of either is loaded at its
end. The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

``--log2-bases`` cuts the sample (default 30), and ``--kernels-only``
stops after the build and the kernel phases (and prints no result line),
for a short first run after a kernel change. ``--compare-modes`` is a
measurement, not a check of the smoke: after the builds it counts the
whole sample with ``count --mode chunked`` and ``--mode stream`` in
turns, each in a process of its own so that each has its own peak RSS,
requires equal tables, prints the seconds, and stops.
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
CATALOG_TARGETS = 400
CATALOG_SAMPLE = "03H116_ITD"
SCALE_CHUNKS = 64  # of 2^24 bases: scale_count's full default
SCALE_CAPACITY = 1 << 23
BIGTABLE_EXTRA = 100_000_000
# one FASTQ record of write_fastq: "@r%09d\n", the read, "\n+\n", the
# qualities, "\n"
RECORD_BYTES = 12 + READ_LEN + 3 + READ_LEN + 1
SHARDED_BASES = 1 << 28
SHARDED_QUERIES = 1 << 22
FULL_STEP_QUERIES = 1 << 20
COHORT_TIMEOUT_S = 600
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
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


def device_times(fn) -> dict:
    """Device ms per kernel of one fn() call after a warm-up, from
    torch.profiler; {} where the profiler sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        name = e.key.replace("(anonymous namespace)::", "")
        name = name.split("(")[0].split("<")[0][:48]
        if us:
            out[name] = out.get(name, 0.0) + us / 1e3
    return out


def max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


# ---------------------------------------------------------------------------
# kernels against their plain versions


def bound_ms(n_bytes: int) -> float:
    """The least time the card could take to move n_bytes once."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


def pack_edges(device) -> int:
    """The pack kernel against its plain version where a rolling key is
    most likely to go wrong; returns the number of cases held equal."""
    import torch

    from km_tpu_torch.ops import pack

    rng = np.random.default_rng(11)
    tile, run = 4096, 16  # windows per block and per thread in pack.cu
    cases = 0
    for n in (1, 14, 30, 4095, 4096, 4097, 3 * tile + 1234 + 7):
        codes = rng.integers(0, 256, n + 3).astype(np.uint8)  # & 3 applies
        valid = np.ones(n + 3, bool)
        # invalid bases at tile and thread-run boundaries, and a few more
        for at in (0, run - 1, run, run + 1, tile - 1, tile, tile + 1,
                   2 * tile - run, 2 * tile + run, n - 1, n):
            if 0 <= at < n + 3:
                valid[at] = False
        valid[rng.integers(0, n + 3, max(n // 97, 1))] = False
        inputs = {
            "aligned": (codes[:n], valid[:n]),
            # views that start 1 and 3 bytes into their buffers
            "unaligned": (None, None),
            "all_invalid": (codes[:n], np.zeros(n, bool)),
            "all_valid": (codes[:n], np.ones(n, bool)),
            "uint8_flags": (codes[:n], valid[:n].astype(np.uint8)),
        }
        for name, (c, v) in inputs.items():
            if name == "unaligned":
                tc = torch.from_numpy(codes).to(device)[1:n + 1]
                tv = torch.from_numpy(valid).to(device)[3:n + 3]
            else:
                tc = torch.from_numpy(np.ascontiguousarray(c)).to(device)
                tv = torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k in (1, 2, 15, 16, 17, 31):
                for canonical in (True, False):
                    got = pack.pack_canonical_windows(tc, tv, k, canonical)
                    want = pack.pack_canonical_windows_plain(tc, tv, k,
                                                             canonical)
                    if not torch.equal(got, want):
                        raise AssertionError(
                            "pack kernel != plain: n=%d %s k=%d canonical=%s,"
                            " %d keys differ" % (n, name, k, canonical,
                                                 int((got != want).sum())))
                    cases += 1
    return cases


def kernel_pack(device, n: int = 1 << 24) -> dict:
    import torch

    from km_tpu_torch.ops import pack

    edge_cases = pack_edges(device)
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
    # a code byte and a flag byte in, an 8-byte key out
    bound = bound_ms(n * (1 + 1 + 8))
    return dict(n=n, edge_cases=edge_cases, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                share_of_bound=bound / ms, library_ms=None)


def sort_edge_inputs(rng, n: int) -> dict:
    from km_tpu_torch.device import SENTINEL

    ties = rng.integers(0, 1 << 6, n).astype(np.int64) << 40
    ties[rng.random(n) < 0.05] = SENTINEL
    wide = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    ramp = np.sort(rng.integers(0, 1 << 62, n).astype(np.int64))
    return {"ties": ties, "wide": wide,
            "all_equal": np.full(n, 12345, np.int64),
            "all_sentinels": np.full(n, SENTINEL, np.int64),
            "sorted": ramp, "reversed": ramp[::-1].copy()}


def sort_edges(device) -> int:
    """Both modes of the chunk sort against their plain versions at every
    accepted chunk size, on whole, ragged and unaligned inputs; returns
    the number of cases held equal."""
    import torch

    from km_tpu_torch.ops import sort_runs

    rng = np.random.default_rng(12)
    cases = 0
    chunk = sort_runs.MIN_CHUNK
    while chunk <= sort_runs.CHUNK:
        # n: one key, under a chunk and not a multiple of 16 or of 2,
        # whole chunks, and a ragged tail
        for n in (1, chunk - 37, 2 * chunk, 3 * chunk + chunk // 3 + 5):
            for name, keys in sort_edge_inputs(rng, n + 1).items():
                buf = torch.from_numpy(keys).to(device)
                # the second view starts 8 bytes into its buffer
                for view in (buf[:n].clone(), buf[1:]):
                    got_k, got_l = sort_runs.sort_chunks_runs(view, chunk)
                    want_k, want_l = sort_runs.sort_chunks_runs_plain(view,
                                                                      chunk)
                    got = sort_runs.sort_chunks(view, chunk)
                    if not (torch.equal(got_k, want_k)
                            and torch.equal(got_l, want_l)
                            and torch.equal(got, want_k)):
                        raise AssertionError(
                            "chunk sort != plain: chunk=%d n=%d %s, %d keys "
                            "and %d lengths differ with runs, %d keys without"
                            % (chunk, n, name, int((got_k != want_k).sum()),
                               int((got_l != want_l).sum()),
                               int((got != want_k).sum())))
                    cases += 1
        chunk *= 2
    return cases


def kernel_sort_runs(device, n: int = 1 << 24) -> dict:
    import torch

    from km_tpu_torch.device import SENTINEL
    from km_tpu_torch.ops import sort_runs

    edge_cases = sort_edges(device)
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
    # an 8-byte key in, an 8-byte key and a 4-byte run length out
    bound = bound_ms(n * (8 + 8 + 4))
    return dict(n=n, chunk=sort_runs.CHUNK, edge_cases=edge_cases,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes", share_of_bound=bound / ms, library_ms=None)


def kernel_sort_chunks(device, n: int = 1 << 24) -> dict:
    import torch

    from km_tpu_torch.device import SENTINEL
    from km_tpu_torch.ops import sort_runs

    rng = np.random.default_rng(3)
    keys = rng.integers(0, 1 << 10, n).astype(np.int64) << 40  # heavy ties
    keys[rng.random(n) < 0.05] = SENTINEL
    keys = torch.from_numpy(keys).to(device)
    got = sort_runs.sort_chunks(keys)
    want = sort_runs.sort_chunks_plain(keys)
    if not torch.equal(got, want):
        raise AssertionError("sort_chunks kernel != plain: %d keys differ"
                             % int((got != want).sum()))
    ms = cuda_time_ms(lambda: sort_runs.sort_chunks(keys))
    plain_ms = cuda_time_ms(lambda: sort_runs.sort_chunks_plain(keys))
    # the one PyTorch call for the same function; the port never calls it
    library_ms = cuda_time_ms(
        lambda: torch.sort(keys.view(-1, sort_runs.CHUNK), dim=1))
    bound = bound_ms(n * (8 + 8))  # an 8-byte key in and out
    return dict(n=n, chunk=sort_runs.CHUNK,
                max_abs_err=max_abs_err(got, want), ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by="bytes", share_of_bound=bound / ms,
                library_ms=library_ms,
                launches=sort_runs.sort_chunks.launches)


def old_chunk_runs(keys, lengths):
    """The chunk's runs as the port summed them before M1 (a sort of the
    live run starts and an index_add_), timed for the record."""
    from km_tpu_torch.ops.count import sum_runs_device

    live = lengths > 0
    skeys, totals = sum_runs_device(keys[live], lengths[live])
    first = totals > 0
    return skeys[first], totals[first]


def old_merge_accum(acc_keys, acc_cnt, keys, lengths):
    """The stream's merge as the port did it before M1 and M2 (km_tpu's
    XLA program in torch: the padded accumulator and the chunk
    concatenated, re-sorted, summed with index_add_, compacted), timed
    for the record."""
    import torch

    from km_tpu_torch.device import SENTINEL
    from km_tpu_torch.ops.count import sum_runs_device

    C = acc_keys.numel()
    k = torch.cat([acc_keys, keys])
    c = torch.cat([acc_cnt, lengths.to(torch.int64)])
    k = torch.where(c == 0, torch.full_like(k, SENTINEL), k)
    skeys, tot = sum_runs_device(k, c)
    alive = (tot > 0) & (skeys != SENTINEL)
    dest = torch.cumsum(alive, 0) - 1
    slot = torch.where(alive & (dest < C), dest, torch.full_like(dest, C))
    out_keys = torch.full((C + 1,), SENTINEL, dtype=torch.int64,
                          device=keys.device)
    out_cnt = torch.zeros(C + 1, dtype=torch.int64, device=keys.device)
    out_keys.scatter_(0, slot, skeys)
    out_cnt.scatter_(0, slot, tot)
    return out_keys[:C], out_cnt[:C], alive.sum()


def check_chunk_runs(runs, sort_chunk: int, what: str):
    """M1 against its plain version on the same input; returns the
    kernel's (keys, counts, m) and the largest absolute difference of
    its live keys and counts from the plain version's."""
    import torch

    from km_tpu_torch.ops import merge

    got = merge.chunk_runs(*runs, sort_chunk)
    want = merge.chunk_runs_plain(*runs, sort_chunk)
    m = int(want[2])
    if not (int(got[2]) == m and torch.equal(got[0][:m], want[0][:m])
            and torch.equal(got[1][:m], want[1][:m])):
        raise AssertionError("chunk_runs kernel != plain (%s): m %d vs %d"
                             % (what, int(got[2]), m))
    err = max(max_abs_err(got[0][:m], want[0][:m]),
              max_abs_err(got[1][:m], want[1][:m]))
    return got, err


def check_merge_accum(acc, runs, what: str):
    """M2 against its plain version on the same input, each into a new
    empty accumulator; returns the kernel's (keys, counts, n_unique) and
    the largest absolute difference of its output from the plain
    version's."""
    import torch

    from km_tpu_torch.ops import merge
    from km_tpu_torch.ops.count import empty_accumulator

    outs = []
    for fn in (merge.merge_accum, merge.merge_accum_plain):
        out = empty_accumulator(acc[0].numel(), acc[0].device)
        fn(*acc, *runs, *out)
        outs.append(out)
    if not all(torch.equal(a, b) for a, b in zip(*outs)):
        raise AssertionError("merge_accum kernel != plain (%s): n_unique "
                             "%d vs %d, %d keys differ"
                             % (what, int(outs[0][2]), int(outs[1][2]),
                                int((outs[0][0] != outs[1][0]).sum())))
    return outs[0], max(max_abs_err(a, b) for a, b in zip(*outs))


def merge_edges(device, kernel: str) -> int:
    """M1 or M2 against its plain version on every edge case (each case
    at its piece size, and a ragged input at every piece size); returns
    the number of cases held equal."""
    from km_tpu_torch.ops import merge
    from km_tpu_torch.scripts import merge_cases as mc

    cases = ([(name, mc.piece_size(name)) for name in mc.CASES + mc.CARD_CASES]
             + [("ragged", sc) for sc in mc.SORT_CHUNKS])
    for name, sc in cases:
        acc, counts, chunk, C = mc.make_case(name, sort_chunk=sc)
        runs = mc.sorted_chunk(chunk, sc, device)
        what = "%s, sort_chunk %d" % (name, sc)
        if kernel == "chunk_runs":
            check_chunk_runs(runs, sc, what)
        else:
            check_merge_accum(mc.accumulator(acc, counts, C, device),
                              merge.chunk_runs_plain(*runs, sc), what)
    return len(cases)


def library_chunk_runs(keys):
    """The one PyTorch call that computes M1's function (the port never
    calls it): torch.unique of the chunk sort's keys gives the chunk's
    distinct keys in order with their window counts, and SENTINEL last
    where there are invalid windows."""
    import torch

    return torch.unique(keys, sorted=True, return_counts=True)


def chunk_runs_fields(runs, what: str) -> dict:
    """M1 on one chunk sort's output: held equal to its plain version and
    to torch.unique, and timed beside both and the old torch form."""
    import torch

    from km_tpu_torch.device import SENTINEL
    from km_tpu_torch.ops import merge
    from km_tpu_torch.ops.sort_runs import CHUNK

    got, err = check_chunk_runs(runs, CHUNK, what)
    n, m = runs[0].numel(), int(got[2])
    lib_k, lib_c = library_chunk_runs(runs[0])
    if lib_k.numel() and int(lib_k[-1]) == SENTINEL:
        lib_k, lib_c = lib_k[:-1], lib_c[:-1]
    if not (torch.equal(lib_k, got[0][:m]) and torch.equal(lib_c, got[1][:m])):
        raise AssertionError("torch.unique differs from chunk_runs (%s): %d "
                             "vs %d keys" % (what, lib_k.numel(), m))
    ms = cuda_time_ms(lambda: merge.chunk_runs(*runs, CHUNK))
    plain_ms = cuda_time_ms(lambda: merge.chunk_runs_plain(*runs, CHUNK),
                            iters=3)
    library_ms = cuda_time_ms(lambda: library_chunk_runs(runs[0]))
    old_ms = cuda_time_ms(lambda: old_chunk_runs(*runs), iters=3)
    live = int((runs[1] > 0).sum())
    # a key and a run length in, a key and an int64 count out per run
    bound = bound_ms(n * (8 + 4) + m * 16)
    return dict(n=n, live_run_starts=live, runs=m, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                share_of_bound=bound / ms, library_ms=library_ms,
                old_torch_ms=old_ms,
                kernels_ms=device_times(
                    lambda: merge.chunk_runs(*runs, CHUNK)))


def kernel_chunk_runs(device, runs, scale_runs) -> dict:
    """M1 at the sample's shape (one chunk of 2^24 windows) and at
    scale_count's (nearly every window of a piece distinct)."""
    edge_cases = merge_edges(device, "chunk_runs")
    out = chunk_runs_fields(runs, "the sample's shape")
    return dict(out, edge_cases=edge_cases,
                at_scale_count=chunk_runs_fields(scale_runs,
                                                 "scale_count's shape"))


def merge_accum_fields(acc, sorted_runs, what: str) -> dict:
    """M2 on one chunk's runs (M1 of the chunk sort's output) into an
    accumulator: held equal to its plain version, and timed beside it,
    the old torch merge, and M1 and M2 together."""
    from km_tpu_torch.ops import merge
    from km_tpu_torch.ops.count import empty_accumulator
    from km_tpu_torch.ops.sort_runs import CHUNK

    runs = merge.chunk_runs(*sorted_runs, CHUNK)
    got, err = check_merge_accum(acc, runs, what)
    slots = acc[0].numel()
    la, m, nu = int(acc[2]), int(runs[2]), int(got[2])
    out = empty_accumulator(slots, acc[0].device)
    ms = cuda_time_ms(lambda: merge.merge_accum(*acc, *runs, *out))
    plain_ms = cuda_time_ms(
        lambda: merge.merge_accum_plain(*acc, *runs, *out), iters=3)
    # what the stream did per chunk before: the old chunk-and-accumulator
    # merge, against M1 and M2 together
    old_ms = cuda_time_ms(lambda: old_merge_accum(*acc[:2], *sorted_runs),
                          iters=3)
    m1_m2_ms = cuda_time_ms(lambda: merge.merge_accum(
        *acc, *merge.chunk_runs(*sorted_runs, CHUNK), *out))
    # both live inputs in, the live output out, 16 bytes a record
    bound = bound_ms((la + m + min(nu, slots)) * 16)
    return dict(slots=slots, live=la, runs=m, n_unique=nu, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                share_of_bound=bound / ms, library_ms=None,
                old_torch_ms=old_ms, m1_and_m2_ms=m1_m2_ms,
                kernels_ms=device_times(
                    lambda: merge.merge_accum(*acc, *runs, *out)))


def kernel_merge_accum(device, acc, sorted_runs, scale_acc,
                       scale_runs) -> dict:
    """M2 at the sample's shape (a chunk's runs into 2.6e7 keys in 2^26
    slots) and at scale_count's. No single PyTorch call merges two sorted
    sequences and sums the counts of equal keys."""
    edge_cases = merge_edges(device, "merge_accum")
    out = merge_accum_fields(acc, sorted_runs, "the sample's shape")
    return dict(out, edge_cases=edge_cases,
                at_scale_count=merge_accum_fields(scale_acc, scale_runs,
                                                  "scale_count's shape"))


def check_cut(acc, min_count: int, what: str):
    """C1 against its plain version on the same accumulator, each into
    out buffers of the same dead contents; raises unless the results and
    the whole buffers are equal bit for bit. Returns the kernel's
    (result, out keys, out counts)."""
    import torch

    from km_tpu_torch.ops import merge

    slots = acc[0].numel()
    dead = (torch.full((slots,), 0x5A5A5A5A5A5A5A5A, dtype=torch.int64,
                       device=acc[0].device),
            torch.full((slots,), 0x5A5A5A5A, dtype=torch.int32,
                       device=acc[0].device))
    outs = []
    for fn in (merge.cut, merge.cut_plain):
        out = tuple(t.clone() for t in dead)
        outs.append((fn(*acc, min_count, *out), *out))
    if not all(torch.equal(a, b) for a, b in zip(*outs)):
        raise AssertionError("cut kernel != plain (%s): %s vs %s"
                             % (what, outs[0][0].tolist(),
                                outs[1][0].tolist()))
    return outs[0]


def kernel_cut(device, slots: int = 1 << 26, live: int = 52_690_000,
               min_count: int = 2) -> dict:
    """C1 on an accumulator of 2^26 slots, 78.5% of them live as in
    count.resident's 2^29, 41% of the live kept at min_count 2: held
    bit-equal to its plain version (and on the cut's edge cases), timed
    against its bytes bound (16 B a live record in, 12 B a kept record
    out) and beside the plain version. No single PyTorch call cuts into
    given buffers (a mask, gathers and conversions that allocate)."""
    from km_tpu_torch.ops import merge
    from km_tpu_torch.scripts.merge_cases import (CUT_CASES, cut_accumulator,
                                                  cut_case)

    for name in CUT_CASES:
        check_cut(*cut_case(name, device), name)
    acc = cut_accumulator(live, slots, device, seed=26)
    result, out_k, out_c = check_cut(acc, min_count, "2^26 slots")
    kept, total, n = result.tolist()
    ms = cuda_time_ms(lambda: merge.cut(*acc, min_count, out_k, out_c))
    plain_ms = cuda_time_ms(
        lambda: merge.cut_plain(*acc, min_count, out_k, out_c), iters=3)
    bound = bound_ms(16 * n + 12 * kept)
    return dict(slots=slots, live=n, kept=kept, kept_share=kept / n,
                total=total, edge_cases=len(CUT_CASES), max_abs_err=0.0,
                ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                share_of_bound=bound / ms, library_ms=None,
                launches=merge.cut.launches,
                kernels_ms=device_times(
                    lambda: merge.cut(*acc, min_count, out_k, out_c)))


# ---------------------------------------------------------------------------
# the synthetic sample


def npm1_sequences():
    from km_tpu_torch.io.fasta import read_target
    from km_tpu_torch.refdata import catalog_fa

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
    from km_tpu_torch.ops.encode import seq_to_codes

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
    head, sep = 12, 3  # "@r%09d\n", "\n+\n"
    width = RECORD_BYTES
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


def timed_cli(argv, want: str) -> float:
    """Seconds of one CLI run, whose rows must equal those of ``want``
    (another run's output)."""
    t0 = time.perf_counter()
    out, _ = run_cli(argv)
    seconds = time.perf_counter() - t0
    if sorted(rows_of(out)) != sorted(rows_of(want)):
        raise AssertionError("%s: rows differ from the first run" % argv)
    return seconds


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
                span_s=stats["span_s"],
                peak_device_bytes=peak)


def device_calls() -> dict:
    """Calls of the catalog's three device programs, and host sweeps."""
    from km_tpu_torch.ops import batch_walk, nnls, pathgraph

    return dict(walk=batch_walk.device_discover.calls,
                sweeps=pathgraph.sweep_kernel.calls,
                nnls=nnls.Refinement.calls,
                host_sweeps=pathgraph.batched_sweeps.host_fallbacks)


def check_device_calls(before: dict, what: str) -> dict:
    """The calls made since ``before``; raises unless the walk, the
    sweeps and NNLS each ran on the card and no graph took the host
    sweep."""
    calls = {k: v - before[k] for k, v in device_calls().items()}
    if min(calls["walk"], calls["sweeps"], calls["nnls"]) == 0 \
            or calls["host_sweeps"]:
        raise AssertionError("%s did not run the device path: %s"
                             % (what, calls))
    return calls


def phase_times() -> dict:
    from km_tpu_torch.utils import profiling

    return {k: v for k, v in profiling.report().items()
            if k in ("walk", "sweeps", "graph_host", "nnls", "rows",
                     "quant_host", "table_to_device")}


def phase_find_mutation(device, workdir: str, table: str) -> dict:
    from km_tpu_torch.ops import batch_walk

    target, _ref, alt = npm1_sequences()
    before = device_calls()
    t0 = time.perf_counter()
    fm, _ = run_cli(["find_mutation", "--batch", "--device", device.type,
                     target, table])
    fm_s = time.perf_counter() - t0
    times = phase_times()
    calls = check_device_calls(before, "find_mutation --batch")
    walk = dict(batch_walk.device_discover.stats)
    # the same command on the port's host path, then on the card again
    # (warm): table load and upload included in each
    host_s, again_s = (timed_cli(["find_mutation", "--batch", "--device", d,
                                  target, table], fm)
                       for d in ("host", device.type))
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
                find_mutation_s=fm_s, with_report_s=total_s,
                host_find_mutation_s=host_s, warm_find_mutation_s=again_s,
                phases_s=times, calls=calls, walk=walk)


def prefix_batches(fastq: str, n_bases: int):
    """The sample's first n_bases as parsed (codes, valid) batches, with
    ``-Q +`` as the count phase reads it; returns (batches, bases)."""
    from km_tpu_torch.io.fastq import read_batches

    batches, total = [], 0
    for codes, valid in read_batches([fastq], min_quality="+"):
        take = min(len(codes), n_bases - total)
        batches.append((codes[:take], valid[:take]))
        total += take
        if total >= n_bases:
            break
    return batches, total


def phase_count_slice(device, fastq: str) -> dict:
    """A 2^24-base slice of the sample counted on the card and by the
    port's numpy spec (count_batches_host, which the CPU tests hold equal
    to km_tpu's): identical keys and counts."""
    from km_tpu_torch.ops.count import (count_batches_device_stream,
                                        count_batches_host)

    batches, total = prefix_batches(fastq, 1 << 24)
    hk, hc = count_batches_host(iter(batches), K, min_count=1)
    dk, dc = count_batches_device_stream(iter(batches), K, min_count=1,
                                         capacity=1 << 25, device=device)
    if not (np.array_equal(hk, dk) and np.array_equal(hc, dc)):
        raise AssertionError("slice counts differ from count_batches_host")
    return dict(bases=total, distinct=len(hk))


def write_catalog(workdir: str, n_targets: int) -> str:
    """The cycled catalog as one FASTA file per target, in a directory
    that ``find_mutation`` takes as its target argument."""
    from km_tpu_torch.refdata import catalog_sequences

    cat = os.path.join(workdir, "catalog_%d" % n_targets)
    os.makedirs(cat, exist_ok=True)
    for seq, name in catalog_sequences(n_targets):
        with open(os.path.join(cat, name + ".fa"), "w") as f:
            f.write(">%s\n%s\n" % (name, seq))
    return cat


def cli_catalog(device, catalog: str, table: str) -> dict:
    """``find_mutation --batch`` on the catalog directory: what a user
    waits for (table load, upload and a cold run included), on the card
    and on the port's host path, with equal rows."""
    t0 = time.perf_counter()
    out, _ = run_cli(["find_mutation", "--batch", "--device", device.type,
                      catalog, table])
    device_s = time.perf_counter() - t0
    host_s = timed_cli(["find_mutation", "--batch", "--device", "host",
                        catalog, table], out)
    return dict(device_s=device_s, host_s=host_s)


def timed_catalog(targets, table, runs: int = 2):
    """run_catalog ``runs`` times; returns (rows as text, seconds of the
    last run, its phase times)."""
    from km_tpu_torch.models.batch import run_catalog
    from km_tpu_torch.utils import profiling

    for _ in range(runs):
        profiling.reset()
        t0 = time.perf_counter()
        rows = run_catalog(targets, table, on_budget="skip")
        seconds = time.perf_counter() - t0
    return [[str(r) for r in rs] for rs in rows], seconds, phase_times()


def compare_catalog(targets, host_table, device) -> dict:
    """The catalog on a CUDA table (cold, then warm) against the port's
    host path on the same table (cold, then warm): equal rows."""
    from km_tpu_torch.ops import batch_walk
    from km_tpu_torch.ops.device_table import DeviceCountTable

    t0 = time.perf_counter()
    dev_table = DeviceCountTable.from_host(host_table, device=device)
    upload_s = time.perf_counter() - t0
    before = device_calls()
    dev_rows, dev_s, dev_phases = timed_catalog(targets, dev_table)
    calls = check_device_calls(before, "the device catalog")
    stats = dict(batch_walk.device_discover.stats)
    host_rows, host_s, host_phases = timed_catalog(targets, host_table)
    if dev_rows != host_rows:
        bad = [i for i, (a, b) in enumerate(zip(dev_rows, host_rows))
               if a != b]
        raise AssertionError("device rows differ from the host path on "
                             "%d targets, first %s" % (len(bad), bad[:3]))
    return dict(targets=len(targets), table_keys=int(dev_table.n),
                rows=sum(len(r) for r in dev_rows), upload_s=upload_s,
                device_s=dev_s, host_s=host_s, device_phases_s=dev_phases,
                host_phases_s=host_phases, walk=stats, calls=calls)


def phase_catalog_device(device, workdir: str, counted_table: str) -> dict:
    from km_tpu_torch.models.table import CountTable
    from km_tpu_torch.refdata import catalog_targets, jf_path

    host = CountTable.from_jf(jf_path(CATALOG_SAMPLE))
    host.name = CATALOG_SAMPLE
    targets = catalog_targets(CATALOG_TARGETS, host.k)
    fixture = compare_catalog(targets, host, device)
    counted = CountTable.load(counted_table)
    counted.name = "counted"
    counted_run = compare_catalog(targets, counted, device)
    catalog = write_catalog(workdir, CATALOG_TARGETS)
    fixture["cli"] = cli_catalog(device, catalog, jf_path(CATALOG_SAMPLE))
    counted_run["cli"] = cli_catalog(device, catalog, counted_table)
    return dict(fixture=fixture, counted=counted_run)


# the kernels each path runs; every other kernel must not launch there
PATH_KERNELS = {
    "main": ("pack", "sort_runs", "chunk_runs", "merge_accum", "cut"),
    "chunked": ("pack", "sort_runs", "chunk_runs"),
    "scale_count": ("pack", "sort_runs", "chunk_runs", "merge_accum"),
    "sharded": ("pack", "sort_runs"),
    "cohort": ("pack", "sort_runs", "chunk_runs", "merge_accum", "cut"),
}


def _counted():
    from km_tpu_torch.ops import merge, pack, sort_runs

    return {"pack": pack.pack_canonical_windows,
            "sort_runs": sort_runs.sort_chunks_runs,
            "chunk_runs": merge.chunk_runs,
            "merge_accum": merge.merge_accum,
            "cut": merge.cut}


def kernel_launches() -> dict:
    return {name: fn.launches for name, fn in _counted().items()}


def reset_launches() -> None:
    for fn in _counted().values():
        fn.launches = 0


def check_launches(launches: dict, path: str) -> dict:
    """Raises unless exactly the kernels of the path were launched."""
    ran = {name for name, n in launches.items() if n}
    if ran != set(PATH_KERNELS[path]):
        raise AssertionError("%s: launches %s, but the path runs %s"
                             % (path, launches, PATH_KERNELS[path]))
    return launches


def peak_rss_mb() -> float:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def phase_count_chunked(device, workdir: str, fastq: str) -> dict:
    """``count --mode chunked`` through the CLI on the sample's first
    2^28 read bases (whole reads, cut from the FASTQ by its fixed record
    width), against ``--mode stream`` on the same file: equal keys and
    counts in the two table files. One launch of each kernel per chunk."""
    from km_tpu_torch.models.table import CountTable

    n_reads = min(SHARDED_BASES // READ_LEN,
                  os.path.getsize(fastq) // RECORD_BYTES)
    prefix = os.path.join(workdir, "prefix.fastq")
    with open(fastq, "rb") as src, open(prefix, "wb") as dst:
        left = n_reads * RECORD_BYTES
        while left:
            block = src.read(min(left, 1 << 26))
            dst.write(block)
            left -= len(block)
    argv = ["count", "--device", device.type, "-k", str(K), "-L", "2",
            "-Q", "+"]
    tables = {mode: os.path.join(workdir, "prefix_%s.npz" % mode)
              for mode in ("chunked", "stream")}
    rss_before = peak_rss_mb()
    reset_launches()
    _, chunked = run_cli(argv + ["--mode", "chunked", "-o", tables["chunked"],
                                 prefix])
    launches = check_launches(kernel_launches(), "chunked")
    rss_after = peak_rss_mb()
    _, stream = run_cli(argv + ["--mode", "stream", "-o", tables["stream"],
                                prefix])
    got, want = (CountTable.load(tables[m]) for m in ("chunked", "stream"))
    if not (got.keys.dtype == want.keys.dtype
            and got.counts.dtype == want.counts.dtype
            and np.array_equal(got.keys, want.keys)
            and np.array_equal(got.counts, want.counts)
            and (got.k, got.canonical) == (want.k, want.canonical)):
        raise AssertionError("count --mode chunked: the table differs from "
                             "--mode stream's")
    windows = n_reads * (READ_LEN - K + 1)
    if chunked["total"] != windows:
        raise AssertionError("chunked counts sum to %d, expected %d windows"
                             % (chunked["total"], windows))
    if not (launches["pack"] == launches["sort_runs"]
            == launches["chunk_runs"] == chunked["chunks"]
            == chunked["pack_launches"] == chunked["sort_runs_launches"]):
        raise AssertionError("chunked: launches %s for %d chunks"
                             % (launches, chunked["chunks"]))
    return dict(reads=n_reads, bases=n_reads * READ_LEN,
                distinct=chunked["distinct"], chunks=chunked["chunks"],
                chunked_s=chunked["seconds"], stream_s=stream["seconds"],
                stream_retries=stream["retries"],
                kmers_per_s=windows / chunked["seconds"],
                runs=chunked["runs"],
                readback_bytes=chunked["readback_bytes"],
                span_s=chunked["span_s"], merge_s=chunked["merge_s"],
                stream_span_s=stream["span_s"],
                peak_rss_mb_before=rss_before, peak_rss_mb_after=rss_after,
                launches=launches)


def compare_modes(device, workdir: str, log2_bases: int, seed: int) -> None:
    """``count`` of the whole sample in turns (chunked, stream, stream,
    chunked), each run ``python -m km_tpu_torch count`` in a fresh
    process that also prints its numbers and its peak RSS; the four
    tables must be equal."""
    from km_tpu_torch.models.table import CountTable

    fq = os.path.join(workdir, "sample.fastq")
    n_reads = write_fastq(fq, 1 << log2_bases, seed)
    code = ("import json, resource, sys\n"
            "from km_tpu_torch import cli\n"
            "stats = cli.main(sys.argv[1:])\n"
            "stats['peak_rss_mb'] = resource.getrusage("
            "resource.RUSAGE_SELF).ru_maxrss / 1024\n"
            "print(json.dumps(stats))\n")
    first = None
    for turn, mode in enumerate(("chunked", "stream", "stream", "chunked")):
        out = os.path.join(workdir, "modes_%d.npz" % turn)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", code, "count", "--device", device.type,
             "--mode", mode, "-k", str(K), "-L", "2", "-Q", "+", "-o", out,
             fq], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
            capture_output=True, text=True, timeout=COHORT_TIMEOUT_S)
        wall_s = time.perf_counter() - t0
        if proc.returncode:
            raise AssertionError("count --mode %s exited %d:\n%s"
                                 % (mode, proc.returncode, proc.stderr[-4000:]))
        table = CountTable.load(out)
        if first is None:
            first = table
        elif not (np.array_equal(table.keys, first.keys)
                  and np.array_equal(table.counts, first.counts)):
            raise AssertionError("turn %d (%s): the table differs from the "
                                 "first turn's" % (turn, mode))
        os.remove(out)
        say("compare_modes", turn=turn, mode=mode, reads=n_reads,
            wall_s=wall_s, **json.loads(proc.stdout.splitlines()[-1]))


def phase_scale_count(device) -> dict:
    """``scripts.scale_count`` at its full default: 64 chunks of 2^24
    bases synthesized and counted on the card into 2^23 slots; it raises
    unless every window is counted. One launch of each kernel per chunk."""
    from km_tpu_torch.scripts.scale_count import scale_count

    reset_launches()
    record, keys, _counts = scale_count(SCALE_CHUNKS, SCALE_CAPACITY,
                                        device=device)
    launches = check_launches(kernel_launches(), "scale_count")
    if {launches[name] for name in PATH_KERNELS["scale_count"]} != {
            SCALE_CHUNKS}:
        raise AssertionError("scale_count: launches %s for %d chunks"
                             % (launches, SCALE_CHUNKS))
    if not (np.diff(keys.astype(np.int64)) > 0).all():
        raise AssertionError("scale_count: the table's keys are not "
                             "ascending and distinct")
    return dict(record, launches=launches)


def phase_bigtable_walk(device) -> dict:
    """``scripts.bigtable_walk`` at 1e8 extra records and 400 targets: it
    raises unless host and device rows equal the fixture-only rows; the
    walk, the sweeps and NNLS must have run on the card."""
    from km_tpu_torch.scripts.bigtable_walk import bigtable_walk

    before = device_calls()
    record, rows = bigtable_walk(BIGTABLE_EXTRA, CATALOG_TARGETS,
                                 device=device)
    calls = check_device_calls(before, "bigtable_walk")
    if not (rows["host"] == rows["device"] == rows["fixture"]
            and record["rows_match_fixture_only_run"]):
        raise AssertionError("bigtable_walk: rows differ")
    return dict(record, calls=calls, peak_rss_mb=peak_rss_mb())


def lookup_queries(host, boundaries, n: int):
    """About n queries: present keys, their reverse complements, random
    absent keys, the table's ends and the shard boundaries."""
    from km_tpu_torch.ops import encode

    rng = np.random.default_rng(5)
    present = host.keys[rng.integers(0, len(host.keys), n // 4)]
    ends = np.concatenate([host.keys[[0, -1]], boundaries])
    absent = rng.integers(0, 1 << (2 * K), n // 2 - len(ends),
                          dtype=np.uint64)
    return np.concatenate([present, encode.revcomp(present, K), absent,
                           ends])


def host_full_step(host, codes, valid, queries, ratio=0.05, n_cutoff=5):
    """full_step recomputed with the port's numpy counter and host
    table: (run keys, run counts, tip counts, child mask)."""
    from km_tpu_torch.ops import encode
    from km_tpu_torch.ops.count import count_batches_host

    keys, counts = count_batches_host(iter([(codes, valid)]), K,
                                      min_count=1)
    tips = host.query_packed(queries)
    children = host.query_packed(encode.child_keys_forward(queries, K))
    thr = np.maximum(children.sum(-1, keepdims=True).astype(np.float64)
                     * ratio, float(n_cutoff))
    return keys, counts.astype(np.int64), tips, children >= thr


def phase_sharded(device, workdir: str, fastq: str) -> dict:
    """The scale-out layer on one card: an NCCL group of one process.
    sharded_count over a 2^28-base prefix of the sample against the
    single-device stream; the sharded table's routed and broadcast
    lookups against DeviceCountTable; full_step on a 1x1 (reads, shard)
    mesh against its host recomputation. All exact."""
    import torch
    import torch.distributed as dist

    from km_tpu_torch.device import to_device_keys, to_host_keys
    from km_tpu_torch.models.table import CountTable
    from km_tpu_torch.ops.count import count_batches_device_stream
    from km_tpu_torch.ops.device_table import DeviceCountTable
    from km_tpu_torch.parallel import distributed
    from km_tpu_torch.parallel.pipeline_step import full_step
    from km_tpu_torch.parallel.sharded_table import (ShardedCountTable,
                                                     sharded_count)
    from km_tpu_torch.tools.count import CHUNK

    out = {}
    batches, bases = prefix_batches(fastq, SHARDED_BASES)
    torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl", init_method="file://" + os.path.join(workdir, "nccl_store"),
        rank=0, world_size=1)
    try:
        reset_launches()
        stats = {}
        t0 = time.perf_counter()
        keys, counts = sharded_count(iter(batches), K, min_count=2,
                                     chunk=CHUNK["cuda"], device=device,
                                     stats=stats)
        out["sharded_count_s"] = time.perf_counter() - t0
        out["launches"] = check_launches(kernel_launches(), "sharded")
        t0 = time.perf_counter()
        want_k, want_c = count_batches_device_stream(
            iter(batches), K, min_count=2, chunk=CHUNK["cuda"],
            capacity=1 << 26, device=device)
        out["single_device_count_s"] = time.perf_counter() - t0
        if not (np.array_equal(keys, want_k)
                and np.array_equal(counts, want_c)):
            raise AssertionError("sharded_count differs from "
                                 "count_batches_device_stream")
        out.update(bases=bases, distinct=len(keys), steps=stats["steps"],
                   runs_per_owner=stats["runs_sent"],
                   exchange_s=stats["exchange_s"], merge_s=stats["merge_s"])

        host = CountTable.from_arrays(keys, counts, K, True, name="sharded",
                                      presorted=True)
        t0 = time.perf_counter()
        table = ShardedCountTable(host, device=device)
        out["table_build_s"] = time.perf_counter() - t0
        ref = DeviceCountTable.from_host(host, device=device)
        q = to_device_keys(lookup_queries(
            host, to_host_keys(table.boundaries), SHARDED_QUERIES), device)
        want = ref.lookup(q)
        for name, look in (("routed", table.lookup_routed),
                           ("broadcast", table.lookup)):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            got = look(q)
            torch.cuda.synchronize(device)
            out["lookup_%s_s" % name] = time.perf_counter() - t0
            if not torch.equal(got, want):
                raise AssertionError("lookup %s differs from DeviceCountTable "
                                     "on %d of %d queries"
                                     % (name, int((got != want).sum()),
                                        q.numel()))
        out.update(queries=q.numel(), hits=int((want > 0).sum()))

        mesh = distributed.global_mesh("cuda", reads=1)
        codes = np.concatenate([c for c, _ in batches])[:CHUNK["cuda"]]
        valid = np.concatenate([v for _, v in batches])[:CHUNK["cuda"]]
        rng = np.random.default_rng(6)
        tips = np.concatenate([
            host.keys[rng.integers(0, len(host.keys), FULL_STEP_QUERIES // 2)],
            rng.integers(0, 1 << (2 * K), FULL_STEP_QUERIES // 2,
                         dtype=np.uint64)])
        t0 = time.perf_counter()
        got = full_step(mesh, torch.from_numpy(codes).to(device),
                        torch.from_numpy(valid).to(device), table,
                        to_device_keys(tips, device))
        torch.cuda.synchronize(device)
        out["full_step_s"] = time.perf_counter() - t0
        got = [to_host_keys(got[0])] + [t.cpu().numpy() for t in got[1:]]
        for name, g, w in zip(("run keys", "run counts", "tips", "child mask"),
                              got, host_full_step(host, codes, valid, tips)):
            if not np.array_equal(g, w):
                raise AssertionError("full_step %s differ from the host "
                                     "recomputation" % name)
        out.update(full_step_runs=len(got[0]),
                   full_step_children_kept=int(got[3].sum()))
    finally:
        dist.destroy_process_group()
    return out


def report_tree(root: str) -> dict:
    """{relative path: text} of every report under root."""
    files = {}
    for base, _dirs, names in os.walk(root):
        for name in names:
            path = os.path.join(base, name)
            with open(path) as f:
                files[os.path.relpath(path, root)] = f.read()
    return files


def pipe_report(device, target: str, sample: str, workdir: str) -> str:
    """``find_mutation --batch | find_report -t target`` through the
    port's CLI."""
    fm, _ = run_cli(["find_mutation", "--batch", "--device", device.type,
                     target, sample])
    path = os.path.join(workdir, "pipe.find_mutation.tsv")
    with open(path, "w") as f:
        f.write(fm)
    report, _ = run_cli(["find_report", "-t", target, path])
    return report


def phase_cohort(device, workdir: str, fastq: str, counted_table: str
                 ) -> dict:
    """``cohort`` under torchrun (one process, NCCL) on the catalog
    against three samples: the 2^30-base FASTQ, its counted table and
    the 03H116_ITD fixture. The FASTQ's reports equal the table's; a
    --device host cohort over the two tables gives the same files; two
    pairs equal the port's find_mutation | find_report pipe."""
    import re

    from km_tpu_torch.refdata import catalog_dir, catalog_fa, jf_path

    cat = catalog_dir("GRCh38")
    n_targets = len(os.listdir(cat))
    # distinct names: a sample's reports go to <outdir>/<its base name>
    reads = os.path.join(workdir, "cohort_reads.fastq")
    table = os.path.join(workdir, "cohort_table.npz")
    os.symlink(fastq, reads)
    os.symlink(counted_table, table)
    fixture = jf_path(CATALOG_SAMPLE)
    out_dir = os.path.join(workdir, "cohort_" + device.type)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=1", "-m", "km_tpu_torch", "cohort", "-t", cat,
         "-o", out_dir, "--device", device.type, "-L", "2", "-Q", "+",
         reads, table, fixture],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=COHORT_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError("torchrun cohort exited %d:\n%s"
                             % (proc.returncode, proc.stderr[-4000:]))
    per_sample = {m[0]: dict(seconds=float(m[1]), table=float(m[2]),
                             catalog=float(m[3]), reports=float(m[4]))
                  for m in re.findall(
                      r"cohort: (\S+) -> \d+ targets in \S+ \(([\d.]+) s: "
                      r"table ([\d.]+), catalog ([\d.]+), reports ([\d.]+)\)",
                      proc.stderr)}
    m = re.search(r"done in ([\d.]+)s .*kernel launches: pack (\d+), "
                  r"sort_runs (\d+), chunk_runs (\d+), merge_accum (\d+), "
                  r"cut (\d+)", proc.stderr)
    if m is None or len(per_sample) != 3:
        raise AssertionError("cohort's summary lines are missing:\n%s"
                             % proc.stderr[-4000:])
    launches = check_launches(
        dict(zip(("pack", "sort_runs", "chunk_runs", "merge_accum", "cut"),
                 map(int, m.groups()[1:]))), "cohort")
    command_s = float(m[1])

    files = report_tree(out_dir)
    names = {"cohort_reads", "cohort_table", CATALOG_SAMPLE}
    if len(files) != 3 * n_targets or \
            {p.split(os.sep)[0] for p in files} != names:
        raise AssertionError("expected %d report files for %s, got %s"
                             % (3 * n_targets, sorted(names), sorted(files)))
    for path, text in files.items():
        sample, target = path.split(os.sep)
        if sample == "cohort_reads":
            # the Sample column names the sample as given
            want = files[os.path.join("cohort_table", target)]
            if text.replace(reads, table) != want:
                raise AssertionError("%s differs from the counted table's "
                                     "report" % path)

    host_dir = os.path.join(workdir, "cohort_host")
    t0 = time.perf_counter()
    run_cli(["cohort", "-t", cat, "-o", host_dir, "--device", "host",
             table, fixture])
    host_s = time.perf_counter() - t0
    host_files = report_tree(host_dir)
    if host_files != {p: t for p, t in files.items()
                      if not p.startswith("cohort_reads")}:
        raise AssertionError("--device host cohort differs from the card's")

    pairs = [(CATALOG_SAMPLE, fixture, "FLT3-ITD_exons_13-15"),
             ("cohort_table", table, NPM1_TARGET)]
    for sample_name, sample, target in pairs:
        if pipe_report(device, catalog_fa(target), sample, workdir) != \
                files[os.path.join(sample_name, target + ".tsv")]:
            raise AssertionError("cohort %s x %s differs from the pipe"
                                 % (sample_name, target))
    variants = sum(1 for text in files.values()
                   for line in text.splitlines()[1:]
                   if line.split("\t")[3] != "Reference")
    return dict(wall_s=wall_s, command_s=command_s, per_sample_s=per_sample,
                host_cohort_s=host_s,
                files=len(files), variant_rows=variants, launches=launches,
                pipes_matched=len(pairs))


def phase_golden(device) -> dict:
    from km_tpu_torch.refdata import DATA_DIR, catalog_fa, jf_path

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
    ap.add_argument("--kernels-only", action="store_true")
    ap.add_argument("--compare-modes", action="store_true")
    opts = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from km_tpu_torch import _build, native
    from km_tpu_torch.device import resolve_device
    from km_tpu_torch.scripts.merge_cases import sample_shape, scale_shape

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
    say("build", seconds=secs, library=_build.LIB_PATH,
        ptxas=[line for line in log.splitlines()
               if "Used" in line or "spill" in line and "0 bytes spill" not
               in line])
    # the native host library, from its source too: a failed build raises
    # here with the compiler's output, and nothing falls back to Python
    native_s = _build.build_native()
    native.require()
    say("build_native", seconds=native_s, library=_build.NATIVE_LIB_PATH)
    if opts.compare_modes:
        workdir = tempfile.mkdtemp(prefix="km_tpu_torch_modes_")
        try:
            compare_modes(device, workdir, opts.log2_bases, opts.seed)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print(smi)
        return 0
    kernels = {"pack": kernel_pack(device)}
    say("kernel_pack", **kernels["pack"])
    kernels["sort_runs"] = kernel_sort_runs(device)
    say("kernel_sort_runs", **kernels["sort_runs"])
    kernels["sort_chunks"] = kernel_sort_chunks(device)
    say("kernel_sort_chunks", **kernels["sort_chunks"])
    acc, sorted_runs = sample_shape(device)
    scale_acc, scale_runs = scale_shape(device)
    kernels["chunk_runs"] = kernel_chunk_runs(device, sorted_runs,
                                              scale_runs)
    say("kernel_chunk_runs", **kernels["chunk_runs"])
    kernels["merge_accum"] = kernel_merge_accum(device, acc, sorted_runs,
                                                scale_acc, scale_runs)
    say("kernel_merge_accum", **kernels["merge_accum"])
    del acc, sorted_runs, scale_acc, scale_runs
    torch.cuda.empty_cache()
    kernels["cut"] = kernel_cut(device)
    say("kernel_cut", **kernels["cut"])
    torch.cuda.empty_cache()

    if opts.kernels_only:
        return 0
    workdir = tempfile.mkdtemp(prefix="km_tpu_torch_smoke_")
    try:
        # the main path: count, then find_mutation --batch | find_report
        reset_launches()
        counted = phase_count(device, workdir, opts.log2_bases, opts.seed)
        say("count", **counted)
        say("find_mutation",
            **phase_find_mutation(device, workdir, counted["table"]))
        launches = check_launches(kernel_launches(), "main")
        say("launches", **launches)
        say("count_slice", **phase_count_slice(device, counted["fastq"]))
        # counting and walking at scale, each path with its own launches
        chunked = phase_count_chunked(device, workdir, counted["fastq"])
        say("count_chunked", **chunked)
        scale = phase_scale_count(device)
        say("scale_count", **scale)
        say("catalog_device", **phase_catalog_device(device, workdir,
                                                     counted["table"]))
        say("bigtable_walk", **phase_bigtable_walk(device))
        # the scale-out paths: the sharded layer in-process, then cohort
        # under torchrun; each reads its own kernel launches
        sharded = phase_sharded(device, workdir, counted["fastq"])
        say("sharded", **sharded)
        cohort = phase_cohort(device, workdir, counted["fastq"],
                              counted["table"])
        say("cohort", **cohort)
        before = device_calls()
        golden = phase_golden(device)
        say("golden", calls=check_device_calls(before, "golden"), **golden)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("km_tpu", "jax"))
    if foreign:
        raise AssertionError("km_tpu or JAX was imported: %s" % foreign[:5])
    say("no_km_tpu", modules=len(sys.modules))

    # K3 lies on no path: its launches are those of its own phase
    launches["sort_chunks"] = kernels["sort_chunks"]["launches"]
    replaces = {"pack": "km_tpu/ops/pallas_pack.py:77",
                "sort_runs": "km_tpu/ops/pallas_sort.py:102",
                "sort_chunks": "km_tpu/ops/pallas_sort.py:68",
                # XLA programs, no Pallas
                "chunk_runs": "km_tpu/ops/count.py:195",
                "merge_accum": "km_tpu/ops/count.py:369",
                # a host numpy cut, no device code
                "cut": "km_tpu/ops/count.py:503"}
    sources = {"pack": "pack", "sort_runs": "sort_runs",
               "sort_chunks": "sort_runs", "chunk_runs": "merge_runs",
               "merge_accum": "merge_runs", "cut": "merge_runs"}
    paths = {"main": launches, "chunked": chunked["launches"],
             "scale_count": scale["launches"], "sharded": sharded["launches"],
             "cohort": cohort["launches"]}
    by_path = {name: {path: got[name] for path, got in paths.items()}
               for name in launches if name != "sort_chunks"}
    report = [dict(name=name, route="cuda",
                   source="km_tpu_torch/csrc/%s.cu" % sources[name],
                   replaces=replaces[name],
                   path=",".join(p for p, n in by_path.get(name, {}).items()
                                 if n) or "none",
                   launches=launches[name],
                   launches_by_path=by_path.get(name, {}),
                   max_abs_err=m["max_abs_err"], ms=m["ms"],
                   plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
                   bound_by=m["bound_by"],
                   share_of_bound=m["share_of_bound"],
                   library_ms=m["library_ms"])
              for name, m in kernels.items()]
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
