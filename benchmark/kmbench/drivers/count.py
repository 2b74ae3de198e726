"""The count cells: a sample's reads counted back to back.

The traffic's ``entry`` says how the reads reach the program:
``count_read_files`` writes them as a FASTQ in $TMPDIR during set-up
and counts the file as ``count`` does (the parser, the capacity retries
from the program's own start); ``count_batches_device_stream`` holds
them in host memory as parsed batches and streams them into one
accumulator of the traffic's ``capacity``. One call is one whole count;
its work is the valid windows it counted.

``correct`` compares the table of every count in the window, keys and
counts after ``min_count``, with the plain reference's
(reference/count_ref.py) from the same reads: the number of keys in
one only plus the keys whose counts differ, and the gap between the
windows each side counted. Both are exact: the limit is 0.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile

import torch

from reference import count_ref

from .. import reads as gen
from .. import roofline

LIMITS = {"table_mismatches": 0, "windows_gap": 0}


class Driver:
    kind = "count"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.stats: list[dict] = []
        self.workdir = None
        self.info: dict = {}

    # -- set-up ------------------------------------------------------------

    def setup(self) -> None:
        c, t = self.config, self.traffic
        p = dict(t["reads"], bases=c["read_bases"])
        on_card = gen.make_reads(p, self.seed, self.device)
        self.reads = on_card.cpu().numpy()
        del on_card
        self.entry = t["entry"]
        if self.entry == "count_read_files":
            self.workdir = tempfile.mkdtemp(prefix="kmbench-")
            self.fastq = os.path.join(self.workdir, "sample.fastq")
            self.info["fastq_bytes"] = gen.write_fastq(self.fastq, self.reads)
            self._warm_parser()
        elif self.entry == "count_batches_device_stream":
            self.batches = gen.resident_batches(self.reads, t["batch_reads"])
        else:
            raise ValueError("unknown count entry %r" % self.entry)
        self._warm_count(t["warm_capacity"])

    def _warm_parser(self) -> None:
        from km_tpu_torch.io.fastq import read_batches

        batches = read_batches([self.fastq],
                               min_quality=self.config["min_quality"])
        next(batches)
        batches.close()

    def _warm_count(self, capacity: int) -> None:
        """One chunk through the device counter at ``capacity`` slots:
        the kernels load, and the allocator holds blocks of the size the
        counts take."""
        from km_tpu_torch.ops import count as ops_count

        c = self.config
        per_chunk = c["chunk"] // (self.reads.shape[1] + 1) + 1
        first = gen.resident_batches(self.reads[:per_chunk], per_chunk)
        ops_count.count_batches_device_stream(
            iter(first), c["k"], canonical=c["canonical"],
            min_count=c["min_count"], chunk=c["chunk"],
            capacity=capacity, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the window --------------------------------------------------------

    def begin_window(self) -> None:
        self.stats.clear()

    def call(self):
        c = self.config
        stats: dict = {}
        if self.entry == "count_read_files":
            from km_tpu_torch.tools import count as tools_count

            out = tools_count.count_read_files(
                [self.fastq], c["k"], canonical=c["canonical"],
                min_count=c["min_count"], min_quality=c["min_quality"],
                device=self.device.type, stats=stats, mode=c["mode"])
        else:
            from km_tpu_torch.ops import count as ops_count

            out = ops_count.count_batches_device_stream(
                iter(self.batches), c["k"], canonical=c["canonical"],
                min_count=c["min_count"], chunk=c["chunk"],
                capacity=self.traffic["capacity"], device=self.device,
                stats=stats)
        self.stats.append(stats)
        return out, stats["total"]

    def observe(self) -> dict:
        """What the metrics read of the counts so far."""
        return {"count_stats": list(self.stats)}

    def end_window(self) -> dict:
        return self.observe()

    # -- the traced run ----------------------------------------------------

    @contextlib.contextmanager
    def traced(self, tracer):
        """Host spans of the input generator, and the sizes of every
        launch of the four kernels, kept on the device until the end."""
        from km_tpu_torch.ops import count as ops_count

        launches: list = []
        saved = {name: getattr(ops_count, name) for name in (
            "pack_canonical_windows", "sort_chunks_runs", "chunk_runs",
            "merge_accum", "chunk_stream")}

        def pack(codes, valid, k, canonical=True):
            launches.append(("K1 pack", codes.numel()))
            return saved["pack_canonical_windows"](codes, valid, k, canonical)

        def sort_runs(keys, *a, **kw):
            launches.append(("K2 sort_runs", keys.numel()))
            return saved["sort_chunks_runs"](keys, *a, **kw)

        def chunk_runs(keys, lengths, *a, **kw):
            out = saved["chunk_runs"](keys, lengths, *a, **kw)
            launches.append(("M1 chunk_runs", keys.numel(), out[2]))
            return out

        def merge_accum(acc_keys, acc_cnt, acc_n, run_keys, run_cnt, run_n,
                        out_keys, out_cnt, out_n):
            saved["merge_accum"](acc_keys, acc_cnt, acc_n, run_keys,
                                 run_cnt, run_n, out_keys, out_cnt, out_n)
            launches.append(("M2 merge_accum", acc_keys.numel(),
                             torch.stack((acc_n, run_n, out_n))))

        def chunk_stream(*a, **kw):
            it = saved["chunk_stream"](*a, **kw)
            while True:
                with tracer.span("input"):
                    item = next(it, None)
                if item is None:
                    return
                yield item

        for name, fn in (("pack_canonical_windows", pack),
                         ("sort_chunks_runs", sort_runs),
                         ("chunk_runs", chunk_runs),
                         ("merge_accum", merge_accum),
                         ("chunk_stream", chunk_stream)):
            setattr(ops_count, name, fn)
        self.launches = launches
        try:
            yield
        finally:
            for name, fn in saved.items():
                setattr(ops_count, name, fn)

    def kernel_bytes(self) -> dict:
        """Bytes moved by each kernel over the window's launches."""
        out = {group: [0, 0] for group in roofline.KERNELS}
        for rec in self.launches:
            group = rec[0]
            if group == "K1 pack":
                b = roofline.pack_bytes(rec[1])
            elif group == "K2 sort_runs":
                b = roofline.sort_runs_bytes(rec[1])
            elif group == "M1 chunk_runs":
                b = roofline.chunk_runs_bytes(rec[1], int(rec[2]))
            else:
                cap = rec[1]
                acc_n, run_n, out_n = (int(v) for v in rec[2].tolist())
                b = roofline.merge_accum_bytes(min(acc_n, cap) + run_n,
                                               min(out_n, cap))
            out[group][0] += b
            out[group][1] += 1
        return out

    # -- correct -----------------------------------------------------------

    def check(self, results) -> dict:
        c = self.config
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        reads = torch.from_numpy(self.reads).to(self.device)
        rk, rc, total, distinct = count_ref.count_reads(
            reads, c["k"], c["canonical"], c["min_count"])
        del reads
        self.info.update(reference_windows=total, reference_distinct=distinct,
                         reference_kept=len(rk),
                         program_unique=[s.get("unique") for s in self.stats],
                         capacity=[s.get("capacity") for s in self.stats],
                         retries=[s.get("retries") for s in self.stats])
        mismatches = [count_ref.table_mismatches(k, n, rk, rc)
                      for k, n in results]
        gaps = [abs(int(s["total"]) - total) for s in self.stats]
        return {"table_mismatches": (max(mismatches, default=0),
                                     LIMITS["table_mismatches"]),
                "windows_gap": (max(gaps, default=0), LIMITS["windows_gap"])}

    def close(self) -> None:
        if self.workdir:
            shutil.rmtree(self.workdir, ignore_errors=True)
            self.workdir = None
