"""The chunked count cell: a sample's FASTQ counted back to back as
``count --mode chunked --size`` counts it, jellyfish's ``--disk`` count
(the stream's accumulator capped at the configuration's ``size``; a
full one dumped to the host, the pieces merged and cut there at the
end). It is the count driver with the configuration's ``mode`` and
``size`` passed to ``count_read_files``.

Set-up makes the reads, then warms the capped path before the FASTQ is
written: two chunks through ``count_batches_device_compact`` under a
ceiling of one chunk, so that the kernels, the dump's cut and readback
and the native host merge are all loaded, and a program without the
ceiling fails at once. The traced run's wrappers, the kernels' bytes
and ``correct`` are the count driver's: every table against
reference/count_ref.py, exact (a table does not depend on how the
counter spills). The info line adds each count's dumps and the host's
peak RSS (of this process, set-up and window: VmHWM of /proc/self/status,
or ru_maxrss where the status file lacks it).
"""

from __future__ import annotations

import os
import resource
import tempfile

import torch

from .. import reads as gen
from . import count


def peak_rss_gib() -> tuple[float, str]:
    """The host's peak RSS of this process in GiB, and where it was read:
    VmHWM of /proc/self/status, or getrusage's ru_maxrss where the
    status file has no such line."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) / 2 ** 20, "VmHWM"
    except OSError:
        pass
    return (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20,
            "ru_maxrss")


class Driver(count.Driver):
    def setup(self) -> None:
        c, t = self.config, self.traffic
        self.entry = t["entry"]
        if self.entry != "count_read_files":
            raise ValueError("the chunked count reads a FASTQ; entry %r"
                             % self.entry)
        p = dict(t["reads"], bases=c["read_bases"])
        on_card = gen.make_reads(p, self.seed, self.device)
        self.reads = on_card.cpu().numpy()
        del on_card
        self._warm_capped()
        self.workdir = tempfile.mkdtemp(prefix="kmbench-")
        self.fastq = os.path.join(self.workdir, "sample.fastq")
        self.info["fastq_bytes"] = gen.write_fastq(self.fastq, self.reads)

    def _warm_capped(self) -> None:
        from km_tpu_torch.ops import count as ops_count

        c = self.config
        per_chunk = c["chunk"] // (self.reads.shape[1] + 1) + 1
        two = gen.resident_batches(self.reads[:2 * per_chunk], per_chunk)
        stats: dict = {}
        ops_count.count_batches_device_compact(
            iter(two), c["k"], canonical=c["canonical"],
            min_count=c["min_count"], chunk=c["chunk"], device=self.device,
            stats=stats, ceiling=c["chunk"])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.info["warm_dumps"] = stats["dumps"]

    def call(self):
        from km_tpu_torch.tools import count as tools_count

        c = self.config
        stats: dict = {}
        out = tools_count.count_read_files(
            [self.fastq], c["k"], canonical=c["canonical"],
            min_count=c["min_count"], min_quality=c["min_quality"],
            device=self.device.type, stats=stats, mode=c["mode"],
            size=c["size"])
        self.stats.append(stats)
        return out, stats["total"]

    def end_window(self) -> dict:
        rss, source = peak_rss_gib()
        self.info.update(host_peak_rss_gib=rss, host_peak_rss_from=source,
                         dumps=[s.get("dumps") for s in self.stats],
                         dumped=[s.get("dumped") for s in self.stats],
                         ceiling=[s.get("ceiling") for s in self.stats])
        return self.observe()
