"""The count cells whose reads are expressed by Zipf's law
(kmbench/reads_zipf.py), with the configuration's ``expression``: the
count driver with its reads made by that generator and written as a
FASTQ in $TMPDIR during set-up. The call, the traced run's wrappers,
the kernels' bytes and ``correct`` (the exact comparison with
reference/count_ref.py, which reads only the reads) are the count
driver's.
"""

from __future__ import annotations

import os
import tempfile

from .. import reads as gen
from .. import reads_zipf
from . import count


class Driver(count.Driver):
    def setup(self) -> None:
        c, t = self.config, self.traffic
        self.entry = t["entry"]
        if self.entry != "count_read_files":
            raise ValueError("the skewed count reads a FASTQ; entry %r"
                             % self.entry)
        p = dict(t["reads"], bases=c["read_bases"])
        on_card = reads_zipf.make_reads_zipf(p, c["expression"], self.seed,
                                             self.device)
        self.reads = on_card.cpu().numpy()
        del on_card
        self.workdir = tempfile.mkdtemp(prefix="kmbench-")
        self.fastq = os.path.join(self.workdir, "sample.fastq")
        self.info["fastq_bytes"] = gen.write_fastq(self.fastq, self.reads)
        self._warm_parser()
        self._warm_count(t["warm_capacity"])
