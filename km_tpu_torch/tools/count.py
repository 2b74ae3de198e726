"""count: build a k-mer count table from FASTQ/FASTA reads.

Replaces the external ``jellyfish count`` step of km's pipeline
(reference: example/run_leucegene.sh:22), as km_tpu's ``count`` does.
``--device cuda`` (the default) counts on the card through the two CUDA
kernels, ``cpu`` runs the same pipeline with their plain torch versions
on CPU tensors, and ``host`` is km_tpu's numpy spec. There is no size
rule that moves small inputs elsewhere: the device asked for is used, or
the run fails.

Not ported yet: the multi-device mesh branch and ``--mode chunked``.
"""

from __future__ import annotations

import sys
import time

from km_tpu.io.fastq import read_batches
from km_tpu.models.table import CountTable
from km_tpu.ops.count import count_batches_host

from ..device import resolve_device
from ..ops.count import CountCapacityOverflow, count_batches_device_stream

# bases per uploaded chunk; the CPU runs the plain versions, where a
# smaller chunk keeps the temporaries small
CHUNK = {"cuda": 1 << 24, "cpu": 1 << 20}
START_CAPACITY = 1 << 22


def count_read_files(paths, k: int, canonical: bool = True,
                     min_count: int = 2, min_quality=None,
                     device: str = "cuda", stats=None):
    """Count k-mers of read files on ``device`` ('cuda', 'cpu' or
    'host'); returns host (keys uint64, counts uint32).

    On accumulator overflow the files are re-read with four times the
    capacity (counting is stateless, so the retry is exact), starting
    from 2^22 slots as km_tpu does. ``stats``, a dict, receives the
    stream's numbers and the number of retries."""
    batches = read_batches(paths, min_quality=min_quality)
    if device == "host":
        return count_batches_host(batches, k, canonical=canonical,
                                  min_count=min_count)
    dev = resolve_device(device)
    capacity = START_CAPACITY
    retries = 0
    while True:
        try:
            out = count_batches_device_stream(
                batches, k, canonical=canonical, min_count=min_count,
                chunk=CHUNK[dev.type], capacity=capacity, device=dev,
                stats=stats)
        except CountCapacityOverflow:
            capacity *= 4
            retries += 1
            sys.stderr.write("count table capacity exceeded; retrying "
                             "with %d slots\n" % capacity)
            batches = read_batches(paths, min_quality=min_quality)
            continue
        if stats is not None:
            stats["retries"] = retries
        return out


def main_count(args, argparser):
    """Returns a dict of the run's numbers (seconds, distinct k-mers,
    and for a device run the stream's stats)."""
    t0 = time.time()
    stats: dict = {}
    keys, counts = count_read_files(
        args.reads_fn, args.k, canonical=args.canonical,
        min_count=args.min_count, min_quality=args.min_quality,
        device=args.device, stats=stats)
    table = CountTable.from_arrays(keys, counts, args.k, args.canonical,
                                   name=args.output, presorted=True)
    table.save(args.output)
    dt = time.time() - t0
    sys.stderr.write(
        "counted %d distinct k-mers (k=%d) in %.2fs -> %s\n"
        % (table.n_kmers, args.k, dt, args.output))
    stats.update(seconds=dt, distinct=table.n_kmers)
    return stats
