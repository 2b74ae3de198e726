"""count: build a k-mer count table from FASTQ/FASTA reads.

Replaces the external ``jellyfish count`` step of km's pipeline
(reference: example/run_leucegene.sh:22), as km_tpu's ``count`` does.
``--device cuda`` (the default) counts on the card through the two CUDA
kernels, ``cpu`` runs the same pipeline with their plain torch versions
on CPU tensors, and ``host`` is the numpy spec. There is no size
rule that moves small inputs elsewhere: the device asked for is used, or
the run fails.

``--mode`` picks the device strategy, as in km_tpu: ``stream`` (and
``auto``) keeps one accumulator on the device, grown there when a chunk
overflows it, and reads it back once; ``chunked`` is jellyfish's
``--disk`` count: the same accumulator, grown no further than a ceiling
(``-s/--size``, jellyfish's hash size in slots, rounded up to a power of
two; without it, what the card's free memory holds). A chunk that
overflows the ceiling dumps the accumulator to the host as one sorted
piece and starts an empty one; the pieces are merged on the host at the
end and cut there at ``-L``. Both read the files once. ``--device host``
ignores the mode, and the stream ignores ``--size``.

Where the count runs on a card in one process and every file is FASTQ,
the text itself goes up and the card parses it (P1,
``ops.count.count_fastq_device_stream``), in either mode; FASTA, CPU
tensors and the sharded count keep the host's native parser.

Under torchrun with more than one process (``python -m
torch.distributed.run --nproc_per_node=N -m km_tpu_torch count ...``),
every process reads the same files and counts every N-th chunk on its own
device, the runs go to the process that owns their key range
(parallel.sharded_table.sharded_count), and the first process writes the
table. This is the port's form of km_tpu's multi-device branch
(km_tpu/tools/count.py:54-70). The sharded count runs whatever ``--mode`` says, as
km_tpu's multi-device branch comes before its mode is read. With one
process the mode's single-device counter runs.
"""

from __future__ import annotations

import sys
import time

import torch.distributed as dist

from ..device import resolve_device
from ..io.fastq import is_fastq, read_batches
from ..models.table import CountTable
from ..ops.count import (count_batches_device_compact,
                         count_batches_device_stream, count_batches_host,
                         count_fastq_device_stream, fitting_ceiling)
from ..parallel import distributed

# bases per uploaded chunk; the CPU runs the plain versions, where a
# smaller chunk keeps the temporaries small
CHUNK = {"cuda": 1 << 24, "cpu": 1 << 20}
START_CAPACITY = 1 << 22
MODES = ("auto", "stream", "chunked")


def chunked_ceiling(size: int | None, chunk: int, dev) -> int:
    """The chunked mode's ceiling in accumulator slots: ``size`` rounded
    up to a power of two, refused below the chunk (whose keys must fit an
    emptied accumulator); without it, ``ops.count.fitting_ceiling``."""
    if size is None:
        return fitting_ceiling(chunk, dev)
    if size < chunk:
        raise ValueError("--size %d is below the chunk of %d bases: the "
                         "chunked count's ceiling must hold a chunk's keys"
                         % (size, chunk))
    return 1 << (size - 1).bit_length()


def count_read_files(paths, k: int, canonical: bool = True,
                     min_count: int = 2, min_quality=None,
                     device: str = "cuda", stats=None, group=None,
                     mode: str = "auto", size: int | None = None):
    """Count k-mers of read files on ``device`` ('cuda', 'cpu' or
    'host'); returns host (keys uint64, counts uint32).

    ``mode`` picks the device strategy: 'stream' (one device-resident
    accumulator, one readback) or 'chunked' (jellyfish's ``--disk``
    count: the accumulator capped at ``chunked_ceiling(size, ...)``
    slots, dumped to the host when a chunk overflows it, the pieces
    merged and cut on the host at the end;
    ``ops.count.count_batches_device_compact``); 'auto' = 'stream'.
    'host' ignores it, and so does a process ``group``; only 'chunked'
    reads ``size``.

    The accumulator starts at 2^22 slots, as km_tpu's does, and doubles
    on the device as the keys need (ops.count's growth), so the files
    are read once. On a card, without a process group, FASTQ files are
    parsed there (``count_fastq_device_stream``: the host reads the text
    into pinned memory, P1 parses it); FASTA, CPU tensors and the
    sharded count parse on the host. ``stats``, a dict, receives the
    counter's numbers (capacity, grows, unique, kept, M1's ``runs`` and
    ``m1_rounds``, its spans under ``span_s``, ...); for the stream
    ``retries``, the times the files were read again, 0; for the chunked
    count ``ceiling``, ``dumps`` and ``dumped``.

    With a process ``group``, every rank of it calls this alike and the
    count is sharded over the group on each rank's own device; the
    group's first rank gets the table, the others None."""
    if mode not in MODES:
        raise ValueError("mode must be one of %s; got %r" % (MODES, mode))
    batches = read_batches(paths, min_quality=min_quality)
    if device == "host":
        return count_batches_host(batches, k, canonical=canonical,
                                  min_count=min_count)
    if group is not None:
        from ..parallel.sharded_table import sharded_count

        dev = distributed.local_device(device)
        return sharded_count(batches, k, group=group, canonical=canonical,
                             min_count=min_count, chunk=CHUNK[dev.type],
                             device=dev, stats=stats)
    dev = resolve_device(device)
    chunk = CHUNK[dev.type]
    ceiling = chunked_ceiling(size, chunk, dev) if mode == "chunked" \
        else None
    if dev.type == "cuda" and all(is_fastq(p) for p in paths):
        out = count_fastq_device_stream(
            paths, k, canonical=canonical, min_count=min_count,
            min_quality=min_quality, chunk=chunk, capacity=START_CAPACITY,
            device=dev, stats=stats, ceiling=ceiling)
    elif mode == "chunked":
        out = count_batches_device_compact(
            batches, k, canonical=canonical, min_count=min_count,
            chunk=chunk, device=dev, stats=stats, ceiling=ceiling)
    else:
        out = count_batches_device_stream(
            batches, k, canonical=canonical, min_count=min_count,
            chunk=chunk, capacity=START_CAPACITY, device=dev, stats=stats)
    if stats is not None and mode != "chunked":
        stats["retries"] = 0
    return out


def main_count(args, argparser):
    """Returns a dict of the run's numbers (seconds, distinct k-mers,
    and for a device run the stream's stats). With more than one
    process (a live process group; under torchrun this opens it) the
    count is sharded over them and only the first writes the table."""
    t0 = time.time()
    stats: dict = {}
    with distributed.session(args.device):
        group = (dist.group.WORLD if distributed.process_count() > 1
                 else None)
        writer = distributed.process_index() == 0
        out = count_read_files(
            args.reads_fn, args.k, canonical=args.canonical,
            min_count=args.min_count, min_quality=args.min_quality,
            device=args.device, stats=stats, group=group,
            mode=getattr(args, "mode", "auto"),
            size=getattr(args, "size", None))
    if not writer:
        return stats
    keys, counts = out
    table = CountTable.from_arrays(keys, counts, args.k, args.canonical,
                                   name=args.output, presorted=True)
    table.save(args.output)
    dt = time.time() - t0
    sys.stderr.write(
        "counted %d distinct k-mers (k=%d) in %.2fs -> %s\n"
        % (table.n_kmers, args.k, dt, args.output))
    stats.update(seconds=dt, distinct=table.n_kmers)
    return stats
