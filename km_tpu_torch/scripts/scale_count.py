"""GB-scale counting: a billion-base sample counted into one
device-resident table, with the memory envelope reported.

The port's form of km_tpu's ``scripts/scale_count.py``. The read stream
is synthesized on the device (chunks derived from a resident reference by
a rotation and hash-sparse point mutations, like RNA-seq reads off a
transcriptome), so the number is the card's own counting rate: the host's
parser and the uploads are out of the way. The end-to-end rate with a
FASTQ on the host is the ``count`` subcommand's.

Per chunk, all on the device:
  synthesize 2^24 bases -> window pack (CUDA kernel) -> chunk sort with
  runs (CUDA kernel) -> the chunk's runs in key order (CUDA kernel) ->
  merged from one resident accumulator into the other (CUDA kernel).
The accumulator is read back once, at the end.

    python -m km_tpu_torch.scripts.scale_count [--chunks N] [--capacity LOG2]
                                               [--chunk LOG2] [--device cuda]

prints one JSON line with km_tpu's keys. Not carried over: km_tpu's
``INNER_CHUNKS`` and its ``fori_loop`` over chunks, which amortised the
round trip of each dispatch over a remote link; here a plain loop queues
the chunks and one synchronize ends the timed region, after one warm
chunk. The accumulator's overflow is read from a running maximum of the
unique-key count, not from the last chunk's alone.
"""

from __future__ import annotations

import argparse
import json
import resource
import sys
import time

import numpy as np
import torch

from ..device import i64_to_u64, resolve_device
from ..ops.count import (CountCapacityOverflow, count_chunk_device,
                         empty_accumulator, merge_accum_device)
from ..ops.merge import chunk_runs, merge_accum
from ..ops.pack import pack_canonical_windows
from ..ops.sort_runs import CHUNK as SORT_CHUNK
from ..ops.sort_runs import sort_chunks_runs

K = 31
CHUNK = 1 << 24      # bases per device chunk
REF_LOG2 = 21        # 2 MB reference: ~2M distinct k-mers, plus mutations
REF_SEED = 7
_M32 = 0xFFFFFFFF


def reference_chunk(chunk: int = CHUNK, ref_log2: int = REF_LOG2
                    ) -> np.ndarray:
    """The resident reference: 2^ref_log2 random bases (seed 7) tiled to
    one chunk, as uint8 codes."""
    if chunk % (1 << ref_log2):
        raise ValueError("chunk must be a multiple of 2**%d" % ref_log2)
    rng = np.random.default_rng(REF_SEED)
    ref = rng.integers(0, 4, 1 << ref_log2, dtype=np.uint8)
    return np.tile(ref, chunk >> ref_log2)


class ChunkSynthesizer:
    """Chunk ``idx`` of the stream from the resident reference, km_tpu's
    formula to the bit: ``roll(base, idx * 99991)``, then a point mutation
    wherever ``h = pos * 2654435761 + idx * 40503`` (uint32 arithmetic)
    is below 429497 (~1e-4 of the range), to base ``(h >> 16) & 3``.
    torch has no shifts or compares on uint32, so h is int64 arithmetic
    masked to 32 bits; the product ``pos * 2654435761`` is kept resident."""

    def __init__(self, base: torch.Tensor):
        self.base = base
        n = base.numel()
        pos = torch.arange(n, dtype=torch.int64, device=base.device)
        self.pos_h = (pos * 2654435761) & _M32

    def __call__(self, idx: int) -> torch.Tensor:
        n = self.base.numel()
        # km_tpu multiplies in int32; the shift is taken modulo n
        shift = (idx * 99991 + (1 << 31)) % (1 << 32) - (1 << 31)
        codes = torch.roll(self.base, shift % n)
        h = (self.pos_h + ((idx * 40503) & _M32)) & _M32
        return torch.where(h < 429497, ((h >> 16) & 3).to(torch.uint8), codes)


def scale_count(chunks: int = 64, capacity: int = 1 << 23,
                chunk: int = CHUNK, ref_log2: int = REF_LOG2, k: int = K,
                device="cuda", sort_chunk: int = SORT_CHUNK):
    """Count ``chunks`` synthesized chunks of ``chunk`` bases into one
    accumulator of ``capacity`` slots on ``device``. Returns (record,
    keys uint64, counts int64): the record is the JSON line's dict.

    Every window is valid, so the counts must sum to chunks * (chunk -
    k + 1): anything else raises. More than ``capacity`` distinct
    k-mers raise CountCapacityOverflow."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    launches0 = (pack_canonical_windows.launches, sort_chunks_runs.launches,
                 chunk_runs.launches, merge_accum.launches)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    synth = ChunkSynthesizer(
        torch.from_numpy(reference_chunk(chunk, ref_log2)).to(dev))
    valid = torch.ones(chunk, dtype=torch.bool, device=dev)
    # each chunk merges from one accumulator into the other
    acc = empty_accumulator(capacity, dev)
    spare = empty_accumulator(capacity, dev)
    max_unique = torch.zeros((), dtype=torch.int64, device=dev)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def one_chunk(idx):
        nonlocal acc, spare
        rkeys, rlen = count_chunk_device(synth(idx), valid, k, canonical=True,
                                         sort_chunk=sort_chunk)
        acc, spare = merge_accum_device(acc, rkeys, rlen, spare,
                                        sort_chunk=sort_chunk), acc
        torch.maximum(max_unique, acc[2], out=max_unique)

    # the warm chunk (kernel load, allocator growth) is timed apart
    t0 = time.perf_counter()
    one_chunk(0)
    sync()
    first_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for idx in range(1, chunks):
        one_chunk(idx)
    sync()
    steady_s = time.perf_counter() - t0
    if int(max_unique) > capacity:
        raise CountCapacityOverflow(capacity)

    # the one readback of the table, timed apart from the counting rate
    t0 = time.perf_counter()
    acc_keys, acc_cnt, n_unique = acc
    nu = int(n_unique)
    keys = i64_to_u64(acc_keys[:nu].cpu().numpy())
    cnt = acc_cnt[:nu].cpu().numpy()
    readback_s = time.perf_counter() - t0

    windows = chunks * (chunk - k + 1)
    total = int(cnt.sum())
    if total != windows or (cnt <= 0).any():
        raise AssertionError("counts sum to %d, expected %d windows"
                             % (total, windows))
    bases = chunks * chunk
    record = {
        "metric": "count_gb_scale_device_kmers_per_s",
        "value": ((chunks - 1) * (chunk - k + 1) / steady_s
                  if chunks > 1 else None),
        "unit": "kmers/s",
        "bases_counted": bases,
        "gb_of_reads_equiv": bases * 2.4 / 1e9,
        "distinct_kmers": len(keys),
        "accumulator_slots": capacity,
        "hbm_envelope_mb": (torch.cuda.max_memory_allocated(dev) / 1e6
                            if on_card else None),
        "host_rss_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        / 1024,
        "first_chunk_incl_compile_s": first_s,
        "steady_wall_s": steady_s,
        "final_readback_s": readback_s,
        "final_readback_mb": nu * 16 / 1e6,
        "device": str(dev),
        "chunks": chunks,
        "total_kmers": total,
        "pack_launches": pack_canonical_windows.launches - launches0[0],
        "sort_runs_launches": sort_chunks_runs.launches - launches0[1],
        "chunk_runs_launches": chunk_runs.launches - launches0[2],
        "merge_accum_launches": merge_accum.launches - launches0[3],
    }
    return record, keys, cnt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chunks", type=int, default=64,
                    help="chunks of 2^24 bases (default 64: 2^30 bases)")
    ap.add_argument("--capacity", type=int, default=23, metavar="LOG2",
                    help="log2 of the accumulator's slots (default 23)")
    ap.add_argument("--chunk", type=int, default=24, metavar="LOG2",
                    help="log2 of the bases per chunk (default 24; smaller "
                         "for a trial run on the CPU)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    opts = ap.parse_args(argv)
    record, _keys, _cnt = scale_count(
        opts.chunks, 1 << opts.capacity, chunk=1 << opts.chunk,
        ref_log2=min(REF_LOG2, opts.chunk), device=opts.device)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
