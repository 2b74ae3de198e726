"""The full pipeline step over a 2-D (reads, shard) DeviceMesh, ported
from km_tpu/parallel/pipeline_step.py.

Mesh axes (see parallel/__init__.py): READS_AXIS is data-parallel, each
row with its own read chunks and queries; SHARD_AXIS holds the count
table's key ranges, one per rank of the row's shard group.

One step, on every rank:
1. count the rank's read chunk (K1 and K2);
2. exchange the (key, count) runs over the shard group and sum them
   exactly at their owner (sharded_table.count_exchange);
3. look up the rank's slice of the row's queries, routed to their owner
   (ShardedCountTable.lookup_routed);
4. look up the four children of each query the same way and threshold
   them: count >= max(sum of the four * ratio, n_cutoff), in float64 as
   in km and the port's DeviceCountTable (km_tpu computes it in float32,
   :111-114).

km_tpu's step also returns the runs and queries its fixed-size buckets
dropped; here the exchanges carry exactly what is sent, so nothing can
drop and there is no such count.
"""

from __future__ import annotations

import numpy as np
import torch

from km_tpu.models.table import CountTable

from ..device import i64_to_u64, to_device_keys
from ..ops.device_table import child_keys
from .distributed import READS_AXIS, SHARD_AXIS, local_device
from .sharded_table import ShardedCountTable, count_exchange


def full_step(mesh, codes: torch.Tensor, valid: torch.Tensor,
              table: ShardedCountTable, queries: torch.Tensor,
              ratio: float = 0.05, n_cutoff: int = 5):
    """One step on this rank. ``table`` is sharded over
    ``mesh.get_group(SHARD_AXIS)``; ``codes``/``valid`` are this rank's
    chunk and ``queries`` its int64 query slice. Returns (the run keys
    and counts this rank owns, summed; the queries' counts; the child
    mask [Q, 4])."""
    delta_keys, delta_counts, _ = count_exchange(
        codes, valid, table.k, canonical=table.canonical,
        group=mesh.get_group(SHARD_AXIS))
    tips = table.lookup_routed(queries)
    children = table.lookup_routed(child_keys(queries, table.k))
    sums = children.sum(dim=-1, keepdim=True).to(torch.float64)
    thr = torch.clamp(sums * float(ratio), min=float(n_cutoff))
    return delta_keys, delta_counts, tips, children.to(torch.float64) >= thr


def demo_step(mesh, k: int = 31, chunk: int = 4096,
              queries_per_row: int = 256):
    """km_tpu's demo_step inputs, made from the same seed, through one
    :func:`full_step` on this rank of ``mesh`` (from
    ``distributed.global_mesh(device, reads=R)``).
    Returns numpy (delta keys uint64, delta counts, tip counts, child
    mask) of this rank: the rank at (r, s) counts km_tpu's chunk [r, s]
    and looks up slice s of query row r."""
    R, S = mesh.size(0), mesh.size(1)
    r, s = mesh.get_local_rank(READS_AXIS), mesh.get_local_rank(SHARD_AXIS)
    if queries_per_row % S:
        raise ValueError("queries_per_row must split over %d shards" % S)
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, (R, S, chunk), dtype=np.uint8)
    keys = np.unique(rng.integers(0, 1 << 62, 1 << 12, dtype=np.uint64))
    counts = rng.integers(1, 100, len(keys))
    q = rng.integers(0, 1 << 62, (R, queries_per_row), dtype=np.uint64)

    dev = local_device(mesh.device_type)
    table = ShardedCountTable(
        CountTable.from_arrays(keys, counts, k, True, name="demo",
                               presorted=True),
        group=mesh.get_group(SHARD_AXIS), device=dev)
    per = queries_per_row // S
    out = full_step(mesh, torch.from_numpy(codes[r, s]).to(dev),
                    torch.ones(chunk, dtype=torch.bool, device=dev), table,
                    to_device_keys(q[r, s * per:(s + 1) * per], dev))
    dkeys, dcounts, tips, mask = (t.cpu().numpy() for t in out)
    return i64_to_u64(dkeys), dcounts, tips, mask
