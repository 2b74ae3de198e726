"""Batched catalog mode for find_mutation (``--batch``).

The pipeline runs through models.batch.run_catalog with the count table
moved to the device the user named (``--device``, 'cuda' by default),
where the walk, the Dijkstra sweeps and the NNLS refinement of every
target run ('cpu' runs them on CPU tensors). 'host' keeps km_tpu's
numpy table and host stages. Rows are the same as sequential mode's.
Replaces the reference's one-process-per-target shell loop (reference:
example/run_leucegene.sh:29-35).
"""

from __future__ import annotations

import sys

from ..models.batch import run_catalog
from ..ops.device_table import DeviceCountTable
from ..utils import profiling


def prepare_table(table, device: str = "cuda"):
    """The table to run the batched pipeline with: the host table for
    'host', else a DeviceCountTable on ``device`` (which raises when
    that device is absent)."""
    if device == "host":
        return table
    with profiling.phase("table_to_device"):
        return DeviceCountTable.from_host(table, device=device)


def emit_batched(targets, table, args) -> None:
    table = prepare_table(table, device=getattr(args, "device", "cuda"))
    with profiling.phase("batch_pipeline"):
        # on_budget='skip': one runaway target loses only its own rows
        # (with km's error line on stderr), matching the blast radius
        # of the reference's one-process-per-target loop
        row_lists = run_catalog(
            targets, table, ratio=args.ratio, count=args.count,
            max_stack=args.steps, max_break=args.branchs,
            max_node=args.nodes, graphical=args.graphical,
            on_budget="skip")
    for rows in row_lists:
        for row in rows:
            sys.stdout.write(str(row) + "\n")
