"""cohort: every target of a catalog against every sample, as one
command; ported from km_tpu/tools/cohort.py.

The reference runs a cohort as nested shell loops, one
``km find_mutation | km find_report`` process per (sample, target) pair
(reference: example/run_leucegene.sh:29-35). Here:

- **processes** split the samples: under torchrun (``python -m
  torch.distributed.run --nproc_per_node=N -m km_tpu_torch cohort ...``)
  process i takes samples i, i+N, ... (parallel.distributed.
  local_read_shards), each on its own card, ``cuda:LOCAL_RANK``;
- **a sample** given as a ``.jf``/``.npz`` table is loaded; any other is
  read as FASTQ/FASTA and counted by the process that owns it, with
  ``count_read_files`` on its own device, with the ``--mode`` given (as
  in ``count``). No collective runs inside a
  sample: processes hold different samples, as km_tpu counts per
  process when more than one runs (km_tpu/tools/count.py:57-65);
- **targets** run as one batched pipeline per sample (models.batch.
  run_catalog) on the table moved to ``--device``, one runaway target
  losing only its own rows (``on_budget="skip"``);
- **reports**: each target's rows go through find_report, one
  file per pair, ``<outdir>/<sample>/<target>.tsv``, as in the
  reference recipe.

km_tpu's switch ``KM_TPU_COHORT_SHARDED`` is gone: ``--device`` names
the device, and nothing else picks it.
"""

from __future__ import annotations

import io
import os
import sys
import time
from argparse import Namespace
from contextlib import redirect_stdout

from ..io.fasta import expand_target_files, read_target
from ..models.batch import run_catalog
from ..models.quant import PathRow
from ..models.sequence import TargetSeq
from ..models.table import CountTable
from ..ops import merge, pack, sort_runs
from ..parallel import distributed
from .batchmode import prepare_table
from .count import count_read_files
from .find_mutation import load_table
from .find_report import create_report


def _table_for_sample(sample: str, args, device):
    """A count table for one sample: a .jf/.npz table is loaded; any
    other file is counted as reads on ``device`` (a torch device, or
    'host')."""
    if sample.endswith((".jf", ".npz")):
        table = load_table(sample)
        table.name = sample
        return table
    keys, counts = count_read_files(
        [sample], args.k, canonical=True, min_count=args.lower_count,
        min_quality=args.min_quality, device=device,
        mode=getattr(args, "mode", "auto"))
    return CountTable.from_arrays(keys, counts, args.k, True, name=sample,
                                  presorted=True)


def _report_rows(rows, target_path, args, out_path):
    """One target's find_mutation rows -> a find_report file (the
    reference pipe ``find_mutation | find_report -t target``)."""
    text = PathRow.HEADER + "\n" + "".join(str(r) + "\n" for r in rows)
    rargs = Namespace(target=target_path, infile=io.StringIO(text),
                      info=args.info, min_cov=args.min_cov,
                      exclu=args.exclu, format=args.format)
    with open(out_path, "w") as f, redirect_stdout(f):
        create_report(rargs)


def main_cohort(args, argparser):
    """One line on stderr per sample with its seconds (table, catalog,
    reports); the last line also gives the launches of the counting
    kernels in this command."""
    t0 = time.time()
    counters = (pack.pack_canonical_windows, sort_runs.sort_chunks_runs,
                merge.chunk_runs, merge.merge_accum, merge.cut)
    launches0 = [fn.launches for fn in counters]
    targets, paths = [], []
    for seq_f in expand_target_files([args.targets]):
        name, _ = os.path.splitext(os.path.basename(seq_f))
        seqs, _attrs = read_target(seq_f)
        paths.append((name, seq_f))
        targets.append(("".join(seqs), name))

    with distributed.session(args.device):
        rank = distributed.process_index()
        n_procs = distributed.process_count()
        my_samples = distributed.local_read_shards(args.samples)
        device = (args.device if args.device == "host"
                  else distributed.local_device(args.device))
        for sample in my_samples:
            s0 = time.time()
            table = _table_for_sample(sample, args, device)
            sample_name = os.path.splitext(os.path.basename(sample))[0]
            outdir = os.path.join(args.outdir, sample_name)
            os.makedirs(outdir, exist_ok=True)
            tgt_objs = [TargetSeq(seq, name, table.k)
                        for seq, name in targets]
            s1 = time.time()
            row_lists = run_catalog(
                tgt_objs, prepare_table(table, device), ratio=args.ratio,
                count=args.count, max_stack=args.steps,
                max_break=args.branchs, max_node=args.nodes,
                on_budget="skip")
            s2 = time.time()
            for (name, seq_f), rows in zip(paths, row_lists):
                _report_rows(rows, seq_f, args,
                             os.path.join(outdir, name + ".tsv"))
            s3 = time.time()
            sys.stderr.write("cohort: %s -> %d targets in %s (%.3f s: table "
                             "%.3f, catalog %.3f, reports %.3f)\n"
                             % (sample_name, len(paths), outdir, s3 - s0,
                                s1 - s0, s2 - s1, s3 - s2))
    if not my_samples:
        sys.stderr.write("cohort: no samples for process %d\n" % rank)
    sys.stderr.write("cohort: done in %.3fs (%d sample(s) on process %d/%d; "
                     "kernel launches: pack %d, sort_runs %d, chunk_runs %d, "
                     "merge_accum %d, cut %d)\n"
                     % (time.time() - t0, len(my_samples), rank, n_procs,
                        *(fn.launches - n0
                          for fn, n0 in zip(counters, launches0))))
