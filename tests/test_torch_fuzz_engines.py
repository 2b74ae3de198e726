"""The port as the fourth engine of the cross-engine fuzz: on the
synthesized samples of tests/test_fuzz_engines.py (the same 8 seeds,
random targets with planted substitutions, indels and tandem
duplications), the port's device path on a CPU table gives rows
byte-identical to km_tpu's exact sequential engine."""

import numpy as np
import pytest

import torch

from km_tpu.models.finder import VariantFinder
from km_tpu.models.sequence import TargetSeq
from km_tpu.models.table import CountTable
from km_tpu.ops import count as opcount

from km_tpu_torch import convert
from km_tpu_torch.models.batch import run_catalog
from km_tpu_torch.ops.device_table import DeviceCountTable

from test_fuzz_engines import K, _linear_seq, _mutate, _sample_table

# the device path on CPU tensors is thousands of small ops: one intra-op
# thread each, so that parallel test workers do not oversubscribe the
# cores
torch.set_num_threads(1)


def _scenario(seed):
    """tests/test_fuzz_engines.py's scenario for ``seed``: three targets,
    one sample table each, merged into one table."""
    rng = np.random.default_rng(seed)
    targets, tables = [], []
    for t in range(3):
        ref = _linear_seq(rng, int(rng.integers(150, 260)))
        alt = _mutate(rng, ref)
        if t == 2:  # one target carries TWO variants (cluster pressure)
            seqs = [ref, alt, _mutate(rng, ref)]
        else:
            seqs = [ref, alt]
        targets.append(TargetSeq(ref, "T%d" % t, K))
        tables.append(_sample_table(rng, seqs))
    keys = np.concatenate([t.keys for t in tables])
    counts = np.concatenate([np.asarray(t.counts, np.int64) for t in tables])
    order = np.argsort(keys, kind="stable")
    mk, mc = opcount.merge_runs(np.empty(0, np.uint64), np.empty(0, np.int64),
                                keys[order], counts[order])
    table = CountTable.from_arrays(mk, mc.astype(np.uint32), K, True,
                                   name="fuzz", presorted=True)
    return targets, table


@pytest.mark.parametrize("seed", [11, 22, 33, 44, 55, 66, 77, 88])
def test_port_device_path_agrees_with_exact_engine(seed):
    targets, table = _scenario(seed)
    exact = []
    for tgt in targets:
        f = VariantFinder(tgt, table)
        f.find_alt_paths()
        f.quantify_paths()
        f.quantify_clusters()
        exact.append([str(r) for r in f.sorted_rows()])
    assert any(len(rows) > 1 for rows in exact)  # variants were planted

    port = run_catalog(
        [convert.target_from_km_tpu(t) for t in targets],
        DeviceCountTable.from_host(convert.count_table_from_km_tpu(table),
                                   device="cpu"))
    assert [[str(r) for r in rows] for rows in port] == exact
