"""km_tpu_torch's device walk (on CPU tensors) against km_tpu's
``device_discover`` (JAX on the CPU) given the same capacities: the
same committed node order per target, exactly; and against the
sequential ``Walker``: the same node set and counts. Overflow retries,
depth retries, the node budget and the child threshold's precision are
each forced once."""

import os

import numpy as np
import pytest

import torch

from km_tpu.io.fasta import read_target
from km_tpu.models.sequence import TargetSeq
from km_tpu.models.table import CountTable
from km_tpu.models.walk import Walker
from km_tpu.ops import encode
from km_tpu.ops.batch_walk import device_discover as jax_discover
from km_tpu.ops.device_table import DeviceCountTable as JaxTable

from km_tpu_torch import convert
from km_tpu_torch.models.batch import batch_discover
from km_tpu_torch.models.walk import NodeBudgetExceeded
from km_tpu_torch.models.walk import Walker as PortWalker
from km_tpu_torch.ops import batch_walk
from km_tpu_torch.ops.device_table import DeviceCountTable

from helpers import REFDATA
from test_device_walk import CASES

# the device path on CPU tensors is thousands of small ops: one intra-op
# thread each, so that parallel test workers do not oversubscribe the
# cores
torch.set_num_threads(1)

CAT = f"{REFDATA}/catalog/GRCh38"


def _target(name, k):
    seqs, _ = read_target(f"{CAT}/{name}.fa")
    return TargetSeq("".join(seqs), name, k)


def _catalog(k):
    return [_target(os.path.splitext(fn)[0], k)
            for fn in sorted(os.listdir(CAT))]


def _port_table(host):
    """The port's table on CPU tensors from km_tpu's host table, through
    the port's own CountTable (convert: numpy arrays, no shared object)."""
    return DeviceCountTable.from_host(convert.count_table_from_km_tpu(host),
                                      device="cpu")


def _orders(result):
    return [None if r is None else list(r) for r in result]


def _both(mers, host, **kw):
    """(km_tpu's result, the port's result) on the same inputs."""
    want = jax_discover(mers, JaxTable.from_host(host), **kw)
    got = batch_walk.device_discover(mers, _port_table(host), **kw)
    return want, got


@pytest.mark.parametrize("target_name,jf_name", CASES)
def test_fixture_orders_match_km_tpu_and_walker(target_name, jf_name):
    host = CountTable.from_jf(f"{REFDATA}/jf/{jf_name}.jf")
    target = _target(target_name, host.k)
    want, got = _both([target.ref_mer], host, walklet_cap=256)
    assert _orders(got) == _orders(want)
    assert got == want  # counts too
    exact = Walker(host, ratio=0.05, count=5).discover(target.ref_mer)
    assert set(got[0]) == set(exact)
    assert got[0] == {k: exact[k] for k in got[0]}


@pytest.mark.parametrize("caps", [
    dict(),  # the defaults: a 512-slot pool
    # a small pool and small buffers force overflow retries
    dict(walklet_cap=8, copy_cap=1, commit_cap=1, log_cap=2),
    # a shallow stack forces depth retries
    dict(stack_cap=8),
], ids=["defaults", "overflow", "depth"])
def test_catalog_orders_match_km_tpu(caps):
    """The 9 catalog targets cycled to 45: on each bundled table only
    the matching target branches, so the cycle makes the commits."""
    host = CountTable.from_jf(f"{REFDATA}/jf/03H116_ITD.jf")
    mers = [t.ref_mer for t in _catalog(host.k)] * 5
    kw = dict(caps)
    if "stack_cap" not in kw:
        kw["stack_cap"] = 64  # km_tpu learns S across calls otherwise
    want, got = _both(mers, host, **kw)
    assert _orders(got) == _orders(want)
    assert got == want
    stats = batch_walk.device_discover.stats
    if caps:
        assert stats["retries"] > 0
    if "copy_cap" in caps:
        assert stats["walklets"] > 8
    if "stack_cap" in caps:
        assert stats["stack"] > 8


def test_walker_agrees_on_catalog():
    host = CountTable.from_jf(f"{REFDATA}/jf/02H025_NPM1.jf")
    targets = _catalog(host.k)
    got = batch_walk.device_discover(
        [t.ref_mer for t in targets], _port_table(host))
    for t, nodes in zip(targets, got):
        exact = Walker(host, ratio=0.05, count=5).discover(t.ref_mer)
        assert nodes == {k: exact[k] for k in nodes}
        assert set(nodes) == set(exact)


def test_node_budget_skip_and_raise():
    host = CountTable.from_jf(f"{REFDATA}/jf/03H116_ITD.jf")
    mers = [t.ref_mer for t in _catalog(host.k)]
    sizes = [len(m) for m in mers]
    max_node = sorted(sizes)[len(sizes) // 2] + 2  # some targets overrun
    want, got = _both(mers, host, max_node=max_node, on_budget="skip",
                      stack_cap=64)
    # a target whose own k-mers outnumber the budget: the port fails it
    # before it walks, as the sequential Walker does at its first call;
    # km_tpu's device walk reads the budget only after a commit, so it
    # fails such a target only if it commits
    oversize = [size > max_node for size in sizes]
    assert any(oversize) and not all(oversize)
    for big, w, g, m in zip(oversize, _orders(want), _orders(got), mers):
        if big:
            assert g is None and (w is None or w == m.tolist())
            with pytest.raises(NodeBudgetExceeded):
                PortWalker(convert.count_table_from_km_tpu(host), 0.05, 5,
                           max_node=max_node).discover(m)
        else:
            assert g == w and g is not None
    assert any(w is None for w in want) and any(
        big and w is not None for big, w in zip(oversize, want))
    with pytest.raises(NodeBudgetExceeded):
        batch_walk.device_discover(mers, _port_table(host),
                                   max_node=max_node)


def test_check_every_changes_nothing(monkeypatch):
    """The exit test read every round or every 8 rounds: the same
    result, since rounds past the exit change no state."""
    host = CountTable.from_jf(f"{REFDATA}/jf/03H112_IandI.jf")
    table = _port_table(host)
    mers = [t.ref_mer for t in _catalog(host.k)]
    kw = dict(copy_cap=4, commit_cap=4, log_cap=8, stack_cap=16)
    monkeypatch.setattr(batch_walk, "CHECK_EVERY", 1)
    one = batch_walk.device_discover(mers, table, **kw)
    rounds = batch_walk.device_discover.stats["rounds"]
    monkeypatch.setattr(batch_walk, "CHECK_EVERY", 8)
    eight = batch_walk.device_discover(mers, table, **kw)
    assert _orders(one) == _orders(eight) and one == eight
    assert batch_walk.device_discover.stats["rounds"] == rounds


def test_learned_stack_depth_is_per_table():
    """A table's walk starts at the depth that sufficed on that table
    before; another table starts at the default."""
    host = CountTable.from_jf(f"{REFDATA}/jf/02H025_NPM1.jf")
    a = _port_table(host)
    b = _port_table(host)
    mers = [_target("NPM1_4ins_exons_10-11utr", host.k).ref_mer]
    first = batch_walk.device_discover(mers, a)
    assert batch_walk.device_discover.stats["retries"] > 0  # 64 too shallow
    assert batch_walk._learned_stack_cap[a] > batch_walk.DEFAULT_STACK_CAP
    assert b not in batch_walk._learned_stack_cap
    assert batch_walk.device_discover(mers, a) == first
    assert batch_walk.device_discover.stats["retries"] == 0
    assert batch_walk.device_discover(mers, b) == first
    assert batch_walk.device_discover.stats["retries"] > 0


def _threshold_sample():
    """A 120-base target and a substitution 60 bases in. The branch
    parent's children count (16127961, 848840): sum 16976801 > 2^24, so
    the alt child fails the float64 threshold 848840.05 (ratio 0.05)
    but passes km_tpu's float32 device threshold (the input of
    test_torch_device_table.py::test_child_threshold_is_float64)."""
    k = 31
    rng = np.random.default_rng(5)
    while True:
        ref = "".join("ACGT"[b] for b in rng.integers(0, 4, 120))
        alt = ref[:60] + "ACGT"[("ACGT".index(ref[60]) + 1) % 4] + ref[61:]
        mers = {s[i:i + k] for s in (ref, alt) for i in range(len(s) - k + 1)}
        canon = encode.canonical(np.array([encode.pack_kmer(m) for m in mers],
                                          np.uint64), k)
        if len(set(canon.tolist())) == len(mers):
            break
    ref_mers = {ref[i:i + k] for i in range(len(ref) - k + 1)}
    keys, counts = [], []
    for m in sorted(mers):
        keys.append(encode.pack_kmer(m))
        counts.append(16127961 if m in ref_mers else 848840)
    keys = encode.canonical(np.array(keys, np.uint64), k)
    table = CountTable.from_arrays(keys, np.array(counts, np.uint32), k, True)
    return TargetSeq(ref, "threshold", k), table


def test_float_threshold_follows_the_port_host_walk():
    target, host = _threshold_sample()
    table = _port_table(host)
    got = batch_walk.device_discover([target.ref_mer], table)[0]
    want = batch_discover([convert.target_from_km_tpu(target)], table)[0]
    assert got == want
    assert set(got) == set(target.ref_mer.tolist())  # the alt is not walked
    # km_tpu's float32 device threshold walks the alt path
    jax_nodes = jax_discover([target.ref_mer], JaxTable.from_host(host),
                             stack_cap=64)[0]
    assert len(jax_nodes) > len(got)
