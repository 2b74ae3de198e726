"""Commit-order fuzz of the walk: graphs built to stress the one place
where the device walk (rounds over a member set that is fixed within an
iteration, iterated to a fixpoint) and the sequential depth-first engine
take different routes to the same node set.

Each seed plants, on a random linear target, a mixture of
- an insertion whose middle a second branch joins: the k-mer it closes
  onto is not a target k-mer, it is committed by another walklet in the
  middle of the same iteration (before or after, by target order);
- an insertion that repeats itself, so the walk closes a loop onto its
  own stack, with an exit back to the target on the loop;
- a tandem duplication, which reconnects behind the branch point;
and sets the node budget relative to the number of nodes the walk ends
with: far above it, exactly at it (the last commit fills the budget to
the node), one below it (the last commit overruns it) and just above the
target's own k-mers (the first commit overruns it).

For every seed the port's device path on CPU tensors, the port's exact
sequential engine and km_tpu's exact sequential engine must give the
same outcome: byte-equal rows, or the budget overrun. km_tpu's own
device walk joins on a few seeds."""

import numpy as np
import pytest

import torch

from km_tpu.models.finder import VariantFinder as KmFinder
from km_tpu.models.sequence import TargetSeq as KmTargetSeq
from km_tpu.models.table import CountTable as KmCountTable
from km_tpu.models.walk import NodeBudgetExceeded as KmBudget

from km_tpu_torch.models.batch import run_catalog
from km_tpu_torch.models.finder import VariantFinder
from km_tpu_torch.models.sequence import TargetSeq
from km_tpu_torch.models.table import CountTable
from km_tpu_torch.models.walk import NodeBudgetExceeded, Walker
from km_tpu_torch.ops import encode
from km_tpu_torch.ops.device_table import DeviceCountTable

torch.set_num_threads(1)

K = 17
BASES = "ACGT"
BUDGETS = ("default", "exact", "one_below", "first_commit")
BREAKS = (10, 10, 2, 1)  # max_break: km's default, and two that bind
TIER1_SEEDS = list(range(48))
SLOW_SEEDS = list(range(48, 200))


def _bases(rng, n):
    return "".join(BASES[b] for b in rng.integers(0, 4, n))


def _kmers(seq):
    return [seq[i:i + K] for i in range(len(seq) - K + 1)]


def _variants(rng, ref):
    """(sequences with their coverage, the kinds planted)."""
    n = len(ref)
    seqs, kinds = [], []
    for _ in range(int(rng.integers(1, 4))):
        kind = str(rng.choice(["join", "loop", "dup"]))
        kinds.append(kind)
        p1 = int(rng.integers(K + 3, n - K - 3))
        cov = int(rng.integers(15, 45))
        if kind == "join":
            # a second branch leaves the target at p2, before or after
            # p1, and closes onto the middle of the first insertion
            ins = _bases(rng, int(rng.integers(K + 4, 2 * K)))
            p2 = int(rng.integers(K + 3, n - K - 3))
            m = int(rng.integers(2, len(ins) - K))
            bridge = _bases(rng, int(rng.integers(1, K)))
            seqs.append((ref[:p1] + ins + ref[p1:], cov))
            seqs.append((ref[:p2] + bridge + ins[m:] + ref[p1:],
                         int(rng.integers(15, 45))))
        elif kind == "loop":
            # the insertion repeats a unit longer than k: the walk comes
            # back onto its own stack, and the loop has an exit
            unit = _bases(rng, int(rng.integers(K + 2, K + 10)))
            seqs.append((ref[:p1] + unit + unit + ref[p1:], cov))
        else:
            d = int(rng.integers(4, K + 6))
            seqs.append((ref[:p1] + ref[max(p1 - d, 0):p1] + ref[p1:], cov))
    return seqs, kinds


def _table_arrays(seqs):
    keys = np.concatenate([encode.canonical(encode.pack_kmers(s, K), K)
                           for s, _ in seqs])
    weights = np.concatenate([np.full(len(s) - K + 1, c, np.int64)
                              for s, c in seqs])
    uk, inv = np.unique(keys, return_inverse=True)
    counts = np.zeros(len(uk), np.int64)
    np.add.at(counts, inv, weights)
    return uk, counts.astype(np.uint32)


def scenario(seed):
    """(target sequence, table keys, table counts, max_node, max_break,
    kinds planted, kind of budget, nodes the walk ends with) for
    ``seed``; the kind of budget and max_break cycle with the seed."""
    rng = np.random.default_rng(1000 + seed)
    while True:
        ref = _bases(rng, int(rng.integers(90, 150)))
        if len(set(_kmers(ref))) == len(ref) - K + 1:
            break
    variants, kinds = _variants(rng, ref)
    keys, counts = _table_arrays([(ref, 60)] + variants)
    table = CountTable.from_arrays(keys, counts, K, True, name="fuzz",
                                   presorted=True)
    target = TargetSeq(ref, "T", K)
    max_break = BREAKS[(seed // len(BUDGETS)) % len(BREAKS)]
    nodes = Walker(table, 0.05, 5, max_break=max_break).discover(
        target.ref_mer)
    budget = BUDGETS[seed % len(BUDGETS)]
    max_node = {"default": 10000, "exact": len(nodes),
                "one_below": len(nodes) - 1,
                "first_commit": len(target.ref_mer) + 1}[budget]
    return ref, keys, counts, max_node, max_break, kinds, budget, len(nodes)


def _exact_rows(finder_cls, budget_cls, target, table, max_node, max_break):
    try:
        f = finder_cls(target, table, max_node=max_node, max_break=max_break)
        f.find_alt_paths()
        f.quantify_paths()
        f.quantify_clusters()
    except budget_cls:
        return "budget"
    return [str(r) for r in f.sorted_rows()]


def outcomes(seed):
    """{engine: rows or 'budget'} for the seed's scenario."""
    ref, keys, counts, max_node, max_break = scenario(seed)[:5]
    table = CountTable.from_arrays(keys, counts, K, True, name="fuzz",
                                   presorted=True)
    km_table = KmCountTable.from_arrays(keys, counts, K, True, name="fuzz",
                                        presorted=True)
    out = {}
    try:
        out["port_device"] = [str(r) for r in run_catalog(
            [TargetSeq(ref, "T", K)],
            DeviceCountTable.from_host(table, device="cpu"),
            max_node=max_node, max_break=max_break)[0]]
    except NodeBudgetExceeded:
        out["port_device"] = "budget"
    out["port_exact"] = _exact_rows(VariantFinder, NodeBudgetExceeded,
                                    TargetSeq(ref, "T", K), table, max_node,
                                    max_break)
    out["km_tpu_exact"] = _exact_rows(KmFinder, KmBudget,
                                      KmTargetSeq(ref, "T", K), km_table,
                                      max_node, max_break)
    return out


def _check(seed):
    out = outcomes(seed)
    assert out["port_exact"] == out["km_tpu_exact"]
    assert out["port_device"] == out["port_exact"]
    budget = scenario(seed)[6]
    if budget in ("default", "exact"):
        assert out["port_exact"] != "budget" and len(out["port_exact"]) >= 1
    if budget == "one_below":
        assert out["port_exact"] == "budget"


@pytest.mark.parametrize("seed", TIER1_SEEDS)
def test_commit_order_family(seed):
    _check(seed)


@pytest.mark.slow
@pytest.mark.parametrize("seed", SLOW_SEEDS)
def test_commit_order_family_more_seeds(seed):
    _check(seed)


def test_family_is_adversarial():
    """What the generator is for really happens: every kind is planted;
    on most seeds the device walk commits in another order than the
    depth-first engine (the rows above are equal all the same); walks
    take a second fixpoint iteration; each kind of budget occurs, and
    'exact' fills the budget to the node without an overrun."""
    from km_tpu_torch.ops import batch_walk

    kinds, budgets = set(), set()
    reordered = iterated = 0
    seeds = TIER1_SEEDS[:16]
    for seed in seeds:
        ref, keys, counts, max_node, max_break, planted, budget, n = \
            scenario(seed)
        kinds.update(planted)
        budgets.add(budget)
        table = CountTable.from_arrays(keys, counts, K, True, presorted=True)
        target = TargetSeq(ref, "T", K)
        exact = Walker(table, 0.05, 5, max_break=max_break).discover(
            target.ref_mer)
        assert len(exact) == n
        if budget == "exact":
            assert max_node == n > len(target.ref_mer)
        dev = batch_walk.device_discover(
            [target.ref_mer], DeviceCountTable.from_host(table, device="cpu"),
            max_break=max_break)[0]
        assert dev == {key: exact[key] for key in dev}
        assert set(dev) == set(exact)
        reordered += list(dev) != list(exact)
        iterated += batch_walk.device_discover.stats["iterations"] > 1
    assert kinds == {"join", "loop", "dup"}
    assert budgets == set(BUDGETS)
    assert reordered >= len(seeds) // 2
    assert iterated >= len(seeds) // 2


@pytest.mark.parametrize("seed", [1, 5, 14, 21])
def test_km_tpu_device_walk_gives_the_same_rows(seed):
    """km_tpu's batched pipeline with its device walk (JAX on the CPU)
    on the same scenario: the port's rows."""
    from km_tpu.models.batch import run_catalog as km_run_catalog
    from km_tpu.ops.device_table import DeviceCountTable as KmDeviceTable

    ref, keys, counts, max_node, max_break = scenario(seed)[:5]
    km_table = KmCountTable.from_arrays(keys, counts, K, True, name="fuzz",
                                        presorted=True)
    try:
        want = [str(r) for r in km_run_catalog(
            [KmTargetSeq(ref, "T", K)], KmDeviceTable.from_host(km_table),
            walk="device", max_node=max_node, max_break=max_break)[0]]
    except KmBudget:
        want = "budget"
    assert outcomes(seed)["port_device"] == want


# seeds of the 400 explored whose target alone outnumbers the budget
# while max_break lets nothing commit
@pytest.mark.parametrize("seed", [190, 222, 350])
def test_budget_below_the_target_itself_is_an_overrun(seed):
    """The target's own k-mers outnumber max_node by one and the walk
    commits nothing. The sequential engines (km's rule: the budget is
    read at every call, the first included) overrun; km_tpu's device
    walk reads the budget only after a commit of depth 2 or more and
    gives rows. The port's batch walks read it before the walk too, and
    agree with the sequential engine."""
    from km_tpu.models.batch import run_catalog as km_run_catalog
    from km_tpu.ops.device_table import DeviceCountTable as KmDeviceTable

    ref, keys, counts, max_node, max_break, _kinds, budget, n = \
        scenario(seed)
    target = TargetSeq(ref, "T", K)
    assert budget == "one_below" and n == len(target.ref_mer) == max_node + 1
    out = outcomes(seed)
    assert out["port_device"] == out["port_exact"] == out["km_tpu_exact"] \
        == "budget"
    table = CountTable.from_arrays(keys, counts, K, True, presorted=True)
    with pytest.raises(NodeBudgetExceeded):
        run_catalog([target], table, walk="host", max_node=max_node,
                    max_break=max_break)
    for dev in (table, DeviceCountTable.from_host(table, device="cpu")):
        assert run_catalog([target], dev, max_node=max_node,
                           max_break=max_break, on_budget="skip") == [[]]
    km_table = KmCountTable.from_arrays(keys, counts, K, True, name="fuzz",
                                        presorted=True)
    rows = km_run_catalog([KmTargetSeq(ref, "T", K)],
                          KmDeviceTable.from_host(km_table), walk="device",
                          max_node=max_node, max_break=max_break)
    assert len(rows[0]) == 1  # km_tpu's device walk: the reference row


# (seed, max_stack): a depth budget that cuts the joining branch before
# it is back on the target
@pytest.mark.parametrize("seed,max_stack", [(18, 46), (66, 48), (89, 44)])
def test_binding_max_stack_device_walk_is_a_superset(seed, max_stack):
    """The one documented difference of the device walk
    (km_tpu/ops/batch_walk.py:30-37), pinned: with a max_stack that
    binds, a branch that joins another insertion is cut by the
    depth-first engine when it is walked before that insertion is
    committed, and is never walked again; the fixpoint walks it again
    in the next iteration, where it closes onto the committed k-mers.
    So the device walk ends with more nodes. The port follows km_tpu's
    device walk to the letter here: the same nodes in the same order."""
    from km_tpu.ops.batch_walk import device_discover as km_discover
    from km_tpu.ops.device_table import DeviceCountTable as KmDeviceTable

    from km_tpu_torch.ops import batch_walk

    ref, keys, counts = scenario(seed)[:3]
    table = CountTable.from_arrays(keys, counts, K, True, presorted=True)
    target = TargetSeq(ref, "T", K)
    exact = Walker(table, 0.05, 5, max_stack=max_stack).discover(
        target.ref_mer)
    dev = batch_walk.device_discover(
        [target.ref_mer], DeviceCountTable.from_host(table, device="cpu"),
        max_stack=max_stack)[0]
    assert set(exact) < set(dev)
    assert batch_walk.device_discover.stats["iterations"] >= 2
    km_table = KmCountTable.from_arrays(keys, counts, K, True, name="fuzz",
                                        presorted=True)
    km_dev = km_discover([KmTargetSeq(ref, "T", K).ref_mer],
                         KmDeviceTable.from_host(km_table),
                         max_stack=max_stack)[0]
    assert list(dev) == list(km_dev) and dev == km_dev
    # without the depth budget both engines end with the same nodes
    assert set(Walker(table, 0.05, 5).discover(target.ref_mer)) == set(
        batch_walk.device_discover(
            [target.ref_mer],
            DeviceCountTable.from_host(table, device="cpu"))[0])
