"""The port's scale-out layer (km_tpu_torch.parallel) under gloo, in 2
and 4 spawned processes on the CPU, held exactly against km_tpu's
parallel layer on the 8-device virtual mesh and against the host table
and counter: the sharded lookups, routed and broadcast; sharded
counting; save and load between the packages; the 2-D pipeline step;
the process helpers and initialize; and the owner rule of the counting
exchange, where km_tpu sends every run to shard 0.

Each world size is one spawn of ranks that run every check and write
their results; the tests read them. The ranks import nothing of km_tpu
(and so no JAX): this module's top level imports the port alone, and
km_tpu is imported only inside the tests that compare with it.
A test marked ``cuda`` runs the same ranks under NCCL on two or four
cards and holds them to the gloo ranks.
"""

import functools
import os
import socket
import sys
import time
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from km_tpu_torch.models.table import CountTable as PortTable
from km_tpu_torch.ops import encode
from km_tpu_torch.parallel import distributed
from km_tpu_torch.parallel.pipeline_step import demo_step
from km_tpu_torch.parallel.sharded_table import (ShardedCountTable,
                                                 owner_of, sharded_count)
from km_tpu_torch.refdata import DATA_DIR as REFDATA

torch.set_num_threads(1)

NPM1 = f"{REFDATA}/jf/02H025_NPM1.jf"
K = 21
# name -> (seed, bases, alphabet, chunk sizes); as tests/test_parallel.py
COUNT_INPUTS = {
    "wide": (4, 200_000, b"ACGT", (1 << 15,)),
    "small": (11, 6000, b"ACGT", (1 << 10, 1 << 12)),
    "ac_only": (12, 3000, b"AC", (1 << 10,)),
}
SAMPLES = ["s%d" % i for i in range(7)]
SPAWN_TIMEOUT_S = 300


def _km_tpu():
    """(km_tpu's host CountTable, its count_batches_host), imported only
    when a test calls this: the spawned ranks import this module too."""
    from km_tpu.models.table import CountTable
    from km_tpu.ops.count import count_batches_host

    return CountTable, count_batches_host


def foreign_modules():
    """Loaded modules that the port must not pull in: km_tpu and jax."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("km_tpu", "jax"))


def _batch(seed, n, alphabet):
    rng = np.random.default_rng(seed)
    seq = rng.choice(np.frombuffer(alphabet, np.uint8), n).tobytes().decode()
    codes = encode.seq_to_codes(seq)
    return codes, np.ones(len(codes), bool)


def _lookup_queries(host):
    """Present keys, their reverse complements, random absent keys, the
    table's ends, and the first key of each range at 2, 4 and 8 ranges
    (the boundaries of both packages' tables)."""
    rng = np.random.default_rng(7)
    n = len(host.keys)
    present = host.keys[rng.integers(0, n, 500)]
    starts = np.concatenate([np.arange(S) * -(-n // S) for S in (2, 4, 8)])
    return np.concatenate([present, encode.revcomp(present, host.k),
                           rng.integers(0, 1 << 61, 500, dtype=np.uint64),
                           host.keys[[0, n - 1]], host.keys[starts[starts < n]]])


def _reads_rows(world):
    return 2 if world == 4 else 1


def _run_world(rank, world, tmp, kind="cpu"):
    """One rank: every check of the module, results to rank<r>.npz.
    ``kind`` 'cpu' runs gloo on CPU tensors; 'cuda' runs NCCL with one
    card per rank, LOCAL_RANK set as torchrun sets it."""
    torch.set_num_threads(1)
    if kind == "cuda":
        os.environ["LOCAL_RANK"] = str(rank)
        torch.cuda.set_device(rank)
    dist.init_process_group(distributed.BACKEND[kind],
                            init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world)
    dev = distributed.local_device(kind)
    out = {}
    host = PortTable.from_jf(NPM1)
    table = ShardedCountTable(host, device=dev)
    q = _lookup_queries(host)
    out["queries"] = q
    out["broadcast"] = table.query_packed(q, routed=False)
    out["routed"] = table.query_packed(q[rank::world])
    # every query owned by the first range; the last rank sends none
    skewed = host.keys[:table.per_shard if rank < world - 1 else 0]
    out["skewed"] = table.query_packed(skewed)

    for name, (seed, n, alphabet, chunks) in COUNT_INPUTS.items():
        for chunk in chunks:
            stats = {}
            got = sharded_count(iter([_batch(seed, n, alphabet)]), K,
                                min_count=1, chunk=chunk, device=dev,
                                stats=stats)
            out[f"{name}_{chunk}_sent"] = np.array(stats["runs_sent"])
            if got is not None:
                out[f"{name}_{chunk}_keys"], out[f"{name}_{chunk}_counts"] = got

    loaded = ShardedCountTable.load(f"{tmp}/km_tpu_saved.npz", device=dev)
    out["loaded"] = loaded.query_packed(q)
    table.save(f"{tmp}/port_saved.npz")

    mesh = distributed.global_mesh(kind, reads=_reads_rows(world))
    out["coord"] = np.array([mesh.get_local_rank(distributed.READS_AXIS),
                             mesh.get_local_rank(distributed.SHARD_AXIS)])
    (out["delta_keys"], out["delta_counts"], out["tips"],
     out["child_mask"]) = demo_step(mesh, k=31, chunk=2048,
                                    queries_per_row=128)
    out["mesh_1d"] = np.array(distributed.global_mesh(kind).mesh.shape)
    try:
        distributed.global_mesh(kind, reads=3)
        out["uneven_reads_raised"] = False
    except ValueError:
        out["uneven_reads_raised"] = True
    out["shards"] = np.array(distributed.local_read_shards(SAMPLES))
    out["index_count"] = np.array([distributed.process_index(),
                                   distributed.process_count()])
    out["foreign_modules"] = np.array(foreign_modules(), dtype=str)
    dist.destroy_process_group()
    np.savez(f"{tmp}/rank{rank}.npz", **out)


def spawn(fn, world, tmp, *args):
    """Run fn(rank, world, tmp, *args) in ``world`` spawned processes;
    fails the test when one raises or all have not ended in time."""
    ctx = mp.start_processes(fn, args=(world, str(tmp)) + args, nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("ranks did not end within %d s" % SPAWN_TIMEOUT_S)


@functools.lru_cache(maxsize=None)
def _km_tpu_table(n_devices):
    from km_tpu.parallel.sharded_table import ShardedCountTable as Km
    from km_tpu.parallel.sharded_table import make_mesh

    return Km(_km_tpu()[0].from_jf(NPM1), make_mesh(n_devices))


@functools.lru_cache(maxsize=None)
def _km_tpu_count(name, chunk, n_devices):
    from km_tpu.parallel.sharded_table import make_mesh
    from km_tpu.parallel.sharded_table import sharded_count as km_count

    seed, n, alphabet, _ = COUNT_INPUTS[name]
    return km_count(iter([_batch(seed, n, alphabet)]), make_mesh(n_devices),
                    K, canonical=True, min_count=1, chunk=chunk)


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: "world%d" % w)
def ranks(request, tmp_path_factory):
    world = request.param
    tmp = tmp_path_factory.mktemp("world%d" % world)
    _km_tpu_table(4).save(str(tmp / "km_tpu_saved.npz"))
    spawn(_run_world, world, tmp)
    return world, tmp, [dict(np.load(tmp / ("rank%d.npz" % r)))
                        for r in range(world)]


def test_sharded_lookups_match_km_tpu_and_host(ranks):
    world, _tmp, res = ranks
    host = _km_tpu()[0].from_jf(NPM1)
    q = res[0]["queries"]
    km = _km_tpu_table(8)
    want = host.query_packed(q)
    np.testing.assert_array_equal(km.query_packed(q, routed=True), want)
    np.testing.assert_array_equal(km.query_packed(q, routed=False), want)
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["queries"], q)
        np.testing.assert_array_equal(out["broadcast"], want)
        np.testing.assert_array_equal(out["routed"], want[r::world])
        n_skewed = len(out["skewed"])
        assert n_skewed == (0 if r == world - 1 else -(-len(host.keys)
                                                       // world))
        np.testing.assert_array_equal(out["skewed"],
                                      host.counts[:n_skewed])


@pytest.mark.parametrize("name", sorted(COUNT_INPUTS))
def test_sharded_count_matches_km_tpu_and_host(ranks, name):
    """Every chunk size, every world size: the host count, km_tpu's
    sharded count, and keys already sorted from the gather (owners are
    contiguous key ranges, so no host re-sort is needed)."""
    world, _tmp, res = ranks
    seed, n, alphabet, chunks = COUNT_INPUTS[name]
    hk, hc = _km_tpu()[1](iter([_batch(seed, n, alphabet)]), K,
                          canonical=True, min_count=1)
    kk, kc = _km_tpu_count(name, chunks[0], 8 if name == "wide" else 4)
    np.testing.assert_array_equal(kk, hk)
    np.testing.assert_array_equal(kc.astype(np.int64), hc.astype(np.int64))
    for chunk in chunks:
        keys = res[0][f"{name}_{chunk}_keys"]
        assert (np.diff(keys.astype(np.float64)) > 0).all()
        np.testing.assert_array_equal(keys, hk)
        np.testing.assert_array_equal(res[0][f"{name}_{chunk}_counts"], hc)
        assert all(f"{name}_{chunk}_keys" not in out for out in res[1:])
    if name == "ac_only":
        # A/C-only reads: canonical keys start with A or C, so only the
        # owners of the low key ranges receive runs, and none are lost
        sent = sum(out[f"ac_only_{chunks[0]}_sent"] for out in res)
        assert sent[0] > 0 and (sent[world // 2:] == 0).all()


def test_owner_rule_spreads_runs_where_km_tpu_funnels_to_shard_0(ranks):
    """km_tpu's counting exchange takes the owner from the top bits of
    the 64-bit word (sharded_table.py:326-328), which are 0 for k <= 31:
    every real run lands on device 0. The port's rule uses the 2k-bit
    key, and every rank receives runs."""
    import jax.numpy as jnp

    from km_tpu.parallel.sharded_table import (build_count_exchange,
                                               make_mesh)

    world, _tmp, res = ranks
    chunk = 1 << 12
    step = build_count_exchange(make_mesh(world), "shard", chunk, K,
                                canonical=True, bucket_cap=chunk)
    codes, valid = _batch(4, world * chunk, b"ACGT")
    _hi, _lo, cnt, dropped = step(jnp.asarray(codes.reshape(world, chunk)),
                                  jnp.asarray(valid.reshape(world, chunk)))
    cnt = np.asarray(cnt).reshape(world, -1)
    assert int(np.asarray(dropped).sum()) == 0
    assert (cnt[0] > 0).sum() > 1000
    assert (cnt[1:] == 0).all()  # the pinned reference defect

    sent = sum(out["wide_%d_sent" % (1 << 15)] for out in res)
    assert (sent > 0).all(), sent


@pytest.mark.parametrize("k,n_ranks", [(21, 1), (21, 3), (31, 4), (1, 8),
                                       (2, 5), (2, 8)])
def test_owner_of_is_contiguous_ranges_in_rank_order(k, n_ranks):
    rng = np.random.default_rng(k * 10 + n_ranks)
    keys = np.unique(rng.integers(0, 4 ** k, 4000, dtype=np.int64))
    keys = np.concatenate([[0], keys, [4 ** k - 1]])
    owner = owner_of(torch.from_numpy(keys), k, n_ranks).numpy()
    assert owner.min() == 0 and owner.max() <= n_ranks - 1
    if 4 ** k >= n_ranks:  # enough distinct keys to reach every rank
        assert owner.max() == n_ranks - 1
    assert (np.diff(owner) >= 0).all()  # sorted keys -> ascending owners


def test_save_and_load_between_packages(ranks):
    world, tmp, res = ranks
    from km_tpu.parallel.sharded_table import ShardedCountTable as Km
    from km_tpu.parallel.sharded_table import make_mesh

    CountTable = _km_tpu()[0]
    host = CountTable.from_jf(NPM1)
    q = res[0]["queries"]
    want = host.query_packed(q)
    for out in res:  # km_tpu's file in the port
        np.testing.assert_array_equal(out["loaded"], want)
    saved = str(tmp / "port_saved.npz")  # the port's file in km_tpu
    back = CountTable.load(saved)
    assert back.k == host.k and back.canonical == host.canonical
    np.testing.assert_array_equal(back.keys, host.keys)
    np.testing.assert_array_equal(back.counts, host.counts)
    np.testing.assert_array_equal(
        Km.load(saved, make_mesh(4)).query_packed(q), want)


def test_full_step_matches_km_tpu_demo_step(ranks):
    """Tips and child masks equal km_tpu's on the same seed and mesh
    shape; each row's summed runs equal the host count of the row's
    chunks and km_tpu's deltas, in key order across the shard ranks."""
    import jax
    from jax.sharding import Mesh

    from km_tpu.parallel.pipeline_step import demo_step as km_demo_step

    world, _tmp, res = ranks
    R = _reads_rows(world)
    S = world // R
    mesh = Mesh(np.array(jax.devices()[:world]).reshape(R, S),
                ("reads", "shard"))
    dhi, dlo, dcnt, tips, child_mask, _dropped, qdropped = km_demo_step(
        mesh, k=31, chunk=2048, queries_per_row=128)
    assert int(np.asarray(qdropped).sum()) == 0
    per = 128 // S
    codes = np.random.default_rng(0).integers(0, 4, (R, S, 2048),
                                              dtype=np.uint8)
    rows = {}
    for out in res:
        r, s = out["coord"]
        np.testing.assert_array_equal(out["tips"],
                                      tips[r, s * per:(s + 1) * per])
        np.testing.assert_array_equal(out["child_mask"],
                                      child_mask[r, s * per:(s + 1) * per])
        rows.setdefault(r, {})[s] = out
    assert sorted(rows) == list(range(R))
    for r, by_shard in rows.items():
        keys = np.concatenate([by_shard[s]["delta_keys"] for s in range(S)])
        counts = np.concatenate([by_shard[s]["delta_counts"]
                                 for s in range(S)])
        assert (np.diff(keys.astype(np.float64)) > 0).all()
        hk, hc = _km_tpu()[1](
            iter([(codes[r, s], np.ones(2048, bool)) for s in range(S)]),
            31, canonical=True, min_count=1)
        np.testing.assert_array_equal(keys, hk)
        np.testing.assert_array_equal(counts, hc.astype(np.int64))
        km_keys = ((np.asarray(dhi[r]).astype(np.uint64) << np.uint64(32))
                   | np.asarray(dlo[r]).astype(np.uint64)).reshape(-1)
        km_cnt = np.asarray(dcnt[r]).reshape(-1)
        real = (km_cnt > 0) & (km_keys < np.uint64(1 << 62))
        order = np.argsort(km_keys[real])
        np.testing.assert_array_equal(km_keys[real][order], keys)
        np.testing.assert_array_equal(km_cnt[real][order], counts)


def test_process_helpers_and_mesh(ranks):
    world, _tmp, res = ranks
    got = []
    for r, out in enumerate(res):
        assert list(out["foreign_modules"]) == []
        assert list(out["index_count"]) == [r, world]
        assert list(out["shards"]) == SAMPLES[r::world]
        got += list(out["shards"])
        assert list(out["mesh_1d"]) == [world]
        assert bool(out["uneven_reads_raised"])
        assert list(out["coord"]) == [r // (world // _reads_rows(world)),
                                      r % (world // _reads_rows(world))]
    assert sorted(got) == SAMPLES


def test_initialize_without_torchrun_env_is_a_noop(monkeypatch):
    for var in distributed.TORCHRUN_ENV + ("LOCAL_RANK",):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize("cpu") is False
    assert not dist.is_initialized()
    assert (distributed.process_index(), distributed.process_count()) == (0, 1)
    assert distributed.local_read_shards(SAMPLES) == SAMPLES
    assert distributed.local_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            distributed.local_device("cuda")
    # no group: the sharded table refuses instead of running alone
    with pytest.raises(RuntimeError, match="no process group"):
        ShardedCountTable(PortTable.from_jf(NPM1), device="cpu")


def test_initialize_failure_raises(monkeypatch):
    """km_tpu reads a failed initialize on its implicit path as "already
    live" and carries on (distributed.py:47-60); the port raises."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]  # closed again: nothing listens there
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(RuntimeError, match="incomplete torchrun"):
        distributed.initialize("cpu")
    monkeypatch.setenv("MASTER_PORT", str(port))
    # the real rendezvous, only with a shorter wait than torch's default
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        functools.partial(dist.init_process_group,
                                          timeout=timedelta(seconds=2)))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError):
        distributed.initialize("cpu")
    assert time.monotonic() - t0 < 60
    assert not dist.is_initialized()


@pytest.mark.cuda
def test_nccl_ranks_match_gloo_ranks(tmp_path):
    """On two or more cards (four, or two, one per rank), every check of
    _run_world under NCCL gives what the same ranks give under gloo on
    the CPU, which the tests above hold against km_tpu; the lookups and
    counts also equal the host table's and counter's directly. Run
    where the cards are: python -m pytest --noconftest -m cuda
    tests/test_torch_parallel.py"""
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards < 2:
        pytest.skip("needs two or more CUDA devices")
    world = 4 if n_cards >= 4 else 2
    CountTable, count_batches_host = _km_tpu()
    host = CountTable.from_jf(NPM1)
    res = {}
    for kind in ("cpu", "cuda"):
        tmp = tmp_path / kind
        tmp.mkdir()
        host.save(str(tmp / "km_tpu_saved.npz"))
        spawn(_run_world, world, tmp, kind)
        res[kind] = [dict(np.load(tmp / ("rank%d.npz" % r)))
                     for r in range(world)]
    for r, (cpu, cuda) in enumerate(zip(res["cpu"], res["cuda"])):
        assert sorted(cpu) == sorted(cuda)
        for key in cpu:
            np.testing.assert_array_equal(cuda[key], cpu[key],
                                          err_msg="rank %d %s" % (r, key))
    q = res["cuda"][0]["queries"]
    np.testing.assert_array_equal(res["cuda"][0]["broadcast"],
                                  host.query_packed(q))
    for name, (seed, n, alphabet, chunks) in COUNT_INPUTS.items():
        hk, hc = count_batches_host(iter([_batch(seed, n, alphabet)]), K,
                                    canonical=True, min_count=1)
        for chunk in chunks:
            np.testing.assert_array_equal(
                res["cuda"][0][f"{name}_{chunk}_keys"], hk)
            np.testing.assert_array_equal(
                res["cuda"][0][f"{name}_{chunk}_counts"], hc)
