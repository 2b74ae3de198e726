"""km_tpu_torch's DeviceCountTable (on CPU tensors) against km_tpu's
device table on the CPU and the host CountTable: lookups, child
expansion and the child threshold, exactly."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from km_tpu.models.table import CountTable
from km_tpu.ops import encode
from km_tpu.ops.device_table import DeviceCountTable as JaxTable
from km_tpu.ops.device_table import join_keys, split_keys

from km_tpu_torch.convert import table_from_jax
from km_tpu_torch.device import (SENTINEL, i64_to_split, i64_to_u64,
                                 split_to_i64, to_device_keys, to_host_keys,
                                 u64_to_i64)
from km_tpu_torch.ops import device_table as tdt

from helpers import REFDATA

SAMPLES = ["02H025_NPM1", "02H033_DNMT3A_sub", "03H112_IandI", "03H116_ITD",
           "05H094_FLT3-TKD_del"]
RATIO, CUTOFF = 0.05, 5


def _queries(table, rng, n=512):
    """Table keys, their reverse complements and random keys."""
    k = table.k
    some = rng.choice(table.keys, size=min(n, len(table.keys)))
    rand = rng.integers(0, 1 << (2 * k), n, dtype=np.uint64)
    return np.concatenate([some, encode.revcomp(some, k), rand])


def _host_children(table, parents, forward):
    ck, cc = table.children_packed(parents, forward=forward)
    sums = cc.sum(axis=-1, keepdims=True)
    thr = np.maximum(sums.astype(np.float64) * RATIO, CUTOFF)
    return ck, cc, cc >= thr


def _check_table(host, rng, check_jax=True):
    port = tdt.DeviceCountTable.from_host(host, device="cpu")
    q = _queries(host, rng)
    want = host.query_packed(q)
    np.testing.assert_array_equal(port.query_packed(q), want)
    jt = JaxTable.from_host(host) if check_jax else None
    if check_jax:
        np.testing.assert_array_equal(jt.query_packed(q), want)
        conv = table_from_jax(jt.keys_hi, jt.keys_lo, jt.counts, host.k,
                              host.canonical, device="cpu")
        assert conv.n == host.n_kmers
        np.testing.assert_array_equal(conv.query_packed(q), want)

    parents = q[:256]
    for forward in (True, False):
        hk, hc, hm = _host_children(host, parents, forward)
        ck, cnt, mask = port.children(to_device_keys(parents, "cpu"), RATIO,
                                      CUTOFF, forward=forward)
        np.testing.assert_array_equal(to_host_keys(ck), hk)
        np.testing.assert_array_equal(cnt.numpy(), hc)
        np.testing.assert_array_equal(mask.numpy(), hm)
        if check_jax:
            phi, plo = split_keys(parents)
            chi, clo, jcnt, jmask = jt.children(
                jnp.asarray(phi), jnp.asarray(plo), RATIO, CUTOFF,
                forward=forward)
            np.testing.assert_array_equal(
                join_keys(np.asarray(chi), np.asarray(clo)), hk)
            np.testing.assert_array_equal(np.asarray(jcnt), hc)
            np.testing.assert_array_equal(np.asarray(jmask), hm)


@pytest.mark.parametrize("sample", SAMPLES)
def test_fixture_tables_match(sample):
    host = CountTable.from_jf(f"{REFDATA}/jf/{sample}.jf")
    _check_table(host, np.random.default_rng(len(sample)))


@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("k", [5, 15, 16, 17, 31])
def test_random_tables_match(k, canonical):
    rng = np.random.default_rng(k)
    keys = rng.integers(0, 1 << (2 * k), 3000, dtype=np.uint64)
    if canonical:
        keys = encode.canonical(keys, k)
    keys = np.unique(keys)
    counts = rng.integers(1, 60, len(keys)).astype(np.uint32)
    host = CountTable.from_arrays(keys, counts, k, canonical)
    _check_table(host, rng, check_jax=canonical)


def test_revcomp_and_child_keys_match_host():
    rng = np.random.default_rng(3)
    for k in (1, 2, 15, 16, 17, 31):
        keys = rng.integers(0, 1 << (2 * k), 1000, dtype=np.uint64)
        t = to_device_keys(keys, "cpu")
        np.testing.assert_array_equal(to_host_keys(tdt.revcomp(t, k)),
                                      encode.revcomp(keys, k))
        np.testing.assert_array_equal(to_host_keys(tdt.canonical(t, k)),
                                      encode.canonical(keys, k))
        np.testing.assert_array_equal(
            to_host_keys(tdt.child_keys(t, k, forward=True)),
            encode.child_keys_forward(keys, k))
        np.testing.assert_array_equal(
            to_host_keys(tdt.child_keys(t, k, forward=False)),
            encode.child_keys_backward(keys, k))


def _boundary_table(counts4):
    """A canonical k=31 table holding the 4 forward children of one
    parent with the given counts; returns (table, parent)."""
    k = 31
    rng = np.random.default_rng(17)
    parent = rng.integers(0, 1 << 62, 1, dtype=np.uint64)
    kids = encode.canonical(encode.child_keys_forward(parent, k)[0], k)
    assert len(set(kids.tolist())) == 4
    keep = np.asarray(counts4) > 0
    return CountTable.from_arrays(kids[keep], np.asarray(counts4)[keep],
                                  k, True), parent


@pytest.mark.parametrize("counts4,passes", [
    # sum 2^25 + 4; threshold 0.25 * sum = 2^23 + 1 exactly: passes
    ((2 ** 23 + 1, 2 ** 25 + 3 - 2 ** 23, 0, 0), True),
    # sum 16976801 (> 2^24, not a float32): threshold 848840.05 in
    # float64, so 848840 fails; in float32 it passes (km_tpu's device)
    ((848840, 16976801 - 848840, 0, 0), False),
])
def test_child_threshold_is_float64(counts4, passes):
    ratio = 0.25 if passes else RATIO
    host, parent = _boundary_table(counts4)
    port = tdt.DeviceCountTable.from_host(host, device="cpu")
    _ck, cnt, mask = port.children(to_device_keys(parent, "cpu"), ratio,
                                   CUTOFF)
    np.testing.assert_array_equal(cnt.numpy()[0], counts4)
    assert bool(mask[0, 0]) is passes
    assert host.get_child_keys(int(parent[0]), ratio, CUTOFF)[:1] == (
        [int(encode.child_keys_forward(parent, 31)[0, 0])] if passes else
        [int(encode.child_keys_forward(parent, 31)[0, 1])])
    if not passes:
        # km_tpu's float32 device threshold lets the count through
        jt = JaxTable.from_host(host)
        phi, plo = split_keys(parent)
        *_, jmask = jt.children(jnp.asarray(phi), jnp.asarray(plo), ratio,
                                CUTOFF)
        assert bool(np.asarray(jmask)[0, 0]) is True


def test_empty_table_lookup():
    host = CountTable.from_arrays(np.empty(0, np.uint64),
                                  np.empty(0, np.uint32), 31, True)
    port = tdt.DeviceCountTable.from_host(host, device="cpu")
    q = np.arange(10, dtype=np.uint64)
    np.testing.assert_array_equal(port.query_packed(q), np.zeros(10))
    assert port.query_packed(np.empty(0, np.uint64)).shape == (0,)


def test_query_shape_kept():
    host = CountTable.from_jf(f"{REFDATA}/jf/{SAMPLES[0]}.jf")
    port = tdt.DeviceCountTable.from_host(host, device="cpu")
    q = host.keys[:12].reshape(3, 4)
    out = port.query_packed(q)
    assert out.shape == (3, 4) and out.dtype == np.int64
    np.testing.assert_array_equal(out, host.query_packed(q))
    assert isinstance(port.lookup(torch.from_numpy(q.astype(np.int64))),
                      torch.Tensor)


def test_key_conversions_round_trip():
    """uint64 <-> int64 and km_tpu (hi, lo) <-> int64, sentinels mapped:
    km_tpu's all-ones word is the port's 2**63-1."""
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 1 << 62, 100, dtype=np.uint64)
    keys[::10] = np.uint64(0xFFFFFFFFFFFFFFFF)
    words = u64_to_i64(keys)
    assert words.dtype == np.int64 and (words[::10] == SENTINEL).all()
    np.testing.assert_array_equal(i64_to_u64(words), keys)
    hi, lo = i64_to_split(words)
    np.testing.assert_array_equal(hi, (keys >> np.uint64(32)).astype(np.uint32))
    np.testing.assert_array_equal(split_to_i64(hi, lo), words)
    with pytest.raises(ValueError):
        u64_to_i64(np.array([1 << 63], np.uint64))
