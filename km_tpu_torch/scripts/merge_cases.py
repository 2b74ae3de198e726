"""Inputs for the checks of the merge kernels (``ops/merge.py``): the edge
cases (an accumulator and one chunk's window keys, made from a seed with
numpy) and the inputs at the shape of a 2^30-base sample's final counting
pass (made on the device from a seed). The CPU tests hold the plain
versions against km_tpu with them; the card tests and chip_smoke.py hold
the kernels against the plain versions."""

from __future__ import annotations

import numpy as np
import torch

from ..device import SENTINEL
from ..ops import sort_runs

SORT_CHUNK = 1024
SORT_CHUNKS = [1 << b for b in range(9, 15)]  # every accepted piece size
CASES = ["empty_accumulator", "chunk_all_sentinel", "all_present", "all_new",
         "one_key_every_piece", "n_unique_C", "n_unique_C_plus_1",
         "n_unique_3C", "ragged", "long_run"]
LONG_RUN_KEY = 12345


def _keys(rng, n: int, odd: bool = False) -> np.ndarray:
    """n distinct ascending keys below 2^62, all even or all odd."""
    keys = np.unique(rng.integers(0, 1 << 61, 2 * n + 16)) * 2 + odd
    return np.sort(rng.permutation(keys)[:n]).astype(np.int64)


def _draw(rng, pool: np.ndarray, n: int, invalid: float = 0.1) -> np.ndarray:
    """n window keys drawn from pool (repeats within and across pieces),
    a share of them invalid (SENTINEL)."""
    keys = pool[rng.integers(0, len(pool), n)] if len(pool) else \
        np.full(n, SENTINEL, np.int64)
    keys[rng.random(n) < invalid] = SENTINEL
    return keys


def make_case(name: str, seed: int = 0, sort_chunk: int = SORT_CHUNK):
    """-> (acc keys int64 ascending distinct, acc counts int64 > 0, the
    chunk's window keys int64 with SENTINEL for invalid windows, the
    capacity C)."""
    rng = np.random.default_rng([seed, CASES.index(name), sort_chunk])
    n = 4 * sort_chunk
    acc = _keys(rng, 1500)
    pool = _keys(rng, n // 3, odd=True)
    C = 4 * n
    if name == "empty_accumulator":
        acc = acc[:0]
        chunk = _draw(rng, pool, n)
    elif name == "chunk_all_sentinel":
        chunk = np.full(n, SENTINEL, np.int64)
    elif name == "all_present":
        chunk = _draw(rng, acc, n)
    elif name == "all_new":
        chunk = _draw(rng, pool, n)
    elif name == "one_key_every_piece":
        chunk = _draw(rng, pool, n)
        key = acc[len(acc) // 2]
        chunk[np.arange(0, n, sort_chunk) + rng.integers(0, sort_chunk)] = key
    elif name.startswith("n_unique"):
        acc = acc[:200]
        chunk = _draw(rng, pool, n)
        distinct = len(np.union1d(acc, chunk[chunk != SENTINEL]))
        C = {"n_unique_C": distinct, "n_unique_C_plus_1": distinct - 1,
             "n_unique_3C": distinct // 3}[name]
    elif name == "ragged":
        chunk = _draw(rng, np.concatenate([pool, acc]), 3 * sort_chunk + 77)
    elif name == "long_run":
        # one key in about 40% of the windows: a run in every piece, and
        # in the accumulator, longer than any bound derived from pieces
        acc = np.union1d(acc, [LONG_RUN_KEY]).astype(np.int64)
        chunk = _draw(rng, pool, n)
        chunk[rng.random(n) < 0.4] = LONG_RUN_KEY
    else:
        raise ValueError(name)
    counts = rng.integers(1, 50, len(acc)).astype(np.int64)
    return acc, counts, chunk, C


def sorted_chunk(chunk: np.ndarray, sort_chunk: int, device="cpu"):
    """The chunk sort's output for the window keys: (int64 keys sorted
    within pieces, int32 run lengths at run starts)."""
    return sort_runs.sort_chunks_runs_plain(
        torch.from_numpy(chunk).to(device), sort_chunk)


def accumulator(acc: np.ndarray, counts: np.ndarray, C: int, device="cpu"):
    """(keys [C], counts [C], live length) with SENTINEL and 0 past the
    live prefix; the prefix is cut to C."""
    live = min(len(acc), C)
    keys = np.full(C, SENTINEL, np.int64)
    cnt = np.zeros(C, np.int64)
    keys[:live], cnt[:live] = acc[:live], counts[:live]
    return (torch.from_numpy(keys).to(device),
            torch.from_numpy(cnt).to(device),
            torch.tensor(len(acc), dtype=torch.int64, device=device))


def sample_shape(device, live: int = 26_000_000, slots: int = 1 << 26,
                 windows: int = (1 << 24) - 30, seed: int = 8):
    """The merge's inputs at the shape of the smoke's sample (2^30 bases,
    k = 31) in its final pass, made on the device from a seed: an
    accumulator of `live` keys in `slots` slots (counts 1..49), and the
    chunk sort's output (sort_chunks_runs) for one chunk of `windows`
    windows, 70% of them valid, drawn from windows / 2 keys (so a key
    is in 1.4 windows on average), half of which are in the accumulator.
    Returns ((acc keys, acc counts, live length), (keys, lengths))."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rand_keys(n):
        return torch.randint(0, 1 << 62, (n,), generator=g, device=device)

    acc = torch.unique(rand_keys(live + live // 64))[:live]
    keys = torch.full((slots,), SENTINEL, dtype=torch.int64, device=device)
    counts = torch.zeros(slots, dtype=torch.int64, device=device)
    keys[:live] = acc
    counts[:live] = torch.randint(1, 50, (live,), generator=g, device=device)
    valid = torch.rand(windows, generator=g, device=device) < 0.7
    distinct = windows // 2
    old = acc[torch.randint(0, live, (distinct // 2,), generator=g,
                            device=device)]
    pool = torch.cat([old, rand_keys(distinct - distinct // 2)])
    window = pool[torch.randint(0, pool.numel(), (windows,), generator=g,
                                device=device)]
    window = torch.where(valid, window, torch.full_like(window, SENTINEL))
    acc_n = torch.tensor(live, dtype=torch.int64, device=device)
    return (keys, counts, acc_n), sort_runs.sort_chunks_runs(window)
