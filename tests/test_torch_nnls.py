"""km_tpu_torch's batched NNLS (float64 on CPU tensors) against km_tpu's
``solve_batch`` (JAX on the CPU) and the host spec
(``km_tpu.models.quant``): the %.3f/%.1f-rounded report fields are equal,
as tests/test_nnls.py holds km_tpu to them."""

import numpy as np
import pytest

import torch

from km_tpu.models import quant
from km_tpu.ops import nnls as jax_nnls

from km_tpu_torch.ops import nnls

from test_nnls import FIXTURES, _finder

# the device path on CPU tensors is thousands of small ops: one intra-op
# thread each, so that parallel test workers do not oversubscribe the
# cores
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _fields(coef, rvaf):
    return (["%.1f" % c for c in coef], ["%.3f" % r for r in rvaf])


def _spec(paths, counts):
    """The host spec on the same problem: lstsq, then refine_fit."""
    cf32 = np.asarray(counts, np.float32)
    cb = quant.build_contrib(paths, len(cf32))
    coef = quant.refine_fit(cb, cf32, quant.lstsq_fit(cb, cf32))
    return coef, quant.ratio_of(coef)


def test_fixture_rows_byte_identical():
    """Every problem of every fixture target in one batch; rows equal to
    the per-target host quantification."""
    finders = [_finder(jf, fa) for jf, fa in FIXTURES]
    jobs, emits = [], []
    for f in finders:
        for paths, emit, _prewarm in f.quant_jobs():
            jobs.append((paths, f.counts))
            emits.append(emit)
    calls = nnls.Refinement.calls
    fetch = nnls.solve_batch(jobs, CPU, defer=True)
    for emit, (coef, rvaf) in zip(emits, fetch()):
        emit(coef, rvaf)
    assert nnls.Refinement.calls == calls + 1
    got = [[str(r) for r in f.sorted_rows()] for f in finders]
    want = []
    for jf, fa in FIXTURES:
        f = _finder(jf, fa)
        f.quantify_paths()
        f.quantify_clusters()
        want.append([str(r) for r in f.sorted_rows()])
    assert got == want


def _random_problems(seed, n_problems=20, max_count=3000):
    rng = np.random.default_rng(seed)
    problems = []
    for _ in range(n_problems):
        n = int(rng.integers(8, 60))
        paths = []
        for _p in range(int(rng.integers(2, 5))):
            ln = int(rng.integers(2, n))
            start = int(rng.integers(0, n - ln + 1))
            paths.append(tuple(range(start, start + ln)))
        problems.append((paths, rng.integers(0, max_count, n).tolist()))
    return problems


@pytest.mark.parametrize("seed", [7, 8])
def test_random_problems_match_km_tpu_and_spec(seed):
    problems = _random_problems(seed)
    got = nnls.solve_batch(problems, CPU)
    want = jax_nnls.solve_batch(problems)
    for (paths, counts), g, w in zip(problems, got, want):
        assert _fields(*g) == _fields(*w)
        assert _fields(*g) == _fields(*_spec(paths, counts))


def test_zero_counts_guard():
    (coef, rvaf), = nnls.solve_batch([([(0, 1), (1, 2)], [0, 0, 0, 0])], CPU)
    assert np.all(coef == 0) and np.all(rvaf == 0)


def test_large_counts_and_occurrences_stay_on_device():
    """A count >= 2^24 (not a float32 integer in km_tpu's narrowing) and
    a path that visits one node >= 2^15 times (beyond its int16): both
    run in the one batched refinement and equal the spec."""
    big_count = ([(0, 1, 2, 3), (2, 3, 4, 5)],
                 [2 ** 24 + 3, 2 ** 24 + 1, 2 ** 25 + 7, 2 ** 25 + 9,
                  2 ** 24 + 5, 2 ** 24 + 11])
    loop = (0,) + (1, 2) * (2 ** 15 + 4) + (3,)
    big_occ = ([loop, (0, 3, 4)], [900, 2 ** 15 * 40, 2 ** 15 * 41, 870, 15])
    problems = [big_count, big_occ] + _random_problems(9, 4)
    assert int(quant.build_contrib(*big_occ[:1], 5).max()) >= 2 ** 15
    calls = nnls.Refinement.calls
    got = nnls.solve_batch([(p, c) for p, c in problems], CPU)
    assert nnls.Refinement.calls == calls + 1
    for (paths, counts), g in zip(problems, got):
        assert _fields(*g) == _fields(*_spec(paths, counts))
