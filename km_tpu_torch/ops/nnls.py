"""Batched non-negative least squares on one device (torch).

Replaces km_tpu.ops.nnls. A catalog run yields hundreds of small
quantification problems (a few paths x a few hundred k-mers; reference
hot loop: km/utils/PathQuant.py:111-149). Each problem starts where the
spec starts (km_tpu.models.quant): a host ``np.linalg.lstsq`` on the
float32 counts, clamped at 0, so every trajectory begins bit for bit
like the spec's. The projected-gradient refinement (step 0.1 x mean
gradient, post-update clamp, stop once max|grad| <= 0.01) then runs for
all problems at once in float64 on the device, and each problem freezes
the step its own gradient test passes, as the sequential loop stops, so
its trajectory is the spec's. What remains different is the float64
summation order of the small products, ~1e-15 relative per step, far
below the %.3f/%.1f rounding of the report.

Padding is inert: zero k-mer rows add zero residual and gradient, zero
path columns get zero gradient, and the mean-gradient divisor is each
problem's real k-mer count.

Where it differs from km_tpu, on purpose: the inputs go up as float64
(km_tpu narrowed them to int16/float32 for its TPU link and sent
problems beyond those ranges, counts >= 2^24 or occurrences >= 2^15,
to the host solver; float64 holds both exactly, so every problem runs
on the device), and no power-of-two padding of B, N or P.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.quant import build_contrib
from ..utils import graphs as cuda_graphs
from ..utils import profiling

MAX_ITERS = 200_000  # safety bound; fixtures converge in < 2k iterations
UNROLL = 8  # spec iterations per convergence test (one host sync)


def _step(contrib, counts, n_kmers, coef, done):
    counts_hat = torch.bmm(contrib, coef.unsqueeze(2)).squeeze(2)
    grad = 2.0 * torch.bmm((counts - counts_hat).unsqueeze(1),
                           contrib).squeeze(1) / n_kmers.unsqueeze(1)
    new_coef = coef + 0.1 * grad
    grad = torch.where(new_coef < 0, 0.0, grad)
    new_coef = new_coef.clamp(min=0.0)
    max_grad = grad.abs().amax(dim=1)
    coef = torch.where(done.unsqueeze(1), coef, new_coef)
    return coef, done | (max_grad <= 0.01)


class Refinement:
    """km_tpu's ``_refine_kernel`` in float64, run in blocks of UNROLL
    spec iterations: contrib [B, N, P] occurrence counts, counts [B, N],
    coef0 [B, P] (clamped at 0), n_kmers [B] (real row counts).
    ``queue(blocks)`` enqueues blocks with no host sync; ``finish()``
    reads the convergence test after each further block, as km_tpu's
    loop tests it, and returns (coef, rvaf). Blocks queued past the
    point where every problem has frozen are no-ops. Each block is one
    call of a ``utils.graphs.Replay``."""

    STATE = ("coef", "done")

    def __init__(self, contrib, counts, coef0, n_kmers):
        Refinement.calls += 1
        self.contrib, self.counts, self.n_kmers = contrib, counts, n_kmers
        self.coef = coef0
        self.done = torch.zeros(coef0.shape[0], dtype=torch.bool,
                                device=coef0.device)
        self.iters = 0
        self._run = cuda_graphs.Replay(self, self.STATE, self._block)

    def _block(self) -> None:
        for _ in range(UNROLL):
            self.coef, self.done = _step(self.contrib, self.counts,
                                         self.n_kmers, self.coef, self.done)

    def queue(self, blocks: int) -> None:
        """Enqueue up to ``blocks`` blocks."""
        for _ in range(blocks):
            if self.iters >= MAX_ITERS:
                return
            self._run()
            self.iters += UNROLL

    def _converged(self) -> bool:
        """Every problem frozen, read on the host: the span ``nnls.sync``."""
        with profiling.phase("nnls.sync"):
            return bool(self.done.all())

    def finish(self):
        while self.iters < MAX_ITERS and not self._converged():
            self.queue(1)
        coef = self.coef
        total = coef.sum(dim=1, keepdim=True)
        all_zero = coef.amax(dim=1, keepdim=True) == 0
        rvaf = torch.where(all_zero, coef,
                           coef / torch.where(all_zero, 1.0, total))
        return coef, rvaf


Refinement.calls = 0
QUEUE_AHEAD = 16  # blocks queued before a deferred solve returns


def solve_batch(problems, device, defer: bool = False):
    """Solve many NNLS problems in one batched refinement on ``device``.

    problems: list of (paths, counts), ``paths`` a list of node-index
    paths, ``counts`` the target's node count vector. Returns a list of
    (coef, rvaf) float64 arrays, each cut to its problem's path count.
    defer=True returns a zero-argument ``fetch`` instead, which
    finishes the refinement and reads it back: its first QUEUE_AHEAD
    blocks are already queued, so the caller can overlap host work with
    them."""
    if not problems:
        return (lambda: []) if defer else []
    built = [build_contrib(paths, len(cnt)) for paths, cnt in problems]
    n_p = [cb.shape[1] for cb in built]
    n_n = [cb.shape[0] for cb in built]
    B, N, P = len(problems), max(n_n), max(n_p)
    contrib = np.zeros((B, N, P), np.float64)
    counts = np.zeros((B, N), np.float64)
    coef0 = np.zeros((B, P), np.float64)
    for i, ((_paths, cnt), cb) in enumerate(zip(problems, built)):
        cf32 = np.asarray(cnt, dtype=np.float32)  # the spec's counts
        contrib[i, :n_n[i], :n_p[i]] = cb
        counts[i, :n_n[i]] = cf32
        # the spec's trajectory start: unconstrained lstsq, then clamp
        start = np.linalg.lstsq(cb, cf32, rcond=None)[0]
        start[start < 0] = 0
        coef0[i, :n_p[i]] = start

    def up(a):
        return torch.from_numpy(a).to(device)

    ref = Refinement(up(contrib), up(counts), up(coef0),
                     up(np.asarray(n_n, np.float64)))
    ref.queue(QUEUE_AHEAD)

    def fetch():
        both = torch.stack(ref.finish())
        with profiling.phase("nnls.sync"):
            both = both.cpu().numpy()
        return [(both[0, i, :n_p[i]], both[1, i, :n_p[i]])
                for i in range(B)]

    return fetch if defer else fetch()
