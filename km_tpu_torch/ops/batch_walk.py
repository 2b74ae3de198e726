"""Frontier-expansion walk of many targets on one device (torch).

Replaces km_tpu.ops.batch_walk (``walk_kernel`` and its fixpoint loop
``device_discover``). Every active walklet of every target advances one
step per round; all child lookups of a round resolve in one batched
``DeviceCountTable.children`` call on the table's device, and the round's
bookkeeping is tensor code on that device. Walk budgets (max_stack
depth, max_break branch events, commit on reconnect or loop, the
per-parent child threshold) are km_tpu's, as are the slot-stable
walklets:

- the common event, a walklet extending through its first unknown
  child, is an elementwise write at its depth column;
- the other unknown children copy the parent's stack into dead slots
  through a ``copy_cap``-entry buffer;
- commits gather the committing stacks through a ``commit_cap``-entry
  buffer and append them to a ``log_cap``-row log;
- dead slots left over are re-seeded from the survivors of the seed
  filter, in order.

Any buffer or pool overflow, or a walklet that needs more than S stack
columns, aborts the attempt, which is retried with doubled capacities
(or doubled S), exactly as km_tpu does: which seeds walk in which round,
and so the order of the commit log, depends on the pool size WC, so the
rule ``WC = min(walklet_cap, max(512, WC of the last iteration))``,
doubled on overflow, is kept to the letter.

Where it differs from km_tpu, on purpose:

- keys are int64 words and the state is ``[WC, S]`` int64 matrices;
- the member set is searched with two ``torch.searchsorted`` calls on
  (key rank, target) composite keys instead of km_tpu's lockstep binary
  search inside each target's slice: the same membership, in a dozen
  launches instead of ~100 per round;
- a Python loop runs the rounds, and the exit test (a host sync) is
  read every CHECK_EVERY rounds; on a card a block of rounds is
  captured once and replayed as a CUDA graph (utils.graphs), since a
  round is ~130 small launches. Rounds past the exit are no-ops:
  each round first computes km_tpu's loop condition on the device and
  gates its overflow flags with it, and a round with no live walklet
  and no seed left changes no state;
- copies into dead slots are gathered by the receiving slot instead of
  scattered with ``mode="drop"``; the small commit/copy buffers keep
  km_tpu's scatter with a trash entry, which alone takes duplicate
  writes;
- the seed filter runs as its own call and its verdict is read back
  once per fixpoint iteration (km_tpu fused it into the walk to save a
  round trip over its TPU link);
- the learned stack depth is kept per table, not per process;
- the node budget is also read before the walk, on each target's own
  k-mers, as the sequential engine reads it at its first call; km_tpu
  reads it only after a commit.

Not ported (see ROADMAP): ``walk_kernel_blob`` and the compile-class
freezing and power-of-two padding of seeds, members and queries.
"""

from __future__ import annotations

import time
import weakref

import numpy as np
import torch

from ..models.walk import NodeBudgetExceeded
from ..utils import graphs as cuda_graphs

TGT_SENTINEL = 0x7FFFFFF
DEFAULT_STACK_CAP = 64
CHECK_EVERY = 4

# stack depth that sufficed in the last walk on each table: starting
# there saves an aborted attempt per call
_learned_stack_cap: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


class MemberSet:
    """The per-target member sets of one fixpoint iteration: each
    member (target t, key) becomes ``rank(key) * T + t``, where rank is
    the key's index among the distinct member keys, and the composite
    words are sorted."""

    def __init__(self, node_order: list[list[int]], device):
        n_targets = len(node_order)
        sizes = [len(order) for order in node_order]
        keys = np.fromiter((key for order in node_order for key in order),
                           dtype=np.int64, count=sum(sizes))
        tgt = np.repeat(np.arange(n_targets, dtype=np.int64), sizes)
        uniq = np.unique(keys)
        comp = np.searchsorted(uniq, keys) * n_targets + tgt
        comp.sort()
        self.n_targets = n_targets
        self.uniq = torch.from_numpy(uniq).to(device)
        self.comp = torch.from_numpy(comp).to(device)


def _member_lookup(members: MemberSet, tgt: torch.Tensor,
                   keys: torch.Tensor) -> torch.Tensor:
    """Is ``keys`` a member of target ``tgt``'s set (tgt broadcasts
    against keys)? km_tpu's ``_member_lookup``."""
    if members.uniq.numel() == 0:
        return torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    rank = torch.searchsorted(members.uniq, keys)
    rank.clamp_(max=members.uniq.numel() - 1)
    hit = members.uniq[rank] == keys
    comp = rank * members.n_targets + tgt
    pos = torch.searchsorted(members.comp, comp)
    pos.clamp_(max=members.comp.numel() - 1)
    return hit & (members.comp[pos] == comp)


def _seed_filter(table, members: MemberSet, seed_tgt, seed_keys, ratio,
                 count) -> torch.Tensor:
    """km_tpu's ``_seed_filter``: a seed whose passing children are all
    known (a member or the seed itself) dies in its first round with no
    side effect, so only seeds with an unknown child need a slot.
    Returns the keep mask."""
    ck, _cnt, kid = table.children(seed_keys, ratio, count)
    known = _member_lookup(members, seed_tgt.unsqueeze(1), ck)
    self_loop = ck == seed_keys.unsqueeze(1)
    return (kid & ~known & ~self_loop).any(dim=1)


class _Walk:
    """One attempt of the walk over fixed capacities: the walklet pool
    (WC slots of S stack columns), the copy and commit buffers, the log.
    ``round()`` is one round of km_tpu's ``walk_kernel`` loop."""

    def __init__(self, table, members, seed_tgt, seed_keys, *, ratio, count,
                 max_stack, max_break, WC, S, copy_cap, commit_cap, log_cap):
        dev = table.device
        i64 = dict(dtype=torch.int64, device=dev)
        self.table, self.members = table, members
        self.seed_tgt, self.seed_keys = seed_tgt, seed_keys
        self.n_seeds = int(seed_keys.numel())
        self.ratio, self.count = ratio, count
        self.max_stack, self.max_break = max_stack, max_break
        self.WC, self.S = WC, S
        self.copy_cap, self.commit_cap, self.log_cap = (copy_cap, commit_cap,
                                                        log_cap)

        self.stack = torch.zeros((WC, S), **i64)
        self.tgt = torch.zeros(WC, **i64)
        self.breaks = torch.zeros(WC, **i64)
        self.depth = torch.ones(WC, **i64)
        self.alive = torch.zeros(WC, dtype=torch.bool, device=dev)
        self.cursor = torch.zeros((), **i64)
        # row log_cap of the log is the trash row of the commit writes
        self.log_keys = torch.zeros((log_cap + 1, S), **i64)
        self.log_tgt = torch.full((log_cap + 1,), TGT_SENTINEL, **i64)
        self.log_depth = torch.zeros(log_cap + 1, **i64)
        self.log_count = torch.zeros((), **i64)
        self.overflow = torch.zeros((), dtype=torch.bool, device=dev)
        self.depth_ovf = torch.zeros((), dtype=torch.bool, device=dev)
        self.rounds = torch.zeros((), **i64)

        self.rows = torch.arange(WC, **i64)
        self.cols = torch.arange(S, **i64)
        self.lanes = torch.arange(4, **i64)
        self.lane_rows = torch.arange(WC * 4, **i64) // 4
        self.commit_ix = torch.arange(commit_cap, **i64)

    def live(self) -> torch.Tensor:
        """km_tpu's loop condition (its 2^22 round cap never binds)."""
        return ((self.alive.any() | (self.cursor < self.n_seeds))
                & ~self.overflow & ~self.depth_ovf)

    def round(self) -> None:
        live = self.live()
        stack, depth, alive = self.stack, self.depth, self.alive
        S, cc, pc = self.S, self.commit_cap, self.copy_cap
        cols = self.cols

        # --- tips and children ---
        tip = stack.gather(1, (depth - 1).clamp(min=0).unsqueeze(1))
        ck, _cnt, kid = self.table.children(tip.squeeze(1), self.ratio,
                                            self.count)
        kid = kid & alive.unsqueeze(1)
        branches = kid.sum(dim=1) > 1
        b2 = self.breaks + branches.long()
        act = alive & ~(branches & (b2 > self.max_break))

        # --- membership: the target's member set or the own stack ---
        known = _member_lookup(self.members, self.tgt.unsqueeze(1), ck)
        in_stack = ((stack.unsqueeze(1) == ck.unsqueeze(2))
                    & (cols < depth.view(-1, 1, 1))).any(dim=2)
        known = (known | in_stack) & kid

        # --- commits: committing stacks through the buffer into the log
        committing = act & known.any(dim=1) & (depth >= 2)
        n_commit = committing.sum()
        slot = torch.where(committing,
                           (committing.cumsum(0) - 1).clamp(max=cc), cc)
        src = torch.zeros(cc + 1, dtype=torch.int64, device=stack.device)
        src = src.scatter_(0, slot, self.rows)[:cc]
        valid = self.commit_ix < n_commit
        off = self.log_count.clamp(max=self.log_cap - cc)
        at = torch.where(valid, off + self.commit_ix, self.log_cap)
        self.log_keys.index_copy_(0, at, stack[src])
        self.log_tgt.index_copy_(0, at, self.tgt[src])
        self.log_depth.index_copy_(0, at, depth[src])
        overflow = (n_commit > cc) | (self.log_count + cc > self.log_cap)
        self.log_count = self.log_count + torch.clamp(n_commit, max=cc)

        # --- in-place extension through the first unknown child ---
        # S may be below max_stack: a walklet that may legally go deeper
        # than S flags a depth overflow and the attempt is retried
        d1 = depth.unsqueeze(1) + 1
        unknown = act.unsqueeze(1) & kid & ~known & (d1 <= self.max_stack)
        depth_ovf = (unknown & (d1 > S)).any()
        unknown = unknown & (d1 <= S)
        first = (unknown.long().cumsum(dim=1) == 0).sum(dim=1).clamp(max=3)
        ext = unknown.any(dim=1)
        ext_key = ck.gather(1, first.unsqueeze(1))
        stack = torch.where((cols == depth.unsqueeze(1)) & ext.unsqueeze(1),
                            ext_key, stack)
        depth = torch.where(ext, depth + 1, depth)
        breaks = torch.where(ext, b2, self.breaks)

        # --- extra unknown children: copies of the parent, buffered ---
        extra = (unknown & (self.lanes != first.unsqueeze(1))).reshape(-1)
        n_extra = extra.sum()
        slot = torch.where(extra, (extra.cumsum(0) - 1).clamp(max=pc), pc)
        cp_src = torch.zeros(pc + 1, dtype=torch.int64, device=stack.device)
        cp_src = cp_src.scatter_(0, slot, self.lane_rows)[:pc]
        cp_key = torch.zeros(pc + 1, dtype=torch.int64, device=stack.device)
        cp_key = cp_key.scatter_(0, slot, ck.reshape(-1))[:pc]
        dead = ~ext
        drank = dead.cumsum(0) - 1
        n_dead = drank[-1] + 1
        n_copied = torch.minimum(n_extra, n_dead)
        overflow = overflow | (n_extra > pc) | (n_extra > n_dead)

        # the e-th dead slot receives buffer entry e
        recv = dead & (drank < n_copied) & (drank < pc)
        entry = drank.clamp(0, pc - 1)
        parent = cp_src[entry]
        cp_depth = depth[parent]  # the parent's depth after its extension
        cp_rows = torch.where(cols == (cp_depth - 1).unsqueeze(1),
                              cp_key[entry].unsqueeze(1), stack[parent])
        stack = torch.where(recv.unsqueeze(1), cp_rows, stack)
        tgt = torch.where(recv, self.tgt[parent], self.tgt)
        breaks = torch.where(recv, breaks[parent], breaks)
        depth = torch.where(recv, cp_depth, depth)

        # --- dead slots left over take fresh seeds, in order ---
        seed_ix = self.cursor + (drank - n_copied)
        is_seed = (dead & (drank >= n_copied) & (seed_ix < self.n_seeds)
                   & (seed_ix >= 0))
        pos = seed_ix.clamp(0, max(self.n_seeds - 1, 0))
        tgt = torch.where(is_seed, self.seed_tgt[pos], tgt)
        breaks = torch.where(is_seed, 0, breaks)
        depth = torch.where(is_seed, 1, depth)
        stack = torch.where((cols == 0) & is_seed.unsqueeze(1),
                            self.seed_keys[pos].unsqueeze(1), stack)

        self.stack, self.tgt, self.breaks, self.depth = stack, tgt, breaks, depth
        self.alive = ext | recv | is_seed
        self.cursor = self.cursor + is_seed.sum()
        self.overflow = self.overflow | (live & overflow)
        self.depth_ovf = self.depth_ovf | (live & depth_ovf)
        self.rounds = self.rounds + live.long()

    STATE = ("stack", "tgt", "breaks", "depth", "alive", "cursor",
             "log_count", "overflow", "depth_ovf", "rounds")

    def run(self) -> tuple[bool, bool]:
        """Rounds until km_tpu's loop would exit, in blocks of
        CHECK_EVERY (on a card the first block runs eagerly and the
        rest replay it as one CUDA graph); returns (overflow,
        depth_overflow)."""

        def block():
            for _ in range(CHECK_EVERY):
                self.round()

        if self.n_seeds:
            if self.stack.device.type == "cuda":
                cuda_graphs.warm_up(block)
                if bool(self.live()):
                    graph = cuda_graphs.capture(self, self.STATE, block)
                    graph.replay()
                    while bool(self.live()):
                        graph.replay()
            else:
                block()
                while bool(self.live()):
                    block()
        return bool(self.overflow), bool(self.depth_ovf)

    def log(self):
        """The commit log on the host: (targets, depths, key rows)."""
        n = int(self.log_count)
        return (self.log_tgt[:n].cpu().numpy(),
                self.log_depth[:n].cpu().numpy(),
                self.log_keys[:n].cpu().numpy())


def device_discover(targets_mers: list[np.ndarray], table, ratio=0.05,
                    count=5, max_stack=500, max_break=10, max_node=10000,
                    walklet_cap=2048, copy_cap=128, commit_cap=128,
                    log_cap=512, stack_cap=None, on_budget="raise",
                    defer_counts=False):
    """Fixpoint loop of the walk on ``table``'s device (a torch
    DeviceCountTable).

    targets_mers: per-target ordered unique packed ref k-mers (uint64).
    Returns per-target ordered {kmer: count} (ref k-mers first, then
    commits in log order), like the host walkers. With on_budget='skip',
    a target that outgrows max_node returns None instead of aborting
    the batch. defer_counts=True returns (orders, fetch) instead: the
    count lookup is queued on the device and ``fetch()`` reads it back,
    so the caller can overlap host work with it.
    ``device_discover.stats`` describes the last call.
    """
    if log_cap <= commit_cap:
        # the log overflows once it holds log_cap - commit_cap commits;
        # retries double both, so that room must start above 0
        raise ValueError("log_cap (%d) must exceed commit_cap (%d)"
                         % (log_cap, commit_cap))
    device_discover.calls += 1
    dev = table.device
    n_targets = len(targets_mers)
    seed_tgt = np.repeat(np.arange(n_targets, dtype=np.int64),
                         [len(m) for m in targets_mers])
    seed_keys = (np.concatenate(targets_mers).astype(np.int64)
                 if n_targets else np.empty(0, np.int64))
    seed_tgt_d = torch.from_numpy(seed_tgt).to(dev)
    seed_keys_d = torch.from_numpy(seed_keys).to(dev)

    node_sets = [set(int(x) for x in m) for m in targets_mers]
    node_order = [[int(x) for x in m] for m in targets_mers]

    # every round touches the whole [WC, S] stack matrix, so S starts
    # shallow (catalog walks commit at depth ~32) and doubles on demand
    if stack_cap is None:
        stack_cap = _learned_stack_cap.get(table, DEFAULT_STACK_CAP)
    S = min(max(8, stack_cap), max(8, max_stack))

    # a target whose own k-mers outnumber the budget fails before it
    # walks, as the sequential engine's first budget check does (km_tpu
    # reads the budget only after a commit, so such a target passes
    # there when it commits nothing)
    failed: set[int] = {t for t, ns in enumerate(node_sets)
                        if len(ns) > max_node}
    if failed and on_budget == "raise":
        raise NodeBudgetExceeded(max_node)
    active = np.flatnonzero(~np.isin(seed_tgt, sorted(failed)))
    WC_f = 0
    stats = dict(iterations=0, rounds=0, retries=0, walklets=0, stack=S,
                 filter_s=0.0, rounds_s=0.0, commits_s=0.0)
    clock = time.perf_counter
    for _iteration in range(64):  # fixpoint iterations (typically 2)
        stats["iterations"] += 1
        t0 = clock()
        members = MemberSet(node_order, dev)
        act = torch.from_numpy(active).to(dev)
        keep = _seed_filter(table, members, seed_tgt_d[act], seed_keys_d[act],
                            ratio, count)
        surv = active[keep.cpu().numpy()]
        surv_d = torch.from_numpy(surv).to(dev)
        t1 = clock()
        stats["filter_s"] += t1 - t0

        WC = min(walklet_cap, max(512, WC_f))
        while True:
            walk = _Walk(table, members, seed_tgt_d[surv_d],
                         seed_keys_d[surv_d],
                         ratio=ratio, count=count, max_stack=max_stack,
                         max_break=max_break, WC=WC, S=S, copy_cap=copy_cap,
                         commit_cap=commit_cap, log_cap=log_cap)
            overflow, depth_ovf = walk.run()
            stats["rounds"] += int(walk.rounds)
            if not overflow and not depth_ovf:
                break
            stats["retries"] += 1
            if depth_ovf:
                S = min(S * 2, max(8, max_stack))
            if overflow:
                WC *= 2
                copy_cap *= 2
                commit_cap *= 2
                log_cap *= 2
        WC_f = WC  # an overflow-doubled pool carries to later iterations
        stats["walklets"] = max(stats["walklets"], WC)
        c_tgt, c_depth, c_keys = walk.log()
        t2 = clock()
        stats["rounds_s"] += t2 - t1

        changed = False
        for i in range(len(c_tgt)):
            t = int(c_tgt[i])
            if t == TGT_SENTINEL or t in failed:
                continue
            ns, order = node_sets[t], node_order[t]
            for key in c_keys[i, :int(c_depth[i])].tolist():
                if key not in ns:
                    ns.add(key)
                    order.append(key)
                    changed = True
            if len(order) > max_node:
                if on_budget == "raise":
                    raise NodeBudgetExceeded(max_node)
                failed.add(t)
        stats["commits_s"] += clock() - t2
        if not changed:
            break
        active = surv  # only prior survivors can still have unknown kids
        if failed:  # failed targets' seeds stop walking
            active = active[~np.isin(seed_tgt[active],
                                     np.fromiter(failed, np.int64,
                                                 len(failed)))]

    _learned_stack_cap[table] = S
    stats["stack"] = S
    device_discover.stats = stats

    # count resolution: one lookup across every target, queued now and
    # read back in _materialize
    sizes = [len(order) for order in node_order]
    all_keys = np.fromiter((key for order in node_order for key in order),
                           dtype=np.int64, count=sum(sizes))
    dev_counts = table.lookup(torch.from_numpy(all_keys).to(dev))

    def _materialize():
        counts = dev_counts.cpu().numpy()
        results = []
        off = 0
        for t, order in enumerate(node_order):
            n = len(order)
            results.append(None if t in failed else
                           dict(zip(order, counts[off:off + n].tolist())))
            off += n
        return results

    if defer_counts:
        orders = [None if t in failed else node_order[t]
                  for t in range(n_targets)]
        return orders, _materialize
    return _materialize()


device_discover.calls = 0
device_discover.stats = {}
