"""Partial reduce — straggler-tolerant dynamic-group gradient averaging
(twin of ``hetu_tpu/parallel/preduce.py``; reference
``python/hetu/preduce.py:8``, P-Reduce, SIGMOD'21).

Each step a controller on the host decides which workers are in the group
(arrival window, ``min_workers``, liveness; the caller's own rank always
in), and every rank computes

    mean_active(g) = all_reduce(mask * g) / all_reduce(mask)

over the whole group: the same number as an all-reduce over the active
subgroup, with no communicator built per membership.
``preduce_scatter_mean`` gives each rank only its block of that mean,
``reduce_scatter(mask * g) / all_reduce(mask)``: the gradient rows the
ZeRO update (``parallel/zero.py``) consumes, in one reduce-scatter.

:class:`DistPartialReduce` forms the group across processes from a
:class:`~hetu_tpu_torch.ps.dist_store.DistributedStore`'s SSP clocks
(channel 1) and heartbeat liveness on rank 0.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..metrics import record_fault
from .collectives import all_reduce, reduce_scatter


def _tree_map(fn, tree):
    """``fn`` over the tensors of a tensor, list, tuple or dict."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class PartialReduce:
    """Controller + helpers for dynamic-group gradient averaging.

    ``get_partner(rank, step)`` mirrors the reference API: returns the
    active-worker mask for this step.  Arrival bookkeeping lives on the
    host: a pluggable ``arrival_fn``, or ``report_arrival`` times.

    ``alive_fn`` (optional) supplies a liveness mask (1 = rank alive):
    dead ranks are excluded from the group within one wait window, and
    every exclusion is counted (``preduce_dead_rank_excluded``).
    """

    def __init__(self, n_workers, max_wait_ms=100.0, min_workers=2,
                 arrival_fn=None, alive_fn=None):
        self.n_workers = n_workers
        self.max_wait_ms = max_wait_ms
        self.min_workers = max(1, min_workers)
        self.arrival_fn = arrival_fn
        self.alive_fn = alive_fn
        self._arrivals = {}

    def _alive(self, rank):
        """Liveness mask (own rank always alive — a worker asking for a
        group is self-evidently not dead); None when liveness is off."""
        if self.alive_fn is None:
            return None
        # copy: the own-rank overwrite must never touch the provider's array
        alive = np.array(self.alive_fn(),
                         np.float32)[:self.n_workers].copy()
        alive[rank] = 1.0
        return alive

    def _finalize(self, mask, rank, alive):
        """Own-rank + dead-exclusion + min-workers discipline."""
        mask[rank] = 1.0
        if alive is not None:
            dead = int((alive == 0).sum())
            if dead:
                record_fault("preduce_dead_rank_excluded", dead)
            mask = mask * alive
        if mask.sum() < self.min_workers:
            # degrade to "everyone believed alive", never to ranks known
            # dead: a full-ones fallback would hang the collective on the
            # failure liveness just detected
            mask = np.ones(self.n_workers, np.float32) if alive is None \
                else alive.copy()
            mask[rank] = 1.0
        return mask

    # -- host-side group formation ------------------------------------------
    def report_arrival(self, rank, step, t=None):
        """A worker announces it reached the sync point for ``step``."""
        self._arrivals.setdefault(step, {})[rank] = \
            time.monotonic() if t is None else t

    def get_partner(self, rank, step):
        """Active mask (float32, shape (n_workers,)) for this step: the
        workers that arrived within ``max_wait_ms`` of the first arrival,
        and the caller's own rank."""
        alive = self._alive(rank)
        if self.arrival_fn is not None:
            mask = np.asarray(self.arrival_fn(step), np.float32)
        else:
            arr = self._arrivals.get(step, {})
            if not arr:
                mask = np.ones(self.n_workers, np.float32)
            else:
                t0 = min(arr.values())
                mask = np.zeros(self.n_workers, np.float32)
                for r, t in arr.items():
                    if (t - t0) * 1e3 <= self.max_wait_ms:
                        mask[r] = 1.0
        return self._finalize(mask, rank, alive)

    # -- the reduction ------------------------------------------------------
    @staticmethod
    def preduce(grad, mask, group=None):
        """The mean of ``grad`` (a tensor, or a list / tuple / dict of
        them) over the active ranks of ``group``.  ``mask``: this rank's
        entry of the ``get_partner`` mask.  Inactive ranks contribute
        zeros and still receive the group mean."""
        leaves = []
        _tree_map(leaves.append, grad)
        m = torch.as_tensor(mask, dtype=torch.float32,
                            device=leaves[0].device)
        den = all_reduce(m, group)
        return _tree_map(lambda g: all_reduce(g * m, group) / den, grad)

    @staticmethod
    def preduce_scatter(grad, mask, group=None):
        """Rank r's block r (along dim 0) of the mean of ``grad`` over the
        active ranks: ``reduce_scatter(mask * g) / all_reduce(mask)``, one
        reduce-scatter where :meth:`preduce` pays an all-reduce.  Every
        leaf's dim 0 must divide by the group size (a ``zero.pack_slab``
        slab does by construction)."""
        leaves = []
        _tree_map(leaves.append, grad)
        m = torch.as_tensor(mask, dtype=torch.float32,
                            device=leaves[0].device)
        den = all_reduce(m, group)
        return _tree_map(lambda g: reduce_scatter(g * m, group) / den, grad)


class DistPartialReduce(PartialReduce):
    """Multi-process group formation from the distributed store's SSP
    clocks (reference ``preduce_get_partner`` asks the PS the same way,
    ``ps-lite preduce_handler.h``; the clocks live on rank 0).

    Each step a worker announces arrival by ticking its clock, then polls
    the clock vector for up to ``max_wait_ms``; the workers whose clock
    reached this worker's own tick count are in the mask.  Stragglers
    that miss the window contribute ``mask=0`` for the step: the
    collective stays lockstep, only the averaging weights change.
    """

    #: its own clock channel: the executor's SSP loop ticks channel 0 every
    #: step, and sharing it would break 'arrival at step s <=> clock >= s+1'
    CHANNEL = 1

    def __init__(self, store, n_workers=None, max_wait_ms=100.0,
                 min_workers=2, poll_ms=5.0, heartbeat_deadline_ms=None):
        super().__init__(n_workers or store.world,
                         max_wait_ms=max_wait_ms, min_workers=min_workers)
        self.store = store
        self.poll_ms = poll_ms
        # with a deadline, ranks whose heartbeat on rank 0 is older are
        # dead: left out of the group and not waited for
        self.heartbeat_deadline_ms = heartbeat_deadline_ms
        # idempotent on the server: every rank may call it
        store.ssp_init(self.n_workers, channel=self.CHANNEL)

    def report_arrival(self, rank, step, t=None):
        self.store.clock(rank, channel=self.CHANNEL)

    def _alive(self, rank):
        if self.heartbeat_deadline_ms is None:
            return super()._alive(rank)     # an explicit alive_fn works too
        alive = self.store.alive_mask(
            self.heartbeat_deadline_ms,
            n_workers=self.n_workers).astype(np.float32)
        alive[rank] = 1.0
        return alive

    def get_partner(self, rank, step):
        """Active mask for this step from the shared clock vector: one
        ``report_arrival`` a worker a step, so arrival at step s means
        clock >= s + 1.  Liveness is read once a formation (a failed read
        forms the group without it, counted as
        ``alive_mask_unavailable``); the wait holds only for ranks still
        believed alive."""
        target = step + 1
        deadline = time.monotonic() + self.max_wait_ms / 1e3
        try:
            alive = self._alive(rank)
        except RuntimeError:
            record_fault("alive_mask_unavailable")
            alive = None
        while True:
            clocks = self.store.clocks(channel=self.CHANNEL)
            if clocks.size < self.n_workers:
                raise RuntimeError(
                    f"preduce clock vector has {clocks.size} entries < "
                    f"n_workers={self.n_workers} — ssp_init raced or ran "
                    f"with a smaller world")
            mask = (clocks[:self.n_workers] >= target).astype(np.float32)
            done = mask.sum() >= self.n_workers if alive is None \
                else bool((mask >= alive).all())
            if done or time.monotonic() >= deadline:
                break
            time.sleep(self.poll_ms / 1e3)
        return self._finalize(mask, rank, alive)


def preduce_mean(grad, mask, group=None):
    """Functional alias of :meth:`PartialReduce.preduce`."""
    return PartialReduce.preduce(grad, mask, group)


def preduce_scatter_mean(grad, mask, group=None):
    """Functional alias of :meth:`PartialReduce.preduce_scatter`."""
    return PartialReduce.preduce_scatter(grad, mask, group)


__all__ = ["PartialReduce", "DistPartialReduce", "preduce_mean",
           "preduce_scatter_mean"]
