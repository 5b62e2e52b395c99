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

Not ported, refused by name: ``DistPartialReduce`` (group formation from
the distributed store's SSP clocks).
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
    """Group formation from the distributed store's SSP clocks: not
    ported."""

    def __init__(self, store, *args, **kwargs):
        raise NotImplementedError(
            "DistPartialReduce: group formation from the distributed "
            "store's SSP clocks is not ported; PartialReduce forms the "
            "group on the host")


def preduce_mean(grad, mask, group=None):
    """Functional alias of :meth:`PartialReduce.preduce`."""
    return PartialReduce.preduce(grad, mask, group)


def preduce_scatter_mean(grad, mask, group=None):
    """Functional alias of :meth:`PartialReduce.preduce_scatter`."""
    return PartialReduce.preduce_scatter(grad, mask, group)


__all__ = ["PartialReduce", "DistPartialReduce", "preduce_mean",
           "preduce_scatter_mean"]
