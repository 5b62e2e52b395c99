"""Per-key HET cache reference model: the semantic oracle (twin of
``hetu_tpu/ps/refcache.py``).

:class:`PerKeyCacheTable` implements the EXACT bounded-staleness contract
of the vectorized :class:`~hetu_tpu_torch.ps.dist_store.DistCacheTable`
(batch-granular hit/refresh decisions over sorted unique keys, eviction by
smallest ``(tick, key)`` / ``(freq, tick, key)``, push-bound accumulation,
grad-only slots, capacity-overflow spill), one key at a time: Python dict
churn per key and ONE single-row ``store.push`` RPC per dirty key
(miss-refresh, eviction, push-bound overflow, flush alike).  The tests
replay identical traces through both over identically-seeded stores and
require bitwise equality (outputs, final server table, versions, stats).
"""
from __future__ import annotations

import numpy as np


class PerKeyCacheTable:
    def __init__(self, store, table, limit=1 << 16, pull_bound=100,
                 push_bound=10, lr=-1.0, policy="lru"):
        self.store, self.table = store, table
        self.width = int(store.width(table))
        self.limit = int(limit)
        self.pull_bound, self.push_bound = int(pull_bound), int(push_bound)
        self.lr = lr
        policy = policy.lower()
        if policy not in ("lru", "lfu"):
            raise ValueError(f"unknown cache policy {policy!r}")
        self.policy = policy
        self._rows = {}     # key -> row (None = grad-only, never serves)
        self._uses = {}     # key -> lookups since refresh
        self._grad = {}     # key -> accumulated grad
        self._gcnt = {}     # key -> pending update events
        self._tick_of = {}  # key -> last-touch clock
        self._freq = {}     # key -> touch count since insert
        self._tick = 0
        self.stats = {"lookups": 0, "hits": 0, "evictions": 0, "pushes": 0,
                      "fetches": 0, "updates": 0, "push_rpcs": 0}

    # -- per-key push: the pre-PR one-RPC-per-dirty-key pattern ------------
    def _push_key(self, k):
        g = self._grad.pop(k, None)
        self._gcnt.pop(k, None)
        if g is not None:
            self.store.push(self.table, np.asarray([k], np.int64),
                            g[None, :], self.lr)
            self.stats["pushes"] += 1
            self.stats["push_rpcs"] += 1

    def _victims(self, need, protect):
        """Evictable keys, worst-first by the policy order, excluding the
        current batch's keys."""
        cands = [k for k in self._rows if k not in protect]
        if self.policy == "lru":
            cands.sort(key=lambda k: (self._tick_of[k], k))
        else:
            cands.sort(key=lambda k: (self._freq[k], self._tick_of[k], k))
        return cands[:min(need, len(cands))]

    def _evict(self, victims):
        for k in victims:
            self._push_key(k)
            for d in (self._rows, self._uses, self._tick_of, self._freq):
                d.pop(k, None)
            self.stats["evictions"] += 1

    def lookup(self, keys):
        keys = np.ascontiguousarray(keys, np.int64)
        flat = keys.reshape(-1)
        self._tick += 1
        self.stats["lookups"] += int(flat.size)
        if not flat.size:
            return np.empty(keys.shape + (self.width,), np.float32)
        uk, cnt = np.unique(flat, return_counts=True)
        served = {}
        hit_keys = set()
        refresh = []
        # batch-granular DECISIONS over the sorted unique keys (the
        # shared contract)…
        for k, c in zip(uk.tolist(), cnt.tolist()):
            if (k in self._rows and self._rows[k] is not None
                    and self._uses[k] < self.pull_bound):
                served[k] = self._rows[k]
                hit_keys.add(k)
                self._tick_of[k] = self._tick
            else:
                refresh.append((k, c))
        if refresh:
            batch_keys = set(uk.tolist())
            # pending grads of stale rows land before the re-pull
            for k, _ in refresh:
                if k in self._rows:
                    self._push_key(k)
            new = [k for k, _ in refresh if k not in self._rows]
            avail = self.limit - len(self._rows)
            if len(new) > avail:
                self._evict(self._victims(len(new) - avail, batch_keys))
            cacheable = set(new[:self.limit - len(self._rows)])
            rk = np.asarray([k for k, _ in refresh], np.int64)
            rows = self.store.pull(self.table, rk)
            self.stats["fetches"] += len(refresh)
            for (k, c), row in zip(refresh, rows):
                served[k] = row
                if k in self._rows or k in cacheable:
                    if k in cacheable:       # fresh insert: freq restarts
                        self._freq[k] = 0
                    self._rows[k] = row.copy()
                    self._uses[k] = c
                    self._tick_of[k] = self._tick
                    self._freq[k] += c
        # …then per-OCCURRENCE serving with per-occurrence bookkeeping —
        # the pre-PR lookup's exact cost shape (dict get + uses/freq/stat
        # increments for every one of the batch's ids)
        out = np.empty((flat.size, self.width), np.float32)
        for i, k in enumerate(flat.tolist()):
            out[i] = served[k]
            if k in hit_keys:
                self._uses[k] += 1
                self._freq[k] += 1
                self.stats["hits"] += 1
        return out.reshape(keys.shape + (self.width,))

    def update(self, keys, grads):
        keys = np.ascontiguousarray(keys, np.int64).reshape(-1)
        if not keys.size:
            return
        grads = np.ascontiguousarray(grads, np.float32).reshape(
            keys.size, -1)
        self._tick += 1
        self.stats["updates"] += int(keys.size)
        uk, cnt = np.unique(keys, return_counts=True)
        # per-OCCURRENCE accumulation, one fresh array per add — the
        # pre-PR update()'s exact cost shape (and bitwise-identical
        # occurrence-order float32 sums)
        sums = {}
        for k, g in zip(keys.tolist(), grads):
            a = sums.get(k)
            sums[k] = g.copy() if a is None else a + g
        acc = np.stack([sums[k] for k in uk.tolist()])
        batch_keys = set(uk.tolist())
        new = [k for k in uk.tolist() if k not in self._rows]
        avail = self.limit - len(self._rows)
        if len(new) > avail:
            self._evict(self._victims(len(new) - avail, batch_keys))
        cacheable = set(new[:self.limit - len(self._rows)])
        for k, c, g in zip(uk.tolist(), cnt.tolist(), acc):
            if k not in self._rows:
                if k not in cacheable:
                    # capacity overflow: straight out, uncached
                    self.store.push(self.table, np.asarray([k], np.int64),
                                    g[None, :], self.lr)
                    self.stats["pushes"] += 1
                    self.stats["push_rpcs"] += 1
                    continue
                self._rows[k] = None       # grad-only slot: born stale
                self._uses[k] = self.pull_bound
                self._freq[k] = 0
            self._grad[k] = self._grad.get(
                k, np.zeros(self.width, np.float32)) + g
            self._gcnt[k] = self._gcnt.get(k, 0) + c
            self._tick_of[k] = self._tick
            self._freq[k] += c
            if self._gcnt[k] >= self.push_bound:
                self._push_key(k)
                self._uses[k] = self.pull_bound   # server is ahead: stale

    def flush(self):
        for k in sorted(self._grad):
            self._push_key(k)
            self._uses[k] = self.pull_bound

    def perf(self):
        d = dict(self.stats)
        d["size"] = len(self._rows)
        d["hit_rate"] = (d["hits"] / d["lookups"]) if d["lookups"] else 0.0
        return d

    def __len__(self):
        return len(self._rows)
