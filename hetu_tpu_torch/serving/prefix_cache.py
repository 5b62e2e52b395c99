"""Shared-prefix KV reuse for the decode plane (twin of
``hetu_tpu/serving/prefix_cache.py``).

The KV rows a prompt prefix produces depend on that prefix alone (each
cache row attends only to the rows before it), so when a sequence has
ingested its prompt the engine snapshots the prompt's rows here, and a
later request whose prompt extends a stored prefix seats with those rows
pre-filled: the shared part's prefill is skipped.

The index is a token trie: one node per stored-prefix position, each
remembering ONE entry whose key passes through it, so a lookup walks at
most ``len(prompt) - 1`` nodes and can reuse the first ``d`` rows of a
longer stored prompt that shares only ``d`` leading tokens.  Capacity is
bounded in bytes (``numel * element_size``), with LRU eviction on a tick
clock (a hit or an insert refreshes the tick, eviction removes the
smallest).

The port's caches are written in place (the decode step appends rows into
the cache tensors, and a recycled slot is overwritten), so a snapshot is
never a view of a cache: the engine hands :meth:`insert` clones, and the
stored tensors are never written again.  :meth:`lookup` returns them, or
views of them, on the asking engine's device.

The same reuse speeds stream recovery: a continuation's prompt is the
original prompt plus the tokens already delivered, and the dead replica's
snapshot of the original prompt (stores are shared across a fleet's
engines) seats it, so only the journal suffix is re-prefilled.

Threading: one lock guards the trie and the entry map so a store may be
shared across engines; slicing and device copies happen outside it.
Counters: the ``prefix_cache`` family.
"""
from __future__ import annotations

import threading

from ..metrics import record_prefix_cache


class _Entry:
    __slots__ = ("key", "rows", "nbytes", "tick")

    def __init__(self, key, rows, nbytes, tick):
        self.key = key          # tuple of int token ids, the full prefix
        self.rows = rows        # {cache_name: (heads, len(key), head_dim)}
        self.nbytes = nbytes
        self.tick = tick


class _Node:
    __slots__ = ("kids", "owner")

    def __init__(self):
        self.kids = {}          # token id -> _Node
        self.owner = None       # key of ONE entry passing through here


class PrefixKVStore:
    """Bounded, LRU-evicted store of KV snapshots keyed on token prefixes.

    ``capacity_bytes`` bounds the resident snapshot bytes;
    ``min_tokens`` skips prefixes too short to save a step.  Safe to share
    across engines.  The tensors handed to :meth:`insert` must not be
    written afterwards (the engine passes clones)."""

    def __init__(self, capacity_bytes=64 << 20, min_tokens=2):
        self.capacity_bytes = int(capacity_bytes)
        self.min_tokens = int(min_tokens)
        self._lock = threading.Lock()
        self._root = _Node()
        self._entries = {}      # key tuple -> _Entry
        self._bytes = 0
        self._clock = 0

    def __len__(self):
        with self._lock:
            return len(self._entries)

    @property
    def nbytes(self):
        with self._lock:
            return self._bytes

    def stats(self):
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "capacity_bytes": self.capacity_bytes}

    # -- lookup ------------------------------------------------------------

    def lookup(self, prompt, device=None):
        """Longest usable stored prefix of ``prompt``: ``(m, rows)`` where
        ``rows[name]`` holds the first ``m`` KV rows (``(heads, m,
        head_dim)``, on ``device`` when given), or ``(0, None)`` on a
        miss.  ``m`` is at most ``len(prompt) - 1``: one prompt token must
        still be fed for the first-token logits."""
        toks = [int(t) for t in prompt]
        limit = len(toks) - 1
        with self._lock:
            node, depth = self._root, 0
            best_key, best_m = None, 0
            while depth < limit:
                node = node.kids.get(toks[depth])
                if node is None:
                    break
                depth += 1
                if node.owner is not None and node.owner in self._entries:
                    best_key, best_m = node.owner, depth
            if best_key is None:
                record_prefix_cache("prefix_cache_misses")
                return 0, None
            ent = self._entries[best_key]
            self._clock += 1
            ent.tick = self._clock
            rows_full = ent.rows
            record_prefix_cache("prefix_cache_hits")
            record_prefix_cache("prefix_cache_hit_rows", best_m)
        # slice outside the lock: the stored tensors are never written
        if best_m == len(best_key):
            rows = dict(rows_full)
        else:
            rows = {name: r[:, :best_m, :] for name, r in rows_full.items()}
        if device is not None:
            rows = {name: r.to(device) for name, r in rows.items()}
        return best_m, rows

    # -- insert / evict ----------------------------------------------------

    def insert(self, prompt, rows):
        """Store ``rows`` (``{cache_name: (heads, len(prompt), head_dim)}``,
        never written afterwards) under ``prompt``'s token key.  Returns
        True when stored, False when skipped (too short, larger than the
        whole capacity, or an exact-key duplicate, which only refreshes
        the LRU tick)."""
        key = tuple(int(t) for t in prompt)
        if len(key) < self.min_tokens:
            return False
        nbytes = sum(int(r.numel()) * int(r.element_size())
                     for r in rows.values())
        if nbytes > self.capacity_bytes:
            return False
        with self._lock:
            self._clock += 1
            ent = self._entries.get(key)
            if ent is not None:
                ent.tick = self._clock
                record_prefix_cache("prefix_cache_dup_inserts")
                return False
            self._entries[key] = _Entry(key, dict(rows), nbytes,
                                        self._clock)
            self._bytes += nbytes
            node = self._root
            for t in key:
                node = node.kids.setdefault(t, _Node())
                node.owner = key
            record_prefix_cache("prefix_cache_inserts")
            while self._bytes > self.capacity_bytes:
                self._evict_locked()
            record_prefix_cache("prefix_cache_bytes_hw", self._bytes)
        return True

    def _evict_locked(self):
        victim = min(self._entries.values(), key=lambda e: e.tick)
        del self._entries[victim.key]
        self._bytes -= victim.nbytes
        record_prefix_cache("prefix_cache_evictions")
        record_prefix_cache("prefix_cache_evicted_bytes", victim.nbytes)
        # walk the victim's path bottom-up: clear owner references that
        # still point at it and prune nodes no live entry needs
        path, node = [self._root], self._root
        for t in victim.key:
            node = node.kids.get(t)
            if node is None:
                break
            path.append(node)
        for depth in range(len(path) - 1, 0, -1):
            node = path[depth]
            if node.owner == victim.key:
                node.owner = None
            if not node.kids and node.owner is None:
                del path[depth - 1].kids[victim.key[depth - 1]]

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._root = _Node()
            self._bytes = 0


__all__ = ["PrefixKVStore"]
