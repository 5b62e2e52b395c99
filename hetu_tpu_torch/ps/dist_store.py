"""The HET bounded-staleness embedding cache (twin of the cache half of
``hetu_tpu/ps/dist_store.py``: ``_segment_sum``, ``_DevLookup`` and
``DistCacheTable``).

Not ported, refused by name: the multi-host store (``DistributedStore``,
``StoreServer``: sharding, replication, fencing) and the cache's read-only
serving mode (``read_only``, ``refresh_every``).  The cache works over
the port's :class:`~hetu_tpu_torch.ps.store.EmbeddingStore`.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..context import resolve_device
from ..metrics import record_cache


def _segment_sum(grads, inv, counts):
    """Per-unique-key float32 grad sums (the host cache's segment sum):
    a one-hot CSR product when scipy is present, which adds each key's
    occurrences in batch order, starting from zero; ``np.add.at``
    otherwise, counted as ``emb_grad_host_fallback`` in the cache family.
    With every key distinct it only reorders."""
    if counts.size == inv.size:
        return np.ascontiguousarray(grads[np.argsort(inv, kind="stable")])
    try:
        from scipy import sparse as _sp
        onehot = _sp.csr_matrix(
            (np.ones(inv.size, np.float32), inv,
             np.arange(inv.size + 1, dtype=np.int64)),
            shape=(inv.size, counts.size))
        return np.asarray(onehot.T @ grads, np.float32)
    except ImportError:
        record_cache("emb_grad_host_fallback", 1)
        out = np.zeros((counts.size, grads.shape[1]), np.float32)
        np.add.at(out, inv, grads)
        return out


class DistributedStore:
    """Not ported: the multi-host sharded store."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "DistributedStore (the multi-host sharded parameter server) is "
            "not ported: use hetu_tpu_torch.ps.EmbeddingStore")


class StoreServer:
    """Not ported: the TCP server of a store shard."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "StoreServer (the parameter-server shard's TCP server) is not "
            "ported")


class _DevLookup:
    """Pending device-mode lookup (:meth:`DistCacheTable.begin_lookup`):
    the host-side plan frozen before the one fallible store round trip.
    :meth:`roundtrip` touches ONLY the store (no cache state, no lock), so
    it is safe on any thread: the executor runs it on its feed thread."""

    __slots__ = ("cache", "flat", "uk", "inv", "cnt", "slots",
                 "hit", "refresh", "rkeys", "rslots", "dirty", "plan",
                 "absent", "pk", "pg", "positions", "fill_targets", "done")

    def __init__(self, cache, flat):
        self.cache, self.flat = cache, flat
        self.uk = self.inv = self.cnt = self.slots = None
        self.hit = self.refresh = None
        self.rkeys = self.rslots = None
        self.dirty = self.plan = self.absent = None
        self.pk = self.pg = None
        self.positions = self.fill_targets = None
        self.done = False

    def roundtrip(self):
        """Pending pushes + the batched MISS pull, fused into one
        ``push_pull`` when both are due.  Returns the pulled rows aligned
        to ``rkeys`` (None when the batch had no misses)."""
        c = self.cache
        rows = None
        if self.pk is not None:
            if self.rkeys is not None:
                rows = c.store.push_pull(c.table, self.pk, self.pg,
                                         self.rkeys, c.lr)
            else:
                c.store.push(c.table, self.pk, self.pg, c.lr)
        if rows is None and self.rkeys is not None:
            rows = c.store.pull(c.table, self.rkeys)
        return rows


class DistCacheTable:
    """HET bounded-staleness embedding cache, vectorized and batch-granular
    (reference ``src/hetu_cache/cache.h`` pull_bound / push_bound
    semantics; HET, VLDB'22), over an :class:`EmbeddingStore` table.

    Storage is a ``(limit, width)`` float32 slab plus an open-addressed
    int64 key→slot hash table in numpy.  The contract (the JAX package's
    per-key oracle ``refcache.py`` implements the same rules):

    - Decisions are batch-granular over the call's sorted unique keys: a
      key is a HIT iff cached with ``uses < pull_bound``; its occurrences
      serve the same row and ``uses`` grows by the occurrence count.  A
      refresh (stale or absent) re-pulls the row and restarts ``uses`` at
      the occurrence count.
    - ``update`` accumulates per-key grads client-side (``gcnt`` grows by
      the occurrence count); reaching ``push_bound`` pushes the
      accumulated grad and invalidates the row (``uses = pull_bound``), as
      does ``flush``.  Updating an uncached key allocates a grad-only slot
      that never serves.
    - Eviction at ``limit``: victims are the smallest ``(tick, key)``
      [LRU] or ``(freq, tick, key)`` [LFU] among slots the batch does not
      touch; dirty victims join the batched push.  Unique keys beyond
      capacity are served (and their grads pushed) uncached.

    **Device-resident mode** (``device=True``): the slot table, hash
    table, clocks and commit protocol stay on the host, unchanged, and the
    row slab lives on ``slab_device`` (CUDA by default; the CPU only when
    asked for) as ``(limit + device_scratch + 1, width)`` float32: the
    ``limit`` cache slots, ``device_scratch`` rows at ``[limit, limit +
    scratch)`` for a batch's uncacheable keys, and the JAX layout's one
    spare row.  A lookup is :meth:`begin_lookup` (plan, under the lock) →
    :meth:`_DevLookup.roundtrip` (pushes + MISS pull, lock-free) →
    :meth:`finish_lookup` (commit, and the miss rows land in the slab in
    place).  Hit rows are gathered on the card by slot index (kernel B4),
    and the training grads arrive summed per unique key (kernel B5)
    through :meth:`apply_update_summed`.  The lock is held from
    ``begin_lookup`` to ``finish_lookup`` / :meth:`abort_lookup`.  The
    host ``_data`` slab is not kept in device mode.
    """

    _EMPTY, _TOMB = -1, -2

    def __init__(self, store, table, limit=1 << 16, pull_bound=100,
                 push_bound=10, lr=-1.0, policy="lru", read_only=False,
                 refresh_every=0, device=False, device_scratch=None,
                 device_interpret=None, slab_device=None):
        if read_only or refresh_every:
            raise NotImplementedError(
                "DistCacheTable(read_only=, refresh_every=): the read-only "
                "serving cache is not ported")
        if device_interpret is not None:
            raise NotImplementedError(
                "DistCacheTable(device_interpret=): the port's kernels are "
                "CUDA, with no interpret mode; a CPU slab "
                "(slab_device='cpu') takes their plain versions")
        self.store, self.table = store, table
        self.width = int(store.width(table))
        self.limit = int(limit)
        self.pull_bound, self.push_bound = int(pull_bound), int(push_bound)
        self.lr = lr
        self.device = bool(device)
        #: where the device slab lives (device mode only)
        self.slab_device = resolve_device(slab_device) if self.device \
            else None
        self._dev_scratch = int(device_scratch) if device_scratch \
            is not None else max(256, self.limit // 4)
        self._dev_slab = None
        policy = policy.lower()
        if policy not in ("lru", "lfu"):
            raise ValueError(f"unknown cache policy {policy!r}")
        self.policy = policy
        L, w = self.limit, self.width
        self._data = np.zeros((0 if self.device else L, w), np.float32)
        self._grad = np.zeros((L, w), np.float32)   # pending grad slab
        self._slotkey = np.full(L, self._EMPTY, np.int64)
        self._uses = np.zeros(L, np.int64)     # lookups since refresh
        self._gcnt = np.zeros(L, np.int64)     # pending update events
        self._ticks = np.zeros(L, np.int64)    # last-touch clock (LRU)
        self._freq = np.zeros(L, np.int64)     # touch count (LFU)
        cap = 1 << max(6, (4 * L - 1).bit_length())   # load factor <= 1/4
        self._hcap, self._hmask = cap, cap - 1
        self._hkey = np.full(cap, self._EMPTY, np.int64)
        self._hslot = np.zeros(cap, np.int64)
        self._htomb = 0
        # popping from the end hands out ascending slot ids
        self._freelist = np.arange(L - 1, -1, -1, dtype=np.int64)
        self._nfree = L
        self._tick = 0
        self._lock = threading.RLock()
        #: (flat, uk, inv, cnt, slots) of the latest host lookup, reused
        #: by an update of the same ids
        self._batch_memo = None
        self.stats = {"lookups": 0, "hits": 0, "evictions": 0, "pushes": 0,
                      "fetches": 0, "updates": 0, "push_rpcs": 0}

    # -- open-addressed int64 hash table (vectorized linear probing) -------
    def _hash(self, keys):
        h = keys.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
        h ^= h >> np.uint64(29)
        return (h & np.uint64(self._hmask)).astype(np.int64)

    def _find(self, ukeys):
        """Slot of each (unique) key, -1 if absent; every probe round
        advances all unresolved keys one step."""
        out = np.full(ukeys.size, -1, np.int64)
        if not ukeys.size:
            return out
        pend = np.arange(ukeys.size)
        h = self._hash(ukeys)
        while pend.size:
            hk = self._hkey[h]
            found = hk == ukeys[pend]
            if found.any():
                out[pend[found]] = self._hslot[h[found]]
            keep = ~(found | (hk == self._EMPTY))   # TOMB keeps probing
            if not keep.any():
                break
            pend = pend[keep]
            h = (h[keep] + 1) & self._hmask
        return out

    def _hinsert(self, ukeys, slots):
        """Insert absent unique keys; rival claims on one free cell are
        resolved per round (first claimant wins, the rest re-probe)."""
        if not ukeys.size:
            return
        pend = np.arange(ukeys.size)
        h = self._hash(ukeys)
        while pend.size:
            hk = self._hkey[h]
            usable = (hk == self._EMPTY) | (hk == self._TOMB)
            if usable.any():
                _, first = np.unique(h[usable], return_index=True)
                winners = np.flatnonzero(usable)[first]
                wcells = h[winners]
                self._htomb -= int((self._hkey[wcells] == self._TOMB).sum())
                self._hkey[wcells] = ukeys[pend[winners]]
                self._hslot[wcells] = slots[pend[winners]]
                keep = np.ones(pend.size, bool)
                keep[winners] = False
                pend, h = pend[keep], h[keep]
            h = (h + 1) & self._hmask

    def _hdelete(self, ukeys):
        """Tombstone present unique keys (chains through them survive)."""
        if not ukeys.size:
            return
        pend = np.arange(ukeys.size)
        h = self._hash(ukeys)
        while pend.size:
            hk = self._hkey[h]
            found = hk == ukeys[pend]
            if found.any():
                self._hkey[h[found]] = self._TOMB
                self._htomb += int(found.sum())
            keep = ~(found | (hk == self._EMPTY))
            if not keep.any():
                break
            pend, h = pend[keep], h[keep]
            h = (h + 1) & self._hmask

    def _maybe_rehash(self):
        if self._htomb <= self._hcap // 4:
            return
        self._hkey.fill(self._EMPTY)
        self._htomb = 0
        occ = np.flatnonzero(self._slotkey >= 0)
        self._hinsert(self._slotkey[occ], occ)

    # -- slot allocation + vectorized victim selection ---------------------
    def _pick_victims(self, occ, n_ev):
        """The ``n_ev`` worst occupied slots under the policy's order —
        LRU ``(tick, key)``, LFU ``(freq, tick, key)`` — by argpartition
        on the primary clock and a lexsort of the boundary ties."""
        if n_ev >= occ.size:
            return occ
        prim = self._ticks[occ] if self.policy == "lru" \
            else self._freq[occ]
        part = np.argpartition(prim, n_ev - 1)[:n_ev]
        thresh = prim[part].max()
        sure = part[prim[part] < thresh]
        ties = np.flatnonzero(prim == thresh)
        if self.policy == "lru":
            order = np.argsort(self._slotkey[occ[ties]], kind="stable")
        else:
            order = np.lexsort((self._slotkey[occ[ties]],
                                self._ticks[occ[ties]]))
        chosen = ties[order[:n_ev - sure.size]]
        return occ[np.concatenate((sure, chosen))]

    def _plan_slots(self, newkeys, protect_slots):
        """PLAN slots for absent sorted unique ``newkeys``: free slots
        first, then victims among slots not in ``protect_slots``; overflow
        stays -1 (uncacheable).  A pure read: nothing is committed until
        :meth:`_commit_slots`."""
        slots = np.full(newkeys.size, -1, np.int64)
        take = min(newkeys.size, self._nfree)
        if take:
            slots[:take] = self._freelist[self._nfree - take:
                                          self._nfree][::-1]
        need = newkeys.size - take
        evslots = evkeys = np.empty(0, np.int64)
        if need > 0:
            protect = np.zeros(self.limit, bool)
            protect[protect_slots] = True
            occ = np.flatnonzero((self._slotkey >= 0) & ~protect)
            n_ev = min(need, occ.size)
            if n_ev > 0:
                evslots = self._pick_victims(occ, n_ev)
                evkeys = self._slotkey[evslots].copy()
                slots[take:take + n_ev] = evslots
        return slots, take, evslots, evkeys

    def _plan_dirty(self, slot_sel):
        """(dirty slots, their keys, grad copies) among ``slot_sel``."""
        dirty = slot_sel[self._gcnt[slot_sel] > 0]
        if not dirty.size:
            return dirty, None, None
        return dirty, self._slotkey[dirty].copy(), self._grad[dirty].copy()

    def _commit_slots(self, newkeys, plan):
        """Apply a :meth:`_plan_slots` plan: pop the freelist, tombstone
        and reset victims, register the new keys.  Returns the registered
        (keys, slots)."""
        slots, take, evslots, evkeys = plan
        self._nfree -= take
        if evslots.size:
            self._hdelete(evkeys)
            self._grad[evslots] = 0.0
            self._gcnt[evslots] = 0
            self.stats["evictions"] += int(evslots.size)
            record_cache("emb_cache_evict_rows", int(evslots.size))
        reg = slots >= 0
        regk, regs = newkeys[reg], slots[reg]
        self._slotkey[regs] = regk
        self._hinsert(regk, regs)
        self._freq[regs] = 0
        return regk, regs

    def _flush_to_store(self, push_keys, push_grads, pull_keys=None):
        """ONE store round trip for everything pending: the push list and,
        when ``pull_keys`` is given, the refresh pull.  Counters record
        only after it succeeds."""
        rows = None
        if push_keys:
            pk = np.concatenate(push_keys)
            pg = np.concatenate(push_grads)
            order = np.argsort(pk, kind="stable")   # deterministic wire
            pk, pg = pk[order], pg[order]
            if pull_keys is not None:
                rows = self.store.push_pull(self.table, pk, pg, pull_keys,
                                            self.lr)
            else:
                self.store.push(self.table, pk, pg, self.lr)
            self.stats["pushes"] += int(pk.size)
            self.stats["push_rpcs"] += 1
            record_cache("emb_cache_push_rows", int(pk.size))
            record_cache("emb_cache_push_rpcs", 1)
        if rows is None and pull_keys is not None:
            rows = self.store.pull(self.table, pull_keys)
        return rows

    # -- core ops ----------------------------------------------------------
    def lookup(self, keys):
        """Rows for ``keys`` (any shape) → keys.shape + (width,), numpy."""
        keys = np.ascontiguousarray(keys, np.int64)
        if self.device:
            return self._lookup_device(keys)
        with self._lock:
            out = self._lookup_locked(keys.reshape(-1))
        return out.reshape(keys.shape + (self.width,))

    # -- device-resident mode ------------------------------------------------
    def _ensure_dev_slab(self):
        """The device row slab, built on first use."""
        if self._dev_slab is None:
            self._dev_slab = torch.zeros(
                (self.limit + self._dev_scratch + 1, self.width),
                dtype=torch.float32, device=self.slab_device)
        return self._dev_slab

    def begin_lookup(self, keys):
        """Device-mode lookup, phase 1 of 3: take the cache lock and PLAN
        (hit/refresh partition, victims, push payload copies, slab
        positions), the pre-round-trip half of the host ``lookup``.
        Returns a :class:`_DevLookup`; after its ``roundtrip``,
        :meth:`finish_lookup` commits or :meth:`abort_lookup` releases
        with the cache untouched.  The lock stays held until then."""
        if not self.device:
            raise RuntimeError("begin_lookup requires device=True")
        keys = np.ascontiguousarray(keys, np.int64)
        flat = keys.reshape(-1)
        self._lock.acquire()
        try:
            h = _DevLookup(self, flat)
            self._tick += 1
            self._batch_memo = None
            self.stats["lookups"] += int(flat.size)
            if not flat.size:
                return h
            uk, inv, cnt = np.unique(flat, return_inverse=True,
                                     return_counts=True)
            slots = self._find(uk)
            present = slots >= 0
            hit = np.zeros(uk.size, bool)
            hit[present] = self._uses[slots[present]] < self.pull_bound
            refresh = ~hit
            h.uk, h.inv, h.cnt = uk, inv, cnt
            h.slots, h.hit, h.refresh = slots, hit, refresh
            push_keys, push_grads = [], []
            if refresh.any():
                rkeys = uk[refresh]
                rslots = slots[refresh].copy()
                stale = rslots >= 0
                dirty, dkeys, dgrads = self._plan_dirty(rslots[stale])
                if dirty.size:
                    push_keys.append(dkeys)
                    push_grads.append(dgrads)
                absent = ~stale
                plan = None
                if absent.any():
                    plan = self._plan_slots(rkeys[absent], slots[present])
                    ev_dirty, evk, evg = self._plan_dirty(plan[2])
                    if ev_dirty.size:
                        push_keys.append(evk)
                        push_grads.append(evg)
                    rslots[absent] = plan[0]
                h.rkeys, h.rslots = rkeys, rslots
                h.dirty, h.plan, h.absent = dirty, plan, absent
            if push_keys:
                pk = np.concatenate(push_keys)
                pg = np.concatenate(push_grads)
                order = np.argsort(pk, kind="stable")  # deterministic wire
                h.pk, h.pg = pk[order], pg[order]
            # slab position per unique key: its committed or planned slot,
            # or a scratch row for a key beyond capacity (served uncached)
            pos = slots.copy()
            if h.rslots is not None:
                pos[refresh] = h.rslots
            over = pos < 0
            n_over = int(over.sum())
            if n_over > self._dev_scratch:
                raise RuntimeError(
                    f"device-mode batch overflow: {n_over} uncacheable "
                    f"unique keys exceed device_scratch="
                    f"{self._dev_scratch} — raise device_scratch (or "
                    f"limit), or use the host cache for this workload")
            pos[over] = self.limit + np.arange(n_over)
            h.positions = pos
            if h.rkeys is not None:
                h.fill_targets = pos[refresh]
            return h
        except BaseException:
            self._lock.release()
            raise

    def finish_lookup(self, h, rows):
        """Device-mode lookup, phase 3: COMMIT the plan with the pulled
        miss ``rows`` (aligned to ``h.rkeys``): slot registration, hit and
        eviction bookkeeping, counters, and the in-place slab fill; then
        release the lock."""
        try:
            if h.flat.size == 0:
                return
            uk, cnt, hit, refresh = h.uk, h.cnt, h.hit, h.refresh
            if h.pk is not None:
                self.stats["pushes"] += int(h.pk.size)
                self.stats["push_rpcs"] += 1
                record_cache("emb_cache_push_rows", int(h.pk.size))
                record_cache("emb_cache_push_rpcs", 1)
            slots = h.slots
            if h.rkeys is not None:
                rslots = h.rslots
                self.stats["fetches"] += int(h.rkeys.size)
                if h.dirty.size:
                    self._grad[h.dirty] = 0.0
                    self._gcnt[h.dirty] = 0
                if h.plan is not None:
                    self._commit_slots(h.rkeys[h.absent], h.plan)
                cached = rslots >= 0
                if cached.all():
                    cs, cnt_r = rslots, cnt[refresh]
                else:
                    cs = rslots[cached]
                    cnt_r = cnt[refresh][cached]
                self._uses[cs] = cnt_r
                self._ticks[cs] = self._tick
                self._freq[cs] += cnt_r
                self._maybe_rehash()
                slots = slots.copy()
                slots[refresh] = rslots
            n_hit_rows = int(cnt[hit].sum())
            self.stats["hits"] += n_hit_rows
            record_cache("emb_cache_hit_rows", n_hit_rows)
            record_cache("emb_cache_miss_rows",
                         int(h.flat.size) - n_hit_rows)
            if hit.any():
                hs = slots[hit]
                self._uses[hs] += cnt[hit]
                self._ticks[hs] = self._tick
                self._freq[hs] += cnt[hit]
            self._batch_memo = (h.flat, uk, h.inv, cnt, slots)
            if h.rkeys is not None:
                try:
                    self._apply_dev_fill(rows, h.fill_targets)
                except BaseException:
                    # the host commit above stands (the pushes landed); a
                    # slot whose row never reached the slab must not serve
                    if cs.size:
                        self._uses[cs] = self.pull_bound
                    raise
        finally:
            h.done = True
            self._lock.release()

    def _apply_dev_fill(self, rows, targets):
        """Land pulled rows in the device slab in place, on the current
        stream (a later gather on the same stream sees them)."""
        from ..ops.kernels import emb_cache as _emb
        slab = self._ensure_dev_slab()
        _emb.fill_rows(
            slab, torch.from_numpy(np.ascontiguousarray(rows, np.float32))
            .to(slab.device),
            torch.from_numpy(np.asarray(targets, np.int64)).to(slab.device))

    def abort_lookup(self, h):
        """Release a :meth:`begin_lookup` handle after a failed round
        trip: the plan is discarded and nothing was mutated by it."""
        if not h.done:
            h.done = True
            self._lock.release()

    def gather(self, h):
        """The batch's rows gathered from the slab, (n, width) on the
        slab's device (kernel B4 on a CUDA slab).  Call with the lock held
        across :meth:`finish_lookup` and this gather."""
        from ..ops.kernels import emb_cache as _emb
        slab = self._ensure_dev_slab()
        if not h.flat.size:
            return slab.new_zeros((0, self.width))
        slots = torch.from_numpy(h.positions[h.inv].astype(np.int32))
        return _emb.emb_gather(slab, slots.to(slab.device))

    def _lookup_device(self, keys):
        """Standalone device-mode lookup: begin → round trip → commit, and
        the gather.  The RLock is re-entered around commit + gather
        (depth 2: ``finish_lookup``'s release drops to 1), so no other
        thread evicts one of this batch's slots in between.  Returns host
        rows, as the host mode does."""
        h = self.begin_lookup(keys)
        try:
            rows = h.roundtrip()
        except BaseException:
            self.abort_lookup(h)
            raise
        self._lock.acquire()
        try:
            self.finish_lookup(h, rows)
            out = self.gather(h)
        finally:
            self._lock.release()
        return out.cpu().numpy().reshape(keys.shape + (self.width,))

    # -- host mode -----------------------------------------------------------
    def _lookup_locked(self, flat):
        self._tick += 1
        self._batch_memo = None
        self.stats["lookups"] += int(flat.size)
        if not flat.size:
            return np.empty((0, self.width), np.float32)
        uk, inv, cnt = np.unique(flat, return_inverse=True,
                                 return_counts=True)
        slots = self._find(uk)
        present = slots >= 0
        hit = np.zeros(uk.size, bool)
        hit[present] = self._uses[slots[present]] < self.pull_bound
        rows_out = np.empty((uk.size, self.width), np.float32)
        refresh = ~hit
        if refresh.any():
            rkeys = uk[refresh]
            rslots = slots[refresh].copy()
            push_keys, push_grads = [], []
            # stale rows keep their slots; their pending grads land BEFORE
            # the re-pull, so the refreshed value includes them
            stale = rslots >= 0
            dirty, dkeys, dgrads = self._plan_dirty(rslots[stale])
            if dirty.size:
                push_keys.append(dkeys)
                push_grads.append(dgrads)
            absent = ~stale
            plan = None
            if absent.any():
                plan = self._plan_slots(rkeys[absent], slots[present])
                ev_dirty, evk, evg = self._plan_dirty(plan[2])
                if ev_dirty.size:
                    push_keys.append(evk)
                    push_grads.append(evg)
                rslots[absent] = plan[0]
            # the one fallible step: a failure leaves the cache untouched
            rows = self._flush_to_store(push_keys, push_grads, rkeys)
            self.stats["fetches"] += int(rkeys.size)
            if dirty.size:
                self._grad[dirty] = 0.0
                self._gcnt[dirty] = 0
            if plan is not None:
                self._commit_slots(rkeys[absent], plan)
            cached = rslots >= 0
            if cached.all():
                cs, rows_c, cnt_r = rslots, rows, cnt[refresh]
            else:
                cs, rows_c = rslots[cached], rows[cached]
                cnt_r = cnt[refresh][cached]
            self._data[cs] = rows_c
            self._uses[cs] = cnt_r
            self._ticks[cs] = self._tick
            self._freq[cs] += cnt_r
            rows_out[refresh] = rows
            self._maybe_rehash()
            slots = slots.copy()
            slots[refresh] = rslots
        # hit bookkeeping after the round trip: a failed lookup burns no
        # pull_bound budget
        n_hit_rows = int(cnt[hit].sum())
        self.stats["hits"] += n_hit_rows
        record_cache("emb_cache_hit_rows", n_hit_rows)
        record_cache("emb_cache_miss_rows", int(flat.size) - n_hit_rows)
        if hit.any():
            hs = slots[hit]
            self._uses[hs] += cnt[hit]
            self._ticks[hs] = self._tick
            self._freq[hs] += cnt[hit]
            rows_out[hit] = self._data[hs]
        self._batch_memo = (flat, uk, inv, cnt, slots)
        return rows_out[inv]

    def update(self, keys, grads):
        """Accumulate per-occurrence ``grads`` for ``keys``."""
        keys = np.ascontiguousarray(keys, np.int64).reshape(-1)
        if not keys.size:
            return
        grads = np.ascontiguousarray(grads, np.float32).reshape(keys.size,
                                                                -1)
        if self.device:
            # the per-unique-key sum through the device scatter-add (the
            # executor hands in sums it made in the step instead)
            from ..ops.kernels import emb_cache as _emb
            uk, inv, cnt = np.unique(keys, return_inverse=True,
                                     return_counts=True)
            dev = self.slab_device
            acc = _emb.emb_scatter_add(
                torch.from_numpy(grads).to(dev),
                torch.from_numpy(inv.astype(np.int32)).to(dev))
            self.apply_update_summed(uk, acc[:uk.size].cpu().numpy(), cnt)
            return
        with self._lock:
            self._update_locked(keys, grads)

    def apply_update_summed(self, uk, acc, cnt):
        """Update entry for grads already summed per unique key: ``uk``
        the batch's sorted unique keys, ``acc`` their grad sums, ``cnt``
        their occurrence counts; the same integer decisions as ``update``
        on the same batch."""
        uk = np.ascontiguousarray(uk, np.int64).reshape(-1)
        acc = np.ascontiguousarray(acc, np.float32).reshape(uk.size, -1)
        cnt = np.ascontiguousarray(cnt, np.int64).reshape(-1)
        with self._lock:
            self._tick += 1
            self._batch_memo = None
            self.stats["updates"] += int(cnt.sum())
            if not uk.size:
                return
            self._apply_update(uk, cnt, self._find(uk), acc)

    def _update_locked(self, flat, grads):
        self._tick += 1
        memo, self._batch_memo = self._batch_memo, None
        self.stats["updates"] += int(flat.size)
        if memo is not None and memo[0].size == flat.size \
                and np.array_equal(memo[0], flat):
            # the preceding lookup partitioned this exact batch
            _, uk, inv, cnt, slots = memo
            slots = slots.copy()
        else:
            uk, inv, cnt = np.unique(flat, return_inverse=True,
                                     return_counts=True)
            slots = self._find(uk)
        acc = _segment_sum(grads, inv, cnt)
        self._apply_update(uk, cnt, slots, acc)

    def _apply_update(self, uk, cnt, slots, acc):
        """The post-segment-sum half of ``update``: slot planning for
        absent keys, push-bound accounting, the one batched push, and the
        commit."""
        present = slots >= 0
        push_keys, push_grads = [], []
        absent = ~present
        plan = None
        if absent.any():
            plan = self._plan_slots(uk[absent], slots[present])
            ev_dirty, evk, evg = self._plan_dirty(plan[2])
            if ev_dirty.size:
                push_keys.append(evk)
                push_grads.append(evg)
            slots[absent] = plan[0]
        cached = slots >= 0
        if cached.all():
            cs, acc_c, cnt_c = slots, acc, cnt
        else:
            cs, acc_c, cnt_c = slots[cached], acc[cached], cnt[cached]
            # keys beyond capacity push their grads at once
            push_keys.append(uk[~cached])
            push_grads.append(acc[~cached])
        # push-bound overflow on the post-batch counts; a slot planned for
        # a new key still holds its victim's gcnt/grad, so a fresh key
        # starts from zero
        fresh = None
        if plan is not None:
            fresh = (absent & (slots >= 0))[cached] if not cached.all() \
                else absent
        prior_gcnt = self._gcnt[cs] if fresh is None \
            else np.where(fresh, 0, self._gcnt[cs])
        new_gcnt = prior_gcnt + cnt_c
        exceed = new_gcnt >= self.push_bound
        if exceed.any():
            es = cs[exceed]
            pgrads = self._grad[es] + acc_c[exceed]
            if fresh is not None and fresh[exceed].any():
                pgrads[fresh[exceed]] = acc_c[exceed][fresh[exceed]]
            push_keys.append(uk[cached][exceed])
            push_grads.append(pgrads)
        # the one fallible step: one batched push
        self._flush_to_store(push_keys, push_grads)
        if plan is not None:
            regk, regs = self._commit_slots(uk[absent], plan)
            # grad-only slots were never pulled: born stale, never serve
            if not self.device:
                self._data[regs] = 0.0
            self._uses[regs] = self.pull_bound
        self._grad[cs] += acc_c
        self._gcnt[cs] = new_gcnt
        self._ticks[cs] = self._tick
        self._freq[cs] += cnt_c
        if exceed.any():
            self._grad[es] = 0.0
            self._gcnt[es] = 0
            self._uses[es] = self.pull_bound   # the server is ahead: stale
        self._maybe_rehash()

    def flush(self):
        """Push every pending accumulated grad (ONE batched push) and
        invalidate the pushed rows (a checkpoint barrier)."""
        with self._lock:
            d = np.flatnonzero((self._slotkey >= 0) & (self._gcnt > 0))
            if d.size:
                d = d[np.argsort(self._slotkey[d], kind="stable")]
                self._flush_to_store([self._slotkey[d].copy()],
                                     [self._grad[d].copy()])
                self._grad[d] = 0.0
                self._gcnt[d] = 0
                self._uses[d] = self.pull_bound

    def perf(self):
        """Counter snapshot and the read hit rate."""
        with self._lock:
            d = dict(self.stats)
            d["size"] = int((self._slotkey >= 0).sum())
        d["hit_rate"] = (d["hits"] / d["lookups"]) if d["lookups"] else 0.0
        return d

    def __len__(self):
        with self._lock:
            return int((self._slotkey >= 0).sum())
