"""CacheSparseTable — HET bounded-staleness embedding cache client (twin
of ``hetu_tpu/ps/cstable.py``, over the same native core).

API parity with the reference's ``python/hetu/cstable.py:19`` (which wraps
the pybind11 ``hetu_cache`` module, ``src/hetu_cache/include/cache.h:21``):
``embedding_lookup`` / ``embedding_update`` / ``embedding_push_pull`` return
futures (the reference's ``wait_t``); eviction policy ∈ {LRU, LFU, LFUOPT};
``pull_bound``/``push_bound`` bound read/write staleness in versions
(HET, VLDB'22).  Over a store with no native handle (the numpy table,
or a :class:`~hetu_tpu_torch.ps.dist_store.DistributedStore`) the cache
passes lookups and updates straight through to the store's pull and push.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .build import get_lib
from .store import default_store

_POLICY = {"LRU": 0, "LFU": 1, "LFUOPT": 2}


class CacheSparseTable:
    def __init__(self, limit, length, width, node_id=0, policy="LRU",
                 bound=100, pull_bound=None, push_bound=None, store=None,
                 table=None, opt="sgd", lr=0.01, seed=0):
        """``limit``: max cached rows; ``length``×``width``: table shape;
        ``bound``: default staleness bound (pull & push), overridable
        separately (reference setPullBound/setPushBound)."""
        self.store = store or default_store()
        if table is None:
            table = self.store.init_table(length, width, opt=opt, lr=lr,
                                          seed=seed)
        self.table = table
        self.length, self.width = length, width
        self.node_id = node_id
        policy = policy.upper()
        if policy not in _POLICY:
            raise ValueError(f"unknown cache policy {policy!r}")
        self.policy = policy
        pull_bound = bound if pull_bound is None else pull_bound
        push_bound = bound if push_bound is None else push_bound
        self._lib = get_lib()
        self._h = None
        if self._lib and getattr(self.store, "_h", None):
            self._h = self._lib.hetu_cache_create(
                self.store._h, table, limit, _POLICY[policy],
                pull_bound, push_bound)
        self._pool = ThreadPoolExecutor(max_workers=1)  # ordered async ops

    def _ensure_pool(self):
        """The async pool, revived if a previous ``close()`` shut it down.

        ``Executor.__del__`` closes the caches its graphs reference, but a
        cache can outlive that executor (shared across graphs, or the
        executor was rebound mid-experiment) — the next async op then
        re-spawns the worker instead of dying on a closed pool; an unused
        closed cache still leaks nothing."""
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=1)
        return self._pool

    # -- bounds ------------------------------------------------------------
    def set_pull_bound(self, bound):
        if self._h:
            self._lib.hetu_cache_set_bounds(self._h, bound, -1)

    def set_push_bound(self, bound):
        if self._h:
            self._lib.hetu_cache_set_bounds(self._h, -1, bound)

    def bypass(self, on=True):
        if self._h:
            self._lib.hetu_cache_bypass(self._h, int(on))

    # -- core (sync) -------------------------------------------------------
    def _check_keys(self, keys):
        if keys.size and (keys.min() < 0 or keys.max() >= self.length):
            raise IndexError(
                f"embedding key out of range: [{keys.min()}, {keys.max()}] "
                f"vs table length {self.length}")

    def _lookup_sync(self, keys, dest):
        keys = np.ascontiguousarray(keys, np.int64).reshape(-1)
        self._check_keys(keys)
        if self._h:
            import ctypes
            self._lib.hetu_cache_lookup(
                self._h,
                keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                keys.size,
                dest.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        else:
            dest.reshape(keys.size, self.width)[:] = \
                self.store.pull(self.table, keys)
        return dest

    def _update_sync(self, keys, grads):
        keys = np.ascontiguousarray(keys, np.int64).reshape(-1)
        self._check_keys(keys)
        grads = np.ascontiguousarray(grads, np.float32)
        if self._h:
            import ctypes
            self._lib.hetu_cache_update(
                self._h,
                keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                keys.size,
                grads.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        else:
            self.store.push(self.table, keys, grads)

    # -- reference async API ----------------------------------------------
    def embedding_lookup(self, keys, dest=None):
        """Async lookup; returns a future resolving to ``dest``
        (keys.shape + (width,))."""
        keys = np.asarray(keys)
        if dest is None:
            dest = np.empty(keys.shape + (self.width,), np.float32)
        return self._ensure_pool().submit(self._lookup_sync, keys, dest)

    def embedding_update(self, keys, grads):
        return self._ensure_pool().submit(self._update_sync, keys, grads)

    def embedding_push_pull(self, push_keys, grads, pull_keys, dest=None):
        if dest is None:
            dest = np.empty(np.asarray(pull_keys).shape + (self.width,),
                            np.float32)

        def run():
            self._update_sync(push_keys, grads)
            return self._lookup_sync(np.asarray(pull_keys), dest)
        return self._ensure_pool().submit(run)

    # -- maintenance -------------------------------------------------------
    def flush(self):
        """Push every dirty cached row to the store (checkpoint barrier)."""
        pool = self._pool    # snapshot: close() may null it from a GC
        if pool is not None:  # thread between the check and the submit
            try:
                pool.submit(lambda: None).result()  # drain queue
            except RuntimeError:
                pass    # close() shut the snapshot down concurrently —
                        # a drained-then-destroyed pool has nothing queued
        if self._h:
            self._lib.hetu_cache_flush(self._h)

    def close(self):
        """Flush, then shut the per-table async pool down.  Idempotent.

        Without this every CacheSparseTable leaked its
        ``ThreadPoolExecutor`` (worker thread + queue) for the process
        lifetime; ``Executor.__del__``'s teardown calls it for every
        cache its graphs own, and ``__del__`` covers direct users.

        Teardown traps this must survive (both observed as interpreter
        hangs): (1) when ``__del__`` fires inside a GC pass, the pool
        OBJECT may already be collected — its weakref callback woke the
        worker, which exited — so a drain via ``submit().result()`` would
        queue a task no thread will ever run and block forever;
        ``shutdown(wait=True)`` drains pending work when the worker is
        alive and joins instantly when it's dead.  (2) GC can run ON the
        pool's own worker thread, where any blocking join deadlocks —
        detected and degraded to ``wait=False``."""
        import sys
        import threading
        pool = self._pool
        if pool is None:
            return
        self._pool = None
        if sys.is_finalizing():
            return      # runtime teardown: joining/flushing segfaults
        on_own_worker = threading.current_thread() in \
            getattr(pool, "_threads", ())
        try:
            pool.shutdown(wait=not on_own_worker)
        except Exception:
            pass        # interpreter already past futures teardown
        try:
            if self._h:
                self._lib.hetu_cache_flush(self._h)
        except Exception:
            pass        # native lib may already be unloaded at teardown

    def perf(self):
        if not self._h:
            return {}
        import ctypes
        out = np.zeros(8, np.int64)
        self._lib.hetu_cache_perf(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        keys = ["lookups", "hits", "evictions", "pushes", "fetches", "size",
                "write_lookups", "write_hits"]
        d = dict(zip(keys, out.tolist()))
        # read hit rate — the HET cache's citable number (reference cache.h
        # perf_ semantics: reads and writes count separately)
        d["hit_rate"] = (d["hits"] / d["lookups"]) if d["lookups"] else 0.0
        return d

    def __len__(self):
        return int(self._lib.hetu_cache_size(self._h)) if self._h else 0

    def __del__(self):
        try:
            self.close()
            if getattr(self, "_h", None):
                self._lib.hetu_cache_destroy(self._h)
                self._h = None
        except Exception:
            pass
