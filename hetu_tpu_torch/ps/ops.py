"""PS-backed embedding lookup as a graph op (twin of ``hetu_tpu/ps/ops.py``).

The table lives in a host store (:mod:`hetu_tpu_torch.ps.store`, or a
sharded :class:`~hetu_tpu_torch.ps.dist_store.DistributedStore`); only
the batch's rows enter the step, as a LEAF whose gradient autograd
computes like a parameter's.  The executor pulls the rows (through the
HET cache when given a :class:`DistCacheTable` or a native
:class:`CacheSparseTable`) before the step and pushes the row gradient
after it, at once (BSP, SSP) or on a background worker (ASP).  With a
device-resident cache (``DistCacheTable(device=True)``) the executor
gathers the rows on the card instead and sums the gradient there (see
``device_mode``).
"""
from __future__ import annotations

import numpy as np

from ..graph.node import PlaceholderOp
from .cstable import CacheSparseTable
from .dist_store import DistCacheTable
from .store import default_store


class PSEmbeddingLookupOp(PlaceholderOp):
    """Leaf node whose per-step value is the batch's pulled embedding rows."""

    op_type = "PSEmbeddingLookup"
    is_ps = True

    def __init__(self, table, ids_node, width=None, name=None):
        super().__init__(name=name or "ps_embedding", shape=None)
        self.inputs = []           # leaf: ids resolved on the host per step
        self.ids_node = ids_node
        self._last_ids = None
        if isinstance(table, (CacheSparseTable, DistCacheTable)):
            self.cache = table
            self.store, self.table = table.store, table.table
            self.width = table.width
        elif isinstance(table, tuple):
            self.cache = None
            self.store, self.table = table
            self.width = width
        else:  # bare table id on the default store
            self.cache = None
            self.store, self.table = default_store(), int(table)
            self.width = width

    @property
    def device_mode(self):
        """True when the backing cache keeps a device-resident slab: the
        executor then gathers the rows on the card by slot index and sums
        the gradient there; the methods below are the host-mode
        protocol."""
        return isinstance(self.cache, DistCacheTable) and self.cache.device

    def pull_rows(self, ids):
        """The rows of ``ids`` without touching ``_last_ids`` (which the
        step in flight pushes to): safe on the prefetch thread."""
        ids = np.asarray(ids, np.int64)
        if isinstance(self.cache, DistCacheTable):
            return self.cache.lookup(ids)
        if self.cache is not None:
            dest = np.empty(ids.shape + (self.cache.width,), np.float32)
            return self.cache._lookup_sync(ids, dest)
        return self.store.pull(self.table, ids)

    def pull(self, ids):
        """The rows of ``ids`` (remembered for :meth:`push`)."""
        ids = np.asarray(ids, np.int64)
        self._last_ids = ids
        return self.pull_rows(ids)

    def push_to(self, ids, grads):
        """Push the row gradient onto explicit ``ids``: what a deferred
        (ASP) push uses, since the next step may have replaced
        ``_last_ids`` by the time it runs."""
        if ids is None:
            return
        if isinstance(self.cache, DistCacheTable):
            self.cache.update(ids, grads)
        elif self.cache is not None:
            self.cache._update_sync(ids, grads)
        else:
            self.store.push(self.table, ids, grads)

    def push(self, grads):
        """Push the row gradient of the last pulled ids."""
        self.push_to(self._last_ids, grads)


def ps_embedding_lookup_op(table, ids_node, width=None, name=None):
    """``ht.ps_embedding_lookup_op(table, ids)``: embedding rows for the ids
    batch from a host store, directly or through a cache (a
    :class:`DistCacheTable` or :class:`CacheSparseTable`), given as the
    cache, a ``(store, table)`` tuple or a bare table id on the default
    store."""
    return PSEmbeddingLookupOp(table, ids_node, width=width, name=name)
