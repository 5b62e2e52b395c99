"""PS-backed embedding lookup as a graph op (twin of ``hetu_tpu/ps/ops.py``).

The table lives in a host store (:mod:`hetu_tpu_torch.ps.store`); only
the batch's rows enter the step, as a LEAF whose gradient autograd
computes like a parameter's.  The executor pulls the rows (through the
HET cache when given a :class:`DistCacheTable`) before the step and
pushes the row gradient after it.  With a device-resident cache
(``DistCacheTable(device=True)``) the executor gathers the rows on the
card instead and sums the gradient there (see ``device_mode``).

Not ported, refused by name: ``CacheSparseTable`` (the native C++ cache).
"""
from __future__ import annotations

import numpy as np

from ..graph.node import PlaceholderOp
from .dist_store import DistCacheTable
from .store import default_store


class CacheSparseTable:
    """Not ported: the native C++ HET cache."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "CacheSparseTable (the native C++ HET cache) is not ported: use "
            "hetu_tpu_torch.ps.DistCacheTable")


class PSEmbeddingLookupOp(PlaceholderOp):
    """Leaf node whose per-step value is the batch's pulled embedding rows."""

    op_type = "PSEmbeddingLookup"
    is_ps = True

    def __init__(self, table, ids_node, width=None, name=None):
        super().__init__(name=name or "ps_embedding", shape=None)
        self.inputs = []           # leaf: ids resolved on the host per step
        self.ids_node = ids_node
        self._last_ids = None
        if type(table).__name__ == "CacheSparseTable":
            raise NotImplementedError(
                "ps_embedding_lookup_op over a CacheSparseTable (the native "
                "C++ HET cache) is not ported: use DistCacheTable")
        if isinstance(table, DistCacheTable):
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
        the gradient there; ``pull`` / ``push`` below are the host-mode
        protocol."""
        return isinstance(self.cache, DistCacheTable) and self.cache.device

    def pull(self, ids):
        """The rows of ``ids`` (remembered for :meth:`push`)."""
        ids = np.asarray(ids, np.int64)
        self._last_ids = ids
        if self.cache is not None:
            return self.cache.lookup(ids)
        return self.store.pull(self.table, ids)

    def push(self, grads):
        """Push the row gradient of the last pulled ids."""
        if self._last_ids is None:
            return
        if self.cache is not None:
            self.cache.update(self._last_ids, grads)
        else:
            self.store.push(self.table, self._last_ids, grads)


def ps_embedding_lookup_op(table, ids_node, width=None, name=None):
    """``ht.ps_embedding_lookup_op(table, ids)``: embedding rows for the ids
    batch from a host store, directly or through a :class:`DistCacheTable`
    (given as the cache, a ``(store, table)`` tuple or a bare table id on
    the default store)."""
    return PSEmbeddingLookupOp(table, ids_node, width=width, name=name)
