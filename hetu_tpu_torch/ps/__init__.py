"""Parameter-server capability of the port: the host embedding store and
the HET bounded-staleness cache, with its device-resident slab on the
card (twin of ``hetu_tpu/ps``; not ported, refused by name:
``CacheSparseTable``, ``DistributedStore``, ``StoreServer``)."""
from .store import EmbeddingStore, default_store
from .dist_store import DistCacheTable, DistributedStore, StoreServer
from .ops import CacheSparseTable, PSEmbeddingLookupOp, ps_embedding_lookup_op

__all__ = ["EmbeddingStore", "default_store", "CacheSparseTable",
           "DistCacheTable", "DistributedStore", "StoreServer",
           "PSEmbeddingLookupOp", "ps_embedding_lookup_op"]
