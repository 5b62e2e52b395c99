"""Parameter-server capability of the port (twin of ``hetu_tpu/ps``): the
host embedding store on the native C++ core, the native HET cache
(``CacheSparseTable``), the sharded store over TCP (``DistributedStore``,
``StoreServer``), and the vectorized HET cache (``DistCacheTable``) with
its device-resident slab on the card.  Shard replication and failover are
not ported (refused by name in ``dist_store``)."""
from .store import EmbeddingStore, default_store
from .cstable import CacheSparseTable
from .dist_store import DistCacheTable, DistributedStore, StoreServer
from .refcache import PerKeyCacheTable
from .ops import PSEmbeddingLookupOp, ps_embedding_lookup_op

__all__ = ["EmbeddingStore", "default_store", "CacheSparseTable",
           "DistCacheTable", "DistributedStore", "StoreServer",
           "PerKeyCacheTable", "PSEmbeddingLookupOp",
           "ps_embedding_lookup_op"]
