"""Embedding lookup (twin of ``hetu_tpu/ops/embedding.py``): row gather
from a dense table.  Unlike ``jnp.take``, an out-of-range id raises."""
import torch

from .base import def_op

embedding_lookup_op = def_op(
    "EmbeddingLookup",
    lambda c, table, idx: torch.nn.functional.embedding(idx.long(), table))
