"""Embedding lookup (twin of ``hetu_tpu/ops/embedding.py``): row gather
from a dense table.  Unlike ``jnp.take``, an out-of-range integer id
raises.

A floating index (the models' position ids, a float32 Variable, which
``compute_dtype="bfloat16"`` casts to bf16 as the JAX package does)
truncates toward zero, as ``astype(int32)`` does.  bf16 is exact only up
to 256, so positions above it are rounded first and share rows, in both
packages (ROADMAP C11).  A position that rounds past the table (BERT's
511 -> 512, GPT-2's 1022 and 1023 -> 1024) reads NaN in the JAX package
(``jnp.take`` fills out-of-range rows), which makes its bf16 loss NaN at
those lengths; the port reads the table's last row there instead.  A
float32 or integer index past the table still raises."""
import torch

from .base import def_op


def _embedding_lookup(c, table, idx):
    rounded = idx.dtype == torch.bfloat16
    idx = idx.long()
    if rounded:
        idx = idx.clamp(max=table.shape[0] - 1)
    return torch.nn.functional.embedding(idx, table)


embedding_lookup_op = def_op("EmbeddingLookup", _embedding_lookup)
