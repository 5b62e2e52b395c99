"""Symbolic ops of the port (the ported subset of ``hetu_tpu.ops``)."""
from .base import OP_REGISTRY, ItemOp, SimpleOp, def_op, tuple_outputs
from .arithmetic import (add_op, minus_op, mul_op, div_op, addbyconst_op,
                         minusbyconst_op, mulbyconst_op, div_const_op,
                         const_div_op, opposite_op, pow_op, ne_op, tanh_op,
                         sigmoid_op, rsqrt_op)
from .matmul import matmul_op, linear_op, einsum_op
from .nn import relu_op, gelu_op, dropout_op, layer_normalization_op
from .transform import (array_reshape_op, transpose_op, slice_op, concat_op,
                        broadcastto_op)
from .reduce import reduce_sum_op, reduce_mean_op
from .losses import (softmaxcrossentropy_op, softmaxcrossentropy_sparse_op,
                     binarycrossentropy_op)
from .embedding import embedding_lookup_op
from .attention import (sdpa_reference, dispatch_sdpa, sdpa_op,
                        dispatch_sdpa_masked, sdpa_masked_op,
                        dispatch_sdpa_bias, sdpa_bias_op,
                        dispatch_sdpa_masked_bias, sdpa_masked_bias_op,
                        dispatch_sdpa_decode, sdpa_decode_op,
                        kv_cache_append_op, dispatch_sdpa_prefill,
                        sdpa_prefill_op, chunk_positions_op,
                        split_heads_chunk_op, merge_heads_chunk_op,
                        chunk_emit_gather_op)
from .moe import (topk_gate_op, layout_transform_op,
                  reverse_layout_transform_op, topk_gate_sparse_op,
                  sparse_dispatch_op, sparse_combine_op)
