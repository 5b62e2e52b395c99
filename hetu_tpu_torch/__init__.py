"""hetu_tpu_torch — the PyTorch/CUDA port of ``hetu_tpu``.

The port keeps ``hetu_tpu``'s module layout, names and define-then-run
graph API (``placeholder_op``, ``Variable``, the ``*_op`` constructors,
the same ``op_type`` strings).  Ops lower to plain PyTorch; every TPU
kernel on a ported path is a hand-written kernel for the H100
(``csrc/``).  Ported paths:

* serving: GPT-2 greedy decode, ``gpt2_decode_graph`` → ``DecodeEngine``
  → ``DecodeRouter``, decode attention in the CUDA flash kernel; with
  ``DecodeEngine(chunked=gpt2_decode_chunked_graph(...)[:3])`` prompts are
  ingested in chunks through the full-mask flash forward;
* training: GPT-2 causal LM, ``gpt2_lm_graph`` →
  ``optim.AdamOptimizer(...).minimize(loss)`` → ``Executor.run``,
  attention in the causal flash kernels, forward and backward; the trained
  weights load into the decode engines by name
  (``params_from_named_arrays(ex.return_tensor_values())``);
* training: BERT pretraining (MLM, MLM+NSP), ``bert_pretrain_graph`` →
  ``optim.AdamOptimizer(...).minimize(loss)`` → ``Executor`` →
  ``Executor.run``, attention forward and backward in the CUDA flash
  kernels;
* CTR training through the HET embedding cache: Wide & Deep,
  ``wdl_criteo(..., embed_mode="vlru_dev")`` → ``ps_embedding_lookup_op``
  over ``DistCacheTable(device=True)`` → ``SGDOptimizer`` → ``Executor.run``,
  the slab row gather and the grad segment-sum in CUDA kernels;
* seq2seq training: T5, ``t5_seq2seq_graph(cfg, use_mask=True)`` →
  ``optim.AdamOptimizer(...).minimize(loss)`` → ``Executor.run``, the
  relative-position bias through the bias specializations of the CUDA
  flash kernels, forward and backward (dbias summed over its group);
* MoE training: GShard top-2 ``TopKGateSparse`` → ``SparseMoELayer``
  (with ``Expert``) → ``AdamOptimizer`` → ``Executor.run``, the sparse
  dispatch and combine, forward and backward, in the CUDA row-gather
  kernel (the dense ``TopKGate`` → ``MoELayer`` graph runs on plain
  products).

Typical use (the shape of the JAX package's)::

    import hetu_tpu_torch as ht
    feeds, loss, _ = ht.bert_pretrain_graph(ht.BertConfig.base())
    train_op = ht.optim.AdamOptimizer(1e-4).minimize(loss)
    ex = ht.Executor({"train": [loss, train_op]}, seed=0)
    ex.run("train", feed_dict={...})[0].asnumpy()

It imports neither ``jax`` nor ``hetu_tpu``.  Entry points run on CUDA
unless the caller passes ``device="cpu"``.
"""
from . import initializers, metrics, ops, optim, ps
from . import initializers as init
from .context import cpu, gpu, resolve_device
from .graph import (Executor, GradientOp, LowerCtx, Op, PlaceholderOp,
                    Variable, gradients, lower_forward, placeholder_op,
                    topo_sort)
from .layers import (DropOut, Embedding, Expert, LayerNorm, Linear,
                     MoELayer, MultiHeadAttention, RMSNorm, SparseMoELayer,
                     TopKGate, TopKGateSparse)
from .models import (BertConfig, GPT2Config, bert_model, bert_pooler,
                     bert_pretrain_graph, gpt2_decode_chunked_graph,
                     gpt2_decode_graph, gpt2_lm_graph, gpt2_model,
                     synthetic_criteo, synthetic_criteo_skewed,
                     synthetic_lm_batch, synthetic_mlm_batch,
                     synthetic_seq2seq_batch, T5Config, t5_seq2seq_graph,
                     wdl_criteo)
from .ndarray import NDArray
from .ops import (array_reshape_op, binarycrossentropy_op, broadcastto_op,
                  concat_op, einsum_op, embedding_lookup_op, matmul_op, mul_op,
                  ne_op, reduce_mean_op, reduce_sum_op, relu_op, rsqrt_op,
                  sdpa_bias_op, sdpa_masked_bias_op, sdpa_masked_op,
                  sdpa_op, sigmoid_op, slice_op, softmaxcrossentropy_op,
                  softmaxcrossentropy_sparse_op, tanh_op, transpose_op)
from .ps import (CacheSparseTable, DistCacheTable, EmbeddingStore,
                 PSEmbeddingLookupOp, default_store, ps_embedding_lookup_op)
from .serving import (DecodeEngine, DecodeRouter, DecodeStream,
                      InferenceExecutor, ServeRejected, default_buckets)
from .weights import params_from_named_arrays
