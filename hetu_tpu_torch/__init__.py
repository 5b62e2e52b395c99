"""hetu_tpu_torch — the PyTorch/CUDA port of ``hetu_tpu``.

The port keeps ``hetu_tpu``'s module layout, names and define-then-run
graph API (``placeholder_op``, ``Variable``, the ``*_op`` constructors,
the same ``op_type`` strings).  Ops lower to plain PyTorch; every TPU
kernel on a ported path is a hand-written kernel for the H100
(``csrc/``).  Ported paths:

* serving: GPT-2 greedy decode, ``gpt2_decode_graph`` → ``DecodeEngine``
  → ``DecodeRouter``, decode attention in the CUDA flash kernel;
* training: BERT pretraining (MLM, MLM+NSP), ``bert_pretrain_graph`` →
  ``optim.AdamOptimizer(...).minimize(loss)`` → ``Executor`` →
  ``Executor.run``, attention forward and backward in the CUDA flash
  kernels.

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
from .layers import DropOut, Embedding, LayerNorm, Linear, MultiHeadAttention
from .models import (BertConfig, GPT2Config, bert_model, bert_pooler,
                     bert_pretrain_graph, gpt2_decode_graph,
                     synthetic_criteo, synthetic_criteo_skewed,
                     synthetic_mlm_batch, wdl_criteo)
from .ndarray import NDArray
from .ops import (array_reshape_op, binarycrossentropy_op, broadcastto_op,
                  concat_op, embedding_lookup_op, matmul_op, ne_op,
                  reduce_mean_op, reduce_sum_op, relu_op, sdpa_masked_op,
                  sdpa_op, sigmoid_op, slice_op, softmaxcrossentropy_op,
                  softmaxcrossentropy_sparse_op, tanh_op, transpose_op)
from .ps import (CacheSparseTable, DistCacheTable, EmbeddingStore,
                 PSEmbeddingLookupOp, default_store, ps_embedding_lookup_op)
from .serving import (DecodeEngine, DecodeRouter, DecodeStream,
                      InferenceExecutor, ServeRejected, default_buckets)
from .weights import params_from_named_arrays
