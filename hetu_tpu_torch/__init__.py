"""hetu_tpu_torch — the PyTorch/CUDA port of ``hetu_tpu``.

The port keeps ``hetu_tpu``'s module layout, names and define-then-run
graph API (``placeholder_op``, ``Variable``, the ``*_op`` constructors,
the same ``op_type`` strings).  Ops lower to plain PyTorch; every TPU
kernel on a ported path is a hand-written kernel for the H100
(``csrc/``).  Ported paths:

* serving: GPT-2 greedy decode, ``gpt2_decode_graph`` → ``DecodeEngine``
  → ``DecodeRouter``, decode attention in the CUDA flash kernel; with
  ``DecodeEngine(chunked=gpt2_decode_chunked_graph(...)[:3])`` prompts are
  ingested in chunks through the full-mask flash forward, and with
  ``prefix_store=PrefixKVStore()`` a shared prompt prefix seats from a
  snapshot; ``FrontDoor(lambda i: DecodeRouter(...), 2)`` serves over
  replicas and carries a dead replica's streams to a survivor; a
  request-level graph (BERT classification) through ``InferenceExecutor``
  → ``ServingRouter``, attention in the key-mask flash kernel;
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
* permutation-LM pretraining: XLNet, ``xlnet_plm_graph`` →
  ``optim.AdamOptimizer(...).minimize(loss)`` → ``Executor.run``, both
  streams through the full-mask-with-bias specialization of the CUDA
  flash kernels (the permutation mask group ``b``, the relative-position
  bias group ``h``), forward and backward;
* long-document MLM pretraining: Longformer, ``longformer_mlm_graph`` →
  ``optim.AdamOptimizer(...).minimize(loss)`` → ``Executor.run``, the
  sliding-window + global mask through the full-mask specialization of
  the CUDA flash kernels, forward and backward;
* training of the other transformer families, each through
  ``optim.AdamOptimizer(...).minimize(loss)`` → ``Executor.run``: ViT and
  Swin image classification (``vit_classify_graph``,
  ``swin_classify_graph``: Swin's windows through the bias and the
  mask-with-bias flash kernels), MAE (``mae_pretrain_graph``) and CLIP
  (``clip_graph``) pretraining, the base Transformer
  (``transformer_graph``) and BART (``bart_seq2seq_graph``), BigBird MLM
  (``bigbird_mlm_graph``, the full-mask kernels), Transformer-XL
  (``transfoxl_lm_graph``: memory carried across ``run`` calls, the
  causal-bias kernels at head dim 41, zero-padded to the kernels'
  multiple) and Reformer (``reformer_lm_graph``: LSH attention in plain
  PyTorch, as the JAX package writes it in plain ``jnp``);
* MoE training: GShard top-2 ``TopKGateSparse`` → ``SparseMoELayer``
  (with ``Expert``) → ``AdamOptimizer`` → ``Executor.run``, the sparse
  dispatch and combine, forward and backward, in the CUDA row-gather
  kernel (the dense ``TopKGate`` → ``MoELayer`` graph runs on plain
  products); every gate family of ``tools/train_moe.py`` (``--gate``
  base, top1, top2, hash, ktop1, sam: ``KTop1Gate``, ``SAMGate`` and
  ``HashGate`` through ``MoELayer``, ``BalanceAssignmentGate`` through
  ``BalancedMoELayer``); under ``DataParallel`` the capacity gates route
  over the global batch, and ``SparseMoELayer`` dispatches each rank's
  rows through the row-gather kernel;
* CNN training: the model zoo of ``models/cnn.py`` (``resnet18`` /
  ``resnet34`` in NCHW or NHWC, ``vgg16`` / ``vgg19``, ``alexnet``,
  ``lenet``, ``cnn_3_layers``, ``mlp``, ``logreg``) over
  ``conv2d_op``, ``batch_normalization_op`` and the pools (cuDNN through
  ``torch.nn.functional``; the JAX package has no Pallas kernel there) →
  ``optim.MomentumOptimizer(0.1).minimize(loss)`` → ``Executor.run``, fed
  by placeholders or by ``dataloader_op([Dataloader(x, 128, "train")])``
  over ``data.cifar10()`` (``run("train")`` with no feed dict);
* data-parallel training of those graphs (BERT, ResNet-18, any graph of
  the ops ``parallel/batch_axis.py`` names): ``torch.distributed`` set up
  by the caller (gloo on the CPU, NCCL on the card), then
  ``Executor(..., dist_strategy=ht.dist.DataParallel())`` on every rank,
  fed the global batch; each rank runs its rows, every reduction over the
  batch (the loss, BatchNorm's statistics) is global, and the gradients
  are averaged over the group; GPT-2, T5, XLNet and Longformer too, in
  float32 or bf16, and with ``Executor(zero=1|2|3)`` each rank keeps and
  updates only its slice of the optimizer state (and, at stage 3, of the
  parameters).

Typical use (the shape of the JAX package's)::

    import hetu_tpu_torch as ht
    feeds, loss, _ = ht.bert_pretrain_graph(ht.BertConfig.base())
    train_op = ht.optim.AdamOptimizer(1e-4).minimize(loss)
    ex = ht.Executor({"train": [loss, train_op]}, seed=0)
    ex.run("train", feed_dict={...})[0].asnumpy()

It imports neither ``jax`` nor ``hetu_tpu``.  Entry points run on CUDA
unless the caller passes ``device="cpu"``.
"""
from . import analysis, data, initializers, metrics, ops, optim, parallel, ps
from .analysis import GraphValidationError, lint
from . import initializers as init
from . import parallel as dist  # reference alias: ht.dist.DataParallel
from .context import cpu, gpu, make_mesh, resolve_device
from .graph import (Executor, GradientOp, LowerCtx, Op, PlaceholderOp,
                    Variable, gradients, lower_forward, placeholder_op,
                    topo_sort)
from .layers import (BalanceAssignmentGate, BalancedMoELayer, DropOut,
                     Embedding, Expert, HashGate, KTop1Gate, LayerNorm,
                     Linear, MoELayer, MultiHeadAttention, RMSNorm, SAMGate,
                     SparseMoELayer, TopKGate, TopKGateSparse)
from .models import (BertConfig, GPT2Config, LongformerConfig, XLNetConfig,
                     bert_classify_graph, bert_model, bert_pooler, bert_pretrain_graph,
                     gpt2_decode_chunked_graph, gpt2_decode_graph,
                     gpt2_lm_graph, gpt2_model, longformer_attention_mask,
                     longformer_mlm_graph, perm_masks_from_order,
                     synthetic_criteo, synthetic_criteo_skewed,
                     synthetic_lm_batch, synthetic_mlm_batch,
                     synthetic_mlm_ids, synthetic_plm_batch,
                     synthetic_seq2seq_batch, T5Config, t5_seq2seq_graph,
                     wdl_criteo, deepfm_criteo, dcn_criteo,
                     validate_cache_parity, xlnet_plm_graph,
                     BartConfig, BigBirdConfig, CLIPConfig, MAEConfig,
                     ReformerConfig, SwinConfig, TransfoXLConfig,
                     TransformerConfig, ViTConfig, bart_seq2seq_graph,
                     bigbird_attention_mask, bigbird_mlm_graph, clip_graph,
                     lsh_attention, mae_pretrain_graph, reformer_lm_graph,
                     swin_classify_graph, synthetic_copy_batch,
                     synthetic_image_batch, synthetic_mae_batch,
                     transfoxl_lm_graph, transformer_graph,
                     vit_classify_graph)
from .data import Dataloader, DataloaderOp, dataloader_op
from .ndarray import NDArray
from .ops import (alltoall_op, balance_assignment_op, halltoall_op,
                  hash_dispatch_op, ktop1_gate_op, layout_transform_op,
                  reverse_layout_transform_op, sam_gate_op,
                  sparse_combine_op, sparse_dispatch_op, topk_gate_op,
                  topk_gate_sparse_op)
from .ops import (BatchNormOp, array_reshape_op, avg_pool2d_op,
                  batch_normalization_op, binarycrossentropy_op,
                  broadcast_shape_op, broadcastto_op, concat_op,
                  concatenate_op, exp_op, indexing_op, repeat_op, roll_op,
                  scatter1d_grad_op, sqrt_op, conv2d_add_bias_op, conv2d_op,
                  dropout2d_op, dropout_op, einsum_op, embedding_lookup_op,
                  gelu_op, instance_normalization2d_op,
                  layer_normalization_op, leaky_relu_op, linear_op,
                  log_softmax_op, matmul_op, max_pool2d_op, mul_op, ne_op,
                  reduce_mean_op, reduce_sum_op, relu_op, rsqrt_op,
                  sdpa_bias_op, sdpa_masked_bias_op, sdpa_masked_op,
                  sdpa_op, sdpa_varlen_op, sigmoid_op, slice_op,
                  softmax_func, softmax_op, softmaxcrossentropy_op,
                  softmaxcrossentropy_sparse_op, tanh_op, transpose_op)
from .ps import (CacheSparseTable, DistCacheTable, EmbeddingStore,
                 PSEmbeddingLookupOp, default_store, ps_embedding_lookup_op)
from .serving import (CLASSES, CellHead, CellMap, DecodeEngine,
                      DecodeRouter, DecodeStream, FrontDoor,
                      InferenceExecutor, PrefixKVStore,
                      ServeRejected, ServingRouter, SLOAutoscaler,
                      default_buckets)
from .weights import params_from_named_arrays
