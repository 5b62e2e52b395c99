#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``hetu_tpu_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero
without printing the final result line:

1. Build every CUDA source of ``hetu_tpu_torch/csrc`` with nvcc (one
   process per source, all started together) and load the kernels.
2. Hold the decode kernel (``lengths``: the split-KV kernel and, when
   its plan has more than one split, the merge) against its plain PyTorch
   version on the card at the decode path's shapes (B=8, H=12, D=64;
   cache lengths 1, 7, 128, 384, 1024; S_q = 1, plus one S_q = 4 case
   with an empty row); at the longest cache under every split plan of
   ``DECODE_PLANS`` (lengths 0, 1, a partial tile, full, tile edges)
   against the plain version and the plain split version: a row of length
   0 exactly 0 with lse -1e30, NaN in every K and V row past a length
   changes no bit, the same bits from run to run, one kernel launch a call
   and one merge a call of more than one split.  Time the kernel (split
   and merge), the plain version, one PyTorch library call and the bound;
   after phase 3, also at the (batch bucket, cache bucket, lengths) shapes
   that phase 3's run gave it.
3. Serve GPT-2 small (published widths, seeded random weights, fp32):
   8 seeded prompts of 8-300 tokens through ``DecodeRouter`` →
   ``DecodeEngine`` with 32 new tokens each.  Every launch counter is set
   to 0 just before and read just after; each kernel of the path must
   have launched (flash: decode steps × n_layer launches; its merge once
   for each of those calls whose split plan has more than one split,
   recorded by ``DecodeCalls``) and no attention dispatch may have left
   the kernel.
4. Teacher-force one prompt through the port on the card and on the CPU
   (plain versions) with the same weights; per-step logits must agree.
5. Hold the training kernels (flash forward dense / key-mask, dQ, dK/dV)
   against their plain versions at BERT-base attention shapes (B=4,
   H=12, S=512, D=64: a key mask from ``synthetic_mlm_batch``'s lengths
   plus one row with every key masked; dense; a ragged S=200; key masks
   whose tail tiles are dead), and time each kernel, its plain version,
   the SDPA yardstick and the bound.
   Phases 5, 14 and 18 share one check (``attn_case``): out and lse
   within ``KERNEL_ATOL``, every gradient finite and within ``GRAD_RTOL``
   / ``GRAD_ATOL``, every row that sees no key out = dQ = 0 with lse =
   -1e30; it also prints the tiles the float32 forward, dQ and dK/dV walk
   (they skip those with no visible pair) against all of them.
6. Train BERT-base (published widths: 12 layers, hidden 768, 12 heads,
   intermediate 3072, vocab 30522; seq 512, batch 16, dropout 0.1) with
   ``AdamOptimizer(1e-4)`` through ``Executor.run``: 2 warm-up steps, then
   10 counted steps with every launch counter set to 0 just before and
   read just after (each training kernel: steps × 12 launches; no
   attention dispatch may leave the kernels).
7. Train the same widths cut to 2 layers (seq 128, batch 4, dropout 0) on
   the card and on the CPU from the same weights for 3 Adam steps; the
   losses and the step-1 gradients of every variable must agree.
8. Hold the embedding-cache kernels against their plain versions at the
   CTR path's shapes: the slots and unique-inverse map of a real
   ``begin_lookup`` over Zipf batches of the WDL configuration below
   (53,248 ids, width 16, a 63,249-row slab), plus n = 0, n off the block
   size, one run, every key distinct, widths 13 and 128, and runs longer
   than the segment-sum's shared-memory chunk (one run of 3,000 x 128;
   53,248 Zipf ids over 4,000).  The gather must match exactly; the
   segment-sum within rtol 2e-5 / atol 1e-6 of its plain version
   (``index_add_``, atomics), exactly the host cache's ``_segment_sum``
   and itself from run to run.  Time each kernel, its plain version, the library
   call and the bound.
9. Train Wide & Deep at the repository's WDL configuration (Criteo layout,
   13 dense and 26 sparse fields, batch 2048, vocab 100,000, dim 16, MLP
   429-256-256-1 plus wide 13-1, ``SGDOptimizer(0.01)``; store SGD lr
   0.01, init scale 0.01; cache limit 10,000, pull/push bound 10, LRU,
   device scratch 53,248; ``synthetic_criteo_skewed(8*2048, seed=0)``
   cycled) through the device-resident HET cache and ``Executor.run``: 3
   warm-up steps, then 20 counted steps with every launch counter set to
   0 just before and read just after (gather and segment-sum: one launch
   a step each; no ``backend:`` fallback).
10. The same configuration trained 8 steps through the device cache and 8
    through the host cache on the card, from the same table and weights:
    losses, the store table, versions and every cache counter equal bit
    for bit.  Then 3 steps on the card against 3 on the CPU: losses within
    rtol 1e-4, the store table within ``allclose(rtol=1e-5, atol=1e-6)``.
11. Hold the MoE row-gather kernel (B6) against its plain version at the
    MoE path's shapes: the maps of a real ``TopKGateSparse`` at the MoE
    configuration below over 8,192 random tokens (the dispatch, 20,480
    slots from 8,192 rows; the combine and its backward, 8,192 rows from
    20,480), plus n = 0, n = 1, every index -1, widths 13 and 2048: equal
    exactly.  ``SparseDispatch`` / ``SparseCombine`` forward and backward
    on those maps, kernel against plain gather: bit for bit.  Time the
    kernel, its plain version, the library call and the bound.
12. Train the repository's MoE configuration (BASELINE config 5,
    ``bench.py``'s ``build_moe_graph``: 8,192 tokens, d 512,
    ``TopKGateSparse(512, 8192, 16, k=2, capacity_factor=1.25)``,
    ``Expert(16, 512, 2048)``, ``AdamOptimizer(1e-3)``) through
    ``SparseMoELayer`` and ``Executor.run``: 3 warm-up steps, then 20
    counted steps with every launch counter set to 0 just before and read
    just after (the row gather: 6 launches a step; no ``backend:``
    fallback), and 5 profiled steps for the device's idle share.  Then the
    dense ``MoELayer`` graph of the same configuration the same way, as a
    yardstick (it launches no row gather).
13. The sparse and the dense graph from one set of weights, 3 Adam steps
    on the card: routing maps equal, losses within rtol 1e-5, step-1
    gradients within ``allclose(rtol=1e-4, atol=1e-6)``.  Then the sparse
    graph at 1,024 tokens (full widths) on the card against the CPU, 3
    Adam steps: routing maps equal (a differing route stops the phase with
    the tokens' gate gaps), losses within rtol 1e-4, step-1 gradients
    within ``allclose(rtol=1e-3, atol=1e-5)``.
14. Hold the causal kernels (forward, dQ, dK/dV) and the full-mask forward
    against their plain versions at GPT-2 small attention shapes (B=8,
    H=12, S=1024, D=64): causal; causal with a key mask (one batch row
    fully masked); the unequal and ragged (S_q, S_kv) pairs (200, 200),
    (64, 200), (200, 64), (1, 130), and (300, 700) with dead key-mask
    tails; the full mask at the chunked-prefill
    shape (C=32 queries against a 512-row cache, the mask of real
    ``positions``, group ``b``) and one case per other group mode, each
    with a fully masked row.  Time each kernel, its plain version, the
    SDPA yardstick (``is_causal=True``; ``attn_mask=``) and the bound (a
    causal kernel's operations count the visible (row, key) pairs only).
15. Train GPT-2 small (published widths: 12 layers, 768 wide, 12 heads,
    vocab 50257; seq 1024, batch 8, dropout 0.1, ``synthetic_lm_batch``)
    with ``AdamOptimizer(1e-4)`` through ``Executor.run``: 2 warm-up steps,
    then 10 counted steps with every launch counter set to 0 just before
    and read just after (the causal forward, dQ and dK/dV: steps x 12
    launches each; no ``backend:`` fallback; the loss falls).
16. Train the same widths cut to 2 layers (seq 128, batch 4, dropout 0) on
    the card and on the CPU from the same weights for 3 Adam steps; the
    losses and the step-1 gradients of every variable must agree.
17. Serve the weights trained in phase 15, carried by name
    (``params_from_named_arrays(ex.return_tensor_values())``), through a
    chunked-prefill ``DecodeEngine`` (``max_chunk`` 32) and through a
    one-token engine, each behind ``DecodeRouter``: the 8 prompts of phase
    3, 32 new tokens each.  Counters set to 0 just before the chunked run
    and read just after: full-mask launches = prefill steps x 12,
    ``lengths`` launches = (decode steps - prefill steps) x 12, both
    nonzero, the merge launched once for each ``lengths`` call of more
    than one split (in the one-token run too), no ``backend:`` fallback,
    prefill steps saved > 0.  Logits of
    one 300-token prompt at every chunk end and the KV caches, chunked
    against token by token on the card and chunked on the card against
    chunked on the CPU, within ``LOGITS_ATOL``.  The greedy streams of the
    two engines must be equal; one may differ only from a step at which
    the one-token path's top-2 logit gap is below 2 x ``LOGITS_ATOL``.
18. Hold the additive-bias kernels (forward, dQ with dbias, dK/dV with
    dkbias) against their plain versions at T5-small attention shapes (B=32,
    H=8, D=64, scale 0.37): the encoder's (S=512, the relative-position bias
    of group ``h``, the key mask of ``synthetic_seq2seq_batch(padded=True)``
    with one batch row fully masked), the decoder's (S=114, causal, group
    ``h``), rows that see no key ((200, 64) causal, group ``bh``), one row
    (group ``b``), and the key-bias strip ((B, 1, 1, S) causal at S=512;
    (114, 200) with a key mask); a dense bias with dead key-mask tiles
    ((150, 450), group ``h``); dbias must be exactly 0 on every pair no
    row sees (above the diagonal: key tiles the causal dQ kernel skips).
    Also the key-mask kernels at the cross-attention's shape (S_q=114,
    S_kv=512, the same key mask with its fully masked row).  Time the
    encoder's, decoder's and cross-attention's kernels and the strip,
    their plain versions, SDPA (with a bias as a float ``attn_mask``, its
    backward with the mask's gradient where torch gives one) and the
    bound.
19. Train T5-small (published widths: 6 + 6 layers, d_model 512, d_ff
    2048, 8 heads, vocab 32,128, 32 relative-position buckets; source 512,
    target 114, batch 32, dropout 0.1, ``use_mask=True`` with
    ``synthetic_seq2seq_batch(padded=True)``) with ``AdamOptimizer(1e-4)``
    through ``Executor.run``: 2 warm-up steps, then 10 counted steps with
    every launch counter set to 0 just before and read just after (the
    bias forward / dQ / dK/dV, their causal twins and the key-mask kernels
    of the cross-attention: steps x 6 launches each; nothing else; no
    ``backend:`` fallback; the loss falls).
20. Train T5-small cut to 2 + 2 layers (batch 4, source 128 padded,
    target 50, dropout 0) on the card and on the CPU from the same weights
    for 3 Adam steps; the losses and the step-1 gradients of every
    variable, the relative-position tables included, must agree.
21. Hold the full-mask kernels (forward, dQ, dK/dV), alone and with a
    bias, against their plain versions at the paths' own shapes (D=64,
    scale 0.125): XLNet's content and query streams (B=8, H=12, S=512, the
    permutation masks of ``synthetic_plm_batch``, group ``b``, with a
    group-``h`` bias; the query stream's first token of each permutation
    sees no key), Longformer's window (B=2, H=12, S=4096,
    ``longformer_attention_mask(4096, 512, 1)``, group ``one``), the
    key-bias strip with XLNet's query mask, at small shapes one causal
    case of each instantiation (with a key mask, S_q > S_kv, ragged), and
    sparse masks with empty key tiles and a query tile that sees no key,
    alone and with a bias (ragged).  Longformer's forward must walk at
    most a quarter of its key tiles.
    Each is checked by ``attn_case`` (dbias exactly 0 on every masked
    pair, rows that see no key 0) and the four path cases are timed: the
    kernel, its plain version and SDPA (a boolean ``attn_mask``, or the
    bias with -1e30 on masked pairs as a float one) beside the bound on
    visible pairs.
22. Train XLNet-base (published widths: 12 layers, d_model 768, 12 heads,
    d_inner 3072, vocab 32,000, clamp 256; seq 512, batch 8, dropout 0.1,
    ``synthetic_plm_batch(seed=0)``) with ``AdamOptimizer(1e-4)`` through
    ``Executor.run``: 2 warm-up steps, then 10 counted steps with every
    launch counter set to 0 just before and read just after (the
    mask-with-bias forward, dQ and dK/dV: steps x 23 each, both streams of
    12 layers less the last layer's content stream, which the loss does not
    reach; nothing else; no ``backend:`` fallback; the loss does not rise).
23. Train Longformer-base (published widths: 12 layers, 768 wide, 12
    heads, window 512, one global token, 4098 positions, vocab 30,522;
    seq 4096, batch 2, dropout 0.1, ``synthetic_mlm_ids(seed=0)``) the same
    way (the full-mask forward, dQ and dK/dV: steps x 12 each).
24. Tiny XLNet and tiny Longformer (dropout 0) on the card and on the CPU
    from the same weights for 3 Adam steps; the losses and the step-1
    gradients of every variable must agree at phase 20's gates.
25. Check in the SASS (``cuobjdump -sass``) that every instantiation of
    the bf16 forward, dQ and dK/dV kernels runs its products on the tensor
    cores (bf16 ``HMMA``).  Hold every bf16 instantiation of the training
    kernels (forward, dQ with dbias, dK/dV with dkbias) against its bf16
    plain version: the key-mask kernels at the BERT-base flagship's
    attention shape (B=64, H=12, S=512, D=64, ``synthetic_mlm_batch``'s
    key mask with one batch row fully masked) and the causal ones at GPT-2
    small's (B=8, H=12, S=1024), each timed (L2 flushed, median of 50)
    beside its plain version, SDPA in bf16 and the bound (bytes at 2 a
    value, or the visible pairs' operations at the 989 TFLOP/s dense bf16
    peak); dense, ragged causal with a key mask, S_q > S_kv, a dense bias
    (groups h and bh), the key-bias strip, a full mask (groups b and one),
    a full mask with a bias and with a strip at small shapes; then the
    other instantiations, timed at their paths' shapes: T5's encoder bias
    (B=32, H=8, S=512, group h, its key mask), decoder bias (S=114, group
    h, causal) and key-bias strip (group b, causal), XLNet's content
    stream (B=8, S=512, mask group b, bias group h) and query stream with
    a strip, and Longformer's window (B=2, S=4096, mask group one).
    Tolerance ``BF16_RTOL`` / ``BF16_ATOL``, lse within ``BF16_LSE_ATOL``.
26. Train BERT-base at bench.py's flagship shape (batch 64, seq 512,
    ``synthetic_mlm_batch``, dropout 0.1, ``AdamOptimizer(1e-4)``) through
    ``Executor(compute_dtype="bfloat16").run``: 2 warm-up steps, then 10
    counted steps with every launch counter set to 0 just before and read
    just after (the bf16 forward, dQ and dK/dV: steps x 12 each; nothing
    else; no ``backend:`` fallback; the loss finite and falling; the
    masters float32), step p50/p99, tokens/s, MFU against the 989 TFLOP/s
    bf16 peak, peak memory, and 3 profiled steps for the device's busy
    time, idle share and the flash and matrix-product shares.
27. Train GPT-2 small (seq 1024, batch 8, dropout 0.1) the same way (the
    causal bf16 kernels: steps x 12 each).
28. Tiny BERT and tiny GPT-2 (seq 128, batch 4, dropout 0) in bf16 on the
    card and on the CPU from the same weights for 3 Adam steps: losses
    within ``BF16_TRAIN_LOSS_RTOL``, step-1 gradients of every variable
    float32 and allclose at ``BF16_TRAIN_GRAD_RTOL`` /
    ``BF16_TRAIN_GRAD_ATOL``.  Then BERT-base (seq 512, batch 8) and
    GPT-2 small (seq 1024, batch 4) at full width and depth, bf16 against
    float32 on the card from the same weights: 3 Adam losses within 5 % /
    0.05.
29. Hold the MoE row gather's bf16 instantiation (B6) against its plain
    version on phase 11's real gate maps at the MoE configuration (8,192
    tokens, d 512, 16 experts, capacity 1,280), every direction on bf16
    rows, plus n = 0, n = 1, every index -1, width 13, a source 2 bytes
    off 16-byte alignment and width 2048: bit for bit.
    ``SparseDispatch`` / ``SparseCombine`` forward and backward in the
    bf16 step's dtypes (bf16 tokens and rows, float32 gate weights, so a
    float32 combine output and d_buffers gather), kernel against plain
    gather: bit for bit.  Time the kernel, its plain version,
    ``index_select`` + ``masked_fill_`` in bf16 and the bytes bound at 2
    bytes a value (L2 flushed, median of 50).
30. Train phase 12's MoE configuration through
    ``Executor(compute_dtype="bfloat16").run``, sparse then dense: 3
    warm-up and 20 counted steps with every launch counter set to 0 just
    before and read just after (the sparse graph: 5 bf16 row gathers and 1
    float32 a step, ``MOE_GATHERS_BF16_STEP``; the dense graph none; no
    other kernel; no ``backend:`` fallback; the loss finite), step
    p50/p99, tokens/s, MFU against the 989 TFLOP/s bf16 peak, peak memory
    and 5 profiled steps for busy time and idle share.
31. Train T5-small, XLNet-base and Longformer-base in bf16 at the shapes
    and widths of phases 19, 22 and 23: 2 warm-up and 10 counted steps
    each (each bf16 flash entry the model reaches: steps x its float32
    count, 6, 23 or 12 a step; nothing else; no ``backend:`` fallback; the
    loss finite and not rising; the masters float32), then 3 profiled
    steps: busy time, idle share, the flash and matrix-product shares.
32. Tiny sparse MoE (tests/test_torch_moe.py's slice), T5, XLNet and
    Longformer in bf16, card against CPU from the same weights for 3 Adam
    steps at each model's own card-vs-CPU rate (MoE 1e-3, as phase 13;
    the others 1e-4, as phases 20 and 24) and phase 28's gates; T5's,
    XLNet's and Longformer's losses as the float64 loss of each device's
    bf16 logits (the fetched loss is a bf16 sum, whose spacing is the
    gate's size); MoE: routing maps equal every step (a differing route
    stops the phase with the tokens' gate gaps).  Then the
    MoE configuration, T5-small (batch 8), XLNet-base (batch 4) and
    Longformer-base (batch 1) at full width, bf16 against float32 on the
    card from the same weights: 3 Adam losses within 5 % / 0.05.
33. Hold every kernel with ``lengths`` (``sdpa_varlen_op``'s
    specialization: the forward, dQ with dbias and dK/dV with dkbias)
    against its plain version in float32 and bf16: at the padding-masked
    paths' shapes, BERT's (B=16, H=12, S=512, ``synthetic_mlm_batch``'s
    lengths) and GPT-2's (B=8, H=12, S=1024, causal, lengths uniform over
    [256, 1024], one row full and one of length 0), each timed (L2
    flushed, median of 50) beside its plain version, SDPA with the
    lengths as a boolean ``attn_mask`` and the bound (visible pairs, the
    K/V rows below the lengths); and at small shapes with every rule the
    kernels combine ``lengths`` with (S_q != S_kv, lengths 0, 1 and past
    S_kv; a key mask, causal, a full mask in each group mode, a dense
    bias, a strip, a full mask with a bias and with a strip).  dK, dV and
    dkbias must be exactly 0 at every key past the lengths; the log gives
    the key tiles below the lengths (the only ones any kernel walks).
34. Train the padding-masked graphs of ``tools/profile_train.py``
    (``varlen_graph``: 12 layers of ``x + o(sdpa_varlen_op(q, k, v,
    lens))`` after a LayerNorm, hidden 768, 12 heads, ``mean((x -
    y)^2)``, ``AdamOptimizer(1e-4)``): BERT's shape (batch 16, seq 512)
    and GPT-2's (batch 8, seq 1024, causal), each in float32 and under
    ``compute_dtype="bfloat16"``: 2 warm-up and 10 counted steps with
    every launch counter set to 0 just before and read just after (the
    forward, dQ and dK/dV with ``lengths``: 12 launches a step each;
    nothing else; no ``backend:`` fallback), step p50/p99, MFU on visible
    pairs, peak memory, 3 profiled steps (busy time, idle share).  Then
    each at full width bf16 against float32 (3 Adam losses within 5 % /
    0.05) and 2 layers (batch 2, seq 128) card against CPU in float32
    (phase 7's gates) and bf16 (phase 28's).
35. Print the card's name and power limit, the ``kernels`` JSON line and,
    last, ``{"ok": true, "device": {...}}``.

Float32 matrix products run in full float32:
``torch.backends.cuda.matmul.allow_tf32`` is set False.  The bf16 ones
run on the tensor cores (cuBLAS), as the JAX package leaves them to XLA.
"""
import gc
import json
import math
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

# kernel vs plain version (float32; only the summation order differs)
KERNEL_ATOL = 1e-5
# card vs CPU logits of the whole model (float32 end to end, no TF32)
LOGITS_ATOL = 1e-4
# training kernels vs plain: forward out / lse atol; dQ / dK / dV allclose
# (the backward sums over S = 512 keys or queries in another order)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
# card vs CPU training: losses rtol; step-1 gradients allclose
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL = 1e-3, 1e-5
# segment-sum kernel vs its plain version (index_add_ adds with atomics),
# on rows at the scale of the CTR step's embedding gradients
SEG_RTOL, SEG_ATOL = 2e-5, 1e-6
GRAD_SCALE = 1e-4
# CTR training, card vs CPU: losses rtol; store table allclose
CTR_LOSS_RTOL = 1e-4
CTR_TABLE_RTOL, CTR_TABLE_ATOL = 1e-5, 1e-6
# MoE sparse vs dense graph on the card: the same products in another
# order around the gathers (losses rtol; step-1 gradients allclose)
MOE_LOSS_RTOL = 1e-5
MOE_GRAD_RTOL, MOE_GRAD_ATOL = 1e-4, 1e-6
# H100 SXM data sheet: HBM3 bytes/s, float32 (non-tensor-core) FLOP/s and
# the dense bf16 tensor-core FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
# bf16 kernels vs their bf16 plain versions (out, dQ, dK, dV, dbias,
# dkbias allclose; lse atol): both round P and dS to bf16 and round their
# outputs, from float32 sums in another order and, in the forward, P
# against the running max (kernel) or the row's max (plain), so an element
# may land a bf16 ulp or two apart; test_pallas.py holds the TPU kernel's
# bf16 instantiation to its reference at the same 2e-2
BF16_RTOL, BF16_ATOL, BF16_LSE_ATOL = 2e-2, 2e-2, 1e-4

B, H, D = 8, 12, 64
CACHE_LENS = (1, 7, 128, 384, 1024)
#: the decode kernel's split plans (n_split, split_tiles) held at B, H and
#: the longest cache: None is the wrapper's own; (1, 16) one split; (3, 6)
#: a short last split; (16, 1) a tile a split; (32, 1) splits past the cache
DECODE_PLANS = (None, (1, 16), (2, 8), (3, 6), (16, 1), (32, 1))
#: their lengths: 0 (every split empty), 1, a partial tile, the whole cache,
#: tile edges
DECODE_LENS = (0, 1, 37, 1024, 64, 65, 700, 1023)
N_REQUESTS, MAX_NEW = 8, 32
PROMPT_RANGE = (8, 300)
# training kernels: BERT-base attention shapes
TB, TS = 4, 512
# BERT-base training step
TRAIN_BATCH, TRAIN_SEQ, WARMUP, STEPS = 16, 512, 2, 10
# Wide & Deep through the HET cache (bench.py's WDL configuration)
CTR_BATCH, CTR_VOCAB, CTR_DIM, CTR_WARMUP, CTR_STEPS = 2048, 100000, 16, 3, 20
# GShard MoE (bench.py's MoE configuration); the card-vs-CPU cut
MOE_WARMUP, MOE_STEPS, MOE_PROFILED, MOE_CPU_TOKENS = 3, 20, 5, 1024
# GPT-2 small training step; the chunked-prefill kernel shape
GPT_BATCH, GPT_SEQ, GPT_WARMUP, GPT_STEPS = 8, 1024, 2, 10
PREFILL_CHUNK, PREFILL_CACHE = 32, 512
# T5-small seq2seq training (span-corruption lengths, batch cut from 128)
T5_BATCH, T5_SRC, T5_TGT, T5_WARMUP, T5_STEPS = 32, 512, 114, 2, 10
# the bias kernels are held at a scale other than T5's 1.0, which would
# hide a bias added before the scale
T5_KERNEL_SCALE = 0.37
# XLNet-base permutation LM (the paper's pretraining length, batch cut);
# the attention scale of both paths (D = 64)
XL_BATCH, XL_SEQ, XL_WARMUP, XL_STEPS, XL_SCALE = 8, 512, 2, 10, 0.125
# Longformer-base MLM at its published length
LF_BATCH, LF_SEQ, LF_WARMUP, LF_STEPS = 2, 4096, 2, 10
# bf16 mixed precision: BERT-base at bench.py's flagship batch (seq TS),
# GPT-2 small at GPT_BATCH x GPT_SEQ; profiled steps for the breakdown
BF_BATCH, BF_WARMUP, BF_STEPS, BF_PROFILED = 64, 2, 10, 3
# bf16 training, card vs CPU (tiny models): losses rtol; step-1 gradients
# allclose (cuBLAS's bf16 products and the bf16 kernels against the CPU's
# bf16 products and plain versions: each rounds once from float32 sums in
# another order; tests/test_torch_bf16.py holds the CPU run to the JAX
# package at the same gates)
BF16_TRAIN_LOSS_RTOL = 5e-3
BF16_TRAIN_GRAD_RTOL, BF16_TRAIN_GRAD_ATOL = 2e-2, 1e-2
# the port's bf16 run against its float32 run: test_bf16_parity.py's budget
BF16_PARITY_TOL = 5e-2
# row-gather launches of one top-2 training step by kernels-line name: the
# dispatch (1), the combine (2), its backward (2 for d_w, 1 for
# d_buffers); the tokens are a feed, so autograd runs no dispatch backward.
# In bf16 the rows are bf16 but the combine's output, and so the gradient
# d_buffers gathers, is float32 (float32 gate weights times bf16 rows, the
# JAX package's promotion)
MOE_GATHERS_PER_STEP = {"row_gather": 6, "row_gather_bf16": 0}
MOE_GATHERS_BF16_STEP = {"row_gather": 1, "row_gather_bf16": 5}
# padding-masked attention (sdpa_varlen_op): the graphs of
# tools/profile_train.py at BERT-base's (batch 16, seq 512, not causal) and
# GPT-2 small's (batch 8, seq 1024, causal) attention widths, 12 layers
VL_SHAPES = {"varlen-bert": (16, 512, False), "varlen-gpt2": (8, 1024, True)}
VL_WARMUP, VL_STEPS, VL_PROFILED = 2, 10, 3


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def reset_launches(*modules):
    """Set every kernel launch counter (each module integer named
    ``launches`` or ``*_launches``) of the kernel modules to 0."""
    for mod in modules:
        for name in list(vars(mod)):
            if name.endswith("launches"):
                setattr(mod, name, 0)


def time_ms(fn, iters=50, flush=None):
    """Median device time of ``fn`` in ms over ``iters`` runs, each
    bracketed by its own CUDA events; ``flush`` (untimed) runs before
    each so every launch finds the L2 cache cold."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def flash_bound(lengths, heads, s_q, d):
    """Least time for the lengths-flash function on these inputs: each
    input read once (q, the K/V rows below each length, lengths), each
    output written once (out, lse), against the two matrix products'
    float32 operations.  Returns (ms, 'bytes' | 'operations')."""
    keys = int(np.sum(lengths)) * heads
    nbytes = 4 * (2 * keys * d                      # K and V rows read
                  + 2 * len(lengths) * heads * s_q * d   # q in, out
                  + len(lengths) * heads * s_q           # lse
                  + len(lengths))                        # lengths
    flops = 4.0 * keys * s_q * d
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


#: floats of the decode timings' L2 flush: a 512 MB fill keeps the device
#: busy (about 0.17 ms) past the host's work in the decode wrapper (the
#: split plan, the partials' allocation), which a 256 MB fill (about 0.085
#: ms) did not always outlast: then the host's enqueue showed in the time
DECODE_FLUSH = 128 * 2 ** 20


def phase_kernels(fa):
    """Kernel vs plain version at the decode path's shapes; times."""
    F = torch.nn.functional
    rng = np.random.RandomState(0)
    scale = 1.0 / math.sqrt(D)
    flush_buf = torch.empty(DECODE_FLUSH, dtype=torch.float32, device="cuda")
    cases = [(1, L) for L in CACHE_LENS] + [(4, 384)]
    worst = 0.0
    for s_q, L in cases:
        lens = rng.randint(1, L + 1, size=B)
        lens[0], lens[1] = 1, L
        if s_q > 1:
            lens[2] = 0                      # a row with no valid key
        q = torch.from_numpy(
            rng.randn(B * H, s_q, D).astype(np.float32)).cuda()
        k = torch.from_numpy(
            rng.randn(B * H, L, D).astype(np.float32)).cuda()
        v = torch.from_numpy(
            rng.randn(B * H, L, D).astype(np.float32)).cuda()
        lengths = torch.from_numpy(lens.astype(np.int32)).cuda()
        out, lse = fa.flash_fwd(q, k, v, lengths, H, scale)
        ref, lse_ref = fa.flash_fwd_plain(q, k, v, lengths, H, scale)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        lse_err = float((lse - lse_ref).abs().max())
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"flash kernel vs plain: S_q={s_q} L={L} "
                                 f"max err {err} > {KERNEL_ATOL}")
        if not torch.allclose(lse, lse_ref, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"flash kernel lse vs plain: S_q={s_q} "
                                 f"L={L} max err {lse_err}")
        if s_q > 1 and float(out.view(B, H, s_q, D)[2].abs().max()) != 0.0:
            raise AssertionError("row with no valid key is not zero")
        worst = max(worst, err)
        log(f"[kernels] flash S_q={s_q} L={L} lengths={lens.tolist()} "
            f"max_abs_err={err:.3e} lse_err={lse_err:.3e}")
        if s_q == 1:
            q4, k4, v4 = (t.view(B, H, -1, D) for t in (q, k, v))
            mask = (torch.arange(L, device="cuda")[None, :]
                    < lengths[:, None]).view(B, 1, 1, L)
            flush = flush_buf.zero_
            row = {"s_q": s_q, "L": L, "lengths": lens.tolist(),
                   "ms": time_ms(lambda: fa.flash_fwd(q, k, v, lengths, H,
                                                      scale), flush=flush),
                   "plain_ms": time_ms(lambda: fa.flash_fwd_plain(
                       q, k, v, lengths, H, scale), flush=flush),
                   "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                       q4, k4, v4, attn_mask=mask), flush=flush)}
            row["bound_ms"], row["bound_by"] = flash_bound(lens, H, s_q, D)
            log(f"[kernels] flash timing {json.dumps(row)}")
    # every split plan: against the plain version and the plain split
    # version; a row of length 0 exactly 0 with lse -1e30; NaN in every K
    # and V row at or past a length changes no bit; the same bits run to run
    L = CACHE_LENS[-1]
    lens = np.array(DECODE_LENS, np.int32)
    q = torch.from_numpy(rng.randn(B * H, 1, D).astype(np.float32)).cuda()
    k, v = (torch.from_numpy(rng.randn(B * H, L, D).astype(np.float32)).cuda()
            for _ in range(2))
    lengths = torch.from_numpy(lens).cuda()
    past = (torch.arange(L, device="cuda")[None, :]
            >= lengths.repeat_interleave(H)[:, None])[..., None]
    kn, vn = (x.masked_fill(past, float("nan")) for x in (k, v))
    ref, lse_ref = fa.flash_fwd_plain(q, k, v, lengths, H, scale)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for plan in DECODE_PLANS:
        used = plan or fa.decode_split_plan(B * H, 1, L, sms)
        before = fa.launches, fa.merge_launches
        out, lse = fa.flash_fwd(q, k, v, lengths, H, scale, plan=plan)
        out_n, lse_n = fa.flash_fwd(q, kn, vn, lengths, H, scale, plan=plan)
        again, lse_again = fa.flash_fwd(q, k, v, lengths, H, scale, plan=plan)
        sref, slse = fa.flash_fwd_split_plain(q, k, v, lengths, H, scale,
                                              used)
        torch.cuda.synchronize()
        if (fa.launches - before[0], fa.merge_launches - before[1]) \
                != (3, 3 * (used[0] > 1)):
            raise AssertionError(f"flash plan {used}: launches "
                                 f"{fa.launches - before[0]}, merges "
                                 f"{fa.merge_launches - before[1]}")
        err = max(float((out - ref).abs().max()),
                  float((out - sref).abs().max()))
        if not (err <= KERNEL_ATOL
                and torch.allclose(lse, lse_ref, rtol=1e-5, atol=1e-5)
                and torch.allclose(lse, slse, rtol=1e-5, atol=1e-5)):
            raise AssertionError(f"flash plan {used} vs plain: max err {err}")
        if float(out[:H].abs().max()) != 0.0 \
                or not bool((lse[:H] == fa.NEG_INF).all()):
            raise AssertionError(f"flash plan {used}: a row of length 0 is "
                                 "not 0 / -1e30")
        if not (torch.equal(out, out_n) and torch.equal(lse, lse_n)):
            raise AssertionError(f"flash plan {used}: NaN past the lengths "
                                 "changed the output")
        if not (torch.equal(out, again) and torch.equal(lse, lse_again)):
            raise AssertionError(f"flash plan {used}: not the same bits from "
                                 "run to run")
        worst = max(worst, err)
        log(f"[kernels] flash plan {used} lengths={lens.tolist()} "
            f"max_abs_err={err:.3e}; NaN past the lengths and a second run: "
            f"bit-equal")

    # the kernels line is taken at the longest cache with every row full
    full = np.full(B, CACHE_LENS[-1], np.int64)
    q = torch.randn(B * H, 1, D, device="cuda")
    k = torch.randn(B * H, L, D, device="cuda")
    v = torch.randn(B * H, L, D, device="cuda")
    lengths = torch.from_numpy(full.astype(np.int32)).cuda()
    out, _ = fa.flash_fwd(q, k, v, lengths, H, scale)
    ref, _ = fa.flash_fwd_plain(q, k, v, lengths, H, scale)
    err = float((out - ref).abs().max())
    if not err <= KERNEL_ATOL:
        raise AssertionError(f"flash kernel vs plain (full L={L}): {err}")
    worst = max(worst, err)
    q4, k4, v4 = (t.view(B, H, -1, D) for t in (q, k, v))
    mask = torch.ones(B, 1, 1, L, dtype=torch.bool, device="cuda")
    flush = flush_buf.zero_
    line = {"ms": time_ms(lambda: fa.flash_fwd(q, k, v, lengths, H, scale),
                          flush=flush),
            "plain_ms": time_ms(lambda: fa.flash_fwd_plain(
                q, k, v, lengths, H, scale), flush=flush),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask), flush=flush)}
    line["bound_ms"], line["bound_by"] = flash_bound(full, H, 1, D)
    line["max_abs_err"] = worst
    n_split = fa.decode_split_plan(B * H, 1, L, sms)[0]
    log(f"[kernels] flash line shape B={B} H={H} L={L} full lengths, "
        f"n_split {n_split}: {json.dumps(line)}")
    return line


def phase_decode_shapes(fa, calls):
    """The decode kernel at the (batch bucket, cache bucket) shapes that
    phase 3's run gave it (``calls``, a :class:`DecodeCalls`), each at the
    lengths of its last call there: held to its plain version, and timed
    beside its plain version, SDPA with the lengths as a boolean mask and
    the bound (L2 flushed, median of 50); the sum of calls x ms over the
    shapes is the kernel's share of the run."""
    F = torch.nn.functional
    rng = np.random.RandomState(3)
    scale = 1.0 / math.sqrt(D)
    flush = torch.empty(DECODE_FLUSH, dtype=torch.float32,
                        device="cuda").zero_
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for (bh, s_q, s_kv), (n, lengths) in sorted(calls.shapes.items()):
        b = bh // H
        q, k, v = (torch.from_numpy(rng.randn(bh, m, D).astype(
            np.float32)).cuda() for m in (s_q, s_kv, s_kv))
        out, _ = fa.flash_fwd(q, k, v, lengths, H, scale)
        ref, _ = fa.flash_fwd_plain(q, k, v, lengths, H, scale)
        err = float((out - ref).abs().max())
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"flash at phase 3's shape B={b} L={s_kv}: "
                                 f"max err {err}")
        q4, k4, v4 = (t.view(b, H, -1, D) for t in (q, k, v))
        mask = (torch.arange(s_kv, device="cuda")[None, :]
                < lengths[:, None]).view(b, 1, 1, s_kv)
        lens = lengths.cpu().numpy()
        row = {"B": b, "L": s_kv, "lengths": lens.tolist(), "calls": n,
               "n_split": fa.decode_split_plan(bh, s_q, s_kv, sms)[0],
               "ms": time_ms(lambda: fa.flash_fwd(q, k, v, lengths, H, scale),
                             flush=flush),
               "plain_ms": time_ms(lambda: fa.flash_fwd_plain(
                   q, k, v, lengths, H, scale), flush=flush),
               "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                   q4, k4, v4, attn_mask=mask), flush=flush),
               "max_abs_err": err}
        row["bound_ms"], row["bound_by"] = flash_bound(lens, H, s_q, D)
        for key in total:
            total[key] += n * row[key]
        log(f"[kernels] flash at phase 3's shape {json.dumps(row)}")
    log(f"[kernels] flash over phase 3's {calls.calls} calls, calls x ms "
        f"summed: {json.dumps(total)}")


def teacher_forced_logits(engine, tokens):
    """Per-step logits of one sequence fed token by token through the
    engine's serving step at batch 1 (prompt teacher-forced)."""
    iex = engine.iex
    fn = iex.compiled(1)
    L = next(b for b in engine.len_ladder if b >= len(tokens))
    caches = {n: engine._alloc(1, L) for n in engine.cache_names}
    out = []
    for t, tok in enumerate(tokens):
        feeds = {
            engine._fk["input_ids"]: torch.tensor(
                [[int(tok)]], dtype=torch.int32, device=engine.device),
            engine._fk["positions"]: torch.tensor(
                [t], dtype=torch.int32, device=engine.device)}
        feeds.update({engine._fk[n]: caches[n] for n in engine.cache_names})
        out.append(fn(iex.params, feeds)[0][0].cpu().numpy())
    return np.stack(out)


def attn_bound(kind, bh, s_q, s_kv, d, pairs, extra_bytes=0, kv_rows=None,
               elem=4, peak=PEAK_FP32_FLOPS):
    """Least time for one attention kernel's function on these inputs.
    Bytes: each input read once, each output written once (q / dO / out /
    dQ rows of S_q, k / v / dK / dV rows of S_kv or, with ``kv_rows``,
    only the K/V rows some query can see, ``elem`` bytes a value: 4 for
    float32, 2 for bf16; float32 lse and delta per row; ``extra_bytes`` of
    masks).  Operations: 4 (forward), 6 (dQ: s, dP, dQ) or 8 (dK/dV: s,
    dP, dV, dK) x D per visible (row, key) pair, at ``peak`` FLOP/s.
    Returns (ms, 'bytes' | 'operations')."""
    qmat, row = bh * s_q * d, bh * s_q
    kmat = bh * s_kv * d if kv_rows is None else kv_rows * d
    mats = {"fwd": qmat + 2 * kmat + qmat, "dq": 2 * qmat + 2 * kmat + qmat,
            "dkv": 2 * qmat + 2 * kmat + 2 * kmat}[kind]
    rows = {"fwd": row, "dq": 2 * row, "dkv": 2 * row}[kind]
    flops = {"fwd": 4, "dq": 6, "dkv": 8}[kind] * float(pairs) * d
    t_bytes = (elem * mats + 4 * rows + extra_bytes) / PEAK_BYTES_PER_S
    t_ops = flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attn_extra(kind, key_mask, bias, kbias, bh, s_q, s_kv, mask=None):
    """Bytes an attention kernel moves beyond q/k/v/dO/out/lse/delta: the
    key mask, a full uint8 mask (G, S_q, S_kv), a bias or strip read once,
    and dQ's dbias (BH, S_q, S_kv) or dK/dV's dkbias (BH, 1, S_kv) written
    once."""
    n = 0 if key_mask is None else 4 * key_mask.numel()
    if mask is not None:
        n += mask.numel()
    for b in (bias, kbias):
        if b is not None:
            n += 4 * b.numel()
    if kind == "dq" and bias is not None:
        n += 4 * bh * s_q * s_kv
    if kind == "dkv" and kbias is not None:
        n += 4 * bh * s_kv
    return n


def _group_view(x, gmode, b, heads):
    """A (G, ...) tensor stored for ``gmode`` as its rank-4 broadcastable
    view (1|B, 1|H, rows, S_kv)."""
    gb = b if gmode in ("b", "bh") else 1
    gh = heads if gmode in ("h", "bh") else 1
    return x.view(gb, gh, x.shape[-2], x.shape[-1])


def length_keys(lengths, s_kv):
    """The (B, S_kv) int32 key mask of ``lengths`` (B,): key ``c`` of row
    ``b`` is visible iff ``c < lengths[b]``."""
    cols = torch.arange(s_kv, device=lengths.device)[None, :]
    return (cols < lengths.long()[:, None]).to(torch.int32)


def sdpa_yardstick(fa, q, k, v, heads, scale, km, causal, bias, kbias,
                   gmode, mask=None, mask_gmode="bh", lengths=None):
    """(B, H, S, D) views of q/k/v that need a gradient, SDPA's keyword
    arguments for the same function and what they are: ``is_causal``, the
    key mask (``lengths`` as one more), full mask (in its broadcast shape)
    and causal rule as a boolean ``attn_mask``, or the bias with -1e30 on
    every masked pair as a float ``attn_mask`` that needs a gradient
    too."""
    bh, s_q, dh = q.shape
    s_kv = k.shape[1]
    b = bh // heads
    if lengths is not None:
        lk = length_keys(lengths, s_kv)
        km = lk if km is None else km * lk
    q4, k4, v4 = (x.view(b, heads, -1, dh).detach().requires_grad_(True)
                  for x in (q, k, v))
    kw = {"scale": scale}
    if bias is None and kbias is None:
        if km is None and mask is None:
            if causal:
                kw["is_causal"] = True
            return (q4, k4, v4), kw, "SDPA" + (" is_causal" if causal else "")
        m = None if mask is None else _group_view(mask != 0, mask_gmode, b,
                                                  heads)
        if km is not None:
            kmv = (km != 0).view(b, 1, 1, s_kv)
            m = kmv if m is None else m & kmv
        if causal:
            m = m & torch.ones(s_q, s_kv, dtype=torch.bool,
                               device="cuda").tril(s_kv - s_q)
        kw["attn_mask"] = m
        return (q4, k4, v4), kw, "SDPA boolean attn_mask"
    amask = fa._expand_group(bias if bias is not None else kbias, gmode,
                             bh, heads).view(b, heads, -1, s_kv)
    valid = fa._valid(bh, s_q, s_kv, q.device, key_mask=km, causal=causal,
                      mask=mask, gmode=mask_gmode, heads=heads)
    amask = amask.expand(b, heads, s_q, s_kv).to(q.dtype)
    if valid is not None:
        amask = amask.masked_fill(
            ~valid.expand(bh, s_q, s_kv).view(b, heads, s_q, s_kv), -1e30)
    kw["attn_mask"] = amask.contiguous().requires_grad_(True)
    return (q4, k4, v4), kw, "SDPA with the bias as a float attn_mask"


def attn_case(fa, tag, name, q, k, v, do, heads, scale, km=None,
              causal=False, bias=None, kbias=None, gmode="bh", flush=None,
              mask=None, mask_gmode="bh", lengths=None):
    """One attention case held to its plain versions on the same inputs:
    with a full uint8 ``mask`` (G, S_q, S_kv) of group mode ``mask_gmode``
    the full-mask forward / dQ / dK/dV kernels, alone or with a bias;
    else the bias forward / dQ (dbias) / dK/dV (dkbias) kernels with a
    dense ``bias`` or a strip ``kbias`` of group mode ``gmode``; else the
    dense / key-mask / causal ones.  float32: out and lse within
    KERNEL_ATOL; dQ, dK, dV, dbias, dkbias finite and allclose at
    GRAD_RTOL / GRAD_ATOL.  bfloat16 q, k, v, dO (the ``_bf16`` kernels
    against the bf16 plain versions): out, dQ, dK, dV, dbias, dkbias
    allclose at BF16_RTOL / BF16_ATOL, lse within BF16_LSE_ATOL, the
    bound at 2 bytes a value and the bf16 peak;
    every row that sees no key (a batch row with every key masked, the
    first S_q - S_kv causal rows, a row the mask hides) out = dQ = 0 and
    lse = -1e30; dbias 0 on every pair no row sees.  With ``lengths``
    (B,) every kernel takes it: dK, dV and dkbias exactly 0 at every key
    at or past its row's length, and the bound reads only the K/V rows
    below the lengths.  With ``flush`` it
    also times each kernel, the plain versions and SDPA on the same
    function, each launch with the L2 flushed, beside its bound.  Returns
    (max_abs_err {fwd, dq, dkv}, timings {fwd, dq, dkv} or None); the
    log line and each float32 timing give the (query tile, key tile) pairs
    the kernel walks (``fa.walked_tiles``) beside all of them."""
    F = torch.nn.functional
    bh, s_q, dh = q.shape
    s_kv = k.shape[1]
    biased = bias is not None or kbias is not None
    bkw = dict(causal=causal, bias=bias, kbias=kbias, bgmode=gmode,
               lengths=lengths)
    lkw = dict(causal=causal, lengths=lengths)

    def fwd():
        if mask is not None:
            return fa.flash_fwd_fullmask(q, k, v, mask, mask_gmode, heads,
                                         scale, key_mask=km, **bkw)
        if biased:
            return fa.flash_fwd_bias(q, k, v, km, bias, kbias, gmode, heads,
                                     scale, **lkw)
        return fa.flash_fwd_masked(q, k, v, km, scale, **lkw)

    def plain_fwd():
        return fa.flash_fwd_plain(q, k, v, lengths, heads, scale, key_mask=km,
                                  causal=causal, bias=bias, kbias=kbias,
                                  bgmode=gmode, mask=mask, gmode=mask_gmode)

    bf16 = q.dtype == torch.bfloat16
    rtol, atol = (BF16_RTOL, BF16_ATOL) if bf16 else (GRAD_RTOL, GRAD_ATOL)
    out, lse = fwd()
    ref, lse_ref = plain_fwd()
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, km, bias, kbias, gmode, heads, do, lse, delta, scale)
    margs = (q, k, v, km, mask, mask_gmode, heads, do, lse, delta, scale)

    def dq_fn():
        if mask is not None:
            return fa.flash_bwd_dq_mask(*margs, **bkw)
        if biased:
            return fa.flash_bwd_dq_bias(*args, **lkw)
        return fa.flash_bwd_dq(q, k, v, km, do, lse, delta, scale,
                               **lkw), None

    def dkv_fn():
        if mask is not None:
            return fa.flash_bwd_dkv_mask(*margs, **bkw)
        if biased:
            return fa.flash_bwd_dkv_bias(*args, **lkw)
        return fa.flash_bwd_dkv(q, k, v, km, do, lse, delta, scale,
                                **lkw) + (None,)

    def plain_bwd():
        if biased or mask is not None:
            return fa.flash_bwd_bias_plain(q, k, v, km, bias, kbias, gmode,
                                           heads, out, lse, do, scale,
                                           causal=causal, mask=mask,
                                           gmode=mask_gmode, lengths=lengths)
        return fa.flash_bwd_plain(q, k, v, km, out, lse, do, scale,
                                  causal=causal, heads=heads,
                                  lengths=lengths) + (None, None)

    dq, dbias = dq_fn()
    dk, dv, dkbias = dkv_fn()
    want = plain_bwd()
    torch.cuda.synchronize()
    err = {"fwd": max(float((out.float() - ref.float()).abs().max()),
                      float((lse - lse_ref).abs().max()))}
    ok = (torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol)
          and float((lse - lse_ref).abs().max()) <= BF16_LSE_ATOL) if bf16 \
        else err["fwd"] <= KERNEL_ATOL
    if not ok:
        raise AssertionError(f"{tag} fwd vs plain ({name}): {err}")
    for got, w, what in zip((dq, dk, dv, dbias, dkbias), want,
                            ("dq", "dk", "dv", "dbias", "dkbias")):
        if (got is None) != (w is None):
            raise AssertionError(f"{tag} {name}: {what} missing")
        if got is None:
            continue
        got, w = got.float(), w.float()
        e = float((got - w).abs().max())
        if not (bool(torch.isfinite(got).all())
                and torch.allclose(got, w, rtol=rtol, atol=atol)):
            raise AssertionError(f"{tag} {what} vs plain ({name}): max err "
                                 f"{e}")
        key = "dq" if what in ("dq", "dbias") else "dkv"
        err[key] = max(err.get(key, 0.0), e)
    valid = fa._valid(bh, s_q, s_kv, q.device, lengths=lengths, key_mask=km,
                      causal=causal, mask=mask, gmode=mask_gmode, heads=heads)
    # the (query tile, key tile) pairs the float32 kernels walk (they skip
    # those with no visible pair): the forward and dQ by query tile, dK/dV
    # by key tile; the bf16 kernels walk all below the causal end and the
    # length
    wkw = dict(key_mask=km, causal=causal, mask=mask, gmode=mask_gmode,
               lengths=lengths)
    walk = fa.walked_tiles(bh, heads, s_q, s_kv, **wkw)
    tiles = {"walked": int(walk.sum()), "of": int(walk.numel()),
             "walked_dkv": int(fa.walked_tiles(bh, heads, s_q, s_kv,
                                               by="key", **wkw).sum())}
    if lengths is not None:
        tiles["below_lengths"] = int(fa.walked_tiles(
            bh, heads, s_q, s_kv, causal=causal, lengths=lengths).sum())
        lk = length_keys(lengths, s_kv).repeat_interleave(heads, dim=0) == 0
        for what, g in (("dk", dk), ("dv", dv), ("dkbias", dkbias)):
            if g is not None and int(torch.count_nonzero(
                    g[:, 0][lk] if what == "dkbias" else g[lk])):
                raise AssertionError(f"{tag} {name}: {what} is not 0 at the "
                                     f"keys past the lengths")
    blind = 0
    if valid is not None:
        valid = valid.expand(bh, s_q, s_kv)
        rows = ~valid.any(-1)                      # rows that see no key
        blind = int(rows.sum())
        if blind and (float(out[rows].abs().max()) != 0.0
                      or float(dq[rows].abs().max()) != 0.0
                      or not bool((lse[rows] == fa.NEG_INF).all())):
            raise AssertionError(f"{tag} {name}: rows with no visible key "
                                 f"are not out = dQ = 0, lse = -1e30")
        if dbias is not None and int(torch.count_nonzero(dbias[~valid])):
            raise AssertionError(f"{tag} {name}: dbias is not 0 on the "
                                 f"pairs no row sees")
    # the kernels and cuBLAS's SIMT products both sum each backward output
    # as one FMA chain in key (query) order, so they may agree exactly;
    # the magnitudes show the outputs are not trivial
    mags = {w_: float(x.abs().max()) for w_, x in zip(
        ("dq", "dk", "dv", "dbias", "dkbias"), want) if x is not None}
    log(f"{tag} {name} B={bh // heads} H={heads} S_q={s_q} S_kv={s_kv} "
        f"D={dh} {str(q.dtype)[6:]} causal={causal} key_mask={km is not None} "
        f"mask={'none' if mask is None else 'group ' + mask_gmode} "
        f"bias={'dense ' + gmode if bias is not None else 'strip ' + gmode if kbias is not None else 'none'} "
        f"lengths={'none' if lengths is None else 'yes'} "
        f"scale={scale:.4g} rows seeing no key={blind} fwd / dQ / dK·dV "
        f"tiles {tiles['walked'] if not bf16 else tiles.get('below_lengths', tiles['of'])}"
        f" / {tiles['walked'] if not bf16 else '-'} / "
        f"{tiles['walked_dkv'] if not bf16 else '-'} of {tiles['of']} "
        f"max_abs_err {json.dumps(err)}; max |plain| {json.dumps(mags)}")
    if flush is None:
        return err, None
    qkv4, kw, what = sdpa_yardstick(fa, q, k, v, heads, scale, km, causal,
                                    bias, kbias, gmode, mask, mask_gmode,
                                    lengths)
    do4 = do.view(qkv4[0].shape)
    with torch.enable_grad():
        lib_out = F.scaled_dot_product_attention(*qkv4, **kw)
    lib_grads = qkv4 + ((kw["attn_mask"],) if biased else ())
    try:
        torch.autograd.grad(lib_out, lib_grads, do4, retain_graph=True)
    except RuntimeError as exc:        # the yardstick only: no bias gradient
        log(f"{tag} SDPA gives no attn_mask gradient: {exc}")
        lib_grads = qkv4
    plain_bwd_ms = time_ms(plain_bwd, flush=flush)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        lib_out, lib_grads, do4, retain_graph=True), flush=flush)
    row = {"fwd": {"ms": time_ms(fwd, flush=flush),
                   "plain_ms": time_ms(plain_fwd, flush=flush),
                   "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                       *(x.detach() for x in qkv4),
                       **{a: (b.detach() if torch.is_tensor(b) else b)
                          for a, b in kw.items()}), flush=flush)},
           "dq": {"ms": time_ms(dq_fn, flush=flush),
                  "plain_ms": plain_bwd_ms, "library_ms": lib_bwd},
           "dkv": {"ms": time_ms(dkv_fn, flush=flush),
                   "plain_ms": plain_bwd_ms, "library_ms": lib_bwd}}
    pairs = visible_pairs(bh, heads, s_q, s_kv, causal=causal, key_mask=km,
                          mask=mask, gmode=mask_gmode, lengths=lengths)
    # with lengths only the K/V rows below them are read, plus the lengths
    kv_rows = None if lengths is None else heads * int(
        lengths.long().clamp(0, s_kv).sum())
    for kk, r in row.items():
        r["bound_ms"], r["bound_by"] = attn_bound(
            kk, bh, s_q, s_kv, dh, pairs,
            attn_extra(kk, km, bias, kbias, bh, s_q, s_kv, mask)
            + (0 if lengths is None else 4 * lengths.numel()),
            kv_rows=kv_rows, elem=q.element_size(),
            peak=PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS)
        r["visible_pairs"] = pairs
        if lengths is not None:
            r["tiles_below_lengths"] = tiles["below_lengths"]
        if not bf16:
            r["walked_tiles"] = tiles["walked_dkv" if kk == "dkv"
                                      else "walked"]
            r["tiles"] = tiles["of"]
        elif mask is not None and not causal:  # a data mask skips no tile
            r["walked_pairs"] = bh * s_q * s_kv
    log(f"{tag} {name} timing (library = {what}; its backward is one call "
        f"for dQ, dK, dV{', dmask' if len(lib_grads) == 4 else ''}) "
        f"{json.dumps(row)}")
    del lib_out, qkv4, kw
    return err, row


def phase_train_kernels(ht, fa):
    """The training kernels vs their plain versions at BERT-base
    attention shapes; times.  Returns the kernels-line entries of the
    key-mask case with the worst error over all cases."""
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    scale = 1.0 / math.sqrt(D)
    _, _, _, attn = ht.synthetic_mlm_batch(
        ht.BertConfig.base(batch_size=TB, seq_len=TS), seed=0)
    attn = attn.copy()
    attn[-1] = 0                          # a row with every key masked
    cases = [("key_mask", TS, attn), ("dense", TS, None),
             ("ragged", 200, (np.arange(200)[None, :]
                              < np.array([200, 77, 1, 150])[:, None])
              .astype(np.int32)),
             ("dead key tiles", TS, (np.arange(TS)[None, :]
                                     < np.array([300, 64, 129, 511])[:, None])
              .astype(np.int32))]
    rng = np.random.RandomState(5)
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    lines = None
    for name, s, mask in cases:
        q, k, v, do = (torch.from_numpy(rng.randn(TB * H, s, D).astype(
            np.float32)).cuda() for _ in range(4))
        km = None if mask is None else torch.from_numpy(mask).cuda()
        err, row = attn_case(fa, "[train-kernels]", name, q, k, v, do, H,
                             scale, km=km, flush=flush_buf.zero_)
        for kk in worst:
            worst[kk] = max(worst[kk], err[kk])
        if name == "key_mask":
            lines = row
    for kk in lines:
        lines[kk]["max_abs_err"] = worst[kk]
    return lines


def _bert_feeds(feeds, batch):
    ids, tt, labels, attn = batch
    return {feeds["input_ids"]: ids, feeds["token_type_ids"]: tt,
            feeds["masked_lm_labels"]: labels,
            feeds["attention_mask"]: attn}


def bert_step_flops(cfg):
    """Model FLOPs of one training step (forward + backward = 3 x the
    forward's): matrix products 6 x tokens x (layers x (4 h^2 + 2 h i) +
    h^2 + h V) and attention 12 x B x heads x S^2 x (h / heads) per layer
    (two S x S products, counted dense)."""
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    n, s, b = cfg.num_hidden_layers, cfg.seq_len, cfg.batch_size
    dense = n * (4 * h * h + 2 * h * i) + h * h + h * v
    attn = 12.0 * b * cfg.num_attention_heads * s * s \
        * (h // cfg.num_attention_heads) * n
    return 6.0 * b * s * dense + attn


def phase_train(ht, fa, metrics, kmods):
    """BERT-base MLM training steps through Executor.run on the card."""
    cfg = ht.BertConfig.base(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    feeds, loss, _ = ht.bert_pretrain_graph(cfg)
    train_op = ht.optim.AdamOptimizer(1e-4).minimize(loss)
    t0 = time.perf_counter()
    ex = ht.Executor({"train": [loss, train_op]}, seed=0, device="cuda")
    log(f"[train] BERT-base executor built in "
        f"{time.perf_counter() - t0:.1f} s")
    fd = _bert_feeds(feeds, ht.synthetic_mlm_batch(cfg, seed=0))
    losses = []
    for _ in range(WARMUP):
        losses.append(float(ex.run("train", feed_dict=fd)[0].asnumpy()))
    torch.cuda.synchronize()
    reset_launches(*kmods)
    metrics.reset_flash_fallbacks()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        out = ex.run("train", feed_dict=fd)
        losses.append(float(out[0].asnumpy()))     # waits for the step
        times.append(time.perf_counter() - t0)
    launches = {"flash_fwd": fa.fwd_launches, "flash_bwd_dq": fa.dq_launches,
                "flash_bwd_dkv": fa.dkv_launches}
    fallbacks = metrics.flash_fallback_counts()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[WARMUP]:
        raise AssertionError(f"loss did not fall over the counted steps: "
                             f"{losses}")
    want = STEPS * cfg.num_hidden_layers
    if any(n != want for n in launches.values()):
        raise AssertionError(f"training kernel launches {launches} != "
                             f"steps {STEPS} x layers {cfg.num_hidden_layers}")
    left = {r: n for r, n in fallbacks.items() if r.startswith("backend:")}
    if left:
        raise AssertionError(f"attention left the kernels: {left}")
    ms = np.asarray(times) * 1e3
    tokens = cfg.batch_size * cfg.seq_len
    real = int(fd[feeds["attention_mask"]].sum())
    flops = bert_step_flops(cfg)
    report = {
        "batch": cfg.batch_size, "seq": cfg.seq_len, "steps": STEPS,
        "losses": losses, "step_ms_p50": float(np.percentile(ms, 50)),
        "step_ms_p99": float(np.percentile(ms, 99)),
        "step_ms_mean": float(ms.mean()),
        "samples_per_s": cfg.batch_size / (ms.mean() / 1e3),
        "tokens_per_s": tokens / (ms.mean() / 1e3),
        "real_tokens_per_s": real / (ms.mean() / 1e3),
        "model_tflop_per_step": flops / 1e12,
        "mfu_fp32": flops / (ms.mean() / 1e3) / PEAK_FP32_FLOPS,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": launches, "card": card_line()}
    log(f"[train] {json.dumps(report)}")
    return launches


def phase_train_parity(ht):
    """BERT-base widths cut to 2 layers: card vs CPU over 3 Adam steps
    from the same weights; losses and step-1 gradients agree."""
    cfg = ht.BertConfig.base(num_hidden_layers=2, batch_size=4, seq_len=128,
                             hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)
    feeds, loss, _ = ht.bert_pretrain_graph(cfg)
    wrt = [n for n in ht.topo_sort([loss])
           if isinstance(n, ht.PlaceholderOp) and n.is_variable
           and n.trainable]
    grads = ht.gradients(loss, wrt)
    train_op = ht.optim.AdamOptimizer(1e-4).minimize(loss)
    fetches = {"train": [loss, train_op] + grads}
    card = ht.Executor(fetches, seed=0, device="cuda")
    host = ht.Executor(fetches, seed=0, device="cpu")
    host.load_dict(card.return_tensor_values())
    fd = _bert_feeds(feeds, ht.synthetic_mlm_batch(cfg, seed=0))
    loss_err, grad_err = 0.0, 0.0
    for step in range(3):
        got = card.run("train", feed_dict=fd, convert_to_numpy_ret_vals=True)
        want = host.run("train", feed_dict=fd,
                        convert_to_numpy_ret_vals=True)
        gl, wl = float(got[0]), float(want[0])
        loss_err = max(loss_err, abs(gl - wl) / abs(wl))
        if not (math.isfinite(gl) and abs(gl - wl) <= TRAIN_LOSS_RTOL * abs(wl)):
            raise AssertionError(f"card vs CPU loss at step {step + 1}: "
                                 f"{gl} vs {wl}")
        if step == 0:
            for node, g, w in zip(wrt, got[2:], want[2:]):
                grad_err = max(grad_err, float(np.max(np.abs(g - w))))
                if not np.allclose(g, w, rtol=TRAIN_GRAD_RTOL,
                                   atol=TRAIN_GRAD_ATOL):
                    raise AssertionError(
                        f"card vs CPU gradient of {node.name}: max err "
                        f"{float(np.max(np.abs(g - w)))}")
    log(f"[train-parity] card vs CPU, {cfg.num_hidden_layers} layers, "
        f"3 Adam steps: loss max rel err {loss_err:.3e} (rtol "
        f"{TRAIN_LOSS_RTOL}); step-1 gradients of {len(wrt)} variables max "
        f"abs err {grad_err:.3e} (rtol {TRAIN_GRAD_RTOL}, atol "
        f"{TRAIN_GRAD_ATOL})")


# -- embedding cache / CTR -----------------------------------------------------

def wdl_executor(ht, mode, device, slab_device=None):
    """Wide & Deep at the WDL configuration: ((dense, sparse, y) feeds,
    executor, its cache)."""
    dense = ht.placeholder_op("dense")
    sparse = ht.placeholder_op("sparse", dtype=np.int64)
    y_ = ht.placeholder_op("y")
    loss, prob = ht.wdl_criteo(dense, sparse, y_, CTR_BATCH, vocab=CTR_VOCAB,
                               dim=CTR_DIM, embed_mode=mode, lr=0.01,
                               slab_device=slab_device)
    train_op = ht.optim.SGDOptimizer(0.01).minimize(loss)
    ex = ht.Executor({"train": [loss, train_op], "eval": [prob]}, seed=0,
                     device=device)
    cache = ex.subexecutors["train"].ps_nodes[0].cache
    return (dense, sparse, y_), ex, cache


def ctr_batches(ht):
    """The 8 training batches of ``synthetic_criteo_skewed(8 * 2048)``."""
    d, s, y = ht.synthetic_criteo_skewed(8 * CTR_BATCH, vocab=CTR_VOCAB,
                                         seed=0)
    return [(d[i * CTR_BATCH:(i + 1) * CTR_BATCH],
             s[i * CTR_BATCH:(i + 1) * CTR_BATCH],
             y[i * CTR_BATCH:(i + 1) * CTR_BATCH]) for i in range(8)]


def bytes_bound(nbytes, adds=0.0):
    """(ms, 'bytes' | 'operations') of a copy or sum: ``nbytes`` at the
    HBM rate against ``adds`` float32 additions at the fp32 peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, adds / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_emb_kernels(ht, emb, seg):
    """The slab gather and the sorted segment-sum vs their plain versions
    at the CTR path's shapes (a real slot plan), edge cases; times."""
    from hetu_tpu_torch.ps.dist_store import _segment_sum
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    flush = flush_buf.zero_
    batches = ctr_batches(ht)
    store = ht.EmbeddingStore()
    t = store.init_table(CTR_VOCAB, CTR_DIM, opt="sgd", lr=0.01, seed=0,
                         init_scale=0.01)
    cache = ht.DistCacheTable(store, t, limit=CTR_VOCAB // 10, pull_bound=10,
                              push_bound=10, policy="lru", device=True,
                              device_scratch=CTR_BATCH * 26)
    cache.lookup(batches[0][1])             # batch 1 then has hits
    h = cache.begin_lookup(batches[1][1])
    try:
        rows = h.roundtrip()
    except BaseException:
        cache.abort_lookup(h)
        raise
    cache.finish_lookup(h, rows)
    slab = cache._ensure_dev_slab()
    slots = torch.from_numpy(h.positions[h.inv].astype(np.int32)).cuda()
    inv_np = h.inv.astype(np.int64)
    inv = torch.from_numpy(h.inv.astype(np.int32)).cuda()
    n, w = slots.shape[0], slab.shape[1]
    rng = np.random.RandomState(8)
    log(f"[emb-kernels] real plan: n={n} unique={h.uk.size} "
        f"hits={int(h.hit.sum())} slab={tuple(slab.shape)}")

    # -- gather: exact
    gcases = [("plan", slab, slots)]
    for name, rows_, w_, n_ in (("n=0", 64, 16, 0), ("n=1001", 5000, 16, 1001),
                                ("w=13", 5000, 13, 4099),
                                ("w=128", 5000, 128, 2051)):
        gcases.append((name, torch.from_numpy(
            rng.randn(rows_, w_).astype(np.float32)).cuda(),
            torch.from_numpy(rng.randint(0, rows_, n_).astype(np.int32))
            .cuda()))
    for name, sl, sv in gcases:
        out = emb.gather_rows(sl, sv)
        ref = emb.gather_rows_plain(sl, sv)
        torch.cuda.synchronize()
        if out.shape != ref.shape or not torch.equal(out, ref):
            raise AssertionError(f"gather kernel vs plain ({name}): max err "
                                 f"{float((out - ref).abs().max())}")
        log(f"[emb-kernels] gather {name} n={sv.shape[0]} "
            f"w={sl.shape[1]}: equal")
    slots64 = slots.long()
    gline = {"ms": time_ms(lambda: emb.gather_rows(slab, slots), flush=flush),
             "plain_ms": time_ms(lambda: emb.gather_rows_plain(slab, slots),
                                 flush=flush),
             "library_ms": time_ms(lambda: torch.index_select(slab, 0,
                                                              slots64),
                                   flush=flush),
             "max_abs_err": 0.0}
    distinct = int(torch.unique(slots).numel())
    gline["bound_ms"], gline["bound_by"] = bytes_bound(
        4 * n + 4 * distinct * w + 4 * n * w)

    # -- segment-sum: plain within tolerance, host _segment_sum exactly
    # rows at the scale of the step's embedding gradients (the loss is a
    # mean over 2048 rows: |g| ~ 1e-5), where the tolerance against the
    # atomics of index_add_ is met; the plan again at unit scale, where a
    # run of ~370 rows cancels and differs from the atomics' order by more
    # than rtol 2e-5, is held to the host _segment_sum exactly
    def grads(n_, w_):
        return torch.from_numpy(
            (rng.randn(n_, w_) * GRAD_SCALE).astype(np.float32)).cuda()
    g_plan = grads(n, w)
    zipf = 1.0 / np.arange(1, 4001) ** 1.1
    scases = [("plan", g_plan, inv_np),
              ("plan, unit scale", torch.from_numpy(
                  rng.randn(n, w).astype(np.float32)).cuda(), inv_np)]
    for name, n_, w_, ids in (
            ("n=0", 0, 16, np.zeros(0, np.int64)),
            ("n=1001", 1001, 16, rng.randint(0, 300, 1001)),
            ("one run", 4096, 16, np.zeros(4096, np.int64)),
            ("distinct", 4096, 16, rng.permutation(10 ** 5)[:4096]),
            ("w=13", 4099, 13, rng.randint(0, 500, 4099)),
            ("w=128", 2051, 128, rng.randint(0, 500, 2051)),
            # runs longer than the kernel's shared-memory chunk, staged by
            # a whole CTA (the GPU test's Zipf case has runs of thousands)
            ("one run, w=128", 3000, 128, np.zeros(3000, np.int64)),
            ("Zipf, 4,000 ids", 53248, 16, np.random.RandomState(88).choice(
                4000, 53248, p=zipf / zipf.sum()))):
        inv_ = np.unique(ids, return_inverse=True)[1].astype(np.int64)
        scases.append((name, grads(n_, w_), inv_))
    worst = 0.0
    for name, gg, iv in scases:
        ii = torch.from_numpy(iv.astype(np.int32)).cuda()
        before = seg.launches
        out = emb.scatter_add_grads(gg, ii)
        order = torch.sort(ii, stable=True)
        ref = seg.sorted_segment_sum_plain(gg.index_select(0, order.indices),
                                           order.values, gg.shape[0])
        torch.cuda.synchronize()
        if gg.shape[0] and seg.launches != before + 1:
            raise AssertionError(f"segment-sum ({name}) did not launch")
        err = float((out - ref).abs().max()) if out.numel() else 0.0
        unit = name.endswith("unit scale")
        if not unit and not torch.allclose(out, ref, rtol=SEG_RTOL,
                                           atol=SEG_ATOL):
            raise AssertionError(f"segment-sum kernel vs plain ({name}): "
                                 f"max err {err}")
        u = int(iv.max()) + 1 if iv.size else 0
        host = out.cpu().numpy()
        if iv.size:
            cnt = np.bincount(iv)
            if not np.array_equal(host[:u], _segment_sum(
                    gg.cpu().numpy(), iv, cnt)):
                raise AssertionError(f"segment-sum kernel vs host "
                                     f"_segment_sum ({name}) not equal")
        if host[u:].any():
            raise AssertionError(f"segment-sum ({name}): rows past the last "
                                 f"segment are not zero")
        if not torch.equal(out, emb.scatter_add_grads(gg, ii)):
            raise AssertionError(f"segment-sum ({name}) differs from run to "
                                 f"run")
        if not unit:
            worst = max(worst, err)
        longest = int(np.bincount(iv).max()) if iv.size else 0
        log(f"[emb-kernels] segment-sum {name} n={gg.shape[0]} "
            f"w={gg.shape[1]} segments={u} longest run {longest}: "
            f"max_abs_err vs plain {err:.3e}, equal to host _segment_sum "
            f"and from run to run")
    order = torch.sort(inv, stable=True)
    rows_sorted = g_plan.index_select(0, order.indices)
    seg_ids = order.values
    seg64 = seg_ids.long()
    zeros = torch.zeros(n, w, device="cuda")
    sline = {"ms": time_ms(lambda: seg.sorted_segment_sum(rows_sorted,
                                                          seg_ids, n),
                           flush=flush),
             "plain_ms": time_ms(lambda: seg.sorted_segment_sum_plain(
                 rows_sorted, seg_ids, n), flush=flush),
             "library_ms": time_ms(lambda: zeros.index_add_(0, seg64,
                                                            rows_sorted),
                                   flush=flush),
             "max_abs_err": worst}
    u = int(h.uk.size)
    sline["bound_ms"], sline["bound_by"] = bytes_bound(
        4 * n * w + 4 * n + 4 * n * w, adds=float((n - u) * w))
    sort_ms = time_ms(lambda: emb.scatter_add_grads(g_plan, inv),
                      flush=flush)
    longest = int(np.bincount(inv_np).max())
    log(f"[emb-kernels] gather timing {json.dumps(gline)}")
    log(f"[emb-kernels] segment-sum timing {json.dumps(sline)}; with the "
        f"stable sort and permutation (scatter_add_grads) {sort_ms:.4f} ms; "
        f"longest run {longest} rows of {n}, {u} segments")
    return gline, sline


def phase_ctr_train(ht, metrics, kmods, emb, seg):
    """Wide & Deep training steps through the device cache on the card."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()     # what earlier phases still hold
    t0 = time.perf_counter()
    feeds, ex, cache = wdl_executor(ht, "vlru_dev", "cuda")
    log(f"[ctr] WDL executor built in {time.perf_counter() - t0:.1f} s")
    batches = ctr_batches(ht)

    def step(i):
        return float(ex.run("train", feed_dict=dict(
            zip(feeds, batches[i % len(batches)])))[0].asnumpy())

    losses = [step(i) for i in range(CTR_WARMUP)]
    torch.cuda.synchronize()
    reset_launches(*kmods)
    metrics.reset_flash_fallbacks()
    metrics.reset_emb_fallbacks()
    metrics.reset_cache_counts()
    before = dict(cache.stats)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(CTR_WARMUP, CTR_WARMUP + CTR_STEPS):
        t0 = time.perf_counter()
        losses.append(step(i))              # the loss copy waits for it
        times.append(time.perf_counter() - t0)
    launches = {"emb_gather": emb.launches, "sorted_segment_sum": seg.launches}
    fallbacks = {**metrics.emb_fallback_counts(),
                 **metrics.flash_fallback_counts()}
    counts = metrics.cache_counts()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite CTR loss: {losses}")
    if any(v != CTR_STEPS for v in launches.values()):
        raise AssertionError(f"embedding kernel launches {launches} != "
                             f"steps {CTR_STEPS}")
    left = {r: c for r, c in fallbacks.items() if "backend:" in r}
    if left:
        raise AssertionError(f"the embedding path left the kernels: {left}")
    # held out: a batch of another draw (seed 1) of the same generator
    hd, hs, hy = ht.synthetic_criteo_skewed(CTR_BATCH, vocab=CTR_VOCAB,
                                            seed=1)
    prob = ex.run("eval", feed_dict=dict(zip(feeds, (hd, hs, hy))),
                  convert_to_numpy_ret_vals=True)[0]
    if prob.shape != (CTR_BATCH, 1) or not np.all(np.isfinite(prob)):
        raise AssertionError(f"eval prob {prob.shape} not finite")
    ms = np.asarray(times) * 1e3
    hits = counts.get("emb_cache_hit_rows", 0)
    occ = hits + counts.get("emb_cache_miss_rows", 0)
    report = {
        "batch": CTR_BATCH, "vocab": CTR_VOCAB, "dim": CTR_DIM,
        "steps": CTR_STEPS, "losses": losses,
        "step_ms_p50": float(np.percentile(ms, 50)),
        "step_ms_p99": float(np.percentile(ms, 99)),
        "step_ms_mean": float(ms.mean()),
        "samples_per_s": CTR_BATCH / (ms.mean() / 1e3),
        "hit_rate": hits / occ if occ else None,
        "miss_rows_per_step": (cache.stats["fetches"] - before["fetches"])
        / CTR_STEPS,
        "miss_occurrences_per_step": counts.get("emb_cache_miss_rows", 0)
        / CTR_STEPS,
        "evicted_rows_per_step": counts.get("emb_cache_evict_rows", 0)
        / CTR_STEPS,
        "pushed_rows_per_step": counts.get("emb_cache_push_rows", 0)
        / CTR_STEPS,
        "held_out_auc": ht.metrics.auc(prob.ravel(), hy.ravel()),
        "peak_mem_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
        "launches": launches, "card": card_line()}
    log(f"[ctr] {json.dumps(report)}")
    ex.close()
    return launches


def _ctr_run(ht, metrics, mode, device, steps, table, weights):
    """``steps`` WDL steps from ``table`` and ``weights``: (losses, final
    store table after a flush, versions, cache stats, cache counters)."""
    feeds, ex, cache = wdl_executor(
        ht, mode, device, slab_device=device if mode.endswith("_dev")
        else None)
    ex.load_dict(weights)
    cache.store.set_data(cache.table, table)
    metrics.reset_cache_counts()
    batches = ctr_batches(ht)
    losses = [float(ex.run("train", feed_dict=dict(
        zip(feeds, batches[i % len(batches)])))[0].asnumpy())
        for i in range(steps)]
    cache.flush()
    ex.close()
    return (losses, cache.store.get_data(cache.table),
            cache.store.versions(cache.table, np.arange(CTR_VOCAB)),
            dict(cache.stats), metrics.cache_counts())


def phase_ctr_parity(ht, metrics):
    """Device cache vs host cache on the card, bit for bit; then card vs
    CPU within tolerances."""
    _, ex, cache = wdl_executor(ht, "vlru_dev", "cuda")
    weights = ex.return_tensor_values()
    table = cache.store.get_data(cache.table)
    ex.close()
    dev = _ctr_run(ht, metrics, "vlru_dev", "cuda", 8, table, weights)
    host = _ctr_run(ht, metrics, "vlru", "cuda", 8, table, weights)
    if dev[0] != host[0]:
        raise AssertionError(f"device vs host cache losses: {dev[0]} vs "
                             f"{host[0]}")
    for i, what in ((1, "store table"), (2, "versions")):
        if not np.array_equal(dev[i], host[i]):
            raise AssertionError(f"device vs host cache {what} differ: max "
                                 f"{float(np.max(np.abs(dev[i] - host[i])))}")
    if dev[3] != host[3] or dev[4] != host[4]:
        raise AssertionError(f"device vs host cache counters: {dev[3]} "
                             f"{dev[4]} vs {host[3]} {host[4]}")
    log(f"[ctr-parity] device vs host cache on the card, 8 steps: losses, "
        f"store table, versions and counters equal bit for bit; "
        f"stats {dev[3]}")
    card = _ctr_run(ht, metrics, "vlru_dev", "cuda", 3, table, weights)
    cpu = _ctr_run(ht, metrics, "vlru_dev", "cpu", 3, table, weights)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card[0], cpu[0]))
    tab_err = float(np.max(np.abs(card[1] - cpu[1])))
    if not loss_err <= CTR_LOSS_RTOL:
        raise AssertionError(f"card vs CPU CTR losses {card[0]} vs {cpu[0]}")
    if not np.allclose(card[1], cpu[1], rtol=CTR_TABLE_RTOL,
                       atol=CTR_TABLE_ATOL):
        raise AssertionError(f"card vs CPU store table: max err {tab_err}")
    if not np.array_equal(card[2], cpu[2]) or card[3] != cpu[3]:
        raise AssertionError("card vs CPU: versions or cache stats differ")
    log(f"[ctr-parity] card vs CPU, 3 steps: loss max rel err "
        f"{loss_err:.3e} (rtol {CTR_LOSS_RTOL}); store table max abs err "
        f"{tab_err:.3e} (rtol {CTR_TABLE_RTOL}, atol {CTR_TABLE_ATOL}); "
        f"versions and stats equal")


# -- MoE ---------------------------------------------------------------------------

def moe_route(ht, pm):
    """The maps of a real ``TopKGateSparse`` at the MoE configuration
    (seeded gate weights, 8,192 tokens from ``RandomState(0).randn``), on
    the card: (tokens, token_of_slot, slot_of_token, k_of_slot, gate_w)."""
    g = pm.moe_graph(sparse=True)
    ex = ht.Executor({"route": list(g["route"][:4])}, seed=0, device="cuda")
    fd = pm.moe_feeds(g)
    tos, sot, kos, gw = (o.torch() for o in ex.run("route", feed_dict=fd))
    return torch.from_numpy(fd[g["x"]]).cuda(), tos, sot, kos, gw


def gather_bound(src, idx):
    """(ms, 'bytes' | 'operations') of one row gather on these inputs: the
    int32 indices and each distinct valid source row read once, the
    output written once (src's element size: 4 bytes, 2 in bf16)."""
    valid = idx[idx >= 0]
    rows = int(torch.unique(valid).numel()) if valid.numel() else 0
    m, es = src.shape[1], src.element_size()
    return bytes_bound(4 * idx.shape[0] + es * rows * m
                       + es * idx.shape[0] * m)


def phase_moe_kernels(ht, pm, md):
    """The MoE row gather vs its plain version at the MoE path's shapes
    (a real gate's maps), edge cases; the autograd functions kernel vs
    plain bit for bit; times."""
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    flush = flush_buf.zero_
    x, tos, sot, kos, gw = moe_route(ht, pm)
    s, m = x.shape
    n_slots, k = tos.shape[0], sot.shape[1]
    rng = np.random.RandomState(11)

    def rand(r, w):
        return torch.from_numpy(rng.randn(r, w).astype(np.float32)).cuda()

    def ints(lo, hi, n):
        return torch.from_numpy(rng.randint(lo, hi, n).astype(np.int32)).cuda()

    buffers, g_tok = rand(n_slots, m), rand(s, m)
    sot_t = sot.t().contiguous()
    log(f"[moe-kernels] real gate maps: tokens={s} slots={n_slots} "
        f"empty slots={int((tos < 0).sum())} dropped routes="
        f"{int((sot < 0).sum())} of {s * k}")
    cases = [("dispatch fwd", x, tos),
             ("combine fwd, d_w, dispatch bwd (route 0)", buffers, sot_t[0]),
             ("combine fwd, d_w, dispatch bwd (route 1)", buffers, sot_t[1]),
             ("combine bwd d_buffers", g_tok, tos),
             ("n=0", rand(64, 16), ints(0, 64, 0)),
             ("n=1", rand(5, 16), ints(0, 5, 1)),
             ("every index -1", rand(100, 16), ints(-1, 0, 777)),
             ("w=13", rand(5000, 13), ints(-1, 5000, 4099)),
             ("w=2048", rand(2000, 2048), ints(-1, 2000, 3001))]
    for name, src, idx in cases:
        before = md.launches
        out = md.row_gather(src, idx)
        ref = md.row_gather_plain(src, idx)
        torch.cuda.synchronize()
        if md.launches != before + (1 if idx.shape[0] else 0):
            raise AssertionError(f"row gather ({name}) did not launch once")
        if out.shape != ref.shape or not torch.equal(out, ref):
            raise AssertionError(f"row gather kernel vs plain ({name}): max "
                                 f"err {float((out - ref).abs().max())}")
        if out[idx < 0].any():
            raise AssertionError(f"row gather ({name}): -1 rows not zero")
        log(f"[moe-kernels] row gather {name} n={idx.shape[0]} m="
            f"{src.shape[1]} src_rows={src.shape[0]}: equal")

    # the autograd functions on those maps, kernel vs plain gather
    def run(gather):
        xx = x.clone().requires_grad_(True)
        bb = buffers.clone().requires_grad_(True)
        ww = gw.clone().requires_grad_(True)
        buf = md.sparse_dispatch(xx, tos, sot, gather=gather)
        out = md.sparse_combine(bb, ww, sot, tos, kos, gather=gather)
        d_x, = torch.autograd.grad(buf, xx, buffers)
        d_b, d_w = torch.autograd.grad(out, (bb, ww), g_tok)
        return {"dispatch": buf, "combine": out, "d_tokens": d_x,
                "d_buffers": d_b, "d_gate_w": d_w}

    before = md.launches
    got = run(md.row_gather)
    torch.cuda.synchronize()
    if md.launches != before + 3 * k + 2:
        raise AssertionError(f"autograd functions launched "
                             f"{md.launches - before}, not 3k + 2")
    want = run(md.row_gather_plain)
    torch.cuda.synchronize()
    for name in got:
        if not torch.equal(got[name], want[name]):
            raise AssertionError(
                f"{name}: kernel vs plain gather not bit-equal, max err "
                f"{float((got[name] - want[name]).abs().max())}")
    log(f"[moe-kernels] SparseDispatch / SparseCombine forward and backward, "
        f"kernel vs plain gather: bit-equal ({', '.join(got)}; "
        f"{3 * k + 2} launches)")

    lines = {}
    for name, src, idx in cases[:2]:
        idx64 = idx.clamp_min(0).long()
        neg = (idx < 0)[:, None]
        row = {"ms": time_ms(lambda: md.row_gather(src, idx), flush=flush),
               "plain_ms": time_ms(lambda: md.row_gather_plain(src, idx),
                                   flush=flush),
               # one library call per half: index_select, then the -1 rows
               # zeroed in place (masked_fill_); the indices prepared once
               "library_ms": time_ms(lambda: src.index_select(
                   0, idx64).masked_fill_(neg, 0.0), flush=flush),
               "max_abs_err": 0.0}
        row["bound_ms"], row["bound_by"] = gather_bound(src, idx)
        log(f"[moe-kernels] row gather timing ({name}, n={idx.shape[0]} "
            f"m={m} src_rows={src.shape[0]}; library = index_select + "
            f"masked_fill_): {json.dumps(row)}")
        lines[name] = row
    return lines["dispatch fwd"]


def phase_moe_bf16_kernels(ht, pm, md):
    """B6's bf16 instantiation against its plain version at the MoE path's
    shapes (the maps of phase 11's real gate), every direction on bf16
    rows, and edge cases (n = 0, n = 1, every index -1, width 13, a source
    2 bytes off 16-byte alignment, width 2048): bit for bit.  The autograd
    functions in the bf16 step's dtypes (bf16 tokens and expert rows,
    float32 gate weights), kernel against plain gather: bit for bit, with
    3k + 1 bf16 launches and one float32.  Times the dispatch and the
    combine's route-0 gather: kernel, plain version, ``index_select`` +
    ``masked_fill_`` in bf16 and the bytes bound at 2 bytes a value.
    Returns the dispatch's kernels-line row."""
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    flush = flush_buf.zero_
    x, tos, sot, kos, gw = moe_route(ht, pm)
    s, m = x.shape
    n_slots, k = tos.shape[0], sot.shape[1]
    rng = np.random.RandomState(29)
    bf = torch.bfloat16

    def rand(r, w):
        return torch.from_numpy(rng.randn(r, w).astype(np.float32)).to(
            "cuda", bf)

    def ints(lo, hi, n):
        return torch.from_numpy(rng.randint(lo, hi, n).astype(np.int32)).cuda()

    xb, buffers, g_tok = x.to(bf), rand(n_slots, m), rand(s, m)
    sot_t = sot.t().contiguous()
    # rows of 16 bf16 values starting one value (2 bytes) into the buffer
    off = rand(1, 5000 * 16 + 1).view(-1)[1:].view(5000, 16)
    cases = [("dispatch fwd", xb, tos),
             ("combine fwd, d_w, dispatch bwd (route 0)", buffers, sot_t[0]),
             ("combine fwd, d_w, dispatch bwd (route 1)", buffers, sot_t[1]),
             ("slot <- token map on bf16 rows", g_tok, tos),
             ("n=0", rand(64, 16), ints(0, 64, 0)),
             ("n=1", rand(5, 16), ints(0, 5, 1)),
             ("every index -1", rand(100, 16), ints(-1, 0, 777)),
             ("w=13", rand(5000, 13), ints(-1, 5000, 4099)),
             ("w=16, src 2 bytes off alignment", off, ints(-1, 5000, 4099)),
             ("w=2048", rand(2000, 2048), ints(-1, 2000, 3001))]
    for name, src, idx in cases:
        before, before32 = md.bf16_launches, md.launches
        out = md.row_gather(src, idx)
        ref = md.row_gather_plain(src, idx)
        torch.cuda.synchronize()
        if md.bf16_launches != before + (1 if idx.shape[0] else 0) \
                or md.launches != before32:
            raise AssertionError(f"bf16 row gather ({name}) did not launch "
                                 f"its bf16 kernel once")
        if out.dtype != bf or out.shape != ref.shape or not torch.equal(
                out.view(torch.int16), ref.view(torch.int16)):
            raise AssertionError(f"bf16 row gather kernel vs plain ({name}): "
                                 f"not bit-equal")
        if out[idx < 0].any():
            raise AssertionError(f"bf16 row gather ({name}): -1 rows not "
                                 f"zero")
        log(f"[moe-bf16-kernels] row gather {name} n={idx.shape[0]} m="
            f"{src.shape[1]} src_rows={src.shape[0]}: bit-equal")

    g_out = g_tok.float()

    def run(gather):
        xx = xb.clone().requires_grad_(True)
        bb = buffers.clone().requires_grad_(True)
        ww = gw.clone().requires_grad_(True)
        buf = md.sparse_dispatch(xx, tos, sot, gather=gather)
        out = md.sparse_combine(bb, ww, sot, tos, kos, gather=gather)
        d_x, = torch.autograd.grad(buf, xx, buffers)
        d_b, d_w = torch.autograd.grad(out, (bb, ww), g_out)
        return {"dispatch": buf, "combine": out, "d_tokens": d_x,
                "d_buffers": d_b, "d_gate_w": d_w}

    before, before32 = md.bf16_launches, md.launches
    got = run(md.row_gather)
    torch.cuda.synchronize()
    if (md.bf16_launches - before, md.launches - before32) != (3 * k + 1, 1):
        raise AssertionError(
            f"bf16 autograd functions launched {md.bf16_launches - before} "
            f"bf16 and {md.launches - before32} float32 gathers, not "
            f"3k + 1 and 1")
    want = run(md.row_gather_plain)
    torch.cuda.synchronize()
    dtypes = {name: str(t.dtype).replace("torch.", "")
              for name, t in got.items()}
    if dtypes != {"dispatch": "bfloat16", "combine": "float32",
                  "d_tokens": "bfloat16", "d_buffers": "bfloat16",
                  "d_gate_w": "float32"}:
        raise AssertionError(f"bf16 autograd functions' dtypes {dtypes}")
    for name in got:
        if not torch.equal(got[name], want[name]):
            raise AssertionError(
                f"bf16 {name}: kernel vs plain gather not bit-equal, max err "
                f"{float((got[name] - want[name]).abs().max())}")
    log(f"[moe-bf16-kernels] SparseDispatch / SparseCombine in the bf16 "
        f"step's dtypes {json.dumps(dtypes)}, kernel vs plain gather: "
        f"bit-equal ({3 * k + 1} bf16 launches, 1 float32)")

    lines = {}
    for name, src, idx in cases[:2]:
        idx64 = idx.clamp_min(0).long()
        neg = (idx < 0)[:, None]
        row = {"ms": time_ms(lambda: md.row_gather(src, idx), flush=flush),
               "plain_ms": time_ms(lambda: md.row_gather_plain(src, idx),
                                   flush=flush),
               "library_ms": time_ms(lambda: src.index_select(
                   0, idx64).masked_fill_(neg, 0.0), flush=flush),
               "max_abs_err": 0.0}
        row["bound_ms"], row["bound_by"] = gather_bound(src, idx)
        log(f"[moe-bf16-kernels] bf16 row gather timing ({name}, n="
            f"{idx.shape[0]} m={m} src_rows={src.shape[0]}; library = "
            f"index_select + masked_fill_): {json.dumps(row)}")
        lines[name] = row
    return lines["dispatch fwd"]


def phase_moe_train(ht, pm, metrics, kmods, md, compute_dtype=None):
    """The MoE configuration trained through SparseMoELayer on the card,
    then the dense MoELayer graph the same way; float32, or bf16 mixed
    precision with ``compute_dtype="bfloat16"``.  Returns the sparse
    graph's row-gather launches by kernels-line name."""
    bf16 = compute_dtype is not None
    tag = "[moe-bf16]" if bf16 else "[moe]"
    peak = ("bf16", PEAK_BF16_FLOPS) if bf16 else ("fp32", PEAK_FP32_FLOPS)
    reports = {}
    for graph in ("sparse", "dense"):
        # what earlier phases still hold, their cycles collected first so
        # none is freed during the run
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        dims, ex, fd = pm.build_moe_graph(sparse=graph == "sparse",
                                          device="cuda",
                                          compute_dtype=compute_dtype)
        log(f"{tag} {graph} executor built in "
            f"{time.perf_counter() - t0:.1f} s")

        def step():
            return float(ex.run("train", feed_dict=fd)[0].asnumpy())

        losses = [step() for _ in range(MOE_WARMUP)]
        torch.cuda.synchronize()
        reset_launches(*kmods)
        metrics.reset_moe_fallbacks()
        metrics.reset_flash_fallbacks()
        metrics.reset_emb_fallbacks()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(MOE_STEPS):
            t0 = time.perf_counter()
            losses.append(step())           # the loss copy waits for it
            times.append(time.perf_counter() - t0)
        launches = {"row_gather": md.launches,
                    "row_gather_bf16": md.bf16_launches}
        others = {m.__name__.rsplit(".", 1)[-1]: n for m in kmods
                  for name, n in vars(m).items()
                  if name.endswith("launches") and m is not md and n}
        fallbacks = {**metrics.moe_fallback_counts(),
                     **metrics.flash_fallback_counts(),
                     **metrics.emb_fallback_counts()}
        peak_mem = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        kern, pwall, _ = pm.device_profile(step, MOE_PROFILED)
        busy_s = sum(v[1] for v in kern.values()) / 1e6 / MOE_PROFILED
        gather_us = {dt: sum(v[1] for n, v in kern.items()
                             if any(k_ in n for k_ in names))
                     for dt, names in pm.B6_KERNELS.items()}
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"non-finite MoE loss ({graph}): {losses}")
        # float32 must fall; the bf16 loss is a bf16 number, held finite
        if not bf16 and not losses[-1] < losses[0]:
            raise AssertionError(f"MoE loss did not fall ({graph}): {losses}")
        per_step = MOE_GATHERS_BF16_STEP if bf16 else MOE_GATHERS_PER_STEP
        want = {name: MOE_STEPS * n if graph == "sparse" else 0
                for name, n in per_step.items()}
        if launches != want:
            raise AssertionError(f"row gather launches ({graph}) {launches} "
                                 f"!= {want}")
        if others:
            raise AssertionError(f"other kernels launched ({graph}): {others}")
        left = {r: c for r, c in fallbacks.items() if "backend:" in r}
        if left:
            raise AssertionError(f"the MoE path left the kernel: {left}")
        if not kern:
            raise AssertionError("the profiler recorded no device time")
        ms = np.asarray(times) * 1e3
        flops = pm.moe_step_flops()
        tokens = pm.TOKENS
        reports[graph] = {
            "graph": graph, "compute_dtype": compute_dtype or "float32",
            "tokens": tokens, "d": dims["d"],
            "experts": dims["experts"], "capacity": dims["capacity"],
            "steps": MOE_STEPS, "losses": losses,
            "loss_fell": losses[-1] < losses[0],
            "step_ms_p50": float(np.percentile(ms, 50)),
            "step_ms_p99": float(np.percentile(ms, 99)),
            "step_ms_mean": float(ms.mean()),
            "tokens_per_s": tokens / (ms.mean() / 1e3),
            "model_gflop_per_step": flops / 1e9,
            "mfu_" + peak[0]: flops / (ms.mean() / 1e3) / peak[1],
            "peak_mem_gib": peak_mem,
            "device_busy_ms_per_step": busy_s * 1e3,
            "device_idle_share": 1.0 - busy_s / (ms.mean() / 1e3),
            "row_gather_device_ms_per_step": {
                dt: us / MOE_PROFILED / 1e3 for dt, us in gather_us.items()},
            "device_ops_per_step": sum(v[0] for v in kern.values())
            / MOE_PROFILED,
            "launches": launches, "card": card_line()}
        log(f"{tag} {json.dumps(reports[graph])}")
        ex.close()
        del ex, fd
        torch.cuda.empty_cache()
    sp, de = reports["sparse"], reports["dense"]
    log(f"{tag} step p50 sparse {sp['step_ms_p50']:.3f} ms, dense "
        f"{de['step_ms_p50']:.3f} ms (dense / sparse "
        f"{de['step_ms_p50'] / sp['step_ms_p50']:.2f}); peak memory sparse "
        f"{sp['peak_mem_gib']:.3f} GiB, dense {de['peak_mem_gib']:.3f} GiB")
    return sp["launches"]


def moe_train_executor(ht, pm, tokens, sparse, device):
    """The MoE graph at ``tokens`` tokens (full widths) with fetches [loss,
    train op, every trainable variable's gradient, the routing maps (the
    sparse gate's token_of_slot and slot_of_token; the dense gate's
    dispatch tensor)]: (graph, variables, executor, feeds)."""
    g = pm.moe_graph(tokens, sparse)
    wrt = [n for n in ht.topo_sort([g["loss"]])
           if isinstance(n, ht.PlaceholderOp) and n.is_variable
           and n.trainable]
    train_op = ht.optim.AdamOptimizer(1e-3).minimize(g["loss"])
    fetches = [g["loss"], train_op] + ht.gradients(g["loss"], wrt) \
        + list(g["route"][:2 if sparse else 1])
    ex = ht.Executor({"train": fetches}, seed=0, device=device)
    return g, wrt, ex, pm.moe_feeds(g)


def load_all(ex, weights):
    """``ex.load_dict(weights)``, after checking every variable of ``ex``
    is in ``weights`` (load_dict skips unknown names silently)."""
    missing = set(ex.var_names.values()) - set(weights)
    if missing:
        raise AssertionError(f"weights lack variables {sorted(missing)}")
    ex.load_dict(weights)


def dense_token_of_slot(dispatch):
    """token_of_slot of a dense (s, e, c) dispatch tensor: the token whose
    one-hot sits in each slot, -1 for an empty slot."""
    flat = dispatch.reshape(dispatch.shape[0], -1)
    token = flat.argmax(0)
    return torch.where(flat.amax(0) > 0, token,
                       torch.full_like(token, -1)).to(torch.int32)


def route_gaps(x, wg, sot_a, sot_b, cap, k):
    """Why two routings of the same tokens differ: each token whose expert
    choice differs, with the gaps between its sorted gate probabilities
    (float64 from ``x`` and ``wg``), p1-p2 ... p_k-p_{k+1}; a near tie
    can flip a route between devices."""
    logits = x.astype(np.float64) @ wg.astype(np.float64)
    p = np.exp(logits - logits.max(1, keepdims=True))
    p = np.sort(p / p.sum(1, keepdims=True), axis=1)[:, ::-1]
    ea = np.where(sot_a >= 0, sot_a // cap, -1)
    eb = np.where(sot_b >= 0, sot_b // cap, -1)
    diff = np.nonzero((ea != eb).any(1))[0]
    gaps = [f"token {t}: " + ", ".join(
        f"p{j + 1}-p{j + 2} {p[t, j] - p[t, j + 1]:.3e}" for j in range(k))
        for t in diff[:20]]
    return (f"{int((sot_a != sot_b).sum())} routes, expert choice of "
            f"{diff.size} tokens; {'; '.join(gaps) or 'no expert flip'}")


def phase_moe_parity(ht, pm):
    """Sparse vs dense graph on the card from one set of weights, 3 Adam
    steps; then the sparse graph on the card vs the CPU at 1,024 tokens."""
    gs, wrt, sex, fd = moe_train_executor(ht, pm, pm.TOKENS, True, "cuda")
    gd, _, dex, _ = moe_train_executor(ht, pm, pm.TOKENS, False, "cuda")
    load_all(dex, sex.return_tensor_values())
    fdd = {gd["x"]: fd[gs["x"]], gd["y"]: fd[gs["y"]]}
    nv = len(wrt)
    loss_err = grad_err = 0.0
    for step in range(3):
        a = [None if o is None else o.torch()
             for o in sex.run("train", feed_dict=fd)]
        b = [None if o is None else o.torch()
             for o in dex.run("train", feed_dict=fdd)]
        tos_s, tos_d = a[2 + nv], dense_token_of_slot(b[2 + nv])
        if not torch.equal(tos_s, tos_d):
            raise AssertionError(f"sparse vs dense routing differs at step "
                                 f"{step + 1}: {int((tos_s != tos_d).sum())} "
                                 f"slots")
        la, lb = float(a[0]), float(b[0])
        loss_err = max(loss_err, abs(la - lb) / abs(lb))
        if not (math.isfinite(la) and abs(la - lb) <= MOE_LOSS_RTOL * abs(lb)):
            raise AssertionError(f"sparse vs dense loss at step {step + 1}: "
                                 f"{la} vs {lb}")
        if step == 0:
            for node, ga, gb in zip(wrt, a[2:2 + nv], b[2:2 + nv]):
                grad_err = max(grad_err, float((ga - gb).abs().max()))
                if not torch.allclose(ga, gb, rtol=MOE_GRAD_RTOL,
                                      atol=MOE_GRAD_ATOL):
                    raise AssertionError(
                        f"sparse vs dense gradient of {node.name}: max err "
                        f"{float((ga - gb).abs().max())}")
    log(f"[moe-parity] sparse vs dense on the card, {pm.TOKENS} tokens, 3 Adam "
        f"steps: routing equal every step; loss max rel err {loss_err:.3e} "
        f"(rtol {MOE_LOSS_RTOL}); step-1 gradients of {nv} variables max abs "
        f"err {grad_err:.3e} (rtol {MOE_GRAD_RTOL}, atol {MOE_GRAD_ATOL})")
    for ex in (sex, dex):
        ex.close()
    del sex, dex, a, b, tos_d
    torch.cuda.empty_cache()

    # card vs CPU, the sparse graph cut to 1,024 tokens at full widths
    g, wrt, card, fd = moe_train_executor(ht, pm, MOE_CPU_TOKENS, True,
                                          "cuda")
    gh, _, host, _ = moe_train_executor(ht, pm, MOE_CPU_TOKENS, True, "cpu")
    load_all(host, card.return_tensor_values())
    fdh = {gh["x"]: fd[g["x"]], gh["y"]: fd[g["y"]]}
    wg_node = next(n for n, name in card.var_names.items()
                   if name == "topk_gate.wg")
    cap = g["gate"].capacity
    loss_err = grad_err = 0.0
    for step in range(3):
        wg = card.var_values[wg_node].cpu().numpy().astype(np.float64)
        got = card.run("train", feed_dict=fd, convert_to_numpy_ret_vals=True)
        want = host.run("train", feed_dict=fdh,
                        convert_to_numpy_ret_vals=True)
        sot_c, sot_h = got[-1], want[-1]
        if not (np.array_equal(got[-2], want[-2])
                and np.array_equal(sot_c, sot_h)):
            # a near tie between a token's top experts can flip one route
            # between the devices: name each differing token's gate gaps
            raise AssertionError(
                f"card vs CPU routing maps differ at step {step + 1}: "
                + route_gaps(fd[g["x"]], wg, sot_c, sot_h, cap,
                             sot_c.shape[1]))
        gl, wl = float(got[0]), float(want[0])
        loss_err = max(loss_err, abs(gl - wl) / abs(wl))
        if not (math.isfinite(gl)
                and abs(gl - wl) <= TRAIN_LOSS_RTOL * abs(wl)):
            raise AssertionError(f"card vs CPU MoE loss at step {step + 1}: "
                                 f"{gl} vs {wl}")
        if step == 0:
            for node, gc, gh_ in zip(wrt, got[2:], want[2:]):
                grad_err = max(grad_err, float(np.max(np.abs(gc - gh_))))
                if not np.allclose(gc, gh_, rtol=TRAIN_GRAD_RTOL,
                                   atol=TRAIN_GRAD_ATOL):
                    raise AssertionError(
                        f"card vs CPU gradient of {node.name}: max err "
                        f"{float(np.max(np.abs(gc - gh_)))}")
    log(f"[moe-parity] card vs CPU, sparse graph, {MOE_CPU_TOKENS} tokens at "
        f"full widths, 3 Adam steps: routing maps equal every step; loss max "
        f"rel err {loss_err:.3e} (rtol {TRAIN_LOSS_RTOL}); step-1 gradients "
        f"of {len(wrt)} variables max abs err {grad_err:.3e} (rtol "
        f"{TRAIN_GRAD_RTOL}, atol {TRAIN_GRAD_ATOL})")
    card.close()
    host.close()

# -- GPT-2: causal kernels, training, chunked-prefill serving ----------------------

def visible_pairs(bh, heads, s_q, s_kv, causal=False, key_mask=None,
                  mask=None, gmode=None, lengths=None):
    """Visible (row, key) pairs summed over the BH rows, counted from the
    inputs themselves: the work a masked attention function has to do."""
    valid = torch.ones(bh, s_q, s_kv, dtype=torch.bool, device="cuda")
    if causal:
        valid = valid.tril(s_kv - s_q)
    if lengths is not None:
        valid &= length_keys(lengths, s_kv).bool().repeat_interleave(
            heads, dim=0)[:, None, :]
    if key_mask is not None:
        valid &= (key_mask != 0).repeat_interleave(heads, dim=0)[:, None, :]
    if mask is not None:
        m = mask != 0
        valid &= {"one": lambda: m.expand(bh, s_q, s_kv),
                  "h": lambda: m.repeat(bh // heads, 1, 1),
                  "b": lambda: m.repeat_interleave(heads, dim=0),
                  "bh": lambda: m}[gmode]()
    return int(valid.sum())


def phase_causal_kernels(fa):
    """The causal forward / dQ / dK/dV kernels and the full-mask forward vs
    their plain versions at GPT-2 small attention shapes; times.  Returns
    the kernels-line entries {fwd, dq, dkv, mask} with the worst error
    over all cases."""
    F = torch.nn.functional
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    flush = flush_buf.zero_
    scale = 1.0 / math.sqrt(D)
    rng = np.random.RandomState(15)
    bh = GPT_BATCH * H

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda()

    km_np = (rng.rand(GPT_BATCH, GPT_SEQ) < 0.8).astype(np.int32)
    km_np[:, 0] = 1
    km_np[-1] = 0                          # a batch row with every key masked
    cases = [("causal", GPT_SEQ, GPT_SEQ, None),
             ("causal+key_mask", GPT_SEQ, GPT_SEQ, km_np),
             ("causal ragged", 200, 200, None),
             ("causal S_q<S_kv", 64, 200, None),
             ("causal S_q>S_kv", 200, 64, None),
             ("causal one row", 1, 130, None)]
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0, "mask": 0.0}
    lines = {}
    for name, s_q, s_kv, mask in cases:
        q, do = t(bh, s_q, D), t(bh, s_q, D)
        k, v = t(bh, s_kv, D), t(bh, s_kv, D)
        km = None if mask is None else torch.from_numpy(mask).cuda()
        # timings at the training shape
        err, row = attn_case(fa, "[causal-kernels]", name, q, k, v, do, H,
                             scale, km=km, causal=True,
                             flush=flush if s_q == GPT_SEQ else None)
        for kk in err:
            worst[kk] = max(worst[kk], err[kk])
        if name == "causal":
            lines.update(row)

    # -- the full-mask forward
    C, L = PREFILL_CHUNK, PREFILL_CACHE
    pos = rng.randint(0, L - C + 1, size=GPT_BATCH).astype(np.int32)
    pos[0], pos[1] = 0, L - C              # the emptiest and the fullest row
    positions = torch.from_numpy(pos).cuda()
    lengths = positions[:, None] + 1 + torch.arange(C, device="cuda")[None, :]
    real = (torch.arange(L, device="cuda")[None, None, :]
            < lengths[:, :, None])                           # (B, C, L)
    fcases = [("prefill, group b", "b", C, L, real.clone())]
    for gmode, s_q, s_kv in (("one", 77, 130), ("h", 32, 512),
                             ("bh", 64, 200), ("b", 1, 65)):
        g = fa._group_rows(gmode, bh, H)
        m = torch.from_numpy(rng.rand(g, s_q, s_kv) < 0.6).cuda()
        fcases.append((f"random, group {gmode}", gmode, s_q, s_kv, m))
    for name, gmode, s_q, s_kv, m in fcases:
        if not name.startswith("prefill"):
            m[0, 0] = False                # a row with every key masked
        mask = m.to(torch.uint8).contiguous()
        q = t(bh, s_q, D)
        k, v = t(bh, s_kv, D), t(bh, s_kv, D)
        before = fa.fwd_mask_launches
        out, lse = fa.flash_fwd_fullmask(q, k, v, mask, gmode, H, scale)
        ref, lse_ref = fa.flash_fwd_plain(q, k, v, None, H, scale, mask=mask,
                                          gmode=gmode)
        torch.cuda.synchronize()
        if fa.fwd_mask_launches != before + 1:
            raise AssertionError(f"full-mask forward ({name}) did not launch")
        err = max(float((out - ref).abs().max()),
                  float((lse - lse_ref).abs().max()))
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"full-mask fwd vs plain ({name}): {err}")
        if not name.startswith("prefill") and (
                float(out[0, 0].abs().max()) != 0.0
                or float(lse[0, 0]) != float(np.float32(fa.NEG_INF))):
            raise AssertionError(f"{name}: the fully masked row is not "
                                 f"out = 0, lse = -1e30")
        worst["mask"] = max(worst["mask"], err)
        log(f"[causal-kernels] full mask {name} B={GPT_BATCH} H={H} "
            f"S_q={s_q} S_kv={s_kv} D={D} max_abs_err={err:.3e}")
        if not name.startswith("prefill"):
            continue
        q4, k4, v4 = (x.view(GPT_BATCH, H, -1, D) for x in (q, k, v))
        smask = m.view(GPT_BATCH, 1, s_q, s_kv)
        row = {"ms": time_ms(lambda: fa.flash_fwd_fullmask(
                   q, k, v, mask, gmode, H, scale), flush=flush),
               "plain_ms": time_ms(lambda: fa.flash_fwd_plain(
                   q, k, v, None, H, scale, mask=mask, gmode=gmode),
                   flush=flush),
               "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                   q4, k4, v4, attn_mask=smask), flush=flush)}
        pairs = visible_pairs(bh, H, s_q, s_kv, mask=m, gmode=gmode)
        # K/V rows that some query of the chunk sees: below positions + C
        kv_rows = int((pos + C).sum()) * H
        row["bound_ms"], row["bound_by"] = attn_bound(
            "fwd", bh, s_q, s_kv, D, pairs, extra_bytes=mask.numel(),
            kv_rows=kv_rows)
        row["visible_pairs"] = pairs
        log(f"[causal-kernels] full mask {name} positions={pos.tolist()} "
            f"timing (library = SDPA attn_mask) {json.dumps(row)}")
        lines["mask"] = row
    # key tiles the float32 kernels skip: dead key-mask tails, S_q < S_kv
    s_q, s_kv = 300, 700
    km = torch.from_numpy((np.arange(s_kv)[None, :] < np.array(
        [700, 650, 400, 129, 64, 1, 300, 0])[:, None]).astype(np.int32)).cuda()
    err, _ = attn_case(fa, "[causal-kernels]",
                       "causal S_q<S_kv, dead key tiles", t(bh, s_q, D),
                       t(bh, s_kv, D), t(bh, s_kv, D), t(bh, s_q, D), H, scale,
                       km=km, causal=True)
    for kk in err:
        worst[kk] = max(worst[kk], err[kk])
    for kk in lines:
        lines[kk]["max_abs_err"] = worst[kk]
    return lines


def gpt2_step_flops(cfg):
    """Model FLOPs of one causal-LM training step (forward + backward = 3 x
    the forward's): matrix products 6 x tokens x (layers x (4 h^2 + 8 h^2)
    + h V) for the 12 blocks' q/k/v/o and MLP and ``lm_head``; attention
    6 x B x heads x S^2 x (h / heads) per layer, two S x S products with
    the causal half of the pairs counted."""
    h, v, n = cfg.n_embd, cfg.vocab_size, cfg.n_layer
    s, b = cfg.seq_len, cfg.batch_size
    dense = n * 12 * h * h + h * v
    attn = 6.0 * b * cfg.n_head * s * s * (h // cfg.n_head) * n
    return 6.0 * b * s * dense + attn


def phase_gpt2_train(ht, fa, metrics, kmods):
    """GPT-2 small causal-LM training steps through Executor.run on the
    card.  Returns (launches, the trained weights by name)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()     # what earlier phases still hold
    cfg = ht.GPT2Config.small(batch_size=GPT_BATCH, seq_len=GPT_SEQ)
    feeds, loss, _ = ht.gpt2_lm_graph(cfg)
    train_op = ht.optim.AdamOptimizer(1e-4).minimize(loss)
    t0 = time.perf_counter()
    ex = ht.Executor({"train": [loss, train_op]}, seed=0, device="cuda")
    log(f"[gpt2-train] GPT-2 small executor built in "
        f"{time.perf_counter() - t0:.1f} s")
    ids, labels = ht.synthetic_lm_batch(cfg, seed=0)
    fd = {feeds["input_ids"]: ids, feeds["labels"]: labels}
    losses = []
    for _ in range(GPT_WARMUP):
        losses.append(float(ex.run("train", feed_dict=fd)[0].asnumpy()))
    torch.cuda.synchronize()
    reset_launches(*kmods)
    metrics.reset_flash_fallbacks()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(GPT_STEPS):
        t0 = time.perf_counter()
        out = ex.run("train", feed_dict=fd)
        losses.append(float(out[0].asnumpy()))     # waits for the step
        times.append(time.perf_counter() - t0)
    launches = {"flash_fwd_causal": fa.fwd_causal_launches,
                "flash_bwd_dq_causal": fa.dq_causal_launches,
                "flash_bwd_dkv_causal": fa.dkv_causal_launches}
    others = {name: n for m in kmods for name, n in vars(m).items()
              if name.endswith("launches") and n
              and not (m is fa and name.endswith("causal_launches"))}
    fallbacks = metrics.flash_fallback_counts()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite GPT-2 training loss: {losses}")
    if not losses[-1] < losses[GPT_WARMUP]:
        raise AssertionError(f"GPT-2 loss did not fall over the counted "
                             f"steps: {losses}")
    want = GPT_STEPS * cfg.n_layer
    if any(n != want for n in launches.values()):
        raise AssertionError(f"causal kernel launches {launches} != steps "
                             f"{GPT_STEPS} x layers {cfg.n_layer}")
    if others:
        raise AssertionError(f"other kernels launched: {others}")
    left = {r: n for r, n in fallbacks.items() if r.startswith("backend:")}
    if left:
        raise AssertionError(f"attention left the kernels: {left}")
    ms = np.asarray(times) * 1e3
    tokens = cfg.batch_size * cfg.seq_len
    flops = gpt2_step_flops(cfg)
    report = {
        "batch": cfg.batch_size, "seq": cfg.seq_len, "steps": GPT_STEPS,
        "losses": losses, "step_ms_p50": float(np.percentile(ms, 50)),
        "step_ms_p99": float(np.percentile(ms, 99)),
        "step_ms_mean": float(ms.mean()),
        "tokens_per_s": tokens / (ms.mean() / 1e3),
        "model_tflop_per_step": flops / 1e12,
        "mfu_fp32": flops / (ms.mean() / 1e3) / PEAK_FP32_FLOPS,
        "peak_mem_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
        "launches": launches, "card": card_line()}
    log(f"[gpt2-train] {json.dumps(report)}")
    weights = ex.return_tensor_values()
    ex.close()
    del ex, out
    torch.cuda.empty_cache()
    return launches, weights


def phase_gpt2_train_parity(ht):
    """GPT-2 small widths cut to 2 layers: card vs CPU over 3 Adam steps
    from the same weights; losses and step-1 gradients agree."""
    cfg = ht.GPT2Config.small(n_layer=2, batch_size=4, seq_len=128,
                              resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    feeds, loss, _ = ht.gpt2_lm_graph(cfg)
    wrt = [n for n in ht.topo_sort([loss])
           if isinstance(n, ht.PlaceholderOp) and n.is_variable
           and n.trainable]
    grads = ht.gradients(loss, wrt)
    train_op = ht.optim.AdamOptimizer(1e-4).minimize(loss)
    fetches = {"train": [loss, train_op] + grads}
    card = ht.Executor(fetches, seed=0, device="cuda")
    host = ht.Executor(fetches, seed=0, device="cpu")
    load_all(host, card.return_tensor_values())
    ids, labels = ht.synthetic_lm_batch(cfg, seed=0)
    labels = labels.copy()
    labels[:, -7:] = -1                   # ignored positions
    fd = {feeds["input_ids"]: ids, feeds["labels"]: labels}
    loss_err, grad_err = 0.0, 0.0
    for step in range(3):
        got = card.run("train", feed_dict=fd, convert_to_numpy_ret_vals=True)
        want = host.run("train", feed_dict=fd,
                        convert_to_numpy_ret_vals=True)
        gl, wl = float(got[0]), float(want[0])
        loss_err = max(loss_err, abs(gl - wl) / abs(wl))
        if not (math.isfinite(gl) and abs(gl - wl) <= TRAIN_LOSS_RTOL * abs(wl)):
            raise AssertionError(f"card vs CPU GPT-2 loss at step "
                                 f"{step + 1}: {gl} vs {wl}")
        if step == 0:
            for node, g, w in zip(wrt, got[2:], want[2:]):
                grad_err = max(grad_err, float(np.max(np.abs(g - w))))
                if not np.allclose(g, w, rtol=TRAIN_GRAD_RTOL,
                                   atol=TRAIN_GRAD_ATOL):
                    raise AssertionError(
                        f"card vs CPU gradient of {node.name}: max err "
                        f"{float(np.max(np.abs(g - w)))}")
    log(f"[gpt2-train-parity] card vs CPU, {cfg.n_layer} layers, 3 Adam "
        f"steps: loss max rel err {loss_err:.3e} (rtol {TRAIN_LOSS_RTOL}); "
        f"step-1 gradients of {len(wrt)} variables max abs err "
        f"{grad_err:.3e} (rtol {TRAIN_GRAD_RTOL}, atol {TRAIN_GRAD_ATOL})")
    card.close()
    host.close()


def chunked_teacher_forced(engine, tokens, chunk):
    """One sequence through the engine's chunked step at batch 1 in pieces
    of ``chunk`` tokens: ({position of each piece's last token: logits},
    the caches)."""
    iex, fk = engine.ciex, engine._cfk
    fn = iex.compiled(1)
    L = next(b for b in engine.len_ladder if b >= len(tokens) + chunk)
    caches = {n: engine._alloc(1, L) for n in engine.cache_names}
    out = {}
    for t in range(0, len(tokens), chunk):
        piece = tokens[t:t + chunk]
        ids = np.zeros((1, chunk), np.int32)
        ids[0, :len(piece)] = piece
        feeds = {
            fk["input_ids"]: torch.from_numpy(ids).to(engine.device),
            fk["positions"]: torch.tensor([t], dtype=torch.int32,
                                          device=engine.device),
            fk["valid"]: torch.tensor([len(piece)], dtype=torch.int32,
                                      device=engine.device)}
        feeds.update({fk[n]: caches[n] for n in engine.cache_names})
        out[t + len(piece) - 1] = fn(iex.params, feeds)[0][0].cpu().numpy()
    return out, caches


class DecodeCalls:
    """While open, records the decode kernel's calls (every call of
    ``fa.flash_fwd``, which the decode attention reaches through
    ``flash_attention``): how many, how many of them the split plan gives
    more than one split (each launches the merge kernel), and for each
    (BH, S_q, S_kv) shape its calls and the lengths of its last call (the
    tensor itself, read after the run: no host sync during it)."""

    def __init__(self, fa):
        self.fa, self.inner = fa, fa.flash_fwd
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.reset()

    def reset(self):
        self.calls = self.split_calls = 0
        self.shapes = {}

    def __enter__(self):
        def flash_fwd(q, k, v, lengths, heads, scale, **kw):
            shape = (q.shape[0], q.shape[1], k.shape[1])
            n_split, _ = self.fa.decode_split_plan(*shape, self.sms)
            self.calls += 1
            self.split_calls += n_split > 1
            self.shapes[shape] = (self.shapes.get(shape, (0,))[0] + 1,
                                  lengths)
            return self.inner(q, k, v, lengths, heads, scale, **kw)

        self.fa.flash_fwd = flash_fwd
        return self

    def __exit__(self, *exc):
        self.fa.flash_fwd = self.inner

    def check(self, fa, tag):
        """The decode kernel launched once a call and its merge once a call
        whose plan has more than one split."""
        if fa.launches != self.calls or fa.merge_launches != self.split_calls:
            raise AssertionError(
                f"{tag}: lengths launches {fa.launches} / merge launches "
                f"{fa.merge_launches} != calls {self.calls} / calls with more "
                f"than one split {self.split_calls}")


def serve_streams(ht, metrics, kmods, engine, prompts, calls=None):
    """The prompts through ``DecodeRouter``; counters (and ``calls``, a
    :class:`DecodeCalls`) set to 0 just before and read just after.
    Returns (token streams, report)."""
    with ht.DecodeRouter(engine, queue_limit=len(prompts)) as router:
        # warm-up (cuBLAS handles, allocator) before the counted run
        router.submit(prompts[1][:40], max_new_tokens=2).result(timeout=300)
        torch.cuda.synchronize()
        reset_launches(*kmods)
        if calls is not None:
            calls.reset()
        metrics.reset_decode_counts()
        metrics.reset_flash_fallbacks()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        streams = [router.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
        results = [s.result(timeout=900) for s in streams]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = metrics.decode_counts()
    lat = metrics.decode_latency_stats()
    n_tok = counts.get("decode_tokens", 0)
    report = {k: counts.get(k, 0) for k in (
        "decode_steps", "decode_prefill_steps", "decode_prefill_steps_saved",
        "decode_prefill_rows", "decode_logits_skipped")}
    report.update({
        "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
        "ttft_p50_ms": lat["ttft"]["p50"] / 1e3,
        "ttft_p99_ms": lat["ttft"]["p99"] / 1e3,
        "step_p50_ms": lat["step"]["p50"] / 1e3,
        "step_p99_ms": lat["step"]["p99"] / 1e3,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "kv_cache_len": engine.lb})
    return results, report


def phase_gpt2_serve(ht, fa, metrics, kmods, trained, prompts):
    """The trained GPT-2 small weights, by name, behind a chunked-prefill
    engine and a one-token engine on the card."""
    cfg = ht.GPT2Config.small()
    graph = ht.gpt2_decode_graph(cfg, max_len=cfg.n_positions)
    cgraph = ht.gpt2_decode_chunked_graph(cfg, max_len=cfg.n_positions,
                                          chunk=PREFILL_CHUNK)

    def engine(device, chunked, slots=N_REQUESTS):
        with warnings.catch_warnings():
            warnings.simplefilter("error")   # a variable not found would warn
            return ht.DecodeEngine(
                *graph[:3], weights=ht.params_from_named_arrays(trained,
                                                                device),
                max_slots=slots, max_len=cfg.n_positions, device=device,
                chunked=cgraph[:3] if chunked else None,
                max_chunk=PREFILL_CHUNK if chunked else None)

    ceng, oeng = engine("cuda", True), engine("cuda", False)
    extra = set(trained) - set(oeng.iex.var_names.values())
    if extra != {"gpt2.pos_ids"}:
        raise AssertionError(f"names the decode graphs lack: {sorted(extra)}")

    # -- the counted chunked run, then the one-token run
    with DecodeCalls(fa) as calls:
        got, crep = serve_streams(ht, metrics, kmods, ceng, prompts, calls)
        calls.check(fa, "chunked engine")
        launches = {"flash_fwd_mask": fa.fwd_mask_launches,
                    "flash_fwd_lengths": fa.launches,
                    "flash_fwd_lengths_merge": fa.merge_launches}
        others = {name: n for m in kmods for name, n in vars(m).items()
                  if name.endswith("launches") and n and not (
                      m is fa and name in ("fwd_mask_launches", "launches",
                                           "merge_launches"))}
        fallbacks = metrics.flash_fallback_counts()
        want, orep = serve_streams(ht, metrics, kmods, oeng, prompts, calls)
        calls.check(fa, "one-token engine")
    if fa.launches != orep["decode_steps"] * cfg.n_layer:
        raise AssertionError("one-token engine: lengths launches "
                             f"{fa.launches} != steps x layers")
    fallbacks.update(metrics.flash_fallback_counts())
    crep["launches"] = launches
    for rep in (crep, orep):
        rep["card"] = card_line()
    log(f"[gpt2-serve] chunked (max_chunk {PREFILL_CHUNK}): "
        f"{json.dumps(crep)}")
    log(f"[gpt2-serve] one-token: {json.dumps(orep)}")
    psteps, steps = crep["decode_prefill_steps"], crep["decode_steps"]
    if launches["flash_fwd_mask"] != psteps * cfg.n_layer or psteps == 0:
        raise AssertionError(f"full-mask launches {launches} != prefill "
                             f"steps {psteps} x n_layer {cfg.n_layer}")
    if launches["flash_fwd_lengths"] != (steps - psteps) * cfg.n_layer \
            or steps == psteps:
        raise AssertionError(f"lengths launches {launches} != one-token "
                             f"steps {steps - psteps} x n_layer")
    if others:
        raise AssertionError(f"other kernels launched: {others}")
    if crep["decode_prefill_steps_saved"] <= 0 or steps >= orep["decode_steps"]:
        raise AssertionError(f"chunked prefill saved no step: {crep} vs "
                             f"{orep}")
    left = {r: n for r, n in fallbacks.items() if r.startswith("backend:")}
    if left:
        raise AssertionError(f"attention left the kernels: {left}")
    for i, toks in enumerate(got):
        if len(toks) != MAX_NEW or not all(0 <= x < cfg.vocab_size
                                           for x in toks):
            raise AssertionError(f"chunked stream {i} returned {toks}")

    # -- greedy streams: equal, or apart only from a near tie
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        at = next(j for j in range(MAX_NEW) if a[j] != b[j])
        seq = list(prompts[i]) + list(b[:at])
        row = np.sort(teacher_forced_logits(oeng, seq)[-1])
        gap = float(row[-1] - row[-2])
        log(f"[gpt2-serve] stream {i} differs from generated token {at}: "
            f"chunked {a[at]} vs one-token {b[at]}; one-token top-2 logit "
            f"gap {gap:.3e}")
        if not gap < 2 * LOGITS_ATOL:
            raise AssertionError(
                f"stream {i}: chunked and one-token engines differ at token "
                f"{at} with a top-2 gap of {gap} >= {2 * LOGITS_ATOL}")
    same = sum(a == b for a, b in zip(got, want))
    log(f"[gpt2-serve] greedy streams chunked vs one-token: {same}/"
        f"{len(got)} equal; first stream {got[0][:8]}...")

    # -- one 300-token prompt: chunked vs token by token, card vs CPU
    tokens = [int(x) for x in prompts[0]]
    one = teacher_forced_logits(oeng, tokens)
    chk, ccaches = chunked_teacher_forced(ceng, tokens, PREFILL_CHUNK)
    heng = engine("cpu", True, 1)
    cpu, hcaches = chunked_teacher_forced(heng, tokens, PREFILL_CHUNK)
    err_one = max(float(np.max(np.abs(chk[p] - one[p]))) for p in chk)
    err_cpu = max(float(np.max(np.abs(chk[p] - cpu[p]))) for p in chk)
    n = len(tokens)
    err_kv = max(float((ccaches[name][:, :, :n].cpu()
                        - hcaches[name][:, :, :n]).abs().max())
                 for name in ceng.cache_names)
    agree = sum(int(chk[p].argmax() == one[p].argmax()) for p in chk)
    log(f"[gpt2-serve] {n}-token prompt, logits at the {len(chk)} chunk "
        f"ends: chunked vs token by token on the card max_abs_err="
        f"{err_one:.3e}; chunked card vs CPU max_abs_err={err_cpu:.3e} "
        f"(atol {LOGITS_ATOL}); KV caches card vs CPU max_abs_err="
        f"{err_kv:.3e}; argmax agree {agree}/{len(chk)}")
    if not (all(np.all(np.isfinite(x)) for x in chk.values())
            and max(err_one, err_cpu, err_kv) <= LOGITS_ATOL):
        raise AssertionError(f"chunked prefill logits disagree: vs one-token "
                             f"{err_one}, vs CPU {err_cpu}, caches {err_kv}")
    return launches


# -- T5: bias kernels, seq2seq training ---------------------------------------------

def phase_bias_kernels(ht, fa):
    """The bias forward / dQ (dbias) / dK/dV (dkbias) kernels vs their
    plain versions at T5-small attention shapes, and the key-mask kernels
    at the cross-attention's; times.  Returns the kernels-line entries
    {fwd, dq, dkv} + suffix, each with the worst error over all cases of
    its instantiation: no suffix for the encoder's dense bias, ``_causal``
    for the decoder's, ``_kbias`` for the key-bias strip, ``_cross`` for
    the cross-attention's key-mask kernels."""
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    rng = np.random.RandomState(18)
    cfg = ht.T5Config.small(batch_size=T5_BATCH, src_len=T5_SRC,
                            tgt_len=T5_TGT)
    heads, dh = cfg.num_heads, cfg.d_model // cfg.num_heads
    bh = T5_BATCH * heads
    attn = ht.synthetic_seq2seq_batch(cfg, seed=0, padded=True)[3].copy()
    attn[-1] = 0                          # a batch row with every key masked
    # key tiles the float32 kernels skip: dead tails and a dead tile inside
    dead = (np.arange(450)[None, :] < np.random.RandomState(181).randint(
        1, 451, size=T5_BATCH)[:, None]).astype(np.int32)
    dead[:, 64:128] = 0

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda()

    # (name, S_q, S_kv, causal, key mask, bias kind, gmode, suffix, timed)
    cases = [("encoder", T5_SRC, T5_SRC, False, attn, "bias", "h", "", True),
             ("decoder", T5_TGT, T5_TGT, True, None, "bias", "h", "_causal",
              True),
             ("cross-attention", T5_TGT, T5_SRC, False, attn, None, None,
              "_cross", True),
             ("rows that see no key", 200, 64, True, None, "bias", "bh",
              "_causal", False),
             ("one row, group b", 1, 130, False, attn[:, :130], "bias", "b",
              "", False),
             ("key-bias strip", T5_SRC, T5_SRC, True, None, "kbias", "b",
              "_kbias", True),
             ("key-bias strip ragged", 114, 200, False, attn[:, :200],
              "kbias", "one", "_kbias", False),
             ("dead key tiles, group h", 150, 450, False, dead, "bias", "h",
              "", False)]
    worst = {}
    lines = {}
    for name, s_q, s_kv, causal, mask, kind, gmode, sfx, timed in cases:
        q, do = t(bh, s_q, dh), t(bh, s_q, dh)
        k, v = t(bh, s_kv, dh), t(bh, s_kv, dh)
        bias = kbias = None
        if kind is not None:
            x = t(fa._group_rows(gmode, bh, heads),
                  s_q if kind == "bias" else 1, s_kv)
            bias, kbias = (x, None) if kind == "bias" else (None, x)
        km = None if mask is None else torch.from_numpy(
            np.ascontiguousarray(mask, np.int32)).cuda()
        err, row = attn_case(fa, "[bias-kernels]", name, q, k, v, do, heads,
                             T5_KERNEL_SCALE, km=km, causal=causal,
                             bias=bias, kbias=kbias, gmode=gmode or "bh",
                             flush=flush_buf.zero_ if timed else None)
        for kk, e in err.items():
            worst[kk + sfx] = max(worst.get(kk + sfx, 0.0), e)
        if row is not None:
            for kk, r in row.items():
                lines[kk + sfx] = r
    for kk in lines:
        lines[kk]["max_abs_err"] = worst[kk]
    return lines


def _t5_feeds(feeds, batch):
    keys = ("input_ids", "decoder_input_ids", "labels", "attention_mask")
    return {feeds[k]: v for k, v in zip(keys, batch)}


def t5_step_flops(cfg):
    """Model FLOPs of one seq2seq training step by ``bert_step_flops``'s
    convention (forward + backward = 3 x the forward's, 2 a multiply-add):
    products 6 x (source tokens x layers x (4 d^2 + 2 d f) [encoder] +
    target tokens x layers x (6 d^2 + 2 d f) [decoder self q/k/v/o, cross
    q/o, FFN] + source tokens x layers x 2 d^2 [cross k/v over the memory]
    + target tokens x d V [lm_head]); attention 12 x B x heads x S_q x
    S_kv x (d / heads) per layer for the encoder and the cross-attention
    (counted dense) and 6 x ... for the causal decoder self-attention
    (half the pairs)."""
    d, f, v, n = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.num_layers
    b, s, t = cfg.batch_size, cfg.src_len, cfg.tgt_len
    ns, nt = b * s, b * t
    dense = ns * n * (4 * d * d + 2 * d * f) + nt * n * (6 * d * d + 2 * d * f) \
        + ns * n * 2 * d * d + nt * d * v
    hd = cfg.num_heads * (d // cfg.num_heads)
    attn = n * b * hd * (12.0 * s * s + 6.0 * t * t + 12.0 * t * s)
    return 6.0 * dense + attn


def phase_t5_train(ht, fa, metrics, kmods):
    """T5-small seq2seq training steps through Executor.run on the card.
    Returns the launches of the bias kernels (and the key-mask kernels the
    cross-attention takes) over the counted steps."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()     # what earlier phases still hold
    cfg = ht.T5Config.small(batch_size=T5_BATCH, src_len=T5_SRC,
                            tgt_len=T5_TGT)
    feeds, loss, _ = ht.t5_seq2seq_graph(cfg, use_mask=True)
    train_op = ht.optim.AdamOptimizer(1e-4).minimize(loss)
    t0 = time.perf_counter()
    ex = ht.Executor({"train": [loss, train_op]}, seed=0, device="cuda")
    log(f"[t5-train] T5-small executor built in "
        f"{time.perf_counter() - t0:.1f} s")
    batch = ht.synthetic_seq2seq_batch(cfg, seed=0, padded=True)
    fd = _t5_feeds(feeds, batch)
    losses = []
    for _ in range(T5_WARMUP):
        losses.append(float(ex.run("train", feed_dict=fd)[0].asnumpy()))
    torch.cuda.synchronize()
    reset_launches(*kmods)
    metrics.reset_flash_fallbacks()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(T5_STEPS):
        t0 = time.perf_counter()
        out = ex.run("train", feed_dict=fd)
        losses.append(float(out[0].asnumpy()))     # waits for the step
        times.append(time.perf_counter() - t0)
    launches = {"flash_fwd_bias": fa.fwd_bias_launches,
                "flash_bwd_dq_bias": fa.dq_bias_launches,
                "flash_bwd_dkv_bias": fa.dkv_bias_launches,
                "flash_fwd_bias_causal": fa.fwd_bias_causal_launches,
                "flash_bwd_dq_bias_causal": fa.dq_bias_causal_launches,
                "flash_bwd_dkv_bias_causal": fa.dkv_bias_causal_launches,
                "flash_fwd": fa.fwd_launches,
                "flash_bwd_dq": fa.dq_launches,
                "flash_bwd_dkv": fa.dkv_launches}
    counted = {"fwd_bias_launches", "dq_bias_launches", "dkv_bias_launches",
               "fwd_bias_causal_launches", "dq_bias_causal_launches",
               "dkv_bias_causal_launches", "fwd_launches", "dq_launches",
               "dkv_launches"}
    others = {name: n for m in kmods for name, n in vars(m).items()
              if name.endswith("launches") and n
              and not (m is fa and name in counted)}
    fallbacks = metrics.flash_fallback_counts()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite T5 training loss: {losses}")
    if not losses[-1] < losses[T5_WARMUP]:
        raise AssertionError(f"T5 loss did not fall over the counted steps: "
                             f"{losses}")
    want = T5_STEPS * cfg.num_layers
    if any(n != want for n in launches.values()):
        raise AssertionError(f"T5 attention launches {launches} != steps "
                             f"{T5_STEPS} x layers {cfg.num_layers} each")
    if others:
        raise AssertionError(f"other kernels launched: {others}")
    left = {r: n for r, n in fallbacks.items() if r.startswith("backend:")}
    if left:
        raise AssertionError(f"attention left the kernels: {left}")
    # off the path: the key-bias strip (0, as ``others`` just checked)
    launches.update({"flash_fwd_kbias": fa.fwd_kbias_launches,
                     "flash_bwd_dq_kbias": fa.dq_kbias_launches,
                     "flash_bwd_dkv_kbias": fa.dkv_kbias_launches})
    ms = np.asarray(times) * 1e3
    mean_s = ms.mean() / 1e3
    src_real = int(batch[3].sum())
    flops = t5_step_flops(cfg)
    report = {
        "batch": cfg.batch_size, "src_len": cfg.src_len,
        "tgt_len": cfg.tgt_len, "steps": T5_STEPS, "losses": losses,
        "step_ms_p50": float(np.percentile(ms, 50)),
        "step_ms_p99": float(np.percentile(ms, 99)),
        "step_ms_mean": float(ms.mean()),
        "tokens_per_s": cfg.batch_size * (cfg.src_len + cfg.tgt_len) / mean_s,
        "tgt_tokens_per_s": cfg.batch_size * cfg.tgt_len / mean_s,
        "real_tokens_per_s": (src_real + cfg.batch_size * cfg.tgt_len)
        / mean_s,
        "src_real_tokens": src_real,
        "model_tflop_per_step": flops / 1e12,
        "mfu_fp32": flops / mean_s / PEAK_FP32_FLOPS,
        "peak_mem_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
        "launches_per_step": {k: n / T5_STEPS for k, n in launches.items()},
        "card": card_line()}
    log(f"[t5-train] {json.dumps(report)}")
    ex.close()
    del ex, out
    torch.cuda.empty_cache()
    return launches


def phase_t5_train_parity(ht):
    """T5-small widths cut to 2 + 2 layers (batch 4, source 128 padded,
    target 50, dropout 0): card vs CPU over 3 Adam steps from the same
    weights; losses and step-1 gradients of every variable agree.  The
    query projections are scaled by 1/8 in both, so the unscaled logits
    are O(1) as under T5's own init (tests/test_torch_t5.py says why)."""
    cfg = ht.T5Config.small(num_layers=2, batch_size=4, src_len=128,
                            tgt_len=50, dropout_rate=0.0)
    feeds, loss, _ = ht.t5_seq2seq_graph(cfg, use_mask=True)
    wrt = [n for n in ht.topo_sort([loss])
           if isinstance(n, ht.PlaceholderOp) and n.is_variable
           and n.trainable]
    grads = ht.gradients(loss, wrt)
    train_op = ht.optim.AdamOptimizer(1e-4).minimize(loss)
    fetches = {"train": [loss, train_op] + grads}
    card = ht.Executor(fetches, seed=0, device="cuda")
    host = ht.Executor(fetches, seed=0, device="cpu")
    weights = {n: w / 8 if n.endswith(".q.weight") else w
               for n, w in card.return_tensor_values().items()}
    load_all(card, weights)
    load_all(host, weights)
    fd = _t5_feeds(feeds, ht.synthetic_seq2seq_batch(cfg, seed=1,
                                                     padded=True))
    loss_err, grad_err = 0.0, 0.0
    for step in range(3):
        got = card.run("train", feed_dict=fd, convert_to_numpy_ret_vals=True)
        want = host.run("train", feed_dict=fd,
                        convert_to_numpy_ret_vals=True)
        gl, wl = float(got[0]), float(want[0])
        loss_err = max(loss_err, abs(gl - wl) / abs(wl))
        if not (math.isfinite(gl) and abs(gl - wl) <= TRAIN_LOSS_RTOL * abs(wl)):
            raise AssertionError(f"card vs CPU T5 loss at step {step + 1}: "
                                 f"{gl} vs {wl}")
        if step == 0:
            for node, g, w in zip(wrt, got[2:], want[2:]):
                grad_err = max(grad_err, float(np.max(np.abs(g - w))))
                if not np.allclose(g, w, rtol=TRAIN_GRAD_RTOL,
                                   atol=TRAIN_GRAD_ATOL):
                    raise AssertionError(
                        f"card vs CPU gradient of {node.name}: max err "
                        f"{float(np.max(np.abs(g - w)))}")
    log(f"[t5-train-parity] card vs CPU, {cfg.num_layers} + "
        f"{cfg.num_layers} layers, 3 Adam steps: loss max rel err "
        f"{loss_err:.3e} (rtol {TRAIN_LOSS_RTOL}); step-1 gradients of "
        f"{len(wrt)} variables (the relative-position tables included) max "
        f"abs err {grad_err:.3e} (rtol {TRAIN_GRAD_RTOL}, atol "
        f"{TRAIN_GRAD_ATOL})")
    card.close()
    host.close()


def phase_mask_kernels(ht, fa):
    """The full-mask kernels (forward, dQ, dK/dV), alone and with a bias
    or strip, vs their plain versions at the XLNet and Longformer paths'
    shapes, plus one causal case of each and the strip with a full mask at
    small shapes; times.  Returns the kernels-line entries {fwd, dq, dkv}
    + suffix, each with the worst error over all cases of its
    instantiation: ``_mask_bias`` (XLNet's content stream), ``_mask``
    (Longformer), ``_mask_kbias`` (the strip at XLNet's shape)."""
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    rng = np.random.RandomState(21)
    xcfg = ht.XLNetConfig.base(batch_size=XL_BATCH, seq_len=XL_SEQ)
    heads = xcfg.n_head
    dh = xcfg.d_model // heads
    _, cmask, qmask, _ = ht.synthetic_plm_batch(xcfg, seed=0)
    lcfg = ht.LongformerConfig.base(batch_size=LF_BATCH, seq_len=LF_SEQ)
    wmask = ht.longformer_attention_mask(LF_SEQ, lcfg.attention_window,
                                         lcfg.num_global_tokens)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda()

    def u8(m):
        return torch.from_numpy(np.ascontiguousarray(m != 0, np.uint8)).cuda()

    def rand_mask(gmode, b, s_q, s_kv, sparse=False):
        m = rng.rand(fa._group_rows(gmode, b * heads, heads), s_q, s_kv) \
            < (0.05 if sparse else 0.5)
        if sparse:                         # tiles the float32 kernels skip
            m[:, :, 64:192] = False
            m[:, 64:128, :] = False
        m[0, 0] = False                    # a row the mask hides entirely
        return m

    # (name, B, S_q, S_kv, mask (G, S_q, S_kv), mask group, bias kind,
    # bias group, causal, key mask, suffix, timed)
    xs = XL_SEQ
    cases = [
        ("XLNet content stream", XL_BATCH, xs, xs, cmask[:, 0], "b", "bias",
         "h", False, False, "_mask_bias", True),
        ("XLNet query stream", XL_BATCH, xs, xs, qmask[:, 0], "b", "bias",
         "h", False, False, "_mask_bias", True),
        ("Longformer window", LF_BATCH, LF_SEQ, LF_SEQ, wmask[None], "one",
         None, None, False, False, "_mask", True),
        ("XLNet query stream, key-bias strip", XL_BATCH, xs, xs,
         qmask[:, 0], "b", "kbias", "one", False, False, "_mask_kbias",
         True),
        ("mask causal, key mask", 2, 200, 200, None, "bh", None, None, True,
         True, "_mask", False),
        ("mask + bias causal, S_q > S_kv", 2, 200, 64, None, "h", "bias",
         "bh", True, False, "_mask_bias", False),
        ("mask + strip causal, key mask", 2, 77, 130, None, "one", "kbias",
         "b", True, True, "_mask_kbias", False),
        ("sparse mask, empty tiles", 2, 300, 520, "sparse", "bh", None, None,
         False, True, "_mask", False),
        ("sparse mask + bias, empty tiles", 2, 200, 333, "sparse", "b",
         "bias", "h", False, False, "_mask_bias", False)]
    worst, lines = {}, {}
    for (name, b, s_q, s_kv, m, mg, kind, bg, causal, keyed, sfx,
         timed) in cases:
        bh = b * heads
        q, do = t(bh, s_q, dh), t(bh, s_q, dh)
        k, v = t(bh, s_kv, dh), t(bh, s_kv, dh)
        mask = u8(rand_mask(mg, b, s_q, s_kv, sparse=m is not None)
                  if m is None or isinstance(m, str) else m)
        bias = kbias = None
        if kind is not None:
            x = t(fa._group_rows(bg, bh, heads),
                  s_q if kind == "bias" else 1, s_kv)
            bias, kbias = (x, None) if kind == "bias" else (None, x)
        km = None
        if keyed:
            kmn = (rng.rand(b, s_kv) < 0.7).astype(np.int32)
            kmn[0, 0] = 1
            km = torch.from_numpy(kmn).cuda()
        err, row = attn_case(fa, "[mask-kernels]", name, q, k, v, do, heads,
                             XL_SCALE, km=km, causal=causal, bias=bias,
                             kbias=kbias, gmode=bg or "bh",
                             flush=flush_buf.zero_ if timed else None,
                             mask=mask, mask_gmode=mg)
        for kk, e in err.items():
            worst[kk + sfx] = max(worst.get(kk + sfx, 0.0), e)
        for kk in ("fwd", "dq", "dkv") if name.startswith("Longformer") \
                else ():
            if row[kk]["walked_tiles"] > row[kk]["tiles"] / 4:
                raise AssertionError(f"{name}: {kk} walks "
                                     f"{row[kk]['walked_tiles']} of "
                                     f"{row[kk]['tiles']} tiles, more than "
                                     f"a quarter")
        if row is not None and "fwd" + sfx not in lines:
            for kk, r in row.items():
                lines[kk + sfx] = r
        del q, k, v, do, mask, bias, kbias
        torch.cuda.empty_cache()
    for kk in lines:
        lines[kk]["max_abs_err"] = worst[kk]
    return lines


def attn_pairs(masks):
    """Visible (row, key) pairs of every (b, h) summed, over a list of
    (mask (G, S, S) numpy 0/1, copies): each mask counted once per head
    and batch row it reaches."""
    return float(sum(int(np.count_nonzero(m)) * n for m, n in masks))


def walked_pairs(fa, m):
    """(row, key) pairs a (b*h) of the float32 kernels walks, on average,
    for a mask (S, S) or (B, ..., S, S) nonzero where visible: the tiles
    ``fa.walked_tiles`` lists times 64 x 64."""
    m = np.asarray(m != 0, np.uint8)
    m = m.reshape(-1, *m.shape[-2:])
    g, s_q, s_kv = m.shape
    walk = fa.walked_tiles(g, 1, s_q, s_kv, mask=torch.from_numpy(m))
    return float(walk.sum()) * fa.TILE * fa.TILE / g


def xlnet_step_flops(cfg, cmask, qmask):
    """Model FLOPs of one permutation-LM training step by
    ``bert_step_flops``'s convention, for the graph as it runs: per token
    and layer the k / v projections of the content stream, q / o of both
    streams and both streams' FFN, except the last layer's content stream
    (q, o, FFN, attention), which the loss does not reach; the lm head on
    the query stream.  Attention 12 x (d / heads) per visible pair of the
    2 L - 1 streams that run (``dense``: every pair)."""
    d, di, v, n = cfg.d_model, cfg.d_inner, cfg.vocab_size, cfg.n_layer
    tokens = cfg.batch_size * cfg.seq_len
    per_layer = 2 * d * d + 2 * (2 * d * d + 2 * d * di)
    dead = 2 * d * d + 2 * d * di        # the last layer's content stream
    products = 6.0 * tokens * (n * per_layer - dead + d * v)
    hd = cfg.d_model // cfg.n_head
    h = cfg.n_head
    vis = 12.0 * hd * h * ((n - 1) * attn_pairs([(cmask, 1)])
                           + n * attn_pairs([(qmask, 1)]))
    dense = 12.0 * hd * h * (2 * n - 1) * tokens * cfg.seq_len
    return products + vis, products + dense


def longformer_step_flops(cfg, wmask):
    """Model FLOPs of one MLM training step by ``bert_step_flops``'s
    convention: per token and layer q, k, v, q_global, o and the FFN, the
    MLM head; attention 12 x (d / heads) per visible pair of the window
    mask in every layer (``dense``: every pair)."""
    d, di, v, n = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                   cfg.num_hidden_layers)
    tokens = cfg.batch_size * cfg.seq_len
    products = 6.0 * tokens * (n * (5 * d * d + 2 * d * di) + d * v)
    hd = d // cfg.num_attention_heads
    per = 12.0 * hd * cfg.num_attention_heads * n * cfg.batch_size
    return (products + per * attn_pairs([(wmask, 1)]),
            products + per * cfg.seq_len * cfg.seq_len)


def line_name(counter):
    """The kernels-line name of a flash launch counter
    (``dq_mask_bias_launches`` -> ``flash_bwd_dq_mask_bias``,
    ``bf16_fwd_causal_launches`` -> ``flash_fwd_causal_bf16``): profile_train's
    rule, which also names the kernels of a trace."""
    from hetu_tpu_torch.tools.profile_train import line_name as name
    return name(counter)


def train_path(fa, metrics, kmods, tag, ex, fd, steps, warmup, launches,
               want, flops, base, peak=("fp32", PEAK_FP32_FLOPS)):
    """``warmup`` + ``steps`` Adam steps of ``ex`` on ``fd``; the counted
    steps with every launch counter set to 0 just before and read just
    after.  ``launches`` names the counters of the path, each of which
    must read ``want``; every other counter must read 0 and no attention
    may take ``backend:cpu``; the loss must be finite and must not rise.
    ``base``: the device memory allocated before the executor was built;
    ``peak``: (name, FLOP/s) of the peak the MFU is taken against.
    Returns the report."""
    losses = [float(ex.run("train", feed_dict=fd)[0].asnumpy())
              for _ in range(warmup)]
    torch.cuda.synchronize()
    reset_launches(*kmods)
    metrics.reset_flash_fallbacks()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        out = ex.run("train", feed_dict=fd)
        losses.append(float(out[0].asnumpy()))     # waits for the step
        times.append(time.perf_counter() - t0)
    got = {name: getattr(fa, name) for name in launches}
    others = {name: n for m in kmods for name, n in vars(m).items()
              if name.endswith("launches") and n
              and not (m is fa and name in launches)}
    fallbacks = metrics.flash_fallback_counts()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag} non-finite training loss: {losses}")
    if not losses[-1] <= losses[warmup]:
        raise AssertionError(f"{tag} loss rose over the counted steps: "
                             f"{losses}")
    if any(n != want for n in got.values()):
        raise AssertionError(f"{tag} launches {got} != {want} each")
    if others:
        raise AssertionError(f"{tag} other kernels launched: {others}")
    left = {r: n for r, n in fallbacks.items() if r.startswith("backend:")}
    if left:
        raise AssertionError(f"{tag} attention left the kernels: {left}")
    ms = np.asarray(times) * 1e3
    mean_s = ms.mean() / 1e3
    vis, dense = flops
    return {"steps": steps, "losses": losses,
            "step_ms_p50": float(np.percentile(ms, 50)),
            "step_ms_p99": float(np.percentile(ms, 99)),
            "step_ms_mean": float(ms.mean()),
            "model_tflop_per_step": vis / 1e12,
            "model_tflop_per_step_dense_attention": dense / 1e12,
            "mfu_" + peak[0]: vis / mean_s / peak[1],
            "mfu_" + peak[0] + "_dense_attention": dense / mean_s / peak[1],
            "peak_mem_gib": (torch.cuda.max_memory_allocated() - base)
            / 2 ** 30,
            "launches": got, "launches_per_step": {
                k_: n / steps for k_, n in got.items()},
            "card": card_line()}


def phase_xlnet_train(ht, fa, metrics, kmods):
    """XLNet-base permutation-LM training steps through Executor.run on
    the card.  Returns the launches of the mask-with-bias kernels."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()     # what earlier phases still hold
    cfg = ht.XLNetConfig.base(seq_len=XL_SEQ, batch_size=XL_BATCH)
    feeds, loss, _ = ht.xlnet_plm_graph(cfg)
    train_op = ht.optim.AdamOptimizer(1e-4).minimize(loss)
    t0 = time.perf_counter()
    ex = ht.Executor({"train": [loss, train_op]}, seed=0, device="cuda")
    log(f"[xlnet-train] XLNet-base executor built in "
        f"{time.perf_counter() - t0:.1f} s")
    batch = ht.synthetic_plm_batch(cfg, seed=0)
    fd = {feeds[k_]: v_ for k_, v_ in zip(
        ("input_ids", "content_mask", "query_mask", "labels"), batch)}
    # every stream of every layer but the last layer's content stream,
    # which the loss (from the query stream) does not reach
    want = XL_STEPS * (2 * cfg.n_layer - 1)
    names = ("fwd_mask_bias_launches", "dq_mask_bias_launches",
             "dkv_mask_bias_launches")
    report = train_path(fa, metrics, kmods, "[xlnet-train]", ex, fd,
                        XL_STEPS, XL_WARMUP, names, want,
                        xlnet_step_flops(cfg, batch[1], batch[2]), base)
    tokens = cfg.batch_size * cfg.seq_len
    report.update({"batch": cfg.batch_size, "seq": cfg.seq_len,
                   "tokens_per_s": tokens / (report["step_ms_mean"] / 1e3),
                   "visible_pairs_per_bh": {
                       "content": attn_pairs([(batch[1], 1)])
                       / cfg.batch_size,
                       "query": attn_pairs([(batch[2], 1)]) / cfg.batch_size,
                       "walked_content": walked_pairs(fa, batch[1]),
                       "walked_query": walked_pairs(fa, batch[2])}})
    log(f"[xlnet-train] {json.dumps(report)}")
    ex.close()
    del ex
    torch.cuda.empty_cache()
    return {line_name(n): c for n, c in report["launches"].items()}


def phase_longformer_train(ht, fa, metrics, kmods):
    """Longformer-base MLM training steps through Executor.run on the
    card.  Returns the launches of the full-mask kernels."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()     # what earlier phases still hold
    cfg = ht.LongformerConfig.base(seq_len=LF_SEQ, batch_size=LF_BATCH)
    feeds, loss, _ = ht.longformer_mlm_graph(cfg)
    train_op = ht.optim.AdamOptimizer(1e-4).minimize(loss)
    t0 = time.perf_counter()
    ex = ht.Executor({"train": [loss, train_op]}, seed=0, device="cuda")
    log(f"[longformer-train] Longformer-base executor built in "
        f"{time.perf_counter() - t0:.1f} s")
    ids, labels = ht.synthetic_mlm_ids(cfg, seed=0)
    fd = {feeds["input_ids"]: ids, feeds["labels"]: labels}
    wmask = ht.longformer_attention_mask(cfg.seq_len, cfg.attention_window,
                                         cfg.num_global_tokens)
    names = ("fwd_mask_launches", "dq_mask_launches", "dkv_mask_launches")
    report = train_path(fa, metrics, kmods, "[longformer-train]", ex, fd,
                        LF_STEPS, LF_WARMUP, names,
                        LF_STEPS * cfg.num_hidden_layers,
                        longformer_step_flops(cfg, wmask[None]), base)
    tokens = cfg.batch_size * cfg.seq_len
    report.update({"batch": cfg.batch_size, "seq": cfg.seq_len,
                   "tokens_per_s": tokens / (report["step_ms_mean"] / 1e3),
                   "visible_pairs_per_bh": attn_pairs([(wmask, 1)]),
                   "walked_pairs_per_bh": walked_pairs(fa, wmask)})
    log(f"[longformer-train] {json.dumps(report)}")
    ex.close()
    del ex
    torch.cuda.empty_cache()
    return {line_name(n): c for n, c in report["launches"].items()}


def phase_mask_train_parity(ht):
    """Tiny XLNet and tiny Longformer (dropout 0): card vs CPU over 3 Adam
    steps from the same weights; losses and step-1 gradients of every
    variable agree at phase 20's gates."""
    xcfg = ht.XLNetConfig.tiny(batch_size=2, dropout=0.0)
    lcfg = ht.LongformerConfig.tiny(batch_size=2, hidden_dropout_prob=0.0)
    xb = ht.synthetic_plm_batch(xcfg, seed=1)
    for tag, (feeds, loss, _), batch in (
            ("XLNet", ht.xlnet_plm_graph(xcfg), dict(zip(
                ("input_ids", "content_mask", "query_mask", "labels"), xb))),
            ("Longformer", ht.longformer_mlm_graph(lcfg), dict(zip(
                ("input_ids", "labels"), ht.synthetic_mlm_ids(lcfg, 1))))):
        wrt = [n for n in ht.topo_sort([loss])
               if isinstance(n, ht.PlaceholderOp) and n.is_variable
               and n.trainable]
        grads = ht.gradients(loss, wrt)
        train_op = ht.optim.AdamOptimizer(1e-4).minimize(loss)
        fetches = {"train": [loss, train_op] + grads}
        card = ht.Executor(fetches, seed=0, device="cuda")
        host = ht.Executor(fetches, seed=0, device="cpu")
        load_all(host, card.return_tensor_values())
        fd = {feeds[k_]: v_ for k_, v_ in batch.items()}
        loss_err, grad_err = 0.0, 0.0
        for step in range(3):
            got = card.run("train", feed_dict=fd,
                           convert_to_numpy_ret_vals=True)
            want = host.run("train", feed_dict=fd,
                            convert_to_numpy_ret_vals=True)
            gl, wl = float(got[0]), float(want[0])
            loss_err = max(loss_err, abs(gl - wl) / abs(wl))
            if not (math.isfinite(gl)
                    and abs(gl - wl) <= TRAIN_LOSS_RTOL * abs(wl)):
                raise AssertionError(f"card vs CPU {tag} loss at step "
                                     f"{step + 1}: {gl} vs {wl}")
            if step == 0:
                for node, g, w in zip(wrt, got[2:], want[2:]):
                    grad_err = max(grad_err, float(np.max(np.abs(g - w))))
                    if not np.allclose(g, w, rtol=TRAIN_GRAD_RTOL,
                                       atol=TRAIN_GRAD_ATOL):
                        raise AssertionError(
                            f"card vs CPU {tag} gradient of {node.name}: "
                            f"max err {float(np.max(np.abs(g - w)))}")
        log(f"[mask-train-parity] {tag} tiny, card vs CPU, 3 Adam steps: "
            f"loss max rel err {loss_err:.3e} (rtol {TRAIN_LOSS_RTOL}); "
            f"step-1 gradients of {len(wrt)} variables max abs err "
            f"{grad_err:.3e} (rtol {TRAIN_GRAD_RTOL}, atol "
            f"{TRAIN_GRAD_ATOL})")
        card.close()
        host.close()


def check_hmma():
    """The SASS of the bf16 forward, dQ and dK/dV libraries (``cuobjdump
    -sass``): every instantiation of the three kernels must run its
    products on the tensor cores (bf16 ``HMMA`` instructions).  Returns
    {kernel template: (instantiations, fewest HMMA in one)}."""
    from hetu_tpu_torch.ops.kernels import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    found = {}
    for source, kern in (("flash_attention_bf16", "flash_fwd_mma_kernel"),
                         ("flash_attention_dq_bf16", "flash_dq_mma_kernel"),
                         ("flash_attention_dkv_bf16",
                          "flash_dkv_mma_kernel")):
        sass = subprocess.run([tool, "-sass", _build.library_path(source)],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        funcs = [f for f in sass.split("Function : ")[1:]
                 if kern in f.split("\n", 1)[0]]
        hmma = [sum("HMMA" in ln and "BF16" in ln for ln in f.splitlines())
                for f in funcs]
        if not funcs or min(hmma) == 0:
            raise AssertionError(f"{source}: {kern} has no bf16 HMMA in "
                                 f"{hmma.count(0)} of {len(funcs)} "
                                 f"instantiations")
        found[kern] = (len(funcs), min(hmma))
    log(f"[bf16-kernels] SASS: bf16 HMMA in every instantiation "
        f"(instantiations, fewest HMMA): {json.dumps(found)}")
    return found


def phase_bf16_kernels(ht, fa):
    """Every bf16 instantiation of the training kernels against its bf16
    plain version: the key-mask kernels at the BERT-base flagship's
    attention shape (B=64, H=12, S=512, D=64, the key mask of
    ``synthetic_mlm_batch`` with one batch row fully masked) and the causal
    ones at GPT-2 small's (B=8, H=12, S=1024), both timed with SDPA in
    bf16 as the yardstick; dense, causal with a key mask, ragged and
    S_q > S_kv, a dense bias (groups h, bh; with causal and a key mask),
    the key-bias strip, a full mask (groups b, one; with causal and a key
    mask), a full mask with a bias and with a strip at small shapes.
    Returns the kernels-line entries {fwd, dq, dkv} of each path, errors
    the worst over the cases of the same instantiation."""
    check_hmma()
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    flush = flush_buf.zero_
    rng = np.random.RandomState(25)
    scale = 1.0 / math.sqrt(D)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)) \
            .to("cuda", torch.bfloat16)

    _, _, _, attn = ht.synthetic_mlm_batch(
        ht.BertConfig.base(batch_size=BF_BATCH, seq_len=TS), seed=0)
    attn = attn.copy()
    attn[-1] = 0                          # a row with every key masked
    bkm = torch.from_numpy(attn).cuda()
    small_km = torch.from_numpy(
        (rng.rand(2, 200) < 0.7).astype(np.int32)).cuda()
    small_km[1] = 0
    worst = {}
    lines = {}

    def run(path, name, bh, s_q, s_kv, timed=False, **kw):
        q, do = t(bh, s_q, D), t(bh, s_q, D)
        k, v = t(bh, s_kv, D), t(bh, s_kv, D)
        heads = kw.pop("heads", H)
        err, row = attn_case(fa, "[bf16-kernels]", name, q, k, v, do, heads,
                             kw.pop("scale", scale),
                             flush=flush if timed else None, **kw)
        for kk, e in err.items():
            worst[(path, kk)] = max(worst.get((path, kk), 0.0), e)
        if timed:
            lines[path] = row
        del q, k, v, do
        torch.cuda.empty_cache()

    run("bert", "BERT flagship key mask", BF_BATCH * H, TS, TS, timed=True,
        km=bkm)
    run("bert", "dense", 4 * H, TS, TS)
    run("gpt2", "GPT-2 causal", GPT_BATCH * H, GPT_SEQ, GPT_SEQ, timed=True,
        causal=True)
    run("gpt2", "causal+key_mask ragged", 2 * 3, 200, 200, heads=3,
        km=small_km, causal=True)
    run("gpt2", "causal S_q>S_kv", 2 * 3, 200, 64, heads=3, causal=True)

    def group(g, s_q, s_kv, bh=6, heads=3, p=None):
        x = torch.from_numpy(rng.randn(fa._group_rows(g, bh, heads), s_q,
                                       s_kv).astype(np.float32)).cuda()
        if p is None:
            return x
        m = (x.abs() < p)
        m[0, 0] = False                   # a row with every key masked
        return m.to(torch.uint8).contiguous()

    others = [
        ("bias_causal", "bias group h, causal", 114, 114,
         dict(bias=group("h", 114, 114), gmode="h", causal=True)),
        ("bias", "bias group bh, key mask", 130, 200,
         dict(bias=group("bh", 130, 200), gmode="bh", km=small_km)),
        ("kbias", "strip group b, causal", 200, 200,
         dict(kbias=group("b", 1, 200), gmode="b", causal=True)),
        ("mask", "mask group b", 96, 96,
         dict(mask=group("b", 96, 96, p=1.0), mask_gmode="b")),
        ("mask", "mask group one, causal, key mask", 200, 200,
         dict(mask=group("one", 200, 200, p=1.0), mask_gmode="one",
              causal=True, km=small_km)),
        ("mask_bias", "mask group b, bias group h", 96, 96,
         dict(mask=group("b", 96, 96, p=1.0), mask_gmode="b",
              bias=group("h", 96, 96), gmode="h")),
        ("mask_kbias", "mask group h, strip group one, causal", 130, 200,
         dict(mask=group("h", 130, 200, p=1.0), mask_gmode="h",
              kbias=group("one", 1, 200), gmode="one", causal=True))]
    for path, name, s_q, s_kv, kw in others:
        run(path, name, 6, s_q, s_kv, heads=3, scale=0.37, **kw)

    # the other instantiations timed at their paths' shapes (phases 18 and
    # 21; the bf16 paths of phase 31 take the same): T5's encoder (bias
    # group h, its padded key mask with a dead batch row), decoder (bias
    # group h, causal) and key-bias strip, XLNet's content stream (mask
    # group b, bias group h) and query stream with a strip, and
    # Longformer's window (mask group one)
    t5 = ht.T5Config.small(batch_size=T5_BATCH, src_len=T5_SRC,
                           tgt_len=T5_TGT)
    t5h = t5.num_heads
    t5km = ht.synthetic_seq2seq_batch(t5, seed=0, padded=True)[3].copy()
    t5km[-1] = 0
    t5km = torch.from_numpy(np.ascontiguousarray(t5km, np.int32)).cuda()
    xcfg = ht.XLNetConfig.base(batch_size=XL_BATCH, seq_len=XL_SEQ)
    _, cmask, qmask, _ = ht.synthetic_plm_batch(xcfg, seed=0)
    lcfg = ht.LongformerConfig.base(batch_size=LF_BATCH, seq_len=LF_SEQ)
    wmask = ht.longformer_attention_mask(LF_SEQ, lcfg.attention_window,
                                         lcfg.num_global_tokens)

    def u8(m):
        return torch.from_numpy(np.ascontiguousarray(m != 0, np.uint8)).cuda()

    def dense(g, bh, heads, rows, s_kv):
        return torch.from_numpy(rng.randn(fa._group_rows(
            g, bh, heads), rows, s_kv).astype(np.float32)).cuda()

    tb, xb = T5_BATCH * t5h, XL_BATCH * H
    paths = [
        ("bias", "T5 encoder, bias group h", tb, T5_SRC, T5_SRC,
         dict(heads=t5h, scale=T5_KERNEL_SCALE, km=t5km, gmode="h",
              bias=dense("h", tb, t5h, T5_SRC, T5_SRC))),
        ("bias_causal", "T5 decoder, bias group h, causal", tb, T5_TGT,
         T5_TGT, dict(heads=t5h, scale=T5_KERNEL_SCALE, causal=True,
                      gmode="h", bias=dense("h", tb, t5h, T5_TGT, T5_TGT))),
        ("kbias", "T5 key-bias strip group b, causal", tb, T5_SRC, T5_SRC,
         dict(heads=t5h, scale=T5_KERNEL_SCALE, causal=True, gmode="b",
              kbias=dense("b", tb, t5h, 1, T5_SRC))),
        ("mask_bias", "XLNet content stream", xb, XL_SEQ, XL_SEQ,
         dict(scale=XL_SCALE, mask=u8(cmask[:, 0]), mask_gmode="b",
              gmode="h", bias=dense("h", xb, H, XL_SEQ, XL_SEQ))),
        ("mask_kbias", "XLNet query stream, key-bias strip", xb, XL_SEQ,
         XL_SEQ, dict(scale=XL_SCALE, mask=u8(qmask[:, 0]), mask_gmode="b",
                      gmode="one", kbias=dense("one", xb, H, 1, XL_SEQ))),
        ("mask", "Longformer window", LF_BATCH * H, LF_SEQ, LF_SEQ,
         dict(scale=XL_SCALE, mask=u8(wmask[None]), mask_gmode="one"))]
    for path, name, bh, s_q, s_kv, kw in paths:
        run(path, name, bh, s_q, s_kv, timed=True, **kw)
    log(f"[bf16-kernels] worst max_abs_err per instantiation "
        f"{json.dumps({f'{p}/{k}': e for (p, k), e in worst.items()})}")
    for path, row in lines.items():
        for kk in row:
            row[kk]["max_abs_err"] = worst[(path, kk)]
    return lines


def phase_bf16_train(ht, fa, metrics, kmods, model):
    """BERT-base at bench.py's flagship shape (``model`` "bert": batch 64,
    seq 512, ``synthetic_mlm_batch``) or GPT-2 small ("gpt2": batch 8,
    seq 1024, ``synthetic_lm_batch``), dropout 0.1, ``AdamOptimizer(1e-4)``
    through ``Executor(compute_dtype="bfloat16").run``: 2 warm-up steps,
    10 counted steps with every launch counter set to 0 just before and
    read just after (each bf16 training kernel of the path: steps x 12; no
    other; no ``backend:`` fallback; the loss finite and falling), the
    masters float32, then 3 profiled steps for the device's breakdown.
    Returns the launches by kernels-line name."""
    from hetu_tpu_torch.tools.profile_train import profile_steps
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()     # what earlier phases still hold
    if model == "bert":
        cfg = ht.BertConfig.base(batch_size=BF_BATCH, seq_len=TS)
        feeds, loss, _ = ht.bert_pretrain_graph(cfg)
        fd = _bert_feeds(feeds, ht.synthetic_mlm_batch(cfg, seed=0))
        names = ("bf16_fwd_launches", "bf16_dq_launches",
                 "bf16_dkv_launches")
        flops, layers = bert_step_flops(cfg), cfg.num_hidden_layers
        tokens = cfg.batch_size * cfg.seq_len
    else:
        cfg = ht.GPT2Config.small(batch_size=GPT_BATCH, seq_len=GPT_SEQ)
        feeds, loss, _ = ht.gpt2_lm_graph(cfg)
        ids, labels = ht.synthetic_lm_batch(cfg, seed=0)
        fd = {feeds["input_ids"]: ids, feeds["labels"]: labels}
        names = ("bf16_fwd_causal_launches", "bf16_dq_causal_launches",
                 "bf16_dkv_causal_launches")
        flops, layers = gpt2_step_flops(cfg), cfg.n_layer
        tokens = cfg.batch_size * cfg.seq_len
    tag = f"[bf16-{model}-train]"
    train_op = ht.optim.AdamOptimizer(1e-4).minimize(loss)
    t0 = time.perf_counter()
    ex = ht.Executor({"train": [loss, train_op]}, seed=0, device="cuda",
                     compute_dtype="bfloat16")
    log(f"{tag} executor built in {time.perf_counter() - t0:.1f} s")
    report = train_path(fa, metrics, kmods, tag, ex, fd, BF_STEPS, BF_WARMUP,
                        names, BF_STEPS * layers, (flops, flops), base,
                        peak=("bf16", PEAK_BF16_FLOPS))
    losses = report["losses"]
    if not losses[-1] < losses[BF_WARMUP]:
        raise AssertionError(f"{tag} loss did not fall: {losses}")
    bad = [ex.var_names[n] for n, v in ex.var_values.items()
           if v.dtype != torch.float32]
    if bad:
        raise AssertionError(f"{tag} masters left float32: {bad[:5]}")
    step_s = report["step_ms_mean"] / 1e3
    report["profiled"], _ = profile_steps(
        lambda: float(ex.run("train", feed_dict=fd)[0].asnumpy()),
        BF_PROFILED, step_s)
    report.update({"batch": cfg.batch_size, "seq": cfg.seq_len,
                   "compute_dtype": "bfloat16",
                   "tokens_per_s": tokens / step_s,
                   "samples_per_s": cfg.batch_size / step_s,
                   "masters": "float32"})
    log(f"{tag} {json.dumps(report)}")
    ex.close()
    del ex
    torch.cuda.empty_cache()
    return {line_name(n): c for n, c in report["launches"].items()}


def phase_bf16_model_train(ht, fa, metrics, kmods, model):
    """T5-small, XLNet-base or Longformer-base at its float32 phase's
    shapes and widths (phases 19, 22, 23: dropout 0.1,
    ``AdamOptimizer(1e-4)``) through
    ``Executor(compute_dtype="bfloat16").run``: 2 warm-up steps, 10
    counted steps with every launch counter set to 0 just before and read
    just after (each bf16 flash entry the model reaches: steps x its
    float32 count, 6, 23 or 12; no other kernel; no ``backend:``
    fallback; the loss finite and not rising), the masters float32, then
    3 profiled steps for the device's busy time, idle share and the flash
    and matrix-product shares.  Returns the launches by kernels-line
    name."""
    from hetu_tpu_torch.tools.profile_train import profile_steps
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()     # what earlier phases still hold
    if model == "t5":
        cfg = ht.T5Config.small(batch_size=T5_BATCH, src_len=T5_SRC,
                                tgt_len=T5_TGT)
        feeds, loss, _ = ht.t5_seq2seq_graph(cfg, use_mask=True)
        fd = _t5_feeds(feeds, ht.synthetic_seq2seq_batch(cfg, seed=0,
                                                         padded=True))
        # each bias kernel, its causal twin and the cross-attention's
        # key-mask kernels, once a layer
        kinds = ("bias", "bias_causal", "")
        per_step, steps, warmup = cfg.num_layers, T5_STEPS, T5_WARMUP
        flops = (t5_step_flops(cfg),) * 2
        tokens = cfg.batch_size * (cfg.src_len + cfg.tgt_len)
    elif model == "xlnet":
        cfg = ht.XLNetConfig.base(seq_len=XL_SEQ, batch_size=XL_BATCH)
        feeds, loss, _ = ht.xlnet_plm_graph(cfg)
        batch = ht.synthetic_plm_batch(cfg, seed=0)
        fd = {feeds[k_]: v_ for k_, v_ in zip(
            ("input_ids", "content_mask", "query_mask", "labels"), batch)}
        kinds = ("mask_bias",)
        per_step, steps, warmup = 2 * cfg.n_layer - 1, XL_STEPS, XL_WARMUP
        flops = xlnet_step_flops(cfg, batch[1], batch[2])
        tokens = cfg.batch_size * cfg.seq_len
    else:
        cfg = ht.LongformerConfig.base(seq_len=LF_SEQ, batch_size=LF_BATCH)
        feeds, loss, _ = ht.longformer_mlm_graph(cfg)
        ids, labels = ht.synthetic_mlm_ids(cfg, seed=0)
        fd = {feeds["input_ids"]: ids, feeds["labels"]: labels}
        wmask = ht.longformer_attention_mask(
            cfg.seq_len, cfg.attention_window, cfg.num_global_tokens)
        kinds = ("mask",)
        per_step, steps, warmup = (cfg.num_hidden_layers, LF_STEPS,
                                   LF_WARMUP)
        flops = longformer_step_flops(cfg, wmask[None])
        tokens = cfg.batch_size * cfg.seq_len
    names = tuple(f"bf16_{op}_{kind}_launches".replace("__", "_")
                  for kind in kinds for op in ("fwd", "dq", "dkv"))
    tag = f"[bf16-{model}-train]"
    train_op = ht.optim.AdamOptimizer(1e-4).minimize(loss)
    t0 = time.perf_counter()
    ex = ht.Executor({"train": [loss, train_op]}, seed=0, device="cuda",
                     compute_dtype="bfloat16")
    log(f"{tag} executor built in {time.perf_counter() - t0:.1f} s")
    report = train_path(fa, metrics, kmods, tag, ex, fd, steps, warmup,
                        names, steps * per_step, flops, base,
                        peak=("bf16", PEAK_BF16_FLOPS))
    bad = [ex.var_names[n] for n, v in ex.var_values.items()
           if v.dtype != torch.float32]
    if bad:
        raise AssertionError(f"{tag} masters left float32: {bad[:5]}")
    step_s = report["step_ms_mean"] / 1e3
    report["profiled"], _ = profile_steps(
        lambda: float(ex.run("train", feed_dict=fd)[0].asnumpy()),
        BF_PROFILED, step_s)
    report.update({"batch": cfg.batch_size, "compute_dtype": "bfloat16",
                   "tokens_per_s": tokens / step_s, "masters": "float32"})
    log(f"{tag} {json.dumps(report)}")
    ex.close()
    del ex
    torch.cuda.empty_cache()
    return {line_name(n): c for n, c in report["launches"].items()}


def parity_configs(ht, model):
    """(tiny configuration, scale of every ``*.q.weight``, Adam learning
    rate of the tiny card-vs-CPU run, full-width configuration) of a bf16
    parity model.  Dropout 0 throughout.  The tiny runs take each model's
    own card-vs-CPU rate: 1e-3 for BERT and GPT-2 (phase 28) and the MoE
    (phase 13), 1e-4 for T5, XLNet and Longformer (phases 20 and 24).
    The full widths at a cut batch: BERT-base batch 8 (of 64), GPT-2
    small 4 (of 8), T5-small 8 (of 32), XLNet-base 4 (of 8),
    Longformer-base 1 (of 2); the MoE configuration (``pm.moe_graph``'s
    arguments) whole, its tiny slice tests/test_torch_moe.py's; the
    padding-masked graphs (``varlen-bert``, ``varlen-gpt2``) whole, their
    tiny run 2 layers at batch 2, seq 128.  T5's query projections are
    scaled by 1/8 in the tiny run, as phase 20 does."""
    if model in VL_SHAPES:
        batch, seq, _ = VL_SHAPES[model]
        return (dict(layers=2, batch=2, seq=128), 1.0, 1e-3,
                dict(layers=12, batch=batch, seq=seq))
    if model == "bert":
        drop = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
        return (ht.BertConfig.tiny(batch_size=4, seq_len=128, **drop), 1.0,
                1e-3, ht.BertConfig.base(batch_size=8, seq_len=TS, **drop))
    if model == "gpt2":
        drop = dict(resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
        return (ht.GPT2Config.tiny(batch_size=4, seq_len=128, **drop), 1.0,
                1e-3, ht.GPT2Config.small(batch_size=4, seq_len=GPT_SEQ,
                                          **drop))
    if model == "t5":
        return (ht.T5Config.tiny(batch_size=4, src_len=128, tgt_len=50,
                                 dropout_rate=0.0), 0.125, 1e-4,
                ht.T5Config.small(batch_size=8, src_len=T5_SRC,
                                  tgt_len=T5_TGT, dropout_rate=0.0))
    if model == "xlnet":
        return (ht.XLNetConfig.tiny(batch_size=2, dropout=0.0), 1.0, 1e-4,
                ht.XLNetConfig.base(batch_size=4, seq_len=XL_SEQ,
                                    dropout=0.0))
    if model == "longformer":
        return (ht.LongformerConfig.tiny(batch_size=2,
                                         hidden_dropout_prob=0.0), 1.0, 1e-4,
                ht.LongformerConfig.base(batch_size=1, seq_len=LF_SEQ,
                                         hidden_dropout_prob=0.0))
    return (dict(batch_tokens=64, d=16, experts=4, hidden=32), 1.0, 1e-3,
            dict(batch_tokens=8192))


def _bf16_graph(ht, pm, model, cfg):
    """(feeds by name, loss, feed values by name, extra fetches) of BERT,
    GPT-2, T5 (``use_mask``), XLNet, Longformer, the sparse MoE graph
    (``cfg``: ``pm.moe_graph``'s arguments) or a padding-masked graph
    (``cfg``: layers, batch, seq).  The extra fetches: the MoE graph's
    token_of_slot and slot_of_token; T5's, XLNet's and Longformer's
    logits (:func:`lm_loss64`)."""
    if model in VL_SHAPES:
        from hetu_tpu_torch.tools.profile_train import (varlen_feeds,
                                                        varlen_graph,
                                                        varlen_lengths)
        feeds, loss = varlen_graph(cfg["batch"], cfg["seq"],
                                   VL_SHAPES[model][2],
                                   n_layer=cfg["layers"])
        lens = varlen_lengths(model, cfg["batch"], cfg["seq"])
        return feeds, loss, {n.name: v for n, v in
                             varlen_feeds(feeds, lens).items()}, []
    if model == "moe":
        g = pm.moe_graph(sparse=True, **cfg)
        values = {n.name: v for n, v in pm.moe_feeds(g, seed=1).items()}
        return ({"x": g["x"], "y": g["y"]}, g["loss"], values,
                list(g["route"][:2]))
    if model == "bert":
        feeds, loss, _ = ht.bert_pretrain_graph(cfg)
        names = ("input_ids", "token_type_ids", "masked_lm_labels",
                 "attention_mask")
        batch = ht.synthetic_mlm_batch(cfg, seed=1)
        return feeds, loss, dict(zip(names, batch)), []
    if model == "gpt2":
        feeds, loss, _ = ht.gpt2_lm_graph(cfg)
        names, batch = ("input_ids", "labels"), ht.synthetic_lm_batch(cfg,
                                                                      seed=1)
        return feeds, loss, dict(zip(names, batch)), []
    if model == "t5":
        feeds, loss, logits = ht.t5_seq2seq_graph(cfg, use_mask=True)
        names = ("input_ids", "decoder_input_ids", "labels",
                 "attention_mask")
        batch = ht.synthetic_seq2seq_batch(cfg, seed=1, padded=True)
    elif model == "xlnet":
        feeds, loss, logits = ht.xlnet_plm_graph(cfg)
        names = ("input_ids", "content_mask", "query_mask", "labels")
        batch = ht.synthetic_plm_batch(cfg, seed=1)
    else:
        feeds, loss, logits = ht.longformer_mlm_graph(cfg)
        names, batch = ("input_ids", "labels"), ht.synthetic_mlm_ids(cfg, 1)
    return feeds, loss, dict(zip(names, batch)), [logits]


def lm_loss64(logits, labels):
    """The models' masked LM loss (``masked_lm_loss``: the mean over labels
    other than -1) in float64 from fetched logits: the bf16 step's loss
    without its last rounding, the bf16 sum over the tokens, whose
    spacing (3.9e-3 to 7.8e-3 relative) is as wide as the loss gate."""
    x = logits.astype(np.float64).reshape(-1, logits.shape[-1])
    y = np.asarray(labels).reshape(-1)
    x, y = x[y != -1], y[y != -1]
    m = x.max(-1)
    lse = m + np.log(np.exp(x - m[:, None]).sum(-1))
    return float(np.mean(lse - x[np.arange(len(y)), y]))


def bf16_card_vs_cpu(ht, pm, model, cfg, q_scale, lr,
                     compute_dtype="bfloat16"):
    """One tiny model at bf16 (dropout 0): card vs CPU over 3 Adam steps
    (learning rate ``lr``) from the same weights (``*.q.weight`` scaled by
    ``q_scale``), losses within BF16_TRAIN_LOSS_RTOL and step-1 gradients
    of every variable float32 and allclose at BF16_TRAIN_GRAD_*
    (``compute_dtype=None``: float32, at TRAIN_LOSS_RTOL and
    TRAIN_GRAD_*, phase 7's gates).  The MoE
    routing maps must be equal at every step (a differing route stops the
    phase with the tokens' gate gaps from the bf16-rounded operands).
    T5's, XLNet's and Longformer's losses are compared as
    :func:`lm_loss64` of each device's bf16 logits (the fetched bf16
    losses are logged beside them); BERT's, GPT-2's and the MoE's (a
    float32 value) as fetched."""
    feeds, loss, values, extra = _bf16_graph(ht, pm, model, cfg)
    route = extra if model == "moe" else []
    wrt = [n for n in ht.topo_sort([loss])
           if isinstance(n, ht.PlaceholderOp) and n.is_variable
           and n.trainable]
    fetches = {"train": [loss, ht.optim.AdamOptimizer(lr).minimize(loss)]
               + ht.gradients(loss, wrt) + extra}
    card = ht.Executor(fetches, seed=0, device="cuda",
                       compute_dtype=compute_dtype)
    host = ht.Executor(fetches, seed=0, device="cpu",
                       compute_dtype=compute_dtype)
    lrtol, grtol, gatol, tag = (
        (BF16_TRAIN_LOSS_RTOL, BF16_TRAIN_GRAD_RTOL, BF16_TRAIN_GRAD_ATOL,
         "bf16") if compute_dtype else
        (TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL, "float32"))
    weights = {n: w * q_scale if n.endswith(".q.weight") else w
               for n, w in card.return_tensor_values().items()}
    load_all(card, weights)
    load_all(host, weights)
    fd = {feeds[k]: v for k, v in values.items()}
    nv = len(wrt)
    wg_node = next((n for n, name in card.var_names.items()
                    if name == "topk_gate.wg"), None)
    loss_err, grad_err, fetched = 0.0, 0.0, []
    for step in range(3):
        wg = None if wg_node is None else \
            card.var_values[wg_node].to(torch.bfloat16).float().cpu().numpy()
        got = card.run("train", feed_dict=fd, convert_to_numpy_ret_vals=True)
        want = host.run("train", feed_dict=fd,
                        convert_to_numpy_ret_vals=True)
        if route and not all(np.array_equal(a, b) for a, b in
                             zip(got[2 + nv:], want[2 + nv:])):
            xb = torch.from_numpy(values["x"]).to(torch.bfloat16).float()
            cap = int(math.ceil(pm.K * pm.CAPACITY_FACTOR
                                * cfg["batch_tokens"] / cfg["experts"]))
            raise AssertionError(
                f"bf16 card vs CPU {model} routing maps differ at step "
                f"{step + 1}: " + route_gaps(xb.numpy(), wg, got[-1],
                                             want[-1], cap, pm.K))
        fetched.append((float(got[0]), float(want[0])))
        if extra and not route:
            gl = lm_loss64(got[-1], values["labels"])
            wl = lm_loss64(want[-1], values["labels"])
        else:
            gl, wl = fetched[-1]
        loss_err = max(loss_err, abs(gl - wl) / abs(wl))
        if not (math.isfinite(gl) and abs(gl - wl) <= lrtol * abs(wl)):
            raise AssertionError(f"{tag} card vs CPU {model} loss at "
                                 f"step {step + 1}: {gl} vs {wl}")
        if step == 0:
            for node, g, w in zip(wrt, got[2:2 + nv], want[2:2 + nv]):
                grad_err = max(grad_err, float(np.max(np.abs(g - w))))
                if g.dtype != np.float32 or not np.allclose(
                        g, w, rtol=grtol, atol=gatol):
                    raise AssertionError(
                        f"{tag} card vs CPU {model} gradient of "
                        f"{node.name}: max err "
                        f"{float(np.max(np.abs(g - w)))}")
    what = ("routing maps equal every step; " if route else "") + (
        "loss (float64 from the bf16 logits)" if extra and not route
        else "loss")
    log(f"[bf16-parity] tiny {model}, {tag} card vs CPU, 3 Adam steps (lr "
        f"{lr}): {what} max rel err {loss_err:.3e} (rtol {lrtol}); fetched "
        f"losses (card, CPU) {fetched}; step-1 gradients of {nv} variables "
        f"max abs err {grad_err:.3e} (rtol {grtol}, atol {gatol})")
    card.close()
    host.close()


def bf16_vs_f32(ht, pm, model, cfg):
    """One model at full width (dropout 0): the bf16 run against the
    float32 run on the card from the same weights, 3 Adam losses within
    ``test_bf16_parity.py``'s 5 % / 0.05."""
    feeds, loss, values, _ = _bf16_graph(ht, pm, model, cfg)
    lr = 1e-3 if model == "moe" else 1e-4    # each training phase's
    fetches = {"train": [loss, ht.optim.AdamOptimizer(lr).minimize(loss)]}
    fd = {feeds[k]: v for k, v in values.items()}
    runs, weights = {}, None
    for cd in ("bfloat16", None):
        ex = ht.Executor(fetches, seed=0, device="cuda", compute_dtype=cd)
        if weights is None:
            weights = ex.return_tensor_values()
        else:
            load_all(ex, weights)
        runs[cd] = [float(ex.run("train", feed_dict=fd)[0].asnumpy())
                    for _ in range(3)]
        ex.close()
        del ex
        torch.cuda.empty_cache()
    got, want = np.array(runs["bfloat16"]), np.array(runs[None])
    if not (np.isfinite(got).all()
            and np.allclose(got, want, rtol=BF16_PARITY_TOL,
                            atol=BF16_PARITY_TOL)):
        raise AssertionError(f"bf16 vs float32 {model} at full width: "
                             f"{got.tolist()} vs {want.tolist()}")
    shape = cfg if isinstance(cfg, dict) else {"batch": cfg.batch_size}
    log(f"[bf16-parity] {model} full width ({json.dumps(shape)}), bf16 vs "
        f"float32 on the card, 3 Adam losses {got.tolist()} vs "
        f"{want.tolist()}: max rel diff "
        f"{float(np.max(np.abs(got - want) / np.abs(want))):.3e} (rtol "
        f"= atol = {BF16_PARITY_TOL})")


def phase_bf16_parity(ht, pm, models, float32_too=False):
    """``models`` at bf16: each tiny model card vs CPU
    (:func:`bf16_card_vs_cpu`; with ``float32_too`` also in float32),
    then each at full width bf16 vs float32 on the card
    (:func:`bf16_vs_f32`); configurations from :func:`parity_configs`."""
    cfgs = {m: parity_configs(ht, m) for m in models}
    for model, (tiny, q_scale, lr, _) in cfgs.items():
        for cd in ((None, "bfloat16") if float32_too else ("bfloat16",)):
            bf16_card_vs_cpu(ht, pm, model, tiny, q_scale, lr, cd)
    for model, (_, _, _, full) in cfgs.items():
        bf16_vs_f32(ht, pm, model, full)


def varlen_step_flops(batch, seq, lens, causal, layers, hidden, heads):
    """Model FLOPs of one step of the padding-masked graph (forward +
    backward = 3 x the forward's): the q, k, v, o products 6 x tokens x
    layers x 4 h^2; attention 12 x (h / heads) per visible (row, key) pair
    of each head and layer (``dense``: every pair, causal or not, as
    ``bert_step_flops`` counts)."""
    products = 6.0 * batch * seq * layers * 4 * hidden * hidden
    lens = np.clip(np.asarray(lens, np.int64), 0, seq)
    if causal:      # row r sees keys [0, min(r + 1, len))
        rows = np.arange(1, seq + 1)[None, :]
        pairs = float(np.minimum(rows, lens[:, None]).sum())
    else:
        pairs = float(seq * lens.sum())
    per_pair = 12.0 * (hidden // heads) * heads * layers
    return (products + per_pair * pairs,
            products + per_pair * batch * seq * seq)


def phase_varlen_kernels(ht, fa):
    """Every kernel with ``lengths`` against its plain version, float32 and
    bf16: timed at the varlen paths' shapes (BERT's B=16 H=12 S=512 with
    ``synthetic_mlm_batch``'s lengths; GPT-2's B=8 H=12 S=1024 causal,
    lengths uniform over [256, 1024], one row full and one of length 0)
    beside the bound on visible pairs and SDPA with the lengths as a
    boolean ``attn_mask``; and at small shapes with every rule the kernels
    combine ``lengths`` with: a key mask, a full mask in each group mode,
    a dense bias, a strip, a full mask with a bias and with a strip, causal
    or not.  Each case checks dK, dV and dkbias exactly 0 past the lengths
    (``attn_case``).  Returns the kernels-line entries {(path, dtype):
    {fwd, dq, dkv}}, errors the worst over the cases of the same
    instantiation."""
    from hetu_tpu_torch.tools.profile_train import varlen_lengths
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    flush = flush_buf.zero_
    rng = np.random.RandomState(33)
    scale = 1.0 / math.sqrt(D)

    def t(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)) \
            .to("cuda", dtype)

    def lens_of(*n):
        return torch.tensor(n, dtype=torch.int32, device="cuda")

    worst, lines = {}, {}

    def run(path, dt, name, b, heads, s_q, s_kv, lengths, timed=False,
            **kw):
        q, do = t(b * heads, s_q, D, dtype=dt), t(b * heads, s_q, D, dtype=dt)
        k, v = t(b * heads, s_kv, D, dtype=dt), t(b * heads, s_kv, D,
                                                  dtype=dt)
        err, row = attn_case(fa, "[varlen-kernels]", name, q, k, v, do,
                             heads, kw.pop("scale", scale),
                             flush=flush if timed else None,
                             lengths=lengths, **kw)
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        if path is not None:
            for kk, e in err.items():
                worst[(path, tag, kk)] = max(worst.get((path, tag, kk), 0.0),
                                             e)
        if timed:
            lines[(path, tag)] = row
        del q, k, v, do
        torch.cuda.empty_cache()

    bb, bs, _ = VL_SHAPES["varlen-bert"]
    gb, gs, _ = VL_SHAPES["varlen-gpt2"]
    blens = torch.from_numpy(varlen_lengths("varlen-bert", bb, bs)).cuda()
    glens = varlen_lengths("varlen-gpt2", gb, gs)
    glens[-1] = 0                         # a row that sees no key
    glens = torch.from_numpy(glens).cuda()
    log(f"[varlen-kernels] BERT lengths {blens.tolist()}; GPT-2 lengths "
        f"{glens.tolist()}")
    small_km = torch.from_numpy((rng.rand(2, 200) < 0.7).astype(np.int32)) \
        .cuda()
    small_km[:, 0] = 1

    def group(g, s_q, s_kv, p=None):
        x = torch.from_numpy(rng.randn(fa._group_rows(g, 6, 3), s_q, s_kv)
                             .astype(np.float32)).cuda()
        if p is None:
            return x
        m = x.abs() < p
        m[0, 0] = False                   # a row with every key masked
        return m.to(torch.uint8).contiguous()

    for dt in (torch.float32, torch.bfloat16):
        run("len", dt, "BERT lengths", bb, H, bs, bs, blens, timed=True)
        run("causal_len", dt, "GPT-2 lengths, causal", gb, H, gs, gs, glens,
            timed=True, causal=True)
        small = [
            ("len", "lengths 0 and > S_kv, S_q != S_kv", 130, 333,
             lens_of(0, 999), {}),
            ("len", "key mask", 200, 200, lens_of(150, 64),
             dict(km=small_km)),
            ("causal_len", "causal S_q > S_kv, key mask", 200, 130,
             lens_of(1, 130), dict(causal=True, km=small_km[:, :130]
                                   .contiguous())),
            (None, "mask group one, causal", 200, 200, lens_of(128, 200),
             dict(mask=group("one", 200, 200, p=1.0), mask_gmode="one",
                  causal=True)),
            (None, "mask group h", 130, 200, lens_of(65, 999),
             dict(mask=group("h", 130, 200, p=1.0), mask_gmode="h")),
            (None, "mask group b, key mask", 96, 200, lens_of(100, 0),
             dict(mask=group("b", 96, 200, p=1.0), mask_gmode="b",
                  km=small_km)),
            (None, "mask group bh", 77, 101, lens_of(1, 64),
             dict(mask=group("bh", 77, 101, p=1.0), mask_gmode="bh")),
            (None, "bias group h", 200, 130, lens_of(100, 129),
             dict(bias=group("h", 200, 130), gmode="h")),
            (None, "bias group bh, causal", 114, 114, lens_of(50, 114),
             dict(bias=group("bh", 114, 114), gmode="bh", causal=True)),
            (None, "strip group b, causal, key mask", 200, 200,
             lens_of(190, 3), dict(kbias=group("b", 1, 200), gmode="b",
                                   causal=True, km=small_km)),
            (None, "mask group b, bias group h", 96, 96, lens_of(70, 96),
             dict(mask=group("b", 96, 96, p=1.0), mask_gmode="b",
                  bias=group("h", 96, 96), gmode="h")),
            (None, "mask group h, strip group one, causal", 130, 200,
             lens_of(129, 0), dict(mask=group("h", 130, 200, p=1.0),
                                   mask_gmode="h",
                                   kbias=group("one", 1, 200), gmode="one",
                                   causal=True))]
        for path, name, s_q, s_kv, lengths, kw in small:
            run(path, dt, name, 2, 3, s_q, s_kv, lengths, scale=0.37, **kw)
    log(f"[varlen-kernels] worst max_abs_err per instantiation "
        f"{json.dumps({f'{p}/{d}/{k}': e for (p, d, k), e in worst.items()})}")
    for (path, tag), row in lines.items():
        for kk in row:
            row[kk]["max_abs_err"] = worst[(path, tag, kk)]
    return lines


def _varlen_executor(ht, model, compute_dtype):
    """(executor on the card, feed dict, lengths) of the padding-masked
    graph of ``tools/profile_train.py`` at ``model``'s full shape
    (``VL_SHAPES``, 12 layers, hidden 768, 12 heads)."""
    from hetu_tpu_torch.tools.profile_train import (varlen_feeds,
                                                    varlen_graph,
                                                    varlen_lengths)
    batch, seq, causal = VL_SHAPES[model]
    feeds, loss = varlen_graph(batch, seq, causal)
    train_op = ht.optim.AdamOptimizer(1e-4).minimize(loss)
    lens = varlen_lengths(model, batch, seq)
    ex = ht.Executor({"train": [loss, train_op]}, seed=0, device="cuda",
                     compute_dtype=compute_dtype)
    return ex, varlen_feeds(feeds, lens), lens


def phase_varlen_train(ht, pm, fa, metrics, kmods):
    """The padding-masked graphs (``sdpa_varlen_op``) at full width and
    depth (12 layers; BERT's batch 16 x seq 512, GPT-2's batch 8 x seq
    1024 causal) through ``Executor.run``, float32 and
    ``compute_dtype="bfloat16"``: 2 warm-up steps, 10 counted steps with
    every launch counter set to 0 just before and read just after (the
    forward, dQ and dK/dV with ``lengths``: 12 launches a step each;
    nothing else; no ``backend:`` fallback; the loss finite and not
    rising), step p50/p99, MFU on visible pairs, peak memory, and 3
    profiled steps for busy time and idle share.  Then bf16 against
    float32 at full width (3 Adam losses within ``BF16_PARITY_TOL``) and
    2 layers of the same widths (batch 2, seq 128) on the card against
    the CPU, float32 at phase 7's gates and bf16 at phase 28's.  Returns
    the launches by kernels-line name."""
    from hetu_tpu_torch.tools.profile_train import (VARLEN_HEADS,
                                                    VARLEN_HIDDEN,
                                                    VARLEN_LAYERS,
                                                    profile_steps)
    got = {}
    for model, (batch, seq, causal) in VL_SHAPES.items():
        for cd in (None, "bfloat16"):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            tag = f"[{model}-train{'-bf16' if cd else ''}]"
            t0 = time.perf_counter()
            ex, fd, lens = _varlen_executor(ht, model, cd)
            log(f"{tag} executor built in {time.perf_counter() - t0:.1f} s")
            names = tuple(("bf16_" if cd else "") + op
                          + ("_causal" if causal else "") + "_len_launches"
                          for op in ("fwd", "dq", "dkv"))
            flops = varlen_step_flops(batch, seq, lens, causal,
                                      VARLEN_LAYERS, VARLEN_HIDDEN,
                                      VARLEN_HEADS)
            peak = ("bf16", PEAK_BF16_FLOPS) if cd else \
                ("fp32", PEAK_FP32_FLOPS)
            report = train_path(fa, metrics, kmods, tag, ex, fd, VL_STEPS,
                                VL_WARMUP, names, VL_STEPS * VARLEN_LAYERS,
                                flops, base, peak=peak)
            step_s = report["step_ms_mean"] / 1e3
            report["profiled"], _ = profile_steps(
                lambda: float(ex.run("train", feed_dict=fd)[0].asnumpy()),
                VL_PROFILED, step_s, lengths=True)
            report.update({"batch": batch, "seq": seq, "causal": causal,
                           "lengths": lens.tolist(),
                           "compute_dtype": cd or "float32",
                           "tokens_per_s": batch * seq / step_s,
                           "real_tokens_per_s": float(lens.sum()) / step_s})
            log(f"{tag} {json.dumps(report)}")
            ex.close()
            del ex
            torch.cuda.empty_cache()
            got.update({line_name(n): c
                        for n, c in report["launches"].items()})
    phase_bf16_parity(ht, pm, tuple(VL_SHAPES), float32_too=True)
    return got


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available — this script runs on the "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import metrics
    from hetu_tpu_torch.ops.kernels import _build
    from hetu_tpu_torch.ops.kernels import emb_cache as emb
    from hetu_tpu_torch.ops.kernels import flash_attention as fa
    from hetu_tpu_torch.ops.kernels import moe_dispatch as md
    from hetu_tpu_torch.ops.kernels import segment_sum as seg
    from hetu_tpu_torch.tools import profile_moe as pm
    kmods = (fa, emb, seg, md)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # -- 1. build -----------------------------------------------------------
    t_start = t0 = time.perf_counter()
    built = _build.build(_build.sources())
    for name, (secs, text) in built.items():
        log(f"[build] {name}: {secs:.1f} s\n{text.strip()}")
    for entry in fa.ENTRIES:
        fa.kernel(entry)
    emb.kernel()
    seg.kernel()
    md.kernel(torch.float32)
    md.kernel(torch.bfloat16)
    log(f"[build] all kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    # -- 2. kernel vs plain -------------------------------------------------
    line = phase_kernels(fa)

    # -- 3. serve GPT-2 small -------------------------------------------------
    cfg = ht.GPT2Config.small()
    graph = ht.gpt2_decode_graph(cfg, max_len=cfg.n_positions)
    t0 = time.perf_counter()
    engine = ht.DecodeEngine(*graph[:3], max_slots=N_REQUESTS,
                             max_len=cfg.n_positions, seed=0, device="cuda")
    log(f"[serve] GPT-2 small engine built in {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(1)
    plens = rng.randint(PROMPT_RANGE[0], PROMPT_RANGE[1] + 1, size=N_REQUESTS)
    plens[0] = PROMPT_RANGE[1]          # the cache grows past 256 rows
    prompts = [rng.randint(0, cfg.vocab_size, size=n) for n in plens]
    with DecodeCalls(fa) as calls:
        results, serve = serve_streams(ht, metrics, kmods, engine, prompts,
                                       calls)
    calls.check(fa, "phase 3")
    launches = {"flash_fwd_lengths": fa.launches,
                "flash_fwd_lengths_merge": fa.merge_launches}
    fallbacks = metrics.flash_fallback_counts()
    steps = serve["decode_steps"]
    for i, toks in enumerate(results):
        if len(toks) != MAX_NEW or not all(0 <= t < cfg.vocab_size
                                           for t in toks):
            raise AssertionError(f"stream {i} returned {toks}")
    if launches["flash_fwd_lengths"] != steps * cfg.n_layer \
            or launches["flash_fwd_lengths"] == 0:
        raise AssertionError(f"flash launches {launches} != decode steps "
                             f"{steps} x n_layer {cfg.n_layer}")
    left = {r: n for r, n in fallbacks.items() if r.startswith("backend:")}
    if left:
        raise AssertionError(f"attention left the kernel: {left}")
    serve.update({"requests": N_REQUESTS, "prompt_lens": plens.tolist(),
                  "max_new_tokens": MAX_NEW, "launches": launches,
                  "card": card_line()})
    log(f"[serve] {json.dumps(serve)}")
    log(f"[serve] first stream: {results[0][:8]}...")
    # the decode kernel at the shapes this run gave it (phase 2's timings)
    phase_decode_shapes(fa, calls)

    # -- 4. card vs CPU, teacher-forced -----------------------------------------
    named = {engine.iex.var_names[n]:
             engine.iex.params[engine.iex._k(n)].cpu().numpy()
             for n in engine.iex.var_nodes}
    cpu_engine = ht.DecodeEngine(
        *graph[:3], weights=ht.params_from_named_arrays(named, "cpu"),
        max_slots=1, max_len=cfg.n_positions, device="cpu")
    tokens = np.random.RandomState(2).randint(0, cfg.vocab_size, size=48)
    got = teacher_forced_logits(engine, tokens)
    want = teacher_forced_logits(cpu_engine, tokens)
    err = float(np.max(np.abs(got - want)))
    log(f"[parity] card vs CPU logits over {len(tokens)} teacher-forced "
        f"steps: max_abs_err={err:.3e} (atol {LOGITS_ATOL}); argmax "
        f"agree {int(np.sum(got.argmax(-1) == want.argmax(-1)))}/"
        f"{len(tokens)}")
    if not (np.all(np.isfinite(got)) and err <= LOGITS_ATOL):
        raise AssertionError(f"card vs CPU logits disagree: {err}")

    # -- 5. training kernels vs plain ---------------------------------------------
    tlines = phase_train_kernels(ht, fa)

    # -- 6. train BERT-base ---------------------------------------------------------
    tlaunches = phase_train(ht, fa, metrics, kmods)

    # -- 7. card vs CPU training ------------------------------------------------------
    phase_train_parity(ht)

    # -- 8. embedding-cache kernels vs plain ----------------------------------------
    gline, sline = phase_emb_kernels(ht, emb, seg)

    # -- 9. train Wide & Deep through the device cache --------------------------------
    claunches = phase_ctr_train(ht, metrics, kmods, emb, seg)

    # -- 10. device vs host cache, card vs CPU ------------------------------------------
    phase_ctr_parity(ht, metrics)

    # -- 11. MoE row gather vs plain -----------------------------------------------------
    mline = phase_moe_kernels(ht, pm, md)

    # -- 12. train the MoE configuration, sparse then dense -------------------------------
    mlaunches = phase_moe_train(ht, pm, metrics, kmods, md)

    # -- 13. sparse vs dense, card vs CPU ---------------------------------------------------
    phase_moe_parity(ht, pm)

    # -- 14. causal and full-mask kernels vs plain -----------------------------------
    glines = phase_causal_kernels(fa)

    # -- 15. train GPT-2 small ---------------------------------------------------------
    glaunches, trained = phase_gpt2_train(ht, fa, metrics, kmods)

    # -- 16. card vs CPU GPT-2 training -------------------------------------------------
    phase_gpt2_train_parity(ht)

    # -- 17. serve the trained weights with chunked prefill ------------------------------
    glaunches.update(phase_gpt2_serve(ht, fa, metrics, kmods, trained,
                                      prompts))

    # -- 18. bias kernels vs plain ------------------------------------------------------
    blines = phase_bias_kernels(ht, fa)

    # -- 19. train T5-small -----------------------------------------------------------
    blaunches = phase_t5_train(ht, fa, metrics, kmods)

    # -- 20. card vs CPU T5 training ---------------------------------------------------
    phase_t5_train_parity(ht)

    # -- 21. full-mask kernels, alone and with a bias, vs plain ----------------------
    mlines = phase_mask_kernels(ht, fa)

    # -- 22. train XLNet-base -------------------------------------------------------
    mlaunches_x = phase_xlnet_train(ht, fa, metrics, kmods)

    # -- 23. train Longformer-base --------------------------------------------------
    mlaunches_l = phase_longformer_train(ht, fa, metrics, kmods)

    # -- 24. card vs CPU XLNet and Longformer training -----------------------------
    phase_mask_train_parity(ht)

    # -- 25. bf16 kernels vs plain -------------------------------------------------
    bflines = phase_bf16_kernels(ht, fa)

    # -- 26. train BERT-base at the bf16 flagship shape ------------------------------
    bflaunches = phase_bf16_train(ht, fa, metrics, kmods, "bert")

    # -- 27. train GPT-2 small in bf16 ----------------------------------------------
    bflaunches.update(phase_bf16_train(ht, fa, metrics, kmods, "gpt2"))

    # -- 28. bf16 card vs CPU, bf16 vs float32 --------------------------------------
    phase_bf16_parity(ht, pm, ("bert", "gpt2"))

    # -- 29. the bf16 MoE row gather vs plain ---------------------------------------
    mline_bf16 = phase_moe_bf16_kernels(ht, pm, md)

    # -- 30. train the MoE configuration in bf16, sparse then dense -----------------
    mlaunches_bf16 = phase_moe_train(ht, pm, metrics, kmods, md,
                                     compute_dtype="bfloat16")

    # -- 31. train T5-small, XLNet-base and Longformer-base in bf16 -----------------
    for model in ("t5", "xlnet", "longformer"):
        for name, n in phase_bf16_model_train(ht, fa, metrics, kmods,
                                              model).items():
            bflaunches[name] = bflaunches.get(name, 0) + n

    # -- 32. bf16 card vs CPU, bf16 vs float32: MoE, T5, XLNet, Longformer ------------
    phase_bf16_parity(ht, pm, ("moe", "t5", "xlnet", "longformer"))

    # -- 33. the kernels with lengths vs plain ----------------------------------------
    vlines = phase_varlen_kernels(ht, fa)

    # -- 34. train the padding-masked graphs, float32 and bf16 -----------------------
    vlaunches = phase_varlen_train(ht, pm, fa, metrics, kmods)

    # -- 35. result lines ---------------------------------------------------------
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")

    def entry(name, source, replaces, n, r):
        return {"name": name, "route": "cuda",
                "source": "hetu_tpu_torch/csrc/" + source,
                "replaces": "hetu_tpu/ops/pallas/" + replaces,
                "launches": n, **{k: r[k] for k in keys}}

    # the cross-attention's key-mask case is held against the same
    # instantiations as BERT's
    for kk in ("fwd", "dq", "dkv"):
        tlines[kk]["max_abs_err"] = max(tlines[kk]["max_abs_err"],
                                        blines[kk + "_cross"]["max_abs_err"])
    kernels = [dict(entry("flash_fwd_lengths", "flash_attention.cu",
                          "flash_attention.py:202",
                          launches["flash_fwd_lengths"], line),
                    merge_launches=launches["flash_fwd_lengths_merge"])]
    flash = (("fwd", "flash_fwd", "flash_attention.cu", 202),
             ("dq", "flash_bwd_dq", "flash_attention_bwd.cu", 299),
             ("dkv", "flash_bwd_dkv", "flash_attention_bwd.cu", 363))
    for lines, counts, key_sfx, name_sfx in (
            (tlines, tlaunches, "", ""), (glines, glaunches, "", "_causal"),
            (blines, blaunches, "", "_bias"),
            (blines, blaunches, "_causal", "_bias_causal"),
            (blines, blaunches, "_kbias", "_kbias")):
        for key, name, source, at in flash:
            kernels.append(entry(name + name_sfx, source,
                                 f"flash_attention.py:{at}",
                                 counts[name + name_sfx],
                                 lines[key + key_sfx]))
    # the full-mask forward: the chunked prefill's launches and
    # Longformer's, its line at the prefill shape (phase 14), its error
    # the worst of phases 14 and 21
    glines["mask"]["max_abs_err"] = max(glines["mask"]["max_abs_err"],
                                        mlines["fwd_mask"]["max_abs_err"])
    kernels.append(entry("flash_fwd_mask", "flash_attention.cu",
                         "flash_attention.py:202",
                         glaunches["flash_fwd_mask"]
                         + mlaunches_l["flash_fwd_mask"], glines["mask"]))
    for key, name, source, at in flash[1:]:
        kernels.append(entry(name + "_mask", source,
                             f"flash_attention.py:{at}",
                             mlaunches_l[name + "_mask"],
                             mlines[key + "_mask"]))
    for sfx, counts in (("_mask_bias", mlaunches_x), ("_mask_kbias", None)):
        for key, name, source, at in flash:
            # the strip with a full mask is on no path: 0, as phases 22
            # and 23 checked
            kernels.append(entry(name + sfx, source,
                                 f"flash_attention.py:{at}",
                                 0 if counts is None else counts[name + sfx],
                                 mlines[key + sfx]))
    # the bf16 instantiations, all three kernels on the tensor cores: the
    # key-mask ones (BERT and T5's cross-attention) and the causal ones
    # (GPT-2) timed at the BERT and GPT-2 shapes, the others at their
    # paths' shapes; their launches from phases 26, 27 and 31 (the
    # key-bias strip, alone or with a full mask, is on no path: 0, as those
    # phases checked)
    bf_sources = {"fwd": "flash_attention_bf16.cu",
                  "dq": "flash_attention_dq_bf16.cu",
                  "dkv": "flash_attention_dkv_bf16.cu"}
    for path, sfx in (("bert", "_bf16"), ("gpt2", "_causal_bf16"),
                      ("bias", "_bias_bf16"),
                      ("bias_causal", "_bias_causal_bf16"),
                      ("kbias", "_kbias_bf16"),
                      ("mask", "_mask_bf16"), ("mask_bias", "_mask_bias_bf16"),
                      ("mask_kbias", "_mask_kbias_bf16")):
        for key, name, _, at in flash:
            kernels.append(entry(name + sfx, bf_sources[key],
                                 f"flash_attention.py:{at}",
                                 bflaunches.get(name + sfx, 0),
                                 bflines[path][key]))
    # the lengths instantiations of the forward, dQ and dK/dV on the
    # padding-masked paths (phase 34), float32 and bf16, timed at their
    # shapes in phase 33
    for path, dtype in (("len", "f32"), ("causal_len", "f32"),
                        ("len", "bf16"), ("causal_len", "bf16")):
        for key, name, source, at in flash:
            nm = name + "_" + path + ("_bf16" if dtype == "bf16" else "")
            kernels.append(entry(nm, bf_sources[key] if dtype == "bf16"
                                 else source, f"flash_attention.py:{at}",
                                 vlaunches[nm], vlines[(path, dtype)][key]))
    kernels.append(entry("emb_gather", "emb_cache.cu", "emb_cache.py:71",
                         claunches["emb_gather"], gline))
    kernels.append(entry("sorted_segment_sum", "segment_sum.cu",
                         "segment_sum.py:25", claunches["sorted_segment_sum"],
                         sline))
    kernels.append(entry("row_gather", "moe_dispatch.cu",
                         "moe_dispatch.py:37", mlaunches["row_gather"],
                         mline))
    kernels.append(entry("row_gather_bf16", "moe_dispatch.cu",
                         "moe_dispatch.py:37",
                         mlaunches_bf16["row_gather_bf16"], mline_bf16))
    log(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
