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
   size, one run, every key distinct, widths 13, 128 and 2048, a slab 4
   bytes off 16-byte alignment, 300,000 rows (more chunks than the
   gather's grid takes at once), and runs longer
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
    20,480), plus n = 0, n = 1, every index -1, widths 13 and 2048, a
    source 4 bytes off 16-byte alignment, a block of the launch plan whose
    every index is -1, and 300,000 rows (more blocks than the grid takes
    at once): equal exactly.  ``SparseDispatch`` / ``SparseCombine``
    forward and backward on those maps, kernel against plain gather: bit
    for bit.  Time the kernel, its plain version, the library call and the
    bound at the dispatch's and the combine's shapes (L2 flushed by a 512
    MB fill, as phases 8 and 29).
12. Train the repository's MoE configuration (BASELINE config 5,
    ``bench.py``'s ``build_moe_graph``: 8,192 tokens, d 512,
    ``TopKGateSparse(512, 8192, 16, k=2, capacity_factor=1.25)``,
    ``Expert(16, 512, 2048)``, ``AdamOptimizer(1e-3)``) through
    ``SparseMoELayer`` and ``Executor.run``: 3 warm-up steps, then 20
    counted steps with every launch counter set to 0 just before and read
    just after (the row gather: 6 launches a step; no ``backend:``
    fallback; each launch's shape recorded, ``GatherCalls``, for the
    kernels line's launches at the combine shape), and 5 profiled steps
    for the device's idle share and the gather's device time (a dtype
    whose gathers launched must show some under ``B6_KERNELS``' names).
    Then the
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
    off 16-byte alignment, width 2048, a block of the launch plan whose
    every index is -1 and 300,000 rows: bit for bit.
    ``SparseDispatch`` / ``SparseCombine`` forward and backward in the
    bf16 step's dtypes (bf16 tokens and rows, float32 gate weights, so a
    float32 combine output and d_buffers gather), kernel against plain
    gather: bit for bit.  Time the kernel, its plain version,
    ``index_select`` + ``masked_fill_`` in bf16 and the bytes bound at 2
    bytes a value at the dispatch's and the combine's shapes (L2 flushed
    by a 512 MB fill, median of 50); both go on the kernels line, the
    combine's under ``combine``.
30. Train phase 12's MoE configuration through
    ``Executor(compute_dtype="bfloat16").run``, sparse then dense: 3
    warm-up and 20 counted steps with every launch counter set to 0 just
    before and read just after (the sparse graph: 5 bf16 row gathers and 1
    float32 a step, ``MOE_GATHERS_BF16_STEP``; the dense graph none; no
    other kernel; no ``backend:`` fallback; the loss finite; each
    launch's shape recorded, as in phase 12), step
    p50/p99, tokens/s, MFU against the 989 TFLOP/s bf16 peak, peak memory
    and 5 profiled steps for busy time, idle share and the gather's device
    ms a step by dtype (nonzero where it launched).
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
35. Train ResNet-18 / CIFAR10 (BASELINE config 1: ``bench.py``'s
    ``build_resnet18_graph`` through ``profile_train.resnet18_step``:
    ``models.resnet18`` at published widths, batch 128, 3x32x32 ``rand``
    inputs and one-hot labels of 10 classes from ``RandomState(0)``,
    ``MomentumOptimizer(0.1)``) with cuDNN's autotuner on for every ResNet
    run (``profile_train.CUDNN_BENCHMARK``, printed) in float32 (TF32 off)
    and in bf16, NCHW, then bf16 NHWC (a finding): 3 warm-up and 20
    counted steps with every launch counter set to 0 just before and read
    just after (the path launches no hand kernel: every counter reads 0),
    the loss finite and falling, the masters float32; step p50 / p99,
    samples/s, peak memory, MFU against 67 or 989 TFLOP/s (3 x 2 x the
    forward's multiply-adds, counted from the graph's convolution and
    linear shapes, ``profile_train.graph_flops``), and 3 profiled steps:
    busy time, idle share, the time by kernel family, and the
    convolutions' forward, dgrad and wgrad timed apart at the step's
    shapes (``profile_train.conv_apart_ms``).
36. The same float32 step fed by ``dataloader_op([Dataloader(x, 128,
    "train")])`` over ``data.cifar10()``'s synthetic split (prefetch on):
    10 counted steps, the loss finite, p50 beside phase 35's.
37. ResNet-18 at batch 8, float32, card against CPU from the same weights
    for 3 Momentum steps: the step-1 loss within ``RN_LOSS_RTOL``, the
    later ones within ``RN_TRAJ_RTOL``, every step-1 gradient within
    ``RN_GRAD_RELNORM``, every running statistic within
    ``RN_STATS_RELNORM`` after step 1 and after the later steps (relative
    norms).
38. Data parallel at world size 1 on the card: an NCCL group of one
    rank (``init_method`` a file under a temporary directory), then
    BERT-base at phase 6's cell and ResNet-18 at batch 128 (BASELINE
    config 2's per-rank shape), float32, each through
    ``Executor(dist_strategy=DataParallel())`` and through the plain
    ``Executor`` from the same seed in the same call: ``DP_STEPS`` steps
    each under ``torch.use_deterministic_algorithms(True)``, so that the
    plain executor repeats itself bit for bit (BERT: the flash launches of
    the strategy's run == steps x layers; the losses and every parameter
    after the steps within ``DP_BERT_RTOL``, bit-equal expected, the
    largest difference printed; ResNet: phase 37's gates, since sync BN
    sums in another order than ``var_mean``, no hand kernel launched, and
    a probe of the step-1 forward and backward lowered both ways from the
    same weights: equal to ``TIE_F64_RELNORM`` in float64, and in float32
    the ReLU pre-activations on opposite sides of 0 located, each step-1
    gradient upstream of one held to ``RN_TIE_GRAD_RELNORM``, the others
    to phase 37's ``RN_GRAD_RELNORM``, in the probe and in the executors'
    runs), then ``DP_TIMED`` timed steps of each in turns (p50, fastest
    and slowest, samples/s) and ``DP_PROFILED`` profiled strategy steps
    (the NCCL kernels' device ms a step, the all-reduce calls and their
    host ms).  Then, on the same group: BERT-base through
    ``Executor(zero=2)``, which builds no plan at world size 1, so its
    losses are the plain executor's bit for bit and ``zero_counts()``
    stays empty; and BERT-base at the same cell in bf16 through the
    strategy against the plain bf16 executor (the bf16 key-mask kernels
    held to their plain versions at its attention shape, B=16, first):
    ``DP_STEPS`` steps each under deterministic algorithms, the losses
    within ``BF16_TRAIN_LOSS_RTOL`` and every step-1 gradient within
    ``BF16_TRAIN_GRAD_RTOL`` / ``_ATOL`` (bit-equal expected, printed), 12
    launches a step of each bf16 key-mask kernel, then p50 of both in
    turns.  The group is destroyed at the end of the phase.
39. Two ranks on the one card: two spawned processes on ``cuda:0``, gloo
    carrying CUDA tensors (NCCL refuses two ranks on one device), each
    running ``DP_STEPS`` steps of tiny BERT (``BertConfig.tiny(batch_size=
    16, seq_len=32)``, Adam 1e-3, dropout 0) and of ResNet-18 at batch 8
    (Momentum 0.1) fed the global batch, from the weights of the
    single-process plain ``Executor`` run on the card over the global batch
    in this process, and held to it at phase 37's gates (losses, step-1
    gradients, ResNet's to ``RN_TIE_GRAD_RELNORM``, tiny BERT's at phase
    7's ``TRAIN_GRAD_RTOL`` / ``TRAIN_GRAD_ATOL`` elementwise: its
    attention key biases have a gradient of 0 in exact arithmetic, every
    row's logits shifting by one constant, so a relative norm there
    compares rounding noise; running statistics; ResNet's later losses
    and statistics to ``RN_TIE_TRAJ``, see ``RN_TIE_GRAD_RELNORM``);
    every rank returns the same losses, and the losses fall.  Then
    GPT-2 small, T5-small (``use_mask=True``, query projections scaled by
    1/8 as in phase 20), XLNet-base and Longformer-base at published
    widths cut to 2 layers (2 + 2 for T5), dropout 0, Adam 1e-4, 2 steps
    each at the global batches of ``DP2_CUT`` (4 at seq 1024; 8 at source
    512 and target 114; 4 at seq 512; 2 at seq 4096), held the same way
    to the single-process run at tiny BERT's gates, each rank counting
    the flash launches of its specializations (``DP2_CUT``).
    The flash kernels at a rank's attention shapes are held to their
    plain versions first: tiny BERT's key mask (B=8, H=2, S=32), GPT-2's
    causal kernels, T5's bias with the key mask, causal bias and
    cross-attention key mask, XLNet's full mask with a bias (both
    streams), Longformer's window mask, each with the rank's rows of the
    masks.  A child that fails, outlives ``DP2_TIMEOUT`` or exits non-zero
    fails the phase.
40. ZeRO on two ranks of the card over gloo: the key-mask kernels at a
    rank's attention shape (B=8, H=12, S=512) first, then BERT-base at
    phase 6's cell (global batch 16, seq 512, dropout 0.1, Adam 1e-4)
    through ``Executor(dist_strategy=DataParallel(), zero=stage)`` at
    stages 0, 1, 2 and 3, ``ZERO_STEPS`` steps each under deterministic
    algorithms: stage 1 bit-equal to stage 0 (losses and every parameter
    after the steps), stages 2 and 3 too, else within phase 37's
    ``RN_LOSS_RTOL`` / ``RN_TRAJ_RTOL`` with the spread printed; every
    rank ends with the same parameters; each kernel 12 launches a step.
    Printed for each rank and stage: the optimizer-state bytes, the
    parameter bytes held between steps (``Executor.memory_accounting``),
    the device memory held after the steps, ``max_memory_allocated``,
    ``zero_counts()`` and the step ms (gloo staging the CUDA tensors
    through the host, two ranks on one card: no multi-card number).  A
    child that fails, outlives ``ZERO_TIMEOUT`` or exits non-zero fails
    the phase.
41. The training loop's state, under deterministic algorithms (the
    embedding backward's atomics would otherwise change bits), in a
    temporary directory removed afterwards.  (a) Schedule, save and
    resume: BERT-base at phase 6's cell (dropout 0.1) on
    ``AdamOptimizer(CosineScheduler(1e-4, warmup_steps=2,
    total_steps=8))``: ``STATE_STEPS`` uninterrupted steps; then half of
    them, ``Executor.save``, a fresh executor, ``load`` and the other
    half, bit-equal to the uninterrupted losses; the same through
    ``auto_save_every`` and ``resume(dir)``; the save and load seconds and
    the checkpoint's bytes printed.  (b) Warm start:
    ``bert_classify_graph(cfg, num_labels=3)`` loads that checkpoint with
    ``params_only=True``: every trunk parameter bit-equal to the
    checkpoint's file, ``step_counter`` 0, 2 steps of finite losses.
    (c) Remat: ``off``, ``dots``, ``full`` and ``offload`` from one set
    of weights, ``REMAT_STEPS`` steps each with dropout on: the losses and
    every gradient bit-equal to ``off``; ``max_memory_allocated`` of each,
    the bytes ``offload`` moved to pinned host memory (more than 0), and
    the flash launches (a recompute launches the forward again: twice a
    layer a step under ``dots`` and ``full``).  (d) Accumulation:
    ``num_microbatches=2`` at batch 16 (the graph built at the microbatch
    size, dropout 0) against the plain step, fed a batch that is two
    copies of one 8-row block, so each microbatch's masked-token mean is
    the whole batch's (the loss of an accumulated step is the mean of its
    microbatches' means, as in the JAX package): the first loss within
    ``ACC_RTOL[0]``, the next two within ``ACC_RTOL[1]``, the peak memory
    of both.  (e) PS tables: Wide & Deep through the device cache at
    phase 9's configuration (every step's gradient rows pushed:
    ``push_bound=1``; with a larger bound a save's cache flush moves the
    trajectory): 3 steps, ``save``, a fresh graph, store and executor,
    ``load``, 3 steps, bit-equal to 6 uninterrupted steps, one B4 and one
    B5 launch a step.
42. The executor's run surface on BERT-base at phase 6's cell (dropout
    0.1, ``AdamOptimizer(1e-4)``, one seed for every executor), under
    deterministic algorithms but for (d), with
    ``HETU_FEED_PIPELINE_MIN_US=0`` so that every ahead-of-step placement
    takes the side stream.  (a) ``lint`` of the graph (its wall time; clean
    and complete), then ``Executor(validate='error')``: every launch
    counter 0 across the construction.  (b) That executor through
    ``run_steps(feeder, 4, sync=False)`` three times and a second one
    through a plain ``run()`` loop of 4 steps three times, in turns: the
    12 losses bit-equal, ``plan_cache_hit`` 11 and ``plan_cache_miss`` 1
    over the async executor's counted steps, ``feeds_pipelined`` and
    ``async_sync_points`` counted, 12 launches a step of each training
    kernel with no ``backend:`` fallback; ms a step of each turn, one
    profiled turn of 3 steps each (device busy ms a step; the idle share
    against the unprofiled turns' p50), and one step each under ``torch.cuda.set_sync_debug_mode("warn")``, whose
    warnings list the host syncs of a step by source line.  (f) A feed of
    the wrong shape: ``GraphValidationError`` naming ``input_ids``, no
    launch.  (c) The same graph with its four feeds ``dataloader_op``s
    over a ``synthetic_mlm_batch`` of 6 batches, the feed pipeline on and
    off: losses bit-equal, ``feeds_pipelined`` 4 a step after the first
    with it on and none off, p50 of both.  (e) ``remat='off'``, ``'auto'``
    with the card's budget and ``'auto'`` under ``HETU_HBM_BUDGET_MB=1``
    (every segment rematted): 2 steps each, losses bit-equal, the plans
    and ``max_memory_allocated``.  (g) Wide & Deep at phase 9's
    configuration, 8 steps with ``sync=False`` against 8 with
    ``sync=True``: losses bit-equal, B4 and B5 once a step.  (d)
    ``matmul_precision`` None, ``'tensorfloat32'`` and ``'bfloat16'``, 5
    steps each: p50, the largest loss gap against None, TF32 off again
    after each.
43. The sharded parameter server at phase 9's configuration (Wide & Deep,
    batch 2048, vocab 100,000, dim 16, the 8 ``ctr_batches``): a spawned
    process serves shard 1 of a two-rank ``DistributedStore`` (keys
    ``% 2``), this process rank 0.  (a) The device cache (``vlru_dev``)
    over the two shards in turns with the same 8 steps over one local
    store, from one table and one set of weights: losses, the store table
    after the flushes, versions and cache counters equal bit for bit, B4
    and B5 once a step (counted over every run), p50 of the timed steps,
    device busy of the profiled ones and the idle share, RPCs and request
    bytes a step; then B4 and B5 held to their plain versions at this
    phase's shapes (a real plan's slots over the sharded store: gather
    exact, segment-sum equal to the host ``_segment_sum`` and within
    ``SEG_RTOL`` / ``SEG_ATOL`` of plain).  (b) The host cache (``vlru``)
    over the two shards, no B4 / B5: ``bsp=0``; ``bsp=-1`` with a
    ``ps_flush`` each step (losses and table equal to ``bsp=0``'s bit for
    bit) and without (every push landed by ``ps_flush``); ``bsp=2`` on an
    ``ssp_init(1)`` store (one clock tick a step, losses equal to
    ``bsp=0``'s); p50 of each.  (c) ``embed_mode='lru'`` (the native
    ``CacheSparseTable``): the store's native library loaded, p50 and hit
    rate.
44. The remaining transformer families (``FAMILIES``).  (a) The flash
    kernels vs their plain versions at their new shapes, timed as phase
    21's with the bound and SDPA beside each: Swin-T stage 1's 49-token
    windows (BH 1,536, D 32), shifted (mask group ``b`` over the 512
    windows + bias group ``h``) and unshifted (bias ``h``); ViT-B/16
    (dense, S 196); CLIP's text tower (causal, S 77); Transformer-XL wt103
    (causal + bias ``h``, S_q 128 over 288 keys, D 41 zero-padded to 44,
    and the entry at D = 41 end to end against the plain attention, three
    ``dpad_launches``); BigBird-base (block-sparse mask ``one``, S 1024).
    (b) ViT-B/16 and Swin-T at full width and depth, batch 8,
    ``AdamOptimizer(1e-4)`` through ``Executor.run``: 2 warm-up and 10
    counted steps (every flash counter of the path at its launches a step,
    none other, no ``backend:`` fallback), p50 / p99, samples/s, MFU
    against 67 TFLOP/s from ``profile_train.graph_flops`` (linear layers
    and attention on its visible pairs), peak memory, 3 profiled steps
    (idle share, flash time by entry), then step 1 at batch 2 on the card
    against the CPU from the same weights (loss within
    ``TRAIN_LOSS_RTOL``, every gradient within ``TRAIN_GRAD_RTOL`` /
    ``TRAIN_GRAD_ATOL``).  (c) BART-base, BigBird-base (seq 1024, batch
    2), CLIP ViT-B/32, MAE-base, the base Transformer, Transformer-XL wt103
    (memory 160, consecutive segments) and Reformer-base at published
    widths cut to 2 layers (2 + 2): 3 steps each with the counters read
    as in (b) (Reformer: none at all; Transformer-XL: every launch also a
    padded one, and its memory written), finite losses, p50; then the
    card-vs-CPU check at batch 2 with dropout 0 (Transformer-XL over two
    segments, the second reading the memory).
45. The serving planes at full width.  (a) GPT-2 small (published widths,
    seeded weights) behind a chunked ``DecodeEngine`` (``max_len`` 512, 8
    slots, chunk 32) and ``DecodeRouter``: ``SP_REQUESTS`` prompts of one
    seeded 256-token preamble and a seeded 16-64-token suffix each, 32 new
    tokens, first on an engine with no store, then on one with a
    ``PrefixKVStore`` (512 MiB) primed by one request that shares the
    preamble: every prompt a hit of at least 256 rows, fewer prefill rows,
    TTFT p50 cold against warm, the decode ``lengths`` (and its merge, as
    ``DecodeCalls`` records) and full-mask forwards launched with no
    ``backend:`` fallback and no other kernel, the streams equal the
    store-less engine's (or apart only at a near tie, phase 17's rule).
    (b) Two such replicas behind ``FrontDoor``, sharing one store and the
    weights, the same prompts: replica 1 killed once its streams hold
    ``SP_KILL_AFTER`` tokens, the door polled until every stream is done,
    each equal to the unkilled run of (a); the ``decode_recovery``
    counters and the ``recovery`` latency p50.  (c)
    ``bert_classify_graph(BertConfig.base(batch_size=32, seq_len=128),
    num_labels=2)`` from a directory ``Executor.save`` wrote, through
    ``ServingRouter(max_batch=32, max_wait_ms=2)`` from 8 submitting
    threads, 256 requests of ``synthetic_mlm_batch``'s rows: each response
    within ``SP_ROW_ATOL`` of ``iex.infer`` of the request alone, p50 / p99
    and requests/s, the key-mask forward launched 12 times a serving call;
    then 64 of them through a two-replica door of such routers with
    replica 1 killed: every admitted request answered.
46. The replicated parameter server and CTR serving at phase 9's
    configuration (BASELINE config 4: batch 2048, vocab 100,000, dim 16,
    one shared table).  Rank 0's ``DistributedStore(replication=2)`` binds
    first and four shard processes are spawned at once (ranks 1 and 2, and
    a standby for each, which binds its rank's port only when told), while
    (a) and (b) run.  (a) Wide & Deep through ``vlru_dev`` over a local
    store, float32 and ``compute_dtype='bfloat16'`` in ``CS_TURNS`` turns
    from one table and one set of weights, 8 steps each (the last
    ``CS_PROFILED`` profiled): bf16 losses within ``CS_BF16_PARITY`` of
    float32, B4 and B5 once a step, p50, busy and idle share; the last
    bf16 run's B4 and B5 calls are recorded and, after it, held to their
    plain versions and timed at those shapes (the row gradient float32),
    the ``wdl_bf16_rows`` shape rows of the kernels line.  (b) DeepFM and
    DCN (``deepfm_criteo`` / ``dcn_criteo``, ``vlru_dev``, float32),
    ``CS_MODEL_STEPS`` steps each (B4 / B5 once a step, p50, idle share),
    then 2 steps at batch ``CS_PARITY_BATCH`` on the card against the CPU
    from one table and one set of weights (losses within ``CTR_LOSS_RTOL``,
    the store table within ``CTR_TABLE_RTOL`` / ``CTR_TABLE_ATOL``).  (c)
    bench.py's failover schedule on Wide & Deep over the three-rank store:
    ``FO_STEPS`` steps on table 0 uninterrupted, then ``FO_STEPS`` on table
    1 with ``HETU_PS_REREPLICATE_EVERY=1``: shard 1's primary (rank 1's
    process) SIGKILLed after step ``FO_KILL`` (1-based), its standby
    relaunched after the next, the repair tick re-replicating it, the
    port's ``ps_fsck`` clean two steps before the promoted ex-backup (rank
    2's process) is SIGKILLed three steps before the end; per-step losses
    bit-equal to the uninterrupted run, failovers absorbed in exactly steps
    ``FO_KILL`` and ``FO_STEPS - 3`` (0-based), ``ps_failover_promoted``
    counted; rank 2's standby relaunched, ``maybe_re_replicate``, and
    ``ps_fsck --verify`` (exit 0) on the whole live cluster.  The
    replicated step's p50 beside phase 43's unreplicated two-shard p50, the
    wall time of each step that absorbed a failover.  (d) The killed run's
    weights behind ``ServingRouter(refresh_every_batches=4)`` over a
    read-only ``DistCacheTable`` on table 1, bucket ``CS_BUCKET``, while a
    writer thread pushes to the table: ``CS_SERVE_REQS`` single-row
    requests from ``CS_CLIENTS`` threads, shard 1's primary (the first
    standby) SIGKILLed halfway, every request answered and the failover
    counted (``serve_failovers``); the writer stopped, a refresh sweep
    joined, ``CS_CHECK_REQS`` requests whose answers are held to a direct
    forward on rows pulled from the store (``SP_ROW_ATOL``); then two cells
    of a ``CellMap``, each with its own read-only cache and router behind
    a ``CellHead``, warmed and serving their own waves (no rejection),
    ``catch_up``.  p50 / p99 latency, requests/s, refreshed rows.
47. The hybrid deployment (dense parameters averaged over
    ``DataParallel`` ranks, embedding rows in a sharded parameter server
    with a shard on every rank) through the launcher, at phase 9's
    configuration.  (a) Two ranks started by ``launcher.launch``, sharing
    the card over gloo, each running ``hetu_tpu_torch/tools/hybrid_wdl.py``
    (a shard of a two-shard ``DistributedStore``, ``wdl_criteo`` with
    ``embed_mode`` ``ps`` and ``vlru``, ``HY_STEPS`` BSP and ``HY_STEPS``
    ASP steps each, every rank fed the global batch, the dense weights and
    the table's rows those of this process's one-process run): both ranks'
    losses equal, ASP's equal to BSP's, the BSP losses within ``HY_RTOL``
    of a one-process run on the card over a local ``EmbeddingStore`` with
    the same feeds, its final table within ``CTR_TABLE_RTOL`` /
    ``CTR_TABLE_ATOL`` and its digest within ``HY_DIGEST_ATOL``; no
    embedding-cache kernel launched on a rank (the strategy refuses the
    device cache, so B4 and B5 are on no path here); p50 step and rank 0's
    device idle share per mode.  (b) Three ranks with
    ``HETU_PS_REPLICATION=2`` (the launcher's ``--ps-replication 2``), the
    hybrid BSP run over ``ps`` (batch ``HY_B_BATCH``, 2048 cut to a
    multiple of 3) without and then with ``HETU_CHAOS=HY_CHAOS``
    (dup 5 %, drop 2 %, shard 1's primary stopped after step 4): the run
    completes with one promotion, its losses and table bit-equal to the
    run without the schedule; the fault counters printed.
48. Print the card's name and power limit, the ``kernels`` JSON line (each
    flash row counts the launches of phases 38-42, 44 and 45 too, B4 and
    B5 those of phases 41-43 and 46, by kernels-line name; the rows of
    phase 44's shapes and phase 46's bf16 step under ``shapes``,
    Transformer-XL's padded launches under ``dpad_launches``) and, last,
    ``{"ok": true, "device": {...}}``.

Float32 matrix products run in full float32:
``torch.backends.cuda.matmul.allow_tf32`` is set False.  The bf16 ones
run on the tensor cores (cuBLAS), as the JAX package leaves them to XLA.
"""
import collections
import contextlib
import copy
import gc
import json
import math
import multiprocessing
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback
import types
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
# ResNet-18 / CIFAR10 (BASELINE config 1, bench.py's build_resnet18_graph):
# batch 128; the dataloader-fed run's steps; the card-vs-CPU cut
RN_BATCH, RN_WARMUP, RN_STEPS, RN_PROFILED = 128, 3, 20, 3
RN_DL_STEPS = 10
RN_CPU_BATCH, RN_CPU_STEPS = 8, 3
# ResNet-18 card vs CPU (float32, TF32 off, cuDNN's autotuned algorithms,
# FFT-based ones among them, against the CPU's): the step-1 loss rtol; the
# later losses rtol (lr 0.1 on 8 samples amplifies the first step's
# rounding: step 3 measured 4.1e-3 apart); each step-1 gradient by its
# relative norm (measured 1.5e-4); each running statistic by its relative
# norm after step 1 and after the later steps (2.2e-3 measured at most)
RN_LOSS_RTOL, RN_TRAJ_RTOL = 1e-4, 2e-2
RN_GRAD_RELNORM = 1e-3
RN_STATS_RELNORM = (1e-4, 2e-2)
# data parallel (phases 38 and 39): the steps held to the plain executor,
# the timed steps of each executor, the profiled ones; BERT-base through
# the strategy at world size 1 against the plain executor (the same
# arithmetic: bit-equal expected); phase 39's world, global batches and
# each child's time limit
DP_STEPS, DP_TIMED, DP_PROFILED = 3, 8, 2
DP_BERT_RTOL = 1e-6
# ResNet-18 where the strategy's sync BN and the plain executor's
# F.batch_norm round the forward differently.  They are one function:
# phase 38's probe holds the two to TIE_F64_RELNORM in float64 on the card
# (tests/test_torch_parallel.py: 1e-12 on the CPU).  In float32 the rounding
# change moves now and then a ReLU pre-activation within ~1e-6 of 0 across
# it, and every gradient upstream of that ReLU changes by one row's term of
# a sum over the N rows of a channel (batch x height x width), of the order
# of 1/sqrt(N) of its norm: 5.4e-3 measured at batch 128, 1.1e-2 at batch 8
# over two ranks.  Phase 38's probe locates those pre-activations on the
# card; a step-1 gradient with no flipped ReLU downstream keeps phase 37's
# RN_GRAD_RELNORM, one with a flip RN_TIE_GRAD_RELNORM.  After such a step
# 1, lr 0.1 on 8 samples carries the changed update into phase 39's later
# losses and statistics (1.9e-2 and 2.0e-2 apart at step 3 in every card
# run), held to RN_TIE_TRAJ (loss rtol, relative norm).  Both set after
# those card runs
RN_TIE_GRAD_RELNORM = 2e-2
RN_TIE_TRAJ = (5e-2, 5e-2)
TIE_F64_RELNORM = 1e-10
DP2_WORLD, DP2_BERT_BATCH, DP2_RN_BATCH, DP2_TIMEOUT = 2, 16, 8, 240
# phase 39's transformer graphs at published widths cut to 2 layers (2 + 2
# for T5): global batch, steps, and the flash launches a step of each
# kernels-line name (GPT-2: causal a layer; T5: a bias and a key mask an
# encoder layer, a causal bias and a cross-attention key mask a decoder
# layer; XLNet: two streams a layer less the last content stream;
# Longformer: the window mask a layer)
DP2_CUT = {"gpt2": (4, 2, {"causal": 2}),
           "t5": (8, 2, {"bias": 2, "bias_causal": 2, "": 2}),
           "xlnet": (4, 2, {"mask_bias": 3}),
           "longformer": (2, 2, {"mask": 2})}
# phase 40: ZeRO on two ranks of the card, BERT-base at phase 6's cell
ZERO_STAGES, ZERO_STEPS, ZERO_TIMEOUT = (0, 1, 2, 3), 3, 300
# phase 41: the training loop's state at phase 6's cell; the accumulated
# step's first loss and its next two against the plain step's (only the
# order of the reductions differs; set before the first card run)
STATE_STEPS, REMAT_STEPS, ACC_M, ACC_STEPS = 6, 2, 2, 3
STATE_LR = (1e-4, 2, 8)
REMAT_POLICIES = ("off", "dots", "full", "offload")
ACC_RTOL = (1e-5, 1e-3)
# phase 42: the executor's run surface at phase 6's cell.  (b) 12 counted
# steps a loop in 3 turns of 4 (the async window of 4 stays full from the
# second turn on), then one profiled turn of 3; (c) steps fed by loaders;
# (d) steps a precision; (e) steps a remat plan and the budget that
# remats everything; (g) WDL steps a mode
RS_TURNS, RS_TURN_STEPS, RS_PROFILED = 3, 4, 3
RS_DL_STEPS, RS_PREC_STEPS, RS_REMAT_STEPS, RS_WDL_STEPS = 6, 5, 2, 8
RS_SMALL_BUDGET_MB = 1
RS_PRECISIONS = (None, "tensorfloat32", "bfloat16")
# phase 43: the sharded parameter server at phase 9's configuration, the 8
# ctr_batches a run: (a) turns of the local and the two-shard store, each
# run's first step untimed and its last PS_PROFILED profiled; the tables
# each store makes ((a) one a turn, (b) BSP, ASP flushed each step, ASP,
# SSP); the seconds the shard process may take to start or stop
PS_TURNS, PS_PROFILED, PS_TABLES, PS_TIMEOUT = 2, 2, 6, 120
# phase 44: the remaining transformer families.  The batch of (a)'s Swin
# and ViT shapes, of (b) and of (c) but BigBird, Transformer-XL and
# Reformer (their configs' own 2, 4 and 2); (b)'s warm-up, counted and
# profiled steps; the card-vs-CPU checks' batch (the CPU's step of the
# full-depth models at batch 8 would take most of the phase); (c)'s steps
FAM_BATCH, FAM_WARMUP, FAM_STEPS, FAM_PROFILED = 8, 2, 10, 3
FAM_PARITY_BATCH, FAM_CUT_STEPS = 2, 3


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


#: floats of the decode and row-gather timings' L2 flush: a 512 MB fill
#: keeps the device busy (about 0.17 ms) past the host's work in the decode
#: wrapper (the split plan, the partials' allocation) and in the gathers'
#: (the launch plan, the output's allocation), which a 256 MB fill (about
#: 0.085 ms) did not always outlast: then the host's enqueue showed in the
#: time (the gathers: 0.031-0.036 ms in a run whose 512 MB timings read
#: 0.013-0.018)
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
    flush_buf = torch.empty(DECODE_FLUSH, dtype=torch.float32, device="cuda")
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
                                ("w=128", 5000, 128, 2051),
                                ("w=2048", 2000, 2048, 3001),
                                # more chunks than the grid takes at once
                                ("n=300000, rounds", 70000, 16, 300000)):
        gcases.append((name, torch.from_numpy(
            rng.randn(rows_, w_).astype(np.float32)).cuda(),
            torch.from_numpy(rng.randint(0, rows_, n_).astype(np.int32))
            .cuda()))
    # rows of 16 floats starting one float (4 bytes) into the buffer
    gcases.append(("slab 4 bytes off alignment", torch.from_numpy(
        rng.randn(5000 * 16 + 1).astype(np.float32)).cuda()[1:].view(5000, 16),
        torch.from_numpy(rng.randint(0, 5000, 4099).astype(np.int32)).cuda()))
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


def gather_plan_of(md, src, idx):
    """The launch plan (ctas, rows) the MoE row gather's wrapper makes for
    ``src`` and ``idx`` on this card: the bulk route's grid and the rows of
    its blocks, or (0, 0) for the chunk-a-thread route."""
    return md.gather_plan(idx.shape[0], src.shape[1], src.element_size(),
                          src.data_ptr(), 0, md._build.sm_count(src.device))


def block_all_neg(md, src, idx):
    """``idx`` with the second block of its launch plan for ``src`` set to
    -1: a block whose every row is zeros, none of them read."""
    _, rows = gather_plan_of(md, src, idx)
    if not rows:
        raise AssertionError("a block all -1: the plan takes no blocks")
    out = idx.clone()
    out[rows:2 * rows] = -1
    return out


class GatherCalls:
    """While open, records the MoE row gather's launches by (dtype, n, m,
    source rows): it wraps ``md.kernel``, through which ``row_gather``
    reaches its C entry (the plain version and the counters are left
    alone), and counts each call of the entry it returns."""

    def __init__(self, md):
        self.md, self.inner = md, md.kernel
        self.shapes = {}

    def __enter__(self):
        def kernel(dtype):
            fn = self.inner(dtype)

            def launch(src, idx, out, n, m, src_rows, *rest):
                key = (str(dtype)[6:], n, m, src_rows)
                self.shapes[key] = self.shapes.get(key, 0) + 1
                return fn(src, idx, out, n, m, src_rows, *rest)
            return launch

        self.md.kernel = kernel
        return self

    def __exit__(self, *exc):
        self.md.kernel = self.inner

    def count(self, dtype, n, src_rows):
        """Launches on ``dtype`` rows gathering ``n`` of ``src_rows``."""
        return sum(c for (dt, n_, _, r), c in self.shapes.items()
                   if dt == dtype and n_ == n and r == src_rows)


def phase_moe_kernels(ht, pm, md):
    """The MoE row gather vs its plain version at the MoE path's shapes
    (a real gate's maps), edge cases; the autograd functions kernel vs
    plain bit for bit; times."""
    flush_buf = torch.empty(DECODE_FLUSH, dtype=torch.float32, device="cuda")
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
    log(f"[moe-kernels] launch plans (ctas, rows): dispatch "
        f"{gather_plan_of(md, x, tos)}, combine "
        f"{gather_plan_of(md, buffers, sot_t[0])}")
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
             ("w=16, src 4 bytes off alignment",
              rand(1, 5000 * 16 + 1).view(-1)[1:].view(5000, 16),
              ints(-1, 5000, 4099)),
             ("w=2048", rand(2000, 2048), ints(-1, 2000, 3001)),
             ("a block all -1", buffers,
              block_all_neg(md, buffers, sot_t[0])),
             ("n=300000, rounds", rand(70000, 16), ints(-1, 70000, 300000))]
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
               "max_abs_err": 0.0, "n": idx.shape[0],
               "src_rows": src.shape[0]}
        row["bound_ms"], row["bound_by"] = gather_bound(src, idx)
        log(f"[moe-kernels] row gather timing ({name}, n={idx.shape[0]} "
            f"m={m} src_rows={src.shape[0]}; library = index_select + "
            f"masked_fill_): {json.dumps(row)}")
        lines[name] = row
    return lines["dispatch fwd"], lines[cases[1][0]]


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
    flush_buf = torch.empty(DECODE_FLUSH, dtype=torch.float32, device="cuda")
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
             ("w=2048", rand(2000, 2048), ints(-1, 2000, 3001)),
             ("a block all -1", buffers,
              block_all_neg(md, buffers, sot_t[0])),
             ("n=300000, rounds", rand(70000, 16), ints(-1, 70000, 300000))]
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
               "max_abs_err": 0.0, "n": idx.shape[0],
               "src_rows": src.shape[0]}
        row["bound_ms"], row["bound_by"] = gather_bound(src, idx)
        log(f"[moe-bf16-kernels] bf16 row gather timing ({name}, n="
            f"{idx.shape[0]} m={m} src_rows={src.shape[0]}; library = "
            f"index_select + masked_fill_): {json.dumps(row)}")
        lines[name] = row
    return lines["dispatch fwd"], lines[cases[1][0]]


def phase_moe_train(ht, pm, metrics, kmods, md, compute_dtype=None):
    """The MoE configuration trained through SparseMoELayer on the card,
    then the dense MoELayer graph the same way; float32, or bf16 mixed
    precision with ``compute_dtype="bfloat16"``.  Returns the sparse
    graph's row-gather launches by kernels-line name, and its counted
    steps' launches by shape (a ``GatherCalls``)."""
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
        with GatherCalls(md) as calls:
            for _ in range(MOE_STEPS):
                t0 = time.perf_counter()
                losses.append(step())       # the loss copy waits for it
                times.append(time.perf_counter() - t0)
        launches = {"row_gather": md.launches,
                    "row_gather_bf16": md.bf16_launches}
        if sum(calls.shapes.values()) != sum(launches.values()):
            raise AssertionError(f"row gather launches {launches} but "
                                 f"{calls.shapes} recorded")
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
        # a dtype whose gathers launched must show device time under
        # pm.B6_KERNELS' names (a renamed kernel would read 0)
        for dt, counter in (("float32", "row_gather"),
                            ("bfloat16", "row_gather_bf16")):
            if launches[counter] and not gather_us[dt] > 0:
                raise AssertionError(
                    f"{launches[counter]} {dt} row gathers launched, but no "
                    f"kernel named {pm.B6_KERNELS[dt]} has device time")
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
            "launches": launches,
            "launches_by_shape": {" ".join(map(str, key)): c for key, c
                                  in sorted(calls.shapes.items())},
            "card": card_line()}
        log(f"{tag} {json.dumps(reports[graph])}")
        reports[graph]["calls"] = calls
        ex.close()
        del ex, fd
        torch.cuda.empty_cache()
    sp, de = reports["sparse"], reports["dense"]
    log(f"{tag} step p50 sparse {sp['step_ms_p50']:.3f} ms, dense "
        f"{de['step_ms_p50']:.3f} ms (dense / sparse "
        f"{de['step_ms_p50'] / sp['step_ms_p50']:.2f}); peak memory sparse "
        f"{sp['peak_mem_gib']:.3f} GiB, dense {de['peak_mem_gib']:.3f} GiB")
    return sp["launches"], sp["calls"]


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
    must read ``want`` (or, with a dict ``want``, its own count); every
    other counter must read 0 and no attention may take ``backend:cpu``;
    the loss must be finite and must not rise.
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
    wants = want if isinstance(want, dict) else dict.fromkeys(launches,
                                                               want)
    if got != wants:
        raise AssertionError(f"{tag} launches {got} != {wants}")
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


# -- ResNet-18 / CIFAR10 (no hand kernel: cuDNN through torch) ---------------

def resnet_run(ht, kmods, tag, macs, compute_dtype=None, data_format="NCHW",
               loader=None, steps=RN_STEPS, profiled=True):
    """bench.py's ResNet-18 step (``profile_train.resnet18_step``) on the
    card: ``RN_WARMUP`` warm-up and ``steps`` counted steps with every
    launch counter set to 0 just before and read just after (the path
    launches no hand kernel: every counter must read 0), the loss finite,
    the masters float32; then ``RN_PROFILED`` profiled steps (device busy
    time, idle share, the time by kernel family).  ``loader``: (x, y) fed
    through ``dataloader_op``.  ``macs``: the forward's multiply-adds.
    Returns the report."""
    from hetu_tpu_torch.tools import profile_train as pt
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ex, fd, loss = pt.resnet18_step(RN_BATCH, data_format, compute_dtype,
                                    device="cuda", loader=loader)
    pt.label_optimizers(ex)
    log(f"{tag} executor built in {time.perf_counter() - t0:.1f} s")

    def step():
        return float(ex.run("train", feed_dict=fd)[0].asnumpy())

    t0 = time.perf_counter()
    losses = [step() for _ in range(RN_WARMUP)]
    log(f"{tag} {RN_WARMUP} warm-up steps (cuDNN autotuning) in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    reset_launches(*kmods)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step())                       # waits for the step
        times.append(time.perf_counter() - t0)
    launched = {name: n for m in kmods for name, n in vars(m).items()
                if name.endswith("launches") and n}
    if launched:
        raise AssertionError(f"{tag} hand kernels launched: {launched}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag} non-finite training loss: {losses}")
    bad = [ex.var_names[n] for n, v in ex.var_values.items()
           if v.dtype != torch.float32]
    if bad:
        raise AssertionError(f"{tag} variables left float32: {bad[:5]}")
    ms = np.asarray(times) * 1e3
    step_s = ms.mean() / 1e3
    flops = 3 * 2 * macs
    peak = ("bf16", PEAK_BF16_FLOPS) if compute_dtype else \
        ("fp32", PEAK_FP32_FLOPS)
    report = {"batch": RN_BATCH, "data_format": data_format,
              "compute_dtype": compute_dtype or "float32",
              "fed_by": "dataloader_op" if loader is not None
              else "placeholders",
              "cudnn_benchmark": torch.backends.cudnn.benchmark,
              "steps": steps, "losses": losses,
              "step_ms_p50": float(np.percentile(ms, 50)),
              "step_ms_p99": float(np.percentile(ms, 99)),
              "step_ms_mean": float(ms.mean()),
              "samples_per_s": RN_BATCH / step_s,
              "model_tflop_per_step": flops / 1e12,
              "mfu_" + peak[0]: flops / step_s / peak[1],
              "peak_mem_gib": (torch.cuda.max_memory_allocated() - base)
              / 2 ** 30,
              "hand_kernel_launches": 0, "card": card_line()}
    if profiled:
        prof_rep, prof = pt.profile_steps(step, RN_PROFILED, step_s)
        if not prof_rep["device_busy_ms_per_step"] > 0:
            raise AssertionError(f"{tag} the profiler saw no device time")
        report["profiled"] = {k: prof_rep[k] for k in (
            "wall_ms_per_step", "device_busy_ms_per_step",
            "device_idle_share", "device_idle_share_unprofiled",
            "kernels_per_step", "top_kernels")}
        report["families_ms_per_step"] = pt.resnet_families(prof,
                                                            RN_PROFILED)
        report["conv_apart_ms_per_step"] = pt.conv_apart_ms(
            loss, {n: np.shape(v) for n, v in fd.items()}, compute_dtype)
    ex.close()
    del ex
    torch.cuda.empty_cache()
    return report


def phase_resnet_train(ht, kmods):
    """Phase 35: ResNet-18 at bench.py's shape in float32 and bf16 (NCHW),
    then bf16 NHWC (a finding).  Returns the float32 report."""
    from hetu_tpu_torch.tools import profile_train as pt
    torch.backends.cudnn.benchmark = pt.CUDNN_BENCHMARK
    log(f"[resnet] torch.backends.cudnn.benchmark = "
        f"{torch.backends.cudnn.benchmark} for every ResNet run; "
        f"cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")
    x = ht.placeholder_op("x", shape=(RN_BATCH, 3, 32, 32))
    y = ht.placeholder_op("y", shape=(RN_BATCH, 10))
    loss, _ = ht.models.resnet18(x, y)
    macs = pt.graph_flops(loss, {x: x.shape, y: y.shape})
    total = macs["conv"] + macs["linear"]
    log(f"[resnet] forward multiply-adds from the graph's shapes: "
        f"{json.dumps(macs)} ({total / RN_BATCH / 1e9:.4f} G a sample); "
        f"a training step counts 3 x 2 x {total} = {6 * total / 1e12:.4f} "
        f"TFLOP")
    reports = {}
    for tag, cd, df in (("[resnet-f32]", None, "NCHW"),
                        ("[resnet-bf16]", "bfloat16", "NCHW"),
                        ("[resnet-bf16-nhwc]", "bfloat16", "NHWC")):
        rep = resnet_run(ht, kmods, tag, total, cd, df)
        losses = rep["losses"]
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{tag} loss did not fall: {losses}")
        log(f"{tag} {json.dumps(rep)}")
        log(f"{tag} p50 {rep['step_ms_p50']:.3f} ms, p99 "
            f"{rep['step_ms_p99']:.3f} ms, {rep['samples_per_s']:.1f} "
            f"samples/s, peak {rep['peak_mem_gib']:.3f} GiB, idle "
            f"{rep['profiled']['device_idle_share_unprofiled']:.4f}")
        reports[tag] = rep
    rep32 = reports["[resnet-f32]"]
    rep32["macs"] = total
    return rep32


def phase_resnet_dataloader(ht, kmods, rep32):
    """Phase 36: ResNet-18 fed by ``dataloader_op`` over ``cifar10()``'s
    synthetic training split (prefetch on), float32 NCHW."""
    tx, ty, _, _ = ht.data.cifar10()
    rep = resnet_run(ht, kmods, "[resnet-dataloader]", rep32["macs"],
                     loader=(tx, ty), steps=RN_DL_STEPS, profiled=False)
    log(f"[resnet-dataloader] {json.dumps(rep)}")
    log(f"[resnet-dataloader] p50 {rep['step_ms_p50']:.3f} ms beside the "
        f"placeholder-fed p50 {rep32['step_ms_p50']:.3f} ms (float32)")


def _resnet_parity_run(ht, device, weights):
    """ResNet-18 at batch ``RN_CPU_BATCH`` on ``device``, float32,
    ``RN_CPU_STEPS`` Momentum steps: (losses, step-1 gradients by name,
    running statistics after each step, the initial weights)."""
    x = ht.placeholder_op("x", shape=(RN_CPU_BATCH, 3, 32, 32))
    y = ht.placeholder_op("y", shape=(RN_CPU_BATCH, 10))
    loss, _ = ht.models.resnet18(x, y)
    wrt = [n for n in ht.topo_sort([loss])
           if getattr(n, "is_variable", False) and n.trainable]
    ex = ht.Executor({"train": [loss, ht.optim.MomentumOptimizer(0.1)
                                .minimize(loss)] + ht.gradients(loss, wrt)},
                     seed=0, device=device)
    if weights is None:
        weights = ex.return_tensor_values()
    ex.load_dict(weights)
    rng = np.random.RandomState(0)
    fd = {x: rng.rand(RN_CPU_BATCH, 3, 32, 32).astype(np.float32),
          y: np.eye(10, dtype=np.float32)[rng.randint(0, 10, RN_CPU_BATCH)]}
    losses, stats, grads = [], [], None
    for _ in range(RN_CPU_STEPS):
        out = ex.run("train", feed_dict=fd)
        losses.append(float(out[0].asnumpy()))
        if grads is None:
            grads = {n.name: g.asnumpy() for n, g in zip(wrt, out[2:])}
        stats.append({k: v for k, v in ex.return_tensor_values().items()
                      if "_running_" in k})
    return losses, grads, stats, weights


def phase_resnet_parity(ht):
    """Phase 37: ResNet-18 at batch 8, float32, card against CPU from the
    same weights for 3 Momentum steps: the step-1 loss within
    ``RN_LOSS_RTOL``, the later ones within ``RN_TRAJ_RTOL``, every step-1
    gradient within ``RN_GRAD_RELNORM`` and every running statistic within
    ``RN_STATS_RELNORM`` after step 1, then after each later step
    (relative norms)."""
    t0 = time.perf_counter()
    card = _resnet_parity_run(ht, "cuda", None)
    host = _resnet_parity_run(ht, "cpu", card[3])

    def rel(a, b):
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

    loss_err = [abs(a - b) / abs(b) for a, b in zip(card[0], host[0])]
    grad_err = {n: rel(card[1][n], host[1][n]) for n in host[1]}
    stats_err = [max(rel(c[k], h[k]) for k in h)
                 for c, h in zip(card[2], host[2])]
    worst = max(grad_err, key=grad_err.get)
    log(f"[resnet-parity] batch {RN_CPU_BATCH}, {RN_CPU_STEPS} steps in "
        f"{time.perf_counter() - t0:.1f} s: losses card {card[0]} CPU "
        f"{host[0]}, relative error by step {loss_err} (rtol "
        f"{RN_LOSS_RTOL}, then {RN_TRAJ_RTOL}); {len(grad_err)} step-1 "
        f"gradients, worst relative norm {grad_err[worst]:.3e} ({worst}; "
        f"gate {RN_GRAD_RELNORM}); {len(host[2][0])} running statistics, "
        f"worst relative norm by step {stats_err} (gates "
        f"{RN_STATS_RELNORM})")
    if not all(math.isfinite(v) for v in card[0]) \
            or loss_err[0] > RN_LOSS_RTOL \
            or max(loss_err[1:]) > RN_TRAJ_RTOL \
            or grad_err[worst] > RN_GRAD_RELNORM \
            or stats_err[0] > RN_STATS_RELNORM[0] \
            or max(stats_err[1:]) > RN_STATS_RELNORM[1] \
            or len(host[2][0]) != 40:
        raise AssertionError("ResNet-18 card vs CPU disagree")


# -- data parallel ----------------------------------------------------------------

def dp_workload(ht, model, batch):
    """(loss, feed dict, optimizer) of a data-parallel workload, fed the
    global batch: ``bert-base`` (phase 6's cell, dropout 0.1),
    ``bert-tiny`` (dropout 0), ``resnet18`` (bench.py's feeds), or one of
    ``DP2_CUT``'s models at published widths cut to 2 layers (2 + 2 for
    T5), dropout 0, Adam 1e-4: ``gpt2`` (seq 1024), ``t5`` (source 512,
    target 114, ``use_mask=True``), ``xlnet`` (seq 512), ``longformer``
    (seq 4096)."""
    if model in DP2_CUT:
        if model == "gpt2":
            cfg = ht.GPT2Config.small(n_layer=2, batch_size=batch,
                                      seq_len=GPT_SEQ, resid_pdrop=0.0,
                                      embd_pdrop=0.0, attn_pdrop=0.0)
            feeds, loss, _ = ht.gpt2_lm_graph(cfg)
            ids, labels = ht.models.gpt2.synthetic_lm_batch(cfg, seed=0)
            fd = {feeds["input_ids"]: ids, feeds["labels"]: labels}
        elif model == "t5":
            cfg = ht.T5Config.small(num_layers=2, batch_size=batch,
                                    src_len=T5_SRC, tgt_len=T5_TGT,
                                    dropout_rate=0.0)
            feeds, loss, _ = ht.t5_seq2seq_graph(cfg, use_mask=True)
            fd = _t5_feeds(feeds, ht.synthetic_seq2seq_batch(
                cfg, seed=0, padded=True))
        elif model == "xlnet":
            cfg = ht.XLNetConfig.base(n_layer=2, batch_size=batch,
                                      seq_len=XL_SEQ, dropout=0.0)
            feeds, loss, _ = ht.xlnet_plm_graph(cfg)
            fd = {feeds[k_]: v_ for k_, v_ in zip(
                ("input_ids", "content_mask", "query_mask", "labels"),
                ht.synthetic_plm_batch(cfg, seed=0))}
        else:
            cfg = ht.LongformerConfig.base(num_hidden_layers=2,
                                           batch_size=batch, seq_len=LF_SEQ,
                                           hidden_dropout_prob=0.0)
            feeds, loss, _ = ht.longformer_mlm_graph(cfg)
            fd = {feeds[k_]: v_ for k_, v_ in zip(
                ("input_ids", "labels"), ht.synthetic_mlm_ids(cfg, 0))}
        return loss, fd, ht.optim.AdamOptimizer(1e-4)
    if model.startswith("bert"):
        if model == "bert-base":
            cfg = ht.BertConfig.base(batch_size=batch, seq_len=TRAIN_SEQ)
        else:
            cfg = ht.BertConfig.tiny(batch_size=batch, seq_len=32,
                                     hidden_dropout_prob=0.0,
                                     attention_probs_dropout_prob=0.0)
        feeds, loss, _ = ht.bert_pretrain_graph(cfg)
        fd = _bert_feeds(feeds, ht.synthetic_mlm_batch(cfg, seed=0))
        lr = 1e-4 if model == "bert-base" else 1e-3
        return loss, fd, ht.optim.AdamOptimizer(lr)
    x = ht.placeholder_op("x", shape=(batch, 3, 32, 32))
    y = ht.placeholder_op("y", shape=(batch, 10))
    loss, _ = ht.models.resnet18(x, y)
    rng = np.random.RandomState(0)
    fd = {x: rng.rand(batch, 3, 32, 32).astype(np.float32),
          y: np.eye(10, dtype=np.float32)[rng.randint(0, 10, batch)]}
    return loss, fd, ht.optim.MomentumOptimizer(0.1)


def dp_executor(ht, model, batch, strategy=None, grads=True, **kw):
    """(executor, feed dict, trainable variables) of ``dp_workload`` on
    the card, ``Executor(seed=0, **kw)``; with ``grads`` every trainable
    variable's gradient is fetched after the loss and the step."""
    loss, fd, opt = dp_workload(ht, model, batch)
    wrt = [n for n in ht.topo_sort([loss])
           if getattr(n, "is_variable", False) and n.trainable]
    fetches = [loss, opt.minimize(loss)] + (ht.gradients(loss, wrt)
                                            if grads else [])
    ex = ht.Executor({"train": fetches}, seed=0, device="cuda",
                     dist_strategy=strategy, **kw)
    return ex, fd, wrt if grads else []


def flash_launches(fa):
    """{kernels-line name: launches} of every nonzero training flash
    counter; the decode counters must read 0."""
    if fa.launches or fa.merge_launches:
        raise AssertionError(f"decode kernels launched: {fa.launches}, "
                             f"{fa.merge_launches}")
    return {line_name(c): n for c, n in vars(fa).items()
            if c.endswith("_launches") and n}


def dp_steps(ex, fd, wrt, steps):
    """``steps`` steps: losses, step-1 gradients by name (``wrt``), the
    running statistics by name after each step."""
    losses, grads, stats = [], None, []
    for _ in range(steps):
        out = ex.run("train", feed_dict=fd)
        losses.append(float(out[0].asnumpy()))
        if grads is None:
            grads = {n.name: g.asnumpy() for n, g in zip(wrt, out[2:])}
        stats.append({ex.var_names[n]: v.cpu().numpy()
                      for n, v in ex.var_values.items()
                      if "_running_" in ex.var_names[n]})
    return {"losses": losses, "grads": grads, "stats": stats}


def _relnorm(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def hold_to_phase37_gates(tag, got, want, grad_gate=RN_GRAD_RELNORM,
                          later=(RN_TRAJ_RTOL, RN_STATS_RELNORM[1])):
    """``got`` against ``want`` (``dp_steps`` records) at phase 37's
    gates: the step-1 loss within ``RN_LOSS_RTOL``, the later losses and
    running statistics within ``later`` (loss rtol, relative norm), every
    step-1 gradient and the step-1 statistics by their relative norms.
    ``grad_gate``: one relative norm, or one a variable by name, or a pair
    ``(rtol, atol)`` that holds every gradient elementwise, as phase 7
    holds BERT's.  Returns the errors."""
    loss_err = [abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                   want["losses"])]
    if isinstance(grad_gate, tuple):
        grad_err = {k: float(np.max(np.abs(got["grads"][k] - w)))
                    for k, w in want["grads"].items()}
        grad_ok = all(np.allclose(got["grads"][k], w, rtol=grad_gate[0],
                                  atol=grad_gate[1])
                      for k, w in want["grads"].items())
    else:
        gates = grad_gate if isinstance(grad_gate, dict) \
            else dict.fromkeys(want["grads"], grad_gate)
        grad_err = {k: _relnorm(got["grads"][k], w)
                    for k, w in want["grads"].items()}
        grad_ok = all(e <= gates[k] for k, e in grad_err.items())
    worst = max(grad_err, key=grad_err.get, default=None)
    total = float(np.sqrt(sum(np.sum((got["grads"][k] - w) ** 2)
                              for k, w in want["grads"].items()))
                  / max(np.sqrt(sum(np.sum(w ** 2)
                                    for w in want["grads"].values())),
                        1e-30))
    stats_err = [max((_relnorm(g[k], w[k]) for k in w), default=0.0)
                 for g, w in zip(got["stats"], want["stats"])]
    errs = {"loss_rel_err_by_step": loss_err,
            "grad_worst": [worst, grad_err.get(worst)],
            "grad_total_relnorm": total,
            "stats_worst_relnorm_by_step": stats_err}
    if not all(math.isfinite(v) for v in got["losses"]) \
            or sorted(got["grads"]) != sorted(want["grads"]) \
            or loss_err[0] > RN_LOSS_RTOL \
            or max(loss_err[1:]) > later[0] \
            or not grad_ok \
            or (stats_err and stats_err[0] > RN_STATS_RELNORM[0]) \
            or (stats_err and max(stats_err[1:]) > later[1]):
        raise AssertionError(f"{tag} disagree at phase 37's gates: "
                             f"{json.dumps(errs)}")
    return errs


def collective_ms(prof, steps):
    """The all-reduces of a profile, a step: NCCL kernels' device ms and
    launches, and ``c10d::allreduce_`` calls and their host ms (the
    profiled host time: the profiler slows the host)."""
    from hetu_tpu_torch.tools import profile_train as pt
    us, n = 0.0, 0
    for e in pt.device_kernels(prof):
        if "nccl" in e.name.lower():
            us += e.time_range.end - e.time_range.start
            n += 1
    host = [e for e in prof.key_averages() if e.key == "c10d::allreduce_"]
    calls = sum(e.count for e in host)
    host_us = sum(e.cpu_time_total for e in host)
    return {"nccl_ms_per_step": us / steps / 1e3,
            "nccl_kernels_per_step": n / steps,
            "allreduce_calls_per_step": calls / steps,
            "allreduce_host_ms_per_step_profiled": host_us / steps / 1e3}


def dp_time_and_profile(tag, runs, batch):
    """``DP_TIMED`` steps of each executor in turns (plain, strategy,
    strategy, plain, ...: p50, fastest, slowest), then ``DP_PROFILED``
    profiled strategy steps.
    ``runs``: {"plain" / "dp": (executor, its feed dict)}.  Returns the
    report."""
    from hetu_tpu_torch.tools import profile_train as pt
    times = {"plain": [], "dp": []}
    order = ["plain", "dp", "dp", "plain"] * (DP_TIMED // 2)
    for which in order:
        ex, fd = runs[which]
        t0 = time.perf_counter()
        float(ex.run("train", feed_dict=fd)[0].asnumpy())  # waits
        times[which].append(time.perf_counter() - t0)
    p50 = {k: float(np.percentile(np.asarray(v) * 1e3, 50))
           for k, v in times.items()}
    spread = {k: [min(v) * 1e3, max(v) * 1e3] for k, v in times.items()}
    dp, fd = runs["dp"]
    rep, prof = pt.profile_steps(
        lambda: float(dp.run("train", feed_dict=fd)[0].asnumpy()),
        DP_PROFILED, p50["dp"] / 1e3)
    coll = collective_ms(prof, DP_PROFILED)
    report = {"batch": batch, "timed_steps_each": DP_TIMED,
              "plain_step_ms_p50": p50["plain"],
              "dp_step_ms_p50": p50["dp"],
              "plain_step_ms_min_max": spread["plain"],
              "dp_step_ms_min_max": spread["dp"],
              "plain_samples_per_s": batch / (p50["plain"] / 1e3),
              "dp_samples_per_s": batch / (p50["dp"] / 1e3),
              **coll,
              "dp_device_busy_ms_per_step": rep["device_busy_ms_per_step"],
              "dp_device_idle_share_unprofiled":
                  rep["device_idle_share_unprofiled"],
              "card": card_line()}
    log(f"{tag} {json.dumps(report)}")
    log(f"{tag} p50 plain {p50['plain']:.3f} ms, DataParallel "
        f"{p50['dp']:.3f} ms; all-reduce (NCCL kernels) "
        f"{coll['nccl_ms_per_step']:.4f} ms a step over "
        f"{coll['nccl_kernels_per_step']:g} launches; "
        f"{coll['allreduce_calls_per_step']:g} c10d all-reduce calls a step, "
        f"{coll['allreduce_host_ms_per_step_profiled']:.3f} host ms "
        f"(profiled)")
    return report


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True)`` (with the cuBLAS
    workspace setting it asks for), the previous state restored after."""
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    prev = torch.are_deterministic_algorithms_enabled()
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev)
        if env is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env


def resnet_tie_probe(ht, weights):
    """Phase 38's ResNet-18 probe: one step-1 forward and backward at
    ``RN_BATCH`` from ``weights``, lowered the plain way and by the
    batch-axis rules on the group of one (sync BN), on the card, as the
    executor's step lowers it.  In float64 the two must agree to
    ``TIE_F64_RELNORM`` (loss and every gradient): one function.  In
    float32 it locates the ReLU pre-activations on opposite sides of 0 in
    the two, and every gradient with none of them downstream must agree
    to ``RN_GRAD_RELNORM``, the others to ``RN_TIE_GRAD_RELNORM``.
    Returns (the names of the variables upstream of a flipped ReLU, the
    float32 step-1 gradients of each way by name)."""
    from hetu_tpu_torch.parallel.batch_axis import BatchAxis
    loss, fd, _ = dp_workload(ht, "resnet18", RN_BATCH)
    topo = ht.topo_sort([loss])
    ex = ht.Executor([loss], seed=0, device="cuda")
    ex.load_dict(weights)
    params = [n for n in topo
              if getattr(n, "is_variable", False) and n.trainable]
    relus = [n for n in topo if n.op_type == "Relu"]
    out = {}
    for dtype in (torch.float64, torch.float32):
        feeds = {n: torch.from_numpy(v).to("cuda", dtype)
                 for n, v in fd.items()}
        for way in ("plain", "dp"):
            axis = None
            if way == "dp":
                axis = BatchAxis(None, 1, 0)
                axis.sharded.update(feeds)
            leaves = {n: ex.var_values[n].to(dtype).requires_grad_(True)
                      for n in params}
            with torch.enable_grad():
                env = ht.lower_forward(
                    topo, ht.LowerCtx(True, None, axis),
                    lambda n: feeds[n] if n in feeds
                    else leaves.get(n, ex.var_values[n].to(dtype)))
                grads = torch.autograd.grad(env[loss],
                                            [leaves[n] for n in params])
            out[dtype, way] = (
                float(env[loss]),
                {n.name: g.cpu().numpy() for n, g in zip(params, grads)},
                {r: env[r.inputs[0]].detach() for r in relus})
            del env, grads, leaves
    ex.close()

    (l64, g64, _), (m64, h64, _) = out[torch.float64, "plain"], \
        out[torch.float64, "dp"]
    f64 = max([abs(m64 - l64) / abs(l64)]
              + [_relnorm(h64[k], g) for k, g in g64.items()])
    (_, g32, pre), (_, h32, dpre) = out[torch.float32, "plain"], \
        out[torch.float32, "dp"]
    flips = {}
    for r in relus:
        diff = (pre[r] > 0) != (dpre[r] > 0)
        if bool(diff.any()):
            near = torch.maximum(pre[r][diff].abs(), dpre[r][diff].abs())
            flips[r] = (int(diff.sum()), float(near.max()))
    parents = {}
    for n in topo:
        parents[n] = set(n.inputs).union(*(parents[i] for i in n.inputs))
    reached = {n.name for r in flips for n in parents[r] if n in params}
    gates = {k: RN_TIE_GRAD_RELNORM if k in reached else RN_GRAD_RELNORM
             for k in g32}
    err = {k: _relnorm(h32[k], g) for k, g in g32.items()}
    free = [err[k] for k in err if k not in reached]
    log(f"[dp1-resnet-probe] float64: the strategy's lowering against the "
        f"plain one, worst relative error of the loss and the {len(g64)} "
        f"gradients {f64:.3e} (gate {TIE_F64_RELNORM}); float32: "
        f"{sum(c for c, _ in flips.values())} ReLU pre-activations on "
        f"opposite sides of 0 in {len(flips)} of {len(relus)} ReLUs "
        f"{json.dumps({r.inputs[0].name: v for r, v in flips.items()})} "
        f"(count, largest |x|); {len(reached)} gradients upstream of a flip,"
        f" worst relative norm {max((err[k] for k in reached), default=0):.3e}"
        f" (gate {RN_TIE_GRAD_RELNORM}); {len(free)} with none, worst "
        f"{max(free, default=0):.3e} (gate {RN_GRAD_RELNORM})")
    if not f64 <= TIE_F64_RELNORM \
            or any(e > gates[k] for k, e in err.items()):
        raise AssertionError("[dp1-resnet-probe] the strategy's lowering "
                             "and the plain one disagree")
    return reached, {"plain": g32, "dp": h32}


def phase_dp_world1(ht, fa, metrics, kmods):
    """Phase 38: BERT-base and ResNet-18 through
    ``Executor(dist_strategy=DataParallel())`` on an NCCL group of one
    rank, against the plain executor in the same call.  Returns the
    strategy's flash launches (BERT)."""
    import torch.distributed as dist
    tmp = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method="file://"
                            + os.path.join(tmp, "init"), rank=0,
                            world_size=1)
    try:
        strategy = ht.dist.DataParallel()
        # -- BERT-base at phase 6's cell --------------------------------------
        torch.cuda.empty_cache()
        plain, pfd, _ = dp_executor(ht, "bert-base", TRAIN_BATCH,
                                    grads=False)
        dp, dfd, _ = dp_executor(ht, "bert-base", TRAIN_BATCH, strategy,
                                 grads=False)
        with deterministic_algorithms():
            want = dp_steps(plain, pfd, [], DP_STEPS)
            torch.cuda.synchronize()
            reset_launches(*kmods)
            metrics.reset_flash_fallbacks()
            got = dp_steps(dp, dfd, [], DP_STEPS)
        launches = {"flash_fwd": fa.fwd_launches,
                    "flash_bwd_dq": fa.dq_launches,
                    "flash_bwd_dkv": fa.dkv_launches}
        left = {r: n for r, n in metrics.flash_fallback_counts().items()
                if r.startswith("backend:")}
        layers = 12
        if left or any(n != DP_STEPS * layers for n in launches.values()):
            raise AssertionError(f"[dp1-bert] flash launches {launches} != "
                                 f"{DP_STEPS} x {layers}, fallbacks {left}")
        pv, dv = plain.return_tensor_values(), dp.return_tensor_values()
        worst = max(float(np.max(np.abs(dv[k] - v))) for k, v in pv.items())
        worst_rel = max(float(np.max(np.abs(dv[k] - v)
                                     / np.maximum(np.abs(v), 1e-30)))
                        for k, v in pv.items())
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                          want["losses"]))
        log(f"[dp1-bert] {DP_STEPS} steps (deterministic algorithms): "
            f"losses DataParallel "
            f"{got['losses']} plain {want['losses']} (max rel {loss_rel:.3e});"
            f" {len(pv)} variables after the steps: largest abs difference "
            f"{worst:.3e}, largest relative {worst_rel:.3e} (rtol "
            f"{DP_BERT_RTOL}); bit-equal: {worst == 0.0 and loss_rel == 0.0};"
            f" flash launches {launches}")
        if loss_rel > DP_BERT_RTOL or not all(
                np.allclose(dv[k], v, rtol=DP_BERT_RTOL, atol=0)
                for k, v in pv.items()):
            raise AssertionError("[dp1-bert] the strategy's path and the "
                                 "plain executor disagree")
        dp_time_and_profile("[dp1-bert]", {"plain": (plain, pfd),
                                           "dp": (dp, dfd)}, TRAIN_BATCH)
        # zero=2 at world size 1: no plan is built, so the plain step
        metrics.reset_zero_counts()
        z2, zfd, _ = dp_executor(ht, "bert-base", TRAIN_BATCH, strategy,
                                 grads=False, zero=2)
        with deterministic_algorithms():
            zl = dp_steps(z2, zfd, [], DP_STEPS)["losses"]
        log(f"[dp1-bert-zero2] Executor(zero=2) on the group of one: "
            f"stage {z2.zero}, plans {len(z2._zero_plans)}, losses {zl} "
            f"(plain {want['losses']}), zero_counts "
            f"{metrics.zero_counts()}")
        if z2._zero_plans or zl != want["losses"] or metrics.zero_counts():
            raise AssertionError("[dp1-bert-zero2] zero=2 at world size 1 "
                                 "is not the plain step")
        plain.close()
        dp.close()
        z2.close()
        del plain, dp, pv, dv, z2
        gc.collect()
        torch.cuda.empty_cache()
        launches.update(phase_dp_world1_bf16(ht, fa, metrics, kmods,
                                             strategy))
        # -- ResNet-18 at BASELINE config 2's per-rank batch ------------------
        plain, pfd, pwrt = dp_executor(ht, "resnet18", RN_BATCH)
        dp, dfd, dwrt = dp_executor(ht, "resnet18", RN_BATCH, strategy)
        weights = plain.return_tensor_values()
        with deterministic_algorithms():
            want = dp_steps(plain, pfd, pwrt, DP_STEPS)
            torch.cuda.synchronize()
            reset_launches(*kmods)
            got = dp_steps(dp, dfd, dwrt, DP_STEPS)
            launched = {name: n for m in kmods
                        for name, n in vars(m).items()
                        if name.endswith("launches") and n}
            reached, probe = resnet_tie_probe(ht, weights)
        if launched:
            raise AssertionError(f"[dp1-resnet] hand kernels launched: "
                                 f"{launched}")
        link = {k: max(_relnorm(run["grads"][n], probe[k][n])
                       for n in probe[k])
                for k, run in (("plain", want), ("dp", got))}
        errs = hold_to_phase37_gates(
            "[dp1-resnet] DataParallel vs plain", got, want,
            {k: RN_TIE_GRAD_RELNORM if k in reached else RN_GRAD_RELNORM
             for k in want["grads"]})
        log(f"[dp1-resnet] {DP_STEPS} steps at batch {RN_BATCH} "
            f"(deterministic algorithms): losses DataParallel "
            f"{got['losses']} plain {want['losses']}; {json.dumps(errs)} "
            f"(gates {RN_LOSS_RTOL}, {RN_TRAJ_RTOL}, {RN_STATS_RELNORM}; "
            f"step-1 gradients {RN_GRAD_RELNORM}, {len(reached)} upstream "
            f"of a flipped ReLU {RN_TIE_GRAD_RELNORM}); the executors' "
            f"step-1 gradients against the probe's, worst relative norm "
            f"{json.dumps(link)}")
        dp_time_and_profile("[dp1-resnet]", {"plain": (plain, pfd),
                                             "dp": (dp, dfd)}, RN_BATCH)
        plain.close()
        dp.close()
        del plain, dp
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def phase_dp_world1_bf16(ht, fa, metrics, kmods, strategy):
    """Phase 38's bf16 part: the bf16 key-mask kernels at the cell's
    attention shape (B=16, H=12, S=512, D=64), then BERT-base at phase 6's
    cell in bf16 through the strategy on the group of one against the
    plain bf16 executor: ``DP_STEPS`` steps each under deterministic
    algorithms (the losses within ``BF16_TRAIN_LOSS_RTOL``, every step-1
    gradient within ``BF16_TRAIN_GRAD_RTOL`` / ``_ATOL``; bit-equal
    expected, printed), 12 launches a step of each bf16 key-mask kernel,
    then p50 of both in turns.  Returns the strategy's bf16 launches."""
    cfg = ht.BertConfig.base(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    attn = torch.from_numpy(ht.synthetic_mlm_batch(cfg, seed=0)[3]).cuda()
    rng = np.random.RandomState(38)
    q, k, v, do = (torch.from_numpy(rng.randn(
        TRAIN_BATCH * H, TRAIN_SEQ, D).astype(np.float32)).to(
            "cuda", torch.bfloat16) for _ in range(4))
    attn_case(fa, "[dp1-bf16-kernels]", "bf16 key mask, B=16", q, k, v, do,
              H, 1.0 / math.sqrt(D), km=attn)
    del q, k, v, do
    torch.cuda.empty_cache()
    plain, pfd, pwrt = dp_executor(ht, "bert-base", TRAIN_BATCH,
                                   compute_dtype="bfloat16")
    dp, dfd, dwrt = dp_executor(ht, "bert-base", TRAIN_BATCH, strategy,
                                compute_dtype="bfloat16")
    with deterministic_algorithms():
        want = dp_steps(plain, pfd, pwrt, DP_STEPS)
        torch.cuda.synchronize()
        reset_launches(*kmods)
        metrics.reset_flash_fallbacks()
        got = dp_steps(dp, dfd, dwrt, DP_STEPS)
    launches = flash_launches(fa)
    left = {r: n for r, n in metrics.flash_fallback_counts().items()
            if r.startswith("backend:")}
    expect = {n: DP_STEPS * cfg.num_hidden_layers
              for n in ("flash_fwd_bf16", "flash_bwd_dq_bf16",
                        "flash_bwd_dkv_bf16")}
    if left or launches != expect:
        raise AssertionError(f"[dp1-bert-bf16] launches {launches} != "
                             f"{expect}, fallbacks {left}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                      want["losses"]))
    gerr = {n: float(np.max(np.abs(got["grads"][n] - g)))
            for n, g in want["grads"].items()}
    worst = max(gerr, key=gerr.get)
    bits = loss_rel == 0.0 and gerr[worst] == 0.0
    log(f"[dp1-bert-bf16] {DP_STEPS} bf16 steps (deterministic algorithms)"
        f": losses DataParallel {got['losses']} plain {want['losses']} (max "
        f"rel {loss_rel:.3e}, rtol {BF16_TRAIN_LOSS_RTOL}); step-1 gradients "
        f"of {len(gerr)} variables, largest abs difference {gerr[worst]:.3e}"
        f" ({worst}; rtol {BF16_TRAIN_GRAD_RTOL}, atol "
        f"{BF16_TRAIN_GRAD_ATOL}); bit-equal: {bits}; bf16 flash launches "
        f"{launches}")
    if loss_rel > BF16_TRAIN_LOSS_RTOL or not all(
            np.allclose(got["grads"][n], g, rtol=BF16_TRAIN_GRAD_RTOL,
                        atol=BF16_TRAIN_GRAD_ATOL)
            for n, g in want["grads"].items()):
        raise AssertionError("[dp1-bert-bf16] the strategy's bf16 path and "
                             "the plain bf16 executor disagree")
    del want, got
    dp_time_and_profile("[dp1-bert-bf16]", {"plain": (plain, pfd),
                                            "dp": (dp, dfd)}, TRAIN_BATCH)
    plain.close()
    dp.close()
    del plain, dp
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def dp2_rank(rank, world, tmp):
    """Entry of one phase-39 rank: gloo over a file in ``tmp``, tiny BERT
    and ResNet-18 through ``DataParallel`` on ``cuda:0`` from the weights
    in ``tmp``; the records (or the traceback) into ``tmp``."""
    import torch.distributed as dist
    try:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        import hetu_tpu_torch as ht
        from hetu_tpu_torch import metrics
        from hetu_tpu_torch.ops.kernels import emb_cache as emb
        from hetu_tpu_torch.ops.kernels import flash_attention as fa
        from hetu_tpu_torch.ops.kernels import moe_dispatch as md
        from hetu_tpu_torch.ops.kernels import segment_sum as seg
        from hetu_tpu_torch.tools import profile_train as pt
        torch.cuda.set_device(0)
        torch.backends.cudnn.benchmark = pt.CUDNN_BENCHMARK
        dist.init_process_group("gloo", init_method="file://"
                                + os.path.join(tmp, "init"), rank=rank,
                                world_size=world)
        with open(os.path.join(tmp, "weights.pkl"), "rb") as f:
            weights = pickle.load(f)
        strategy = ht.dist.DataParallel()
        res = {}
        for model, batch, steps in dp2_models():
            ex, fd, wrt = dp_executor(ht, model, batch, strategy)
            ex.load_dict(weights[model])
            reset_launches(fa, emb, seg, md)
            metrics.reset_flash_fallbacks()
            t0 = time.perf_counter()
            res[model] = dp_steps(ex, fd, wrt, steps)
            res[model]["seconds"] = time.perf_counter() - t0
            res[model]["launches"] = dict(flash_launches(fa), **{
                name: n for m in (emb, seg, md)
                for name, n in vars(m).items()
                if name.endswith("launches") and n})
            res[model]["fallbacks"] = metrics.flash_fallback_counts()
            if rank:                     # rank 0's are held to the reference
                res[model]["grads"] = None
            ex.close()
            del ex
            gc.collect()
            torch.cuda.empty_cache()
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def dp2_models():
    """Phase 39's (model, global batch, steps)."""
    return [("bert-tiny", DP2_BERT_BATCH, DP_STEPS),
            ("resnet18", DP2_RN_BATCH, DP_STEPS)] + [
        (m, batch, steps) for m, (batch, steps, _) in DP2_CUT.items()]


def dp2_kernels(ht, fa):
    """The flash specializations that phase 39's transformer graphs launch,
    held to their plain versions at a rank's attention shape, with each
    rank's rows of the masks: GPT-2's causal kernels; T5's bias with the
    key mask, causal bias and cross-attention key mask; XLNet's full mask
    with a bias (both streams); Longformer's window mask."""
    rng = np.random.RandomState(39)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda()

    def u8(m):
        return torch.from_numpy(np.ascontiguousarray(m != 0, np.uint8)).cuda()

    t5cfg = ht.T5Config.small(batch_size=DP2_CUT["t5"][0], src_len=T5_SRC,
                              tgt_len=T5_TGT)
    t5attn = ht.synthetic_seq2seq_batch(t5cfg, seed=0, padded=True)[3]
    xcfg = ht.XLNetConfig.base(batch_size=DP2_CUT["xlnet"][0],
                               seq_len=XL_SEQ)
    _, cmask, qmask, _ = ht.synthetic_plm_batch(xcfg, seed=0)
    lcfg = ht.LongformerConfig.base(batch_size=DP2_CUT["longformer"][0],
                                    seq_len=LF_SEQ)
    wmask = ht.longformer_attention_mask(LF_SEQ, lcfg.attention_window,
                                         lcfg.num_global_tokens)
    t5h, xh = t5cfg.num_heads, xcfg.n_head
    for r in range(DP2_WORLD):
        tag = f"rank {r}"
        b = DP2_CUT["gpt2"][0] // DP2_WORLD
        q, k, v, do = (t(b * H, GPT_SEQ, D) for _ in range(4))
        attn_case(fa, "[dp2-kernels]", f"{tag} GPT-2 causal", q, k, v, do,
                  H, 1.0 / math.sqrt(D), causal=True)
        b = DP2_CUT["t5"][0] // DP2_WORLD
        km = torch.from_numpy(np.ascontiguousarray(
            t5attn[r * b:(r + 1) * b], np.int32)).cuda()
        for name, s_q, s_kv, causal, bias, keyed in (
                ("T5 encoder bias + key mask", T5_SRC, T5_SRC, False, True,
                 True),
                ("T5 decoder causal bias", T5_TGT, T5_TGT, True, True, False),
                ("T5 cross-attention key mask", T5_TGT, T5_SRC, False, False,
                 True)):
            q, do = t(b * t5h, s_q, D), t(b * t5h, s_q, D)
            k, v = t(b * t5h, s_kv, D), t(b * t5h, s_kv, D)
            attn_case(fa, "[dp2-kernels]", f"{tag} {name}", q, k, v, do,
                      t5h, T5_KERNEL_SCALE, km=km if keyed else None,
                      causal=causal, bias=t(t5h, s_q, s_kv) if bias else None,
                      gmode="h")
        b = DP2_CUT["xlnet"][0] // DP2_WORLD
        for name, m in (("content", cmask), ("query", qmask)):
            q, k, v, do = (t(b * xh, XL_SEQ, D) for _ in range(4))
            attn_case(fa, "[dp2-kernels]", f"{tag} XLNet {name} stream", q,
                      k, v, do, xh, XL_SCALE, bias=t(xh, XL_SEQ, XL_SEQ),
                      gmode="h", mask=u8(m[r * b:(r + 1) * b, 0]),
                      mask_gmode="b")
        b = DP2_CUT["longformer"][0] // DP2_WORLD
        q, k, v, do = (t(b * H, LF_SEQ, D) for _ in range(4))
        attn_case(fa, "[dp2-kernels]", f"{tag} Longformer window", q, k, v,
                  do, H, XL_SCALE, mask=u8(wmask[None]), mask_gmode="one")
        del q, k, v, do
        torch.cuda.empty_cache()


def dp2_expected(model, cfg_layers):
    """{kernels-line name: launches} a phase-39 rank must count."""
    if model == "resnet18":
        return {}
    if model == "bert-tiny":
        per, steps = {"": cfg_layers}, DP_STEPS
    else:
        _, steps, per = DP2_CUT[model]
    out = {}
    for sfx, n in per.items():
        for kern in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            out[kern + ("_" + sfx if sfx else "")] = n * steps
    return out


def phase_dp_two_ranks(ht, fa):
    """Phase 39: two ranks on the one card over gloo, held to the
    single-process plain executor over the global batch.  Returns the
    flash launches of both ranks by kernels-line name."""
    tmp = tempfile.mkdtemp()
    try:
        dp2_kernels(ht, fa)
        # the kernels at a rank's attention shape, with each rank's mask
        cfg = ht.BertConfig.tiny(batch_size=DP2_BERT_BATCH, seq_len=32)
        attn = ht.synthetic_mlm_batch(cfg, seed=0)[3]
        heads, dk = cfg.num_attention_heads, cfg.hidden_size \
            // cfg.num_attention_heads
        per = DP2_BERT_BATCH // DP2_WORLD
        rng = np.random.RandomState(7)
        for r in range(DP2_WORLD):
            q, k, v, do = (torch.from_numpy(rng.randn(
                per * heads, 32, dk).astype(np.float32)).cuda()
                for _ in range(4))
            km = torch.from_numpy(attn[r * per:(r + 1) * per]).cuda()
            attn_case(fa, "[dp2-kernels]", f"rank {r} key mask", q, k, v,
                      do, heads, 1.0 / math.sqrt(dk), km=km)
        # the single-process reference over the global batch, its weights
        # (T5's query projections scaled by 1/8, as phase 20 does)
        refs, weights = {}, {}
        for model, batch, steps in dp2_models():
            ex, fd, wrt = dp_executor(ht, model, batch)
            weights[model] = ex.return_tensor_values()
            if model == "t5":
                weights[model] = {n: w / 8 if n.endswith(".q.weight")
                                  else w for n, w in weights[model].items()}
                load_all(ex, weights[model])
            refs[model] = dp_steps(ex, fd, wrt, steps)
            ex.close()
            del ex
            gc.collect()
            torch.cuda.empty_cache()
        with open(os.path.join(tmp, "weights.pkl"), "wb") as f:
            pickle.dump(weights, f)
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=dp2_rank, args=(r, DP2_WORLD, tmp))
                 for r in range(DP2_WORLD)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.monotonic() + DP2_TIMEOUT
        try:
            while any(p.is_alive() for p in procs) \
                    and time.monotonic() < deadline \
                    and not any(p.exitcode not in (None, 0) for p in procs):
                time.sleep(0.2)
            codes = [p.exitcode for p in procs]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(30)
        errs = [open(os.path.join(tmp, f)).read()
                for f in sorted(os.listdir(tmp)) if f.endswith(".err")]
        if errs or codes != [0] * DP2_WORLD:
            raise AssertionError(f"[dp2] ranks exited {codes} (None: alive "
                                 f"past {DP2_TIMEOUT} s)\n" + "\n".join(errs))
        ranks = []
        for r in range(DP2_WORLD):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        log(f"[dp2] {DP2_WORLD} ranks on cuda:0 over gloo in "
            f"{time.perf_counter() - t0:.1f} s (spawn included)")
        launches = {}
        for model in refs:
            resnet = model == "resnet18"
            errs = hold_to_phase37_gates(
                f"[dp2-{model}] rank 0 vs the single-process run",
                ranks[0][model], refs[model],
                RN_TIE_GRAD_RELNORM if resnet
                else (TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL),
                RN_TIE_TRAJ if resnet
                else (RN_TRAJ_RTOL, RN_STATS_RELNORM[1]))
            if not ranks[0][model]["losses"][-1] \
                    < ranks[0][model]["losses"][0]:
                raise AssertionError(f"[dp2-{model}] the loss did not fall: "
                                     f"{ranks[0][model]['losses']}")
            for r, rec in enumerate(ranks):
                if rec[model]["losses"] != ranks[0][model]["losses"]:
                    raise AssertionError(f"[dp2-{model}] rank {r} losses "
                                         f"{rec[model]['losses']} differ")
                left = {k: n for k, n in rec[model]["fallbacks"].items()
                        if k.startswith("backend:")}
                got = rec[model]["launches"]
                want = dp2_expected(model, cfg.num_hidden_layers)
                if left or got != want:
                    raise AssertionError(f"[dp2-{model}] rank {r} launches "
                                         f"{got} != {want}, fallbacks {left}")
                for name, n in got.items():
                    launches[name] = launches.get(name, 0) + n
            batch, steps = next((b, n) for m, b, n in dp2_models()
                                if m == model)
            log(f"[dp2-{model}] global batch {batch}, {steps} steps"
                f"{' (2 layers)' if model in DP2_CUT else ''}: losses rank 0 "
                f"{ranks[0][model]['losses']} single-process "
                f"{refs[model]['losses']}; {json.dumps(errs)}; seconds by "
                f"rank {[rec[model]['seconds'] for rec in ranks]}; "
                f"launches by rank {[rec[model]['launches'] for rec in ranks]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches

def zero_rank(rank, world, tmp):
    """Entry of one phase-40 rank: gloo over a file in ``tmp``, BERT-base
    through ``DataParallel`` at each ZeRO stage on ``cuda:0`` under
    deterministic algorithms; the records (or the traceback) into
    ``tmp``."""
    import hashlib
    import torch.distributed as dist
    try:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        import hetu_tpu_torch as ht
        from hetu_tpu_torch import metrics
        from hetu_tpu_torch.ops.kernels import flash_attention as fa
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method="file://"
                                + os.path.join(tmp, "init"), rank=rank,
                                world_size=world)
        res, base = {}, None
        with deterministic_algorithms():
            for stage in ZERO_STAGES:
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                ex, fd, _ = dp_executor(ht, "bert-base", TRAIN_BATCH,
                                        ht.dist.DataParallel(), grads=False,
                                        zero=stage)
                reset_launches(fa)
                metrics.reset_zero_counts()
                losses, times = [], []
                for _ in range(ZERO_STEPS):
                    t0 = time.perf_counter()
                    losses.append(float(ex.run("train", feed_dict=fd)[0]
                                        .asnumpy()))
                    times.append((time.perf_counter() - t0) * 1e3)
                gc.collect()
                held = torch.cuda.memory_allocated() - before
                mem = ex.memory_accounting()
                vals = ex.return_tensor_values()
                digest = hashlib.sha256(b"".join(
                    vals[k].tobytes() for k in sorted(vals))).hexdigest()
                if base is None:
                    base = vals
                diff = max(float(np.max(np.abs(v - base[k])))
                           for k, v in vals.items())
                rel = max(float(np.max(np.abs(v - base[k])
                                       / np.maximum(np.abs(base[k]), 1e-30)))
                          for k, v in vals.items())
                res[stage] = {
                    "losses": losses, "step_ms": times, "mem": mem,
                    "held_between_steps_bytes": held,
                    "max_memory_allocated_gib":
                        torch.cuda.max_memory_allocated() / 2 ** 30,
                    "zero_counts": metrics.zero_counts(),
                    "plans": {op.name: len(plan.buckets)
                              for op, plan in ex._zero_plans.items()},
                    "digest": digest, "max_abs_diff_vs_stage0": diff,
                    "max_rel_diff_vs_stage0": rel,
                    "launches": flash_launches(fa)}
                ex.close()
                del ex, vals
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def phase_zero_two_ranks(ht, fa):
    """Phase 40: ZeRO stages 0-3 on two ranks of the card over gloo.  The
    key-mask kernels at a rank's attention shape first, then BERT-base at
    phase 6's cell (global batch 16, seq 512, dropout 0.1, Adam 1e-4),
    ``ZERO_STEPS`` steps a stage under deterministic algorithms.  Stage 1
    must be bit-equal to stage 0 (losses and every parameter after the
    steps); stages 2 and 3 too (at dp 2 a reduce-scatter adds the same two
    terms as the all-reduce), else held to phase 37's gates with the
    spread printed; every rank ends with the same parameters.  Prints each
    rank's and stage's optimizer-state and parameter bytes, peak memory,
    ``zero_counts()`` and step ms (gloo staging through the host: no
    multi-card number).  Returns the flash launches of both ranks."""
    cfg = ht.BertConfig.base(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    attn = ht.synthetic_mlm_batch(cfg, seed=0)[3]
    per = TRAIN_BATCH // DP2_WORLD
    rng = np.random.RandomState(40)
    for r in range(DP2_WORLD):
        q, k, v, do = (torch.from_numpy(rng.randn(
            per * H, TRAIN_SEQ, D).astype(np.float32)).cuda()
            for _ in range(4))
        km = torch.from_numpy(attn[r * per:(r + 1) * per]).cuda()
        attn_case(fa, "[zero-kernels]", f"rank {r} key mask", q, k, v, do,
                  H, 1.0 / math.sqrt(D), km=km)
        del q, k, v, do
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp()
    try:
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=zero_rank, args=(r, DP2_WORLD, tmp))
                 for r in range(DP2_WORLD)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.monotonic() + ZERO_TIMEOUT
        try:
            while any(p.is_alive() for p in procs) \
                    and time.monotonic() < deadline \
                    and not any(p.exitcode not in (None, 0) for p in procs):
                time.sleep(0.2)
            codes = [p.exitcode for p in procs]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(30)
        errs = [open(os.path.join(tmp, f)).read()
                for f in sorted(os.listdir(tmp)) if f.endswith(".err")]
        if errs or codes != [0] * DP2_WORLD:
            raise AssertionError(f"[zero] ranks exited {codes} (None: alive "
                                 f"past {ZERO_TIMEOUT} s)\n" + "\n".join(errs))
        ranks = []
        for r in range(DP2_WORLD):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[zero] {DP2_WORLD} ranks on cuda:0 over gloo in "
        f"{time.perf_counter() - t0:.1f} s (spawn included); {card_line()}")
    layers = cfg.num_hidden_layers
    expect = {n: ZERO_STEPS * layers
              for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    launches = {}
    base = ranks[0][0]
    for stage in ZERO_STAGES:
        rec = ranks[0][stage]
        for r, other in enumerate(ranks):
            o = other[stage]
            if o["digest"] != rec["digest"] or o["losses"] != rec["losses"]:
                raise AssertionError(f"[zero-{stage}] rank {r} ends with "
                                     f"other parameters or losses")
            if o["launches"] != expect:
                raise AssertionError(f"[zero-{stage}] rank {r} launches "
                                     f"{o['launches']} != {expect}")
            for name, n in o["launches"].items():
                launches[name] = launches.get(name, 0) + n
            m = o["mem"]
            log(f"[zero-{stage}] rank {r}: optimizer state "
                f"{m['opt_state_bytes_per_device']} B, parameters held "
                f"between steps {m['param_bytes_per_device']} B full + "
                f"{m['zero_slab_bytes_per_device']} B rows, gradients' "
                f"layout {m['grad_bytes_per_device']} B; device memory held "
                f"after the steps {o['held_between_steps_bytes']} B, "
                f"max_memory_allocated {o['max_memory_allocated_gib']:.3f} "
                f"GiB; zero_counts {json.dumps(o['zero_counts'])} "
                f"({ZERO_STEPS} steps); buckets {json.dumps(o['plans'])}; "
                f"step ms (gloo staging CUDA tensors through the host, two "
                f"ranks on one card: no multi-card number) "
                f"{[round(t, 3) for t in o['step_ms']]}; {card_line()}")
        bits = rec["losses"] == base["losses"] \
            and rec["digest"] == base["digest"]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(rec["losses"],
                                                          base["losses"]))
        log(f"[zero-{stage}] losses {rec['losses']} (stage 0 "
            f"{base['losses']}, max rel {loss_rel:.3e}); parameters after "
            f"{ZERO_STEPS} steps vs stage 0: largest abs difference "
            f"{rec['max_abs_diff_vs_stage0']:.3e}, relative "
            f"{rec['max_rel_diff_vs_stage0']:.3e}; bit-equal: {bits}")
        if stage and not rec["plans"]:
            raise AssertionError(f"[zero-{stage}] no ZeRO plan was built")
        if stage == 1 and not bits:
            raise AssertionError("[zero-1] stage 1 is not bit-equal to "
                                 "stage 0")
        if stage > 1 and not bits and (
                loss_rel > RN_LOSS_RTOL
                or rec["max_rel_diff_vs_stage0"] > RN_TRAJ_RTOL):
            raise AssertionError(f"[zero-{stage}] outside phase 37's gates")
    return launches


# -- phase 41: the training loop's state ------------------------------------

def _free_cuda():
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _state_bert(ht, cfg, **kw):
    """BERT-base at ``cfg`` on Adam under the Cosine schedule: (executor,
    feed dict, trainable variables)."""
    feeds, loss, _ = ht.bert_pretrain_graph(cfg)
    wrt = [n for n in ht.topo_sort([loss])
           if isinstance(n, ht.PlaceholderOp) and n.is_variable
           and n.trainable]
    fetches = [loss, ht.optim.AdamOptimizer(
        ht.optim.CosineScheduler(STATE_LR[0], warmup_steps=STATE_LR[1],
                                 total_steps=STATE_LR[2])).minimize(loss)]
    if kw.pop("grads", False):
        fetches += ht.gradients(loss, wrt)
    ex = ht.Executor({"train": fetches}, seed=0, device="cuda", **kw)
    return ex, feeds, wrt


def _losses(ex, fd, n):
    return [float(ex.run("train", feed_dict=fd)[0].asnumpy())
            for _ in range(n)]


def _flash_counts(fa):
    return {"flash_fwd": fa.fwd_launches, "flash_bwd_dq": fa.dq_launches,
            "flash_bwd_dkv": fa.dkv_launches}


def _ckpt_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def state_resume(ht, fa, metrics, kmods, cfg, fd_of, tmp, launches):
    """41a: the schedule, save / load and auto-save / resume, bit-equal to
    the uninterrupted run.  Returns (the checkpoint's path, report)."""
    half = STATE_STEPS // 2
    report = {}

    def counted(run):
        reset_launches(*kmods)
        metrics.reset_flash_fallbacks()
        out = run()
        for k, n in _flash_counts(fa).items():
            launches[k] += n
        left = {r: c for r, c in metrics.flash_fallback_counts().items()
                if r.startswith("backend:")}
        if left:
            raise AssertionError(f"attention left the kernels: {left}")
        return out

    ex, feeds, _ = _state_bert(ht, cfg)
    fd = fd_of(feeds)
    want = counted(lambda: _losses(ex, fd, STATE_STEPS))
    opt = ex.subexecutors["train"].opt_ops[0].optimizer
    rates = [float(opt.step_lr(s)) for s in range(STATE_STEPS)]
    del ex, opt
    _free_cuda()
    ex, feeds, _ = _state_bert(ht, cfg)
    fd = fd_of(feeds)
    first = counted(lambda: _losses(ex, fd, half))
    path = os.path.join(tmp, "bert_ckpt")
    t0 = time.perf_counter()
    ex.save(path)
    report["save_s"] = time.perf_counter() - t0
    report["ckpt_bytes"] = _ckpt_bytes(path)
    del ex
    _free_cuda()
    ex, feeds, _ = _state_bert(ht, cfg)
    fd = fd_of(feeds)
    t0 = time.perf_counter()
    ex.load(path)
    torch.cuda.synchronize()
    report["load_s"] = time.perf_counter() - t0
    if ex.step_counter != half:
        raise AssertionError(f"loaded step {ex.step_counter} != {half}")
    rest = counted(lambda: _losses(ex, fd, STATE_STEPS - half))
    if first + rest != want:
        raise AssertionError(f"save -> load -> continue {first + rest} != "
                             f"uninterrupted {want}")
    del ex
    _free_cuda()
    auto = os.path.join(tmp, "auto")
    ex, feeds, _ = _state_bert(ht, cfg, auto_save_dir=auto,
                               auto_save_every=half,
                               install_signal_handlers=False)
    fd = fd_of(feeds)
    first = counted(lambda: _losses(ex, fd, half))
    del ex
    _free_cuda()
    ex, feeds, _ = _state_bert(ht, cfg)
    fd = fd_of(feeds)
    t0 = time.perf_counter()
    step = ex.resume(auto)
    report["resume_s"] = time.perf_counter() - t0
    if step != half:
        raise AssertionError(f"resume({auto}) gave step {step}, not {half}")
    rest = counted(lambda: _losses(ex, fd, STATE_STEPS - half))
    if first + rest != want:
        raise AssertionError(f"auto-save -> resume -> continue "
                             f"{first + rest} != uninterrupted {want}")
    del ex
    _free_cuda()
    faults = metrics.fault_counts()
    if faults.get("auto_save", 0) < 1 or faults.get("resume", 0) != 1:
        raise AssertionError(f"fault counters {faults}")
    report.update({"losses": want, "rates": rates, "faults": faults})
    return path, report


def state_warm_start(ht, fa, kmods, cfg, path, launches):
    """41b: ``bert_classify_graph`` warm-started from the checkpoint."""
    feeds, loss, _ = ht.bert_classify_graph(cfg, num_labels=3)
    ex = ht.Executor({"train": [loss, ht.optim.AdamOptimizer(1e-4)
                                .minimize(loss)]}, seed=11, device="cuda")
    ex.load(path, params_only=True)
    if ex.step_counter != 0:
        raise AssertionError(f"params_only load set step {ex.step_counter}")
    with open(os.path.join(path, "meta.json")) as f:
        names = json.load(f)["params"]
    vals = ex.return_tensor_values()
    trunk = [n for n in names if n in vals]
    for name in trunk:
        if not np.array_equal(vals[name], np.load(
                os.path.join(path, "params", names[name]))):
            raise AssertionError(f"warm-started {name} differs from the "
                                 f"checkpoint")
    ids, tt, _, attn = ht.synthetic_mlm_batch(cfg, seed=0)
    labels = (ids[:, 0] % 3).astype(np.int32)
    fd = {feeds["input_ids"]: ids, feeds["token_type_ids"]: tt,
          feeds["labels"]: labels, feeds["attention_mask"]: attn}
    reset_launches(*kmods)
    losses = _losses(ex, fd, 2)
    for k, n in _flash_counts(fa).items():
        launches[k] += n
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"warm-started losses {losses}")
    del ex
    _free_cuda()
    return {"trunk_params": len(trunk), "fresh_params": len(vals)
            - len(trunk), "losses": losses}


def state_remat(ht, fa, metrics, kmods, cfg, fd_of, launches):
    """41c: every policy bit-equal to ``off`` with dropout on; peak
    memory, offloaded bytes and flash launches of each."""
    ref, report = None, {}
    for pol in REMAT_POLICIES:
        ex, feeds, wrt = _state_bert(ht, cfg, grads=True, remat=pol)
        fd = fd_of(feeds)
        _free_cuda()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(*kmods)
        metrics.reset_remat_counts()
        t0 = time.perf_counter()
        got = []
        for _ in range(REMAT_STEPS):
            out = ex.run("train", feed_dict=fd)
            got.append((float(out[0].asnumpy()),
                        [g.torch().cpu() for g in out[2:]]))
        secs = time.perf_counter() - t0
        counts = _flash_counts(fa)
        for k, n in counts.items():
            launches[k] += n
        recompute = 2 if pol in ("dots", "full") else 1
        want_n = {"flash_fwd": recompute, "flash_bwd_dq": 1,
                  "flash_bwd_dkv": 1}
        for k, n in counts.items():
            if n != REMAT_STEPS * cfg.num_hidden_layers * want_n[k]:
                raise AssertionError(f"remat={pol}: {k} launched {n} times")
        moved = metrics.remat_counts().get("remat_offload_bytes", 0)
        if pol == "offload" and not moved > 0:
            raise AssertionError("remat='offload' moved no bytes to the "
                                 "host")
        if ref is None:
            ref = got
        else:
            for step, ((gl, gg), (wl, wg)) in enumerate(zip(got, ref)):
                if gl != wl or not all(torch.equal(a, b)
                                       for a, b in zip(gg, wg)):
                    bad = [n.name for n, a, b in zip(wrt, gg, wg)
                           if not torch.equal(a, b)]
                    raise AssertionError(
                        f"remat={pol} step {step + 1}: loss {gl} vs {wl}, "
                        f"gradients differ: {bad[:5]}")
        report[pol] = {"peak_mem_gib": torch.cuda.max_memory_allocated()
                       / 2 ** 30, "offload_bytes": moved,
                       "s_per_step": secs / REMAT_STEPS, "flash": counts,
                       "plan_segments": (ex.remat_plan("train") or {})
                       .get("segments"), "losses": [g[0] for g in got]}
        del ex, got
        _free_cuda()
    return report


def state_accumulate(ht, fa, kmods, launches):
    """41d: ``num_microbatches=ACC_M`` against the plain step."""
    runs = {}
    for m in (1, ACC_M):
        cfg = ht.BertConfig.base(batch_size=TRAIN_BATCH // m,
                                 seq_len=TRAIN_SEQ, hidden_dropout_prob=0.0,
                                 attention_probs_dropout_prob=0.0)
        block = ht.synthetic_mlm_batch(ht.BertConfig.base(
            batch_size=TRAIN_BATCH // ACC_M, seq_len=TRAIN_SEQ), seed=0)
        batch = [np.concatenate([a] * ACC_M) for a in block]
        ex, feeds, _ = _state_bert(ht, cfg, num_microbatches=m)
        fd = _bert_feeds(feeds, batch)
        _free_cuda()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(*kmods)
        t0 = time.perf_counter()
        losses = _losses(ex, fd, ACC_STEPS)
        secs = time.perf_counter() - t0
        counts = _flash_counts(fa)
        for k, n in counts.items():
            launches[k] += n
            if n != ACC_STEPS * m * cfg.num_hidden_layers:
                raise AssertionError(f"M={m}: {k} launched {n} times")
        runs[m] = {"losses": losses, "s_per_step": secs / ACC_STEPS,
                   "peak_mem_gib": torch.cuda.max_memory_allocated()
                   / 2 ** 30}
        del ex
        _free_cuda()
    got, want = runs[ACC_M]["losses"], runs[1]["losses"]
    spread = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    runs["rel_spread"] = spread
    if not (all(math.isfinite(x) for x in got) and spread[0] <= ACC_RTOL[0]
            and max(spread[1:]) <= ACC_RTOL[1]):
        raise AssertionError(f"M={ACC_M} losses {got} vs M=1 {want}: "
                             f"spread {spread}")
    return runs


def state_ps(ht, emb, seg, kmods, tmp, launches):
    """41e: Wide & Deep through the device cache, saved and resumed."""
    batches = ctr_batches(ht)[:6]

    def wdl():
        feeds, ex, cache = wdl_executor(ht, "vlru_dev", "cuda")
        cache.push_bound = 1
        return feeds, ex

    def run(feeds, ex, part):
        reset_launches(*kmods)
        out = [float(ex.run("train", feed_dict=dict(zip(feeds, b)))[0]
                     .asnumpy()) for b in part]
        for k, mod in (("emb_gather", emb), ("sorted_segment_sum", seg)):
            if mod.launches != len(part):
                raise AssertionError(f"{k}: {mod.launches} launches in "
                                     f"{len(part)} steps")
            launches[k] += mod.launches
        return out

    feeds, ex = wdl()
    want = run(feeds, ex, batches)
    ex.close()
    feeds, ex = wdl()
    first = run(feeds, ex, batches[:3])
    path = os.path.join(tmp, "wdl_ckpt")
    t0 = time.perf_counter()
    ex.save(path)
    save_s = time.perf_counter() - t0
    ex.close()
    del ex
    _free_cuda()
    feeds, ex = wdl()
    t0 = time.perf_counter()
    ex.load(path)
    load_s = time.perf_counter() - t0
    rest = run(feeds, ex, batches[3:])
    ex.close()
    if first + rest != want:
        raise AssertionError(f"WDL save -> load -> continue {first + rest} "
                             f"!= uninterrupted {want}")
    return {"losses": want, "save_s": save_s, "load_s": load_s,
            "ckpt_bytes": _ckpt_bytes(path)}


def phase_training_state(ht, fa, emb, seg, metrics, kmods):
    """Phase 41 (see the module docstring); returns its launches by
    kernels-line name."""
    t_phase = time.perf_counter()
    launches = {k: 0 for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                               "emb_gather", "sorted_segment_sum")}
    cfg = ht.BertConfig.base(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ)

    def fd_of(feeds):
        return _bert_feeds(feeds, ht.synthetic_mlm_batch(cfg, seed=0))

    metrics.reset_faults()
    report = {"card": card_line()}
    with tempfile.TemporaryDirectory() as tmp, deterministic_algorithms():
        t0 = time.perf_counter()
        path, report["resume"] = state_resume(ht, fa, metrics, kmods, cfg,
                                              fd_of, tmp, launches)
        report["resume"]["phase_s"] = time.perf_counter() - t0
        log(f"[state] {json.dumps(report['resume'])}")
        t0 = time.perf_counter()
        report["warm_start"] = state_warm_start(ht, fa, kmods, cfg, path,
                                                launches)
        report["warm_start"]["phase_s"] = time.perf_counter() - t0
        log(f"[state] warm start {json.dumps(report['warm_start'])}")
        t0 = time.perf_counter()
        report["remat"] = state_remat(ht, fa, metrics, kmods, cfg, fd_of,
                                      launches)
        report["remat"]["phase_s"] = time.perf_counter() - t0
        log(f"[state] remat {json.dumps(report['remat'])}")
        t0 = time.perf_counter()
        report["accumulate"] = state_accumulate(ht, fa, kmods, launches)
        report["accumulate"]["phase_s"] = time.perf_counter() - t0
        log(f"[state] accumulate {json.dumps(report['accumulate'])}")
        t0 = time.perf_counter()
        report["ps"] = state_ps(ht, emb, seg, kmods, tmp, launches)
        report["ps"]["phase_s"] = time.perf_counter() - t0
        log(f"[state] ps {json.dumps(report['ps'])}")
    report["launches"] = launches
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"[state] launches {json.dumps(launches)} card {report['card']} "
        f"phase 41 in {report['phase_s']:.1f} s")
    return launches


def _launch_counts(kmods):
    """{module: {counter: n}} of every kernel launch counter that is not
    0."""
    out = {}
    for mod in kmods:
        hot = {k: v for k, v in vars(mod).items()
               if k.endswith("launches") and v}
        if hot:
            out[mod.__name__.rsplit(".", 1)[-1]] = hot
    return out


def _rs_bert(ht, cfg, **kw):
    """BERT-base at ``cfg`` on ``AdamOptimizer(1e-4)``: (feeds, fetches,
    executor)."""
    feeds, loss, _ = ht.bert_pretrain_graph(cfg)
    fetches = [loss, ht.optim.AdamOptimizer(1e-4).minimize(loss)]
    ex = ht.Executor({"train": fetches}, seed=0, device="cuda", **kw)
    return feeds, fetches, ex


def _left_kernels(metrics):
    left = {r: c for r, c in metrics.flash_fallback_counts().items()
            if r.startswith("backend:")}
    if left:
        raise AssertionError(f"attention left the kernels: {left}")


def _check_flash(fa, steps, layers, tag, fwd_per_layer=1):
    counts = _flash_counts(fa)
    want = {"flash_fwd": steps * layers * fwd_per_layer,
            "flash_bwd_dq": steps * layers, "flash_bwd_dkv": steps * layers}
    if counts != want:
        raise AssertionError(f"{tag}: flash launches {counts} != {want}")
    return counts


def _device_busy(pm, step, steps):
    """(device busy ms a step, profiled wall ms a step) of one profiled
    call of ``step``, which runs ``steps`` steps."""
    kern, wall, _ = pm.device_profile(step, 1)
    if not kern:
        raise AssertionError("the profiler recorded no device time")
    return sum(v[1] for v in kern.values()) / 1e3 / steps, \
        wall * 1e3 / steps


def _sync_sites(step):
    """``step()`` under ``torch.cuda.set_sync_debug_mode("warn")``, which
    warns wherever a call synchronizes the host with the card: (its
    result, {source line: count} of those syncs, each at the innermost
    frame of this repository's code)."""
    root = os.path.dirname(os.path.abspath(__file__))
    sites = collections.Counter()
    active = [False]     # the mode switch itself warns: count the step only

    def hook(message, category, filename, lineno, file=None, line=None):
        if not active[0] or "synchroniz" not in str(message):
            return
        for fr in reversed(traceback.extract_stack()[:-1]):
            if fr.filename.startswith(root):
                sites[f"{os.path.relpath(fr.filename, root)}:{fr.lineno} "
                      f"in {fr.name}"] += 1
                return
        sites[f"{filename}:{lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        active[0] = True
        try:
            out = step()
        finally:
            active[0] = False
            torch.cuda.set_sync_debug_mode(0)
    return out, dict(sites)


def rs_construct(ht, metrics, kmods, cfg):
    """42a: the lint's wall time, and a validated construction that
    launches nothing."""
    feeds, loss, _ = ht.bert_pretrain_graph(cfg)
    fetches = [loss, ht.optim.AdamOptimizer(1e-4).minimize(loss)]
    reset_launches(*kmods)
    metrics.reset_flash_fallbacks()
    t0 = time.perf_counter()
    report = ht.lint(fetches)
    lint_s = time.perf_counter() - t0
    if not report.ok or not report.complete:
        raise AssertionError(f"BERT-base lint: {report}")
    t0 = time.perf_counter()
    ex = ht.Executor({"train": fetches}, seed=0, device="cuda",
                     validate="error")
    build_s = time.perf_counter() - t0
    hot = _launch_counts(kmods)
    if hot or metrics.flash_fallback_counts():
        raise AssertionError(f"validated construction launched {hot}, "
                             f"fallbacks {metrics.flash_fallback_counts()}")
    return feeds, ex, {"lint_s": lint_s, "build_s": build_s,
                       "nodes": len(report.shapes.topo), "launches": 0}


def rs_async(ht, fa, metrics, kmods, pm, cfg, batch, feeds_a, ex_a,
             launches):
    """42b: ``run_steps(sync=False)`` against a plain ``run()`` loop, in
    turns; bit-equal losses, the plan counters, launches, p50, idle
    share."""
    feeds_s, _, ex_s = _rs_bert(ht, cfg)
    fd_a, fd_s = _bert_feeds(feeds_a, batch), _bert_feeds(feeds_s, batch)
    plan = {}
    turns = {"async": [], "sync": []}
    call_ms, losses = [], {"async": [], "sync": []}

    def async_turn(n):
        outs = ex_a.run_steps(lambda i: fd_a, n, name="train", sync=False)
        torch.cuda.synchronize()
        return [o[0] for o in outs]

    def sync_turn(n):
        outs = []
        for _ in range(n):
            t0 = time.perf_counter()
            outs.append(ex_s.run("train", feed_dict=fd_s)[0])
            call_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return outs

    for _ in range(RS_TURNS):
        for kind, turn in (("async", async_turn), ("sync", sync_turn)):
            reset_launches(*kmods)
            metrics.reset_flash_fallbacks()
            metrics.reset_run_plan_counts()
            t0 = time.perf_counter()
            outs = turn(RS_TURN_STEPS)
            turns[kind].append((time.perf_counter() - t0) * 1e3
                               / RS_TURN_STEPS)
            losses[kind] += [float(o.asnumpy()) for o in outs]
            counts = _check_flash(fa, RS_TURN_STEPS, cfg.num_hidden_layers,
                                  f"42b {kind}")
            for k, n in counts.items():
                launches[k] += n
            _left_kernels(metrics)
            for k, n in metrics.run_plan_counts().items():
                if kind == "async":
                    plan[k] = plan.get(k, 0) + n
    if plan.get("plan_cache_hit") != RS_TURNS * RS_TURN_STEPS - 1 \
            or plan.get("plan_cache_miss") != 1:
        raise AssertionError(f"async plan lookups {plan}")
    for k in ("feeds_pipelined", "async_sync_points"):
        if not plan.get(k):
            raise AssertionError(f"{k} not counted: {plan}")
    # one profiled turn of each (the trajectories stay in step)
    idle = {}
    for kind, turn, out in (("async", async_turn, losses["async"]),
                            ("sync", sync_turn, losses["sync"])):
        reset_launches(*kmods)
        last = []
        busy, wall = _device_busy(
            pm, lambda t=turn: last.extend(t(RS_PROFILED)), RS_PROFILED)
        out += [float(o.asnumpy()) for o in last]
        for k, n in _check_flash(fa, RS_PROFILED, cfg.num_hidden_layers,
                                 f"42b {kind} profiled").items():
            launches[k] += n
        # the profiler's own host cost inflates the profiled step: the
        # share is taken against the unprofiled turns' p50
        p50 = float(np.percentile(turns[kind], 50))
        idle[kind] = {"device_busy_ms_per_step": busy,
                      "profiled_ms_per_step": wall,
                      "device_idle_share_unprofiled": 1.0 - busy / p50,
                      "device_idle_share_profiled": 1.0 - busy / wall}
    # the host syncs of one step of each
    syncs = {}
    probes = (("async", lambda: ex_a.run_steps(lambda i: fd_a, 1,
                                               name="train", sync=False)[0],
               losses["async"]),
              ("sync", lambda: ex_s.run("train", feed_dict=fd_s),
               losses["sync"]))
    for kind, step, out in probes:
        reset_launches(*kmods)
        step_out, syncs[kind] = _sync_sites(step)
        out.append(float(step_out[0].asnumpy()))
        for k, n in _check_flash(fa, 1, cfg.num_hidden_layers,
                                 f"42b {kind} sync probe").items():
            launches[k] += n
    if losses["async"] != losses["sync"]:
        raise AssertionError(f"async losses {losses['async']} != sync "
                             f"{losses['sync']}")
    rep = {"steps": RS_TURNS * RS_TURN_STEPS + RS_PROFILED + 1,
           "losses": losses["sync"], "plan_counts_async": plan,
           "host_syncs_a_step": syncs,
           "turn_ms_per_step": turns,
           "step_ms_p50": {k: float(np.percentile(v, 50))
                           for k, v in turns.items()},
           "sync_run_call_ms_p50": float(np.percentile(call_ms, 50)),
           "idle": idle}
    ex_s.close()
    del ex_s
    _free_cuda()
    return rep


def _dataloader_bert(ht, cfg, data):
    """BERT-base at ``cfg`` with each of its four feeds a ``dataloader_op``
    over ``data`` (the placeholders swapped for loaders, int32 kept)."""
    feeds, loss, _ = ht.bert_pretrain_graph(cfg)
    fetches = [loss, ht.optim.AdamOptimizer(1e-4).minimize(loss)]
    swap = {}
    for key, arr in data.items():
        node = ht.dataloader_op([ht.Dataloader(arr, cfg.batch_size,
                                               "train")], name=key)
        node.dtype, node.shape = np.int32, feeds[key].shape
        swap[feeds[key]] = node
    for node in ht.topo_sort(fetches):
        node.inputs = [swap.get(i, i) for i in node.inputs]
    return ht.Executor({"train": fetches}, seed=0, device="cuda")


def rs_dataloader(ht, fa, metrics, kmods, cfg, launches):
    """42c: the same graph fed by loaders, the double buffer on and off."""
    big = ht.BertConfig.base(batch_size=cfg.batch_size * RS_DL_STEPS,
                             seq_len=cfg.seq_len)
    ids, tt, labels, attn = ht.synthetic_mlm_batch(big, seed=1)
    data = {"input_ids": ids, "token_type_ids": tt,
            "masked_lm_labels": labels, "attention_mask": attn}
    runs = {}
    for pipe in ("1", "0"):
        os.environ["HETU_FEED_PIPELINE"] = pipe
        try:
            ex = _dataloader_bert(ht, cfg, data)
            reset_launches(*kmods)
            metrics.reset_flash_fallbacks()
            metrics.reset_run_plan_counts()
            losses, ms = [], []
            for _ in range(RS_DL_STEPS):
                t0 = time.perf_counter()
                losses.append(float(ex.run("train")[0].asnumpy()))
                ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            os.environ.pop("HETU_FEED_PIPELINE", None)
        for k, n in _check_flash(fa, RS_DL_STEPS, cfg.num_hidden_layers,
                                 f"42c pipeline={pipe}").items():
            launches[k] += n
        _left_kernels(metrics)
        counts = metrics.run_plan_counts()
        piped = counts.get("feeds_pipelined", 0)
        if (pipe == "1") != (piped == 4 * (RS_DL_STEPS - 1)):
            raise AssertionError(f"pipeline={pipe}: feeds_pipelined "
                                 f"{piped}")
        runs[pipe] = {"losses": losses, "step_ms": ms,
                      "step_ms_p50": float(np.percentile(ms, 50)),
                      "run_plan": counts}
        ex.close()
        del ex
        _free_cuda()
    if runs["1"]["losses"] != runs["0"]["losses"]:
        raise AssertionError(f"pipelined losses {runs['1']['losses']} != "
                             f"{runs['0']['losses']}")
    return runs


def rs_precision(ht, fa, metrics, kmods, cfg, batch, launches):
    """42d: matmul_precision None, 'tensorfloat32', 'bfloat16'."""
    runs = {}
    for prec in RS_PRECISIONS:
        feeds, _, ex = _rs_bert(ht, cfg, matmul_precision=prec)
        fd = _bert_feeds(feeds, batch)
        reset_launches(*kmods)
        metrics.reset_flash_fallbacks()
        losses, ms = [], []
        for _ in range(RS_PREC_STEPS):
            t0 = time.perf_counter()
            losses.append(float(ex.run("train", feed_dict=fd)[0].asnumpy()))
            ms.append((time.perf_counter() - t0) * 1e3)
        state = (torch.get_float32_matmul_precision(),
                 torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        if state != ("highest", False, False):
            raise AssertionError(f"matmul_precision={prec}: {state} after "
                                 f"the steps")
        for k, n in _check_flash(fa, RS_PREC_STEPS, cfg.num_hidden_layers,
                                 f"42d {prec}").items():
            launches[k] += n
        _left_kernels(metrics)
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"matmul_precision={prec}: {losses}")
        runs[str(prec)] = {"losses": losses,
                           "step_ms_p50": float(np.percentile(ms, 50))}
        del ex
        _free_cuda()
    base = runs["None"]["losses"]
    for rep in runs.values():
        rep["max_loss_gap_vs_none"] = max(abs(a - b) for a, b in
                                          zip(rep["losses"], base))
    return runs


def rs_remat(ht, fa, metrics, kmods, cfg, batch, launches):
    """42e: remat='auto' with the card's budget and with one that must
    remat everything, against 'off'."""
    runs = {}
    for tag, remat, budget in (("off", "off", None), ("auto", "auto", None),
                               ("auto_small", "auto", RS_SMALL_BUDGET_MB)):
        if budget is not None:
            os.environ["HETU_HBM_BUDGET_MB"] = str(budget)
        try:
            feeds, _, ex = _rs_bert(ht, cfg, remat=remat)
        finally:
            os.environ.pop("HETU_HBM_BUDGET_MB", None)
        fd = _bert_feeds(feeds, batch)
        plan = ex.remat_plan("train")
        _free_cuda()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(*kmods)
        metrics.reset_flash_fallbacks()
        losses = [float(ex.run("train", feed_dict=fd)[0].asnumpy())
                  for _ in range(RS_REMAT_STEPS)]
        rematted = plan["segments_rematted"] if plan else 0
        for k, n in _check_flash(fa, RS_REMAT_STEPS, cfg.num_hidden_layers,
                                 f"42e {tag}",
                                 2 if rematted else 1).items():
            launches[k] += n
        _left_kernels(metrics)
        runs[tag] = {"losses": losses,
                     "peak_mem_gib": torch.cuda.max_memory_allocated()
                     / 2 ** 30,
                     "plan": None if plan is None else
                     {k: plan[k] for k in plan if k != "per_segment"}}
        del ex
        _free_cuda()
    if runs["auto_small"]["plan"]["segments_rematted"] != \
            runs["auto_small"]["plan"]["segments"]:
        raise AssertionError(f"a {RS_SMALL_BUDGET_MB} MB budget left "
                             f"segments unrematted: {runs['auto_small']}")
    for tag in ("auto", "auto_small"):
        if runs[tag]["losses"] != runs["off"]["losses"]:
            raise AssertionError(f"remat {tag} losses {runs[tag]['losses']} "
                                 f"!= off {runs['off']['losses']}")
    return runs


def rs_feed_check(ht, kmods, cfg, feeds, ex):
    """42f: validate='error' names a mis-shaped feed's placeholder."""
    fd = _bert_feeds(feeds, ht.synthetic_mlm_batch(cfg, seed=0))
    key = feeds["input_ids"]
    fd[key] = fd[key][:, :-1]
    reset_launches(*kmods)
    try:
        ex.run("train", feed_dict=fd)
    except ht.GraphValidationError as e:
        if "input_ids" not in str(e):
            raise AssertionError(f"the error does not name input_ids: {e}")
        if _launch_counts(kmods):
            raise AssertionError(f"a rejected feed launched "
                                 f"{_launch_counts(kmods)}")
        return {"raised": type(e).__name__, "message": str(e)[:160]}
    raise AssertionError("a mis-shaped feed ran under validate='error'")


def rs_wdl(ht, emb, seg, kmods, launches):
    """42g: Wide & Deep at phase 9's configuration, sync=False against
    sync=True."""
    batches = ctr_batches(ht)[:RS_WDL_STEPS]
    runs = {}
    for sync in (True, False):
        feeds, ex, _ = wdl_executor(ht, "vlru_dev", "cuda")
        reset_launches(*kmods)
        outs = [ex.run("train", feed_dict=dict(zip(feeds, b)), sync=sync)[0]
                for b in batches]
        runs[sync] = [float(o.asnumpy()) for o in outs]
        for k, mod in (("emb_gather", emb), ("sorted_segment_sum", seg)):
            if mod.launches != RS_WDL_STEPS:
                raise AssertionError(f"{k}: {mod.launches} launches in "
                                     f"{RS_WDL_STEPS} steps (sync={sync})")
            launches[k] += mod.launches
        ex.close()
        del ex
        _free_cuda()
    if runs[True] != runs[False]:
        raise AssertionError(f"WDL async {runs[False]} != sync {runs[True]}")
    return {"losses": runs[True]}


def phase_run_surface(ht, fa, emb, seg, metrics, kmods, pm):
    """Phase 42 (see the module docstring); returns its launches by
    kernels-line name."""
    t_phase = time.perf_counter()
    launches = {k: 0 for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                               "emb_gather", "sorted_segment_sum")}
    cfg = ht.BertConfig.base(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    batch = ht.synthetic_mlm_batch(cfg, seed=0)
    report = {"card": card_line()}

    def part(key, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        out["phase_s"] = time.perf_counter() - t0
        report[key] = out
        log(f"[run-surface] {key} {json.dumps(out)}")

    feeds, ex = [None], [None]

    def construct():
        feeds[0], ex[0], rep = rs_construct(ht, metrics, kmods, cfg)
        return rep

    # the feed pipeline is forced on for any placement cost, so that the
    # side-stream path runs whatever the host's speed
    os.environ["HETU_FEED_PIPELINE_MIN_US"] = "0"
    try:
        with deterministic_algorithms():
            part("a_construct", construct)
            part("b_async", rs_async, ht, fa, metrics, kmods, pm, cfg, batch,
                 feeds[0], ex[0], launches)
            part("f_feed_check", rs_feed_check, ht, kmods, cfg, feeds[0],
                 ex[0])
            ex[0].close()
            ex[0] = None
            _free_cuda()
            part("c_dataloader", rs_dataloader, ht, fa, metrics, kmods, cfg,
                 launches)
            part("e_remat", rs_remat, ht, fa, metrics, kmods, cfg, batch,
                 launches)
            part("g_wdl", rs_wdl, ht, emb, seg, kmods, launches)
        part("d_precision", rs_precision, ht, fa, metrics, kmods, cfg, batch,
             launches)
    finally:
        os.environ.pop("HETU_FEED_PIPELINE_MIN_US", None)
    report["launches"] = launches
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"[run-surface] launches {json.dumps(launches)} card "
        f"{report['card']} phase 42 in {report['phase_s']:.1f} s")
    return launches


# -- phase 43: the sharded parameter server --------------------------------------

def ps_shard(ports, conn, vocab, dim):
    """Phase 43's shard process: rank 1 of the two-rank store, serving
    shard 1 of ``PS_TABLES`` tables of ``vocab`` x ``dim`` until told to
    stop."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from hetu_tpu_torch.ps.dist_store import DistributedStore
    store = DistributedStore(1, 2, [("127.0.0.1", p) for p in ports],
                             port=ports[1])
    for _ in range(PS_TABLES):
        store.init_table(vocab, dim, opt="sgd", lr=0.01, seed=0,
                         init_scale=0.01)
    conn.send(("ready", store.local.native))
    conn.recv()
    store.close()
    conn.send(("closed", None))


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for sk in socks:
        sk.bind(("127.0.0.1", 0))
    ports = [sk.getsockname()[1] for sk in socks]
    for sk in socks:
        sk.close()
    return ports


def ps_wdl(ht, store, tid, mode, weights, device="cuda", **ex_kw):
    """Wide & Deep at the WDL configuration over ``store``'s table
    ``tid`` through the HET cache as ``wdl_criteo`` builds it (``vlru_dev``
    or ``vlru``): (feeds, executor, cache)."""
    dense = ht.placeholder_op("dense")
    sparse = ht.placeholder_op("sparse", dtype=np.int64)
    y_ = ht.placeholder_op("y")
    dev = mode.endswith("_dev")
    cache = ht.DistCacheTable(
        store, tid, limit=max(CTR_VOCAB // 10, 256), pull_bound=10,
        push_bound=10, policy="lru", device=dev,
        device_scratch=min(CTR_VOCAB, CTR_BATCH * 26) if dev else None,
        slab_device=device if dev else None)
    emb = ht.ps_embedding_lookup_op(cache, sparse, width=CTR_DIM)
    loss, _ = ht.models.ctr._wdl_head(emb, dense, y_, CTR_BATCH, CTR_DIM)
    ex = ht.Executor({"train": [loss, ht.optim.SGDOptimizer(0.01)
                                .minimize(loss)]}, seed=0, device=device,
                     **ex_kw)
    if weights is not None:
        ex.load_dict(weights)
    return (dense, sparse, y_), ex, cache


def ps_run(ht, metrics, pm, store, tid, mode, weights, batches, table0,
           device="cuda", profiled=0, flush_each=False, **ex_kw):
    """One run of ``batches`` from ``table0``: its losses, the ms of the
    steps after the first and before the last ``profiled`` (the loss copy
    waits for each), device busy ms a profiled step, RPCs and request
    bytes, then the store table, versions and cache stats after the
    flushes."""
    store.set_data(tid, table0)
    feeds, ex, cache = ps_wdl(ht, store, tid, mode, weights, device,
                              **ex_kw)
    metrics.reset_rpc_stats()
    losses, ms = [], []
    plain = len(batches) - profiled
    for i, b in enumerate(batches[:plain]):
        t0 = time.perf_counter()
        losses.append(float(ex.run("train", feed_dict=dict(
            zip(feeds, b)))[0].asnumpy()))
        if flush_each:
            ex.ps_flush()
        if i:
            ms.append((time.perf_counter() - t0) * 1e3)
    busy = None
    if profiled:
        it = iter(batches[plain:])

        def step():
            losses.append(float(ex.run("train", feed_dict=dict(
                zip(feeds, next(it))))[0].asnumpy()))
        busy = _device_busy(pm, lambda: [step() for _ in range(profiled)],
                            profiled)[0]
    rpc = metrics.rpc_stats()
    ex.ps_flush()
    cache.flush()
    keys = np.arange(CTR_VOCAB)
    out = {"losses": losses, "ms": ms, "busy_ms": busy,
           "rpc_calls": rpc["calls"], "rpc_bytes": rpc["bytes"],
           "table": store.pull(tid, keys), "versions": store.versions(
               tid, keys), "stats": dict(cache.stats),
           "ex": ex, "cache": cache}
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss over the PS ({mode}): "
                             f"{losses}")
    return out


def _per_step(d, steps):
    return {k: v / steps for k, v in sorted(d.items())}


def ps_kernels_at_phase_shapes(emb, seg, cache, ids):
    """B4 and B5 at phase 43's shapes, after its counted steps: the slots
    of a real plan over the sharded store (two batches of ``ids``, the
    second with hits), against their plain versions."""
    from hetu_tpu_torch.ps.dist_store import _segment_sum
    cache.lookup(ids[0])                    # the next batch then has hits
    h = cache.begin_lookup(ids[1])
    try:
        rows = h.roundtrip()
    except BaseException:
        cache.abort_lookup(h)
        raise
    cache.finish_lookup(h, rows)
    slab = cache._ensure_dev_slab()
    slots = torch.from_numpy(h.positions[h.inv].astype(np.int32)).to(
        slab.device)
    out = emb.gather_rows(slab, slots)
    if not torch.equal(out, emb.gather_rows_plain(slab, slots)):
        raise AssertionError("phase 43: B4 vs plain not equal")
    inv = torch.from_numpy(h.inv.astype(np.int32)).to(slab.device)
    g = torch.from_numpy((np.random.RandomState(43).randn(
        h.inv.size, CTR_DIM) * GRAD_SCALE).astype(np.float32)).to(slab.device)
    got = emb.scatter_add_grads(g, inv)
    order = torch.sort(inv, stable=True)
    plain = seg.sorted_segment_sum_plain(g.index_select(0, order.indices),
                                         order.values, g.shape[0])
    err = float((got - plain).abs().max())
    if not torch.allclose(got, plain, rtol=SEG_RTOL, atol=SEG_ATOL):
        raise AssertionError(f"phase 43: B5 vs plain max err {err}")
    u = int(h.uk.size)
    if not np.array_equal(got.cpu().numpy()[:u], _segment_sum(
            g.cpu().numpy(), h.inv, h.cnt)):
        raise AssertionError("phase 43: B5 vs the host _segment_sum")
    return {"n": int(h.inv.size), "unique": u,
            "hits": int(h.hit.sum()), "gather": "equal",
            "segment_sum_max_abs_err": err}


def phase_ps_sharded(ht, emb, seg, metrics, kmods, pm, device="cuda"):
    """Phase 43 (see the module docstring); returns its B4 / B5 launches
    by kernels-line name and the sharded device-cache step's p50 (ms)."""
    from hetu_tpu_torch.ps import build as ps_build
    from hetu_tpu_torch.ps.dist_store import DistributedStore
    t_phase = time.perf_counter()
    ports = _free_ports(2)
    ctx = multiprocessing.get_context("spawn")
    conn, child = ctx.Pipe()
    proc = ctx.Process(target=ps_shard,
                       args=(ports, child, CTR_VOCAB, CTR_DIM), daemon=True)
    proc.start()
    dstore = None
    report = {"card": card_line()}
    launches = {"emb_gather": 0, "sorted_segment_sum": 0}
    try:
        batches = ctr_batches(ht)
        steps = len(batches)
        local = ht.EmbeddingStore()
        ltids = [local.init_table(CTR_VOCAB, CTR_DIM, opt="sgd", lr=0.01,
                                  seed=0, init_scale=0.01)
                 for _ in range(PS_TURNS)]
        table0 = local.get_data(ltids[0])
        _, ex0, _ = ps_wdl(ht, local, ltids[0], "vlru_dev", None, device)
        weights = ex0.return_tensor_values()
        ex0.close()
        dstore = DistributedStore(0, 2, [("127.0.0.1", p) for p in ports],
                                  port=ports[0])
        dtids = [dstore.init_table(CTR_VOCAB, CTR_DIM, opt="sgd", lr=0.01,
                                   seed=0, init_scale=0.01)
                 for _ in range(PS_TABLES)]
        if not conn.poll(PS_TIMEOUT):
            raise AssertionError("phase 43: the shard process did not start")
        status, native = conn.recv()
        if status != "ready" or not (native and dstore.local.native
                                     and local.native):
            raise AssertionError(f"phase 43: the stores' native library is "
                                 f"not loaded ({status}, {native})")

        # (a) the device cache, local and sharded in turns
        runs = {"local": [], "sharded": []}
        for turn in range(PS_TURNS):
            for kind, store, tid in (("local", local, ltids[turn]),
                                     ("sharded", dstore, dtids[turn])):
                reset_launches(*kmods)
                r = ps_run(ht, metrics, pm, store, tid, "vlru_dev", weights,
                           batches, table0, device, profiled=PS_PROFILED)
                got = {"emb_gather": emb.launches,
                       "sorted_segment_sum": seg.launches}
                if any(v != steps for v in got.values()):
                    raise AssertionError(f"phase 43 (a) {kind}: B4 / B5 "
                                         f"launches {got} != {steps}")
                for k in launches:
                    launches[k] += got[k]
                runs[kind].append(r)
                if kind == "local" or turn < PS_TURNS - 1:
                    r["ex"].close()
        for turn in range(PS_TURNS):
            a, b = runs["sharded"][turn], runs["local"][turn]
            if a["losses"] != b["losses"]:
                raise AssertionError(f"phase 43 (a): sharded losses "
                                     f"{a['losses']} != local {b['losses']}")
            for k in ("table", "versions"):
                if not np.array_equal(a[k], b[k]):
                    raise AssertionError(f"phase 43 (a): sharded vs local "
                                         f"{k} differ")
            if a["stats"] != b["stats"]:
                raise AssertionError(f"phase 43 (a): cache stats "
                                     f"{a['stats']} != {b['stats']}")
        last = runs["sharded"][-1]
        kcheck = ps_kernels_at_phase_shapes(emb, seg, last["cache"],
                                            [b[1] for b in batches[:2]])
        last["ex"].close()
        part = {"losses": runs["local"][0]["losses"],
                "equal": "losses, table, versions, cache stats",
                "launches": dict(launches), "kernels_vs_plain": kcheck}
        for kind, rs in runs.items():
            ms = np.concatenate([r["ms"] for r in rs])
            p50 = float(np.percentile(ms, 50))
            busy = float(np.mean([r["busy_ms"] for r in rs]))
            part[kind] = {
                "step_ms_p50": p50, "step_ms": [r["ms"] for r in rs],
                "busy_ms": busy, "idle_share": 1.0 - busy / p50,
                "rpcs_per_step": _per_step(rs[0]["rpc_calls"], steps),
                "request_bytes_per_step": _per_step(rs[0]["rpc_bytes"],
                                                    steps),
                "miss_rows_per_step": rs[0]["stats"]["fetches"] / steps}
        report["a_device_cache"] = part
        log(f"[ps] (a) {json.dumps(part)}")

        # (b) the host cache over the two shards: BSP, ASP, SSP
        reset_launches(*kmods)
        part = {}
        bsp0 = ps_run(ht, metrics, pm, dstore, dtids[2], "vlru", weights,
                      batches, table0, device, bsp=0)
        flushed = ps_run(ht, metrics, pm, dstore, dtids[3], "vlru", weights,
                         batches, table0, device, bsp=-1, flush_each=True)
        asp = ps_run(ht, metrics, pm, dstore, dtids[4], "vlru", weights,
                     batches, table0, device, bsp=-1)
        dstore.ssp_init(1)
        ssp = ps_run(ht, metrics, pm, dstore, dtids[5], "vlru", weights,
                     batches, table0, device, bsp=2)
        clocks = dstore.clocks()
        if flushed["losses"] != bsp0["losses"] or not np.array_equal(
                flushed["table"], bsp0["table"]):
            raise AssertionError("phase 43 (b): ASP flushed each step is not "
                                 "BSP bit for bit")
        if asp["stats"]["updates"] != steps * CTR_BATCH * 26 \
                or asp["ex"]._ps_futures:
            raise AssertionError(f"phase 43 (b): ASP pushes did not all land "
                                 f"({asp['stats']})")
        if clocks.tolist() != [steps] or ssp["losses"] != bsp0["losses"]:
            raise AssertionError(f"phase 43 (b): SSP clocks {clocks} (want "
                                 f"[{steps}]) or losses differ from BSP")
        if emb.launches or seg.launches:
            raise AssertionError("phase 43 (b): the host cache launched B4 / "
                                 "B5")
        for name, r in (("bsp0", bsp0), ("asp_flushed", flushed),
                        ("asp", asp), ("ssp2", ssp)):
            part[name] = {"step_ms_p50": float(np.percentile(r["ms"], 50)),
                          "losses": r["losses"],
                          "rpcs_per_step": _per_step(r["rpc_calls"], steps),
                          "request_bytes_per_step": _per_step(r["rpc_bytes"],
                                                              steps)}
            r["ex"].close()
        part["asp_table_max_abs_diff_vs_bsp0"] = float(
            np.max(np.abs(asp["table"] - bsp0["table"])))
        part["ssp_clocks"] = clocks.tolist()
        report["b_host_cache"] = part
        log(f"[ps] (b) {json.dumps(part)}")

        # (c) the native HET cache (CacheSparseTable) on the default store
        feeds, ex, cache = wdl_executor(ht, "lru", device)
        if cache._h is None or not cache.store.native:
            raise AssertionError("phase 43 (c): the native cache is not in "
                                 "use")
        ms, losses = [], []
        for i, b in enumerate(batches):
            t0 = time.perf_counter()
            losses.append(float(ex.run("train", feed_dict=dict(
                zip(feeds, b)))[0].asnumpy()))
            if i:
                ms.append((time.perf_counter() - t0) * 1e3)
        if not all(math.isfinite(x) for x in losses) \
                or emb.launches or seg.launches:
            raise AssertionError(f"phase 43 (c): losses {losses}, B4 / B5 "
                                 f"{emb.launches} / {seg.launches}")
        perf = cache.perf()
        ex.close()
        part = {"step_ms_p50": float(np.percentile(ms, 50)),
                "losses": losses, "hit_rate": perf["hit_rate"],
                "perf": perf,
                "library": os.path.basename(ps_build.library_path())}
        report["c_native_lru"] = part
        log(f"[ps] (c) {json.dumps(part)}")
    finally:
        if dstore is not None:
            dstore.close()
        if proc.is_alive():
            try:
                conn.send("stop")
                if conn.poll(PS_TIMEOUT):
                    conn.recv()
            except (OSError, EOFError):
                pass
        proc.join(30)
        if proc.is_alive():
            proc.terminate()
            proc.join(10)
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"[ps] launches {json.dumps(launches)} card {report['card']} "
        f"phase 43 in {report['phase_s']:.1f} s")
    return launches, report["a_device_cache"]["sharded"]["step_ms_p50"]


# -- the remaining transformer families: ViT, Swin, MAE, CLIP, the base
# -- Transformer, BART, BigBird, Transformer-XL, Reformer ------------------------

def _fam_feeds(ht, model, cfg, seed=0, segment=0):
    """Seeded feeds {name: array} of a family's graph: the images and
    labels of ``synthetic_image_batch`` (ViT, Swin), the images and
    shuffles of ``synthetic_mae_batch``, ``rand`` images and uniform ids
    (CLIP), the copy task (the base Transformer), uniform source, target
    and next-token ids (BART), MLM ids (BigBird), next-token ids
    (Reformer) and, for Transformer-XL, segment ``segment`` of one seeded
    text, so consecutive segments carry the memory."""
    rng = np.random.RandomState(seed)
    b = cfg.batch_size
    if model in ("vit", "swin"):
        return dict(zip(("images", "labels"),
                        ht.synthetic_image_batch(cfg, seed)))
    if model == "mae":
        return dict(zip(("images", "shuffle"),
                        ht.synthetic_mae_batch(cfg, seed)))
    if model == "clip":
        return {"images": rng.rand(b, 3, cfg.image_size,
                                   cfg.image_size).astype(np.float32),
                "input_ids": rng.randint(0, cfg.vocab_size,
                                         (b, cfg.text_len)).astype(np.int32)}
    if model == "transformer":
        return dict(zip(("src_ids", "tgt_ids", "labels"),
                        ht.synthetic_copy_batch(cfg, seed)))
    if model == "bart":
        tgt = rng.randint(0, cfg.vocab_size, (b, cfg.tgt_len + 1))
        return {"input_ids": rng.randint(0, cfg.vocab_size,
                                         (b, cfg.src_len)).astype(np.int32),
                "decoder_input_ids": tgt[:, :-1].astype(np.int32),
                "labels": tgt[:, 1:].astype(np.int32)}
    if model == "bigbird":
        return dict(zip(("input_ids", "labels"),
                        ht.synthetic_mlm_ids(cfg, seed)))
    seq = cfg.tgt_len if model == "transfoxl" else cfg.seq_len
    text = rng.randint(0, cfg.vocab_size, (b, (segment + 1) * seq + 1))
    part = text[:, segment * seq:].astype(np.int32)
    return {"input_ids": part[:, :-1], "labels": part[:, 1:]}


#: each family at its published widths: (config, graph, published
#: config's keywords beside the cut ones, the flash counters a counted step
#: reads by name); the cut ones are (c)'s 2 layers (2 + 2 for the
#: encoder-decoders) and batch
FAMILIES = {
    "vit": ("ViTConfig", "vit_classify_graph", dict(batch_size=FAM_BATCH),
            {"": 12}),
    "swin": ("SwinConfig", "swin_classify_graph", dict(batch_size=FAM_BATCH),
             {"bias": 7, "mask_bias": 5}),
    "bart": ("BartConfig", "bart_seq2seq_graph",
             dict(encoder_layers=2, decoder_layers=2, batch_size=FAM_BATCH),
             {"": 4, "causal": 2}),
    "bigbird": ("BigBirdConfig", "bigbird_mlm_graph",
                dict(num_hidden_layers=2, batch_size=2, seq_len=1024),
                {"mask": 2}),
    "clip": ("CLIPConfig", "clip_graph",
             dict(vision_layers=2, text_layers=2, batch_size=FAM_BATCH),
             {"": 2, "causal": 2}),
    "mae": ("MAEConfig", "mae_pretrain_graph",
            dict(encoder_layers=2, decoder_layers=2, batch_size=FAM_BATCH),
            {"": 4}),
    "transformer": ("TransformerConfig", "transformer_graph",
                    dict(num_layers=2, batch_size=FAM_BATCH),
                    {"": 4, "causal": 2}),
    "transfoxl": ("TransfoXLConfig", "transfoxl_lm_graph",
                  dict(n_layer=2, batch_size=4), {"bias_causal": 2}),
    "reformer": ("ReformerConfig", "reformer_lm_graph",
                 dict(num_hidden_layers=2, batch_size=2), {}),
}
#: the dropout keyword of each family's config (0 for the card-vs-CPU
#: check: the card's and the CPU's generators draw different masks)
FAM_DROPOUT = {"bart": "dropout", "bigbird": "hidden_dropout_prob",
               "transformer": "dropout", "transfoxl": "dropout",
               "reformer": "hidden_dropout_prob"}


def _fam_config(ht, model, **over):
    config, _, kw, _ = FAMILIES[model]
    make = getattr(ht, config)
    make = make.base if hasattr(make, "base") else make
    return make(**dict(kw, **over))


def _fam_counters(model):
    """The flash counters a family's step reads, with their launches a
    step: ``fwd_bias_causal_launches`` etc."""
    out = {}
    for sfx, n in FAMILIES[model][3].items():
        for kind in ("fwd", "dq", "dkv"):
            out[kind + ("_" + sfx if sfx else "") + "_launches"] = n
    return out


def _fam_graph(ht, model, cfg):
    feeds, loss, _ = getattr(ht, FAMILIES[model][1])(cfg)
    return feeds, loss


def phase_family_kernels(ht, fa):
    """(a) The flash kernels vs their plain versions at the new families'
    shapes, each timed as phase 21's (64 MB L2 flush, median of 50 CUDA
    events) beside its bound and SDPA: Swin-T stage 1's windows (BH 1,536
    = 8 x 64 windows x 3 heads, S 49, D 32), shifted (the tiled shift mask
    group ``b`` and the relative bias group ``h``) and unshifted (the bias
    alone); ViT-B/16 (dense, BH 96, S 196, D 64); CLIP's text tower
    (causal, BH 64, S 77, D 64); Transformer-XL wt103 (causal + bias
    group ``h``, S_q 128 over 160 + 128 keys, BH 40, D 41 zero-padded to
    44 as :class:`FlashAttention` pads it, scale 1/sqrt(41)); BigBird-base
    (the block-sparse mask, group ``one``, BH 24, S 1024, D 64).  The D =
    41 entry is also held end to end: ``fa.flash_attention`` on the
    unpadded tensors, out and every gradient against the plain attention
    at D = 41, three ``dpad_launches``.  Returns {shape name: {fwd, dq,
    dkv: timing row with max_abs_err}}."""
    from hetu_tpu_torch.models.swin import _rel_bias_index, _shift_mask
    from hetu_tpu_torch.ops.attention import sdpa_reference
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    rng = np.random.RandomState(44)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda()

    swin = ht.SwinConfig.base()
    w, res = swin.window_size, swin.image_size // swin.patch_size
    nwin = FAM_BATCH * (res // w) ** 2
    sheads = swin.num_heads[0]
    table = rng.randn((2 * w - 1) ** 2, sheads).astype(np.float32) * 0.02
    sbias = torch.from_numpy(np.ascontiguousarray(
        table[_rel_bias_index(w)].reshape(w * w, w * w, sheads)
        .transpose(2, 0, 1))).cuda()                         # (3, 49, 49)
    smask = torch.from_numpy(np.ascontiguousarray(np.tile(
        _shift_mask(res, res, w, w // 2), (FAM_BATCH, 1, 1)) != 0,
        np.uint8)).cuda()                                     # (512, 49, 49)
    xl = ht.TransfoXLConfig.base()
    xheads, xd = xl.n_head, xl.d_model // xl.n_head
    xkv = xl.mem_len + xl.tgt_len
    bb = ht.BigBirdConfig.base()
    bmask = torch.from_numpy(ht.bigbird_attention_mask(
        bb.seq_len, bb.block_size, bb.num_random_blocks,
        bb.num_global_blocks, bb.mask_seed)[None] != 0).to(
            torch.uint8).cuda()
    # (name, B, heads, S_q, S_kv, D, causal, mask, mask group, bias, bias
    # group, scale)
    cases = [
        ("swin_shifted", nwin, sheads, w * w, w * w, 32, False, smask, "b",
         sbias, "h", 32 ** -0.5),
        ("swin_unshifted", nwin, sheads, w * w, w * w, 32, False, None, None,
         sbias, "h", 32 ** -0.5),
        ("vit", FAM_BATCH, 12, 196, 196, 64, False, None, None, None, None,
         0.125),
        ("clip_text", FAM_BATCH, 8, 77, 77, 64, True, None, None, None, None,
         0.125),
        ("transfoxl_d41", xl.batch_size, xheads, xl.tgt_len, xkv, xd, True,
         None, None, t(xheads, xl.tgt_len, xkv) * 0.1, "h", xd ** -0.5),
        ("bigbird", bb.batch_size, 12, bb.seq_len, bb.seq_len, 64, False,
         bmask, "one", None, None, 0.125)]
    rows = {}
    for (name, b, heads, s_q, s_kv, d, causal, mask, mg, bias, bg,
         scale) in cases:
        bh = b * heads
        dk = fa.padded_head_dim(d, torch.float32)
        q, k, v, do = (torch.nn.functional.pad(x, (0, dk - d)) for x in (
            t(bh, s_q, d), t(bh, s_kv, d), t(bh, s_kv, d), t(bh, s_q, d)))
        err, row = attn_case(fa, "[family-kernels]", name, q, k, v, do,
                             heads, scale, causal=causal, bias=bias,
                             gmode=bg or "bh", flush=flush_buf.zero_,
                             mask=mask, mask_gmode=mg or "bh")
        for kk in row:
            row[kk]["max_abs_err"] = err[kk]
            row[kk]["shape"] = {"B": b, "H": heads, "S_q": s_q,
                                "S_kv": s_kv, "D": d, "D_launched": dk}
        rows[name] = row
        if dk != d:
            # the entry on the unpadded tensors: it pads, launches, slices
            q4, k4, v4 = (x[..., :d].reshape(b, heads, -1, d).detach()
                          .requires_grad_(True) for x in (q, k, v))
            b4 = bias.reshape(1, heads, s_q, s_kv).detach() \
                .requires_grad_(True)
            do4 = do[..., :d].reshape(b, heads, s_q, d)
            before = dict(vars(fa))
            out = fa.flash_attention(q4, k4, v4, causal=causal, bias=b4)
            got = (out,) + torch.autograd.grad(out, (q4, k4, v4, b4), do4)
            torch.cuda.synchronize()
            moved = {n: c - before[n] for n, c in vars(fa).items()
                     if n.endswith("launches") and c != before[n]}
            ref = sdpa_reference(q4, k4, v4, causal=causal, bias=b4)
            want = (ref,) + torch.autograd.grad(ref, (q4, k4, v4, b4), do4)
            e2e = 0.0
            for what, g, w_ in zip(("out", "dq", "dk", "dv", "dbias"), got,
                                   want):
                e2e = max(e2e, float((g - w_).abs().max()))
                if g.shape != w_.shape or not torch.allclose(
                        g, w_, rtol=GRAD_RTOL, atol=GRAD_ATOL):
                    raise AssertionError(f"{name} entry {what} vs plain: "
                                         f"{float((g - w_).abs().max())}")
            if moved != {"fwd_bias_causal_launches": 1,
                         "dq_bias_causal_launches": 1,
                         "dkv_bias_causal_launches": 1, "dpad_launches": 3}:
                raise AssertionError(f"{name} entry launched {moved}")
            log(f"[family-kernels] {name} entry at D={d} (padded to {dk}): "
                f"out, dQ, dK, dV, dbias vs plain max_abs_err {e2e:.3e}; "
                f"launches {json.dumps(moved)}")
            for kk in row:
                row[kk]["max_abs_err"] = max(row[kk]["max_abs_err"], e2e)
            _unpadded_yardsticks(fa, row, q, k, v, do, d, heads, scale,
                                 causal, bias, flush_buf.zero_)
        del q, k, v, do
        torch.cuda.empty_cache()
    return rows


def _unpadded_yardsticks(fa, row, q, k, v, do, d, heads, scale, causal,
                         bias, flush):
    """For a case launched zero-padded along D: the bound, the plain
    versions and SDPA of the function the entry computes, at the true
    ``d`` on the unpadded columns of ``q``, ``k``, ``v``, ``dO`` (BH, S,
    D_padded), in place of attn_case's at the launched D."""
    F = torch.nn.functional
    q, k, v, do = (x[..., :d].contiguous() for x in (q, k, v, do))
    bh, s_q, s_kv = q.shape[0], q.shape[1], k.shape[1]
    pkw = dict(causal=causal, bias=bias, bgmode="h")
    out, lse = fa.flash_fwd_plain(q, k, v, None, heads, scale, **pkw)
    row["fwd"]["plain_ms"] = time_ms(
        lambda: fa.flash_fwd_plain(q, k, v, None, heads, scale, **pkw),
        flush=flush)
    row["dq"]["plain_ms"] = row["dkv"]["plain_ms"] = time_ms(
        lambda: fa.flash_bwd_bias_plain(q, k, v, None, bias, None, "h",
                                        heads, out, lse, do, scale,
                                        causal=causal), flush=flush)
    qkv4, kw, what = sdpa_yardstick(fa, q, k, v, heads, scale, None, causal,
                                    bias, None, "h")
    do4 = do.view(qkv4[0].shape)
    with torch.enable_grad():
        lib_out = F.scaled_dot_product_attention(*qkv4, **kw)
    lib_grads = qkv4 + (kw["attn_mask"],)
    try:
        torch.autograd.grad(lib_out, lib_grads, do4, retain_graph=True)
    except RuntimeError:               # the yardstick only: no bias gradient
        lib_grads = qkv4
    row["fwd"]["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(
            *(x.detach() for x in qkv4),
            **{a: (b.detach() if torch.is_tensor(b) else b)
               for a, b in kw.items()}), flush=flush)
    row["dq"]["library_ms"] = row["dkv"]["library_ms"] = time_ms(
        lambda: torch.autograd.grad(lib_out, lib_grads, do4,
                                    retain_graph=True), flush=flush)
    for kk, r in row.items():
        r["bound_ms"], r["bound_by"] = attn_bound(
            kk, bh, s_q, s_kv, d, r["visible_pairs"],
            attn_extra(kk, None, bias, None, bh, s_q, s_kv))
    log(f"[family-kernels] D={d} yardsticks (library = {what}) "
        f"{json.dumps(row)}")


def _fam_parity(ht, model, cfg, steps=1):
    """The family's graph (dropout 0) on the card and on the CPU from the
    card's weights: ``steps`` Adam steps (Transformer-XL: 2 consecutive
    segments, the second reading the memory the first wrote), the losses
    within TRAIN_LOSS_RTOL, the step-1 gradient of every variable within
    ``allclose(TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL)``.  Returns the worst
    errors."""
    feeds, loss = _fam_graph(ht, model, cfg)
    wrt = [n for n in ht.topo_sort([loss])
           if isinstance(n, ht.PlaceholderOp) and n.is_variable
           and n.trainable]
    fetches = {"train": [loss, ht.optim.AdamOptimizer(1e-4).minimize(loss)]
               + ht.gradients(loss, wrt)}
    card = ht.Executor(fetches, seed=0, device="cuda")
    host = ht.Executor(fetches, seed=0, device="cpu")
    load_all(host, card.return_tensor_values())
    loss_err = grad_err = 0.0
    for step in range(steps):
        fd = {feeds[k_]: v_ for k_, v_ in _fam_feeds(
            ht, model, cfg, seed=1, segment=step).items()}
        got = card.run("train", feed_dict=fd, convert_to_numpy_ret_vals=True)
        want = host.run("train", feed_dict=fd,
                        convert_to_numpy_ret_vals=True)
        gl, wl = float(got[0]), float(want[0])
        loss_err = max(loss_err, abs(gl - wl) / abs(wl))
        if not (math.isfinite(gl) and abs(gl - wl) <= TRAIN_LOSS_RTOL
                * abs(wl)):
            raise AssertionError(f"card vs CPU {model} loss at step "
                                 f"{step + 1}: {gl} vs {wl}")
        if step == 0:
            for node, g, w_ in zip(wrt, got[2:], want[2:]):
                grad_err = max(grad_err, float(np.max(np.abs(g - w_))))
                if not np.allclose(g, w_, rtol=TRAIN_GRAD_RTOL,
                                   atol=TRAIN_GRAD_ATOL):
                    raise AssertionError(
                        f"card vs CPU {model} gradient of {node.name}: max "
                        f"err {float(np.max(np.abs(g - w_)))}")
    card.close()
    host.close()
    del card, host
    torch.cuda.empty_cache()
    return {"batch": cfg.batch_size, "steps": steps, "variables": len(wrt),
            "loss_max_rel_err": loss_err, "grad_max_abs_err": grad_err}


def _fam_flops(loss, fd):
    """Model FLOPs of one training step on the feeds ``fd`` ({placeholder:
    array}): 6 x the forward's multiply-adds of the linear layers and of
    attention on its visible pairs (``profile_train.graph_flops``)."""
    from hetu_tpu_torch.tools import profile_train as pt
    macs = pt.graph_flops(loss, {n: np.shape(v_) for n, v_ in fd.items()})
    return 6.0 * (macs["linear"] + macs["attention"]), macs


def phase_family_full(ht, fa, metrics, kmods, model):
    """(b) ViT-B/16 or Swin-T at full width and depth (batch FAM_BATCH):
    ``vit_classify_graph`` / ``swin_classify_graph`` →
    ``AdamOptimizer(1e-4)`` → ``Executor.run``, FAM_WARMUP + FAM_STEPS
    steps through ``train_path`` (every flash counter of the path at its
    launches a step: ViT's dense ones 12, Swin's bias ones 7 (the
    unshifted blocks, stage 4's two included) and mask-with-bias ones 5),
    p50 / p99, samples/s, MFU against 67 TFLOP/s from the graph's linear
    and attention shapes, peak memory; FAM_PROFILED profiled steps (idle
    share, flash time by entry); then the step-1 card-vs-CPU check at
    batch FAM_PARITY_BATCH.  Returns the counted launches by
    kernels-line name."""
    from hetu_tpu_torch.tools.profile_train import profile_steps
    tag = f"[{model}-train]"
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    cfg = _fam_config(ht, model)
    feeds, loss = _fam_graph(ht, model, cfg)
    fd = {feeds[k_]: v_ for k_, v_ in _fam_feeds(ht, model, cfg).items()}
    flops, macs = _fam_flops(loss, fd)
    train_op = ht.optim.AdamOptimizer(1e-4).minimize(loss)
    t0 = time.perf_counter()
    ex = ht.Executor({"train": [loss, train_op]}, seed=0, device="cuda")
    log(f"{tag} executor built in {time.perf_counter() - t0:.1f} s")
    want = _fam_counters(model)
    want = {n: c * FAM_STEPS for n, c in want.items()}
    report = train_path(fa, metrics, kmods, tag, ex, fd, FAM_STEPS,
                        FAM_WARMUP, tuple(want), want, (flops, flops), base)
    step_s = report["step_ms_mean"] / 1e3
    report["profiled"], _ = profile_steps(
        lambda: float(ex.run("train", feed_dict=fd)[0].asnumpy()),
        FAM_PROFILED, step_s)
    ex.close()
    del ex
    torch.cuda.empty_cache()
    report.update({
        "batch": cfg.batch_size, "samples_per_s": cfg.batch_size / step_s,
        "forward_macs": macs,
        "parity": _fam_parity(ht, model, _fam_config(
            ht, model, batch_size=FAM_PARITY_BATCH))})
    for k_ in ("mfu_fp32_dense_attention",
               "model_tflop_per_step_dense_attention"):
        report.pop(k_)
    log(f"{tag} {json.dumps(report)}")
    return {line_name(n): c for n, c in report["launches"].items()}


def phase_family_cut(ht, fa, metrics, kmods, model):
    """(c) One family at published widths cut to 2 layers (2 + 2 for
    BART, MAE and the base Transformer; each cut in FAMILIES): FAM_CUT_STEPS
    Adam steps through ``Executor.run`` with every launch counter set to 0
    just before and read just after (the path's flash counters at their
    launches a step, every other 0; Reformer's LSH attention is plain
    PyTorch: no flash launch at all; Transformer-XL's consecutive
    segments write and read the memory on the card and every one of its
    launches is also a ``dpad_launches`` one), finite losses, p50; then
    the step-1 card-vs-CPU check at batch FAM_PARITY_BATCH (Transformer-XL
    two segments).  Returns the counted launches by kernels-line name and
    Transformer-XL's padded launches."""
    tag = f"[{model}-cut]"
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    cfg = _fam_config(ht, model)
    feeds, loss = _fam_graph(ht, model, cfg)
    train_op = ht.optim.AdamOptimizer(1e-4).minimize(loss)
    t0 = time.perf_counter()
    ex = ht.Executor({"train": [loss, train_op]}, seed=0, device="cuda")
    built = time.perf_counter() - t0
    fds = [{feeds[k_]: v_ for k_, v_ in _fam_feeds(
        ht, model, cfg, segment=i if model == "transfoxl" else 0).items()}
        for i in range(FAM_CUT_STEPS)]
    mems = [n for n in ex.var_values if n.name.endswith(".mems")]
    torch.cuda.synchronize()
    reset_launches(*kmods)
    metrics.reset_flash_fallbacks()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for fd in fds:
        t0 = time.perf_counter()
        losses.append(float(ex.run("train", feed_dict=fd)[0].asnumpy()))
        times.append(time.perf_counter() - t0)
    want = {n: c * FAM_CUT_STEPS for n, c in _fam_counters(model).items()}
    if model == "transfoxl":
        want["dpad_launches"] = sum(want.values())
    want = {n: c for n, c in want.items() if c}
    got = {name: n for m in kmods for name, n in vars(m).items()
           if name.endswith("launches") and n}
    if got != want:
        raise AssertionError(f"{tag} launches {got} != {want}")
    left = {r: n for r, n in metrics.flash_fallback_counts().items()
            if r.startswith("backend:")}
    if left:
        raise AssertionError(f"{tag} attention left the kernels: {left}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag} non-finite loss: {losses}")
    if mems and not all(float(ex.var_values[m].abs().max()) > 0
                        for m in mems):
        raise AssertionError(f"{tag} the memory was not written")
    ms = np.asarray(times[1:]) * 1e3         # the first step is untimed
    report = {"config": {k_: v_ for k_, v_ in vars(cfg).items()
                         if k_ in FAMILIES[model][2]
                         or k_ in ("hidden_size", "d_model", "vocab_size")},
              "executor_build_s": built, "steps": FAM_CUT_STEPS,
              "losses": losses, "step_ms_p50": float(np.percentile(ms, 50)),
              "peak_mem_gib": (torch.cuda.max_memory_allocated() - base)
              / 2 ** 30, "launches": got, "card": card_line()}
    ex.close()
    del ex
    torch.cuda.empty_cache()
    report["parity"] = _fam_parity(
        ht, model, _fam_config(ht, model, batch_size=FAM_PARITY_BATCH,
                               **({FAM_DROPOUT[model]: 0.0}
                                  if model in FAM_DROPOUT else {})),
        steps=2 if model == "transfoxl" else 1)
    log(f"{tag} {json.dumps(report)}")
    counts = {line_name(n): c for n, c in got.items()
              if n != "dpad_launches"}
    return counts, got.get("dpad_launches", 0)


def phase_families(ht, fa, metrics, kmods):
    """Phase 44: (a) the kernels at the families' new shapes, (b) ViT-B/16
    and Swin-T at full depth, (c) the seven others cut to 2 layers.
    Returns (the (a) rows by shape, the launches by kernels-line name,
    Transformer-XL's padded launches by kernels-line name)."""
    t_phase = time.perf_counter()
    rows = phase_family_kernels(ht, fa)
    launches, dpad = {}, {}
    for model in ("vit", "swin"):
        for name, n in phase_family_full(ht, fa, metrics, kmods,
                                         model).items():
            launches[name] = launches.get(name, 0) + n
    for model in ("bart", "bigbird", "clip", "mae", "transformer",
                  "transfoxl", "reformer"):
        counts, padded = phase_family_cut(ht, fa, metrics, kmods, model)
        if model == "transfoxl":
            # every Transformer-XL launch is a padded one (D 41 -> 44)
            if padded != sum(counts.values()):
                raise AssertionError(f"Transformer-XL padded launches "
                                     f"{padded} != {counts}")
            dpad = dict(counts)
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    log(f"[families] launches {json.dumps(launches)} padded "
        f"{json.dumps(dpad)} phase 44 in {time.perf_counter() - t_phase:.1f}"
        f" s")
    return rows, launches, dpad


# -- 45. the serving planes ---------------------------------------------------------

# GPT-2 small behind the prefix store: the cache length, the slots, the
# shared preamble, the suffix range, the requests and their new tokens
SP_MAX_LEN, SP_SLOTS, SP_PREAMBLE, SP_SUFFIX = 512, 8, 256, (16, 64)
SP_REQUESTS, SP_NEW, SP_STORE_BYTES = 16, 32, 512 << 20
# replica 1 of the two-replica fleet is killed once it emitted this many
SP_KILL_AFTER = 8
# BERT-base classification behind the request router
SP_BERT_BATCH, SP_BERT_SEQ, SP_BERT_REQS, SP_BERT_THREADS = 32, 128, 256, 8
SP_BERT_WAIT_MS, SP_ROW_ATOL, SP_FLEET_REQS = 2.0, 1e-5, 64


def sp_prompts(cfg, seed=45):
    """``SP_REQUESTS`` prompts: one seeded ``SP_PREAMBLE``-token preamble,
    each followed by its own seeded suffix of ``SP_SUFFIX`` tokens; and a
    priming prompt (the preamble and 8 tokens of its own)."""
    rng = np.random.RandomState(seed)
    pre = rng.randint(0, cfg.vocab_size, SP_PREAMBLE)
    prompts = [np.concatenate([pre, rng.randint(
        0, cfg.vocab_size, rng.randint(SP_SUFFIX[0], SP_SUFFIX[1] + 1))])
        for _ in range(SP_REQUESTS)]
    prime = np.concatenate([pre, rng.randint(0, cfg.vocab_size, 8)])
    return prompts, prime


def sp_engine(ht, graphs, weights, device, store=None):
    (feeds, logits, caches, _), cg = graphs
    return ht.DecodeEngine(feeds, logits, caches, weights=weights,
                           max_slots=SP_SLOTS, max_len=SP_MAX_LEN,
                           device=device, chunked=cg[:3],
                           max_chunk=PREFILL_CHUNK, prefix_store=store)


def sp_serve(ht, metrics, engine, prompts, prime=None, on_start=None):
    """``prompts`` through one ``DecodeRouter`` after an untimed warm-up
    (and the priming request, whose snapshot the prompts then hit); the
    decode, prefix-cache and fallback counters set to 0 just before, and
    ``on_start()`` called there (the caller's launch counters).  Returns
    (streams, report)."""
    with ht.DecodeRouter(engine, queue_limit=len(prompts) + 1) as router:
        router.submit(prompts[0][:40], max_new_tokens=2).result(timeout=300)
        if prime is not None:
            router.submit(prime, max_new_tokens=1).result(timeout=300)
        sync(engine.device)
        metrics.reset_decode_counts()
        metrics.reset_prefix_cache_counts()
        metrics.reset_flash_fallbacks()
        if on_start is not None:
            on_start()
        t0 = time.perf_counter()
        streams = [router.submit(p, max_new_tokens=SP_NEW) for p in prompts]
        out = [s.result(timeout=900) for s in streams]
        sync(engine.device)
        wall = time.perf_counter() - t0
    counts = metrics.decode_counts()
    pc = metrics.prefix_cache_counts()
    lat = metrics.decode_latency_stats()
    report = {k: counts.get(k, 0) for k in (
        "decode_steps", "decode_prefill_steps", "decode_prefill_steps_saved",
        "decode_prefill_rows", "decode_tokens")}
    report.update({
        "prefix_cache_hits": pc.get("prefix_cache_hits", 0),
        "prefix_cache_hit_rows": pc.get("prefix_cache_hit_rows", 0),
        "prefix_cache_bytes_hw": pc.get("prefix_cache_bytes_hw", 0),
        "wall_s": wall, "tokens_per_s": counts.get("decode_tokens", 0) / wall,
        "ttft_p50_ms": lat["ttft"]["p50"] / 1e3,
        "ttft_p99_ms": lat["ttft"]["p99"] / 1e3,
        "step_p50_ms": lat["step"]["p50"] / 1e3,
        "fallbacks": metrics.flash_fallback_counts()})
    return out, report


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def sp_agree(tag, got, want, prompts, engine):
    """Greedy streams equal token for token, or apart only at a near tie:
    the one-token engine's top-2 logit gap at the first differing token
    under ``2 * LOGITS_ATOL`` (phase 17's rule).  Returns the count of
    equal streams."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        at = next(j for j in range(len(b)) if a[j] != b[j])
        row = np.sort(teacher_forced_logits(
            engine, list(prompts[i]) + list(b[:at]))[-1])
        gap = float(row[-1] - row[-2])
        log(f"[{tag}] stream {i} differs from token {at}: {a[at]} vs "
            f"{b[at]}; top-2 logit gap {gap:.3e}")
        if not gap < 2 * LOGITS_ATOL:
            raise AssertionError(f"{tag}: stream {i} differs at token {at} "
                                 f"with a top-2 gap of {gap}")
    return sum(a == b for a, b in zip(got, want))


def sp_recovery(ht, metrics, graphs, weights, device, prompts,
                on_start=None):
    """Two chunked ``DecodeRouter`` replicas behind a ``FrontDoor``,
    sharing one prefix store and the weights: every prompt submitted,
    replica 1 killed once its streams hold ``SP_KILL_AFTER`` tokens, the
    door polled until every stream is done.  Returns (streams, report)."""
    store = ht.PrefixKVStore(capacity_bytes=SP_STORE_BYTES)
    routers = {}

    def mk(idx):
        routers[idx] = ht.DecodeRouter(
            sp_engine(ht, graphs, weights, device, store),
            queue_limit=len(prompts), name=f"r{idx}")
        return routers[idx]

    door = ht.FrontDoor(mk, 2, wedge_timeout_ms=60000.0)
    try:
        for r in routers.values():       # warm-up, uncounted
            r.submit(prompts[0][:40], max_new_tokens=2).result(timeout=300)
        sync(device)
        for reset in (metrics.reset_decode_counts,
                      metrics.reset_decode_recovery_counts,
                      metrics.reset_fleet_counts,
                      metrics.reset_prefix_cache_counts,
                      metrics.reset_flash_fallbacks):
            reset()
        if on_start is not None:
            on_start()
        t0 = time.perf_counter()
        streams, on1 = [], []
        for p in prompts:
            before = routers[1].pending
            streams.append(door.submit(p, max_new_tokens=SP_NEW))
            if routers[1].pending > before:
                on1.append(streams[-1])
        deadline = time.monotonic() + 600
        while sum(s.n_tokens for s in on1) < SP_KILL_AFTER:
            if time.monotonic() > deadline:
                raise AssertionError("replica 1 emitted no tokens")
            time.sleep(0.001)
        killed_at = sum(s.n_tokens for s in on1)
        routers[1].kill()
        while not all(s.done for s in streams):
            if time.monotonic() > deadline:
                raise AssertionError("streams did not finish after the kill")
            door.poll()
            time.sleep(0.002)
        out = [s.result(timeout=5) for s in streams]
        sync(device)
        wall = time.perf_counter() - t0
    finally:
        door.close()
    rec = metrics.decode_recovery_counts()
    lat = metrics.decode_latency_stats()
    report = {"streams_on_replica_1": len(on1), "tokens_at_kill": killed_at,
              "wall_s": wall, "decode_recovery": rec,
              "fleet": metrics.fleet_counts(),
              "recovery_p50_ms": lat["recovery"]["p50"] / 1e3
              if "recovery" in lat else None,
              "fallbacks": metrics.flash_fallback_counts()}
    return out, report


def sp_bert(ht, metrics, device, tmp, cfg=None):
    """BERT-base classification (``num_labels=2``) from a checkpoint
    directory that ``Executor.save`` wrote, served through
    ``ServingRouter`` from ``SP_BERT_THREADS`` submitting threads, each
    response held to ``iex.infer`` of its request alone; then a
    two-replica ``FrontDoor`` of such routers with replica 1 killed.
    Returns (report, the serving calls made: each request alone, the
    router's batches and the door's)."""
    import threading
    cfg = cfg or ht.BertConfig.base(batch_size=SP_BERT_BATCH,
                                    seq_len=SP_BERT_SEQ)
    feeds, _, logits = ht.bert_classify_graph(cfg, num_labels=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # dropout in a served graph warns
        ex = ht.Executor({"eval": [logits]}, seed=0, device=device)
        ck = os.path.join(tmp, "bert_classify")
        t0 = time.perf_counter()
        ex.save(ck)
        save_s = time.perf_counter() - t0
        del ex
        iex = ht.InferenceExecutor([logits], weights=ck,
                                   buckets=(cfg.batch_size,), device=device,
                                   strict=True)
    data = copy.copy(cfg)
    data.batch_size = SP_BERT_REQS
    ids, tt, _, mask = ht.synthetic_mlm_batch(data, seed=45)
    reqs = [{feeds["input_ids"]: ids[i], feeds["token_type_ids"]: tt[i],
             feeds["attention_mask"]: mask[i]} for i in range(len(ids))]
    metrics.reset_serve_counts()
    want = [iex.infer({k: v[None] for k, v in r.items()})[0][0]
            for r in reqs]
    b_alone = metrics.serve_counts().get("serve_batches", 0)
    metrics.reset_serve_latency()
    got, lat = [None] * len(reqs), [None] * len(reqs)
    router = ht.ServingRouter(iex, max_batch=cfg.batch_size,
                              max_wait_ms=SP_BERT_WAIT_MS,
                              queue_limit=len(reqs))

    def client(k):
        for i in range(k, len(reqs), SP_BERT_THREADS):
            t = time.perf_counter()
            got[i] = router.submit(reqs[i]).result(timeout=300)[0]
            lat[i] = (time.perf_counter() - t) * 1e3

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,))
               for k in range(SP_BERT_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    router.close()
    batches = metrics.serve_counts().get("serve_batches", 0) - b_alone
    err = max(float(np.max(np.abs(g - w))) for g, w in zip(got, want))
    if not err <= SP_ROW_ATOL:
        raise AssertionError(f"router responses vs infer alone: {err}")
    # the same requests through a two-replica door, replica 1 killed
    named = {iex.var_names[n]: iex.params[iex._k(n)] for n in iex.var_nodes}
    routers = {}

    def mk(idx):
        routers[idx] = ht.ServingRouter(
            ht.InferenceExecutor([logits], weights=named,
                                 buckets=(cfg.batch_size,), device=device,
                                 validate="off"),
            max_batch=cfg.batch_size, max_wait_ms=SP_BERT_WAIT_MS,
            queue_limit=len(reqs), name=f"b{idx}")
        return routers[idx]

    metrics.reset_fleet_counts()
    door = ht.FrontDoor(mk, 2, wedge_timeout_ms=60000.0)
    try:
        futs = []
        for i in range(SP_FLEET_REQS):
            futs.append((i, door.submit(reqs[i])))
            if i == SP_FLEET_REQS // 2:
                routers[1].kill()
        deadline = time.monotonic() + 300
        door.poll()                      # the killed replica is ejected
        while not all(f.done() for _, f in futs):
            if time.monotonic() > deadline:
                raise AssertionError("fleet requests not answered")
            door.poll()
            time.sleep(0.002)
        ferr = max(float(np.max(np.abs(f.result()[0] - want[i])))
                   for i, f in futs)
    finally:
        door.close()
    fleet = metrics.fleet_counts()
    if fleet.get("fleet_request_failures", 0) or not ferr <= SP_ROW_ATOL \
            or fleet.get("fleet_replica_ejected", 0) != 1:
        raise AssertionError(f"two-replica BERT door: {fleet}, err {ferr}")
    ms = np.asarray(lat)
    served = metrics.serve_counts().get("serve_batches", 0)
    report = {"batch_bucket": cfg.batch_size, "seq": cfg.seq_len,
              "requests": len(reqs), "threads": SP_BERT_THREADS,
              "save_s": save_s, "batches": batches,
              "max_abs_err_vs_alone": err, "p50_ms": float(np.median(ms)),
              "p99_ms": float(np.percentile(ms, 99)),
              "requests_per_s": len(reqs) / wall,
              "serve": metrics.serve_counts(),
              "fleet_admitted": fleet.get("fleet_admitted", 0),
              "fleet_rescued": fleet.get("fleet_rescued", 0),
              "fleet_max_abs_err": ferr, "calls_alone": b_alone,
              "router_batches": batches, "all_calls": served}
    return report, served


def phase_serving_planes(ht, fa, metrics, kmods):
    """Phase 45: the prefix store, stream recovery behind the front door,
    and BERT-base behind the request router, at full width on the card.
    Returns (launches by kernels-line name, merge launches)."""
    t_phase = time.perf_counter()
    cfg = ht.GPT2Config.small()
    graphs = (ht.gpt2_decode_graph(cfg, max_len=SP_MAX_LEN),
              ht.gpt2_decode_chunked_graph(cfg, max_len=SP_MAX_LEN,
                                           chunk=PREFILL_CHUNK))
    cold_eng = sp_engine(ht, graphs, None, "cuda")
    weights = {cold_eng.iex.var_names[n]: cold_eng.iex.params[
        cold_eng.iex._k(n)] for n in cold_eng.iex.var_nodes}
    prompts, prime = sp_prompts(cfg)
    launches = {"flash_fwd_lengths": 0, "flash_fwd_mask": 0, "flash_fwd": 0}
    merges = 0

    def count(tag, need):
        nonlocal merges
        got = {"flash_fwd_lengths": fa.launches,
               "flash_fwd_mask": fa.fwd_mask_launches,
               "flash_fwd": fa.fwd_launches}
        others = {name: n for m in kmods for name, n in vars(m).items()
                  if name.endswith("launches") and n and not (
                      m is fa and name in ("launches", "merge_launches",
                                           "fwd_mask_launches",
                                           "fwd_launches"))}
        left = {r: n for r, n in metrics.flash_fallback_counts().items()
                if r.startswith("backend:")}
        if any(got[k] <= 0 for k in need) or others or left:
            raise AssertionError(f"[{tag}] launches {got}, others {others}, "
                                 f"fallbacks {left}")
        for k in launches:
            launches[k] += got[k]
        merges += fa.merge_launches
        return dict(got, merges=fa.merge_launches)

    # (a) prefix reuse: the store-less engine, then the store engine
    def start():
        reset_launches(*kmods)
        calls.reset()

    with DecodeCalls(fa) as calls:
        cold, crep = sp_serve(ht, metrics, cold_eng, prompts,
                              on_start=start)
        calls.check(fa, "phase 45a, no store")
        crep["launches"] = count("prefix-cold", ("flash_fwd_lengths",
                                                 "flash_fwd_mask"))
        warm_eng = sp_engine(ht, graphs, weights, "cuda",
                             ht.PrefixKVStore(capacity_bytes=SP_STORE_BYTES))
        warm, wrep = sp_serve(ht, metrics, warm_eng, prompts, prime,
                              on_start=start)
        calls.check(fa, "phase 45a")
        wrep["launches"] = count("prefix-warm", ("flash_fwd_lengths",
                                                 "flash_fwd_mask"))
    if wrep["prefix_cache_hits"] != SP_REQUESTS \
            or wrep["prefix_cache_hit_rows"] < SP_REQUESTS * SP_PREAMBLE:
        raise AssertionError(f"prefix store: {wrep}")
    if not wrep["decode_prefill_rows"] < crep["decode_prefill_rows"]:
        raise AssertionError(f"the hits skipped no prefill: {wrep} {crep}")
    same = sp_agree("prefix", warm, cold, prompts, cold_eng)
    card = card_line()
    for tag, rep in (("cold (no store)", crep), ("warm (store)", wrep)):
        log(f"[serving-planes] (a) GPT-2 small {tag}: {json.dumps(rep)} "
            f"[{card}]")
    log(f"[serving-planes] (a) TTFT p50 cold {crep['ttft_p50_ms']:.3f} ms / "
        f"warm {wrep['ttft_p50_ms']:.3f} ms; prefill steps saved "
        f"{crep['decode_prefill_steps_saved']} / "
        f"{wrep['decode_prefill_steps_saved']}; streams equal {same}/"
        f"{len(cold)} [{card}]")
    del warm_eng
    _free_cuda()

    # (b) recovery behind the front door
    rec, rrep = sp_recovery(ht, metrics, graphs, weights, "cuda", prompts,
                            on_start=lambda: reset_launches(*kmods))
    rrep["launches"] = count("recovery", ("flash_fwd_lengths",
                                          "flash_fwd_mask"))
    r = rrep["decode_recovery"]
    if r.get("decode_recovery_reseated", 0) < 1 \
            or r.get("decode_recovery_exhausted", 0) \
            or rrep["fleet"].get("fleet_request_failures", 0):
        raise AssertionError(f"recovery: {rrep}")
    same = sp_agree("recovery", rec, cold, prompts, cold_eng)
    log(f"[serving-planes] (b) two replicas, replica 1 killed: "
        f"{json.dumps(rrep)}; streams equal to the unkilled run {same}/"
        f"{len(rec)} [{card}]")
    del cold_eng
    _free_cuda()

    # (c) BERT-base behind the request router
    reset_launches(*kmods)
    with tempfile.TemporaryDirectory() as tmp:
        metrics.reset_flash_fallbacks()
        brep, calls_made = sp_bert(ht, metrics, "cuda", tmp)
    got = fa.fwd_launches
    brep["launches"] = count("bert", ("flash_fwd",))
    if got != 12 * calls_made:
        raise AssertionError(f"key-mask launches {got} != 12 layers x "
                             f"{calls_made} serving calls")
    log(f"[serving-planes] (c) BERT-base classify: {json.dumps(brep)} "
        f"[{card}]")
    _free_cuda()
    log(f"[serving-planes] launches {json.dumps(launches)} merges {merges}; "
        f"phase 45 in {time.perf_counter() - t_phase:.1f} s [{card}]")
    return launches, merges


# -- 46. the replicated parameter server and CTR serving --------------------------

#: (a) / (b): WDL turns of each dtype, profiled steps a run, DeepFM and DCN
#: steps, and the card-vs-CPU batch
CS_TURNS, CS_PROFILED, CS_MODEL_STEPS, CS_PARITY_BATCH = 2, 2, 5, 2
#: test_torch_bf16.py's budget of a bf16 run against its float32 twin
CS_BF16_PARITY = dict(rtol=5e-2, atol=5e-2)
#: (c): bench.py's failover schedule at WDL's width: three ranks, 10
#: steps, shard 1's primary killed after step FO_KILL (its 4th step
#: absorbs the failover), the promoted ex-backup killed three steps before
#: the end; the store's RPC settings; the tables (the uninterrupted run's,
#: the killed run's)
FO_WORLD, FO_STEPS, FO_KILL, FO_TABLES = 3, 10, 3, 2
FO_RPC = dict(rpc_timeout=5.0, rpc_retries=2, connect_timeout=2.0)
FO_HB_DEADLINE_MS = 1500.0
# phase 47: the hybrid deployment through the launcher
HY_STEPS = 8
HY_RTOL = 2e-5              # tests/test_launcher.py's hybrid case
HY_DIGEST_ATOL = 2e-4       # that case's table digest bar
HY_DEADLINE = 300
HY_CHAOS = "7:dup=0.05,drop=0.02,kill:primary@shard1:step4"
#: (b)'s batch over three ranks: phase 9's 2048 cut to a multiple of 3
HY_B_BATCH = 2046
HY_RPC = ("--rpc-timeout", "5")
#: (d): the serving bucket, the requests of the killed wave, the checked
#: wave and each cell's wave, client threads, the router's refresh period
CS_BUCKET, CS_SERVE_REQS, CS_CHECK_REQS, CS_CELL_REQS = 64, 512, 64, 64
CS_CLIENTS, CS_REFRESH_EVERY, CS_WAIT_MS = 4, 4, 2.0


def ps_replica(rank, ports, conn, vocab, dim, standby):
    """Phase 46's shard process: rank ``rank`` of the three-rank replicated
    store with ``FO_TABLES`` tables; a ``standby`` (a relaunched
    replacement) waits for a word before it binds the dead rank's port,
    and creates no table (re-replication brings them).  Serves until told
    to stop, or killed."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from hetu_tpu_torch.ps.dist_store import DistributedStore
    if standby:
        conn.send(("waiting", None))
        conn.recv()
    store = DistributedStore(rank, FO_WORLD,
                             [("127.0.0.1", p) for p in ports],
                             port=ports[rank], replication=2,
                             standby=standby, **FO_RPC)
    if not standby:
        for _ in range(FO_TABLES):
            store.init_table(vocab, dim, opt="sgd", lr=0.01, seed=0,
                             init_scale=0.01)
    conn.send(("ready", store.local.native))
    conn.recv()
    store.close()
    conn.send(("closed", None))


class _Replicas:
    """The phase's shard processes: ranks 1 and 2, and a standby for each,
    all spawned at once at the phase's start."""

    def __init__(self, ports):
        ctx = multiprocessing.get_context("spawn")
        self.procs = {}
        for key, rank, standby in (("r1", 1, False), ("r2", 2, False),
                                   ("s1", 1, True), ("s2", 2, True)):
            conn, child = ctx.Pipe()
            p = ctx.Process(target=ps_replica, args=(
                rank, ports, child, CTR_VOCAB, CTR_DIM, standby),
                daemon=True)
            p.start()
            self.procs[key] = (p, conn)

    def wait(self, key, status):
        p, conn = self.procs[key]
        if not conn.poll(PS_TIMEOUT):
            raise AssertionError(f"phase 46: shard process {key} did not "
                                 f"reach {status}")
        got, native = conn.recv()
        if got != status:
            raise AssertionError(f"phase 46: {key} said {got}")
        return native

    def go(self, key):
        """Bind a standby (it took the dead rank's port)."""
        self.wait(key, "waiting")
        self.procs[key][1].send("go")
        return self.wait(key, "ready")

    def kill(self, key):
        import signal
        p, _ = self.procs[key]
        os.kill(p.pid, signal.SIGKILL)
        p.join(30)

    def close(self):
        for p, conn in self.procs.values():
            if p.is_alive():
                try:
                    conn.send("stop")
                    if conn.poll(PS_TIMEOUT):
                        conn.recv()
                except (OSError, EOFError):
                    pass
            p.join(30)
            if p.is_alive():
                p.terminate()
                p.join(10)


def _launched(emb, seg):
    return {"emb_gather": emb.launches, "sorted_segment_sum": seg.launches}


def _add(total, got):
    for k, v in got.items():
        total[k] = total.get(k, 0) + v


def cs_capture(emb):
    """Record the last B4 call of the device-cache path and the last B5
    call of the executor's step (their tensors), calling through: the
    launches count as before."""
    from hetu_tpu_torch.graph import executor as exmod
    got, orig = {}, (emb.emb_gather, exmod.emb_scatter_add)

    def gather(slab, slots):
        got["gather"] = (slab, slots)
        return orig[0](slab, slots)

    def scatter(grad, inv):
        got["scatter"] = (grad, inv)
        return orig[1](grad, inv)

    emb.emb_gather, exmod.emb_scatter_add = gather, scatter

    def restore():
        emb.emb_gather, exmod.emb_scatter_add = orig
    return got, restore


def cs_kernels_at(emb, seg, got, tag):
    """B4 and B5 held to their plain versions and timed at the shapes of
    one captured step (``cs_capture``): the gather exact, the segment
    sum within SEG_RTOL / SEG_ATOL.  Returns their kernels-line shape
    rows."""
    slab, slots = got["gather"]
    flush_buf = torch.empty(DECODE_FLUSH, dtype=torch.float32,
                            device=slab.device)
    flush = flush_buf.zero_
    slots = slots.to(torch.int32)
    out = emb.gather_rows(slab, slots)
    if not torch.equal(out, emb.gather_rows_plain(slab, slots)):
        raise AssertionError(f"phase 46 ({tag}): B4 vs plain not equal")
    n, w = slots.shape[0], slab.shape[1]
    slots64 = slots.long()
    grow = {"name": tag, "shape": [int(n), int(w)], "max_abs_err": 0.0,
            "ms": time_ms(lambda: emb.gather_rows(slab, slots), flush=flush),
            "plain_ms": time_ms(lambda: emb.gather_rows_plain(slab, slots),
                                flush=flush),
            "library_ms": time_ms(lambda: torch.index_select(
                slab, 0, slots64), flush=flush)}
    distinct = int(torch.unique(slots).numel())
    grow["bound_ms"], grow["bound_by"] = bytes_bound(
        4 * n + 4 * distinct * w + 4 * n * w)
    g, inv = got["scatter"]
    if g.dtype != torch.float32:
        raise AssertionError(f"phase 46 ({tag}): the row gradient reached "
                             f"B5 as {g.dtype}, not float32")
    g = g.reshape(-1, g.shape[-1])
    inv = inv.to(torch.int32)
    got_sum = emb.scatter_add_grads(g, inv)
    order = torch.sort(inv, stable=True)
    rows_sorted = g.index_select(0, order.indices)
    seg_ids = order.values
    plain = seg.sorted_segment_sum_plain(rows_sorted, seg_ids, g.shape[0])
    err = float((got_sum - plain).abs().max()) if g.numel() else 0.0
    if not torch.allclose(got_sum, plain, rtol=SEG_RTOL, atol=SEG_ATOL):
        raise AssertionError(f"phase 46 ({tag}): B5 vs plain max err {err}")
    m = g.shape[0]
    seg64 = seg_ids.long()
    zeros = torch.zeros(m, g.shape[1], device=g.device)
    u = int(seg_ids[-1]) + 1 if m else 0
    srow = {"name": tag, "shape": [int(m), int(g.shape[1])],
            "max_abs_err": err,
            "ms": time_ms(lambda: seg.sorted_segment_sum(rows_sorted,
                                                         seg_ids, m),
                          flush=flush),
            "plain_ms": time_ms(lambda: seg.sorted_segment_sum_plain(
                rows_sorted, seg_ids, m), flush=flush),
            "library_ms": time_ms(lambda: zeros.index_add_(
                0, seg64, rows_sorted), flush=flush)}
    srow["bound_ms"], srow["bound_by"] = bytes_bound(
        4 * m * g.shape[1] + 4 * m + 4 * m * g.shape[1],
        adds=float((m - u) * g.shape[1]))
    return {"emb_gather": grow, "sorted_segment_sum": srow}


def cs_precision(ht, emb, seg, metrics, kmods, pm, device):
    """(a) Wide & Deep through ``vlru_dev`` over a local store, float32 and
    bf16 in turns from one table and one set of weights; the bf16 step's
    B4 / B5 shapes held to plain.  Returns (report, launches, shape
    rows)."""
    batches = ctr_batches(ht)
    steps = len(batches)
    local = ht.EmbeddingStore()
    tids = [local.init_table(CTR_VOCAB, CTR_DIM, opt="sgd", lr=0.01, seed=0,
                             init_scale=0.01) for _ in range(2 * CS_TURNS)]
    table0 = local.get_data(tids[0])
    _, ex0, _ = ps_wdl(ht, local, tids[0], "vlru_dev", None, device)
    weights = ex0.return_tensor_values()
    ex0.close()
    launches, runs, rows = {}, {"float32": [], "bfloat16": []}, None
    for turn in range(CS_TURNS):
        for i, cd in enumerate(("float32", "bfloat16")):
            last = cd == "bfloat16" and turn == CS_TURNS - 1
            got, restore = cs_capture(emb) if last else ({}, None)
            reset_launches(*kmods)
            try:
                r = ps_run(ht, metrics, pm, local, tids[2 * turn + i],
                           "vlru_dev", weights, batches, table0, device,
                           profiled=CS_PROFILED,
                           compute_dtype=None if cd == "float32" else cd)
            finally:
                if restore is not None:
                    restore()
            n = _launched(emb, seg)
            if any(v != steps for v in n.values()):
                raise AssertionError(f"phase 46 (a) {cd}: B4 / B5 launches "
                                     f"{n} != {steps}")
            _add(launches, n)
            r["ex"].close()
            runs[cd].append(r)
            if last:
                rows = cs_kernels_at(emb, seg, got, "wdl_bf16_rows")
    f32, bf = runs["float32"][0]["losses"], runs["bfloat16"][0]["losses"]
    if not np.allclose(bf, f32, **CS_BF16_PARITY):
        raise AssertionError(f"phase 46 (a): bf16 losses {bf} vs float32 "
                             f"{f32}")
    report = {"losses": {"float32": f32, "bfloat16": bf},
              "bf16_max_abs_loss_gap": float(np.max(np.abs(
                  np.subtract(bf, f32)))),
              "turns_equal": {cd: all(r["losses"] == rs[0]["losses"]
                                      for r in rs)
                              for cd, rs in runs.items()},
              "launches_per_step": {k: v / (2 * CS_TURNS * steps)
                                    for k, v in launches.items()}}
    for cd, rs in runs.items():
        ms = np.concatenate([r["ms"] for r in rs])
        p50 = float(np.percentile(ms, 50))
        busy = float(np.mean([r["busy_ms"] for r in rs]))
        report[cd] = {"step_ms_p50": p50, "busy_ms": busy,
                      "idle_share": 1.0 - busy / p50}
    report["bf16_rows"] = rows
    return report, launches, rows


def cs_model_executor(ht, model, device, batch):
    """``model`` ('deepfm' | 'dcn') at WDL's configuration and ``batch``
    through ``vlru_dev``: (feeds, executor, cache)."""
    dense = ht.placeholder_op("dense")
    sparse = ht.placeholder_op("sparse", dtype=np.int64)
    y_ = ht.placeholder_op("y")
    loss, _ = getattr(ht, f"{model}_criteo")(
        dense, sparse, y_, batch, vocab=CTR_VOCAB, dim=CTR_DIM,
        embed_mode="vlru_dev", lr=0.01, slab_device=device)
    ex = ht.Executor({"train": [loss, ht.optim.SGDOptimizer(0.01)
                                .minimize(loss)]}, seed=0, device=device)
    return (dense, sparse, y_), ex, ex.subexecutors["train"].ps_nodes[0].cache


def cs_models(ht, emb, seg, metrics, kmods, pm, device):
    """(b) DeepFM and DCN through ``vlru_dev`` in float32: a few steps at
    full width (p50, idle share), then card against CPU at batch
    ``CS_PARITY_BATCH`` from one table and one set of weights."""
    batches = ctr_batches(ht)
    report, launches = {}, {}
    for model in ("deepfm", "dcn"):
        feeds, ex, cache = cs_model_executor(ht, model, device, CTR_BATCH)
        weights = ex.return_tensor_values()
        table = cache.store.get_data(cache.table)
        reset_launches(*kmods)
        losses, ms = [], []
        for i in range(CS_MODEL_STEPS - CS_PROFILED):
            t0 = time.perf_counter()
            losses.append(float(ex.run("train", feed_dict=dict(
                zip(feeds, batches[i])))[0].asnumpy()))
            if i:
                ms.append((time.perf_counter() - t0) * 1e3)
        it = iter(batches[CS_MODEL_STEPS - CS_PROFILED:CS_MODEL_STEPS])

        def step():
            losses.append(float(ex.run("train", feed_dict=dict(
                zip(feeds, next(it))))[0].asnumpy()))
        busy = _device_busy(pm, lambda: [step() for _ in
                                         range(CS_PROFILED)],
                            CS_PROFILED)[0]
        n = _launched(emb, seg)
        if any(v != CS_MODEL_STEPS for v in n.values()) \
                or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"phase 46 (b) {model}: launches {n}, "
                                 f"losses {losses}")
        _add(launches, n)
        ex.close()
        par = []
        for dev in (device, "cpu"):
            f, e, c = cs_model_executor(ht, model, dev, CS_PARITY_BATCH)
            e.load_dict(weights)
            c.store.set_data(c.table, table)
            ls = [float(e.run("train", feed_dict=dict(zip(feeds_, (
                b[0][:CS_PARITY_BATCH], b[1][:CS_PARITY_BATCH],
                b[2][:CS_PARITY_BATCH]))))[0].asnumpy())
                for feeds_, b in ((f, batches[0]), (f, batches[1]))]
            c.flush()
            par.append((ls, c.store.get_data(c.table)))
            e.close()
        reset_launches(*kmods)      # the parity steps are not the path's
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(par[0][0],
                                                           par[1][0]))
        tab_err = float(np.max(np.abs(par[0][1] - par[1][1])))
        if not loss_err <= CTR_LOSS_RTOL or not np.allclose(
                par[0][1], par[1][1], rtol=CTR_TABLE_RTOL,
                atol=CTR_TABLE_ATOL):
            raise AssertionError(f"phase 46 (b) {model}: card vs CPU loss "
                                 f"{loss_err}, table {tab_err}")
        p50 = float(np.percentile(ms, 50))
        report[model] = {"losses": losses, "step_ms_p50": p50,
                         "busy_ms": busy, "idle_share": 1.0 - busy / p50,
                         "card_vs_cpu_loss_rel_err": loss_err,
                         "card_vs_cpu_table_max_abs_err": tab_err}
    return report, launches


def cs_failover(ht, emb, seg, metrics, kmods, device, reps, ports, dstore,
                tids, weights, table0, ps_p50):
    """(c) bench.py's failover schedule on WDL over the replicated store
    (see the module docstring); ``ps_p50``: phase 43's unreplicated
    two-shard step p50, reported beside this one's.  Returns (report,
    launches, the trained executor's weights)."""
    from hetu_tpu_torch.tools import ps_fsck
    batches = ctr_batches(ht)
    ends = [("127.0.0.1", p) for p in ports]

    def run(tid, chaos):
        dstore.set_data(tid, table0)
        feeds, ex, cache = ps_wdl(ht, dstore, tid, "vlru_dev", weights,
                                  device)
        losses, ms, failed_over, checks = [], [], [], {}
        for step in range(FO_STEPS):
            before = metrics.fault_counts().get("ps_failover_promoted", 0)
            t0 = time.perf_counter()
            losses.append(float(ex.run("train", feed_dict=dict(zip(
                feeds, batches[step % len(batches)])))[0].asnumpy()))
            ms.append((time.perf_counter() - t0) * 1e3)
            if metrics.fault_counts().get("ps_failover_promoted",
                                          0) > before:
                failed_over.append(step)
            if not chaos:
                continue
            if step == FO_KILL - 1:
                reps.kill("r1")               # shard 1's primary
            elif step == FO_KILL:
                # ops relaunch a standby at the dead rank's endpoint; the
                # executor's re-replication tick attaches it
                reps.go("s1")
            elif step == FO_STEPS - 5:
                # the whole cluster is up again: redundancy restored
                checks["fsck_before_second_kill"] = ps_fsck.fsck(
                    ends, FO_TABLES, replication=2)
            elif step == FO_STEPS - 4:
                reps.kill("r2")               # the promoted ex-backup
        n = _launched(emb, seg)
        rows = {"losses": losses, "ms": ms, "failover_steps": failed_over,
                "launches": n, **checks}
        return rows, ex, cache

    os.environ.pop("HETU_PS_REREPLICATE_EVERY", None)
    reset_launches(*kmods)
    base, ex, _ = run(tids[0], False)
    ex.close()
    metrics.reset_faults()
    os.environ["HETU_PS_REREPLICATE_EVERY"] = "1"
    reset_launches(*kmods)
    try:
        killed, ex, cache = run(tids[1], True)
    finally:
        os.environ.pop("HETU_PS_REREPLICATE_EVERY", None)
    faults = dict(metrics.fault_counts())
    trained = ex.return_tensor_values()
    cache.flush()
    ex.close()
    launches = {}
    for r in (base, killed):
        if any(v != FO_STEPS for v in r["launches"].values()):
            raise AssertionError(f"phase 46 (c): B4 / B5 launches "
                                 f"{r['launches']} != {FO_STEPS}")
        _add(launches, r["launches"])
    if killed["losses"] != base["losses"]:
        raise AssertionError(f"phase 46 (c): losses through the kills "
                             f"{killed['losses']} != uninterrupted "
                             f"{base['losses']}")
    if killed["failover_steps"] != [FO_KILL, FO_STEPS - 3] \
            or base["failover_steps"] or not faults.get(
                "ps_failover_promoted"):
        raise AssertionError(f"phase 46 (c): failover steps "
                             f"{killed['failover_steps']} (uninterrupted "
                             f"{base['failover_steps']}), faults {faults}")
    pre = killed["fsck_before_second_kill"]
    if not pre["ok"]:
        raise AssertionError(f"phase 46 (c): fsck before the second kill: "
                             f"{pre}")
    # the second standby takes rank 2's place; the repair tick's work done
    # by hand, then fsck --verify on the whole live cluster
    reps.go("s2")
    repaired = dstore.maybe_re_replicate()
    code = ps_fsck.main(["--endpoints", ",".join(f"{h}:{p}" for h, p in ends),
                         "--tables", str(FO_TABLES), "--verify"])
    post = ps_fsck.fsck(ends, FO_TABLES, replication=2)
    if code != 0 or not post["ok"] or not repaired:
        raise AssertionError(f"phase 46 (c): fsck --verify after the "
                             f"relaunch exit {code}: {post}")
    ms = np.asarray(base["ms"][1:])
    p50 = float(np.percentile(ms, 50))
    bound_ms = FO_RPC["rpc_timeout"] * 1e3 + FO_HB_DEADLINE_MS
    report = {
        "losses": base["losses"], "loss_parity": "bit-equal",
        "failover_steps": killed["failover_steps"],
        "failover_step_ms": [killed["ms"][s]
                             for s in killed["failover_steps"]],
        "recovery_bound_ms": bound_ms,
        "replicated_step_ms_p50": p50,
        "unreplicated_two_shard_step_ms_p50_phase43": ps_p50,
        "killed_run_step_ms": killed["ms"],
        "fault_counters": faults,
        "fsck_before_second_kill": {k: pre[k] for k in (
            "ok", "serving_ranks", "retries_used")},
        "fsck_after_relaunch": {k: post[k] for k in (
            "ok", "serving_ranks", "retries_used")},
        "serving_epochs": {s: [v["epoch"] for v in e.values()]
                           for s, e in post["epochs"].items()}}
    return report, launches, trained


def cs_serving(ht, metrics, device, reps, dstore, tid, trained):
    """(d) The trained weights behind ``ServingRouter(refresh_every_batches
    =CS_REFRESH_EVERY)`` over a read-only ``DistCacheTable`` on the
    replicated store, a writer pushing meanwhile; a primary killed
    mid-serving; a checked wave against a direct forward on freshly
    pulled rows; two cells each serving its own wave."""
    import threading
    d, s, _ = ht.synthetic_criteo_skewed(
        CS_SERVE_REQS + CS_CHECK_REQS + 2 * CS_CELL_REQS, vocab=CTR_VOCAB,
        seed=46)

    def serving(cache):
        dense = ht.placeholder_op("dense")
        sparse = ht.placeholder_op("sparse", dtype=np.int64)
        y_ = ht.placeholder_op("y")
        emb_n = ht.ps_embedding_lookup_op(cache, sparse, width=CTR_DIM)
        _, prob = ht.models.ctr._wdl_head(emb_n, dense, y_, CS_BUCKET,
                                          CTR_DIM)
        iex = ht.InferenceExecutor([prob], weights=trained,
                                   buckets=(CS_BUCKET,), device=device,
                                   strict=True)
        return dense, sparse, iex

    def reqs(dense, sparse, lo, n):
        return [{dense: d[i], sparse: s[i]} for i in range(lo, lo + n)]

    cache = ht.DistCacheTable(dstore, tid, limit=max(CTR_VOCAB // 10, 256),
                              policy="lru", read_only=True)
    dense, sparse, iex = serving(cache)
    metrics.reset_serve_counts()
    metrics.reset_faults()
    router = ht.ServingRouter(iex, max_batch=CS_BUCKET,
                              max_wait_ms=CS_WAIT_MS,
                              queue_limit=CS_SERVE_REQS,
                              refresh_every_batches=CS_REFRESH_EVERY)
    stop = threading.Event()
    pushes = [0]

    def writer():
        rng = np.random.RandomState(47)
        while not stop.is_set():
            keys = rng.randint(0, CTR_VOCAB, 256)
            dstore.push(tid, keys, (rng.randn(256, CTR_DIM) * 1e-3)
                        .astype(np.float32))
            pushes[0] += 1
            time.sleep(0.002)

    wave = reqs(dense, sparse, 0, CS_SERVE_REQS)
    # the bucket's scatter plan (shape inference at two batch sizes) is
    # made at the first call: timed apart, before the wave
    t = time.perf_counter()
    iex.infer({k: v[None] for k, v in wave[0].items()})
    first_call_s = time.perf_counter() - t
    got, lat = [None] * len(wave), [None] * len(wave)
    killed = threading.Event()

    def client(k):
        for i in range(k, len(wave), CS_CLIENTS):
            if i >= len(wave) // 2 and not killed.is_set() and k == 0:
                killed.set()
                reps.kill("s1")       # shard 1's primary, mid-serving
            t = time.perf_counter()
            got[i] = router.submit(wave[i]).result(timeout=300)[0]
            lat[i] = (time.perf_counter() - t) * 1e3

    wt = threading.Thread(target=writer, daemon=True)
    wt.start()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,))
               for k in range(CS_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    stop.set()
    wt.join(timeout=60)
    answered = sum(g is not None for g in got)
    served = metrics.serve_counts()
    faults = dict(metrics.fault_counts())
    if answered != len(wave) or not all(np.all(np.isfinite(g)) for g in got):
        raise AssertionError(f"phase 46 (d): {answered} of {len(wave)} "
                             f"requests answered")
    if not faults.get("ps_failover_promoted") \
            or not served.get("serve_failovers"):
        raise AssertionError(f"phase 46 (d): the kill was not absorbed by "
                             f"a failover: {faults} {served}")
    # the writer has stopped: after a sweep every cached row is the
    # store's, and a wave must equal a direct forward on pulled rows
    refreshed = iex.refresh_embeddings()
    cache.refresh_join(timeout=60)
    check = reqs(dense, sparse, CS_SERVE_REQS, CS_CHECK_REQS)
    futs = [router.submit(r) for r in check]
    served_rows = np.stack([f.result(timeout=300)[0] for f in futs])
    router.close()
    rows_ph = ht.placeholder_op("rows")
    dn, yy = ht.placeholder_op("dense"), ht.placeholder_op("y")
    _, direct_prob = ht.models.ctr._wdl_head(rows_ph, dn, yy, CS_BUCKET,
                                             CTR_DIM)
    direct = ht.InferenceExecutor([direct_prob], weights=trained,
                                  buckets=(CS_BUCKET,), device=device,
                                  strict=True)
    ids = np.stack([r[sparse] for r in check])
    want = direct.infer({rows_ph: dstore.pull(tid, ids),
                         dn: np.stack([r[dense] for r in check])})[0]
    err = float(np.max(np.abs(served_rows - want)))
    if not err <= SP_ROW_ATOL:
        raise AssertionError(f"phase 46 (d): served vs a direct forward on "
                             f"pulled rows: max err {err}")
    # two cells, each its own cache, router and wave
    cm = ht.CellMap({"west": [0], "east": {"ranks": [1, 2],
                                           "replicas": 1}})
    cells, lo = {}, CS_SERVE_REQS + CS_CHECK_REQS
    for name in ("west", "east"):
        c = ht.DistCacheTable(dstore, tid, limit=max(CTR_VOCAB // 10, 256),
                              policy="lru", read_only=True)
        dn_, sp_, iex_ = serving(c)
        head = ht.CellHead(name, dstore, ht.ServingRouter(
            iex_, max_batch=CS_BUCKET, max_wait_ms=CS_WAIT_MS,
            queue_limit=CS_CELL_REQS), c)
        wave_reqs = reqs(dn_, sp_, lo, CS_CELL_REQS)
        lo += CS_CELL_REQS
        head.warm(np.stack([r[sp_] for r in wave_reqs]))
        t = time.perf_counter()
        resp, stats = head.serve_wave(wave_reqs, timeout=300)
        wave_s = time.perf_counter() - t
        up = head.catch_up()
        head.close()
        if stats["answered"] != CS_CELL_REQS or stats["rejections"]:
            raise AssertionError(f"phase 46 (d) cell {name}: {stats}")
        cells[name] = {"ranks": cm.ranks(name), "wave": stats,
                       "wave_s": wave_s, "catch_up": up}
    ms = np.asarray(lat)
    return {"requests": len(wave), "bucket": CS_BUCKET,
            "clients": CS_CLIENTS, "writer_pushes": pushes[0],
            "first_call_s": first_call_s,
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "requests_per_s": len(wave) / wall,
            "refreshed_rows_router": served.get("serve_emb_refresh_rows", 0),
            "refreshed_rows_final_sweep": refreshed,
            "serve_failovers": served.get("serve_failovers", 0),
            "checked_wave_max_abs_err": err, "cells": cells,
            "cache": cache.perf()}


def phase_ctr_serving(ht, emb, seg, metrics, kmods, pm, ps_p50=None,
                      device="cuda"):
    """Phase 46 (see the module docstring); ``ps_p50``: phase 43's
    two-shard step p50.  Returns (B4 / B5 launches by kernels-line name,
    the bf16 step's shape rows of B4 and B5)."""
    t_phase = time.perf_counter()
    report = {"card": card_line()}
    from hetu_tpu_torch.ps.dist_store import DistributedStore
    ports = _free_ports(FO_WORLD)
    # rank 0's server binds first (rank 2's replica tables land on it);
    # the shard processes start now and (a) and (b) run meanwhile
    dstore = DistributedStore(0, FO_WORLD, [("127.0.0.1", p) for p in ports],
                              port=ports[0], replication=2, **FO_RPC)
    reps = _Replicas(ports)
    launches = {}
    try:
        report["a_precision"], n, rows = cs_precision(
            ht, emb, seg, metrics, kmods, pm, device)
        _add(launches, n)
        log(f"[ctr-serve] (a) {json.dumps(report['a_precision'])}")
        report["b_models"], n = cs_models(ht, emb, seg, metrics, kmods, pm,
                                          device)
        _add(launches, n)
        log(f"[ctr-serve] (b) {json.dumps(report['b_models'])}")
        tids = [dstore.init_table(CTR_VOCAB, CTR_DIM, opt="sgd", lr=0.01,
                                  seed=0, init_scale=0.01)
                for _ in range(FO_TABLES)]
        natives = [reps.wait(k, "ready") for k in ("r1", "r2")]
        if not (all(natives) and dstore.local.native):
            raise AssertionError("phase 46: the stores' native library is "
                                 "not loaded")
        local = ht.EmbeddingStore()
        lt = local.init_table(CTR_VOCAB, CTR_DIM, opt="sgd", lr=0.01,
                              seed=0, init_scale=0.01)
        _, ex0, _ = ps_wdl(ht, local, lt, "vlru_dev", None, device)
        weights = ex0.return_tensor_values()
        ex0.close()
        report["c_failover"], n, trained = cs_failover(
            ht, emb, seg, metrics, kmods, device, reps, ports, dstore, tids,
            weights, local.get_data(lt), ps_p50)
        _add(launches, n)
        log(f"[ctr-serve] (c) {json.dumps(report['c_failover'])}")
        report["d_serving"] = cs_serving(ht, metrics, device, reps, dstore,
                                         tids[1], trained)
        log(f"[ctr-serve] (d) {json.dumps(report['d_serving'])}")
    finally:
        dstore.close()
        reps.close()
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"[ctr-serve] launches {json.dumps(launches)} card {report['card']} "
        f"phase 46 in {report['phase_s']:.1f} s")
    return launches, rows


# -- phase 47: the hybrid deployment through the launcher ----------------------

def hy_launch(n, args, env=None):
    """``n`` ranks of ``tools/hybrid_wdl.py`` started by the launcher
    (``launcher.launch``, local processes) with ``env`` added to their
    environment; every rank killed past ``HY_DEADLINE``.  Returns each
    rank's JSON."""
    from hetu_tpu_torch import launcher
    from hetu_tpu_torch.context import DistConfig
    root = os.path.dirname(os.path.abspath(__file__))
    tool = os.path.join(root, "hetu_tpu_torch", "tools", "hybrid_wdl.py")
    out = args[args.index("--out") + 1]
    ports = _free_ports(n + 1)
    saved = dict(os.environ)
    os.environ.update(env or {})
    try:
        procs = launcher.launch(
            DistConfig(num_hosts=n, hosts=["localhost"] * n), tool,
            ["--ports", ",".join(map(str, ports[:n]))] + list(args),
            ssh=False, coordinator_port=ports[n])
    finally:
        os.environ.clear()
        os.environ.update(saved)
    t0, codes = time.monotonic(), None
    try:
        while time.monotonic() - t0 < HY_DEADLINE:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes) \
                    or all(c == 0 for c in codes):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if [p.returncode for p in procs] != [0] * n:
        raise AssertionError(f"phase 47: the ranks exited {codes} (None: "
                             f"past the {HY_DEADLINE} s deadline)")
    ranks = []
    for r in range(n):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def hy_reference(ht, hybrid_wdl, mode, weights, device):
    """The one-process run on the card over a local ``EmbeddingStore``:
    (losses, final table, the dense weights: ``weights``, else the run's
    initial ones)."""
    a = types.SimpleNamespace(batch=CTR_BATCH, vocab=CTR_VOCAB, dim=CTR_DIM,
                              device=device)
    store = ht.EmbeddingStore()
    run = hybrid_wdl.Run(store, mode, "sgd", a, None)
    store.set_data(run.node.table, hybrid_wdl.table0(CTR_VOCAB, CTR_DIM, 1))
    if weights is None:
        weights = run.ex.return_tensor_values()
    run.ex.load_dict(weights)
    losses, _ = run.steps(hybrid_wdl.feeds(HY_STEPS, CTR_BATCH, CTR_VOCAB,
                                           0))
    run.finish()
    run.ex.close()
    return losses, store.pull(run.node.table, np.arange(CTR_VOCAB)), weights


def phase_hybrid(ht, device="cuda"):
    """Phase 47 (see the module docstring)."""
    from hetu_tpu_torch.tools import hybrid_wdl
    t_phase = time.perf_counter()
    card = card_line()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_hybrid_")
    report = {"card": card}
    try:
        ref, weights = {}, None
        for mode in ("ps", "vlru"):
            losses, table, weights = hy_reference(ht, hybrid_wdl, mode,
                                                  weights, device)
            ref[mode] = (losses, table)
        wpath = os.path.join(tmp, "weights.pkl")
        with open(wpath, "wb") as f:
            pickle.dump(weights, f)
        common = ["--device", device, "--steps", str(HY_STEPS),
                  "--vocab", str(CTR_VOCAB), "--dim", str(CTR_DIM),
                  "--weights", wpath, "--dump-tables"]
        # (a) two ranks sharing the card
        out_a = os.path.join(tmp, "a")
        os.makedirs(out_a)
        t0 = time.perf_counter()
        ranks = hy_launch(2, ["--out", out_a, "--modes", "ps,vlru",
                              "--bsps", "0,-1", "--profile",
                              "--batch", str(CTR_BATCH)] + common)
        report["a_s"] = time.perf_counter() - t0
        rows = {}
        for mode in ("ps", "vlru"):
            want, wtable = ref[mode]
            for bsp in (0, -1):
                name = f"{mode}_sgd_bsp{bsp}"
                r0, r1 = (r["runs"][name] for r in ranks)
                if r1["losses"] != r0["losses"] \
                        or r1["digest"] != r0["digest"]:
                    raise AssertionError(f"phase 47 {name}: the ranks "
                                         f"disagree")
                if r0["losses"] != ranks[0]["runs"][
                        f"{mode}_sgd_bsp0"]["losses"]:
                    raise AssertionError(f"phase 47 {name}: ASP (flushed "
                                         f"at the step boundary) left BSP")
                got = np.load(os.path.join(out_a, name + ".npy"))
                loss_err = float(np.max(np.abs(np.subtract(
                    r0["losses"], want)) / np.abs(want)))
                table_err = float(np.max(np.abs(got - wtable)))
                digest_err = abs(float(np.abs(
                    got.astype(np.float64)).sum())
                    - float(np.abs(wtable.astype(np.float64)).sum()))
                if not (loss_err <= HY_RTOL and digest_err < HY_DIGEST_ATOL
                        and np.allclose(got, wtable, rtol=CTR_TABLE_RTOL,
                                        atol=CTR_TABLE_ATOL)
                        and all(math.isfinite(x) for x in r0["losses"])):
                    raise AssertionError(
                        f"phase 47 {name}: two ranks vs one process: loss "
                        f"rel {loss_err:.3e}, table {table_err:.3e}, "
                        f"digest {digest_err:.3e}")
                rows[name] = {
                    "p50_step_ms": float(np.median(r0["step_ms"][1:])),
                    "rank0_idle_share": r0.get("idle_share"),
                    "rank0_busy_ms": r0.get("busy_ms"),
                    "loss_rel_err": loss_err, "table_max_abs_err": table_err,
                    "digest_err": digest_err, "cache_rank0": r0["cache"],
                    "cache_rank1": r1["cache"], "last_loss": r0["losses"][-1]}
        for r in ranks:
            if any(r["launches"].values()):
                raise AssertionError(f"phase 47: an embedding-cache kernel "
                                     f"launched on a rank: {r['launches']}")
        report["a"] = rows
        log(f"[hybrid] (a) {json.dumps(rows)} card {card}")
        # (b) three ranks, replicated, without and with the schedule
        runs = {}
        for tag, env in (("clean", {}), ("chaos", {"HETU_CHAOS": HY_CHAOS})):
            out = os.path.join(tmp, tag)
            os.makedirs(out)
            t0 = time.perf_counter()
            runs[tag] = hy_launch(
                3, ["--out", out, "--modes", "ps", "--bsps", "0",
                    "--batch", str(HY_B_BATCH), *HY_RPC] + common,
                env=dict(env, HETU_PS_REPLICATION="2"))
            report[f"b_{tag}_s"] = time.perf_counter() - t0
        name = "ps_sgd_bsp0"
        base = runs["clean"][0]["runs"][name]["losses"]
        for tag in ("clean", "chaos"):
            for r in runs[tag]:
                if r["runs"][name]["losses"] != base:
                    raise AssertionError(f"phase 47 (b) {tag} rank "
                                         f"{r['rank']}: losses left the "
                                         f"clean run's")
        tables = [np.load(os.path.join(tmp, tag, name + ".npy"))
                  for tag in ("clean", "chaos")]
        if not np.array_equal(*tables):
            raise AssertionError("phase 47 (b): the chaos run's table left "
                                 "the clean run's")
        faults = [r["faults"] for r in runs["chaos"]]
        promoted = sum(f.get("ps_promoted", 0) for f in faults)
        killed = sum(f.get("chaos_kill_primary", 0) for f in faults)
        if promoted != 1 or killed != 1 \
                or 1 not in runs["chaos"][2]["serving"]:
            raise AssertionError(f"phase 47 (b): not one failover of shard "
                                 f"1: {faults}")
        if any(r["faults"] for r in runs["clean"]):
            raise AssertionError("phase 47 (b): faults in the clean run")
        report["b"] = {"faults_by_rank": faults,
                       "serving": [r["serving"] for r in runs["chaos"]],
                       "p50_step_ms_clean": float(np.median(
                           runs["clean"][0]["runs"][name]["step_ms"][1:])),
                       "p50_step_ms_chaos": float(np.median(
                           runs["chaos"][0]["runs"][name]["step_ms"][1:])),
                       "chaos_step_ms": runs["chaos"][0]["runs"][name][
                           "step_ms"]}
        log(f"[hybrid] (b) {json.dumps(report['b'])} card {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"[hybrid] card {card} phase 47 in {report['phase_s']:.1f} s "
        f"(a {report['a_s']:.1f} s, b {report['b_clean_s']:.1f} + "
        f"{report['b_chaos_s']:.1f} s)")
    return report


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
    mline, mline_c = phase_moe_kernels(ht, pm, md)

    # -- 12. train the MoE configuration, sparse then dense -------------------------------
    mlaunches, mcalls = phase_moe_train(ht, pm, metrics, kmods, md)

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
    mline_bf16, mline_bf16_c = phase_moe_bf16_kernels(ht, pm, md)

    # -- 30. train the MoE configuration in bf16, sparse then dense -----------------
    mlaunches_bf16, mcalls_bf16 = phase_moe_train(
        ht, pm, metrics, kmods, md, compute_dtype="bfloat16")

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

    # -- 35. train ResNet-18 / CIFAR10: float32, bf16, bf16 NHWC -----------------
    rn32 = phase_resnet_train(ht, kmods)

    # -- 36. ResNet-18 fed by a DataloaderOp ----------------------------------------
    phase_resnet_dataloader(ht, kmods, rn32)

    # -- 37. card vs CPU ResNet-18 training -------------------------------------------
    phase_resnet_parity(ht)

    # -- 38. data parallel at world size 1: BERT-base, ResNet-18 ---------------------
    dlaunches = phase_dp_world1(ht, fa, metrics, kmods)

    # -- 39. two ranks on the one card over gloo ---------------------------------------
    for name, n in phase_dp_two_ranks(ht, fa).items():
        dlaunches[name] = dlaunches.get(name, 0) + n

    # -- 40. ZeRO stages 0-3 on two ranks of the card -----------------------------
    for name, n in phase_zero_two_ranks(ht, fa).items():
        dlaunches[name] = dlaunches.get(name, 0) + n

    # -- 41. the training loop's state: schedule, checkpoints, remat, ... ----------
    for name, n in phase_training_state(ht, fa, emb, seg, metrics,
                                        kmods).items():
        dlaunches[name] = dlaunches.get(name, 0) + n

    # -- 42. the executor's run surface on BERT-base --------------------------------
    for name, n in phase_run_surface(ht, fa, emb, seg, metrics, kmods,
                                     pm).items():
        dlaunches[name] = dlaunches.get(name, 0) + n

    # -- 43. the sharded parameter server on Wide & Deep ----------------------------
    ps_launches, ps_p50 = phase_ps_sharded(ht, emb, seg, metrics, kmods, pm)
    for name, n in ps_launches.items():
        dlaunches[name] = dlaunches.get(name, 0) + n

    # -- 44. the remaining transformer families --------------------------------
    frows, flaunches, fdpad = phase_families(ht, fa, metrics, kmods)
    for name, n in flaunches.items():
        dlaunches[name] = dlaunches.get(name, 0) + n

    # -- 45. the serving planes: prefix store, recovery, request router ------------
    slaunches, smerges = phase_serving_planes(ht, fa, metrics, kmods)
    for name, n in slaunches.items():
        dlaunches[name] = dlaunches.get(name, 0) + n

    # -- 46. the replicated parameter server and CTR serving ----------------------
    claunches46, crows = phase_ctr_serving(ht, emb, seg, metrics, kmods, pm,
                                           ps_p50)
    for name, n in claunches46.items():
        dlaunches[name] = dlaunches.get(name, 0) + n

    # -- 47. the hybrid deployment through the launcher ---------------------------
    phase_hybrid(ht)

    # -- 48. result lines ---------------------------------------------------------
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
    # B6 at the dispatch shape (20,480 rows from 8,192), and under
    # "combine" at the combine's (8,192 from 20,480): its times from phases
    # 11 and 29, its launches those phases 12 and 30 recorded at that shape
    # in their counted steps (GatherCalls)
    for name, dtype, counts, calls, line, cline in (
            ("row_gather", "float32", mlaunches, mcalls, mline, mline_c),
            ("row_gather_bf16", "bfloat16", mlaunches_bf16, mcalls_bf16,
             mline_bf16, mline_bf16_c)):
        kernels.append(dict(
            entry(name, "moe_dispatch.cu", "moe_dispatch.py:37",
                  counts[name], line),
            combine=dict({k: cline[k] for k in keys + ("n", "src_rows")},
                         launches=calls.count(dtype, cline["n"],
                                              cline["src_rows"]))))
    # the flash kernels of the data-parallel paths (phases 38-40) and of
    # phases 41, 42, 44 and 45, and the B4 and B5 launches of phases 41-43
    # and 46, by kernels-line name; phase 45's decode merges beside phase
    # 3's
    for e in kernels:
        e["launches"] += dlaunches.pop(e["name"], 0)
    kernels[0]["merge_launches"] += smerges
    # phase 44's shapes beside each float32 flash entry they launch, and
    # Transformer-XL's padded launches (D 41 -> 44)
    by_name = {e["name"]: e for e in kernels}
    for shape, sfx in (("swin_shifted", "_mask_bias"),
                       ("swin_unshifted", "_bias"), ("vit", ""),
                       ("clip_text", "_causal"),
                       ("transfoxl_d41", "_bias_causal"),
                       ("bigbird", "_mask")):
        for key, name, _, _ in flash:
            e, r = by_name[name + sfx], frows[shape][key]
            e.setdefault("shapes", []).append(dict(
                {k_: r[k_] for k_ in keys + ("shape",)}, name=shape))
            e["max_abs_err"] = max(e["max_abs_err"], r["max_abs_err"])
    for name, n in fdpad.items():
        by_name[name]["dpad_launches"] = n
    # phase 46's bf16 step: B4 and B5 at its float32 rows' shapes
    for name, r in crows.items():
        by_name[name].setdefault("shapes", []).append(dict(r))
        by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"],
                                           r["max_abs_err"])
    if dlaunches:
        raise AssertionError(f"launches with no kernels-line entry: "
                             f"{dlaunches}")
    log(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
