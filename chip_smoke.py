#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``hetu_tpu_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero
without printing the final result line:

1. Build every CUDA source of ``hetu_tpu_torch/csrc`` with nvcc (one
   process per source, all started together) and load the kernels.
2. Hold the decode kernel (``lengths``) against its plain PyTorch version
   on the card at the decode path's shapes (B=8, H=12, D=64; cache
   lengths 1, 7, 128, 384, 1024; S_q = 1, plus one S_q = 4 case with an
   empty row), and time the kernel, the plain version, one PyTorch
   library call and the bound.
3. Serve GPT-2 small (published widths, seeded random weights, fp32):
   8 seeded prompts of 8-300 tokens through ``DecodeRouter`` →
   ``DecodeEngine`` with 32 new tokens each.  Every launch counter is set
   to 0 just before and read just after; each kernel of the path must
   have launched (flash: decode steps × n_layer launches) and no
   attention dispatch may have left the kernel.
4. Teacher-force one prompt through the port on the card and on the CPU
   (plain versions) with the same weights; per-step logits must agree.
5. Hold the training kernels (flash forward dense / key-mask, dQ, dK/dV)
   against their plain versions at BERT-base attention shapes (B=4,
   H=12, S=512, D=64: a key mask from ``synthetic_mlm_batch``'s lengths
   plus one row with every key masked; dense; a ragged S=200), and time
   each kernel, its plain version, the SDPA yardstick and the bound.
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
   size, one run, every key distinct, widths 13 and 128.  The gather must
   match exactly; the segment-sum within rtol 2e-5 / atol 1e-6 of its
   plain version (``index_add_``, atomics) and exactly the host cache's
   ``_segment_sum``.  Time each kernel, its plain version, the library
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
    (64, 200), (200, 64), (1, 130); the full mask at the chunked-prefill
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
    nonzero, no ``backend:`` fallback, prefill steps saved > 0.  Logits of
    one 300-token prompt at every chunk end and the KV caches, chunked
    against token by token on the card and chunked on the card against
    chunked on the CPU, within ``LOGITS_ATOL``.  The greedy streams of the
    two engines must be equal; one may differ only from a step at which
    the one-token path's top-2 logit gap is below 2 x ``LOGITS_ATOL``.
18. Print the card's name and power limit, the ``kernels`` JSON line and,
    last, ``{"ok": true, "device": {...}}``.

Float32 matrix products run in full float32:
``torch.backends.cuda.matmul.allow_tf32`` is set False.
"""
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
# H100 SXM data sheet: HBM3 bytes/s and float32 (non-tensor-core) FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

B, H, D = 8, 12, 64
CACHE_LENS = (1, 7, 128, 384, 1024)
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
# row-gather launches of one top-2 training step: the dispatch (1), the
# combine (2), its backward (2 for d_w, 1 for d_buffers); the tokens are
# a feed, so autograd runs no dispatch backward
MOE_GATHERS_PER_STEP = 6


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


def phase_kernels(fa):
    """Kernel vs plain version at the decode path's shapes; times."""
    F = torch.nn.functional
    rng = np.random.RandomState(0)
    scale = 1.0 / math.sqrt(D)
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
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
    # the kernels line is taken at the longest cache with every row full
    full = np.full(B, CACHE_LENS[-1], np.int64)
    L = CACHE_LENS[-1]
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
    log(f"[kernels] flash line shape B={B} H={H} L={L} full lengths: "
        f"{json.dumps(line)}")
    return line


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


def attn_bound(kind, bh, s_q, s_kv, d, pairs, extra_bytes=0, kv_rows=None):
    """Least time for one attention kernel's function on these inputs.
    Bytes: each input read once, each output written once (float32 q /
    dO / out / dQ rows of S_q, k / v / dK / dV rows of S_kv or, with
    ``kv_rows``, only the K/V rows some query can see; lse and delta per
    row; ``extra_bytes`` of masks).  Operations: 4 (forward), 6 (dQ: s,
    dP, dQ) or 8 (dK/dV: s, dP, dV, dK) x D per visible (row, key) pair.
    Returns (ms, 'bytes' | 'operations')."""
    qmat, row = bh * s_q * d, bh * s_q
    kmat = bh * s_kv * d if kv_rows is None else kv_rows * d
    words = {"fwd": qmat + 2 * kmat + qmat + row,
             "dq": 2 * qmat + 2 * kmat + 2 * row + qmat,
             "dkv": 2 * qmat + 2 * kmat + 2 * row + 2 * kmat}[kind]
    flops = {"fwd": 4, "dq": 6, "dkv": 8}[kind] * float(pairs) * d
    t_bytes = (4 * words + extra_bytes) / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_train_kernels(ht, fa):
    """The training kernels vs their plain versions at BERT-base
    attention shapes; times.  Returns the kernels-line entries of the
    key-mask case with the worst error over all cases."""
    F = torch.nn.functional
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    flush = flush_buf.zero_
    scale = 1.0 / math.sqrt(D)
    _, _, _, attn = ht.synthetic_mlm_batch(
        ht.BertConfig.base(batch_size=TB, seq_len=TS), seed=0)
    attn = attn.copy()
    attn[-1] = 0                          # a row with every key masked
    cases = [("key_mask", TS, attn), ("dense", TS, None),
             ("ragged", 200, (np.arange(200)[None, :]
                              < np.array([200, 77, 1, 150])[:, None])
              .astype(np.int32))]
    rng = np.random.RandomState(5)
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    lines = None
    for name, s, mask in cases:
        def t(*shape):
            return torch.from_numpy(
                rng.randn(*shape).astype(np.float32)).cuda()
        q, k, v, do = (t(TB * H, s, D) for _ in range(4))
        km = None if mask is None else torch.from_numpy(mask).cuda()
        out, lse = fa.flash_fwd_masked(q, k, v, km, scale)
        ref, lse_ref = fa.flash_fwd_plain(q, k, v, None, H, scale,
                                          key_mask=km)
        delta = (do * out).sum(-1)
        dq = fa.flash_bwd_dq(q, k, v, km, do, lse, delta, scale)
        dk, dv = fa.flash_bwd_dkv(q, k, v, km, do, lse, delta, scale)
        dq_r, dk_r, dv_r = fa.flash_bwd_plain(q, k, v, km, out, lse, do,
                                              scale)
        torch.cuda.synchronize()
        err = {"fwd": max(float((out - ref).abs().max()),
                          float((lse - lse_ref).abs().max())),
               "dq": float((dq - dq_r).abs().max()),
               "dkv": max(float((dk - dk_r).abs().max()),
                          float((dv - dv_r).abs().max()))}
        if not err["fwd"] <= KERNEL_ATOL:
            raise AssertionError(f"flash fwd vs plain ({name}): {err}")
        for got, want, what in ((dq, dq_r, "dq"), (dk, dk_r, "dk"),
                                (dv, dv_r, "dv")):
            if not torch.allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL):
                raise AssertionError(
                    f"flash {what} vs plain ({name}): max err "
                    f"{float((got - want).abs().max())}")
        if name == "key_mask":
            dead = slice((TB - 1) * H, TB * H)
            if float(out[dead].abs().max()) != 0.0 \
                    or float(dq[dead].abs().max()) != 0.0:
                raise AssertionError("row with no valid key: out/dQ not 0")
        for kk in worst:
            worst[kk] = max(worst[kk], err[kk])
        # the kernels and cuBLAS's SIMT products both sum each backward
        # output as one FMA chain in key (query) order, so dQ/dK/dV may
        # agree exactly; the magnitudes show the outputs are not trivial
        log(f"[train-kernels] {name} B={TB} H={H} S={s} D={D} "
            f"max_abs_err fwd={err['fwd']:.3e} dq={err['dq']:.3e} "
            f"dkv={err['dkv']:.3e}; max |dq| {float(dq_r.abs().max()):.3e} "
            f"|dk| {float(dk_r.abs().max()):.3e} "
            f"|dv| {float(dv_r.abs().max()):.3e}")

        # timings, each launch with the L2 cache flushed
        q4, k4, v4 = (x.view(TB, H, s, D).detach().requires_grad_(True)
                      for x in (q, k, v))
        smask = None if km is None else (km != 0).view(TB, 1, 1, s)
        with torch.enable_grad():
            lib_out = F.scaled_dot_product_attention(q4, k4, v4,
                                                     attn_mask=smask)
        do4 = do.view(TB, H, s, D)
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            q4.detach(), k4.detach(), v4.detach(), attn_mask=smask),
            flush=flush)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            lib_out, (q4, k4, v4), do4, retain_graph=True), flush=flush)
        # visible (row, key) pairs: every row sees the valid keys
        pairs = (TB * s if km is None else int(km.sum())) * H * s
        extra = 0 if km is None else 4 * km.numel()
        row = {
            "fwd": {"ms": time_ms(lambda: fa.flash_fwd_masked(
                        q, k, v, km, scale), flush=flush),
                    "plain_ms": time_ms(lambda: fa.flash_fwd_plain(
                        q, k, v, None, H, scale, key_mask=km), flush=flush),
                    "library_ms": lib_fwd},
            "dq": {"ms": time_ms(lambda: fa.flash_bwd_dq(
                       q, k, v, km, do, lse, delta, scale), flush=flush),
                   "plain_ms": time_ms(lambda: fa.flash_bwd_plain(
                       q, k, v, km, out, lse, do, scale), flush=flush),
                   "library_ms": lib_bwd},
            "dkv": {"ms": time_ms(lambda: fa.flash_bwd_dkv(
                        q, k, v, km, do, lse, delta, scale), flush=flush),
                    "plain_ms": time_ms(lambda: fa.flash_bwd_plain(
                        q, k, v, km, out, lse, do, scale), flush=flush),
                    "library_ms": lib_bwd}}
        for kk, r in row.items():
            r["bound_ms"], r["bound_by"] = attn_bound(kk, TB * H, s, s, D,
                                                      pairs, extra)
        log(f"[train-kernels] {name} timing {json.dumps(row)}")
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
    scases = [("plan", g_plan, inv_np),
              ("plan, unit scale", torch.from_numpy(
                  rng.randn(n, w).astype(np.float32)).cuda(), inv_np)]
    for name, n_, w_, ids in (
            ("n=0", 0, 16, np.zeros(0, np.int64)),
            ("n=1001", 1001, 16, rng.randint(0, 300, 1001)),
            ("one run", 4096, 16, np.zeros(4096, np.int64)),
            ("distinct", 4096, 16, rng.permutation(10 ** 5)[:4096]),
            ("w=13", 4099, 13, rng.randint(0, 500, 4099)),
            ("w=128", 2051, 128, rng.randint(0, 500, 2051))):
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
        if not unit:
            worst = max(worst, err)
        log(f"[emb-kernels] segment-sum {name} n={gg.shape[0]} "
            f"w={gg.shape[1]} segments={u}: max_abs_err vs plain "
            f"{err:.3e}, equal to host _segment_sum")
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
    output written once."""
    valid = idx[idx >= 0]
    rows = int(torch.unique(valid).numel()) if valid.numel() else 0
    m = src.shape[1]
    return bytes_bound(4 * idx.shape[0] + 4 * rows * m + 4 * idx.shape[0] * m)


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


def phase_moe_train(ht, pm, metrics, kmods, md):
    """The MoE configuration trained through SparseMoELayer on the card,
    then the dense MoELayer graph the same way."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()     # what earlier phases still hold
    reports = {}
    for graph in ("sparse", "dense"):
        t0 = time.perf_counter()
        dims, ex, fd = pm.build_moe_graph(sparse=graph == "sparse",
                                          device="cuda")
        log(f"[moe] {graph} executor built in {time.perf_counter() - t0:.1f} s")

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
        launches = {"row_gather": md.launches}
        others = {m.__name__.rsplit(".", 1)[-1]: n for m in kmods
                  for name, n in vars(m).items()
                  if name.endswith("launches") and m is not md and n}
        fallbacks = {**metrics.moe_fallback_counts(),
                     **metrics.flash_fallback_counts(),
                     **metrics.emb_fallback_counts()}
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        kern, pwall, _ = pm.device_profile(step, MOE_PROFILED)
        busy_s = sum(v[1] for v in kern.values()) / 1e6 / MOE_PROFILED
        gather_us = sum(v[1] for n, v in kern.items() if "row_gather" in n)
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"non-finite MoE loss ({graph}): {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"MoE loss did not fall ({graph}): {losses}")
        want = MOE_STEPS * MOE_GATHERS_PER_STEP if graph == "sparse" else 0
        if launches["row_gather"] != want:
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
            "graph": graph, "tokens": tokens, "d": dims["d"],
            "experts": dims["experts"], "capacity": dims["capacity"],
            "steps": MOE_STEPS, "losses": losses,
            "step_ms_p50": float(np.percentile(ms, 50)),
            "step_ms_p99": float(np.percentile(ms, 99)),
            "step_ms_mean": float(ms.mean()),
            "tokens_per_s": tokens / (ms.mean() / 1e3),
            "model_gflop_per_step": flops / 1e9,
            "mfu_fp32": flops / (ms.mean() / 1e3) / PEAK_FP32_FLOPS,
            "peak_mem_gib": peak,
            "device_busy_ms_per_step": busy_s * 1e3,
            "device_idle_share": 1.0 - busy_s / (ms.mean() / 1e3),
            "row_gather_device_ms_per_step": gather_us / MOE_PROFILED / 1e3,
            "device_ops_per_step": sum(v[0] for v in kern.values())
            / MOE_PROFILED,
            "launches": launches, "card": card_line()}
        log(f"[moe] {json.dumps(reports[graph])}")
        ex.close()
        del ex, fd
        torch.cuda.empty_cache()
    sp, de = reports["sparse"], reports["dense"]
    log(f"[moe] step p50 sparse {sp['step_ms_p50']:.3f} ms, dense "
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
            logits = fd[g["x"]].astype(np.float64) @ wg
            p = np.exp(logits - logits.max(1, keepdims=True))
            p = np.sort(p / p.sum(1, keepdims=True), axis=1)[:, ::-1]
            ec = np.where(sot_c >= 0, sot_c // cap, -1)
            eh = np.where(sot_h >= 0, sot_h // cap, -1)
            diff = np.nonzero((ec != eh).any(1))[0]
            gaps = [f"token {t}: p1-p2 {p[t, 0] - p[t, 1]:.3e}, p2-p3 "
                    f"{p[t, 1] - p[t, 2]:.3e}" for t in diff[:20]]
            raise AssertionError(
                f"card vs CPU routing maps differ at step {step + 1}: "
                f"{int((sot_c != sot_h).sum())} routes, expert choice of "
                f"{diff.size} tokens; {'; '.join(gaps) or 'no expert flip'}")
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
                  mask=None, gmode=None):
    """Visible (row, key) pairs summed over the BH rows, counted from the
    inputs themselves: the work a masked attention function has to do."""
    valid = torch.ones(bh, s_q, s_kv, dtype=torch.bool, device="cuda")
    if causal:
        valid = valid.tril(s_kv - s_q)
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
        out, lse = fa.flash_fwd_masked(q, k, v, km, scale, causal=True)
        ref, lse_ref = fa.flash_fwd_plain(q, k, v, None, H, scale,
                                          key_mask=km, causal=True)
        delta = (do * out).sum(-1)
        dq = fa.flash_bwd_dq(q, k, v, km, do, lse, delta, scale, causal=True)
        dk, dv = fa.flash_bwd_dkv(q, k, v, km, do, lse, delta, scale,
                                  causal=True)
        dq_r, dk_r, dv_r = fa.flash_bwd_plain(q, k, v, km, out, lse, do,
                                              scale, causal=True)
        torch.cuda.synchronize()
        err = {"fwd": max(float((out - ref).abs().max()),
                          float((lse - lse_ref).abs().max())),
               "dq": float((dq - dq_r).abs().max()),
               "dkv": max(float((dk - dk_r).abs().max()),
                          float((dv - dv_r).abs().max()))}
        if not err["fwd"] <= KERNEL_ATOL:
            raise AssertionError(f"causal fwd vs plain ({name}): {err}")
        for got, want, what in ((dq, dq_r, "dq"), (dk, dk_r, "dk"),
                                (dv, dv_r, "dv")):
            if not (bool(torch.isfinite(got).all())
                    and torch.allclose(got, want, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL)):
                raise AssertionError(
                    f"causal {what} vs plain ({name}): max err "
                    f"{float((got - want).abs().max())}")
        empty = max(0, s_q - s_kv)         # rows that see no key
        if empty and (float(out[:, :empty].abs().max()) != 0.0
                      or float(dq[:, :empty].abs().max()) != 0.0
                      or not bool((lse[:, :empty] == fa.NEG_INF).all())):
            raise AssertionError(f"{name}: rows with no visible key are not "
                                 f"out = dQ = 0, lse = -1e30")
        if km is not None:
            dead = slice((GPT_BATCH - 1) * H, bh)
            if float(out[dead].abs().max()) != 0.0 \
                    or float(dq[dead].abs().max()) != 0.0:
                raise AssertionError(f"{name}: fully masked batch row: "
                                     f"out / dQ not 0")
        for kk in err:
            worst[kk] = max(worst[kk], err[kk])
        log(f"[causal-kernels] {name} B={GPT_BATCH} H={H} S_q={s_q} "
            f"S_kv={s_kv} D={D} max_abs_err fwd={err['fwd']:.3e} "
            f"dq={err['dq']:.3e} dkv={err['dkv']:.3e}; max |dq| "
            f"{float(dq_r.abs().max()):.3e} |dk| "
            f"{float(dk_r.abs().max()):.3e} |dv| "
            f"{float(dv_r.abs().max()):.3e}")
        if s_q != GPT_SEQ:
            continue
        # timings at the training shape, each launch with the L2 flushed
        q4, k4, v4 = (x.view(GPT_BATCH, H, -1, D).detach()
                      .requires_grad_(True) for x in (q, k, v))
        smask = None if km is None else \
            ((km != 0).view(GPT_BATCH, 1, 1, s_kv)
             & torch.ones(s_q, s_kv, dtype=torch.bool,
                          device="cuda").tril())
        sdpa_kw = {"is_causal": True} if km is None else {"attn_mask": smask}
        with torch.enable_grad():
            lib_out = F.scaled_dot_product_attention(q4, k4, v4, **sdpa_kw)
        do4 = do.view(GPT_BATCH, H, s_q, D)
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            q4.detach(), k4.detach(), v4.detach(), **sdpa_kw), flush=flush)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            lib_out, (q4, k4, v4), do4, retain_graph=True), flush=flush)
        plain_bwd = time_ms(lambda: fa.flash_bwd_plain(
            q, k, v, km, out, lse, do, scale, causal=True), flush=flush)
        row = {
            "fwd": {"ms": time_ms(lambda: fa.flash_fwd_masked(
                        q, k, v, km, scale, causal=True), flush=flush),
                    "plain_ms": time_ms(lambda: fa.flash_fwd_plain(
                        q, k, v, None, H, scale, key_mask=km, causal=True),
                        flush=flush),
                    "library_ms": lib_fwd},
            "dq": {"ms": time_ms(lambda: fa.flash_bwd_dq(
                       q, k, v, km, do, lse, delta, scale, causal=True),
                       flush=flush),
                   "plain_ms": plain_bwd, "library_ms": lib_bwd},
            "dkv": {"ms": time_ms(lambda: fa.flash_bwd_dkv(
                        q, k, v, km, do, lse, delta, scale, causal=True),
                        flush=flush),
                    "plain_ms": plain_bwd, "library_ms": lib_bwd}}
        pairs = visible_pairs(bh, H, s_q, s_kv, causal=True, key_mask=km)
        extra = 0 if km is None else 4 * km.numel()
        for kk, r in row.items():
            r["bound_ms"], r["bound_by"] = attn_bound(kk, bh, s_q, s_kv, D,
                                                      pairs, extra)
            r["visible_pairs"] = pairs
        log(f"[causal-kernels] {name} timing (library = SDPA "
            f"{'is_causal' if km is None else 'attn_mask'}; its backward "
            f"is one call for dQ, dK and dV) {json.dumps(row)}")
        if name == "causal":
            lines.update(row)
        del lib_out, q4, k4, v4

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


def serve_streams(ht, metrics, kmods, engine, prompts):
    """The prompts through ``DecodeRouter``; counters set to 0 just before
    and read just after.  Returns (token streams, report)."""
    with ht.DecodeRouter(engine, queue_limit=len(prompts)) as router:
        # warm-up (cuBLAS handles, allocator) before the counted run
        router.submit(prompts[1][:40], max_new_tokens=2).result(timeout=300)
        torch.cuda.synchronize()
        reset_launches(*kmods)
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
    got, crep = serve_streams(ht, metrics, kmods, ceng, prompts)
    launches = {"flash_fwd_mask": fa.fwd_mask_launches,
                "flash_fwd_lengths": fa.launches}
    others = {name: n for m in kmods for name, n in vars(m).items()
              if name.endswith("launches") and n and not (
                  m is fa and name in ("fwd_mask_launches", "launches"))}
    fallbacks = metrics.flash_fallback_counts()
    want, orep = serve_streams(ht, metrics, kmods, oeng, prompts)
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
    md.kernel()
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
    results, serve = serve_streams(ht, metrics, kmods, engine, prompts)
    launches = {"flash_fwd_lengths": fa.launches}
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

    # -- 18. result lines ---------------------------------------------------------
    kernels = [{
        "name": "flash_fwd_lengths", "route": "cuda",
        "source": "hetu_tpu_torch/csrc/flash_attention.cu",
        "replaces": "hetu_tpu/ops/pallas/flash_attention.py:202",
        "launches": launches["flash_fwd_lengths"],
        "max_abs_err": line["max_abs_err"], "ms": line["ms"],
        "plain_ms": line["plain_ms"], "bound_ms": line["bound_ms"],
        "bound_by": line["bound_by"], "library_ms": line["library_ms"]}]
    for key, name, source, replaces in (
            ("fwd", "flash_fwd", "hetu_tpu_torch/csrc/flash_attention.cu",
             "hetu_tpu/ops/pallas/flash_attention.py:202"),
            ("dq", "flash_bwd_dq", "hetu_tpu_torch/csrc/flash_attention_bwd.cu",
             "hetu_tpu/ops/pallas/flash_attention.py:299"),
            ("dkv", "flash_bwd_dkv",
             "hetu_tpu_torch/csrc/flash_attention_bwd.cu",
             "hetu_tpu/ops/pallas/flash_attention.py:363")):
        r = tlines[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": tlaunches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    for r, name, source, replaces in (
            (gline, "emb_gather", "hetu_tpu_torch/csrc/emb_cache.cu",
             "hetu_tpu/ops/pallas/emb_cache.py:71"),
            (sline, "sorted_segment_sum", "hetu_tpu_torch/csrc/segment_sum.cu",
             "hetu_tpu/ops/pallas/segment_sum.py:25")):
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": claunches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    for key, name, source, replaces in (
            ("fwd", "flash_fwd_causal",
             "hetu_tpu_torch/csrc/flash_attention.cu",
             "hetu_tpu/ops/pallas/flash_attention.py:202"),
            ("dq", "flash_bwd_dq_causal",
             "hetu_tpu_torch/csrc/flash_attention_bwd.cu",
             "hetu_tpu/ops/pallas/flash_attention.py:299"),
            ("dkv", "flash_bwd_dkv_causal",
             "hetu_tpu_torch/csrc/flash_attention_bwd.cu",
             "hetu_tpu/ops/pallas/flash_attention.py:363"),
            ("mask", "flash_fwd_mask",
             "hetu_tpu_torch/csrc/flash_attention.cu",
             "hetu_tpu/ops/pallas/flash_attention.py:202")):
        r = glines[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": glaunches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    kernels.append({
        "name": "row_gather", "route": "cuda",
        "source": "hetu_tpu_torch/csrc/moe_dispatch.cu",
        "replaces": "hetu_tpu/ops/pallas/moe_dispatch.py:37",
        "launches": mlaunches["row_gather"],
        "max_abs_err": mline["max_abs_err"], "ms": mline["ms"],
        "plain_ms": mline["plain_ms"], "bound_ms": mline["bound_ms"],
        "bound_by": mline["bound_by"], "library_ms": mline["library_ms"]})
    log(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
