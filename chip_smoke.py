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
11. Print the card's name and power limit, the ``kernels`` JSON line and,
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


def train_bound(kind, bh, heads, s, d, valid_keys):
    """Least time for one training kernel's function on these inputs.
    Bytes: each input read once, each output written once (float32
    q/k/v/dO/out/dQ/dK/dV rows, lse and delta per row, int32 key mask
    when given).  Operations: 4 (forward), 6 (dQ: s, dP, dQ) or 8 (dK/dV:
    s, dP, dV, dK) x S_q x D per valid (row, key) pair, ``valid_keys``
    being the valid keys summed over the batch rows.  Returns (ms,
    'bytes' | 'operations')."""
    mat, row = bh * s * d, bh * s
    mask = 0 if valid_keys is None else (bh // heads) * s
    keys = (bh // heads) * s if valid_keys is None else valid_keys
    words = {"fwd": 3 * mat + mask + mat + row,             # q k v m → o lse
             "dq": 4 * mat + mask + 2 * row + mat,          # + dO lse δ → dQ
             "dkv": 4 * mat + mask + 2 * row + 2 * mat}[kind]
    flops = {"fwd": 4, "dq": 6, "dkv": 8}[kind] * float(keys) * heads * s * d
    t_bytes, t_ops = 4 * words / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
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
        valid = None if km is None else int(km.sum())
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
            r["bound_ms"], r["bound_by"] = train_bound(kk, TB * H, H, s, D,
                                                       valid)
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
    from hetu_tpu_torch.ops.kernels import segment_sum as seg
    kmods = (fa, emb, seg)

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
    with ht.DecodeRouter(engine, queue_limit=N_REQUESTS) as router:
        # warm-up (cuBLAS handles, allocator) before the counted run
        router.submit(prompts[1][:4], max_new_tokens=2).result(timeout=300)
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
        launches = {"flash_fwd_lengths": fa.launches}
    counts = metrics.decode_counts()
    fallbacks = metrics.flash_fallback_counts()
    steps = counts.get("decode_steps", 0)
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
    lat = metrics.decode_latency_stats()
    n_tok = counts.get("decode_tokens", 0)
    serve = {"requests": N_REQUESTS, "prompt_lens": plens.tolist(),
             "max_new_tokens": MAX_NEW, "decode_steps": steps,
             "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
             "step_p50_ms": lat["step"]["p50"] / 1e3,
             "step_p99_ms": lat["step"]["p99"] / 1e3,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "kv_cache_len": engine.lb, "launches": launches,
             "card": card_line()}
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

    # -- 11. result lines ---------------------------------------------------------
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
    log(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
