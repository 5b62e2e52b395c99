"""Where the time of a BERT-base, GPT-2 small, T5-small, XLNet-base or
Longformer-base training step goes, on the card.

Runs a training workload of ``chip_smoke.py``: ``--model bert`` (the
default) BERT-base at published widths, seq 512, batch 16,
``synthetic_mlm_batch(cfg, seed=0)``; ``--model gpt2`` GPT-2 small at
published widths, seq 1024, batch 8, ``synthetic_lm_batch(cfg, seed=0)``,
attention through the causal kernels; ``--model t5`` T5-small at
published widths, source 512, target 114, batch 32,
``t5_seq2seq_graph(cfg, use_mask=True)`` on
``synthetic_seq2seq_batch(cfg, seed=0, padded=True)``, attention through
the bias kernels (encoder: with the key mask; decoder: causal) and the
key-mask kernels (cross-attention); ``--model xlnet`` XLNet-base at
published widths, seq 512, batch 8, ``xlnet_plm_graph`` on
``synthetic_plm_batch(cfg, seed=0)``, both streams through the
full-mask-with-bias kernels; ``--model longformer`` Longformer-base at
published widths, seq 4096, batch 2, ``longformer_mlm_graph`` on
``synthetic_mlm_ids(cfg, seed=0)``, the window mask through the full-mask
kernels.  All: seeded random weights, fp32 (with ``--compute-dtype
bfloat16``: bf16 mixed precision, the bf16 flash kernels; ``--batch``
sets the batch: bench.py's flagship is ``--model bert --compute-dtype
bfloat16 --batch 64``), dropout 0.1, the one batch fed every step,
``AdamOptimizer(1e-4)`` through ``Executor.run``.  Reports per step: host wall time without
the profiler, then under ``torch.profiler`` the device busy time (sum of
kernel durations on the one stream), the device's idle share, kernel
launches, the kernels that take the most device time, the share of the
three flash attention kernels and of the matrix products.  Run from the
repository root::

    python3 -m hetu_tpu_torch.tools.profile_train
        [--model bert|gpt2|t5|xlnet|longformer] [--compute-dtype bfloat16]
        [--batch N] [--out DIR] [--steps N]

``--out`` receives ``profile_train[_<model>][_bf16].json`` (no model
suffix for bert) and the operator tables.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import time

import numpy as np
import torch

import hetu_tpu_torch as ht
from hetu_tpu_torch.ops.kernels import flash_attention as fa

WARMUP = 2
#: T5's source and target lengths; model -> (batch, tokens a sequence)
T5_SRC, T5_TGT = 512, 114
SHAPES = {"bert": (16, 512), "gpt2": (8, 1024), "t5": (32, T5_SRC + T5_TGT),
          "xlnet": (8, 512), "longformer": (2, 4096)}
# the kernels' names in a trace (the float32 SIMT ones, then the bf16
# tensor-core ones); the causal, mask and bias instantiations share them
FLASH = {"flash_fwd_kernel": "fwd", "flash_bwd_dq_kernel": "dq",
         "flash_bwd_dkv_kernel": "dkv", "flash_fwd_mma_kernel": "fwd",
         "flash_dq_mma_kernel": "dq", "flash_dkv_mma_kernel": "dkv"}


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _is_gemm(name):
    n = name.lower()
    return ("gemm" in n or "sgemm" in n or "cutlass" in n or "xmma" in n
            or "nvjet" in n)                # cuBLAS's Hopper bf16 kernels


def build(model, device="cuda", compute_dtype=None, batch=None):
    """(executor, feed dict) of ``model``'s training workload, with
    ``compute_dtype`` and, given, ``batch`` instead of the model's."""
    batch = batch or SHAPES[model][0]
    seq = SHAPES[model][1]
    if model == "t5":
        cfg = ht.T5Config.small(batch_size=batch, src_len=T5_SRC,
                                tgt_len=T5_TGT)
        feeds, loss, _ = ht.t5_seq2seq_graph(cfg, use_mask=True)
        batch_np = ht.synthetic_seq2seq_batch(cfg, seed=0, padded=True)
        fd = {feeds[k]: v for k, v in zip(
            ("input_ids", "decoder_input_ids", "labels", "attention_mask"),
            batch_np)}
    elif model == "xlnet":
        cfg = ht.XLNetConfig.base(batch_size=batch, seq_len=seq)
        feeds, loss, _ = ht.xlnet_plm_graph(cfg)
        fd = {feeds[k]: v for k, v in zip(
            ("input_ids", "content_mask", "query_mask", "labels"),
            ht.synthetic_plm_batch(cfg, seed=0))}
    elif model == "longformer":
        cfg = ht.LongformerConfig.base(batch_size=batch, seq_len=seq)
        feeds, loss, _ = ht.longformer_mlm_graph(cfg)
        ids, labels = ht.synthetic_mlm_ids(cfg, seed=0)
        fd = {feeds["input_ids"]: ids, feeds["labels"]: labels}
    elif model == "gpt2":
        cfg = ht.GPT2Config.small(batch_size=batch, seq_len=seq)
        feeds, loss, _ = ht.gpt2_lm_graph(cfg)
        ids, labels = ht.synthetic_lm_batch(cfg, seed=0)
        fd = {feeds["input_ids"]: ids, feeds["labels"]: labels}
    else:
        cfg = ht.BertConfig.base(batch_size=batch, seq_len=seq)
        feeds, loss, _ = ht.bert_pretrain_graph(cfg)
        ids, tt, labels, attn = ht.synthetic_mlm_batch(cfg, seed=0)
        fd = {feeds["input_ids"]: ids, feeds["token_type_ids"]: tt,
              feeds["masked_lm_labels"]: labels,
              feeds["attention_mask"]: attn}
    train_op = ht.optim.AdamOptimizer(1e-4).minimize(loss)
    return ht.Executor({"train": [loss, train_op]}, seed=0, device=device,
                       compute_dtype=compute_dtype), fd


def profile_steps(step, psteps=3, step_s=None):
    """``psteps`` calls of ``step`` (one training step each) under
    ``torch.profiler``: per step the device busy time (sum of kernel
    durations on the one stream), the device's idle share (against the
    profiled wall time and, given ``step_s``, the unprofiled step time:
    the profiler slows the host, not the kernels), kernel launches, the
    three flash kernels' time and share, the matrix products' and the
    kernels that take the most device time.  Returns (that report, the
    profiler)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(psteps):
            step()
        torch.cuda.synchronize()
    pwall = time.perf_counter() - t0

    kern = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kern[e.name]
            k[0] += 1
            k[1] += e.time_range.end - e.time_range.start
    busy_us = sum(v[1] for v in kern.values())
    n_kern = sum(v[0] for v in kern.values())
    flash = collections.Counter()
    for key, short in FLASH.items():
        flash[short] += sum(v[1] for n, v in kern.items() if key in n)
    gemm = sum(v[1] for n, v in kern.items() if _is_gemm(n))
    top = sorted(kern.items(), key=lambda kv: -kv[1][1])[:15]

    def per_step_ms(us):
        return us / psteps / 1e3

    return {
        "steps": psteps, "wall_ms_per_step": pwall / psteps * 1e3,
        "device_busy_ms_per_step": per_step_ms(busy_us),
        "device_idle_share": 1.0 - busy_us / 1e6 / pwall,
        "device_idle_share_unprofiled":
            None if step_s is None else 1.0 - busy_us / 1e6 / psteps / step_s,
        "kernels_per_step": n_kern / psteps,
        "flash_ms_per_step": {k: per_step_ms(v) for k, v in flash.items()},
        "flash_share_of_device":
            sum(flash.values()) / busy_us if busy_us else None,
        "gemm_ms_per_step": per_step_ms(gemm),
        "gemm_share_of_device": gemm / busy_us if busy_us else None,
        "top_kernels": [{"name": n[:90], "count_per_step": c / psteps,
                         "ms_per_step": per_step_ms(us)}
                        for n, (c, us) in top]}, prof


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(SHAPES), default="bert")
    ap.add_argument("--compute-dtype", choices=["bfloat16"], default=None,
                    help="mixed precision (default: float32)")
    ap.add_argument("--batch", type=int, default=None,
                    help="batch size (default: the model's)")
    ap.add_argument("--out", default=None,
                    help="directory for the JSON report and tables")
    ap.add_argument("--steps", type=int, default=5,
                    help="timed steps without the profiler (and the "
                         "profiled steps: 3)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = args.batch or SHAPES[args.model][0]
    seq = SHAPES[args.model][1]
    ex, fd = build(args.model, compute_dtype=args.compute_dtype, batch=batch)

    def step():
        return float(ex.run("train", feed_dict=fd)[0].asnumpy())

    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    times = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step()
        times.append(time.perf_counter() - t0)
    step_s = float(np.mean(times))

    counters = [n for n in vars(fa) if n.endswith("_launches")]
    for n in counters:
        setattr(fa, n, 0)
    psteps = 3
    profiled, prof = profile_steps(step, psteps, step_s)
    report = {
        "card": _card(), "torch": torch.__version__, "model": args.model,
        "batch": batch, "seq": seq,
        "compute_dtype": args.compute_dtype or "float32",
        "step_ms_mean": step_s * 1e3,
        "step_ms_all": [t * 1e3 for t in times],
        "samples_per_s": batch / step_s,
        "tokens_per_s": batch * seq / step_s,
        "tgt_tokens_per_s": (batch * T5_TGT / step_s if args.model == "t5"
                             else None),
        "profiled": profiled,
    }
    dev_table = prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=30)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        stem = "profile_train" + ("" if args.model == "bert"
                                  else "_" + args.model) \
            + ("_bf16" if args.compute_dtype else "")
        with open(os.path.join(args.out, stem + ".json"), "w") as f:
            json.dump(report, f, indent=1)
        with open(os.path.join(args.out, stem + "_ops.txt"), "w") as f:
            f.write(dev_table + "\n\n")
            f.write(prof.key_averages().table(sort_by="self_cpu_time_total",
                                              row_limit=30))
    print(json.dumps(report, indent=1))
    if not profiled["kernels_per_step"]:
        print("profile_train: the profiler recorded no device time")
    print(dev_table)
    print("flash launches per profiled step: " + ", ".join(
        f"{n} {getattr(fa, n) / psteps}" for n in counters
        if getattr(fa, n)))


if __name__ == "__main__":
    main()
