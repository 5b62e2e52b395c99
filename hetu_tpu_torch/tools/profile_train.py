"""Where the time of a BERT-base, GPT-2 small, T5-small, XLNet-base,
Longformer-base or padding-masked (``sdpa_varlen_op``) training step goes,
on the card.

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
kernels; ``--model varlen-bert`` and ``--model varlen-gpt2``
(:func:`varlen_graph`): L = 12 pre-norm attention blocks at BERT-base's
and GPT-2 small's attention widths (hidden 768, 12 heads of 64),
``x = x + o(sdpa_varlen_op(q(LN x), k(LN x), v(LN x), lens))`` and the
loss ``mean((x - y)^2)`` on seeded float feeds, BERT's at seq 512, batch
16, not causal, the lengths of ``synthetic_mlm_batch``'s rule (35 % of
rows full, the rest uniform over [128, 512], seed 0), GPT-2's at seq
1024, batch 8, causal, lengths uniform over [256, 1024] from seed 0 with
one row full: the training kernels' ``lengths`` specialization;
``--model resnet18`` bench.py's ResNet-18 / CIFAR10 step
(:func:`resnet18_step`: batch 128, 3x32x32 ``rand`` inputs, one-hot
labels of 10 classes, NCHW, ``MomentumOptimizer(0.1)``, cuDNN's
autotuner on: ``CUDNN_BENCHMARK``), whose report splits the device time
by kernel family (:func:`resnet_families`: convolution forward, dgrad
and wgrad, BatchNorm, ReLU and add, pooling, the head, the Momentum
update; the convolutions also timed apart, :func:`conv_apart_ms`) and
gives the step's FLOPs from the graph's convolution and
linear shapes (:func:`graph_flops`).  All but ResNet:
seeded random weights, fp32 (with ``--compute-dtype
bfloat16``: bf16 mixed precision, the bf16 flash kernels; ``--batch``
sets the batch: bench.py's flagship is ``--model bert --compute-dtype
bfloat16 --batch 64``), dropout 0.1, the one batch fed every step,
``AdamOptimizer(1e-4)`` through ``Executor.run``.  Reports per step: host wall time without
the profiler, then under ``torch.profiler`` the device busy time (sum of
kernel durations on the one stream), the device's idle share, kernel
launches, the kernels that take the most device time, the share of the
three flash attention kernels and of the matrix products, and each flash
entry's launches and device time by its name in ``chip_smoke.py``'s
``kernels`` line (``flash_fwd_mask_bias_bf16``: the counter
``bf16_fwd_mask_bias_launches``).  Run from the repository root::

    python3 -m hetu_tpu_torch.tools.profile_train
        [--model bert|gpt2|t5|xlnet|longformer|varlen-bert|varlen-gpt2|
                 resnet18]
        [--compute-dtype bfloat16] [--batch N] [--out DIR] [--steps N]

``--out`` receives ``profile_train[_<model>][_bf16].json`` (no model
suffix for bert) and the operator tables.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
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
          "xlnet": (8, 512), "longformer": (2, 4096),
          "varlen-bert": (16, 512), "varlen-gpt2": (8, 1024),
          "resnet18": (128, None)}
#: cuDNN's autotuner (``torch.backends.cudnn.benchmark``) for the ResNet
#: step: on, in this tool and in ``chip_smoke.py``'s ResNet phases
CUDNN_BENCHMARK = True
#: the varlen graphs' widths (BERT-base's and GPT-2 small's attention) and
#: depth (both models' published 12 layers)
VARLEN_HIDDEN, VARLEN_HEADS, VARLEN_LAYERS = 768, 12, 12
# the kernels' names in a trace (the float32 SIMT ones, then the bf16
# tensor-core ones); the causal, mask and bias instantiations share them
FLASH = {"flash_fwd_kernel": "fwd", "flash_bwd_dq_kernel": "dq",
         "flash_bwd_dkv_kernel": "dkv", "flash_fwd_mma_kernel": "fwd",
         "flash_dq_mma_kernel": "dq", "flash_dkv_mma_kernel": "dkv"}


#: a flash training kernel in a trace; its last four template arguments
#: are (CAUSAL, FMASK, BIAS, KBIAS) in every source
_FLASH_KERNEL = re.compile(
    r"(flash_fwd|flash_bwd_dq|flash_bwd_dkv|flash_dq|flash_dkv)(_mma)?"
    r"_kernel<([^>]*)>")


def line_name(counter):
    """The kernels-line name of a flash launch counter
    (``dq_mask_bias_launches`` -> ``flash_bwd_dq_mask_bias``,
    ``bf16_fwd_causal_launches`` -> ``flash_fwd_causal_bf16``)."""
    if counter.startswith("bf16_"):
        return line_name(counter[len("bf16_"):]) + "_bf16"
    kind, _, rest = counter[:-len("_launches")].partition("_")
    return ("flash_fwd" if kind == "fwd" else f"flash_bwd_{kind}") \
        + ("_" + rest if rest else "")


def kernel_counter(kernel, lengths=False):
    """The launch counter of ``ops/kernels/flash_attention.py`` that counts
    the trace's kernel ``kernel`` (``bf16_dq_mask_bias_launches``), from
    its template arguments; None for any other kernel.  The tensor-core
    (``_mma``) kernels are the bf16 ones.  ``lengths`` is an argument, not
    a template flag: with ``lengths=True`` (a run whose every flash call
    takes it) the counter is the ``_len`` one."""
    m = _FLASH_KERNEL.search(kernel)
    if m is None:
        return None
    kind = m.group(1).rsplit("_", 1)[-1]
    args = [a.strip() for a in m.group(3).split(",")]
    causal, fmask, bias, kbias = (a in ("true", "1", "(bool)1")
                                  for a in args[-4:])
    if fmask:
        rest = "mask" + ("_bias" if bias else "_kbias" if kbias else "")
    elif bias:
        rest = "bias_causal" if causal else "bias"
    elif kbias:
        rest = "kbias"
    else:
        rest = "causal" if causal else ""
    bf16 = m.group(2) is not None or "bfloat16" in m.group(3)
    return ("bf16_" if bf16 else "") + kind + ("_" + rest if rest else "") \
        + ("_len" if lengths else "") + "_launches"


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _is_gemm(name):
    n = name.lower()
    return ("gemm" in n or "sgemm" in n or "cutlass" in n or "xmma" in n
            or "nvjet" in n)                # cuBLAS's Hopper bf16 kernels


def varlen_graph(batch, seq, causal, n_layer=VARLEN_LAYERS,
                 hidden=VARLEN_HIDDEN, heads=VARLEN_HEADS):
    """The padding-masked attention graph: float feeds ``x`` and ``y``
    (B·S, hidden) and the int32 feed ``lens`` (B,); each of ``n_layer``
    layers ``x = x + o(attn(LayerNorm(x)))``, with q, k, v ``Linear``
    layers reshaped to (B, S, heads, hidden / heads), transposed to
    (B, heads, S, hidden / heads), ``sdpa_varlen_op(q, k, v, lens,
    causal=causal)`` and the way back; the loss ``mean((x - y)^2)``.
    Variables ``layer<i>.ln``, ``.q``, ``.k``, ``.v``, ``.o``: the JAX
    package builds the same graph from the same ops and layers, so weights
    carry by name.  Returns ({name: placeholder}, loss)."""
    x = ht.placeholder_op("x", shape=(batch * seq, hidden))
    y = ht.placeholder_op("y", shape=(batch * seq, hidden))
    lens = ht.placeholder_op("lens", shape=(batch,), dtype=np.int32)
    dk = hidden // heads

    def split(t):
        t = ht.array_reshape_op(t, output_shape=(batch, seq, heads, dk))
        return ht.transpose_op(t, perm=(0, 2, 1, 3))

    h = x
    for i in range(n_layer):
        a = ht.layers.LayerNorm(hidden, name=f"layer{i}.ln")(h)
        q, k, v = (split(ht.layers.Linear(hidden, hidden,
                                          name=f"layer{i}.{n}")(a))
                   for n in "qkv")
        o = ht.ops.sdpa_varlen_op(q, k, v, lens, causal=causal)
        o = ht.transpose_op(o, perm=(0, 2, 1, 3))
        o = ht.array_reshape_op(o, output_shape=(batch * seq, hidden))
        h = h + ht.layers.Linear(hidden, hidden, name=f"layer{i}.o")(o)
    diff = h - y
    loss = ht.reduce_mean_op(ht.mul_op(diff, diff), [0, 1])
    return {"x": x, "y": y, "lens": lens}, loss


def varlen_lengths(model, batch, seq, seed=0):
    """The varlen workloads' lengths (B,) int32: ``varlen-bert``
    ``synthetic_mlm_batch``'s rule (35 % of rows full, the rest uniform over
    [seq / 4, seq]); ``varlen-gpt2`` uniform over [seq / 4, seq] with row
    0 full."""
    if model == "varlen-bert":
        cfg = ht.BertConfig.base(batch_size=batch, seq_len=seq)
        return ht.synthetic_mlm_batch(cfg, seed=seed)[3].sum(1) \
            .astype(np.int32)
    lens = np.random.RandomState(seed).randint(seq // 4, seq + 1, batch)
    lens[0] = seq
    return lens.astype(np.int32)


def varlen_feeds(feeds, lens, hidden=VARLEN_HIDDEN, seed=0):
    """The feed dict of :func:`varlen_graph`: ``x`` and ``y`` standard
    normal from ``seed``, ``lens``."""
    rng = np.random.RandomState(seed)
    rows = feeds["x"].shape[0]
    return {feeds["x"]: rng.randn(rows, hidden).astype(np.float32),
            feeds["y"]: rng.randn(rows, hidden).astype(np.float32),
            feeds["lens"]: np.asarray(lens, np.int32)}


def build(model, device="cuda", compute_dtype=None, batch=None):
    """(executor, feed dict) of ``model``'s training workload, with
    ``compute_dtype`` and, given, ``batch`` instead of the model's."""
    batch = batch or SHAPES[model][0]
    seq = SHAPES[model][1]
    if model == "resnet18":
        ex, fd, _ = resnet18_step(batch, device=device,
                                  compute_dtype=compute_dtype)
        return ex, fd
    if model.startswith("varlen"):
        feeds, loss = varlen_graph(batch, seq, causal=model == "varlen-gpt2")
        fd = varlen_feeds(feeds, varlen_lengths(model, batch, seq))
    elif model == "t5":
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


def resnet18_step(batch=128, data_format="NCHW", compute_dtype=None,
                  device="cuda", loader=None, dist_strategy=None):
    """bench.py's ``build_resnet18_graph`` on the port: ``resnet18`` on x
    (batch, 3, 32, 32) and one-hot y (batch, 10), ``MomentumOptimizer(0.1)``
    through ``Executor(seed=0)``; the feeds as bench.py makes them
    (``RandomState(0)``: ``rand`` inputs, then ``np.eye(10)[randint]``).
    ``loader``: (x, y) arrays fed through ``dataloader_op`` instead (a
    ``Dataloader`` of ``batch`` each, split "train", prefetch on), the
    feed dict then empty.  ``dist_strategy``: the executor's.  Returns
    (executor, feed dict, loss)."""
    if loader is None:
        x = ht.placeholder_op("x", shape=(batch, 3, 32, 32))
        y = ht.placeholder_op("y", shape=(batch, 10))
    else:
        x = ht.dataloader_op([ht.Dataloader(loader[0], batch, "train")])
        y = ht.dataloader_op([ht.Dataloader(loader[1], batch, "train")])
    loss, _ = ht.models.resnet18(x, y, data_format=data_format)
    train_op = ht.optim.MomentumOptimizer(0.1).minimize(loss)
    ex = ht.Executor({"train": [loss, train_op]}, seed=0, device=device,
                     compute_dtype=compute_dtype, dist_strategy=dist_strategy)
    if loader is not None:
        return ex, {}, loss
    rng = np.random.RandomState(0)
    xv = rng.rand(batch, 3, 32, 32).astype(np.float32)
    yv = np.eye(10, dtype=np.float32)[rng.randint(0, 10, batch)]
    return ex, {x: xv, y: yv}, loss


#: the training attention ops and the input index of their mask (None: no
#: mask input)
ATTENTION_MASK_INPUT = {"ScaledDotProductAttention": None,
                        "ScaledDotProductAttentionBias": None,
                        "ScaledDotProductAttentionMasked": 3,
                        "ScaledDotProductAttentionMaskedBias": 3}


def _const_value(node):
    """``node``'s value when it depends only on variables with a value,
    computed on the CPU (a constant mask: BigBird's, Swin's tiled shift
    mask); None when it depends on a feed."""
    from hetu_tpu_torch.graph.executor import lower_forward
    from hetu_tpu_torch.graph.node import LowerCtx
    topo = ht.topo_sort([node])
    leaves = {n: n.get_init_value() for n in topo if not n.inputs
              and getattr(n, "_value", None) is not None}
    if any(not n.inputs and n not in leaves for n in topo):
        return None
    return lower_forward(topo, LowerCtx(False), leaves.__getitem__)[node]


def attention_pairs(q_shape, k_shape, causal=False, mask=None):
    """Visible (row, key) pairs of a (B, H, S_q, D) x (B, H, S_kv, D)
    attention: every pair, less those above the bottom-right diagonal with
    ``causal``, less those a ``mask`` broadcastable to (B, H, S_q, S_kv)
    hides."""
    b, h, s_q, _ = q_shape
    s_kv = k_shape[-2]
    if mask is None and not causal:
        return b * h * s_q * s_kv
    valid = torch.ones((s_q, s_kv), dtype=torch.bool)
    if causal:
        valid = valid.tril(s_kv - s_q)
    if mask is not None:
        valid = valid & (mask != 0)
    return int(valid.expand(b, h, s_q, s_kv).sum())


def graph_flops(loss, feed_shapes):
    """Multiply-adds of one forward of ``loss``'s graph, from its
    convolutions', linear layers' and attention ops' shapes: the graph
    lowered on meta tensors (shapes only, no data), each ``Conv2d``
    counting N * C_out * H_out * W_out * C_in * k_h * k_w, each
    ``Linear`` / ``MatrixMult`` M * N * K, each training attention op 2 *
    D (q·kᵀ and P·V) a visible pair (:func:`attention_pairs`: causal from
    the bottom right, a constant mask on its visible pairs, a fed one on
    every pair).  ``feed_shapes``: {placeholder: shape}.  Returns
    {"conv": MACs, "linear": MACs, "attention": MACs}."""
    from hetu_tpu_torch.graph.executor import lower_forward
    from hetu_tpu_torch.graph.node import LowerCtx
    from hetu_tpu_torch.metrics import suppress_perf_counters
    topo = ht.topo_sort([loss])

    def leaf(node):
        shape = feed_shapes.get(node, node.shape)
        return torch.empty(shape, device="meta")

    # meta tensors: the attention dispatchers take the plain versions,
    # launching and counting nothing
    with suppress_perf_counters():
        env = lower_forward(topo, LowerCtx(False), leaf)
    macs = {"conv": 0, "linear": 0, "attention": 0}
    for node in topo:
        if node.op_type in ("Conv2d", "Conv2dAddBias"):
            w = env[node.inputs[1]].shape          # OIHW in both layouts
            macs["conv"] += env[node].numel() * int(np.prod(w[1:]))
        elif node.op_type in ("Linear", "MatrixMult"):
            a, b = (env[i].shape for i in node.inputs[:2])
            macs["linear"] += int(np.prod(a)) * int(b[-1])
        elif node.op_type in ATTENTION_MASK_INPUT:
            q, k = (env[i].shape for i in node.inputs[:2])
            m_i = ATTENTION_MASK_INPUT[node.op_type]
            mask = None if m_i is None else _const_value(node.inputs[m_i])
            pairs = attention_pairs(q, k, node.attrs.get("causal", False),
                                    mask)
            macs["attention"] += 2 * pairs * int(q[-1])
    return macs


#: the names of the ``record_function`` ranges the tools open
RANGE_LABELS = frozenset({"optimizer"})

#: the ResNet step's kernel families, in report order
RESNET_FAMILIES = ("conv forward", "conv dgrad", "conv wgrad",
                   "conv backward, other", "batchnorm", "relu and add",
                   "pooling", "head", "momentum update", "casts and copies",
                   "other")


def resnet_family(ops, kernel):
    """The family of a device kernel of the ResNet step: ``ops`` names
    the CPU ops it ran under, innermost first (the optimizer's apply is
    labelled ``optimizer``; a backward op's node is ``autograd::engine::
    evaluate_function: <Name>Backward0``), ``kernel`` the kernel's name."""
    chain = " ".join(ops)
    low = kernel.lower()
    if "optimizer" in ops:
        return "momentum update"
    if "ConvolutionBackward" in chain:
        return "conv wgrad" if "wgrad" in low else \
            "conv dgrad" if "dgrad" in low else "conv backward, other"
    if "aten::convolution" in chain or "aten::conv2d" in chain:
        return "conv forward"
    if "batch_norm" in chain or "BatchNorm" in chain or "var_mean" in chain:
        return "batchnorm"
    if "pool" in chain.lower():
        return "pooling"
    if any(k in chain for k in ("relu", "Relu", "threshold_backward",
                                "aten::add", "AddBackward")):
        return "relu and add"
    if any(k in chain for k in ("aten::mm", "aten::matmul", "MmBackward",
                                "softmax", "Softmax", "aten::mean",
                                "aten::sum", "aten::neg", "aten::mul")):
        return "head"
    if any(k in chain for k in ("aten::copy_", "aten::to", "Memcpy")) \
            or "memcpy" in low:
        return "casts and copies"
    return "other"


def label_optimizers(ex):
    """Run each optimizer's ``apply`` of ``ex`` under a profiler range
    named ``optimizer`` (no cost without a profiler), so
    :func:`resnet_families` finds the update's kernels."""
    for op in {n for sub in ex.subexecutors.values() for n in sub.opt_ops}:
        opt = op.optimizer
        if getattr(opt, "_labelled", False):
            continue
        apply = opt.apply

        def labelled(*args, _apply=apply, **kw):
            with torch.profiler.record_function("optimizer"):
                return _apply(*args, **kw)
        opt.apply = labelled
        opt._labelled = True


def resnet_families(prof, psteps):
    """Device ms a step by :data:`RESNET_FAMILIES` from a profile: each
    kernel through the op that launched it (``FunctionEvent.kernels``)
    and that op's parents; ``unattributed`` is the device time of kernels
    the profiler tied to no op (e.g. the feeds' copies)."""
    fam = collections.Counter()
    attributed = 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels \
                or e.name in RANGE_LABELS:
            continue
        ops, p = [], e
        while p is not None:
            ops.append(p.name)
            p = p.cpu_parent
        for k in e.kernels:
            fam[resnet_family(ops, k.name)] += k.duration
            attributed += k.duration
    busy = sum(e.time_range.end - e.time_range.start
               for e in device_kernels(prof))
    out = {name: fam[name] / psteps / 1e3 for name in RESNET_FAMILIES}
    out["unattributed"] = (busy - attributed) / psteps / 1e3
    return out


def device_kernels(prof):
    """The device events of a profile that are kernels or copies: not the
    device-side copy of a ``record_function`` range (such as
    :func:`label_optimizers`' ``optimizer``), which spans kernels already
    counted."""
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and e.name not in RANGE_LABELS:
            yield e


def conv_apart_ms(loss, feed_shapes, compute_dtype=None, iters=10):
    """The step's convolutions run apart on the card, at their shapes,
    layout and dtype, each kind under the profiler: the forward
    (``F.conv2d``), the input gradient (dgrad) and the weight gradient
    (wgrad), each through ``aten.convolution_backward`` asking for that one
    output (a convolution on a feed, the stem, has no dgrad in the step).
    Device time of the kernels a kind launches (cuDNN's layout conversions
    included, as in the step), over ``iters`` passes of the graph's
    convolutions, after two untimed passes in which cuDNN's autotuner
    settles.  The step's trace cannot split a backward whose algorithm
    runs FFTs and GEMMs (kernels named for neither gradient); this can.
    Returns ms a step {"forward", "dgrad", "wgrad"}."""
    from hetu_tpu_torch.graph.executor import lower_forward
    from hetu_tpu_torch.graph.node import LowerCtx, PlaceholderOp
    F = torch.nn.functional
    topo = ht.topo_sort([loss])
    env = lower_forward(topo, LowerCtx(False), lambda n: torch.empty(
        feed_shapes.get(n, n.shape), device="meta"))
    learned = set()                 # nodes that depend on a variable
    for node in topo:
        if (isinstance(node, PlaceholderOp) and node.is_variable) \
                or any(i in learned for i in node.inputs):
            learned.add(node)
    dtype = torch.bfloat16 if compute_dtype else torch.float32
    calls = {"forward": [], "dgrad": [], "wgrad": []}
    for node in topo:
        if node.op_type not in ("Conv2d", "Conv2dAddBias"):
            continue
        stride, padding = (node.attrs.get(k, d) for k, d in
                           (("stride", 1), ("padding", 0)))
        stride = (stride, stride) if isinstance(stride, int) else stride
        padding = (padding, padding) if isinstance(padding, int) \
            else padding
        x = torch.randn(tuple(env[node.inputs[0]].shape), device="cuda",
                        dtype=dtype)
        if node.attrs.get("data_format") == "NHWC":
            x = x.permute(0, 3, 1, 2)
        w = torch.randn(tuple(env[node.inputs[1]].shape), device="cuda",
                        dtype=dtype)
        gy = torch.randn_like(F.conv2d(x, w, None, stride, padding))

        def back(mask, x=x, w=w, gy=gy, stride=stride, padding=padding):
            return torch.ops.aten.convolution_backward(
                gy, x, w, None, stride, padding, (1, 1), False, (0, 0), 1,
                mask)
        calls["forward"].append(
            lambda x=x, w=w, stride=stride, padding=padding:
                F.conv2d(x, w, None, stride, padding))
        if node.inputs[0] in learned:
            calls["dgrad"].append(lambda back=back:
                                  back((True, False, False)))
        calls["wgrad"].append(lambda back=back: back((False, True, False)))
    for _ in range(2):
        for fns in calls.values():
            for fn in fns:
                fn()
    torch.cuda.synchronize()
    out = {}
    for kind, fns in calls.items():
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                for fn in fns:
                    fn()
            torch.cuda.synchronize()
        out[kind] = sum(e.time_range.end - e.time_range.start
                        for e in device_kernels(prof)) / iters / 1e3
    return out


def profile_steps(step, psteps=3, step_s=None, lengths=False):
    """``psteps`` calls of ``step`` (one training step each) under
    ``torch.profiler``: per step the device busy time (sum of kernel
    durations on the one stream), the device's idle share (against the
    profiled wall time and, given ``step_s``, the unprofiled step time:
    the profiler slows the host, not the kernels), kernel launches, the
    three flash kernels' time and share, the matrix products' and the
    kernels that take the most device time; each flash entry under its
    kernels-line name (``lengths``: the ``_len`` entries, for a run whose
    every flash call takes ``lengths``).  Returns (that report, the
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
    for e in device_kernels(prof):
        k = kern[e.name]
        k[0] += 1
        k[1] += e.time_range.end - e.time_range.start
    busy_us = sum(v[1] for v in kern.values())
    n_kern = sum(v[0] for v in kern.values())
    flash = collections.Counter()
    for key, short in FLASH.items():
        flash[short] += sum(v[1] for n, v in kern.items() if key in n)
    entries = collections.defaultdict(lambda: [0, 0.0])
    for n, (c, us) in kern.items():
        counter = kernel_counter(n, lengths)
        if counter is not None:
            entries[line_name(counter)][0] += c
            entries[line_name(counter)][1] += us
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
        "flash_entries": {name: {"launches_per_step": c / psteps,
                                 "ms_per_step": per_step_ms(us)}
                          for name, (c, us) in sorted(entries.items())},
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
    resnet = args.model == "resnet18"
    if resnet:
        torch.backends.cudnn.benchmark = CUDNN_BENCHMARK
    ex, fd = build(args.model, compute_dtype=args.compute_dtype, batch=batch)
    if resnet:
        label_optimizers(ex)

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
    profiled, prof = profile_steps(step, psteps, step_s,
                                   lengths=args.model.startswith("varlen"))
    report = {
        "card": _card(), "torch": torch.__version__, "model": args.model,
        "batch": batch, "seq": seq,
        "compute_dtype": args.compute_dtype or "float32",
        "step_ms_mean": step_s * 1e3,
        "step_ms_all": [t * 1e3 for t in times],
        "samples_per_s": batch / step_s,
        "tokens_per_s": None if seq is None else batch * seq / step_s,
        "tgt_tokens_per_s": (batch * T5_TGT / step_s if args.model == "t5"
                             else None),
        "profiled": profiled,
        "flash_launches_per_profiled_step": {
            line_name(n): getattr(fa, n) / psteps for n in counters
            if getattr(fa, n)},
    }
    if resnet:
        loss = ex.subexecutors["train"].loss_node
        feed_shapes = {n: tuple(np.shape(v)) for n, v in fd.items()}
        macs = graph_flops(loss, feed_shapes)
        step_flops = 3 * 2 * (macs["conv"] + macs["linear"])
        peak = 989e12 if args.compute_dtype else 67e12
        report.update({
            "cudnn_benchmark": torch.backends.cudnn.benchmark,
            "forward_macs": macs, "step_tflop": step_flops / 1e12,
            "mfu": step_flops / step_s / peak,
            "mfu_peak_tflops": peak / 1e12,
            "families_ms_per_step": resnet_families(prof, psteps),
            "conv_apart_ms_per_step": conv_apart_ms(
                loss, feed_shapes, args.compute_dtype)})
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


if __name__ == "__main__":
    main()
