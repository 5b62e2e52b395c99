"""Time the flash training kernels of one tree of the repository on the card.

Builds the flash sources of the ``hetu_tpu_torch`` package found under
``--root`` (default: this file's tree) and times its forward, dQ and
dK/dV wrappers at the training paths' shapes (D = 64): BERT's key mask
(B=16, H=12, S=512, ``synthetic_mlm_batch``'s lengths as a key mask),
GPT-2's causal (B=8, S=1024), the same causal with the varlen path's
lengths as a key mask, T5's encoder bias (B=32, H=8, S=512, group ``h``,
its padded key mask), XLNet's content stream (B=8, S=512, mask group
``b``, bias group ``h``) and Longformer's window (B=2, S=4096, group
``one``), float32 and bf16.  Where the tree's wrappers take ``lengths``
it also times the two varlen shapes with ``lengths`` in place of the key
mask: the same visible pairs through the ``lengths`` specialization.
Each time is the median of ``--iters`` CUDA-event timings with the L2
cache flushed before each launch.  It prints one JSON object: the card,
the build's seconds, each kernel instantiation's registers and spilled
bytes as ``ptxas`` reports them (when the call built the sources) and
``{case: {fwd, dq, dkv}}`` in ms.

Comparing two trees takes one call on one card, in turns::

    python3 hetu_tpu_torch/tools/flash_timings.py --root PARENT
    python3 hetu_tpu_torch/tools/flash_timings.py
    python3 hetu_tpu_torch/tools/flash_timings.py
    python3 hetu_tpu_torch/tools/flash_timings.py --root PARENT

Run it as a file, not with ``-m``: it imports the package of ``--root``.
"""
import argparse
import inspect
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: one kernel in ptxas's report: its mangled name, spill stores and loads,
#: registers
_PTXAS = re.compile(
    r"Compiling entry function '(\S+)' for 'sm_90a'\n.*?\n\s+\d+ bytes "
    r"stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads\n"
    r"ptxas info\s+: Used (\d+) registers")


def _ptxas(log):
    """{``kernel<template args>``: [registers, spill stores, spill loads]}
    from one source's ptxas report."""
    out = {}
    for name, st, ld, regs in _PTXAS.findall(log):
        m = re.search(r"\d(flash_\w+?_kernel)I(.*)EEv", name)
        key = name if m is None else "{}<{}>".format(
            m.group(1), ",".join(re.findall(r"L[ib](\d+)E", m.group(2))))
        out[key] = [int(regs), int(st), int(ld)]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="the repository tree whose package is timed")
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.ops.kernels import _build
    from hetu_tpu_torch.ops.kernels import flash_attention as fa
    from hetu_tpu_torch.tools.kernel_variants import time_ms
    if not fa.__file__.startswith(root + os.sep):
        raise SystemExit(f"flash_timings: imported {fa.__file__}, not the "
                         f"tree at {root}")
    if not torch.cuda.is_available():
        raise SystemExit("flash_timings: needs a CUDA card")
    t0 = time.perf_counter()
    built = _build.build([s for s in _build.sources()
                          if s.startswith("flash")])
    build_s = time.perf_counter() - t0
    takes_lengths = "lengths" in inspect.signature(
        fa.flash_fwd_masked).parameters
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    rng = np.random.RandomState(0)

    def t(*shape, dtype):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            "cuda", dtype)

    def keys(lens, s):
        return torch.from_numpy((np.arange(s)[None, :] < np.asarray(
            lens)[:, None]).astype(np.int32)).cuda()

    bcfg = ht.BertConfig.base(batch_size=16, seq_len=512)
    blens = ht.synthetic_mlm_batch(bcfg, seed=0)[3].sum(1)
    glens = np.random.RandomState(0).randint(256, 1025, 8)
    glens[0] = 1024
    t5 = ht.T5Config.small(batch_size=32, src_len=512, tgt_len=114)
    t5km = np.ascontiguousarray(
        ht.synthetic_seq2seq_batch(t5, seed=0, padded=True)[3], np.int32)
    xcfg = ht.XLNetConfig.base(batch_size=8, seq_len=512)
    cmask = ht.synthetic_plm_batch(xcfg, seed=0)[1][:, 0]
    wmask = ht.longformer_attention_mask(4096, 512, 1)[None]

    def u8(m):
        return torch.from_numpy(np.ascontiguousarray(m != 0, np.uint8)).cuda()

    # (name, B, H, S, options)
    cases = [("bert key mask", 16, 12, 512, dict(km=keys(blens, 512))),
             ("gpt2 causal", 8, 12, 1024, dict(causal=True)),
             ("gpt2 causal key mask", 8, 12, 1024,
              dict(causal=True, km=keys(glens, 1024))),
             ("t5 encoder bias", 32, 8, 512,
              dict(km=torch.from_numpy(t5km).cuda(), bgmode="h",
                   bias=lambda: t(8, 512, 512, dtype=torch.float32))),
             ("xlnet mask bias", 8, 12, 512,
              dict(mask=u8(cmask), gmode="b", bgmode="h",
                   bias=lambda: t(12, 512, 512, dtype=torch.float32))),
             ("longformer mask", 2, 12, 4096,
              dict(mask=u8(wmask), gmode="one"))]
    if takes_lengths:
        cases += [("bert lengths", 16, 12, 512,
                   dict(lengths=torch.from_numpy(blens.astype(np.int32))
                        .cuda())),
                  ("gpt2 causal lengths", 8, 12, 1024,
                   dict(causal=True, lengths=torch.from_numpy(
                       glens.astype(np.int32)).cuda()))]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, b, h, s, o in cases:
            bh = b * h
            q, k, v, do = (t(bh, s, 64, dtype=dtype) for _ in range(4))
            km, mask, causal = o.get("km"), o.get("mask"), o.get("causal",
                                                                  False)
            bias = o["bias"]() if "bias" in o else None
            lw = {"lengths": o["lengths"]} if "lengths" in o else {}
            scale = 0.125
            if mask is not None:
                kw = dict(causal=causal, bias=bias, bgmode=o.get("bgmode",
                                                                 "bh"), **lw)
                fwd = (lambda: fa.flash_fwd_fullmask(
                    q, k, v, mask, o["gmode"], h, scale, key_mask=km, **kw))
                res, lse = fwd()
                delta = (do.float() * res.float()).sum(-1)
                margs = (q, k, v, km, mask, o["gmode"], h, do, lse, delta,
                         scale)
                dq = (lambda: fa.flash_bwd_dq_mask(*margs, **kw))
                dkv = (lambda: fa.flash_bwd_dkv_mask(*margs, **kw))
            elif bias is not None:
                fwd = (lambda: fa.flash_fwd_bias(q, k, v, km, bias, None,
                                                 o["bgmode"], h, scale,
                                                 causal=causal, **lw))
                res, lse = fwd()
                delta = (do.float() * res.float()).sum(-1)
                bargs = (q, k, v, km, bias, None, o["bgmode"], h, do, lse,
                         delta, scale)
                dq = (lambda: fa.flash_bwd_dq_bias(*bargs, causal=causal,
                                                   **lw))
                dkv = (lambda: fa.flash_bwd_dkv_bias(*bargs, causal=causal,
                                                     **lw))
            else:
                fwd = (lambda: fa.flash_fwd_masked(q, k, v, km, scale,
                                                   causal=causal, **lw))
                res, lse = fwd()
                delta = (do.float() * res.float()).sum(-1)
                dq = (lambda: fa.flash_bwd_dq(q, k, v, km, do, lse, delta,
                                              scale, causal=causal, **lw))
                dkv = (lambda: fa.flash_bwd_dkv(q, k, v, km, do, lse, delta,
                                                scale, causal=causal, **lw))
            tag = name + (" bf16" if dtype == torch.bfloat16 else " f32")
            out[tag] = {kk: time_ms(fn, flush_buf.zero_, args.iters)
                        for kk, fn in (("fwd", fwd), ("dq", dq),
                                       ("dkv", dkv))}
            del q, k, v, do, bias, res, lse, delta
            torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"root": root, "card": card, "build_s": build_s,
                      "build_s_per_source": {n: sec for n, (sec, _)
                                             in built.items()},
                      "ptxas": {n: _ptxas(log) for n, (_, log)
                                in built.items()},
                      "ms": out}))


if __name__ == "__main__":
    main()
