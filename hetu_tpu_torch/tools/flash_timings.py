"""Time the flash training kernels of one tree of the repository on the card.

Builds the flash sources of the ``hetu_tpu_torch`` package found under
``--root`` (default: this file's tree) and times its forward, dQ and
dK/dV wrappers at the training paths' shapes (D = 64): BERT's key mask
(B=16, H=12, S=512, ``synthetic_mlm_batch``'s lengths as a key mask),
GPT-2's causal (B=8, S=1024), the same causal with the varlen path's
lengths as a key mask, T5's encoder bias (B=32, H=8, S=512, group ``h``,
its padded key mask), decoder bias (causal, S=114) and cross-attention
(114 queries, 512 keys, the padded key mask), XLNet's content stream
(B=8, S=512, mask group ``b``, bias group ``h``) and Longformer's window
(B=2, S=4096, group ``one``), float32 and bf16.  Where the tree's wrappers take ``lengths``
it also times the two varlen shapes with ``lengths`` in place of the key
mask: the same visible pairs through the ``lengths`` specialization.
It also times the decode kernel (``flash_fwd``, the ``lengths``
specialization at one query row, D = 64, H = 12) at the kernels line's
shape (B=8, a 1024-row cache, every row full) and at the (batch bucket,
cache bucket, lengths) shapes that ``chip_smoke.py``'s phase 3 gave it
(``DECODE_SHAPES``, recorded from a phase 3 run on the card), with the
split plan where the tree has one; ``--decode`` times those alone and
builds only ``csrc/flash_attention.cu``.
Each time is the median of ``--iters`` CUDA-event timings with the L2
cache flushed before each launch: by filling a 512 MB buffer (``--flush
fill``, the repository's convention, which leaves the L2 full of dirty
lines that the timed kernel's reads must write back) or by reading it
(``--flush read``: clean lines).  It prints one JSON object: the card,
the build's seconds, each kernel instantiation's registers and spilled
bytes as ``ptxas`` reports them (when the call built the sources) and
``{case: {fwd, dq, dkv}}`` in ms, and ``decode``: ``{case: {ms,
n_split}}``.

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


#: the decode kernel's shapes: (name, batch, cache rows, lengths); the
#: kernels line's, then the (batch bucket, cache bucket) pairs of a phase 3
#: run of chip_smoke.py, each at the lengths of its last call there (768,
#: 768, 1,536 and 900 of the run's 3,972 calls; "NVIDIA H100 80GB HBM3,
#: 700.00 W")
DECODE_SHAPES = [("kernels line", 8, 1024, [1024] * 8),
                 ("phase 3", 8, 64, [64] * 8),
                 ("phase 3", 8, 128, [128, 128, 1, 128, 128, 128, 128, 128]),
                 ("phase 3", 8, 256, [256, 256, 1, 256, 1, 1, 1, 1]),
                 ("phase 3", 8, 384, [331, 1, 1, 1, 1, 1, 1, 1])]


def time_ms(fn, flush, iters):
    """Median device time of ``fn`` in ms, each run after ``flush`` (this
    file's own, so both trees of a comparison are timed by one code)."""
    import numpy as np
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _decode_times(fa, flush, iters):
    """{case: {ms, n_split}} of ``fa.flash_fwd`` at ``DECODE_SHAPES``."""
    import numpy as np
    import torch
    rng = np.random.RandomState(0)
    plan = getattr(fa, "decode_split_plan", None)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for name, b, s_kv, lens in DECODE_SHAPES:
        q, k, v = (torch.from_numpy(rng.randn(b * 12, n, 64).astype(
            np.float32)).cuda() for n in (1, s_kv, s_kv))
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        out[f"{name} B={b} L={s_kv}"] = {
            "ms": time_ms(lambda: fa.flash_fwd(q, k, v, lengths, 12, 0.125),
                          flush, iters),
            "n_split": plan(b * 12, 1, s_kv, sms)[0] if plan else 1}
    return out


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
    ap.add_argument("--decode", action="store_true",
                    help="time the decode kernel alone")
    ap.add_argument("--flush", choices=("fill", "read"), default="fill",
                    help="the L2 flush before each launch: fill a 512 MB "
                    "buffer (the L2 left dirty) or read it (left clean)")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.ops.kernels import _build
    from hetu_tpu_torch.ops.kernels import flash_attention as fa
    if not fa.__file__.startswith(root + os.sep):
        raise SystemExit(f"flash_timings: imported {fa.__file__}, not the "
                         f"tree at {root}")
    if not torch.cuda.is_available():
        raise SystemExit("flash_timings: needs a CUDA card")
    t0 = time.perf_counter()
    built = _build.build(["flash_attention"] if args.decode else
                         [s for s in _build.sources()
                          if s.startswith("flash")])
    build_s = time.perf_counter() - t0
    takes_lengths = "lengths" in inspect.signature(
        fa.flash_fwd_masked).parameters
    # 512 MB: the fill or read (about 0.17 ms) outlasts the host's work in
    # a wrapper, so the host's enqueue never shows in a kernel's time
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.float32, device="cuda")
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

    # (name, B, H, S_q, options: S_kv when it differs)
    cases = [("bert key mask", 16, 12, 512, dict(km=keys(blens, 512))),
             ("gpt2 causal", 8, 12, 1024, dict(causal=True)),
             ("gpt2 causal key mask", 8, 12, 1024,
              dict(causal=True, km=keys(glens, 1024))),
             ("t5 encoder bias", 32, 8, 512,
              dict(km=torch.from_numpy(t5km).cuda(), bgmode="h",
                   bias=lambda: t(8, 512, 512, dtype=torch.float32))),
             ("t5 decoder bias causal", 32, 8, 114,
              dict(causal=True, bgmode="h",
                   bias=lambda: t(8, 114, 114, dtype=torch.float32))),
             ("t5 cross key mask", 32, 8, 114,
              dict(km=torch.from_numpy(t5km).cuda(), s_kv=512)),
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
    flush = flush_buf.zero_ if args.flush == "fill" else flush_buf.sum
    decode = _decode_times(fa, flush, args.iters)
    out = {}
    for dtype in () if args.decode else (torch.float32, torch.bfloat16):
        for name, b, h, s, o in cases:
            bh, s_kv = b * h, o.get("s_kv", s)
            q, do = (t(bh, s, 64, dtype=dtype) for _ in range(2))
            k, v = (t(bh, s_kv, 64, dtype=dtype) for _ in range(2))
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
            out[tag] = {kk: time_ms(fn, flush, args.iters)
                        for kk, fn in (("fwd", fwd), ("dq", dq),
                                       ("dkv", dkv))}
            del q, k, v, do, bias, res, lse, delta
            torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"root": root, "card": card, "flush": args.flush,
                      "build_s": build_s,
                      "build_s_per_source": {n: sec for n, (sec, _)
                                             in built.items()},
                      "ptxas": {n: _ptxas(log) for n, (_, log)
                                in built.items()},
                      "ms": out, "decode": decode}))


if __name__ == "__main__":
    main()
