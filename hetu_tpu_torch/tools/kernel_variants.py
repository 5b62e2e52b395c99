"""Time one kernel against builds of itself with one choice changed, on the
card: the evidence behind a design choice that no single build can show.

``fwd``: the float32 training forward (``csrc/flash_attention.cu``) built
three ways, the launcher's rule for 32-row CTAs as written, always 64-row
CTAs and always 32-row ones, each launched directly (a full mask's tile
map built beforehand), beside the tile map's own time and the wrapper's,
at the paths' small and large grids.  ``segsum``: the sorted segment-sum
(``csrc/segment_sum.cu``) as written, with its long-run CTAs returning at
once, with its short-run threads returning at once, and with both (the
last three give wrong sums: they time one part alone, or the launch and
the long-run CTAs' first id loads), at the CTR plan's shape (the ids of
one WDL batch, ``synthetic_criteo_skewed(8 * 2048, vocab=100000,
seed=0)``'s second, width 16), beside ``index_add_`` and the wrapper.
Every time is the median of 50 CUDA-event timings, each launch after an
L2 flush.  Run from the repository root::

    python3 -m hetu_tpu_torch.tools.kernel_variants fwd|segsum

The modified sources and libraries go to ``hetu_tpu_torch/_build/variants``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import numpy as np
import torch

import hetu_tpu_torch as ht
from hetu_tpu_torch.ops.kernels import _build
from hetu_tpu_torch.ops.kernels import flash_attention as fa
from hetu_tpu_torch.ops.kernels import segment_sum as seg
from hetu_tpu_torch.ps.dist_store import _segment_sum

VARIANT_DIR = os.path.join(_build.BUILD_DIR, "variants")


def time_ms(fn, flush, iters=50):
    """Median device time of ``fn`` in ms, each run after ``flush``."""
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


def build_variants(source, edits):
    """``{name: ctypes library}``: ``csrc/<source>.cu`` with each name's
    (old, new) text replacements, one nvcc each, all started together."""
    os.makedirs(VARIANT_DIR, exist_ok=True)
    text = open(_build.source_path(source)).read()
    procs = {}
    for name, pairs in edits.items():
        body = text
        for old, new in pairs:
            if old not in body:
                raise SystemExit(f"kernel_variants: {old!r} is not in {source}.cu")
            body = body.replace(old, new)
        path = os.path.join(VARIANT_DIR, f"{source}_{name}.cu")
        with open(path, "w") as f:
            f.write(body)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-o",
             path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=_build.NVCC_TIMEOUT)
        if proc.returncode:
            raise SystemExit(f"kernel_variants: {name} failed to build\n{log}")
        libs[name] = ctypes.CDLL(os.path.join(VARIANT_DIR,
                                              f"{source}_{name}.so"))
    return libs


def _entry(lib, name):
    fn = getattr(lib, name)
    _, n_ptr, n_int = fa.ENTRIES[name]
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def forward_variants(flush):
    rule = "constexpr int WAVE_CTAS = 2;"
    libs = build_variants("flash_attention", {
        "as_written": [],
        "always64": [(rule, "constexpr int WAVE_CTAS = 0;")],
        "always32": [(rule, "constexpr int WAVE_CTAS = 1 << 20;")]})
    rng = np.random.RandomState(0)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda()

    def km_of(s, lens):
        return torch.from_numpy((np.arange(s)[None, :] < np.asarray(
            lens)[:, None]).astype(np.int32)).cuda()

    pos = rng.randint(0, 481, size=8)
    prefill = (np.arange(512)[None, None, :] < (
        pos[:, None] + 1 + np.arange(32)[None, :])[:, :, None])
    # (name, B, H, S_q, S_kv, options)
    cases = [
        ("BERT key mask B4 S512", 4, 12, 512, 512,
         dict(km=km_of(512, [512, 467, 512, 0]))),
        ("BERT dense B4 S512", 4, 12, 512, 512, {}),
        ("BERT key mask B16 S512", 16, 12, 512, 512,
         dict(km=km_of(512, rng.randint(100, 513, 16)))),
        ("ragged B4 S200", 4, 12, 200, 200,
         dict(km=km_of(200, [200, 77, 1, 150]))),
        ("T5 cross B32 H8 114x512", 32, 8, 114, 512,
         dict(km=km_of(512, rng.randint(200, 513, 32)))),
        ("GPT-2 causal B8 S1024", 8, 12, 1024, 1024, dict(causal=True)),
        ("prefill B8 C32 L512", 8, 12, 32, 512,
         dict(mask=torch.from_numpy(prefill.astype(np.uint8)).cuda(),
              gmode="b")),
        ("T5 decoder bias causal B32 H8 S114", 32, 8, 114, 114,
         dict(causal=True, bias=t(8, 114, 114), bgmode="h")),
        ("T5 encoder bias B32 H8 S512", 32, 8, 512, 512,
         dict(km=km_of(512, rng.randint(200, 513, 32)), bias=t(8, 512, 512),
              bgmode="h")),
        ("Longformer B2 S4096", 2, 12, 4096, 4096,
         dict(mask=torch.from_numpy(np.ascontiguousarray(
             ht.longformer_attention_mask(4096, 512, 1)[None] != 0,
             np.uint8)).cuda(), gmode="one"))]
    stream = torch.cuda.current_stream().cuda_stream
    for name, b, h, s_q, s_kv, kw in cases:
        bh, d, scale = b * h, 64, 0.125
        q, k, v = t(bh, s_q, d), t(bh, s_kv, d), t(bh, s_kv, d)
        km, mask, bias = kw.get("km"), kw.get("mask"), kw.get("bias")
        causal = kw.get("causal", False)
        gmode, bgmode = kw.get("gmode", "bh"), kw.get("bgmode", "bh")
        out = torch.empty_like(q)
        lse = torch.empty(bh, s_q, device="cuda")
        mt = fa.tile_maps(mask=mask)[1]
        head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), fa._ptr(km),
                None)                                   # no lengths
        if mask is not None:
            entry = "hetu_flash_fwd_mask"
            args = head + (mask.data_ptr(), mt.data_ptr(), None,
                           out.data_ptr(), lse.data_ptr(), bh, h, s_q, s_kv,
                           d, fa.GMODES.index(gmode), 0, 0, int(causal))
        elif bias is not None:
            entry = "hetu_flash_fwd_bias"
            args = head + (bias.data_ptr(), out.data_ptr(), lse.data_ptr(),
                           bh, h, s_q, s_kv, d, fa.GMODES.index(bgmode), 0,
                           int(causal))
        else:
            entry = "hetu_flash_fwd_causal" if causal else "hetu_flash_fwd"
            args = head + (out.data_ptr(), lse.data_ptr(), bh, h, s_q, s_kv,
                           d)
        args = args + (scale, stream)
        ref, lse_ref = fa.flash_fwd_plain(q, k, v, None, h, scale,
                                          key_mask=km, causal=causal,
                                          mask=mask, gmode=gmode, bias=bias,
                                          bgmode=bgmode)
        row = {}
        for vname, lib in libs.items():
            fn = _entry(lib, entry)
            if fn(*args) != 0:
                raise SystemExit(f"kernel_variants: {vname} did not launch")
            torch.cuda.synchronize()
            err = max(float((out - ref).abs().max()),
                      float((lse - lse_ref).abs().max()))
            row[vname] = {"ms": time_ms(lambda: fn(*args), flush),
                          "max_abs_err": err}
        row["tile_map_ms"] = (time_ms(lambda: fa.tile_maps(mask=mask), flush)
                              if mask is not None else 0.0)
        if mask is not None:
            def wrap():
                return fa.flash_fwd_fullmask(q, k, v, mask, gmode, h, scale,
                                             key_mask=km, causal=causal)
        elif bias is not None:
            def wrap():
                return fa.flash_fwd_bias(q, k, v, km, bias, None, bgmode, h,
                                         scale, causal=causal)
        else:
            def wrap():
                return fa.flash_fwd_masked(q, k, v, km, scale, causal=causal)
        row["wrapper_ms"] = time_ms(wrap, flush)
        walk = fa.walked_tiles(bh, h, s_q, s_kv, key_mask=km, causal=causal,
                               mask=mask, gmode=gmode)
        row["walked_tiles"], row["tiles"] = int(walk.sum()), walk.numel()
        print(f"[kernel-variants] fwd {name}: {json.dumps(row)}", flush=True)


def segsum_variants(flush):
    long_hook = "  if (count == 0) return;  // uniform\n"
    short_hook = "  constexpr int W = sizeof(V) / sizeof(float);\n"
    quit_long = (long_hook, "  return;\n" + long_hook)
    quit_short = (short_hook, "  return;\n" + short_hook)
    libs = build_variants("segment_sum", {
        "as_written": [], "no_long_runs": [quit_long],
        "no_short_runs": [quit_short], "neither": [quit_long, quit_short]})
    _, sparse, _ = ht.synthetic_criteo_skewed(8 * 2048, vocab=100000, seed=0)
    ids = sparse[2048:2 * 2048].ravel()
    _, inv, cnt = np.unique(ids, return_inverse=True, return_counts=True)
    n, w = inv.size, 16
    g = (np.random.RandomState(0).randn(n, w) * 1e-4).astype(np.float32)
    order = np.argsort(inv, kind="stable")
    rows = torch.from_numpy(g[order]).cuda()
    segs = torch.from_numpy(inv[order].astype(np.int32)).cuda()
    host = _segment_sum(g, inv, cnt)
    stream = torch.cuda.current_stream().cuda_stream
    report = {"n": n, "segments": int(cnt.size), "longest_run": int(cnt.max())}
    for name, lib in libs.items():
        fn = lib.hetu_segment_sum
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = torch.zeros(n, w, device="cuda")

        def call():
            return fn(rows.data_ptr(), segs.data_ptr(), out.data_ptr(), n, w,
                      n, stream)

        if call() != 0:
            raise SystemExit(f"kernel_variants: {name} did not launch")
        torch.cuda.synchronize()
        report[name] = {"ms": time_ms(call, flush),
                        "equal_to_host": bool(np.array_equal(
                            out.cpu().numpy()[:cnt.size], host))}
    seg64 = segs.long()
    zeros = torch.zeros(n, w, device="cuda")
    report["index_add_ms"] = time_ms(
        lambda: zeros.index_add_(0, seg64, rows), flush)
    report["wrapper_ms"] = time_ms(
        lambda: seg.sorted_segment_sum(rows, segs, n), flush)
    print(f"[kernel-variants] segsum {json.dumps(report)}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", choices=["fwd", "segsum"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(64 * 2 ** 20, device="cuda").zero_
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    if args.which == "fwd":
        forward_variants(flush)
    else:
        segsum_variants(flush)


if __name__ == "__main__":
    main()
