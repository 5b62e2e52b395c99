"""Where the time of a GPT-2 small decode run goes, on the card.

Serves the same workload as ``chip_smoke.py`` (GPT-2 small at published
widths, seeded random weights, fp32; 8 seeded prompts of 8-300 tokens,
32 new tokens each) by stepping a ``DecodeEngine`` in this thread under
``torch.profiler``, and reports per engine step: host wall time (also
through ``DecodeRouter``, as chip_smoke.py serves it), device
busy time (sum of kernel durations on the one stream), the device's idle
share, kernel launches, and the kernels and host operators that take the
most time.  ``--chunked`` gives the engine the chunked-prefill entry
(``gpt2_decode_chunked_graph``, chunks of up to 32 tokens through the
full-mask flash kernel) and also reports the prefill counters.  Run from
the repository root::

    python3 -m hetu_tpu_torch.tools.profile_decode [--chunked] [--out DIR]

``--out`` receives ``profile_decode[_chunked].json`` and the two operator
tables.
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
from hetu_tpu_torch import metrics
from hetu_tpu_torch.ops.kernels import flash_attention as fa
from hetu_tpu_torch.serving.decode import _DecodeRequest

N_REQUESTS, MAX_NEW = 8, 32
PROMPT_RANGE = (8, 300)


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _prompts(vocab):
    rng = np.random.RandomState(1)
    plens = rng.randint(PROMPT_RANGE[0], PROMPT_RANGE[1] + 1, size=N_REQUESTS)
    plens[0] = PROMPT_RANGE[1]
    return [rng.randint(0, vocab, size=n) for n in plens]


def _serve(engine, prompts):
    """Seat every prompt and step until all finish; returns step count."""
    reqs = [_DecodeRequest(np.asarray(p, np.int32), MAX_NEW, None)
            for p in prompts]
    for r in reqs:
        engine.join(r)
    steps = 0
    while not engine.idle:
        engine.step()
        steps += 1
    for r in reqs:
        assert len(r.stream.result(timeout=1)) == MAX_NEW
    return steps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for the JSON report and tables")
    ap.add_argument("--chunked", action="store_true",
                    help="ingest prompts through the chunked-prefill entry")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ht.GPT2Config.small()
    feeds, logits, caches, _ = ht.gpt2_decode_graph(cfg, max_len=1024)
    chunked = ht.gpt2_decode_chunked_graph(cfg, max_len=1024)[:3] \
        if args.chunked else None
    engine = ht.DecodeEngine(feeds, logits, caches, max_slots=N_REQUESTS,
                             max_len=1024, seed=0, device="cuda",
                             chunked=chunked)
    prompts = _prompts(cfg.vocab_size)
    _serve(engine, [p[:4] for p in prompts])          # warm-up

    # unprofiled run: the wall clock the profiler's own cost cannot touch
    metrics.reset_decode_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = _serve(engine, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lat = metrics.decode_latency_stats()["step"]
    ttft = metrics.decode_latency_stats()["ttft"]
    counts = metrics.decode_counts()

    # the same run through DecodeRouter's loop thread, as chip_smoke.py
    # serves it: the difference is the router's cost
    with ht.DecodeRouter(engine, queue_limit=N_REQUESTS) as router:
        t0 = time.perf_counter()
        streams = [router.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
        for st in streams:
            assert len(st.result(timeout=900)) == MAX_NEW
        torch.cuda.synchronize()
        router_wall = time.perf_counter() - t0

    fa.launches = fa.fwd_mask_launches = 0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        psteps = _serve(engine, prompts)
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
    top = sorted(kern.items(), key=lambda kv: -kv[1][1])[:12]
    flash = sum(v[1] for name, v in kern.items()
                if "flash_fwd_lengths" in name)
    # the full-mask forward: the only flash_fwd_kernel a decode run launches
    flash_mask = sum(v[1] for name, v in kern.items()
                     if "flash_fwd_kernel" in name)
    report = {
        "card": _card(), "torch": torch.__version__,
        "chunked": bool(args.chunked),
        "counters": {k: counts.get(k, 0) for k in (
            "decode_steps", "decode_prefill_steps",
            "decode_prefill_steps_saved", "decode_prefill_rows",
            "decode_logits_skipped")},
        "ttft_ms_p50": ttft["p50"] / 1e3, "ttft_ms_p99": ttft["p99"] / 1e3,
        "steps": steps, "tokens": N_REQUESTS * MAX_NEW,
        "wall_s": wall, "tokens_per_s": N_REQUESTS * MAX_NEW / wall,
        "step_ms_mean": wall / steps * 1e3,
        "step_ms_p50": lat["p50"] / 1e3, "step_ms_p99": lat["p99"] / 1e3,
        "router_wall_s": router_wall,
        "router_tokens_per_s": N_REQUESTS * MAX_NEW / router_wall,
        "profiled": {
            "steps": psteps, "wall_s": pwall,
            "device_busy_ms_per_step": busy_us / psteps / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e6 / pwall,
            # the profiler slows the host, not the kernels: the busy time
            # per step against the unprofiled run's step time
            "device_idle_share_unprofiled":
                1.0 - busy_us / 1e6 / psteps / (wall / steps),
            "kernels_per_step": n_kern / psteps,
            "flash_launches_per_step": fa.launches / psteps,
            "flash_ms_per_step": flash / psteps / 1e3,
            "flash_share_of_device": flash / busy_us if busy_us else None,
            "flash_mask_launches_per_step": fa.fwd_mask_launches / psteps,
            "flash_mask_ms_per_step": flash_mask / psteps / 1e3,
            "top_kernels": [{"name": n[:90], "count": c,
                             "ms_per_step": us / psteps / 1e3}
                            for n, (c, us) in top]},
    }
    cpu_table = prof.key_averages().table(sort_by="self_cpu_time_total",
                                          row_limit=25)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        stem = "profile_decode" + ("_chunked" if args.chunked else "")
        with open(os.path.join(args.out, stem + ".json"), "w") as f:
            json.dump(report, f, indent=1)
        with open(os.path.join(args.out, stem + "_ops.txt"), "w") as f:
            f.write(cpu_table + "\n\n")
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=25))
    print(json.dumps(report, indent=1))
    if not kern:
        print("profile_decode: the profiler recorded no device time")
    print(cpu_table)


if __name__ == "__main__":
    main()
