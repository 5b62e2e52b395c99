"""The PyTorch port stands alone: ``hetu_tpu_torch`` (and the GPU smoke
script) import neither ``jax`` nor ``hetu_tpu``, entry points refuse a
silent CPU fallback, and unported options fail by name."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hetu_tpu_torch as ht                                   # noqa: E402
from hetu_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402

PKG = os.path.join(ROOT, "hetu_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "hetu_tpu")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(module):
    return any(module == m or module.startswith(m + ".") for m in FORBIDDEN)


def test_import_with_jax_and_hetu_tpu_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['jaxlib'] = None\n"
            "sys.modules['hetu_tpu'] = None\n"
            "import hetu_tpu_torch\n"
            "import hetu_tpu_torch.ops.kernels.flash_attention\n"
            "import hetu_tpu_torch.ops.kernels._build\n"
            "import hetu_tpu_torch.tools.profile_train\n"
            "import hetu_tpu_torch.tools.profile_decode\n"
            "import hetu_tpu_torch.tools.profile_moe\n"
            "import hetu_tpu_torch.models.gpt2\n"
            "import hetu_tpu_torch.models.t5\n"
            "import hetu_tpu_torch.models.xlnet\n"
            "import hetu_tpu_torch.models.longformer\n"
            "import hetu_tpu_torch.ops.attention\n"
            "import hetu_tpu_torch.serving.decode\n"
            "assert sys.modules['jax'] is None\n"
            "print(hetu_tpu_torch.GPT2Config.small().n_layer)\n"
            "print(hetu_tpu_torch.T5Config.small().num_layers)\n"
            "print(hetu_tpu_torch.XLNetConfig.base().n_layer)\n"
            "print(hetu_tpu_torch.LongformerConfig.base().attention_window)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["12", "6", "12", "512"]


def test_sources_import_no_jax_or_hetu_tpu():
    bad = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, ROOT)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert len(_sources()) > 15
    assert not bad, bad


@pytest.mark.parametrize("entry", ["DecodeEngine", "InferenceExecutor",
                                   "params_from_named_arrays", "Executor"])
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                           entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ht.GPT2Config.tiny(n_layer=1)
    feeds, logits, caches, _ = ht.gpt2_decode_graph(cfg, max_len=8)
    bcfg = ht.BertConfig.tiny(num_hidden_layers=1, batch_size=1, seq_len=4,
                              hidden_size=8, intermediate_size=8,
                              vocab_size=16)
    _, loss, _ = ht.bert_pretrain_graph(bcfg)
    calls = {
        "DecodeEngine": lambda: ht.DecodeEngine(feeds, logits, caches),
        "InferenceExecutor": lambda: ht.InferenceExecutor([logits]),
        "params_from_named_arrays": lambda: ht.params_from_named_arrays(
            {"w": np.zeros(2, np.float32)}),
        "Executor": lambda: ht.Executor(
            {"train": [loss, ht.optim.AdamOptimizer(1e-4).minimize(loss)]},
            device=None),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


@pytest.mark.parametrize("opt", ["plan", "prefix_store"])
def test_decode_engine_refuses_unported_options(opt):
    cfg = ht.GPT2Config.tiny(n_layer=1)
    feeds, logits, caches, _ = ht.gpt2_decode_graph(cfg, max_len=8)
    with pytest.raises(NotImplementedError, match=opt):
        ht.DecodeEngine(feeds, logits, caches, device="cpu", **{opt: object()})


def test_decode_engine_takes_a_chunked_entry_and_needs_its_variables():
    """``chunked=`` is ported: the second executor is loaded from the
    primary's parameters (the same tensors), and a chunked graph with a
    variable the primary lacks raises instead of drawing it from a seed."""
    cfg = ht.GPT2Config.tiny(n_layer=1)
    feeds, logits, caches, _ = ht.gpt2_decode_graph(cfg, max_len=8)
    chunked = ht.gpt2_decode_chunked_graph(cfg, max_len=8)[:3]
    eng = ht.DecodeEngine(feeds, logits, caches, device="cpu",
                          chunked=chunked, max_len=8)
    assert eng.chunk_ladder == (1, 2, 4, 8) and eng.chunk_top == 8
    by_name = {eng.iex.var_names[n]: eng.iex.params[eng.iex._k(n)]
               for n in eng.iex.var_nodes}
    for n in eng.ciex.var_nodes:
        name = eng.ciex.var_names[n]
        assert eng.ciex.params[eng.ciex._k(n)] is by_name[name]
    other = ht.gpt2_decode_chunked_graph(cfg, max_len=8, name="other")[:3]
    with pytest.raises(KeyError, match="other"):
        ht.DecodeEngine(feeds, logits, caches, device="cpu", chunked=other)


@pytest.mark.parametrize("opt", ["plan", "mesh", "validate"])
def test_inference_executor_refuses_unported_options(opt):
    cfg = ht.GPT2Config.tiny(n_layer=1)
    _, logits, _, _ = ht.gpt2_decode_graph(cfg, max_len=8)
    with pytest.raises(NotImplementedError, match=opt):
        ht.InferenceExecutor([logits], device="cpu", **{opt: "error"})


def test_inference_executor_refuses_checkpoint_directory(tmp_path):
    cfg = ht.GPT2Config.tiny(n_layer=1)
    _, logits, _, _ = ht.gpt2_decode_graph(cfg, max_len=8)
    with pytest.raises(NotImplementedError, match="checkpoint"):
        ht.InferenceExecutor([logits], weights=str(tmp_path), device="cpu")


@pytest.mark.parametrize("spec", ["causal", "key_mask", "mask", "bias"])
def test_flash_attention_unported_specializations_raise(spec):
    """Ported: ``lengths`` (decode), dense / ``key_mask`` / causal / full
    mask / bias, alone or together (training), with their backward.
    Unported and refused by name: ``lengths`` together with ``key_mask``,
    ``mask``, ``causal`` or a bias."""
    q = torch.zeros(1, 1, 1, 8)
    kw = {"lengths": torch.ones(1, dtype=torch.int32)}
    match = spec
    if spec == "causal":
        kw["causal"] = True
    elif spec == "key_mask":
        kw[spec] = torch.ones(1, 1, dtype=torch.int32)
        match = "lengths together with key_mask"
    else:
        kw[spec] = torch.ones(1, 1, 1, 1)
    with pytest.raises(NotImplementedError, match=match):
        fa.flash_attention(q, q, q, **kw)


@pytest.mark.parametrize("what", ["causal", "full_mask", "prefill", "bias",
                                  "masked_bias", "masked_bias_full"])
def test_attention_dispatch_off_the_cpu_raises_for_unported_kinds(what):
    """A tensor off the CPU (a meta tensor stands in for the card here)
    goes to the kernel wrappers, which launch or raise: the dispatcher
    never falls back to the plain attention.  Causal, a full mask, the
    chunked prefill and a bias (alone, with a key mask or with a full
    mask) are ported, so each reaches its wrapper, and the wrapper has no
    kernel for a device that is not CUDA."""
    from hetu_tpu_torch.ops import attention
    q = torch.zeros(1, 1, 2, 8, device="meta")
    bias = torch.zeros(1, 1, 2, 2, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        if what == "bias":
            attention.dispatch_sdpa_bias(q, q, q, bias, causal=True)
        elif what.startswith("masked_bias"):
            rows = 2 if what == "masked_bias_full" else 1
            mask = torch.ones(1, 1, rows, 2, dtype=torch.int32, device="meta")
            attention.dispatch_sdpa_masked_bias(q, q, q, mask, bias)
        elif what == "prefill":
            attention.dispatch_sdpa_prefill(
                q, q, q, torch.zeros(1, dtype=torch.int32, device="meta"))
        else:
            mask = torch.ones(1, 1, 1 if what == "causal" else 2, 2,
                              dtype=torch.int32, device="meta")
            attention.dispatch_sdpa_masked(q, q, q, mask,
                                           causal=what == "causal")


def test_build_paths_stay_inside_the_package():
    from hetu_tpu_torch.ops.kernels import _build
    lib = _build.library_path("flash_attention")
    assert lib.startswith(os.path.join(PKG, "_build") + os.sep)
    assert os.path.exists(_build.source_path("flash_attention"))
    assert _build.sources() == ["emb_cache", "flash_attention",
                                "flash_attention_bwd", "moe_dispatch",
                                "segment_sum"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
