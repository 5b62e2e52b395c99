"""The PyTorch port stands alone: ``hetu_tpu_torch`` (and the GPU smoke
script) import neither ``jax`` nor ``hetu_tpu``, entry points refuse a
silent CPU fallback, and unported options fail by name."""
import ast
import os
import re
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
#: the repo's own script folders: the port keeps its own copy of what it
#: needs from them (``tools/ps_fsck.py``, ``examples/ctr/models.py``)
REPO_SCRIPTS = ("tools", "examples")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(module):
    return any(module == m or module.startswith(m + ".")
               for m in FORBIDDEN + REPO_SCRIPTS)


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
            "import hetu_tpu_torch.tools.profile_dp\n"
            "import hetu_tpu_torch.models.gpt2\n"
            "import hetu_tpu_torch.models.t5\n"
            "import hetu_tpu_torch.models.xlnet\n"
            "import hetu_tpu_torch.models.longformer\n"
            "import hetu_tpu_torch.models.vit\n"
            "import hetu_tpu_torch.models.swin\n"
            "import hetu_tpu_torch.models.mae\n"
            "import hetu_tpu_torch.models.clip\n"
            "import hetu_tpu_torch.models.transformer\n"
            "import hetu_tpu_torch.models.bart\n"
            "import hetu_tpu_torch.models.bigbird\n"
            "import hetu_tpu_torch.models.transfoxl\n"
            "import hetu_tpu_torch.models.reformer\n"
            "import hetu_tpu_torch.ops.transform\n"
            "import hetu_tpu_torch.ops.attention\n"
            "import hetu_tpu_torch.ops.arithmetic\n"
            "import hetu_tpu_torch.ops.embedding\n"
            "import hetu_tpu_torch.graph.executor\n"
            "import hetu_tpu_torch.parallel.zero\n"
            "import hetu_tpu_torch.serving.decode\n"
            "import hetu_tpu_torch.serving.executor\n"
            "import hetu_tpu_torch.serving.router\n"
            "import hetu_tpu_torch.serving.prefix_cache\n"
            "import hetu_tpu_torch.serving.fleet\n"
            "import hetu_tpu_torch.parallel.elastic\n"
            "import hetu_tpu_torch.models.cnn\n"
            "import hetu_tpu_torch.ops.nn\n"
            "import hetu_tpu_torch.data.dataloader\n"
            "import hetu_tpu_torch.data.datasets\n"
            "import hetu_tpu_torch.data.transforms\n"
            "import hetu_tpu_torch.context\n"
            "import hetu_tpu_torch.parallel\n"
            "import hetu_tpu_torch.parallel.batch_axis\n"
            "import hetu_tpu_torch.parallel.collectives\n"
            "import hetu_tpu_torch.parallel.preduce\n"
            "import hetu_tpu_torch.parallel.strategies\n"
            "import hetu_tpu_torch.parallel.remat\n"
            "import hetu_tpu_torch.graph.checkpoint\n"
            "import hetu_tpu_torch.optim.lr_scheduler\n"
            "import hetu_tpu_torch.ps.store\n"
            "import hetu_tpu_torch.ps.build\n"
            "import hetu_tpu_torch.ps.opcodes\n"
            "import hetu_tpu_torch.ps.cstable\n"
            "import hetu_tpu_torch.ps.refcache\n"
            "import hetu_tpu_torch.ps.dist_store\n"
            "import hetu_tpu_torch.ps.ops\n"
            "import hetu_tpu_torch.analysis\n"
            "import hetu_tpu_torch.analysis.shapes\n"
            "import hetu_tpu_torch.analysis.lint\n"
            "import hetu_tpu_torch.autoparallel\n"
            "import hetu_tpu_torch.autoparallel.cost_model\n"
            "import hetu_tpu_torch.graph.run_plan\n"
            "import hetu_tpu_torch.serving.cells\n"
            "import hetu_tpu_torch.tools.ps_fsck\n"
            "import hetu_tpu_torch.models.ctr\n"
            "import hetu_tpu_torch.chaos\n"
            "import hetu_tpu_torch.launcher\n"
            "import hetu_tpu_torch.tools.hybrid_wdl\n"
            "assert sys.modules['jax'] is None\n"
            "assert 'tools' not in sys.modules\n"
            "assert 'examples' not in sys.modules\n"
            "x = hetu_tpu_torch.placeholder_op('x')\n"
            "ex = hetu_tpu_torch.Executor([x * 2.0], device='cpu',\n"
            "                             compute_dtype='bfloat16')\n"
            "print(ex.run(feed_dict={x: [1.5]})[0].asnumpy().dtype)\n"
            "print(hetu_tpu_torch.lint([x * 2.0], feeds={x: (3,)}).ok)\n"
            "print(hetu_tpu_torch.GPT2Config.small().n_layer)\n"
            "print(hetu_tpu_torch.T5Config.small().num_layers)\n"
            "print(hetu_tpu_torch.XLNetConfig.base().n_layer)\n"
            "print(hetu_tpu_torch.LongformerConfig.base().attention_window)\n"
            "tx, ty, _, _ = hetu_tpu_torch.data.cifar10()\n"
            "x = hetu_tpu_torch.dataloader_op(\n"
            "    [hetu_tpu_torch.Dataloader(tx[:4], 2, 'train')])\n"
            "y = hetu_tpu_torch.dataloader_op(\n"
            "    [hetu_tpu_torch.Dataloader(ty[:4], 2, 'train')])\n"
            "loss, _ = hetu_tpu_torch.models.resnet18(x, y)\n"
            "ex = hetu_tpu_torch.Executor({'train': [loss]}, device='cpu')\n"
            "print(ex.get_batch_num('train'),\n"
            "      ex.run('train')[0].asnumpy().shape)\n"
            "import os, tempfile, torch.distributed as dist\n"
            "init = os.path.join(tempfile.mkdtemp(), 'init')\n"
            "dist.init_process_group('gloo', init_method='file://' + init,\n"
            "                        rank=0, world_size=1)\n"
            "x = hetu_tpu_torch.placeholder_op('x')\n"
            "loss = hetu_tpu_torch.reduce_mean_op(x * 2.0, [0])\n"
            "ex = hetu_tpu_torch.Executor(\n"
            "    [loss], device='cpu',\n"
            "    dist_strategy=hetu_tpu_torch.dist.DataParallel())\n"
            "print(ex.run(feed_dict={x: [1.0, 2.0]})[0].asnumpy())\n"
            "dist.destroy_process_group()\n"
            "s = hetu_tpu_torch.ps.DistributedStore(0, 1)\n"
            "t = s.init_table(4, 2, init_scale=0.0)\n"
            "s.push(t, [1], [[1.0, 1.0]], 0.5)\n"
            "print(s.pull(t, [1])[0, 0], s.local.native)\n"
            "s.close()\n"
            "print(hetu_tpu_torch.CacheSparseTable(4, 8, 2).perf()['size'])\n"
            "import socket\n"
            "ports = []\n"
            "for _ in range(2):\n"
            "    sk = socket.socket(); sk.bind(('127.0.0.1', 0))\n"
            "    ports.append(sk.getsockname()[1]); sk.close()\n"
            "ends = [('127.0.0.1', p) for p in ports]\n"
            "ss = [hetu_tpu_torch.ps.DistributedStore(r, 2, ends, port=p,\n"
            "      replication=2, rpc_timeout=5.0, connect_timeout=2.0)\n"
            "      for r, p in enumerate(ports)]\n"
            "t = [s.init_table(8, 2, init_scale=0.0) for s in ss][0]\n"
            "ss[0].push(t, [1, 2], [[1.0, 1.0]] * 2, 1.0)\n"
            "from hetu_tpu_torch.tools import ps_fsck\n"
            "print(ps_fsck.fsck(ends, 1)['ok'])\n"
            "for s in ss:\n"
            "    s.close()\n"
            "print(hetu_tpu_torch.CellMap({'a': [0], 'b': [1]}).world)\n"
            "from hetu_tpu_torch import chaos, launcher\n"
            "print(len(chaos.parse_spec('7:dup=0.1,kill:ps@rank1:step3')[1]))\n"
            "launcher.init_distributed(num_processes=1)\n"
            "print(dist.is_initialized())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["float32", "True", "12", "6", "12", "512",
                                   "2", "()", "3.0", "-0.5", "True", "0",
                                   "True", "2", "2", "False"]


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
                                   "params_from_named_arrays", "Executor",
                                   "Executor(resnet18, dataloader)",
                                   "Executor(DataParallel)"])
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                           entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ht.GPT2Config.tiny(n_layer=1)
    feeds, logits, caches, _ = ht.gpt2_decode_graph(cfg, max_len=8)
    bcfg = ht.BertConfig.tiny(num_hidden_layers=1, batch_size=1, seq_len=4,
                              hidden_size=8, intermediate_size=8,
                              vocab_size=16)
    _, loss, _ = ht.bert_pretrain_graph(bcfg)
    images = ht.dataloader_op([ht.Dataloader(np.zeros((4, 3, 32, 32)), 2)])
    labels = ht.dataloader_op([ht.Dataloader(np.zeros((4, 10)), 2)])
    cnn_loss, _ = ht.models.resnet18(images, labels)
    calls = {
        "DecodeEngine": lambda: ht.DecodeEngine(feeds, logits, caches),
        "InferenceExecutor": lambda: ht.InferenceExecutor([logits]),
        "params_from_named_arrays": lambda: ht.params_from_named_arrays(
            {"w": np.zeros(2, np.float32)}),
        "Executor": lambda: ht.Executor(
            {"train": [loss, ht.optim.AdamOptimizer(1e-4).minimize(loss)]},
            device=None),
        "Executor(resnet18, dataloader)": lambda: ht.Executor(
            {"train": [cnn_loss,
                       ht.optim.MomentumOptimizer(0.1).minimize(cnn_loss)]}),
        "Executor(DataParallel)": lambda: ht.Executor(
            {"train": [loss, ht.optim.AdamOptimizer(1e-4).minimize(loss)]},
            dist_strategy=ht.dist.DataParallel()),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


@pytest.mark.parametrize("opt", ["plan"])
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


@pytest.mark.parametrize("opt", ["plan", "mesh"])
def test_inference_executor_refuses_unported_options(opt):
    cfg = ht.GPT2Config.tiny(n_layer=1)
    _, logits, _, _ = ht.gpt2_decode_graph(cfg, max_len=8)
    with pytest.raises(NotImplementedError, match=opt):
        ht.InferenceExecutor([logits], device="cpu", **{opt: "error"})


def test_inference_executor_rejects_a_directory_without_meta_json(tmp_path):
    """Checkpoint-directory weights are ported; a directory that holds no
    ``meta.json`` raises ``ValueError``, as in the JAX package."""
    cfg = ht.GPT2Config.tiny(n_layer=1)
    _, logits, _, _ = ht.gpt2_decode_graph(cfg, max_len=8)
    with pytest.raises(ValueError, match="meta.json"):
        ht.InferenceExecutor([logits], weights=str(tmp_path), device="cpu")


def test_fleet_refuses_hetu_chaos_by_name(monkeypatch):
    """The serving planes' chaos hooks are not ported: with
    ``HETU_CHAOS`` set the front door and both routers refuse by name
    instead of ignoring it; unset, ``register_chaos`` does nothing, as the
    JAX package without a schedule."""
    x = ht.placeholder_op("x")
    iex = ht.InferenceExecutor([x * 2.0], buckets=(1,), device="cpu")
    cfg = ht.GPT2Config.tiny(n_layer=1)
    feeds, logits, caches, _ = ht.gpt2_decode_graph(cfg, max_len=8)
    eng = ht.DecodeEngine(feeds, logits, caches, device="cpu", max_len=8)
    monkeypatch.setenv("HETU_CHAOS", "7:kill:replica@0:req4")
    calls = [lambda: ht.FrontDoor(lambda i: None, 1),
             lambda: ht.ServingRouter(iex, start=False),
             lambda: ht.DecodeRouter(eng, start=False)]
    for call in calls:
        with pytest.raises(NotImplementedError, match="HETU_CHAOS"):
            call()
    monkeypatch.delenv("HETU_CHAOS")
    door = ht.FrontDoor(lambda i: ht.ServingRouter(iex, start=False), 1,
                        register_chaos=True)
    assert door.n_replicas == 1
    door.close(timeout=0.1)


@pytest.mark.parametrize("what", ["causal", "full_mask", "prefill", "bias",
                                  "masked_bias", "masked_bias_full",
                                  "bf16_key_mask", "bf16_causal", "varlen",
                                  "bf16_varlen_causal"])
def test_attention_dispatch_off_the_cpu_raises_for_unported_kinds(what):
    """A tensor off the CPU (a meta tensor stands in for the card here)
    goes to the kernel wrappers, which launch or raise: the dispatcher
    never falls back to the plain attention.  Causal, a full mask, the
    chunked prefill, a bias (alone, with a key mask or with a full mask)
    and ``lengths`` (``sdpa_varlen_op``, alone or causal) are ported, and
    so is bfloat16 (the mixed-precision path), so each reaches its
    wrapper, and the wrapper has no kernel for a device that is not
    CUDA."""
    from hetu_tpu_torch.ops import attention
    q = torch.zeros(1, 1, 2, 8, device="meta",
                    dtype=torch.bfloat16 if what.startswith("bf16")
                    else torch.float32)
    bias = torch.zeros(1, 1, 2, 2, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        if what == "bias":
            attention.dispatch_sdpa_bias(q, q, q, bias, causal=True)
        elif what.startswith("masked_bias"):
            rows = 2 if what == "masked_bias_full" else 1
            mask = torch.ones(1, 1, rows, 2, dtype=torch.int32, device="meta")
            attention.dispatch_sdpa_masked_bias(q, q, q, mask, bias)
        elif what.endswith(("varlen", "varlen_causal")):
            attention.dispatch_sdpa_varlen(
                q, q, q, torch.ones(1, dtype=torch.int32, device="meta"),
                causal=what.endswith("causal"))
        elif what == "prefill":
            attention.dispatch_sdpa_prefill(
                q, q, q, torch.zeros(1, dtype=torch.int32, device="meta"))
        else:
            mask = torch.ones(1, 1, 2 if what == "full_mask" else 1, 2,
                              dtype=torch.int32, device="meta")
            attention.dispatch_sdpa_masked(q, q, q, mask,
                                           causal=what.endswith("causal"))


def test_bf16_decode_is_refused_by_name():
    """The ``lengths`` (decode) kernel takes float32 only: the decode
    caches are float32 in both packages, and no bf16 decode path exists
    to port."""
    q = torch.zeros(2, 1, 8, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32 only"):
        fa.flash_fwd(q, q, q, torch.ones(1, dtype=torch.int32), 2, 1.0)


def test_build_paths_stay_inside_the_package():
    from hetu_tpu_torch.ops.kernels import _build
    lib = _build.library_path("flash_attention")
    assert lib.startswith(os.path.join(PKG, "_build") + os.sep)
    assert os.path.exists(_build.source_path("flash_attention"))
    assert _build.sources() == ["emb_cache", "flash_attention",
                                "flash_attention_bf16",
                                "flash_attention_bwd",
                                "flash_attention_dkv_bf16",
                                "flash_attention_dq_bf16", "moe_dispatch",
                                "segment_sum"]
    assert {src for src, _, _ in fa.ENTRIES.values()} == {
        "flash_attention", "flash_attention_bf16", "flash_attention_bwd",
        "flash_attention_dkv_bf16", "flash_attention_dq_bf16"}
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def _c_entries(source):
    """Names of the ``extern "C" int`` functions ``csrc/<source>.cu``
    defines: written out, or through an entry macro (``#define
    NAME(T, SFX)`` whose body names ``<entry>##SFX``) of the source or a
    header it includes, expanded with the suffix it is invoked with."""
    from hetu_tpu_torch.ops.kernels import _build
    with open(_build.source_path(source)) as f:
        text = f.read()
    files = [text]
    for inc in re.findall(r'#include "([^"]+)"', text):
        with open(os.path.join(_build.CSRC_DIR, inc)) as f:
            files.append(f.read())
    names, macros = set(), {}
    for body in files:
        joined = body.replace("\\\n", " ")
        for m in re.finditer(r"#define (\w+)\(T, SFX\)(.*)", joined):
            macros[m.group(1)] = m.group(2)
        plain = "\n".join(ln for ln in joined.splitlines()
                          if not ln.startswith("#define"))
        names |= set(re.findall(r'extern "C" int (\w+)\(', plain))
    for macro, sfx in re.findall(r"^(\w+)\([^,()]*,\s*(\w*)\)\s*$", text,
                                 re.M):
        seen, todo = set(), [macro]
        while todo:                        # macros that expand macros
            body = macros[todo.pop()]
            names |= {n + sfx for n in
                      re.findall(r'extern "C" int (\w+)##SFX\(', body)}
            for inner in re.findall(r"\b(HETU_\w+)\(T, SFX\)", body):
                if inner not in seen:
                    seen.add(inner)
                    todo.append(inner)
    return names


def test_every_entry_is_defined_in_the_source_the_map_names():
    """A routing typo in ``fa.ENTRIES`` would only show on the card (the
    symbol is missing from the library that is loaded): every entry must be
    an ``extern "C" int`` of the source the map names, and the map must
    route every training entry's bf16 twin."""
    defined = {}
    for name, (source, _, _) in fa.ENTRIES.items():
        if source not in defined:
            defined[source] = _c_entries(source)
        assert name in defined[source], (name, source,
                                         sorted(defined[source]))
    assert {n + "_bf16" for n in fa.ENTRIES
            if not n.endswith("_bf16") and n != "hetu_flash_fwd_lengths"} \
        == {n for n in fa.ENTRIES if n.endswith("_bf16")}


#: the tensor-core source of each bf16 training kernel; the SIMT sources
#: (``flash_attention``, ``flash_attention_bwd``) build float32 only
BF16_SOURCES = {"fwd": "flash_attention_bf16", "dq": "flash_attention_dq_bf16",
                "dkv": "flash_attention_dkv_bf16"}


@pytest.mark.parametrize("entry", sorted(n for n in fa.ENTRIES
                                         if n.endswith("_bf16")))
def test_bf16_entry_routes_to_its_tensor_core_source(entry):
    """Every bf16 training entry (forward, dQ, dK/dV) is built from its
    tensor-core source, and none from a SIMT one."""
    kind = "fwd" if entry.startswith("hetu_flash_fwd") else \
        "dkv" if entry.startswith("hetu_flash_bwd_dkv") else "dq"
    source = fa.ENTRIES[entry][0]
    assert source == BF16_SOURCES[kind], (entry, source)
    assert source not in ("flash_attention", "flash_attention_bwd")
