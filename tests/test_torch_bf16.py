"""bf16 mixed precision in the port (``Executor(compute_dtype="bfloat16")``)
against the JAX package's.

Both packages cast every float32 variable and feed to bf16 inside the
step, keep float32 masters, optimizer state and fetches, and leave
integer feeds alone.  Here on the CPU the port's attention takes
``sdpa_reference`` (its ``ScoresF32`` twin of the JAX package's
``_scores_f32``), as the JAX package's does; the bf16 flash kernels are
held to their plain versions in tests/test_torch_flash_attention.py (and
on the card in tests/test_torch_kernels_gpu.py).  The sparse MoE slice's
gathers take the plain version in the port and the Pallas kernel in
interpret mode in the JAX package, as its own lowering does on the CPU.

Tiny BERT (MLM, MLM + NSP), GPT-2, T5 (dense and ``use_mask``, the query
projections scaled by 1/8 as in tests/test_torch_t5.py), XLNet,
Longformer (each at the tiny configuration of its own
tests/test_torch_<model>.py, dropout off) and the sparse GShard MoE
slice of tests/test_torch_moe.py (64 tokens, d 16, 4 experts, hidden 32,
top-2, capacity factor 1.25) start from the JAX package's weights and
take the same feeds.  XLA on the CPU fuses a bf16 elementwise chain and
rounds once (it may even keep the float32 value of a bf16 node: GPT-2's
fetched loss is not a bf16 number there), torch rounds after every op,
so the two agree to bf16 tolerances, not bit for bit.  The tolerances
come from the measured spread; beside each, the worst measured ratio to
it per model (bert, bert_nsp, gpt2, t5, t5_mask, xlnet, longformer,
moe):

* losses (step 1 and 3 Adam steps): rtol 5e-3 (step 1: 0, 0, 0.44, 0,
  0, 0, 0.20, 0; 3 steps: 0, 0.31, 0.44, 0.34, 0.34, 0, 0.48, 0.001);
* step-1 gradients of every variable: ``allclose(rtol=2e-2, atol=1e-2)``
  (0.62 and 0.63 BERT's token-type table, 0.25 GPT-2's ``wpe``, 0.024
  T5's shared embedding, 0.54 XLNet's ``layer0.o.bias``, 0.17
  Longformer's word table, 0.009 MoE's ``expert.b2``; the key biases'
  gradients are rounding noise around an exact 0);
* the port's bf16 run against its own float32 run, 3 Adam losses:
  ``test_bf16_parity.py``'s budget, rtol 5e-2 / atol 5e-2 (0.039, 0.058,
  0.092, 0.080, 0.079, 0.030, 0.067, 0.004);
* the MoE slice's routing maps equal at every step, exactly (they held
  only once the port's gate took the JAX package's softmax one op at a
  time, ROADMAP C13)."""
import functools
import os
import sys

import jax
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hetu_tpu as jht                                      # noqa: E402
from hetu_tpu.graph.node import LowerCtx as JaxLowerCtx     # noqa: E402
from hetu_tpu.graph.node import topo_sort as jax_topo      # noqa: E402
from hetu_tpu.models import bert as jbert                  # noqa: E402
from hetu_tpu.models import gpt2 as jgpt2                  # noqa: E402
from hetu_tpu.models import longformer as jlf              # noqa: E402
from hetu_tpu.models import t5 as jt5                      # noqa: E402
from hetu_tpu.models import xlnet as jxl                   # noqa: E402
from hetu_tpu.ops import moe as jmoe                       # noqa: E402
from hetu_tpu.ops.pallas import moe_dispatch as jmd        # noqa: E402
import hetu_tpu_torch as tht                               # noqa: E402
from hetu_tpu_torch.ops import moe as tmoe                 # noqa: E402
from hetu_tpu_torch.ops.kernels import moe_dispatch as tmd  # noqa: E402
from test_torch_cnn import jax_cnn_models                  # noqa: E402

BERT_CFG = dict(batch_size=2, seq_len=24, hidden_size=32,
                intermediate_size=64, vocab_size=96, num_hidden_layers=2,
                num_attention_heads=2, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)
GPT2_CFG = dict(batch_size=2, seq_len=24, resid_pdrop=0.0, embd_pdrop=0.0,
                attn_pdrop=0.0)
# each model's tiny configuration from its own tests/test_torch_<model>.py
T5_CFG = dict(batch_size=2, src_len=16, tgt_len=12, dropout_rate=0.0)
#: test_torch_t5.py's scale of every ``*.q.weight`` (T5's own init)
T5_Q_SCALE = 0.125
XLNET_CFG = dict(batch_size=2, dropout=0.0)
LONGFORMER_CFG = dict(batch_size=2, hidden_dropout_prob=0.0)
# test_torch_moe.py's MoE slice: tokens, d, experts, hidden, top-k,
# capacity factor
MOE_TOKENS, MOE_D, MOE_E, MOE_HIDDEN, MOE_K, MOE_CF = 64, 16, 4, 32, 2, 1.25
LOSS_RTOL = 5e-3
GRAD_TOL = dict(rtol=2e-2, atol=1e-2)
PARITY_TOL = dict(rtol=5e-2, atol=5e-2)
STEPS = 3
MODELS = ["bert", "bert_nsp", "gpt2", "t5", "t5_mask", "xlnet",
          "longformer", "moe"]


def _moe_graph(ht):
    """test_torch_moe.py's sparse slice: (feeds, loss, [token_of_slot,
    slot_of_token])."""
    x = ht.placeholder_op("x", shape=(MOE_TOKENS, MOE_D))
    y_ = ht.placeholder_op("y", shape=(MOE_TOKENS, MOE_D))
    gate = ht.layers.TopKGateSparse(MOE_D, MOE_TOKENS, MOE_E, k=MOE_K,
                                    capacity_factor=MOE_CF)
    moe = ht.layers.SparseMoELayer(
        gate, ht.layers.Expert(MOE_E, MOE_D, MOE_HIDDEN), MOE_D)
    h, aux = moe(x)
    loss = ht.reduce_mean_op(ht.ops.mul_op(h - y_, h - y_), [0, 1]) \
        + aux * 0.01
    route = sorted((n for n in ht.topo_sort([loss])
                    if n.inputs and n.inputs[0].op_type == "TopKGateSparse"),
                   key=lambda n: n.index)
    return {"x": x, "y": y_}, loss, route[:2]


def _graph(jax_side, model):
    """(feeds {name: node}, loss, extra fetches) of a tiny model in one
    package: the MoE slice's routing maps, nothing for the others."""
    ht = jht if jax_side else tht
    if model == "moe":
        return _moe_graph(ht)
    if model == "gpt2":
        mod = jgpt2 if jax_side else tht.models
        feeds, loss, _ = mod.gpt2_lm_graph(mod.GPT2Config.tiny(**GPT2_CFG))
    elif model in ("t5", "t5_mask"):
        mod = jt5 if jax_side else tht.models
        feeds, loss, _ = mod.t5_seq2seq_graph(mod.T5Config.tiny(**T5_CFG),
                                              use_mask=model == "t5_mask")
    elif model == "xlnet":
        mod = jxl if jax_side else tht.models
        feeds, loss, _ = mod.xlnet_plm_graph(mod.XLNetConfig.tiny(**XLNET_CFG))
    elif model == "longformer":
        mod = jlf if jax_side else tht.models
        feeds, loss, _ = mod.longformer_mlm_graph(
            mod.LongformerConfig.tiny(**LONGFORMER_CFG))
    else:
        mod = jbert if jax_side else tht.models
        feeds, loss, _ = mod.bert_pretrain_graph(
            mod.BertConfig.tiny(**BERT_CFG), use_nsp=model == "bert_nsp")
    return feeds, loss, []


def _feed_values(model):
    if model == "moe":
        rng = np.random.RandomState(0)
        return {"x": rng.randn(MOE_TOKENS, MOE_D).astype(np.float32),
                "y": rng.randn(MOE_TOKENS, MOE_D).astype(np.float32)}
    if model in ("t5", "t5_mask"):
        batch = jt5.synthetic_seq2seq_batch(jt5.T5Config.tiny(**T5_CFG),
                                            seed=0, padded=model == "t5_mask")
        return dict(zip(("input_ids", "decoder_input_ids", "labels",
                         "attention_mask"), batch))
    if model == "xlnet":
        return dict(zip(("input_ids", "content_mask", "query_mask",
                         "labels"), jxl.synthetic_plm_batch(
                             jxl.XLNetConfig.tiny(**XLNET_CFG), seed=0)))
    if model == "longformer":
        return dict(zip(("input_ids", "labels"), tht.models.longformer
                        .synthetic_mlm_ids(tht.models.LongformerConfig.tiny(
                            **LONGFORMER_CFG), seed=0)))
    if model == "gpt2":
        ids, labels = jgpt2.synthetic_lm_batch(
            jgpt2.GPT2Config.tiny(**GPT2_CFG), seed=0)
        labels = labels.copy()
        labels[0, -5:] = -1                 # padded positions: ignored
        return {"input_ids": ids, "labels": labels}
    ids, tt, labels, attn = jbert.synthetic_mlm_batch(
        jbert.BertConfig.tiny(**BERT_CFG), seed=0)
    fd = {"input_ids": ids, "token_type_ids": tt,
          "masked_lm_labels": labels, "attention_mask": attn}
    if model == "bert_nsp":
        fd["next_sentence_label"] = np.array([1, 0], np.int32)
    return fd


def _executor(jax_side, model, compute_dtype):
    ht = jht if jax_side else tht
    topo = jax_topo if jax_side else tht.topo_sort
    feeds, loss, extra = _graph(jax_side, model)
    wrt = [n for n in topo([loss]) if getattr(n, "is_variable", False)
           and n.trainable]
    fetches = {"train": [loss, ht.optim.AdamOptimizer(1e-3).minimize(loss)]
               + ht.gradients(loss, wrt) + extra}
    kw = {} if jax_side else {"device": "cpu"}
    ex = ht.Executor(fetches, seed=0, compute_dtype=compute_dtype, **kw)
    return feeds, ex, [n.name for n in wrt]


def _weights(jex, model):
    """The JAX package's initial weights by name; T5's query projections
    scaled as tests/test_torch_t5.py scales them (loaded back into
    ``jex``)."""
    weights = jex.return_tensor_values()
    if model in ("t5", "t5_mask"):
        weights = {n: w * T5_Q_SCALE if n.endswith(".q.weight") else w
                   for n, w in weights.items()}
        jex.load_dict(weights)
    return weights


@functools.lru_cache(maxsize=None)
def _runs(model):
    """The JAX package's bf16 run, the port's bf16 run and the port's
    float32 run of one tiny model, all from the JAX package's weights:
    {run: (losses, step-1 gradients, each step's extra fetches)}, the
    variable names and, for the MoE slice, the gate weights of each step
    (the port's masters before the step)."""
    values = _feed_values(model)
    jfeeds, jex, names = _executor(True, model, "bfloat16")
    weights = _weights(jex, model)
    out, gate_ws = {}, []
    for tag, jax_side, cd in (("jax", True, "bfloat16"),
                              ("port", False, "bfloat16"),
                              ("port_f32", False, None)):
        if jax_side:
            feeds, ex = jfeeds, jex
        else:
            feeds, ex, tnames = _executor(False, model, cd)
            assert tnames == names
            assert set(ex.var_names.values()) == set(weights)
            ex.load_dict(weights)
        fd = {feeds[k]: v for k, v in values.items()}
        losses, grads, extras = [], None, []
        for step in range(STEPS):
            if tag == "port" and model == "moe":
                gate_ws.append(next(
                    v.numpy() for n, v in ex.var_values.items()
                    if ex.var_names[n] == "topk_gate.wg"))
            got = ex.run("train", feed_dict=fd)
            losses.append(got[0].asnumpy())
            extras.append([e.asnumpy() for e in got[2 + len(names):]])
            if step == 0:
                grads = [g.asnumpy() for g in got[2:2 + len(names)]]
        if not jax_side:
            masters = list(ex.var_values.values())
            assert all(v.dtype == torch.float32 for v in masters)
            assert ex.step_counter == STEPS
        out[tag] = (losses, grads, extras)
    return names, out, gate_ws


@pytest.fixture(scope="module", params=MODELS)
def runs(request):
    names, out, _ = _runs(request.param)
    return request.param, names, out


def test_tiny_model_step_one_loss_matches_jax_bf16(runs):
    _, _, out = runs
    assert out["port"][0][0].dtype == np.float32   # fetches leave as f32
    np.testing.assert_allclose(out["port"][0][0], out["jax"][0][0],
                               rtol=LOSS_RTOL)


def test_tiny_model_gradients_match_jax_bf16(runs):
    _, names, out = runs
    for name, g, w in zip(names, out["port"][1], out["jax"][1]):
        assert g.dtype == np.float32, name          # gradients reach the
        np.testing.assert_allclose(g, w, err_msg=name, **GRAD_TOL)  # master


def test_tiny_model_adam_losses_match_jax_bf16(runs):
    _, _, out = runs
    np.testing.assert_allclose(np.array(out["port"][0], np.float64),
                               np.array(out["jax"][0], np.float64),
                               rtol=LOSS_RTOL)
    assert out["port"][0][-1] < out["port"][0][0]


def test_port_bf16_tracks_its_float32_run(runs):
    _, _, out = runs
    np.testing.assert_allclose(np.array(out["port"][0], np.float64),
                               np.array(out["port_f32"][0], np.float64),
                               **PARITY_TOL)


def test_tiny_moe_routing_maps_match_jax_bf16():
    """The bf16 MoE slice's token_of_slot and slot_of_token equal the JAX
    package's at every step.  On a difference the message names each
    token whose expert choice differs with the gaps between its sorted
    gate probabilities (float64 from the bf16-rounded operands): a route
    flips only across a near tie."""
    _, out, gate_ws = _runs("moe")
    x = _feed_values("moe")["x"]
    bf = torch.bfloat16
    cap = int(np.ceil(MOE_K * MOE_CF * MOE_TOKENS / MOE_E))
    for step, (got, want) in enumerate(zip(out["port"][2], out["jax"][2])):
        if all(np.array_equal(g, w) for g, w in zip(got, want)):
            continue
        xb, wb = (torch.from_numpy(a).to(bf).double().numpy()
                  for a in (x, gate_ws[step]))
        logits = xb @ wb
        p = np.exp(logits - logits.max(1, keepdims=True))
        p = np.sort(p / p.sum(1, keepdims=True), axis=1)[:, ::-1]
        sot_t, sot_j = got[1], want[1]
        et = np.where(sot_t >= 0, sot_t // cap, -1)
        ej = np.where(sot_j >= 0, sot_j // cap, -1)
        diff = np.nonzero((et != ej).any(1))[0]
        gaps = [f"token {t}: " + ", ".join(
            f"p{j + 1}-p{j + 2} {p[t, j] - p[t, j + 1]:.3e}"
            for j in range(MOE_K)) for t in diff]
        pytest.fail(f"step {step + 1}: routing maps differ "
                    f"(token_of_slot {int((got[0] != want[0]).sum())} "
                    f"slots, slot_of_token {int((sot_t != sot_j).sum())} "
                    f"routes); {'; '.join(gaps) or 'no expert flip'}")
    # the slice drops routes and leaves slots empty: both -1 rules run
    tos, sot = out["port"][2][0]
    assert (tos < 0).any() and tos.dtype == sot.dtype == np.int32


# -- every node's dtype ---------------------------------------------------------

def _lower_all(jax_side, loss, weights, values):
    """Every node's value of one package's graph, evaluated eagerly with
    the executor's bf16 casts: float32 variables and feeds become bf16,
    feeds first take their placeholder's dtype."""
    if jax_side:
        import jax.numpy as jnp
        ctx, topo = JaxLowerCtx(True, jax.random.key(0)), jax_topo

        def place(v):
            v = jnp.asarray(v)
            return v.astype(jnp.bfloat16) if v.dtype == jnp.float32 else v
    else:
        ctx = tht.LowerCtx(True, torch.Generator().manual_seed(0))
        topo = tht.topo_sort

        def place(v):
            v = torch.from_numpy(v)
            return v.to(torch.bfloat16) if v.dtype == torch.float32 else v
    env = {}
    for n in topo([loss]):
        if getattr(n, "is_variable", None) is None:
            env[n] = n.lower(ctx, *[env[i] for i in n.inputs])
        elif n.is_variable:
            env[n] = place(np.array(weights[n.name], np.float32))
        else:
            env[n] = place(np.asarray(values[n.name])
                           .astype(n.dtype or np.float32))
    return [env[n] for n in topo([loss])], topo([loss])


@pytest.mark.parametrize("model", ["bert_nsp", "gpt2", "t5_mask", "xlnet",
                                   "longformer", "moe"])
def test_every_node_has_the_jax_packages_dtype(model):
    """Tiny BERT (MLM + NSP, whose graph holds the MLM-only one), GPT-2, T5
    (``use_mask``, whose graph holds the dense one), XLNet, Longformer and
    the sparse MoE slice lowered node by node in both packages at bf16:
    the graphs line up op for op, and every node's output has the JAX
    package's dtype (jnp's promotion: a bf16 sum over an integer count
    plus 1e-6 stays bf16, the port's weak-float rule in
    ops/arithmetic.py).  In the MoE slice the softmax and the expert
    buffers are bf16, the one-hots, queue positions, gate weights, aux
    loss and the combine's output float32 (bf16 rows times float32 gate
    weights); the JAX package's gathers run its Pallas kernel in
    interpret mode, as its own lowering does on the CPU."""
    values = _feed_values(model)
    _, jloss, _ = _graph(True, model)
    _, tloss, _ = _graph(False, model)
    jex = jht.Executor([jloss], seed=0)
    weights = {jex.var_names[n]: np.asarray(v)
               for n, v in jex.var_values.items()}
    jvals, jnodes = _lower_all(True, jloss, weights, values)
    tvals, tnodes = _lower_all(False, tloss, weights, values)
    assert [n.op_type for n in tnodes] == [n.op_type for n in jnodes]
    kinds = set()
    seen = {}
    for jn, jv, tv in zip(jnodes, jvals, tvals):
        if isinstance(jv, tuple):           # a multi-output op: its items
            continue                        # are nodes of their own
        want = str(jv.dtype)
        got = str(tv.dtype).replace("torch.", "")
        assert got == want, (jn.op_type, jn.name, want, got)
        kinds.add(want)
        seen.setdefault(jn.op_type, set()).add(want)
    assert {"bfloat16", "float32", "int32"} <= kinds
    if model == "moe":
        assert seen["SparseDispatch"] == {"bfloat16"}     # expert buffers
        assert seen["SparseCombine"] == {"float32"}       # w * bf16 rows
        gate = sorted((n.index, str(v.dtype)) for n, v in zip(jnodes, jvals)
                      if n.op_type == "Item"
                      and n.inputs[0].op_type == "TopKGateSparse")
        # token_of_slot, slot_of_token, k_of_slot, gate_w, aux
        assert [dt for _, dt in gate] == ["int32"] * 3 + ["float32"] * 2, \
            gate


@pytest.mark.parametrize("experts", [4, 16])
def test_moe_gate_softmax_is_the_jax_packages(experts):
    """The gate's softmax on bf16 logits is ``jax.nn.softmax``'s, bit for
    bit: one bf16 rounding per op (ROADMAP C13).  ``torch.softmax``,
    which rounds once from float32, differs from it in most rows.  Its
    gradient passes gradcheck in float64."""
    import jax.numpy as jnp
    logits = np.random.RandomState(experts).randn(2000, experts)
    jl = jnp.asarray(logits, jnp.bfloat16)
    want = np.asarray(jax.nn.softmax(jl, axis=-1).astype(jnp.float32))
    tl = torch.from_numpy(np.array(jl.astype(jnp.float32))).to(
        torch.bfloat16)
    got = tmoe._softmax(tl)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    once = torch.softmax(tl, dim=-1).float().numpy()
    assert (once != want).any(1).mean() > 0.5
    x64 = torch.from_numpy(logits[:8]).requires_grad_(True)
    assert torch.autograd.gradcheck(tmoe._softmax, (x64,))


def test_bf16_moe_gathers_keep_the_jax_packages_dtypes():
    """Every row gather of a bf16 sparse MoE step, forward and backward,
    in the order it runs, against the JAX package's ``pallas_call``s in
    the jaxpr of the same gradient: the dispatch (forward and backward),
    the combine forward and d_w's re-gathers gather bf16 rows; d_buffers
    gathers the combine's float32 gradient (the gate weights are float32,
    so the combine's output is).  Nothing is cast to make them agree."""
    rng = np.random.RandomState(5)
    s, d, e, k, cap = 16, 8, 4, 2, 6
    tokens = rng.randn(s, d).astype(np.float32)
    w = (rng.randn(d, d) * 0.3).astype(np.float32)
    wg = rng.randn(d, e).astype(np.float32)
    import jax.numpy as jnp

    def jloss(tok, w_, wg_):
        tos, sot, kos, gw, _ = jmoe._topk_sparse_indices(tok @ wg_, k, cap)
        buf = jmd.sparse_dispatch(tok, tos, sot, True)
        out = jmd.sparse_combine(jnp.tanh(buf @ w_), gw, sot, tos, kos, True)
        return jnp.sum(out * out)

    bf = (jnp.asarray(a, jnp.bfloat16) for a in (tokens, w, wg))
    jaxpr = jax.make_jaxpr(jax.grad(jloss, argnums=(0, 1, 2)))(*bf)

    def pallas_dtypes(jx):
        found = []
        for eqn in jx.eqns:
            if eqn.primitive.name == "pallas_call":
                found += [str(v.aval.dtype) for v in eqn.outvars]
            for p in eqn.params.values():
                for sub in p if isinstance(p, (tuple, list)) else (p,):
                    inner = getattr(sub, "jaxpr", sub)
                    if hasattr(inner, "eqns"):
                        found += pallas_dtypes(inner)
        return found

    want = pallas_dtypes(jaxpr.jaxpr)
    got = []

    def gather(src, idx):
        got.append(str(src.dtype).replace("torch.", ""))
        return tmd.row_gather(src, idx)

    tt, tw, twg = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
                   for a in (tokens, w, wg))
    tos, sot, kos, gw, _ = tmoe._topk_sparse_indices(tt @ twg, k, cap)
    assert gw.dtype == torch.float32
    buf = tmd.sparse_dispatch(tt, tos, sot, gather=gather)
    out = tmd.sparse_combine(torch.tanh(buf @ tw), gw, sot, tos, kos,
                             gather=gather)
    assert buf.dtype == torch.bfloat16 and out.dtype == torch.float32
    torch.autograd.grad(torch.sum(out * out), (tt, tw, twg))
    # forward: dispatch, k combine routes; backward: k d_w re-gathers,
    # d_buffers, k dispatch routes
    assert got == ["bfloat16"] * (1 + 2 * k) + ["float32"] \
        + ["bfloat16"] * k
    assert sorted(got) == sorted(want), want


# -- position ids (ROADMAP C11) --------------------------------------------------

@pytest.mark.parametrize("seq,rows", [(384, 512), (512, 512), (1024, 1024)])
def test_position_ids_round_to_bf16_in_both_packages(seq, rows):
    """BERT and GPT-2 keep ``arange(seq)`` as a float32 non-trainable
    Variable, which the bf16 cast rounds above 256 (steps of 2, then 4)
    before the lookup truncates it: both packages look up the same rounded
    rows.  A position that rounds past the table (511 -> 512 of 512 rows,
    1022 and 1023 -> 1024 of 1024) reads NaN in the JAX package and the
    last row in the port."""
    table = np.random.RandomState(seq).randn(rows, 8).astype(np.float32)
    out = {}
    for tag, ht in (("jax", jht), ("port", tht)):
        pos = ht.Variable("pos_ids", value=np.arange(seq, dtype=np.float32),
                          trainable=False)
        tab = ht.Variable("table", value=table, trainable=False)
        kw = {} if ht is jht else {"device": "cpu"}
        ex = ht.Executor([ht.embedding_lookup_op(tab, pos)],
                         compute_dtype="bfloat16", **kw)
        out[tag] = ex.run(feed_dict={}, convert_to_numpy_ret_vals=True)[0]
    rounded = torch.arange(seq, dtype=torch.float32).to(torch.bfloat16) \
        .long().numpy()
    assert rounded[257] == 256 and rounded[300] == 300
    # every odd position in (256, 512), three in four in (512, 1024)
    assert np.count_nonzero(rounded != np.arange(seq)) == \
        {384: 64, 512: 128, 1024: 512}[seq]
    table_bf16 = torch.from_numpy(table).to(torch.bfloat16).float().numpy()
    inside = rounded < rows
    assert out["port"].dtype == out["jax"].dtype == np.float32
    np.testing.assert_array_equal(out["jax"][inside],
                                  table_bf16[rounded[inside]])
    np.testing.assert_array_equal(out["port"][inside], out["jax"][inside])
    past = np.flatnonzero(~inside)
    assert list(past) == {384: [], 512: [511], 1024: [1022, 1023]}[seq]
    assert np.isnan(out["jax"][past]).all()
    np.testing.assert_array_equal(out["port"][past],
                                  table_bf16[np.full(len(past), rows - 1)])


# -- the executor's contract --------------------------------------------------------

def test_int_feeds_stay_exact_and_float_feeds_round():
    """Integer ids above 256 look up their own rows; a float32 feed is
    rounded to bf16 inside the step and fetched back as float32."""
    ids = tht.placeholder_op("ids", dtype=np.int32)
    x = tht.placeholder_op("x")
    table = np.random.RandomState(0).randn(4096, 4).astype(np.float32)
    tab = tht.Variable("table", value=table, trainable=False)
    ex = tht.Executor([tht.embedding_lookup_op(tab, ids), x * 1.0],
                      compute_dtype="bfloat16", device="cpu")
    want_ids = np.array([257, 1001, 4095], np.int32)
    xv = np.array([1.0 + 2 ** -9, 300.7, -3.14159], np.float32)
    rows, xs = ex.run(feed_dict={ids: want_ids.astype(np.float64), x: xv},
                      convert_to_numpy_ret_vals=True)
    bf = torch.bfloat16
    np.testing.assert_array_equal(
        rows, torch.from_numpy(table[want_ids]).to(bf).float().numpy())
    np.testing.assert_array_equal(
        xs, torch.from_numpy(xv).to(bf).float().numpy())
    assert rows.dtype == xs.dtype == np.float32
    assert xs[0] == 1.0                      # 1 + 2^-9 rounds in bf16


@pytest.mark.parametrize("cd", ["float16", torch.float16, "float32"])
def test_other_compute_dtypes_are_refused_by_name(cd):
    x = tht.placeholder_op("x")
    with pytest.raises(NotImplementedError, match="compute_dtype"):
        tht.Executor([x * 2.0], compute_dtype=cd, device="cpu")
    for ok in ("bfloat16", torch.bfloat16, None):
        tht.Executor([x * 2.0], compute_dtype=ok, device="cpu")


def test_ps_subgraphs_take_compute_dtype_and_keep_float32_rows():
    """PS embeddings train in bf16 (tests/test_torch_ctr_models.py holds
    Wide & Deep against the JAX package's): the slab stays float32, the
    rows are cast inside the step, and the summed row gradient (B5's
    output) reaches the cache as float32.  ``num_microbatches`` with PS
    embeddings stays refused by name."""
    ids = tht.placeholder_op("ids", dtype=np.int64)
    st = tht.EmbeddingStore()
    t = st.init_table(10, 4, opt="sgd", lr=1.0, init_scale=0.1)
    before = st.get_data(t)
    cache = tht.DistCacheTable(st, t, limit=4, push_bound=1, device=True,
                               slab_device="cpu")
    e = tht.ps_embedding_lookup_op(cache, ids)
    w = tht.Variable("w_psbf", value=np.ones((4, 1), np.float32))
    loss = tht.reduce_sum_op(tht.matmul_op(tht.array_reshape_op(
        e, (-1, 4)), w))
    ex = tht.Executor([loss, tht.optim.SGDOptimizer(0.5).minimize(loss)],
                      compute_dtype="bfloat16", device="cpu")
    ex.run(feed_dict={ids: np.asarray([[1, 2], [2, 3]], np.int64)})
    assert cache._ensure_dev_slab().dtype == torch.float32
    # d loss / d row = w = 1 an occurrence: row 2 moved twice, 1 and 3 once
    moved = before - st.get_data(t)
    np.testing.assert_array_equal(moved[[1, 2, 3], 0], [1.0, 2.0, 1.0])
    with pytest.raises(NotImplementedError, match="num_microbatches"):
        tht.Executor([loss, tht.optim.SGDOptimizer(0.5).minimize(loss)],
                     compute_dtype="bfloat16", device="cpu",
                     num_microbatches=2)


# -- ResNet-18 (BASELINE config 1) -------------------------------------------
#: ResNet-18's batch here: tests/test_torch_cnn.py's float32 parity batch
RESNET_BATCH = 2
#: the port's bf16 gradient may lie at most this many times as far from the
#: JAX package's bf16 gradient as that lies from the JAX float32 one (a
#: relative norm, floored at GRAD_TOL's rtol); see the ResNet test
RESNET_SPREAD_RATIO = 1.5


def _resnet_step(jax_side, compute_dtype, weights):
    """(loss, [(name, step-1 gradient)], running statistics after the step)
    of ResNet-18 (NCHW, batch 2, bench.py's feeds) in one package under
    ``compute_dtype``, from ``weights`` (None: the JAX package's seed-0
    init, returned as the fourth item)."""
    ht = jht if jax_side else tht
    topo = jax_topo if jax_side else tht.topo_sort
    x = ht.placeholder_op("x", shape=(RESNET_BATCH, 3, 32, 32))
    y = ht.placeholder_op("y", shape=(RESNET_BATCH, 10))
    models = jax_cnn_models() if jax_side else tht.models
    loss, _ = models.resnet18(x, y)
    wrt = [n for n in topo([loss]) if getattr(n, "is_variable", False)
           and n.trainable]
    fetches = [loss, ht.optim.MomentumOptimizer(0.1).minimize(loss)] \
        + ht.gradients(loss, wrt)
    kw = {"validate": "off"} if jax_side else {"device": "cpu"}
    ex = ht.Executor({"train": fetches}, seed=0,
                     compute_dtype=compute_dtype, **kw)
    if weights is None:
        weights = ex.return_tensor_values()
    else:
        ex.load_dict(weights)
    rng = np.random.RandomState(0)
    xv = rng.rand(RESNET_BATCH, 3, 32, 32).astype(np.float32)
    yv = np.eye(10, dtype=np.float32)[rng.randint(0, 10, RESNET_BATCH)]
    out = ex.run("train", feed_dict={x: xv, y: yv})
    grads = [(n.name, np.asarray(g.asnumpy())) for n, g in zip(wrt, out[2:])]
    stats = {k: v for k, v in ex.return_tensor_values().items()
             if "_running_" in k}
    return float(np.asarray(out[0].asnumpy())), grads, stats, weights


@pytest.fixture(scope="module")
def resnet_bf16():
    j32 = _resnet_step(True, None, None)
    weights = j32[3]
    return {"j32": j32, "j16": _resnet_step(True, "bfloat16", weights),
            "t16": _resnet_step(False, "bfloat16", weights)}


def _relnorm(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_resnet18_step_one_loss_matches_jax_bf16(resnet_bf16):
    np.testing.assert_allclose(resnet_bf16["t16"][0], resnet_bf16["j16"][0],
                               rtol=LOSS_RTOL)


def test_resnet18_bf16_gradients_and_stats_lie_within_bf16s_own_spread(
        resnet_bf16):
    """ResNet-18 at full width, batch 2, from the JAX package's weights, one
    ``MomentumOptimizer(0.1)`` step in bf16 in both packages and in float32
    in the JAX package.  ``GRAD_TOL`` cannot hold here, in either package:
    the JAX package's own bf16 gradients lie a relative norm of 0.004
    (the head's bias) to 0.58 (a stage-0 BatchNorm bias) from its float32
    ones, growing from the head (0.02) to the stem (0.44) as the backward
    runs through 20 BatchNorms whose gradient (dy - mean(dy) - x_hat *
    mean(dy * x_hat)) cancels nearly equal terms after bf16 rounding; 55
    of the 62 gradients fail ``GRAD_TOL`` against the JAX package's own
    float32 run.  The port's bf16 gradients lie 0.009 to 0.58 from the
    JAX package's bf16 ones.  So each is held to the spread of bf16
    itself: its relative norm to the JAX bf16 gradient at most
    ``RESNET_SPREAD_RATIO`` (1.5) times the JAX package's bf16-to-float32
    one, floored at ``GRAD_TOL``'s rtol (measured: at most 1.09 times,
    0.73 of the gate, at ``s1b1_bn2_bias``; the head's bias 0.009 against
    the 0.02 floor).  The running statistics after the step by the same
    rule (0.61 of the gate at most: ``bn_running_var~19``, 0.018 against
    the 0.02 floor).  The step-1 loss holds ``LOSS_RTOL`` (2.9375 in
    both)."""
    _, j32, s32, _ = resnet_bf16["j32"]
    _, j16, s16, _ = resnet_bf16["j16"]
    _, t16, st16, _ = resnet_bf16["t16"]
    assert [n for n, _ in t16] == [n for n, _ in j16]
    for (name, g32), (_, g16), (_, tg) in zip(j32, j16, t16):
        assert tg.dtype == np.float32, name          # the masters' dtype
        spread = max(_relnorm(g16, g32), GRAD_TOL["rtol"])
        assert _relnorm(tg, g16) <= RESNET_SPREAD_RATIO * spread, \
            (name, _relnorm(tg, g16), spread)
    assert sorted(st16) == sorted(s16) and len(st16) == 40
    for name in s16:
        spread = max(_relnorm(s16[name], s32[name]), GRAD_TOL["rtol"])
        assert _relnorm(st16[name], s16[name]) <= \
            RESNET_SPREAD_RATIO * spread, name
