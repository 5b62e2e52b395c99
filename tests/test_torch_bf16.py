"""bf16 mixed precision in the port (``Executor(compute_dtype="bfloat16")``)
against the JAX package's.

Both packages cast every float32 variable and feed to bf16 inside the
step, keep float32 masters, optimizer state and fetches, and leave
integer feeds alone.  Here on the CPU the port's attention takes
``sdpa_reference`` (its ``ScoresF32`` twin of the JAX package's
``_scores_f32``), as the JAX package's does; the bf16 flash kernels are
held to their plain versions in tests/test_torch_flash_attention.py (and
on the card in tests/test_torch_kernels_gpu.py).

Tiny BERT (MLM, MLM + NSP) and tiny GPT-2 start from the JAX package's
weights and take the same feeds.  XLA on the CPU fuses a bf16 elementwise
chain and rounds once (it may even keep the float32 value of a bf16 node:
GPT-2's fetched loss is not a bf16 number there), torch rounds after every
op, so the two agree to bf16 tolerances, not bit for bit.  The tolerances
come from the measured spread:

* losses (step 1 and 3 Adam steps): rtol 5e-3 (measured: at most 2.2e-3,
  GPT-2; BERT 0 and 1.6e-3);
* step-1 gradients of every variable: ``allclose(rtol=2e-2, atol=1e-2)``
  (measured at rtol 2e-2: atol 5.6e-3 needed at most, BERT's token-type
  table; the key biases' gradients are rounding noise around an exact 0);
* the port's bf16 run against its own float32 run, 3 Adam losses:
  ``test_bf16_parity.py``'s budget, rtol 5e-2 / atol 5e-2 (measured: at
  most 5.3e-3 relative)."""
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
import hetu_tpu_torch as tht                               # noqa: E402

BERT_CFG = dict(batch_size=2, seq_len=24, hidden_size=32,
                intermediate_size=64, vocab_size=96, num_hidden_layers=2,
                num_attention_heads=2, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)
GPT2_CFG = dict(batch_size=2, seq_len=24, resid_pdrop=0.0, embd_pdrop=0.0,
                attn_pdrop=0.0)
LOSS_RTOL = 5e-3
GRAD_TOL = dict(rtol=2e-2, atol=1e-2)
PARITY_TOL = dict(rtol=5e-2, atol=5e-2)
STEPS = 3
MODELS = ["bert", "bert_nsp", "gpt2"]


def _graph(jax_side, model):
    """(feeds {name: node}, loss) of a tiny model in one package."""
    if model == "gpt2":
        mod = jgpt2 if jax_side else tht.models
        feeds, loss, _ = mod.gpt2_lm_graph(mod.GPT2Config.tiny(**GPT2_CFG))
    else:
        mod = jbert if jax_side else tht.models
        feeds, loss, _ = mod.bert_pretrain_graph(
            mod.BertConfig.tiny(**BERT_CFG), use_nsp=model == "bert_nsp")
    return feeds, loss


def _feed_values(model):
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
    feeds, loss = _graph(jax_side, model)
    wrt = [n for n in topo([loss]) if getattr(n, "is_variable", False)
           and n.trainable]
    fetches = {"train": [loss, ht.optim.AdamOptimizer(1e-3).minimize(loss)]
               + ht.gradients(loss, wrt)}
    kw = {} if jax_side else {"device": "cpu"}
    ex = ht.Executor(fetches, seed=0, compute_dtype=compute_dtype, **kw)
    return feeds, ex, [n.name for n in wrt]


@pytest.fixture(scope="module", params=MODELS)
def runs(request):
    """The JAX package's bf16 run, the port's bf16 run and the port's
    float32 run of one tiny model, all from the JAX package's weights:
    {run: (losses, step-1 gradients)}, and the variable names."""
    model = request.param
    values = _feed_values(model)
    jfeeds, jex, names = _executor(True, model, "bfloat16")
    weights = jex.return_tensor_values()
    out = {}
    for tag, jax_side, cd in (("jax", True, "bfloat16"),
                              ("port", False, "bfloat16"),
                              ("port_f32", False, None)):
        if jax_side:
            feeds, ex = jfeeds, jex
        else:
            feeds, ex, tnames = _executor(False, model, cd)
            assert tnames == names
            ex.load_dict(weights)
        fd = {feeds[k]: v for k, v in values.items()}
        losses, grads = [], None
        for step in range(STEPS):
            got = ex.run("train", feed_dict=fd)
            losses.append(got[0].asnumpy())
            if step == 0:
                grads = [g.asnumpy() for g in got[2:]]
        if not jax_side:
            masters = list(ex.var_values.values())
            assert all(v.dtype == torch.float32 for v in masters)
            assert ex.step_counter == STEPS
        out[tag] = (losses, grads)
    return model, names, out


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


@pytest.mark.parametrize("model", ["bert_nsp", "gpt2"])
def test_every_node_has_the_jax_packages_dtype(model):
    """Tiny BERT (MLM + NSP, whose graph holds the MLM-only one) and GPT-2
    lowered node by node in both packages at bf16:
    the graphs line up op for op, and every node's output has the JAX
    package's dtype (jnp's promotion: a bf16 sum over an integer count
    plus 1e-6 stays bf16, the port's weak-float rule in
    ops/arithmetic.py)."""
    values = _feed_values(model)
    _, jloss = _graph(True, model)
    _, tloss = _graph(False, model)
    jex = jht.Executor([jloss], seed=0)
    weights = {jex.var_names[n]: np.asarray(v)
               for n, v in jex.var_values.items()}
    jvals, jnodes = _lower_all(True, jloss, weights, values)
    tvals, tnodes = _lower_all(False, tloss, weights, values)
    assert [n.op_type for n in tnodes] == [n.op_type for n in jnodes]
    kinds = set()
    for jn, jv, tv in zip(jnodes, jvals, tvals):
        want = str(jv.dtype)
        got = str(tv.dtype).replace("torch.", "")
        assert got == want, (jn.op_type, jn.name, want, got)
        kinds.add(want)
    assert {"bfloat16", "float32", "int32"} <= kinds


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


def test_ps_and_moe_subgraphs_refuse_compute_dtype_by_name():
    """PS embeddings and the MoE sparse dispatch take float32 only (their
    kernels, B4/B5 and B6, have no bf16 instantiation yet)."""
    ids = tht.placeholder_op("ids", dtype=np.int64)
    st = tht.EmbeddingStore()
    cache = tht.DistCacheTable(st, st.init_table(10, 4), limit=4,
                               device=True, slab_device="cpu")
    ps = tht.reduce_sum_op(tht.ps_embedding_lookup_op(cache, ids))
    with pytest.raises(NotImplementedError, match="PS embeddings"):
        tht.Executor([ps], compute_dtype="bfloat16", device="cpu")
    tht.Executor([ps], device="cpu")                # float32 takes it
    x = tht.placeholder_op("x", shape=(16, 8))
    moe = tht.layers.SparseMoELayer(
        tht.layers.TopKGateSparse(8, 16, 4, k=2, capacity_factor=2.0),
        tht.layers.Expert(4, 8, 16), 8)
    h, aux = moe(x)
    loss = tht.reduce_mean_op(h, [0, 1]) + aux
    with pytest.raises(NotImplementedError, match="MoE sparse dispatch"):
        tht.Executor([loss], compute_dtype="bfloat16", device="cpu")
