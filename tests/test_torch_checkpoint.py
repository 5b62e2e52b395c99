"""Checkpoints of the port (``graph/checkpoint.py``, ``ps/store.py``)
against the JAX package's ``hetu_tpu.ckpt.v1`` format.

* Tiny BERT (``tests/test_torch_bert.py``'s configuration, Adam under a
  Cosine schedule): a directory the JAX package wrote loads in the port
  and the next 3 steps match the JAX continuation at that file's gates
  (rtol 1e-5), and a port directory loads in the JAX package the same
  way; both packages' ``meta.json`` for the graph name the same
  parameters, the same optimizer leaves (``jax.tree_util.keystr``) and
  the same files, with the same shapes and dtypes.
* The port's own save → load → continue is bit-equal to the
  uninterrupted run (dropout on: the masks come from (seed, step)), in the
  directory form and the ``file=`` blob; a JAX blob loads in the port;
  ``params_only`` restores parameters and nothing else; a ``DataloaderOp``
  resumes at its next batch.
* A PS table's v3 file is byte for byte the JAX package's numpy table's
  for the same state, and each store loads the other's; Wide & Deep
  through the device cache (a CPU slab) saves, loads into a fresh graph
  and store, and continues bit-equal to the uninterrupted run.  The cache
  pushes every step there (``push_bound=1``): with a larger bound the
  cache holds gradient rows that a checkpoint (here as in the JAX
  package) flushes to the store, so the saving run itself leaves the
  uninterrupted trajectory.
* Auto-save, retention, the atomic manifest, stranded renames,
  ``auto_resume`` and the SIGTERM save mirror ``tests/test_chaos.py``.
* The warm start mirrors ``tests/test_models.py``'s
  ``bert_classify_graph`` case."""
import glob
import json
import os
import signal
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hetu_tpu as jht                                     # noqa: E402
from hetu_tpu.models import bert as jbert                 # noqa: E402
import hetu_tpu_torch as tht                              # noqa: E402
from hetu_tpu_torch import metrics as tmetrics            # noqa: E402

BERT_CFG = dict(batch_size=2, seq_len=24, hidden_size=32,
                intermediate_size=64, vocab_size=96, num_hidden_layers=2,
                num_attention_heads=2, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)
RTOL = 1e-5


def _bert(ht, models, device=None, dropout=0.0, **kw):
    cfg = models.BertConfig.tiny(**dict(
        BERT_CFG, hidden_dropout_prob=dropout,
        attention_probs_dropout_prob=dropout))
    feeds, loss, _ = models.bert_pretrain_graph(cfg)
    opt = ht.optim.AdamOptimizer(ht.optim.CosineScheduler(1e-3, 2, 8))
    kw.update({"validate": "off"} if device is None else {"device": device})
    ex = ht.Executor({"train": [loss, opt.minimize(loss)]}, seed=0, **kw)
    ids, tt, labels, attn = jbert.synthetic_mlm_batch(cfg, seed=0)
    fd = {feeds["input_ids"]: ids, feeds["token_type_ids"]: tt,
          feeds["masked_lm_labels"]: labels, feeds["attention_mask"]: attn}
    return ex, fd


def _steps(ex, fd, n):
    return [float(np.asarray(ex.run("train", feed_dict=fd)[0].asnumpy()))
            for _ in range(n)]


@pytest.fixture(scope="module")
def bert_ckpts(tmp_path_factory):
    """Both packages from the JAX weights, 3 steps, saved; then each
    continues 3 steps.  Returns the paths and trajectories."""
    d = str(tmp_path_factory.mktemp("bert_ckpt"))
    jex, jfd = _bert(jht, jbert)
    tex, tfd = _bert(tht, tht.models, device="cpu")
    tex.load_dict(jex.return_tensor_values())
    out = {"jax_first": _steps(jex, jfd, 3), "port_first": _steps(tex, tfd, 3)}
    jex.save(os.path.join(d, "jax"))
    tex.save(os.path.join(d, "port"))
    out["jax_next"] = _steps(jex, jfd, 3)
    out["port_next"] = _steps(tex, tfd, 3)
    out["dir"] = d
    return out


def test_meta_names_the_same_parameters_leaves_and_files(bert_ckpts):
    d = bert_ckpts["dir"]
    metas = []
    for who in ("jax", "port"):
        with open(os.path.join(d, who, "meta.json")) as f:
            metas.append(json.load(f))
    mj, mt = metas
    assert mt["format"] == mj["format"] == "hetu_tpu.ckpt.v1"
    assert (mt["step"], mt["seed"]) == (mj["step"], mj["seed"]) == (3, 0)
    assert mt["params"] == mj["params"]
    assert [e["leaves"] for e in mt["opt"]] == [e["leaves"] for e in mj["opt"]]
    assert "['m']['bert.layer0.attn.q.weight']" in mt["opt"][0]["leaves"]
    assert "['t']" in mt["opt"][0]["leaves"]
    assert sorted(mt["manifest"]) == sorted(mj["manifest"])
    for rel in mj["manifest"]:
        a = np.load(os.path.join(d, "jax", rel))
        b = np.load(os.path.join(d, "port", rel))
        assert (a.shape, a.dtype) == (b.shape, b.dtype), rel
    t = np.load(os.path.join(d, "port", "opt",
                             mt["opt"][0]["leaves"]["['t']"]))
    assert t.shape == () and t.dtype == np.int32 and int(t) == 3


def test_jax_checkpoint_continues_in_the_port(bert_ckpts):
    tex, tfd = _bert(tht, tht.models, device="cpu")
    tex.load(os.path.join(bert_ckpts["dir"], "jax"))
    assert tex.step_counter == 3
    np.testing.assert_allclose(_steps(tex, tfd, 3), bert_ckpts["jax_next"],
                               rtol=RTOL, atol=0)


def test_port_checkpoint_continues_in_jax(bert_ckpts):
    jex, jfd = _bert(jht, jbert)
    jex.load(os.path.join(bert_ckpts["dir"], "port"))
    assert jex.step_counter == 3
    np.testing.assert_allclose(_steps(jex, jfd, 3), bert_ckpts["port_next"],
                               rtol=RTOL, atol=0)
    np.testing.assert_allclose(bert_ckpts["port_next"],
                               bert_ckpts["jax_next"], rtol=RTOL, atol=0)


@pytest.mark.parametrize("form", ["dir", "blob"])
def test_save_load_continue_is_bit_equal(tmp_path, form):
    base, fd = _bert(tht, tht.models, device="cpu", dropout=0.1)
    want = _steps(base, fd, 6)
    ex, fd = _bert(tht, tht.models, device="cpu", dropout=0.1)
    assert _steps(ex, fd, 3) == want[:3]
    kw = {"file": "ck.pkl"} if form == "blob" else {}
    ex.save(str(tmp_path / "ck"), **kw)
    fresh, fd2 = _bert(tht, tht.models, device="cpu", dropout=0.1)
    fresh.load(str(tmp_path / "ck"), **kw)
    assert fresh.step_counter == 3
    assert _steps(fresh, fd2, 3) == want[3:]
    for a, b in zip(base.return_tensor_values().values(),
                    fresh.return_tensor_values().values()):
        np.testing.assert_array_equal(a, b)


def test_jax_blob_loads_in_the_port(tmp_path, bert_ckpts):
    jex, jfd = _bert(jht, jbert)
    _steps(jex, jfd, 3)
    jex.save(str(tmp_path), file="ck.pkl")
    want = _steps(jex, jfd, 3)
    tex, tfd = _bert(tht, tht.models, device="cpu")
    tex.load(str(tmp_path), file="ck.pkl")
    assert tex.step_counter == 3
    np.testing.assert_allclose(_steps(tex, tfd, 3), want, rtol=RTOL, atol=0)


def test_params_only_restores_parameters_and_nothing_else(bert_ckpts):
    path = os.path.join(bert_ckpts["dir"], "port")
    ex, _ = _bert(tht, tht.models, device="cpu")
    ex.load(path, params_only=True)
    assert ex.step_counter == 0
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    vals = ex.return_tensor_values()
    for name, fn in meta["params"].items():
        np.testing.assert_array_equal(
            vals[name], np.load(os.path.join(path, "params", fn)))
    st = next(iter(ex.opt_states.values()))
    assert int(st["t"]) == 0
    assert all(float(abs(m).max()) == 0.0 for m in st["m"].values())


def _dl_mlp(ht, rows, **kw):
    rng = np.random.RandomState(3)
    x = ht.dataloader_op([ht.Dataloader(rows[0], 4, "train")])
    y_ = ht.dataloader_op([ht.Dataloader(rows[1], 4, "train")])
    w = ht.Variable("w", value=rng.randn(6, 3).astype(np.float32) * .3)
    loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(
        ht.matmul_op(x, w), y_), [0])
    return ht.Executor(
        {"train": [loss, ht.optim.SGDOptimizer(0.1).minimize(loss)]},
        seed=0, device="cpu", **kw)


def test_dataloader_cursor_resumes_at_the_next_batch(tmp_path):
    rng = np.random.RandomState(0)
    rows = (rng.randn(40, 6).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.randint(0, 3, 40)])

    def run(ex, n):
        return [float(ex.run("train")[0].asnumpy()) for _ in range(n)]

    want = run(_dl_mlp(tht, rows), 7)
    ex = _dl_mlp(tht, rows)
    assert run(ex, 4) == want[:4]
    ex.save(str(tmp_path / "ck"))
    with open(tmp_path / "ck" / "meta.json") as f:
        assert [st["train"]["consumed"]
                for st in json.load(f)["dataloaders"]] == [4, 4]
    fresh = _dl_mlp(tht, rows)
    fresh.load(str(tmp_path / "ck"))
    assert run(fresh, 3) == want[4:]


# -- PS tables -------------------------------------------------------------------

def _pushed(store, table):
    rng = np.random.RandomState(5)
    for _ in range(3):
        keys = rng.randint(0, 50, 32)
        store.push(table, keys, rng.randn(32, 8).astype(np.float32))


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_ps_v3_file_is_the_jax_numpy_tables(tmp_path, monkeypatch, opt):
    from hetu_tpu.ps import store as jstore
    monkeypatch.setattr(jstore, "get_lib", lambda: None)
    js, ts = jstore.EmbeddingStore(), tht.EmbeddingStore()
    jt = js.init_table(50, 8, opt=opt, lr=0.05, seed=2)
    tt = ts.init_table(50, 8, opt=opt, lr=0.05, seed=2)
    _pushed(js, jt)
    _pushed(ts, tt)
    js.save(jt, str(tmp_path / "j.bin"))
    ts.save(tt, str(tmp_path / "t.bin"))
    assert (tmp_path / "j.bin").read_bytes() == \
        (tmp_path / "t.bin").read_bytes()
    # each store loads the other's file: the state round-trips
    js2, ts2 = jstore.EmbeddingStore(), tht.EmbeddingStore()
    jt2 = js2.init_table(50, 8, opt=opt, lr=0.05, seed=9)
    tt2 = ts2.init_table(50, 8, opt=opt, lr=0.05, seed=9)
    ts2.load(tt2, str(tmp_path / "j.bin"))
    js2.load(jt2, str(tmp_path / "t.bin"))
    np.testing.assert_array_equal(ts2.get_data(tt2), js.get_data(jt))
    keys = np.arange(50)
    np.testing.assert_array_equal(ts2.versions(tt2, keys),
                                  js.versions(jt, keys))
    ts2.save(tt2, str(tmp_path / "t2.bin"))
    js2.save(jt2, str(tmp_path / "j2.bin"))
    assert (tmp_path / "t2.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes() == \
        (tmp_path / "j2.bin").read_bytes()


def test_ps_store_reads_the_older_formats(tmp_path):
    ts = tht.EmbeddingStore()
    t = ts.init_table(10, 4, opt="adam", seed=1)
    _data = np.arange(40, dtype=np.float32).reshape(10, 4)
    np.save(str(tmp_path / "v1.npy"), _data)
    ts.load(t, str(tmp_path / "v1.npy"))
    np.testing.assert_array_equal(ts.get_data(t), _data)
    np.savez(str(tmp_path / "v2.npz"), data=_data + 1,
             version=np.full(10, 7, np.int64), t=np.full(10, 2, np.int32))
    ts.load(t, str(tmp_path / "v2.npz"))
    np.testing.assert_array_equal(ts.get_data(t), _data + 1)
    assert list(ts.versions(t, np.arange(3))) == [7, 7, 7]


WDL_VOCAB, WDL_DIM, WDL_BATCH = 520, 4, 8


def _wdl():
    dense = tht.placeholder_op("dense")
    sparse = tht.placeholder_op("sparse", dtype=np.int64)
    y_ = tht.placeholder_op("y")
    loss, _ = tht.models.ctr.wdl_criteo(
        dense, sparse, y_, WDL_BATCH, vocab=WDL_VOCAB, dim=WDL_DIM,
        embed_mode="vlru_dev", lr=0.01, slab_device="cpu")
    ex = tht.Executor(
        {"train": [loss, tht.optim.SGDOptimizer(0.01).minimize(loss)]},
        seed=0, device="cpu")
    ex.subexecutors["train"].ps_nodes[0].cache.push_bound = 1
    return (dense, sparse, y_), ex


def _wdl_steps(feeds, ex, batches):
    return [float(ex.run("train", feed_dict=dict(zip(feeds, b)))[0]
                  .asnumpy()) for b in batches]


def test_wdl_device_cache_save_load_continue_is_bit_equal(tmp_path):
    d, s, y = tht.synthetic_criteo_skewed(6 * WDL_BATCH, vocab=WDL_VOCAB)
    batches = [(d[i * WDL_BATCH:(i + 1) * WDL_BATCH],
                s[i * WDL_BATCH:(i + 1) * WDL_BATCH],
                y[i * WDL_BATCH:(i + 1) * WDL_BATCH]) for i in range(6)]
    want = _wdl_steps(*_wdl(), batches)
    feeds, ex = _wdl()
    assert _wdl_steps(feeds, ex, batches[:3]) == want[:3]
    ex.save(str(tmp_path / "ck"))
    with open(tmp_path / "ck" / "meta.json") as f:
        assert [e["file"] for e in json.load(f)["ps_tables"]] == ["ps0.bin"]
    feeds2, fresh = _wdl()
    fresh.load(str(tmp_path / "ck"))
    assert _wdl_steps(feeds2, fresh, batches[3:]) == want[3:]


def test_save_flushes_the_cache_pending_rows(tmp_path):
    feeds, ex = _wdl()
    cache = ex.subexecutors["train"].ps_nodes[0].cache
    cache.push_bound = 100           # keep the gradients in the cache
    d, s, y = tht.synthetic_criteo_skewed(2 * WDL_BATCH, vocab=WDL_VOCAB)
    _wdl_steps(feeds, ex, [(d[:8], s[:8], y[:8]), (d[8:], s[8:], y[8:])])
    assert int((cache._gcnt > 0).sum()) > 0
    before = cache.store.get_data(cache.table)
    ex.save(str(tmp_path / "ck"))
    assert int((cache._gcnt > 0).sum()) == 0
    assert not np.array_equal(cache.store.get_data(cache.table), before)


# -- auto-save, resume, preemption (tests/test_chaos.py) -----------------------

def _dense_executor(**kw):
    rng = np.random.RandomState(3)
    x = tht.placeholder_op("x")
    y_ = tht.placeholder_op("y")
    w1 = tht.Variable("w1", value=rng.randn(16, 32).astype(np.float32) * .1)
    w2 = tht.Variable("w2", value=rng.randn(32, 4).astype(np.float32) * .1)
    loss = tht.reduce_mean_op(tht.softmaxcrossentropy_op(
        tht.matmul_op(tht.relu_op(tht.matmul_op(x, w1)), w2), y_), [0])
    kw.setdefault("install_signal_handlers", False)
    ex = tht.Executor(
        {"train": [loss, tht.optim.AdamOptimizer(0.01).minimize(loss)]},
        seed=0, device="cpu", **kw)
    return ex, x, y_


def _dense_feeds(n):
    rng = np.random.RandomState(0)
    return [(rng.randn(8, 16).astype(np.float32),
             np.eye(4, dtype=np.float32)[rng.randint(0, 4, 8)])
            for _ in range(n)]


def _run_steps(ex, x, y_, feeds):
    return [float(ex.run("train", feed_dict={x: f[0], y_: f[1]}
                         )[0].asnumpy()) for f in feeds]


@pytest.fixture(autouse=True)
def _faults():
    tmetrics.reset_faults()
    yield
    tmetrics.reset_faults()


def test_autosave_resume_exact_continuation(tmp_path):
    feeds = _dense_feeds(6)
    base = _run_steps(*_dense_executor(), feeds)
    d = str(tmp_path / "autosave")
    ex1, x1, y1 = _dense_executor(auto_save_dir=d, auto_save_every=2)
    assert _run_steps(ex1, x1, y1, feeds[:3]) == base[:3]
    assert tmetrics.fault_counts().get("auto_save", 0) == 1      # step 2
    ex2, x2, y2 = _dense_executor()
    assert ex2.resume(d) == 2
    assert _run_steps(ex2, x2, y2, feeds[2:]) == base[2:]
    assert tmetrics.fault_counts().get("resume", 0) == 1


def test_autosave_retention_keeps_last_n(tmp_path, monkeypatch):
    d = str(tmp_path / "keep")
    monkeypatch.setenv("HETU_AUTO_SAVE_DIR", d)
    monkeypatch.setenv("HETU_AUTO_SAVE_EVERY", "1")
    monkeypatch.setenv("HETU_AUTO_SAVE_KEEP", "2")
    ex, x, y_ = _dense_executor()
    _run_steps(ex, x, y_, _dense_feeds(5))
    left = sorted(os.path.basename(p)
                  for p in glob.glob(os.path.join(d, "ckpt-*")))
    assert left == ["ckpt-00000004", "ckpt-00000005"], left


def test_truncated_checkpoint_rejected(tmp_path):
    d = str(tmp_path / "trunc")
    ex, x, y_ = _dense_executor(auto_save_dir=d, auto_save_every=1,
                                auto_save_keep=10)
    _run_steps(ex, x, y_, _dense_feeds(4))
    ck4 = os.path.join(d, "ckpt-00000004")
    with open(os.path.join(ck4, "meta.json")) as f:
        rel = sorted(json.load(f)["manifest"])[0]
    with open(os.path.join(ck4, rel), "r+b") as f:
        f.truncate(2)                               # cut mid-write
    os.remove(os.path.join(d, "ckpt-00000003", "meta.json"))
    assert not tht.Executor._checkpoint_complete(ck4)
    ex2, _, _ = _dense_executor()
    with pytest.warns(RuntimeWarning, match="incomplete"):
        assert ex2.resume(d) == 2
    assert tmetrics.fault_counts().get("ckpt_incomplete_skipped", 0) >= 2


def test_auto_resume_at_construction(tmp_path, monkeypatch):
    feeds = _dense_feeds(6)
    base = _run_steps(*_dense_executor(), feeds)
    d = str(tmp_path / "ar")
    ex1, x1, y1 = _dense_executor(auto_save_dir=d, auto_save_every=1)
    _run_steps(ex1, x1, y1, feeds[:4])
    monkeypatch.setenv("HETU_AUTO_RESUME", "1")
    monkeypatch.setenv("HETU_AUTO_SAVE_DIR", d)
    ex2, x2, y2 = _dense_executor()     # no resume() call
    assert ex2.step_counter == 4
    assert _run_steps(ex2, x2, y2, feeds[4:]) == base[4:]


def test_resume_recovers_stranded_rename_checkpoint(tmp_path):
    d = str(tmp_path / "stranded")
    ex, x, y_ = _dense_executor(auto_save_dir=d, auto_save_every=1)
    _run_steps(ex, x, y_, _dense_feeds(2))
    ck2 = os.path.join(d, "ckpt-00000002")
    os.rename(ck2, ck2 + ".replaced")   # cut between the two renames
    ex2, _, _ = _dense_executor()
    assert ex2.resume(d) == 2           # not 1: the remnant is newer


def test_overwriting_save_and_stale_work_dir(tmp_path):
    path = str(tmp_path / "ck")
    ex, x, y_ = _dense_executor()
    feeds = _dense_feeds(2)
    _run_steps(ex, x, y_, feeds[:1])
    os.makedirs(path + ".saving")       # a cut save's leftovers
    ex.save(path)
    _run_steps(ex, x, y_, feeds[1:])
    ex.save(path)                       # through <path>.replaced
    assert not os.path.exists(path + ".saving")
    assert not os.path.exists(path + ".replaced")
    ex2, _, _ = _dense_executor()
    assert ex2.resume(path) == 2


def test_resume_empty_dir_returns_none(tmp_path):
    ex, _, _ = _dense_executor()
    assert ex.resume(str(tmp_path)) is None
    assert ex.step_counter == 0


def test_sigterm_triggers_emergency_save(tmp_path):
    d = str(tmp_path / "emerg")
    feeds = _dense_feeds(1)
    ex, x, y_ = _dense_executor(auto_save_dir=d,
                                install_signal_handlers=None)
    try:
        assert ex._installed_handlers
        ex.run("train", feed_dict={x: feeds[0][0], y_: feeds[0][1]})
        with pytest.raises(SystemExit) as ei:
            signal.raise_signal(signal.SIGTERM)
        assert ei.value.code == 143                 # 128 + SIGTERM
        ck = os.path.join(d, "ckpt-00000001")
        assert tht.Executor._checkpoint_complete(ck)
        assert tmetrics.fault_counts().get("emergency_save", 0) == 1
    finally:
        ex.uninstall_signal_handlers()
    assert not ex._installed_handlers
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL


def test_signal_during_a_step_saves_at_its_end(tmp_path):
    d = str(tmp_path / "defer")
    ex, x, y_ = _dense_executor(auto_save_dir=d)
    feeds = _dense_feeds(1)
    ex._prev_handlers[signal.SIGTERM] = signal.SIG_IGN   # save, continue
    ex._in_step = True
    ex._on_preempt(signal.SIGTERM, None)
    assert not glob.glob(os.path.join(d, "ckpt-*"))   # deferred
    ex._in_step = False
    ex.run("train", feed_dict={x: feeds[0][0], y_: feeds[0][1]})
    assert tht.Executor._checkpoint_complete(
        os.path.join(d, "ckpt-00000001"))


# -- warm start (tests/test_models.py) ---------------------------------------------

def test_bert_finetune_warm_starts_from_pretrain_checkpoint(tmp_path):
    cfg = tht.BertConfig.tiny(batch_size=4, seq_len=16, vocab_size=64,
                              hidden_size=32, intermediate_size=64,
                              num_hidden_layers=1, hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    feeds, loss, _ = tht.bert_pretrain_graph(cfg)
    ex = tht.Executor({"train": [loss, tht.optim.AdamOptimizer(1e-3)
                                 .minimize(loss)]}, seed=0, device="cpu")
    ids, tt, labels, attn = tht.synthetic_mlm_batch(cfg)
    fd = {feeds["input_ids"]: ids, feeds["token_type_ids"]: tt,
          feeds["masked_lm_labels"]: labels, feeds["attention_mask"]: attn}
    for _ in range(3):
        ex.run("train", feed_dict=fd)
    ckpt = str(tmp_path / "pretrain_ckpt")
    ex.save(ckpt)
    trunk = {n: v.copy() for n, v in ex.return_tensor_values().items()
             if n.startswith("bert.")}

    feeds2, loss2, _ = tht.bert_classify_graph(cfg, num_labels=3)
    ex2 = tht.Executor({"train": [loss2, tht.optim.AdamOptimizer(1e-3)
                                  .minimize(loss2)]}, seed=11, device="cpu")
    before = ex2.return_tensor_values()["bert.layer0.attn.q.weight"].copy()
    ex2.load(ckpt, params_only=True)
    assert ex2.step_counter == 0
    after = ex2.return_tensor_values()
    for name in after:
        if name in trunk:
            np.testing.assert_array_equal(after[name], trunk[name])
    assert not np.array_equal(before, trunk["bert.layer0.attn.q.weight"])
    assert "bert.classifier.weight" in after
    assert "bert.mlm_decoder.weight" not in after

    rng = np.random.RandomState(7)
    f_ids = rng.randint(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    fd2 = {feeds2["input_ids"]: f_ids,
           feeds2["token_type_ids"]: np.zeros((4, 16), np.int32),
           feeds2["labels"]: (f_ids[:, 0] % 3).astype(np.int32),
           feeds2["attention_mask"]: np.ones((4, 16), np.int32)}
    hist = [float(ex2.run("train", feed_dict=fd2)[0].asnumpy())
            for _ in range(30)]
    assert np.isfinite(hist).all() and hist[-1] < hist[0]


def test_classify_graph_matches_jax_names_and_ops():
    cfg = dict(batch_size=2, seq_len=8, vocab_size=32, hidden_size=16,
               intermediate_size=32, num_hidden_layers=1)
    _, jloss, _ = jbert.bert_classify_graph(jbert.BertConfig.tiny(**cfg), 3)
    _, tloss, _ = tht.bert_classify_graph(tht.BertConfig.tiny(**cfg), 3)
    from hetu_tpu.graph.node import topo_sort as jtopo
    jt, tt = jtopo([jloss]), tht.topo_sort([tloss])
    assert [n.op_type for n in tt] == [n.op_type for n in jt]
    assert [n.name for n in tt if isinstance(n, tht.PlaceholderOp)] == \
        [n.name for n in jt if isinstance(n, jht.PlaceholderOp)]
