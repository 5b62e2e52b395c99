"""MoE under the port's ``DataParallel`` over a gloo world of 2 against
the JAX package's single-process run on the global batch.

A module-scoped fixture spawns world 2 once (the pattern of
``tests/test_torch_parallel.py``); every rank is fed the global batch of
each workload from the JAX package's initial weights, while the JAX
references run in the test process.  Workloads, 3 Adam steps each:

* ``sparse``: the MoE configuration's sparse graph
  (``tools/profile_moe.py::moe_graph``: ``TopKGateSparse`` k 2, capacity
  factor 1.25, ``SparseMoELayer``) cut to 64 tokens, d 16, 4 experts,
  hidden 32, held to the JAX package's dense ``MoELayer`` graph (the same
  routing) and, for its maps, to the JAX package's
  ``_topk_sparse_indices``;
* ``tools/train_moe.py``'s graph (d 32, 256 tokens, 4 experts) with each
  of the gates ``top1``, ``top2``, ``ktop1``, ``sam`` and ``hash``
  (routed on a replicated Variable of the global batch's ids), held to
  ``examples/moe/train_moe.py``'s graph.

Gates: the step-1 loss atol 1e-5, every step-1 gradient ``allclose(rtol
=1e-4, atol=1e-6)``, the losses rtol 1e-5, the step-1 routing maps (the
dense dispatch, the sparse index maps) equal and the combine within rtol
1e-6 / atol 1e-7; both ranks' losses equal.  Each gate's capacity and
queue positions count the global batch: the same gate on rank 1's rows
alone routes otherwise (asserted, so the parity is not vacuous).  On the
CPU the sparse graph's dispatch and combine take the row gather's plain
version, counted once a step a rank.  A hash gate on fed (sharded) ids
gathers them and equals the JAX package's routing of the global ids.
``train_moe --dp 2`` through ``python -m hetu_tpu_torch.launcher``
prints the one-process run's losses.

The rank processes import this module, so JAX is imported only inside
functions."""
import os
import pickle
import sys
import time
import traceback

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import hetu_tpu_torch as tht                                  # noqa: E402
from hetu_tpu_torch.ops import moe as tmoe                    # noqa: E402
from hetu_tpu_torch.tools import profile_moe, train_moe       # noqa: E402
from test_torch_parallel import (JOIN_TIMEOUT, end_world,     # noqa: E402
                                 join_world, spawn_world)

WORLD = 2
STEPS = 3
LOSS1_ATOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_RTOL = 1e-5
GATE_TOL = dict(rtol=1e-6, atol=1e-7)
GATES = ("top1", "top2", "ktop1", "sam", "hash")
WORKLOADS = ("sparse",) + GATES
#: the sparse workload: tokens, d, experts, hidden
SPARSE = (64, 16, 4, 32)
#: train_moe's defaults: d, tokens, experts
D, TOKENS, EXPERTS = 32, 256, 4
#: the hash gate on fed ids: tokens, experts, capacity
HASH_FED = (64, 4, 12)
#: the gate ops whose items are routing maps
ROUTERS = ("TopKGate", "TopKGateSparse", "KTop1Gate", "SAMGate")


def _trainable(loss, topo):
    return [n for n in topo([loss]) if getattr(n, "is_variable", False)
            and n.trainable]


def _route(loss, topo):
    """The gate's outputs in order: its items, or the hash dispatch."""
    return sorted((n for n in topo([loss]) if n.op_type == "HashDispatch"
                   or n.op_type == "Item" and n.inputs[0].op_type in ROUTERS),
                  key=lambda n: getattr(n, "index", 0))


def port_graph(workload):
    """(loss, {feed name: node}) of a workload in the port."""
    if workload == "sparse":
        tokens, d, e, hidden = SPARSE
        g = profile_moe.moe_graph(tokens, True, d=d, experts=e,
                                  hidden=hidden)
    else:
        g = train_moe.build_graph(workload, EXPERTS, D, TOKENS)
    return g["loss"], {"x": g["x"], "y": g["y"]}


def jax_graph(workload):
    """(loss, {feed name: node}, gate) of a workload in the JAX package:
    the sparse one as its dense twin."""
    import hetu_tpu as jht
    from hetu_tpu.layers import Expert, MoELayer, TopKGate
    if workload != "sparse":
        from test_torch_moe_gates import jax_graph as train_moe_graph
        g = train_moe_graph(workload)
        return g["loss"], {"x": g["x"], "y": g["y"]}, g["gate"]
    tokens, d, e, hidden = SPARSE
    x = jht.placeholder_op("x", shape=(tokens, d))
    y_ = jht.placeholder_op("y", shape=(tokens, d))
    gate = TopKGate(d, tokens, e, k=profile_moe.K,
                    capacity_factor=profile_moe.CAPACITY_FACTOR)
    h, aux = MoELayer(gate, Expert(e, d, hidden))(x)
    loss = jht.reduce_mean_op(jht.mul_op(h - y_, h - y_), [0, 1]) \
        + aux * 0.01
    return loss, {"x": x, "y": y_}, gate


def hash_fed_ids():
    return np.random.RandomState(5).randint(-100, 100, size=HASH_FED[0]) \
        .astype(np.int32)


def feeds(workload):
    """{feed name: the global batch}."""
    if workload == "sparse":
        tokens, d = SPARSE[:2]
        rng = np.random.RandomState(0)
        return {"x": rng.randn(tokens, d).astype(np.float32),
                "y": rng.randn(tokens, d).astype(np.float32)}
    g = train_moe.build_graph(workload, EXPERTS, D, TOKENS)
    fd = train_moe.feeds(g, TOKENS, D)
    return {"x": fd[g["x"]], "y": fd[g["y"]]}


def train(ex, fd, steps, n_grads):
    """Losses, step-1 gradients and step-1 route values."""
    losses, grads, route = [], None, None
    for _ in range(steps):
        out = ex.run("train", feed_dict=fd, convert_to_numpy_ret_vals=True)
        losses.append(float(out[0]))
        if grads is None:
            grads = [np.asarray(g) for g in out[2:2 + n_grads]]
            route = [np.asarray(r) for r in out[2 + n_grads:]]
    return {"losses": losses, "grads": grads, "route": route}


# -- the port, on every rank ------------------------------------------------------

def port_workloads(data):
    from hetu_tpu_torch import metrics
    res = {}
    for workload in WORKLOADS:
        loss, nodes = port_graph(workload)
        wrt = _trainable(loss, tht.topo_sort)
        ex = tht.Executor({"train": [loss, tht.optim.AdamOptimizer(1e-3)
                                     .minimize(loss)]
                           + tht.gradients(loss, wrt)
                           + _route(loss, tht.topo_sort)},
                          seed=0, device="cpu",
                          dist_strategy=tht.dist.DataParallel())
        ex.load_dict(data["weights"][workload])
        metrics.reset_moe_fallbacks()
        fd = {nodes[k]: v for k, v in data["feeds"][workload].items()}
        res[workload] = train(ex, fd, STEPS, len(wrt))
        res[workload]["names"] = [n.name for n in wrt]
        res[workload]["fallbacks"] = metrics.moe_fallback_counts()
    # a hash gate on fed (batch-sharded) ids: gathered, routed globally
    ids = tht.placeholder_op("ids", dtype=np.int32)
    ex = tht.Executor([tmoe.hash_dispatch_op(ids, *HASH_FED[1:])],
                      device="cpu", dist_strategy=tht.dist.DataParallel())
    res["hash_fed"] = ex.run(feed_dict={ids: hash_fed_ids()},
                             convert_to_numpy_ret_vals=True)[0]
    return res


def rank_main(rank, world, init_file, out_dir, data_path):
    import torch.distributed as dist
    torch.set_num_threads(1)
    clean = False
    try:
        dist.init_process_group("gloo", init_method="file://" + init_file,
                                rank=rank, world_size=world)
        with open(data_path, "rb") as f:
            data = pickle.load(f)
        res = port_workloads(data)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
        clean = True
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        end_world(clean)


# -- the JAX references, in the test process ---------------------------------------

def jax_references():
    """The weights and feed values (yielded first), then each workload's
    single-process run and its gate's capacity."""
    import hetu_tpu as jht
    from hetu_tpu.graph.node import topo_sort as jtopo
    data = {"weights": {}, "feeds": {}}
    built = {}
    for workload in WORKLOADS:
        loss, nodes, gate = jax_graph(workload)
        wrt = _trainable(loss, jtopo)
        # the sparse twin's maps come from _topk_sparse_indices below
        route = [] if workload == "sparse" else _route(loss, jtopo)
        ex = jht.Executor({"train": [loss, jht.optim.AdamOptimizer(1e-3)
                                     .minimize(loss)]
                           + jht.gradients(loss, wrt) + route}, seed=0,
                          validate="off")
        data["weights"][workload] = {k: np.asarray(v) for k, v in
                                     ex.return_tensor_values().items()}
        data["feeds"][workload] = feeds(workload)
        fd = {nodes[k]: v for k, v in data["feeds"][workload].items()}
        built[workload] = (ex, fd, [n.name for n in wrt],
                           getattr(gate, "gate", gate).capacity)
    yield data
    out = {}
    for workload, (ex, fd, names, cap) in built.items():
        out[workload] = train(ex, fd, STEPS, len(names))
        out[workload].update(names=names, capacity=cap)
    yield out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ref": the JAX runs, "ranks": each rank's results, "data": the
    weights and feeds}."""
    tmp = str(tmp_path_factory.mktemp("moedp"))
    refs = jax_references()
    data = next(refs)
    data_path = os.path.join(tmp, "data.pkl")
    with open(data_path, "wb") as f:
        pickle.dump(data, f)
    deadline = time.monotonic() + JOIN_TIMEOUT
    started = spawn_world(WORLD, tmp, rank_main, data_path)
    try:
        ref = next(refs)
    finally:
        ranks = join_world(*started, deadline)
    return {"ref": ref, "ranks": ranks, "data": data}


# -- the cases ----------------------------------------------------------------------

@pytest.mark.parametrize("workload", WORKLOADS)
def test_moe_under_the_strategy_matches_jax_single_process(runs, workload):
    got, want = runs["ranks"][0][workload], runs["ref"][workload]
    assert got["names"] == want["names"]
    assert abs(got["losses"][0] - want["losses"][0]) <= LOSS1_ATOL
    for name, g, w in zip(want["names"], got["grads"], want["grads"]):
        np.testing.assert_allclose(g, w, err_msg=name, **GRAD_TOL)
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL)
    assert got["losses"][-1] < got["losses"][0]
    assert runs["ranks"][1][workload]["losses"] == got["losses"]


def _jax_sparse_maps(data):
    """The JAX package's index maps of the sparse workload's step 1."""
    import jax
    import jax.numpy as jnp
    from hetu_tpu.ops import moe as jmoe
    x = data["feeds"]["sparse"]["x"]
    wg = data["weights"]["sparse"]["topk_gate.wg"]
    tokens, _, e, _ = SPARSE
    cap = int(np.ceil(profile_moe.K * profile_moe.CAPACITY_FACTOR
                      * tokens / e))
    return [np.asarray(v) for v in jax.jit(
        jmoe._topk_sparse_indices, static_argnums=(1, 2))(
            jnp.asarray(x @ wg), profile_moe.K, cap)]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_routing_maps_are_the_global_batch_s(runs, workload):
    """The step-1 maps every rank returns (its rows gathered) equal the
    JAX single-process run's."""
    for rank in runs["ranks"]:
        got = rank[workload]["route"]
        if workload == "sparse":
            want = _jax_sparse_maps(runs["data"])
            maps = 3                      # token_of_slot, slot_of_token, ...
        else:
            want = runs["ref"][workload]["route"]
            maps = 1                      # the 0/1 dispatch
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            if i < maps:
                np.testing.assert_array_equal(g, w, err_msg=f"output {i}")
            else:
                np.testing.assert_allclose(g, w, err_msg=f"output {i}",
                                           **GATE_TOL)


def _local_and_global(workload, data, cap):
    """Rank 1's routing map from its rows alone, and its rows of the
    global batch's (the port's gate functions on the step-1 logits)."""
    weights, x = data["weights"][workload], data["feeds"][workload]["x"]
    rows = x.shape[0] // WORLD
    if workload == "hash":
        ids = torch.from_numpy(np.array(weights["token_ids"]))
        glob = tmoe._hash_dispatch(None, ids, EXPERTS, cap)
        return tmoe._hash_dispatch(None, ids[rows:], EXPERTS, cap), \
            glob[rows:]
    name = {"sparse": "topk_gate", "top1": "topk_gate", "top2": "topk_gate",
            "ktop1": "ktop1_gate", "sam": "sam_gate"}[workload]
    logits = torch.from_numpy(x @ weights[name + ".wg"])
    fn = {"sparse": lambda lg: tmoe._topk_sparse_indices(lg, 2, cap)[1],
          "top1": lambda lg: tmoe._top1_gating(lg, cap)[0],
          "top2": lambda lg: tmoe._top2_gating(lg, cap)[0],
          "ktop1": lambda lg: tmoe._ktop1_gating(lg, 2, cap)[0],
          "sam": lambda lg: tmoe._sam_gating(lg, 1, cap, 2)[0]}[workload]
    return fn(logits[rows:]), fn(logits)[rows:]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_rank_local_routing_would_differ(runs, workload):
    cap = runs["ref"][workload]["capacity"]
    local, glob = _local_and_global(workload, runs["data"], cap)
    assert local.shape == glob.shape
    assert not torch.equal(local, glob)


def test_sparse_dispatch_ran_once_a_step_a_rank(runs):
    """On the CPU the row gather's plain version, counted by the
    dispatch and the combine once a step on every rank."""
    for rank in runs["ranks"]:
        assert rank["sparse"]["fallbacks"] == {"dispatch:backend:cpu": STEPS,
                                               "combine:backend:cpu": STEPS}


def test_train_moe_dp_through_the_launcher(capsys):
    """``python -m hetu_tpu_torch.launcher -n 2 --no-ssh
    hetu_tpu_torch/tools/train_moe.py --dp 2 --device cpu``: rank 0
    prints the losses of the one-process run."""
    import socket
    import subprocess
    args = ["--gate", "top2", "--device", "cpu", "--steps", "2",
            "--tokens", "64", "--dim", "16"]
    train_moe.main(args)
    want = capsys.readouterr().out.split()
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    proc = subprocess.run(
        [sys.executable, "-m", "hetu_tpu_torch.launcher", "-n", "2",
         "--no-ssh", "--coordinator-port", str(port),
         os.path.join("hetu_tpu_torch", "tools", "train_moe.py"),
         "--dp", "2"] + args,
        cwd=ROOT, capture_output=True, text=True, timeout=JOIN_TIMEOUT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == want and len(want) == 6, proc.stdout


def test_hash_gate_on_fed_ids_routes_the_global_batch(runs):
    """Ids fed (so batch-sharded): the gate gathers them and routes the
    global batch, each rank's rows returned gathered; equal to the JAX
    package's ``_hash_dispatch`` on the global ids, and not to rank 1's
    ids routed alone."""
    import jax.numpy as jnp
    from hetu_tpu.ops import moe as jmoe
    ids = hash_fed_ids()
    tokens, e, cap = HASH_FED
    want = np.asarray(jmoe._hash_dispatch(None, jnp.asarray(ids),
                                          num_experts=e, capacity=cap))
    for rank in runs["ranks"]:
        np.testing.assert_array_equal(rank["hash_fed"], want)
    local = tmoe._hash_dispatch(None, torch.from_numpy(ids[tokens // 2:]),
                                e, cap).numpy()
    assert not np.array_equal(local, want[tokens // 2:])
