"""The port's collectives (``hetu_tpu_torch/parallel/collectives.py``),
``CommGroup``, ``PartialReduce`` and ``preduce_mean`` against the JAX
package's of the same name.

World 4 over gloo (one module-scoped fixture: four spawned ranks, one
torch thread each, ``init_method`` a file under ``tmp_path``, the
pattern of ``test_torch_parallel.py``) against the JAX wrappers under
``shard_map`` on 4 of the 8 CPU devices of ``tests/conftest.py``, with the
same per-rank inputs, drawn from a seed: exact for data movement
(gathers, scatters of data, all-to-all, broadcast, permutes, max / min),
rtol 1e-6 for sums, with atol 1e-6: the inputs are of unit scale, and a
sum that cancels (a reduce-scatter element of 0.0052 from four
operands near 1) moves by an ulp of its operands with the order of
summation (7.5e-9 measured).  ``hierarchical_all_to_all`` over a 2 x 2 split of
the world is held equal to the flat ``all_to_all``, as
``tests/test_collectives.py`` holds the JAX one.  The backward of the
differentiable ``all_reduce`` and ``all_gather`` is held to its sum over
ranks, computed here with numpy.  ``PartialReduce``'s masks are held
equal to the JAX class's on the same arrival sequences (host code, no
spawn).  The rank processes import this module to reach their entry
point, so JAX is imported only inside the reference functions."""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import hetu_tpu_torch as tht                                  # noqa: E402
from hetu_tpu_torch import metrics as tmetrics                # noqa: E402
from hetu_tpu_torch.parallel import collectives as tcc        # noqa: E402
from test_torch_parallel import (end_world, join_world,       # noqa: E402
                                 spawn_world)

WORLD = 4
SUM_TOL = dict(rtol=1e-6, atol=1e-6)
PERM = [(0, 2), (2, 0), (1, 3)]         # rank 1 receives nothing: zeros
PREDUCE_MASK = (1.0, 1.0, 0.0, 1.0)     # rank 2 dropped


def inputs(rank):
    """This rank's inputs, from a seed of its own."""
    rng = np.random.RandomState(100 + rank)
    return {"v": rng.randn(3, 5).astype(np.float32),
            "rows": rng.randn(8, 3).astype(np.float32),
            "cols": rng.randn(3, 8).astype(np.float32),
            "square": rng.randn(WORLD, 6).astype(np.float32),
            "a2a": rng.randn(WORLD * 3, 5).astype(np.float32),
            "cot": rng.randn(3, 5).astype(np.float32),
            "gcot": rng.randn(WORLD * 3, 5).astype(np.float32)}


#: case -> (input name, sum (rtol) or data movement (exact), the port's
#: call on (x, group), the JAX wrapper's call on (x, axis name))
CASES = {
    "all_reduce_sum": ("v", True, lambda x, g: tcc.all_reduce(x, g),
                       lambda cc, x, a: cc.all_reduce(x, a)),
    "all_reduce_avg": ("v", True, lambda x, g: tcc.all_reduce(x, g, "avg"),
                       lambda cc, x, a: cc.all_reduce(x, a, "avg")),
    "all_reduce_mean": ("v", True,
                        lambda x, g: tcc.all_reduce(x, g, "mean"),
                        lambda cc, x, a: cc.all_reduce(x, a, "mean")),
    "all_reduce_max": ("v", False, lambda x, g: tcc.all_reduce(x, g, "max"),
                       lambda cc, x, a: cc.all_reduce(x, a, "max")),
    "all_reduce_min": ("v", False, lambda x, g: tcc.all_reduce(x, g, "min"),
                       lambda cc, x, a: cc.all_reduce(x, a, "min")),
    "all_gather_0": ("v", False, lambda x, g: tcc.all_gather(x, g),
                     lambda cc, x, a: cc.all_gather(x, a)),
    "all_gather_1": ("v", False, lambda x, g: tcc.all_gather(x, g, axis=1),
                     lambda cc, x, a: cc.all_gather(x, a, axis=1)),
    "all_gather_0_stacked": (
        "v", False, lambda x, g: tcc.all_gather(x, g, tiled=False),
        lambda cc, x, a: cc.all_gather(x, a, tiled=False)),
    "all_gather_1_stacked": (
        "v", False, lambda x, g: tcc.all_gather(x, g, axis=1, tiled=False),
        lambda cc, x, a: cc.all_gather(x, a, axis=1, tiled=False)),
    "reduce_scatter_0": ("rows", True,
                         lambda x, g: tcc.reduce_scatter(x, g),
                         lambda cc, x, a: cc.reduce_scatter(x, a)),
    "reduce_scatter_1": ("cols", True,
                         lambda x, g: tcc.reduce_scatter(x, g, axis=1),
                         lambda cc, x, a: cc.reduce_scatter(x, a, axis=1)),
    "reduce_scatter_stacked": (
        "square", True, lambda x, g: tcc.reduce_scatter(x, g, tiled=False),
        lambda cc, x, a: cc.reduce_scatter(x, a, tiled=False)),
    "all_to_all_0_0": ("rows", False, lambda x, g: tcc.all_to_all(x, g),
                       lambda cc, x, a: cc.all_to_all(x, a)),
    "all_to_all_1_0": ("cols", False,
                       lambda x, g: tcc.all_to_all(x, g, 1, 0),
                       lambda cc, x, a: cc.all_to_all(x, a, 1, 0)),
    "all_to_all_0_1": ("rows", False,
                       lambda x, g: tcc.all_to_all(x, g, 0, 1),
                       lambda cc, x, a: cc.all_to_all(x, a, 0, 1)),
    "broadcast": ("v", False, lambda x, g: tcc.broadcast(x, g, root=2),
                  lambda cc, x, a: cc.broadcast(x, a, root=2)),
    "reduce_sum": ("v", True, lambda x, g: tcc.reduce(x, g, root=1),
                   lambda cc, x, a: cc.reduce(x, a, root=1)),
    "reduce_max": ("v", False,
                   lambda x, g: tcc.reduce(x, g, root=3, op="max"),
                   lambda cc, x, a: cc.reduce(x, a, root=3, op="max")),
    "ppermute": ("v", False, lambda x, g: tcc.ppermute(x, g, PERM),
                 lambda cc, x, a: cc.ppermute(x, a, PERM)),
    "send_next": ("v", False, lambda x, g: tcc.send_next(x, g),
                  lambda cc, x, a: cc.send_next(x, a, WORLD)),
    "send_prev": ("v", False, lambda x, g: tcc.send_prev(x, g),
                  lambda cc, x, a: cc.send_prev(x, a, WORLD)),
}


# -- the port, on every rank --------------------------------------------------------

def port_collectives(rank):
    import torch.distributed as dist
    x = {k: torch.from_numpy(v) for k, v in inputs(rank).items()}
    mesh = tht.make_mesh()
    comm = tht.dist.new_group_comm(mesh, "dp")
    out = {}
    for name, (key, _, fn, _) in CASES.items():
        before = x[key].clone()
        out[name] = fn(x[key], comm if name == "all_reduce_sum"
                       else None).numpy()
        assert torch.equal(x[key], before), name       # functional
    out["comm_allreduce"] = comm.allreduce(x["v"]).numpy()
    out["comm"] = (comm.size, comm.rank, mesh.mesh_dim_names)
    # the world as 2 x 2: flat rank o * 2 + i; inner groups share o,
    # outer groups share i (every rank creates every group, in order)
    inner = [dist.new_group([o * 2, o * 2 + 1]) for o in range(2)]
    outer = [dist.new_group([i, 2 + i]) for i in range(2)]
    out["hier"] = tcc.hierarchical_all_to_all(
        x["a2a"], outer[rank % 2], inner[rank // 2]).numpy()
    out["flat"] = tcc.all_to_all(x["a2a"]).numpy()
    mask = PREDUCE_MASK[rank]
    out["preduce"] = tht.dist.preduce_mean(x["v"], mask).numpy()
    tree = tht.dist.preduce_mean({"a": x["v"], "b": [x["rows"]]}, mask)
    out["preduce_tree"] = (tree["a"].numpy(), tree["b"][0].numpy())
    # backward: a sum over ranks of the cotangents
    v = x["v"].clone().requires_grad_(True)
    (gx,) = torch.autograd.grad((tcc.all_reduce(v * 2.0) * x["cot"]).sum(),
                                [v])
    out["grad_all_reduce"] = gx.numpy()
    v = x["v"].clone().requires_grad_(True)
    (gx,) = torch.autograd.grad((tcc.all_gather(v) * x["gcot"]).sum(), [v])
    out["grad_all_gather"] = gx.numpy()
    return out


def rank_main(rank, world, init_file, out_dir):
    import pickle
    import traceback
    import torch.distributed as dist
    torch.set_num_threads(1)
    clean = False
    try:
        dist.init_process_group("gloo", init_method="file://" + init_file,
                                rank=rank, world_size=world)
        res = port_collectives(rank)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
        clean = True
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        end_world(clean)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import time
    from test_torch_parallel import JOIN_TIMEOUT
    started = spawn_world(WORLD, str(tmp_path_factory.mktemp("cc")),
                          rank_main)
    return join_world(*started, time.monotonic() + JOIN_TIMEOUT)


# -- the JAX package, in this process --------------------------------------------

def jax_per_rank(fn, key):
    """``fn(x, 'dp')`` under ``shard_map`` on 4 CPU devices, each device
    holding its rank's input; the outputs stacked by rank."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("dp",))
    x = np.stack([inputs(r)[key] for r in range(WORLD)])
    f = jax.shard_map(lambda v: fn(v[0], "dp")[None], mesh=mesh,
                      in_specs=(P("dp"),), out_specs=P("dp"),
                      check_vma=False)
    return np.asarray(f(x))


def _check(got, want, is_sum):
    assert got.shape == want.shape and got.dtype == want.dtype
    if is_sum:
        np.testing.assert_allclose(got, want, **SUM_TOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_collective_matches_jax(ranks, name):
    from hetu_tpu.parallel import collectives as jcc
    key, is_sum, _, jfn = CASES[name]
    want = jax_per_rank(lambda x, a: jfn(jcc, x, a), key)
    for r in range(WORLD):
        _check(ranks[r][name], want[r], is_sum)


def test_comm_group_matches_jax(ranks):
    import jax
    from jax.sharding import Mesh
    from hetu_tpu.parallel import collectives as jcc
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("dp",))
    x = np.concatenate([inputs(r)["v"] for r in range(WORLD)])
    want = np.asarray(jcc.new_group_comm(mesh, "dp").allreduce(x))
    for r in range(WORLD):
        assert ranks[r]["comm"] == (WORLD, r, ("dp",))
        _check(ranks[r]["comm_allreduce"], want, True)


def test_hierarchical_all_to_all_equals_flat(ranks):
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r]["hier"], ranks[r]["flat"])
    from hetu_tpu.parallel import collectives as jcc
    want = jax_per_rank(jcc.all_to_all, "a2a")
    for r in range(WORLD):
        _check(ranks[r]["flat"], want[r], False)


def test_preduce_mean_matches_jax(ranks):
    from hetu_tpu.parallel.preduce import preduce_mean
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("dp",))
    g = np.stack([inputs(r)["v"] for r in range(WORLD)])
    m = np.array(PREDUCE_MASK, np.float32).reshape(WORLD, 1)
    want = np.asarray(jax.shard_map(
        lambda v, k: preduce_mean(v[0], k[0, 0], "dp")[None], mesh=mesh,
        in_specs=(P("dp"), P("dp")), out_specs=P("dp"),
        check_vma=False)(g, m))
    active = g[np.array(PREDUCE_MASK) == 1].mean(0)
    for r in range(WORLD):
        _check(ranks[r]["preduce"], want[r], True)
        np.testing.assert_allclose(ranks[r]["preduce"], active, **SUM_TOL)
        a, b = ranks[r]["preduce_tree"]
        np.testing.assert_array_equal(a, ranks[r]["preduce"])
        rows = np.stack([inputs(q)["rows"] for q in range(WORLD)])
        np.testing.assert_allclose(
            b, rows[np.array(PREDUCE_MASK) == 1].mean(0), **SUM_TOL)


def test_differentiable_collectives_sum_cotangents_over_ranks(ranks):
    cots = np.stack([inputs(r)["cot"] for r in range(WORLD)])
    gcots = np.stack([inputs(r)["gcot"] for r in range(WORLD)])
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r]["grad_all_reduce"],
                                   2.0 * cots.sum(0), **SUM_TOL)
        np.testing.assert_allclose(ranks[r]["grad_all_gather"],
                                   gcots[:, 3 * r:3 * (r + 1)].sum(0),
                                   **SUM_TOL)


# -- PartialReduce's group formation, host code --------------------------------------

def _arrivals(pr):
    """One arrival sequence: step 0 with a straggler, step 1 where the
    window would leave one worker (min_workers falls back), step 2 with
    nobody reported yet."""
    for r, t in ((0, 0.000), (1, 0.005), (3, 0.009), (2, 0.050)):
        pr.report_arrival(r, step=0, t=t)
    for r, t in ((0, 0.0), (1, 5.0)):
        pr.report_arrival(r, step=1, t=t)


@pytest.mark.parametrize("kw", [
    dict(max_wait_ms=10.0, min_workers=2),
    dict(max_wait_ms=1.0, min_workers=3),
    dict(max_wait_ms=10.0, min_workers=2, alive=(1, 1, 0, 1)),
    dict(max_wait_ms=10.0, min_workers=3, alive=(1, 0, 0, 1)),
    dict(max_wait_ms=10.0, min_workers=2,
         arrival=((1, 0, 1, 0), (0, 0, 0, 1), (1, 1, 1, 1)))],
    ids=["window", "min_workers", "one_dead", "dead_below_min", "arrival_fn"])
def test_partial_reduce_masks_match_jax(kw):
    from hetu_tpu import metrics as jmetrics
    from hetu_tpu.parallel.preduce import PartialReduce as JaxPartialReduce
    kw = dict(kw)
    alive, arrival = kw.pop("alive", None), kw.pop("arrival", None)
    extra = {}
    if alive is not None:
        extra["alive_fn"] = lambda: np.array(alive)
    if arrival is not None:
        extra["arrival_fn"] = lambda step: np.array(arrival[step])
    ours = tht.dist.PartialReduce(WORLD, **kw, **extra)
    theirs = JaxPartialReduce(WORLD, **kw, **extra)
    _arrivals(ours)
    _arrivals(theirs)
    kind = "preduce_dead_rank_excluded"
    t0 = tmetrics.fault_counts().get(kind, 0)
    j0 = jmetrics.fault_counts().get(kind, 0)
    for step in range(3):
        for rank in range(WORLD):
            got, want = ours.get_partner(rank, step), \
                theirs.get_partner(rank, step)
            assert got.dtype == want.dtype, (step, rank)
            np.testing.assert_array_equal(got, want, err_msg=f"{step} {rank}")
            assert got[rank] == 1.0
    assert tmetrics.fault_counts().get(kind, 0) - t0 == \
        jmetrics.fault_counts().get(kind, 0) - j0
    assert (tmetrics.fault_counts().get(kind, 0) > t0) == (alive is not None
                                                           and 0 in alive)


def test_partial_reduce_store_takes_the_replication_knobs(monkeypatch):
    # DistPartialReduce is ported (tests/test_torch_ps_dist.py); the store
    # it rides on takes the replication knobs by keyword or environment,
    # as the JAX package's does: a world of one has no room for a backup
    # and runs unreplicated, and only replication 1 or 2 is accepted
    monkeypatch.setenv("HETU_PS_REPLICATION", "2")
    monkeypatch.setenv("HETU_PS_STANDBY", "1")
    for mod in (tht.ps, jht_ps()):
        store = mod.DistributedStore(0, 1)
        try:
            assert store.replication == 1 and store.server.serves(0)
            pr = tht.dist.DistPartialReduce(store, max_wait_ms=50.0,
                                            min_workers=1)
            pr.report_arrival(0, 0)
            assert pr.get_partner(0, 0).tolist() == [1.0]
        finally:
            store.close()
    with pytest.raises(ValueError, match="replication=3"):
        tht.ps.DistributedStore(0, 1, replication=3)


def jht_ps():
    """The JAX package's ``ps`` (imported here: the rank processes import
    this module)."""
    from hetu_tpu import ps
    return ps
