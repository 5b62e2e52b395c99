"""The port's launcher (``python -m hetu_tpu_torch.launcher``, twin of
``bin/heturun`` / ``hetu_tpu/launcher.py``) on the CPU: the twins of
``tests/test_launcher.py``'s launch, CLI, monitor, supervise and standby
cases.  Two real local ranks open a gloo world through
``init_distributed`` and exchange a sum and a sharded store's rows; the
monitor kills the survivors of a dead rank; the supervisor relaunches
under its budget (a chaos ``kill:proc`` included) with the JAX
launcher's fault counters; a supervised job with ``--ckpt-dir`` resumes
its executor from the auto-save and ends on the uninterrupted run's
losses; ``--standby`` respawns a dead rank alone.  The children import
only the port (or nothing), so these stay cheap.  The pipeline / ring
attention case waits for those ports."""
import json
import os
import socket
import sys
import textwrap
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hetu_tpu_torch import launcher               # noqa: E402
from hetu_tpu_torch.context import DistConfig     # noqa: E402
from hetu_tpu_torch.metrics import fault_counts, reset_faults  # noqa: E402


@pytest.fixture(autouse=True)
def _clean():
    from hetu_tpu import metrics as jmetrics
    reset_faults()
    jmetrics.reset_faults()
    yield
    reset_faults()
    jmetrics.reset_faults()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write(tmp_path, name, body):
    p = tmp_path / name
    p.write_text(textwrap.dedent(body))
    return str(p)


WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    import torch.distributed as dist
    from hetu_tpu_torch import launcher
    launcher.init_distributed()          # the reference's worker_init()
    rank, world = dist.get_rank(), dist.get_world_size()
    assert world == 2, world
    x = torch.full((1,), float(rank + 1))
    dist.all_reduce(x)
    assert float(x) == 3.0, float(x)
    ports = [int(p) for p in sys.argv[1:3]]
    from hetu_tpu_torch.ps.dist_store import DistributedStore
    store = DistributedStore(rank, world, [("127.0.0.1", p) for p in ports],
                             port=ports[rank])
    tid = store.init_table(8, 4, opt="sgd", lr=1.0, init_scale=0)
    dist.barrier()
    if rank == 0:                        # keys 1, 3 live on rank 1
        store.push(tid, np.asarray([1, 3]),
                   np.ones((2, 4), np.float32) * np.asarray([[1.], [3.]]))
    dist.barrier()
    rows = store.pull(tid, np.asarray([1, 3]))
    np.testing.assert_allclose(rows[0], -1.0 * np.ones(4))
    np.testing.assert_allclose(rows[1], -3.0 * np.ones(4))
    dist.barrier()
    store.close()
    dist.destroy_process_group()
    print(f"rank {{rank}} OK", flush=True)
""")


def test_launch_two_local_processes(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=ROOT))
    ports = [_free_port(), _free_port()]
    config = DistConfig(num_hosts=2, hosts=["localhost", "localhost"])
    procs = launcher.launch(config, str(script),
                            script_args=[str(p) for p in ports],
                            coordinator_port=_free_port())
    try:
        rcs = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert rcs == [0, 0], rcs


def test_cli_single_host(tmp_path):
    """One local process: ``init_distributed`` opens no world."""
    script = _write(tmp_path, "solo.py", f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        import torch.distributed as dist
        from hetu_tpu_torch import launcher
        launcher.init_distributed()
        assert not dist.is_initialized()
        print("solo ok")
    """)
    assert launcher.main(["--no-ssh", script]) == 0


def test_cli_module_entry_point(tmp_path):
    """``python -m hetu_tpu_torch.launcher`` passes the rank's settings in
    its environment and the script's arguments through."""
    out = tmp_path / "env"
    script = _write(tmp_path, "env.py", f"""
        import json, os, sys
        keys = ("HETU_COORDINATOR", "HETU_NUM_PROCESSES", "HETU_PROCESS_ID")
        with open({str(out)!r} + os.environ["HETU_PROCESS_ID"], "w") as f:
            json.dump([os.environ[k] for k in keys] + sys.argv[1:], f)
    """)
    import subprocess
    rc = subprocess.call([sys.executable, "-m", "hetu_tpu_torch.launcher",
                          "-n", "2", "--no-ssh", "--coordinator-port",
                          "29123", script, "--flag", "v"], cwd=ROOT)
    assert rc == 0
    got = [json.loads((tmp_path / f"env{r}").read_text()) for r in (0, 1)]
    assert got == [["localhost:29123", "2", str(r), "--flag", "v"]
                   for r in (0, 1)]


def test_local_devices_is_refused_by_name(tmp_path):
    script = _write(tmp_path, "noop.py", "pass\n")
    with pytest.raises(SystemExit):
        launcher.main(["--no-ssh", "--local-devices", "4", script])
    config = DistConfig(num_hosts=1, hosts=["localhost"])
    with pytest.raises(NotImplementedError, match="local_devices"):
        launcher.launch(config, script, local_devices=4)


def test_monitor_detects_early_remote_rank_death(tmp_path):
    script = _write(tmp_path, "die.py", """
        import os, sys, time
        if int(os.environ.get("HETU_PROCESS_ID", "0")) == 1:
            sys.exit(3)
        time.sleep(30)
    """)
    t0 = time.monotonic()
    assert launcher.main(["--no-ssh", "-n", "2", script]) == 3
    assert time.monotonic() - t0 < 20, "a serial wait blocked on rank 0"


def _both(scenario):
    """``scenario(launcher module, DistConfig, metrics)`` with the JAX
    package's launcher and the port's: equal results and fault
    counters."""
    from hetu_tpu import launcher as jl
    from hetu_tpu import metrics as jm
    from hetu_tpu.context import DistConfig as JConfig
    from hetu_tpu_torch import metrics as tm
    got = []
    for lmod, cfg, m in ((jl, JConfig, jm), (launcher, DistConfig, tm)):
        m.reset_faults()
        got.append((scenario(lmod, cfg), dict(m.fault_counts())))
    assert got[0] == got[1], got
    return got[1]


def test_supervise_restarts_until_success(tmp_path):
    def scenario(lmod, cfg):
        marker = tmp_path / f"{lmod.__name__}.attempt1"
        script = _write(tmp_path, "flaky.py", f"""
            import os, sys
            if int(os.environ.get("HETU_PROCESS_ID", "0")) == 1:
                if not os.path.exists({str(marker)!r}):
                    open({str(marker)!r}, "w").close()
                    sys.exit(5)        # first attempt: rank 1 dies
            sys.exit(0)
        """)
        return lmod.supervise(cfg(num_hosts=2, hosts=["localhost"] * 2),
                              script, max_restarts=2, backoff_s=0.05,
                              ssh=False, log=lambda m: None)
    rc, faults = _both(scenario)
    assert rc == 0 and faults == {"supervisor_restart": 1}


def test_supervise_budget_exhausted_propagates_rc(tmp_path):
    script = _write(tmp_path, "alwaysfail.py", "import sys\nsys.exit(7)\n")

    def scenario(lmod, cfg):
        return lmod.supervise(cfg(num_hosts=1, hosts=["localhost"]), script,
                              max_restarts=1, backoff_s=0.05, ssh=False,
                              log=lambda m: None)
    rc, faults = _both(scenario)
    assert rc == 7 and faults == {"supervisor_restart": 1}


def test_supervise_chaos_proc_kill_then_recovery(tmp_path):
    """A ``kill:proc@rank0:after300`` fault kills rank 0 once; the
    relaunch completes."""
    script = _write(tmp_path, "sleeper.py", "import time\ntime.sleep(1.5)\n")

    def scenario(lmod, cfg):
        chaos = __import__(lmod.__name__.rsplit(".", 1)[0] + ".chaos",
                           fromlist=["ChaosInjector"])
        inj = chaos.ChaosInjector.from_spec("3:kill:proc@rank0:after300")
        return lmod.supervise(cfg(num_hosts=1, hosts=["localhost"]), script,
                              max_restarts=2, backoff_s=0.05, chaos=inj,
                              log=lambda m: None)
    rc, faults = _both(scenario)
    assert rc == 0
    assert faults == {"chaos_kill_proc": 1, "supervisor_restart": 1}


def test_monitor_standby_respawns_dead_rank_without_killing_job(tmp_path):
    def scenario(lmod, cfg):
        marker = tmp_path / f"{lmod.__name__}.died"
        script = _write(tmp_path, "worker.py", f"""
            import os, sys, time
            if os.environ.get("HETU_PS_STANDBY") == "1":
                sys.exit(0)            # the respawned standby ends clean
            if int(os.environ.get("HETU_PROCESS_ID", "0")) == 1 \\
                    and not os.path.exists({str(marker)!r}):
                open({str(marker)!r}, "w").close()
                sys.exit(9)            # rank 1's first life dies
            time.sleep(0.5)
        """)
        config = cfg(num_hosts=2, hosts=["localhost", "localhost"])
        procs = lmod.launch(config, script, ssh=False)

        def respawn(rank):
            return lmod._launch_rank(config, rank, script, ssh=False,
                                     extra_env={"HETU_PS_STANDBY": "1"})
        return lmod.monitor(procs, poll_s=0.05, standby=respawn,
                            standby_budget=2, log=lambda m: None)
    rc, faults = _both(scenario)
    assert rc == 0 and faults == {"standby_spawn": 1}


def test_monitor_standby_budget_exhausted_falls_back_to_kill_all(tmp_path):
    script = _write(tmp_path, "alwaysdie.py", """
        import os, sys, time
        if int(os.environ.get("HETU_PROCESS_ID", "0")) == 1:
            sys.exit(4)
        time.sleep(30)
    """)
    config = DistConfig(num_hosts=2, hosts=["localhost", "localhost"])
    procs = launcher.launch(config, script, ssh=False)
    t0 = time.monotonic()
    rc = launcher.monitor(
        procs, poll_s=0.05, standby_budget=1, log=lambda m: None,
        standby=lambda r: launcher._launch_rank(config, r, script,
                                                ssh=False))
    assert rc == 4
    assert time.monotonic() - t0 < 20, "the kill-all fallback did not fire"
    assert fault_counts() == {"standby_spawn": 1}


def test_supervised_ckpt_dir_resumes_the_executor(tmp_path):
    """``--supervise --ckpt-dir``: the workers' executors auto-save every
    step (``HETU_AUTO_SAVE_EVERY=1``); the first attempt dies after step
    3, the relaunch resumes at construction (``HETU_AUTO_RESUME=1``) and
    its losses from step 3 on are the uninterrupted run's, bit for bit;
    ``--ps-replication`` reaches the workers' environment."""
    marker = tmp_path / "died"
    script = _write(tmp_path, "train.py", f"""
        import json, os, sys
        sys.path.insert(0, {ROOT!r})
        import numpy as np
        import hetu_tpu_torch as ht
        rng = np.random.RandomState(0)
        x = ht.placeholder_op("x"); y_ = ht.placeholder_op("y")
        w = ht.Variable("w", value=rng.randn(4, 2).astype(np.float32))
        loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(
            ht.matmul_op(x, w), y_), [0])
        ex = ht.Executor([loss, ht.optim.AdamOptimizer(0.1).minimize(loss)],
                         seed=0, device="cpu")
        xv = rng.randn(8, 4).astype(np.float32)
        yv = np.eye(2, dtype=np.float32)[rng.randint(0, 2, 8)]
        out = {{"start": ex.step_counter, "losses": [],
               "repl": os.environ.get("HETU_PS_REPLICATION")}}
        while ex.step_counter < 6:
            out["losses"].append(float(ex.run(
                feed_dict={{x: xv, y_: yv}})[0].asnumpy()))
            if ex.step_counter == 3 and not os.path.exists({str(marker)!r}):
                open({str(marker)!r}, "w").close()
                os._exit(5)
        with open({str(tmp_path)!r} + "/out.json", "w") as f:
            json.dump(out, f)
    """)
    ckpt = str(tmp_path / "ckpt")
    saved = dict(os.environ)      # main() exports into os.environ
    try:
        for k in ("HETU_AUTO_SAVE_DIR", "HETU_AUTO_RESUME",
                  "HETU_PS_REPLICATION"):
            os.environ.pop(k, None)
        os.environ["HETU_AUTO_SAVE_EVERY"] = "1"
        rc = launcher.main(["--no-ssh", "--supervise", "--ckpt-dir", ckpt,
                            "--restart-backoff", "0.05",
                            "--ps-replication", "2", script])
    finally:
        os.environ.clear()
        os.environ.update(saved)
    assert rc == 0 and fault_counts() == {"supervisor_restart": 1}
    got = json.loads((tmp_path / "out.json").read_text())
    assert got["start"] == 3 and got["repl"] == "2"
    # the uninterrupted run, in this process
    import numpy as np
    import hetu_tpu_torch as ht
    rng = np.random.RandomState(0)
    x = ht.placeholder_op("x")
    y_ = ht.placeholder_op("y")
    w = ht.Variable("w", value=rng.randn(4, 2).astype(np.float32))
    loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(
        ht.matmul_op(x, w), y_), [0])
    ex = ht.Executor([loss, ht.optim.AdamOptimizer(0.1).minimize(loss)],
                     seed=0, device="cpu", auto_save_dir=None)
    xv = rng.randn(8, 4).astype(np.float32)
    yv = np.eye(2, dtype=np.float32)[rng.randint(0, 2, 8)]
    want = [float(ex.run(feed_dict={x: xv, y_: yv})[0].asnumpy())
            for _ in range(6)]
    assert got["losses"] == want[3:]
    assert sorted(os.listdir(ckpt))[-1] == "ckpt-00000006"
