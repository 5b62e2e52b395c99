"""Cluster launcher of the port (twin of ``hetu_tpu/launcher.py``; the CLI
``python -m hetu_tpu_torch.launcher`` is the twin of ``bin/heturun``).

Every rank runs the same script.  The launcher starts one process a host
of the cluster spec (:class:`~hetu_tpu_torch.context.DistConfig`: a yaml,
or ``-n`` local processes) with ``HETU_COORDINATOR`` (``host:port`` of the
chief), ``HETU_NUM_PROCESSES`` and ``HETU_PROCESS_ID`` in its
environment; the script calls :func:`init_distributed`, which opens the
``torch.distributed`` world from them (gloo by default, ``backend=``
otherwise) and does nothing for one process.  A remote host is reached
over ssh with those settings on the command line; ``--no-ssh`` starts
every rank locally.

Fault tolerance: :func:`monitor` polls every rank's handle and, on a
failed rank, kills the rest (a data-parallel program cannot go on with a
partial world) and returns its exit code.  ``--supervise`` adds the
recovery loop of :func:`supervise`: relaunch the whole job with
exponential backoff under a restart budget; ``--ckpt-dir`` exports
``HETU_AUTO_SAVE_DIR`` (and, supervised, ``HETU_AUTO_RESUME=1``) so the
workers' executors auto-save and resume from the newest complete
checkpoint.  A ``HETU_CHAOS`` schedule's ``kill:proc@rank<r>:after<ms>``
faults fire inside the monitor loop (:mod:`hetu_tpu_torch.chaos`).

PS replication (``--ps-replication 2`` exports ``HETU_PS_REPLICATION``):
a dead rank's shard keeps serving from its backup, so ``--standby``
respawns just that rank, as a standby (``HETU_PS_STANDBY=1``), up to
``--standby-budget`` times, instead of killing the job; the survivors'
executors re-attach it as the fresh backup (``HETU_PS_REREPLICATE_EVERY``,
which ``--standby`` defaults to 10).

``--local-devices`` (the JAX package's virtual device count a process)
has no meaning here and is refused by name.

CLI: ``python -m hetu_tpu_torch.launcher [-c cluster.yml | -n N]
[--no-ssh] [--supervise ...] train.py [args...]``.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

from . import chaos as _chaos
from .context import DistConfig
from .metrics import record_fault

#: the settings a remote rank needs on its ssh command line
_REMOTE_ENV = (
    "HETU_COORDINATOR", "HETU_NUM_PROCESSES", "HETU_PROCESS_ID",
    # fault tolerance: without these --supervise --ckpt-dir would restart
    # a real cluster from scratch instead of resuming
    "HETU_AUTO_SAVE_DIR", "HETU_AUTO_SAVE_EVERY", "HETU_AUTO_SAVE_KEEP",
    "HETU_AUTO_RESUME", "HETU_CHAOS", "HETU_HEARTBEAT_MS",
    "HETU_MAX_FRAME_MB",
    # PS replication: every rank must agree on the topology
    "HETU_PS_REPLICATION", "HETU_RPC_BACKOFF_MS",
    "HETU_PS_REREPLICATE_EVERY", "HETU_PS_STANDBY")


def _refuse_local_devices(local_devices):
    if local_devices:
        raise NotImplementedError(
            f"local_devices={local_devices}: a virtual device count a "
            f"process is the JAX package's CPU mesh and has no meaning "
            f"in the port (one process is one rank)")


def init_distributed(coordinator=None, num_processes=None, process_id=None,
                     backend="gloo"):
    """Open the ``torch.distributed`` world of a launched rank (the
    reference's ``worker_init``): ``tcp://`` at ``coordinator`` (else
    ``HETU_COORDINATOR``, default ``localhost:8476``), ``num_processes``
    ranks (else ``HETU_NUM_PROCESSES``), this one ``process_id`` (else
    ``HETU_PROCESS_ID``).  ``backend``: ``"gloo"`` (CPU tensors, or CUDA
    tensors of ranks sharing a card) or ``"nccl"`` (the caller picks the
    rank's card first).  One process: a no-op, so a script runs alone
    unchanged."""
    if num_processes is None:
        num_processes = int(os.environ.get("HETU_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return
    import torch.distributed as dist
    addr = coordinator or os.environ.get("HETU_COORDINATOR",
                                         "localhost:8476")
    rank = process_id if process_id is not None \
        else int(os.environ.get("HETU_PROCESS_ID", "0"))
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=num_processes, rank=rank)


def _host_env(config, rank, coordinator_port=8476):
    env = dict(os.environ)
    env["HETU_COORDINATOR"] = f"{config.chief}:{coordinator_port}"
    env["HETU_NUM_PROCESSES"] = str(config.num_hosts)
    env["HETU_PROCESS_ID"] = str(rank)
    return env


def _launch_rank(config, rank, script, script_args=(), local_devices=None,
                 ssh=True, coordinator_port=8476, extra_env=None):
    """Start one rank's process (also the standby respawn: a replicated
    PS cluster relaunches a dead rank alone while the survivors train on
    against the promoted backups)."""
    _refuse_local_devices(local_devices)
    host = config.hosts[rank]
    env = _host_env(config, rank, coordinator_port=coordinator_port)
    if extra_env:
        env.update(extra_env)
    cmd = [sys.executable, script, *script_args]
    if host in ("localhost", "127.0.0.1") or not ssh:
        return subprocess.Popen(cmd, env=env)
    import shlex
    exports = " ".join(f"{k}={shlex.quote(env[k])}" for k in _REMOTE_ENV
                       if env.get(k))
    remote_cmd = " ".join(shlex.quote(a) for a in cmd)
    # -tt: killing the local ssh client hangs up the remote session, so
    # monitor()'s kill of the remaining ranks reaches the remote process
    return subprocess.Popen(
        ["ssh", "-tt", host,
         f"cd {shlex.quote(os.getcwd())} && {exports} {remote_cmd}"])


def launch(config, script, script_args=(), local_devices=None, ssh=True,
           coordinator_port=8476):
    """Start ``script`` on every host of ``config``; returns the Popen
    handles in rank order."""
    return [_launch_rank(config, rank, script, script_args,
                         local_devices=local_devices, ssh=ssh,
                         coordinator_port=coordinator_port)
            for rank in range(len(config.hosts))]


def monitor(procs, poll_s=0.2, chaos=None, log=None, standby=None,
            standby_budget=3):
    """Watch every rank's handle until the job resolves: all exits 0
    return 0; the first non-zero exit kills the remaining ranks and is
    returned.

    ``standby``: a ``rank -> Popen`` respawner (``--standby``): a dead rank
    is relaunched alone instead of failing the job, at most
    ``standby_budget`` times; past that, the kill-all policy.
    ``chaos``: an injector whose ``kill:proc@rank<r>:after<ms>`` faults
    fire here."""
    t0 = time.monotonic()
    live = dict(enumerate(procs))
    spawned = 0
    while live:
        if chaos is not None:
            for r in chaos.due_proc_kills((time.monotonic() - t0) * 1e3):
                p = live.get(r)
                if p is not None and p.poll() is None:
                    if log:
                        log(f"chaos: killing rank {r}")
                    p.kill()
        for r, p in sorted(live.items()):
            rc = p.poll()
            if rc is None:
                continue
            del live[r]
            if rc != 0:
                if standby is not None and spawned < standby_budget:
                    spawned += 1
                    record_fault("standby_spawn")
                    if log:
                        log(f"rank {r} exited rc={rc}; spawning standby "
                            f"({spawned}/{standby_budget}) — survivors "
                            f"keep serving from the promoted replicas")
                    live[r] = standby(r)
                    continue
                if log:
                    log(f"rank {r} exited rc={rc}; killing "
                        f"{len(live)} remaining rank(s)")
                for q in live.values():
                    if q.poll() is None:
                        q.kill()
                for q in live.values():
                    q.wait()
                return rc
        if live:
            time.sleep(poll_s)
    return 0


def supervise(config, script, script_args=(), local_devices=None, ssh=True,
              coordinator_port=8476, max_restarts=3, backoff_s=1.0,
              poll_s=0.2, chaos=None, log=None, standby=False,
              standby_budget=3):
    """Launch, monitor and, on a failure, relaunch the whole job after
    ``backoff_s * 2**attempt`` seconds, at most ``max_restarts`` times;
    the relaunched workers resume from the newest complete auto-save
    (``HETU_AUTO_SAVE_DIR`` with ``HETU_AUTO_RESUME=1``, as ``main``
    exports them for ``--supervise --ckpt-dir``).  Past the budget the
    last attempt's exit code is returned."""
    _refuse_local_devices(local_devices)
    if chaos is None:
        chaos = _chaos.active() or _chaos.install_from_env()
    log = log or (lambda msg: print(f"[launcher] {msg}", file=sys.stderr,
                                    flush=True))
    attempt = 0
    respawn = None
    if standby:
        def respawn(rank):
            # the replacement holds its shards but serves nothing until
            # re-replication re-attaches it
            return _launch_rank(config, rank, script, script_args, ssh=ssh,
                                coordinator_port=coordinator_port,
                                extra_env={"HETU_PS_STANDBY": "1"})
    while True:
        procs = launch(config, script, script_args, ssh=ssh,
                       coordinator_port=coordinator_port)
        rc = monitor(procs, poll_s=poll_s, chaos=chaos, log=log,
                     standby=respawn, standby_budget=standby_budget)
        if rc == 0:
            if attempt:
                log(f"job recovered after {attempt} restart(s)")
            return 0
        if attempt >= max_restarts:
            log(f"restart budget ({max_restarts}) exhausted; "
                f"propagating rc={rc}")
            return rc
        delay = backoff_s * (2 ** attempt)
        attempt += 1
        record_fault("supervisor_restart")
        log(f"job failed rc={rc}; restart {attempt}/{max_restarts} in "
            f"{delay:.1f}s (workers resume from the latest checkpoint)")
        time.sleep(delay)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m hetu_tpu_torch.launcher",
        description="hetu_tpu_torch cluster launcher")
    p.add_argument("-c", "--config", default=None,
                   help="cluster yaml (the JAX package's DistConfig format)")
    p.add_argument("-n", "--num-hosts", type=int, default=None,
                   help="that many localhost processes")
    p.add_argument("--local-devices", type=int, default=None,
                   help="refused: the JAX package's virtual device count")
    p.add_argument("--coordinator-port", type=int, default=8476,
                   help="the chief's torch.distributed rendezvous port")
    p.add_argument("--no-ssh", action="store_true",
                   help="start every rank locally")
    p.add_argument("--supervise", action="store_true",
                   help="relaunch the whole job from the latest checkpoint "
                        "on a rank failure")
    p.add_argument("--max-restarts", type=int, default=3,
                   help="supervision restart budget (default 3)")
    p.add_argument("--restart-backoff", type=float, default=1.0,
                   help="base seconds of the exponential restart backoff")
    p.add_argument("--ckpt-dir", default=None,
                   help="exported as HETU_AUTO_SAVE_DIR (auto-save "
                        "destination and resume source; defaults "
                        "HETU_AUTO_SAVE_EVERY to 100 steps)")
    p.add_argument("--ps-replication", type=int, default=None,
                   help="exported as HETU_PS_REPLICATION: 2 keeps a live "
                        "backup of every PS shard on the next rank")
    p.add_argument("--standby", action="store_true",
                   help="with PS replication: respawn a dead rank alone as "
                        "a standby instead of failing the job")
    p.add_argument("--standby-budget", type=int, default=3,
                   help="most solo respawns before the kill-all policy "
                        "(default 3)")
    p.add_argument("script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    if args.local_devices is not None:
        p.error("--local-devices (the JAX package's virtual device count "
                "a process) has no meaning in the port: one process is "
                "one rank")

    if args.config:
        config = DistConfig(file=args.config)
    else:
        n = args.num_hosts or 1
        config = DistConfig(num_hosts=n, hosts=["localhost"] * n)
    # _host_env copies os.environ: every rank inherits what is set here
    if args.ps_replication is not None:
        os.environ["HETU_PS_REPLICATION"] = str(args.ps_replication)
        if args.standby:
            # a respawned standby re-attaches by itself even when the
            # script never sets the knob
            os.environ.setdefault("HETU_PS_REREPLICATE_EVERY", "10")
    if args.ckpt_dir:
        os.environ["HETU_AUTO_SAVE_DIR"] = args.ckpt_dir
        # a directory with no cadence would never be written, and every
        # supervised relaunch would start again from step 0
        os.environ.setdefault("HETU_AUTO_SAVE_EVERY", "100")
        if args.supervise:
            os.environ.setdefault("HETU_AUTO_RESUME", "1")
    if args.supervise:
        return supervise(config, args.script, args.script_args,
                         ssh=not args.no_ssh,
                         coordinator_port=args.coordinator_port,
                         max_restarts=args.max_restarts,
                         backoff_s=args.restart_backoff,
                         standby=args.standby,
                         standby_budget=args.standby_budget)
    procs = launch(config, args.script, args.script_args,
                   ssh=not args.no_ssh,
                   coordinator_port=args.coordinator_port)
    respawn = None
    if args.standby:
        def respawn(rank):
            return _launch_rank(config, rank, args.script, args.script_args,
                                ssh=not args.no_ssh,
                                coordinator_port=args.coordinator_port,
                                extra_env={"HETU_PS_STANDBY": "1"})
    return monitor(procs,
                   chaos=_chaos.active() or _chaos.install_from_env(),
                   standby=respawn, standby_budget=args.standby_budget)


if __name__ == "__main__":
    sys.exit(main())
