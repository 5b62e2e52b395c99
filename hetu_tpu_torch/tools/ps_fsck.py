"""ps_fsck: the live replica-divergence and lineage check of the
replicated parameter server (twin of the repo's ``tools/ps_fsck.py``).

With ``replication=2`` a shard's two copies are bit-equal because the
backup replays the primary's op-log; this tool tests that on a running
cluster.  For each shard it asks both holders (home rank ``s`` and ring
backup ``(s + 1) % world``) for an ``OP_CHECKSUM`` state digest (sha256
over the slab, the optimizer slots and the per-row versions,
``EmbeddingStore.state_digest``) and compares them, and asks each for its
``OP_EPOCH`` (fencing epoch, serving flag): exactly one holder must serve
each shard.  It speaks the frame protocol over throwaway connections, so
it checks a cluster of either package, and reports what the JAX
package's tool reports.

Usage::

    python -m hetu_tpu_torch.tools.ps_fsck \
        --endpoints 127.0.0.1:5000,127.0.0.1:5001 --tables 1 \
        [--replication 2] [--verify] [--retries N] [--json]

``--verify`` exits 1 on any stable divergence, missing replica, or shard
without exactly one serving lineage.  Each failure names the invariant it
falsifies (``exactly-once-apply``, ``single-serving-lineage``,
``epoch-monotonicity``).  Digests are taken holder by holder, not under a
barrier, so a frame in flight can make a false mismatch on a cluster
taking writes; ``--retries N`` re-digests only the diverging pairs up to
N more times and keeps a mismatch only if it survives every pass.
"""
from __future__ import annotations

import argparse
import json
import socket
import struct
import sys
import time

import numpy as np

from ..ps.dist_store import (OP_CHECKSUM, OP_EPOCH, _HDR, _recv_frame,
                             _send_frame)


def _probe(endpoint, op, shard, table=0, keys=b"", timeout=10.0):
    """One raw request/response against a server — fsck speaks the
    dist-store frame protocol directly over a throwaway connection so it
    never needs (or perturbs) a DistributedStore of its own.  Returns
    ``("ok", payload_bytes)`` or ``("error", why)``."""
    try:
        s = socket.create_connection(endpoint, timeout=timeout)
    except OSError as e:
        return "error", f"unreachable: {e}"
    try:
        s.settimeout(timeout)
        hdr = _HDR.pack(op, table, len(keys) // 8, -1.0, 0, -1,
                        time.time_ns(), shard, 0)
        _send_frame(s, hdr, keys)
        resp = _recv_frame(s)
        if not resp or resp[:1] == b"\x01":
            return "error", resp[1:].decode(errors="replace")
        return "ok", resp[1:]
    except (OSError, ConnectionError) as e:
        return "error", f"{type(e).__name__}: {e}"
    finally:
        try:
            s.close()
        except OSError:
            pass


def checksum(endpoint, shard, table, timeout=10.0):
    """One OP_CHECKSUM probe: ``("ok", hex_digest)`` or ``("error", why)``."""
    status, val = _probe(endpoint, OP_CHECKSUM, shard, table,
                         timeout=timeout)
    return status, val.decode() if status == "ok" else val


def shard_epoch(endpoint, shard, timeout=10.0):
    """One OP_EPOCH probe: ``("ok", (epoch, serving))`` or ``("error",
    why)`` — which lineage a holder's copy belongs to and whether it
    still claims to serve it."""
    status, val = _probe(endpoint, OP_EPOCH, shard,
                         keys=np.asarray([shard], np.int64).tobytes(),
                         timeout=timeout)
    if status != "ok":
        return status, val
    ep, serving = struct.unpack("<qq", val)
    return "ok", (int(ep), bool(serving))


def _digest_cell(endpoints, rank, shard, table, timeout, probe):
    status, val = probe(endpoints[rank], shard, table, timeout=timeout)
    return {"status": status, "value": val}


def fsck(endpoints, n_tables, replication=2, timeout=10.0, retries=0,
         retry_wait=0.5, probe=None):
    """Digest every (shard, table) on every replica holder and compare;
    probe every holder's fencing epoch and count serving lineages.

    ``endpoints``: ``[(host, port)]`` indexed by rank (= home shard).
    ``retries``: re-digest only still-diverging (shard, table) pairs up
    to this many extra passes — an in-flight op-log frame clears, a real
    divergence survives (the report's ``mismatches`` are the stable
    ones; transients that cleared are counted in ``transient_cleared``).
    ``probe`` overrides the digest probe (tests inject transients).
    Returns a report dict; ``report["ok"]`` is True iff every shard's
    copies exist, answer, agree bitwise, and exactly one holder serves
    each shard (a single surviving lineage)."""
    probe = probe or checksum
    world = len(endpoints)
    holders_of = (lambda s: [s, (s + 1) % world]) if replication >= 2 \
        and world >= 2 else (lambda s: [s])
    report = {"world": world, "replication": replication,
              "tables": n_tables, "shards": {}, "mismatches": [],
              "errors": [], "epochs": {}, "serving_ranks": {},
              "lineage_violations": [], "retries_used": 0,
              "transient_cleared": 0}

    def digest_pair(shard, table):
        return {rank: _digest_cell(endpoints, rank, shard, table,
                                   timeout, probe)
                for rank in holders_of(shard)}

    def diverged(digests):
        return len({v["value"] for v in digests.values()
                    if v["status"] == "ok"}) > 1

    def probe_lineage(shard):
        """Every holder's (epoch, serving) + the sorted serving ranks.
        Returns the name of the violated model invariant (matching
        the JAX package's protocol model) or None:
        ``single-serving-lineage`` when not exactly one holder serves
        (0 is an outage, 2+ a split brain), ``epoch-monotonicity`` when
        the one serving holder's fencing epoch is BELOW another copy's —
        a stale lineage serving past a promotion it never saw."""
        eps = {}
        for rank in holders_of(shard):
            status, val = shard_epoch(endpoints[rank], shard,
                                      timeout=timeout)
            eps[rank] = {"status": status,
                         "epoch": val[0] if status == "ok" else None,
                         "serving": val[1] if status == "ok" else None,
                         "error": None if status == "ok" else val}
        serving = sorted(r for r, v in eps.items()
                         if v["status"] == "ok" and v["serving"])
        report["epochs"][shard] = eps
        report["serving_ranks"][shard] = serving
        if len(serving) != 1:
            return "single-serving-lineage"
        ok_eps = [v["epoch"] for v in eps.values() if v["status"] == "ok"]
        if ok_eps and eps[serving[0]]["epoch"] < max(ok_eps):
            return "epoch-monotonicity"
        return None

    pending = []                       # (shard, table) pairs to re-check
    pending_lineage = []               # shards whose lineage looked split
    lineage_kind = {}                  # shard -> violated invariant name
    for shard in range(world):
        per_shard = {}
        for table in range(n_tables):
            digests = digest_pair(shard, table)
            if diverged(digests):
                pending.append((shard, table))
            per_shard[table] = digests
        report["shards"][shard] = per_shard
        kind = probe_lineage(shard)
        if kind:
            pending_lineage.append(shard)
            lineage_kind[shard] = kind

    # stabilisation passes: only the diverging pairs / split-looking
    # shards are re-probed, so an in-flight op-log frame or a probe that
    # landed mid-failover (old primary seen serving an instant before
    # its demotion) cannot fail --verify — only a STABLE divergence or
    # split brain survives every pass
    for _ in range(max(0, retries)):
        if not pending and not pending_lineage:
            break
        report["retries_used"] += 1
        time.sleep(retry_wait)
        still = []
        for shard, table in pending:
            digests = digest_pair(shard, table)
            report["shards"][shard][table] = digests
            if diverged(digests):
                still.append((shard, table))
            else:
                report["transient_cleared"] += 1
        pending = still
        still_split = []
        for shard in pending_lineage:
            kind = probe_lineage(shard)
            if kind:
                still_split.append(shard)
                lineage_kind[shard] = kind
            else:
                report["transient_cleared"] += 1
        pending_lineage = still_split

    # each finding names the protocol-model invariant it falsifies (the
    # names match the JAX package's protocol model, so a
    # live-cluster fsck failure points at the same property the model
    # checker proves on the abstract protocol)
    for shard, table in pending:
        digests = report["shards"][shard][table]
        report["mismatches"].append(
            {"shard": shard, "table": table,
             "invariant": "exactly-once-apply",
             "digests": {r: v["value"] for r, v in digests.items()
                         if v["status"] == "ok"}})
    for shard in pending_lineage:
        eps = report["epochs"][shard]
        report["lineage_violations"].append(
            {"shard": shard,
             "invariant": lineage_kind.get(shard,
                                           "single-serving-lineage"),
             "serving_ranks": report["serving_ranks"][shard],
             "epochs": {r: v["epoch"] for r, v in eps.items()
                        if v["status"] == "ok"}})
    for shard, eps in report["epochs"].items():
        for rank, v in eps.items():
            if v["status"] != "ok":
                report["errors"].append(
                    {"shard": shard, "table": None, "rank": rank,
                     "error": f"epoch probe: {v['error']}"})
    for shard, per_shard in report["shards"].items():
        for table, digests in per_shard.items():
            for rank, v in digests.items():
                if v["status"] != "ok":
                    report["errors"].append(
                        {"shard": shard, "table": table, "rank": rank,
                         "error": v["value"]})
    report["ok"] = not report["mismatches"] and not report["errors"] \
        and not report["lineage_violations"]
    return report


def _parse_endpoints(spec):
    out = []
    for part in spec.split(","):
        host, port = part.strip().rsplit(":", 1)
        out.append((host, int(port)))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="ps_fsck",
        description="PS replica-divergence + lineage checker")
    p.add_argument("--endpoints", required=True,
                   help="host:port per rank, comma-separated, rank order")
    p.add_argument("--tables", type=int, default=1,
                   help="number of tables per shard (default 1)")
    p.add_argument("--replication", type=int, default=2,
                   help="cluster replication factor (default 2)")
    p.add_argument("--timeout", type=float, default=10.0)
    p.add_argument("--retries", type=int, default=0,
                   help="re-digest only diverging shards up to N extra "
                        "passes: an in-flight op-log frame clears, only "
                        "a STABLE divergence fails --verify")
    p.add_argument("--retry-wait", type=float, default=0.5,
                   help="pause between stabilisation passes (seconds)")
    p.add_argument("--verify", action="store_true",
                   help="exit nonzero on any stable divergence, missing "
                        "replica, or shard without exactly one serving "
                        "lineage")
    p.add_argument("--json", action="store_true",
                   help="emit the full report (incl. per-shard fencing "
                        "epochs + serving ranks) as JSON")
    args = p.parse_args(argv)

    report = fsck(_parse_endpoints(args.endpoints), args.tables,
                  replication=args.replication, timeout=args.timeout,
                  retries=args.retries, retry_wait=args.retry_wait)
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        for m in report["mismatches"]:
            print(f"MISMATCH shard {m['shard']} table {m['table']} "
                  f"[invariant: {m['invariant']} — replicas replaying "
                  f"one op-log must be bitwise identical]: "
                  f"{m['digests']}")
        for v in report["lineage_violations"]:
            print(f"LINEAGE shard {v['shard']} [invariant: "
                  f"{v['invariant']}]: serving ranks "
                  f"{v['serving_ranks']} (want exactly 1), epochs "
                  f"{v['epochs']}")
        for e in report["errors"]:
            print(f"ERROR shard {e['shard']} table {e['table']} rank "
                  f"{e['rank']}: {e['error']}")
        print("ok" if report["ok"] else
              f"DIVERGED: {len(report['mismatches'])} mismatch(es), "
              f"{len(report['lineage_violations'])} lineage violation(s), "
              f"{len(report['errors'])} error(s)")
    if args.verify and not report["ok"]:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
