"""Shared harness of the replicated parameter server's parity tests
(``test_torch_ps_replication.py``, ``test_torch_ps_partition.py``,
``test_torch_ctr_serving.py``): free loopback ports, teardown, and
``run_both``, which runs one scenario in each package and holds the two
results together."""
import socket

import numpy as np


def free_ports(n):
    """``n`` loopback ports free at the time of the call."""
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def ends(ports):
    return [("127.0.0.1", p) for p in ports]


def close_all(stores):
    """Close every store; one already stopped or closed is no error."""
    for s in stores:
        try:
            s.close()
        except Exception:   # noqa: BLE001 — teardown of killed servers
            pass


def run_both(pkgs, scenario, faults=True, rtol=0.0):
    """``scenario(pkg)`` for each package of ``pkgs`` (the JAX package's
    first), each returning a dict.  The dicts must agree key for key:
    float arrays within ``rtol`` (bit for bit at 0), everything else
    exactly; with ``faults`` the fault counters each run left join the
    dict (reset before each run).  Returns the port's dict."""
    got = []
    for pkg in pkgs:
        if faults:
            pkg.metrics.reset_faults()
        out = scenario(pkg)
        if faults:
            out["faults"] = dict(pkg.metrics.fault_counts())
        got.append(out)
    j, t = got
    assert sorted(j) == sorted(t)
    for k in j:
        a, b = j[k], t[k]
        if isinstance(a, np.ndarray) and a.dtype.kind == "f" and rtol:
            np.testing.assert_allclose(b, a, rtol=rtol, atol=0, err_msg=k)
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), k
        else:
            assert a == b, (k, a, b)
    return t
