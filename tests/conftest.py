"""Test config: run on a simulated 8-device CPU mesh so every parallelism
test (dp/tp/ep/pp/cp) executes real XLA collectives without TPU hardware
(SURVEY.md §4 — replaces the reference's mpirun-based distributed tests).

Note: jax may already be imported by site customization with a TPU platform
pinned in the environment, so we must force the platform via jax.config (env
vars alone are read too early to override here).
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# newer jax defaults this ON; the parity tests (single-device vs sharded
# with dropout RNG inside shard_map) assume sharding-invariant random
# bits, which is exactly what the partitionable threefry gives
jax.config.update("jax_threefry_partitionable", True)


def pytest_configure(config):
    # pytest-timeout is not installed on this image; the mark is registered
    # as DOCUMENTATION of each test's budget (silences unknown-mark
    # warnings).  The real hang protection in the multiprocess tests is
    # their explicit subprocess deadlines (communicate(timeout=...) against
    # a shared monotonic deadline + kill() in finally).
    config.addinivalue_line(
        "markers",
        "timeout(seconds): intended wall-clock budget; enforced by the "
        "tests' own subprocess deadlines, not by a pytest plugin")
    config.addinivalue_line(
        "markers",
        "slow: excluded from the tier-1 budgeted run (-m 'not slow'); "
        "the full unfiltered suite still runs these — heavyweight "
        "end-to-end/interpret-mode parity tests whose core coverage a "
        "cheaper sibling already provides, plus multiprocess launcher "
        "tests that need more CPU than the 1.5-core CI box offers")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card (hetu_tpu_torch's CUDA kernels have no "
        "CPU mode); skips with a reason elsewhere — on the card run "
        "`python -m pytest --noconftest tests/test_torch_kernels_gpu.py "
        "-m gpu`")
