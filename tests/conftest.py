"""Test configuration: 8 virtual CPU devices (so mesh/sharding tests run
without several accelerators — SURVEY.md section 4 test-strategy note), and
float64 enabled so numerical oracles are meaningful.

The platform is JAX's choice: run the suite on the CPU with
``JAX_PLATFORMS=cpu python -m pytest tests/``, and the tests that need the
card (marked ``gpu``; they skip elsewhere) with
``python -m pytest -m gpu tests/`` on a machine with a GPU.

Must set env vars before jax initializes.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    _flags += " --xla_force_host_platform_device_count=8"
# XLA CPU's in-process collectives CHECK-fail (abort, no Python traceback)
# when any virtual device thread misses an all-reduce rendezvous by 40 s.
# On an oversubscribed box (8 virtual devices on 2 cores running 1024-chain
# sharded pipelines) stragglers legitimately exceed that, killing the test
# process intermittently — observed on tests/test_config5.py, root-caused
# via xla::cpu::InProcessCommunicator::AllReduce rendezvous logs. Raise the
# deadline; meshes of real devices don't use this code path at all.
if "xla_cpu_collective_call_terminate_timeout_seconds" not in _flags:
    _flags += (
        " --xla_cpu_collective_call_warn_stuck_timeout_seconds=300"
        " --xla_cpu_collective_call_terminate_timeout_seconds=1200"
    )
os.environ["XLA_FLAGS"] = _flags.strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU. Decided here, at test
    time, so every xdist worker collects the same tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run `python -m pytest -m gpu tests/` on the card")
