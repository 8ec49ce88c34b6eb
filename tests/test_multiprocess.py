"""REAL multi-process distributed execution.

Spawns 2 OS processes, each with 4 virtual CPU devices, joined through
``jax.distributed.initialize`` into one 8-device cluster, and runs the
engine's two collective patterns across the process boundary:

- one sharded NUTS training step (pooled dual-averaging all-reduce), with an
  HLO check for the collective;
- one full sharded SMC run (weight normalization + resampling gathers).

This is the only test in the suite that exercises
``gptools_tpu.parallel.distributed.initialize`` with process_count > 1 —
everything else runs single-process on a virtual mesh.
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "mp_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_cluster_runs_sharded_step_and_smc():
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")

    procs = [
        subprocess.Popen(
            [
                sys.executable,
                WORKER,
                "--coordinator",
                f"localhost:{port}",
                "--num-processes",
                "2",
                "--process-id",
                str(pid),
                "--local-devices",
                "4",
            ],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=900)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multi-process workers timed out:\n" + "\n".join(outs))

    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid}: MP-OK" in out, f"proc {pid} output:\n{out}"
        assert "collective=True" in out, f"no cross-process collective:\n{out}"
        assert "2 processes, 8 global devices" in out

    # both processes must agree on the (replicated) SMC results
    smc_lines = [
        [ln for ln in out.splitlines() if "smc ok=" in ln][0] for out in outs
    ]
    assert smc_lines[0].split(": ", 1)[1] == smc_lines[1].split(": ", 1)[1], smc_lines
