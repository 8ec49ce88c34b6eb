"""Multi-process worker: exercises the jax.distributed bootstrap for real.

Launched N times (one per process) by tests/test_multiprocess.py — and
usable by hand as a template for real multi-host runs:

    python scripts/mp_worker.py --coordinator localhost:9876 \
        --num-processes 2 --process-id 0 --local-devices 4

Each process owns ``--local-devices`` virtual CPU devices; the global mesh is
(num_processes x local devices). The worker builds the ('hosts', 'gpus') pod
mesh, runs ONE sharded NUTS training step and ONE sharded SMC round across
all processes (the two collective patterns of the engine: pooled-adaptation
all-reduce and weight-normalization/resampling), checks the compiled HLO for
cross-process collectives, and prints machine-readable result lines.

SURVEY.md section 2.4: the reference has no distributed backend (single-node
multiprocessing only); this is the rebuild's multi-host equivalence proof.
"""

import argparse
import os
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=4)
    args = ap.parse_args()

    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={args.local_devices}"
    ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from gptools_tpu.parallel import distributed

    distributed.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )
    assert jax.process_count() == args.num_processes, jax.process_count()
    n_global = args.num_processes * args.local_devices
    assert jax.device_count() == n_global, jax.device_count()
    print(
        f"proc {args.process_id}: {jax.process_count()} processes, "
        f"{jax.device_count()} global devices",
        flush=True,
    )

    import numpy as np
    import jax.numpy as jnp

    from gptools_tpu.models.dataset import DatasetBuilder
    from gptools_tpu.models.gp import GPModel
    from gptools_tpu.ops.kernels import SquaredExponentialKernel
    from gptools_tpu.parallel import mesh as pmesh
    from gptools_tpu.utils.priors import LogNormalJointPrior

    rng = np.random.default_rng(0)
    X = np.linspace(0, 2, 8)
    b = DatasetBuilder(1)
    b.add(X, np.sin(X) + 0.05 * rng.standard_normal(8), err_y=0.05)
    data = b.build()
    model = GPModel(
        SquaredExponentialKernel(hyperprior=LogNormalJointPrior([0, -1], [1, 1]))
    )

    mesh = distributed.pod_mesh()  # ('hosts', 'gpus'): processes x local devices
    assert mesh.devices.shape == (args.num_processes, args.local_devices)

    # ---- sharded NUTS training step (pooled-adaptation all-reduce) --------
    # flatten the 2-D pod mesh into the 1-D chains mesh the step builder uses
    from jax.sharding import Mesh

    flat_mesh = Mesh(mesh.devices.reshape(-1), ("chains",))
    step, (u0, da0, inv_mass0) = pmesh.training_step_sharded(
        model, data, flat_mesh, num_chains=2 * n_global
    )
    keys = jax.random.split(jax.random.PRNGKey(0), u0.shape[0])
    hlo = step.lower(u0, keys, da0, inv_mass0).compile().as_text()
    has_collective = ("all-reduce" in hlo) or ("all_reduce" in hlo)
    q, logp, da, _ = step(u0, keys, da0, inv_mass0)
    # logp spans non-addressable devices: reduce to a replicated scalar
    # on-device before fetching (the all-reduce rides the gloo backend)
    all_finite = jax.jit(lambda x: jnp.isfinite(x).all())
    ok_step = bool(jax.device_get(all_finite(logp))) and bool(
        np.isfinite(float(jax.device_get(da.log_eps)))
    )
    print(
        f"proc {args.process_id}: step ok={ok_step} collective={has_collective}",
        flush=True,
    )

    # ---- sharded SMC round (weight normalization + resampling gather) ----
    from gptools_tpu.infer import smc as _smc

    res = _smc.sample(
        model,
        data,
        jax.random.PRNGKey(1),
        num_particles=4 * n_global,
        num_mutations=2,
        max_rounds=12,
        mesh=flat_mesh,
    )
    log_z = float(jax.device_get(res.diagnostics["log_evidence"]))
    means = np.asarray(
        jax.device_get(jax.jit(lambda x: x.mean(axis=0))(res.thetas[0]))
    )
    ok_smc = bool(np.isfinite(log_z) and np.isfinite(means).all())
    print(
        f"proc {args.process_id}: smc ok={ok_smc} log_z={log_z:.4f} "
        f"means={means.round(4).tolist()}",
        flush=True,
    )

    if not (ok_step and has_collective and ok_smc):
        sys.exit(1)
    print(f"proc {args.process_id}: MP-OK", flush=True)


if __name__ == "__main__":
    main()
