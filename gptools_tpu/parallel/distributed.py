"""Multi-host initialization and mesh construction.

The reference has no distributed backend at all (SURVEY.md section 2.4 —
single-node ``multiprocessing`` only). This module is the multi-host entry
point of the rebuild: ``jax.distributed`` process bootstrap plus a 2-D
(hosts, local GPUs) mesh. The GPUs of one host are joined all to all by
NVLink, so the per-iteration collective traffic (pooled adaptation scalars,
SMC weight reductions) reduces within a host first and crosses the network
between hosts only for the tiny cross-host portion of the all-reduce.

Usage on each host:

    from gptools_tpu.parallel import distributed
    distributed.initialize("host0:1234", num_processes=2, process_id=rank)
    mesh = distributed.pod_mesh()              # ('hosts', 'gpus') 2-D mesh
    sharding = distributed.chain_sharding_2d(mesh)
    # shard the chain axis over all devices: chains = hosts x local GPUs

On one host a 1-D mesh over its GPUs (`gptools_tpu.parallel.make_mesh`) is
all the layout there is; no process group is needed.

The samplers themselves are topology-agnostic: they consume a sharded
(chains, P) state and reduce with ``jnp.mean``/``jnp.sum`` — GSPMD lowers
those to hierarchical all-reduces over the mesh axes.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["initialize", "pod_mesh", "chain_sharding_2d", "is_multiprocess"]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize ``jax.distributed`` when running multi-process.

    With no arguments this initializes only when the environment names a
    coordinator (``COORDINATOR_ADDRESS`` / ``JAX_COORDINATOR_ADDRESS``) and
    is otherwise a NO-OP for single-process runs, so library code can call
    it unconditionally.
    """
    # NOTE: must not touch the backend (jax.process_count / jax.devices)
    # before jax.distributed.initialize — backend init is one-shot and
    # would lock this process into single-process mode.
    from jax._src import distributed as _jd

    if _jd.is_initialized():
        return  # already initialized
    explicit = coordinator_address is not None or num_processes is not None
    if not explicit:
        # only auto-initialize when an environment actually provides
        # cluster metadata; otherwise stay single-process
        import os

        markers = ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS")
        if not any(m in os.environ for m in markers):
            return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (RuntimeError, ValueError):
        if explicit:
            # the caller asked for a real cluster: a coordinator that can't
            # be reached is a hard error, not a single-process fallback
            raise
        # auto-detect raced an already-initialized runtime: keep going


def is_multiprocess() -> bool:
    return jax.process_count() > 1


def pod_mesh(axis_names=("hosts", "gpus")) -> Mesh:
    """2-D mesh: hosts x local GPUs.

    Single-process: degenerates to (1, num_devices). Chains shard over BOTH
    axes (flattened), so the pooled-statistic all-reduce is hierarchical:
    an NVLink reduction per host, then one scalar hop between hosts.
    """
    n_proc = jax.process_count()
    local = jax.local_device_count()
    devs = np.asarray(jax.devices()).reshape(n_proc, local)
    return Mesh(devs, axis_names)


def chain_sharding_2d(mesh: Mesh) -> NamedSharding:
    """Shard a leading chains axis over all devices of the 2-D mesh."""
    return NamedSharding(mesh, P(mesh.axis_names))
