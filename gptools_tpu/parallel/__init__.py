"""Parallel layer: device meshes, sharded chains/particles, collectives.

Replacement for the reference's only parallelism mechanism —
single-node ``multiprocessing.Pool`` fan-outs (SURVEY.md sections 2.3-2.4):

=================================  =======================================
reference                           here
=================================  =======================================
Pool over MAP random starts         ``vmap`` on-device; starts sharded over
(``optimize_hyperparameters``)      the mesh for large sweeps
emcee walkers + worker processes    chains axis of the vmapped NUTS/HMC
(``sample_hyperparameter_post.``)   state sharded over the mesh; pooled
                                    adaptation stats become all-reduces
Pool over posterior samples         ``vmap`` + mesh sharding of the sample
(``compute_from_MCMC``)             axis (batched Cholesky per shard)
(no distributed backend at all)     ``jax.distributed`` + GSPMD collectives
=================================  =======================================
"""

from gptools_tpu.parallel import distributed
from gptools_tpu.parallel.mesh import (
    chain_sharding,
    make_mesh,
    shard_chains,
    sharded_sample,
    sharded_smc,
)

__all__ = [
    "distributed",
    "make_mesh",
    "chain_sharding",
    "shard_chains",
    "sharded_sample",
    "sharded_smc",
]
