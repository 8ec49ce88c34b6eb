"""Mesh construction and chain/particle sharding.

Design (SURVEY.md section 7.1 "replace multiprocessing with a mesh"): the
sampler state's leading axis (chains for NUTS/HMC, particles for SMC) is laid
out over a 1-D ``jax.sharding.Mesh`` (2-D hosts x GPUs across hosts,
`gptools_tpu.parallel.distributed.pod_mesh`). All per-chain
computation is embarrassingly parallel, so GSPMD partitions the vmapped
transition automatically from the input sharding; the ONLY cross-device
traffic is:

- the pooled adaptation statistic (``jnp.mean`` over chains -> all-reduce
  over NVLink) once per iteration, a few bytes;
- SMC weight normalization + resampling gathers (particles are ~10 floats
  each at GP-hyperparameter dimensionality, so a full gather is cheap).

The GPUs of one host are joined all to all by NVLink, so the mesh follows
the algorithm alone: one chain axis, no torus shape. Multi-host: call
``gptools_tpu.parallel.distributed.initialize`` before building the mesh;
the same code runs unchanged over hosts x local GPUs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "make_mesh",
    "chain_sharding",
    "shard_chains",
    "sharded_sample",
    "sharded_smc",
    "pt_step_sharded",
]

CHAIN_AXIS = "chains"


def make_mesh(
    num_devices: Optional[int] = None, axis_name: str = CHAIN_AXIS
) -> Mesh:
    """1-D mesh over (the first ``num_devices``) devices."""
    devs = jax.devices()
    if num_devices is not None:
        devs = devs[:num_devices]
    return Mesh(np.asarray(devs), (axis_name,))


def chain_sharding(mesh: Mesh, axis_name: str = CHAIN_AXIS) -> NamedSharding:
    """Leading-axis sharding for (chains, ...) state pytrees."""
    return NamedSharding(mesh, P(axis_name))


def shard_chains(tree, mesh: Mesh, axis_name: str = CHAIN_AXIS):
    """Device-put every leaf with its leading axis over the mesh."""
    sh = chain_sharding(mesh, axis_name)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), tree)


def sharded_sample(
    logp,
    u0: jax.Array,
    key: jax.Array,
    mesh: Optional[Mesh] = None,
    sampler: str = "nuts",
    **kwargs,
):
    """NUTS/HMC with the chains axis sharded over the mesh.

    ``u0``: (num_chains, P); num_chains should be a multiple of the mesh
    size. All adaptation pooling inside becomes cross-device collectives.
    """
    from gptools_tpu.infer import hmc, nuts

    if mesh is None:
        mesh = make_mesh()
    axis = mesh.axis_names[0]
    if u0.shape[0] % mesh.devices.size != 0:
        raise ValueError(
            f"num_chains {u0.shape[0]} must be a multiple of mesh size "
            f"{mesh.devices.size}"
        )
    u0 = jax.device_put(u0, NamedSharding(mesh, P(axis)))
    mod = nuts if sampler == "nuts" else hmc
    return mod.sample(logp, u0, key, **kwargs)


def sharded_smc(model, data, key, mesh: Optional[Mesh] = None, **kwargs):
    """SMC with the particle axis sharded over the mesh.

    Weight normalization (logsumexp over particles) and the ESS bisection
    lower to all-reduces; systematic resampling is a gather — trivial traffic
    at hyperparameter dimensionality (SURVEY.md section 7.3 #3).
    """
    from gptools_tpu.infer import smc

    if mesh is None:
        mesh = make_mesh()
    return smc.sample(model, data, key, mesh=mesh, **kwargs)


def training_step_sharded(model, data, mesh: Mesh, num_chains: int):
    """Build ONE jitted, sharded sampling step: a vmapped NUTS transition
    plus pooled (collective) dual-averaging update — the 'training step' of
    this engine. Used by the multi-chip dry run and benchmarks.

    Returns (step_fn, init_state) with step_fn jitted with explicit
    in/out shardings over the chains axis.
    """
    from gptools_tpu.infer import hmc as _hmc
    from gptools_tpu.infer import nuts as _nuts

    axis = mesh.axis_names[0]
    sh_chain = NamedSharding(mesh, P(axis))
    sh_rep = NamedSharding(mesh, P())

    def logp(u):
        return model.log_posterior_u(u, data)

    logp_and_grad = jax.value_and_grad(logp)
    transition = _nuts.nuts_transition_builder(max_depth=8)(logp_and_grad)

    def step(qs, keys, da, inv_mass):
        q_new, logp_v, stats = jax.vmap(
            lambda q, k: transition(q, k, jnp.exp(da.log_eps), inv_mass)
        )(qs, keys)
        q_new = jax.lax.with_sharding_constraint(q_new, sh_chain)
        pooled = jnp.mean(stats["accept_prob"])  # all-reduce over the mesh
        da_new = _hmc.da_update(da, pooled)
        return q_new, logp_v, da_new, stats

    step_jit = jax.jit(
        step,
        in_shardings=(sh_chain, sh_chain, sh_rep, sh_rep),
        out_shardings=(sh_chain, sh_chain, sh_rep, None),
    )

    nf = model.num_free_params
    u0 = jnp.zeros((num_chains, nf))
    da0 = _hmc.da_init(jnp.asarray(0.1, u0.dtype))
    inv_mass0 = jnp.ones((nf,), u0.dtype)
    return step_jit, (u0, da0, inv_mass0)


def pt_step_sharded(
    model,
    data,
    mesh: Mesh,
    num_temps: int,
    num_chains: int,
    num_steps: int = 8,
    beta_min: float = 0.1,
):
    """One jitted parallel-tempering sweep sharded over a 2-D mesh — the
    "tempering ladder as a mesh axis" design (SURVEY.md section 2.3 PT row).

    State is (T, C, P) with T over ``mesh.axis_names[0]`` and C over
    ``mesh.axis_names[1]``. The HMC sweep is embarrassingly parallel over
    both axes; per-rung step-size pooling all-reduces over the chains axis
    only; and the replica-exchange ``jnp.roll`` over the temperature axis
    lowers to a ``ppermute`` between neighbouring devices.

    Returns ``(step_fn, init_state)`` where
    ``step_fn(u, key, eps, inv_mass, step_idx) -> (u', ll, swap_frac, accept)``.
    """
    from gptools_tpu.infer import hmc as _hmc
    from gptools_tpu.infer import pt as _pt

    t_axis, c_axis = mesh.axis_names[0], mesh.axis_names[1]
    sh_state = NamedSharding(mesh, P(t_axis, c_axis))     # (T, C, P)
    sh_tc = NamedSharding(mesh, P(t_axis, c_axis))        # (T, C)
    sh_t = NamedSharding(mesh, P(t_axis))                 # (T,) / (T, P)
    sh_rep = NamedSharding(mesh, P())

    dtype = jnp.asarray(model.initial_params).dtype
    betas = _pt.geometric_ladder(num_temps, beta_min, dtype)
    log_like_fn, log_prior_fn = _pt.model_splits(model, data)

    def rung_logp_and_grad(beta):
        return _pt.tempered_logp_and_grad(log_like_fn, log_prior_fn, beta)

    def sweep(u, key, eps, inv_mass, step_idx):
        k_hmc, k_swap = jax.random.split(key)
        T, C, _ = u.shape

        def rung(q_rung, keys_rung, eps_t, inv_mass_t, beta_t):
            lg = rung_logp_and_grad(beta_t)
            return jax.vmap(
                lambda q, k: _hmc._hmc_transition(
                    lg, q, k, eps_t, inv_mass_t, num_steps
                )
            )(q_rung, keys_rung)

        keys = jax.random.split(k_hmc, T * C).reshape(T, C, -1)
        u_new, logp_beta, stats = jax.vmap(rung)(u, keys, eps, inv_mass, betas)
        lp = jax.vmap(jax.vmap(log_prior_fn))(u_new)
        ll = (logp_beta - lp) / betas[:, None]
        (u_new, _), ll, swap_frac = _pt._swap_step(
            [u_new, lp], ll, betas, k_swap, step_idx % 2
        )
        u_new = jax.lax.with_sharding_constraint(u_new, sh_state)
        return u_new, ll, swap_frac, stats["accept_prob"]

    step_jit = jax.jit(
        sweep,
        in_shardings=(sh_state, sh_rep, sh_t, sh_t, sh_rep),
        out_shardings=(sh_state, sh_tc, None, sh_tc),
    )

    nf = model.num_free_params
    u0 = jnp.zeros((num_temps, num_chains, nf), dtype)
    eps0 = jnp.full((num_temps,), 0.1, dtype)
    inv_mass0 = jnp.ones((num_temps, nf), dtype)
    return step_jit, (u0, eps0, inv_mass0)
