"""SMC-initialized massively-parallel NUTS: the flagship inference pipeline.

Rationale: one accelerator runs thousands of chains for nearly the
price of one, so the optimal regime is MANY SHORT chains — but short chains
only work if they start in (and correctly across) the posterior's modes.
Adaptive tempered SMC (`gptools_tpu.infer.smc`) provides exactly that: its
final particle ensemble is an (approximately) correctly-weighted posterior
sample, including multimodal mass splits that independent prior-initialized
NUTS chains get stuck on (the Gibbs-kernel profile posteriors of
BASELINE.json config 4 are the motivating case). The pipeline:

1. SMC to beta = 1 -> particles + empirical covariance;
2. initialize C >> particles chains by resampling the ensemble;
3. short NUTS warmup (step size only — the mass matrix comes from the SMC
   covariance diagonal) + sampling.

This is the configuration `bench.py` measures for the north-star ESS/s.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from gptools_tpu.infer import chees as _chees
from gptools_tpu.infer import nuts as _nuts
from gptools_tpu.infer import smc as _smc
from gptools_tpu.infer.hmc import SampleResult

__all__ = ["smc_then_nuts", "smc_then_chees"]

# the whitening products run at full f32 precision (no TF32 on the GPU)
_HI = jax.lax.Precision.HIGHEST


def _stable_fns(model, data):
    """Per-(model, data) cache of the density closures handed to the
    ChEES sampler.

    The sampler's compiled-program cache (`chees._build_programs`) is keyed
    on the density function's IDENTITY, so these closures must be created
    once per model/data pair — a fresh lambda per pipeline call would force
    a fresh multi-minute XLA compile per call (exactly the bug this fixes:
    the r3 bench's priming run primed nothing because every repeat rebuilt
    the jitted programs; see BASELINE.md). Whitening moments are NOT closed
    over — they arrive through the sampler's ``logp_params`` operand.

    A sharded and an unsharded run share the closures: the jitted programs
    specialize on their inputs' shardings, and GSPMD partitions the batched
    density over the chain axis.

    The cache entry holds ``data`` strongly, so the ``id(data)`` key cannot
    be reused by a different object while the entry lives.
    """
    cache = model.__dict__.setdefault("_pipeline_fn_cache", {})
    cache_key = id(data)
    entry = cache.get(cache_key)
    if entry is not None and entry["data"] is data:
        return entry
    if len(cache) > 8:
        cache.clear()
    batched = model._batch_supported(data)

    def logp_w(v, params):
        mu, C = params
        return model.log_posterior_u(
            mu + jnp.matmul(C, v, precision=_HI), data
        )

    def logp_u(u, params):
        del params
        return model.log_posterior_u(u, data)

    logp_w_batched = logp_u_batched = None
    if batched:

        def logp_w_batched(vs, params):
            mu, C = params
            return model.log_posterior_u_batch(
                jnp.matmul(vs, C.T, precision=_HI) + mu, data
            )

        def logp_u_batched(us, params):
            del params
            return model.log_posterior_u_batch(us, data)

    entry = {
        "data": data,
        "logp_w": logp_w,
        "logp_w_batched": logp_w_batched,
        "logp_u": logp_u,
        "logp_u_batched": logp_u_batched,
    }
    cache[cache_key] = entry
    return entry


@jax.jit
def _whiten_init(C, mu, u0):
    """v0 = C^{-1} (u0 - mu) rowwise (module-level jit: compiles once)."""
    return jax.vmap(
        lambda u: jax.scipy.linalg.solve_triangular(C, u - mu, lower=True)
    )(u0)


@jax.jit
def _unwhiten_samples(C, mu, vs):
    """u = mu + C v over a (chains, samples, P) stack."""
    return mu + jnp.einsum("ij,csj->csi", C, vs, precision=_HI)


def _embed2(model):
    """Cached jit of the double-vmapped u -> theta embedding."""
    f = model.__dict__.get("_embed2_jit")
    if f is None:
        f = jax.jit(jax.vmap(jax.vmap(model.theta_of_u)))
        model.__dict__["_embed2_jit"] = f
    return f


def _chain_sharding(mesh, mesh_axis, num_chains):
    """Chain-axis NamedSharding for the pipeline's (C, P) state, or None.

    BASELINE config 5 path: both SMC particles and sampler chains lay their
    leading axis over the mesh; GSPMD propagates the sharding through every
    jitted chunk, so the pooled adaptation statistics (step size, ChEES tau)
    lower to cross-device all-reduces — the collective step-size adaptation
    the north-star names (SURVEY.md section 2.4).
    """
    if mesh is None:
        return None
    from jax.sharding import NamedSharding, PartitionSpec

    axis = mesh_axis or mesh.axis_names[0]
    if num_chains % mesh.devices.size != 0:
        raise ValueError(
            f"num_chains {num_chains} must be a multiple of mesh size "
            f"{mesh.devices.size}"
        )
    return NamedSharding(mesh, PartitionSpec(axis))


def smc_then_nuts(
    model,
    data,
    key: jax.Array,
    num_chains: int = 1024,
    num_warmup: int = 150,
    num_samples: int = 350,
    num_particles: int = 1024,
    max_depth: int = 8,
    target_accept: float = 0.85,
    whiten: bool = True,
    smc_kwargs: Optional[dict] = None,
    mesh=None,
    mesh_axis: Optional[str] = None,
) -> SampleResult:
    """Run SMC, then NUTS chains initialized from the particle ensemble.

    ``whiten=True`` runs NUTS in the SMC-covariance-whitened coordinates
    (full preconditioner, shorter trees); otherwise the SMC variance is used
    as a frozen diagonal mass matrix. ``mesh``: optional
    `jax.sharding.Mesh` — SMC particles and NUTS chains shard their leading
    axis over it (BASELINE config 5).
    """
    sh_chain = _chain_sharding(mesh, mesh_axis, num_chains)
    k_smc, k_res, k_nuts = jax.random.split(key, 3)
    smc_res = _smc.sample(
        model, data, k_smc, num_particles=num_particles,
        mesh=mesh, mesh_axis=mesh_axis, **(smc_kwargs or {})
    )
    particles = smc_res.u[0]  # (N, P) unconstrained

    idx = jax.random.randint(k_res, (num_chains,), 0, particles.shape[0])
    u0 = particles[idx]
    if sh_chain is not None:
        u0 = jax.device_put(u0, sh_chain)

    # stable per-(model, data) closures + whitening moments as operands:
    # repeated calls reuse the compiled NUTS window programs
    # (hmc._window_program)
    fns = _stable_fns(model, data)
    if whiten:
        mu = jnp.mean(particles, axis=0)
        P = particles.shape[1]
        with jax.default_matmul_precision("highest"):
            cov = jnp.cov(particles.T)
        cov = cov + 1e-8 * jnp.eye(P, dtype=particles.dtype)
        C = jnp.linalg.cholesky(cov)

        v0 = _whiten_init(C, mu, u0)
        # The whitening jit can emit a fully-replicated v0 even when u0 is
        # chain-sharded (GSPMD resolves the small solve to a replicated
        # layout), which would silently run every chain on every device.
        # Re-pin the chain axis so the sampler stage stays sharded.
        if sh_chain is not None:
            v0 = jax.device_put(v0, sh_chain)
        res = _nuts.sample(
            fns["logp_w"],
            v0,
            k_nuts,
            num_warmup=num_warmup,
            num_samples=num_samples,
            max_depth=max_depth,
            target_accept=target_accept,
            adapt_mass=False,
            eps0=0.3,
            logp_params=(mu, C),
        )
        res = res._replace(u=_unwhiten_samples(C, mu, res.u))
    else:
        var = jnp.var(particles, axis=0) + 1e-10

        res = _nuts.sample(
            fns["logp_u"],
            u0,
            k_nuts,
            num_warmup=num_warmup,
            num_samples=num_samples,
            max_depth=max_depth,
            target_accept=target_accept,
            adapt_mass=False,
            inv_mass0=var,
            logp_params=(),
        )
    thetas = _embed2(model)(res.u)
    res = res._replace(thetas=thetas)
    res.diagnostics["smc_log_evidence"] = smc_res.diagnostics["log_evidence"]
    res.diagnostics["smc_rounds"] = smc_res.diagnostics["num_rounds"]
    return res


def smc_then_chees(
    model,
    data,
    key: jax.Array,
    num_chains: int = 2048,
    num_warmup: int = 150,
    num_samples: int = 350,
    num_particles: int = 1024,
    target_accept: float = 0.75,
    max_steps: int = 256,
    whiten: bool = True,
    smc_kwargs: Optional[dict] = None,
    chees_kwargs: Optional[dict] = None,
    cost_normalize: bool = True,
    cost_elasticity: float = 0.6,
    mesh=None,
    mesh_axis: Optional[str] = None,
) -> SampleResult:
    """SMC warm start + ChEES-HMC chains: the fastest configuration
    (uniform trajectory lengths -> zero masked-lane waste; see
    `gptools_tpu.infer.chees`).

    ``whiten=True`` runs the chains in the affinely-whitened coordinates
    ``v = C^{-1}(u - mu)`` with (mu, C C^T) the SMC ensemble moments — a FULL
    covariance preconditioner (the diagonal-mass equivalent of a dense mass
    matrix), which shortens trajectories on correlated posteriors. The
    affine map has constant Jacobian, so no density correction is needed.

    ``cost_normalize=True`` (default) adapts the shared trajectory time to
    maximize the ChEES criterion PER LEAPFROG rather than per iteration —
    measured 1.5-2x ESS/s on the flagship posterior at identical quality
    gates (BASELINE.md r3 tau sweep); set False for the plain ChEES rule.
    ``cost_elasticity`` is the equilibrium target of that rule: 1.0 is the
    exact criterion-per-time stationary point; the default 0.6 is calibrated
    on hardware against a fixed-tau ESS/s sweep OF THE FLAGSHIP POSTERIOR
    (BASELINE.json config 4 — the ChEES criterion is a proxy for ESS, and
    its elasticity-1 point lands slightly short of the measured
    ESS-per-leapfrog optimum there; BASELINE.md r3 elasticity sweep). The
    calibration is posterior-specific: on a markedly different target,
    sweep it (`scripts/sweep_tau.py --elasticities`) or pass 1.0 via
    ``chees_kwargs`` for the theoretically motivated equilibrium. Both may
    be overridden via ``chees_kwargs``.

    ``mesh``: optional `jax.sharding.Mesh` — SMC particles and ChEES chains
    shard their leading axis over it, with the pooled step-size/tau
    adaptation lowering to cross-device all-reduces (BASELINE config 5).
    """
    sh_chain = _chain_sharding(mesh, mesh_axis, num_chains)
    ck = {"cost_normalize": cost_normalize,
          "cost_elasticity": cost_elasticity}
    ck.update(chees_kwargs or {})
    # Keys the _chees.sample calls below pass EXPLICITLY must be popped out
    # of ck, or supplying them via chees_kwargs raises "got multiple values";
    # popping also keeps the explicit arguments and ck consistent.
    target_accept = ck.pop("target_accept", target_accept)
    max_steps = ck.pop("max_steps", max_steps)
    for k in ("logp_batched", "logp_params"):
        if k in ck:
            raise ValueError(
                f"chees_kwargs[{k!r}] is managed by the pipeline (the density "
                "closures and whitening moments are wired internally); it "
                "cannot be overridden here"
            )
    fns = _stable_fns(model, data)
    k_smc, k_res, k_run = jax.random.split(key, 3)
    smc_res = _smc.sample(
        model, data, k_smc, num_particles=num_particles,
        mesh=mesh, mesh_axis=mesh_axis, **(smc_kwargs or {})
    )
    particles = smc_res.u[0]
    idx = jax.random.randint(k_res, (num_chains,), 0, particles.shape[0])
    u0 = particles[idx]
    if sh_chain is not None:
        u0 = jax.device_put(u0, sh_chain)

    # run-specific whitening moments go through the sampler's logp_params
    # operand so repeated pipeline calls reuse the compiled sampler
    # programs (chees._build_programs; `fns` built before the SMC stage)
    if whiten:
        mu = jnp.mean(particles, axis=0)
        P = particles.shape[1]
        with jax.default_matmul_precision("highest"):
            cov = jnp.cov(particles.T)
        cov = cov + 1e-8 * jnp.eye(P, dtype=particles.dtype)
        C = jnp.linalg.cholesky(cov)

        v0 = _whiten_init(C, mu, u0)
        # See smc_then_nuts: the whitening jit can drop the chain sharding
        # (replicated output), making the mesh a no-op for the sampler stage.
        if sh_chain is not None:
            v0 = jax.device_put(v0, sh_chain)
        res = _chees.sample(
            fns["logp_w"],
            v0,
            k_run,
            num_warmup=num_warmup,
            num_samples=num_samples,
            target_accept=target_accept,
            eps0=ck.pop("eps0", 0.3),
            max_steps=max_steps,
            # chains-minor batched density (ops/evidence.py :: loglik_b) when
            # the model supports it: same values/grads, cheaper per leapfrog
            logp_batched=fns["logp_w_batched"],
            logp_params=(mu, C),
            **ck,
        )
        res = res._replace(u=_unwhiten_samples(C, mu, res.u))
    else:
        var = jnp.var(particles, axis=0) + 1e-10

        res = _chees.sample(
            fns["logp_u"],
            u0,
            k_run,
            num_warmup=num_warmup,
            num_samples=num_samples,
            target_accept=target_accept,
            # pop explicitly-passed keys so chees_kwargs overrides don't
            # raise "got multiple values" (same class as the
            # target_accept/max_steps/eps0 pops above); defaults match the
            # previous behavior (chees.sample's own eps0 default here)
            eps0=ck.pop("eps0", 0.1),
            inv_mass0=ck.pop("inv_mass0", var),
            max_steps=max_steps,
            logp_batched=fns["logp_u_batched"],
            logp_params=(),
            **ck,
        )

    thetas = _embed2(model)(res.u)
    res = res._replace(thetas=thetas)
    res.diagnostics["smc_log_evidence"] = smc_res.diagnostics["log_evidence"]
    res.diagnostics["smc_rounds"] = smc_res.diagnostics["num_rounds"]
    return res
