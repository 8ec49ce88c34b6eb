"""Inference layer: MAP, HMC, NUTS, SMC, ADVI — all driving the single
differentiable ``log_posterior_u`` of `gptools_tpu.models.gp.GPModel`.

Counterpart of the reference's inference layer (SURVEY.md
sections 2.3 and 3): ``optimize_hyperparameters`` (multiprocessing multi-start
SLSQP) becomes vmapped L-BFGS; ``sample_hyperparameter_posterior`` (emcee
ensemble walkers / parallel tempering over process pools) becomes vectorized
NUTS/HMC chains, adaptive tempered SMC, and ADVI, all jit-compiled with the
chains/particles axis ready to shard over a device mesh
(`gptools_tpu.parallel`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from gptools_tpu.infer import advi, chees, hmc, map_fit, nuts, pipeline, pt, smc
from gptools_tpu.infer.hmc import SampleResult

__all__ = [
    "run_sampler",
    "SampleResult",
    "hmc",
    "nuts",
    "smc",
    "chees",
    "advi",
    "map_fit",
    "pipeline",
    "pt",
]


def run_sampler(
    model,
    data,
    key,
    sampler: str = "nuts",
    num_chains: int = 8,
    num_samples: int = 1000,
    num_warmup: int = 500,
    init: str = "prior",
    **kwargs,
):
    """Dispatch to a posterior sampler over GP hyperparameters.

    Replaces ``gptools/core.py :: sample_hyperparameter_posterior``'s
    ``sampler_type`` switch (emcee Ensemble/PT) with ``sampler in
    {'nuts', 'hmc', 'chees', 'pt', 'smc', 'advi', 'smc+nuts', 'smc+chees'}``
    ('pt' is true replica-exchange HMC over a temperature ladder, the
    PTSampler counterpart — see `gptools_tpu.infer.pt`)
    ('smc+chees' is the fastest configuration — SMC warm start + whitened
    ChEES-HMC). Returns a `SampleResult` whose ``thetas`` are
    (chains, samples, P) constrained hyperparameters.
    """
    logp = model_logp(model, data)
    dim = model.num_free_params
    k_init, k_run = jax.random.split(jax.random.PRNGKey(key) if isinstance(key, int) else key)

    if sampler in ("nuts", "hmc", "chees"):
        u0 = _initial_positions(model, k_init, num_chains, init)
        mod = {"nuts": nuts, "hmc": hmc, "chees": chees}[sampler]
        if sampler == "chees" and "logp_batched" not in kwargs:
            # chains-minor batched evidence when the model supports it —
            # same speedup the pipeline gets (cached per model/data so the
            # compiled-program cache keys stay stable)
            batched = _model_logp_batched(model, data)
            if batched is not None:
                kwargs = dict(kwargs, logp_batched=batched)
        result = mod.sample(
            logp,
            u0,
            k_run,
            num_warmup=num_warmup,
            num_samples=num_samples,
            **kwargs,
        )
        return _attach_thetas(model, result)
    if sampler in ("smc+chees", "smc-chees"):
        return pipeline.smc_then_chees(
            model,
            data,
            k_run,
            num_chains=num_chains,
            num_samples=num_samples,
            num_warmup=num_warmup,
            **kwargs,
        )
    if sampler in ("smc+nuts", "smc-nuts"):
        return pipeline.smc_then_nuts(
            model,
            data,
            k_run,
            num_chains=num_chains,
            num_samples=num_samples,
            num_warmup=num_warmup,
            **kwargs,
        )
    if sampler in ("pt", "tempered"):
        return pt.sample(
            model,
            data,
            k_run,
            num_chains=num_chains,
            num_samples=num_samples,
            num_warmup=num_warmup,
            init=init,
            **kwargs,
        )
    if sampler == "smc":
        num_particles = kwargs.pop("num_particles", max(num_chains * num_samples // 4, 256))
        return smc.sample(model, data, k_run, num_particles=num_particles, **kwargs)
    if sampler == "advi":
        return advi.sample(
            model, data, k_run, num_samples=num_samples, **kwargs
        )
    raise ValueError(f"unknown sampler {sampler!r}")


def model_logp(model, data):
    """The unconstrained-space target closed over static model + data.

    Cached per (model, data) so its IDENTITY is stable across calls: the
    samplers' compiled-program caches (e.g. `chees._build_programs`) key on
    the density function object, so a fresh closure per `run_sampler` call
    would force a fresh XLA compile per call. The entry holds ``data``
    strongly, so the id key cannot be reused by a different object."""
    cache = model.__dict__.setdefault("_model_logp_cache", {})
    entry = cache.get(id(data))
    if entry is not None and entry[0] is data:
        return entry[1]
    if len(cache) > 8:
        cache.clear()

    def logp(u):
        return model.log_posterior_u(u, data)

    cache[id(data)] = (data, logp)
    return logp


def _model_logp_batched(model, data):
    """Stable-identity chains-minor batched density per (model, data), or
    None when the model/data combination has no batched path."""
    if not model._batch_supported(data):
        return None
    cache = model.__dict__.setdefault("_model_logp_batched_cache", {})
    entry = cache.get(id(data))
    if entry is not None and entry[0] is data:
        return entry[1]
    if len(cache) > 8:
        cache.clear()

    def logp_batched(us):
        return model.log_posterior_u_batch(us, data)

    cache[id(data)] = (data, logp_batched)
    return logp_batched


def _initial_positions(model, key, num_chains, init):
    if init == "prior":
        thetas = model.hyperprior.sample(key, (num_chains,))
        return jax.jit(jax.vmap(model.u_of_theta))(thetas)
    # jitter around current initial params
    u0 = model.u_of_theta(jnp.asarray(model.initial_params))
    noise = 0.1 * jax.random.normal(key, (num_chains, model.num_free_params))
    return u0[None, :] + noise


def _attach_thetas(model, result: "SampleResult") -> "SampleResult":
    C, S, P = result.u.shape
    thetas = jax.jit(jax.vmap(jax.vmap(model.theta_of_u)))(result.u)
    return result._replace(thetas=thetas)
