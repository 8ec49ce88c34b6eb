"""Adaptive tempered Sequential Monte Carlo over GP hyperparameters.

The reference's closest analogue is emcee's parallel-tempering option
(``gptools/core.py :: sample_hyperparameter_posterior(sampler_type='pt')``,
SURVEY.md section 2.3); the north star names SMC as its successor. Design:

- particles live in the unconstrained bijector space; the tempering path is
  ``pi_beta(u) ∝ prior(u) * likelihood(u)^beta`` from beta=0 (prior, exact
  i.i.d. draws) to beta=1 (posterior);
- the next inverse temperature is chosen ADAPTIVELY by bisection on the
  effective sample size of the incremental weights (target fraction
  ``ess_target``), entirely on-device (``lax.while_loop``);
- systematic resampling (lowest-variance standard scheme);
- mutation: several random-walk Metropolis steps preconditioned by the
  weighted particle covariance (full covariance, Cholesky-correlated
  proposals) — robust for the ~5-12 dim hyperparameter posteriors of this
  model family; each step is one vmapped batched-Cholesky likelihood sweep;
- the log normalizing constant (model evidence) accumulates for free.

The whole round (reweight -> resample -> mutate) is one jitted function of
the particle state; the host only drives the β-progression loop. Under pjit
the particle axis shards over the mesh: the ESS/normalization terms are
``jnp.sum`` over particles (-> psum), and resampling gathers — tiny at
hyperparameter dimensionality (SURVEY.md section 7.3 hard part #3 collapses
because particles are ~10 floats each).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from gptools_tpu.infer.hmc import SampleResult

__all__ = ["sample", "SMCState"]


@functools.lru_cache(maxsize=32)
def _round_program(log_like_fn, log_prior_fn, log_like_batched, ess_target,
                   num_mutations, state_sh):
    """Jitted SMC round, cached on the (stable) density-split functions plus
    static config — repeated SMC runs over the same (model, data) reuse the
    compiled round instead of recompiling it per `sample` call (the same
    program-reuse contract as `chees._build_programs`; `pt.model_splits` /
    `pt.model_splits_batched` guarantee stable function identities).
    ``state_sh``: optional SMCState of NamedShardings (hashable) for the
    mesh path."""
    kw = {}
    if state_sh is not None:
        kw = {"in_shardings": (state_sh,), "out_shardings": state_sh}
    return jax.jit(
        lambda s: smc_round(
            log_like_fn,
            log_prior_fn,
            s,
            ess_target=ess_target,
            num_mutations=num_mutations,
            log_like_batched=log_like_batched,
        ),
        **kw,
    )


@functools.lru_cache(maxsize=64)
def _vmapped_jit(fn):
    """jit(vmap(fn)) cached on fn identity (init-time particle sweeps)."""
    return jax.jit(jax.vmap(fn))


class SMCState(NamedTuple):
    u: jax.Array           # (N, P) particles (unconstrained)
    log_like: jax.Array    # (N,) cached log-likelihood terms
    log_prior: jax.Array   # (N,) cached prior (incl. log|det J|) terms
    beta: jax.Array        # scalar inverse temperature
    log_z: jax.Array       # accumulated log evidence
    key: jax.Array
    acc_rate: jax.Array    # last mutation acceptance rate


def _ess_fraction(log_w: jax.Array) -> jax.Array:
    lw = log_w - jax.scipy.special.logsumexp(log_w)
    return jnp.exp(-jax.scipy.special.logsumexp(2.0 * lw)) / log_w.shape[0]


def _systematic_resample(key, log_w, n):
    lw = log_w - jax.scipy.special.logsumexp(log_w)
    w = jnp.exp(lw)
    cum = jnp.cumsum(w)
    u0 = jax.random.uniform(key)
    pts = (u0 + jnp.arange(n)) / n
    idx = jnp.searchsorted(cum, pts)
    return jnp.clip(idx, 0, n - 1)


def _next_beta(log_like, beta, ess_target, n_bisect: int = 30):
    """Largest beta' in (beta, 1] whose incremental weights keep
    ESS >= ess_target * N, found by bisection (monotone in beta')."""

    def ess_at(b):
        return _ess_fraction((b - beta) * log_like)

    full = ess_at(jnp.asarray(1.0, log_like.dtype))

    def body(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        ok = ess_at(mid) >= ess_target
        return jnp.where(ok, mid, lo), jnp.where(ok, hi, mid)

    lo, hi = jax.lax.fori_loop(
        0, n_bisect, body, (beta, jnp.asarray(1.0, log_like.dtype))
    )
    return jnp.where(full >= ess_target, jnp.asarray(1.0, log_like.dtype), lo)


def smc_round(
    log_like_fn: Callable,
    log_prior_fn: Callable,
    state: SMCState,
    ess_target: float = 0.5,
    num_mutations: int = 5,
    proposal_scale: float = 1.0,
    log_like_batched: Optional[Callable] = None,
) -> SMCState:
    """One reweight -> resample -> mutate round (jitted by the driver).

    ``log_like_batched``: optional (N, P) -> (N,) likelihood for the
    mutation sweep (`pt.model_splits_batched`) — the chains-minor
    evidence instead of the vmapped per-particle scalar path.
    """
    n, p = state.u.shape
    dtype = state.u.dtype
    key, k_res, k_mut = jax.random.split(state.key, 3)

    beta_new = _next_beta(state.log_like, state.beta, ess_target)
    d_beta = beta_new - state.beta
    log_w = d_beta * state.log_like
    # evidence increment: log mean of incremental weights
    log_z = state.log_z + jax.scipy.special.logsumexp(log_w) - jnp.log(
        jnp.asarray(n, dtype)
    )

    idx = _systematic_resample(k_res, log_w, n)
    u = state.u[idx]
    log_like = state.log_like[idx]
    log_prior = state.log_prior[idx]

    # preconditioner from the (resampled, hence equal-weight) ensemble
    mean = jnp.mean(u, axis=0)
    centered = u - mean
    cov = jnp.matmul(
        centered.T, centered, precision=jax.lax.Precision.HIGHEST
    ) / n + 1e-8 * jnp.eye(p, dtype=dtype)
    chol = jnp.linalg.cholesky(cov)
    step = proposal_scale * 2.38 / jnp.sqrt(jnp.asarray(p, dtype))

    def mutate_once(carry, k):
        u, log_like, log_prior, n_acc = carry
        k1, k2 = jax.random.split(k)
        z = jax.random.normal(k1, u.shape, dtype)
        prop = u + step * jnp.matmul(
            z, chol.T, precision=jax.lax.Precision.HIGHEST
        )
        if log_like_batched is not None:
            ll_p = log_like_batched(prop)
        else:
            ll_p = jax.vmap(log_like_fn)(prop)
        lp_p = jax.vmap(log_prior_fn)(prop)
        log_alpha = (
            beta_new * ll_p + lp_p - (beta_new * log_like + log_prior)
        )
        log_alpha = jnp.where(jnp.isnan(log_alpha), -jnp.inf, log_alpha)
        accept = jnp.log(jax.random.uniform(k2, (n,), dtype)) < log_alpha
        u = jnp.where(accept[:, None], prop, u)
        log_like = jnp.where(accept, ll_p, log_like)
        log_prior = jnp.where(accept, lp_p, log_prior)
        return (u, log_like, log_prior, n_acc + jnp.mean(accept.astype(dtype))), None

    keys = jax.random.split(k_mut, num_mutations)
    (u, log_like, log_prior, n_acc), _ = jax.lax.scan(
        mutate_once, (u, log_like, log_prior, jnp.zeros((), dtype)), keys
    )

    return SMCState(
        u=u,
        log_like=log_like,
        log_prior=log_prior,
        beta=beta_new,
        log_z=log_z,
        key=key,
        acc_rate=n_acc / num_mutations,
    )


def sample(
    model,
    data,
    key: jax.Array,
    num_particles: int = 1024,
    ess_target: float = 0.5,
    num_mutations: int = 5,
    max_rounds: int = 100,
    verbose: bool = False,
    mesh=None,
    mesh_axis: Optional[str] = None,
) -> SampleResult:
    """Full adaptive-tempering SMC run. Returns equally-weighted posterior
    particles as a `SampleResult` (chains axis = 1) plus ``log_evidence`` in
    the diagnostics.

    ``mesh``: optional `jax.sharding.Mesh` — the particle axis of the state
    (u, log_like, log_prior) is laid out over ``mesh_axis`` (default: the
    mesh's first axis) and every round runs as one pjit program: ESS /
    normalization sums lower to all-reduces, resampling to gathers
    (SURVEY.md section 7.3 hard part #3).
    """
    # likelihood / prior(+log|det J|) split in u-space, shared with PT
    from gptools_tpu.infer.pt import model_splits, model_splits_batched

    embed = model.theta_of_u
    log_like_fn, log_prior_fn = model_splits(model, data)
    # batched mutation sweep (chains-minor evidence) when the model
    # supports it
    log_like_b = model_splits_batched(model, data)

    k_init, key = jax.random.split(key)
    thetas0 = model.hyperprior.sample(k_init, (num_particles,))
    u_of_theta = model.__dict__.get("_u_of_theta_jit")
    if u_of_theta is None:
        u_of_theta = jax.jit(jax.vmap(model.u_of_theta))
        model.__dict__["_u_of_theta_jit"] = u_of_theta
    u0 = u_of_theta(thetas0)
    dtype = u0.dtype

    state = SMCState(
        u=u0,
        log_like=_vmapped_jit(log_like_fn)(u0),
        log_prior=_vmapped_jit(log_prior_fn)(u0),
        beta=jnp.zeros((), dtype),
        log_z=jnp.zeros((), dtype),
        key=key,
        acc_rate=jnp.ones((), dtype),
    )

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        axis = mesh_axis or mesh.axis_names[0]
        if num_particles % mesh.devices.size != 0:
            raise ValueError(
                f"num_particles {num_particles} must be a multiple of mesh "
                f"size {mesh.devices.size}"
            )
        sh_part = NamedSharding(mesh, PartitionSpec(axis))
        sh_rep = NamedSharding(mesh, PartitionSpec())
        state_sh = SMCState(
            u=sh_part,
            log_like=sh_part,
            log_prior=sh_part,
            beta=sh_rep,
            log_z=sh_rep,
            key=sh_rep,
            acc_rate=sh_rep,
        )
        state = jax.device_put(state, state_sh)

    round_fn = _round_program(
        log_like_fn,
        log_prior_fn,
        log_like_b,
        float(ess_target),
        int(num_mutations),
        state_sh if mesh is not None else None,
    )

    n_rounds = 0
    betas = [0.0]
    while float(state.beta) < 1.0 and n_rounds < max_rounds:
        state = round_fn(state)
        n_rounds += 1
        betas.append(float(state.beta))
        if verbose:
            print(
                f"SMC round {n_rounds}: beta={float(state.beta):.4f} "
                f"acc={float(state.acc_rate):.2f} logZ={float(state.log_z):.2f}"
            )

    embed_jit = model.__dict__.get("_theta_of_u_jit")
    if embed_jit is None:
        embed_jit = jax.jit(jax.vmap(embed))
        model.__dict__["_theta_of_u_jit"] = embed_jit
    thetas = embed_jit(state.u)
    log_post = state.log_like + state.log_prior
    diagnostics = {
        "log_evidence": state.log_z,
        "num_rounds": n_rounds,
        "beta_schedule": betas,
        "final_accept_rate": state.acc_rate,
    }
    return SampleResult(
        u=state.u[None],
        thetas=thetas[None],
        log_prob=log_post[None],
        diagnostics=diagnostics,
    )
