"""Parallel-tempering (replica-exchange) HMC over GP hyperparameters.

Counterpart of the reference's ``emcee.PTSampler`` option
(``gptools/core.py :: sample_hyperparameter_posterior(sampler_type='pt',
ntemps=...)`` — SURVEY.md section 2.3). The reference ran an affine-invariant
ensemble at each rung of a temperature ladder, fanned over worker processes,
with in-process replica exchange. Here the ladder is a *leading array axis*:

- positions are ``(T, C, P)`` — ``T`` temperatures x ``C`` chains per rung —
  and one vmapped HMC transition advances every (rung, chain) lane in a single
  fused XLA program. Under pjit either axis shards over the device mesh
  (temperatures x chains is a natural 2-D mesh layout; swaps between adjacent
  rungs lower to collectives between neighbouring devices).
- each rung targets ``beta_t * log_like(u) + log_prior_u(u)`` (likelihood-only
  tempering, the PTSampler convention; the prior — including the bijector
  log-Jacobian — is kept cold so every rung stays normalizable).
- after every HMC sweep, adjacent rungs propose even/odd alternating swaps
  (the deterministic-even-odd scheme): pair ``(t, t+1)`` swaps a chain with
  probability ``min(1, exp((beta_t - beta_{t+1}) (ll_{t+1} - ll_t)))``.
  Even/odd alternation makes the pairs disjoint so the whole exchange is one
  branchless roll+where — no sequential sweep over rungs.
- step size adapts per rung by dual averaging POOLED across that rung's
  chains; the diagonal mass matrix adapts per rung from pooled Welford
  moments at slow-window boundaries (hot rungs see a flatter, wider target
  and genuinely need their own geometry).

The likelihood value needed for swap acceptances is recovered from the
tempered density as ``(logp_beta - log_prior_u) / beta`` — one extra *prior*
evaluation, which is trivially cheap next to the O(N^3) evidence Cholesky.

Like every sampler here, device work is chunked into short jitted scans
(see `gptools_tpu.infer.hmc.make_window_runner`: chunking reuses a handful
of compiled programs across all window lengths).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from gptools_tpu.infer import hmc
from gptools_tpu.infer.hmc import (
    DualAveragingState,
    SampleResult,
    WelfordState,
    da_init,
    da_update,
    warmup_schedule,
    welford_update_batch,
    welford_variance,
)

__all__ = ["sample", "geometric_ladder", "model_splits", "model_splits_batched", "tempered_logp_and_grad"]


def tempered_logp_and_grad(log_like_fn, log_prior_fn, beta):
    """value_and_grad of the rung-``beta`` target ``beta * log_like(u) +
    log_prior_u(u)`` with the reject-don't-crash guard (out-of-support prior
    short-circuits the likelihood to keep -inf finite-gradient-safe). Shared
    by `sample` and `gptools_tpu.parallel.mesh.pt_step_sharded`."""

    def f(q):
        lp = log_prior_fn(q)
        ll = jnp.where(jnp.isfinite(lp), log_like_fn(q), 0.0)
        return beta * ll + lp

    return jax.value_and_grad(f)


def model_splits(model, data):
    """Split the model's unconstrained-space density into
    ``(log_like_fn, log_prior_fn)`` — likelihood vs prior-plus-log-Jacobian —
    the decomposition likelihood tempering needs (shared with
    `gptools_tpu.parallel.mesh.pt_step_sharded`).

    The pair is cached per (model, data): downstream compiled-program caches
    (`smc._round_program`) key on these functions' identities, so handing out
    fresh closures per call would force a fresh XLA compile per SMC run. The
    cache entry holds ``data`` strongly, so the id key cannot be reused."""
    cache = model.__dict__.setdefault("_model_splits_cache", {})
    entry = cache.get(id(data))
    if entry is not None and entry[0] is data:
        return entry[1], entry[2]
    if len(cache) > 8:
        cache.clear()
    dtype = jnp.asarray(model.initial_params).dtype

    def log_like_fn(u):
        theta = model.theta_of_u(u)
        return model.log_marginal(theta, data)

    u0_full = model.bijector.inverse(
        jnp.asarray(model.initial_params, dtype=dtype)
    )
    free_idx = (
        jnp.asarray(model.free_idx)
        if model.num_free_params != model.num_params
        else None
    )

    def log_prior_fn(u_free):
        if free_idx is None:
            u_full = u_free
        else:
            u_full = u0_full.astype(u_free.dtype).at[free_idx].set(u_free)
        theta = model.bijector.forward(u_full)
        return model.log_prior(theta) + model.bijector.log_det_jac(u_full)

    cache[id(data)] = (data, log_like_fn, log_prior_fn)
    return log_like_fn, log_prior_fn


def model_splits_batched(model, data):
    """Batched (us (N, P) -> (N,)) u-space log-likelihood for the model, or
    None when the model/data has no chains-minor path.

    The SMC mutation sweep is a pure likelihood evaluation over the whole
    particle ensemble — exactly the shape the batched evidence
    (`GPModel.log_marginal_batch`) is built for; the vmapped scalar path
    recomputes the covariance per particle with generic autodiff assembly.
    Cached per (model, data) for the same program-identity reuse contract
    as `model_splits`.
    """
    # duck-typed: toy/test models without the GPModel batch machinery simply
    # keep the vmapped scalar path
    supported = getattr(model, "_batch_supported", None)
    if supported is None or not supported(data):
        return None
    cache = model.__dict__.setdefault("_model_splits_batched_cache", {})
    cache_key = id(data)
    entry = cache.get(cache_key)
    if entry is not None and entry[0] is data:
        return entry[1]
    if len(cache) > 8:
        cache.clear()

    def log_like_batched(us):
        thetas = jax.vmap(model.theta_of_u)(us)
        return model.log_marginal_batch(thetas, data)

    cache[cache_key] = (data, log_like_batched)
    return log_like_batched


def geometric_ladder(num_temps: int, beta_min: float = 0.1, dtype=jnp.float32):
    """Geometric inverse-temperature ladder ``beta_0=1 > ... > beta_{T-1} =
    beta_min`` (the standard spacing; emcee's default ladder is likewise
    geometric)."""
    if num_temps < 2:
        return jnp.ones((max(num_temps, 1),), dtype)
    t = jnp.arange(num_temps, dtype=dtype) / (num_temps - 1)
    return jnp.exp(t * jnp.log(jnp.asarray(beta_min, dtype)))


class _PTCarry(NamedTuple):
    u: jax.Array             # (T, C, P)
    da: DualAveragingState   # per-rung vectors, shapes (T,)
    welford: WelfordState    # per-rung: count (T,), mean/m2 (T, P)
    inv_mass: jax.Array      # (T, P)
    step: jax.Array          # scalar int32 (drives even/odd swap parity)
    key: jax.Array


def _swap_step(arrays, ll, betas, key, parity):
    """One even/odd replica-exchange sweep. ``arrays`` is a list of
    per-(rung, chain) state arrays ((T, C, ...)) permuted together with the
    (T, C) likelihood table. Disjoint adjacent pairs make the accepted
    permutation two rolls + a where — branchless, vmap/pjit friendly."""
    T, C = ll.shape
    pair = jnp.arange(T - 1)
    active = (pair % 2) == parity                                # (T-1,)
    log_acc = (betas[:-1] - betas[1:])[:, None] * (ll[1:] - ll[:-1])
    accept = (
        jnp.log(jax.random.uniform(key, (T - 1, C), ll.dtype)) < log_acc
    ) & active[:, None]                                          # (T-1, C)
    zero = jnp.zeros((1, C), bool)
    take_next = jnp.concatenate([accept, zero], axis=0)          # rung t <- t+1
    take_prev = jnp.concatenate([zero, accept], axis=0)          # rung t <- t-1

    def permute(x):
        up = jnp.roll(x, -1, axis=0)    # x[t+1] at slot t
        dn = jnp.roll(x, 1, axis=0)     # x[t-1] at slot t
        sel_next = take_next.reshape(take_next.shape + (1,) * (x.ndim - 2))
        sel_prev = take_prev.reshape(take_prev.shape + (1,) * (x.ndim - 2))
        return jnp.where(sel_next, up, jnp.where(sel_prev, dn, x))

    swap_frac = jnp.sum(accept, axis=1) / C                      # (T-1,)
    return [permute(x) for x in arrays], permute(ll), swap_frac


@functools.lru_cache(maxsize=128)
def _pt_chunk_program(
    log_like_fn: Callable,
    log_prior_fn: Callable,
    num_steps: int,
    target_accept: float,
    jitter: float,
    length: int,
    adapt_eps: bool,
    collect_welford: bool,
):
    """Jitted PT chunk (scan of HMC sweep + swap sweep) cached on the stable
    density-split identities (`model_splits`) + static config — the PT
    counterpart of `chees._build_programs`. The temperature ladder ``betas``
    is a runtime OPERAND (its length T is read from the operand's static
    shape), so repeated PT runs — and runs differing only in beta VALUES —
    reuse the compiled chunk."""

    def chunk_fn(carry: _PTCarry, betas: jax.Array):
        T = betas.shape[0]

        def one_sweep(carry: _PTCarry):
            key, k_hmc, k_swap = jax.random.split(carry.key, 3)
            C = carry.u.shape[1]
            eps = jnp.exp(
                carry.da.log_eps if adapt_eps else carry.da.log_eps_avg
            )

            def rung(q_rung, keys_rung, eps_t, inv_mass_t, beta_t):
                lg = tempered_logp_and_grad(log_like_fn, log_prior_fn, beta_t)
                return jax.vmap(
                    lambda q, k: hmc._hmc_transition(
                        lg, q, k, eps_t, inv_mass_t, num_steps, jitter
                    )
                )(q_rung, keys_rung)

            keys = jax.random.split(k_hmc, T * C).reshape(T, C, -1)
            u_new, logp_beta, stats = jax.vmap(rung)(
                carry.u, keys, eps, carry.inv_mass, betas
            )
            lp = jax.vmap(jax.vmap(log_prior_fn))(u_new)          # cheap
            ll_new = (logp_beta - lp) / betas[:, None]

            parity = carry.step % 2
            (u_new, lp), ll_new, swap_frac = _swap_step(
                [u_new, lp], ll_new, betas, k_swap, parity
            )

            pooled_accept = jnp.mean(stats["accept_prob"], axis=1)  # (T,)
            da_new = (
                da_update(carry.da, pooled_accept, target=target_accept)
                if adapt_eps
                else carry.da
            )
            welford = (
                jax.vmap(welford_update_batch)(carry.welford, u_new)
                if collect_welford
                else carry.welford
            )
            out = {
                "u_cold": u_new[0],
                "log_prob_cold": ll_new[0] + lp[0],  # beta_0=1: full posterior
                "accept_prob": stats["accept_prob"],  # (T, C)
                "diverged": stats["diverged"],
                "swap_frac": swap_frac,               # (T-1,)
                "eps": eps,
            }
            new_carry = _PTCarry(
                u_new, da_new, welford, carry.inv_mass, carry.step + 1, key
            )
            return new_carry, out

        return jax.lax.scan(
            lambda c, _: one_sweep(c), carry, None, length=length
        )

    return jax.jit(chunk_fn)


def _make_chunk_runner(
    log_like_fn: Callable,
    log_prior_fn: Callable,
    betas: jax.Array,
    num_steps: int,
    target_accept: float,
    jitter: float,
    chunk: int = 25,
):
    """Compile-cached chunked scan over PT sweeps (HMC sweep + swap sweep).
    Programs come from the GLOBAL `_pt_chunk_program` cache; ``betas`` is
    passed to each chunk as an operand."""

    def run(carry: _PTCarry, length: int, adapt_eps: bool, collect_welford: bool):
        parts = []
        remaining = length
        while remaining > 0:
            n = min(chunk, remaining)
            fn = _pt_chunk_program(
                log_like_fn, log_prior_fn, int(num_steps),
                float(target_accept), float(jitter), n,
                bool(adapt_eps), bool(collect_welford),
            )
            carry, outs = fn(carry, betas)
            parts.append(outs)
            remaining -= n
        if len(parts) > 1:
            outs = jax.tree_util.tree_map(
                lambda *xs: jnp.concatenate(xs, axis=0), *parts
            )
        else:
            outs = parts[0]
        return carry, outs

    return run


def sample(
    model,
    data,
    key,
    num_chains: int = 8,
    num_samples: int = 1000,
    num_warmup: int = 500,
    num_temps: int = 8,
    beta_min: float = 0.1,
    num_steps: int = 32,
    target_accept: float = 0.8,
    eps0: float = 0.1,
    jitter: float = 0.2,
    adapt_mass: bool = True,
    init: str = "prior",
    metrics=None,
) -> SampleResult:
    """Replica-exchange HMC posterior sampling. Returns the cold (beta=1)
    rung as a `SampleResult`; hot rungs exist to ferry chains across
    posterior modes.

    ``num_temps`` plays the reference's ``ntemps`` role; total device work per
    sweep is ``num_temps * num_chains`` evidence evaluations, all in one
    vmapped program.
    """
    from gptools_tpu.infer import _initial_positions  # circular-safe

    dtype = jnp.asarray(model.initial_params).dtype
    betas = geometric_ladder(num_temps, beta_min, dtype)
    T = betas.shape[0]
    P = model.num_free_params

    log_like_fn, log_prior_fn = model_splits(model, data)

    key, k_init = jax.random.split(
        jax.random.PRNGKey(key) if isinstance(key, int) else key
    )
    u_init = _initial_positions(model, k_init, T * num_chains, init)
    u = u_init.reshape(T, num_chains, P).astype(dtype)

    def fresh_welford():
        return WelfordState(
            jnp.zeros((T,), dtype),
            jnp.zeros((T, P), dtype),
            jnp.zeros((T, P), dtype),
        )

    carry = _PTCarry(
        u=u,
        da=da_init(jnp.full((T,), eps0, dtype)),
        welford=fresh_welford(),
        inv_mass=jnp.ones((T, P), dtype),
        step=jnp.zeros((), jnp.int32),
        key=key,
    )

    runner = _make_chunk_runner(
        log_like_fn, log_prior_fn, betas, num_steps, target_accept, jitter
    )

    div_warmup = jnp.zeros((), jnp.int32)
    swap_accum = []
    for phase, length in warmup_schedule(num_warmup):
        collect = (phase == "slow") and adapt_mass
        carry, outs = runner(carry, length, True, collect)
        div_warmup = div_warmup + jnp.sum(outs["diverged"]).astype(jnp.int32)
        swap_accum.append(outs["swap_frac"])
        if metrics is not None:
            metrics.log_window(f"pt-{phase}", length, outs)
        if collect:
            # close the slow window: adopt pooled variance as the per-rung
            # mass, reset moments, restart dual averaging (Stan's recipe)
            inv_mass = jax.vmap(welford_variance)(carry.welford).astype(dtype)
            carry = carry._replace(
                inv_mass=inv_mass,
                welford=fresh_welford(),
                da=da_init(jnp.exp(carry.da.log_eps_avg)),
            )

    # frozen adaptation; collect the cold rung
    eps_final = jnp.exp(carry.da.log_eps_avg)
    carry = carry._replace(da=carry.da._replace(log_eps=jnp.log(eps_final)))
    carry, outs = runner(carry, num_samples, False, False)
    if metrics is not None:
        metrics.log_window("pt-sampling", num_samples, outs)

    u_cold = jnp.swapaxes(outs["u_cold"], 0, 1)          # (C, S, P)
    log_prob = jnp.swapaxes(outs["log_prob_cold"], 0, 1)
    # each pair is active every other sweep, so the conditional swap rate is
    # twice the raw mean over sweeps
    swap_accept = (
        jnp.mean(
            jnp.concatenate(swap_accum + [outs["swap_frac"]], axis=0), axis=0
        )
        * 2.0
    )
    diagnostics = {
        "step_size": eps_final,                           # (T,)
        "betas": betas,
        "swap_accept": swap_accept,                       # (T-1,)
        "accept_prob": jnp.swapaxes(outs["accept_prob"][:, 0, :], 0, 1),
        "divergences": jnp.sum(outs["diverged"]).astype(jnp.int32),
        "divergences_warmup": div_warmup,
        "mean_accept": jnp.mean(outs["accept_prob"]),
    }
    from gptools_tpu.infer import _attach_thetas  # circular-safe

    return _attach_thetas(
        model,
        SampleResult(
            u=u_cold, thetas=None, log_prob=log_prob, diagnostics=diagnostics
        ),
    )
