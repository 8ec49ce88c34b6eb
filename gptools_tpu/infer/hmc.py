"""Vectorized HMC with Stan-style windowed warmup, pooled across chains.

Replaces the reference's emcee ensemble sampling
(``gptools/core.py :: sample_hyperparameter_posterior``): instead of N
affine-invariant walkers coupled in-process and fanned over worker processes,
N *independent* gradient-based chains run under ``vmap`` in one fused XLA
program, with adaptation statistics POOLED across the chain axis:

- step size: one shared dual-averaging iterate driven by the cross-chain mean
  acceptance statistic (a ``jnp.mean`` over the chains axis — under pjit with
  chains sharded over the mesh this lowers to a ``psum``, which is exactly
  the north-star's "collective step-size adaptation");
- diagonal mass matrix: Welford moments pooled over chains x window samples.

This module provides the building blocks shared with NUTS
(`gptools_tpu.infer.nuts`): leapfrog, dual averaging, Welford, the warmup
window schedule, and the scan/vmap sampling driver.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

__all__ = [
    "SampleResult",
    "DualAveragingState",
    "WelfordState",
    "leapfrog",
    "sample",
    "warmup_schedule",
    "run_window",
    "make_window_runner",
]


class SampleResult(NamedTuple):
    """Posterior sample container (all samplers return this)."""

    u: jax.Array                      # (chains, samples, P) unconstrained
    thetas: Optional[jax.Array]       # (chains, samples, P) constrained
    log_prob: jax.Array               # (chains, samples)
    diagnostics: dict                 # step size, divergences, accept, ...

    @property
    def num_chains(self):
        return self.u.shape[0]

    @property
    def num_samples(self):
        return self.u.shape[1]


class DualAveragingState(NamedTuple):
    """Nesterov dual averaging for log step size (Hoffman & Gelman 2014)."""

    log_eps: jax.Array
    log_eps_avg: jax.Array
    h_sum: jax.Array
    mu: jax.Array
    t: jax.Array


def da_init(eps0: jax.Array) -> DualAveragingState:
    log_eps = jnp.log(eps0)
    return DualAveragingState(
        log_eps=log_eps,
        # seed the average at eps0 so a zero-warmup run samples at eps0
        # rather than exp(0)=1; the first da_update has weight w = t^-kappa
        # = 1 and replaces this entirely, so adaptation is unaffected.
        log_eps_avg=log_eps,
        h_sum=jnp.zeros_like(log_eps),
        mu=jnp.log(10.0) + log_eps,
        t=jnp.zeros_like(log_eps),
    )


def da_update(
    state: DualAveragingState,
    accept_prob: jax.Array,
    target: float = 0.8,
    gamma: float = 0.05,
    t0: float = 10.0,
    kappa: float = 0.75,
) -> DualAveragingState:
    t = state.t + 1.0
    h_sum = state.h_sum + (target - accept_prob)
    log_eps = state.mu - jnp.sqrt(t) / gamma * h_sum / (t + t0)
    w = t ** (-kappa)
    log_eps_avg = w * log_eps + (1.0 - w) * state.log_eps_avg
    return DualAveragingState(log_eps, log_eps_avg, h_sum, state.mu, t)


class WelfordState(NamedTuple):
    """Pooled running mean/variance for diagonal mass adaptation."""

    count: jax.Array
    mean: jax.Array
    m2: jax.Array


def welford_init(dim: int, dtype=jnp.float32) -> WelfordState:
    return WelfordState(
        count=jnp.zeros((), dtype),
        mean=jnp.zeros((dim,), dtype),
        m2=jnp.zeros((dim,), dtype),
    )


def welford_update_batch(state: WelfordState, xs: jax.Array) -> WelfordState:
    """Fold a (batch, dim) matrix of draws into the pooled moments
    (chunk-parallel Welford / Chan et al. update)."""
    nb = jnp.asarray(xs.shape[0], state.count.dtype)
    mb = jnp.mean(xs, axis=0)
    m2b = jnp.sum((xs - mb) ** 2, axis=0)
    delta = mb - state.mean
    tot = state.count + nb
    mean = state.mean + delta * nb / tot
    m2 = state.m2 + m2b + delta**2 * state.count * nb / tot
    return WelfordState(tot, mean, m2)


def welford_variance(state: WelfordState, regularize: bool = True) -> jax.Array:
    var = state.m2 / jnp.maximum(state.count - 1.0, 1.0)
    if regularize:
        # Stan's shrinkage toward unit scale for small counts
        n = state.count
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return var


def leapfrog(
    value_and_grad_fn: Callable, q, p, eps, inv_mass, grad=None
):
    """One leapfrog step of H = -logp(q) + 1/2 p^T M^-1 p. Returns
    (q', p', logp', grad'). Pass the cached ``grad`` at ``q`` to spend
    exactly one gradient evaluation per step."""
    if grad is None:
        _, grad = value_and_grad_fn(q)
    p_half = p + 0.5 * eps * grad
    q_new = q + eps * inv_mass * p_half
    v_new, g_new = value_and_grad_fn(q_new)
    p_new = p_half + 0.5 * eps * g_new
    return q_new, p_new, v_new, g_new


def kinetic(p, inv_mass):
    return 0.5 * jnp.sum(p * p * inv_mass)


def _hmc_transition(
    logp_and_grad: Callable,
    q: jax.Array,
    key: jax.Array,
    eps: jax.Array,
    inv_mass: jax.Array,
    num_steps: int,
    jitter: float = 0.2,
):
    """One fixed-length HMC proposal for a single chain (vmapped by caller)."""
    k_mom, k_acc, k_jit = jax.random.split(key, 3)
    p0 = jax.random.normal(k_mom, q.shape, q.dtype) / jnp.sqrt(inv_mass)
    logp0, g0 = logp_and_grad(q)
    h0 = -logp0 + kinetic(p0, inv_mass)
    # jittered step size decorrelates fixed trajectory lengths
    eps_c = eps * (1.0 + jitter * (2.0 * jax.random.uniform(k_jit) - 1.0))

    def body(_, carry):
        qc, pc, _, gc = carry
        return leapfrog(logp_and_grad, qc, pc, eps_c, inv_mass, grad=gc)

    qn, pn, logpn, _ = jax.lax.fori_loop(
        0, num_steps, body, (q, p0, logp0, g0)
    )
    h1 = -logpn + kinetic(pn, inv_mass)
    log_accept = jnp.minimum(0.0, h0 - h1)
    log_accept = jnp.where(jnp.isnan(log_accept), -jnp.inf, log_accept)
    accept = jnp.log(jax.random.uniform(k_acc)) < log_accept
    q_out = jnp.where(accept, qn, q)
    logp_out = jnp.where(accept, logpn, logp0)
    stats = {
        "accept_prob": jnp.exp(log_accept),
        "diverged": (h1 - h0) > 1000.0,
        "num_leapfrog": jnp.asarray(num_steps, jnp.int32),
    }
    return q_out, logp_out, stats


def warmup_schedule(num_warmup: int, init_buffer=75, term_buffer=50, base_window=25):
    """Stan's three-phase warmup: fast start (step size only), doubling slow
    windows (mass matrix), fast tail. Returns a list of (phase, length),
    phase in {'fast', 'slow'}."""
    if num_warmup <= 20:
        return [("fast", num_warmup)] if num_warmup else []
    if init_buffer + term_buffer + base_window > num_warmup:
        init_buffer = max(num_warmup // 4, 1)
        term_buffer = max(num_warmup // 10, 1)
        base_window = num_warmup - init_buffer - term_buffer
    out = [("fast", init_buffer)]
    remaining = num_warmup - init_buffer - term_buffer
    w = base_window
    while remaining > 0:
        if remaining < 2 * w or remaining - w < base_window:
            out.append(("slow", remaining))
            remaining = 0
        else:
            out.append(("slow", w))
            remaining -= w
            w *= 2
    out.append(("fast", term_buffer))
    return out


def _window_scan(
    transition_of_params: Callable,
    target_accept: float,
    adapt_eps: bool,
    collect_welford: bool,
    length: int,
):
    """The ONE window scan body shared by `run_window` and
    `make_window_runner` (they previously held near-identical copies).
    Returns
    ``fn(qs, key, da, welford, inv_mass, params) ->
    ((qs, da, welford, key), outs)``.

    ``transition_of_params(params) -> transition`` binds the density's extra
    operand pytree (e.g. whitening moments) INSIDE the traced program, so
    run-specific values never become closure constants (the compiled-program
    reuse contract, see `chees._build_programs`).
    """

    def window_fn(qs, key, da, welford, inv_mass, params):
        transition = transition_of_params(params)

        def step(carry, _):
            qs, da, welford, key = carry
            key, sub = jax.random.split(key)
            ckeys = jax.random.split(sub, qs.shape[0])
            eps = jnp.exp(da.log_eps if adapt_eps else da.log_eps_avg)
            q_new, logp, stats = jax.vmap(
                lambda q, k: transition(q, k, eps, inv_mass)
            )(qs, ckeys)
            # POOLED statistic: mean over the chains axis -> psum when sharded
            pooled_accept = jnp.mean(stats["accept_prob"])
            if adapt_eps:
                da_new = da_update(da, pooled_accept, target=target_accept)
            else:
                da_new = da
            if collect_welford:
                welford = welford_update_batch(welford, q_new)
            out = {
                "u": q_new,
                "log_prob": logp,
                "accept_prob": stats["accept_prob"],
                "diverged": stats["diverged"],
                "num_leapfrog": stats["num_leapfrog"],
                "eps": eps,
            }
            return (q_new, da_new, welford, key), out

        return jax.lax.scan(step, (qs, da, welford, key), None, length=length)

    return window_fn


def run_window(
    transition: Callable,
    qs: jax.Array,
    key: jax.Array,
    length: int,
    da: DualAveragingState,
    inv_mass: jax.Array,
    adapt_eps: bool = True,
    collect_welford: bool = False,
    welford: Optional[WelfordState] = None,
    target_accept: float = 0.8,
):
    """Scan ``length`` iterations of ``vmap(transition)`` over all chains,
    with pooled step-size adaptation (and optionally pooled Welford moments),
    as ONE un-chunked device program (use `make_window_runner` for the
    chunked production path).

    transition(q, key, eps, inv_mass) -> (q_new, logp, stats)
    """
    if welford is None:
        welford = welford_init(qs.shape[1], qs.dtype)
    fn = _window_scan(
        lambda params: transition, target_accept, adapt_eps, collect_welford,
        length,
    )
    (qs, da, welford, _), outs = fn(qs, key, da, welford, inv_mass, ())
    return qs, da, welford, outs


def _make_transition(logp_and_grad: Callable, spec: tuple) -> Callable:
    """Build a per-chain transition kernel from a HASHABLE spec:
    ``("hmc", num_steps, jitter)`` or ``("nuts", max_depth, div_threshold)``.
    The spec (not a closure) is what the compiled-program cache keys on."""
    kind = spec[0]
    if kind == "hmc":
        _, num_steps, jitter = spec

        def transition(q, k, eps, inv_mass):
            return _hmc_transition(
                logp_and_grad, q, k, eps, inv_mass, num_steps, jitter
            )

        return transition
    if kind == "nuts":
        from gptools_tpu.infer import nuts as _nuts

        _, max_depth, div_threshold = spec
        return _nuts.nuts_transition_builder(max_depth, div_threshold)(
            logp_and_grad
        )
    raise ValueError(f"unknown transition spec {spec!r}")


@functools.lru_cache(maxsize=128)
def _window_program(
    logp: Callable,
    takes_params: bool,
    spec: tuple,
    target_accept: float,
    adapt_eps: bool,
    collect_welford: bool,
    length: int,
):
    """Jitted window program cached on the DENSITY FUNCTION'S IDENTITY plus
    the hashable transition spec and static window config — the HMC/NUTS
    counterpart of `chees._build_programs`: repeated `sample` calls over the
    same (model, data) reuse the compiled windows instead of recompiling.
    Run-specific values (mass matrix, step-size state, whitening params)
    are runtime operands."""
    if takes_params:
        fn = logp
    else:
        def fn(q, params):
            del params
            return logp(q)

    def transition_of_params(params):
        return _make_transition(
            jax.value_and_grad(lambda q: fn(q, params)), spec
        )

    return jax.jit(
        _window_scan(
            transition_of_params, target_accept, adapt_eps, collect_welford,
            length,
        )
    )


def make_window_runner(
    transition: Optional[Callable] = None,
    target_accept: float = 0.8,
    chunk: int = 25,
    logp: Optional[Callable] = None,
    takes_params: bool = False,
    spec: Optional[tuple] = None,
):
    """Chunked, compile-cached window runner.

    Executes windows of any length as repeated short jitted scans of
    ``chunk`` iterations (plus one remainder program per distinct remainder
    length), so EVERY window of every length reuses at most a handful of
    compiled programs instead of one per window length.

    Two modes:
    - ``logp`` + ``spec`` (preferred): programs come from the GLOBAL
      `_window_program` cache, so repeated sampler invocations over the same
      density reuse compiled windows across calls;
    - ``transition`` (legacy): a prebuilt per-chain kernel; programs are
      cached only within this runner instance.
    """
    cache = {}

    def get_chunk_fn(length: int, adapt_eps: bool, collect_welford: bool):
        if logp is not None and spec is not None:
            return _window_program(
                logp, takes_params, spec, float(target_accept),
                adapt_eps, collect_welford, length,
            )
        key_ = (length, adapt_eps, collect_welford)
        if key_ not in cache:
            cache[key_] = jax.jit(
                _window_scan(
                    lambda params: transition, target_accept, adapt_eps,
                    collect_welford, length,
                )
            )
        return cache[key_]

    def run(qs, key, length, da, inv_mass, adapt_eps, collect_welford,
            welford, params=()):
        if welford is None:
            welford = welford_init(qs.shape[1], qs.dtype)
        outs_parts = []
        remaining = length
        while remaining > 0:
            n = min(chunk, remaining)
            key, sub = jax.random.split(key)
            fn = get_chunk_fn(n, adapt_eps, collect_welford)
            (qs, da, welford, _), outs = fn(
                qs, sub, da, welford, inv_mass, params
            )
            outs_parts.append(outs)
            remaining -= n
        if len(outs_parts) > 1:
            outs_all = jax.tree_util.tree_map(
                lambda *xs: jnp.concatenate(xs, axis=0), *outs_parts
            )
        else:
            outs_all = outs_parts[0]
        return qs, da, welford, outs_all

    return run


def sample(
    logp: Callable,
    u0: jax.Array,
    key: jax.Array,
    num_warmup: int = 500,
    num_samples: int = 1000,
    num_steps: int = 32,
    target_accept: float = 0.8,
    eps0: float = 0.1,
    adapt_mass: bool = True,
    inv_mass0=None,
    jitter: float = 0.2,
    transition_builder: Optional[Callable] = None,
    transition_spec: Optional[tuple] = None,
    logp_params=None,
    metrics=None,
) -> SampleResult:
    """Warmup + sampling driver for fixed-length HMC (and, via
    ``transition_spec=("nuts", max_depth, div_threshold)``, NUTS).
    ``u0``: (chains, P) initial positions.

    ``logp_params``: optional pytree passed to the density as a second
    argument (``logp(q, params)``); run-specific values travel here so the
    compiled window programs (`_window_program`) are reused across calls.
    ``transition_builder`` (legacy): a prebuilt kernel factory; bypasses the
    global program cache.
    """
    u0 = jnp.atleast_2d(u0)
    C, P = u0.shape
    dtype = u0.dtype
    takes_params = logp_params is not None
    params = logp_params if takes_params else ()

    if transition_builder is not None:
        if takes_params:
            raise ValueError(
                "logp_params requires transition_spec, not transition_builder"
            )
        transition = transition_builder(jax.value_and_grad(logp))
        runner = make_window_runner(transition, target_accept=target_accept)
    else:
        spec = (
            transition_spec
            if transition_spec is not None
            else ("hmc", int(num_steps), float(jitter))
        )
        runner = make_window_runner(
            target_accept=target_accept,
            logp=logp,
            takes_params=takes_params,
            spec=spec,
        )

    if inv_mass0 is None:
        inv_mass = jnp.ones((P,), dtype)
    else:
        inv_mass = jnp.asarray(inv_mass0, dtype)
    da = da_init(jnp.asarray(eps0, dtype))
    welford = welford_init(P, dtype)
    qs = u0.astype(dtype)

    key, k0 = jax.random.split(key)

    schedule = warmup_schedule(num_warmup)
    div_warmup = jnp.zeros((), jnp.int32)
    for phase, length in schedule:
        key, sub = jax.random.split(key)
        qs, da, welford, outs = runner(
            qs,
            sub,
            length,
            da,
            inv_mass,
            True,
            (phase == "slow") and adapt_mass,
            welford,
            params=params,
        )
        div_warmup = div_warmup + jnp.sum(outs["diverged"]).astype(jnp.int32)
        if metrics is not None:
            metrics.log_window(phase, length, outs)
        if phase == "slow" and adapt_mass:
            inv_mass = welford_variance(welford).astype(dtype)
            welford = welford_init(P, dtype)
            # restart dual averaging around the current step size (Stan)
            da = da_init(jnp.exp(da.log_eps_avg))

    # frozen-adaptation sampling phase
    eps_final = jnp.exp(da.log_eps_avg)
    da_sampling = da._replace(log_eps=jnp.log(eps_final))
    key, sub = jax.random.split(key)
    qs, _, _, outs = runner(
        qs, sub, num_samples, da_sampling, inv_mass, False, False, None,
        params=params,
    )

    if metrics is not None:
        metrics.log_window("sampling", num_samples, outs)
    u = jnp.swapaxes(outs["u"], 0, 1)            # (C, S, P)
    log_prob = jnp.swapaxes(outs["log_prob"], 0, 1)
    diagnostics = {
        "step_size": eps_final,
        "inv_mass": inv_mass,
        "accept_prob": jnp.swapaxes(outs["accept_prob"], 0, 1),
        "divergences": jnp.sum(outs["diverged"]).astype(jnp.int32),
        "divergences_warmup": div_warmup,
        "num_leapfrog_total": jnp.sum(outs["num_leapfrog"]),
        "mean_accept": jnp.mean(outs["accept_prob"]),
    }
    return SampleResult(u=u, thetas=None, log_prob=log_prob, diagnostics=diagnostics)
