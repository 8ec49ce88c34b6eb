"""ChEES-HMC: jittered fixed-length HMC with cross-chain adaptive trajectory
length (Hoffman, Radul & Sountsov, AISTATS 2021).

Why it is THE accelerator-native sampler for this engine: NUTS builds a
different-size trajectory per chain, so under ``vmap`` every chain pays for
the deepest tree in the batch (masked lanes). ChEES instead runs the SAME
number of leapfrog steps for every chain each iteration — perfect
vectorization, zero wasted lanes — and adapts that shared trajectory length
from CROSS-CHAIN statistics, which fits this library's pooled-collective
design exactly (the adaptation reductions become psums over the mesh).

Algorithm per iteration t:
  - halton jitter: L_t = max(1, ceil(h_t * tau / eps)), h_t in (0, 1];
  - all chains leapfrog L_t steps, Metropolis accept;
  - ChEES criterion gradient for tau: with centered proposal dq' = q' - mean(q')
    and end velocity v', per-chain estimate
        g = (||dq'||^2 - ||dq||^2) * (dq' . v')
    weighted by the acceptance probability, pooled over chains, fed to Adam
    on log tau;
  - step size adapts by pooled dual averaging as elsewhere.

Used by `sample` (standalone warmup) and by
`gptools_tpu.infer.pipeline.smc_then_chees` (SMC warm start).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from gptools_tpu.infer import hmc as _hmc
from gptools_tpu.infer.hmc import SampleResult

__all__ = ["sample", "chees_step"]


def _halton(i: jax.Array, base: int = 2) -> jax.Array:
    """Radical-inverse halton sequence element in (0, 1), jit-safe."""
    # 16 bits is plenty for jitter purposes
    def body(k, carry):
        val, inv, idx = carry
        inv = inv / base
        digit = idx % base
        return (val + digit.astype(jnp.float32) * inv, inv, idx // base)

    val, _, _ = jax.lax.fori_loop(
        0, 16, body, (jnp.float32(0.0), jnp.float32(1.0), i + 1)
    )
    return val


class CheesState(NamedTuple):
    qs: jax.Array          # (C, P) positions
    logps: jax.Array       # (C,)
    grads: jax.Array       # (C, P)
    da: _hmc.DualAveragingState
    log_tau: jax.Array     # shared trajectory TIME (log)
    adam_m: jax.Array
    adam_v: jax.Array
    iteration: jax.Array
    key: jax.Array


def chees_step(
    logp_and_grad: Callable,
    state: CheesState,
    inv_mass: jax.Array,
    target_accept: float = 0.75,
    adapt: bool = True,
    adam_lr: float = 0.025,
    max_steps: int = 1024,
    cost_normalize: bool = False,
    cost_elasticity=1.0,
):
    """One vectorized ChEES-HMC iteration over all chains.

    ``logp_and_grad`` is BATCHED: (C, P) -> ((C,), (C, P)). The leapfrog
    update is layout-agnostic elementwise math, so a chains-minor evidence
    implementation (``GPModel.log_posterior_u_batch``) plugs in directly —
    `sample` wraps a per-chain logp in vmap when no batched one is given.
    """
    C, P = state.qs.shape
    dtype = state.qs.dtype
    key, k_mom, k_acc = jax.random.split(state.key, 3)

    # `adapt` may be a Python bool (two specializations) or a traced 0/1
    # scalar (ONE compiled program serves warmup and sampling — halves the
    # pipeline's dominant compile cost, see BASELINE.md r3 profile)
    adapt_t = jnp.asarray(adapt)
    eps = jnp.exp(
        jnp.where(adapt_t, state.da.log_eps, state.da.log_eps_avg)
    )
    tau = jnp.exp(state.log_tau)
    h = _halton(state.iteration).astype(dtype)
    L = jnp.clip(
        jnp.ceil(h * tau / eps).astype(jnp.int32), 1, max_steps
    )

    p0 = jax.random.normal(k_mom, (C, P), dtype) / jnp.sqrt(inv_mass)

    # same L for every chain -> one while loop, no masked lanes; leapfrog is
    # elementwise over (C, P) given the batched gradient
    def loop_body(i, carry):
        q, p, logp, g = carry
        return _hmc.leapfrog(logp_and_grad, q, p, eps, inv_mass, grad=g)

    qn, pn, logpn, gn = jax.lax.fori_loop(
        0, L, loop_body, (state.qs, p0, state.logps, state.grads)
    )

    kin = lambda p_: 0.5 * jnp.sum(p_ * p_ * inv_mass, axis=-1)
    h0 = -state.logps + kin(p0)
    h1 = -logpn + kin(pn)
    log_accept = jnp.minimum(0.0, h0 - h1)
    log_accept = jnp.where(jnp.isnan(log_accept), -jnp.inf, log_accept)
    accept_prob = jnp.exp(log_accept)
    accept = jnp.log(jax.random.uniform(k_acc, (C,), dtype)) < log_accept

    q_out = jnp.where(accept[:, None], qn, state.qs)
    logp_out = jnp.where(accept, logpn, state.logps)
    g_out = jnp.where(accept[:, None], gn, state.grads)

    # --- ChEES trajectory-length adaptation (pooled across chains) ---
    # diverged chains produce NaN endpoints; mask them out of every pooled
    # statistic or the adaptation (and then tau) is silently poisoned
    finite = jnp.all(jnp.isfinite(qn), axis=1) & jnp.isfinite(accept_prob)
    qn_safe = jnp.where(finite[:, None], qn, 0.0)
    n_fin = jnp.maximum(jnp.sum(finite.astype(dtype)), 1.0)
    mean_q = jnp.mean(state.qs, axis=0)    # psum-style cross-chain means
    mean_qn = jnp.sum(qn_safe, axis=0) / n_fin
    dq0 = state.qs - mean_q
    dq1 = qn_safe - mean_qn
    vel = jnp.where(finite[:, None], pn * inv_mass, 0.0)
    dsq = jnp.sum(dq1 * dq1, axis=1) - jnp.sum(dq0 * dq0, axis=1)
    per_chain = dsq * jnp.sum(dq1 * vel, axis=1)
    w = jnp.where(finite, accept_prob, 0.0)
    grad_tau = jnp.sum(w * per_chain) / jnp.maximum(jnp.sum(w), 1e-6)
    grad_tau = jnp.where(jnp.isfinite(grad_tau), grad_tau, 0.0)

    if cost_normalize:
        # Maximize the ChEES criterion PER UNIT INTEGRATION TIME instead of
        # per iteration. Plain ChEES lengthens trajectories until the
        # criterion C(t) = E[(||dq'||^2 - ||dq||^2)^2] stops improving —
        # but each unit of t costs leapfrogs (gradient evaluations)
        # linearly, so on accelerators where the gradient IS the wall-clock
        # the right objective is log C - log t, whose d/dlog tau is the
        # criterion's ELASTICITY minus one:
        #     d log(C/t) / d log t = t * C'/C - 1.
        # Equilibrium at elasticity 1 = the point of diminishing returns
        # per leapfrog. Measured on the flagship posterior (BASELINE.md r3
        # tau sweep): plain ChEES converges to tau ~ 10 at 8.7k ESS/s while
        # tau ~ 2.5-3.3 yields 19-20k ESS/s at the same R-hat gates; this
        # scheme finds the short-tau optimum automatically.
        # Using d(D^2)/dt = 4 * per_chain (D = ||dq'||^2 - ||dq||^2) and the
        # REALIZED integration time t = L * eps (halton-jittered):
        # ``cost_elasticity`` is the equilibrium target (a runtime scalar so
        # one compiled program serves any value): 1.0 is the exact C/t
        # stationary point; the production default is CALIBRATED on hardware
        # (BASELINE.md r3 elasticity sweep) because the ChEES criterion is a
        # proxy for ESS — its elasticity-1 point sits slightly below the
        # measured ESS-per-leapfrog optimum on the flagship posterior.
        crit = jnp.sum(w * dsq * dsq) / jnp.maximum(jnp.sum(w), 1e-6)
        t_real = L.astype(dtype) * eps
        elasticity = t_real * 4.0 * grad_tau / jnp.maximum(crit, 1e-12)
        grad_tau = jnp.clip(elasticity - cost_elasticity, -10.0, 10.0)
        grad_tau = jnp.where(jnp.isfinite(grad_tau), grad_tau, 0.0)

    def adam_update(log_tau, m, v, g, t):
        b1, b2, eps_ = 0.9, 0.999, 1e-8
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / (1 - b1 ** (t + 1))
        vh = v / (1 - b2 ** (t + 1))
        return log_tau + adam_lr * mh / (jnp.sqrt(vh) + eps_), m, v

    t_f = state.iteration.astype(dtype)
    norm_g = grad_tau / (jnp.abs(grad_tau) + 1e-12) * jnp.minimum(
        jnp.abs(grad_tau), 1e3
    )  # clip exploding estimates
    # compute the adaptation updates unconditionally and mask by `adapt`
    # (cheap scalar math; keeps warmup and sampling in one compiled program)
    log_tau_upd, m_upd, v_upd = adam_update(
        state.log_tau, state.adam_m, state.adam_v, norm_g, t_f
    )
    # keep tau within sane STATIC bounds. An earlier revision clipped to
    # [log eps, log(eps*max_steps)] with the CURRENT (still-adapting) eps:
    # a transient dual-averaging overshoot of eps then permanently RATCHETED
    # tau upward through the lower clip (observed at the bench shapes:
    # tau0=2.0 with adam_lr=0 ended at tau=3.45 = the warmup eps peak;
    # BASELINE.md r3). Static bounds avoid that; the realized cost is
    # already capped by L <= max_steps, and tau < eps just means L = 1.
    log_tau_upd = jnp.clip(log_tau_upd, jnp.log(1e-3), jnp.log(1e4))
    da_upd = _hmc.da_update(
        state.da, jnp.mean(accept_prob), target=target_accept
    )
    sel = lambda a, b: jnp.where(adapt_t, a, b)
    log_tau_new = sel(log_tau_upd, state.log_tau)
    m_new = sel(m_upd, state.adam_m)
    v_new = sel(v_upd, state.adam_v)
    da_new = jax.tree_util.tree_map(sel, da_upd, state.da)

    new_state = CheesState(
        qs=q_out,
        logps=logp_out,
        grads=g_out,
        da=da_new,
        log_tau=log_tau_new,
        adam_m=m_new,
        adam_v=v_new,
        iteration=state.iteration + 1,
        key=key,
    )
    stats = {
        "accept_prob": accept_prob,
        "diverged": (h1 - h0) > 1000.0,
        "num_leapfrog": L * jnp.ones((C,), jnp.int32),
        "eps": eps,
        "tau": jnp.exp(state.log_tau),
    }
    return new_state, (q_out, logp_out, stats)


@functools.lru_cache(maxsize=32)
def _build_programs(
    user_fn: Callable,
    batched: bool,
    takes_params: bool,
    target_accept: float,
    max_steps: int,
    chunk: int,
    adam_lr: float,
    cost_normalize: bool,
):
    """Jitted ``(init_fn, chunk_fn)`` programs for `sample`, cached on the
    DENSITY FUNCTION'S IDENTITY plus the static sampler config.

    This cache is the difference between paying the dominant XLA compile
    cost once per (model, data) and paying it on EVERY pipeline invocation:
    everything that varies between runs — whitening moments, mass matrix,
    initial step size / trajectory time, seeds, positions — enters the
    programs as runtime OPERANDS, never as closed-over constants, so a
    repeated fit (bench repeats, refits in a scan over datasets) reuses the
    compiled executables. Callers must therefore hand `sample` STABLE
    function objects (see ``gptools_tpu.infer.pipeline._stable_fns``); a
    fresh lambda per call silently falls back to one compile per call.

    ``takes_params``: the density takes an extra pytree operand,
    ``fn(q, params)``; otherwise ``fn(q)`` and params is an empty tuple.
    """
    if takes_params:
        fn = user_fn
    else:
        def fn(q, params):
            del params
            return user_fn(q)

    if batched:

        def logp_and_grad(qs, params):
            lls, pull = jax.vjp(lambda q: fn(q, params), qs)
            (g,) = pull(jnp.ones_like(lls))
            return lls, g

    else:

        def logp_and_grad(qs, params):
            return jax.vmap(jax.value_and_grad(lambda q: fn(q, params)))(qs)

    @jax.jit
    def init_fn(u0, params, key, eps0, tau0):
        dtype = u0.dtype
        logps, grads = logp_and_grad(u0, params)
        return CheesState(
            qs=u0,
            logps=logps,
            grads=grads,
            da=_hmc.da_init(eps0.astype(dtype)),
            log_tau=jnp.log(tau0.astype(dtype)),
            adam_m=jnp.zeros((), dtype),
            adam_v=jnp.zeros((), dtype),
            iteration=jnp.zeros((), jnp.int32),
            key=key,
        )

    @jax.jit
    def chunk_fn(state, params, inv_mass, adapt, cost_target):
        def body(s, _):
            s, (q, lp, stats) = chees_step(
                lambda qs: logp_and_grad(qs, params),
                s,
                inv_mass,
                target_accept=target_accept,
                adapt=adapt,
                adam_lr=adam_lr,
                max_steps=max_steps,
                cost_normalize=cost_normalize,
                cost_elasticity=cost_target,
            )
            return s, (q, lp, stats["diverged"], stats["accept_prob"],
                       stats["num_leapfrog"])

        return jax.lax.scan(body, state, None, length=chunk)

    return init_fn, chunk_fn


def sample(
    logp: Callable,
    u0: jax.Array,
    key: jax.Array,
    num_warmup: int = 300,
    num_samples: int = 500,
    target_accept: float = 0.75,
    eps0: float = 0.1,
    tau0: Optional[float] = None,
    inv_mass0=None,
    max_steps: int = 1024,
    chunk: int = 25,
    logp_batched: Optional[Callable] = None,
    logp_params=None,
    adam_lr: float = 0.025,
    cost_normalize: bool = False,
    cost_elasticity: float = 1.0,
) -> SampleResult:
    """Vectorized ChEES-HMC: warmup (eps + tau + optional mass pooled
    adaptation), then frozen sampling. ``u0``: (C, P) initial positions.

    ``logp_batched``: optional (C, P) -> (C,) implementation of the same
    density (e.g. ``GPModel.log_posterior_u_batch``, the chains-minor
    evidence). When given, the whole sampler runs on one batched
    value-and-gradient instead of vmapping a per-chain one — measurably
    faster to compile AND run at bench shapes (BASELINE.md r3).

    ``logp_params``: optional pytree of arrays passed through to the density
    as a second argument (``logp(q, params)`` / ``logp_batched(qs, params)``).
    Run-specific values (e.g. whitening moments) MUST travel here rather than
    be closed over: the compiled programs are cached on the density function's
    identity (`_build_programs`), so closed-over constants would either go
    stale or force a fresh multi-minute compile per run.
    """
    u0 = jnp.atleast_2d(u0)
    C, P = u0.shape
    dtype = u0.dtype
    takes_params = logp_params is not None
    params = logp_params if takes_params else ()

    inv_mass = (
        jnp.ones((P,), dtype)
        if inv_mass0 is None
        else jnp.asarray(inv_mass0, dtype)
    )
    tau_init = float(tau0) if tau0 is not None else eps0 * 8.0

    # Device calls are CHUNKED: one jitted scan of `chunk` iterations,
    # executed repeatedly from the host, so one compiled program serves any
    # warmup/sample count.
    # Warmup and sampling share the SAME compiled program: `adapt` is a
    # traced 0/1 operand masked into the adaptation updates (chees_step), so
    # the pipeline pays ONE big compile instead of three — measured 413 s ->
    # ~1/3 at 12288 chains (BASELINE.md r3 profile).
    chunk = max(1, int(chunk))
    init_fn, chunk_fn = _build_programs(
        logp_batched if logp_batched is not None else logp,
        logp_batched is not None,
        takes_params,
        float(target_accept),
        int(max_steps),
        chunk,
        float(adam_lr),
        bool(cost_normalize),
    )

    cost_t = jnp.asarray(cost_elasticity, dtype)

    def run_chunk(state, adapt):
        return chunk_fn(state, params, inv_mass, adapt, cost_t)

    eps0_arr = jnp.asarray(eps0, dtype)
    tau0_arr = jnp.asarray(tau_init, dtype)

    state = init_fn(u0, params, key, eps0_arr, tau0_arr)
    one = jnp.ones((), jnp.int32)
    div_w = jnp.zeros((), jnp.int32)
    for _ in range(-(-num_warmup // chunk)):
        state, (_, _, div, _, _) = run_chunk(state, one)
        div_w = div_w + jnp.sum(div).astype(jnp.int32)

    # freeze: use averaged step size
    eps_final = jnp.exp(state.da.log_eps_avg)
    state = state._replace(da=state.da._replace(log_eps=jnp.log(eps_final)))

    us_parts, lps_parts, acc_parts = [], [], []
    divergences = jnp.zeros((), jnp.int32)
    n_leap = jnp.zeros((), jnp.int64 if jax.config.jax_enable_x64 else jnp.int32)
    n_chunks = -(-num_samples // chunk)
    zero = jnp.zeros((), jnp.int32)
    for _ in range(n_chunks):
        state, (us_c, lps_c, div_c, acc_c, leap_c) = run_chunk(state, zero)
        us_parts.append(us_c)
        lps_parts.append(lps_c)
        acc_parts.append(acc_c)
        divergences = divergences + jnp.sum(div_c).astype(jnp.int32)
        n_leap = n_leap + jnp.sum(leap_c).astype(n_leap.dtype)

    us = jnp.concatenate(us_parts, axis=0)[:num_samples]
    lps = jnp.concatenate(lps_parts, axis=0)[:num_samples]
    accs = jnp.concatenate(acc_parts, axis=0)[:num_samples]

    u = jnp.swapaxes(us, 0, 1)
    log_prob = jnp.swapaxes(lps, 0, 1)
    diagnostics = {
        "step_size": eps_final,
        "trajectory_time": jnp.exp(state.log_tau),
        "inv_mass": inv_mass,
        "accept_prob": jnp.swapaxes(accs, 0, 1),
        "divergences": divergences,
        "divergences_warmup": div_w,
        "num_leapfrog_total": n_leap,
        "mean_accept": jnp.mean(accs),
    }
    return SampleResult(u=u, thetas=None, log_prob=log_prob, diagnostics=diagnostics)
