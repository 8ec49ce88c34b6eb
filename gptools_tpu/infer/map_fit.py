"""Multi-start MAP estimation, vectorized on-chip.

Counterpart of ``gptools/core.py ::
GaussianProcess.optimize_hyperparameters`` (SURVEY.md section 3.1): the
reference drew ``random_starts`` points from the hyperprior and fanned
scipy SLSQP over a ``multiprocessing.Pool``; here every start runs the SAME
jitted L-BFGS update under ``vmap`` — one XLA program, all starts in flight
at once, batched Cholesky in the objective. Bound constraints are handled by
optimizing in the unconstrained bijector space (no SLSQP needed); the
hyperprior term makes it MAP rather than MLE, matching the reference's
objective (log marginal likelihood + hyperprior).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

__all__ = ["MAPResult", "optimize"]


@functools.lru_cache(maxsize=64)
def _optimizer_program(
    logp: Callable, method: str, num_steps: int, learning_rate: float
):
    """Jitted vmapped multi-start optimizer cached on the density function's
    identity + static config (`infer.model_logp` supplies a stable ``logp``
    per (model, data)), so repeated `optimize` calls — e.g. refits inside a
    cross-validation loop — reuse the compiled program instead of re-paying
    the XLA compile (the same reuse contract as `chees._build_programs`)."""

    def loss(u):
        return -logp(u)

    if method == "lbfgs":
        opt = optax.lbfgs()

        def run_one(u0):
            value_and_grad = optax.value_and_grad_from_state(loss)

            def step(carry, _):
                params, state = carry
                value, grad = value_and_grad(params, state=state)
                updates, state = opt.update(
                    grad, state, params, value=value, grad=grad, value_fn=loss
                )
                params = optax.apply_updates(params, updates)
                return (params, state), value

            (u_fin, _), values = jax.lax.scan(
                step, (u0, opt.init(u0)), None, length=num_steps
            )
            return u_fin, -loss(u_fin)

    elif method == "adam":
        opt = optax.adam(learning_rate)

        def run_one(u0):
            def step(carry, _):
                params, state = carry
                value, grad = jax.value_and_grad(loss)(params)
                grad = jnp.where(jnp.isfinite(grad), grad, 0.0)
                updates, state = opt.update(grad, state, params)
                params = optax.apply_updates(params, updates)
                return (params, state), value

            (u_fin, _), _ = jax.lax.scan(
                step, (u0, opt.init(u0)), None, length=num_steps
            )
            return u_fin, -loss(u_fin)

    else:
        raise ValueError(f"unknown method {method!r}")

    return jax.jit(jax.vmap(run_one))


class MAPResult(NamedTuple):
    theta: jax.Array          # best constrained hyperparameters (P,)
    u: jax.Array              # best unconstrained free vector
    log_posterior: jax.Array  # value at the optimum
    all_log_posteriors: jax.Array  # per-start final values
    all_thetas: jax.Array     # per-start final constrained params
    converged: jax.Array      # per-start finiteness flag


def optimize(
    model,
    data,
    key: jax.Array,
    random_starts: int = 8,
    num_steps: int = 200,
    method: str = "lbfgs",
    learning_rate: float = 0.05,
    include_current: bool = True,
) -> MAPResult:
    """Maximize ``model.log_posterior_u`` from prior-drawn starts.

    Returns the best start's constrained parameters (reference semantics:
    best −ll wins, GP left in optimized state by the caller).
    """
    from gptools_tpu.infer import model_logp  # circular-safe

    nf = model.num_free_params

    k_draw, k_log = jax.random.split(key)
    thetas0 = model.hyperprior.sample(k_draw, (random_starts,))
    # The reference drew every start uniformly from the hyperprior
    # (gptools/core.py :: optimize_hyperparameters). With the default wide
    # uniform bounds (e.g. (1e-4, 1e4)) a LINEAR-uniform draw puts nearly
    # every start on the flat huge-lengthscale plateau, where all of them
    # converge to the same degenerate mode (observed: a 12-point sine fit
    # MAP-ing to lengthscale ~5e3 and predicting the data mean everywhere).
    # Re-spread half the starts LOG-uniformly across their bounds when a
    # parameter's scale spans >= 2 decades — a start-placement heuristic
    # only; the MAP objective (posterior incl. hyperprior) is unchanged.
    try:
        bounds = np.asarray(
            [tuple(b) for b in model.param_bounds], dtype=np.float64
        )
    except Exception:
        bounds = None
    if bounds is not None and random_starts >= 2:
        lo, hi = bounds[:, 0], bounds[:, 1]
        # np.isfinite(hi): an unbounded upper bound would put log_hi = inf
        # and silently waste the re-spread half of the start budget on
        # inf/NaN starts (masked later, but never useful).
        log_spread = (
            (lo > 0.0)
            & np.isfinite(hi)
            & (hi / np.maximum(lo, 1e-300) >= 1e2)
        )
        if log_spread.any():
            n_log = random_starts // 2
            draw = jax.random.uniform(
                k_log, (n_log, bounds.shape[0]), thetas0.dtype
            )
            log_lo = jnp.log(jnp.where(log_spread, lo, 1.0))
            log_hi = jnp.log(jnp.where(log_spread, hi, 1.0))
            log_draws = jnp.exp(log_lo + draw * (log_hi - log_lo))
            thetas0 = thetas0.at[:n_log].set(
                jnp.where(log_spread[None, :], log_draws, thetas0[:n_log])
            )
    u_of_theta = model.__dict__.get("_u_of_theta_jit")
    if u_of_theta is None:
        u_of_theta = jax.jit(jax.vmap(model.u_of_theta))
        model.__dict__["_u_of_theta_jit"] = u_of_theta
    u0s = u_of_theta(thetas0)
    if include_current:
        u_cur = model.u_of_theta(jnp.asarray(model.initial_params, u0s.dtype))
        u0s = jnp.concatenate([u_cur[None, :], u0s], axis=0)

    run_all = _optimizer_program(
        model_logp(model, data), method, int(num_steps), float(learning_rate)
    )
    us, lps = run_all(u0s)
    finite = jnp.isfinite(lps)
    lps_masked = jnp.where(finite, lps, -jnp.inf)
    best = jnp.argmax(lps_masked)
    u_best = us[best]
    theta_best = model.theta_of_u(u_best)
    embed_jit = model.__dict__.get("_theta_of_u_jit")
    if embed_jit is None:
        embed_jit = jax.jit(jax.vmap(model.theta_of_u))
        model.__dict__["_theta_of_u_jit"] = embed_jit
    all_thetas = embed_jit(us)
    return MAPResult(
        theta=theta_best,
        u=u_best,
        log_posterior=lps_masked[best],
        all_log_posteriors=lps,
        all_thetas=all_thetas,
        converged=finite,
    )
