"""Gaussian-process evidence linear algebra: Cholesky + solve + logdet.

Counterpart of the single hot path of the reference,
``gptools/core.py :: GaussianProcess.compute_K_L_alpha_ll`` (SURVEY.md
section 3.1): build K, factor, solve for alpha, accumulate the log marginal
likelihood. Differences by design:

- the factorization is XLA's batched Cholesky (blocked under jit/vmap),
  differentiated exactly by JAX's built-in Cholesky JVP/VJP — the reference
  instead traced analytic ``hyper_deriv`` formulas through every kernel;
- failure (non-PSD K from an extreme hyperparameter draw) follows the
  reference's reject-don't-crash contract: the log-likelihood becomes
  ``-inf`` via a ``where`` on finiteness instead of raising
  (``gptools/error_handling.py :: GPImpossibleParamsError`` path), so jitted
  NUTS/SMC simply rejects the proposal;
- jitter is relative to the mean diagonal (the reference added
  ``diag_factor * machine-eps`` absolutely), which keeps f32 runs
  well-conditioned across amplitude scales (SURVEY.md section 7.1 numerics
  note), and it only tops the diagonal up to that floor: the observation
  noise already on the diagonal counts towards it (`_jitter`).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = [
    "CholState",
    "add_jitter",
    "chol_factor",
    "gaussian_loglik",
    "loglik",
    "loglik_b",
    "small_cholesky",
    "small_cholesky_b",
    "small_solve_lower",
    "small_solve_lower_b",
    "small_solve_upper_t",
    "small_solve_upper_t_b",
]

_LOG_2PI = math.log(2.0 * math.pi)

# K^{-1} in the analytic gradient runs at full f32 precision (no TF32)
_HI = jax.lax.Precision.HIGHEST

# Below this size the small-matrix loops replace XLA's cholesky /
# triangular_solve: a library's blocked factorization is tuned for LARGE
# matrices, while the column loop below runs N fused elementwise steps over
# the batch dimension at GP-hyperparameter sizes, and remains plain jnp ops
# (exact autodiff, no custom VJP). The threshold has not been measured on
# the GPU.
_SMALL_N_MAX = 64


def small_cholesky(K: jax.Array) -> jax.Array:
    """Lower Cholesky of a small SPD matrix by a column
    (Cholesky-Banachiewicz) loop. Supports arbitrary leading batch axes;
    NaN-poisons (rather than raises) on non-PSD input, matching
    ``jnp.linalg.cholesky`` semantics so the -inf-on-failure contract holds.

    The loop is ROLLED (`lax.fori_loop` with a masked full-column update),
    so the program stays the same size for any N and compiles in seconds.
    """
    n = K.shape[-1]
    rows = jnp.arange(n)

    def column(j, L):
        # columns < j are final; row j of L holds L[j, k] for k < j, zeros
        # after, so this sums exactly the k < j terms
        Lj = jax.lax.dynamic_index_in_dim(L, j, axis=-2, keepdims=False)
        Kj = jax.lax.dynamic_index_in_dim(K, j, axis=-1, keepdims=False)
        v = Kj - jnp.sum(L * Lj[..., None, :], axis=-1)
        d = jax.lax.dynamic_index_in_dim(v, j, axis=-1, keepdims=False)
        col = jnp.where(rows >= j, v / jnp.sqrt(d)[..., None], 0.0)
        return jax.lax.dynamic_update_index_in_dim(L, col, j, L.ndim - 1)

    return jax.lax.fori_loop(0, n, column, jnp.zeros_like(K))


def _diag_entry(L, i):
    row = jax.lax.dynamic_index_in_dim(L, i, axis=-2, keepdims=False)
    return jax.lax.dynamic_index_in_dim(row, i, axis=-1, keepdims=False)


def small_solve_lower(L: jax.Array, b: jax.Array) -> jax.Array:
    """Forward substitution ``L x = b`` (rolled, batch-axis friendly)."""
    n = L.shape[-1]

    def row(i, x):  # x[k] = 0 for k >= i: the sum takes the k < i terms
        Li = jax.lax.dynamic_index_in_dim(L, i, axis=-2, keepdims=False)
        bi = jax.lax.dynamic_index_in_dim(b, i, axis=-1, keepdims=False)
        xi = (bi - jnp.sum(Li * x, axis=-1)) / _diag_entry(L, i)
        return jax.lax.dynamic_update_index_in_dim(x, xi, i, x.ndim - 1)

    return jax.lax.fori_loop(
        0, n, row, jnp.zeros(jnp.broadcast_shapes(b.shape, L.shape[:-1]), b.dtype)
    )


def small_solve_upper_t(L: jax.Array, w: jax.Array) -> jax.Array:
    """Back substitution ``L^T x = w`` (rolled, batch-axis friendly)."""
    n = L.shape[-1]

    def row(t, x):  # x[k] = 0 for k <= i: the sum takes the k > i terms
        i = n - 1 - t
        Li = jax.lax.dynamic_index_in_dim(L, i, axis=-1, keepdims=False)
        wi = jax.lax.dynamic_index_in_dim(w, i, axis=-1, keepdims=False)
        xi = (wi - jnp.sum(Li * x, axis=-1)) / _diag_entry(L, i)
        return jax.lax.dynamic_update_index_in_dim(x, xi, i, x.ndim - 1)

    return jax.lax.fori_loop(
        0, n, row, jnp.zeros(jnp.broadcast_shapes(w.shape, L.shape[:-1]), w.dtype)
    )


class CholState(NamedTuple):
    """Cached factorization, mirroring the reference's cached
    ``(K, L, alpha, ll)`` quadruple."""

    L: jax.Array       # lower Cholesky factor of K (+ jitter)
    alpha: jax.Array   # K^{-1} (y - mu)
    ll: jax.Array      # log marginal likelihood (scalar, may be -inf)
    ok: jax.Array      # bool: factorization succeeded and ll is finite


def _jitter(scale, diag_factor, noise_floor, dtype):
    """Diagonal jitter ``diag_factor * eps * max(scale, 1)`` less the
    observation-noise variance ``noise_floor`` that every diagonal entry of
    K already carries: the jitter only tops the diagonal up to its floor.
    Where the noise covers it, nothing is added, so an f32 run samples the
    same posterior as an f64 one (an additive f32 jitter acts as extra
    noise and biases it). Returns (jitter, d jitter / d scale)."""
    c = diag_factor * jnp.finfo(dtype).eps
    want = c * jnp.maximum(scale, jnp.asarray(1.0, dtype))
    on = want > noise_floor
    jitter = jnp.where(on, want - noise_floor, jnp.zeros_like(want))
    return jitter, jnp.where(on & (scale > 1.0), c, 0.0).astype(dtype)


def add_jitter(
    K: jax.Array, diag_factor: float = 1e2, noise_floor=0.0
) -> jax.Array:
    """Add relative diagonal jitter: ``diag_factor * eps * mean(diag K)``,
    less ``noise_floor`` (see `_jitter`)."""
    scale = jnp.mean(jnp.diagonal(K, axis1=-2, axis2=-1))
    jitter, _ = _jitter(scale, diag_factor, noise_floor, K.dtype)
    n = K.shape[-1]
    return K + jitter * jnp.eye(n, dtype=K.dtype)


def chol_factor(
    K: jax.Array, diag_factor: float = 1e2, noise_floor=0.0
) -> jax.Array:
    """Lower Cholesky of K with relative jitter (NaN rows on failure).

    Dispatches to the small-matrix loop below ``_SMALL_N_MAX``
    (shape is static under jit, so this is a trace-time branch)."""
    Kj = add_jitter(K, diag_factor, noise_floor)
    if K.shape[-1] <= _SMALL_N_MAX:
        return small_cholesky(Kj)
    return jnp.linalg.cholesky(Kj)


def gaussian_loglik(
    K: jax.Array, r: jax.Array, diag_factor: float = 1e2, noise_floor=0.0
) -> CholState:
    """log N(r | 0, K) with exact gradients and -inf-on-failure.

    Args:
      K: (N, N) covariance (before jitter).
      r: (N,) residual ``y - mu``.
      noise_floor: the smallest noise variance on K's diagonal (`_jitter`).

    Returns a `CholState`; ``state.ll`` is the log marginal likelihood
    ``-1/2 r^T K^-1 r - sum(log diag L) - N/2 log(2 pi)``.
    """
    n = r.shape[-1]
    L = chol_factor(K, diag_factor, noise_floor)
    # L may contain NaNs if K was not PD; propagate and mask at the end.
    if n <= _SMALL_N_MAX:
        w = small_solve_lower(L, r)
        alpha = small_solve_upper_t(L, w)
    else:
        w = jax.scipy.linalg.solve_triangular(L, r, lower=True)
        alpha = jax.scipy.linalg.solve_triangular(L, w, lower=True, trans=1)
    quad = jnp.sum(w * w)
    logdet_half = jnp.sum(jnp.log(jnp.diagonal(L)))
    ll = -0.5 * quad - logdet_half - 0.5 * n * _LOG_2PI
    ok = jnp.isfinite(ll)
    ll = jnp.where(ok, ll, -jnp.inf)
    return CholState(L=L, alpha=alpha, ll=ll, ok=ok)


# ---------------------------------------------------------------------------
# analytic-gradient scalar evidence (the sampler hot path)
# ---------------------------------------------------------------------------
#
# Autodiffing through the Cholesky loop is CORRECT but slow: the transpose
# of each column update materializes a (batch, N, N) scatter, so the
# backward pass costs many times the forward, and its temporaries grow with
# the batch. The gradient of the Gaussian evidence is
# analytic:
#
#     d ll / d K = 1/2 (alpha alpha^T - K^{-1}),   alpha = K^{-1} r
#     d ll / d r = -alpha
#
# so `loglik` wraps the forward in a custom VJP that reuses the factor:
# K^{-1} from one triangular solve with identity RHS plus one tiny
# batched matmul — no differentiation through the factorization at all.
# The jitter's dependence on mean(diag K) is included (trace term below).


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def loglik(
    K: jax.Array, r: jax.Array, diag_factor: float = 1e2, noise_floor=0.0
) -> jax.Array:
    """``log N(r | 0, K + jitter)`` as a scalar, with the analytic VJP.

    Gradient-path twin of `gaussian_loglik().ll` (which callers needing the
    cached factor still use): identical value and -inf-on-failure contract,
    but the backward pass costs ~2x the forward instead of ~18x. Unbatched
    (N, N)/(N,) in, scalar out; vmap batches the custom VJP as usual.
    """
    return gaussian_loglik(K, r, diag_factor, noise_floor).ll


def _loglik_fwd(K, r, diag_factor, noise_floor):
    state = gaussian_loglik(K, r, diag_factor, noise_floor)
    scale = jnp.mean(jnp.diagonal(K, axis1=-2, axis2=-1))
    _, dj = _jitter(scale, diag_factor, noise_floor, K.dtype)
    return state.ll, (state.L, state.alpha, state.ok, dj)


def _loglik_bwd(diag_factor, res, g):
    L, alpha, ok, dj = res
    n = L.shape[-1]
    eye = jnp.eye(n, dtype=L.dtype)
    # X[j] = L^{-1} e_j  =>  X = (L^{-1})^T;  K^{-1} = L^{-T} L^{-1} = X X^T
    if n <= _SMALL_N_MAX:
        X = small_solve_lower(L, eye)
    else:
        X = jax.scipy.linalg.solve_triangular(L, eye, lower=True).T
    Kinv = jnp.matmul(X, X.T, precision=_HI)
    Kbar = 0.5 * (alpha[:, None] * alpha[None, :] - Kinv)
    # the jitter's K-dependence (through mean diag K) adds
    # (d jitter/d K_ii) * dll/d jitter = (dj/n) * trace(S) on the diag
    Kbar = Kbar + (dj * jnp.trace(Kbar) / n) * eye
    rbar = -alpha
    # failed factorization: ll is the -inf constant, gradient is zero
    zero = jnp.zeros((), L.dtype)
    Kbar = jnp.where(ok, g * Kbar, zero)
    rbar = jnp.where(ok, g * rbar, zero)
    # noise_floor is data: no cotangent
    return Kbar, rbar, None


loglik.defvjp(_loglik_fwd, _loglik_bwd)


# ---------------------------------------------------------------------------
# chains-minor ("structure of arrays") batched evidence — the sampler hot path
# ---------------------------------------------------------------------------
#
# The vmapped per-chain path lays batches out as (C, N, N), so every
# scalar op of the factorization works on a strided slice of tiny matrices.
# The functions below keep the CHAIN axis minormost instead: matrices are
# (N, N, C), vectors (N, C), so every step of the factorization/solves is a
# dense, contiguous op over chains. The steps are ROLLED (`lax.fori_loop`
# over columns/rows with masked full-width updates) rather than unrolled:
# the program stays the same size for any N, so it compiles in seconds on
# the GPU, where the unrolled graph took minutes at N = 27 (PERF.md). Same
# math, same -inf-on-failure contract; pinned against the per-chain path in
# tests/test_evidence_batch.py.


def small_cholesky_b(K: jax.Array) -> jax.Array:
    """Lower Cholesky of a batch of small SPD matrices in chains-minor layout:
    K (N, N, C) -> L (N, N, C). NaN-poisons on non-PSD input."""
    n = K.shape[0]
    rows = jnp.arange(n)[:, None]

    def column(j, L):
        # columns < j are final; row j of L holds L[j, k] for k < j, zeros
        # after, so this sums exactly the k < j terms
        v = K[:, j] - jnp.sum(L * L[j][None], axis=1)  # (N, C)
        col = jnp.where(rows >= j, v / jnp.sqrt(v[j])[None], 0.0)
        return jax.lax.dynamic_update_index_in_dim(L, col, j, 1)

    return jax.lax.fori_loop(0, n, column, jnp.zeros_like(K))


def small_solve_lower_b(L: jax.Array, b: jax.Array) -> jax.Array:
    """Forward substitution ``L x = b`` in chains-minor layout:
    L (N, N, C), b (N, C) -> x (N, C)."""

    def row(i, x):  # x[k] = 0 for k >= i: the sum takes the k < i terms
        xi = (b[i] - jnp.sum(L[i] * x, axis=0)) / L[i, i]
        return jax.lax.dynamic_update_index_in_dim(x, xi, i, 0)

    return jax.lax.fori_loop(0, L.shape[0], row, jnp.zeros_like(b))


def small_solve_upper_t_b(L: jax.Array, w: jax.Array) -> jax.Array:
    """Back substitution ``L^T x = w`` in chains-minor layout."""
    n = L.shape[0]

    def row(t, x):  # x[k] = 0 for k <= i: the sum takes the k > i terms
        i = n - 1 - t
        xi = (w[i] - jnp.sum(L[:, i] * x, axis=0)) / L[i, i]
        return jax.lax.dynamic_update_index_in_dim(x, xi, i, 0)

    return jax.lax.fori_loop(0, n, row, jnp.zeros_like(w))


def _inv_lower_b(L: jax.Array) -> jax.Array:
    """Z = L^{-1} for lower-triangular L (N, N, C), row by row:
    Z[i] = (e_i - sum_{k<i} L[i, k] Z[k]) / L[i, i]."""
    n = L.shape[0]
    eye = jnp.eye(n, dtype=L.dtype)[:, :, None]

    def row(i, Z):  # rows >= i of Z are still zero
        zi = (eye[i] - jnp.sum(L[i][:, None, :] * Z, axis=0)) / L[i, i]
        return jax.lax.dynamic_update_index_in_dim(Z, zi, i, 0)

    return jax.lax.fori_loop(0, n, row, jnp.zeros_like(L))


def _add_jitter_b(K: jax.Array, diag_factor: float, noise_floor):
    """Relative diagonal jitter (`_jitter`), chains-minor: K (N, N, C).
    Returns K + jitter and d jitter / d mean(diag K), per chain."""
    n = K.shape[0]
    diag = jnp.stack([K[i, i] for i in range(n)], axis=0)  # (N, C)
    scale = jnp.mean(diag, axis=0)  # (C,)
    jitter, dj = _jitter(scale, diag_factor, noise_floor, K.dtype)
    eye = jnp.eye(n, dtype=K.dtype)[:, :, None]
    return K + jitter[None, None, :] * eye, dj


def _loglik_b_value(K, r, diag_factor, noise_floor):
    n = r.shape[0]
    Kj, dj = _add_jitter_b(K, diag_factor, noise_floor)
    L = small_cholesky_b(Kj)
    w = small_solve_lower_b(L, r)
    alpha = small_solve_upper_t_b(L, w)
    quad = jnp.sum(w * w, axis=0)
    diagL = jnp.stack([L[i, i] for i in range(n)], axis=0)
    logdet_half = jnp.sum(jnp.log(diagL), axis=0)
    ll = -0.5 * quad - logdet_half - 0.5 * n * _LOG_2PI
    ok = jnp.isfinite(ll)
    ll = jnp.where(ok, ll, -jnp.inf)
    return ll, (L, alpha, ok, dj)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def loglik_b(
    K: jax.Array, r: jax.Array, diag_factor: float = 1e2, noise_floor=0.0
) -> jax.Array:
    """Batched ``log N(r | 0, K + jitter)`` in chains-minor layout with the
    analytic VJP: K (N, N, C), r (N, C) -> ll (C,).

    Value/gradient twin of ``vmap(loglik)`` over a leading chain axis, but
    every op runs chain-dense (see module comment above)."""
    return _loglik_b_value(K, r, diag_factor, noise_floor)[0]


def _loglik_b_fwd(K, r, diag_factor, noise_floor):
    return _loglik_b_value(K, r, diag_factor, noise_floor)


def _loglik_b_bwd(diag_factor, res, g):
    L, alpha, ok, dj = res
    n = L.shape[0]
    Z = _inv_lower_b(L)  # L^{-1}
    Kinv = jnp.einsum("kic,kjc->ijc", Z, Z, precision=_HI)  # L^{-T} L^{-1}
    Kbar = 0.5 * (alpha[:, None, :] * alpha[None, :, :] - Kinv)
    tr = jnp.einsum("iic->c", Kbar)
    eye = jnp.eye(n, dtype=L.dtype)[:, :, None]
    Kbar = Kbar + (dj * tr / n)[None, None, :] * eye
    rbar = -alpha
    okf = ok[None, None, :]
    Kbar = jnp.where(okf, g[None, None, :] * Kbar, 0.0)
    rbar = jnp.where(ok[None, :], g[None, :] * rbar, 0.0)
    return Kbar, rbar, None


loglik_b.defvjp(_loglik_b_fwd, _loglik_b_bwd)
