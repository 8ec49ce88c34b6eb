"""Bijectors mapping unconstrained sampler space to constrained hyperparameters.

The reference (``gptools/core.py :: update_hyperparameters``) handles bounds by
returning ``-inf`` log-likelihood when a proposal violates ``param_bounds``,
which is fine for emcee's random-walk-ish ensemble moves but poisonous for
gradient-based samplers (HMC/NUTS) and for ADVI. This engine instead
samples in an unconstrained space ``u`` and maps through a smooth bijector
``x = forward(u)`` chosen from the parameter bounds, with the exact
``log |det J|`` correction added to the log-density.

All bijectors act on 1-D parameter vectors (a slice of the flat
hyperparameter vector) and are shape-polymorphic pytree-free objects: they are
static (hashable) and safe to close over inside ``jit``.
"""

from __future__ import annotations

import math
from typing import Sequence

import jax
import jax.numpy as jnp

__all__ = [
    "Bijector",
    "IdentityBijector",
    "ExpBijector",
    "SoftplusBijector",
    "SigmoidBijector",
    "NegExpBijector",
    "OrderedIntervalBijector",
    "ConcatBijector",
    "interval_bijector",
    "bijector_from_bounds",
]

_EPS = 1e-12


def _softplus(u):
    return jax.nn.softplus(u)


def _log_sigmoid(u):
    return jax.nn.log_sigmoid(u)


class Bijector:
    """Smooth invertible map ``u (unconstrained) -> x (constrained)`` on a
    vector of length `dim`."""

    dim: int

    def forward(self, u: jax.Array) -> jax.Array:
        raise NotImplementedError

    def inverse(self, x: jax.Array) -> jax.Array:
        raise NotImplementedError

    def log_det_jac(self, u: jax.Array) -> jax.Array:
        """log |det d forward / d u| evaluated at ``u`` (scalar)."""
        raise NotImplementedError

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self):
        return hash((type(self).__name__, tuple(sorted(self.__dict__.items()))))


class IdentityBijector(Bijector):
    def __init__(self, dim: int = 1):
        self.dim = dim

    def forward(self, u):
        return u

    def inverse(self, x):
        return x

    def log_det_jac(self, u):
        return jnp.zeros((), dtype=u.dtype)


class ExpBijector(Bijector):
    """``x = lo + exp(u)`` onto ``(lo, inf)``."""

    def __init__(self, lo: float = 0.0, dim: int = 1):
        self.lo = float(lo)
        self.dim = dim

    def forward(self, u):
        return self.lo + jnp.exp(u)

    def inverse(self, x):
        return jnp.log(jnp.maximum(x - self.lo, _EPS))

    def log_det_jac(self, u):
        return jnp.sum(u)


class SoftplusBijector(Bijector):
    """``x = lo + softplus(u)`` onto ``(lo, inf)``.

    Gentler than `ExpBijector` for large ``u``; preferred for scale parameters
    whose posteriors may sit many e-folds from the initial point.
    """

    def __init__(self, lo: float = 0.0, dim: int = 1):
        self.lo = float(lo)
        self.dim = dim

    def forward(self, u):
        return self.lo + _softplus(u)

    def inverse(self, x):
        y = jnp.maximum(x - self.lo, _EPS)
        # softplus^-1(y) = y + log1p(-exp(-y)), stable for both tails
        return y + jnp.log(-jnp.expm1(-y))

    def log_det_jac(self, u):
        return jnp.sum(_log_sigmoid(u))


class NegExpBijector(Bijector):
    """``x = hi - exp(u)`` onto ``(-inf, hi)``."""

    def __init__(self, hi: float = 0.0, dim: int = 1):
        self.hi = float(hi)
        self.dim = dim

    def forward(self, u):
        return self.hi - jnp.exp(u)

    def inverse(self, x):
        return jnp.log(jnp.maximum(self.hi - x, _EPS))

    def log_det_jac(self, u):
        return jnp.sum(u)


class SigmoidBijector(Bijector):
    """``x = lo + (hi - lo) * sigmoid(u)`` onto ``(lo, hi)``."""

    def __init__(self, lo: float, hi: float, dim: int = 1):
        if not (hi > lo):
            raise ValueError(f"need hi > lo, got ({lo}, {hi})")
        self.lo = float(lo)
        self.hi = float(hi)
        self.dim = dim

    def forward(self, u):
        return self.lo + (self.hi - self.lo) * jax.nn.sigmoid(u)

    def inverse(self, x):
        p = jnp.clip((x - self.lo) / (self.hi - self.lo), _EPS, 1.0 - 1e-7)
        return jnp.log(p) - jnp.log1p(-p)

    def log_det_jac(self, u):
        # d/du [ (hi-lo) sigmoid(u) ] = (hi-lo) sigmoid(u) sigmoid(-u)
        return jnp.sum(
            math.log(self.hi - self.lo) + _log_sigmoid(u) + _log_sigmoid(-u)
        )


class OrderedIntervalBijector(Bijector):
    """Map ``u in R^k`` to ``lo < x_1 < x_2 < ... < x_k < hi``.

    Stick-breaking recursion: ``x_1 = lo + (hi-lo) s(u_1)``,
    ``x_i = x_{i-1} + (hi - x_{i-1}) s(u_i)`` with ``s = sigmoid``. The
    Jacobian is lower-triangular, so
    ``log|det J| = sum_i log[(hi - x_{i-1}) s'(u_i)]``.

    Used as the sampling-space transform for sorted priors
    (`gptools_tpu.utils.priors.SortedUniformJointPrior`), the counterpart of
    the reference's ``gptools/utils.py :: SortedUniformJointPrior`` which
    relied on rejection at the likelihood level.
    """

    def __init__(self, lo: float, hi: float, dim: int):
        if not (hi > lo):
            raise ValueError(f"need hi > lo, got ({lo}, {hi})")
        self.lo = float(lo)
        self.hi = float(hi)
        self.dim = dim

    def _scan(self, u):
        def step(prev, ui):
            gap = self.hi - prev
            xi = prev + gap * jax.nn.sigmoid(ui)
            ld = jnp.log(gap) + _log_sigmoid(ui) + _log_sigmoid(-ui)
            return xi, (xi, ld)

        _, (xs, lds) = jax.lax.scan(step, jnp.asarray(self.lo, u.dtype), u)
        return xs, jnp.sum(lds)

    def forward(self, u):
        xs, _ = self._scan(u)
        return xs

    def inverse(self, x):
        prev = jnp.concatenate([jnp.full((1,), self.lo, x.dtype), x[:-1]])
        p = jnp.clip((x - prev) / (self.hi - prev), _EPS, 1.0 - 1e-7)
        return jnp.log(p) - jnp.log1p(-p)

    def log_det_jac(self, u):
        _, ld = self._scan(u)
        return ld


class ConcatBijector(Bijector):
    """Apply a sequence of bijectors to consecutive slices of the vector."""

    def __init__(self, parts: Sequence[Bijector]):
        self.parts = tuple(parts)
        self.dim = sum(p.dim for p in self.parts)
        offs = []
        o = 0
        for p in self.parts:
            offs.append(o)
            o += p.dim
        self._offsets = tuple(offs)

    def _map(self, fn, v):
        outs = [
            fn(p, jax.lax.dynamic_slice_in_dim(v, o, p.dim))
            for p, o in zip(self.parts, self._offsets)
        ]
        return outs

    def forward(self, u):
        return jnp.concatenate(self._map(lambda p, s: p.forward(s), u))

    def inverse(self, x):
        return jnp.concatenate(self._map(lambda p, s: p.inverse(s), x))

    def log_det_jac(self, u):
        parts = self._map(lambda p, s: p.log_det_jac(s), u)
        return sum(parts[1:], parts[0])

    def __hash__(self):
        return hash((type(self).__name__, self.parts))

    def __eq__(self, other):
        return type(self) is type(other) and self.parts == other.parts


def interval_bijector(lo: float, hi: float) -> Bijector:
    """Choose the canonical scalar bijector for one bounded/unbounded interval."""
    lo_f = lo if lo is not None else -math.inf
    hi_f = hi if hi is not None else math.inf
    finite_lo = math.isfinite(lo_f)
    finite_hi = math.isfinite(hi_f)
    if finite_lo and finite_hi:
        return SigmoidBijector(lo_f, hi_f)
    if finite_lo:
        return SoftplusBijector(lo_f)
    if finite_hi:
        return NegExpBijector(hi_f)
    return IdentityBijector()


def bijector_from_bounds(bounds: Sequence[tuple]) -> Bijector:
    """Build a `ConcatBijector` of canonical scalar bijectors from a bounds list."""
    return ConcatBijector([interval_bijector(lo, hi) for lo, hi in bounds])
