"""Hyperprior objects over (slices of) the flat hyperparameter vector.

Counterpart of the reference's prior zoo in
``gptools/utils.py`` (``JointPrior``, ``ProductJointPrior``,
``UniformJointPrior``, ``IndependentJointPrior``, ``NormalJointPrior``,
``LogNormalJointPrior``, ``GammaJointPrior`` / ``GammaJointPriorAlt``,
``SortedUniformJointPrior``, ``CoreEdgeJointPrior`` — SURVEY.md section 2.1).

Contracts kept from the reference:

- a joint prior covers a contiguous block of hyperparameters and exposes a
  joint log-density plus random draws (used for MCMC initialization and
  multi-start MAP, ``gptools/core.py :: optimize_hyperparameters``);
- priors compose with ``*`` into a `ProductJointPrior` over the concatenated
  vector (reference ``JointPrior.__mul__``);
- evaluating outside the support yields ``-inf`` (the reference's
  reject-don't-crash contract, ``gptools/error_handling.py``).

New relative to the reference (needed by gradient-based inference):

- every prior knows a smooth default `bijector()` to an unconstrained sampling
  space (see `gptools_tpu.utils.bijectors`), so HMC/NUTS/ADVI never see the
  hard support boundary.

All log-densities are pure jittable JAX; ``sample`` uses explicit PRNG keys
(no global numpy seed, unlike the reference).
"""

from __future__ import annotations

import math
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from gptools_tpu.utils import bijectors as bij

__all__ = [
    "JointPrior",
    "ProductJointPrior",
    "UniformJointPrior",
    "NormalJointPrior",
    "LogNormalJointPrior",
    "GammaJointPrior",
    "GammaJointPriorAlt",
    "ExponentialJointPrior",
    "SortedUniformJointPrior",
    "CoreEdgeJointPrior",
    "IndependentJointPrior",
    "Uniform",
    "Normal",
    "LogNormal",
    "Gamma",
    "Exponential",
]

_NEG_INF = -jnp.inf


def _as_tuple(x, k: int) -> tuple:
    if np.ndim(x) == 0 or isinstance(x, (int, float)):
        return (float(x),) * k
    t = tuple(float(v) for v in x)
    if len(t) != k:
        raise ValueError(f"expected length {k}, got {len(t)}")
    return t


class JointPrior:
    """Base class: joint prior over a length-`dim` block of hyperparameters."""

    dim: int

    def log_prob(self, theta: jax.Array) -> jax.Array:
        raise NotImplementedError

    def sample(self, key: jax.Array, shape: tuple = ()) -> jax.Array:
        raise NotImplementedError

    @property
    def bounds(self) -> list:
        raise NotImplementedError

    def bijector(self) -> bij.Bijector:
        return bij.bijector_from_bounds(self.bounds)

    def __mul__(self, other: "JointPrior") -> "ProductJointPrior":
        mine = self.parts if isinstance(self, ProductJointPrior) else (self,)
        theirs = other.parts if isinstance(other, ProductJointPrior) else (other,)
        return ProductJointPrior(mine + theirs)

    def __call__(self, theta):  # reference spelling: hyperprior(theta)
        return self.log_prob(theta)


class ProductJointPrior(JointPrior):
    """Product of independent blocks over the concatenated vector.

    Counterpart of ``gptools/utils.py :: ProductJointPrior``.
    """

    def __init__(self, parts: Sequence[JointPrior]):
        self.parts = tuple(parts)
        self.dim = sum(p.dim for p in self.parts)
        offs, o = [], 0
        for p in self.parts:
            offs.append(o)
            o += p.dim
        self._offsets = tuple(offs)

    def log_prob(self, theta):
        total = jnp.zeros((), dtype=jnp.result_type(theta, jnp.float32))
        for p, o in zip(self.parts, self._offsets):
            total = total + p.log_prob(jax.lax.dynamic_slice_in_dim(theta, o, p.dim))
        return total

    def sample(self, key, shape=()):
        keys = jax.random.split(key, len(self.parts))
        draws = [p.sample(k, shape) for p, k in zip(self.parts, keys)]
        return jnp.concatenate(draws, axis=-1)

    @property
    def bounds(self):
        out = []
        for p in self.parts:
            out.extend(p.bounds)
        return out

    def bijector(self):
        return bij.ConcatBijector([p.bijector() for p in self.parts])


class UniformJointPrior(JointPrior):
    """Independent uniforms on boxes; ``gptools/utils.py :: UniformJointPrior``."""

    def __init__(self, lb, ub=None, dim: int | None = None):
        if ub is None:
            # gptools also accepts a list of (lb, ub) pairs
            pairs = [(float(a), float(b)) for a, b in lb]
            self.lb = tuple(p[0] for p in pairs)
            self.ub = tuple(p[1] for p in pairs)
        else:
            k = dim if dim is not None else (np.ndim(lb) and len(lb)) or 1
            if np.ndim(lb) > 0:
                k = len(lb)
            self.lb = _as_tuple(lb, k)
            self.ub = _as_tuple(ub, k)
        if any(u <= l for l, u in zip(self.lb, self.ub)):
            raise ValueError("UniformJointPrior requires ub > lb elementwise")
        self.dim = len(self.lb)

    def log_prob(self, theta):
        lb = jnp.asarray(self.lb, theta.dtype)
        ub = jnp.asarray(self.ub, theta.dtype)
        inside = jnp.all((theta >= lb) & (theta <= ub))
        lp = -jnp.sum(jnp.log(ub - lb))
        return jnp.where(inside, lp, _NEG_INF)

    def sample(self, key, shape=()):
        lb = jnp.asarray(self.lb)
        ub = jnp.asarray(self.ub)
        u = jax.random.uniform(key, shape + (self.dim,))
        return lb + (ub - lb) * u

    @property
    def bounds(self):
        return list(zip(self.lb, self.ub))


class NormalJointPrior(JointPrior):
    """Independent normals; ``gptools/utils.py :: NormalJointPrior``."""

    def __init__(self, mu, sigma, dim: int | None = None):
        k = dim if dim is not None else (len(mu) if np.ndim(mu) > 0 else (len(sigma) if np.ndim(sigma) > 0 else 1))
        self.mu = _as_tuple(mu, k)
        self.sigma = _as_tuple(sigma, k)
        if any(s <= 0 for s in self.sigma):
            raise ValueError("sigma must be positive")
        self.dim = k

    def log_prob(self, theta):
        mu = jnp.asarray(self.mu, theta.dtype)
        sig = jnp.asarray(self.sigma, theta.dtype)
        z = (theta - mu) / sig
        return jnp.sum(-0.5 * z * z - jnp.log(sig) - 0.5 * math.log(2 * math.pi))

    def sample(self, key, shape=()):
        mu = jnp.asarray(self.mu)
        sig = jnp.asarray(self.sigma)
        return mu + sig * jax.random.normal(key, shape + (self.dim,))

    @property
    def bounds(self):
        return [(-math.inf, math.inf)] * self.dim


class LogNormalJointPrior(JointPrior):
    """Independent lognormals on (0, inf); ``gptools/utils.py :: LogNormalJointPrior``.

    Parameterized like the reference: ``mu``/``sigma`` are the mean/std of
    ``log(theta)``.
    """

    def __init__(self, mu, sigma, dim: int | None = None):
        k = dim if dim is not None else (len(mu) if np.ndim(mu) > 0 else (len(sigma) if np.ndim(sigma) > 0 else 1))
        self.mu = _as_tuple(mu, k)
        self.sigma = _as_tuple(sigma, k)
        if any(s <= 0 for s in self.sigma):
            raise ValueError("sigma must be positive")
        self.dim = k

    def log_prob(self, theta):
        mu = jnp.asarray(self.mu, theta.dtype)
        sig = jnp.asarray(self.sigma, theta.dtype)
        ok = jnp.all(theta > 0)
        x = jnp.where(theta > 0, theta, 1.0)
        lx = jnp.log(x)
        z = (lx - mu) / sig
        lp = jnp.sum(-0.5 * z * z - lx - jnp.log(sig) - 0.5 * math.log(2 * math.pi))
        return jnp.where(ok, lp, _NEG_INF)

    def sample(self, key, shape=()):
        mu = jnp.asarray(self.mu)
        sig = jnp.asarray(self.sigma)
        return jnp.exp(mu + sig * jax.random.normal(key, shape + (self.dim,)))

    @property
    def bounds(self):
        return [(0.0, math.inf)] * self.dim


class GammaJointPrior(JointPrior):
    """Independent Gammas on (0, inf); ``gptools/utils.py :: GammaJointPrior``.

    Reference parameterization: shape ``a`` and scale ``b``:
    ``p(x) = x^(a-1) exp(-x/b) / (Gamma(a) b^a)``.
    """

    def __init__(self, a, b, dim: int | None = None):
        k = dim if dim is not None else (len(a) if np.ndim(a) > 0 else (len(b) if np.ndim(b) > 0 else 1))
        self.a = _as_tuple(a, k)
        self.b = _as_tuple(b, k)
        if any(v <= 0 for v in self.a) or any(v <= 0 for v in self.b):
            raise ValueError("a, b must be positive")
        self.dim = k

    def log_prob(self, theta):
        a = jnp.asarray(self.a, theta.dtype)
        b = jnp.asarray(self.b, theta.dtype)
        ok = jnp.all(theta > 0)
        x = jnp.where(theta > 0, theta, 1.0)
        lp = jnp.sum(
            (a - 1.0) * jnp.log(x) - x / b - jax.lax.lgamma(a) - a * jnp.log(b)
        )
        return jnp.where(ok, lp, _NEG_INF)

    def sample(self, key, shape=()):
        a = jnp.asarray(self.a)
        b = jnp.asarray(self.b)
        g = jax.random.gamma(key, jnp.broadcast_to(a, shape + (self.dim,)))
        return g * b

    @property
    def bounds(self):
        return [(0.0, math.inf)] * self.dim


class GammaJointPriorAlt(GammaJointPrior):
    """Gamma prior parameterized by mode ``m`` and standard deviation ``s``
    (``gptools/utils.py :: GammaJointPriorAlt``).

    Solving ``mode = (a-1) b`` and ``var = a b^2`` gives
    ``b = (-m + sqrt(m^2 + 4 s^2)) / 2`` and ``a = 1 + m / b``.
    """

    def __init__(self, mode, std, dim: int | None = None):
        k = dim if dim is not None else (len(mode) if np.ndim(mode) > 0 else (len(std) if np.ndim(std) > 0 else 1))
        m = _as_tuple(mode, k)
        s = _as_tuple(std, k)
        b = tuple((-mi + math.sqrt(mi * mi + 4 * si * si)) / 2.0 for mi, si in zip(m, s))
        a = tuple(1.0 + mi / bi for mi, bi in zip(m, b))
        super().__init__(a, b, dim=k)
        self.mode = m
        self.std = s


class ExponentialJointPrior(GammaJointPrior):
    """Independent exponentials (Gamma with a=1), rate parameterization."""

    def __init__(self, rate, dim: int | None = None):
        k = dim if dim is not None else (len(rate) if np.ndim(rate) > 0 else 1)
        r = _as_tuple(rate, k)
        super().__init__((1.0,) * k, tuple(1.0 / ri for ri in r), dim=k)
        self.rate = r


class SortedUniformJointPrior(JointPrior):
    """Uniform over the simplex ``lb < x_1 < ... < x_k < ub``
    (``gptools/utils.py :: SortedUniformJointPrior``).

    Density is ``k! / (ub - lb)^k`` on the ordered region, ``-inf`` outside.
    The default bijector is the smooth `OrderedIntervalBijector`, so NUTS
    never proposes an unordered point.
    """

    def __init__(self, dim: int, lb: float, ub: float):
        if not (ub > lb):
            raise ValueError("need ub > lb")
        self.dim = int(dim)
        self.lb = float(lb)
        self.ub = float(ub)

    def log_prob(self, theta):
        inside = (
            jnp.all(theta >= self.lb)
            & jnp.all(theta <= self.ub)
            & jnp.all(jnp.diff(theta) > 0)
        )
        lp = math.lgamma(self.dim + 1) - self.dim * math.log(self.ub - self.lb)
        return jnp.where(inside, jnp.asarray(lp, theta.dtype), _NEG_INF)

    def sample(self, key, shape=()):
        u = jax.random.uniform(key, shape + (self.dim,))
        return jnp.sort(self.lb + (self.ub - self.lb) * u, axis=-1)

    @property
    def bounds(self):
        return [(self.lb, self.ub)] * self.dim

    def bijector(self):
        return bij.OrderedIntervalBijector(self.lb, self.ub, self.dim)


class CoreEdgeJointPrior(SortedUniformJointPrior):
    """Sorted two-block prior for (core, edge) length-scale pairs
    (``gptools/utils.py :: CoreEdgeJointPrior`` [MED confidence, SURVEY.md]).

    Implemented as a sorted uniform over the common interval: enforces
    ``l_core > l_edge`` ordering convention by sorting ascending
    ``(l_edge, l_core)`` blocks. For the tokamak profile use-case this
    reproduces the reference behavior of excluding core/edge label swaps.
    """


class _Dist1D:
    """Minimal scalar distribution interface for `IndependentJointPrior`."""

    bounds: tuple

    def log_pdf(self, x):
        raise NotImplementedError

    def sample(self, key, shape=()):
        raise NotImplementedError


class Uniform(_Dist1D):
    def __init__(self, lo: float, hi: float):
        self._p = UniformJointPrior([lo], [hi])
        self.bounds = (lo, hi)

    def log_pdf(self, x):
        return self._p.log_prob(jnp.reshape(x, (1,)))

    def sample(self, key, shape=()):
        return self._p.sample(key, shape)[..., 0]


class Normal(_Dist1D):
    def __init__(self, mu: float, sigma: float):
        self._p = NormalJointPrior([mu], [sigma])
        self.bounds = (-math.inf, math.inf)

    def log_pdf(self, x):
        return self._p.log_prob(jnp.reshape(x, (1,)))

    def sample(self, key, shape=()):
        return self._p.sample(key, shape)[..., 0]


class LogNormal(_Dist1D):
    def __init__(self, mu: float, sigma: float):
        self._p = LogNormalJointPrior([mu], [sigma])
        self.bounds = (0.0, math.inf)

    def log_pdf(self, x):
        return self._p.log_prob(jnp.reshape(x, (1,)))

    def sample(self, key, shape=()):
        return self._p.sample(key, shape)[..., 0]


class Gamma(_Dist1D):
    def __init__(self, a: float, b: float):
        self._p = GammaJointPrior([a], [b])
        self.bounds = (0.0, math.inf)

    def log_pdf(self, x):
        return self._p.log_prob(jnp.reshape(x, (1,)))

    def sample(self, key, shape=()):
        return self._p.sample(key, shape)[..., 0]


class Exponential(_Dist1D):
    def __init__(self, rate: float):
        self._p = ExponentialJointPrior([rate])
        self.bounds = (0.0, math.inf)

    def log_pdf(self, x):
        return self._p.log_prob(jnp.reshape(x, (1,)))

    def sample(self, key, shape=()):
        return self._p.sample(key, shape)[..., 0]


class IndependentJointPrior(JointPrior):
    """Product of arbitrary scalar distributions
    (``gptools/utils.py :: IndependentJointPrior``, which wrapped
    ``scipy.stats`` frozen distributions; here the univariates are the jittable
    `_Dist1D` objects above)."""

    def __init__(self, univariates: Sequence[_Dist1D]):
        self.univariates = tuple(univariates)
        self.dim = len(self.univariates)

    def log_prob(self, theta):
        lps = [d.log_pdf(theta[i]) for i, d in enumerate(self.univariates)]
        return sum(lps[1:], lps[0])

    def sample(self, key, shape=()):
        keys = jax.random.split(key, self.dim)
        draws = [d.sample(k, shape) for d, k in zip(self.univariates, keys)]
        return jnp.stack(draws, axis=-1)

    @property
    def bounds(self):
        return [d.bounds for d in self.univariates]
