"""Covariance-function zoo with derivative support via autodiff.

Counterpart of the reference package ``gptools/kernel/``
(SURVEY.md section 2.1):

===========================  =====================================================
reference                     here
===========================  =====================================================
``kernel/core.py``            `Kernel` base, `SumKernel`, `ProductKernel`,
``:: Kernel, BinaryKernel``   `ScaledKernel`, `MaskedKernel`, `ArbitraryKernel`
``:: ChainRuleKernel``        (not needed — autodiff, see `gptools_tpu.ops.derivs`)
``squared_exponential.py``    `SquaredExponentialKernel`
``matern.py``                 `MaternKernel` (any half-integer nu, closed form),
                              `Matern52Kernel`; general real nu via
                              `gptools_tpu.ops.special.bessel_kve` (quadrature)
``gibbs.py``                  `GibbsKernel` + length-scale warps (`TanhWarp`,
                              `GaussWarp`, `ExpWarp`, `InterpolatedWarp`),
                              `GibbsKernel1dTanh`, `GibbsKernel1dGauss`,
                              `GibbsKernel1dExp`
``rational_quadratic.py``     `RationalQuadraticKernel`
``noise.py``                  `DiagonalNoiseKernel`, `ZeroKernel`
``warping.py``                `WarpedKernel` + input warps (`LinearWarp`,
                              `BetaWarp`, `ArbitraryWarp`)
===========================  =====================================================

Design: a kernel object is **static** (safe to close over under ``jit``);
hyperparameter *values* flow separately as a flat vector ``theta``. The single
semantic entry point is the scalar covariance

    k.smooth_scalar(x1, x2, theta)    # x1, x2: (num_dim,)

from which every derivative cross-covariance block is generated by forward-
mode autodiff (`gptools_tpu.ops.derivs.kernel_block_fn`) and every matrix by
`gptools_tpu.ops.assemble`. White-noise (delta) components are kept out of the
smooth scalar and exposed via `delta_terms` so they are never differentiated.

Parameter metadata (initial values, bounds, fixed mask, hyperprior) follows
the reference's free/fixed-parameter plumbing
(``gptools/kernel/core.py :: Kernel.free_params`` etc.), but lives at the
metadata level only: inference always sees the full flat vector and masks
fixed entries (see `gptools_tpu.models.gp`).
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from gptools_tpu.ops import derivs
from gptools_tpu.utils.priors import JointPrior, UniformJointPrior

__all__ = [
    "Kernel",
    "SumKernel",
    "ProductKernel",
    "ScaledKernel",
    "MaskedKernel",
    "ArbitraryKernel",
    "ConstantKernel",
    "ZeroKernel",
    "SquaredExponentialKernel",
    "MaternKernel",
    "MaternGeneralKernel",
    "Matern52Kernel",
    "RationalQuadraticKernel",
    "GibbsKernel",
    "GibbsKernel1dTanh",
    "GibbsKernel1dGauss",
    "GibbsKernel1dExp",
    "LengthScaleWarp",
    "TanhWarp",
    "GaussWarp",
    "ExpWarp",
    "InterpolatedWarp",
    "DiagonalNoiseKernel",
    "WarpedKernel",
    "LinearWarp",
    "BetaWarp",
    "ArbitraryWarp",
]


def _norm_bounds(bounds, k):
    out = []
    for b in bounds:
        lo, hi = b
        lo = -math.inf if lo is None else float(lo)
        hi = math.inf if hi is None else float(hi)
        out.append((lo, hi))
    if len(out) != k:
        raise ValueError(f"expected {k} bounds, got {len(out)}")
    return tuple(out)


class Kernel:
    """Base covariance function.

    Subclasses define ``_scalar(x1, x2, theta)`` (the smooth part) and class
    attributes for parameter metadata. Instances are static w.r.t. jit.
    """

    #: True when the kernel contributes a smooth (differentiable) part.
    has_smooth: bool = True

    def __init__(
        self,
        num_dim: int,
        param_names: Sequence[str],
        initial_params: Optional[Sequence[float]] = None,
        fixed_params: Optional[Sequence[bool]] = None,
        param_bounds: Optional[Sequence[tuple]] = None,
        hyperprior: Optional[JointPrior] = None,
        default_bounds: Optional[Sequence[tuple]] = None,
    ):
        self.num_dim = int(num_dim)
        self.param_names = tuple(param_names)
        k = len(self.param_names)
        if hyperprior is not None and hyperprior.dim != k:
            raise ValueError(
                f"hyperprior dim {hyperprior.dim} != num params {k}"
            )
        if param_bounds is None:
            if hyperprior is not None:
                param_bounds = hyperprior.bounds
            elif default_bounds is not None:
                param_bounds = default_bounds
            else:
                param_bounds = [(1e-4, 1e4)] * k
        # mutable list: the reference exposes bounds as writable views
        # (``gptools/utils.py :: CombinedBounds``); bounds are host-side
        # metadata here (bijectors/priors snapshot them at build time)
        self.param_bounds = list(_norm_bounds(param_bounds, k))
        if hyperprior is None:
            # reference default: uniform over the bounds
            # (gptools/kernel/core.py :: Kernel.__init__ builds a
            # UniformJointPrior from param_bounds when none is given)
            finite = [
                (lo if math.isfinite(lo) else -1e6, hi if math.isfinite(hi) else 1e6)
                for lo, hi in self.param_bounds
            ]
            hyperprior = UniformJointPrior(finite)
        self.hyperprior = hyperprior
        if initial_params is None:
            initial_params = [
                self._default_initial(lo, hi) for lo, hi in self.param_bounds
            ]
        self.initial_params = tuple(float(v) for v in initial_params)
        if len(self.initial_params) != k:
            raise ValueError(f"expected {k} initial params")
        if fixed_params is None:
            fixed_params = [False] * k
        self.fixed_params = tuple(bool(v) for v in fixed_params)
        if len(self.fixed_params) != k:
            raise ValueError(f"expected {k} fixed flags")

    @staticmethod
    def _default_initial(lo, hi):
        if math.isfinite(lo) and math.isfinite(hi):
            return 0.5 * (lo + hi)
        if math.isfinite(lo):
            return lo + 1.0
        if math.isfinite(hi):
            return hi - 1.0
        return 0.0

    # -- parameter metadata -------------------------------------------------
    @property
    def num_params(self) -> int:
        return len(self.param_names)

    @property
    def num_free_params(self) -> int:
        return sum(not f for f in self.fixed_params)

    @property
    def free_param_names(self):
        return tuple(
            n for n, f in zip(self.param_names, self.fixed_params) if not f
        )

    # -- covariance ---------------------------------------------------------
    def _scalar(self, x1, x2, theta):
        raise NotImplementedError

    def smooth_scalar(self, x1, x2, theta):
        """Smooth covariance k(x1, x2); delta (white-noise) parts excluded."""
        return self._scalar(x1, x2, theta)

    def delta_terms(self):
        """List of ``(param_offset, DiagonalNoiseKernel)`` white-noise terms."""
        return []

    def block_fn(self, a: derivs.MultiIndex, b: derivs.MultiIndex) -> Callable:
        """Derivative cross-covariance block ``d^a_x1 d^b_x2 k`` as a scalar fn."""
        return derivs.kernel_block_fn(self.smooth_scalar, a, b)

    def __call__(self, x1, x2, theta, ni=0, nj=0):
        """Reference-flavoured convenience entry
        (``gptools/kernel/core.py :: Kernel.__call__``): evaluate the
        derivative block for *static* orders ``ni``/``nj`` at a single pair."""
        a = derivs.normalize_multi_index(ni, self.num_dim)
        b = derivs.normalize_multi_index(nj, self.num_dim)
        return self.block_fn(a, b)(
            jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(theta)
        )

    # -- algebra ------------------------------------------------------------
    def __add__(self, other):
        if isinstance(other, Kernel):
            return SumKernel(self, other)
        return NotImplemented

    def __mul__(self, other):
        if isinstance(other, Kernel):
            return ProductKernel(self, other)
        if isinstance(other, (int, float)):
            return ScaledKernel(self, float(other))
        return NotImplemented

    __rmul__ = __mul__

    def __repr__(self):
        return f"{type(self).__name__}(num_dim={self.num_dim}, params={self.param_names})"


class _CombinedKernel(Kernel):
    """Shared plumbing for binary kernel combinations
    (``gptools/kernel/core.py :: BinaryKernel``)."""

    def __init__(self, k1: Kernel, k2: Kernel):
        if k1.num_dim != k2.num_dim:
            raise ValueError("combined kernels must share num_dim")
        self.k1 = k1
        self.k2 = k2
        names = tuple(f"k1.{n}" for n in k1.param_names) + tuple(
            f"k2.{n}" for n in k2.param_names
        )
        prior = k1.hyperprior * k2.hyperprior
        super().__init__(
            k1.num_dim,
            names,
            initial_params=k1.initial_params + k2.initial_params,
            fixed_params=k1.fixed_params + k2.fixed_params,
            param_bounds=k1.param_bounds + k2.param_bounds,
            hyperprior=prior,
        )

    def _split(self, theta):
        p1 = self.k1.num_params
        return theta[:p1], theta[p1:]


class SumKernel(_CombinedKernel):
    """``k1 + k2`` (``gptools/kernel/core.py :: SumKernel``)."""

    def smooth_scalar(self, x1, x2, theta):
        t1, t2 = self._split(theta)
        parts = []
        if self.k1.has_smooth:
            parts.append(self.k1.smooth_scalar(x1, x2, t1))
        if self.k2.has_smooth:
            parts.append(self.k2.smooth_scalar(x1, x2, t2))
        if not parts:
            return jnp.zeros((), dtype=jnp.result_type(x1, jnp.float32))
        return sum(parts[1:], parts[0])

    @property
    def has_smooth(self):
        return self.k1.has_smooth or self.k2.has_smooth

    def delta_terms(self):
        out = list(self.k1.delta_terms())
        p1 = self.k1.num_params
        out.extend((off + p1, dk) for off, dk in self.k2.delta_terms())
        return out

    def _scalar(self, x1, x2, theta):  # pragma: no cover — smooth_scalar overrides
        return self.smooth_scalar(x1, x2, theta)


class ProductKernel(_CombinedKernel):
    """``k1 * k2`` (``gptools/kernel/core.py :: ProductKernel``).

    The reference implements derivative orders of a product via the general
    Leibniz rule; autodiff gives the identical result for free.
    """

    def __init__(self, k1: Kernel, k2: Kernel):
        if k1.delta_terms() or k2.delta_terms():
            raise ValueError(
                "products involving white-noise (delta) kernels are not "
                "supported; add noise at the top level instead"
            )
        super().__init__(k1, k2)

    def _scalar(self, x1, x2, theta):
        t1, t2 = self._split(theta)
        return self.k1.smooth_scalar(x1, x2, t1) * self.k2.smooth_scalar(
            x1, x2, t2
        )


class ScaledKernel(Kernel):
    """Kernel scaled by a static positive constant (``c * k``)."""

    def __init__(self, base: Kernel, factor: float):
        if base.delta_terms():
            raise ValueError("cannot scale a kernel containing delta terms")
        self.base = base
        self.factor = float(factor)
        super().__init__(
            base.num_dim,
            base.param_names,
            initial_params=base.initial_params,
            fixed_params=base.fixed_params,
            param_bounds=base.param_bounds,
            hyperprior=base.hyperprior,
        )

    def _scalar(self, x1, x2, theta):
        return self.factor * self.base.smooth_scalar(x1, x2, theta)


class MaskedKernel(Kernel):
    """Kernel acting on a subset of the input dimensions
    (``gptools/kernel/core.py :: MaskedKernel`` [MED confidence, SURVEY.md]).

    Derivatives with respect to inactive dimensions are exactly zero, which
    autodiff reproduces automatically.
    """

    def __init__(self, base: Kernel, total_dim: int, active_dims: Sequence[int]):
        active = tuple(int(d) for d in active_dims)
        if len(active) != base.num_dim:
            raise ValueError("len(active_dims) must equal base.num_dim")
        if any(d < 0 or d >= total_dim for d in active):
            raise ValueError("active_dims out of range")
        self.base = base
        self.active_dims = active
        super().__init__(
            total_dim,
            base.param_names,
            initial_params=base.initial_params,
            fixed_params=base.fixed_params,
            param_bounds=base.param_bounds,
            hyperprior=base.hyperprior,
        )

    def _scalar(self, x1, x2, theta):
        idx = jnp.asarray(self.active_dims)
        return self.base.smooth_scalar(x1[idx], x2[idx], theta)

    def delta_terms(self):
        return self.base.delta_terms()


class ArbitraryKernel(Kernel):
    """Wrap any scalar covariance callable ``fn(x1, x2, theta)``.

    The reference (``gptools/kernel/core.py :: ArbitraryKernel``) needed
    mpmath numerical differentiation to support derivative observations for
    arbitrary covariances; here autodiff makes the wrapped callable a fully
    first-class kernel with exact derivative blocks.
    """

    def __init__(self, fn: Callable, num_dim: int, param_names, **kw):
        self.fn = fn
        super().__init__(num_dim, param_names, **kw)

    def _scalar(self, x1, x2, theta):
        return self.fn(x1, x2, theta)


class ChainRuleKernel(ArbitraryKernel):
    """Covariance of the composed form ``k(x1, x2) = outer(inner(x1, x2,
    theta), theta)`` (reference ``gptools/kernel/core.py :: ChainRuleKernel``).

    In the reference this base class existed to assemble high-order
    derivatives of compositions via Faa di Bruno / incomplete Bell polynomials
    (`gptools_tpu.utils.combinatorics` keeps those utilities for validation).
    Under autodiff the chain rule is free, so this reduces to wrapping the
    composition — kept as a named class so kernels written against the
    reference's subclassing pattern port directly.
    """

    def __init__(self, outer: Callable, inner: Callable, num_dim: int, param_names, **kw):
        self.outer = outer
        self.inner = inner
        super().__init__(
            lambda x1, x2, theta: outer(inner(x1, x2, theta), theta),
            num_dim,
            param_names,
            **kw,
        )


class ConstantKernel(Kernel):
    """Constant covariance ``k = sigma2`` (one parameter)."""

    def __init__(self, num_dim: int = 1, **kw):
        kw.setdefault("default_bounds", [(1e-8, 1e4)])
        super().__init__(num_dim, ("sigma2",), **kw)

    def _scalar(self, x1, x2, theta):
        del x1, x2
        return theta[0]


class ZeroKernel(Kernel):
    """Identically-zero kernel (``gptools/kernel/noise.py :: ZeroKernel``)."""

    def __init__(self, num_dim: int = 1):
        super().__init__(num_dim, ())

    def _scalar(self, x1, x2, theta):
        del theta
        return jnp.zeros((), dtype=jnp.result_type(x1, x2, jnp.float32))


class SquaredExponentialKernel(Kernel):
    """ARD squared exponential
    (``gptools/kernel/squared_exponential.py :: SquaredExponentialKernel``):

        k = sigma_f^2 exp( -1/2 sum_d (x1_d - x2_d)^2 / l_d^2 )

    parameters ``(sigma_f, l_1, ..., l_D)``. The reference evaluated arbitrary
    derivative orders through Hermite-polynomial closed forms; here they come
    from the autodiff tower and agree to machine precision (tested against
    finite differences and the closed forms in ``tests/test_kernels.py``).
    """

    def __init__(self, num_dim: int = 1, **kw):
        names = ("sigma_f",) + tuple(f"l_{d+1}" for d in range(num_dim))
        kw.setdefault("default_bounds", [(1e-4, 1e4)] * (num_dim + 1))
        super().__init__(num_dim, names, **kw)

    def _scalar(self, x1, x2, theta):
        sigma_f = theta[0]
        ell = theta[1 : 1 + self.num_dim]
        z = (x1 - x2) / ell
        return sigma_f * sigma_f * jnp.exp(-0.5 * jnp.sum(z * z))


def _matern_series_coeffs(p: int):
    """Exact Taylor coefficients (t0, t1, t2) of the half-integer Matern shape
    function in ``u = 2 nu r^2/l^2``:  f = t0 + t1 u + t2 u^2 + O(u^{5/2}).

    Derived from f(s) = exp(-s) * sum_j c_j s^j with s = sqrt(u) and
    c_j = p!/(2p)! * (p+i)!/(i!(p-i)!) * 2^{p-i},  j = p-i.
    """
    c = [Fraction(0)] * (p + 1)
    pref = Fraction(math.factorial(p), math.factorial(2 * p))
    for i in range(p + 1):
        j = p - i
        c[j] = pref * Fraction(
            math.factorial(p + i),
            math.factorial(i) * math.factorial(p - i),
        ) * (2 ** (p - i))
    # a_m = sum_j c_j * (-1)^(m-j) / (m-j)!   (coefficient of s^m)
    def a(m):
        tot = Fraction(0)
        for j in range(0, min(m, p) + 1):
            tot += c[j] * Fraction((-1) ** (m - j), math.factorial(m - j))
        return tot

    return float(a(0)), float(a(2)), float(a(4))


class MaternKernel(Kernel):
    """Half-integer Matern kernel, ARD
    (``gptools/kernel/matern.py :: MaternKernel`` — the reference additionally
    supports free real ``nu`` via Bessel-K chain rules; for real ``nu``
    use `gptools_tpu.ops.special.bessel_kve`-based `MaternGeneralKernel`,
    half-integer ``nu`` uses the exact closed form below):

        k = sigma_f^2 exp(-s) * P_p(s),   s = sqrt(2 nu) r,
        r^2 = sum_d (x1_d - x2_d)^2 / l_d^2,   nu = p + 1/2.

    Near r = 0 the exact expression is evaluated through its (even) Taylor
    series in ``u = s^2`` so that autodiff derivative blocks are finite and
    exact at coincident points — the spot where the reference fell back to
    mpmath precision (``gptools/kernel/matern.py``, SURVEY.md section 7.3).
    """

    _U_SWITCH = 1e-6

    def __init__(self, nu: float = 2.5, num_dim: int = 1, **kw):
        two_nu = 2.0 * nu
        if abs(two_nu - round(two_nu)) > 1e-12 or round(two_nu) % 2 == 0:
            raise NotImplementedError(
                "MaternKernel: closed form requires half-integer nu "
                "(nu = p + 1/2); for general real nu use MaternGeneralKernel"
            )
        self.nu = float(nu)
        self.p = int(round(nu - 0.5))
        if self.p == 0:
            raise NotImplementedError(
                "nu = 1/2 (exponential kernel) is not differentiable at "
                "coincident points; use MaternKernel(nu=1.5) or higher"
            )
        self._taylor = _matern_series_coeffs(self.p)
        # polynomial coefficients of P_p(s), exact rationals -> float
        pref = Fraction(math.factorial(self.p), math.factorial(2 * self.p))
        poly = [0.0] * (self.p + 1)
        for i in range(self.p + 1):
            j = self.p - i
            poly[j] = float(
                pref
                * Fraction(
                    math.factorial(self.p + i),
                    math.factorial(i) * math.factorial(self.p - i),
                )
                * (2 ** (self.p - i))
            )
        self._poly = tuple(poly)
        names = ("sigma_f",) + tuple(f"l_{d+1}" for d in range(num_dim))
        kw.setdefault("default_bounds", [(1e-4, 1e4)] * (num_dim + 1))
        super().__init__(num_dim, names, **kw)

    def _scalar(self, x1, x2, theta):
        sigma_f = theta[0]
        ell = theta[1 : 1 + self.num_dim]
        z = (x1 - x2) / ell
        u = 2.0 * self.nu * jnp.sum(z * z)
        # exact branch, evaluated at a safe argument to avoid NaN tangents
        u_safe = jnp.where(u > self._U_SWITCH, u, 1.0)
        s = jnp.sqrt(u_safe)
        poly = self._poly[self.p]
        for j in range(self.p - 1, -1, -1):
            poly = poly * s + self._poly[j]
        exact = jnp.exp(-s) * poly
        t0, t1, t2 = self._taylor
        series = t0 + u * (t1 + u * t2)
        f = jnp.where(u > self._U_SWITCH, exact, series)
        return sigma_f * sigma_f * f


class MaternGeneralKernel(Kernel):
    """Matern kernel with FREE real smoothness ``nu``, ARD:

        k = sigma_f^2 * 2^(1-nu)/Gamma(nu) * s^nu K_nu(s),   s = sqrt(2 nu) r

    parameters ``(sigma_f, nu, l_1, ..., l_D)`` — ``nu`` is a sampled
    hyperparameter, matching the reference's headline Matern feature
    (``gptools/kernel/matern.py :: MaternKernel`` with free nu, which relied
    on CPU ``scipy.special.kv`` + mpmath). Here ``K_nu`` is the quadrature
    implementation `gptools_tpu.ops.special.bessel_kve`, differentiable in
    *both* arguments, so NUTS gets exact gradients d(log evidence)/d(nu).

    Derivative observations: value, (0,1) and (1,1) blocks are exact
    everywhere for nu > 1, INCLUDING at and near coincident points: below
    ``u = 2 nu r^2 <= _U_SWITCH`` the kernel shape is evaluated through its
    two-series expansion (DLMF 10.31: analytic part + the non-analytic
    ``u^nu`` branch), whose autodiff matches the Bessel-quadrature branch
    where they meet and carries the exact finite (1,1) limit
    ``sigma_f^2 nu / (l^2 (nu - 1))`` at coincidence. For nu <= 1 the (1,1)
    block genuinely diverges at coincident points (a Matern process with
    nu <= 1 has no mean-square derivative) — value-only data remains fine.
    Near-integer nu (|nu - round(nu)| < 1e-6) is nudged off the integer
    inside the series branch, where the two series individually have poles
    that cancel (the integer-nu log limit); the induced bias is O(1e-6).
    Prefer `MaternKernel` (half-integer) when nu is fixed.
    """

    # series/quadrature switch: bessel_kve second derivatives are verified
    # accurate for u >= 1e-2 (tests/test_kernels.py near-coincidence FD
    # sweep); the 5-term series truncation error at u = 1e-2 is O(1e-12).
    _U_SWITCH = 1e-2
    _U_TINY = 1e-25  # below: drop the u^nu branch (exact-coincidence limit)
    _SERIES_M = 5

    def __init__(self, num_dim: int = 1, **kw):
        names = ("sigma_f", "nu") + tuple(f"l_{d+1}" for d in range(num_dim))
        kw.setdefault(
            "default_bounds",
            [(1e-4, 1e4), (0.51, 30.0)] + [(1e-4, 1e4)] * num_dim,
        )
        super().__init__(num_dim, names, **kw)

    def _shape_series(self, u, nu):
        """shape(u) for small u via DLMF 10.31 / 10.27.4:

            shape = sum_m (u/4)^m / (m! prod_{j<=m}(j - nu))
                  - [Gamma(1-nu)/Gamma(1+nu)] (u/4)^nu
                    * sum_m (u/4)^m / (m! prod_{j<=m}(j + nu))

        valid for non-integer nu; both series are nudged off integer nu.
        """
        # nudge nu off integers (poles of the individual series; their sum
        # has a finite log-type limit)
        r = jnp.round(nu)
        near = jnp.abs(nu - r) < 1e-6
        nu = jnp.where(near & (r >= 1.0), r + jnp.where(nu >= r, 1e-6, -1e-6), nu)

        q = 0.25 * u
        A = jnp.ones_like(u)
        B = jnp.ones_like(u)
        tA = jnp.ones_like(u)
        tB = jnp.ones_like(u)
        for m in range(1, self._SERIES_M + 1):
            tA = tA * q / (m * (m - nu))
            tB = tB * q / (m * (m + nu))
            A = A + tA
            B = B + tB
        # g = Gamma(1-nu)/Gamma(1+nu) = pi / (sin(pi nu) Gamma(nu) Gamma(1+nu))
        log_gg = jax.lax.lgamma(nu) + jax.lax.lgamma(1.0 + nu)
        g = (math.pi / jnp.sin(math.pi * nu)) * jnp.exp(-log_gg)
        # (u/4)^nu with a NaN-safe log; the contribution (and its u-tangents,
        # for nu > 1) vanishes as u -> 0, so it is masked below _U_TINY
        q_safe = jnp.maximum(q, 0.25 * self._U_TINY)
        pow_term = g * jnp.exp(nu * jnp.log(q_safe)) * B
        return A - jnp.where(u > self._U_TINY, pow_term, 0.0)

    def _scalar(self, x1, x2, theta):
        from gptools_tpu.ops.special import bessel_kve

        sigma_f, nu = theta[0], theta[1]
        ell = theta[2 : 2 + self.num_dim]
        z = (x1 - x2) / ell
        u = 2.0 * nu * jnp.sum(z * z)
        u_safe = jnp.where(u > self._U_SWITCH, u, self._U_SWITCH)
        s = jnp.sqrt(u_safe)
        # 2^(1-nu)/Gamma(nu) s^nu K_nu(s); log-space for the prefactor
        log_pref = (1.0 - nu) * math.log(2.0) - jax.lax.lgamma(nu) + nu * jnp.log(s) - s
        shape_exact = jnp.exp(log_pref) * bessel_kve(nu, s)
        shape = jnp.where(
            u > self._U_SWITCH, shape_exact, self._shape_series(u, nu)
        )
        return sigma_f * sigma_f * shape


class Matern52Kernel(MaternKernel):
    """Fixed nu = 5/2 Matern (``gptools/kernel/matern.py :: Matern52Kernel``,
    the reference's hard-coded fast variant with values + first derivatives;
    here *all* derivative orders come from autodiff)."""

    def __init__(self, num_dim: int = 1, **kw):
        super().__init__(nu=2.5, num_dim=num_dim, **kw)


# Reference-name alias (``gptools/kernel/matern.py :: MaternKernelArb``): the
# reference's arbitrary-precision mpmath variant for free/real nu. Its role —
# "Matern whose nu is an inferred hyperparameter, whatever the derivative
# cost" — is played here by the differentiable-quadrature Bessel-K kernel.
MaternKernelArb = MaternGeneralKernel


class RationalQuadraticKernel(Kernel):
    """ARD rational quadratic
    (``gptools/kernel/rational_quadratic.py :: RationalQuadraticKernel``):

        k = sigma_f^2 (1 + r^2 / (2 alpha))^(-alpha),
        r^2 = sum_d (x1_d - x2_d)^2 / l_d^2

    parameters ``(sigma_f, alpha, l_1, ..., l_D)``. Smooth in r^2, so
    derivative blocks need no special-casing anywhere.
    """

    def __init__(self, num_dim: int = 1, **kw):
        names = ("sigma_f", "alpha") + tuple(f"l_{d+1}" for d in range(num_dim))
        kw.setdefault("default_bounds", [(1e-4, 1e4)] * (num_dim + 2))
        super().__init__(num_dim, names, **kw)

    def _scalar(self, x1, x2, theta):
        sigma_f, alpha = theta[0], theta[1]
        ell = theta[2 : 2 + self.num_dim]
        z = (x1 - x2) / ell
        r2 = jnp.sum(z * z)
        return sigma_f * sigma_f * jnp.exp(
            -alpha * jnp.log1p(r2 / (2.0 * alpha))
        )


# ---------------------------------------------------------------------------
# Gibbs nonstationary kernel + length-scale warps
# ---------------------------------------------------------------------------


class LengthScaleWarp:
    """Length-scale profile ``l(x) > 0`` for the Gibbs kernel.

    Counterpart of the warp functions in ``gptools/kernel/gibbs.py``
    (``tanh_warp`` and friends). Static object; parameters flow via theta.
    """

    param_names: Tuple[str, ...]
    default_bounds: Tuple[tuple, ...]

    @property
    def num_params(self):
        return len(self.param_names)

    def __call__(self, x, theta):
        """x: scalar input coordinate; theta: (num_params,) -> l(x) scalar."""
        raise NotImplementedError


class TanhWarp(LengthScaleWarp):
    """The flagship pedestal/edge warp
    (``gptools/kernel/gibbs.py :: GibbsKernel1dTanh``, ``tanh_warp``):

        l(x) = l1 + (l2 - l1)/2 * (1 + tanh((x - x0) / lw))

    parameters ``(l1, l2, lw, x0)``: core length scale, edge length scale,
    transition width, transition location.
    """

    param_names = ("l1", "l2", "lw", "x0")
    default_bounds = ((1e-4, 1e4), (1e-4, 1e4), (1e-4, 1e4), (-1e4, 1e4))

    def __call__(self, x, theta):
        l1, l2, lw, x0 = theta[0], theta[1], theta[2], theta[3]
        return l1 + 0.5 * (l2 - l1) * (1.0 + jnp.tanh((x - x0) / lw))


class GaussWarp(LengthScaleWarp):
    """Gaussian dip/bump warp (``gptools/kernel/gibbs.py`` gauss-style warp
    [MED confidence, SURVEY.md]):

        l(x) = l1 - (l1 - l2) * exp(-(x - x0)^2 / (2 lw^2))

    i.e. baseline ``l1`` with a localized excursion to ``l2`` at ``x0``.
    """

    param_names = ("l1", "l2", "lw", "x0")
    default_bounds = ((1e-4, 1e4), (1e-4, 1e4), (1e-4, 1e4), (-1e4, 1e4))

    def __call__(self, x, theta):
        l1, l2, lw, x0 = theta[0], theta[1], theta[2], theta[3]
        z = (x - x0) / lw
        return l1 - (l1 - l2) * jnp.exp(-0.5 * z * z)


class ExpWarp(LengthScaleWarp):
    """Exponential-in-x warp: ``l(x) = l0 * exp(x / s)`` with softplus guard.

    parameters ``(l0, s)``.
    """

    param_names = ("l0", "s")
    default_bounds = ((1e-4, 1e4), (1e-4, 1e4))

    def __call__(self, x, theta):
        l0, s = theta[0], theta[1]
        return l0 * jnp.exp(x / s)


class InterpolatedWarp(LengthScaleWarp):
    """Smooth (cubic-Hermite) interpolation of length-scale knot values at
    fixed knot locations (the spline-style warp family of
    ``gptools/kernel/gibbs.py`` [MED confidence, SURVEY.md]).

    Knot *locations* are static; knot *values* are the hyperparameters, so
    NUTS can infer a free-form smooth l(x) profile. Outside the knot span the
    profile is held constant (clamped).
    """

    def __init__(self, knots: Sequence[float]):
        self.knots = tuple(float(v) for v in knots)
        if len(self.knots) < 2:
            raise ValueError("need >= 2 knots")
        if any(b <= a for a, b in zip(self.knots, self.knots[1:])):
            raise ValueError("knots must be strictly increasing")
        self.param_names = tuple(f"l_knot_{i}" for i in range(len(self.knots)))
        self.default_bounds = ((1e-4, 1e4),) * len(self.knots)

    def __call__(self, x, theta):
        xs = jnp.asarray(self.knots, dtype=jnp.result_type(x, jnp.float32))
        n = len(self.knots)
        xq = jnp.clip(x, xs[0], xs[-1])
        i = jnp.clip(jnp.searchsorted(xs, xq, side="right") - 1, 0, n - 2)
        x0, x1 = xs[i], xs[i + 1]
        h = x1 - x0
        t = (xq - x0) / h
        y0, y1 = theta[i], theta[i + 1]
        # Catmull-Rom tangents with one-sided ends (clamped knot indexing)
        im1 = jnp.maximum(i - 1, 0)
        ip2 = jnp.minimum(i + 2, n - 1)
        m0 = (theta[i + 1] - theta[im1]) / (xs[i + 1] - xs[im1])
        m1 = (theta[ip2] - theta[i]) / (xs[ip2] - xs[i])
        t2 = t * t
        t3 = t2 * t
        h00 = 2 * t3 - 3 * t2 + 1
        h10 = t3 - 2 * t2 + t
        h01 = -2 * t3 + 3 * t2
        h11 = t3 - t2
        return h00 * y0 + h10 * h * m0 + h01 * y1 + h11 * h * m1


class GibbsKernel(Kernel):
    """Gibbs nonstationary covariance with input-dependent length scale
    (``gptools/kernel/gibbs.py``):

        k(x1, x2) = sigma_f^2 sqrt( 2 l(x1) l(x2) / (l(x1)^2 + l(x2)^2) )
                    * exp( -(x1 - x2)^2 / (l(x1)^2 + l(x2)^2) )

    1-D only, like the reference. The warp ``l(x)`` is pluggable; parameters
    are ``(sigma_f,) + warp params``. Everything (including the slope
    constraints of the flagship pedestal fits) differentiates cleanly through
    autodiff — the place where the reference needed mpmath
    (SURVEY.md section 7.3 "hard parts").
    """

    def __init__(self, warp: LengthScaleWarp, **kw):
        self.warp = warp
        names = ("sigma_f",) + tuple(warp.param_names)
        kw.setdefault(
            "default_bounds", ((1e-4, 1e4),) + tuple(warp.default_bounds)
        )
        super().__init__(1, names, **kw)

    def _scalar(self, x1, x2, theta):
        sigma_f = theta[0]
        tw = theta[1:]
        l1 = self.warp(x1[0], tw)
        l2 = self.warp(x2[0], tw)
        s2 = l1 * l1 + l2 * l2
        d = x1[0] - x2[0]
        return (
            sigma_f
            * sigma_f
            * jnp.sqrt(2.0 * l1 * l2 / s2)
            * jnp.exp(-d * d / s2)
        )


class GibbsKernel1dTanh(GibbsKernel):
    """``gptools/kernel/gibbs.py :: GibbsKernel1dTanh`` — the flagship
    nonstationary kernel for tokamak pedestal profile fits. Parameters
    ``(sigma_f, l1, l2, lw, x0)``."""

    def __init__(self, **kw):
        super().__init__(TanhWarp(), **kw)


class GibbsKernel1dGauss(GibbsKernel):
    """Gibbs kernel with `GaussWarp` length scale."""

    def __init__(self, **kw):
        super().__init__(GaussWarp(), **kw)


class GibbsKernel1dExp(GibbsKernel):
    """Gibbs kernel with `ExpWarp` length scale."""

    def __init__(self, **kw):
        super().__init__(ExpWarp(), **kw)


# ---------------------------------------------------------------------------
# White noise
# ---------------------------------------------------------------------------


class DiagonalNoiseKernel(Kernel):
    """White (delta-correlated) noise attached to observations of a given
    derivative order (``gptools/kernel/noise.py :: DiagonalNoiseKernel``):

        k((x1, n1), (x2, n2)) = sigma_n^2 * delta(x1, x2) * delta(n1, n2)
                                 [* delta(n1, n_match) if n_match is not None]

    Not differentiable, so it contributes nothing to the smooth scalar; the
    assembly layer (`gptools_tpu.ops.assemble.delta_matrix`) adds it on
    exactly-matching index pairs.
    """

    has_smooth = False

    def __init__(self, num_dim: int = 1, n=None, **kw):
        self.n_match = (
            None if n is None else derivs.normalize_multi_index(n, num_dim)
        )
        kw.setdefault("default_bounds", [(0.0, 1e4)])
        super().__init__(num_dim, ("sigma_n",), **kw)

    def _scalar(self, x1, x2, theta):
        # The smooth part of white noise is identically zero.
        del theta
        return jnp.zeros((), dtype=jnp.result_type(x1, x2, jnp.float32))

    def delta_terms(self):
        return [(0, self)]

    def delta_value(self, theta):
        """Variance added on matching diagonal entries."""
        return theta[0] * theta[0]


# ---------------------------------------------------------------------------
# Input warping (gptools/kernel/warping.py)
# ---------------------------------------------------------------------------


class InputWarp:
    """Monotone coordinate map ``w(x)`` applied per input dimension
    (``gptools/kernel/warping.py`` warp-function classes)."""

    param_names: Tuple[str, ...] = ()
    default_bounds: Tuple[tuple, ...] = ()

    @property
    def num_params(self):
        return len(self.param_names)

    def __call__(self, x, theta):
        raise NotImplementedError


class LinearWarp(InputWarp):
    """Affine map ``w(x) = (x - a) / (b - a)`` onto [0, 1]; static a, b."""

    def __init__(self, a: float, b: float):
        self.a = float(a)
        self.b = float(b)

    def __call__(self, x, theta):
        del theta
        return (x - self.a) / (self.b - self.a)


class BetaWarp(InputWarp):
    """Beta-CDF warp on [0, 1] (``gptools/kernel/warping.py :: BetaWarp``):
    ``w(x) = I_x(a, b)`` (regularized incomplete beta), parameters (a, b).

    Uses the quadrature-based, fully differentiable incomplete beta from
    `gptools_tpu.ops.special` (differentiable in x *and* in (a, b), which the
    library betainc gradient rules do not provide).
    """

    param_names = ("a", "b")
    default_bounds = ((1e-2, 1e2), (1e-2, 1e2))

    def __call__(self, x, theta):
        from gptools_tpu.ops.special import betainc_dd

        return betainc_dd(theta[0], theta[1], x)


class ArbitraryWarp(InputWarp):
    """Wrap any callable ``w(x, theta)``."""

    def __init__(self, fn: Callable, param_names=(), default_bounds=()):
        self.fn = fn
        self.param_names = tuple(param_names)
        self.default_bounds = tuple(default_bounds)

    def __call__(self, x, theta):
        return self.fn(x, theta)


class WarpedKernel(Kernel):
    """Kernel evaluated on warped inputs: ``k(w(x1), w(x2))``
    (``gptools/kernel/warping.py :: WarpedKernel``).

    One warp object; its map is applied elementwise to every input dimension
    and its parameters are appended after the base kernel's. The reference
    propagated derivative orders through the warp with the chain rule
    (Faa di Bruno); autodiff does that implicitly and exactly.
    """

    def __init__(self, base: Kernel, warp: InputWarp, **kw):
        if base.delta_terms():
            raise ValueError("cannot warp a kernel containing delta terms")
        self.base = base
        self.input_warp = warp
        names = base.param_names + tuple(
            f"warp.{n}" for n in warp.param_names
        )
        kw.setdefault(
            "initial_params",
            base.initial_params
            + tuple(
                Kernel._default_initial(lo, hi) for lo, hi in warp.default_bounds
            ),
        )
        kw.setdefault(
            "fixed_params", base.fixed_params + (False,) * warp.num_params
        )
        kw.setdefault(
            "param_bounds", list(base.param_bounds) + list(warp.default_bounds)
        )
        super().__init__(base.num_dim, names, **kw)

    def _scalar(self, x1, x2, theta):
        pb = self.base.num_params
        tb, tw = theta[:pb], theta[pb:]
        w1 = jnp.stack([self.input_warp(x1[d], tw) for d in range(self.num_dim)])
        w2 = jnp.stack([self.input_warp(x2[d], tw) for d in range(self.num_dim)])
        return self.base.smooth_scalar(w1, w2, tb)
