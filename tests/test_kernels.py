"""Kernel-zoo correctness: values vs closed forms, derivative blocks vs
finite differences (the oracle strategy prescribed in SURVEY.md section 4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gptools_tpu.ops import kernels as K
from gptools_tpu.ops.derivs import kernel_block_fn


def fd_block(scalar, x1, x2, theta, a, b, h=1e-5):
    """Finite-difference mixed partial d^a_x1 d^b_x2 k (central, nested)."""

    def f(x1v, x2v):
        return float(scalar(jnp.asarray(x1v), jnp.asarray(x2v), jnp.asarray(theta)))

    def diff(fun, idx, which):
        def d(x1v, x2v):
            e = np.zeros_like(x1v if which == 0 else x2v)
            e[idx] = h
            if which == 0:
                return (fun(x1v + e, x2v) - fun(x1v - e, x2v)) / (2 * h)
            return (fun(x1v, x2v + e) - fun(x1v, x2v - e)) / (2 * h)

        return d

    fun = f
    for d_, order in enumerate(a):
        for _ in range(order):
            fun = diff(fun, d_, 0)
    for d_, order in enumerate(b):
        for _ in range(order):
            fun = diff(fun, d_, 1)
    return fun(np.asarray(x1, float), np.asarray(x2, float))


SE = K.SquaredExponentialKernel(num_dim=1)
SE2 = K.SquaredExponentialKernel(num_dim=2)
M52 = K.Matern52Kernel(num_dim=1)
M32 = K.MaternKernel(nu=1.5, num_dim=1)
RQ = K.RationalQuadraticKernel(num_dim=1)
GIBBS = K.GibbsKernel1dTanh()


def test_se_value_closed_form():
    theta = jnp.array([2.0, 0.7])
    x1 = jnp.array([0.3])
    x2 = jnp.array([1.1])
    got = SE.smooth_scalar(x1, x2, theta)
    want = 4.0 * np.exp(-0.5 * (0.8 / 0.7) ** 2)
    assert np.isclose(float(got), want, rtol=1e-12)


def test_se_derivative_closed_forms():
    """SE derivative blocks vs the Hermite-polynomial closed forms the
    reference hard-coded (gptools/kernel/squared_exponential.py):
    d/dx1 k = -(x1-x2)/l^2 k ; d2/dx1 dx2 k = (1 - (x1-x2)^2/l^2) k / l^2."""
    sf, l = 1.7, 0.6
    theta = jnp.array([sf, l])
    x1 = jnp.array([0.2])
    x2 = jnp.array([0.9])
    d = 0.2 - 0.9
    k0 = sf**2 * np.exp(-0.5 * d**2 / l**2)
    d10 = kernel_block_fn(SE.smooth_scalar, (1,), (0,))(x1, x2, theta)
    assert np.isclose(float(d10), -d / l**2 * k0, rtol=1e-10)
    d11 = kernel_block_fn(SE.smooth_scalar, (1,), (1,))(x1, x2, theta)
    assert np.isclose(float(d11), (1 - d**2 / l**2) * k0 / l**2, rtol=1e-10)
    # second-order: d2/dx1^2 k = (d^2/l^2 - 1) k / l^2
    d20 = kernel_block_fn(SE.smooth_scalar, (2,), (0,))(x1, x2, theta)
    assert np.isclose(float(d20), (d**2 / l**2 - 1) * k0 / l**2, rtol=1e-10)


@pytest.mark.parametrize(
    "kern,theta",
    [
        (SE, [1.3, 0.8]),
        (M52, [1.1, 0.9]),
        (RQ, [1.2, 1.7, 0.8]),
        (GIBBS, [1.5, 0.4, 0.1, 0.2, 0.6]),
    ],
)
@pytest.mark.parametrize("ab", [((0,), (0,)), ((1,), (0,)), ((0,), (1,)), ((1,), (1,)), ((2,), (1,))])
def test_deriv_blocks_match_finite_differences(kern, theta, ab):
    a, b = ab
    theta = jnp.asarray(theta, jnp.float64)
    x1 = jnp.array([0.31], jnp.float64)
    x2 = jnp.array([0.74], jnp.float64)
    got = float(kern.block_fn(a, b)(x1, x2, theta))
    order = sum(a) + sum(b)
    h = 1e-5 if order <= 2 else 1e-3
    want = fd_block(kern.smooth_scalar, x1, x2, theta, a, b, h=h)
    rtol = 2e-4 if order <= 2 else 2e-3
    assert np.isclose(got, want, rtol=rtol, atol=5e-6), (got, want)


def test_se2d_ard_mixed_dims_fd():
    theta = jnp.array([1.4, 0.8, 1.3])
    x1 = jnp.array([0.3, -0.2])
    x2 = jnp.array([0.6, 0.5])
    a, b = (1, 0), (0, 1)
    got = float(SE2.block_fn(a, b)(x1, x2, theta))
    want = fd_block(SE2.smooth_scalar, x1, x2, theta, a, b)
    assert np.isclose(got, want, rtol=1e-5)


def test_matern_value_matches_scipy():
    from scipy.special import kv, gamma

    for nu, kern in [(1.5, M32), (2.5, M52)]:
        sf, l = 1.3, 0.7
        theta = jnp.array([sf, l])
        for dist in [0.05, 0.4, 2.3]:
            x1 = jnp.array([0.0])
            x2 = jnp.array([dist])
            got = float(kern.smooth_scalar(x1, x2, theta))
            s = np.sqrt(2 * nu) * dist / l
            want = sf**2 * (2 ** (1 - nu) / gamma(nu)) * s**nu * kv(nu, s)
            assert np.isclose(got, want, rtol=1e-9), (nu, dist)


def test_matern_coincident_derivatives_finite_and_correct():
    """(1,1) block at x1 == x2 must equal 2*nu/((2*nu-2) l^2) * sigma^2
    (= -k''(0), the derivative-process variance)."""
    sf, l = 1.2, 0.8
    theta = jnp.array([sf, l])
    x = jnp.array([0.4])
    for nu, kern in [(2.5, M52)]:
        got = float(kern.block_fn((1,), (1,))(x, x, theta))
        want = sf**2 * nu / (nu - 1.0) / l**2  # -k''(0) for Matern
        assert np.isfinite(got)
        assert np.isclose(got, want, rtol=1e-8), (got, want)
    # value at coincidence is sigma_f^2
    assert np.isclose(float(M52.smooth_scalar(x, x, theta)), sf**2, rtol=1e-12)


def test_gibbs_value_closed_form():
    sf, l1, l2, lw, x0 = 1.5, 0.4, 0.1, 0.2, 0.6
    theta = jnp.array([sf, l1, l2, lw, x0])

    def lx(x):
        return l1 + 0.5 * (l2 - l1) * (1 + np.tanh((x - x0) / lw))

    xa, xb = 0.3, 0.8
    la, lb = lx(xa), lx(xb)
    want = (
        sf**2
        * np.sqrt(2 * la * lb / (la**2 + lb**2))
        * np.exp(-((xa - xb) ** 2) / (la**2 + lb**2))
    )
    got = float(GIBBS.smooth_scalar(jnp.array([xa]), jnp.array([xb]), theta))
    assert np.isclose(got, want, rtol=1e-12)


def test_kernel_algebra_sum_product():
    ksum = SE + M52
    kprod = SE * M52
    theta = jnp.array([1.3, 0.8, 1.1, 0.9])
    x1 = jnp.array([0.2])
    x2 = jnp.array([0.5])
    vs = float(SE.smooth_scalar(x1, x2, theta[:2]))
    vm = float(M52.smooth_scalar(x1, x2, theta[2:]))
    assert np.isclose(float(ksum.smooth_scalar(x1, x2, theta)), vs + vm)
    assert np.isclose(float(kprod.smooth_scalar(x1, x2, theta)), vs * vm)
    # product-rule derivative via autodiff == finite differences
    got = float(kprod.block_fn((1,), (1,))(x1, x2, theta))
    want = fd_block(kprod.smooth_scalar, x1, x2, theta, (1,), (1,))
    assert np.isclose(got, want, rtol=1e-5)
    assert ksum.num_params == 4
    # scaling
    k2 = 2.5 * SE
    assert np.isclose(float(k2.smooth_scalar(x1, x2, theta[:2])), 2.5 * vs)


def test_masked_kernel_inactive_dims_zero_derivative():
    km = K.MaskedKernel(SE, total_dim=2, active_dims=[0])
    theta = jnp.array([1.3, 0.8])
    x1 = jnp.array([0.2, 5.0])
    x2 = jnp.array([0.5, -3.0])
    # value only depends on dim 0
    v = float(km.smooth_scalar(x1, x2, theta))
    assert np.isclose(v, float(SE.smooth_scalar(x1[:1], x2[:1], theta)))
    # derivative w.r.t. dim 1 is exactly zero
    d = float(km.block_fn((0, 1), (0, 0))(x1, x2, theta))
    assert d == 0.0


def test_warped_kernel_chain_rule():
    warp = K.LinearWarp(0.0, 2.0)
    kw = K.WarpedKernel(SE, warp)
    theta = jnp.array([1.3, 0.8])
    x1 = jnp.array([0.2])
    x2 = jnp.array([0.5])
    want = float(SE.smooth_scalar(x1 / 2.0, x2 / 2.0, theta))
    assert np.isclose(float(kw.smooth_scalar(x1, x2, theta)), want)
    # chain rule: d/dx1 k(w(x1), w(x2)) = (1/2) * k'(...)
    d = float(kw.block_fn((1,), (0,))(x1, x2, theta))
    d_base = float(SE.block_fn((1,), (0,))(x1 / 2.0, x2 / 2.0, theta))
    assert np.isclose(d, 0.5 * d_base, rtol=1e-10)


def test_interpolated_warp_values_and_smoothness():
    w = K.InterpolatedWarp([0.0, 0.5, 1.0])
    theta = jnp.array([0.3, 0.6, 0.2])
    # hits knot values exactly
    for x, v in [(0.0, 0.3), (0.5, 0.6), (1.0, 0.2)]:
        assert np.isclose(float(w(jnp.asarray(x), theta)), v, atol=1e-12)
    # differentiable in between
    g = jax.grad(lambda x: w(x, theta))(jnp.asarray(0.25))
    assert np.isfinite(float(g))


def test_arbitrary_kernel_autodiff():
    fn = lambda x1, x2, th: th[0] * jnp.exp(-jnp.sum((x1 - x2) ** 2) / th[1])
    ka = K.ArbitraryKernel(fn, num_dim=1, param_names=("amp", "s"))
    theta = jnp.array([2.0, 0.5])
    x1 = jnp.array([0.1])
    x2 = jnp.array([0.4])
    got = float(ka.block_fn((1,), (1,))(x1, x2, theta))
    want = fd_block(ka.smooth_scalar, x1, x2, theta, (1,), (1,))
    assert np.isclose(got, want, rtol=1e-5)


def test_matern_general_free_nu():
    """Free-nu Matern matches scipy closed form and has finite nu-gradient."""
    from scipy.special import kv, gamma

    kg = K.MaternGeneralKernel()
    sf, nu, l = 1.2, 1.8, 0.6
    theta = jnp.array([sf, nu, l])
    x1 = jnp.array([0.1])
    x2 = jnp.array([0.8])
    got = float(kg.smooth_scalar(x1, x2, theta))
    s = np.sqrt(2 * nu) * 0.7 / l
    want = sf**2 * 2 ** (1 - nu) / gamma(nu) * s**nu * kv(nu, s)
    assert np.isclose(got, want, rtol=1e-6)
    # value at coincidence -> sigma^2
    assert np.isclose(float(kg.smooth_scalar(x1, x1, theta)), sf**2, rtol=1e-5)
    # gradient w.r.t. nu vs finite differences
    g = jax.grad(lambda t: kg.smooth_scalar(x1, x2, t))(theta)
    h = 1e-5
    fd = (
        float(kg.smooth_scalar(x1, x2, theta.at[1].add(h)))
        - float(kg.smooth_scalar(x1, x2, theta.at[1].add(-h)))
    ) / (2 * h)
    assert np.isclose(float(g[1]), fd, rtol=1e-4)
    # half-integer consistency: nu=2.5 equals Matern52
    t52 = jnp.array([sf, 2.5, l])
    v1 = float(kg.smooth_scalar(x1, x2, t52))
    v2 = float(M52.smooth_scalar(x1, x2, jnp.array([sf, l])))
    assert np.isclose(v1, v2, rtol=1e-7)


def test_chain_rule_kernel_matches_se():
    """ChainRuleKernel(outer, inner) == SE when outer=exp, inner=-r^2/2l^2 —
    values AND autodiff derivative blocks (the reference assembled these with
    Faa di Bruno; here the chain rule is free)."""
    outer = lambda u, th: th[0] ** 2 * jnp.exp(u)
    inner = lambda x1, x2, th: -jnp.sum((x1 - x2) ** 2) / (2 * th[1] ** 2)
    kc = K.ChainRuleKernel(outer, inner, num_dim=1, param_names=("sf", "l"))
    kse = K.SquaredExponentialKernel()
    theta = jnp.array([1.3, 0.7])
    x1 = jnp.array([0.2])
    x2 = jnp.array([0.9])
    for ni, nj in [((0,), (0,)), ((1,), (0,)), ((1,), (1,)), ((2,), (1,))]:
        got = float(kc.block_fn(ni, nj)(x1, x2, theta))
        want = float(kse.block_fn(ni, nj)(x1, x2, theta))
        assert np.isclose(got, want, rtol=1e-6), (ni, nj)


@pytest.mark.slow
def test_matern_general_derivative_blocks_near_coincidence():
    """(0,1)/(1,1) blocks of the free-nu Matern vs finite differences and the
    analytic coincidence limit, INCLUDING the near-coincident band that the
    first implementation got wrong (the exact-Bessel branch produced O(1e4) garbage for u in (1e-8, 1e-4) and the small-u
    guard clamped nu-1 at 0.25, breaking the nu < 1.25 limit)."""
    kg = K.MaternGeneralKernel()

    def k00(x1, x2, th):
        return kg.smooth_scalar(jnp.asarray([x1]), jnp.asarray([x2]), th)

    k01 = jax.grad(k00, argnums=1)
    k11 = jax.grad(jax.grad(k00, argnums=0), argnums=1)

    for nu in [1.2, 1.5, 2.0, 2.3, 5.7]:
        sf, ell = 1.3, 0.7
        th = jnp.asarray([sf, nu, ell])
        # exact coincidence: k11 -> sf^2 nu / (ell^2 (nu - 1))
        lim = sf**2 * nu / (ell**2 * (nu - 1.0))
        got = float(k11(0.5, 0.5, th))
        assert np.isclose(got, lim, rtol=2e-6), (nu, got, lim)
        # FD sweep across the series/quadrature switch (u = 2 nu (d/l)^2)
        f = lambda a, b: float(k00(a, b, th))
        for d in [1e-5, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.5]:
            h = max(min(1e-4, d / 4), 1e-6)
            fd11 = (
                (f(0.5 + h, 0.5 + d + h) - f(0.5 + h, 0.5 + d - h))
                - (f(0.5 - h, 0.5 + d + h) - f(0.5 - h, 0.5 + d - h))
            ) / (4 * h * h)
            fd01 = (f(0.5, 0.5 + d + h) - f(0.5, 0.5 + d - h)) / (2 * h)
            assert np.isclose(float(k11(0.5, 0.5 + d, th)), fd11, rtol=1e-3), (nu, d)
            assert np.isclose(float(k01(0.5, 0.5 + d, th)), fd01, rtol=1e-3), (nu, d)


def test_matern_general_series_quadrature_branches_agree():
    """The two shape branches agree (value AND second derivative) where they
    meet; validated absolutely against mpmath in round-2 dev (series 1e-15,
    quadrature <= 2e-7 at u = _U_SWITCH)."""
    kg = K.MaternGeneralKernel()
    u_sw = kg._U_SWITCH

    def shape_series(u, nu):
        return kg._shape_series(jnp.asarray(u), jnp.asarray(nu))

    from gptools_tpu.ops.special import bessel_kve

    def shape_exact(u, nu):
        s = jnp.sqrt(u)
        import math as _m

        log_pref = (
            (1.0 - nu) * _m.log(2.0) - jax.lax.lgamma(nu) + nu * jnp.log(s) - s
        )
        return jnp.exp(log_pref) * bessel_kve(nu, s)

    for nu in [1.2, 1.9999995, 2.3, 5.7, 11.4]:
        for u in [u_sw, 2 * u_sw]:
            a = float(shape_series(u, nu))
            b = float(shape_exact(u, nu))
            assert np.isclose(a, b, rtol=5e-6), (nu, u, a, b)
            da = float(jax.grad(shape_series)(u, nu))
            db = float(jax.grad(shape_exact)(u, nu))
            # 5e-3 bounds the QUADRATURE branch's derivative error at the
            # switch (the series side is mpmath-exact; quadrature du-grad
            # error grows with nu: ~4e-4 at nu=5.7, ~3e-3 at nu=11.4) —
            # still orders below the r1 failure mode, and values (which the
            # MCMC accept step uses) agree to 5e-6
            assert np.isclose(da, db, rtol=5e-3), (nu, u, da, db)


@pytest.mark.slow
def test_matern_general_dll_dnu_through_evidence():
    """d(log evidence)/d(nu) through the full GP evidence (with coincident
    and near-coincident derivative observations in the data) matches finite
    differences — the gradient NUTS consumes when nu is sampled."""
    from gptools_tpu.models.dataset import DatasetBuilder
    from gptools_tpu.models.gp import GPModel
    from gptools_tpu.utils.priors import LogNormalJointPrior

    rng = np.random.default_rng(3)
    X = np.linspace(0, 2, 9)
    b = DatasetBuilder(1)
    b.add(X, np.sin(X) + 0.05 * rng.standard_normal(9), err_y=0.05)
    # slope observations, one at a value-observation location (coincident)
    b.add(np.array([0.0, 1.0]), np.array([1.0, 0.5]), err_y=0.05, n=1)
    data = b.build()
    prior = (
        LogNormalJointPrior([0.0], [1.0])
        * LogNormalJointPrior([0.6], [0.5])  # nu
        * LogNormalJointPrior([-0.5], [1.0])
    )
    model = GPModel(K.MaternGeneralKernel(hyperprior=prior))

    theta = jnp.asarray([1.1, 1.7, 0.8])
    g = jax.grad(lambda t: model.log_marginal(t, data))(theta)
    h = 1e-5
    for i in range(3):
        fd = (
            float(model.log_marginal(theta.at[i].add(h), data))
            - float(model.log_marginal(theta.at[i].add(-h), data))
        ) / (2 * h)
        assert np.isclose(float(g[i]), fd, rtol=5e-4, atol=1e-7), (i, float(g[i]), fd)


def test_matern_general_integer_nudge_bias():
    """The integer-nu nudge (|nu - round(nu)| < 1e-6 is
    moved to round(nu) +- 1e-6 inside the series branch) must induce only an
    O(1e-6)-relative VALUE bias. Check: shape(u, nu) across nu = 2 +- {5,2,0}
    e-6 lies on a line (the true shape is analytic in nu across integers),
    with the nudged nu=2.0 point off the line by at most ~|slope| * 1.5e-6;
    and the full evidence at nu exactly 2.0 is bracketed by its un-nudged
    neighbors at 2 +- 2e-6 to the same order."""
    kg = K.MaternGeneralKernel()
    u = 5e-3  # inside the series branch (u < _U_SWITCH)

    def shape(nu):
        return float(kg._shape_series(jnp.asarray(u), jnp.asarray(float(nu))))

    # slope of shape in nu from clearly-un-nudged points
    s_lo, s_hi = shape(2 - 5e-6), shape(2 + 5e-6)
    slope = (s_hi - s_lo) / 1e-5
    line = lambda nu: s_lo + slope * (nu - (2 - 5e-6))
    for nu, tol_units in [(2 - 2e-6, 0.1), (2 + 2e-6, 0.1), (2.0, 1.5)]:
        bias = abs(shape(nu) - line(nu))
        assert bias <= abs(slope) * tol_units * 1e-6 + 1e-14, (nu, bias, slope)

    # evidence level, with a coincident derivative observation in the data
    from gptools_tpu.models.dataset import DatasetBuilder
    from gptools_tpu.models.gp import GPModel
    from gptools_tpu.utils.priors import (
        LogNormalJointPrior,
        UniformJointPrior,
    )

    rng = np.random.default_rng(5)
    X = np.linspace(0, 2, 9)
    b = DatasetBuilder(1)
    b.add(X, np.sin(X) + 0.05 * rng.standard_normal(9), err_y=0.05)
    b.add(np.array([0.0, 1.0]), np.array([1.0, 0.5]), err_y=0.05, n=1)
    data = b.build()
    prior = (
        LogNormalJointPrior([0.0], [1.0])
        * UniformJointPrior([1.01], [30.0])  # nu > 1: deriv obs require it
        * LogNormalJointPrior([-0.5], [1.0])
    )
    model = GPModel(K.MaternGeneralKernel(hyperprior=prior))

    def ll(nu):
        return float(model.log_marginal(jnp.asarray([1.1, nu, 0.8]), data))

    lo, mid, hi = ll(2 - 2e-6), ll(2.0), ll(2 + 2e-6)
    dll = (hi - lo) / 4e-6  # local dll/dnu
    assert abs(hi - lo) <= abs(dll) * 4e-6 * 1.5 + 1e-9
    # nudged midpoint within ~2e-6 * |dll/dnu| of either neighbor
    assert abs(mid - 0.5 * (lo + hi)) <= abs(dll) * 2.0e-6 + 1e-9, (
        lo, mid, hi, dll,
    )
    # and the autodiff dll/dnu NEXT to the nudge zone matches the local FD
    g = jax.grad(lambda t: model.log_marginal(t, data))(
        jnp.asarray([1.1, 2 + 2e-6, 0.8])
    )
    assert np.isclose(float(g[1]), dll, rtol=5e-3), (float(g[1]), dll)


def test_matern_general_deriv_obs_nu_support_warning():
    """A free-nu Matern model whose nu prior/bounds admit
    nu <= 1 must hard-warn when evaluated on derivative observations (the
    (1,1) block diverges at coincidence for nu <= 1); a nu-safe prior must
    not warn."""
    import warnings

    from gptools_tpu.models.dataset import DatasetBuilder
    from gptools_tpu.models.gp import GPModel
    from gptools_tpu.utils.priors import (
        LogNormalJointPrior,
        UniformJointPrior,
    )

    b = DatasetBuilder(1)
    b.add(np.linspace(0, 1, 6), np.zeros(6), err_y=0.1)
    b.add(np.array([0.0]), np.array([0.0]), err_y=0.1, n=1)
    data_deriv = b.build()
    b2 = DatasetBuilder(1)
    b2.add(np.linspace(0, 1, 6), np.zeros(6), err_y=0.1)
    data_valonly = b2.build()

    loose = (
        LogNormalJointPrior([0.0], [1.0])
        * LogNormalJointPrior([0.6], [0.5])  # support (0, inf): admits nu<=1
        * LogNormalJointPrior([-0.5], [1.0])
    )
    theta = jnp.asarray([1.1, 1.7, 0.8])
    with pytest.warns(UserWarning, match="nu > 1"):
        m = GPModel(K.MaternGeneralKernel(hyperprior=loose))
        m.log_marginal(theta, data_deriv)
    # warning fires once per model, not per call
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        m.log_marginal(theta, data_deriv)

    # value-only data: no warning even with the loose prior
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        m2 = GPModel(K.MaternGeneralKernel(hyperprior=loose))
        m2.log_marginal(theta, data_valonly)

    # nu-safe prior + derivative data: no warning
    safe = (
        LogNormalJointPrior([0.0], [1.0])
        * UniformJointPrior([1.01], [30.0])
        * LogNormalJointPrior([-0.5], [1.0])
    )
    kern = K.MaternGeneralKernel(hyperprior=safe)
    kern.param_bounds[1] = (1.01, 30.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        m3 = GPModel(kern)
        m3.log_marginal(theta, data_deriv)
