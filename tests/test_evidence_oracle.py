"""Covariance assembly + evidence vs the independent numpy oracle
(SURVEY.md section 4: 'a pure-numpy CPU oracle of the likelihood to pin down
parity before any Pallas kernel lands')."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gptools_tpu.models.dataset import DatasetBuilder
from gptools_tpu.models.gp import GPModel
from gptools_tpu.ops import assemble, evidence
from gptools_tpu.ops.kernels import (
    DiagonalNoiseKernel,
    GibbsKernel1dTanh,
    SquaredExponentialKernel,
)
from tests.oracle import gp_numpy as oracle


def _se_dataset(rng, N=20, with_derivs=True):
    b = DatasetBuilder(1)
    X = np.sort(rng.uniform(0, 3, N))
    y = np.sin(X) + 0.05 * rng.standard_normal(N)
    b.add(X, y, err_y=0.05)
    if with_derivs:
        Xd = np.array([0.0, 3.0])
        b.add(Xd, np.cos(Xd), err_y=0.02, n=1)
    return b.build()


def test_cov_matrix_matches_oracle_se_derivs(rng):
    data = _se_dataset(rng)
    sf, ell = 1.3, 0.7
    k = SquaredExponentialKernel()
    theta = jnp.array([sf, ell])
    K = assemble.cov_matrix(
        k, theta, data.Xf, data.nid, data.Xf, data.nid, data.multi_indices
    )
    X = np.asarray(data.Xf)[:, 0]
    n = [data.multi_indices[i][0] for i in np.asarray(data.nid)]
    K_oracle = oracle.build_K(
        X, n, lambda a, b_, p, q: oracle.se_kernel(a, b_, p, q, sf, ell)
    )
    np.testing.assert_allclose(np.asarray(K), K_oracle, rtol=1e-10, atol=1e-12)


def test_cov_matrix_matches_oracle_gibbs_derivs(rng):
    data = _se_dataset(rng, N=12)
    theta_t = (1.5, 0.4, 0.12, 0.1, 2.0)
    k = GibbsKernel1dTanh()
    K = assemble.cov_matrix(
        k,
        jnp.asarray(theta_t),
        data.Xf,
        data.nid,
        data.Xf,
        data.nid,
        data.multi_indices,
    )
    X = np.asarray(data.Xf)[:, 0]
    n = [data.multi_indices[i][0] for i in np.asarray(data.nid)]
    K_oracle = oracle.build_K(
        X, n, lambda a, b_, p, q: oracle.gibbs_block_fd(a, b_, p, q, theta_t)
    )
    np.testing.assert_allclose(np.asarray(K), K_oracle, rtol=5e-4, atol=1e-7)


def test_gaussian_loglik_matches_oracle(rng):
    data = _se_dataset(rng)
    sf, ell = 1.3, 0.7
    model = GPModel(SquaredExponentialKernel(), diag_factor=0.0)
    ll = float(model.log_marginal(jnp.array([sf, ell]), data))
    X = np.asarray(data.Xf)[:, 0]
    n = [data.multi_indices[i][0] for i in np.asarray(data.nid)]
    K = oracle.build_K(X, n, lambda a, b_, p, q: oracle.se_kernel(a, b_, p, q, sf, ell))
    want = oracle.log_marginal(K, np.asarray(data.y), np.asarray(data.err_y))
    assert np.isclose(ll, want, rtol=1e-9), (ll, want)


def test_loglik_gradient_finite_difference(rng):
    data = _se_dataset(rng)
    model = GPModel(SquaredExponentialKernel(), diag_factor=0.0)
    theta = jnp.array([1.3, 0.7])
    g = jax.grad(lambda t: model.log_marginal(t, data))(theta)
    for i in range(2):
        h = 1e-6
        tp = theta.at[i].add(h)
        tm = theta.at[i].add(-h)
        fd = (
            float(model.log_marginal(tp, data)) - float(model.log_marginal(tm, data))
        ) / (2 * h)
        assert np.isclose(float(g[i]), fd, rtol=1e-5), (i, float(g[i]), fd)


def test_impossible_params_give_neg_inf(rng):
    """The reference's reject-don't-crash contract
    (gptools/error_handling.py): a non-PD covariance yields ll = -inf."""
    data = _se_dataset(rng, with_derivs=False)
    model = GPModel(SquaredExponentialKernel(), diag_factor=0.0)
    # nan hyperparameters -> non-finite K -> -inf, no exception
    ll = float(model.log_marginal(jnp.array([np.nan, 0.7]), data))
    assert ll == -np.inf


def test_noise_kernel_matches_explicit_diagonal(rng):
    data = _se_dataset(rng, with_derivs=True)
    sf, ell, sn = 1.1, 0.8, 0.3
    m_noise = GPModel(
        SquaredExponentialKernel(),
        noise_kernel=DiagonalNoiseKernel(n=0),
        diag_factor=0.0,
    )
    ll_noise = float(m_noise.log_marginal(jnp.array([sf, ell, sn]), data))
    # oracle: add sn^2 on value-observation diagonal entries
    X = np.asarray(data.Xf)[:, 0]
    n = [data.multi_indices[i][0] for i in np.asarray(data.nid)]
    K = oracle.build_K(X, n, lambda a, b_, p, q: oracle.se_kernel(a, b_, p, q, sf, ell))
    K = K + np.diag([sn**2 if ni == 0 else 0.0 for ni in n])
    want = oracle.log_marginal(K, np.asarray(data.y), np.asarray(data.err_y))
    assert np.isclose(ll_noise, want, rtol=1e-9)


def test_transformed_observations_line_integral(rng):
    """y = T f(X) path: quadrature-weighted observation equals the oracle's
    T K T^T likelihood (reference add_data(..., T=...) semantics)."""
    b = DatasetBuilder(1)
    Xq = np.linspace(0.0, 1.0, 11)
    w = np.full(11, 1.0 / 11)  # crude quadrature of mean value
    b.add(np.array([0.2, 0.5, 0.9]), np.array([0.1, 0.4, 0.8]), err_y=0.05)
    b.add(Xq, y=[0.45], T=w[None, :], err_y=0.02)
    data = b.build()
    assert data.has_transform and data.num_obs == 4 and data.num_latent == 14

    sf, ell = 1.0, 0.5
    model = GPModel(SquaredExponentialKernel(), diag_factor=0.0)
    ll = float(model.log_marginal(jnp.array([sf, ell]), data))

    X = np.asarray(data.Xf)[:, 0]
    Kff = oracle.build_K(
        X, [0] * len(X), lambda a, b_, p, q: oracle.se_kernel(a, b_, p, q, sf, ell)
    )
    T = np.asarray(data.T)
    Kobs = T @ Kff @ T.T
    want = oracle.log_marginal(Kobs, np.asarray(data.y), np.asarray(data.err_y))
    assert np.isclose(ll, want, rtol=1e-9)


def test_predict_matches_oracle(rng):
    data = _se_dataset(rng)
    sf, ell = 1.3, 0.7
    model = GPModel(SquaredExponentialKernel(), diag_factor=0.0)
    theta = jnp.array([sf, ell])
    Xstar = np.array([0.5, 1.5, 2.5])
    pred = model.predict(theta, data, Xstar, n=0, return_cov=True)
    X = np.asarray(data.Xf)[:, 0]
    n = [data.multi_indices[i][0] for i in np.asarray(data.nid)]
    mean_o, cov_o = oracle.se_predict(
        X, np.asarray(data.y), np.asarray(data.err_y), n, Xstar, [0, 0, 0], sf, ell
    )
    np.testing.assert_allclose(np.asarray(pred.mean), mean_o, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(np.asarray(pred.cov), cov_o, rtol=1e-5, atol=1e-8)


def test_predict_derivative_consistency(rng):
    """Predicted derivative == finite difference of predicted mean."""
    data = _se_dataset(rng)
    model = GPModel(SquaredExponentialKernel(), diag_factor=0.0)
    theta = jnp.array([1.3, 0.7])
    x0, h = 1.2, 1e-4
    m = model.predict(theta, data, np.array([x0 - h, x0 + h]), n=0, return_std=False).mean
    fd = (float(m[1]) - float(m[0])) / (2 * h)
    d = float(
        model.predict(theta, data, np.array([x0]), n=1, return_std=False).mean[0]
    )
    assert np.isclose(d, fd, rtol=1e-6)


@pytest.mark.slow
def test_vmap_over_theta_batches(rng):
    """The chains hot path: batched evidence under vmap."""
    data = _se_dataset(rng)
    model = GPModel(SquaredExponentialKernel(), diag_factor=0.0)
    thetas = jnp.array([[1.0, 0.5], [1.3, 0.7], [0.7, 1.1]])
    lls = jax.vmap(lambda t: model.log_marginal(t, data))(thetas)
    singles = [float(model.log_marginal(t, data)) for t in thetas]
    np.testing.assert_allclose(np.asarray(lls), singles, rtol=1e-12)


def test_draw_sample_moments(rng, key):
    data = _se_dataset(rng, with_derivs=False)
    model = GPModel(SquaredExponentialKernel(), diag_factor=0.0)
    theta = jnp.array([1.3, 0.7])
    Xs = np.array([0.5, 1.5])
    draws = model.draw_sample(key, theta, data, Xs, num_samp=20000)
    pred = model.predict(theta, data, Xs, return_cov=True)
    emp_mean = np.asarray(draws).mean(axis=1)
    emp_cov = np.cov(np.asarray(draws))
    np.testing.assert_allclose(emp_mean, np.asarray(pred.mean), atol=0.02)
    np.testing.assert_allclose(emp_cov, np.asarray(pred.cov), atol=0.02)


@pytest.mark.slow
def test_f32_evidence_close_to_f64(rng):
    """f32 numerics guard (SURVEY.md section 7.1 note): the f32 evidence with
    relative jitter must track the f64 value on the flagship-style problem."""
    data = _se_dataset(rng)
    model = GPModel(SquaredExponentialKernel())  # default diag_factor
    theta64 = jnp.array([1.3, 0.7], jnp.float64)
    ll64 = float(model.log_marginal(theta64, data))
    data32 = data.astype(jnp.float32)
    ll32 = float(model.log_marginal(theta64.astype(jnp.float32), data32))
    assert abs(ll32 - ll64) / abs(ll64) < 5e-3, (ll32, ll64)
    g64 = np.asarray(jax.grad(lambda t: model.log_marginal(t, data))(theta64))
    g32 = np.asarray(
        jax.grad(lambda t: model.log_marginal(t, data32))(
            theta64.astype(jnp.float32)
        )
    )
    np.testing.assert_allclose(g32, g64, rtol=5e-2)


@pytest.mark.slow
def test_small_cholesky_matches_xla(rng):
    """Small-N Cholesky/solve loops == XLA's, values and gradients
    (the hot-path replacement for XLA's batched cholesky of tiny
    matrices)."""
    from gptools_tpu.ops.evidence import (
        small_cholesky,
        small_solve_lower,
        small_solve_upper_t,
    )

    for n in (1, 2, 5, 27, 64):
        A = rng.standard_normal((n, n))
        K = jnp.asarray(A @ A.T + n * np.eye(n))
        b = jnp.asarray(rng.standard_normal(n))
        L_want = np.linalg.cholesky(np.asarray(K))
        np.testing.assert_allclose(
            np.asarray(small_cholesky(K)), L_want, rtol=1e-10, atol=1e-10
        )
        L = small_cholesky(K)
        w = small_solve_lower(L, b)
        np.testing.assert_allclose(
            np.asarray(w),
            np.linalg.solve_tril(np.asarray(L), np.asarray(b))
            if hasattr(np.linalg, "solve_tril")
            else np.asarray(
                jax.scipy.linalg.solve_triangular(L, b, lower=True)
            ),
            rtol=1e-10,
        )
        alpha = small_solve_upper_t(L, w)
        np.testing.assert_allclose(
            np.asarray(alpha), np.linalg.solve(np.asarray(K), np.asarray(b)),
            rtol=1e-8,
        )
    # batched leading axes
    Ks = jnp.asarray(
        np.stack(
            [A @ A.T + 8 * np.eye(8) for A in rng.standard_normal((4, 8, 8))]
        )
    )
    Ls = small_cholesky(Ks)
    for i in range(4):
        np.testing.assert_allclose(
            np.asarray(Ls[i]), np.linalg.cholesky(np.asarray(Ks[i])), rtol=1e-10
        )


def test_small_path_gradients_match_xla(rng):
    """d ll / d K identical through the unrolled path and XLA's cholesky."""
    from gptools_tpu.ops.evidence import (
        _LOG_2PI,
        small_cholesky,
        small_solve_lower,
    )

    n = 9
    A = rng.standard_normal((n, n))
    K = jnp.asarray(A @ A.T + n * np.eye(n))
    r = jnp.asarray(rng.standard_normal(n))

    def ll_small(K):
        L = small_cholesky(K)
        w = small_solve_lower(L, r)
        return (
            -0.5 * jnp.sum(w * w)
            - jnp.sum(jnp.log(jnp.diagonal(L)))
            - 0.5 * n * _LOG_2PI
        )

    def ll_xla(K):
        L = jnp.linalg.cholesky(K)
        w = jax.scipy.linalg.solve_triangular(L, r, lower=True)
        return (
            -0.5 * jnp.sum(w * w)
            - jnp.sum(jnp.log(jnp.diagonal(L)))
            - 0.5 * n * _LOG_2PI
        )

    np.testing.assert_allclose(float(ll_small(K)), float(ll_xla(K)), rtol=1e-12)
    # VJP conventions differ: the unrolled path reads only the LOWER triangle
    # (all sensitivity lands there), XLA's cholesky VJP symmetrizes. They are
    # the same linear functional on symmetric perturbations:
    #   diag equal; lower off-diagonal of small == 2 x XLA's off-diagonal.
    g1 = np.asarray(jax.grad(ll_small)(K))  # lower triangular
    g2 = np.asarray(jax.grad(ll_xla)(K))    # symmetric
    assert np.allclose(np.triu(g1, 1), 0.0)
    np.testing.assert_allclose(np.diag(g1), np.diag(g2), rtol=1e-8)
    np.testing.assert_allclose(
        np.tril(g1, -1), 2.0 * np.tril(g2, -1), rtol=1e-8, atol=1e-10
    )
    # and the total derivative along an arbitrary SYMMETRIC direction agrees
    S = rng.standard_normal((n, n))
    S = jnp.asarray(S + S.T)
    d1 = float(jax.jvp(ll_small, (K,), (S,))[1])
    d2 = float(jax.jvp(ll_xla, (K,), (S,))[1])
    np.testing.assert_allclose(d1, d2, rtol=1e-8)


def test_small_path_non_psd_gives_neg_inf():
    """Reject-don't-crash contract through the unrolled path."""
    from gptools_tpu.ops.evidence import gaussian_loglik

    K = jnp.asarray([[1.0, 2.0], [2.0, 1.0]])  # indefinite
    r = jnp.asarray([0.3, -0.2])
    st = gaussian_loglik(K, r)
    assert float(st.ll) == -np.inf
    assert not bool(st.ok)


@pytest.mark.slow
def test_solve_dtype_fallback_improves_f32_evidence(rng):
    """`GPModel(solve_dtype=float64)` (DESIGN.md section 4 escalation path):
    with f32 inputs, upcasting ONLY the factorization/solves must land the
    log-evidence closer to the full-f64 value than the all-f32 pipeline on
    an ill-conditioned K (near-duplicate inputs)."""
    from gptools_tpu.utils.priors import LogNormalJointPrior

    X = np.concatenate([np.linspace(0, 2, 12), np.linspace(0, 2, 12) + 2e-4])
    y = np.sin(X) + 0.01 * rng.standard_normal(24)
    b = DatasetBuilder(1)
    b.add(X, y, err_y=0.01)
    data = b.build()
    prior = LogNormalJointPrior([0.0, -0.5], [1.0, 1.0])

    def ll(solve_dtype, dtype):
        model = GPModel(
            SquaredExponentialKernel(hyperprior=prior), solve_dtype=solve_dtype
        )
        theta = jnp.asarray([1.0, 0.8], dtype)
        # the conftest enables x64, so the dataset must be downcast too for
        # a true f32 pipeline (x64 promotion would silently upcast K)
        return float(model.log_marginal(theta, data.astype(dtype)))

    ll64 = ll(None, jnp.float64)
    ll32 = ll(None, jnp.float32)
    ll_mixed = ll(jnp.float64, jnp.float32)
    assert abs(ll_mixed - ll64) < abs(ll32 - ll64), (ll32, ll_mixed, ll64)
    assert abs(ll_mixed - ll64) < 1e-3 * abs(ll64) + 1e-3


@pytest.mark.slow
def test_analytic_loglik_vjp_matches_autodiff(rng):
    """`evidence.loglik`'s analytic VJP (dll/dK = (aa^T - K^-1)/2, the
    sampler hot path since r2) must match full autodiff through the
    unrolled Cholesky — values, dK, dr, and dtheta through a real GP model
    with derivative observations — and return ZERO gradient on failed
    factorizations (the -inf contract)."""
    n = 9
    A = rng.standard_normal((n, n))
    K = jnp.asarray(A @ A.T + n * np.eye(n))
    r = jnp.asarray(rng.standard_normal(n))

    ll_a = lambda K, r: evidence.loglik(K, r)
    ll_d = lambda K, r: evidence.gaussian_loglik(K, r).ll
    assert np.isclose(float(ll_a(K, r)), float(ll_d(K, r)), rtol=1e-12)

    gK_a, gr_a = jax.grad(ll_a, argnums=(0, 1))(K, r)
    gK_d, gr_d = jax.grad(ll_d, argnums=(0, 1))(K, r)
    # the unrolled-Cholesky autodiff reads only the lower triangle, so its
    # K-cotangent piles both (i,j)/(j,i) contributions into the lower entry;
    # the analytic VJP is symmetric. They are the same gradient for any
    # symmetric K(theta) — compare via symmetrization.
    sym = lambda M: np.asarray(M) + np.asarray(M).T
    np.testing.assert_allclose(sym(gK_a), sym(gK_d), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(gr_a), np.asarray(gr_d), rtol=1e-9, atol=1e-12)

    # through the full model (what NUTS differentiates), incl. vmap
    from gptools_tpu.utils.priors import LogNormalJointPrior

    X = np.linspace(0, 2, 10)
    b = DatasetBuilder(1)
    b.add(X, np.sin(X), err_y=0.05)
    b.add(np.array([0.0]), np.array([1.0]), err_y=0.05, n=1)
    data = b.build()
    model = GPModel(
        SquaredExponentialKernel(hyperprior=LogNormalJointPrior([0, -1], [1, 1]))
    )

    def ll_model_autodiff(theta):
        return model.compute_K_L_alpha_ll(theta, data).ll

    thetas = jnp.asarray([[1.0, 0.7], [0.4, 1.9], [2.2, 0.2]])
    g_a = jax.vmap(jax.grad(lambda t: model.log_marginal(t, data)))(thetas)
    g_d = jax.vmap(jax.grad(ll_model_autodiff))(thetas)
    np.testing.assert_allclose(np.asarray(g_a), np.asarray(g_d), rtol=1e-8)

    # non-PSD K -> ll = -inf, gradient exactly zero (not NaN)
    K_bad = jnp.asarray(-np.eye(n))
    assert float(ll_a(K_bad, r)) == -np.inf
    gK_bad, gr_bad = jax.grad(ll_a, argnums=(0, 1))(K_bad, r)
    assert np.all(np.asarray(gK_bad) == 0.0)
    assert np.all(np.asarray(gr_bad) == 0.0)
