"""Posterior-moment parity: engine samplers vs the reference pipeline
stand-in (numpy GP oracle + affine-invariant ensemble sampler).

This is the acceptance criterion of BASELINE.json: hyperparameter posterior
moments must agree within Monte-Carlo error (SURVEY.md section 7.3 hard part
#4 — different samplers explore differently, so parity is judged on moments
with honest MC-error accounting).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gptools_tpu.models.dataset import DatasetBuilder
from gptools_tpu.models.gp import GPModel
from gptools_tpu.ops.kernels import GibbsKernel1dTanh, SquaredExponentialKernel
from gptools_tpu.utils.priors import LogNormalJointPrior, UniformJointPrior
from gptools_tpu.utils.diagnostics import ess_per_param
from gptools_tpu.infer import nuts, smc, model_logp
from tests.oracle.ensemble import run_ensemble


def _se_problem(rng):
    """Config-2 style: SE GP with a derivative observation, small N."""
    X = np.linspace(0, 3, 16)
    f = np.sin(1.5 * X)
    y = f + 0.1 * rng.standard_normal(len(X))
    b = DatasetBuilder(1)
    b.add(X, y, err_y=0.1)
    b.add(np.array([0.0]), np.array([1.5]), err_y=0.05, n=1)  # slope at 0
    data = b.build()
    prior = LogNormalJointPrior([0.0, -0.5], [0.75, 0.75])
    model = GPModel(SquaredExponentialKernel(hyperprior=prior))
    return model, data


def _run_oracle(model, data, rng, num_steps=1500, burn=500, walkers=16):
    """Ensemble-sample the SAME posterior density (via the jitted evidence)."""
    lp_fn = jax.jit(lambda t: model.log_posterior(jnp.asarray(t), data))

    def log_prob(theta):
        return float(lp_fn(theta))

    p0 = np.asarray(model.hyperprior.sample(jax.random.PRNGKey(7), (walkers,)))
    chain, _, acc = run_ensemble(log_prob, p0, num_steps, rng)
    assert acc > 0.1, f"oracle sampler failed to move (accept={acc})"
    flat = chain[burn:].reshape(-1, chain.shape[-1])
    return flat


def _moment_parity(flat_a, flat_b, label, z_tol=4.0):
    """Means must agree within combined MC standard errors (z < z_tol)."""
    for d in range(flat_a.shape[1]):
        a, b = flat_a[:, d], flat_b[:, d]
        # conservative independent-sample ESS guesses
        se_a = a.std() / np.sqrt(max(len(a) / 10, 1))
        se_b = b.std() / np.sqrt(max(len(b) / 10, 1))
        z = abs(a.mean() - b.mean()) / np.sqrt(se_a**2 + se_b**2)
        assert z < z_tol, (
            f"{label} param {d}: means {a.mean():.4f} vs {b.mean():.4f}, z={z:.1f}"
        )
        ratio = a.std() / b.std()
        assert 0.6 < ratio < 1.7, f"{label} param {d}: std ratio {ratio:.2f}"


@pytest.mark.slow
def test_nuts_parity_se_deriv(rng, key):
    model, data = _se_problem(rng)
    res = nuts.sample(
        model_logp_u(model, data),
        _prior_inits(model, key, 8),
        key,
        num_warmup=400,
        num_samples=600,
    )
    thetas = np.asarray(
        jax.vmap(jax.vmap(model.theta_of_u))(res.u)
    ).reshape(-1, model.num_params)
    flat_oracle = _run_oracle(model, data, rng)
    _moment_parity(thetas, flat_oracle, "nuts-vs-ensemble")
    # chains healthy
    ess = np.asarray(ess_per_param(jax.vmap(jax.vmap(model.theta_of_u))(res.u)))
    assert (ess > 50).all(), ess


@pytest.mark.slow
def test_smc_parity_gibbs(rng, key):
    """Config-4 style: Gibbs tanh kernel profile fit with an edge derivative
    constraint, SMC posterior vs ensemble oracle."""
    x = np.linspace(0, 1.2, 14)
    core, edge, w, x0 = 0.4, 0.08, 0.1, 0.9
    prof = 1.0 - 0.5 * x**2
    prof[x > x0] = (1.0 - 0.5 * x0**2) * np.exp(-(x[x > x0] - x0) / 0.05)
    y = prof + 0.03 * rng.standard_normal(len(x))
    b = DatasetBuilder(1)
    b.add(x, y, err_y=0.03)
    b.add(np.array([0.0]), np.array([0.0]), err_y=0.01, n=1)  # flat core
    data = b.build()
    prior = (
        LogNormalJointPrior([0.0], [0.75])      # sigma_f
        * LogNormalJointPrior([-1.0], [0.6])    # l1 core
        * LogNormalJointPrior([-2.3], [0.6])    # l2 edge
        * LogNormalJointPrior([-2.3], [0.6])    # lw
        * UniformJointPrior([0.6], [1.1])       # x0
    )
    model = GPModel(GibbsKernel1dTanh(hyperprior=prior))
    res = smc.sample(model, data, key, num_particles=1024, num_mutations=8)
    flat_smc = np.asarray(res.thetas[0])
    flat_oracle = _run_oracle(model, data, rng, num_steps=2500, burn=800, walkers=20)
    _moment_parity(flat_smc, flat_oracle, "smc-vs-ensemble")


def model_logp_u(model, data):
    def logp(u):
        return model.log_posterior_u(u, data)

    return logp


def _prior_inits(model, key, n):
    thetas = model.hyperprior.sample(key, (n,))
    return jax.vmap(model.u_of_theta)(thetas)


@pytest.mark.slow
def test_hmc_parity_matern_warp_mean(rng, key):
    """Config-3 style: Matern-5/2 + BetaWarp input warping + linear mean,
    multi-chain HMC vs the ensemble oracle."""
    from gptools_tpu import configs
    from gptools_tpu.infer import hmc

    prob = configs.config3_matern_mean_warp_hmc()
    model, data = prob.model, prob.data
    res = hmc.sample(
        model_logp_u(model, data),
        _prior_inits(model, key, 12),
        key,
        num_warmup=400,
        num_samples=500,
        num_steps=24,
    )
    thetas = np.asarray(
        jax.vmap(jax.vmap(model.theta_of_u))(res.u)
    ).reshape(-1, model.num_params)
    flat_oracle = _run_oracle(
        model, data, rng, num_steps=2200, burn=700, walkers=24
    )
    _moment_parity(thetas, flat_oracle, "hmc-vs-ensemble-config3", z_tol=5.0)


@pytest.mark.slow
def test_2d_ard_mixed_partial_end_to_end(rng, key):
    """The reference's derivative machinery is
    dimension-generic (``gptools/kernel/core.py :: Kernel.__call__`` takes
    multi-index derivative orders); pin the 2-D path end to end — 2-D ARD SE
    with value + d/dx1 observations through evidence (FD-pinned gradient) ->
    NUTS -> derivative prediction against the known truth."""
    # truth: f(x) = sin(1.5 x1) cos(0.8 x2); df/dx1 = 1.5 cos(1.5 x1) cos(0.8 x2)
    g = np.linspace(0.0, 2.0, 5)
    X1, X2 = np.meshgrid(g, g, indexing="ij")
    Xv = np.stack([X1.ravel(), X2.ravel()], axis=1)
    f = np.sin(1.5 * Xv[:, 0]) * np.cos(0.8 * Xv[:, 1])
    yv = f + 0.05 * rng.standard_normal(len(f))

    Xd = np.array([[0.3, 0.5], [1.1, 1.4], [1.7, 0.2], [0.6, 1.8]])
    dfdx1 = 1.5 * np.cos(1.5 * Xd[:, 0]) * np.cos(0.8 * Xd[:, 1])
    yd = dfdx1 + 0.05 * rng.standard_normal(len(dfdx1))

    b = DatasetBuilder(2)
    b.add(Xv, yv, err_y=0.05)
    b.add(Xd, yd, err_y=0.05, n=[1, 0])  # multi-index (1, 0): d/dx1
    data = b.build()

    prior = LogNormalJointPrior([0.0, -0.3, -0.3], [0.75, 0.75, 0.75])
    model = GPModel(SquaredExponentialKernel(num_dim=2, hyperprior=prior))

    # 1) evidence gradient FD-pinned at a generic theta
    theta = jnp.asarray([1.2, 0.9, 1.3])
    grad = jax.grad(lambda t: model.log_marginal(t, data))(theta)
    for i in range(3):
        h = 1e-5
        fd = (
            float(model.log_marginal(theta.at[i].add(h), data))
            - float(model.log_marginal(theta.at[i].add(-h), data))
        ) / (2 * h)
        assert np.isclose(float(grad[i]), fd, rtol=1e-4, atol=1e-8), (
            i, float(grad[i]), fd,
        )

    # 2) NUTS over the hyperposterior
    res = nuts.sample(
        model_logp_u(model, data),
        _prior_inits(model, key, 8),
        key,
        num_warmup=300,
        num_samples=300,
    )
    th = jax.vmap(jax.vmap(model.theta_of_u))(res.u)
    ess = np.asarray(ess_per_param(th))
    assert (ess > 50).all(), ess
    theta_hat = jnp.asarray(np.asarray(th).reshape(-1, 3).mean(axis=0))

    # 3) value and d/dx1 predictions at held-out points match the truth
    Xs = np.array([[0.5, 0.9], [1.3, 0.6], [1.8, 1.7], [0.2, 1.2]])
    truth_v = np.sin(1.5 * Xs[:, 0]) * np.cos(0.8 * Xs[:, 1])
    truth_d = 1.5 * np.cos(1.5 * Xs[:, 0]) * np.cos(0.8 * Xs[:, 1])
    pv = model.predict(theta_hat, data, jnp.asarray(Xs), n=0)
    pd = model.predict(theta_hat, data, jnp.asarray(Xs), n=[1, 0])
    for i in range(len(Xs)):
        tol_v = 4.0 * float(pv.std[i]) + 0.02
        tol_d = 4.0 * float(pd.std[i]) + 0.05
        assert abs(float(pv.mean[i]) - truth_v[i]) < tol_v, (i, float(pv.mean[i]), truth_v[i], tol_v)
        assert abs(float(pd.mean[i]) - truth_d[i]) < tol_d, (i, float(pd.mean[i]), truth_d[i], tol_d)


@pytest.mark.slow
def test_nuts_parity_matern_free_nu(rng, key):
    """SURVEY section 7.3 #6: a posterior over the
    Matern smoothness nu itself, sampled end-to-end (the reference's
    headline free-nu Matern feature ran scipy.special.kv under emcee;
    here the differentiable-quadrature Bessel-K kernel under NUTS), with
    moments checked against the ensemble oracle on the same density.
    Derivative observations included, so the nu prior is supported on
    nu > 1 (the (1,1) block diverges at coincidence otherwise)."""
    from gptools_tpu.ops.kernels import MaternGeneralKernel

    X = np.linspace(0, 3, 10)
    f = np.sin(1.3 * X)
    y = f + 0.1 * rng.standard_normal(len(X))
    b = DatasetBuilder(1)
    b.add(X, y, err_y=0.1)
    b.add(np.array([0.0]), np.array([1.3]), err_y=0.05, n=1)  # slope at 0
    data = b.build()
    prior = (
        LogNormalJointPrior([0.0], [0.75])       # sigma_f
        * UniformJointPrior([1.05], [6.0])       # nu (free smoothness)
        * LogNormalJointPrior([-0.3], [0.6])     # l
    )
    model = GPModel(MaternGeneralKernel(hyperprior=prior))
    res = nuts.sample(
        model_logp_u(model, data),
        _prior_inits(model, key, 8),
        key,
        num_warmup=300,
        num_samples=400,
    )
    thetas = np.asarray(
        jax.vmap(jax.vmap(model.theta_of_u))(res.u)
    ).reshape(-1, model.num_params)
    # the sampler must genuinely explore nu (not pin at a bound)
    nu_draws = thetas[:, 1]
    assert nu_draws.std() > 0.05, nu_draws.std()
    assert nu_draws.min() > 1.05 - 1e-6 and nu_draws.max() < 6.0 + 1e-6
    flat_oracle = _run_oracle(model, data, rng, num_steps=1500, burn=500)
    _moment_parity(thetas, flat_oracle, "nuts-free-nu-vs-ensemble")
