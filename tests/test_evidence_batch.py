"""Chains-minor batched evidence path: value/gradient equality with the
vmapped per-chain path, -inf contract, and model-level batched posteriors.

This is the XLA sampler hot path: same math as ``vmap(loglik)`` but with
the chain axis minormost, so every step of the rolled loops is a
contiguous vector op over chains.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gptools_tpu.models.dataset import DatasetBuilder
from gptools_tpu.models.gp import GPModel
from gptools_tpu.ops import evidence
from gptools_tpu.ops.kernels import (
    DiagonalNoiseKernel,
    GibbsKernel1dTanh,
    SquaredExponentialKernel,
)
from gptools_tpu.utils.priors import LogNormalJointPrior, UniformJointPrior


def _spd_batch(rng, n, c):
    A = rng.standard_normal((c, n, n))
    K = np.einsum("cij,ckj->cik", A, A) + n * np.eye(n)
    return jnp.asarray(K)


def test_loglik_b_matches_vmapped_loglik(rng):
    n, c = 9, 7
    K = _spd_batch(rng, n, c)
    r = jnp.asarray(rng.standard_normal((c, n)))

    ll_ref = jax.vmap(lambda Ki, ri: evidence.loglik(Ki, ri))(K, r)
    K_soa = jnp.moveaxis(K, 0, -1)
    r_soa = r.T
    ll_b = evidence.loglik_b(K_soa, r_soa)
    np.testing.assert_allclose(np.asarray(ll_b), np.asarray(ll_ref), rtol=1e-12)

    # gradients: d sum(ll) / d(K, r) must match elementwise
    gK_ref, gr_ref = jax.grad(
        lambda K_, r_: jnp.sum(jax.vmap(lambda a, b: evidence.loglik(a, b))(K_, r_)),
        argnums=(0, 1),
    )(K, r)
    gK_b, gr_b = jax.grad(
        lambda K_, r_: jnp.sum(evidence.loglik_b(K_, r_)), argnums=(0, 1)
    )(K_soa, r_soa)
    np.testing.assert_allclose(
        np.asarray(jnp.moveaxis(gK_b, -1, 0)), np.asarray(gK_ref), rtol=1e-10
    )
    np.testing.assert_allclose(np.asarray(gr_b.T), np.asarray(gr_ref), rtol=1e-10)


def test_loglik_b_neg_inf_contract(rng):
    """A non-PSD chain gets ll = -inf and ZERO gradient; healthy chains in the
    same batch are unaffected."""
    n, c = 5, 4
    K = np.array(_spd_batch(rng, n, c))
    K[2] = -np.eye(n)  # chain 2: not PSD
    K_soa = jnp.moveaxis(jnp.asarray(K), 0, -1)
    r_soa = jnp.asarray(rng.standard_normal((n, c)))
    ll = evidence.loglik_b(K_soa, r_soa)
    assert np.isneginf(float(ll[2]))
    assert np.isfinite(np.asarray(ll)[[0, 1, 3]]).all()
    gK, gr = jax.grad(
        lambda K_, r_: jnp.sum(evidence.loglik_b(K_, r_)), argnums=(0, 1)
    )(K_soa, r_soa)
    assert np.all(np.asarray(gK)[:, :, 2] == 0.0)
    assert np.all(np.asarray(gr)[:, 2] == 0.0)
    assert np.isfinite(np.asarray(gK)[:, :, [0, 1, 3]]).all()


@pytest.mark.parametrize("floor", [0.0, 0.1, 1e3])
def test_jitter_floor_value_and_gradient(rng, floor):
    """The jitter tops the diagonal up to ``diag_factor * eps * max(mean
    diag, 1)`` past the noise variance ``floor`` already on it (nothing when
    the noise covers it), and both analytic VJPs include its K-dependence."""
    n, c, df = 6, 3, 1e14  # df * eps64 * scale ~ 0.3: a visible jitter
    K = _spd_batch(rng, n, c)
    r = jnp.asarray(rng.standard_normal((c, n)))
    A = rng.standard_normal((c, n, n))
    D = jnp.asarray(A + np.swapaxes(A, 1, 2))  # symmetric directions
    scale = np.asarray(jnp.mean(jnp.diagonal(K, axis1=1, axis2=2), axis=1))
    want = np.maximum(df * np.finfo(np.float64).eps * scale - floor, 0.0)
    Kj = jax.vmap(lambda k: evidence.add_jitter(k, df, floor))(K)
    np.testing.assert_allclose(
        np.asarray(jnp.diagonal(Kj - K, axis1=1, axis2=2)),
        np.broadcast_to(want[:, None], (c, n)), rtol=1e-12,
    )
    gK = jax.vmap(jax.grad(lambda k, v: evidence.loglik(k, v, df, floor)))(K, r)
    gK_b = jax.grad(
        lambda k: jnp.sum(evidence.loglik_b(k, r.T, df, floor))
    )(jnp.moveaxis(K, 0, -1))
    for i in range(c):
        # forward-mode through the plain factorization is the reference
        _, t_ref = jax.jvp(
            lambda k: evidence.gaussian_loglik(k, r[i], df, floor).ll,
            (K[i],), (D[i],),
        )
        np.testing.assert_allclose(float(jnp.sum(gK[i] * D[i])), float(t_ref),
                                   rtol=1e-8)
        np.testing.assert_allclose(
            float(jnp.sum(gK_b[:, :, i] * D[i])), float(t_ref), rtol=1e-8
        )


def _problems(rng):
    """(model, data) pairs covering the fused kernels, T transforms, noise
    kernels, and a mean-free/mean-full split."""
    out = []

    # flagship gibbs (the bench problem)
    x = np.linspace(0, 1.2, 14)
    y = 1.0 - 0.5 * x**2 + 0.03 * rng.standard_normal(len(x))
    b = DatasetBuilder(1)
    b.add(x, y, err_y=0.03)
    b.add(np.array([0.0]), np.array([0.0]), err_y=0.01, n=1)
    prior = (
        LogNormalJointPrior([0.0], [0.75])
        * LogNormalJointPrior([-1.0], [0.6])
        * LogNormalJointPrior([-2.3], [0.6])
        * LogNormalJointPrior([-2.3], [0.6])
        * UniformJointPrior([0.6], [1.1])
    )
    out.append((GPModel(GibbsKernel1dTanh(hyperprior=prior)), b.build()))

    # SE + line-integral T transform + noise kernel (config-5 flavor)
    b2 = DatasetBuilder(1)
    b2.add(x, y, err_y=0.05)
    T = np.zeros((3, 6))
    xq = np.linspace(0.1, 1.1, 6)
    T[0, :2] = 0.5
    T[1, 2:4] = 0.5
    T[2, 4:] = 0.5
    b2.add(xq, np.array([0.8, 0.6, 0.2]), err_y=0.05, T=T)
    prior2 = LogNormalJointPrior([0.0, -0.5], [0.75, 0.75]) * LogNormalJointPrior(
        [-3.0], [0.5]
    )
    out.append(
        (
            GPModel(
                SquaredExponentialKernel(
                    hyperprior=LogNormalJointPrior([0.0, -0.5], [0.75, 0.75])
                ),
                noise_kernel=DiagonalNoiseKernel(
                    hyperprior=LogNormalJointPrior([-3.0], [0.5])
                ),
            ),
            b2.build(),
        )
    )
    return out


@pytest.mark.slow
def test_log_marginal_batch_matches_vmap(rng, key):
    for model, data in _problems(rng):
        thetas = model.hyperprior.sample(key, (6,))
        ll_ref = jax.vmap(lambda t: model.log_marginal(t, data))(thetas)
        ll_b = model.log_marginal_batch(thetas, data)
        np.testing.assert_allclose(
            np.asarray(ll_b), np.asarray(ll_ref), rtol=1e-11
        )
        g_ref = jax.grad(
            lambda th: jnp.sum(jax.vmap(lambda t: model.log_marginal(t, data))(th))
        )(thetas)
        g_b = jax.grad(lambda th: jnp.sum(model.log_marginal_batch(th, data)))(
            thetas
        )
        np.testing.assert_allclose(np.asarray(g_b), np.asarray(g_ref), rtol=1e-9)


def test_log_posterior_u_batch_matches_vmap(rng, key):
    for model, data in _problems(rng):
        us = jax.vmap(model.u_of_theta)(model.hyperprior.sample(key, (6,)))
        lp_ref = jax.vmap(lambda u: model.log_posterior_u(u, data))(us)
        lp_b = model.log_posterior_u_batch(us, data)
        np.testing.assert_allclose(
            np.asarray(lp_b), np.asarray(lp_ref), rtol=1e-11
        )
        g_ref = jax.grad(
            lambda U: jnp.sum(
                jax.vmap(lambda u: model.log_posterior_u(u, data))(U)
            )
        )(us)
        g_b = jax.grad(lambda U: jnp.sum(model.log_posterior_u_batch(U, data)))(us)
        np.testing.assert_allclose(np.asarray(g_b), np.asarray(g_ref), rtol=1e-9)


def test_batch_fallback_unsupported_kernel(rng, key):
    """Matern-5/2 isn't fused: the batch path must fall back to vmap and
    still agree."""
    from gptools_tpu.ops.kernels import Matern52Kernel

    x = np.linspace(0, 2, 10)
    b = DatasetBuilder(1)
    b.add(x, np.sin(x), err_y=0.1)
    data = b.build()
    model = GPModel(
        Matern52Kernel(hyperprior=LogNormalJointPrior([0.0, -0.3], [0.7, 0.7]))
    )
    thetas = model.hyperprior.sample(key, (4,))
    np.testing.assert_allclose(
        np.asarray(model.log_marginal_batch(thetas, data)),
        np.asarray(jax.vmap(lambda t: model.log_marginal(t, data))(thetas)),
        rtol=1e-12,
    )
