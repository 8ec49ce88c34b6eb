"""Fused flagship covariance path: equality with the generic autodiff path,
gradient correctness, and GPModel backend dispatch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gptools_tpu.models.dataset import DatasetBuilder
from gptools_tpu.models.gp import GPModel
from gptools_tpu.ops import assemble, fused
from gptools_tpu.ops.kernels import (
    GibbsKernel1dTanh,
    Matern52Kernel,
    SquaredExponentialKernel,
)


def _data(rng):
    b = DatasetBuilder(1)
    X = np.sort(rng.uniform(0, 1.2, 18))
    b.add(X, np.sin(X), err_y=0.05)
    b.add(np.array([0.0, 1.2]), np.zeros(2), err_y=0.01, n=1)
    return b.build()


@pytest.mark.parametrize(
    "kern,theta",
    [
        (SquaredExponentialKernel(), [1.3, 0.4]),
        (GibbsKernel1dTanh(), [1.5, 0.4, 0.08, 0.1, 0.9]),
    ],
)
def test_fused_matches_generic(rng, kern, theta):
    data = _data(rng)
    theta = jnp.asarray(theta)
    K_gen = assemble.cov_matrix(
        kern, theta, data.Xf, data.nid, data.Xf, data.nid, data.multi_indices
    )
    K_fus = fused.flagship_cov(
        kern, theta, data.Xf, data.nid, data.multi_indices
    )
    np.testing.assert_allclose(np.asarray(K_fus), np.asarray(K_gen), rtol=1e-11)


def test_fused_gradients_match_generic(rng):
    data = _data(rng)
    kern = GibbsKernel1dTanh()
    theta = jnp.array([1.5, 0.4, 0.08, 0.1, 0.9])

    def loss_gen(t):
        K = assemble.cov_matrix(
            kern, t, data.Xf, data.nid, data.Xf, data.nid, data.multi_indices
        )
        return jnp.sum(jnp.sin(K))

    def loss_fus(t):
        K = fused.flagship_cov(kern, t, data.Xf, data.nid, data.multi_indices)
        return jnp.sum(jnp.sin(K))

    g1 = jax.grad(loss_gen)(theta)
    g2 = jax.grad(loss_fus)(theta)
    np.testing.assert_allclose(np.asarray(g2), np.asarray(g1), rtol=1e-9)


def test_model_backend_dispatch_equal_evidence(rng):
    data = _data(rng)
    theta = jnp.array([1.5, 0.4, 0.08, 0.1, 0.9])
    lls = {}
    for backend in ["generic", "fused"]:
        m = GPModel(GibbsKernel1dTanh(), cov_backend=backend, diag_factor=0.0)
        lls[backend] = float(m.log_marginal(theta, data))
    assert np.isclose(lls["generic"], lls["fused"], rtol=1e-12)
    # unsupported kernel silently falls back to generic under 'auto'/'fused'
    m = GPModel(Matern52Kernel(), cov_backend="fused", diag_factor=0.0)
    ll = float(m.log_marginal(jnp.array([1.2, 0.5]), data))
    assert np.isfinite(ll)


def test_fused_evidence_gradcheck(rng):
    data = _data(rng)
    m = GPModel(GibbsKernel1dTanh(), cov_backend="fused", diag_factor=0.0)
    theta = jnp.array([1.5, 0.4, 0.08, 0.1, 0.9])
    g = jax.grad(lambda t: m.log_marginal(t, data))(theta)
    for i in range(5):
        h = 1e-6
        fd = (
            float(m.log_marginal(theta.at[i].add(h), data))
            - float(m.log_marginal(theta.at[i].add(-h), data))
        ) / (2 * h)
        assert np.isclose(float(g[i]), fd, rtol=2e-5, atol=1e-7), (i, float(g[i]), fd)


@pytest.mark.parametrize(
    "full,sym,P",
    [
        (fused.se_cov_fused_soa, fused.se_cov_fused_soa_sym, 2),
        (fused.gibbs_tanh_cov_fused_soa, fused.gibbs_tanh_cov_fused_soa_sym, 5),
    ],
)
def test_symmetric_soa_builders_match_full(rng, full, sym, P):
    """The pairs-packed symmetric builders (upper triangle + mirror, the
    batched-evidence default) must reproduce the full-matrix chains-minor
    build exactly: values AND theta-cotangents, including non-symmetric
    output cotangents (whose (i,j)/(j,i) parts fold into one pair)."""
    N, C = 11, 6
    X = jnp.asarray(np.sort(rng.uniform(0, 1.2, N)))
    nid = jnp.asarray(np.array([0] * (N - 3) + [1] * 3))
    thetaT = jnp.asarray(rng.uniform(0.2, 1.5, (P, C)))
    Kf = full(X, nid, thetaT)
    Ks = sym(X, nid, thetaT)
    np.testing.assert_allclose(np.asarray(Ks), np.asarray(Kf), rtol=1e-12)
    # K must be exactly symmetric (the evidence only reads the lower triangle)
    np.testing.assert_array_equal(
        np.asarray(Ks), np.asarray(jnp.swapaxes(Ks, 0, 1))
    )
    ct = jnp.asarray(rng.standard_normal(Kf.shape))
    gf = jax.vjp(lambda t: full(X, nid, t), thetaT)[1](ct)[0]
    gs = jax.vjp(lambda t: sym(X, nid, t), thetaT)[1](ct)[0]
    np.testing.assert_allclose(np.asarray(gs), np.asarray(gf), rtol=1e-9)


def test_batched_marginal_symmetric_matches_per_chain(rng):
    """GPModel.log_marginal_batch (which routes through the symmetric
    builder by default) must equal the per-chain path on the flagship
    kernel with derivative observations."""
    data = _data(rng)
    m = GPModel(GibbsKernel1dTanh(), diag_factor=0.0)
    thetas = jnp.asarray(
        rng.uniform(0.2, 1.2, (5, 5))
    )
    lls_b = m.log_marginal_batch(thetas, data)
    lls_v = jax.vmap(lambda t: m.log_marginal(t, data))(thetas)
    np.testing.assert_allclose(
        np.asarray(lls_b), np.asarray(lls_v), rtol=1e-10
    )


def test_non_tanh_gibbs_rejected(rng):
    """The fused flagship builders hard-code the TanhWarp formulas; a direct
    call with another Gibbs warp must raise, not silently compute TanhWarp
    covariances."""
    from gptools_tpu.ops.kernels import GibbsKernel1dGauss

    data = _data(rng)
    kern = GibbsKernel1dGauss()
    theta = jnp.array([1.5, 0.4, 0.08, 0.9])
    with pytest.raises(ValueError, match="TanhWarp"):
        fused.flagship_cov(kern, theta, data.Xf, data.nid, data.multi_indices)
    with pytest.raises(ValueError, match="TanhWarp"):
        fused.flagship_cov_soa(
            kern, theta[:, None], data.Xf, data.nid, data.multi_indices
        )
    # and the model-level dispatch must fall back to the generic path
    assert not fused.fused_supported(kern, data.multi_indices, data.num_dim)
    m = GPModel(kern, cov_backend="fused", diag_factor=0.0)
    assert np.isfinite(float(m.log_marginal(theta, data)))


@pytest.mark.parametrize(
    "mk_kern,P",
    [
        (lambda: _M52(), 2),
        (lambda: _WK(_M52(), _BW()), 4),
        (lambda: _WK(_SE(), _BW()), 4),
        (lambda: _WK(_M52(), _LW(0.0, 2.0)), 2),
    ],
)
def test_widened_fused_matches_generic(rng, mk_kern, P):
    """Matern-5/2 and input-warped (BetaWarp /
    LinearWarp) kernels get the fused per-chain AND chains-minor builders;
    values (incl. derivative blocks chain-ruled through the warp) must match
    the generic autodiff assembly."""
    kern = mk_kern()
    N = 9
    X = np.sort(rng.uniform(0.05, 0.95, N))
    nid = np.array([0] * 6 + [1] * 3)
    mis = ((0,), (1,))
    Xf = jnp.asarray(X).reshape(-1, 1)
    nidj = jnp.asarray(nid)
    assert fused.fused_supported(kern, mis, 1)
    theta = jnp.asarray(rng.uniform(0.3, 1.5, P))
    from gptools_tpu.ops import assemble

    K_gen = assemble.cov_matrix(kern, theta, Xf, nidj, Xf, nidj, mis)
    K_fus = fused.flagship_cov(kern, theta, Xf, nidj, mis)
    # generic path differentiates the quadrature betainc for the warp slope;
    # the fused path uses the closed-form beta pdf — agreement to ~1e-12
    np.testing.assert_allclose(
        np.asarray(K_fus), np.asarray(K_gen), rtol=1e-9, atol=1e-11
    )
    C = 5
    thetaT = jnp.asarray(rng.uniform(0.3, 1.5, (P, C)))
    K_soa = fused.flagship_cov_soa(kern, thetaT, Xf, nidj, mis)
    K_ref = jnp.stack(
        [
            assemble.cov_matrix(kern, thetaT[:, c], Xf, nidj, Xf, nidj, mis)
            for c in range(C)
        ],
        axis=-1,
    )
    np.testing.assert_allclose(
        np.asarray(K_soa), np.asarray(K_ref), rtol=1e-9, atol=1e-11
    )


def _M52():
    from gptools_tpu.ops.kernels import Matern52Kernel

    return Matern52Kernel()


def _SE():
    from gptools_tpu.ops.kernels import SquaredExponentialKernel

    return SquaredExponentialKernel()


def _BW():
    from gptools_tpu.ops.kernels import BetaWarp

    return BetaWarp()


def _LW(a, b):
    from gptools_tpu.ops.kernels import LinearWarp

    return LinearWarp(a, b)


def _WK(base, warp):
    from gptools_tpu.ops.kernels import WarpedKernel

    return WarpedKernel(base, warp)
