"""Quadrature special functions vs scipy oracles, including parameter
derivatives (the capability scipy/CPU lacked an accelerator story for)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sps

from gptools_tpu.ops.special import bessel_kve, betainc_dd


@pytest.mark.parametrize("a,b", [(0.5, 0.5), (2.0, 3.0), (0.1, 5.0), (10.0, 0.3), (30.0, 30.0)])
def test_betainc_matches_scipy(a, b):
    x = np.linspace(0.01, 0.99, 21)
    got = np.asarray(betainc_dd(a, b, jnp.asarray(x)))
    want = sps.betainc(a, b, x)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


def test_betainc_grad_x_is_beta_pdf():
    a, b = 2.5, 1.7
    g = jax.grad(lambda x: betainc_dd(a, b, x))(jnp.asarray(0.4))
    want = sps.beta(a, b) ** -1 * 0.4 ** (a - 1) * 0.6 ** (b - 1)
    assert np.isclose(float(g), want, rtol=1e-5)


def test_betainc_grad_ab_finite_diff():
    x = 0.37
    h = 1e-6
    ga = jax.grad(lambda a: betainc_dd(a, 1.3, x))(jnp.asarray(2.1))
    fa = (sps.betainc(2.1 + h, 1.3, x) - sps.betainc(2.1 - h, 1.3, x)) / (2 * h)
    assert np.isclose(float(ga), fa, rtol=1e-5)
    gb = jax.grad(lambda b: betainc_dd(2.1, b, x))(jnp.asarray(1.3))
    fb = (sps.betainc(2.1, 1.3 + h, x) - sps.betainc(2.1, 1.3 - h, x)) / (2 * h)
    assert np.isclose(float(gb), fb, rtol=1e-5)


@pytest.mark.parametrize("v", [0.0, 0.5, 1.0, 1.7, 2.5, 7.3, 15.0, 30.0])
def test_bessel_kve_matches_scipy(v):
    x = np.array([1e-2, 0.1, 0.5, 1.0, 3.0, 10.0, 50.0])
    got = np.asarray(bessel_kve(v, jnp.asarray(x)))
    want = sps.kve(v, x)
    np.testing.assert_allclose(got, want, rtol=5e-6)


def test_bessel_kve_grad_nu_finite_diff():
    x = 2.3
    h = 1e-5
    g = jax.grad(lambda v: bessel_kve(v, x))(jnp.asarray(1.7))
    fd = (sps.kve(1.7 + h, x) - sps.kve(1.7 - h, x)) / (2 * h)
    assert np.isclose(float(g), fd, rtol=1e-5)
