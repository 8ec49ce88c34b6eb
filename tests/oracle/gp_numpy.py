"""Pure-numpy oracle of the GP evidence pipeline.

SURVEY.md section 0/4: while the reference mount is empty, this module is the
stand-in for the reference pipeline — an independent, hand-derived
implementation of the same math (SE and Gibbs-tanh kernels with analytic
derivative formulas, dense Cholesky log marginal likelihood) used to pin down
parity of the JAX engine. Deliberately written with explicit loops/formulas,
not by calling the library under test.
"""

import numpy as np


def se_kernel(x1, x2, n1, n2, sigma_f, ell):
    """SE covariance between derivative orders n1, n2 in {0,1,2} (1-D).

    Closed forms (the same ones the reference hard-codes via Hermite
    polynomials in gptools/kernel/squared_exponential.py):
      d^p_x1 d^q_x2 k = sigma^2 (-1)^q H_{p+q}(t) / (l sqrt(2))^{p+q} e^{-t^2}
    with t = (x1-x2)/(l sqrt(2)) and physicists' Hermite H_n.
    """
    d = x1 - x2
    t = d / (ell * np.sqrt(2.0))
    p, q = int(n1), int(n2)
    m = p + q
    H = [
        lambda t: np.ones_like(t),
        lambda t: 2 * t,
        lambda t: 4 * t**2 - 2,
        lambda t: 8 * t**3 - 12 * t,
        lambda t: 16 * t**4 - 48 * t**2 + 12,
    ][m]
    # Derivation: k = s^2 e^{-t^2}; d^m/dt^m e^{-t^2} = (-1)^m H_m(t) e^{-t^2}
    # each d/dx1 = (1/(l sqrt2)) d/dt ; each d/dx2 = -(1/(l sqrt2)) d/dt
    pref = (1.0 / (ell * np.sqrt(2.0))) ** m * (-1.0) ** q
    return sigma_f**2 * pref * (-1.0) ** m * H(t) * np.exp(-(t**2))


def tanh_l(x, l1, l2, lw, x0):
    return l1 + 0.5 * (l2 - l1) * (1 + np.tanh((x - x0) / lw))


def gibbs_value(x1, x2, sigma_f, l1, l2, lw, x0):
    la = tanh_l(x1, l1, l2, lw, x0)
    lb = tanh_l(x2, l1, l2, lw, x0)
    s2 = la**2 + lb**2
    return sigma_f**2 * np.sqrt(2 * la * lb / s2) * np.exp(-((x1 - x2) ** 2) / s2)


def gibbs_block_fd(x1, x2, n1, n2, theta, h=1e-6):
    """Gibbs derivative blocks via high-accuracy central finite differences
    (independent of any autodiff)."""

    def f(a, b):
        return gibbs_value(a, b, *theta)

    if n1 == 0 and n2 == 0:
        return f(x1, x2)
    if n1 == 1 and n2 == 0:
        return (f(x1 + h, x2) - f(x1 - h, x2)) / (2 * h)
    if n1 == 0 and n2 == 1:
        return (f(x1, x2 + h) - f(x1, x2 - h)) / (2 * h)
    if n1 == 1 and n2 == 1:
        return (
            f(x1 + h, x2 + h) - f(x1 + h, x2 - h) - f(x1 - h, x2 + h) + f(x1 - h, x2 - h)
        ) / (4 * h**2)
    raise NotImplementedError


def build_K(X, n, kernel_fn):
    N = len(X)
    K = np.empty((N, N))
    for i in range(N):
        for j in range(N):
            K[i, j] = kernel_fn(X[i], X[j], n[i], n[j])
    return K


def engine_jitter(Kn, err_y, eps, diag_factor=1e2):
    """The diagonal jitter the engine adds to the noisy covariance ``Kn``
    (leading batch axes allowed): ``diag_factor * eps * max(mean diag, 1)``
    less the smallest noise variance ``min(err_y**2)`` already on the
    diagonal, and never negative. Both sides of a comparison must factor the
    same matrix, so the oracle applies the engine's numerical convention."""
    d = np.diagonal(Kn, axis1=-2, axis2=-1).mean(axis=-1)
    want = diag_factor * eps * np.maximum(d, 1.0)
    return np.maximum(want - np.min(np.asarray(err_y) ** 2), 0.0)


def log_marginal(K, y, err_y, jitter=0.0):
    """Dense-Cholesky log marginal likelihood, numpy/LAPACK
    (the role scipy.linalg.cholesky plays in the reference's
    compute_K_L_alpha_ll)."""
    Kn = K + np.diag(np.asarray(err_y) ** 2) + jitter * np.eye(len(y))
    L = np.linalg.cholesky(Kn)
    w = np.linalg.solve(L, y)
    return (
        -0.5 * w @ w
        - np.sum(np.log(np.diag(L)))
        - 0.5 * len(y) * np.log(2 * np.pi)
    )


def se_predict(X, y, err_y, n, Xstar, nstar, sigma_f, ell, jitter=0.0):
    """Full numpy GP prediction with derivative orders, SE kernel."""
    K = build_K(X, n, lambda a, b, p, q: se_kernel(a, b, p, q, sigma_f, ell))
    Kn = K + np.diag(np.asarray(err_y) ** 2) + jitter * np.eye(len(y))
    Ks = np.array(
        [
            [se_kernel(xs, xj, ps, pj, sigma_f, ell) for xj, pj in zip(X, n)]
            for xs, ps in zip(Xstar, nstar)
        ]
    )
    Kss = np.array(
        [
            [se_kernel(xa, xb, pa, pb, sigma_f, ell) for xb, pb in zip(Xstar, nstar)]
            for xa, pa in zip(Xstar, nstar)
        ]
    )
    Ki = np.linalg.inv(Kn)
    mean = Ks @ Ki @ np.asarray(y)
    cov = Kss - Ks @ Ki @ Ks.T
    return mean, cov


def gibbs_block_cs(x1, x2, n1, n2, theta, h=1e-5):
    """Gibbs derivative blocks by complex-step differentiation in x1 (exact
    to rounding for first derivatives) and a central difference in x2 for
    the slope-slope block. Broadcasts over array inputs and parameters."""

    def f(a, b):
        return gibbs_value(a, b, *theta)

    cs = 1e-30
    if n1 == 0 and n2 == 0:
        return f(x1, x2)
    if n1 == 1 and n2 == 0:
        return np.imag(f(x1 + 1j * cs, x2)) / cs
    if n1 == 0 and n2 == 1:
        return np.imag(f(x1, x2 + 1j * cs)) / cs
    if n1 == 1 and n2 == 1:
        return (
            np.imag(f(x1 + 1j * cs, x2 + h)) - np.imag(f(x1 + 1j * cs, x2 - h))
        ) / (2 * h * cs)
    raise NotImplementedError


def matern52_value(x1, x2, sigma_f, ell):
    """Matern-5/2 covariance sigma_f^2 (1 + s + s^2/3) e^{-s},
    s = sqrt(5) |x1 - x2| / ell."""
    s = np.sqrt(5.0) * np.abs(x1 - x2) / ell
    return sigma_f**2 * (1.0 + s + s * s / 3.0) * np.exp(-s)


def beta_warp(x, a, b):
    """Beta-CDF input warp: the regularized incomplete beta I_x(a, b)."""
    from scipy.special import betainc

    return betainc(a, b, x)


def block_matrix(X1, n1, X2, n2, block_fn):
    """Covariance over all pairs from a block function ``block_fn(x1, x2,
    p, q)`` that evaluates one derivative block (orders p, q) on broadcast
    arrays; leading batch axes of the parameters carry through."""
    X1, X2 = np.asarray(X1, float), np.asarray(X2, float)
    n1, n2 = np.asarray(n1), np.asarray(n2)
    K = 0.0
    for p in np.unique(n1):
        for q in np.unique(n2):
            mask = (n1[:, None] == p) & (n2[None, :] == q)
            K = np.where(mask, block_fn(X1[:, None], X2[None, :], int(p), int(q)), K)
    return K
