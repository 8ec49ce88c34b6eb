"""The batched XLA evidence, its gradient rule and the predictive mixture
against the independent float64 numpy oracle (tests/oracle/gp_numpy.py) —
the same comparisons ``chip_smoke.py`` makes on the card in f32, here in
f64 on the CPU at small chain counts, plus the oracle's own consistency and
the golden-moment gate rule."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gptools_tpu import configs
from gptools_tpu.models.dataset import Dataset
from gptools_tpu.models.gp import GPModel
from gptools_tpu.ops.kernels import GibbsKernel1dTanh
from tests.oracle import gp_numpy as O

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
EPS64 = float(np.finfo(np.float64).eps)


@pytest.mark.parametrize("n1,n2", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_complex_step_blocks_match_finite_differences(n1, n2):
    """The complex-step Gibbs blocks agree with the plain central
    differences of the value kernel (to the differences' own accuracy)."""
    theta = (0.7, 1.1, 0.3, 0.05, 0.9)
    x1 = np.linspace(0.0, 1.2, 7)[:, None]
    x2 = np.linspace(0.05, 1.15, 5)[None, :]
    cs = O.gibbs_block_cs(x1, x2, n1, n2, theta)
    fd = O.gibbs_block_fd(x1, x2, n1, n2, theta, h=1e-4)
    np.testing.assert_allclose(cs, fd, rtol=1e-5, atol=1e-6 * np.abs(cs).max())


def _oracle_ll(case, data, t):
    X = np.asarray(data.Xf, np.float64).reshape(-1)
    nid = np.asarray(data.nid)
    y = np.asarray(data.y, np.float64)
    err = np.asarray(data.err_y, np.float64)
    r = y
    if case == "config3":
        w = O.beta_warp(X, t[2], t[3])
        K = O.matern52_value(w[:, None], w[None, :], t[0], t[1])
        r = y - (t[4] * X + t[5])
    else:
        K = O.block_matrix(
            X, nid, X, nid, lambda a, b, p, q: O.gibbs_block_cs(a, b, p, q, t)
        )
        if data.T is not None:
            T = np.asarray(data.T, np.float64)
            K = T @ K @ T.T
    jit = O.engine_jitter(K + np.diag(err**2), err, EPS64)
    return O.log_marginal(K, r, err, jitter=jit)


@pytest.mark.parametrize("case", ["config4", "config3", "config5"])
def test_batched_evidence_matches_oracle(case):
    """Value and analytic gradient (the chains-minor VJP rule) of
    `log_marginal_batch` against the oracle's value and its central
    differences, at posterior-plausible theta."""
    n = {"config4": 4, "config3": 3, "config5": 5}[case]
    prob = configs.ALL_CONFIGS[n]()
    model, data = prob.model, prob.data
    thetas = model.hyperprior.sample(jax.random.PRNGKey(1), (64,))
    lp = model.log_posterior_batch(thetas, data)
    thetas = thetas[jnp.argsort(-jnp.where(jnp.isfinite(lp), lp, -jnp.inf))[:3]]
    ll, pull = jax.vjp(lambda q: model.log_marginal_batch(q, data), thetas)
    (g,) = pull(jnp.ones_like(ll))
    for c, t in enumerate(np.asarray(thetas, np.float64)):
        want = _oracle_ll(case, data, t)
        np.testing.assert_allclose(float(ll[c]), want, rtol=1e-7)
        fd = np.empty_like(t)
        for k in range(t.size):
            h = 1e-5 * max(abs(t[k]), 1e-3)
            tp, tm = t.copy(), t.copy()
            tp[k] += h
            tm[k] -= h
            fd[k] = (_oracle_ll(case, data, tp) - _oracle_ll(case, data, tm)) / (2 * h)
        np.testing.assert_allclose(
            np.asarray(g[c]), fd, rtol=1e-4, atol=1e-4 * np.abs(fd).max()
        )


@pytest.mark.parametrize("chains", [1, 37])
def test_batched_evidence_any_chain_count(chains):
    """The chains-minor path takes any chain count, including one, and
    equals the per-chain path."""
    prob = configs.ALL_CONFIGS[4]()
    model, data = prob.model, prob.data
    thetas = model.hyperprior.sample(jax.random.PRNGKey(2), (chains,))
    ll_b = model.log_marginal_batch(thetas, data)
    ll_v = jax.vmap(lambda t: model.log_marginal(t, data))(thetas)
    assert ll_b.shape == (chains,)
    # prior draws include ill-conditioned K, and the two paths sum in a
    # different order: f64 agreement to ~1e-9 relative there
    np.testing.assert_allclose(np.asarray(ll_b), np.asarray(ll_v), rtol=1e-7)


@pytest.mark.parametrize("noiseless", [False, True])
def test_f32_jitter_only_below_the_noise(noiseless):
    """In f32 at config 4's posterior mean, the observation noise already
    exceeds the relative jitter, so the evidence equals the unjittered one
    (an additive f32 jitter biased the posterior against the f64 golden);
    with noiseless data the jitter is still added."""
    from f32_parity import load_golden

    prob = configs.ALL_CONFIGS[4]()
    data = prob.data.astype(jnp.float32)
    if noiseless:
        data = Dataset(data.Xf, data.nid, data.y, jnp.zeros_like(data.err_y),
                       data.T, data.multi_indices)
    theta = jnp.asarray(load_golden()["mean"], jnp.float32)[None]
    kern = prob.model.kernel
    ll = GPModel(kern).log_marginal_batch(theta, data)
    ll0 = GPModel(kern, diag_factor=0.0).log_marginal_batch(theta, data)
    assert ll.dtype == jnp.float32
    assert (float(ll[0]) == float(ll0[0])) is not noiseless


def test_cov_backend_choices():
    """Covariance assembly is fused XLA or generic autodiff ("auto" is the
    older name of "fused"); there is no other backend."""
    for b, want in (("auto", "fused"), ("fused", "fused"), ("generic", "generic")):
        assert GPModel(GibbsKernel1dTanh(), cov_backend=b).cov_backend == want
    assert GPModel(GibbsKernel1dTanh()).cov_backend == "fused"
    with pytest.raises(ValueError, match="cov_backend"):
        GPModel(GibbsKernel1dTanh(), cov_backend="pallas")


def test_predictive_mixture_matches_float64(monkeypatch):
    """`FrozenMCMCPredictor` mean and std over posterior draws against the
    float64 numpy computation ``chip_smoke.py`` gates the card with (config
    5: slope row and line-integral observation)."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from gptools_tpu.models.serve import FrozenMCMCPredictor

    monkeypatch.setattr(chip_smoke, "EPS32", EPS64)
    prob = configs.ALL_CONFIGS[5]()
    model, data = prob.model, prob.data
    thetas = model.hyperprior.sample(jax.random.PRNGKey(3), (256,))
    lp = model.log_posterior_batch(thetas, data)
    thetas = thetas[jnp.argsort(-jnp.where(jnp.isfinite(lp), lp, -jnp.inf))[:6]]
    pred = FrozenMCMCPredictor(model, data, thetas, bucket=1)
    grid = np.linspace(0.0, 1.2, 9)
    mean, std = pred(grid)
    m64, s64 = chip_smoke._predictive_f64(data, pred.thetas, grid)
    np.testing.assert_allclose(np.asarray(mean), m64, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(np.asarray(std), s64, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("shift,ok", [(0.0, True), (8.0, False)])
def test_golden_gate_rule(shift, ok):
    """The golden-moment gate passes the golden run itself and fails a
    mean shifted by many MC standard errors."""
    from f32_parity import golden_gate, load_golden

    gold = load_golden()
    se = np.asarray(gold["std"]) / np.sqrt(np.asarray(gold["ess"]))
    mean = np.asarray(gold["mean"]) + shift * se
    assert golden_gate(mean, gold["std"], gold["ess"], gold)["ok"] is ok


@pytest.mark.gpu
def test_f32_evidence_on_gpu_matches_oracle(gpu):
    """On the card, in f32: the batched evidence and its gradient at
    config-4 posterior-typical theta against the float64 oracle, with the
    gates ``chip_smoke.py`` uses."""
    prob = configs.ALL_CONFIGS[4]()
    model, data = prob.model, prob.data.astype(jnp.float32)
    thetas = model.hyperprior.sample(jax.random.PRNGKey(4), (512,))
    lp = model.log_posterior_batch(thetas, data)
    thetas = thetas[jnp.argsort(-jnp.where(jnp.isfinite(lp), lp, -jnp.inf))[:8]]
    thetas = thetas.astype(jnp.float32)
    ll, pull = jax.vjp(lambda q: model.log_marginal_batch(q, data), thetas)
    (g,) = pull(jnp.ones_like(ll))
    assert ll.dtype == jnp.float32
    eps32 = float(np.finfo(np.float32).eps)
    for c, t in enumerate(np.asarray(thetas, np.float64)):
        X = np.asarray(data.Xf, np.float64).reshape(-1)
        nid = np.asarray(data.nid)
        err = np.asarray(data.err_y, np.float64)

        def oll(th):
            K = O.block_matrix(
                X, nid, X, nid, lambda a, b, p, q: O.gibbs_block_cs(a, b, p, q, th)
            )
            jit = O.engine_jitter(K + np.diag(err**2), err, eps32)
            return O.log_marginal(K, np.asarray(data.y, np.float64), err, jitter=jit)

        want = oll(t)
        assert abs(float(ll[c]) - want) <= 1e-3 * max(1.0, abs(want))
        fd = np.array([
            (oll(t + h) - oll(t - h)) / (2e-5 * max(abs(t[k]), 1e-3))
            for k, h in enumerate(1e-5 * np.maximum(np.abs(t), 1e-3) * np.eye(t.size))
        ])
        rel = np.abs(np.asarray(g[c], np.float64) - fd) / (
            np.abs(fd) + 1e-3 * np.abs(fd).max()
        )
        assert rel.max() <= 1e-2
