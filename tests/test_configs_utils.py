"""Baseline configs build + run; checkpoint round-trip; plotting; errors."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gptools_tpu import configs
from gptools_tpu.utils import plotting
from gptools_tpu.utils.checkpoint import restore_state, save_state
from gptools_tpu.utils.error_handling import (
    GPImpossibleParamsError,
    check_finite_params,
)


@pytest.mark.parametrize(
    "cid",
    [1] + [pytest.param(c, marks=pytest.mark.slow) for c in (2, 3, 4, 5)],
)
def test_configs_build_and_evaluate(cid):
    prob = configs.ALL_CONFIGS[cid]()
    theta = jnp.asarray(prob.model.initial_params)
    ll = float(prob.model.log_marginal(theta, prob.data))
    assert np.isfinite(ll), (cid, ll)
    # gradients exist too
    g = jax.grad(lambda t: prob.model.log_marginal(t, prob.data))(theta)
    assert np.isfinite(np.asarray(g)).all(), cid


@pytest.mark.slow
def test_config1_map_runs(key):
    prob = configs.config1_se_map()
    from gptools_tpu.infer import map_fit

    res = map_fit.optimize(
        prob.model, prob.data, key, random_starts=4, num_steps=60
    )
    assert np.isfinite(float(res.log_posterior))


def test_config5_has_transform():
    prob = configs.config5_multihost_profile()
    assert prob.data.has_transform
    assert prob.data.num_obs == prob.data.T.shape[0]


def test_checkpoint_roundtrip(tmp_path, key):
    state = {
        "u": jax.random.normal(key, (8, 3)),
        "da": {"log_eps": jnp.asarray(-2.3)},
        "count": jnp.asarray(17),
    }
    path = os.path.join(tmp_path, "ckpt")
    save_state(path, state)
    back = restore_state(path, template=state)
    np.testing.assert_allclose(np.asarray(back["u"]), np.asarray(state["u"]))
    assert int(back["count"]) == 17


def test_compute_stats_and_plots(tmp_path, rng):
    vals = rng.standard_normal((500, 20)) * 0.3 + np.linspace(0, 1, 20)
    mean, lo, hi = plotting.compute_stats(vals)
    np.testing.assert_allclose(mean, np.linspace(0, 1, 20), atol=0.08)
    m2, l2, h2 = plotting.compute_stats(vals, robust=True)
    np.testing.assert_allclose(m2, mean, atol=0.08)

    samples = rng.standard_normal((4, 100, 3))
    summary = plotting.summarize_sampler(samples, param_names=["a", "b", "c"])
    assert len(summary["mean"]) == 3 and "ci_low" in summary

    fig = plotting.plot_sampler(samples, path=os.path.join(tmp_path, "corner.png"))
    assert os.path.exists(os.path.join(tmp_path, "corner.png"))
    ax = plotting.univariate_envelope_plot(
        np.linspace(0, 1, 20), mean, std=(hi / 1.96),
        path=os.path.join(tmp_path, "env.png"),
    )
    assert os.path.exists(os.path.join(tmp_path, "env.png"))


def test_error_handling():
    with pytest.raises(GPImpossibleParamsError):
        check_finite_params([1.0, np.nan])
    with pytest.raises(GPImpossibleParamsError):
        check_finite_params([2.0], bounds=[(0.0, 1.0)])
    check_finite_params([0.5], bounds=[(0.0, 1.0)])  # ok


def test_rank_normalized_ess(rng):
    from gptools_tpu.utils.diagnostics import bulk_ess_per_param, ess_per_param

    chains = rng.standard_normal((4, 300, 2))
    # heavy-tailed second param
    chains[..., 1] = np.sign(chains[..., 1]) * np.abs(chains[..., 1]) ** 3
    plain = np.asarray(ess_per_param(chains))
    bulk = np.asarray(bulk_ess_per_param(chains))
    assert np.all(bulk > 100)
    assert np.all(np.isfinite(plain))


def test_ess_finite_with_stuck_chains(rng):
    """A zero-variance (stuck) chain must not poison ESS with NaN (observed
    with 4096-chain ChEES runs where a few chains reject every proposal)."""
    from gptools_tpu.utils.diagnostics import ess_per_param, split_rhat

    chains = rng.standard_normal((8, 200, 3))
    chains[2] = 1.7  # completely stuck chain, all params
    ess = np.asarray(ess_per_param(chains))
    assert np.isfinite(ess).all()
    # stuck chain inflates between-chain variance -> ESS should be depressed
    ess_clean = np.asarray(ess_per_param(np.delete(chains, 2, axis=0)))
    assert (ess < ess_clean * 1.5).all()


def test_checkpoint_resume_sampler_state(tmp_path, key):
    """Deterministic mid-run resume: window -> checkpoint -> restore ->
    continue equals an uninterrupted run (SURVEY.md section 5 checkpoint
    requirement)."""
    import jax.numpy as jnp

    from gptools_tpu.infer import hmc

    def logp(u):
        return -0.5 * jnp.sum(u * u)

    logp_and_grad = jax.value_and_grad(logp)

    def transition(q, k, eps, inv_mass):
        return hmc._hmc_transition(logp_and_grad, q, k, eps, inv_mass, 8)

    qs = jax.random.normal(key, (6, 2))
    da = hmc.da_init(jnp.asarray(0.2))
    inv_mass = jnp.ones((2,))
    k1, k2 = jax.random.split(key)

    # uninterrupted: two windows
    qs_a, da_a, _, _ = hmc.run_window(transition, qs, k1, 20, da, inv_mass)
    qs_b, da_b, _, _ = hmc.run_window(transition, qs_a, k2, 20, da_a, inv_mass)

    # interrupted: checkpoint between windows, restore, continue
    state = {"qs": qs_a, "da": da_a._asdict()}
    path = os.path.join(tmp_path, "resume")
    save_state(path, state)
    back = restore_state(path, template=state)
    from gptools_tpu.infer.hmc import DualAveragingState

    da_r = DualAveragingState(**back["da"])
    qs_c, da_c, _, _ = hmc.run_window(transition, back["qs"], k2, 20, da_r, inv_mass)

    np.testing.assert_allclose(np.asarray(qs_c), np.asarray(qs_b), rtol=1e-12)
    np.testing.assert_allclose(
        float(da_c.log_eps), float(da_b.log_eps), rtol=1e-12
    )


def test_combined_and_masked_bounds_views():
    """Reference list-view semantics (``gptools/utils.py :: CombinedBounds,
    MaskedBounds``): reads concatenate/subset, writes mutate the owners."""
    from gptools_tpu.utils import CombinedBounds, MaskedBounds

    a = [(0.0, 1.0), (1.0, 2.0)]
    b = [(5.0, 6.0)]
    v = CombinedBounds(a, b)
    assert len(v) == 3
    assert v[2] == (5.0, 6.0) and v[-1] == (5.0, 6.0)
    assert v[1:] == [(1.0, 2.0), (5.0, 6.0)]
    v[2] = (7.0, 8.0)
    assert b[0] == (7.0, 8.0)  # write-through
    v[0:2] = [(9.0, 9.5), (9.5, 10.0)]
    assert a == [(9.0, 9.5), (9.5, 10.0)]
    assert list(v) == [(9.0, 9.5), (9.5, 10.0), (7.0, 8.0)]
    import pytest

    with pytest.raises(IndexError):
        v[3]

    base = [10, 20, 30, 40]
    m = MaskedBounds(base, [0, 2])
    assert list(m) == [10, 30] and m[-1] == 30
    m[1] = 99
    assert base == [10, 20, 99, 40]  # masked slot 1 -> base index 2
    with pytest.raises(IndexError):
        m[2]


def test_matern_kernel_arb_alias():
    from gptools_tpu.ops.kernels import MaternGeneralKernel, MaternKernelArb

    assert MaternKernelArb is MaternGeneralKernel


def test_gp_bounds_views_write_through(rng):
    """gp.param_bounds / gp.free_param_bounds are LIVE views: writes reach
    the owning kernel (reference CombinedBounds/MaskedBounds semantics)."""
    import numpy as np

    from gptools_tpu.models.gp import GaussianProcess
    from gptools_tpu.ops.kernels import SquaredExponentialKernel

    k = SquaredExponentialKernel()
    gp = GaussianProcess(k)
    gp.free_param_bounds[0] = (0.5, 2.0)
    assert gp.free_param_bounds[0] == (0.5, 2.0)   # read back through the view
    assert k.param_bounds[0] == (0.5, 2.0)          # reached the owning kernel
    gp.param_bounds[1] = (0.1, 9.0)
    assert k.param_bounds[1] == (0.1, 9.0)
    # comparisons against non-iterables are False, not TypeError
    assert (gp.param_bounds == None) is False  # noqa: E711


def test_zero_warmup_uses_eps0(key):
    """num_warmup=0 must sample at eps0, not exp(0)=1 (da_init seeds the
    dual-averaging iterate AND its average at eps0)."""
    import jax.numpy as jnp
    import numpy as np

    from gptools_tpu.infer import hmc, pt
    from tests.test_samplers import _ToyModel, gauss_logp

    u0 = 0.1 * jnp.ones((4, 3))
    res = hmc.sample(
        gauss_logp, u0, key, num_warmup=0, num_samples=20, num_steps=8,
        eps0=0.025,
    )
    eps = float(res.diagnostics["step_size"])
    assert np.isclose(eps, 0.025, rtol=1e-6), eps

    res_pt = pt.sample(
        _ToyModel(), None, key, num_chains=2, num_temps=2, num_warmup=0,
        num_samples=10, num_steps=4, eps0=0.05,
    )
    np.testing.assert_allclose(
        np.asarray(res_pt.diagnostics["step_size"]), 0.05, rtol=1e-6
    )


def test_xla_cache_enable_persists_entries(tmp_path, monkeypatch):
    """utils/xla_cache.enable writes compiled programs to the cache dir.

    bench.py, chip_smoke.py and the GPTOOLS_XLA_CACHE env opt-in all route
    through enable(); this pins that a fresh dir gains at least one
    persisted executable after a non-trivial compile (min_compile_secs=0 so
    even CPU compiles qualify).
    """
    from gptools_tpu.utils import xla_cache

    cache_dir = str(tmp_path / "xla_cache")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(xla_cache, "DEFAULT_DIR", cache_dir)
    prev_dir = jax.config.jax_compilation_cache_dir
    prev_secs = jax.config.jax_persistent_cache_min_compile_time_secs
    prev_bytes = jax.config.jax_persistent_cache_min_entry_size_bytes
    try:
        assert xla_cache.enable(min_compile_secs=0.0) == cache_dir

        @jax.jit
        def f(x):
            return jnp.linalg.cholesky(
                x @ x.T + 1e-3 * jnp.eye(x.shape[0], dtype=x.dtype)
            ).sum()

        f(jnp.ones((64, 64))).block_until_ready()
        entries = [p for p in os.listdir(cache_dir) if not p.startswith(".")]
        assert entries, "no cache entries persisted"
    finally:
        # the cache config is process-global; restore so later tests are
        # not silently serialized into this test's tmp dir
        jax.config.update("jax_compilation_cache_dir", prev_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", prev_secs)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", prev_bytes)


def test_device_ess_rhat_matches_host_path(rng):
    """The on-device diagnostics program (`_device_ess_rhat`, used by
    ess_and_rhat for accelerator-resident samples so only per-param scalars
    cross the host boundary) must agree with the host path (native C++ when
    built, JAX-on-CPU otherwise)."""
    from gptools_tpu.utils.diagnostics import _device_ess_rhat, ess_and_rhat

    s = rng.standard_normal((16, 400, 3))
    # AR(1)-ish correlation so tau > 1 and the Geyer truncation is exercised
    for t in range(1, s.shape[1]):
        s[:, t] = 0.6 * s[:, t - 1] + 0.8 * s[:, t]
    e_dev, r_dev = _device_ess_rhat(jnp.asarray(s))
    e_host, r_host = ess_and_rhat(s)  # numpy input -> host path
    np.testing.assert_allclose(np.asarray(e_dev), e_host, rtol=2e-3)
    np.testing.assert_allclose(np.asarray(r_dev), r_host, rtol=1e-5)


def test_device_moments_match_numpy(rng):
    """summarize_samples' on-device moment program vs numpy reference."""
    from gptools_tpu.utils.diagnostics import _device_moments

    s = rng.standard_normal((8, 250, 4))
    mean, std, q05, q50, q95 = (np.asarray(v) for v in _device_moments(jnp.asarray(s)))
    flat = s.reshape(-1, 4)
    np.testing.assert_allclose(mean, flat.mean(axis=0), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(std, flat.std(axis=0, ddof=1), rtol=1e-6)
    for got, q in ((q05, 0.05), (q50, 0.50), (q95, 0.95)):
        np.testing.assert_allclose(got, np.quantile(flat, q, axis=0), rtol=1e-5, atol=1e-7)


def test_metrics_finalize_ess_fields(tmp_path, rng):
    """MetricsLogger.finalize routes through the residency-driven
    ess_and_rhat and logs ESS / R-hat / ESS-per-second fields."""
    from gptools_tpu.utils.metrics import MetricsLogger

    log = MetricsLogger(path=str(tmp_path / "m.jsonl"), run_name="t")
    s = rng.standard_normal((4, 200, 2))
    log.finalize(s, wall_time=2.0)
    (rec,) = [r for r in log.records if r["event"] == "final"]
    assert rec["min_ess"] > 50 and len(np.asarray(rec["ess"])) == 2
    assert rec["ess_per_s"] == rec["min_ess"] / 2.0
    assert np.all(np.asarray(rec["rhat"]) < 1.1)
