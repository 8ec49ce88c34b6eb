"""Sharded-chain sampling on the 8-virtual-device CPU mesh (SURVEY.md
section 4: multi-host behavior must be testable without a pod)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gptools_tpu.parallel import make_mesh, shard_chains, sharded_sample
from gptools_tpu.parallel.mesh import training_step_sharded

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)

_COV = np.array([[1.0, 0.5], [0.5, 2.0]])
_PREC = np.linalg.inv(_COV)


def _gauss_logp(u):
    return -0.5 * u @ jnp.asarray(_PREC) @ u


def test_mesh_and_sharding():
    mesh = make_mesh(8)
    assert mesh.devices.size == 8
    x = jnp.zeros((16, 3))
    xs = shard_chains(x, mesh)
    assert xs.sharding.is_equivalent_to(
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("chains")),
        ndim=2,
    )


def test_sharded_nuts_matches_unsharded_moments(key):
    mesh = make_mesh(8)
    u0 = jax.random.normal(key, (16, 2))
    res = sharded_sample(
        _gauss_logp, u0, key, mesh=mesh, num_warmup=300, num_samples=400
    )
    flat = np.asarray(res.u).reshape(-1, 2)
    np.testing.assert_allclose(flat.mean(axis=0), [0, 0], atol=0.15)
    np.testing.assert_allclose(np.cov(flat.T), _COV, atol=0.5)


def test_training_step_sharded_executes(key):
    from gptools_tpu.models.dataset import DatasetBuilder
    from gptools_tpu.models.gp import GPModel
    from gptools_tpu.ops.kernels import SquaredExponentialKernel
    from gptools_tpu.utils.priors import LogNormalJointPrior

    rng = np.random.default_rng(0)
    X = np.linspace(0, 2, 10)
    b = DatasetBuilder(1)
    b.add(X, np.sin(X) + 0.05 * rng.standard_normal(10), err_y=0.05)
    data = b.build()
    model = GPModel(
        SquaredExponentialKernel(hyperprior=LogNormalJointPrior([0, -1], [1, 1]))
    )
    mesh = make_mesh(8)
    step_jit, (u0, da0, inv_mass0) = training_step_sharded(model, data, mesh, 16)
    sh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("chains"))
    u0 = jax.device_put(u0, sh)
    keys = jax.device_put(jax.random.split(key, 16), sh)
    q1, logp_v, da1, stats = step_jit(u0, keys, da0, inv_mass0)
    assert q1.shape == (16, 2)
    assert np.isfinite(np.asarray(logp_v)).all()
    # the pooled statistic is replicated (collective result)
    assert np.isfinite(float(jnp.exp(da1.log_eps)))

    # compiled module must contain a cross-device reduction for the pooled stat
    txt = step_jit.lower(u0, keys, da0, inv_mass0).compile().as_text()
    assert ("all-reduce" in txt) or ("all_reduce" in txt), "no collective found"


def _tiny_gp():
    from gptools_tpu.models.dataset import DatasetBuilder
    from gptools_tpu.models.gp import GPModel
    from gptools_tpu.ops.kernels import SquaredExponentialKernel
    from gptools_tpu.utils.priors import LogNormalJointPrior

    rng = np.random.default_rng(0)
    X = np.linspace(0, 2, 10)
    b = DatasetBuilder(1)
    b.add(X, np.sin(X) + 0.05 * rng.standard_normal(10), err_y=0.05)
    data = b.build()
    model = GPModel(
        SquaredExponentialKernel(hyperprior=LogNormalJointPrior([0, -1], [1, 1]))
    )
    return model, data


def test_sharded_smc_runs_sharded(key):
    """`sharded_smc` must actually lay the particle state over the mesh
    (it used to silently ignore its mesh argument) and agree with the unsharded run on posterior moments."""
    from gptools_tpu.infer import pt as _pt
    from gptools_tpu.infer import smc as _smc
    from gptools_tpu.parallel.mesh import sharded_smc

    model, data = _tiny_gp()
    mesh = make_mesh(8)
    res_ref = _smc.sample(model, data, key, num_particles=64)
    res_sh = sharded_smc(model, data, key, mesh=mesh, num_particles=64)

    m_ref = np.asarray(res_ref.thetas[0]).mean(axis=0)
    m_sh = np.asarray(res_sh.thetas[0]).mean(axis=0)
    # same key; differences only via cross-device reduction order (which can
    # flip a resampling index), so tolerance is MC-scale, not bitwise
    np.testing.assert_allclose(m_sh, m_ref, atol=0.5)
    np.testing.assert_allclose(
        float(res_sh.diagnostics["log_evidence"]),
        float(res_ref.diagnostics["log_evidence"]),
        atol=1.0,
    )

    # particle count must divide the mesh
    with pytest.raises(ValueError):
        sharded_smc(model, data, key, mesh=mesh, num_particles=63)

    # the compiled round must contain cross-device reductions (weight
    # normalization / ESS bisection over the sharded particle axis)
    from jax.sharding import NamedSharding, PartitionSpec as P

    ll_fn, lp_fn = _pt.model_splits(model, data)
    nf = model.num_free_params
    dtype = jnp.asarray(model.initial_params).dtype
    state = _smc.SMCState(
        u=jnp.zeros((64, nf), dtype),
        log_like=jnp.zeros((64,), dtype),
        log_prior=jnp.zeros((64,), dtype),
        beta=jnp.zeros((), dtype),
        log_z=jnp.zeros((), dtype),
        key=key,
        acc_rate=jnp.ones((), dtype),
    )
    sh_part = NamedSharding(mesh, P("chains"))
    sh_rep = NamedSharding(mesh, P())
    state_sh = _smc.SMCState(
        u=sh_part,
        log_like=sh_part,
        log_prior=sh_part,
        beta=sh_rep,
        log_z=sh_rep,
        key=sh_rep,
        acc_rate=sh_rep,
    )
    f = jax.jit(
        lambda s: _smc.smc_round(ll_fn, lp_fn, s),
        in_shardings=(state_sh,),
        out_shardings=state_sh,
    )
    txt = f.lower(state).compile().as_text()
    assert ("all-reduce" in txt) or ("all_reduce" in txt), "no collective found"


def test_chain_count_must_divide_mesh(key):
    mesh = make_mesh(8)
    u0 = jnp.zeros((10, 2))
    with pytest.raises(ValueError):
        sharded_sample(_gauss_logp, u0, key, mesh=mesh)


def test_pod_mesh_and_2d_sharding(key):
    from gptools_tpu.parallel import distributed

    distributed.initialize()  # no-op single-process
    assert not distributed.is_multiprocess()
    mesh = distributed.pod_mesh()
    assert mesh.devices.shape == (1, len(jax.devices()))
    sh = distributed.chain_sharding_2d(mesh)
    x = jax.device_put(jnp.arange(32.0).reshape(16, 2), sh)
    # hierarchical mean over the sharded chains axis
    m = jax.jit(lambda v: jnp.mean(v, axis=0))(x)
    np.testing.assert_allclose(np.asarray(m), np.arange(32.0).reshape(16, 2).mean(0))


def test_pt_step_sharded_2d_mesh(key):
    """Parallel tempering over a 2-D (temps x chains) mesh: the replica
    ladder is a sharded axis (SURVEY.md section 2.3 PT row) and the swap
    roll induces cross-device permutation collectives."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from gptools_tpu.parallel.mesh import pt_step_sharded
    from tests.test_samplers import _ToyModel

    devs = np.asarray(jax.devices()[:8]).reshape(4, 2)
    mesh = Mesh(devs, ("temps", "chains"))
    model = _ToyModel()
    step_jit, (u0, eps0, inv_mass0) = pt_step_sharded(
        model, None, mesh, num_temps=4, num_chains=6, num_steps=4
    )
    sh_state = NamedSharding(mesh, P("temps", "chains"))
    sh_t = NamedSharding(mesh, P("temps"))
    u = jax.device_put(0.1 * np.ones((4, 6, 2)), sh_state)
    eps = jax.device_put(eps0, sh_t)
    inv_mass = jax.device_put(inv_mass0, sh_t)

    for i in range(4):
        key, sub = jax.random.split(key)
        u, ll, swap_frac, accept = step_jit(u, sub, eps, inv_mass, i)
    assert u.shape == (4, 6, 2)
    assert np.isfinite(np.asarray(u)).all()
    assert np.isfinite(np.asarray(ll)).all()
    assert swap_frac.shape == (3,)
    assert float(np.asarray(accept).mean()) > 0.1
    # output keeps the 2-D sharding
    assert u.sharding.is_equivalent_to(sh_state, 3)
    # compiled module must move data between devices (swap roll / pooling)
    txt = step_jit.lower(u, key, eps, inv_mass, 0).compile().as_text()
    assert any(
        tok in txt for tok in ("collective-permute", "all-reduce", "all_reduce")
    ), "no cross-device traffic found in PT sweep"
