"""Every matrix product on the sampler and predictive paths asks for full
f32 precision: on the GPU the default may round f32 operands to TF32 (about
three decimal digits), which would show in the line-integral (T) evidence,
the whitened density and the predictive moments. Checked on the jaxprs, so
the test says the same thing on the CPU as on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from gptools_tpu import configs
from gptools_tpu.infer.pipeline import _stable_fns


def _dot_precisions(jaxpr):
    """precision params of every dot_general in a closed jaxpr, recursively
    (pjit bodies, custom_vjp rules, scans, ...)."""
    out = []

    def visit(j):
        for eqn in j.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                visit(sub)

    visit(jaxpr.jaxpr)
    return out


def _is_highest(p):
    if p is None:
        return False
    if isinstance(p, tuple):
        return all(q == lax.Precision.HIGHEST for q in p)
    return p == lax.Precision.HIGHEST


def _assert_all_highest(closed):
    precs = _dot_precisions(closed)
    assert precs, "expected matrix products in this program"
    bad = [p for p in precs if not _is_highest(p)]
    assert not bad, f"{len(bad)} of {len(precs)} dot_general below HIGHEST: {bad[:3]}"


@pytest.fixture(scope="module")
def config5():
    return configs.ALL_CONFIGS[5]()


def test_t_data_batched_evidence_products_are_highest(config5):
    model, data = config5.model, config5.data
    assert data.T is not None
    thetas = model.hyperprior.sample(jax.random.PRNGKey(0), (4,))

    def vag(t):
        return jax.value_and_grad(
            lambda q: jnp.sum(model.log_marginal_batch(q, data))
        )(t)

    _assert_all_highest(jax.make_jaxpr(vag)(thetas))


def test_whitened_logp_products_are_highest(config5):
    model, data = config5.model, config5.data
    fns = _stable_fns(model, data)
    P = model.num_free_params
    vs = jnp.zeros((4, P))
    params = (jnp.zeros((P,)), jnp.eye(P))

    def vag(v):
        return jax.value_and_grad(
            lambda q: jnp.sum(fns["logp_w_batched"](q, params))
        )(v)

    _assert_all_highest(jax.make_jaxpr(vag)(vs))


def test_predictive_products_are_highest(config5):
    from gptools_tpu.models.serve import FrozenMCMCPredictor

    model, data = config5.model, config5.data
    thetas = model.hyperprior.sample(jax.random.PRNGKey(1), (3,))
    pred = FrozenMCMCPredictor(model, data, thetas, bucket=1)
    xs = jnp.linspace(0.0, 1.2, 5)[:, None]
    _assert_all_highest(jax.make_jaxpr(lambda x: pred._query(x, 0))(xs))
    mean, std = pred(np.linspace(0.0, 1.2, 5))
    assert np.isfinite(np.asarray(mean)).all() and np.isfinite(np.asarray(std)).all()
