"""gptools-tpu: a GPU probabilistic-programming inference engine for
Gaussian-process models with derivative and linear-transform (line-integral)
observations.

This is a from-scratch JAX/XLA rebuild of the capability set of
the reference library ``markchil/gptools`` (see SURVEY.md at the repo root):

- kernel zoo: squared exponential, Matern (half-integer and general nu),
  rational quadratic, Gibbs nonstationary (tanh and other length-scale warps),
  diagonal noise, kernel algebra (sum/product/scale), input warping, masking;
- observations carry per-dimension derivative orders and optional linear
  transforms ``y = T f(X)`` (quadrature / line integrals);
- one differentiable log marginal likelihood (Cholesky + logdet with exact
  JAX gradients) consumed by MAP, HMC/NUTS, SMC and ADVI;
- chains/particles shard over a ``jax.sharding.Mesh`` with collective
  (psum-style) adaptation statistics;
- prediction at arbitrary derivative orders with output transforms, and
  fully-Bayesian (MCMC-marginalized) predictive envelopes.

Design stance (vs the reference, cited per SURVEY.md section):

- the reference's hand-derived Hermite / Faa-di-Bruno / mpmath derivative
  machinery (``gptools/kernel/core.py :: ChainRuleKernel``,
  ``gptools/kernel/squared_exponential.py``) is replaced wholesale by JAX
  autodiff towers over scalar kernel functions (`gptools_tpu.ops.derivs`);
- numpy tiling + LAPACK (``gptools/core.py :: compute_Kij`` +
  ``scipy.linalg.cholesky``) becomes batched XLA covariance assembly
  plus batched Cholesky (`gptools_tpu.ops.assemble`, `gptools_tpu.ops.evidence`);
- emcee ensemble sampling / multiprocessing pools
  (``gptools/core.py :: sample_hyperparameter_posterior``) become vectorized
  NUTS/HMC/SMC/ADVI under ``vmap`` + mesh sharding (`gptools_tpu.infer`,
  `gptools_tpu.parallel`).
"""

import os as _os

if _os.environ.get("GPTOOLS_XLA_CACHE", "").lower() in ("1", "true", "yes"):
    # Opt-in persistent XLA compilation cache: the one-time compile is a
    # large part of a short run's wall; the cache amortizes it across
    # processes (utils/xla_cache.py). Import-time so it precedes the first
    # compile.
    from gptools_tpu.utils.xla_cache import enable as _enable_xla_cache

    _enable_xla_cache()

from gptools_tpu.models.gp import GaussianProcess, GPModel, Prediction
from gptools_tpu.models.dataset import Dataset, DatasetBuilder
from gptools_tpu.models import mean
from gptools_tpu.ops import kernels
from gptools_tpu.ops.kernels import (
    SquaredExponentialKernel,
    MaternKernel,
    MaternGeneralKernel,
    Matern52Kernel,
    RationalQuadraticKernel,
    GibbsKernel,
    GibbsKernel1dTanh,
    DiagonalNoiseKernel,
    ZeroKernel,
    ConstantKernel,
    SumKernel,
    ProductKernel,
    WarpedKernel,
    MaskedKernel,
    ArbitraryKernel,
)
from gptools_tpu.utils import priors
from gptools_tpu.utils.priors import (
    UniformJointPrior,
    NormalJointPrior,
    LogNormalJointPrior,
    GammaJointPrior,
    GammaJointPriorAlt,
    ExponentialJointPrior,
    SortedUniformJointPrior,
    IndependentJointPrior,
    ProductJointPrior,
    CoreEdgeJointPrior,
)
from gptools_tpu.utils import diagnostics
from gptools_tpu.utils.diagnostics import ess, split_rhat, summarize_samples
from gptools_tpu import configs
from gptools_tpu.models.serve import FrozenMCMCPredictor, FrozenPredictor

__version__ = "0.1.0"

__all__ = [
    "GaussianProcess",
    "GPModel",
    "Prediction",
    "Dataset",
    "DatasetBuilder",
    "mean",
    "kernels",
    "priors",
    "diagnostics",
    "SquaredExponentialKernel",
    "MaternKernel",
    "MaternGeneralKernel",
    "Matern52Kernel",
    "RationalQuadraticKernel",
    "GibbsKernel",
    "GibbsKernel1dTanh",
    "DiagonalNoiseKernel",
    "ZeroKernel",
    "ConstantKernel",
    "SumKernel",
    "ProductKernel",
    "WarpedKernel",
    "MaskedKernel",
    "ArbitraryKernel",
    "UniformJointPrior",
    "NormalJointPrior",
    "LogNormalJointPrior",
    "GammaJointPrior",
    "GammaJointPriorAlt",
    "ExponentialJointPrior",
    "SortedUniformJointPrior",
    "IndependentJointPrior",
    "ProductJointPrior",
    "CoreEdgeJointPrior",
    "ess",
    "split_rhat",
    "summarize_samples",
    "configs",
    "FrozenPredictor",
    "FrozenMCMCPredictor",
]
