"""Parametric prior mean functions with derivative-order evaluation.

Counterpart of ``gptools/mean.py`` (SURVEY.md section 2.1):
``MeanFunction``, ``ConstantMeanFunction``, ``LinearMeanFunction``, and the
mtanh-style pedestal mean (``MtanhMeanFunction1d`` [MED naming confidence]).
Mean functions share the kernel layer's hyperparameter plumbing (initial
values / bounds / fixed mask / hyperprior) and are inferred jointly with the
kernel hyperparameters; derivatives at any multi-index come from the same
autodiff tower as the kernels (`gptools_tpu.ops.derivs.mean_block_fn`).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp

from gptools_tpu.ops import derivs
from gptools_tpu.utils.priors import JointPrior, UniformJointPrior

__all__ = [
    "MeanFunction",
    "ConstantMeanFunction",
    "LinearMeanFunction",
    "MtanhMeanFunction1d",
    "ArbitraryMeanFunction",
    "SumMeanFunction",
]


class MeanFunction:
    """Base parametric mean ``m(x, theta)``; static w.r.t. jit.

    Mirrors the metadata protocol of `gptools_tpu.ops.kernels.Kernel`.
    """

    def __init__(
        self,
        num_dim: int,
        param_names: Sequence[str],
        initial_params: Optional[Sequence[float]] = None,
        fixed_params: Optional[Sequence[bool]] = None,
        param_bounds: Optional[Sequence[tuple]] = None,
        hyperprior: Optional[JointPrior] = None,
        default_bounds: Optional[Sequence[tuple]] = None,
    ):
        self.num_dim = int(num_dim)
        self.param_names = tuple(param_names)
        k = len(self.param_names)
        if param_bounds is None:
            if hyperprior is not None:
                param_bounds = hyperprior.bounds
            elif default_bounds is not None:
                param_bounds = default_bounds
            else:
                param_bounds = [(-1e4, 1e4)] * k
        pb = []
        for lo, hi in param_bounds:
            lo = -math.inf if lo is None else float(lo)
            hi = math.inf if hi is None else float(hi)
            pb.append((lo, hi))
        self.param_bounds = list(pb)  # writable view semantics, like kernels
        if hyperprior is None:
            finite = [
                (lo if math.isfinite(lo) else -1e6, hi if math.isfinite(hi) else 1e6)
                for lo, hi in self.param_bounds
            ]
            hyperprior = UniformJointPrior(finite) if k else None
        self.hyperprior = hyperprior
        if initial_params is None:
            initial_params = [
                0.5 * (max(lo, -1e2) + min(hi, 1e2)) for lo, hi in self.param_bounds
            ]
        self.initial_params = tuple(float(v) for v in initial_params)
        if fixed_params is None:
            fixed_params = [False] * k
        self.fixed_params = tuple(bool(v) for v in fixed_params)

    @property
    def num_params(self):
        return len(self.param_names)

    def _scalar(self, x, theta):
        raise NotImplementedError

    def scalar(self, x, theta):
        return self._scalar(x, theta)

    def block_fn(self, a: derivs.MultiIndex) -> Callable:
        return derivs.mean_block_fn(self.scalar, a)

    def __call__(self, x, theta, n=0):
        a = derivs.normalize_multi_index(n, self.num_dim)
        return self.block_fn(a)(jnp.asarray(x), jnp.asarray(theta))

    def __add__(self, other):
        if isinstance(other, MeanFunction):
            return SumMeanFunction(self, other)
        return NotImplemented


class SumMeanFunction(MeanFunction):
    """``m1 + m2`` with concatenated parameters."""

    def __init__(self, m1: MeanFunction, m2: MeanFunction):
        if m1.num_dim != m2.num_dim:
            raise ValueError("summed means must share num_dim")
        self.m1, self.m2 = m1, m2
        prior = None
        if m1.hyperprior is not None and m2.hyperprior is not None:
            prior = m1.hyperprior * m2.hyperprior
        else:
            prior = m1.hyperprior or m2.hyperprior
        super().__init__(
            m1.num_dim,
            tuple(f"m1.{n}" for n in m1.param_names)
            + tuple(f"m2.{n}" for n in m2.param_names),
            initial_params=m1.initial_params + m2.initial_params,
            fixed_params=m1.fixed_params + m2.fixed_params,
            param_bounds=m1.param_bounds + m2.param_bounds,
            hyperprior=prior,
        )

    def _scalar(self, x, theta):
        p1 = self.m1.num_params
        return self.m1.scalar(x, theta[:p1]) + self.m2.scalar(x, theta[p1:])


class ConstantMeanFunction(MeanFunction):
    """``m(x) = c`` (``gptools/mean.py :: ConstantMeanFunction``)."""

    def __init__(self, num_dim: int = 1, **kw):
        super().__init__(num_dim, ("c",), **kw)

    def _scalar(self, x, theta):
        del x
        return theta[0]


class LinearMeanFunction(MeanFunction):
    """``m(x) = sum_d a_d x_d + b`` (``gptools/mean.py :: LinearMeanFunction``)."""

    def __init__(self, num_dim: int = 1, **kw):
        names = tuple(f"a_{d+1}" for d in range(num_dim)) + ("b",)
        super().__init__(num_dim, names, **kw)

    def _scalar(self, x, theta):
        a = theta[: self.num_dim]
        b = theta[self.num_dim]
        return jnp.sum(a * x) + b


class MtanhMeanFunction1d(MeanFunction):
    """mtanh pedestal profile mean
    (``gptools/mean.py`` mtanh-style pedestal mean [MED naming, SURVEY.md]):

        z = (x0 - x) / (2 delta)
        mtanh(z, alpha) = ((1 + alpha z) e^z - e^-z) / (e^z + e^-z)
        m(x) = (ped - off)/2 * (mtanh(z, alpha) + 1) + off

    parameters ``(x0, delta, alpha, ped, off)``: pedestal center, width, core
    slope, pedestal height, offset. Standard H-mode edge profile shape.
    """

    def __init__(self, **kw):
        kw.setdefault(
            "default_bounds",
            [(-1e2, 1e2), (1e-4, 1e2), (-1e2, 1e2), (-1e4, 1e4), (-1e4, 1e4)],
        )
        super().__init__(1, ("x0", "delta", "alpha", "ped", "off"), **kw)

    def _scalar(self, x, theta):
        x0, delta, alpha, ped, off = (
            theta[0],
            theta[1],
            theta[2],
            theta[3],
            theta[4],
        )
        z = (x0 - x[0]) / (2.0 * delta)
        # stable mtanh: ((1+az) e^z - e^-z)/(e^z + e^-z)
        # = tanh(z) + a z e^z / (e^z + e^-z) = tanh(z) + a z sigmoid(2z)
        mt = jnp.tanh(z) + alpha * z * jax.nn.sigmoid(2.0 * z)
        return 0.5 * (ped - off) * (mt + 1.0) + off


class ArbitraryMeanFunction(MeanFunction):
    """Wrap any callable ``m(x, theta)`` as a mean function."""

    def __init__(self, fn: Callable, num_dim: int, param_names, **kw):
        self.fn = fn
        super().__init__(num_dim, param_names, **kw)

    def _scalar(self, x, theta):
        return self.fn(x, theta)
