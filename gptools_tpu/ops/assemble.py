"""Covariance-matrix assembly from scalar kernels + derivative multi-indices.

Counterpart of ``gptools/core.py :: GaussianProcess.compute_Kij``,
which tiled ``(Xi, Xj, ni, nj)`` index arrays and made one vectorized kernel
call over all pairs (SURVEY.md section 3.1). Here each derivative block
``d^a d^b k`` is generated by autodiff (`gptools_tpu.ops.derivs`), evaluated
**branchlessly over the full tile** and mask-combined, so the whole build is
one fused XLA elementwise kernel — no data-dependent control flow, static
shapes, ready for ``vmap`` over hyperparameter batches (chains/particles).

Hand-fused builders for the flagship kernels live in `gptools_tpu.ops.fused`;
this module is the reference implementation they are tested against, and the
general path for arbitrary kernels.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from gptools_tpu.ops.derivs import MultiIndex

__all__ = ["cov_matrix", "delta_matrix", "mean_vector", "all_pairs"]


def all_pairs(num_a: int, num_b: int) -> Tuple[Tuple[int, int], ...]:
    return tuple((i, j) for i in range(num_a) for j in range(num_b))


def cov_matrix(
    kernel,
    theta: jax.Array,
    X1: jax.Array,
    nid1: jax.Array,
    X2: jax.Array,
    nid2: jax.Array,
    multi_indices: Sequence[MultiIndex],
    pairs: Optional[Sequence[Tuple[int, int]]] = None,
    include_delta: bool = True,
) -> jax.Array:
    """Dense covariance between observation sets with derivative orders.

    Args:
      kernel: a `gptools_tpu.ops.kernels.Kernel` (static).
      theta: (P,) flat hyperparameter vector of the kernel.
      X1: (N1, D) inputs; nid1: (N1,) int ids into ``multi_indices``.
      X2: (N2, D) inputs; nid2: (N2,) int ids into ``multi_indices``.
      multi_indices: static tuple of derivative multi-index tuples.
      pairs: static list of (aid, bid) combinations to evaluate; defaults to
        the full cross product. Pairs absent from the data waste compute only.
      include_delta: add white-noise delta terms (matching X and n).

    Returns (N1, N2) covariance. Differentiable in ``theta`` (and X).
    """
    multi_indices = tuple(tuple(m) for m in multi_indices)
    if pairs is None:
        pairs = all_pairs(len(multi_indices), len(multi_indices))
    pairs = tuple(pairs)
    dtype = jnp.result_type(X1, theta, jnp.float32)

    K = jnp.zeros((X1.shape[0], X2.shape[0]), dtype=dtype)
    if kernel.has_smooth:
        if len(multi_indices) == 1:
            # fast path: single derivative order everywhere (e.g. all values)
            (a,) = multi_indices
            fn = kernel.block_fn(a, a)
            K = jax.vmap(
                jax.vmap(fn, in_axes=(None, 0, None)), in_axes=(0, None, None)
            )(X1, X2, theta).astype(dtype)
        else:
            for aid, bid in pairs:
                fn = kernel.block_fn(multi_indices[aid], multi_indices[bid])
                block = jax.vmap(
                    jax.vmap(fn, in_axes=(None, 0, None)),
                    in_axes=(0, None, None),
                )(X1, X2, theta)
                mask = (nid1[:, None] == aid) & (nid2[None, :] == bid)
                K = K + jnp.where(mask, block.astype(dtype), 0.0)

    if include_delta:
        K = K + delta_matrix(
            kernel, theta, X1, nid1, X2, nid2, multi_indices, dtype=dtype
        )
    return K


def delta_matrix(
    kernel,
    theta: jax.Array,
    X1: jax.Array,
    nid1: jax.Array,
    X2: jax.Array,
    nid2: jax.Array,
    multi_indices: Sequence[MultiIndex],
    dtype=None,
) -> jax.Array:
    """White-noise contributions: ``sigma_n^2`` where inputs AND derivative
    orders match exactly (``gptools/kernel/noise.py :: DiagonalNoiseKernel``
    semantics: the reference compares input values, so repeated X locations
    also couple — reproduced here)."""
    multi_indices = tuple(tuple(m) for m in multi_indices)
    if dtype is None:
        dtype = jnp.result_type(X1, theta, jnp.float32)
    terms = kernel.delta_terms()
    out = jnp.zeros((X1.shape[0], X2.shape[0]), dtype=dtype)
    if not terms:
        return out
    same_x = jnp.all(X1[:, None, :] == X2[None, :, :], axis=-1)
    same_n = nid1[:, None] == nid2[None, :]
    base_mask = same_x & same_n
    for off, dk in terms:
        val = dk.delta_value(theta[off : off + dk.num_params]).astype(dtype)
        if dk.n_match is not None:
            if dk.n_match not in multi_indices:
                continue  # no observation of the matching order exists
            tid = multi_indices.index(dk.n_match)
            mask = base_mask & (nid1[:, None] == tid)
        else:
            mask = base_mask
        out = out + jnp.where(mask, val, 0.0)
    return out


def mean_vector(
    mean_fn,
    theta: jax.Array,
    X: jax.Array,
    nid: jax.Array,
    multi_indices: Sequence[MultiIndex],
) -> jax.Array:
    """Evaluate a mean function at derivative orders
    (``gptools/mean.py :: MeanFunction.__call__(X, n)`` counterpart).

    ``mean_fn`` is a `gptools_tpu.models.mean.MeanFunction`; returns (N,).
    """
    multi_indices = tuple(tuple(m) for m in multi_indices)
    dtype = jnp.result_type(X, theta, jnp.float32)
    out = jnp.zeros((X.shape[0],), dtype=dtype)
    for aid, a in enumerate(multi_indices):
        fn = mean_fn.block_fn(a)
        vals = jax.vmap(fn, in_axes=(0, None))(X, theta)
        out = out + jnp.where(nid == aid, vals.astype(dtype), 0.0)
    return out
