"""Observation container: derivative orders + linear-transform observations.

Counterpart of the data-management half of
``gptools/core.py :: GaussianProcess`` (``add_data``, ``X``, ``y``, ``err_y``,
``n``, ``T`` attributes — SURVEY.md section 1, architectural facts 1-2).

Canonical form (the key design decision): every observation is a
linear functional of latent function/derivative values,

    y = T f,    f_q = d^{n_q} f(X_q),   q = 1..Q  (latent evaluation points)

Direct observations are identity rows of ``T``; line-integral / quadrature
observations (``add_data(..., T=...)`` in the reference) are dense rows. When
no transformed observations exist ``T`` is ``None`` and the fast path
``K_obs = K_ff`` applies; otherwise ``K_obs = T K_ff T^T`` — two matmuls that
land straight on the matrix units, unifying what the reference special-cased across
its likelihood and prediction paths.

The builder runs host-side (numpy); `Dataset` is a frozen pytree with static
metadata (derivative multi-index table), so the finished dataset is jit/vmap
friendly with fully static shapes.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gptools_tpu.ops.derivs import MultiIndex, normalize_multi_index

__all__ = ["Dataset", "DatasetBuilder"]


@jax.tree_util.register_pytree_node_class
class Dataset:
    """Frozen observation set.

    Attributes:
      Xf: (Q, D) latent evaluation points.
      nid: (Q,) int32 ids into ``multi_indices``.
      y: (M,) observed values.
      err_y: (M,) homoscedastic/heteroscedastic observation noise stddevs
        (the reference's ``err_y``; added as a diagonal to K_obs).
      T: (M, Q) observation matrix or None (identity; then M == Q).
      multi_indices: static tuple of derivative multi-index tuples.
    """

    def __init__(self, Xf, nid, y, err_y, T, multi_indices: Tuple[MultiIndex, ...]):
        self.Xf = Xf
        self.nid = nid
        self.y = y
        self.err_y = err_y
        self.T = T
        self.multi_indices = tuple(tuple(m) for m in multi_indices)

    # -- pytree protocol ----------------------------------------------------
    def tree_flatten(self):
        return (self.Xf, self.nid, self.y, self.err_y, self.T), self.multi_indices

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, multi_indices=aux)

    # -- shapes -------------------------------------------------------------
    @property
    def num_obs(self) -> int:
        return self.y.shape[0]

    @property
    def num_latent(self) -> int:
        return self.Xf.shape[0]

    @property
    def num_dim(self) -> int:
        return self.Xf.shape[1]

    @property
    def has_transform(self) -> bool:
        return self.T is not None

    def astype(self, dtype) -> "Dataset":
        return Dataset(
            self.Xf.astype(dtype),
            self.nid,
            self.y.astype(dtype),
            self.err_y.astype(dtype),
            None if self.T is None else self.T.astype(dtype),
            self.multi_indices,
        )

    def __repr__(self):
        return (
            f"Dataset(M={self.num_obs}, Q={self.num_latent}, D={self.num_dim}, "
            f"orders={self.multi_indices}, transformed={self.has_transform})"
        )


class DatasetBuilder:
    """Accumulate observations host-side, then `build()` a static `Dataset`.

    Mirrors the call pattern of ``gptools/core.py :: GaussianProcess.add_data``:
    repeated calls append batches; ``n`` is a derivative order (scalar or
    per-dimension multi-index, scalar or per-point); ``T`` attaches a
    quadrature/weight matrix so the batch observes ``y = T f(X)``.
    """

    def __init__(self, num_dim: int = 1):
        self.num_dim = int(num_dim)
        self._X: list = []        # per-batch (B, D) latent points
        self._mi: list = []       # per-point multi-index tuples
        self._y: list = []
        self._err: list = []
        self._T: list = []        # per-batch (Mb, Qb) or None

    def _norm_X(self, X) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        if X.ndim == 0:
            X = X.reshape(1, 1)
        elif X.ndim == 1:
            if self.num_dim == 1:
                X = X.reshape(-1, 1)
            else:
                X = X.reshape(1, -1)
        if X.shape[1] != self.num_dim:
            raise ValueError(f"X has {X.shape[1]} dims, expected {self.num_dim}")
        return X

    def _norm_n(self, n, count: int) -> list:
        if n is None:
            n = 0
        arr = np.asarray(n)
        if arr.ndim == 0:
            return [normalize_multi_index(int(arr), self.num_dim)] * count
        if arr.ndim == 1:
            if self.num_dim == 1:
                if len(arr) != count:
                    raise ValueError("per-point n has wrong length")
                return [normalize_multi_index(int(v), 1) for v in arr]
            # single multi-index shared by the batch
            if len(arr) == self.num_dim:
                return [normalize_multi_index([int(v) for v in arr], self.num_dim)] * count
            raise ValueError("ambiguous n for multi-dimensional input")
        if arr.ndim == 2:
            if arr.shape != (count, self.num_dim):
                raise ValueError("per-point multi-index n has wrong shape")
            return [
                normalize_multi_index([int(v) for v in row], self.num_dim)
                for row in arr
            ]
        raise ValueError("n must be scalar, 1-D, or 2-D")

    def add(self, X, y, err_y=0.0, n=0, T=None):
        """Append a batch of observations (reference ``add_data``).

        Without ``T``: ``y[i]`` observes ``d^{n[i]} f(X[i])`` with noise
        stddev ``err_y[i]``. With ``T`` (shape (M, Q)): ``X`` are the Q
        quadrature points and ``y = T f(X)`` (M values), e.g. line integrals.
        """
        X = self._norm_X(X)
        q = X.shape[0]
        if T is not None:
            T = np.asarray(T, dtype=np.float64)
            if T.ndim == 1:
                T = T.reshape(1, -1)
            if T.shape[1] != q:
                raise ValueError(f"T has {T.shape[1]} cols, X has {q} rows")
            m = T.shape[0]
        else:
            m = q
        y = np.broadcast_to(np.asarray(y, dtype=np.float64), (m,)).copy()
        err = np.broadcast_to(np.asarray(err_y, dtype=np.float64), (m,)).copy()
        if np.any(err < 0):
            raise ValueError("err_y must be >= 0")
        mi = self._norm_n(n, q)
        self._X.append(X)
        self._mi.extend(mi)
        self._y.append(y)
        self._err.append(err)
        self._T.append(T)
        return self

    # reference spelling
    add_data = add

    @property
    def num_obs(self):
        return int(sum(len(y) for y in self._y))

    def build(self, dtype=None) -> Dataset:
        """Freeze into a `Dataset`. ``dtype=None`` uses the JAX default float
        (respects ``jax_enable_x64``)."""
        if not self._X:
            raise ValueError("no observations added")
        if dtype is None:
            dtype = jnp.asarray(0.0).dtype
        Xf = np.concatenate(self._X, axis=0)
        y = np.concatenate(self._y, axis=0)
        err = np.concatenate(self._err, axis=0)

        multi_indices = tuple(sorted(set(self._mi)))
        mi_to_id = {m: i for i, m in enumerate(multi_indices)}
        nid = np.asarray([mi_to_id[m] for m in self._mi], dtype=np.int32)

        any_T = any(t is not None for t in self._T)
        if any_T:
            Q = Xf.shape[0]
            M = y.shape[0]
            T = np.zeros((M, Q), dtype=np.float64)
            row = 0
            col = 0
            for Xb, Tb in zip(self._X, self._T):
                qb = Xb.shape[0]
                if Tb is None:
                    mb = qb
                    T[row : row + mb, col : col + qb] = np.eye(qb)
                else:
                    mb = Tb.shape[0]
                    T[row : row + mb, col : col + qb] = Tb
                row += mb
                col += qb
            T_j = jnp.asarray(T, dtype)
        else:
            T_j = None

        return Dataset(
            jnp.asarray(Xf, dtype),
            jnp.asarray(nid),
            jnp.asarray(y, dtype),
            jnp.asarray(err, dtype),
            T_j,
            multi_indices,
        )
