"""GP core: model spec, log evidence, prediction, and the user-facing wrapper.

Counterpart of ``gptools/core.py :: GaussianProcess`` (SURVEY.md
sections 1-3). The architecture splits the reference's single mutable class
into:

- `GPModel` — a *static* spec (kernel + noise kernel + mean function +
  parameter metadata) exposing pure, jittable functions of
  ``(theta, data)``: `log_prior`, `log_marginal`, `log_posterior`, the
  unconstrained-space `log_posterior_u` (what NUTS/HMC/SMC/ADVI drive), and
  `predict`. One differentiable log-evidence, many consumers — the
  reference's key invariant (SURVEY.md architectural fact 3) preserved under
  ``jit``/``vmap``/``pjit``.
- `GaussianProcess` — a thin stateful convenience wrapper with the
  reference's API surface (``add_data``, ``update_hyperparameters``,
  ``compute_K_L_alpha_ll``, ``optimize_hyperparameters``,
  ``sample_hyperparameter_posterior``, ``predict``, ``draw_sample``,
  ``compute_from_MCMC``, ``predict_MCMC``, ``compute_ll_matrix``,
  ``remove_outliers``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gptools_tpu.models.dataset import Dataset, DatasetBuilder
from gptools_tpu.models.mean import MeanFunction
from gptools_tpu.ops import assemble, evidence
from gptools_tpu.ops.derivs import normalize_multi_index
from gptools_tpu.ops.kernels import Kernel
from gptools_tpu.utils import bijectors as bij

__all__ = ["GPModel", "GaussianProcess", "Prediction"]

# Every f32 matrix product runs at full precision: on the GPU the default
# precision may round the operands to TF32 (about three decimal digits).
_HI = jax.lax.Precision.HIGHEST

class Prediction(NamedTuple):
    """Posterior predictive summary (reference ``predict`` return tuple)."""

    mean: jax.Array
    std: Optional[jax.Array] = None
    cov: Optional[jax.Array] = None


def _merge_multi_indices(base: Tuple, extra) -> Tuple:
    """Union of multi-index tables, preserving base ids."""
    table = list(base)
    for m in extra:
        if m not in table:
            table.append(m)
    return tuple(table)


class GPModel:
    """Static GP specification + pure likelihood/prediction functions.

    Parameter layout of the flat vector ``theta``:
    ``[kernel params | noise-kernel params | mean params]``, concatenated in
    the reference's order (``gptools/core.py`` concatenates k / noise_k / mu
    hyperparameters the same way via ``CombinedBounds`` list views).
    """

    def __init__(
        self,
        kernel: Kernel,
        noise_kernel: Optional[Kernel] = None,
        mean: Optional[MeanFunction] = None,
        diag_factor: float = 1e2,
        solve_dtype=None,
        cov_backend: str = "fused",
    ):
        self.kernel = kernel
        self.noise_kernel = noise_kernel
        self.mean = mean
        self.diag_factor = float(diag_factor)
        self.solve_dtype = solve_dtype
        if cov_backend not in ("auto", "generic", "fused"):
            raise ValueError(f"unknown cov_backend {cov_backend!r}")
        # "auto" is the older name of "fused"
        self.cov_backend = "generic" if cov_backend == "generic" else "fused"

        sizes = [kernel.num_params]
        sizes.append(noise_kernel.num_params if noise_kernel else 0)
        sizes.append(mean.num_params if mean else 0)
        self._sizes = tuple(sizes)
        self._offsets = (0, sizes[0], sizes[0] + sizes[1])
        self.num_params = sum(sizes)

        from gptools_tpu.utils.bounds import CombinedBounds

        names = [f"k.{n}" for n in kernel.param_names]
        fixed = list(kernel.fixed_params)
        bound_views = [kernel.param_bounds]
        init = list(kernel.initial_params)
        if noise_kernel:
            names += [f"noise.{n}" for n in noise_kernel.param_names]
            fixed += list(noise_kernel.fixed_params)
            bound_views.append(noise_kernel.param_bounds)
            init += list(noise_kernel.initial_params)
        if mean:
            names += [f"mu.{n}" for n in mean.param_names]
            fixed += list(mean.fixed_params)
            bound_views.append(mean.param_bounds)
            init += list(mean.initial_params)
        self.param_names = tuple(names)
        self.fixed_params = tuple(fixed)
        # live view over the components' own (mutable) bounds lists, the
        # reference's CombinedBounds semantics: writing through this view
        # mutates the owning kernel/mean. Bounds are host-side metadata —
        # bijectors/hyperpriors snapshot them when THEY are built.
        self.param_bounds = CombinedBounds(*bound_views)
        self.initial_params = tuple(init)
        self.free_idx = tuple(i for i, f in enumerate(self.fixed_params) if not f)
        self.num_free_params = len(self.free_idx)

        parts = [kernel.hyperprior]
        if noise_kernel and noise_kernel.num_params:
            parts.append(noise_kernel.hyperprior)
        if mean and mean.num_params and mean.hyperprior is not None:
            parts.append(mean.hyperprior)
        prior = parts[0]
        for p in parts[1:]:
            prior = prior * p
        self.hyperprior = prior
        self.bijector = prior.bijector()

    # -- theta slicing ------------------------------------------------------
    def _theta_k(self, theta):
        return theta[: self._sizes[0]]

    def _theta_noise(self, theta):
        o = self._offsets[1]
        return theta[o : o + self._sizes[1]]

    def _theta_mean(self, theta):
        o = self._offsets[2]
        return theta[o : o + self._sizes[2]]

    # -- free/fixed embedding -----------------------------------------------
    def embed_free(self, theta_free: jax.Array) -> jax.Array:
        """Scatter free parameters into the full vector (fixed at initial)."""
        full = jnp.asarray(self.initial_params, dtype=theta_free.dtype)
        if self.num_free_params == self.num_params:
            return theta_free
        return full.at[jnp.asarray(self.free_idx)].set(theta_free)

    def extract_free(self, theta_full: jax.Array) -> jax.Array:
        if self.num_free_params == self.num_params:
            return theta_full
        return theta_full[jnp.asarray(self.free_idx)]

    # -- unconstrained space -------------------------------------------------
    def u_of_theta(self, theta_full: jax.Array) -> jax.Array:
        return self.extract_free(self.bijector.inverse(theta_full))

    def theta_of_u(self, u_free: jax.Array) -> jax.Array:
        u0 = self.bijector.inverse(
            jnp.asarray(self.initial_params, dtype=u_free.dtype)
        )
        if self.num_free_params == self.num_params:
            u_full = u_free
        else:
            u_full = u0.at[jnp.asarray(self.free_idx)].set(u_free)
        return self.bijector.forward(u_full)

    # -- densities -----------------------------------------------------------
    def log_prior(self, theta_full: jax.Array) -> jax.Array:
        return self.hyperprior.log_prob(theta_full)

    def _check_matern_nu_support(self, data: Dataset) -> None:
        """Free-nu Matern + derivative observations need nu > 1 everywhere the
        sampler/optimizer can reach: the (1,1) covariance block diverges at
        coincident points for nu <= 1 (no mean-square derivative), so a prior
        or bound that admits nu <= 1 makes the likelihood silently -inf/NaN
        mid-run. Hard-warns once per model on static metadata (a warning
        rather than an error because direct evidence evaluation at a safe nu
        remains legitimate).
        """
        from gptools_tpu.ops.kernels import MaternGeneralKernel

        if getattr(self, "_nu_support_warned", False):
            return
        if not isinstance(self.kernel, MaternGeneralKernel):
            return
        if all(sum(m) == 0 for m in data.multi_indices):
            return  # value-only data: any nu > 0 is fine
        i_nu = self.kernel.param_names.index("nu")
        lo_bound = float(self.kernel.param_bounds[i_nu][0])
        lo_prior = float(self.kernel.hyperprior.bounds[i_nu][0])
        # MCMC explores the prior's support (the bijector comes from the
        # prior); MAP respects param_bounds — both must exclude nu <= 1.
        lo = min(lo_bound, lo_prior)
        if lo <= 1.0:
            import warnings

            self._nu_support_warned = True
            warnings.warn(
                "MaternGeneralKernel with derivative observations requires "
                "nu > 1 wherever the sampler/optimizer can reach (the (1,1) "
                "covariance block diverges at coincidence for nu <= 1), but "
                f"the searchable nu lower bound is {lo:.4g} (param_bounds "
                f"{lo_bound:.4g}, prior support {lo_prior:.4g}). Tighten the "
                "nu prior/bounds to (1 + delta, hi) — e.g. "
                "UniformJointPrior([1.01], [30.0]) — or use the fixed "
                "half-integer MaternKernel.",
                stacklevel=3,
            )

    def _latent_cov(self, theta, data: Dataset, include_noise: bool):
        """K over the latent grid: kernel (+ noise kernel if requested).

        The smooth part dispatches to the fused flagship builders
        (`gptools_tpu.ops.fused`, single-pass shared-subexpression formulas)
        when the kernel/data support them (``cov_backend="fused"``, the
        default); "generic" forces the autodiff assembly.
        """
        from gptools_tpu.ops import fused

        self._check_matern_nu_support(data)
        if self.cov_backend != "generic" and fused.fused_supported(
            self.kernel, data.multi_indices, data.num_dim
        ):
            Kff = fused.flagship_cov(
                self.kernel,
                self._theta_k(theta),
                data.Xf,
                data.nid,
                data.multi_indices,
            )
            # generic path still supplies any delta terms inside the kernel
            if self.kernel.delta_terms():
                Kff = Kff + assemble.delta_matrix(
                    self.kernel,
                    self._theta_k(theta),
                    data.Xf,
                    data.nid,
                    data.Xf,
                    data.nid,
                    data.multi_indices,
                )
        else:
            Kff = assemble.cov_matrix(
                self.kernel,
                self._theta_k(theta),
                data.Xf,
                data.nid,
                data.Xf,
                data.nid,
                data.multi_indices,
            )
        if include_noise and self.noise_kernel is not None:
            Kff = Kff + assemble.cov_matrix(
                self.noise_kernel,
                self._theta_noise(theta),
                data.Xf,
                data.nid,
                data.Xf,
                data.nid,
                data.multi_indices,
            )
        return Kff

    def _latent_mean(self, theta, data: Dataset):
        if self.mean is None:
            return jnp.zeros_like(data.y if data.T is None else data.Xf[:, 0])
        return assemble.mean_vector(
            self.mean,
            self._theta_mean(theta),
            data.Xf,
            data.nid,
            data.multi_indices,
        )

    def obs_cov_and_resid(self, theta_full: jax.Array, data: Dataset):
        """Observation-space covariance (incl. noise + err_y) and residual."""
        Kff = self._latent_cov(theta_full, data, include_noise=True)
        mu = self._latent_mean(theta_full, data)
        if data.T is not None:
            Kobs = jnp.matmul(
                jnp.matmul(data.T, Kff, precision=_HI), data.T.T, precision=_HI
            )
            mu_obs = jnp.matmul(data.T, mu, precision=_HI)
        else:
            Kobs = Kff
            mu_obs = mu
        Kobs = Kobs + jnp.diag(data.err_y * data.err_y)
        r = data.y - mu_obs
        return Kobs, r

    @staticmethod
    def _noise_floor(data: Dataset, dtype):
        """The smallest observation-noise variance on K's diagonal: the
        evidence's jitter only tops the diagonal up past it."""
        return jnp.min(data.err_y * data.err_y).astype(dtype)

    def compute_K_L_alpha_ll(
        self, theta_full: jax.Array, data: Dataset
    ) -> evidence.CholState:
        """The reference hot path
        (``gptools/core.py :: compute_K_L_alpha_ll``): build K, Cholesky,
        alpha, log marginal likelihood. Pure and differentiable."""
        Kobs, r = self.obs_cov_and_resid(theta_full, data)
        if self.solve_dtype is not None:
            Kobs = Kobs.astype(self.solve_dtype)
            r = r.astype(self.solve_dtype)
        return evidence.gaussian_loglik(
            Kobs, r, self.diag_factor, self._noise_floor(data, Kobs.dtype)
        )

    def log_marginal(self, theta_full: jax.Array, data: Dataset) -> jax.Array:
        # analytic-VJP scalar path: same value as compute_K_L_alpha_ll().ll,
        # but the backward pass reuses the factor (dll/dK = (aa^T - K^-1)/2)
        # instead of differentiating through the Cholesky — ~8x cheaper
        # gradient at bench shapes (ops/evidence.py :: loglik)
        Kobs, r = self.obs_cov_and_resid(theta_full, data)
        if self.solve_dtype is not None:
            Kobs = Kobs.astype(self.solve_dtype)
            r = r.astype(self.solve_dtype)
        return evidence.loglik(
            Kobs, r, self.diag_factor, self._noise_floor(data, Kobs.dtype)
        )

    def log_posterior(self, theta_full: jax.Array, data: Dataset) -> jax.Array:
        lp = self.log_prior(theta_full)
        ll = jnp.where(
            jnp.isfinite(lp), self.log_marginal(theta_full, data), 0.0
        )
        return lp + ll

    # -- chains-minor batched evidence (the sampler hot path) ----------------
    def _batch_supported(self, data: Dataset) -> bool:
        from gptools_tpu.ops import fused

        return fused.fused_supported(
            self.kernel, data.multi_indices, data.num_dim
        ) and not self.kernel.delta_terms()

    def log_marginal_batch(self, thetas: jax.Array, data: Dataset) -> jax.Array:
        """Batched log marginal likelihood: thetas (C, P) -> (C,).

        Identical values/gradients to ``vmap(log_marginal)`` but built
        chains-minor: the covariance, factorization, solves, and the analytic
        VJP all keep the chain axis minormost, so every step of the loops is
        a contiguous vector op over chains (ops/evidence.py :: loglik_b).
        Falls back to the vmapped per-chain path for kernels/data the fused
        builders don't cover. Under a chain-sharded input, GSPMD partitions
        it over the mesh like any other jitted XLA computation.
        """
        from gptools_tpu.ops import fused

        if not self._batch_supported(data):
            return jax.vmap(lambda t: self.log_marginal(t, data))(thetas)
        self._check_matern_nu_support(data)
        thetaT = thetas.T  # (P, C) full rows; the kernel slice is a prefix
        thetaT_k = self._theta_k(thetaT)  # (Pk, C) slice of (P, C)
        Kff = fused.flagship_cov_soa(
            self.kernel, thetaT_k, data.Xf, data.nid, data.multi_indices
        )  # (N, N, C)
        C = thetas.shape[0]
        if self.noise_kernel is not None:
            Kn = jax.vmap(
                lambda t: assemble.cov_matrix(
                    self.noise_kernel,
                    self._theta_noise(t),
                    data.Xf,
                    data.nid,
                    data.Xf,
                    data.nid,
                    data.multi_indices,
                )
            )(thetas)
            Kff = Kff + jnp.moveaxis(Kn, 0, -1)
        if self.mean is not None:
            mu = jnp.moveaxis(
                jax.vmap(lambda t: self._latent_mean(t, data))(thetas), 0, -1
            )  # (N, C)
        else:
            mu = jnp.zeros(
                (Kff.shape[0], 1), Kff.dtype
            )  # broadcasts over chains
        if data.T is not None:
            Kobs = jnp.einsum(
                "mi,ijc,nj->mnc", data.T, Kff, data.T, optimize=True,
                precision=_HI,
            )
            mu_obs = jnp.matmul(data.T, mu, precision=_HI)
        else:
            Kobs = Kff
            mu_obs = mu
        err = data.err_y * data.err_y
        Kobs = Kobs + jnp.diag(err)[:, :, None]
        r = data.y[:, None] - mu_obs  # (N, C)
        if self.solve_dtype is not None:
            Kobs = Kobs.astype(self.solve_dtype)
            r = r.astype(self.solve_dtype)
        r = jnp.broadcast_to(r, (Kobs.shape[0], Kobs.shape[-1]))
        return evidence.loglik_b(
            Kobs, r, self.diag_factor, self._noise_floor(data, Kobs.dtype)
        )

    def log_posterior_batch(self, thetas: jax.Array, data: Dataset) -> jax.Array:
        lp = jax.vmap(self.log_prior)(thetas)
        ll = jnp.where(
            jnp.isfinite(lp), self.log_marginal_batch(thetas, data), 0.0
        )
        return lp + ll

    def log_posterior_u_batch(self, us: jax.Array, data: Dataset) -> jax.Array:
        """Batched unconstrained-space log posterior: us (C, Pf) -> (C,).

        The bijector/prior work is per-chain tiny (P ~ 5-12 elementwise ops)
        and stays vmapped; the evidence runs chains-minor.
        """
        u0 = self.bijector.inverse(
            jnp.asarray(self.initial_params, dtype=us.dtype)
        )
        if self.num_free_params == self.num_params:
            u_full = us
        else:
            u_full = jnp.broadcast_to(
                u0, (us.shape[0], self.num_params)
            ).at[:, jnp.asarray(self.free_idx)].set(us)
        thetas = jax.vmap(self.bijector.forward)(u_full)
        ldj = jax.vmap(self.bijector.log_det_jac)(u_full)
        return self.log_posterior_batch(thetas, data) + ldj

    def log_posterior_u(self, u_free: jax.Array, data: Dataset) -> jax.Array:
        """Unconstrained-space log posterior = ll + prior + log|det J|.

        This is the single scalar function every inference algorithm in
        `gptools_tpu.infer` drives (MAP ascends it; NUTS/HMC leapfrog on its
        gradient; SMC tempers it; ADVI lower-bounds it).
        """
        u0 = self.bijector.inverse(
            jnp.asarray(self.initial_params, dtype=u_free.dtype)
        )
        if self.num_free_params == self.num_params:
            u_full = u_free
        else:
            u_full = u0.at[jnp.asarray(self.free_idx)].set(u_free)
        theta = self.bijector.forward(u_full)
        ldj = self.bijector.log_det_jac(u_full)
        return self.log_posterior(theta, data) + ldj

    # -- prediction -----------------------------------------------------------
    def _star_ids(self, data: Dataset, Xstar, nstar):
        """Normalize star inputs/orders against the data's multi-index table."""
        Xstar = jnp.atleast_2d(jnp.asarray(Xstar))
        if Xstar.shape[-1] != data.num_dim:
            if data.num_dim == 1:
                Xstar = Xstar.reshape(-1, 1)
            else:
                raise ValueError("Xstar dimensionality mismatch")
        ns = Xstar.shape[0]
        arr = np.asarray(nstar)
        if arr.ndim == 0:
            mis = [normalize_multi_index(int(arr), data.num_dim)] * ns
        elif arr.ndim == 1 and data.num_dim == 1:
            if len(arr) == 1:
                mis = [normalize_multi_index(int(arr[0]), 1)] * ns
            else:
                mis = [normalize_multi_index(int(v), 1) for v in arr]
        elif arr.ndim == 1 and len(arr) == data.num_dim:
            mis = [normalize_multi_index([int(v) for v in arr], data.num_dim)] * ns
        elif arr.ndim == 2:
            mis = [
                normalize_multi_index([int(v) for v in row], data.num_dim)
                for row in arr
            ]
        else:
            raise ValueError("bad nstar")
        table = _merge_multi_indices(data.multi_indices, mis)
        sid = jnp.asarray([table.index(m) for m in mis], dtype=jnp.int32)
        return Xstar, sid, table

    def predict(
        self,
        theta_full: jax.Array,
        data: Dataset,
        Xstar,
        n=0,
        noise: bool = False,
        return_std: bool = True,
        return_cov: bool = False,
        output_transform: Optional[jax.Array] = None,
        state: Optional[evidence.CholState] = None,
    ) -> Prediction:
        """Posterior predictive at ``Xstar`` with derivative orders ``n``
        (``gptools/core.py :: GaussianProcess.predict``).

        ``noise=True`` includes the noise kernel in the *predictive*
        covariance (reference semantics); ``output_transform`` post-multiplies
        the prediction by a matrix O (predicting line integrals etc.,
        reference ``output_transform=``).
        """
        Xstar_a, sid, table = self._star_ids(data, Xstar, n)
        if state is None:
            state = self.compute_K_L_alpha_ll(theta_full, data)

        tk = self._theta_k(theta_full)
        Ksf = assemble.cov_matrix(
            self.kernel, tk, Xstar_a, sid, data.Xf, data.nid, table
        )
        if noise and self.noise_kernel is not None:
            Ksf = Ksf + assemble.cov_matrix(
                self.noise_kernel,
                self._theta_noise(theta_full),
                Xstar_a,
                sid,
                data.Xf,
                data.nid,
                table,
            )
        if data.T is not None:
            Ks_obs = jnp.matmul(Ksf, data.T.T, precision=_HI)
        else:
            Ks_obs = Ksf

        mu_star = jnp.zeros((Xstar_a.shape[0],), dtype=Ks_obs.dtype)
        if self.mean is not None:
            mu_star = assemble.mean_vector(
                self.mean, self._theta_mean(theta_full), Xstar_a, sid, table
            )

        mean = mu_star + jnp.matmul(Ks_obs, state.alpha, precision=_HI)

        std = cov = None
        if return_std or return_cov:
            Kss = assemble.cov_matrix(
                self.kernel, tk, Xstar_a, sid, Xstar_a, sid, table
            )
            if noise and self.noise_kernel is not None:
                Kss = Kss + assemble.cov_matrix(
                    self.noise_kernel,
                    self._theta_noise(theta_full),
                    Xstar_a,
                    sid,
                    Xstar_a,
                    sid,
                    table,
                )
            V = jax.scipy.linalg.solve_triangular(
                state.L, Ks_obs.T, lower=True
            )
            cov = Kss - jnp.matmul(V.T, V, precision=_HI)

        if output_transform is not None:
            O = jnp.asarray(output_transform, dtype=mean.dtype)
            mean = jnp.matmul(O, mean, precision=_HI)
            if cov is not None:
                cov = jnp.matmul(
                    jnp.matmul(O, cov, precision=_HI), O.T, precision=_HI
                )
        if (return_std or return_cov) and cov is not None:
            std = jnp.sqrt(jnp.clip(jnp.diagonal(cov), 0.0))
        return Prediction(
            mean=mean,
            std=std if return_std else None,
            cov=cov if return_cov else None,
        )

    def draw_sample(
        self,
        key: jax.Array,
        theta_full: jax.Array,
        data: Dataset,
        Xstar,
        n=0,
        num_samp: int = 1,
        method: str = "cholesky",
        num_eig: Optional[int] = None,
        modify_sign: bool = False,
        noise: bool = False,
        output_transform: Optional[jax.Array] = None,
        state: Optional[evidence.CholState] = None,
    ) -> jax.Array:
        """Draw joint posterior function samples
        (``gptools/core.py :: GaussianProcess.draw_sample``); returns
        (num_points, num_samp) like the reference. ``modify_sign`` fixes the
        eigenvector sign gauge (largest-|component| positive) so draws are
        comparable across hyperparameter samples (reference ``modify_sign``).
        """
        pred = self.predict(
            theta_full,
            data,
            Xstar,
            n=n,
            noise=noise,
            return_std=False,
            return_cov=True,
            output_transform=output_transform,
            state=state,
        )
        mean, cov = pred.mean, pred.cov
        m = mean.shape[0]
        z = jax.random.normal(key, (m, int(num_samp)), dtype=mean.dtype)
        if method == "cholesky":
            L = evidence.chol_factor(cov, self.diag_factor)
            draws = mean[:, None] + jnp.matmul(L, z, precision=_HI)
        elif method == "eig":
            w, V = jnp.linalg.eigh(cov)
            if num_eig is not None:
                k = int(num_eig)
                w = w[..., -k:]
                V = V[..., -k:]
                z = z[: w.shape[-1], :]
            if modify_sign:
                # gauge fix: flip each eigenvector so its largest-magnitude
                # component is positive (reference modify_sign behavior)
                idx = jnp.argmax(jnp.abs(V), axis=0)
                signs = jnp.sign(V[idx, jnp.arange(V.shape[1])])
                V = V * jnp.where(signs == 0, 1.0, signs)[None, :]
            w = jnp.clip(w, 0.0)
            draws = mean[:, None] + jnp.matmul(
                V, jnp.sqrt(w)[:, None] * z, precision=_HI
            )
        else:
            raise ValueError(f"unknown method {method!r}")
        return draws


class GaussianProcess:
    """Stateful convenience wrapper with the reference's API surface.

    Example (mirrors the reference's canonical usage):

        >>> k = SquaredExponentialKernel()
        >>> gp = GaussianProcess(k)
        >>> gp.add_data(x, y, err_y=err)
        >>> gp.add_data(0.0, 0.0, n=1)         # slope constraint at the edge
        >>> gp.optimize_hyperparameters()
        >>> yhat, std = gp.predict(xstar)
    """

    def __init__(
        self,
        k: Kernel,
        noise_k: Optional[Kernel] = None,
        mu: Optional[MeanFunction] = None,
        diag_factor: float = 1e2,
        solve_dtype=None,
    ):
        self.model = GPModel(
            k,
            noise_kernel=noise_k,
            mean=mu,
            diag_factor=diag_factor,
            solve_dtype=solve_dtype,
        )
        self.builder = DatasetBuilder(k.num_dim)
        self._data: Optional[Dataset] = None
        self.theta = jnp.asarray(self.model.initial_params)
        self._state: Optional[evidence.CholState] = None
        self.sample_result = None  # last MCMC/SMC result

    # -- data ---------------------------------------------------------------
    @property
    def num_dim(self):
        return self.model.kernel.num_dim

    @property
    def X(self):
        """Latent evaluation points (reference ``GaussianProcess.X``)."""
        return self.data.Xf

    @property
    def y(self):
        return self.data.y

    @property
    def err_y(self):
        return self.data.err_y

    @property
    def n(self):
        """Derivative multi-indices per latent point (reference ``n``)."""
        import numpy as _np

        return _np.asarray(
            [self.data.multi_indices[i] for i in _np.asarray(self.data.nid)]
        )

    @property
    def T(self):
        return self.data.T

    @property
    def K(self):
        """Observation covariance at the current hyperparameters."""
        Kobs, _ = self.model.obs_cov_and_resid(self.theta, self.data)
        return Kobs

    @property
    def L(self):
        return self.compute_K_L_alpha_ll().L

    @property
    def alpha(self):
        return self.compute_K_L_alpha_ll().alpha

    @property
    def params(self):
        """Current hyperparameter values (reference ``params`` view)."""
        return self.theta

    @property
    def free_params(self):
        return self.model.extract_free(self.theta)

    @free_params.setter
    def free_params(self, value):
        self.theta = self.model.embed_free(jnp.asarray(value))
        self._state = None

    @property
    def param_names(self):
        return self.model.param_names

    @property
    def free_param_names(self):
        return tuple(
            self.model.param_names[i] for i in self.model.free_idx
        )

    @property
    def param_bounds(self):
        """Concatenated per-component bounds (reference ``param_bounds``
        ``CombinedBounds`` view): writes go through to the owning
        kernel/mean. Host-side metadata only — the jitted paths use
        bijectors/hyperpriors, which snapshot bounds when built."""
        return self.model.param_bounds

    @property
    def free_param_bounds(self):
        """Bounds of the free parameters (reference ``free_param_bounds``
        ``MaskedBounds`` view); writes go through to the owning component."""
        from gptools_tpu.utils.bounds import MaskedBounds

        return MaskedBounds(self.model.param_bounds, self.model.free_idx)

    @property
    def hyperprior(self):
        return self.model.hyperprior

    @property
    def k(self):
        return self.model.kernel

    @property
    def noise_k(self):
        return self.model.noise_kernel

    @property
    def mu(self):
        return self.model.mean

    def add_data(self, X, y, err_y=0.0, n=0, T=None):
        self.builder.add(X, y, err_y=err_y, n=n, T=T)
        self._data = None
        self._state = None
        return self

    @property
    def data(self) -> Dataset:
        if self._data is None:
            self._data = self.builder.build()
        return self._data

    def remove_outliers(self, thresh: float = 3.0):
        """Drop direct observations whose standardized residual exceeds
        ``thresh`` (``gptools/core.py :: remove_outliers``), then refresh.
        Returns the number of removed points."""
        data = self.data
        if data.T is not None:
            raise NotImplementedError(
                "remove_outliers with transformed observations is not supported"
            )
        pred = self.model.predict(
            self.theta, data, np.asarray(data.Xf), n=0, return_std=True
        )
        err = np.asarray(data.err_y)
        resid = np.abs(np.asarray(data.y) - np.asarray(pred.mean))
        scale = np.sqrt(err**2 + np.asarray(pred.std) ** 2)
        keep = resid <= thresh * np.maximum(scale, 1e-300)
        n_removed = int((~keep).sum())
        if n_removed:
            nb = DatasetBuilder(data.num_dim)
            mi_arr = [data.multi_indices[i] for i in np.asarray(data.nid)]
            Xk = np.asarray(data.Xf)[keep]
            yk = np.asarray(data.y)[keep]
            ek = np.asarray(data.err_y)[keep]
            nk = np.asarray([mi_arr[i] for i in np.where(keep)[0]])
            nb.add(Xk, yk, err_y=ek, n=nk)
            self.builder = nb
            self._data = None
            self._state = None
        return n_removed

    # -- likelihood ---------------------------------------------------------
    def update_hyperparameters(self, theta_full) -> jax.Array:
        """Set parameters and return the NEGATIVE log posterior density
        (reference semantics: the MAP objective,
        ``gptools/core.py :: update_hyperparameters``)."""
        self.theta = jnp.asarray(theta_full)
        self._state = None
        ll = self.model.log_marginal(self.theta, self.data)
        lp = self.model.log_prior(self.theta)
        return -(ll + lp)

    def compute_K_L_alpha_ll(self) -> evidence.CholState:
        if self._state is None:
            self._state = self.model.compute_K_L_alpha_ll(self.theta, self.data)
        return self._state

    @property
    def ll(self):
        return self.compute_K_L_alpha_ll().ll

    # -- inference ----------------------------------------------------------
    def optimize_hyperparameters(
        self, random_starts: int = 8, key=None, **opt_kwargs
    ):
        """Multi-start MAP (``gptools/core.py :: optimize_hyperparameters``).

        The reference fanned starts over a multiprocessing pool running
        SLSQP; here starts are drawn from the hyperprior and optimized
        *vectorized on-chip* with L-BFGS under ``vmap``
        (`gptools_tpu.infer.map_fit`)."""
        from gptools_tpu.infer import map_fit

        if key is None:
            key = jax.random.PRNGKey(0)
        result = map_fit.optimize(
            self.model, self.data, key, random_starts=random_starts, **opt_kwargs
        )
        self.theta = result.theta
        self._state = None
        return result

    def sample_hyperparameter_posterior(
        self,
        nsamp: int = 1000,
        burn: int = 500,
        num_chains: int = 8,
        sampler: str = "nuts",
        sampler_type: Optional[str] = None,
        thin: int = 1,
        key=None,
        **kwargs,
    ):
        """Sample the hyperparameter posterior
        (``gptools/core.py :: sample_hyperparameter_posterior``), replacing
        emcee's ensemble walkers with vectorized NUTS/HMC chains or SMC
        (`gptools_tpu.infer`). Reference spellings accepted: ``sampler_type``
        ('ensemble'/'pt'), ``nwalkers`` (-> num_chains), ``ntemps``
        (-> num_temps), ``thin``; ``num_proc`` is ignored (parallelism is
        the chains axis, not worker processes)."""
        from gptools_tpu.infer import run_sampler

        if sampler_type is not None:  # reference spelling
            sampler = {"ensemble": "nuts"}.get(sampler_type, sampler_type)
        if "ntemps" in kwargs:  # reference PTSampler spelling
            kwargs["num_temps"] = kwargs.pop("ntemps")
        if "nwalkers" in kwargs:  # reference ensemble spelling
            num_chains = kwargs.pop("nwalkers")
        kwargs.pop("num_proc", None)  # no process pools here
        if key is None:
            key = jax.random.PRNGKey(0)
        result = run_sampler(
            self.model,
            self.data,
            key,
            sampler=sampler,
            num_chains=num_chains,
            num_samples=nsamp,
            num_warmup=burn,
            **kwargs,
        )
        if thin > 1:
            result = result._replace(
                u=result.u[:, ::thin],
                thetas=(
                    result.thetas[:, ::thin]
                    if result.thetas is not None
                    else None
                ),
                log_prob=result.log_prob[:, ::thin],
            )
        self.sample_result = result
        return result

    # -- prediction ---------------------------------------------------------
    def predict(
        self,
        Xstar,
        n=0,
        noise: bool = False,
        return_std: bool = True,
        return_cov: bool = False,
        output_transform=None,
        use_MCMC: bool = False,
        **mcmc_kwargs,
    ):
        """Reference-compatible prediction. Returns ``(mean, std)`` by
        default, ``(mean, cov)`` with ``return_cov``, or just ``mean``."""
        if use_MCMC:
            return self.predict_MCMC(
                Xstar,
                n=n,
                noise=noise,
                return_std=return_std,
                return_cov=return_cov,
                output_transform=output_transform,
                **mcmc_kwargs,
            )
        state = self.compute_K_L_alpha_ll()
        pred = self.model.predict(
            self.theta,
            self.data,
            Xstar,
            n=n,
            noise=noise,
            return_std=return_std or return_cov,
            return_cov=return_cov,
            output_transform=output_transform,
            state=state,
        )
        if return_cov:
            return pred.mean, pred.cov
        if return_std:
            return pred.mean, pred.std
        return pred.mean

    def draw_sample(self, Xstar, num_samp: int = 1, key=None, **kwargs):
        if key is None:
            key = jax.random.PRNGKey(0)
        state = self.compute_K_L_alpha_ll()
        return self.model.draw_sample(
            key,
            self.theta,
            self.data,
            Xstar,
            num_samp=num_samp,
            state=state,
            **kwargs,
        )

    # -- fully-Bayesian prediction -------------------------------------------
    def compute_from_MCMC(self, Xstar, thetas=None, n=0, noise=False, thin=1):
        """Per-posterior-sample predictions
        (``gptools/core.py :: compute_from_MCMC``): the reference fanned a
        multiprocessing pool over samples, each worker redoing K build +
        Cholesky; here it is one ``vmap`` with batched Cholesky."""
        if thetas is None:
            if self.sample_result is None:
                raise ValueError("no MCMC samples available; run "
                                 "sample_hyperparameter_posterior first")
            thetas = self.sample_result.thetas.reshape(-1, self.model.num_params)
        thetas = jnp.asarray(thetas)[::thin]

        def one(theta):
            pred = self.model.predict(
                theta, self.data, Xstar, n=n, noise=noise,
                return_std=True, return_cov=False,
            )
            return pred.mean, pred.std

        means, stds = jax.vmap(one)(thetas)
        return means, stds

    def predict_MCMC(
        self,
        Xstar,
        n=0,
        noise=False,
        return_std=True,
        return_cov=False,
        output_transform=None,
        thetas=None,
        thin=1,
    ):
        """Marginalized predictive moments over the hyperparameter posterior
        (``gptools/core.py :: predict_MCMC``): law of total
        mean/variance over posterior samples."""
        if thetas is None:
            if self.sample_result is None:
                raise ValueError("no MCMC samples available")
            thetas = self.sample_result.thetas.reshape(-1, self.model.num_params)
        thetas = jnp.asarray(thetas)[::thin]

        want_cov = return_cov

        def one(theta):
            pred = self.model.predict(
                theta, self.data, Xstar, n=n, noise=noise,
                return_std=not want_cov, return_cov=want_cov,
                output_transform=output_transform,
            )
            return pred

        preds = jax.vmap(one)(thetas)
        mean = jnp.mean(preds.mean, axis=0)
        if want_cov:
            # E[cov] + cov of means
            dm = preds.mean - mean
            cov = jnp.mean(preds.cov, axis=0) + (
                jnp.matmul(dm.T, dm, precision=_HI)
            ) / preds.mean.shape[0]
            return mean, cov
        if return_std:
            var = jnp.mean(preds.std**2 + preds.mean**2, axis=0) - mean**2
            return mean, jnp.sqrt(jnp.clip(var, 0.0))
        return mean

    # -- serving --------------------------------------------------------------
    def freeze_predictor(self, bucket: int = 64):
        """Precompute (L, alpha) at the current hyperparameters and return a
        jitted low-latency predictor (`gptools_tpu.models.serve`)."""
        from gptools_tpu.models.serve import FrozenPredictor

        return FrozenPredictor(self.model, self.data, self.theta, bucket=bucket)

    def freeze_mcmc_predictor(self, thetas=None, max_samples: int = 512):
        """Precompute a batch of posterior states and return a jitted
        MCMC-marginalized envelope predictor."""
        from gptools_tpu.models.serve import FrozenMCMCPredictor

        if thetas is None:
            if self.sample_result is None:
                raise ValueError("no MCMC samples available")
            thetas = self.sample_result.thetas
        return FrozenMCMCPredictor(
            self.model, self.data, thetas, max_samples=max_samples
        )

    # -- diagnostics ---------------------------------------------------------
    def compute_ll_matrix(self, bounds: Sequence[tuple], num_pts) -> tuple:
        """Grid evaluation of the log posterior over free parameters
        (``gptools/core.py :: compute_ll_matrix``), vectorized with ``vmap``.

        Returns ``(ll_grid, axes)`` with ``ll_grid`` of shape ``num_pts``.
        """
        nf = self.model.num_free_params
        if len(bounds) != nf:
            raise ValueError(f"need {nf} bounds")
        if isinstance(num_pts, int):
            num_pts = [num_pts] * nf
        axes = [
            jnp.linspace(lo, hi, int(np_)) for (lo, hi), np_ in zip(bounds, num_pts)
        ]
        grids = jnp.meshgrid(*axes, indexing="ij")
        flat = jnp.stack([g.ravel() for g in grids], axis=-1)

        def lp(tf):
            theta = self.model.embed_free(tf)
            return self.model.log_posterior(theta, self.data)

        vals = jax.vmap(lp)(flat)
        return vals.reshape([int(v) for v in num_pts]), axes
