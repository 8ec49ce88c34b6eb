"""Fused covariance block math for the flagship kernels.

Why this exists: the generic assembly (`gptools_tpu.ops.assemble`) evaluates
each derivative block with its own autodiff tower, recomputing the
exponential / tanh warp per block. The evidence hot loop (NUTS leapfrog)
evaluates K and dK/dtheta hundreds of times per sample, so the covariance
build is worth hand-fusing: the formulas below compute the shared
subexpressions once and emit all four {value, slope} blocks in a single
elementwise pass. Written in plain jnp they are fully differentiable (exact
gradients for the samplers), and XLA fuses each build into one elementwise
kernel.

Correctness: pinned against the generic autodiff path to 1e-11 (f64) in
tests/test_fused.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "se_blocks",
    "se_blocks_d",
    "gibbs_tanh_blocks",
    "matern52_blocks",
    "matern52_blocks_d",
    "assemble_blocks",
    "se_cov_fused",
    "gibbs_tanh_cov_fused",
    "matern52_cov_fused",
    "se_cov_fused_soa",
    "gibbs_tanh_cov_fused_soa",
    "matern52_cov_fused_soa",
    "se_cov_fused_soa_sym",
    "gibbs_tanh_cov_fused_soa_sym",
    "matern52_cov_fused_soa_sym",
    "warped_cov_fused",
    "warped_cov_fused_soa_sym",
    "warp_coords",
    "beta_warp_pdf",
    "classify_flagship",
    "fused_supported",
    "flagship_cov",
    "flagship_cov_soa",
]

# Chains-minor builders compute only the upper triangle and mirror it when
# True (covariance symmetry: ~1.9x less transcendental/elementwise work per
# build at N = 27; see the *_soa_sym builders). Module-level so benches can
# A/B both paths; `flagship_cov_soa(symmetric=None)` reads it.
SOA_SYMMETRIC = True


def se_blocks_d(d, theta):
    """SE {value, slope} blocks from a precomputed (broadcast-compatible)
    separation ``d = x_row - x_col`` — shared by the static-coordinate tile
    builders and the input-warped builders (where d is chain-dependent)."""
    sf = theta[0]
    ell = theta[1]
    inv_l2 = 1.0 / (ell * ell)
    r2 = d * d * inv_l2
    e = sf * sf * jnp.exp(-0.5 * r2)
    k10 = -d * inv_l2 * e
    return e, k10, -k10, (1.0 - r2) * inv_l2 * e


def se_blocks(x_row, x_col, theta):
    """SE {value, slope} covariance blocks on a broadcasted (row, col) tile.

    x_row: (..., N, 1); x_col: (..., 1, M); theta: [sigma_f, l].
    Returns (k00, k10, k01, k11) with k10 = d/dx_row k etc.
    """
    return se_blocks_d(x_row - x_col, theta)


_SQRT5 = np.sqrt(5.0)


def matern52_blocks_d(d, theta):
    """Matern-5/2 {value, slope} blocks from a precomputed separation.

    k(d) = sf^2 (1 + s + s^2/3) e^{-s},  s = sqrt(5)|d|/l. The closed forms
    (k' = -sf^2 (5d/(3l^2))(1+s) e^{-s}; -k'' = sf^2 (5/(3l^2))(1+s-s^2)
    e^{-s}) are polynomial-times-exp in s — smooth at d = 0 (nu = 5/2 is
    exactly twice mean-square differentiable, so {0, 1}-order blocks are
    finite at coincidence; reference: gptools/kernel/matern.py ::
    Matern52Kernel, the hard-coded values+first-derivatives fast path)."""
    sf = theta[0]
    ell = theta[1]
    s = _SQRT5 * jnp.abs(d) / ell
    e = sf * sf * jnp.exp(-s)
    k00 = (1.0 + s + s * s / 3.0) * e
    g = (5.0 / 3.0) * (d / (ell * ell)) * (1.0 + s) * e
    k11 = (5.0 / (3.0 * ell * ell)) * (1.0 + s - s * s) * e
    return k00, -g, g, k11


def matern52_blocks(x_row, x_col, theta):
    """Matern-5/2 blocks on a broadcasted (row, col) tile (see
    `matern52_blocks_d`)."""
    return matern52_blocks_d(x_row - x_col, theta)


def _gibbs_pair_blocks(sf, la, dla, lb, dlb, d):
    """Post-warp Gibbs-tanh block math on broadcast-compatible operands
    (shared between the tile builders and the symmetric pairs builders)."""
    u = la * la
    v = lb * lb
    S = u + v
    inv_S = 1.0 / S
    d2 = d * d
    k = (sf * sf) * jnp.sqrt(2.0 * la * lb * inv_S) * jnp.exp(-d2 * inv_S)

    up = 2.0 * la * dla
    vp = 2.0 * lb * dlb
    inv_S2 = inv_S * inv_S
    common = -0.5 * inv_S + d2 * inv_S2
    g1 = up * (0.25 / u + common) - 2.0 * d * inv_S
    g2 = vp * (0.25 / v + common) + 2.0 * d * inv_S
    dg2dx = (
        vp * (0.5 * up * inv_S2 + 2.0 * d * inv_S2 - 2.0 * d2 * up * inv_S2 * inv_S)
        + 2.0 * inv_S
        - 2.0 * d * up * inv_S2
    )
    return k, g1 * k, g2 * k, (g1 * g2 + dg2dx) * k


def gibbs_tanh_blocks(x_row, x_col, theta):
    """Gibbs-tanh {value, slope} blocks (hand-derived: the warp l(x), l'(x)
    is evaluated once per point and shared by all four blocks)."""
    sf, l1, l2, lw, x0 = theta[0], theta[1], theta[2], theta[3], theta[4]

    def warp(x):
        t = jnp.tanh((x - x0) / lw)
        l = l1 + 0.5 * (l2 - l1) * (1.0 + t)
        dl = 0.5 * (l2 - l1) * (1.0 - t * t) / lw
        return l, dl

    la, dla = warp(x_row)
    lb, dlb = warp(x_col)
    return _gibbs_pair_blocks(sf, la, dla, lb, dlb, x_row - x_col)


def assemble_blocks(blocks, nid_row, nid_col):
    """Mask-combine the four blocks by derivative-order ids (0=value,
    1=slope; any other id contributes zero, used for padding)."""
    k00, k10, k01, k11 = blocks
    row_v = nid_row == 0
    col_v = nid_col == 0
    row_d = nid_row == 1
    col_d = nid_col == 1
    return jnp.where(
        row_v & col_v,
        k00,
        jnp.where(
            row_d & col_v,
            k10,
            jnp.where(row_v & col_d, k01, jnp.where(row_d & col_d, k11, 0.0)),
        ),
    )


def se_cov_fused(X, nid, theta):
    """(N,) + (N,) + (2,) -> (N, N), differentiable fused SE covariance."""
    x_r = X.reshape(-1, 1)
    x_c = X.reshape(1, -1)
    return assemble_blocks(
        se_blocks(x_r, x_c, theta), nid.reshape(-1, 1), nid.reshape(1, -1)
    )


def gibbs_tanh_cov_fused(X, nid, theta):
    """(N,) + (N,) + (5,) -> (N, N), differentiable fused Gibbs covariance."""
    x_r = X.reshape(-1, 1)
    x_c = X.reshape(1, -1)
    return assemble_blocks(
        gibbs_tanh_blocks(x_r, x_c, theta),
        nid.reshape(-1, 1),
        nid.reshape(1, -1),
    )


def se_cov_fused_soa(X, nid, thetaT):
    """Chains-minor batched fused SE covariance: (N,) points + (N,) order ids
    + (2, C) per-chain theta -> (N, N, C). The blocks/assembly formulas are
    shared with the per-chain path — only the broadcast axes differ (chain
    axis minormost, so every elementwise op runs chain-dense with no tile
    padding; see ops/evidence.py chains-minor comment)."""
    x_r = X.reshape(-1, 1, 1)
    x_c = X.reshape(1, -1, 1)
    return assemble_blocks(
        se_blocks(x_r, x_c, thetaT),
        nid.reshape(-1, 1, 1),
        nid.reshape(1, -1, 1),
    )


def gibbs_tanh_cov_fused_soa(X, nid, thetaT):
    """Chains-minor batched fused Gibbs covariance: (N,), (N,), (5, C) ->
    (N, N, C)."""
    x_r = X.reshape(-1, 1, 1)
    x_c = X.reshape(1, -1, 1)
    return assemble_blocks(
        gibbs_tanh_blocks(x_r, x_c, thetaT),
        nid.reshape(-1, 1, 1),
        nid.reshape(1, -1, 1),
    )


@functools.lru_cache(maxsize=64)
def _triu_index_maps(n: int):
    """Static index plumbing for the symmetric pairs builders: upper-triangle
    (row, col) index vectors of length Np = n(n+1)/2 and the (n, n) pair-id
    matrix that mirrors packed pair values back into a full matrix."""
    rows, cols = np.triu_indices(n)
    pid = np.zeros((n, n), np.int32)
    pid[rows, cols] = np.arange(rows.shape[0], dtype=np.int32)
    pid[cols, rows] = pid[rows, cols]
    return rows, cols, pid


def se_cov_fused_soa_sym(X, nid, thetaT):
    """Symmetric chains-minor fused SE covariance: compute only the
    Np = N(N+1)/2 upper-triangle pairs as a packed (Np, C) array, then
    mirror via a static gather. Same values as `se_cov_fused_soa` (K is
    symmetric: K[j,i] = K[i,j] for every derivative-order combination), but
    ~1.9x less O(N^2 C) elementwise/transcendental work in both the forward
    build and its VJP (the gather transposes to a pair-indexed scatter-add).
    The packed pair axis is chain-major/(pair, C)-shaped, so the chain axis
    stays minormost and tile-dense exactly like the full builder."""
    rows, cols, pid = _triu_index_maps(X.shape[0])
    x_r = X[rows][:, None]
    x_c = X[cols][:, None]
    vals = assemble_blocks(
        se_blocks(x_r, x_c, thetaT),
        nid[rows][:, None],
        nid[cols][:, None],
    )  # (Np, C)
    return vals[pid]


def gibbs_tanh_cov_fused_soa_sym(X, nid, thetaT):
    """Symmetric chains-minor fused Gibbs-tanh covariance (see
    `se_cov_fused_soa_sym`). The tanh warp is additionally hoisted OUT of
    the pair computation: l(x) and l'(x) are evaluated once per point on an
    (N, C) array and gathered per pair, so the pairs path does not repay the
    warp transcendentals per pair."""
    rows, cols, pid = _triu_index_maps(X.shape[0])
    sf, l1, l2, lw, x0 = thetaT[0], thetaT[1], thetaT[2], thetaT[3], thetaT[4]
    t = jnp.tanh((X[:, None] - x0) / lw)          # (N, C)
    l = l1 + 0.5 * (l2 - l1) * (1.0 + t)
    dl = 0.5 * (l2 - l1) * (1.0 - t * t) / lw
    d = (X[rows] - X[cols])[:, None]              # (Np, 1): chain-free
    blocks = _gibbs_pair_blocks(sf, l[rows], dl[rows], l[cols], dl[cols], d)
    vals = assemble_blocks(
        blocks, nid[rows][:, None], nid[cols][:, None]
    )  # (Np, C)
    return vals[pid]


def matern52_cov_fused(X, nid, theta):
    """(N,) + (N,) + (2,) -> (N, N), differentiable fused Matern-5/2."""
    x_r = X.reshape(-1, 1)
    x_c = X.reshape(1, -1)
    return assemble_blocks(
        matern52_blocks(x_r, x_c, theta), nid.reshape(-1, 1), nid.reshape(1, -1)
    )


def matern52_cov_fused_soa(X, nid, thetaT):
    """Chains-minor batched fused Matern-5/2: (N,), (N,), (2, C) -> (N, N, C)."""
    x_r = X.reshape(-1, 1, 1)
    x_c = X.reshape(1, -1, 1)
    return assemble_blocks(
        matern52_blocks(x_r, x_c, thetaT),
        nid.reshape(-1, 1, 1),
        nid.reshape(1, -1, 1),
    )


def matern52_cov_fused_soa_sym(X, nid, thetaT):
    """Symmetric chains-minor fused Matern-5/2 (see `se_cov_fused_soa_sym`)."""
    rows, cols, pid = _triu_index_maps(X.shape[0])
    x_r = X[rows][:, None]
    x_c = X[cols][:, None]
    vals = assemble_blocks(
        matern52_blocks(x_r, x_c, thetaT),
        nid[rows][:, None],
        nid[cols][:, None],
    )
    return vals[pid]


# ---------------------------------------------------------------------------
# Input-warped stationary kernels: k(w(x), w(x')) with derivative-order
# blocks chain-ruled through the warp slope w'(x) (reference:
# gptools/kernel/warping.py :: WarpedKernel; SURVEY.md section 2.1 input-
# warping row). The warped coordinate (and its slope, when derivative
# observations exist) is computed ONCE PER POINT and gathered per pair, so
# the O(N^2) pair stage never repays the warp transcendentals.
# ---------------------------------------------------------------------------

_BASE_BLOCKS_D = None  # set below (after the classifier) to avoid forward refs


def beta_warp_pdf(a, b, x):
    """Beta(a, b) density — the BetaWarp slope w'(x) for the chain-ruled
    derivative blocks. Broadcasts like `special.betainc_dd`."""
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    x = jnp.asarray(x)
    dtype = jnp.result_type(a, b, x, jnp.float32)
    xc = jnp.clip(x, 1e-12, 1.0 - 1e-12)
    log_beta = (
        jax.lax.lgamma(a.astype(dtype))
        + jax.lax.lgamma(b.astype(dtype))
        - jax.lax.lgamma((a + b).astype(dtype))
    )
    return jnp.exp(
        (a - 1.0) * jnp.log(xc) + (b - 1.0) * jnp.log1p(-xc) - log_beta
    )


def warp_coords(input_warp, X, theta_w, need_slope, chains_minor):
    """Per-point warped coordinates w(x) (and slope w'(x) when derivative
    observations exist). ``theta_w``: the warp's parameter rows — scalars for
    the per-chain path, (C,) rows for chains-minor. Returns (w, wp) shaped
    (N,)/(N, C) (wp None when not needed)."""
    from gptools_tpu.ops.kernels import BetaWarp, LinearWarp
    from gptools_tpu.ops.special import betainc_dd

    Xcol = X[:, None] if chains_minor else X
    if type(input_warp) is LinearWarp:
        scale = 1.0 / (input_warp.b - input_warp.a)
        w = (Xcol - input_warp.a) * scale
        wp = jnp.full_like(w, scale) if need_slope else None
        return w, wp
    if type(input_warp) is BetaWarp:
        a, b = theta_w[0], theta_w[1]
        w = betainc_dd(a, b, Xcol)
        wp = beta_warp_pdf(a, b, Xcol) if need_slope else None
        return w, wp
    raise ValueError(type(input_warp).__name__)


def warped_cov_fused(base_kind, input_warp, X, ids, theta):
    """Per-chain fused warped covariance: k_base(w(x), w(x')) with slope
    blocks scaled by w' (chain rule)."""
    pb = {"se": 2, "matern52": 2}[base_kind]
    base_th, theta_w = theta[:pb], theta[pb:]
    need_slope = True  # cheap per point; avoids lifting ids to host
    w, wp = warp_coords(input_warp, X, theta_w, need_slope, False)
    d = w[:, None] - w[None, :]
    k00, k10, k01, k11 = _BASE_BLOCKS_D[base_kind](d, base_th)
    k10 = k10 * wp[:, None]
    k01 = k01 * wp[None, :]
    k11 = k11 * (wp[:, None] * wp[None, :])
    return assemble_blocks(
        (k00, k10, k01, k11), ids.reshape(-1, 1), ids.reshape(1, -1)
    )


def warped_cov_fused_soa_sym(base_kind, input_warp, X, ids, thetaT):
    """Symmetric chains-minor fused warped covariance: (P, C) theta rows ->
    (N, N, C); warp evaluated once per point, pairs gathered (see
    `gibbs_tanh_cov_fused_soa_sym` for the hoisting rationale)."""
    pb = {"se": 2, "matern52": 2}[base_kind]
    base_th, theta_w = thetaT[:pb], thetaT[pb:]
    rows, cols, pid = _triu_index_maps(X.shape[0])
    need_slope = bool(np.any(np.asarray(ids) == 1))
    w, wp = warp_coords(input_warp, X, theta_w, need_slope, True)  # (N, C)
    d = w[rows] - w[cols]  # (Np, C)
    k00, k10, k01, k11 = _BASE_BLOCKS_D[base_kind](d, base_th)
    if wp is not None:
        k10 = k10 * wp[rows]
        k01 = k01 * wp[cols]
        k11 = k11 * (wp[rows] * wp[cols])
    vals = assemble_blocks(
        (k00, k10, k01, k11),
        np.asarray(ids)[rows][:, None],
        np.asarray(ids)[cols][:, None],
    )
    return vals[pid]


def classify_flagship(kernel):
    """Classify a kernel for the fused fast paths.

    Returns ``(kind, base_params, input_warp)`` with kind in
    {'se', 'gibbs_tanh', 'matern52'}, ``base_params`` the number of base-
    kernel parameter rows, and ``input_warp`` the InputWarp instance (None
    when unwarped) — or None when the kernel has no fused implementation.
    Gibbs cannot be input-warped (WarpedKernel wraps stationary bases)."""
    from gptools_tpu.ops.kernels import (
        BetaWarp,
        GibbsKernel,
        LinearWarp,
        MaternKernel,
        SquaredExponentialKernel,
        TanhWarp,
        WarpedKernel,
    )

    def base_kind(k):
        if type(k) is SquaredExponentialKernel and k.num_dim == 1:
            return "se"
        if isinstance(k, MaternKernel) and k.p == 2 and k.num_dim == 1:
            return "matern52"
        return None

    if isinstance(kernel, WarpedKernel):
        if type(kernel.input_warp) not in (BetaWarp, LinearWarp):
            return None
        kind = base_kind(kernel.base)
        if kind is None:
            return None
        return kind, kernel.base.num_params, kernel.input_warp
    if isinstance(kernel, GibbsKernel) and type(kernel.warp) is TanhWarp:
        return "gibbs_tanh", kernel.num_params, None
    kind = base_kind(kernel)
    if kind is None:
        return None
    return kind, kernel.num_params, None


_BASE_BLOCKS_D = {"se": se_blocks_d, "matern52": matern52_blocks_d}


def flagship_cov_soa(kernel, thetaT, X, nid, multi_indices, symmetric=None):
    """Chains-minor batched fused K: thetaT (P, C) -> (N, N, C) for a
    supported flagship kernel (the batched-evidence hot path).

    ``symmetric``: build only the upper-triangle pairs and mirror
    (default: the module flag `SOA_SYMMETRIC`; the input-warped builders are
    symmetric-only)."""
    from gptools_tpu.ops.kernels import GibbsKernel, TanhWarp

    if isinstance(kernel, GibbsKernel) and type(kernel.warp) is not TanhWarp:
        raise ValueError(
            "flagship_cov_soa only implements the TanhWarp Gibbs kernel; got "
            f"GibbsKernel with warp {type(kernel.warp).__name__}"
        )
    cls = classify_flagship(kernel)
    if cls is None:
        raise ValueError(type(kernel).__name__)
    kind, _, input_warp = cls
    ids = _order_ids(nid, multi_indices)
    Xf = X.reshape(-1)
    if symmetric is None:
        symmetric = SOA_SYMMETRIC
    if input_warp is not None:
        return warped_cov_fused_soa_sym(kind, input_warp, Xf, ids, thetaT)
    builds = {
        "se": (se_cov_fused_soa, se_cov_fused_soa_sym),
        "gibbs_tanh": (gibbs_tanh_cov_fused_soa, gibbs_tanh_cov_fused_soa_sym),
        "matern52": (matern52_cov_fused_soa, matern52_cov_fused_soa_sym),
    }
    return builds[kind][1 if symmetric else 0](Xf, ids, thetaT)


def fused_supported(kernel, multi_indices, num_dim) -> bool:
    if num_dim != 1:
        return False
    if not set(tuple(m) for m in multi_indices) <= {(0,), (1,)}:
        return False
    return classify_flagship(kernel) is not None


def _order_ids(nid, multi_indices):
    mi = tuple(tuple(m) for m in multi_indices)
    if mi == ((0,),) or mi == ((0,), (1,)):
        return nid
    if mi == ((1,),):
        return nid + 1
    raise ValueError(f"unsupported multi-index table {mi}")


def flagship_cov(kernel, theta, X, nid, multi_indices):
    """Fused K over one point set for a supported flagship kernel (plain
    XLA, differentiable)."""
    from gptools_tpu.ops.kernels import GibbsKernel, TanhWarp

    # The Gibbs formulas below hard-code the TanhWarp length-scale profile.
    # `GPModel._latent_cov` only routes here when `fused_supported` says yes,
    # but a direct caller with e.g. GibbsKernel1dGauss would otherwise get
    # silently wrong covariances — so re-check the warp type and raise.
    if isinstance(kernel, GibbsKernel) and type(kernel.warp) is not TanhWarp:
        raise ValueError(
            "flagship_cov only implements the TanhWarp Gibbs kernel; got "
            f"GibbsKernel with warp {type(kernel.warp).__name__}. Use the "
            "generic assembly (ops.assemble) for other warps."
        )
    cls = classify_flagship(kernel)
    if cls is None:
        raise ValueError(type(kernel).__name__)
    kind, _, input_warp = cls
    ids = _order_ids(nid, multi_indices)
    Xf = X.reshape(-1)
    if input_warp is not None:
        return warped_cov_fused(kind, input_warp, Xf, ids, theta)
    builds = {
        "se": se_cov_fused,
        "gibbs_tanh": gibbs_tanh_cov_fused,
        "matern52": matern52_cov_fused,
    }
    return builds[kind](Xf, ids, theta)
