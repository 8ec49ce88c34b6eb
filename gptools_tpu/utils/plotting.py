"""Sampler and predictive-envelope plotting + robust profile statistics.

Counterpart of the reference's presentation layer (SURVEY.md section 2.1,
``gptools/utils.py :: summarize_sampler, plot_sampler, compute_stats,
univariate_envelope_plot``). Headless-safe: matplotlib is imported lazily
with the Agg backend, and every function works on plain numpy arrays pulled
from device once.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = [
    "compute_stats",
    "summarize_sampler",
    "plot_sampler",
    "univariate_envelope_plot",
]


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def compute_stats(
    vals: np.ndarray,
    check_nan: bool = False,
    robust: bool = False,
    axis: int = 0,
    plot_sample: bool = False,
    ci: float = 0.95,
):
    """Mean and symmetric credible half-widths of sampled values
    (``gptools/utils.py :: compute_stats``): returns ``(mean, ci_low_width,
    ci_up_width)`` along ``axis``. ``robust=True`` uses median/percentiles.
    """
    v = np.asarray(vals)
    if check_nan:
        v = np.ma.masked_invalid(v)
    lo_q = 100 * (1 - ci) / 2
    hi_q = 100 * (1 + ci) / 2
    if robust:
        center = np.median(v, axis=axis)
        lo = center - np.percentile(v, lo_q, axis=axis)
        hi = np.percentile(v, hi_q, axis=axis) - center
    else:
        center = np.mean(v, axis=axis)
        sd = np.std(v, axis=axis, ddof=1)
        from scipy.stats import norm

        z = norm.ppf(hi_q / 100)
        lo = hi = z * sd
    return center, lo, hi


def summarize_sampler(result, param_names=None, burn: int = 0, ci: float = 0.95):
    """Posterior summary table from a `SampleResult` (or raw (C, S, P) array)
    — the reference's ``summarize_sampler`` (means + CIs per parameter),
    extended with ESS and split-R-hat."""
    from gptools_tpu.utils.diagnostics import summarize_samples

    from gptools_tpu.utils.diagnostics import _accelerator_resident

    thetas = getattr(result, "thetas", result)
    if thetas is None:
        thetas = result.u
    lo_q, hi_q = (1 - ci) / 2, (1 + ci) / 2
    if _accelerator_resident(thetas):
        # keep the stack on device: burn-slice, summary, and CI quantiles
        # all reduce on the device; only per-param vectors are fetched
        import jax.numpy as jnp

        s = thetas if thetas.ndim == 3 else thetas[None]
        s = s[:, burn:, :]
        out = summarize_samples(s, param_names=param_names)
        flat = s.reshape(-1, s.shape[-1])
        out["ci_low"] = np.asarray(jnp.quantile(flat, lo_q, axis=0))
        out["ci_high"] = np.asarray(jnp.quantile(flat, hi_q, axis=0))
        return out
    s = np.asarray(thetas)
    if s.ndim == 2:
        s = s[None]
    s = s[:, burn:, :]
    out = summarize_samples(s, param_names=param_names)
    flat = s.reshape(-1, s.shape[-1])
    out["ci_low"] = np.quantile(flat, lo_q, axis=0)
    out["ci_high"] = np.quantile(flat, hi_q, axis=0)
    return out


def plot_sampler(
    result,
    param_names: Optional[Sequence[str]] = None,
    burn: int = 0,
    path: Optional[str] = None,
    max_points: int = 5000,
):
    """Corner-style plot of the hyperparameter posterior + trace panels
    (``gptools/utils.py :: plot_sampler``). Returns the figure; saves to
    ``path`` if given."""
    plt = _plt()
    thetas = getattr(result, "thetas", result)
    if thetas is None:
        thetas = result.u
    s = np.asarray(thetas)
    if s.ndim == 2:
        s = s[None]
    s = s[:, burn:, :]
    C, S, P = s.shape
    flat = s.reshape(-1, P)
    if flat.shape[0] > max_points:
        idx = np.random.default_rng(0).choice(flat.shape[0], max_points, False)
        flat = flat[idx]
    names = list(param_names) if param_names else [f"p{i}" for i in range(P)]

    fig, axes = plt.subplots(P, P, figsize=(2.2 * P, 2.2 * P))
    axes = np.atleast_2d(axes)
    for i in range(P):
        for j in range(P):
            ax = axes[i, j]
            if j > i:
                ax.axis("off")
                continue
            if i == j:
                ax.hist(flat[:, i], bins=40, color="#46628a")
                ax.set_yticks([])
            else:
                ax.plot(
                    flat[:, j], flat[:, i], ",", color="#46628a", alpha=0.4
                )
            if i == P - 1:
                ax.set_xlabel(names[j])
            if j == 0 and i > 0:
                ax.set_ylabel(names[i])
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig


def univariate_envelope_plot(
    x,
    mean,
    std=None,
    lower=None,
    upper=None,
    ax=None,
    color="#46628a",
    label: Optional[str] = None,
    path: Optional[str] = None,
    num_std: float = 1.96,
):
    """Mean curve + shaded uncertainty envelope
    (``gptools/utils.py :: univariate_envelope_plot``)."""
    plt = _plt()
    x = np.asarray(x).reshape(-1)
    mean = np.asarray(mean).reshape(-1)
    if ax is None:
        fig, ax = plt.subplots(figsize=(6, 4))
    else:
        fig = ax.figure
    if lower is None or upper is None:
        sd = np.asarray(std).reshape(-1)
        lower = mean - num_std * sd
        upper = mean + num_std * sd
    ax.fill_between(x, lower, upper, alpha=0.25, color=color, linewidth=0)
    ax.plot(x, mean, color=color, label=label)
    if label:
        ax.legend()
    if path:
        fig.savefig(path, dpi=120)
    return ax
