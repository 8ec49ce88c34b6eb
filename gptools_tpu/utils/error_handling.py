"""Library-specific exceptions and the reject-don't-crash contract.

Counterpart of ``gptools/error_handling.py`` (SURVEY.md section 2.1): the
reference defines ``GPArgumentError`` for bad user input and an
impossible-hyperparameters error class whose only consumer converts it to a
``-inf`` log-likelihood so MCMC rejects instead of crashing.

In the jitted engine the -inf contract is structural — the evidence
(`gptools_tpu.ops.evidence.gaussian_loglik`) masks non-finite factorization
results to -inf with no Python control flow — so `GPImpossibleParamsError`
exists only for EAGER host-side use (e.g. validating a user-supplied theta
before a long run).
"""

from __future__ import annotations

__all__ = ["GPArgumentError", "GPImpossibleParamsError", "check_finite_params"]


class GPArgumentError(ValueError):
    """Invalid argument to a GP API (reference ``GPArgumentError``)."""


class GPImpossibleParamsError(ValueError):
    """Hyperparameters outside the feasible region (non-PSD covariance,
    bound violation). Inside jit this never raises — the likelihood becomes
    ``-inf`` instead (reference contract)."""


def check_finite_params(theta, bounds=None) -> None:
    """Eager validation helper: raise `GPImpossibleParamsError` for
    non-finite or out-of-bounds hyperparameters."""
    import numpy as np

    t = np.asarray(theta)
    if not np.all(np.isfinite(t)):
        raise GPImpossibleParamsError(f"non-finite hyperparameters: {t}")
    if bounds is not None:
        for i, (lo, hi) in enumerate(bounds):
            if not (lo <= t[i] <= hi):
                raise GPImpossibleParamsError(
                    f"param {i} = {t[i]} outside bounds ({lo}, {hi})"
                )
