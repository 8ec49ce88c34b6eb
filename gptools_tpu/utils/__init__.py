"""Utility layer: hyperpriors, bijectors, chain diagnostics, checkpointing.

Counterpart of the reference's ``gptools/utils.py`` (priors,
combinatorics, sampler summaries — see SURVEY.md section 2.1). The
combinatorial machinery (``incomplete_bell_poly``, ``generate_set_partitions``,
``fixed_poch``) lives in `gptools_tpu.utils.combinatorics` for API parity and
for cross-validating the autodiff derivative towers — the covariance hot path
never calls it, because this rebuild obtains kernel derivatives from JAX
autodiff (see `gptools_tpu.ops.derivs`).
"""

from .bounds import CombinedBounds, MaskedBounds  # noqa: F401
from .combinatorics import (  # noqa: F401
    fixed_poch,
    generate_set_partition_strings,
    generate_set_partitions,
    incomplete_bell_poly,
)


def unique_rows(arr):
    """Unique rows of a 2-D array, preserving first-occurrence order
    (``gptools/utils.py :: unique_rows``). Host-side numpy helper."""
    import numpy as _np

    a = _np.asarray(arr)
    if a.ndim != 2:
        raise ValueError("unique_rows expects a 2-D array")
    _, idx = _np.unique(a, axis=0, return_index=True)
    return a[_np.sort(idx)]
