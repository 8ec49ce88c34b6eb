"""Affine-invariant ensemble sampler (Goodman & Weare 2010 stretch move) —
a faithful numpy stand-in for the emcee EnsembleSampler the reference drives
in ``gptools/core.py :: sample_hyperparameter_posterior`` (SURVEY.md
section 3.2). emcee is not installed in this environment (SURVEY.md section
0), so parity of the engine's posteriors is judged against this
implementation of the same algorithm; it matches emcee's default moves
(stretch, a=2, parallel two-half update).
"""

import numpy as np


def run_ensemble(log_prob, p0, num_steps, rng, a=2.0, progress=False):
    """Run the stretch-move ensemble.

    Args:
      log_prob: callable (P,) -> float (may return -inf).
      p0: (W, P) initial walkers.
      num_steps: iterations.
      rng: numpy Generator.

    Returns (chain (num_steps, W, P), log_probs (num_steps, W), accept_frac).
    """
    walkers = np.array(p0, dtype=float)
    W, P = walkers.shape
    if W < 2 * P:
        raise ValueError("need at least 2*dim walkers")
    lp = np.array([log_prob(w) for w in walkers])
    chain = np.empty((num_steps, W, P))
    lps = np.empty((num_steps, W))
    n_accept = 0
    half = W // 2
    sets = [np.arange(half), np.arange(half, W)]
    for it in range(num_steps):
        for s in range(2):
            active, other = sets[s], sets[1 - s]
            for i in active:
                j = other[rng.integers(len(other))]
                z = ((a - 1.0) * rng.random() + 1.0) ** 2 / a
                prop = walkers[j] + z * (walkers[i] - walkers[j])
                lp_prop = log_prob(prop)
                log_ratio = (P - 1) * np.log(z) + lp_prop - lp[i]
                if np.log(rng.random()) < log_ratio:
                    walkers[i] = prop
                    lp[i] = lp_prop
                    n_accept += 1
        chain[it] = walkers
        lps[it] = lp
    return chain, lps, n_accept / (num_steps * W)
