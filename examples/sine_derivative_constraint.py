"""The reference's canonical worked example: synthetic sine-wave
regression with a derivative constraint at the edge (the sphinx-docs demo of
markchil/gptools — SURVEY.md section 4 'docs-as-tests'), done three ways:
MAP, NUTS, and fully-Bayesian prediction.
"""

import numpy as np

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))



def main():
    import jax

    from gptools_tpu import GaussianProcess, SquaredExponentialKernel
    from gptools_tpu.utils.priors import LogNormalJointPrior

    rng = np.random.default_rng(0)
    X = np.linspace(0, 3, 25)
    y = np.sin(2 * X) + 0.1 * rng.standard_normal(25)

    k = SquaredExponentialKernel(
        hyperprior=LogNormalJointPrior([0.0, -0.7], [0.8, 0.8])
    )
    gp = GaussianProcess(k)
    gp.add_data(X, y, err_y=0.1)
    gp.add_data(0.0, 2.0, n=1, err_y=0.05)  # slope constraint at the edge

    gp.optimize_hyperparameters(random_starts=8)
    yhat, std = gp.predict(np.linspace(0, 3, 50))
    print("MAP fit:", dict(zip(gp.model.param_names, np.round(np.asarray(gp.theta), 4))))

    gp.sample_hyperparameter_posterior(nsamp=500, burn=300, num_chains=8)
    m, s = gp.predict_MCMC(np.array([0.5, 1.5, 2.5]))
    print("fully-Bayesian prediction:", np.round(np.asarray(m), 3),
          "+-", np.round(np.asarray(s), 3))

    d, dstd = gp.predict(np.array([1.0]), n=1)
    print(f"predicted slope at x=1: {float(d[0]):.3f} (true {2*np.cos(2.0):.3f})")


if __name__ == "__main__":
    main()
