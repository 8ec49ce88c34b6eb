"""Compile time and device time per call of the batched evidence value and
gradient (``GPModel.log_marginal_batch`` and its VJP) at the shapes the
samplers run: config 4's bench problem (N = 27) and config 3 (N = 35).

    python scripts/time_evidence.py                  # this checkout
    python scripts/time_evidence.py --root OTHER     # another checkout's
                                                     # package, same thetas

Theta is drawn near the golden posterior moments of config 4 (config 3:
log-normal draws around its prior medians), in f32. Prints one JSON line
per case with the card's name and power limit. Fails without a GPU.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _thetas(case, num, seed=0):
    rng = np.random.default_rng(seed)
    if case == "config4":
        with open(os.path.join(HERE, "tests", "golden_config4.json")) as f:
            gold = json.load(f)
        m, s = np.asarray(gold["mean"]), np.asarray(gold["std"])
        z = rng.standard_normal((num, m.size))
        th = m * np.exp(z * s / m)
        th[:, 4] = np.clip(m[4] + s[4] * z[:, 4], 0.61, 1.09)
        return th
    # config 3: sigma_f, l, warp a, warp b, slope, intercept
    med = np.array([1.0, 0.37, 1.0, 1.0, 0.8, 0.0])
    th = med * np.exp(0.2 * rng.standard_normal((num, 6)))
    th[:, 4:] = med[4:] + 0.1 * rng.standard_normal((num, 2))
    return th


def _problem(case):
    if case == "config4":
        from bench import _flagship_problem

        return _flagship_problem()
    from gptools_tpu import configs

    p = configs.ALL_CONFIGS[3]()
    return p.model, p.data


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose gptools_tpu package is timed")
    ap.add_argument("--cases", default="config4,config3")
    ap.add_argument("--chains", type=int, default=12288)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "gpu":
        raise SystemExit("time_evidence.py needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.splitlines()[0]
    for case in args.cases.split(","):
        model, data = _problem(case)
        th = jnp.asarray(_thetas(case, args.chains), jnp.float32)

        def vag(t):
            ll, pull = jax.vjp(lambda q: model.log_marginal_batch(q, data), t)
            return ll, pull(jnp.ones_like(ll))[0]

        t0 = time.perf_counter()
        compiled = jax.jit(vag).lower(th).compile()
        compile_s = time.perf_counter() - t0
        ll, g = jax.block_until_ready(compiled(th))
        per_call = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            for _ in range(20):
                out = compiled(th)
            jax.block_until_ready(out)
            per_call.append((time.perf_counter() - t0) / 20 * 1e3)
        print(json.dumps({
            "case": case, "root": os.path.abspath(args.root),
            "N": int(data.Xf.shape[0]), "chains": args.chains,
            "compile_s": compile_s, "per_grad_ms": per_call,
            "finite_frac": float(np.isfinite(np.asarray(ll)).mean()),
            "card": card,
        }), flush=True)


if __name__ == "__main__":
    main()
