"""Per-config performance recorder: BASELINE.json configs 1-3, on the GPU.

The headline bench measures config 4 only; this script records throughput
for the other configs. Protocols:

  config 1  MAP wall (vmapped multi-start L-BFGS; compile and exec reported
            separately) + the same fit via scipy L-BFGS-B over the jitted
            CPU density under --cpu-baseline (the reference's
            multiprocessing-SLSQP stand-in)
  config 2  gated ESS/s, smc_then_chees (SE + derivative observations)
  config 3  gated ESS/s, smc_then_chees (Matern-5/2 + BetaWarp + linear
            mean)
  config 4  the headline bench (bench.py) — not re-measured here
  config 5  the sharded pipeline — checked by ``chip_smoke.py --multi``

Usage:
  python scripts/bench_configs.py                 # GPU side (fails without one)
  JAX_PLATFORMS=cpu python scripts/bench_configs.py --cpu-baseline
  python scripts/bench_configs.py --configs 2 3

Each result prints as one JSON line.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RHAT_GATE = 1.1
DIVERGENCE_FRAC_GATE = 1e-3
DEVICE = None  # device_record() of the GPU run


def _emit(obj):
    print(json.dumps(obj), flush=True)


def _ess_run(model, data, seed, num_chains, num_warmup, num_samples):
    import jax

    from gptools_tpu.infer.pipeline import smc_then_chees
    from gptools_tpu.utils.diagnostics import ess_and_rhat

    key = jax.random.PRNGKey(seed)
    t0 = time.perf_counter()
    res = smc_then_chees(
        model, data, key,
        num_chains=num_chains, num_warmup=num_warmup,
        num_samples=num_samples, num_particles=1024, max_steps=256,
    )
    jax.block_until_ready(res.u)
    wall = time.perf_counter() - t0
    ess, rhat = ess_and_rhat(res.thetas)
    ess = np.asarray(ess)
    min_ess = float(ess.min())
    div = int(res.diagnostics["divergences"])
    degraded = (
        float(np.asarray(rhat).max()) > RHAT_GATE
        or div / (num_chains * num_samples) > DIVERGENCE_FRAC_GATE
    )
    return {
        "wall_s": round(wall, 3),
        "min_ess": round(min_ess, 1),
        "ess_per_s": round(min_ess / wall, 1),
        "max_rhat": round(float(np.asarray(rhat).max()), 4),
        "divergences": div,
        "degraded": degraded,
    }


def bench_sampler_config(cfg_num, num_chains, num_warmup, num_samples,
                         repeats=3):
    import jax

    from gptools_tpu.configs import ALL_CONFIGS

    prob = ALL_CONFIGS[cfg_num]()
    model, data = prob.model, prob.data
    # priming run at full shape (same protocol as bench.py)
    _ess_run(model, data, 99, num_chains, num_warmup, num_samples)
    runs = [
        _ess_run(model, data, s, num_chains, num_warmup, num_samples)
        for s in range(repeats)
    ]
    good = [r for r in runs if not r["degraded"]] or runs
    vals = sorted(r["ess_per_s"] for r in good)
    med = vals[len(vals) // 2] if len(vals) % 2 else 0.5 * (
        vals[len(vals) // 2 - 1] + vals[len(vals) // 2]
    )
    _emit({
        "config": cfg_num,
        "name": prob.name,
        "metric": "ess_per_s",
        "value": med,
        "runs": runs,
        "num_chains": num_chains,
        "num_samples": num_samples,
        "device": DEVICE,
    })


def bench_config1_map(repeats=3, random_starts=32):
    import jax

    from gptools_tpu.configs import config1_se_map
    from gptools_tpu.infer import map_fit

    prob = config1_se_map()
    model, data = prob.model, prob.data

    def run(seed):
        t0 = time.perf_counter()
        res = map_fit.optimize(
            model, data, jax.random.PRNGKey(seed),
            random_starts=random_starts, num_steps=200,
        )
        jax.block_until_ready(res.theta)
        return time.perf_counter() - t0, float(res.log_posterior)

    compile_wall, lp0 = run(0)
    walls, lps = zip(*(run(s + 1) for s in range(repeats)))
    _emit({
        "config": 1,
        "name": prob.name,
        "metric": "map_wall_s",
        "value": round(float(np.median(walls)), 4),
        "compile_plus_first_s": round(compile_wall, 2),
        "random_starts": random_starts,
        "best_log_posterior": round(max([lp0, *lps]), 4),
        "device": DEVICE,
    })


def cpu_baseline_map(random_starts=8):
    """Reference MAP stand-in: scipy L-BFGS-B per start, serial (the
    reference fanned SLSQP starts over a process pool; single-process serial
    matches its num_proc=1 path)."""
    import jax
    import jax.numpy as jnp
    from scipy import optimize as sopt

    from gptools_tpu.configs import config1_se_map

    prob = config1_se_map()
    model, data = prob.model, prob.data
    lp = jax.jit(lambda t: model.log_posterior(t, data))
    glp = jax.jit(jax.grad(lambda t: model.log_posterior(t, data)))

    def neg(t):
        v = float(lp(jnp.asarray(t)))
        return 1e30 if not np.isfinite(v) else -v

    def dneg(t):
        g = np.asarray(glp(jnp.asarray(t)), dtype=np.float64)
        return np.where(np.isfinite(g), -g, 0.0)

    starts = np.asarray(
        model.hyperprior.sample(jax.random.PRNGKey(0), (random_starts,))
    )
    neg(starts[0]); dneg(starts[0])  # compile outside the clock
    t0 = time.perf_counter()
    best = -np.inf
    for s in starts:
        r = sopt.minimize(neg, s, jac=dneg, method="L-BFGS-B")
        best = max(best, -r.fun)
    wall = time.perf_counter() - t0
    _emit({
        "config": 1,
        "metric": "cpu_map_wall_s",
        "value": round(wall, 3),
        "random_starts": random_starts,
        "best_log_posterior": round(best, 4),
    })


def cpu_baseline_sampler(cfg_num, num_steps=1200, burn=400, walkers=16):
    """Reference sampler stand-in: affine-invariant ensemble (emcee's
    algorithm) over the same posterior, single process — the identical
    protocol to bench.py --baseline."""
    import jax
    import jax.numpy as jnp

    from gptools_tpu.configs import ALL_CONFIGS
    from gptools_tpu.utils.diagnostics import ess_per_param
    from tests.oracle.ensemble import run_ensemble

    prob = ALL_CONFIGS[cfg_num]()
    model, data = prob.model, prob.data
    lp_jit = jax.jit(lambda t: model.log_posterior(t, data))

    def log_prob(theta):
        return float(lp_jit(jnp.asarray(theta)))

    rng = np.random.default_rng(0)
    p0 = np.asarray(model.hyperprior.sample(jax.random.PRNGKey(0), (walkers,)))
    log_prob(p0[0])
    t0 = time.perf_counter()
    chain, _, acc = run_ensemble(log_prob, p0, num_steps, rng)
    wall = time.perf_counter() - t0
    series = np.swapaxes(chain[burn:], 0, 1)
    ess = np.asarray(ess_per_param(series))
    _emit({
        "config": cfg_num,
        "metric": "cpu_ess_per_s",
        "value": round(float(ess.min()) / wall, 4),
        "wall_s": round(wall, 1),
        "min_ess": round(float(ess.min()), 1),
        "accept": acc,
    })


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", type=int, nargs="*", default=[1, 2, 3])
    ap.add_argument("--cpu-baseline", action="store_true")
    ap.add_argument("--chains", type=int, default=4096)
    ap.add_argument("--samples", type=int, default=2000)
    ap.add_argument("--warmup", type=int, default=100)
    args = ap.parse_args()

    if args.cpu_baseline:
        import jax

        if jax.default_backend() != "cpu":
            sys.exit("--cpu-baseline runs with JAX_PLATFORMS=cpu")
        if 1 in args.configs:
            cpu_baseline_map()
        for c in (2, 3):
            if c in args.configs:
                cpu_baseline_sampler(c)
        return

    from gptools_tpu.utils.device import device_record

    global DEVICE
    DEVICE = device_record()  # fails without a GPU
    if 1 in args.configs:
        bench_config1_map()
    for c in (2, 3):
        if c in args.configs:
            bench_sampler_config(
                c, args.chains, args.warmup, args.samples
            )


if __name__ == "__main__":
    main()
