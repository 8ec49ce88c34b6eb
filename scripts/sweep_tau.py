"""Trajectory-time (tau) study for the bench sampler (BASELINE.md r3).

Motivation: the post-program-reuse bench shows a wide seed-to-seed spread
([9.1k, 17.5k] ESS/s) driven almost entirely by where the ChEES adaptation
lands tau — seed 2 converged to tau=3.95 and spent 2.7x fewer leapfrogs per
draw than seed 0 (tau=10.0) at 73% of the min-ESS. This script measures
ESS/s at FIXED tau values (adam_lr=0 freezes the ladder; tau0 is a runtime
operand, so all fixed-tau runs share ONE compiled program) against the
adaptive baseline, at the exact bench protocol. The result decides whether
the default adaptation (or its bounds/learning rate) should change.

Usage: python scripts/sweep_tau.py [--seeds 0 1] [--taus 2.5 5 10 20]
Prints one JSON line per run.
"""

import argparse
import json
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--taus", type=float, nargs="*",
                    default=[2.5, 5.0, 10.0, 20.0])
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1])
    ap.add_argument("--chains", type=int, default=12288)
    ap.add_argument("--warmup", type=int, default=75)
    ap.add_argument("--samples", type=int, default=300)
    ap.add_argument("--adaptive-too", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--elasticities", type=float, nargs="*", default=[],
                    help="cost-normalized ChEES equilibrium targets to "
                    "sweep (cost_elasticity is a runtime operand: all "
                    "values share one compiled program)")
    ap.add_argument("--config", type=int, default=None,
                    help="sweep a BASELINE config's posterior instead of "
                    "the flagship bench problem (e.g. 2 for the SE + "
                    "derivative posterior — a differently-shaped target "
                    "for the elasticity-generalization question)")
    args = ap.parse_args()

    import jax

    sys.path.insert(0, ".")
    from bench import _flagship_problem
    from gptools_tpu.infer.pipeline import smc_then_chees
    from gptools_tpu.utils.diagnostics import ess_and_rhat

    if args.config is None:
        model, data = _flagship_problem()
    else:
        from gptools_tpu.configs import ALL_CONFIGS

        prob = ALL_CONFIGS[args.config]()
        model, data = prob.model, prob.data

    def run(seed, chees_kwargs, label):
        key = jax.random.PRNGKey(seed)
        t0 = time.perf_counter()
        res = smc_then_chees(
            model, data, key,
            num_chains=args.chains, num_warmup=args.warmup,
            num_samples=args.samples, num_particles=1024, max_steps=256,
            chees_kwargs=chees_kwargs,
        )
        jax.block_until_ready(res.u)
        wall = time.perf_counter() - t0
        ess, rhat = ess_and_rhat(res.thetas)
        ess = np.asarray(ess)
        out = {
            "label": label,
            "seed": seed,
            "wall_s": round(wall, 2),
            "min_ess": round(float(ess.min()), 1),
            "ess_per_s": round(float(ess.min()) / wall, 1),
            "rhat_max": round(float(np.asarray(rhat).max()), 5),
            "divergences": int(res.diagnostics["divergences"]),
            "eps": round(float(res.diagnostics["step_size"]), 5),
            "tau": round(float(res.diagnostics["trajectory_time"]), 3),
            "leapfrogs": int(res.diagnostics["num_leapfrog_total"]),
        }
        print(json.dumps(out), flush=True)
        return out

    # priming at tiny lengths compiles both programs (fixed + adaptive).
    # Elasticity runs share the adaptive program (cost_elasticity is a
    # runtime operand), so they need the adaptive prime too — without it
    # the first elasticity measurement would eat the one-time compile wall.
    if args.taus:
        run(0, {"adam_lr": 0.0, "tau0": 5.0}, "prime_fixed")
    if args.adaptive_too or args.elasticities:
        run(0, {}, "prime_adaptive")

    for tau in args.taus:
        for seed in args.seeds:
            run(seed, {"adam_lr": 0.0, "tau0": float(tau)}, f"fixed_tau={tau}")
    if args.adaptive_too:
        for seed in args.seeds:
            run(seed, {}, "adaptive")
    for beta in args.elasticities:
        for seed in args.seeds:
            run(seed, {"cost_elasticity": float(beta)},
                f"elasticity={beta}")


if __name__ == "__main__":
    main()
