"""Benchmark: ESS/s on the flagship Gibbs-kernel GP hyperparameter posterior.

The north-star metric (BASELINE.json): effective samples per second per GPU
on a Gibbs-tanh-kernel profile fit with derivative constraints, sampled with
the SMC-initialized vectorized-HMC pipeline. Fails without a GPU. Prints ONE
JSON line:

    {"metric": ..., "value": N, "unit": "ESS/s", "vs_baseline": R, ...}

``value`` is the MEDIAN over ``--repeats`` timed repeats (distinct seeds, one
shared compile), with only quality-gated runs (max split R-hat <= 1.1,
divergence fraction <= 1e-3) entering the median; degraded runs are counted
and reported, never averaged in. Per-run details (wall, min ESS, per-param
ESS/R-hat, divergences) are written to ``bench_detail.json`` (not tracked)
and echoed on stderr. The result names the device: platform, kind, count,
and the card's name and power limit.

``vs_baseline`` compares against the CPU reference pipeline stand-in (numpy
GP oracle + affine-invariant ensemble sampler — the same algorithm emcee
runs for the reference; emcee itself is not installed, see SURVEY.md §0),
measured with ``JAX_PLATFORMS=cpu python bench.py --baseline`` and recorded
in BASELINE.md. The batched evidence's parity with the float64 oracle is
gated by ``chip_smoke.py``.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

# CPU reference-pipeline ESS/s measured via --baseline (see BASELINE.md for
# the measurement protocol and raw numbers).
CPU_BASELINE_ESS_PER_S = 5.97  # mean of two --baseline runs (6.33, 5.62)

# Quality gates: a repeat whose chains have not converged (split R-hat) or
# that diverged materially is reported as degraded and excluded from the
# median (unless every repeat is degraded, in which case the degraded median
# is reported with ok=false).
RHAT_GATE = 1.1
DIVERGENCE_FRAC_GATE = 1e-3

# ChEES trajectory cap at the bench shape.
MAX_STEPS_DEFAULT = 256

DETAIL_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bench_detail.json")


def _flagship_problem(n_points=25):
    """Config-4-style problem, sized like a realistic pedestal profile fit."""
    from gptools_tpu.models.dataset import DatasetBuilder
    from gptools_tpu.models.gp import GPModel
    from gptools_tpu.ops.kernels import GibbsKernel1dTanh
    from gptools_tpu.utils.priors import LogNormalJointPrior, UniformJointPrior

    rng = np.random.default_rng(0)
    x = np.linspace(0.0, 1.2, n_points)
    x0 = 0.9
    prof = 1.0 - 0.5 * np.minimum(x, x0) ** 2
    edge = x > x0
    prof[edge] = (1.0 - 0.5 * x0**2) * np.exp(-(x[edge] - x0) / 0.05)
    y = prof + 0.03 * rng.standard_normal(n_points)
    b = DatasetBuilder(1)
    b.add(x, y, err_y=0.03)
    b.add(np.array([0.0]), np.array([0.0]), err_y=0.01, n=1)  # core slope = 0
    b.add(np.array([1.2]), np.array([0.0]), err_y=0.05, n=1)  # edge slope ~ 0
    data = b.build()
    prior = (
        LogNormalJointPrior([0.0], [0.75])
        * LogNormalJointPrior([-1.0], [0.6])
        * LogNormalJointPrior([-2.3], [0.6])
        * LogNormalJointPrior([-2.3], [0.6])
        * UniformJointPrior([0.6], [1.1])
    )
    model = GPModel(GibbsKernel1dTanh(hyperprior=prior))
    return model, data


def _measure_once(model, data, seed, num_chains, num_warmup, num_samples,
                  max_steps=256):
    """One timed end-to-end pipeline run. Returns (ess_per_s, info dict)."""
    import jax

    from gptools_tpu.infer.pipeline import smc_then_chees
    from gptools_tpu.utils.diagnostics import ess_and_rhat

    key = jax.random.PRNGKey(seed)
    t0 = time.perf_counter()
    res = smc_then_chees(
        model,
        data,
        key,
        num_chains=num_chains,
        num_warmup=num_warmup,
        num_samples=num_samples,
        num_particles=1024,
        max_steps=max_steps,
    )
    jax.block_until_ready(res.u)
    wall = time.perf_counter() - t0

    # post-run diagnostics are untimed: device-resident thetas reduce ON
    # DEVICE and only per-param scalars come back to the host
    ess, rhat = ess_and_rhat(res.thetas)
    ess = np.asarray(ess)
    rhat = np.asarray(rhat)
    min_ess = float(ess.min())
    divergences = int(res.diagnostics["divergences"])
    total_draws = num_chains * num_samples
    degraded_reasons = []
    if float(rhat.max()) > RHAT_GATE:
        degraded_reasons.append(f"max_rhat {float(rhat.max()):.4f} > {RHAT_GATE}")
    if divergences / total_draws > DIVERGENCE_FRAC_GATE:
        degraded_reasons.append(
            f"divergence_frac {divergences / total_draws:.2e} > {DIVERGENCE_FRAC_GATE}"
        )
    info = {
        "seed": seed,
        "wall_s": round(wall, 3),
        "min_ess": round(min_ess, 1),
        "ess_per_s": round(min_ess / wall, 2),
        "ess": [round(float(e), 1) for e in ess],
        "rhat": [round(float(r), 5) for r in rhat],
        "divergences": divergences,
        "total_draws": total_draws,
        "eps": round(float(res.diagnostics["step_size"]), 5),
        "tau": round(float(res.diagnostics["trajectory_time"]), 3),
        "leapfrogs": int(res.diagnostics["num_leapfrog_total"]),
        "degraded": bool(degraded_reasons),
        "degraded_reasons": degraded_reasons,
    }
    return min_ess / wall, info


def run_bench(num_chains=12288, num_warmup=75, num_samples=3000, seed=0,
              repeats=3, max_steps=256, budget_s=None, use_cache=True):
    """Compile once (SHORT untimed priming run), then up to ``repeats`` timed
    end-to-end pipeline runs with distinct seeds. Returns (median ESS/s over
    non-degraded runs, summary dict).

    ``budget_s``: wall budget for the TIMED phase. After each repeat, if
    the elapsed timed wall exceeds the budget, remaining repeats are skipped
    (at least one always runs) and the summary records how many ran.
    ``None`` = unbudgeted (the --full protocol).
    """
    from gptools_tpu.utils.device import device_record

    device = device_record()  # fails without a GPU
    if use_cache:
        from gptools_tpu.utils.xla_cache import enable as _enable_cache

        _enable_cache()
    model, data = _flagship_problem()

    # Priming run at FULL length: compiles every program at the measured
    # shapes (the post-sampling jits specialize on the (chains, samples, P)
    # stack), so every timed repeat is a pure-execution measurement.
    # Different seeds do NOT retrace; shapes are identical across repeats.
    t_prime0 = time.perf_counter()
    _measure_once(model, data, seed + repeats, num_chains, num_warmup,
                  num_samples, max_steps=max_steps)
    print(
        f"priming wall: {time.perf_counter() - t_prime0:.1f}s "
        f"(cache={'on' if use_cache else 'off'})",
        file=sys.stderr,
    )

    runs = []
    t_timed0 = time.perf_counter()
    for i in range(repeats):
        _, info = _measure_once(
            model, data, seed + i, num_chains, num_warmup, num_samples,
            max_steps=max_steps,
        )
        print(f"bench repeat {i + 1}/{repeats}: {json.dumps(info)}", file=sys.stderr)
        runs.append(info)
        elapsed = time.perf_counter() - t_timed0
        if budget_s is not None and elapsed > budget_s and i + 1 < repeats:
            print(
                f"bench budget exhausted after {i + 1}/{repeats} repeats "
                f"({elapsed:.0f}s > {budget_s:.0f}s); skipping the rest",
                file=sys.stderr,
            )
            break

    good = [r for r in runs if not r["degraded"]]
    pool = good if good else runs
    vals = sorted(r["ess_per_s"] for r in pool)
    median = vals[len(vals) // 2] if len(vals) % 2 else 0.5 * (
        vals[len(vals) // 2 - 1] + vals[len(vals) // 2]
    )
    summary = {
        "median_ess_per_s": round(median, 2),
        "min_ess_per_s": min(r["ess_per_s"] for r in runs),
        "max_ess_per_s": max(r["ess_per_s"] for r in runs),
        "repeats": len(runs),
        "repeats_requested": repeats,
        "budget_s": budget_s,
        "degraded_runs": len(runs) - len(good),
        "ok": bool(good),
        "num_chains": num_chains,
        "num_warmup": num_warmup,
        "num_samples": num_samples,
        "device": device,
        "runs": runs,
    }
    return median, summary


def run_cpu_baseline(num_steps=1200, burn=400, walkers=16, seed=0):
    """Reference pipeline stand-in: numpy-driven ensemble sampler over the
    same posterior, single process (the reference's default num_proc usage
    evaluates walkers serially per step)."""
    import jax
    import jax.numpy as jnp

    from gptools_tpu.utils.diagnostics import ess_per_param
    from tests.oracle.ensemble import run_ensemble

    model, data = _flagship_problem()
    lp_jit = jax.jit(lambda t: model.log_posterior(t, data))

    def log_prob(theta):
        return float(lp_jit(jnp.asarray(theta)))

    rng = np.random.default_rng(seed)
    p0 = np.asarray(model.hyperprior.sample(jax.random.PRNGKey(seed), (walkers,)))
    log_prob(p0[0])  # compile outside the clock
    t0 = time.perf_counter()
    chain, _, acc = run_ensemble(log_prob, p0, num_steps, rng)
    wall = time.perf_counter() - t0
    kept = chain[burn:]  # (S, W, P)
    series = np.swapaxes(kept, 0, 1)  # (W, S, P)
    ess = np.asarray(ess_per_param(series))
    return float(ess.min()) / wall, {
        "wall_s": wall,
        "min_ess": float(ess.min()),
        "accept": acc,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", action="store_true", help="measure the CPU reference pipeline")
    ap.add_argument("--chains", type=int, default=12288)
    ap.add_argument("--samples", type=int, default=None,
                    help="sampling draws per chain (default 3000; 8000 under "
                    "--full)")
    ap.add_argument("--warmup", type=int, default=75)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--budget-s", type=float, default=500.0,
                    help="wall budget for the timed repeats; at least one "
                    "repeat always runs. Use --full for the unbudgeted long "
                    "protocol.")
    ap.add_argument("--full", action="store_true",
                    help="unbudgeted protocol: all --repeats timed runs "
                    "regardless of wall")
    ap.add_argument("--max-steps", type=int, default=MAX_STEPS_DEFAULT,
                    help="ChEES leapfrog cap")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the persistent XLA compilation cache")
    args = ap.parse_args()
    if args.samples is None:
        args.samples = 8000 if args.full else 3000

    if args.baseline:
        import jax

        if jax.default_backend() != "cpu":
            sys.exit("--baseline measures the CPU stand-in: run it with "
                     "JAX_PLATFORMS=cpu")
        val, info = run_cpu_baseline()
        print(json.dumps(info), file=sys.stderr)
        print(
            json.dumps(
                {
                    "metric": "cpu_baseline_ess_per_s_gibbs_ensemble",
                    "value": round(val, 4),
                    "unit": "ESS/s",
                    "vs_baseline": 1.0,
                }
            )
        )
        return

    val, summary = run_bench(
        num_chains=args.chains,
        num_warmup=args.warmup,
        num_samples=args.samples,
        seed=args.seed,
        repeats=args.repeats,
        max_steps=args.max_steps,
        budget_s=None if args.full else args.budget_s,
        use_cache=not args.no_cache,
    )
    with open(DETAIL_PATH, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({"summary": summary}), file=sys.stderr)
    print(
        json.dumps(
            {
                "metric": "ess_per_s_gibbs_smc_chees",
                "value": round(val, 2),
                "unit": "ESS/s",
                "vs_baseline": round(val / CPU_BASELINE_ESS_PER_S, 2),
                "spread": [summary["min_ess_per_s"], summary["max_ess_per_s"]],
                "repeats": summary["repeats"],
                "degraded_runs": summary["degraded_runs"],
                "ok": summary["ok"],
                "device": summary["device"],
            }
        )
    )


if __name__ == "__main__":
    main()
