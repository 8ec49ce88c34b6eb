"""f32 posterior parity gate against committed float64 golden moments.

The CPU test suite runs x64; the GPU runs f32. This gate closes the loop:
config-4 (Gibbs-tanh profile fit, the bench problem) posterior moments from
an f32 run are z-tested against golden moments from the CPU x64 oracle run.

    python scripts/f32_parity.py --golden   # regenerate tests/golden_config4.json
                                            # (forces CPU + x64)
    python scripts/f32_parity.py            # gate: f32 on the GPU vs golden

Prints one JSON line {"ok": bool, "z": [...], ...}; exit code 1 on failure.
`golden_gate` is the rule, and ``chip_smoke.py`` calls it on the flagship
run: every parameter's |mean_f32 - mean_x64| <= 4 combined MC standard
errors (se = std/sqrt(ESS)) and stds agree within 15%.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GOLDEN_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tests",
    "golden_config4.json",
)

# Sized so the x64 CPU oracle finishes in minutes on a 2-core box; the gate's
# z-test uses MC standard errors from the measured ESS, so chain count only
# sets the tolerance width, not the validity of the comparison.
RUN_KWARGS = dict(num_chains=512, num_warmup=75, num_samples=300, num_particles=1024)
SEED = 7


def run_pipeline():
    import jax

    from gptools_tpu import configs
    from gptools_tpu.infer.pipeline import smc_then_chees
    from gptools_tpu.utils.diagnostics import ess_per_param, split_rhat

    prob = configs.ALL_CONFIGS[4]()
    res = smc_then_chees(
        prob.model, prob.data, jax.random.PRNGKey(SEED), **RUN_KWARGS
    )
    th = np.asarray(res.thetas)
    flat = th.reshape(-1, th.shape[-1])
    ess = np.asarray(ess_per_param(th))
    return {
        "params": list(prob.model.param_names),
        "mean": flat.mean(axis=0).tolist(),
        "std": flat.std(axis=0, ddof=1).tolist(),
        "ess": ess.tolist(),
        "rhat": np.asarray(split_rhat(th)).tolist(),
        "dtype": str(th.dtype),
        "kwargs": RUN_KWARGS,
        "seed": SEED,
    }


def load_golden():
    with open(GOLDEN_PATH) as f:
        return json.load(f)


def golden_gate(mean, std, ess, gold=None):
    """z-test posterior moments (per parameter) against the golden run."""
    gold = gold if gold is not None else load_golden()
    m, s, e = (np.asarray(v, np.float64) for v in (mean, std, ess))
    gm, gs, ge = (np.asarray(gold[k]) for k in ("mean", "std", "ess"))
    se = np.sqrt(s**2 / e + gs**2 / ge)
    z = (m - gm) / se
    ok_mean = bool(np.all(np.abs(z) <= 4.0))
    ok_std = bool(np.all(np.abs(s - gs) <= 0.15 * gs + 4.0 * se))
    return {
        "ok": ok_mean and ok_std,
        "z": np.round(z, 2).tolist(),
        "mean": np.round(m, 5).tolist(),
        "golden_mean": np.round(gm, 5).tolist(),
        "std_rel_err": np.round((s - gs) / gs, 4).tolist(),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--golden", action="store_true", help="regenerate the x64 oracle")
    args = ap.parse_args()

    import jax

    if args.golden:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    else:
        from gptools_tpu.utils.device import require_gpu

        require_gpu()

    out = run_pipeline()
    out["device"] = str(jax.devices()[0])

    if args.golden:
        assert out["dtype"] == "float64", out["dtype"]
        with open(GOLDEN_PATH, "w") as f:
            json.dump(out, f, indent=1)
        print(json.dumps({"golden_written": GOLDEN_PATH, **{k: out[k] for k in ("mean", "std", "ess")}}))
        return

    if not os.path.exists(GOLDEN_PATH):
        print(
            json.dumps(
                {
                    "ok": False,
                    "error": f"golden file {GOLDEN_PATH} missing - run "
                    "`python scripts/f32_parity.py --golden` (CPU x64) first",
                }
            )
        )
        sys.exit(2)
    gold = load_golden()
    if gold.get("kwargs") != RUN_KWARGS or gold.get("seed") != SEED:
        print(
            json.dumps(
                {
                    "ok": False,
                    "error": "golden was generated at different RUN_KWARGS/"
                    "seed - regenerate with --golden",
                    "golden_kwargs": gold.get("kwargs"),
                    "expected": RUN_KWARGS,
                }
            )
        )
        sys.exit(2)
    gate = golden_gate(out["mean"], out["std"], out["ess"], gold)
    print(
        json.dumps(
            {
                **gate,
                "rhat_max": max(out["rhat"]),
                "dtype": out["dtype"],
                "device": out["device"],
            }
        )
    )
    sys.exit(0 if gate["ok"] else 1)


if __name__ == "__main__":
    main()
