"""Bring-up check of the GP inference engine on one GPU (four with --multi).

Drives the main path once through the entry points a user calls, at the
full width of the flagship model, and checks every result against an
independent float64 numpy reference run on the host
(``tests/oracle/gp_numpy.py``). Any failure raises and the process exits
non-zero; the last line of standard output is printed only when every
phase passed:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Phases (one card):

- device: refuses to run unless JAX's default backend is a GPU;
- evidence: the batched evidence value and gradient as compiled for the
  card (the chains-minor XLA path; the repository has no hand-written
  kernel) at config 4's bench shape (N = 27, 12288 chains, Gibbs-tanh with
  slope rows) and at config 3's (N = 35, Matern-5/2 on BetaWarp'd inputs
  with a linear mean), against the float64 oracle;
- flagship: config 4 through ``smc_then_chees`` at 12288 chains, gated on
  split R-hat, divergences and the golden posterior moments;
- config 5: the line-integral dataset through ``smc_then_chees`` at 1024
  chains, then ``FrozenMCMCPredictor`` mean and std on a 200-point grid over
  1024 posterior draws against float64 numpy from the same draws;
- readme: the README quick start (MAP, predict, a short NUTS run).

``--multi`` (four cards) runs only the sharded phase: the batched
evidence at fixed theta sharded against unsharded (in a process of its own,
with deterministic GPU ops), the 2-D (temps x chains) parallel-tempering
step, and config 5's pipeline with chains sharded over ``make_mesh(4)``
against the one-card run.

    python chip_smoke.py            # one card
    python chip_smoke.py --multi    # four cards
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

# f32 gates against the float64 oracle
LL_GATE = 1e-3  # |dll| <= LL_GATE * max(1, |ll|)
GRAD_P99_GATE = 1e-2  # p99 of the per-component relative gradient error
RHAT_GATE = 1.1
DIVERGENCE_FRAC_GATE = 1e-3
# predictive mean and std against float64, in units of the f64 std
PRED_GATE = 2e-2
# the one-card flagship run is cut from the bench's 3000 samples
FLAGSHIP_SAMPLES = 300
# sharded vs one-card evidence, max relative difference over every value and
# gradient component. The check runs with --xla_gpu_deterministic_ops: by
# default the GPU compiler sums the gradient's scatter-adds with atomics and
# schedules reductions and products per shape, so the gradient's last bits
# change between compilations and batch sizes. With the flag, each chain's
# arithmetic does not depend on how many chains share a device, so the two
# agree to the bit (one H100, configs 3-5: 4096 chains in one call against
# four calls of 1024, identical; without the flag, 15,824 of 20,480
# gradient components differ between two compilations of one program)
SHARDED_GATE = 1e-6

EPS32 = float(np.finfo(np.float32).eps)


def say(msg, **fields):
    print(msg + (" " + json.dumps(fields) if fields else ""), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


@contextlib.contextmanager
def phase(name):
    say(f"== {name}")
    t0 = time.perf_counter()
    yield
    say(f"== {name}: passed", wall_s=round(time.perf_counter() - t0, 1))


# ---------------------------------------------------------------- oracle --
def _oracle():
    """tests/oracle/gp_numpy.py, loaded by path, so that an installed
    package named ``tests`` cannot shadow the repository's own."""
    import importlib.util

    path = os.path.join(ROOT, "tests", "oracle", "gp_numpy.py")
    spec = importlib.util.spec_from_file_location("gp_numpy_oracle", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jitter(K_obs, err):
    """The f32 path's jitter (the oracle's copy of the engine's rule), so
    both sides factor the same K."""
    return _oracle().engine_jitter(K_obs, err, EPS32)


def oracle_loglik(case, data):
    """Host float64 log marginal likelihood of one theta: config 4's
    Gibbs-tanh model, or config 3's warped Matern-5/2 with a linear mean."""
    O = _oracle()

    X = np.asarray(data.Xf, np.float64).reshape(-1)
    nid = np.asarray(data.nid)
    y = np.asarray(data.y, np.float64)
    err = np.asarray(data.err_y, np.float64)

    def ll(t):
        if case == "config4":
            K = O.block_matrix(
                X, nid, X, nid, lambda a, b, p, q: O.gibbs_block_cs(a, b, p, q, t)
            )
            r = y
        else:  # config 3: Matern-5/2 on BetaWarp'd inputs + linear mean
            w = O.beta_warp(X, t[2], t[3])
            K = O.matern52_value(w[:, None], w[None, :], t[0], t[1])
            r = y - (t[4] * X + t[5])
        jit = _jitter(K + np.diag(err**2), err)
        return O.log_marginal(K, r, err, jitter=jit)

    return ll


def oracle_grad(ll, t, rel=1e-5):
    g = np.zeros_like(t)
    for k in range(t.shape[0]):
        h = rel * max(abs(t[k]), 1e-3)
        tp, tm = t.copy(), t.copy()
        tp[k] += h
        tm[k] -= h
        g[k] = (ll(tp) - ll(tm)) / (2 * h)
    return g


def errors(ll, g, ll_ref, g_ref):
    """(max relative ll error, p99 relative gradient error). A gradient
    component near zero has no scale of its own, so the denominator is
    floored at 1e-3 of that chain's largest component."""
    dll = np.abs(ll - ll_ref) / np.maximum(1.0, np.abs(ll_ref))
    scale = np.abs(g_ref) + 1e-3 * np.abs(g_ref).max(axis=1, keepdims=True)
    return float(dll.max()), float(np.percentile(np.abs(g - g_ref) / scale, 99))


# --------------------------------------------------------------- phases --
def device_phase(multi):
    import jax

    from gptools_tpu.utils import xla_cache
    from gptools_tpu.utils.device import card_line, require_gpu

    devs = require_gpu()
    cache = xla_cache.enable()
    say(
        "device",
        kind=devs[0].device_kind,
        count=len(devs),
        jax=jax.__version__,
        xla_flags=os.environ.get("XLA_FLAGS", ""),
        compile_cache=cache,
    )
    print(card_line(), flush=True)
    want = 4 if multi else 1
    check(len(devs) == want, f"need {want} GPUs, found {len(devs)}")
    return devs


def _vag(model, data):
    import jax
    import jax.numpy as jnp

    def f(t):
        ll, pull = jax.vjp(lambda q: model.log_marginal_batch(q, data), t)
        (g,) = pull(jnp.ones_like(ll))
        return ll, g

    return f


def _config4_typical(num, seed=0):
    """Draws near the golden posterior moments of config 4 (log-normal in
    the positive parameters, normal in x0 clipped to its prior support)."""
    import jax.numpy as jnp

    from f32_parity import load_golden

    gold = load_golden()
    m, s = np.asarray(gold["mean"]), np.asarray(gold["std"])
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((num, m.size))
    th = m * np.exp(z * s / m)
    th[:, 4] = np.clip(m[4] + s[4] * z[:, 4], 0.61, 1.09)
    return jnp.asarray(th, jnp.float32)


def _config3_problem():
    from gptools_tpu import configs

    p3 = configs.ALL_CONFIGS[3]()
    return p3.model, p3.data


def _config3_typical(num, seed=0):
    """Config 3 posterior draws: the package's SMC particles (1024), tiled
    to ``num`` chains."""
    import jax
    import jax.numpy as jnp

    from gptools_tpu.infer import smc

    model, data = _config3_problem()
    res = smc.sample(model, data, jax.random.PRNGKey(seed), num_particles=1024)
    th = res.thetas.reshape(-1, res.thetas.shape[-1])
    return jnp.tile(th, (-(-num // th.shape[0]), 1))[:num].astype(jnp.float32)


def evidence_phase(case, make, thetas, n_oracle=16):
    import jax

    model, data = make()
    num_chains = thetas.shape[0]
    t0 = time.perf_counter()
    compiled = jax.jit(_vag(model, data)).lower(thetas).compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    ll, g = jax.block_until_ready(compiled(thetas))
    t0 = time.perf_counter()
    for _ in range(20):
        out = compiled(thetas)
    jax.block_until_ready(out)
    per_grad_ms = (time.perf_counter() - t0) / 20 * 1e3
    ll, g = np.asarray(ll, np.float64), np.asarray(g, np.float64)
    check(np.isfinite(ll).all() and np.isfinite(g).all(),
          f"{case}: non-finite evidence at posterior-typical theta")
    ll_fn = oracle_loglik(case, data)
    th64 = np.asarray(thetas[:n_oracle], np.float64)
    ll_o = np.array([ll_fn(t) for t in th64])
    g_o = np.array([oracle_grad(ll_fn, t) for t in th64])
    err = errors(ll[:n_oracle], g[:n_oracle], ll_o, g_o)
    say(
        f"{case} evidence",
        N=int(data.Xf.shape[0]),
        chains=num_chains,
        compile_s=round(compile_s, 2),
        per_grad_ms=round(per_grad_ms, 3),
        temp_bytes=int(mem.temp_size_in_bytes),
        argument_bytes=int(mem.argument_size_in_bytes),
        output_bytes=int(mem.output_size_in_bytes),
        vs_oracle=err,
        gates=[LL_GATE, GRAD_P99_GATE],
        oracle_chains=n_oracle,
    )
    check(err[0] <= LL_GATE, f"{case}: ll vs oracle {err[0]}")
    check(err[1] <= GRAD_P99_GATE, f"{case}: grad vs oracle {err[1]}")


def _run_pipeline(model, data, seed, num_chains, num_warmup, num_samples,
                  mesh=None):
    import jax

    from gptools_tpu.infer.pipeline import smc_then_chees
    from gptools_tpu.utils.diagnostics import ess_and_rhat

    t0 = time.perf_counter()
    res = smc_then_chees(
        model, data, jax.random.PRNGKey(seed), num_chains=num_chains,
        num_warmup=num_warmup, num_samples=num_samples, num_particles=1024,
        max_steps=256, mesh=mesh,
    )
    jax.block_until_ready(res.u)
    wall = time.perf_counter() - t0
    ess, rhat = ess_and_rhat(res.thetas)
    ess, rhat = np.asarray(ess), np.asarray(rhat)
    div = int(res.diagnostics["divergences"])
    frac = div / (num_chains * num_samples)
    flat = res.thetas.reshape(-1, res.thetas.shape[-1])
    stats = {
        "wall_s": round(wall, 2),
        "min_ess": float(ess.min()),
        "max_rhat": float(rhat.max()),
        "divergence_frac": frac,
        "mean": np.asarray(flat.mean(axis=0)).tolist(),
        "std": np.asarray(flat.std(axis=0, ddof=1)).tolist(),
        "ess": ess.tolist(),
    }
    check(stats["max_rhat"] <= RHAT_GATE, f"max split-R-hat {stats['max_rhat']}")
    check(frac <= DIVERGENCE_FRAC_GATE, f"divergence fraction {frac}")
    return res, stats


def flagship_phase():
    from bench import _flagship_problem
    from f32_parity import golden_gate

    model, data = _flagship_problem()
    say(
        f"flagship: config 4, 12288 chains, 1024 particles, 75 warmup, "
        f"{FLAGSHIP_SAMPLES} samples (cut from the bench's 3000)"
    )
    _, st = _run_pipeline(model, data, 0, 12288, 75, FLAGSHIP_SAMPLES)
    gate = golden_gate(st["mean"], st["std"], st["ess"])
    say("flagship", **{k: st[k] for k in ("wall_s", "min_ess", "max_rhat",
                                           "divergence_frac")}, golden=gate)
    check(gate["ok"], f"golden moments: {gate}")


def _predictive_f64(data, thetas, grid):
    """Mixture predictive mean and std of config 5 (Gibbs-tanh latent with a
    slope row and a line-integral observation) in float64 numpy, over the
    same posterior draws."""
    O = _oracle()

    X = np.asarray(data.Xf, np.float64).reshape(-1)
    nid = np.asarray(data.nid)
    y = np.asarray(data.y, np.float64)
    err = np.asarray(data.err_y, np.float64)
    T = np.asarray(data.T, np.float64)
    th = np.asarray(thetas, np.float64)[:, :, None, None]  # (D, 5, 1, 1)
    t = tuple(th[:, k] for k in range(5))

    def blocks(a, b, p, q):
        return O.gibbs_block_cs(a, b, p, q, t)

    Kff = O.block_matrix(X, nid, X, nid, blocks)  # (D, N, N)
    Kobs = T @ Kff @ T.T + np.diag(err**2)
    Kobs = Kobs + _jitter(Kobs, err)[:, None, None] * np.eye(len(y))
    L = np.linalg.cholesky(Kobs)
    alpha = np.linalg.solve(Kobs, y[None, :, None])[..., 0]
    Ks = O.block_matrix(grid, np.zeros(len(grid), int), X, nid, blocks) @ T.T
    mean_d = np.einsum("dsn,dn->ds", Ks, alpha)
    V = np.linalg.solve(L, np.swapaxes(Ks, 1, 2))
    var_d = th[:, 0, 0] ** 2 - np.sum(V * V, axis=1)
    mean = mean_d.mean(axis=0)
    var = (np.clip(var_d, 0.0, None) + mean_d**2).mean(axis=0) - mean**2
    return mean, np.sqrt(np.clip(var, 0.0, None))


def config5_phase():
    from gptools_tpu import configs
    from gptools_tpu.models.serve import FrozenMCMCPredictor

    p5 = configs.ALL_CONFIGS[5]()
    model, data = p5.model, p5.data
    res, st = _run_pipeline(model, data, 0, 1024, 100, 300)
    say("config5 pipeline", **{k: st[k] for k in ("wall_s", "min_ess",
                                                   "max_rhat", "divergence_frac")})
    flat = res.thetas.reshape(-1, res.thetas.shape[-1])
    pred = FrozenMCMCPredictor(model, data, flat, max_samples=1024, bucket=1)
    grid = np.linspace(0.0, 1.2, 200)
    t0 = time.perf_counter()
    mean, std = pred(grid)
    mean, std = np.asarray(mean, np.float64), np.asarray(std, np.float64)
    wall = time.perf_counter() - t0
    m64, s64 = _predictive_f64(data, pred.thetas, grid)
    dm = float(np.max(np.abs(mean - m64) / s64))
    ds = float(np.max(np.abs(std - s64) / s64))
    say("config5 predictive", draws=int(pred.thetas.shape[0]), points=200,
        query_wall_s=round(wall, 2), max_dmean_over_std=dm,
        max_dstd_over_std=ds, gate=PRED_GATE)
    check(np.isfinite(mean).all() and np.isfinite(std).all(), "non-finite")
    check(dm <= PRED_GATE and ds <= PRED_GATE, "predictive vs float64")


def readme_phase():
    import jax

    from gptools_tpu import GaussianProcess, SquaredExponentialKernel
    from gptools_tpu.utils.priors import LogNormalJointPrior
    O = _oracle()

    X = np.linspace(0, 3, 25)
    y = np.sin(2 * X) + 0.1 * np.random.default_rng(0).standard_normal(25)
    mu, sig = np.array([0.0, -0.7]), np.array([0.8, 0.8])
    k = SquaredExponentialKernel(hyperprior=LogNormalJointPrior(mu, sig))
    gp = GaussianProcess(k)
    gp.add_data(X, y, err_y=0.1)
    gp.add_data(0.0, 2.0, n=1, err_y=0.05)
    gp.optimize_hyperparameters(random_starts=8)
    mean, std = gp.predict(np.linspace(0, 3, 100))
    slope, _ = gp.predict([1.0], n=1)
    res = gp.sample_hyperparameter_posterior(nsamp=200, burn=100, num_chains=8,
                                             sampler="nuts")
    m, s = gp.predict_MCMC(np.linspace(0, 3, 100))
    for name, v in (("mean", mean), ("std", std), ("slope", slope),
                    ("thetas", res.thetas), ("mcmc mean", m), ("mcmc std", s)):
        check(np.isfinite(np.asarray(v)).all(), f"readme: non-finite {name}")

    theta = np.asarray(gp.theta, np.float64)
    data = gp.data
    lp = float(jax.jit(gp.model.log_posterior)(gp.theta, data))
    Xd = np.asarray(data.Xf, np.float64).reshape(-1)
    nd = np.asarray(data.nid)
    err = np.asarray(data.err_y, np.float64)
    K = O.block_matrix(
        Xd, nd, Xd, nd, lambda a, b, p, q: O.se_kernel(a, b, p, q, *theta)
    )
    jit = _jitter(K + np.diag(err**2), err)
    ll64 = O.log_marginal(K, np.asarray(data.y, np.float64), err, jitter=jit)
    lx = np.log(theta)
    lprior = np.sum(-0.5 * ((lx - mu) / sig) ** 2 - lx - np.log(sig)
                    - 0.5 * np.log(2 * np.pi))
    lp64 = ll64 + lprior
    rel = abs(lp - lp64) / max(1.0, abs(lp64))
    say("readme", theta=theta.tolist(), map_log_posterior=lp,
        oracle_log_posterior=lp64, rel_err=rel, slope_at_1=float(slope[0]))
    check(rel <= LL_GATE, f"readme: MAP log posterior vs oracle {rel}")


def sharded_evidence_check(mesh):
    """Config 5's batched evidence value + gradient at fixed prior draws,
    sharded over the mesh (GSPMD) against one device, gated by
    SHARDED_GATE on the largest relative difference (equal infinities and
    NaNs count as equal). Returns whether they agree, after printing where
    they differ."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from gptools_tpu import configs

    p5 = configs.ALL_CONFIGS[5]()
    model, data = p5.model, p5.data
    vag = jax.jit(_vag(model, data))
    thetas = jax.device_put(
        np.asarray(model.hyperprior.sample(jax.random.PRNGKey(3), (4096,))),
        jax.devices()[0],
    )
    ref = vag(thetas)
    sh = NamedSharding(mesh, PartitionSpec(mesh.axis_names[0]))
    out = vag(jax.device_put(thetas, sh))
    check(not out[0].sharding.is_fully_replicated, "evidence replicated")
    rels, where = {}, {}
    for name, a, b in zip(("ll", "grad"), out, ref):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        same = (a == b) | (np.isnan(a) & np.isnan(b))
        rel = np.where(same, 0.0, np.abs(a - b) / np.maximum(1e-6, np.abs(b)))
        rel = np.where(np.isnan(rel), np.inf, rel)
        rels[name] = float(rel.max())
        bad = np.argwhere(rel > SHARDED_GATE)
        where[name] = {
            "count": int(len(bad)),
            "chains_per_shard": np.bincount(
                bad[:, 0] // (a.shape[0] // 4), minlength=4
            ).tolist(),
            "first": [[int(i) for i in idx] + [float(a[tuple(idx)]),
                                                float(b[tuple(idx)])]
                      for idx in bad[:4]],
        }
    say("sharded evidence config5", ll_rel_max=rels["ll"],
        grad_rel_max=rels["grad"], gate=SHARDED_GATE, mismatches=where)
    return max(rels.values()) <= SHARDED_GATE


def pt_2d_step():
    """The 2-D (temps x chains) parallel-tempering step on four devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    import __graft_entry__ as entry
    from gptools_tpu.parallel.mesh import pt_step_sharded

    model, data = entry._flagship(num_points=8)
    mesh2 = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("temps", "chains"))
    T, C = 4, 256
    pt_jit, (ut0, eps0, im0) = pt_step_sharded(
        model, data, mesh2, num_temps=T, num_chains=C, num_steps=4
    )
    sh2 = NamedSharding(mesh2, PartitionSpec("temps", "chains"))
    sh_t = NamedSharding(mesh2, PartitionSpec("temps"))
    u1, ll1, swap, _ = pt_jit(
        jax.device_put(jnp.zeros_like(ut0), sh2), jax.random.PRNGKey(3),
        jax.device_put(eps0, sh_t), jax.device_put(im0, sh_t), 0,
    )
    check(u1.shape == (T, C, model.num_free_params), "PT shape")
    check(np.isfinite(np.asarray(ll1)).all(), "PT non-finite")
    say("pt 2-D step", swap_frac=float(np.asarray(swap).mean()))


def multi_phase():
    """Four cards: the 2-D PT step, then config 5's pipeline sharded over
    make_mesh(4) against one card."""
    import jax

    from gptools_tpu import configs
    from gptools_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(4)
    pt_2d_step()

    # config 5's pipeline, chains sharded over the mesh, against one card
    p5 = configs.ALL_CONFIGS[5]()
    model, data = p5.model, p5.data
    res4, st4 = _run_pipeline(model, data, 0, 1024, 100, 300, mesh=mesh)
    check(not res4.u.sharding.is_fully_replicated, "pipeline replicated")
    check(res4.u.addressable_shards[0].data.shape[0] == res4.u.shape[0] // 4,
          "shard size")
    with jax.default_device(jax.devices()[0]):
        _, st1 = _run_pipeline(model, data, 1, 1024, 100, 300)
    m4, s4, e4 = (np.asarray(st4[k]) for k in ("mean", "std", "ess"))
    m1, s1, e1 = (np.asarray(st1[k]) for k in ("mean", "std", "ess"))
    z = (m4 - m1) / np.sqrt(s4**2 / e4 + s1**2 / e1)
    say("config5 4 cards vs 1", wall_4=st4["wall_s"], wall_1=st1["wall_s"],
        rhat_4=st4["max_rhat"], rhat_1=st1["max_rhat"], z=z.tolist())
    check(np.all(np.abs(z) <= 4.0), "4-card moments vs 1-card")
    check(np.all(np.abs(s4 - s1) <= 0.15 * s1), "4-card stds vs 1-card")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four cards: run only the sharded phase")
    ap.add_argument("--multi-evidence", action="store_true",
                    help="four cards: only the sharded evidence check, with "
                    "deterministic GPU ops (--multi runs it first)")
    args = ap.parse_args()
    if args.multi_evidence:
        # before JAX starts (see SHARDED_GATE)
        os.environ["XLA_FLAGS"] = " ".join(
            (os.environ.get("XLA_FLAGS", ""), "--xla_gpu_deterministic_ops=true")
        ).strip()
        with phase("device"):
            device_phase(True)
        with phase("sharded evidence"):
            from gptools_tpu.parallel.mesh import make_mesh

            check(sharded_evidence_check(make_mesh(4)),
                  "sharded vs unsharded evidence")
        return
    if args.multi:
        # deterministic GPU ops slow the samplers several times over, so the
        # bit-level evidence check runs alone, in its own process, before
        # this one opens the cards
        with phase("sharded evidence (own process)"):
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--multi-evidence"], check=True)

    with phase("device"):
        devs = device_phase(args.multi)
    if args.multi:
        with phase("multi"):
            multi_phase()
    else:
        from bench import _flagship_problem

        with phase("evidence config4"):
            evidence_phase("config4", _flagship_problem,
                           _config4_typical(12288))
        with phase("evidence config3"):
            evidence_phase("config3", _config3_problem,
                           _config3_typical(12288))
        with phase("flagship"):
            flagship_phase()
        with phase("config5"):
            config5_phase()
        with phase("readme"):
            readme_phase()
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devs)}}))


if __name__ == "__main__":
    main()
