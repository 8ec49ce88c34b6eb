"""Stage-level wall breakdown of the bench pipeline on the current device.

Separates COMPILE (first call) from RUN (steady-state call) for each jitted
program in the smc_then_chees production pipeline at bench shapes, so
bench-budget decisions are driven by measurement:

    python scripts/profile_pipeline.py --chains 12288 --warmup 75

Prints one JSON line per stage and a totals line.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def t():
    return time.perf_counter()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=12288)
    ap.add_argument("--particles", type=int, default=1024)
    ap.add_argument("--warmup", type=int, default=75)
    ap.add_argument("--sample-chunks", type=int, default=2)
    ap.add_argument("--max-steps", type=int, default=256)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from bench import _flagship_problem
    from gptools_tpu.infer import chees as _chees
    from gptools_tpu.infer import hmc as _hmc
    from gptools_tpu.infer import smc as _smc
    from gptools_tpu.infer.pt import model_splits

    model, data = _flagship_problem()
    stages = {}

    def stage(name, fn):
        t0 = t()
        out = fn()
        jax.block_until_ready(out)
        stages[name] = round(t() - t0, 3)
        print(json.dumps({"stage": name, "wall_s": stages[name]}), flush=True)
        return out

    # ---- SMC ----
    log_like_fn, log_prior_fn = model_splits(model, data)
    k = jax.random.PRNGKey(0)
    k_init, k = jax.random.split(k)
    thetas0 = model.hyperprior.sample(k_init, (args.particles,))
    u0p = jax.jit(jax.vmap(model.u_of_theta))(thetas0)
    state = _smc.SMCState(
        u=u0p,
        log_like=jax.jit(jax.vmap(log_like_fn))(u0p),
        log_prior=jax.jit(jax.vmap(log_prior_fn))(u0p),
        beta=jnp.zeros((), u0p.dtype),
        log_z=jnp.zeros((), u0p.dtype),
        key=k,
        acc_rate=jnp.ones((), u0p.dtype),
    )
    round_fn = jax.jit(lambda s: _smc.smc_round(log_like_fn, log_prior_fn, s))
    state = stage("smc_round_1_compile+run", lambda: round_fn(state))
    n_rounds = 1
    t0 = t()
    while float(state.beta) < 1.0 and n_rounds < 100:
        state = round_fn(state)
        n_rounds += 1
    jax.block_until_ready(state.u)
    stages["smc_rounds_rest_run"] = round(t() - t0, 3)
    print(json.dumps({"stage": "smc_rounds_rest_run",
                      "wall_s": stages["smc_rounds_rest_run"],
                      "rounds": n_rounds}), flush=True)

    # ---- whitening + chain init ----
    particles = state.u
    k_res, k_run = jax.random.split(jax.random.PRNGKey(1))
    idx = jax.random.randint(k_res, (args.chains,), 0, particles.shape[0])
    u0 = particles[idx]
    mu = jnp.mean(particles, axis=0)
    P = particles.shape[1]
    cov = jnp.cov(particles.T) + 1e-8 * jnp.eye(P, dtype=particles.dtype)
    C = jnp.linalg.cholesky(cov)

    def logp_w(v):
        return model.log_posterior_u(mu + C @ v, data)

    v0 = stage(
        "whiten_compile+run",
        lambda: jax.jit(
            jax.vmap(
                lambda u: jax.scipy.linalg.solve_triangular(C, u - mu, lower=True)
            )
        )(u0),
    )

    # ---- ChEES warmup / sampling chunks (mirrors chees.sample: ONE merged
    # warm/samp program with a traced adapt flag, batched chains-minor logp
    # when the model supports it) ----
    if model._batch_supported(data):

        def logp_w_batched(vs):
            return model.log_posterior_u_batch(vs @ C.T + mu, data)

        def logp_and_grad(qs):
            lls, pull = jax.vjp(logp_w_batched, qs)
            (g,) = pull(jnp.ones_like(lls))
            return lls, g

    else:
        _vag = jax.value_and_grad(logp_w)

        def logp_and_grad(qs):
            return jax.vmap(_vag)(qs)

    inv_mass = jnp.ones((P,), v0.dtype)
    logps, grads = stage(
        "init_logp_grad_compile+run",
        lambda: jax.jit(logp_and_grad)(v0),
    )
    cstate = _chees.CheesState(
        qs=v0,
        logps=logps,
        grads=grads,
        da=_hmc.da_init(jnp.asarray(0.3, v0.dtype)),
        log_tau=jnp.log(jnp.asarray(0.3 * 8.0, v0.dtype)),
        adam_m=jnp.zeros((), v0.dtype),
        adam_v=jnp.zeros((), v0.dtype),
        iteration=jnp.zeros((), jnp.int32),
        key=k_run,
    )
    chunk = 25

    @jax.jit
    def run_chunk(s0, adapt):
        def body(s, _):
            s, (q, lp, st) = _chees.chees_step(
                logp_and_grad, s, inv_mass, adapt=adapt,
                max_steps=args.max_steps,
            )
            return s, (q, lp, st["accept_prob"])

        return jax.lax.scan(body, s0, None, length=chunk)

    one = jnp.ones((), jnp.int32)
    zero = jnp.zeros((), jnp.int32)
    cstate, _ = stage(
        "warm_chunk_1_compile+run", lambda: run_chunk(cstate, one)
    )
    n_wchunks = -(-args.warmup // chunk)
    t0 = t()
    for _ in range(n_wchunks - 1):
        cstate, _ = run_chunk(cstate, one)
    jax.block_until_ready(cstate.qs)
    stages["warm_chunks_rest_run"] = round(t() - t0, 3)
    print(json.dumps({"stage": "warm_chunks_rest_run",
                      "wall_s": stages["warm_chunks_rest_run"],
                      "chunks": n_wchunks - 1}), flush=True)

    eps_final = jnp.exp(cstate.da.log_eps_avg)
    cstate = cstate._replace(da=cstate.da._replace(log_eps=jnp.log(eps_final)))
    cstate, out1 = stage(
        "samp_chunk_1_run(shared program)", lambda: run_chunk(cstate, zero)
    )
    t0 = t()
    outs = [out1]
    for _ in range(args.sample_chunks - 1):
        cstate, o = run_chunk(cstate, zero)
        outs.append(o)
    jax.block_until_ready(cstate.qs)
    per = (t() - t0) / max(args.sample_chunks - 1, 1)
    stages["samp_chunk_run_each"] = round(per, 3)
    print(json.dumps({"stage": "samp_chunk_run_each", "wall_s": per,
                      "eps": float(eps_final),
                      "tau": float(jnp.exp(cstate.log_tau))}), flush=True)

    us = jnp.concatenate([o[0] for o in outs], axis=0)
    theta = stage(
        "unwhiten+theta_compile+run",
        lambda: jax.jit(
            lambda vs: jax.vmap(jax.vmap(model.theta_of_u))(
                jnp.swapaxes(mu + jnp.einsum("ij,csj->csi", C, vs), 0, 1)
            )
        )(us),
    )

    from gptools_tpu.utils.diagnostics import ess_per_param

    t0 = t()
    ess = np.asarray(ess_per_param(theta))
    stages["host_ess"] = round(t() - t0, 3)
    print(json.dumps({"stage": "host_ess", "wall_s": stages["host_ess"],
                      "min_ess": float(ess.min())}), flush=True)

    print(json.dumps({
        "totals": stages,
        "device": str(jax.devices()[0]),
        "chains": args.chains,
        "warmup": args.warmup,
        "sample_chunks": args.sample_chunks,
    }), flush=True)


if __name__ == "__main__":
    main()
