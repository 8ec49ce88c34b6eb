"""f32 error of each matrix product on the sampler and predictive paths,
with the default precision and with ``Precision.HIGHEST``, against float64
numpy on the same f32 operands.

On the GPU the default precision may round f32 operands to TF32; the
package passes HIGHEST at every product below. Operands are seeded random
arrays at the shapes the products take in config 5 (line-integral T,
32 observations over 47 latent points, 1024 chains) and config 4 (N = 27).

    python scripts/precision_report.py

Prints one JSON line per product: max |error| / max |f64 result|.
Fails without a GPU.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp
    from jax import lax

    from gptools_tpu.utils.device import device_record

    dev = device_record()
    print(json.dumps({"device": dev}), flush=True)
    rng = np.random.default_rng(0)

    def spd(n, c):
        a = rng.standard_normal((c, n, n)) / np.sqrt(n)
        return np.moveaxis(a @ np.swapaxes(a, 1, 2) + np.eye(n), 0, -1)

    T = rng.uniform(0.0, 0.1, (32, 47))
    Kff = spd(47, 1024)
    C = np.linalg.cholesky(spd(5, 1)[..., 0])
    v = rng.standard_normal((12288, 5))
    mu = rng.standard_normal(5)
    Z = np.tril(rng.standard_normal((27, 27)))[:, :, None] * rng.uniform(
        0.5, 2.0, (1, 1, 12288)
    )
    Ks = rng.standard_normal((200, 32))
    alpha = rng.standard_normal(32)
    V = rng.standard_normal((32, 200))

    products = {
        "T contraction (gp.log_marginal_batch)": (
            lambda p, T, K: jnp.einsum("mi,ijc,nj->mnc", T, K, T, precision=p),
            (T, Kff),
            lambda T, K: np.einsum("mi,ijc,nj->mnc", T, K, T),
        ),
        "whitening vs @ C.T + mu (pipeline)": (
            lambda p, v, C, mu: jnp.matmul(v, C.T, precision=p) + mu,
            (v, C, mu),
            lambda v, C, mu: v @ C.T + mu,
        ),
        "K^-1 = Z^T Z (evidence.loglik_b gradient)": (
            lambda p, Z: jnp.einsum("kic,kjc->ijc", Z, Z, precision=p),
            (Z,),
            lambda Z: np.einsum("kic,kjc->ijc", Z, Z),
        ),
        "predictive mean Ks_obs @ alpha (gp.predict)": (
            lambda p, Ks, a: jnp.matmul(Ks, a, precision=p),
            (Ks, alpha),
            lambda Ks, a: Ks @ a,
        ),
        "predictive cov V^T V (gp.predict)": (
            lambda p, V: jnp.matmul(V.T, V, precision=p),
            (V,),
            lambda V: V.T @ V,
        ),
        "Ksf @ T^T (gp.predict)": (
            lambda p, Ks, T: jnp.matmul(Ks, T.T, precision=p),
            (rng.standard_normal((200, 47)), T),
            lambda Ks, T: Ks @ T.T,
        ),
    }
    for name, (f, args, ref) in products.items():
        a32 = [np.asarray(a, np.float32) for a in args]
        want = ref(*[a.astype(np.float64) for a in a32])
        scale = np.abs(want).max()
        out = {"product": name}
        for label, prec in (("default", lax.Precision.DEFAULT),
                            ("highest", lax.Precision.HIGHEST)):
            got = np.asarray(
                jax.jit(lambda *xs: f(prec, *xs))(*map(jnp.asarray, a32)),
                np.float64,
            )
            out[f"rel_err_{label}"] = float(np.abs(got - want).max() / scale)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
