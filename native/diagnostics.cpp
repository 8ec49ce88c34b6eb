// Host-side chain diagnostics: batched ESS and split-R-hat.
//
// Role in the framework (SURVEY.md section 2.2): the reference delegated all
// heavy host numerics to compiled libraries (LAPACK/Cephes via scipy); this
// rebuild keeps device compute in XLA/Pallas but gives the HOST
// side of the runtime a compiled core too. Post-processing checkpointed
// chain archives (thousands of chains x long runs x many params) through
// numpy/JAX round-trips is allocation-bound; this library computes the
// Geyer-truncated effective sample size and split-R-hat in one pass with a
// thread pool, bit-identical in algorithm to
// gptools_tpu/utils/diagnostics.py (tested against it).
//
// Build: `make -C native` (plain C ABI, loaded via ctypes — no pybind11).
//
// Algorithm (matches diagnostics.ess):
//   acov_j  = (1/n) sum_t xc_t xc_{t+j}                (biased autocov)
//   w       = mean over chains of var(chain, ddof=1)
//   varplus = w (n-1)/n + B/n,  B = n var(chain means, ddof=1)  [m > 1]
//   rho_j   = 1 - (w - mean_c acov_j) / varplus
//   pairs P_k = rho_{2k} + rho_{2k+1}; running-min monotonization;
//   truncate at first non-positive pair; tau = -1 + 2 sum P;
//   ESS = m n / max(tau, 1/n).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// ESS for one parameter: chains is (m, n) row-major with row stride `stride`.
//
// Lags are evaluated INCREMENTALLY, outer loop over Geyer pairs with the
// running-min truncation applied as soon as each pair is known: the scan
// stops at the first non-positive monotonized pair (identical math to the
// full-lag version — every skipped lag had zero weight), which turns the
// O(m n^2) full autocovariance into O(m n J_stop) with J_stop typically a
// few dozen. For long-memory chains the scan may not terminate early; a
// `max_pairs` budget bounds the work and the function returns NaN when the
// budget is exhausted — callers fall back to an FFT path (the Python wrapper
// reruns only those parameters through JAX). Measured on
// (12288 chains, 800 draws, 5 params), iid-like chains: 12.2 s (full-lag)
// -> ~1.0 s, vs 6.0 s for the JAX FFT path on the same host.
double ess_one(const double* chains, int64_t m, int64_t n, int64_t stride,
               int64_t max_pairs) {
    std::vector<double> xc((size_t)(m * n));
    double w = 0.0;
    std::vector<double> chain_means(m);

    for (int64_t c = 0; c < m; ++c) {
        const double* x = chains + c * stride;
        double* xcc = xc.data() + c * n;
        double mu = 0.0;
        for (int64_t t = 0; t < n; ++t) mu += x[t];
        mu /= (double)n;
        chain_means[c] = mu;
        double ss = 0.0;
        for (int64_t t = 0; t < n; ++t) {
            xcc[t] = x[t] - mu;
            ss += xcc[t] * xcc[t];
        }
        w += ss / (double)(n - 1);  // ddof=1 variance
    }
    w /= (double)m;

    double varplus = w * (double)(n - 1) / (double)n;
    if (m > 1) {
        double gm = 0.0;
        for (int64_t c = 0; c < m; ++c) gm += chain_means[c];
        gm /= (double)m;
        double b = 0.0;
        for (int64_t c = 0; c < m; ++c) {
            double d = chain_means[c] - gm;
            b += d * d;
        }
        b = (double)n * b / (double)(m - 1);
        varplus += b / (double)n;
    }
    if (varplus <= 0.0) return (double)(m * n);

    // Lags are produced in blocks, CHAIN-MAJOR within a block so each
    // centered chain row (n doubles, L1-resident for typical n) is streamed
    // from RAM once per block instead of once per lag — the lag-major form
    // was memory-bound (m*n*8 bytes re-read per lag). Geyer pairs are
    // consumed between blocks, so the scan still exits as soon as the
    // monotonized pair sum goes non-positive.
    const int64_t n_pairs = n / 2;
    const int64_t pair_budget =
        (max_pairs > 0) ? std::min(max_pairs, n_pairs) : n_pairs;
    std::vector<double> acov;  // sum over chains of biased autocov / n
    double tau = -1.0;
    double running_min = INFINITY;
    int64_t j_done = 0;      // lags accumulated so far
    int64_t k = 0;           // pairs consumed so far
    int64_t lag_block = 8;   // grows geometrically: fast-mixing chains pay
                             // for ~8 lags, long-memory ones amortize
    while (true) {
        int64_t j_hi = std::min(j_done + lag_block, n);
        lag_block *= 4;
        acov.resize((size_t)j_hi, 0.0);
        for (int64_t c = 0; c < m; ++c) {
            const double* xcc = xc.data() + c * n;
            for (int64_t j = j_done; j < j_hi; ++j) {
                // 4 accumulators break the FP-add dependency chain
                double s0 = 0.0, s1 = 0.0, s2 = 0.0, s3 = 0.0;
                const int64_t lim = n - j;
                int64_t t = 0;
                for (; t + 4 <= lim; t += 4) {
                    s0 += xcc[t] * xcc[t + j];
                    s1 += xcc[t + 1] * xcc[t + 1 + j];
                    s2 += xcc[t + 2] * xcc[t + 2 + j];
                    s3 += xcc[t + 3] * xcc[t + 3 + j];
                }
                for (; t < lim; ++t) s0 += xcc[t] * xcc[t + j];
                acov[(size_t)j] += (s0 + s1 + s2 + s3) / (double)n;
            }
        }
        j_done = j_hi;
        while (2 * k + 1 < j_done && k < pair_budget) {
            double a0 = acov[(size_t)(2 * k)] / (double)m;
            double a1 = acov[(size_t)(2 * k + 1)] / (double)m;
            double pair = (1.0 - (w - a0) / varplus) + (1.0 - (w - a1) / varplus);
            running_min = std::min(running_min, pair);
            if (running_min <= 0.0) {
                tau = std::max(tau, 1.0 / (double)n);
                return (double)(m * n) / tau;
            }
            tau += 2.0 * running_min;
            ++k;
        }
        if (k >= n_pairs) {  // every pair consumed, all positive
            tau = std::max(tau, 1.0 / (double)n);
            return (double)(m * n) / tau;
        }
        if (k >= pair_budget) return NAN;  // budget exhausted: FFT fallback
    }
}

// split-R-hat for one parameter on (m, n) with stride.
double rhat_one(const double* chains, int64_t m, int64_t n, int64_t stride) {
    const int64_t half = n / 2;
    if (half < 2) return NAN;
    const int64_t m2 = 2 * m;
    std::vector<double> means(m2), vars(m2);
    for (int64_t c = 0; c < m2; ++c) {
        const double* x = chains + (c % m) * stride + (c / m) * half;
        double mu = 0.0;
        for (int64_t t = 0; t < half; ++t) mu += x[t];
        mu /= (double)half;
        double ss = 0.0;
        for (int64_t t = 0; t < half; ++t) {
            double d = x[t] - mu;
            ss += d * d;
        }
        means[c] = mu;
        vars[c] = ss / (double)(half - 1);
    }
    double wv = 0.0, gm = 0.0;
    for (int64_t c = 0; c < m2; ++c) {
        wv += vars[c];
        gm += means[c];
    }
    wv /= (double)m2;
    gm /= (double)m2;
    double b = 0.0;
    for (int64_t c = 0; c < m2; ++c) {
        double d = means[c] - gm;
        b += d * d;
    }
    b = (double)half * b / (double)(m2 - 1);
    double varplus = (double)(half - 1) / (double)half * wv + b / (double)half;
    return std::sqrt(varplus / wv);
}

template <typename F>
void parallel_over(int64_t count, F&& fn) {
    unsigned hw = std::thread::hardware_concurrency();
    int64_t n_threads = std::min<int64_t>(count, hw ? hw : 4);
    if (n_threads <= 1) {
        for (int64_t i = 0; i < count; ++i) fn(i);
        return;
    }
    std::atomic<int64_t> next(0);
    std::vector<std::thread> pool;
    for (int64_t t = 0; t < n_threads; ++t) {
        pool.emplace_back([&]() {
            for (;;) {
                int64_t i = next.fetch_add(1);
                if (i >= count) return;
                fn(i);
            }
        });
    }
    for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// chains: (m, n, d) C-contiguous float64. out: (d,) per-parameter values.
// max_pairs <= 0 means unbounded; out[k] = NaN when the Geyer scan for
// parameter k did not terminate within max_pairs pairs.
void gpt_ess_batch(const double* chains, int64_t m, int64_t n, int64_t d,
                   int64_t max_pairs, double* out) {
    parallel_over(d, [&](int64_t k) {
        // gather parameter k into a contiguous (m, n) scratch
        std::vector<double> buf((size_t)(m * n));
        for (int64_t c = 0; c < m; ++c)
            for (int64_t t = 0; t < n; ++t)
                buf[(size_t)(c * n + t)] = chains[(c * n + t) * d + k];
        out[k] = ess_one(buf.data(), m, n, n, max_pairs);
    });
}

void gpt_split_rhat_batch(const double* chains, int64_t m, int64_t n,
                          int64_t d, double* out) {
    parallel_over(d, [&](int64_t k) {
        std::vector<double> buf((size_t)(m * n));
        for (int64_t c = 0; c < m; ++c)
            for (int64_t t = 0; t < n; ++t)
                buf[(size_t)(c * n + t)] = chains[(c * n + t) * d + k];
        out[k] = rhat_one(buf.data(), m, n, n);
    });
}

int gpt_abi_version() { return 2; }

}  // extern "C"
