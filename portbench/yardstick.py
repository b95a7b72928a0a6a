"""The benchmark's fixed arithmetic: peaks, bounds, percentiles, intervals.

Frozen here so that a later change to the program cannot move the
yardstick.  Peaks are NVIDIA's published figures for one H100 SXM at its
700 W limit (the card's limit is printed beside every run): 67 TFLOP/s in
float32 outside the tensor cores, 3.35 TB/s of HBM3.  Operation counts are
taken from shapes, as ``chip_smoke.py`` (``bound``) and
``auxpm_tpu_torch/ops/fused_estimator.probe_flops`` count them: a probe of
one chain is the product f = u C^T with C lower triangular, S n (n + 1)
FLOPs; a factorisation n^3 / 3 FLOPs, reading the lower triangle of the
Gram and writing the factor (n^2 + n (n + 1) / 2 floats).
"""

from __future__ import annotations

import math

import numpy as np

PEAK_F32_FLOPS = 67e12          # FLOP/s, float32 without tensor cores
PEAK_HBM_BYTES = 3.35e12        # bytes/s
F32 = 4                         # bytes of a float32


def bound_s(flops=0.0, bytes_=0.0):
    """Least seconds for ``flops`` and ``bytes_``: the larger of the two
    over their peaks."""
    return max(flops / PEAK_F32_FLOPS, bytes_ / PEAK_HBM_BYTES)


def probe_flops(s, n):
    """FLOPs of one probe of one chain: S n (n + 1)."""
    return float(s) * n * (n + 1)


def factor_flops(n):
    """FLOPs of one Cholesky factorisation of an n x n matrix."""
    return n ** 3 / 3.0


def factor_bytes(n):
    """Bytes one factorisation must move: the Gram's lower triangle read
    and written as the factor, n^2 + n (n + 1) / 2 floats as counted for
    the panel kernels' bound."""
    return (n * n + n * (n + 1) / 2.0) * F32


def factor_bound_s(n):
    return bound_s(factor_flops(n), factor_bytes(n))


def ess_sweep_bytes(s, n, n_repeats):
    """Bytes one chain's ESS sweep must move: u and the n_repeats v read,
    u' written, the factor's lower triangle read."""
    return (s * n * (n_repeats + 2) + n * (n + 1) / 2.0) * F32


def percentile(values, q):
    """The q-th percentile (0..100) by linear interpolation between order
    statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def union_seconds(intervals):
    """Length of the union of ``(start, end)`` intervals, and the gaps
    between the merged intervals as ``(start, end)``."""
    total, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


# --- effective sample size (a diagnostic line, not a metric) --------------
# Frozen copy of ``auxpm_tpu_torch/utils/diagnostics.effective_sample_size``
# (FFT autocovariance, Geyer's initial monotone sequence, Stan's rules).

def _autocov_fft(x):
    n = x.shape[0]
    x = x - x.mean()
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(x, nfft)
    return np.fft.irfft(f * np.conj(f), nfft)[:n].real / n


def effective_sample_size(chains):
    """ESS per dimension of ``(n_chains, n_steps, d)``."""
    x = np.asarray(chains, np.float64)
    m, n, d = x.shape
    ess = np.empty(d)
    for j in range(d):
        xa = x[:, :, j]
        acov = np.stack([_autocov_fft(xa[c]) for c in range(m)], 0)
        chain_mean = xa.mean(1)
        mean_var = acov[:, 0].mean() * n / (n - 1.0)
        var_plus = mean_var * (n - 1.0) / n
        if m > 1:
            var_plus += chain_mean.var(ddof=1)
        if var_plus == 0 or not np.isfinite(var_plus):
            ess[j] = 0.0
            continue
        rho = 1.0 - (mean_var - acov.mean(0)) / var_plus
        rho[0] = 1.0
        max_t = n - 2 if n % 2 == 0 else n - 1
        pair = rho[: max_t + 1][0:max_t:2] + rho[: max_t + 1][1:max_t + 1:2]
        k = np.argmax(pair < 0) if np.any(pair < 0) else len(pair)
        pair = np.minimum.accumulate(pair[:k]) if k > 0 else pair[:0]
        tau = -1.0 + 2.0 * pair.sum()
        tau = max(tau, 1.0 / math.log10(max(n, 10)))
        ess[j] = m * n / tau
    return ess
