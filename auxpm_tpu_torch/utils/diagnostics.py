"""Post-hoc chain diagnostics: ESS and R-hat (NumPy only).

The port's own copy of ``auxpm_tpu/utils/diagnostics.py``.  Host-side NumPy
on stored chains, the standard conservative estimators:

- ESS via FFT autocovariance + Geyer initial-monotone-sequence truncation
  (Geyer 1992; the estimator used by Stan/ArviZ).
- Split-R-hat (Gelman et al., BDA3) across chains.
"""

from __future__ import annotations

import numpy as np


def _autocov_fft(x):
    """Autocovariance of a 1-D array via FFT, biased (divide by n)."""
    n = x.shape[0]
    x = x - x.mean()
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(x, nfft)
    acov = np.fft.irfft(f * np.conj(f), nfft)[:n].real / n
    return acov


def effective_sample_size(chains):
    """ESS per dimension from a (n_chains, n_steps[, d]) array.

    Multi-chain rule (Stan): combine within-chain autocovariances and the
    between-chain variance, then truncate the autocorrelation sum by Geyer's
    initial monotone positive sequence.

    Returns an array of shape (d,) (or a scalar if input was 2-D).
    """
    x = np.asarray(chains, np.float64)
    scalar_dim = x.ndim == 2
    if scalar_dim:
        x = x[..., None]
    m, n, d = x.shape
    ess = np.empty(d)
    for j in range(d):
        xa = x[:, :, j]
        acov = np.stack([_autocov_fft(xa[c]) for c in range(m)], 0)  # (m, n)
        chain_mean = xa.mean(1)
        mean_var = acov[:, 0].mean() * n / (n - 1.0)
        var_plus = mean_var * (n - 1.0) / n
        if m > 1:
            var_plus += chain_mean.var(ddof=1)
        if var_plus == 0 or not np.isfinite(var_plus):
            ess[j] = 0.0
            continue
        # rho_t = 1 - (W - mean autocov_t) / var_plus
        rho = 1.0 - (mean_var - acov.mean(0)) / var_plus
        rho[0] = 1.0
        # Geyer: sums of adjacent pairs must be positive and non-increasing
        max_t = n - 2 if n % 2 == 0 else n - 1
        pair = rho[: max_t + 1][0 : max_t : 2] + rho[: max_t + 1][1 : max_t + 1 : 2]
        k = np.argmax(pair < 0) if np.any(pair < 0) else len(pair)
        pair = np.minimum.accumulate(pair[:k]) if k > 0 else pair[:0]
        tau = -1.0 + 2.0 * pair.sum()
        tau = max(tau, 1.0 / np.log10(max(n, 10)))  # Stan's lower clamp
        ess[j] = m * n / tau
    return ess[0] if scalar_dim else ess


def potential_scale_reduction(chains):
    """Split-R-hat from a (n_chains, n_steps[, d]) array."""
    x = np.asarray(chains, np.float64)
    scalar_dim = x.ndim == 2
    if scalar_dim:
        x = x[..., None]
    m, n, d = x.shape
    half = n // 2
    x = np.concatenate([x[:, :half], x[:, half : 2 * half]], axis=0)  # split
    m2, n2, _ = x.shape
    chain_mean = x.mean(1)  # (m2, d)
    chain_var = x.var(1, ddof=1)  # (m2, d)
    w = chain_var.mean(0)
    b = n2 * chain_mean.var(0, ddof=1)
    var_plus = (n2 - 1.0) / n2 * w + b / n2
    with np.errstate(divide="ignore", invalid="ignore"):
        rhat = np.sqrt(var_plus / w)
    out = rhat
    return float(out[0]) if scalar_dim else out
