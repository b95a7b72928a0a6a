"""Analysis figures: traces, marginal densities, autocorrelation.

Counterpart of ``auxpm_tpu/utils/plots.py``.  Everything here is host-side
NumPy and matplotlib over recorded chains; nothing touches the device.
matplotlib is imported lazily, with the Agg backend, so runs without
``--plots`` never need it; where it is missing a figure raises an
``ImportError`` that names it.

``chains`` arrays follow the recorder convention: shape (n_chains, n_steps,
d) for theta records, (n_chains, n_steps) for scalars.
"""

from __future__ import annotations

import numpy as np

from auxpm_tpu_torch.utils.diagnostics import effective_sample_size


def _mpl():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "figures (--plots) need matplotlib, which is not installed; "
            "install matplotlib or run without --plots") from e

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _as_chains(chains):
    chains = np.asarray(chains)
    return chains[:, :, None] if chains.ndim == 2 else chains


def _save(plt, fig, path):
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path
    return fig


def autocorrelation(x, max_lag=None):
    """Normalised autocorrelation of a 1-D chain via FFT, lags 0..max_lag."""
    x = np.asarray(x, np.float64)
    n = len(x)
    max_lag = max_lag or min(n - 1, 200)
    xc = x - x.mean()
    nfft = 1 << (2 * n - 1).bit_length()
    ac = np.fft.irfft(np.abs(np.fft.rfft(xc, nfft)) ** 2)[: max_lag + 1]
    return ac / ac[0]


def trace_plot(chains, names=None, max_chains=8, path=None):
    """Trace plot per dimension, one line per chain."""
    plt = _mpl()
    chains = _as_chains(chains)
    c, _, d = chains.shape
    names = names or [f"theta[{i}]" for i in range(d)]
    fig, axes = plt.subplots(d, 1, figsize=(9, 2.2 * d), squeeze=False,
                             sharex=True)
    for i in range(d):
        ax = axes[i, 0]
        for j in range(min(c, max_chains)):
            ax.plot(chains[j, :, i], lw=0.6, alpha=0.8)
        ax.set_ylabel(names[i])
    axes[-1, 0].set_xlabel("iteration")
    fig.tight_layout()
    return _save(plt, fig, path)


def density_plot(chains, names=None, bins=80, path=None, truth=None):
    """Pooled marginal histogram per dimension (+ optional truth lines)."""
    plt = _mpl()
    chains = _as_chains(chains)
    d = chains.shape[-1]
    names = names or [f"theta[{i}]" for i in range(d)]
    fig, axes = plt.subplots(1, d, figsize=(3.2 * d, 2.8), squeeze=False)
    flat = chains.reshape(-1, d)
    for i in range(d):
        ax = axes[0, i]
        ax.hist(flat[:, i], bins=bins, density=True, alpha=0.75)
        if truth is not None:
            ax.axvline(truth[i], color="k", ls="--", lw=1)
        ax.set_xlabel(names[i])
    fig.tight_layout()
    return _save(plt, fig, path)


def autocorr_plot(chains, names=None, max_lag=100, path=None):
    """Chain-averaged autocorrelation per dimension, with the pooled ESS in
    the legend."""
    plt = _mpl()
    chains = _as_chains(chains)
    c, _, d = chains.shape
    names = names or [f"theta[{i}]" for i in range(d)]
    ess = np.atleast_1d(effective_sample_size(chains))
    fig, ax = plt.subplots(figsize=(6, 3.2))
    lags = np.arange(max_lag + 1)
    for i in range(d):
        ac = np.mean(
            [autocorrelation(chains[j, :, i], max_lag) for j in range(c)],
            axis=0)
        ax.plot(lags[: len(ac)], ac, label=f"{names[i]} (ESS={ess[i]:.0f})")
    ax.axhline(0.0, color="k", lw=0.5)
    ax.set_xlabel("lag")
    ax.set_ylabel("autocorrelation")
    ax.legend()
    fig.tight_layout()
    return _save(plt, fig, path)


def experiment_report(chains, out_prefix, names=None, truth=None):
    """Write the standard three figures; returns the written paths."""
    return [
        trace_plot(chains, names, path=f"{out_prefix}_trace.png"),
        density_plot(chains, names, path=f"{out_prefix}_density.png",
                     truth=truth),
        autocorr_plot(chains, names, path=f"{out_prefix}_autocorr.png"),
    ]
