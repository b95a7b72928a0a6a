"""Windowed global adaptation of sampler hyperparameters.

Counterpart of ``auxpm_tpu/samplers/adaptation.py`` (the slice-width rule and
the warm-up loop; the step-size rules of the MH/HMC/NUTS samplers come with
those samplers).  Slice widths are set to ``width_scale`` x the global
per-coordinate posterior std of the window's samples over ALL chains,
clamped to a sane range.  Warm-up only: params are frozen afterwards, so the
main chain is a fixed valid kernel.
"""

from __future__ import annotations

import torch


def adapt_params(params, recs, infos, width_scale=2.0,
                 width_bounds=(1e-3, 1e3)):
    """One window update; returns a new params dict."""
    new = {k: dict(v) if isinstance(v, dict) else v for k, v in params.items()}
    if any(k.startswith("slice_theta/") for k in infos):
        theta = recs["theta"]
        stds = theta.reshape(-1, theta.shape[-1]).std(dim=0, unbiased=False)
        g = dict(new.get("slice_theta", {}))
        g["widths"] = torch.clamp(width_scale * stds, *width_bounds).to(
            torch.float32)
        new["slice_theta"] = g
    return new


def warmup(run_fn, states, params, n_windows, window_size, step, **adapt_kw):
    """Run ``n_windows`` adaptation windows; returns (states, params, log).

    ``run_fn(transition, states, params, n_steps) -> (states, recs, infos)``
    is the chain runner; ``step`` is the transition."""
    history = []
    for w in range(n_windows):
        states, recs, infos = run_fn(step, states, params, window_size)
        params = adapt_params(params, recs, infos, **adapt_kw)
        history.append(
            {"window": w, **{k: float(v.mean()) for k, v in infos.items()}}
        )
    return states, params, history
