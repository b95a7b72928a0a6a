"""Systematic resampling, single device.

Counterpart of the single-device half of ``auxpm_tpu/parallel/resampling.py``
(``systematic_resample_indices``): one uniform, n evenly spaced positions
through the weight CDF.  The lowest-variance standard scheme, and a
deterministic function of (weights, one uniform).  The distributed half,
which places each shard's local CDF inside the global one, is ROADMAP.md
queue 1, item 7c.
"""

from __future__ import annotations

import torch


def systematic_resample_indices(log_w, u01):
    """``log_w (n,)`` unnormalised log-weights and one uniform ``u01`` in
    [0, 1) -> ``(n,)`` int64 source indices, non-decreasing."""
    n = log_w.shape[0]
    w = torch.exp(log_w - log_w.max())
    cdf = torch.cumsum(w, 0)
    pos = (u01 + torch.arange(n, dtype=log_w.dtype, device=log_w.device)) \
        / n * cdf[-1]
    return torch.clamp(torch.searchsorted(cdf, pos), 0, n - 1)
