"""Exact (non-pseudo-marginal) targets, for validating samplers alone.

Counterpart of ``auxpm_tpu/models/exact.py``.  A target whose
``log_lik_est`` ignores u lets a theta kernel be held to a closed-form
posterior without estimator noise in the way; ``u_shape`` is a dummy (1, 1)
block.
"""

from __future__ import annotations

import numpy as np
import torch

from auxpm_tpu_torch._device import resolve_device
from auxpm_tpu_torch.models.base import Target


def make_mvn_target(mean, cov, device="cuda"):
    """Multivariate-normal target N(mean, cov) (log-prior up to its
    constant, log-likelihood zero) with its exact moments attached;
    ``device="cuda"`` (default) raises without a GPU."""
    device = resolve_device(device)
    dtype = torch.float32
    mean = np.asarray(mean, np.float64)
    cov = np.asarray(cov, np.float64)
    d = mean.shape[0]
    mean_t = torch.as_tensor(mean, dtype=dtype, device=device)
    prec_t = torch.as_tensor(np.linalg.inv(cov), dtype=dtype, device=device)

    def log_prior(theta):
        r = theta - mean_t
        return -0.5 * ((r @ prec_t) * r).sum(-1)

    def log_lik_est(theta, u):
        return torch.zeros(theta.shape[:-1], dtype=dtype, device=device)

    return Target(
        d=d,
        u_shape=(1, 1),
        log_prior=log_prior,
        log_lik_est=log_lik_est,
        theta_init=torch.zeros((d,), dtype=dtype, device=device),
        device=device,
        name="mvn_exact",
        posterior_mean=mean_t,
        posterior_cov=torch.as_tensor(cov, dtype=dtype, device=device),
    )
