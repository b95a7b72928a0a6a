"""2-D Gaussian toy target with a noisy-but-unbiased IS likelihood estimator.

Counterpart of ``auxpm_tpu/models/gaussian_toy.py``, batched over a leading
chains axis.  The construction gives a closed-form posterior, so estimator
noise against mixing can be studied exactly:

  prior:       theta ~ N(0, prior_var I_2)
  likelihood:  p(y | theta) = N(y; theta, Sigma_y)   (y fixed data)
  estimator:   decompose Sigma_y = sigma_n^2 I + A A^T and estimate the
               convolution integral
                 p(y|theta) = ∫ N(y; z, sigma_n^2 I) N(z; theta, A A^T) dz
               by importance sampling with S draws z_s = theta + A u_s,
               u_s ~ N(0, I_2):
                 log L̂(theta, u) = logsumexp_s log N(y; theta + A u_s,
                                                      sigma_n^2 I) - log S.
  E[exp(log L̂)] = p(y|theta) exactly, for every S: unbiased in L, not in
  log L (fine for pseudo-marginal MCMC; Andrieu & Roberts 2009).

``noise_frac`` in (0, 1) sets sigma_n^2 = noise_frac * min_eig(Sigma_y);
smaller => noisier estimator => stickier PM-MH, which is the pathology the
auxiliary slice method fixes (Murray & Graham 2016, section 2).

The posterior is conjugate:  Lambda = I/prior_var + Sigma_y^{-1},
mean = Lambda^{-1} Sigma_y^{-1} y, cov = Lambda^{-1}.

The target has no per-coordinate probe factories, no sweep and no carried
factor: the samplers take their generic paths on it.  It has no kernel
either; every callable is plain PyTorch on the target's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from auxpm_tpu_torch._device import resolve_device
from auxpm_tpu_torch.core import prng
from auxpm_tpu_torch.models.base import Target
from auxpm_tpu_torch.ops.logsumexp import logsumexp

_LOG_2PI = float(np.log(2.0 * np.pi))


def make_gaussian_toy(
    n_importance: int = 16,
    noise_frac: float = 0.3,
    prior_var: float = 4.0,
    y=(1.0, -0.5),
    sigma_y=((1.0, 0.4), (0.4, 0.8)),
    device="cuda",
) -> Target:
    """``y`` and ``sigma_y`` may be NumPy arrays (the reference's constants
    carried across); ``device="cuda"`` (default) raises without a GPU."""
    device = resolve_device(device)
    dtype = torch.float32
    y64 = np.asarray(np.asarray(y, np.float32), np.float64)
    sy = np.asarray(np.asarray(sigma_y, np.float32), np.float64)
    d = y64.shape[0]
    y_dev = torch.as_tensor(y64, dtype=dtype, device=device)

    sigma_n2 = float(noise_frac * np.linalg.eigvalsh(sy).min())
    # A A^T = Sigma_y - sigma_n^2 I  (positive definite by construction)
    a_mat = torch.as_tensor(
        np.linalg.cholesky(sy - sigma_n2 * np.eye(d)), dtype=dtype,
        device=device,
    )

    log_norm = -0.5 * d * (_LOG_2PI + float(np.log(sigma_n2)))
    log_prior_norm = 0.5 * d * (_LOG_2PI + float(np.log(np.float32(prior_var))))
    log_s = math.log(float(n_importance))

    def log_prior(theta):
        return -0.5 * (theta * theta).sum(-1) / prior_var - log_prior_norm

    def log_weights_u(theta, u):
        # z_s = theta + A u_s ; w_s = N(y; z_s, sigma_n^2 I)
        z = theta[:, None, :] + u @ a_mat.T  # (B, S, d)
        sq = ((y_dev - z) ** 2).sum(-1)  # (B, S)
        return log_norm - 0.5 * sq / sigma_n2

    def log_lik_est(theta, u):
        return logsumexp(log_weights_u(theta, u)) - log_s

    # closed-form posterior moments (float64 on the host for accuracy)
    lam = np.eye(d) / prior_var + np.linalg.inv(sy)
    cov = np.linalg.inv(lam)
    mean = cov @ np.linalg.solve(sy, y64)
    mean_dev = torch.as_tensor(mean, dtype=dtype, device=device)
    lam_dev = torch.as_tensor(lam, dtype=dtype, device=device)

    def exact_log_post(theta):
        r = theta - mean_dev
        return -0.5 * ((r @ lam_dev) * r).sum(-1)

    return Target(
        d=d,
        u_shape=(n_importance, d),
        log_prior=log_prior,
        log_lik_est=log_lik_est,
        theta_init=torch.zeros((d,), dtype=dtype, device=device),
        device=device,
        name="gaussian_toy",
        exact_log_post=exact_log_post,
        posterior_mean=mean_dev,
        posterior_cov=torch.as_tensor(cov, dtype=dtype, device=device),
        sample_prior_key=lambda keys: torch.sqrt(
            torch.tensor(prior_var, dtype=dtype, device=keys.device))
        * prng.normal(keys, (d,)),
        prepare=lambda theta: theta,  # no theta-only precomputation to cache
        log_lik_est_u=lambda theta, u: log_lik_est(theta, u),
        log_weights_u=log_weights_u,
    )
