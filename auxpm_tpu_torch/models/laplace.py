"""Laplace approximate-posterior importance proposal for the GP estimator.

Counterpart of ``auxpm_tpu/models/laplace.py``, batched over a leading
chains axis.  The proposal is

    q(f) = N(f̂, (K⁻¹ + W)⁻¹),
    f̂ = argmax_f [log p(y|f) - ½ fᵀK⁻¹f],   W = -∇∇_f log p(y|f̂) (diagonal)

found by the fixed-iteration Newton loop of Rasmussen & Williams, *GPML*,
Algorithm 3.1: every solve goes through B = I + W^½ K W^½ (B ≥ I, well
conditioned), never through K⁻¹:

    b = W f + ∇ log p(y|f)
    a = b - W^½ B⁻¹ W^½ K b          (B⁻¹ via the Cholesky factor of B)
    f ← K a

and Σ_q = K - K W^½ B⁻¹ W^½ K (Woodbury, B at the mode), symmetrised and
floored on the diagonal before its factorisation.  The importance weights are

    log ŵ_s = log p(y|f_s) + log N(f_s; 0, K) - log N(f_s; f̂, Σ_q),
    f_s = f̂ + C_q u_s,

the q-density free in whitened coordinates and the prior density one
triangular-solve pair off the factor of K.  Padded rows carry mask 0, so
g = W = 0 there: f̂ = 0 and Σ_q = K on the pad block, and the padded
coordinates' two densities cancel in log ŵ.

Reverse mode: every step above is differentiable (the unrolled Newton loop,
``RobustCholesky``, ``torch.cholesky_solve``, the log-determinants), so the
GP target's ``log_lik_est`` has a gradient in theta for HMC and NUTS.  W^½
takes its limit 0 as derivative at w = 0 (``_sqrt_w``), which keeps that
gradient finite on a padded target; the reference's ``jnp.sqrt`` gives NaN
there.

Every factorisation goes through ``ops/cholesky.robust_cholesky`` (on the
card: the blocked loop over the v3 panel kernel); the solves against a factor
are ``torch.cholesky_solve``, as the reference solves outside any kernel.  A
``prepare`` of the GP target is ``1 + newton_iters + 2`` batched
factorisations (K, one B per Newton iteration, B at the mode, Σ_q), each
reading one host flag (``robust_cholesky``'s retry test).
"""

from __future__ import annotations

import torch

from auxpm_tpu_torch.models.likelihoods import LIKELIHOOD_GRAD_HESS
from auxpm_tpu_torch.ops.cholesky import robust_cholesky


def _sqrt_w(w):
    """W^½ with a finite derivative where w = 0.  The forward is
    ``torch.sqrt(w)`` bit for bit (W >= 0); the derivative there is 0, the
    limit of the exact gradient, where ``sqrt``'s is infinite: a padded row
    (mask 0, so w = 0) gets an exactly 0 cotangent, and 0 x inf would make
    the whole gradient NaN.  The same guard covers a real row whose w
    underflows to 0 in the probit tail."""
    pos = w > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, w, 1.0)), w * 0.0)


def _matvec(k, x):
    """``k (..., n, n) @ x (..., n) -> (..., n)``."""
    return (k @ x[..., None])[..., 0]


def laplace_fit(k, y, mask, likelihood="logistic", newton_iters=12,
                chol_jitter=1e-6):
    """Fit N(f̂, Σ_q) to p(f | y) ∝ p(y|f) N(f; 0, K) for a batch of K.

    Args:
      k: (B, n, n) GP prior covariances (already including their nugget).
      y: (n,) labels in {-1, +1} (padded entries arbitrary).
      mask: (n,) 1.0 for real points, 0.0 for padding.
      likelihood: key into ``LIKELIHOOD_GRAD_HESS``.
      newton_iters: fixed Newton iteration count.
      chol_jitter: relative nugget (x mean diag K, per matrix) added to Σ_q
        before its factorisation (SPD in exact arithmetic; f32 round-off
        needs a floor).

    Returns ``(f_hat (B, n), chol_q (B, n, n), half_logdet_q (B,))``.
    """
    grad_hess = LIKELIHOOD_GRAD_HESS[likelihood]
    n = k.shape[-1]
    eye = torch.eye(n, dtype=k.dtype, device=k.device)

    def b_factor(w):
        sw = _sqrt_w(w)
        b_mat = eye + sw[..., :, None] * k * sw[..., None, :]
        return sw, robust_cholesky(b_mat)

    f = torch.zeros(k.shape[:-1], dtype=k.dtype, device=k.device)
    for _ in range(newton_iters):
        g, w = grad_hess(f, y, mask)
        sw, l_b = b_factor(w)
        b = w * f + g
        # a = b - W^½ B⁻¹ (W^½ K b)
        rhs = sw * _matvec(k, b)
        sol = torch.cholesky_solve(rhs[..., None], l_b)[..., 0]
        f = _matvec(k, b - sw * sol)

    _, w = grad_hess(f, y, mask)
    sw, l_b = b_factor(w)
    swk = sw[..., :, None] * k  # W^½ K
    sigma_q = k - swk.mT @ torch.cholesky_solve(swk, l_b)
    sigma_q = 0.5 * (sigma_q + sigma_q.mT)  # symmetrise f32 round-off
    diag_floor = chol_jitter * torch.diagonal(k, dim1=-2, dim2=-1).mean(-1)
    chol_q = robust_cholesky(sigma_q + diag_floor[..., None, None] * eye)
    return f, chol_q, gaussian_half_logdet(chol_q)


def gaussian_half_logdet(chol):
    """½ log |Σ| from its lower factor, over the leading axes."""
    return torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)


def laplace_log_weight_terms(chol_k, f_hat, chol_q, half_logdet_q, u):
    """Non-likelihood part of log ŵ for Laplace-proposal importance samples.

    ``chol_k (B, n, n)``, ``f_hat (B, n)``, ``chol_q (B, n, n)``,
    ``half_logdet_q (B,)``, ``u (B, S, n)``.  Returns ``(f (B, S, n), extra
    (B, S))`` with f_s = f̂ + C_q u_s and

      extra_s = log N(f_s; 0, K) - log N(f_s; f̂, Σ_q)
              = -½ f_sᵀ K⁻¹ f_s - ½log|K| + ½‖u_s‖² + ½log|Σ_q|

    (the (2π)^{n/2} constants cancel between the two densities)."""
    f = f_hat[..., None, :] + u @ chol_q.mT
    alpha = torch.cholesky_solve(f.mT, chol_k).mT  # K⁻¹ f_s
    quad_k = (f * alpha).sum(-1)
    quad_q = (u * u).sum(-1)
    extra = (-0.5 * quad_k - gaussian_half_logdet(chol_k)[..., None]
             + 0.5 * quad_q + half_logdet_q[..., None])
    return f, extra
