"""Bernoulli classification likelihoods on latent GP values.

Counterpart of ``auxpm_tpu/models/likelihoods.py``: the value functions and
the gradient / negative-Hessian helpers of the Laplace proposal
(``models/laplace.py``).  Labels are +-1; a ``mask`` lets padded datasets
contribute zero.  The value functions are elementwise-stable and spelled
exactly as the CUDA probe body spells them (``csrc/probe.cuh``), so the
estimator is one fixed function of (theta, u) on either path.
"""

from __future__ import annotations

import math

import torch

_INV_SQRT2 = 0.7071067811865476

# Chebyshev-fitted coefficients of the single-formula erfc approximation
# erfc(x) = t * exp(-x^2 + P(t)),  t = 1/(1 + x/2),  x >= 0, relative error
# < 1.2e-7 uniformly (Numerical Recipes 6.2 "erfcc").
_ERFC_P = (
    -1.26551223, 1.00002368, 0.37409196, 0.09678418, -0.18628806,
    0.27886807, -1.13520398, 1.48851587, -0.82215223, 0.17087277,
)


def _log_erfc_pos(x):
    """log erfc(x) for x >= 0, in log form so it never underflows."""
    t = 1.0 / (1.0 + 0.5 * x)
    p = torch.full_like(x, _ERFC_P[-1])
    for c in _ERFC_P[-2::-1]:
        p = p * t + c
    return torch.log(t) - x * x + p


def log_ndtr(z):
    """log Phi(z), stable for all z, relative error ~1.2e-7."""
    x = torch.abs(z) * _INV_SQRT2
    log_ec = _log_erfc_pos(x)
    neg = math.log(0.5) + log_ec
    pos = torch.log1p(-0.5 * torch.exp(log_ec))
    return torch.where(z < 0, neg, pos)


def log_sigmoid(z):
    """log sigma(z) = -softplus(-z), written out as max + log1p(exp(-|z|))."""
    return -(torch.clamp(-z, min=0.0) + torch.log1p(torch.exp(-torch.abs(z))))


def logistic_log_lik(f, y, mask=None):
    """Sum_i log sigma(y_i f_i) along the last axis."""
    ll = log_sigmoid(y * f)
    if mask is not None:
        ll = ll * mask
    return ll.sum(-1)


def probit_log_lik(f, y, mask=None):
    """Sum_i log Phi(y_i f_i) along the last axis (log-form erfc, stable)."""
    ll = log_ndtr(y * f)
    if mask is not None:
        ll = ll * mask
    return ll.sum(-1)


LIKELIHOODS = {"logistic": logistic_log_lik, "probit": probit_log_lik}


# Gradient and NEGATIVE Hessian diagonal of log p(y|f) w.r.t. f, for the
# Newton iteration of the Laplace proposal; both elementwise because the
# likelihood factorises over points.  Closed forms (stable):
#   logistic: g = y sigma(-y f);           w = sigma(f) sigma(-f)
#   probit:   r = phi(z)/Phi(z), z = y f;  g = y r;  w = r (r + z)
# with the probit ratio computed from the stable log Phi, which stays finite
# in the far-left tail where phi and Phi both underflow.  Shapes follow
# ``f`` (any leading batch axes); mask 0 gives g = w = 0.

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def logistic_grad_hess(f, y, mask=None):
    """(g, w) for the logistic likelihood."""
    g = y * torch.sigmoid(-y * f)
    w = torch.sigmoid(f) * torch.sigmoid(-f)
    if mask is not None:
        g, w = g * mask, w * mask
    return g, w


def probit_grad_hess(f, y, mask=None):
    """(g, w) for the probit likelihood via the stable phi/Phi ratio."""
    z = y * f
    r = torch.exp(-0.5 * z * z - _HALF_LOG_2PI - log_ndtr(z))
    g = y * r
    w = r * (r + z)
    if mask is not None:
        g, w = g * mask, w * mask
    return g, torch.clamp(w, min=0.0)


LIKELIHOOD_GRAD_HESS = {
    "logistic": logistic_grad_hess,
    "probit": probit_grad_hess,
}
