"""Squared-exponential Gram matrices (isotropic).

Counterpart of ``auxpm_tpu/ops/gram.py``.  The isotropic Gram is an
elementwise transform of squared distances cached once per dataset.  The ARD
Gram (a TPU kernel in the reference) is not ported yet.

    K[i,j] = exp(2 log_sigma) exp(-0.5 sqdist[i,j] / exp(2 log_ell)) + jitter I
"""

from __future__ import annotations

import torch


def pairwise_sqdist(x):
    """(n, d) -> (n, n) squared Euclidean distances, cross term in exact f32
    (``ops/__init__`` keeps TF32 off: the expansion cancels catastrophically
    for nearby points)."""
    sq = (x * x).sum(-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    return torch.clamp(d2, min=0.0)


def se_gram_iso(sqdist, log_ell, log_sigma, jitter=1e-6):
    """Isotropic SE Gram from cached squared distances.

    ``sqdist (n, n)``; ``log_ell`` / ``log_sigma`` scalars or ``(B,)`` tensors
    (a batch of chains gives ``(B, n, n)``)."""
    log_ell = torch.as_tensor(log_ell, dtype=sqdist.dtype, device=sqdist.device)
    log_sigma = torch.as_tensor(log_sigma, dtype=sqdist.dtype,
                                device=sqdist.device)
    inv2ell2 = 0.5 * torch.exp(-2.0 * log_ell)
    k = torch.exp(2.0 * log_sigma[..., None, None]
                  - sqdist * inv2ell2[..., None, None])
    n = sqdist.shape[-1]
    return k + jitter * torch.eye(n, dtype=k.dtype, device=k.device)
