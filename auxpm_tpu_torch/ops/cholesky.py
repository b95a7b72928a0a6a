"""Cholesky factorisation + whitening for the GP estimator path.

Counterpart of ``auxpm_tpu/ops/cholesky.py``.  A batch of Gram matrices
``(B, n, n)`` on the card with ``n % 128 == 0`` is factored by the blocked
loop over the hand-written panel kernel (``ops/chol_hopper.py``), as the
reference routes a batched call to its panel kernel on the TPU; a CPU tensor
goes to ``torch.linalg.cholesky_ex``.  The reverse-mode rule of the reference
is not ported yet.

Host synchronisations: ``robust_cholesky`` reads one flag per retry test
(``bad.any()``), i.e. one per call in the usual no-failure case.  A later
change can fold the test into the device code.
"""

from __future__ import annotations

import torch

from auxpm_tpu_torch.ops import chol_hopper


def _chol_dispatch(a):
    """Batched lower Cholesky; a matrix that fails has a non-finite diagonal."""
    if a.device.type == "cpu":
        l, info = torch.linalg.cholesky_ex(a)
        return torch.where((info > 0)[..., None, None],
                           torch.full_like(l, float("nan")), l)
    n = a.shape[-1]
    if n % chol_hopper.BLK:
        raise ValueError(
            f"n={n}: the CUDA factorisation needs n % {chol_hopper.BLK} == 0 "
            "(build the target with pad_to_tiles=True)"
        )
    batch = a.shape[:-2]
    l = chol_hopper.cholesky_batched3(a.reshape(-1, n, n))
    return l.reshape(*batch, n, n)


def _robust_cholesky_impl(gram, jitter0=0.0, growth=10.0, max_tries=3):
    """Returns ``(L, extra)`` with ``extra`` the per-matrix diagonal boost."""
    n = gram.shape[-1]
    eye = torch.eye(n, dtype=gram.dtype, device=gram.device)
    # base is PER MATRIX: a sick matrix never inflates the jitter of its
    # healthy batch-mates
    mean_diag = torch.diagonal(gram, dim1=-2, dim2=-1).mean(-1)
    base = torch.full_like(mean_diag, jitter0) if jitter0 > 0 else 1e-6 * mean_diag

    def bad(l):
        return ~torch.isfinite(torch.diagonal(l, dim1=-2, dim2=-1)).all(-1)

    l = _chol_dispatch(gram)
    extra = torch.zeros_like(base)
    for _ in range(max_tries):
        failed = bad(l)
        if not bool(failed.any()):  # host sync, see the module note
            break
        # first escalation applies the base itself, then grows
        extra = torch.where(
            failed, torch.where(extra > 0, extra * growth, base), extra
        )
        l = _chol_dispatch(gram + extra[..., None, None] * eye)
    return l, extra


def robust_cholesky(gram, jitter0=0.0, growth=10.0, max_tries=3):
    """Cholesky with automatic per-matrix diagonal-jitter escalation.

    A factorisation that fails (non-finite diagonal of L) is retried with the
    diagonal boosted by ``base * growth^k`` (``base = jitter0`` if > 0 else
    ``1e-6 * mean diag``), up to ``max_tries`` escalations.  Deterministic in
    the input matrix, so estimators built on it stay valid pseudo-marginal
    estimators.  Usual case: zero escalations, one factorisation."""
    return _robust_cholesky_impl(gram, jitter0, growth, max_tries)[0]


def whiten(chol, u):
    """Map whitened draws u (..., S, n) to latent draws f = u @ C^T."""
    return u @ chol.mT


def chol_logdet(chol):
    """log |K| from its Cholesky factor (2 * sum log diag)."""
    return 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
