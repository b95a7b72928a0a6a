"""Cholesky factorisation + whitening for the GP estimator path.

Counterpart of ``auxpm_tpu/ops/cholesky.py``.  A batch of Gram matrices
``(B, n, n)`` on the card is factored by the blocked loop over the
hand-written panel kernel (``ops/chol_hopper.py``), as the reference routes
a batched call to its panel kernel on the TPU; off a multiple of 128 the
batch is padded with the identity first and the factor sliced back (the
reference takes XLA's Cholesky there).  A CPU tensor goes to
``torch.linalg.cholesky_ex``.

Reverse mode (the reference's ``custom_vjp``): ``robust_cholesky`` is the
``torch.autograd.Function`` ``RobustCholesky`` on both devices.  Its forward
is the factorisation above; its backward is plain PyTorch, the standard
Cholesky pullback at the SHIFTED matrix ``gram + extra I`` computed from the
saved forward factor (never re-factored: on the card a library factor of a
near-singular Gram can differ from the panel's by ~5e-3, and the gradient
must belong to the factor the forward returned):

    S = L^-T Phi(L^T Lbar) L^-1,   Gbar = (S + S^T) / 2

with Phi the lower triangle with its diagonal halved and the two products by
L^-1 as triangular solves.  The symmetrisation is the one
``jnp.linalg.cholesky`` applies to its input, so the gradient with respect to
the Gram's entries is the reference's for any cotangent.  The escalated
jitter gets no gradient (it is piecewise constant in the Gram).

Host synchronisations: ``robust_cholesky`` reads one flag per retry test
(``bad.any()``), i.e. one per call in the usual no-failure case; ``host_syncs``
counts them.  A later change can fold the test into the device code.
"""

from __future__ import annotations

import torch

from auxpm_tpu_torch.ops import chol_hopper

host_syncs = 0  # flags read by robust_cholesky's retry test


def _chol_dispatch(a):
    """Batched lower Cholesky; a matrix that fails has a non-finite diagonal.

    On the card any n (``chol_hopper.cholesky_padded3``): off a multiple of
    128 the batch is padded with the identity to the next one (chol([[K, 0],
    [0, I]]) = [[chol(K), 0], [0, I]], exact), factored by the v3 panel route
    and sliced back to n.  The reference takes XLA's Cholesky there; the
    port keeps its own kernel.  ``robust_cholesky`` adds each matrix's
    jitter before this call, so the pad rows never change it."""
    if a.device.type == "cpu":
        l, info = torch.linalg.cholesky_ex(a)
        return torch.where((info > 0)[..., None, None],
                           torch.full_like(l, float("nan")), l)
    return chol_hopper.cholesky_padded3(a)


def _robust_cholesky_impl(gram, jitter0=0.0, growth=10.0, max_tries=3):
    """Returns ``(L, extra)`` with ``extra`` the per-matrix diagonal boost."""
    global host_syncs
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
        host_syncs += 1
        if not bool(failed.any()):  # host sync, see the module note
            break
        # first escalation applies the base itself, then grows
        extra = torch.where(
            failed, torch.where(extra > 0, extra * growth, base), extra
        )
        l = _chol_dispatch(gram + extra[..., None, None] * eye)
    return l, extra


def cholesky_pullback(l, lbar):
    """Gradient with respect to the (symmetrised) matrix that ``l`` factors,
    for the cotangent ``lbar`` of ``l``: ``(S + S^T) / 2`` with ``S = L^-T
    Phi(L^T Lbar) L^-1``; two batched triangular solves."""
    p = torch.tril(l.mT @ lbar)
    p = p - 0.5 * torch.diag_embed(torch.diagonal(p, dim1=-2, dim2=-1))
    s = torch.linalg.solve_triangular(l.mT, p, upper=True)     # L^-T P
    s = torch.linalg.solve_triangular(l, s, upper=False, left=False)  # . L^-1
    return 0.5 * (s + s.mT)


class RobustCholesky(torch.autograd.Function):
    """``robust_cholesky`` with the reference's reverse-mode rule (see the
    module note); forward on the panel route (card) or ``cholesky_ex``
    (CPU), backward plain PyTorch from the saved factor."""

    @staticmethod
    def forward(ctx, gram, jitter0, growth, max_tries):
        l, extra = _robust_cholesky_impl(gram, jitter0, growth, max_tries)
        ctx.save_for_backward(l, extra)
        ctx.mark_non_differentiable(extra)
        return l, extra

    @staticmethod
    def backward(ctx, lbar, _extra_bar):
        l, _ = ctx.saved_tensors
        return cholesky_pullback(l, lbar), None, None, None


def robust_cholesky(gram, jitter0=0.0, growth=10.0, max_tries=3):
    """Cholesky with automatic per-matrix diagonal-jitter escalation.

    A factorisation that fails (non-finite diagonal of L) is retried with the
    diagonal boosted by ``base * growth^k`` (``base = jitter0`` if > 0 else
    ``1e-6 * mean diag``), up to ``max_tries`` escalations.  Deterministic in
    the input matrix, so estimators built on it stay valid pseudo-marginal
    estimators.  Usual case: zero escalations, one factorisation.
    Differentiable in ``gram`` (``RobustCholesky``)."""
    return RobustCholesky.apply(gram, jitter0, growth, max_tries)[0]


def chol_with_jitter(gram, jitter=0.0):
    """Lower-triangular Cholesky factor of ``gram + jitter I`` through
    ``torch.linalg.cholesky``, as the reference's helper goes through
    ``jnp.linalg.cholesky``; the caller chooses the jitter (the Gram
    functions already add a fixed diagonal one).  A plain helper: the
    samplers factor through ``robust_cholesky``."""
    if jitter:
        gram = gram + jitter * torch.eye(gram.shape[-1], dtype=gram.dtype,
                                         device=gram.device)
    return torch.linalg.cholesky(gram)


def whiten(chol, u):
    """Map whitened draws u (..., S, n) to latent draws f = u @ C^T."""
    return u @ chol.mT


def chol_logdet(chol):
    """log |K| from its Cholesky factor (2 * sum log diag)."""
    return 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
