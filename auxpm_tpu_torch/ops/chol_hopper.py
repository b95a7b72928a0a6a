"""Batched Cholesky through a 128 x 128 panel kernel.

Counterpart of ``auxpm_tpu/ops/chol_pallas.py`` v3 (``chol_panel_batched3`` +
the blocked right-looking loop ``cholesky_batched3``):

    for each 128-panel j:
        L[j,j], inv(L[j,j])^T  <- panel kernel (csrc/chol_panel.cu)
        L[i,j]   = A[i,j] @ inv(L[j,j])^T        (torch.bmm, exact f32)
        A[tr,tr] -= L[tr,j] @ L[tr,j]^T          (torch.bmm, exact f32)

The panel solve and the trailing update are plain matrix products outside the
kernel, as they are in the reference's blocked loop.  A failed factorisation shows
as NaN on L's diagonal (``ops/cholesky.robust_cholesky`` escalates on it).
Requires n % 128 == 0.
"""

from __future__ import annotations

import torch

from auxpm_tpu_torch.ops import _build

BLK = 128

launches = 0  # kernel launches made by this module's wrapper


def _ref_chol_panel(a):
    """Plain panel function: ``(B,128,128) -> (L lower, inv(L)^T upper)``;
    a tile that is not positive definite comes back as NaN."""
    l, info = torch.linalg.cholesky_ex(a)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device).expand_as(a)
    linv = torch.linalg.solve_triangular(l, eye, upper=False)
    bad = (info > 0)[:, None, None]
    nan = torch.full_like(l, float("nan"))
    return torch.where(bad, nan, l), torch.where(bad, nan, linv.mT)


def _cuda_chol_panel(a):
    global launches
    if a.dim() != 3 or a.shape[1:] != (BLK, BLK):
        raise ValueError(f"expected (B, {BLK}, {BLK}) tiles, got {tuple(a.shape)}")
    device = _build.require_f32_contiguous(a=a)
    lib = _build.load_library()
    l = torch.empty_like(a)
    xt = torch.empty_like(a)
    with torch.cuda.device(device):
        err = lib.auxpm_chol_panel(
            a.data_ptr(), l.data_ptr(), xt.data_ptr(), a.shape[0],
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch(err, "chol_panel_kernel")
    launches += 1
    return l, xt


def chol_panel_batched3(a):
    """``(B,128,128)`` SPD tiles -> ``(L lower-tri, inv(L)^T upper-tri)``.

    CUDA tensors go to the kernel (or raise); CPU tensors take the plain
    version."""
    if a.device.type == "cpu":
        return _ref_chol_panel(a)
    return _cuda_chol_panel(a)


def cholesky_batched3(a):
    """Blocked batched Cholesky ``(B, n, n) -> L`` (lower), n % 128 == 0."""
    n = a.shape[-1]
    nb = n // BLK
    if a.dim() != 3 or nb * BLK != n:
        raise ValueError(f"expected (B, n, n) with n a multiple of {BLK}, "
                         f"got {tuple(a.shape)}")
    a = a.clone()  # the trailing blocks are updated in place
    out = torch.zeros_like(a)
    for j in range(nb):
        sl = slice(j * BLK, (j + 1) * BLK)
        tr = slice((j + 1) * BLK, n)
        ljj, linv_t = chol_panel_batched3(a[:, sl, sl].contiguous())
        out[:, sl, sl] = ljj
        if j + 1 < nb:
            lij = torch.bmm(a[:, tr, sl], linv_t)
            out[:, tr, sl] = lij
            a[:, tr, tr] -= torch.bmm(lij, lij.mT)
    return out
