"""Batched Cholesky through a 128 x 128 panel kernel: three routes.

Counterpart of ``auxpm_tpu/ops/chol_pallas.py``.  Every route is the blocked
right-looking loop

    for each 128-panel j:
        L[j,j], inverse of L[j,j]  <- panel kernel
        L[i,j]   = A[i,j] @ inv(L[j,j])^T        (torch.bmm, exact f32)
        A[tr,tr] -= L[tr,j] @ L[tr,j]^T          (torch.bmm, exact f32)

and they differ in what the panel kernel writes and in where the inverse
comes from.  The panel kernel is one, ``csrc/chol_panel.cu``, with three
output modes over the same factor code, so the three routes' panels give the
same L bit for bit:

- v3 (``chol_panel_batched3`` + ``cholesky_batched3``): the kernel returns L
  and inv(L)^T.  The route ``ops/cholesky.py`` takes.
- v1 (``chol_panel_batched`` + ``cholesky_batched``, and ``cholesky_fast`` for
  any n and any batch dims by identity padding): the kernel returns L and
  inv(L), v3's inverse stored untransposed.
- v2 (``chol_panel_batched2`` + ``cholesky_batched2``): the kernel returns L
  only; the inverse is ``tri_inv_newton``, matrix products in the blocked
  loop.

The panel solve and the trailing update are plain matrix products outside the
kernels, as they are in the reference's blocked loops; TF32 is off for them
(``torch.backends.cuda.matmul.allow_tf32`` is False by default and these
functions refuse to run with it on).  A failed factorisation shows as NaN on
L's diagonal in all three (``ops/cholesky.robust_cholesky`` escalates on it).
The blocked loops require n % 128 == 0; ``cholesky_fast`` (v1) and
``cholesky_padded3`` (v3) pad with the identity.
"""

from __future__ import annotations

import torch

from auxpm_tpu_torch.ops import _build

BLK = 128

launches = 0     # launches of the v3 panel kernel by its wrapper
launches_v1 = 0  # launches of the v1 panel kernel by its wrapper
launches_v2 = 0  # launches of the v2 panel kernel by its wrapper


def _ref_chol_panel(a):
    """Plain panel function: ``(B,128,128) -> (L lower, inv(L)^T upper)``;
    a tile that is not positive definite comes back as NaN."""
    l, info = torch.linalg.cholesky_ex(a)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device).expand_as(a)
    linv = torch.linalg.solve_triangular(l, eye, upper=False)
    bad = (info > 0)[:, None, None]
    nan = torch.full_like(l, float("nan"))
    return torch.where(bad, nan, l), torch.where(bad, nan, linv.mT)


def _require_tiles(a):
    if a.dim() != 3 or a.shape[1:] != (BLK, BLK):
        raise ValueError(f"expected (B, {BLK}, {BLK}) tiles, got {tuple(a.shape)}")
    return _build.require_f32_contiguous(a=a)


def _cuda_chol_panel(a):
    global launches
    device = _require_tiles(a)
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


def _blocked(a, panel):
    """The blocked right-looking loop over ``panel(tiles) -> (L_jj,
    inv(L_jj)^T)``; ``(B, n, n) -> L`` (lower), n % 128 == 0."""
    n = a.shape[-1]
    nb = n // BLK
    if a.dim() != 3 or nb * BLK != n:
        raise ValueError(f"expected (B, n, n) with n a multiple of {BLK}, "
                         f"got {tuple(a.shape)}; use pad_gram")
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the blocked factorisation needs exact float32 "
                           "products: torch.backends.cuda.matmul.allow_tf32 "
                           "is on")
    a = a.clone()  # the trailing blocks are updated in place
    out = torch.zeros_like(a)
    for j in range(nb):
        sl = slice(j * BLK, (j + 1) * BLK)
        tr = slice((j + 1) * BLK, n)
        ljj, linv_t = panel(a[:, sl, sl].contiguous())
        out[:, sl, sl] = ljj
        if j + 1 < nb:
            lij = torch.bmm(a[:, tr, sl], linv_t)
            out[:, tr, sl] = lij
            a[:, tr, tr] -= torch.bmm(lij, lij.mT)
    return out


def cholesky_batched3(a):
    """Blocked batched Cholesky ``(B, n, n) -> L`` (lower), n % 128 == 0,
    over the v3 panel kernel."""
    return _blocked(a, chol_panel_batched3)


# ---------------------------------------------------------------------------
# v1: L and inv(L) from the kernel
# ---------------------------------------------------------------------------


def _ref_chol_panel_v1(a):
    """Plain v1 panel function: ``(B,128,128) -> (L, inv(L))``, both lower;
    a tile that is not positive definite comes back as NaN."""
    l, xt = _ref_chol_panel(a)
    return l, xt.mT.contiguous()


def _cuda_chol_panel_v1(a):
    global launches_v1
    device = _require_tiles(a)
    lib = _build.load_library()
    l = torch.empty_like(a)
    linv = torch.empty_like(a)
    with torch.cuda.device(device):
        err = lib.auxpm_chol_panel_v1(
            a.data_ptr(), l.data_ptr(), linv.data_ptr(), a.shape[0],
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch(err, "chol_panel_kernel (v1)")
    launches_v1 += 1
    return l, linv


def chol_panel_batched(a):
    """``(B,128,128)`` SPD tiles -> ``(L, inv(L))``, both lower-triangular.

    CUDA tensors go to the kernel (or raise); CPU tensors take the plain
    version."""
    if a.device.type == "cpu":
        return _ref_chol_panel_v1(a)
    return _cuda_chol_panel_v1(a)


def _panel_v1(tiles):
    l, linv = chol_panel_batched(tiles)
    return l, linv.mT


def cholesky_batched(a):
    """Blocked batched Cholesky ``(B, n, n) -> L`` (lower), n % 128 == 0,
    over the v1 panel kernel."""
    return _blocked(a, _panel_v1)


def pad_gram(k, n_pad):
    """Embed ``(B, n, n)`` SPD into ``(B, n_pad, n_pad)`` with identity
    padding: chol([[K,0],[0,I]]) = [[chol(K),0],[0,I]], exact; slice the rows
    back afterwards."""
    n = k.shape[-1]
    if n == n_pad:
        return k
    out = torch.zeros(*k.shape[:-2], n_pad, n_pad, dtype=k.dtype,
                      device=k.device)
    out[..., :n, :n] = k
    idx = torch.arange(n, n_pad, device=k.device)
    out[..., idx, idx] = 1.0
    return out


def _padded(k, route):
    """``route`` (a blocked driver) on ``(..., n, n)`` for any n and any
    batch dims: identity padding to a multiple of 128, the factor sliced
    back (contiguous) to ``(..., n, n)``."""
    n = k.shape[-1]
    n_pad = -(-n // BLK) * BLK
    batch = k.shape[:-2]
    l = route(pad_gram(k.reshape(-1, n, n), n_pad))
    if n_pad != n:
        l = l[:, :n, :n].contiguous()
    return l.reshape(*batch, n, n)


def cholesky_fast(k):
    """Batched Cholesky of ``(..., n, n)`` for any n and any batch dims: the
    v1 blocked route with identity padding to a multiple of 128.  Returns
    ``(..., n, n)``."""
    return _padded(k, cholesky_batched)


def cholesky_padded3(k):
    """The same over the v3 route (``cholesky_batched3``): what
    ``ops/cholesky`` takes on the card for any n."""
    return _padded(k, cholesky_batched3)


# ---------------------------------------------------------------------------
# v2: L only from the kernel, the inverse by Newton iteration outside it
# ---------------------------------------------------------------------------


def _ref_chol_panel_v2(a):
    """Plain v2 panel function: ``(B,128,128) -> L`` (lower); a tile that is
    not positive definite comes back as NaN."""
    l, info = torch.linalg.cholesky_ex(a)
    return torch.where((info > 0)[:, None, None],
                       torch.full_like(l, float("nan")), l)


def _cuda_chol_panel_v2(a):
    global launches_v2
    device = _require_tiles(a)
    lib = _build.load_library()
    l = torch.empty_like(a)
    with torch.cuda.device(device):
        err = lib.auxpm_chol_panel_v2(
            a.data_ptr(), l.data_ptr(), a.shape[0],
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch(err, "chol_panel_kernel (v2)")
    launches_v2 += 1
    return l


def chol_panel_batched2(a):
    """``(B,128,128)`` SPD tiles -> ``L`` (lower-triangular).

    CUDA tensors go to the kernel (or raise); CPU tensors take the plain
    version.  The kernel is v3's factor phase alone: its L is v3's bit for
    bit, pivots scaled by 1 / sqrt as there, not by the reference v2 body's
    rsqrt, so it is held to that body by tolerance only."""
    if a.device.type == "cpu":
        return _ref_chol_panel_v2(a)
    return _cuda_chol_panel_v2(a)


def tri_inv_newton(l):
    """Exact inverse of batched lower-triangular ``(B, n, n)`` by Newton
    squaring: X <- X (2I - L X) with X0 = diag(1 / diag(L)).  The error
    I - X L is strictly lower triangular (nilpotent), so ceil(log2 n)
    iterations end exactly (7 for a 128-tile).  All work is ``torch.bmm``."""
    n = l.shape[-1]
    eye = torch.eye(n, dtype=l.dtype, device=l.device)
    x = eye / torch.diagonal(l, dim1=-2, dim2=-1)[..., None, :]
    for _ in range(max(1, (n - 1).bit_length())):
        x = torch.matmul(x, 2.0 * eye - torch.matmul(l, x))
    return x


def _panel_v2(tiles):
    l = chol_panel_batched2(tiles)
    return l, tri_inv_newton(l).mT


def cholesky_batched2(a):
    """Blocked batched Cholesky ``(B, n, n) -> L`` (lower), n % 128 == 0,
    over the v2 panel kernel and the Newton inverse."""
    return _blocked(a, _panel_v2)
