"""Squared-exponential Gram matrices, isotropic and ARD.

Counterpart of ``auxpm_tpu/ops/gram.py``.  The isotropic Gram is an
elementwise transform of squared distances cached once per dataset:

    K[i,j] = exp(2 log_sigma) exp(-0.5 sqdist[i,j] / exp(2 log_ell)) + jitter I

With per-dimension lengthscales (ARD) the scaled distances change with theta,
so every build is a scaled cross product plus ``exp``:

    K[i,j] = exp(2 log_sigma) exp(-0.5 sum_k (x_ik - x_jk)^2 / exp(2 log_ell_k))
             + jitter I

``se_gram_ard`` is the plain version, batched over chains.
``se_gram_ard_hopper`` is what the GP target calls: the correlation matrix
``R(ell) + jitter I`` with the pad fix-up of the target in one pass.  On a
CUDA tensor it launches the hand-written kernel ``csrc/se_gram.cu`` (or
raises): a persistent grid over the (chain, 64-tile pair i >= j) items, each
tile computed once and written with its mirror, bitwise symmetric; x is
scaled by exp(-log_ell) inside the kernel, as ``_scaled`` forms it.  On a CPU
tensor it takes ``se_gram_ard_masked``, the plain version of the same
function.  ``SeGramArd`` makes it differentiable in ``log_ells`` on both
devices: the backward is autograd through ``se_gram_ard_masked`` recomputed
at the saved lengthscales, the semantics of the reference's plain ARD Gram,
which its CPU path differentiates.
"""

from __future__ import annotations

import torch

from auxpm_tpu_torch.ops import _build

_TILE = 64            # the kernel's tiles (csrc/se_gram.cu kGramTile)
_BLOCK_SMEM_BYTES = 232448  # bytes of shared memory a block can use on sm_90

launches = 0  # kernel launches made by this module's wrapper


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


def _scaled(x, log_ells):
    """``x (n, d)``, ``log_ells (B, d) -> xs (B, n, d)`` = x / ell."""
    return x[None, :, :] * torch.exp(-log_ells)[:, None, :]


def se_gram_ard(x, log_ells, log_sigma=0.0, jitter=1e-6):
    """ARD SE Gram, plain version: ``x (n, d)``, ``log_ells (B, d)`` (or
    ``(d,)``) -> ``(B, n, n)`` (or ``(n, n)``).

    The reference's expression: squared distances of the pre-scaled data by
    the expansion ``sq_i + sq_j - 2 xs_i . xs_j`` (exact-f32 cross term),
    clamped at 0."""
    log_ells = torch.as_tensor(log_ells, dtype=x.dtype, device=x.device)
    single = log_ells.dim() == 1
    xs = _scaled(x, log_ells[None] if single else log_ells)
    sq = (xs * xs).sum(-1)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * (xs @ xs.mT)
    d2 = torch.clamp(d2, min=0.0)
    log_sigma = torch.as_tensor(log_sigma, dtype=x.dtype, device=x.device)
    k = torch.exp(2.0 * log_sigma.reshape(-1, 1, 1) - 0.5 * d2)
    n = x.shape[0]
    k = k + jitter * torch.eye(n, dtype=k.dtype, device=k.device)
    return k[0] if single else k


def se_gram_ard_masked(x, log_ells, jitter=1e-6, mask=None):
    """Plain version of ``se_gram_ard_hopper``: ``R(ell) + jitter I`` and,
    with ``mask (n,)`` (1 real row, 0 pad row), zero covariance to and from
    pad rows and a pad diagonal of exactly 1:
    ``r * mask_i * mask_j + diag(1 - mask)``."""
    r = se_gram_ard(x, log_ells, 0.0, jitter)
    if mask is not None:
        r = r * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
    return r


def gram_smem_bytes(n, d):
    """Shared memory of one block of the ARD Gram kernel: a chain's xs as
    [k][row] with its squared norms and mask (rows padded to 64), and one
    transposed 64 x 65 tile (``csrc/se_gram.cu`` ``gram_smem_bytes``)."""
    n_pad = -(-n // _TILE) * _TILE
    return 4 * (n_pad * (d + 2) + _TILE * (_TILE + 1))


def _cuda_se_gram_ard(x, log_ells, jitter, mask):
    global launches
    if x.dim() != 2 or log_ells.dim() != 2 or log_ells.shape[1] != x.shape[1]:
        raise ValueError(
            f"expected x (n, d) and log_ells (B, d), got {tuple(x.shape)} "
            f"and {tuple(log_ells.shape)}")
    n, d = x.shape
    b = log_ells.shape[0]
    smem = gram_smem_bytes(n, d)
    if smem > _BLOCK_SMEM_BYTES:
        raise ValueError(f"n={n}, d={d}: a chain's staged data needs {smem} "
                         "bytes of shared memory, a block has "
                         f"{_BLOCK_SMEM_BYTES}")
    if mask is not None and mask.shape != (n,):
        raise ValueError(f"mask {tuple(mask.shape)}: expected ({n},)")
    if log_ells.stride(1) != 1:    # rows may be strided (a slice of theta)
        log_ells = log_ells.contiguous()
    tensors = {"x": x} if mask is None else {"x": x, "mask": mask}
    device = _build.require_f32_contiguous(**tensors)
    if (not log_ells.is_cuda or log_ells.device != device
            or log_ells.dtype != torch.float32):
        raise ValueError(f"log_ells: expected float32 on {device}")
    lib = _build.load_library()
    out = torch.empty((b, n, n), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.auxpm_se_gram_ard(
            x.data_ptr(), log_ells.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(), b, n,
            d, log_ells.stride(0), float(jitter),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch(err, "se_gram_ard_kernel")
    launches += 1
    return out


def se_gram_ard_hopper(x, log_ells, jitter=1e-6, mask=None):
    """``x (n, d)``, ``log_ells (B, d) -> (B, n, n)``: ``R(ell) + jitter I``
    with the pad fix-up (see ``se_gram_ard_masked``).

    CUDA tensors go to the kernel (or raise); CPU tensors take the plain
    version."""
    if x.device.type == "cpu":
        return se_gram_ard_masked(x, log_ells, jitter, mask)
    return _cuda_se_gram_ard(x, log_ells, jitter, mask)


class SeGramArd(torch.autograd.Function):
    """``se_gram_ard_hopper`` differentiable in ``log_ells``: forward the
    kernel (card) or the plain version (CPU), backward autograd through
    ``se_gram_ard_masked``.  ``SeGramArd.apply(x, log_ells, jitter, mask)``
    is what the GP target calls."""

    @staticmethod
    def forward(ctx, x, log_ells, jitter, mask):
        ctx.save_for_backward(x, log_ells, mask)
        ctx.jitter = jitter
        return se_gram_ard_hopper(x, log_ells, jitter, mask)

    @staticmethod
    def backward(ctx, g):
        x, log_ells, mask = ctx.saved_tensors
        with torch.enable_grad():
            le = log_ells.detach().requires_grad_(True)
            (gl,) = torch.autograd.grad(
                se_gram_ard_masked(x, le, ctx.jitter, mask), le, g)
        return None, gl, None, None
