"""Fused whiten -> likelihood -> log-sum-exp estimator.

Counterpart of ``auxpm_tpu/ops/fused_estimator.py`` (``_fused_kernel`` /
``_pallas_estimate`` / ``make_fused_estimator`` and ``_fused_rot_kernel`` /
``_pallas_estimate_rot`` / ``make_fused_rot_estimator``).  For each chain b

    f   = u[b] @ C[b].T                        (S, n)
    lw  = sum_i mask_i * log lik(y_i f_si)     per importance sample
    out = blocked-lse_s(lw) - log S            scalar

On a CUDA tensor each function of this module launches one entry of the
hand-written kernel source ``csrc/fused_estimator.cu``; on a CPU tensor it
takes its plain version (``_ref_*``).  Every entry is ONE round of the sweep
body ``csrc/sweep_body.cuh``: the (chain, 64-row block, 64-column tile) items
of the call's chains over the whole card, the triangle of C skipped, f never
stored, and the block that completes a chain's last item folds it.  Every
entry takes any S from 1 to ``MAX_SAMPLES`` and any n, as the reference's
kernels do (C is re-read once per row block past 64 samples,
and the last column tile of an n that 64 does not divide is masked).

- ``fused_estimate``: the estimate at u.
- ``fused_estimate_rot``: the same at the elliptical-slice proposal
  ``u cos a + v sin a`` (formed inside the kernel, never stored), over the
  ACTIVE chains only (``active``: the bracket loop's unfinished chains).
- ``fused_weights`` / ``fused_rot_weights`` (``_pallas_weights`` /
  ``_pallas_rot_weights`` / ``make_fused_weights`` /
  ``make_fused_rot_weights`` in the reference): the per-sample log-weights
  ``lw`` with no log-sum-exp, at u and at the rotated proposal (the latter
  over the active chains only).  They are the local half of the
  particle-sharded estimator, where a rank holds ``S_local = S / K`` rows of
  u and a collective folds the blocked partials
  (``parallel/collectives.allgather_blocked_logsumexp``).

A row's weight has the same bits whichever rows share its call (the K ranks
of a particle group rest on it), and a chain's result the same bits whichever
chains share its call.

Reverse mode (the reference's ``custom_vjp`` on the estimate and the
weights): ``FusedEstimate`` and ``FusedWeights`` are ``torch.autograd.
Function``s whose forward is the dispatch above (the kernel for a CUDA
tensor, the plain version for a CPU tensor, the same on both devices) and
whose backward is ``torch.autograd.grad`` of the plain version
(``_ref_estimate`` / ``_ref_weights``) recomputed from the saved ``(chol,
u)`` in exact f32; there is no backward kernel, as the reference has none.
``make_fused_estimator`` and ``make_fused_weights`` return callables through
them.  The rotated entries and the sweeps have no reverse mode: no gradient
path reaches them.

The wrappers whose kernel keeps a list of active chains (the rotated
estimate and the rotated weights here, both sweeps) split a call of more
than ``MAX_CHAINS`` chains into consecutive slices (``over_chain_slices``).
"""

from __future__ import annotations

import numpy as np
import torch

from auxpm_tpu_torch.models.likelihoods import log_ndtr, log_sigmoid
from auxpm_tpu_torch.ops import _build
from auxpm_tpu_torch.ops.logsumexp import blocked_logsumexp

WHITEN_DTYPES = ("float32", "bfloat16")
LIKELIHOOD_IDS = {"logistic": 0, "probit": 1}

# shapes of the sweep body (csrc/sweep_body.cuh)
TILE_N = 64         # columns of f in one work item (64 rows of u in one)
MAX_SAMPLES = 4096  # most importance samples S (csrc/probe.cuh kMaxSamples)
MAX_CHAINS = 2048   # chains of one launch with an active list
                    # (csrc/sweep_body.cuh kMaxChains); wrappers split more

launches = 0        # launches of the plain-estimator kernel by its wrapper
launches_rot = 0    # launches of the rotated-estimator kernel by its wrapper
launches_w = 0      # launches of the weights kernel by its wrapper
launches_rot_w = 0  # launches of the rotated-weights kernel by its wrapper


class _ActiveCount:
    """Chains passed to one kernel's launches, and per device an int32 to
    which each launch adds how many of them were active (block 0 of the
    kernel adds it on the card)."""

    def __init__(self):
        self.slots = 0
        self._totals = {}

    def total(self, device):
        t = self._totals.get(device)
        if t is None:
            t = self._totals[device] = torch.zeros(1, dtype=torch.int32,
                                                   device=device)
        return t

    def share(self):
        """Mean share of active chains per launch since the last ``reset``;
        reading it synchronises.  None before any launch."""
        if not self.slots:
            return None
        return sum(int(t.item()) for t in self._totals.values()) / self.slots

    def reset(self):
        self.slots = 0
        for t in self._totals.values():
            t.zero_()


# the kernels with an active list: "estimate_rot", "rot_weights"
active_counts = {"estimate_rot": _ActiveCount(), "rot_weights": _ActiveCount()}


def _dot_whiten(u, chol, whiten_dtype):
    """``u (..., S, n) x chol (..., n, n)^T -> (..., S, n)``, f32 accumulate.

    bfloat16: both operands rounded to bf16, products and sums in f32 (a
    product of two bf16 values is exact in f32) — the same arithmetic the
    kernel does."""
    if whiten_dtype == "bfloat16":
        u = u.to(torch.bfloat16).to(torch.float32)
        chol = chol.to(torch.bfloat16).to(torch.float32)
    return u @ chol.mT


def _log_lik_tile(f, y, mask, likelihood):
    if likelihood == "logistic":
        return log_sigmoid(y * f) * mask
    return log_ndtr(y * f) * mask


def _ref_weights(chol, u, y, mask, likelihood, whiten_dtype="float32"):
    """Plain per-sample log-weights ``(..., S)``."""
    f = _dot_whiten(u, chol, whiten_dtype)
    return _log_lik_tile(f, y, mask, likelihood).sum(-1)


def _log_s(u, log_s):
    if log_s is not None:
        return float(log_s)
    return float(np.log(np.float32(u.shape[-2])))


def _ref_estimate(chol, u, y, mask, likelihood, n_blocks=1, log_s=None,
                  whiten_dtype="float32"):
    """Plain estimate with the canonical blocked reduction; ``(...,)``."""
    lw = _ref_weights(chol, u, y, mask, likelihood, whiten_dtype)
    return blocked_logsumexp(lw, n_blocks) - _log_s(u, log_s)


def probe_shape_error(s, n, n_blocks=None):
    """Why the sweep body does not take these shapes, or None if it does
    (``n_blocks=None``: an entry without a log-sum-exp).  Its shared memory
    depends on neither S nor n: any n goes, and S up to ``MAX_SAMPLES``, the
    most log-weights of one chain that a sweep's phase B folds in a block's
    idle ring (16 KB of its 104 KB)."""
    if n < 1:
        return f"n={n}: the probe needs at least one data point"
    if s < 1 or s > MAX_SAMPLES:
        return (f"S={s}: the kernels take 1 to {MAX_SAMPLES} importance "
                "samples (a sweep folds a chain's S log-weights in 16 KB of "
                "a block's shared memory)")
    if n_blocks is not None and (n_blocks < 1 or n_blocks > 32
                                 or s % n_blocks):
        return f"n_blocks={n_blocks} must divide S={s} and be <= 32"
    return None


def check_probe_shapes(s, n, n_blocks=None):
    """Raise on shapes the sweep body does not take (``probe_shape_error``)."""
    err = probe_shape_error(s, n, n_blocks)
    if err is not None:
        raise ValueError(err)


def sweep_shape_error(s, n, n_blocks):
    """Why the two sweeps (``ops/ess_sweep``, ``ops/sigma_sweep``) do not
    take these shapes, or None: the body's limits, and n a multiple of 64,
    the only n their callers give them (the factories give sweeps to padded
    targets alone, as the reference's ``use_fused`` does)."""
    if n % TILE_N:
        return (f"n={n}: the sweeps take n a multiple of {TILE_N} (a padded "
                "target; an unpadded one takes the per-probe path)")
    return probe_shape_error(s, n, n_blocks)


def check_sweep_shapes(s, n, n_blocks):
    """Raise on shapes the sweeps do not take (``sweep_shape_error``)."""
    err = sweep_shape_error(s, n, n_blocks)
    if err is not None:
        raise ValueError(err)


def fits_sweep_body(s, n, n_blocks):
    """Whether both sweeps take S = ``s`` samples at n = ``n`` with that
    reduction tree.  The target's sweep factories return None where this is
    False, as the reference's return None past their memory gates."""
    return sweep_shape_error(s, n, n_blocks) is None


def col_tiles(n):
    """Column tiles of f, the last one partial where 64 does not divide n."""
    return -(-n // TILE_N)


def _round_workspace(b, s, n, device):
    """Workspace of one round of the sweep body: the tile sums
    rowsum[chain][tile][S], then one int32 arrival counter per chain, zero
    at the launch."""
    floats = b * col_tiles(n) * s
    workspace = torch.empty(floats + b, dtype=torch.float32, device=device)
    workspace[floats:].zero_()
    return workspace


def over_chain_slices(fn, chained, limit=MAX_CHAINS):
    """``fn(*parts)`` on consecutive slices of at most ``limit`` chains of
    the tensors ``chained`` (leading axis = chains), the outputs (a tensor or
    a tuple of tensors) concatenated along that axis.  A chain's result does
    not depend on the other chains of its call, so the split gives the bits
    one call would."""
    b = chained[0].shape[0]
    outs = [fn(*(a[i:i + limit] for a in chained))
            for i in range(0, b, limit)]
    if len(outs) == 1:
        return outs[0]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def _cuda_estimate(chol, u, y, mask, likelihood, n_blocks, log_s,
                   whiten_dtype):
    global launches
    if chol.dim() != 3 or u.dim() != 3:
        raise ValueError("expected chol (B, n, n) and u (B, S, n)")
    b, s, n = u.shape
    if chol.shape != (b, n, n) or y.shape != (n,) or mask.shape != (n,):
        raise ValueError(
            f"shape mismatch: chol {tuple(chol.shape)}, u {tuple(u.shape)}, "
            f"y {tuple(y.shape)}, mask {tuple(mask.shape)}"
        )
    check_probe_shapes(s, n, n_blocks)
    device = _build.require_f32_contiguous(chol=chol, u=u, y=y, mask=mask)
    lib = _build.load_library()
    out = torch.empty((b,), dtype=torch.float32, device=device)
    workspace = _round_workspace(b, s, n, device)
    with torch.cuda.device(device):
        err = lib.auxpm_fused_estimate(
            chol.data_ptr(), u.data_ptr(), y.data_ptr(), mask.data_ptr(),
            out.data_ptr(), workspace.data_ptr(), b, s, n, n_blocks,
            _log_s(u, log_s),
            LIKELIHOOD_IDS[likelihood], int(whiten_dtype == "bfloat16"),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch(err, "fused_estimate_kernel")
    launches += 1
    return out


def fused_estimate(chol, u, y, mask, likelihood="logistic", n_blocks=1,
                   log_s=None, whiten_dtype="float32"):
    """``chol (B, n, n), u (B, S, n) -> (B,)`` estimates.

    CUDA tensors go to the kernel (or raise); CPU tensors take the plain
    version."""
    _check_names(likelihood, whiten_dtype)
    if u.device.type == "cpu":
        return _ref_estimate(chol, u, y, mask, likelihood, n_blocks, log_s,
                             whiten_dtype)
    return _cuda_estimate(chol, u, y, mask, likelihood, n_blocks, log_s,
                          whiten_dtype)


def rotate(u, v, angle):
    """``u cos a + v sin a`` with ``angle (B,)`` against ``(B, S, n)``."""
    return (u * torch.cos(angle)[:, None, None]
            + v * torch.sin(angle)[:, None, None])


def _ref_estimate_rot(chol, u, v, angle, y, mask, likelihood, n_blocks=1,
                      log_s=None, whiten_dtype="float32", active=None):
    """Plain estimate at the rotated proposal; ``(B,)``.  With ``active
    (B,)`` (1 = wanted) the chains that are not wanted give 0."""
    est = _ref_estimate(chol, rotate(u, v, angle), y, mask, likelihood,
                        n_blocks, log_s, whiten_dtype)
    if active is not None:
        est = torch.where(active != 0, est, torch.zeros_like(est))
    return est


def _cuda_estimate_rot(chol, u, v, angle, y, mask, likelihood, n_blocks,
                       log_s, whiten_dtype, active):
    global launches_rot
    if chol.dim() != 3 or u.dim() != 3:
        raise ValueError("expected chol (B, n, n) and u (B, S, n)")
    b, s, n = u.shape
    if (chol.shape != (b, n, n) or v.shape != u.shape or angle.shape != (b,)
            or y.shape != (n,) or mask.shape != (n,)
            or (active is not None and active.shape != (b,))):
        raise ValueError(
            f"shape mismatch: chol {tuple(chol.shape)}, u {tuple(u.shape)}, "
            f"v {tuple(v.shape)}, angle {tuple(angle.shape)}"
        )
    check_probe_shapes(s, n, n_blocks)
    if b > MAX_CHAINS:
        chained = (chol, u, v, angle) + (() if active is None else (active,))
        return over_chain_slices(
            lambda c, u_, v_, a_, act=None: _cuda_estimate_rot(
                c, u_, v_, a_, y, mask, likelihood, n_blocks, log_s,
                whiten_dtype, act),
            chained)
    tensors = dict(chol=chol, u=u, v=v, angle=angle, y=y, mask=mask)
    if active is not None:
        tensors["active"] = active
    device = _build.require_f32_contiguous(**tensors)
    lib = _build.load_library()
    out = torch.empty((b,), dtype=torch.float32, device=device)
    workspace = _round_workspace(b, s, n, device)
    count = active_counts["estimate_rot"]
    with torch.cuda.device(device):
        err = lib.auxpm_fused_estimate_rot(
            chol.data_ptr(), u.data_ptr(), v.data_ptr(), angle.data_ptr(),
            None if active is None else active.data_ptr(), y.data_ptr(),
            mask.data_ptr(), out.data_ptr(), workspace.data_ptr(),
            count.total(device).data_ptr(), b, s, n, n_blocks,
            _log_s(u, log_s), LIKELIHOOD_IDS[likelihood],
            int(whiten_dtype == "bfloat16"),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch(err, "fused_estimate_rot_kernel")
    launches_rot += 1
    count.slots += b
    return out


def fused_estimate_rot(chol, u, v, angle, y, mask, likelihood="logistic",
                       n_blocks=1, log_s=None, whiten_dtype="float32",
                       active=None):
    """``chol (B, n, n), u, v (B, S, n), angle (B,) -> (B,)``: the estimate
    at ``u cos a + v sin a``.  ``active (B,)`` float32, optional: chains with
    0 are skipped and give 0 (the bracket loop's finished chains).

    CUDA tensors go to the kernel (or raise); CPU tensors take the plain
    version."""
    _check_names(likelihood, whiten_dtype)
    if u.device.type == "cpu":
        return _ref_estimate_rot(chol, u, v, angle, y, mask, likelihood,
                                 n_blocks, log_s, whiten_dtype, active)
    return _cuda_estimate_rot(chol, u, v, angle, y, mask, likelihood,
                              n_blocks, log_s, whiten_dtype, active)


def _check_names(likelihood, whiten_dtype):
    if likelihood not in LIKELIHOOD_IDS:
        raise ValueError(f"unknown likelihood {likelihood!r}")
    if whiten_dtype not in WHITEN_DTYPES:
        raise ValueError(f"unknown whiten_dtype {whiten_dtype!r}")


def _ref_rot_weights(chol, u, v, angle, y, mask, likelihood,
                     whiten_dtype="float32", active=None):
    """Plain per-sample log-weights at the rotated proposal; ``(B, S)``.
    With ``active (B,)`` (1 = wanted) the chains that are not wanted give 0."""
    lw = _ref_weights(chol, rotate(u, v, angle), y, mask, likelihood,
                      whiten_dtype)
    if active is not None:
        lw = torch.where((active != 0)[:, None], lw, torch.zeros_like(lw))
    return lw


def _cuda_weights(chol, u, y, mask, likelihood, whiten_dtype):
    global launches_w
    if chol.dim() != 3 or u.dim() != 3:
        raise ValueError("expected chol (B, n, n) and u (B, S, n)")
    b, s, n = u.shape
    if chol.shape != (b, n, n) or y.shape != (n,) or mask.shape != (n,):
        raise ValueError(
            f"shape mismatch: chol {tuple(chol.shape)}, u {tuple(u.shape)}, "
            f"y {tuple(y.shape)}, mask {tuple(mask.shape)}"
        )
    check_probe_shapes(s, n)
    # no split: without an active list the kernel takes any number of chains
    device = _build.require_f32_contiguous(chol=chol, u=u, y=y, mask=mask)
    lib = _build.load_library()
    out = torch.empty((b, s), dtype=torch.float32, device=device)
    workspace = _round_workspace(b, s, n, device)
    with torch.cuda.device(device):
        err = lib.auxpm_fused_weights(
            chol.data_ptr(), u.data_ptr(), y.data_ptr(), mask.data_ptr(),
            out.data_ptr(), workspace.data_ptr(), b, s, n,
            LIKELIHOOD_IDS[likelihood],
            int(whiten_dtype == "bfloat16"),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch(err, "fused_weights_kernel")
    launches_w += 1
    return out


def fused_weights(chol, u, y, mask, likelihood="logistic",
                  whiten_dtype="float32"):
    """``chol (B, n, n), u (B, S_local, n) -> (B, S_local)`` per-sample
    log-weights.

    CUDA tensors go to the kernel (or raise); CPU tensors take the plain
    version."""
    _check_names(likelihood, whiten_dtype)
    if u.device.type == "cpu":
        return _ref_weights(chol, u, y, mask, likelihood, whiten_dtype)
    return _cuda_weights(chol, u, y, mask, likelihood, whiten_dtype)


def _cuda_rot_weights(chol, u, v, angle, y, mask, likelihood, whiten_dtype,
                      active):
    global launches_rot_w
    if chol.dim() != 3 or u.dim() != 3:
        raise ValueError("expected chol (B, n, n) and u (B, S, n)")
    b, s, n = u.shape
    if (chol.shape != (b, n, n) or v.shape != u.shape or angle.shape != (b,)
            or y.shape != (n,) or mask.shape != (n,)
            or (active is not None and active.shape != (b,))):
        raise ValueError(
            f"shape mismatch: chol {tuple(chol.shape)}, u {tuple(u.shape)}, "
            f"v {tuple(v.shape)}, angle {tuple(angle.shape)}"
        )
    check_probe_shapes(s, n)
    if b > MAX_CHAINS:
        chained = (chol, u, v, angle) + (() if active is None else (active,))
        return over_chain_slices(
            lambda c, u_, v_, a_, act=None: _cuda_rot_weights(
                c, u_, v_, a_, y, mask, likelihood, whiten_dtype, act),
            chained)
    tensors = dict(chol=chol, u=u, v=v, angle=angle, y=y, mask=mask)
    if active is not None:
        tensors["active"] = active
    device = _build.require_f32_contiguous(**tensors)
    lib = _build.load_library()
    out = torch.empty((b, s), dtype=torch.float32, device=device)
    workspace = _round_workspace(b, s, n, device)
    count = active_counts["rot_weights"]
    with torch.cuda.device(device):
        err = lib.auxpm_fused_rot_weights(
            chol.data_ptr(), u.data_ptr(), v.data_ptr(), angle.data_ptr(),
            None if active is None else active.data_ptr(), y.data_ptr(),
            mask.data_ptr(), out.data_ptr(), workspace.data_ptr(),
            count.total(device).data_ptr(), b, s, n,
            LIKELIHOOD_IDS[likelihood], int(whiten_dtype == "bfloat16"),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch(err, "fused_rot_weights_kernel")
    launches_rot_w += 1
    count.slots += b
    return out


def fused_rot_weights(chol, u, v, angle, y, mask, likelihood="logistic",
                      whiten_dtype="float32", active=None):
    """``chol (B, n, n), u, v (B, S_local, n), angle (B,) -> (B, S_local)``:
    the per-sample log-weights at ``u cos a + v sin a``.  ``active (B,)``
    float32, optional: chains with 0 are skipped and give 0.

    CUDA tensors go to the kernel (or raise); CPU tensors take the plain
    version."""
    _check_names(likelihood, whiten_dtype)
    if u.device.type == "cpu":
        return _ref_rot_weights(chol, u, v, angle, y, mask, likelihood,
                                whiten_dtype, active)
    return _cuda_rot_weights(chol, u, v, angle, y, mask, likelihood,
                             whiten_dtype, active)


def _plain_vjp(plain, chol, u, g, needs):
    """Gradients of ``plain(chol, u)`` with respect to the inputs in
    ``needs`` for the cotangent ``g``, recomputed in exact f32."""
    with torch.enable_grad():
        c = chol.detach().requires_grad_(needs[0])
        uu = u.detach().requires_grad_(needs[1])
        wrt = [a for a, need in zip((c, uu), needs) if need]
        grads = iter(torch.autograd.grad(plain(c, uu), wrt, g))
    return tuple(next(grads) if need else None for need in needs)


class FusedEstimate(torch.autograd.Function):
    """``fused_estimate`` with the reference's reverse-mode rule: the
    backward is the gradient of ``_ref_estimate`` at the saved inputs."""

    @staticmethod
    def forward(ctx, chol, u, y, mask, likelihood, n_blocks, log_s,
                whiten_dtype):
        ctx.save_for_backward(chol, u, y, mask)
        ctx.args = (likelihood, n_blocks, log_s, whiten_dtype)
        return fused_estimate(chol, u, y, mask, likelihood, n_blocks, log_s,
                              whiten_dtype)

    @staticmethod
    def backward(ctx, g):
        chol, u, y, mask = ctx.saved_tensors
        gc, gu = _plain_vjp(
            lambda c, uu: _ref_estimate(c, uu, y, mask, *ctx.args), chol, u,
            g, ctx.needs_input_grad[:2])
        return gc, gu, None, None, None, None, None, None


class FusedWeights(torch.autograd.Function):
    """``fused_weights`` with the reference's reverse-mode rule: the backward
    is the vector-Jacobian product of ``_ref_weights`` at the saved
    inputs."""

    @staticmethod
    def forward(ctx, chol, u, y, mask, likelihood, whiten_dtype):
        ctx.save_for_backward(chol, u, y, mask)
        ctx.args = (likelihood, whiten_dtype)
        return fused_weights(chol, u, y, mask, likelihood, whiten_dtype)

    @staticmethod
    def backward(ctx, g):
        chol, u, y, mask = ctx.saved_tensors
        gc, gu = _plain_vjp(
            lambda c, uu: _ref_weights(c, uu, y, mask, *ctx.args), chol, u,
            g, ctx.needs_input_grad[:2])
        return gc, gu, None, None, None, None


def make_fused_estimator(y, mask, likelihood="logistic", n_blocks=1,
                         whiten_dtype="float32"):
    """Returns ``est(chol (B,n,n), u (B,S,n)) -> (B,)`` through
    ``FusedEstimate`` (differentiable in both arguments); ``n_blocks`` fixes
    the reduction tree and ``whiten_dtype`` the product's precision, both
    part of the estimator's definition."""
    y = y.to(torch.float32).contiguous()
    mask = mask.to(torch.float32).contiguous()
    return lambda chol, u: FusedEstimate.apply(chol, u, y, mask, likelihood,
                                               n_blocks, None, whiten_dtype)


def make_fused_rot_estimator(y, mask, likelihood="logistic", n_blocks=1,
                             whiten_dtype="float32"):
    """Returns ``est(chol, u, v, angle, active=None) -> (B,)`` for the
    elliptical-slice loop: the estimate at the rotated proposal."""
    y = y.to(torch.float32).contiguous()
    mask = mask.to(torch.float32).contiguous()
    return lambda chol, u, v, angle, active=None: fused_estimate_rot(
        chol, u, v, angle, y, mask, likelihood, n_blocks, None, whiten_dtype,
        active)


def make_fused_weights(y, mask, likelihood="logistic", whiten_dtype="float32"):
    """Returns ``lw(chol (B,n,n), u (B,S_local,n)) -> (B, S_local)`` through
    ``FusedWeights`` (differentiable in both arguments)."""
    y = y.to(torch.float32).contiguous()
    mask = mask.to(torch.float32).contiguous()
    return lambda chol, u: FusedWeights.apply(chol, u, y, mask, likelihood,
                                              whiten_dtype)


def make_fused_rot_weights(y, mask, likelihood="logistic",
                           whiten_dtype="float32"):
    """Returns ``lw(chol, u, v, angle, active=None) -> (B, S_local)`` at the
    rotated proposal."""
    y = y.to(torch.float32).contiguous()
    mask = mask.to(torch.float32).contiguous()
    return lambda chol, u, v, angle, active=None: fused_rot_weights(
        chol, u, v, angle, y, mask, likelihood, whiten_dtype, active)


def probe_flops(s, n):
    """Least FLOPs of one probe of one chain, the f = u C^T product: C is
    lower-triangular, so column i of f needs i + 1 terms, S n (n + 1) in
    all."""
    return float(s) * n * (n + 1)

