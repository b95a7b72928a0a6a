"""Whole log_sigma slice sweep in one call.

Counterpart of ``auxpm_tpu/ops/sigma_sweep.py`` (``_sigma_sweep_kernel`` /
``_pallas_sigma_sweep`` / ``make_fused_sigma_sweep``).  The GP target's
log_sigma coordinate is Cholesky-free (chol(K) = exp(log_sigma) chol(R +
jitter I)); all ``1 + n_sigma_extra`` shrinkage-only slice updates of a step
run off the carried factor C0:

    per probe at candidate x:  f  = u @ (exp(x) * C0)^T   (scale BEFORE the
                                                           product)
                               ll = blocked-lse(loglik(f)) - log S
                               lp = lp_rest - hiv (x - mu)^2 + ll

Inputs filled by the caller (``models/gp_classification.sigma_sweep_factory``
and ``samplers/slice_theta.py``):

    chain (B, 8):      [ll0, lp0, sigma0, width, mu_p, hiv, lp_rest, 0] with
                       hiv = 0.5 / prior_std^2 and
                       lp_rest = log_prior(theta) + hiv (sigma0 - mu_p)^2
    rep (B, R, 2+32):  per slice repeat [log U (height), u1 (interval
                       placement), 32 shrink uniforms]

On CUDA tensors the sweep is ONE cooperative launch of
``csrc/sigma_sweep.cu`` over the whole card (one per slice of at most
``MAX_CHAINS`` chains): it advances in rounds, each
active chain making its next probe in every round, so each chain runs exactly
its own probe count and the number of rounds is the largest of them; on CPU
tensors it is the plain batched version ``_ref_sigma_sweep``.  The shrink cap
is the fixed 32 of the reference's kernel; cap-hit keeps the current point.
"""

from __future__ import annotations

import torch

from auxpm_tpu_torch.ops import _build
from auxpm_tpu_torch.ops.ess_sweep import sweep_workspace
from auxpm_tpu_torch.ops.fused_estimator import (
    LIKELIHOOD_IDS,
    MAX_CHAINS,
    WHITEN_DTYPES,
    _log_s,
    _ref_estimate,
    check_sweep_shapes,
    over_chain_slices,
)

MAX_SHRINK = 32
REP_COLS = 2 + MAX_SHRINK

launches = 0  # kernel launches made by this module's wrapper
# rounds of the last call (the most of its slices): a 1-element CUDA tensor,
# read after a synchronize (the kernel writes it at its end)
last_rounds = None


def _ref_sigma_sweep(chol0, u, chain, rep, y, mask, likelihood, n_blocks,
                     log_s, n_reps, whiten_dtype, probe_log=None):
    """Plain sweep over the whole batch, each chain frozen by its own
    ``done`` flag.  Returns ``(sigma', ll', lp', n_shrink, moved)``.

    ``probe_log``: optional list; every probe appends
    ``(active (B,) bool, lp - log_y (B,))``."""
    ll, lp, sig = chain[:, 0], chain[:, 1], chain[:, 2]
    w, mu, hiv, lp_rest = chain[:, 3], chain[:, 4], chain[:, 5], chain[:, 6]
    n_shrink_tot = torch.zeros_like(ll)
    moved_tot = torch.zeros_like(ll)

    def probe(x):
        c_x = torch.exp(x)[:, None, None] * chol0
        ll_x = _ref_estimate(c_x, u, y, mask, likelihood, n_blocks, log_s,
                             whiten_dtype)
        d = x - mu
        return lp_rest - hiv * d * d + ll_x, ll_x

    for r in range(n_reps):
        log_y = lp + rep[:, r, 0]
        l = sig - w * rep[:, r, 1]
        rt = l + w
        x, lp_n, ll_n = sig, lp, ll
        done = torch.zeros_like(ll, dtype=torch.bool)
        n_sh = torch.zeros_like(ll)
        for i in range(MAX_SHRINK):
            active = ~done
            if not bool(active.any()):
                break
            x_new = l + (rt - l) * rep[:, r, 2 + i]
            lp2, ll2 = probe(x_new)
            if probe_log is not None:
                probe_log.append((active.clone(), lp2 - log_y))
            ok = lp2 > log_y
            l = torch.where(active & ~(ok | (x_new >= sig)), x_new, l)
            rt = torch.where(active & ~(ok | (x_new < sig)), x_new, rt)
            x = torch.where(active, x_new, x)
            lp_n = torch.where(active, lp2, lp_n)
            ll_n = torch.where(active, ll2, ll_n)
            n_sh = n_sh + active.to(ll.dtype)
            done = done | (active & ok)
        sig = torch.where(done, x, sig)
        lp = torch.where(done, lp_n, lp)
        ll = torch.where(done, ll_n, ll)
        n_shrink_tot = n_shrink_tot + n_sh
        moved_tot = moved_tot + done.to(ll.dtype)
    return sig, ll, lp, n_shrink_tot, moved_tot


def _cuda_sigma_sweep(chol0, u, chain, rep, y, mask, likelihood, n_blocks,
                      log_s, n_reps, whiten_dtype):
    global launches, last_rounds
    if u.dim() != 3:
        raise ValueError("expected u (B, S, n)")
    b, s, n = u.shape
    if (chol0.shape != (b, n, n) or chain.shape != (b, 8)
            or rep.shape != (b, n_reps, REP_COLS) or y.shape != (n,)
            or mask.shape != (n,)):
        raise ValueError(
            f"shape mismatch: chol0 {tuple(chol0.shape)}, u {tuple(u.shape)}, "
            f"chain {tuple(chain.shape)}, rep {tuple(rep.shape)}"
        )
    check_sweep_shapes(s, n, n_blocks)
    if b < 1 or n_reps < 1:
        raise ValueError(f"B={b}, n_reps={n_reps}: the sweep takes at least "
                         "one chain and one repeat")
    if b > MAX_CHAINS:
        rounds = []

        def part(*chained):
            out = _cuda_sigma_sweep(*chained, y, mask, likelihood, n_blocks,
                                    log_s, n_reps, whiten_dtype)
            rounds.append(last_rounds)
            return out

        out = over_chain_slices(part, (chol0, u, chain, rep))
        last_rounds = torch.cat(rounds).amax(0, keepdim=True)
        return out
    device = _build.require_f32_contiguous(chol0=chol0, u=u, chain=chain,
                                           rep=rep, y=y, mask=mask)
    lib = _build.load_library()
    stats = torch.empty((b, 8), dtype=torch.float32, device=device)
    workspace = sweep_workspace(b, s, n, device)
    with torch.cuda.device(device):
        err = lib.auxpm_sigma_sweep(
            chol0.data_ptr(), u.data_ptr(), chain.data_ptr(), rep.data_ptr(),
            y.data_ptr(), mask.data_ptr(), stats.data_ptr(),
            workspace.data_ptr(), b, s, n, n_reps, n_blocks, _log_s(u, log_s),
            LIKELIHOOD_IDS[likelihood], int(whiten_dtype == "bfloat16"),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch(err, "sigma_sweep_kernel")
    launches += 1
    last_rounds = workspace[-1:]
    return stats[:, 0], stats[:, 1], stats[:, 2], stats[:, 3], stats[:, 4]


def sigma_sweep(chol0, u, chain, rep, y, mask, likelihood="logistic",
                n_blocks=1, log_s=None, n_reps=1, whiten_dtype="float32"):
    """``-> (sigma', ll', lp', n_shrink, moved)``, each ``(B,)``.

    CUDA tensors go to the kernel (or raise); CPU tensors take the plain
    version."""
    if likelihood not in LIKELIHOOD_IDS:
        raise ValueError(f"unknown likelihood {likelihood!r}")
    if whiten_dtype not in WHITEN_DTYPES:
        raise ValueError(f"unknown whiten_dtype {whiten_dtype!r}")
    if u.device.type == "cpu":
        return _ref_sigma_sweep(chol0, u, chain, rep, y, mask, likelihood,
                                n_blocks, log_s, n_reps, whiten_dtype)
    return _cuda_sigma_sweep(chol0, u, chain, rep, y, mask, likelihood,
                             n_blocks, log_s, n_reps, whiten_dtype)


def make_fused_sigma_sweep(y, mask, likelihood="logistic", n_blocks=1,
                           whiten_dtype="float32", n_reps=1):
    """Returns ``sweep(chol0, u, chain, rep) -> (sigma', ll', lp', n_shrink,
    moved)``."""
    y = y.to(torch.float32).contiguous()
    mask = mask.to(torch.float32).contiguous()
    return lambda chol0, u, chain, rep: sigma_sweep(
        chol0, u, chain, rep, y, mask, likelihood, n_blocks, None, n_reps,
        whiten_dtype)
