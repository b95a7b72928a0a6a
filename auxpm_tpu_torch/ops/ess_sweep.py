"""Whole elliptical-slice sweep of u | theta in one call.

Counterpart of ``auxpm_tpu/ops/ess_sweep.py`` (``_ess_sweep_kernel`` /
``_pallas_ess_sweep`` / ``make_fused_ess_sweep``): all ``n_repeats`` ESS
updates of a chain, every bracket-shrink probe included, computed off the
prepared factor C.  Each probe evaluates the estimator of
``ops/fused_estimator.py`` at ``u cos a + v_r sin a``.

Randomness is precomputed by the caller (``samplers/ess_u.py``):

    scal (B, R, 3 + 32): per repeat [ll0 (repeat 0 only), log U (slice
                         height), a0, 32 shrink uniforms]
    v    (B, R, S, n):   per-repeat direction draws

On CUDA tensors the sweep is ONE cooperative launch of ``csrc/ess_sweep.cu``
over the whole card (one per slice of at most ``MAX_CHAINS`` chains): it
advances in rounds, each active chain making its next probe in every round,
so each chain runs exactly its own probe count and the number of rounds is
the largest of them; any S up to ``MAX_SAMPLES`` and n a multiple of 64
(``check_sweep_shapes``); on CPU tensors it is the plain batched,
done-masked version ``_ref_ess_sweep``.  Cap-hit
(32 shrinks) keeps the current state, an exact no-op move.
"""

from __future__ import annotations

import math

import torch

from auxpm_tpu_torch.ops import _build
from auxpm_tpu_torch.ops.fused_estimator import (
    LIKELIHOOD_IDS,
    MAX_CHAINS,
    TILE_N,
    WHITEN_DTYPES,
    _log_s,
    _ref_estimate,
    check_sweep_shapes,
    col_tiles,
    over_chain_slices,
)

MAX_SHRINK = 32
SCAL_COLS = 3 + MAX_SHRINK
_STATE = 16         # floats of per-chain state in the kernel's workspace
_TILE = TILE_N      # columns of f per work item
_TWO_PI = 2.0 * math.pi

launches = 0  # kernel launches made by this module's wrapper
# rounds of the last call (the most of its slices): a 1-element CUDA tensor,
# read after a synchronize (the kernel writes it at its end)
last_rounds = None


def _ref_ess_sweep(chol, u, scal, v, y, mask, likelihood, n_blocks, log_s,
                   n_repeats, whiten_dtype, probe_log=None):
    """Plain sweep: the same algorithm over the whole batch, each chain
    frozen by its own ``done`` flag.  Returns ``(u', ll', n_shrink, moved)``.

    ``probe_log``: optional list; every probe appends
    ``(active (B,) bool, ll - log_y (B,))`` so a test can check how far each
    accept/shrink decision was from its boundary."""
    ll = scal[:, 0, 0]
    n_shrink_tot = torch.zeros_like(ll)
    moved_tot = torch.zeros_like(ll)
    for r in range(n_repeats):
        v_r = v[:, r]
        log_y = ll + scal[:, r, 1]

        def probe(a, active, u=u, v_r=v_r, log_y=log_y):
            rot = (u * torch.cos(a)[:, None, None]
                   + v_r * torch.sin(a)[:, None, None])
            ll_a = _ref_estimate(chol, rot, y, mask, likelihood, n_blocks,
                                 log_s, whiten_dtype)
            if probe_log is not None:
                probe_log.append((active.clone(), ll_a - log_y))
            return ll_a

        a = scal[:, r, 2]
        a_min, a_max = a - _TWO_PI, a
        ll_p = probe(a, torch.ones_like(a, dtype=torch.bool))
        done = ll_p > log_y
        n_shrink = torch.zeros_like(ll)
        for i in range(MAX_SHRINK):
            active = ~done
            if not bool(active.any()):
                break
            a_min = torch.where(active & (a < 0), a, a_min)
            a_max = torch.where(active & ~(a < 0), a, a_max)
            a_new = a_min + (a_max - a_min) * scal[:, r, 3 + i]
            ll_new = probe(a_new, active)
            a = torch.where(active, a_new, a)
            ll_p = torch.where(active, ll_new, ll_p)
            n_shrink = n_shrink + active.to(ll.dtype)
            done = done | (active & (ll_new > log_y))
        u_new = (u * torch.cos(a)[:, None, None]
                 + v_r * torch.sin(a)[:, None, None])
        u = torch.where(done[:, None, None], u_new, u)
        ll = torch.where(done, ll_p, ll)
        n_shrink_tot = n_shrink_tot + n_shrink
        moved_tot = moved_tot + done.to(ll.dtype)
    return u, ll, n_shrink_tot, moved_tot


def _cuda_ess_sweep(chol, u, scal, v, y, mask, likelihood, n_blocks, log_s,
                    n_repeats, whiten_dtype):
    global launches, last_rounds
    if u.dim() != 3:
        raise ValueError("expected u (B, S, n)")
    b, s, n = u.shape
    if (chol.shape != (b, n, n) or scal.shape != (b, n_repeats, SCAL_COLS)
            or v.shape != (b, n_repeats, s, n) or y.shape != (n,)
            or mask.shape != (n,)):
        raise ValueError(
            f"shape mismatch: chol {tuple(chol.shape)}, u {tuple(u.shape)}, "
            f"scal {tuple(scal.shape)}, v {tuple(v.shape)}"
        )
    check_sweep_shapes(s, n, n_blocks)
    if b < 1 or n_repeats < 1:
        raise ValueError(f"B={b}, n_repeats={n_repeats}: the sweep takes at "
                         "least one chain and one repeat")
    if b > MAX_CHAINS:
        rounds = []

        def part(*chained):
            out = _cuda_ess_sweep(*chained, y, mask, likelihood, n_blocks,
                                  log_s, n_repeats, whiten_dtype)
            rounds.append(last_rounds)
            return out

        out = over_chain_slices(part, (chol, u, scal, v))
        last_rounds = torch.cat(rounds).amax(0, keepdim=True)
        return out
    device = _build.require_f32_contiguous(chol=chol, u=u, scal=scal, v=v,
                                           y=y, mask=mask)
    lib = _build.load_library()
    u_out = torch.empty_like(u)
    stats = torch.empty((b, 4), dtype=torch.float32, device=device)
    workspace = sweep_workspace(b, s, n, device)
    with torch.cuda.device(device):
        err = lib.auxpm_ess_sweep(
            chol.data_ptr(), u.data_ptr(), scal.data_ptr(), v.data_ptr(),
            y.data_ptr(), mask.data_ptr(), u_out.data_ptr(), stats.data_ptr(),
            workspace.data_ptr(), b, s, n, n_repeats, n_blocks,
            _log_s(u, log_s),
            LIKELIHOOD_IDS[likelihood], int(whiten_dtype == "bfloat16"),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch(err, "ess_sweep_kernel")
    launches += 1
    last_rounds = workspace[-1:]
    return u_out, stats[:, 0], stats[:, 1], stats[:, 2]


def sweep_workspace(b, s, n, device):
    """Global workspace of a round-synchronous sweep kernel
    (``csrc/sweep_body.cuh``) on ``b`` chains of ``s`` samples: per-chain
    state (two buffers), the tile sums rowsum[chain][tile][S], and last the
    number of rounds."""
    return torch.empty(b * (2 * _STATE + col_tiles(n) * s) + 1,
                       dtype=torch.float32, device=device)


def sweep_grid(device=None):
    """Blocks of the grid every kernel of the sweep body launches on
    ``device`` (occupancy x SM count: two per SM); raises if the card cannot
    hold one block."""
    lib = _build.load_library()
    with torch.cuda.device(device):
        grid = lib.auxpm_sweep_grid()
    _build.check_launch(-grid if grid < 0 else 0, "sweep grid")
    return grid


def cooperative_launch_error(extra_blocks, device=None):
    """The CUDA error (0 = taken) of a cooperative launch of the sweep body's
    block shape on that grid plus ``extra_blocks``: the card has to refuse a
    grid whose blocks cannot all be resident, and the sweeps' wrappers raise
    on that error."""
    lib = _build.load_library()
    with torch.cuda.device(device):
        return lib.auxpm_cooperative_launch_check(int(extra_blocks))


def ess_sweep(chol, u, scal, v, y, mask, likelihood="logistic", n_blocks=1,
              log_s=None, n_repeats=1, whiten_dtype="float32"):
    """``-> (u' (B,S,n), ll' (B,), n_shrink (B,), moved (B,))``.

    CUDA tensors go to the kernel (or raise); CPU tensors take the plain
    version."""
    if likelihood not in LIKELIHOOD_IDS:
        raise ValueError(f"unknown likelihood {likelihood!r}")
    if whiten_dtype not in WHITEN_DTYPES:
        raise ValueError(f"unknown whiten_dtype {whiten_dtype!r}")
    if u.device.type == "cpu":
        return _ref_ess_sweep(chol, u, scal, v, y, mask, likelihood, n_blocks,
                              log_s, n_repeats, whiten_dtype)
    return _cuda_ess_sweep(chol, u, scal, v, y, mask, likelihood, n_blocks,
                           log_s, n_repeats, whiten_dtype)


def make_fused_ess_sweep(y, mask, likelihood="logistic", n_blocks=1,
                         whiten_dtype="float32", n_repeats=1):
    """Returns ``sweep(chol, u, scal, v) -> (u', ll', n_shrink, moved)``."""
    y = y.to(torch.float32).contiguous()
    mask = mask.to(torch.float32).contiguous()
    return lambda chol, u, scal, v: ess_sweep(
        chol, u, scal, v, y, mask, likelihood, n_blocks, None, n_repeats,
        whiten_dtype)
