"""Elliptical slice update of the auxiliary draws u | theta.

Counterpart of ``auxpm_tpu/samplers/ess_u.py`` (both of its paths).
Murray, Adams & MacKay (2010) ESS applied to the auxiliary block:

    v ~ N(0, I);  log_y = log L̂(theta, u) + log Uniform(0,1)
    a ~ U(0, 2 pi); bracket = [a - 2 pi, a]
    while log L̂(theta, u cos a + v sin a) <= log_y:
        shrink bracket toward 0; redraw a
    u <- u cos a + v sin a

Rejection-free and tuning-free; the rotation preserves the N(0, I) prior on u
exactly.  The shrink cap (32) is a safety net: on cap-hit the state is kept.

theta is fixed for every probe and repeat, so the expensive part of the
estimator is prepared once per call, off the carried cache when the state has
one (the step then pays no Cholesky).  Two paths, with the same random rows:

- whole sweep: all ``n_repeats`` updates, every probe included, as ONE call
  of the target's sweep (``ops/ess_sweep.py``).  Taken when the target has an
  ``ess_sweep_factory`` and is not particle sharded, unless the environment
  says ``AUXPM_ESS_SWEEP=0`` (read when the transition is built, as the
  reference reads it);
- per-probe loop: a BATCHED Python loop over bracket shrinks with a per-chain
  ``done`` mask, one estimator call per round.  A probe carries only the
  angle: with ``target.log_lik_est_rot`` the rotation is fused into the
  estimator kernel (``ops/fused_estimator.fused_estimate_rot``), which is
  told which chains are still unfinished so that the others cost nothing;
  otherwise the proposal is formed here and goes through ``log_lik_est_u``
  (targets with ``prepare``) or ``log_lik_est``.  The accepted u' is formed
  ONCE after the loop.  The loop reads one flag per round (is any chain
  unfinished) to stop early: a host synchronisation per round.

The two paths make the same decisions and agree in values to about an ulp,
not bitwise: which path computes the probes is part of the realised float
trajectory.
"""

from __future__ import annotations

import math
import os

import torch

from auxpm_tpu_torch.core import prng
from auxpm_tpu_torch.core.state import ChainState, make_u_normal
from auxpm_tpu_torch.core.transition import keyed
from auxpm_tpu_torch.ops.ess_sweep import MAX_SHRINK
from auxpm_tpu_torch.ops.fused_estimator import rotate

_TWO_PI = 2.0 * math.pi


def make_ess_u(target, particle_axis=None, n_repeats=1):
    """``particle_axis``: this rank's ``parallel.mesh.Mesh`` when ``target``
    is particle sharded.  The update then takes the per-probe loop (a sweep
    kernel reduces over S inside its block), v covers the rank's rows
    (``core/state.make_u_normal``), and every probe is one call of the
    target's collective estimator."""
    if particle_axis is not None:
        from auxpm_tpu_torch.parallel.mesh import require_mesh

        require_mesh(particle_axis)
    # AUXPM_ESS_SWEEP=0 disables the whole-sweep path (A/B runs); read at
    # build time like the reference's other environment switches
    sweep = None
    if (target.ess_sweep_factory is not None and particle_axis is None
            and os.environ.get("AUXPM_ESS_SWEEP", "1") != "0"):
        sweep = target.ess_sweep_factory(n_repeats)
    draw_v = make_u_normal(target, particle_axis)

    def _prepare(state):
        cache = state.extras.get("target_cache")
        if cache is not None and target.prepare_c is not None:
            return target.prepare_c(state.theta, cache)
        return target.prepare(state.theta)

    def draw(state: ChainState, params=None):
        """Rows of one call, the same for both paths, from each chain's key
        as the reference splits it: per repeat ``key, k_v, k_h, k_loop =
        split(key, 4)``, ``v = draw_v(k_v)``, ``log uniform(k_h)``, ``a0 =
        uniform(k_loop) 2 pi`` and shrink uniform i from ``fold_in(k_loop, i
        + 1)``.  Returns ``({"scal": (B, R, 3 + 32), "v": (B, R, S, n)},
        advanced keys)``: ``scal`` = per repeat [ll0 (repeat 0 only), log U,
        a0, 32 shrink uniforms]."""
        del params
        key, subkeys = state.key, []
        for _ in range(n_repeats):
            k = prng.split(key, 4)
            key = k[:, 0]
            subkeys.append(k[:, 1:])
        k = torch.stack(subkeys, dim=1)              # (B, R, 3, 2)
        v = draw_v(k[:, :, 0], state.u.shape[1])
        shrink = prng.fold_in(k[:, :, 2, None], torch.arange(
            1, MAX_SHRINK + 1, device=key.device))
        # the uniforms of k_h, k_loop and the shrink keys in one draw
        unif = prng.uniform(torch.cat([k[:, :, 1:], shrink], dim=2))
        scal = torch.empty((*k.shape[:2], 3 + MAX_SHRINK),
                           dtype=torch.float32, device=key.device)
        scal[:, :, 0] = 0.0
        scal[:, 0, 0] = state.log_lik_hat
        scal[:, :, 1] = torch.log(unif[:, :, 0])
        scal[:, :, 2] = unif[:, :, 1] * _TWO_PI
        scal[:, :, 3:] = unif[:, :, 2:]
        return {"scal": scal, "v": v}, key

    def _info(n_shrink_total, moved_total):
        return {"n_shrink": n_shrink_total / n_repeats,
                "moved": moved_total / n_repeats}

    def apply_sweep(state: ChainState, rows: dict, params: dict):
        del params  # tuning-free
        u, ll, n_shrink_total, moved_total = sweep(
            _prepare(state), state.u, rows["scal"], rows["v"])
        return (state.replace(u=u, log_lik_hat=ll),
                _info(n_shrink_total, moved_total))

    def _rotated_estimator(state):
        """``est(u, v, angle, active) -> (B,)`` by the target's best route;
        ``active`` (None = all) is passed on where the route can use it."""
        if target.prepare is None:
            return lambda u, v, a, active: target.log_lik_est(
                state.theta, rotate(u, v, a))
        prepared = _prepare(state)
        if target.log_lik_est_rot is not None:
            return lambda u, v, a, active: target.log_lik_est_rot(
                prepared, u, v, a, active)
        return lambda u, v, a, active: target.log_lik_est_u(
            prepared, rotate(u, v, a))

    def apply_loop(state: ChainState, rows: dict, params: dict):
        # tuning-free; ``params["probe_log"]``, an optional list, collects
        # ``(chains the probe counted for, ll - log_y)`` of every probe
        probe_log = params.get("probe_log")
        est_rot = _rotated_estimator(state)
        scal = rows["scal"]
        u, ll = state.u, state.log_lik_hat
        n_shrink_total = torch.zeros_like(ll)
        moved_total = torch.zeros_like(ll)
        for r in range(n_repeats):
            v = rows["v"][:, r].contiguous()
            log_y = ll + scal[:, r, 1]
            a = scal[:, r, 2].contiguous()
            a_min, a_max = a - _TWO_PI, a
            ll_p = est_rot(u, v, a, None)
            done = ll_p > log_y
            if probe_log is not None:
                probe_log.append((torch.ones_like(done), ll_p - log_y))
            n_shrink = torch.zeros_like(ll)
            for i in range(MAX_SHRINK):
                active = ~done
                if not bool(active.any()):  # host sync, see the module note
                    break
                # shrink toward 0, redraw the angle
                a_min = torch.where(active & (a < 0), a, a_min)
                a_max = torch.where(active & ~(a < 0), a, a_max)
                a_new = a_min + (a_max - a_min) * scal[:, r, 3 + i]
                ll_new = est_rot(u, v, a_new, active.to(ll.dtype))
                if probe_log is not None:
                    probe_log.append((active, ll_new - log_y))
                a = torch.where(active, a_new, a)
                ll_p = torch.where(active, ll_new, ll_p)
                n_shrink = n_shrink + active.to(ll.dtype)
                done = done | (active & (ll_new > log_y))
            # the accepted u', once; cap-hit keeps the state (a no-op move)
            u = torch.where(done[:, None, None], rotate(u, v, a), u)
            ll = torch.where(done, ll_p, ll)
            n_shrink_total = n_shrink_total + n_shrink
            moved_total = moved_total + done.to(ll.dtype)
        return (state.replace(u=u, log_lik_hat=ll),
                _info(n_shrink_total, moved_total))

    step = keyed(draw, apply_loop if sweep is None else apply_sweep)
    step.uses_sweep = sweep is not None
    return step
