"""Linear slice sampling of theta | u (Neal 2003): stepping out + shrinkage.

Counterpart of ``auxpm_tpu/samplers/slice_theta.py`` (``make_slice_theta``
and ``make_slice_theta_rd``).
With u part of the chain state,

    f(theta') = log p(theta') + log L̂(theta', u)

is a deterministic function of theta', so the pseudo-marginal problem is a
plain slice-sampling problem.  Per 1-D update (Neal 2003, 4 and 5):

    log_y = f(theta) + log U
    l = x0 - w U1; r = l + w
    while f(l) > log_y and steps < m: l -= w      (step out left)
    while f(r) > log_y and steps < m: r += w      (step out right)
    repeat: x ~ U(l, r)
            if f(x) > log_y: accept
            elif x < x0: l = x else r = x        (shrink)

Every loop is a BATCHED Python loop over the chains with per-chain masks: a
chain that has finished keeps its values while the others go on.  Both
step-out ends of every chain are probed in ONE estimator call per iteration
(the factory's 2-point probe ``f2``, a batch of 2B); an end that has stopped
expanding is still probed and its result ignored, and a chain's probe count
is ``2 * (iterations while it was expanding) + shrinks``.  ``max_step_out ==
0`` is the shrinkage-only variant: the randomly placed interval is used as it
is.  On cap-hit the coordinate keeps its current value (an exact no-op).

Three branches, chosen as the reference chooses them:

- carried factor (the state has a ``target_cache`` and the target has
  ``coord_estimators_c``): the ell coordinates one after the other, each probe
  factoring its own Gram, capped at ``max_shrink_chol``; ONE refresh of the
  carried factor at the post-ell theta, outside every loop; then the last
  coordinate (log_sigma) off that factor with ``1 + n_sigma_extra`` repeats,
  capped at ``max_shrink``: all repeats in one call of the target's sweep
  (``ops/sigma_sweep.py``) when ``max_step_out == 0``, the target has a
  sweep and ``AUXPM_SIGMA_SWEEP`` is not ``0``, per probe otherwise;
- structure-aware without a cache (``coord_estimators``): the same with the
  log_sigma factory factoring once per sweep;
- generic (a target without factories, e.g. the Gaussian toy): every
  coordinate through ``log_lik_est`` with ``max_shrink``; all its probes count
  as ``n_probe_chol``.

A cache that a non-cache-aware branch passed by is refreshed at the end, so
``extras["target_cache"] == cache_init(theta)`` holds at every step boundary.

Host synchronisations: each loop reads one flag per iteration (is any chain
still expanding / shrinking) to stop early, so a coordinate costs up to
``max_step_out + max_shrink`` reads and usually a handful; a later change can
drop the early exits or move the loops into device code.

``make_slice_theta_rd`` makes one 1-D update along a random unit direction
e per chain: x is the step t along e from theta, every probe (and both ends
of the step-out probe, one batch of 2B) goes through ``target.log_lik_est``
at theta + t e, and a carried factor is refreshed once at the new theta.

Params:
  widths: scalar or (d,) bracket widths w.
  max_step_out: cap m on step-out expansions each side (default 8).
  max_shrink: shrink cap (default 32, at most 32: a row carries 32 shrink
    uniforms).
  max_shrink_chol: shrink cap of the coordinates whose probes pay a
    factorisation (default ``max_shrink``).
  probe_log: optional list that collects every per-probe decision margin
    (see ``_slice_1d``); the sigma sweep, one call, logs nothing.
"""

from __future__ import annotations

import os
import warnings

import torch

from auxpm_tpu_torch.core import prng
from auxpm_tpu_torch.core.state import ChainState, refresh_target_cache
from auxpm_tpu_torch.core.transition import keyed
from auxpm_tpu_torch.models.base import full_coord_probes, set_coord
from auxpm_tpu_torch.ops.sigma_sweep import MAX_SHRINK

REP_COLS = 2 + MAX_SHRINK


def _slice_1d(rep, x0, log_fx0, f, f2, w, max_step_out, max_shrink,
              probe_log=None):
    """One batched 1-D slice update.

    ``rep (B, 2 + 32)`` = [log U, U1, shrink uniforms]; ``f(x (B,)) ->
    (log_post, log_lik)``; ``f2(xs (2, B)) -> ((2, B), (2, B))`` the 2-point
    probe of the step-out loop.  Returns ``(x_new, log_post_new, log_lik_new,
    done, n_probe)``; ``log_lik_new`` is valid only where ``done``.

    ``probe_log``: optional list; every decision appends ``(chains it
    counted for (B,) bool, log_post - log_y (B,))`` so a caller can see how
    far each decision was from its boundary."""
    log_y = log_fx0 + rep[:, 0]
    l = x0 - w * rep[:, 1]
    r = l + w
    n_probe = torch.zeros_like(x0)

    # --- step out: both ends of every chain in one batched estimator call ---
    if max_step_out > 0:
        expand_l = torch.ones_like(x0, dtype=torch.bool)
        expand_r = torch.ones_like(x0, dtype=torch.bool)
        for _ in range(max_step_out):
            expanding = expand_l | expand_r
            if not bool(expanding.any()):  # host sync, see the module note
                break
            lps, _ = f2(torch.stack([l, r]))
            if probe_log is not None:
                probe_log.append((expand_l, lps[0] - log_y))
                probe_log.append((expand_r, lps[1] - log_y))
            expand_l = expand_l & (lps[0] > log_y)
            expand_r = expand_r & (lps[1] > log_y)
            l = torch.where(expand_l, l - w, l)
            r = torch.where(expand_r, r + w, r)
            n_probe = n_probe + 2.0 * expanding.to(x0.dtype)

    # --- shrinkage ---
    x, lp, ll = x0, log_fx0, torch.zeros_like(x0)
    done = torch.zeros_like(x0, dtype=torch.bool)
    for i in range(max_shrink):
        active = ~done
        if not bool(active.any()):  # host sync, see the module note
            break
        x_new = l + (r - l) * rep[:, 2 + i]
        lp_new, ll_new = f(x_new)
        ok = lp_new > log_y
        if probe_log is not None:
            probe_log.append((active, lp_new - log_y))
        l = torch.where(active & ~(ok | (x_new >= x0)), x_new, l)
        r = torch.where(active & ~(ok | (x_new < x0)), x_new, r)
        x = torch.where(active, x_new, x)
        lp = torch.where(active, lp_new, lp)
        ll = torch.where(active, ll_new, ll)
        n_probe = n_probe + active.to(x0.dtype)
        done = done | (active & ok)
    return (
        torch.where(done, x, x0),
        torch.where(done, lp, log_fx0),
        ll,
        done,
        n_probe,
    )


def make_slice_theta(target, n_sigma_extra=0):
    """Per-coordinate slice sampling of theta | u.

    ``n_sigma_extra`` (structure-aware targets only): repeat the LAST
    coordinate's update that many extra times per sweep.  For the GP target
    that is log_sigma, whose probes pay no factorisation."""
    structured = (target.coord_estimators_c is not None
                  or target.coord_estimators is not None)
    if n_sigma_extra and not structured:
        warnings.warn(
            "n_sigma_extra > 0 requires a target with coord_estimators "
            "(structure-aware per-coordinate probes); ignoring it for "
            f"target {target.name!r}"
        )
        n_sigma_extra = 0
    n_coords = target.d
    for factories in (target.coord_estimators_c, target.coord_estimators):
        if factories is not None and len(factories) != n_coords:
            raise ValueError(
                f"target {target.name!r} has {len(factories)} coordinate "
                f"factories for d={n_coords}")
    sigma_reps = 1 + n_sigma_extra
    # AUXPM_SIGMA_SWEEP=0 disables the whole-sigma-slice sweep (A/B runs):
    # the log_sigma updates then take the per-probe path.  Read when the
    # step is built, as the reference reads it and as ess_u reads
    # AUXPM_ESS_SWEEP
    sigma_sweep_fn = None
    if (target.sigma_sweep_factory is not None
            and os.environ.get("AUXPM_SIGMA_SWEEP", "1") != "0"):
        sigma_sweep_fn = target.sigma_sweep_factory(sigma_reps)

    def draw(state: ChainState, params=None):
        """One ``rep (B, reps_i, 2 + 32)`` per coordinate i, each row [log U
        (height), U1 (interval placement), 32 shrink uniforms], from each
        chain's key as the reference draws them: ``key, *coord_keys =
        split(key, d + 1)``, a repeat r > 0 of the last coordinate from
        ``fold_in(coord_key, r)``, each row from ``keyed_rep``.  Stepping out
        draws nothing of its own.  Returns the advanced keys too."""
        del params
        k = prng.split(state.key, n_coords + 1)
        coord = k[:, 1:]                   # one key per coordinate's row
        if sigma_reps > 1:                 # the last coordinate's repeats
            coord = torch.cat([coord, prng.fold_in(
                coord[:, -1:], torch.arange(1, sigma_reps,
                                            device=coord.device))], dim=1)
        reps = keyed_rep(coord)            # every row in one draw
        last = n_coords - 1
        return (tuple(reps[:, i:i + 1] for i in range(last))
                + (reps[:, last:].contiguous(),), k[:, 0])

    def apply(state: ChainState, rows: tuple, params: dict):
        max_step_out = int(params.get("max_step_out", 8))
        max_shrink = int(params.get("max_shrink", MAX_SHRINK))
        max_shrink_chol = int(params.get("max_shrink_chol", max_shrink))
        if max(max_shrink, max_shrink_chol) > MAX_SHRINK:
            raise ValueError(
                f"max_shrink={max_shrink} / max_shrink_chol={max_shrink_chol}"
                f": a row carries {MAX_SHRINK} shrink uniforms")
        widths = torch.as_tensor(
            params.get("widths", 1.0), dtype=state.theta.dtype,
            device=state.theta.device,
        ).expand(target.d)

        theta = state.theta
        log_lik = state.log_lik_hat
        log_post = target.log_prior(theta) + log_lik
        n_probe_total = torch.zeros_like(log_lik)
        n_probe_chol = torch.zeros_like(log_lik)
        cache = state.extras.get("target_cache")
        new_extras = state.extras

        def update(i, rep, f, f2, cap):
            """One 1-D update of coordinate i on (theta, log_post, log_lik)."""
            x_new, lp_new, ll_new, done, n_probe = _slice_1d(
                rep, theta[:, i], log_post, f, f2, widths[i], max_step_out,
                cap, params.get("probe_log"))
            return (set_coord(theta, i, x_new), lp_new,
                    torch.where(done, ll_new, log_lik), n_probe)

        cached = target.coord_estimators_c is not None and cache is not None
        if cached or target.coord_estimators is not None:
            last = n_coords - 1
            for i in range(n_coords):
                if cached and i == last:
                    # the ell coordinates are final: refresh the carried
                    # factor at the post-ell theta (the ONE extra
                    # factorisation of this path); it feeds the log_sigma
                    # probes now and the ESS prepare of the next step
                    cache = target.cache_init(theta)
                    if sigma_sweep_fn is not None and max_step_out == 0:
                        sig_new, log_lik, log_post, n_sh, _moved = \
                            sigma_sweep_fn(theta, state.u, cache, log_lik,
                                           log_post, widths[last], rows[last])
                        theta = set_coord(theta, last, sig_new)
                        n_probe_total = n_probe_total + n_sh
                        continue
                if cached:
                    f, f2 = target.coord_estimators_c[i](theta, state.u, cache)
                else:
                    f, f2 = target.coord_estimators[i](theta, state.u)
                # the factory closes over the OTHER coordinates only, so it
                # stays valid across repeats of its own coordinate
                for rep in range(sigma_reps if i == last else 1):
                    theta, log_post, log_lik, n_probe = update(
                        i, rows[i][:, rep], f, f2,
                        max_shrink if i == last else max_shrink_chol)
                    n_probe_total = n_probe_total + n_probe
                    if i != last:
                        n_probe_chol = n_probe_chol + n_probe
            if cached:
                new_extras = {**state.extras, "target_cache": cache}
        else:
            for i in range(n_coords):
                f, f2 = full_coord_probes(target.log_prior,
                                          target.log_lik_est, theta, state.u,
                                          i)
                theta, log_post, log_lik, n_probe = update(
                    i, rows[i][:, 0], f, f2, max_shrink)
                n_probe_total = n_probe_total + n_probe
            # every probe paid the full estimator
            n_probe_chol = n_probe_total

        if cache is not None and new_extras is state.extras:
            # a branch that does not know the cache ran while one was
            # carried: refresh so that cache == cache_init(theta) holds
            new_extras = refresh_target_cache(target, state.extras, theta)
        new_state = state.replace(theta=theta, log_lik_hat=log_lik,
                                  extras=new_extras)
        info = {"n_probe": n_probe_total, "n_probe_chol": n_probe_chol}
        return new_state, info

    return keyed(draw, apply)


def keyed_rep(keys):
    """One ``_slice_1d`` row per key ``(..., 2)`` as the reference's
    ``_slice_1d`` draws it: ``k_h, k_init, k_loop = split(key, 3)``, [log
    uniform(k_h), uniform(k_init), uniform(fold_in(k_loop, j)) for j < 32]:
    ``(..., 2 + 32)``, all 34 uniforms in one draw."""
    k = prng.split(keys, 3)
    shrink = prng.fold_in(k[..., 2, None, :],
                          torch.arange(MAX_SHRINK, device=keys.device))
    rep = prng.uniform(torch.cat([k[..., :2, :], shrink], dim=-2))
    rep[..., 0] = torch.log(rep[..., 0])
    return rep


def unit_directions(keys, d):
    """One N(0, I) direction of length ``d`` per key ``(B, 2)``, normalised:
    ``(B, d)``."""
    e = prng.normal(keys, (d,))
    return e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)


def make_slice_theta_rd(target):
    """Random-direction slice sampling of theta | u (one 1-D update per
    step).  The bracket is the scalar ``mean(widths)``.  Info: ``n_probe``
    and ``moved`` (the update was accepted)."""

    def draw(state: ChainState, params=None):
        """``direction (B, d)`` unit vectors and ``rep (B, 2 + 32)``, as the
        reference draws them: ``key, k_dir, k_slice = split(key, 3)``.
        Returns the advanced keys too."""
        del params
        k = prng.split(state.key, 3)
        return ({"direction": unit_directions(k[:, 1], target.d),
                 "rep": keyed_rep(k[:, 2])}, k[:, 0])

    def apply(state: ChainState, rows: dict, params: dict):
        max_step_out = int(params.get("max_step_out", 8))
        max_shrink = int(params.get("max_shrink", MAX_SHRINK))
        if max_shrink > MAX_SHRINK:
            raise ValueError(f"max_shrink={max_shrink}: a row carries "
                             f"{MAX_SHRINK} shrink uniforms")
        theta0, e = state.theta, rows["direction"]
        width = torch.as_tensor(
            params.get("widths", 1.0), dtype=theta0.dtype,
            device=theta0.device).expand(target.d).mean()
        log_post0 = target.log_prior(theta0) + state.log_lik_hat

        def f(t):
            th = theta0 + t[:, None] * e
            ll = target.log_lik_est(th, state.u)
            return target.log_prior(th) + ll, ll

        u2 = []

        def f2(ts):
            if not u2:
                u2.append(torch.cat([state.u, state.u]))
            th = (theta0[None] + ts[:, :, None] * e[None]).reshape(
                -1, target.d)
            ll = target.log_lik_est(th, u2[0])
            return (target.log_prior(th) + ll).view(2, -1), ll.view(2, -1)

        t_new, _lp, ll_new, done, n_probe = _slice_1d(
            rows["rep"], torch.zeros_like(log_post0), log_post0, f, f2,
            width, max_step_out, max_shrink, params.get("probe_log"))
        theta_new = theta0 + t_new[:, None] * e
        new_state = state.replace(
            theta=theta_new,
            log_lik_hat=torch.where(done, ll_new, state.log_lik_hat),
            extras=refresh_target_cache(target, state.extras, theta_new),
        )
        return new_state, {"n_probe": n_probe,
                           "moved": done.to(torch.float32)}

    return keyed(draw, apply)
