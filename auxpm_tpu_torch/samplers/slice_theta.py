"""Linear slice sampling of theta | u (Neal 2003), shrinkage-only variant.

Counterpart of ``auxpm_tpu/samplers/slice_theta.py`` (``make_slice_theta``,
its carried-factor branch).  With u part of the chain state,

    f(theta') = log p(theta') + log L̂(theta', u)

is a deterministic function of theta', so the pseudo-marginal problem is a
plain slice-sampling problem.  Per 1-D update (Neal 2003, 4.1 and 5):

    log_y = f(theta) + log U
    l = x0 - w U1; r = l + w            (no stepping out)
    repeat: x ~ U(l, r)
            if f(x) > log_y: accept
            elif x < x0: l = x else r = x        (shrink)

Per step, for the GP target theta = [log_ell, log_sigma]:

- log_ell: every probe factors its own Gram; a BATCHED Python loop over
  shrink iterations with a per-chain ``done`` mask, capped at
  ``max_shrink_chol`` (cap-hit keeps the current value, an exact no-op);
- the carried factor is refreshed ONCE at the post-ell theta, outside the
  loop;
- log_sigma: all ``1 + n_sigma_extra`` updates in one call of the target's
  sweep (``ops/sigma_sweep.py``) off that factor.

Host synchronisations: the log_ell loop reads one flag per shrink iteration
(``done.all()``, at most ``max_shrink_chol`` per step) to stop early; a later
change can drop the early exit or move the loop into device code.

Stepping out (``max_step_out > 0``), the per-probe log_sigma path and the
random-direction variant of the reference are not ported yet and raise.

Params:
  widths: (d,) bracket widths w.
  max_step_out: must be 0 here.
  max_shrink_chol: shrink cap of the log_ell coordinate (default 32).
"""

from __future__ import annotations

import torch

from auxpm_tpu_torch.core.state import ChainState
from auxpm_tpu_torch.ops.sigma_sweep import MAX_SHRINK

REP_COLS = 2 + MAX_SHRINK


def _slice_1d_shrink(rep, x0, log_fx0, f, w, max_shrink):
    """One batched shrinkage-only 1-D slice update.

    ``rep (B, 2 + 32)`` = [log U, U1, shrink uniforms]; ``f(x (B,)) ->
    (log_post, log_lik)``.  Returns ``(x_new, log_post_new, log_lik_new,
    done, n_probe)``; ``log_lik_new`` is valid only where ``done``."""
    log_y = log_fx0 + rep[:, 0]
    l = x0 - w * rep[:, 1]
    r = l + w
    x, lp, ll = x0, log_fx0, torch.zeros_like(x0)
    done = torch.zeros_like(x0, dtype=torch.bool)
    n_probe = torch.zeros_like(x0)
    for i in range(max_shrink):
        active = ~done
        if not bool(active.any()):  # host sync, see the module note
            break
        x_new = l + (r - l) * rep[:, 2 + i]
        lp_new, ll_new = f(x_new)
        ok = lp_new > log_y
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
    """Per-coordinate slice sampling of theta | u on the carried-factor path.

    ``n_sigma_extra``: repeat the log_sigma update that many extra times per
    sweep; the repeats share the sweep call and cost no Cholesky."""
    if target.coord_estimators_c is None or target.sigma_sweep_factory is None:
        raise NotImplementedError(
            "make_slice_theta needs a target with the carried-factor "
            "protocol (coord_estimators_c, sigma_sweep_factory); the generic "
            "per-coordinate path is not ported yet, see ROADMAP.md"
        )
    n_coords = len(target.coord_estimators_c)
    sigma_reps = 1 + n_sigma_extra
    sigma_sweep_fn = target.sigma_sweep_factory(sigma_reps)

    def draw(generator, state: ChainState):
        """One ``rep (B, reps_i, 2 + 32)`` per coordinate i, each row
        [log U (height), U1 (interval placement), 32 shrink uniforms]."""
        b = state.theta.shape[0]
        rows = []
        for i in range(n_coords):
            reps = sigma_reps if i == n_coords - 1 else 1
            rep = torch.rand((b, reps, REP_COLS), generator=generator,
                             dtype=torch.float32, device=state.theta.device)
            rep[:, :, 0] = torch.log(rep[:, :, 0])
            rows.append(rep)
        return tuple(rows)

    def apply(state: ChainState, rows: tuple, params: dict):
        max_step_out = params.get("max_step_out", 8)
        if max_step_out != 0:
            raise NotImplementedError(
                f"max_step_out={max_step_out}: stepping out is not ported "
                "yet, only the shrinkage-only variant (max_step_out=0); see "
                "ROADMAP.md"
            )
        cache = state.extras.get("target_cache")
        if cache is None:
            raise NotImplementedError(
                "the uncached slice path is not ported yet: initialise the "
                "chains with with_cache=True; see ROADMAP.md"
            )
        max_shrink_chol = params.get("max_shrink_chol",
                                     params.get("max_shrink", MAX_SHRINK))
        widths = torch.as_tensor(
            params.get("widths", 1.0), dtype=state.theta.dtype,
            device=state.theta.device,
        ).expand(target.d)

        theta = state.theta
        log_lik = state.log_lik_hat
        log_post = target.log_prior(theta) + log_lik
        n_probe_total = torch.zeros_like(log_lik)
        n_probe_chol = torch.zeros_like(log_lik)
        for i in range(n_coords - 1):
            f = target.coord_estimators_c[i](theta, state.u, cache)
            x_new, log_post, ll_new, done, n_probe = _slice_1d_shrink(
                rows[i][:, 0], theta[:, i], log_post, f, widths[i],
                max_shrink_chol,
            )
            theta = torch.cat(
                [theta[:, :i], x_new[:, None], theta[:, i + 1:]], dim=1)
            log_lik = torch.where(done, ll_new, log_lik)
            n_probe_total = n_probe_total + n_probe
            n_probe_chol = n_probe_chol + n_probe
        # the ell coordinate is final: refresh the carried factor at the
        # post-ell theta (the ONE extra factorisation of this path); it feeds
        # the sigma sweep now and the ESS prepare of the next step
        cache = target.cache_init(theta)
        last = n_coords - 1
        sig_new, log_lik, log_post, n_sh, _moved = sigma_sweep_fn(
            theta, state.u, cache, log_lik, log_post, widths[last], rows[last]
        )
        theta = torch.cat([theta[:, :last], sig_new[:, None]], dim=1)
        n_probe_total = n_probe_total + n_sh

        new_state = state.replace(
            theta=theta, log_lik_hat=log_lik,
            extras={**state.extras, "target_cache": cache},
        )
        info = {"n_probe": n_probe_total, "n_probe_chol": n_probe_chol}
        return new_state, info

    def step(state: ChainState, params: dict):
        return apply(state, draw(state.generator, state), params)

    step.draw = draw
    step.apply = apply
    return step
