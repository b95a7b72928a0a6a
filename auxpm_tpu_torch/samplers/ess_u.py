"""Elliptical slice update of the auxiliary draws u | theta.

Counterpart of ``auxpm_tpu/samplers/ess_u.py`` (its whole-sweep path).
Murray, Adams & MacKay (2010) ESS applied to the auxiliary block:

    v ~ N(0, I);  log_y = log L̂(theta, u) + log Uniform(0,1)
    a ~ U(0, 2 pi); bracket = [a - 2 pi, a]
    while log L̂(theta, u cos a + v sin a) <= log_y:
        shrink bracket toward 0; redraw a
    u <- u cos a + v sin a

Rejection-free and tuning-free; the rotation preserves the N(0, I) prior on u
exactly.  The shrink cap (32) is a safety net: on cap-hit the state is kept.

All ``n_repeats`` updates of a step, every probe included, run as ONE call of
the target's sweep (``ops/ess_sweep.py``) off the prepared factor, which is
taken from the carried cache when the state has one (theta is fixed for the
whole sweep, so the step pays no Cholesky).  The per-probe loop path of the
reference is not ported yet.
"""

from __future__ import annotations

import math

import torch

from auxpm_tpu_torch.core.state import ChainState, make_u_normal
from auxpm_tpu_torch.ops.ess_sweep import MAX_SHRINK

_TWO_PI = 2.0 * math.pi


def make_ess_u(target, particle_axis=None, n_repeats=1):
    if particle_axis is not None:
        raise NotImplementedError(
            "particle sharding is not ported yet; see ROADMAP.md"
        )
    if target.ess_sweep_factory is None:
        raise NotImplementedError(
            "the per-probe loop path of the ESS update is not ported yet "
            "(the target has no ess_sweep_factory); see ROADMAP.md"
        )
    sweep = target.ess_sweep_factory(n_repeats)
    draw_v = make_u_normal(target)

    def _prepare(state):
        cache = state.extras.get("target_cache")
        if cache is not None and target.prepare_c is not None:
            return target.prepare_c(state.theta, cache)
        return target.prepare(state.theta)

    def draw(generator, state: ChainState):
        """Rows of one sweep: ``scal (B, R, 3 + 32)`` = per repeat [ll0
        (repeat 0 only), log U, a0, 32 shrink uniforms] and
        ``v (B, R, S, n)``."""
        b = state.u.shape[0]
        dev = state.u.device
        v = draw_v(generator, (b, n_repeats, *state.u.shape[1:]))
        unif = torch.rand((b, n_repeats, 2 + MAX_SHRINK), generator=generator,
                          dtype=torch.float32, device=dev)
        scal = torch.empty((b, n_repeats, 3 + MAX_SHRINK),
                           dtype=torch.float32, device=dev)
        scal[:, :, 0] = 0.0
        scal[:, 0, 0] = state.log_lik_hat
        scal[:, :, 1] = torch.log(unif[:, :, 0])
        scal[:, :, 2] = unif[:, :, 1] * _TWO_PI
        scal[:, :, 3:] = unif[:, :, 2:]
        return {"scal": scal, "v": v}

    def apply(state: ChainState, rows: dict, params: dict):
        del params  # tuning-free
        u, ll, n_shrink_total, moved_total = sweep(
            _prepare(state), state.u, rows["scal"], rows["v"])
        new_state = state.replace(u=u, log_lik_hat=ll)
        info = {
            "n_shrink": n_shrink_total / n_repeats,
            "moved": moved_total / n_repeats,
        }
        return new_state, info

    def step(state: ChainState, params: dict):
        return apply(state, draw(state.generator, state), params)

    step.draw = draw
    step.apply = apply
    step.uses_sweep = True
    return step
