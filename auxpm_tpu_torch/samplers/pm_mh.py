"""Pseudo-marginal Metropolis-Hastings (Andrieu & Roberts 2009).

Counterpart of ``auxpm_tpu/samplers/pm_mh.py``:

    theta' = theta + step_size * N(0, I_d)      (random-walk proposal)
    u'     ~ N(0, I)                            (FRESH auxiliary draws)
    log a  = log p(theta') + log L̂(theta',u') - log p(theta) - log L̂(theta,u)
    accept iff log Uniform < log a              (symmetric q cancels)

The defining PM-MH move is the fresh ``u'`` each proposal: the estimate is
re-drawn jointly with theta, so the chain targets the exact marginal but can
stick when an upward-noise L̂ is locked into the accepted state (the
pathology the auxiliary updates fix; Murray & Graham 2016 section 2).

The proposal's estimate runs at a fresh theta' and u' with no carried factor:
``target.log_lik_est`` (for the GP target one batched factorisation and one
estimator call per step).  The accept is a per-chain ``torch.where``.

Params:
  step_size: scalar or (d,) random-walk scale.
"""

from __future__ import annotations

import torch

from auxpm_tpu_torch.core import prng
from auxpm_tpu_torch.core.state import (
    ChainState,
    make_u_normal,
    refresh_target_cache,
)
from auxpm_tpu_torch.core.transition import keyed


def random_walk_move(target, state: ChainState, eps, log_unif, step_size,
                     u_prop):
    """The shared Metropolis move of PM-MH and MH on theta: propose
    ``theta + step_size * eps`` with ``u_prop``, accept per chain where
    ``log_unif < log a``.  Returns ``(state', accept (B,) bool, log a)``."""
    step_size = torch.as_tensor(step_size, dtype=state.theta.dtype,
                                device=state.theta.device)
    theta_p = state.theta + step_size * eps
    log_lik_p = target.log_lik_est(theta_p, u_prop)
    log_accept = (target.log_prior(theta_p) + log_lik_p
                  - target.log_prior(state.theta) - state.log_lik_hat)
    accept = log_unif < log_accept
    theta_new = torch.where(accept[:, None], theta_p, state.theta)
    u_new = state.u if u_prop is state.u else torch.where(
        accept[:, None, None], u_prop, state.u)
    new_state = state.replace(
        theta=theta_new,
        u=u_new,
        log_lik_hat=torch.where(accept, log_lik_p, state.log_lik_hat),
        extras=refresh_target_cache(target, state.extras, theta_new),
    )
    return new_state, accept, log_accept


def make_pm_mh(target, particle_axis=None):
    """``particle_axis``: this rank's ``parallel.mesh.Mesh`` when ``target``
    is particle sharded: the fresh u' then covers this rank's rows (the
    rows the unsharded state would draw there, ``core/state.make_u_normal``);
    every other draw is replicated over the particle group."""
    if particle_axis is not None:
        from auxpm_tpu_torch.parallel.mesh import require_mesh

        require_mesh(particle_axis)
    draw_u = make_u_normal(target, particle_axis)

    def draw(state: ChainState, params=None):
        """``eps (B, d)`` proposal noise, ``u (B, S, n)`` fresh rows and
        ``log_unif (B,)``, as the reference draws them: ``key, k_prop, k_u,
        k_acc = split(key, 4)``.  Returns the advanced keys too."""
        del params
        k = prng.split(state.key, 4)
        return ({"eps": prng.normal(k[:, 1], (state.theta.shape[1],)),
                 "u": draw_u(k[:, 2], state.u.shape[1]),
                 "log_unif": torch.log(prng.uniform(k[:, 3]))}, k[:, 0])

    def apply(state: ChainState, rows: dict, params: dict):
        new_state, accept, log_accept = random_walk_move(
            target, state, rows["eps"], rows["log_unif"],
            params.get("step_size", 0.5), rows["u"])
        info = {"accept": accept.to(torch.float32),
                "log_accept_ratio": torch.clamp(log_accept, max=0.0)}
        return new_state, info

    return keyed(draw, apply)
