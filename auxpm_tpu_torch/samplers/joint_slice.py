"""Joint (theta, u) updates: moving parameters and auxiliaries together.

Counterpart of ``auxpm_tpu/samplers/joint_slice.py`` (Murray & Graham 2016
section 4's joint-update family), batched over chains.

Joint slice (``make_joint_slice``).  With v ~ N(0, I), a random unit
direction e in theta-space and the rotation rate c = angle_scale / width,
the flow

    T_t(theta, u, v) = (theta + t e, u cos(ct) + v sin(ct), v cos(ct) - u sin(ct))

is a volume-preserving group that leaves N(u) N(v) invariant, so along the
orbit the augmented target varies only through

    h(t) = p(theta + t e) L̂(theta + t e, u cos(ct) + v sin(ct)),

and a Neal (2003) slice update of t (``slice_theta._slice_1d``: stepping out,
then shrinkage toward t = 0) is a valid update of the joint chain.  Every
probe is one ``target.log_lik_est`` call at its own (theta, u); the step-out
probe scores both ends of every chain, two different u's each, as ONE batch
of 2B.  A chain takes the new (theta, u, log L̂) only where the update was
accepted.

Joint MH (``make_joint_mh``).  Random walk on theta with a
preconditioned-Crank-Nicolson move on u:

    theta' = theta + s xi,   u' = u cos(rho) + v sin(rho),  v ~ N(0, I).

The pCN rotation is reversible w.r.t. N(u), so the acceptance is
min(1, p(theta') L̂(theta', u') / (p(theta) L̂(theta, u))); rho = pi/2 is
PM-MH, small rho keeps the estimator noise correlated between the two sides.

Both draw from each chain's key as the reference splits it, v through
``core/state.make_u_normal`` as ``ess_u`` draws its v, so a particle-sharded
chain draws the rows the unsharded chain draws there; every other draw is
replicated over the particle group.  Both refresh a carried factor at the new
theta (``core/state.refresh_target_cache``).

Params (groups "joint_slice" / "joint_mh"):
  width: slice bracket along the theta direction (scalar, default 1).
  angle_scale: u-rotation (radians) per ``width`` of theta motion (pi/2).
  max_step_out / max_shrink: loop caps, as in slice_theta (8 / 32).
  step_size: joint-MH random-walk scale (0.3).
  rho: joint-MH u-rotation angle (0.3).
  probe_log: optional list, as in slice_theta (joint MH: its one accept
    decision, ``(all chains, log a - log U)``).
"""

from __future__ import annotations

import math

import torch

from auxpm_tpu_torch.core import prng
from auxpm_tpu_torch.core.state import (
    ChainState,
    make_u_normal,
    refresh_target_cache,
)
from auxpm_tpu_torch.core.transition import keyed
from auxpm_tpu_torch.samplers.slice_theta import (
    MAX_SHRINK,
    _slice_1d,
    keyed_rep,
    unit_directions,
)


def _require_mesh(particle_axis):
    if particle_axis is not None:
        from auxpm_tpu_torch.parallel.mesh import require_mesh

        require_mesh(particle_axis)


def _scalar(params, key, default, like):
    return torch.as_tensor(params.get(key, default), dtype=like.dtype,
                           device=like.device)


def _accepted(state, target, mask, theta_p, u_p, ll_p):
    """The state with (theta, u, log L̂) replaced where ``mask (B,)``."""
    theta = torch.where(mask[:, None], theta_p, state.theta)
    return state.replace(
        theta=theta,
        u=torch.where(mask[:, None, None], u_p, state.u),
        log_lik_hat=torch.where(mask, ll_p, state.log_lik_hat),
        extras=refresh_target_cache(target, state.extras, theta),
    )


def make_joint_slice(target, particle_axis=None):
    """``particle_axis``: this rank's ``parallel.mesh.Mesh`` when ``target``
    is particle sharded (v then covers this rank's rows)."""
    _require_mesh(particle_axis)
    draw_v = make_u_normal(target, particle_axis)

    def draw(state: ChainState, params=None):
        """``direction (B, d)``, ``v (B, S, n)`` and ``rep (B, 2 + 32)``:
        ``key, k_dir, k_v, k_slice = split(key, 4)``.  Returns the advanced
        keys too."""
        del params
        k = prng.split(state.key, 4)
        return ({"direction": unit_directions(k[:, 1], target.d),
                 "v": draw_v(k[:, 2], state.u.shape[1]),
                 "rep": keyed_rep(k[:, 3])}, k[:, 0])

    def apply(state: ChainState, rows: dict, params: dict):
        max_step_out = int(params.get("max_step_out", 8))
        max_shrink = int(params.get("max_shrink", MAX_SHRINK))
        if max_shrink > MAX_SHRINK:
            raise ValueError(f"max_shrink={max_shrink}: a row carries "
                             f"{MAX_SHRINK} shrink uniforms")
        theta0, u0 = state.theta, state.u
        e, v = rows["direction"], rows["v"]
        width = _scalar(params, "width", 1.0, theta0)
        rate = _scalar(params, "angle_scale", math.pi / 2, theta0) / width
        log_post0 = target.log_prior(theta0) + state.log_lik_hat

        def path(t):
            """(theta, u) at steps ``t`` of shape (B,) or (2, B)."""
            a = (rate * t)[..., None, None]
            th = theta0 + t[..., None] * e
            return th, u0 * torch.cos(a) + v * torch.sin(a)

        def f(t):
            th, ut = path(t)
            ll = target.log_lik_est(th, ut)
            return target.log_prior(th) + ll, ll

        def f2(ts):
            th, ut = path(ts)
            th = th.reshape(-1, target.d)
            ll = target.log_lik_est(th, ut.reshape(-1, *u0.shape[1:]))
            return (target.log_prior(th) + ll).view(2, -1), ll.view(2, -1)

        t_new, _lp, ll_new, done, n_probe = _slice_1d(
            rows["rep"], torch.zeros_like(log_post0), log_post0, f, f2,
            width, max_step_out, max_shrink, params.get("probe_log"))
        th_new, u_new = path(t_new)
        new_state = _accepted(state, target, done, th_new, u_new, ll_new)
        return new_state, {"n_probe": n_probe,
                           "moved": done.to(torch.float32)}

    return keyed(draw, apply)


def make_joint_mh(target, particle_axis=None):
    """``particle_axis`` as in ``make_joint_slice``."""
    _require_mesh(particle_axis)
    draw_v = make_u_normal(target, particle_axis)

    def draw(state: ChainState, params=None):
        """``xi (B, d)``, ``v (B, S, n)`` and ``log_unif (B,)``: ``key, k_xi,
        k_v, k_acc = split(key, 4)``.  Returns the advanced keys too."""
        del params
        k = prng.split(state.key, 4)
        return ({"xi": prng.normal(k[:, 1], (state.theta.shape[1],)),
                 "v": draw_v(k[:, 2], state.u.shape[1]),
                 "log_unif": torch.log(prng.uniform(k[:, 3]))}, k[:, 0])

    def apply(state: ChainState, rows: dict, params: dict):
        s = _scalar(params, "step_size", 0.3, state.theta)
        rho = _scalar(params, "rho", 0.3, state.theta)
        theta_p = state.theta + s * rows["xi"]
        u_p = state.u * torch.cos(rho) + rows["v"] * torch.sin(rho)
        ll_p = target.log_lik_est(theta_p, u_p)
        log_a = (target.log_prior(theta_p) + ll_p
                 - target.log_prior(state.theta) - state.log_lik_hat)
        accept = rows["log_unif"] < log_a
        probe_log = params.get("probe_log")
        if probe_log is not None:
            probe_log.append((torch.ones_like(accept),
                              log_a - rows["log_unif"]))
        new_state = _accepted(state, target, accept, theta_p, u_p, ll_p)
        return new_state, {"accept": accept.to(torch.float32)}

    return keyed(draw, apply)
