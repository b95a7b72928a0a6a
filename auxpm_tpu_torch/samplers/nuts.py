"""Multinomial NUTS (No-U-Turn Sampler), iterative and batched.

Counterpart of ``auxpm_tpu/samplers/nuts.py``: Hoffman & Gelman (2014) Alg. 3
with Betancourt (2017) multinomial sampling and biased progressive tree
sampling, with no recursion.  A subtree of 2^d leaves is built by a loop of
leapfrog steps; the recursive algorithm's internal-node U-turn checks are
reproduced with the checkpoint trick: leaf i with i even is stored in slot
``popcount(i)``, and on completing leaf i every span of size 2^k ending at i
(k = 1..ctz(i+1)) is checked against its left end in slot
``popcount(i + 1 - 2^k)``.  For a span integrated in direction v the
time-ordered displacement is v (z_later - z_earlier) (leapfrog with -eps
follows the orbit backwards with forward momenta), so those dot products are
scaled by v; the whole-trajectory check needs no scaling.

Batching.  Within a subtree every chain still going at depth d takes exactly
2^d leaves, as in the reference's ``fori_loop``, so the chains run in
lockstep per depth and the checkpoint slots are the same for all of them.
A chain leaves the outer loop on a U-turn, a divergence or ``max_depth``.
Before each depth the chains still going are gathered (one host sync per
depth, at most ``max_depth`` per step), so finished chains cost no gradient
evaluation, and the results are scattered back.  A chain's values do not
depend on the other chains of a call, so the gather changes no value.

Randomness.  ``draw`` gives a fixed table per chain: the momentum draw
``r0 (d,)``; per depth the direction (+1 / -1) and the uniform of the biased
take between the old tree and the new subtree; per depth and leaf the
uniform of the in-subtree multinomial take, ``(max_depth,
2^(max_depth-1))``.  ``apply`` is deterministic given the table, so a test
can feed the reference's own draws (``split(key, 3)``; per depth
``split(kkey, 4)``; per leaf ``uniform(fold_in(ks, s))``).

The proposal is exact multinomial sampling over the trajectory (no MH
accept); ``accept_prob`` in the info is the Stan-style mean Metropolis
statistic that dual averaging reads.

Targets: those of ``samplers/hmc.py`` (the GP target with either proposal,
isotropic or ARD, and the toy, each also particle sharded; the MVN),
through its ``value_and_grad``, which counts the gradient calls
(``hmc.grad_calls``) and the collectives entered inside them
(``hmc.grad_collectives``; 2 per call on a sharded GP target).  On a
particle-sharded target every rank computes bitwise the same trajectories,
so the U-turn and divergence tests and the gathers of the chains still
going agree across the group.

Factory args:
  max_depth: maximum tree depth (default 8: at most 255 gradient
    evaluations per step).
Params:
  step_size: leapfrog step size, scalar or per-chain ``(B,)``.
  inv_mass: diagonal inverse mass, scalar or ``(d,)``.
"""

from __future__ import annotations

import torch

from auxpm_tpu_torch.core import prng
from auxpm_tpu_torch.core.state import ChainState, refresh_target_cache
from auxpm_tpu_torch.core.transition import keyed
from auxpm_tpu_torch.samplers import hmc
from auxpm_tpu_torch.samplers.hmc import (
    inv_mass_vector,
    kinetic,
    leapfrog,
    per_chain,
    value_and_grad,
)

_DIVERGENCE = 1000.0


def _popcount(x):
    return bin(x).count("1")


def _ctz(x):
    """Count trailing zeros of x > 0."""
    return (x & -x).bit_length() - 1


def _uturn_dots(z_minus, r_minus, z_plus, r_plus, inv_mass):
    """The two dot products of the U-turn test; a U-turn if either is < 0."""
    dz = z_plus - z_minus
    return (dz * (inv_mass * r_minus)).sum(-1), (dz * (inv_mass * r_plus)).sum(-1)


def _uturn(z_minus, r_minus, z_plus, r_plus, inv_mass):
    a, b = _uturn_dots(z_minus, r_minus, z_plus, r_plus, inv_mass)
    return (a < 0.0) | (b < 0.0)


def make_nuts(target, max_depth=8):

    def draw(state: ChainState, params=None):
        """``r0 (B, d)`` ~ N(0, I) (scaled by ``inv_mass^-1/2`` in
        ``apply``), ``direction (B, max_depth)`` of +1 / -1, ``u_biased (B,
        max_depth)`` and ``leaf_keys (B, max_depth, 2)``, from each chain's
        key as the reference draws them: ``key, k_mom, k_loop = split(key,
        3)``, then per depth ``kd, kb, ks, k_loop = split(k_loop, 4)``, the
        direction ``bernoulli(kd)``, ``uniform(kb)`` and the subtree's key
        ``ks``, whose leaf s takes ``uniform(fold_in(ks, s))``; ``apply``
        draws a depth's 2^depth leaves when the trajectory gets there (a
        table of every leaf would be 2^(max_depth - 1) draws per depth,
        nearly all unused).  Returns the advanced keys too."""
        del params
        keys = state.key
        k = prng.split(keys, 3)
        k_loop, per_depth = k[:, 2], []
        for _ in range(max_depth):
            kk = prng.split(k_loop, 4)
            per_depth.append(kk[:, :3])
            k_loop = kk[:, 3]
        kd = torch.stack(per_depth, dim=1)        # (B, max_depth, 3, 2)
        u_db = prng.uniform(kd[:, :, :2])
        return ({
            "r0": prng.normal(k[:, 1], (state.theta.shape[1],)),
            # bernoulli(kd) is uniform(kd) < 0.5: both uniforms in one draw
            "direction": torch.where(u_db[:, :, 0] < 0.5, 1.0, -1.0),
            "u_biased": u_db[:, :, 1].contiguous(),
            "leaf_keys": kd[:, :, 2].contiguous()}, k[:, 0])

    def apply(state: ChainState, rows: dict, params: dict):
        theta = state.theta
        b = theta.shape[0]
        dev, dt = theta.device, theta.dtype
        eps = per_chain(params.get("step_size", 0.1), b, theta)
        inv_mass = inv_mass_vector(params.get("inv_mass", 1.0), theta)
        # optional ``params["probe_log"]``: a list that collects (kind,
        # chains, margin) of every decision: the takes ("take", in
        # probability) and the U-turn tests ("uturn", a dot product over its
        # norms)
        probe_log = params.get("probe_log")
        vg = value_and_grad(target, state.u)

        pe0, g0 = vg(theta)
        r0 = rows["r0"] / torch.sqrt(inv_mass)
        h0 = pe0 + kinetic(inv_mass, r0)

        # per-chain state of the outer doubling loop (the reference's carry)
        zm, rm, gm = theta, r0, g0
        zp, rp, gp = theta, r0, g0
        z_prop, pe_prop = theta, pe0
        lsw = torch.zeros(b, dtype=dt, device=dev)   # log 1: the start point
        sum_met = torch.zeros(b, dtype=dt, device=dev)
        n_met = torch.zeros(b, dtype=dt, device=dev)
        depth = torch.zeros(b, dtype=dt, device=dev)
        turn = torch.zeros(b, dtype=torch.bool, device=dev)
        div = torch.zeros(b, dtype=torch.bool, device=dev)

        def log_margin(kind, idx, margin_fn, counted=None):
            """Log ``margin_fn()`` of the chains ``idx`` (those of them in
            ``counted``), computed only when there is a log."""
            if probe_log is None:
                return
            margin = margin_fn()
            if counted is not None:
                margin = torch.where(counted, margin,
                                     torch.full_like(margin, float("inf")))
            mask = torch.zeros(b, dtype=torch.bool, device=dev)
            full = torch.full((b,), float("inf"), dtype=dt, device=dev)
            probe_log.append((kind, mask.index_fill(0, idx, True),
                              full.index_copy(0, idx, margin)))

        def uturn_margin(za, ra, zb, rb):
            dz = zb - za
            dots = _uturn_dots(za, ra, zb, rb, inv_mass)
            norm = torch.linalg.vector_norm(dz, dim=-1)
            return torch.minimum(
                dots[0] / (norm * torch.linalg.vector_norm(inv_mass * ra,
                                                           dim=-1) + 1e-30),
                dots[1] / (norm * torch.linalg.vector_norm(inv_mass * rb,
                                                           dim=-1) + 1e-30))

        for dep in range(max_depth):
            going = ~turn & ~div
            idx = torch.nonzero(going).flatten()   # host sync: one per depth
            hmc.host_syncs += 1
            if idx.numel() == 0:
                break
            direction = rows["direction"][idx, dep]
            fwd = (direction > 0)[:, None]
            z0 = torch.where(fwd, zp[idx], zm[idx])
            r_ = torch.where(fwd, rp[idx], rm[idx])
            g_ = torch.where(fwd, gp[idx], gm[idx])
            e_dir = direction * eps[idx]
            h0_i = h0[idx]
            # this subtree's 2^dep leaves, from its key
            u_leaf = prng.uniform(prng.fold_in(
                rows["leaf_keys"][idx, dep, None],
                torch.arange(1 << dep, device=dev)))
            n_i = idx.shape[0]

            # ---- the subtree of 2^dep leaves, the chains in lockstep
            z = z0
            lsw_s = torch.full((n_i,), -float("inf"), dtype=dt, device=dev)
            zp_s, pep_s = z0, torch.zeros(n_i, dtype=dt, device=dev)
            sm_s = torch.zeros(n_i, dtype=dt, device=dev)
            turn_s = torch.zeros(n_i, dtype=torch.bool, device=dev)
            div_s = torch.zeros(n_i, dtype=torch.bool, device=dev)
            ckpt_z, ckpt_r = {}, {}
            for s in range(1 << dep):
                z, r_, g_, pe = leapfrog(z, r_, g_, e_dir, inv_mass, vg, idx)
                h = pe + kinetic(inv_mass, r_)
                log_w = h0_i - h
                log_w = torch.where(torch.isfinite(log_w), log_w,
                                    torch.full_like(log_w, -float("inf")))
                div_s = div_s | ((h - h0_i) > _DIVERGENCE) | ~torch.isfinite(h)
                sm_s = sm_s + torch.exp(torch.clamp(log_w, max=0.0))
                new_lsw = torch.logaddexp(lsw_s, log_w)
                p_take = torch.exp(log_w - torch.where(
                    torch.isfinite(new_lsw), new_lsw, torch.zeros_like(new_lsw)))
                take = u_leaf[:, s] < p_take
                log_margin("take", idx, lambda: u_leaf[:, s] - p_take)
                zp_s = torch.where(take[:, None], z, zp_s)
                pep_s = torch.where(take, pe, pep_s)
                lsw_s = new_lsw
                if s % 2 == 0:   # checkpoint store, slot popcount(s)
                    ckpt_z[_popcount(s)], ckpt_r[_popcount(s)] = z, r_
                else:            # spans ending at this (odd) leaf
                    for k in range(1, _ctz(s + 1) + 1):
                        slot = _popcount(s + 1 - (1 << k))
                        zl = direction[:, None] * ckpt_z[slot]
                        zr = direction[:, None] * z
                        turn_s = turn_s | _uturn(zl, ckpt_r[slot], zr, r_,
                                                 inv_mass)
                        log_margin("uturn", idx, lambda: uturn_margin(
                            zl, ckpt_r[slot], zr, r_))

            # ---- merge the subtree into the trajectory
            ok = ~(turn_s | div_s)
            lsw_i = lsw[idx]
            p_new = torch.exp(torch.clamp(lsw_s - lsw_i, max=0.0))
            u_b = rows["u_biased"][idx, dep]
            take = ok & (u_b < p_new)
            log_margin("take", idx, lambda: u_b - p_new, ok)
            z_prop_i = torch.where(take[:, None], zp_s, z_prop[idx])
            pe_prop_i = torch.where(take, pep_s, pe_prop[idx])
            lsw_i = torch.where(ok, torch.logaddexp(lsw_i, lsw_s), lsw_i)
            back = (ok & (direction < 0))[:, None]
            ahead = (ok & (direction > 0))[:, None]
            zm_i = torch.where(back, z, zm[idx])
            rm_i = torch.where(back, r_, rm[idx])
            gm_i = torch.where(back, g_, gm[idx])
            zp_i = torch.where(ahead, z, zp[idx])
            rp_i = torch.where(ahead, r_, rp[idx])
            gp_i = torch.where(ahead, g_, gp[idx])
            turn_all = _uturn(zm_i, rm_i, zp_i, rp_i, inv_mass)
            log_margin("uturn", idx,
                       lambda: uturn_margin(zm_i, rm_i, zp_i, rp_i), ok)

            z_prop, pe_prop = (z_prop.index_copy(0, idx, z_prop_i),
                               pe_prop.index_copy(0, idx, pe_prop_i))
            zm, rm, gm = (zm.index_copy(0, idx, zm_i), rm.index_copy(0, idx, rm_i),
                          gm.index_copy(0, idx, gm_i))
            zp, rp, gp = (zp.index_copy(0, idx, zp_i), rp.index_copy(0, idx, rp_i),
                          gp.index_copy(0, idx, gp_i))
            lsw = lsw.index_copy(0, idx, lsw_i)
            sum_met = sum_met.index_add(0, idx, sm_s)
            n_met = n_met.index_add(0, idx, torch.full_like(sm_s, 1 << dep))
            turn = turn.index_copy(0, idx, turn_s | (ok & turn_all))
            div = div.index_copy(0, idx, div[idx] | div_s)
            depth = depth.index_add(0, idx, torch.ones_like(sm_s))

        new_log_lik = -pe_prop - target.log_prior(z_prop)
        with torch.no_grad():
            extras = refresh_target_cache(target, state.extras, z_prop)
        info = {
            "depth": depth,
            "diverged": div.to(torch.float32),
            "accept_prob": sum_met / torch.clamp(n_met, min=1.0),
            "n_leapfrog": n_met,
        }
        return state.replace(theta=z_prop, log_lik_hat=new_log_lik,
                             extras=extras), info

    return keyed(draw, apply)
