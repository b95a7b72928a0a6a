"""Hamiltonian Monte Carlo on theta (u held fixed).

Counterpart of ``auxpm_tpu/samplers/hmc.py``.  The potential is the
pseudo-marginal conditional

    U(theta) = -[log p(theta) + log L̂(theta, u)]

which is differentiable in theta: the GP estimator is Gram -> Cholesky ->
whiten -> log-likelihood, and every kernel on that chain is a
``torch.autograd.Function`` whose backward is plain PyTorch
(``ops/cholesky.RobustCholesky``, ``ops/fused_estimator.FusedEstimate`` /
``FusedWeights``, ``ops/gram.SeGramArd``).  One gradient evaluation is
``torch.autograd.grad(U(theta).sum(), theta)`` on a fresh leaf; no graph is
kept across leapfrog steps.

Targets: every target with a differentiable ``log_lik_est``: the GP target
(isotropic or ARD, prior or Laplace proposal, whose Newton fit is unrolled
under the gradient) and the Gaussian toy, each of them also particle
sharded (``parallel/particle_shard.py``), and the exact MVN.  On a particle-sharded
target a gradient call enters collectives in its forward (the fold) and in
its backward (the theta sum, ``parallel/collectives.particle_grad_sum``): 2
per call on a sharded GP target at S % 8 == 0.  Every rank of the group
holds bitwise the same U and gradient, so the accept tests, the step counts
and the gathers of the chains still integrating agree across the group, and
the ranks enter the same collectives in the same order.  ``grad_collectives``
counts the collectives entered inside gradient calls (read from
``parallel/collectives.calls``).

Batching: every chain draws its own number of leapfrog steps, uniform in
{1..n_leapfrog} (fixed-length HMC resonates on near-Gaussian targets; Neal
2011 section 3.2).  ``apply`` integrates the chains in lockstep up to the
largest count and freezes each chain once its own count is reached, as the
reference's ``fori_loop`` with a batched bound does under ``vmap``.  Each
leapfrog step evaluates the gradient of the chains still integrating only
(gathered, then scattered back): a chain's estimate does not depend on the
other chains of its call, so the gather changes no value.  The step counts
are read to the host once per step.

Params:
  step_size: leapfrog step size, a scalar or a per-chain ``(B,)`` tensor
    (dual averaging gives each chain its own during warm-up).
  n_leapfrog: MAXIMUM number of leapfrog steps (default 8).
  inv_mass: diagonal inverse mass, a scalar or ``(d,)`` (default 1).
"""

from __future__ import annotations

import torch

from auxpm_tpu_torch.core import prng
from auxpm_tpu_torch.core.state import ChainState, refresh_target_cache
from auxpm_tpu_torch.core.transition import keyed
from auxpm_tpu_torch.parallel import collectives

_DIVERGENCE = 1000.0

grad_calls = 0  # batched gradient evaluations made by HMC and NUTS
grad_rows = 0   # chain-gradients among them (the rows of those calls)
grad_collectives = 0  # collectives entered inside those calls (sharded)
host_syncs = 0  # reads to the host by HMC and NUTS (step counts, active sets)


def potential_fn(target, u):
    """``U(theta) = -(log p(theta) + log L̂(theta, u))``, batched."""

    def u_fn(theta):
        return -(target.log_prior(theta) + target.log_lik_est(theta, u))

    return u_fn


def value_and_grad(target, u):
    """``vg(theta, rows=None) -> (U, dU/dtheta)`` of the chains ``rows``
    (an index tensor; None = all), each call on a fresh leaf."""

    def vg(theta, rows=None):
        global grad_calls, grad_rows, grad_collectives
        uu = u if rows is None else u[rows]
        entered = collectives.calls
        with torch.enable_grad():
            z = theta.detach().requires_grad_(True)
            pe = potential_fn(target, uu)(z)
            (g,) = torch.autograd.grad(pe.sum(), z)
        grad_calls += 1
        grad_rows += theta.shape[0]
        grad_collectives += collectives.calls - entered
        return pe.detach(), g

    return vg


def per_chain(value, b, like):
    """A scalar or ``(B,)`` parameter as a ``(B,)`` tensor like ``like``."""
    v = torch.as_tensor(value, dtype=like.dtype, device=like.device)
    return v.expand(b) if v.dim() == 0 else v


def inv_mass_vector(value, like):
    """A scalar or ``(d,)`` inverse mass as a ``(d,)`` tensor."""
    v = torch.as_tensor(value, dtype=like.dtype, device=like.device)
    return v.expand(like.shape[-1]) if v.dim() == 0 else v


def kinetic(inv_mass, r):
    return 0.5 * (inv_mass * r * r).sum(-1)


def leapfrog(z, r, g, eps, inv_mass, vg, rows=None):
    """One leapfrog step of the chains ``rows`` (index tensor or None);
    ``eps (B_rows,)`` may carry a direction sign.  Returns ``(z, r, g, U)``
    of those chains."""
    e = eps[:, None]
    r = r - 0.5 * e * g
    z = z + e * inv_mass * r
    pe, g = vg(z, rows)
    r = r - 0.5 * e * g
    return z, r, g, pe


def make_hmc(target):
    def draw(state: ChainState, params=None):
        """``n_steps (B,)`` int64 in {1..n_leapfrog}, the momentum draw
        ``r0 (B, d)`` ~ N(0, I) (scaled by ``inv_mass^-1/2`` in ``apply``)
        and ``log_u (B,)``, as the reference draws them: ``key, k_mom,
        k_acc, k_traj = split(key, 4)``.  Returns the advanced keys too."""
        n_leapfrog = int((params or {}).get("n_leapfrog", 8))
        k = prng.split(state.key, 4)
        return ({"n_steps": prng.randint(k[:, 3], (), 1, n_leapfrog + 1),
                 "r0": prng.normal(k[:, 1], (state.theta.shape[1],)),
                 "log_u": torch.log(prng.uniform(k[:, 2]))}, k[:, 0])

    def apply(state: ChainState, rows: dict, params: dict):
        global host_syncs
        theta = state.theta
        b = theta.shape[0]
        eps = per_chain(params.get("step_size", 0.1), b, theta)
        inv_mass = inv_mass_vector(params.get("inv_mass", 1.0), theta)
        vg = value_and_grad(target, state.u)

        pe0, g0 = vg(theta)
        r0 = rows["r0"] / torch.sqrt(inv_mass)
        h0 = pe0 + kinetic(inv_mass, r0)
        z, r, g, pe = theta, r0, g0, torch.zeros_like(pe0)
        counts = rows["n_steps"].cpu()   # host sync: one per step
        host_syncs += 1
        for s in range(int(counts.max())):
            idx = torch.nonzero(counts > s).flatten().to(theta.device)
            zi, ri, gi, pei = leapfrog(z[idx], r[idx], g[idx], eps[idx],
                                       inv_mass, vg, idx)
            z, r, g, pe = (a.index_copy(0, idx, ai) for a, ai in
                           ((z, zi), (r, ri), (g, gi), (pe, pei)))
        h1 = pe + kinetic(inv_mass, r)

        delta_h = h0 - h1
        diverged = ~torch.isfinite(delta_h) | (delta_h < -_DIVERGENCE)
        accept = (rows["log_u"] < delta_h) & ~diverged
        # optional ``params["probe_log"]``: a list that collects (kind,
        # chains, margin) of the accept decision
        probe_log = params.get("probe_log")
        if probe_log is not None:
            probe_log.append(("accept", torch.ones_like(accept),
                              delta_h - rows["log_u"]))
        new_theta = torch.where(accept[:, None], z, theta)
        new_log_lik = torch.where(accept, -pe - target.log_prior(z),
                                  state.log_lik_hat)
        with torch.no_grad():
            extras = refresh_target_cache(target, state.extras, new_theta)
        info = {
            "accept": accept.to(torch.float32),
            "accept_prob": torch.exp(torch.clamp(torch.where(
                diverged, torch.full_like(delta_h, -float("inf")), delta_h),
                max=0.0)),
            "diverged": diverged.to(torch.float32),
        }
        return state.replace(theta=new_theta, log_lik_hat=new_log_lik,
                             extras=extras), info

    return keyed(draw, apply)
