"""Particle (importance-sample) sharding of a target.

Counterpart of ``auxpm_tpu/parallel/particle_shard.py``.  The S importance
samples of ONE estimate are split over the K ranks of a particle group; each
rank scores its ``S / K`` rows against the replicated prepared state and the
log-sum-exp over S becomes a collective.

``shard_target_particles(target, mesh)`` returns the target to run on this
rank, whose ``u`` holds the local rows:

- the estimate is bitwise the same on every rank of the group (the collective
  leaves one value everywhere), so accept and shrink decisions taken from the
  replicated per-chain keys agree across the group with no other
  synchronisation: the invariant the scheme rests on;
- the samplers draw u-shaped randomness per rank, the rows of its own
  (``core/state.make_u_normal``), and everything else from the replicated
  keys;
- ``log_lik_est(theta, u_local)`` is differentiable in theta with bitwise
  the same gradient on every rank: the fold's backward reaches this rank's
  rows, ``particle_grad_sum`` adds the group's theta cotangents
  (``parallel/collectives.py``), so HMC and NUTS take the same decisions on
  every rank as well.  ``log_lik_est_u`` on a state prepared once (the ESS
  update's probes) is not differentiated.
"""

from __future__ import annotations

import dataclasses
import math

from auxpm_tpu_torch.parallel.collectives import (
    particle_grad_sum,
    psum_logsumexp,
)


def shard_target_particles(target, mesh):
    """Wrap ``target`` so that its estimator reduces over ``mesh``'s particle
    group.  Returns ``(sharded target, global S)``."""
    s_global = target.u_shape[0]
    if target.make_sharded is not None:
        # the target rebuilds itself with a collective-aware estimator and
        # keeps its structure-aware paths (coordinate factories, the rotated
        # probe), all through the blocked combine
        return target.make_sharded(mesh), s_global

    if target.log_weights_u is None or target.prepare is None:
        raise ValueError(f"target {target.name} does not expose log_weights_u")
    log_s = math.log(float(s_global))

    def log_lik_est_u(prepared, u_local):
        return psum_logsumexp(target.log_weights_u(prepared, u_local),
                              mesh) - log_s

    def log_lik_est(theta, u_local):
        # the prior's gradient is never summed over ranks: only the
        # estimate's path goes through the theta sum
        return log_lik_est_u(target.prepare(particle_grad_sum(theta, mesh)),
                             u_local)

    return dataclasses.replace(
        target,
        log_lik_est=log_lik_est,
        log_lik_est_u=log_lik_est_u,
        # structure-aware coordinate probes and a rotated probe would close
        # over the UNSHARDED estimator and give every rank its own
        # likelihood, hence its own trip counts, hence a collective that some
        # ranks never enter; the generic paths use the wrapped estimator
        coord_estimators=None,
        coord_estimators_c=None,
        cache_init=None,
        prepare_c=None,
        log_lik_est_rot=None,
        ess_sweep_factory=None,
        sigma_sweep_factory=None,
        make_sharded=None,
        name=f"{target.name}@{mesh.name}",
    ), s_global
