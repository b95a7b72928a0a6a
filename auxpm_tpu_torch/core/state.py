"""Chain state: one dataclass of batched tensors.

Counterpart of ``auxpm_tpu/core/state.py``.  Where the JAX package keeps a
per-chain pytree and ``vmap``s over it, here every leaf carries the chains on
its LEADING axis and the transitions are written for the batch.

PRNG discipline, as the reference's: every chain carries its own counter-based
key (``key``, int64 ``(B, 2)``: the two uint32 words of
``jax.random.key_data``, ``core/prng.py``).  A transition splits each chain's
key exactly as the reference splits it and hands the advanced key back, so a
chain's trajectory is a function of its own initial state alone: the same on
any number of chain shards, after a resume on another layout, and key for key
the reference's from the same seed.  Under particle sharding the key is
replicated over the ranks of a particle group, and a u-shaped draw covers the
rank's rows only (``make_u_normal``): with partitionable threefry element i of
a draw depends on counter i alone, so no rank draws another's rows.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from auxpm_tpu_torch._device import resolve_device
from auxpm_tpu_torch.core import prng


@dataclasses.dataclass(frozen=True)
class ChainState:
    """Sampler state of a batch of B chains.

    Attributes:
      theta: parameters, ``(B, d)``.
      u: auxiliary standard-normal draws defining the likelihood estimate,
        ``(B, S, n)`` (the key-as-u SMC keeps their generating key words
        here instead).  The estimator is a deterministic function of
        ``(theta, u)``.
      log_lik_hat: cached ``log_lik_est(theta, u)``, ``(B,)``.
      key: per-chain PRNG key, int64 ``(B, 2)``.
      extras: carried quantities as a dict (``"target_cache"``: the
        sigma-independent Cholesky factor of the GP target).
    """

    theta: torch.Tensor
    u: torch.Tensor
    log_lik_hat: torch.Tensor
    key: torch.Tensor
    extras: dict[str, Any] = dataclasses.field(default_factory=dict)

    def replace(self, **kw) -> "ChainState":
        return dataclasses.replace(self, **kw)


def local_rows(target, mesh=None):
    """Rows of u a rank holds: ``S / K``."""
    k = 1 if mesh is None else mesh.n_particle_shards
    s = target.u_shape[0]
    if s % k:
        raise ValueError(f"S={s} importance samples do not split over {k} "
                         "particle shards")
    return s // k


def make_u_normal(target, particle_axis=None):
    """Returns ``draw(keys (..., 2), rows) -> fresh N(0, I) (..., rows, n)``
    honouring the target's block granularity, branch for branch
    ``auxpm_tpu/core/state.make_u_normal``:

    - blocks (``target.n_weight_blocks > 1``) that the rows cover whole:
      global row block b is ``normal(fold_in(key, b))``
      (``prng.blocked_normal``), the same rows whether u is whole or a
      particle shard's slice;
    - no blocks, unsharded: a plain ``normal(key, (rows, n))``;
    - no blocks to follow under particle sharding: ``normal(fold_in(key,
      particle index))``, rows of the shard's own.

    ``particle_axis``: this rank's ``parallel.mesh.Mesh`` under particle
    sharding (the rows are then ``S / K``)."""
    s_global = target.u_shape[0]
    n_cols = tuple(target.u_shape[1:])
    nb = target.n_weight_blocks or 1

    def draw(keys, rows):
        shape = (rows, *n_cols)
        if particle_axis is None:
            if nb > 1:
                return prng.blocked_normal(keys, shape, nb, s_global)
            return prng.normal(keys, shape)
        k_shards = s_global // rows
        if (nb > 1 and k_shards * rows == s_global and nb % k_shards == 0
                and rows % (nb // k_shards) == 0):
            return prng.blocked_normal(
                keys, shape, nb, s_global,
                block0=particle_axis.particle_index * (nb // k_shards))
        return prng.normal(prng.fold_in(keys, particle_axis.particle_index),
                           shape)

    return draw


def refresh_target_cache(target, extras, theta_new):
    """Rebuild ``extras["target_cache"]`` for a NEW theta (or pass through).

    Safety net for theta-changing kernels that are not cache-aware: the
    cached kernels assume
    ``extras["target_cache"] == target.cache_init(state.theta)``."""
    if target.cache_init is not None and "target_cache" in extras:
        return {**extras, "target_cache": target.cache_init(theta_new)}
    return extras


def init_chain_states(seed, target, n_chains, theta0=None, jitter_scale=0.1,
                      with_cache=False, device=None, mesh=None):
    """Initialise ``n_chains`` chains: draw ``u ~ N(0, I)``, evaluate the
    estimator.  Chain c is the reference's ``init_chain_state`` of
    ``split(key(seed), n_chains)[c]``: ``k_u, k_t, k_carry = split(., 3)``,
    theta jitter ``normal(k_t, (d,))``, u a plain ``normal(k_u, u_shape)``
    (not blocked) and the carried key ``k_carry``.

    Args:
      seed: an integer seed: the run key is ``prng.key(seed)``, what
        ``jax.random.key(seed)`` gives.
      target: an ``auxpm_tpu_torch.models.base.Target``.
      n_chains: chains of the WHOLE run; with ``mesh`` the state holds its
        chain shard's slice of them.
      theta0: optional initial parameters ``(d,)``; defaults to the target's
        ``theta_init``.  A chain-specific jitter ``N(0, jitter_scale^2)`` is
        added so chains start overdispersed.
      with_cache: populate ``extras["target_cache"]`` via
        ``target.cache_init`` (the carried-factor path).
      device: defaults to the target's device; must agree with it.
      mesh: this rank's ``parallel.mesh.Mesh``: the state then holds the
        chains of its chain shard and, when ``target`` is particle sharded,
        the rank's ``S / K`` rows of each u (the counters of those rows
        only); theta is the same on every rank of a particle group.
    """
    device = resolve_device(target.device if device is None else device)
    if device.type != target.device.type:
        raise ValueError(
            f"state device {device} differs from the target's {target.device}"
        )
    if mesh is not None:
        from auxpm_tpu_torch.parallel.sharded_chain import chain_slice

        cs = chain_slice(n_chains, mesh)
    else:
        cs = slice(0, n_chains)
    keys = prng.split(prng.key(seed).to(target.device), n_chains)[cs]
    return _init_from_keys(keys, target, theta0, jitter_scale, with_cache,
                           mesh)


def init_chain_state(key, target, theta0=None, jitter_scale=0.0,
                     with_cache=False):
    """Initialise ONE chain from its key: the reference's
    ``init_chain_state`` (``k_u, k_t, k_carry = split(key, 3)``, theta jitter
    ``normal(k_t, (d,))``, u ``normal(k_u, u_shape)``).  ``key``: an int64
    ``(2,)`` of ``core/prng.py`` (``prng.key(seed)`` or one row of
    ``prng.split``), moved to the target's device.  Returns a state with a
    chain axis of one, as every state of the port has: chain c of
    ``init_chain_states(seed, target, n)`` is this of ``prng.split(
    prng.key(seed), n)[c]`` (note the defaults: ``jitter_scale`` 0 here,
    0.1 there, as in the reference)."""
    keys = torch.as_tensor(key, dtype=torch.int64).to(target.device)
    return _init_from_keys(keys.reshape(1, 2), target, theta0, jitter_scale,
                           with_cache)


def _init_from_keys(keys, target, theta0, jitter_scale, with_cache,
                    mesh=None):
    """The chains of ``keys`` (int64 ``(B, 2)`` on the target's device); see
    ``init_chain_states``."""
    k = prng.split(keys, 3)
    n_local = keys.shape[0]
    if theta0 is None:
        theta0 = target.theta_init
    theta = torch.as_tensor(theta0, dtype=torch.float32,
                            device=target.device).expand(n_local, target.d)
    if jitter_scale:
        theta = theta + jitter_scale * prng.normal(k[:, 1], (target.d,))
    theta = theta.contiguous()
    rows = local_rows(target, mesh)
    n_cols = tuple(target.u_shape[1:])
    row0 = 0 if mesh is None else mesh.particle_index * rows
    u = prng.normal(k[:, 0], (rows, *n_cols),
                    offset=row0 * math.prod(n_cols))
    extras = {}
    if with_cache and target.cache_init is not None:
        extras = {"target_cache": target.cache_init(theta)}
        log_lik = target.log_lik_est_u(
            target.prepare_c(theta, extras["target_cache"]), u)
    else:
        log_lik = target.log_lik_est(theta, u)
    return ChainState(theta=theta, u=u, log_lik_hat=log_lik,
                      key=k[:, 2].contiguous(), extras=extras)
