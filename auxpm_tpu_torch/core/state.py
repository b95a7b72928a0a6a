"""Chain state: one dataclass of batched tensors.

Counterpart of ``auxpm_tpu/core/state.py``.  Where the JAX package keeps a
per-chain pytree and ``vmap``s over it, here every leaf carries the chains on
its LEADING axis and the transitions are written for the batch.  Randomness
comes from explicit ``torch.Generator``s on the state's device, carried by
the state and advanced by every draw (there is no per-chain key; the
reference's counter-based keys are a later piece of the port, needed by the
SMC mode that regenerates u from a key):

- ``generator`` serves every theta-level draw (heights, angles, interval
  placements, shrink uniforms).  Under particle sharding it is REPLICATED over
  the ranks of a particle group (same seed, same sequence of draws), so that
  every rank takes the same decisions;
- ``block_generators`` serve the u-shaped draws (u at initialisation, the
  elliptical-slice direction v), one generator per GLOBAL row block of the
  estimator's reduction tree, seeded from (seed, chain shard, block).  The
  rows of block b are a fixed function of that generator's history whether
  the state holds all S rows or a particle shard's slice of them: a rank
  carries the generators of its own blocks and draws exactly the rows the
  unsharded state would draw there (the reference's ``blocked_normal``).  A
  target without blocks has none when unsharded (a plain draw from
  ``generator``) and one per rank when sharded.

Nothing here makes a run invariant to the number of CHAIN shards: the seeds
depend on the chain shard, not on the chain.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from auxpm_tpu_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class ChainState:
    """Sampler state of a batch of B chains.

    Attributes:
      theta: parameters, ``(B, d)``.
      u: auxiliary standard-normal draws defining the likelihood estimate,
        ``(B, S, n)``.  The estimator is a deterministic function of
        ``(theta, u)``.
      log_lik_hat: cached ``log_lik_est(theta, u)``, ``(B,)``.
      generator: the ``torch.Generator`` of every theta-level draw.
      block_generators: the generators of the u-shaped draws, one per row
        block this state holds (see the module note); may be empty.
      extras: carried quantities as a dict (``"target_cache"``: the
        sigma-independent Cholesky factor of the GP target).
    """

    theta: torch.Tensor
    u: torch.Tensor
    log_lik_hat: torch.Tensor
    generator: torch.Generator
    extras: dict[str, Any] = dataclasses.field(default_factory=dict)
    block_generators: tuple = ()

    def replace(self, **kw) -> "ChainState":
        return dataclasses.replace(self, **kw)


def mix_seed(seed, *ids):
    """A 63-bit seed that is a fixed function of ``(seed, *ids)``."""
    h = int(seed) % 2**63
    for i in ids:
        h = (h * 6364136223846793005 + int(i) + 1442695040888963407) % 2**63
    return h


def local_blocks(target, mesh=None):
    """``(first global block, number of blocks)`` this rank's rows cover, or
    None when the rows do not fall on the blocks of the target's reduction
    tree (no blocks, or S / K not a whole number of blocks)."""
    nb = target.n_weight_blocks or 1
    k = 1 if mesh is None else mesh.n_particle_shards
    s = target.u_shape[0]
    if nb <= 1 or s % k or nb % k or (s // k) % (nb // k):
        return None
    pi = 0 if mesh is None else mesh.particle_index
    return pi * (nb // k), nb // k


def make_generators(seed, target, mesh=None):
    """``(generator, block_generators)`` of a state on the target's device;
    ``mesh``: this rank's ``parallel.mesh.Mesh`` (None: unsharded)."""
    ci = 0 if mesh is None else mesh.chain_index

    def gen(s):
        g = torch.Generator(device=target.device)
        g.manual_seed(s)
        return g

    generator = gen(int(seed) if ci == 0 else mix_seed(seed, ci))
    blocks = local_blocks(target, mesh)
    if blocks is not None:
        b0, nb_local = blocks
        return generator, tuple(gen(mix_seed(seed, ci, b0 + b))
                                for b in range(nb_local))
    if mesh is None or mesh.n_particle_shards == 1:
        return generator, ()
    # no blocks to follow: every shard draws rows of its own
    return generator, (gen(mix_seed(seed, ci, 1 << 20, mesh.particle_index)),)


def local_rows(target, mesh=None):
    """Rows of u a rank holds: ``S / K``."""
    k = 1 if mesh is None else mesh.n_particle_shards
    s = target.u_shape[0]
    if s % k:
        raise ValueError(f"S={s} importance samples do not split over {k} "
                         "particle shards")
    return s // k


def make_u_normal(target, particle_axis=None):
    """Returns ``draw(generator, shape, block_generators=()) -> fresh
    N(0, I)`` on the target's device, ``shape = (..., rows, n)``.  With block
    generators the rows are drawn block by block, each block from its own
    generator; without, it is a plain draw from ``generator``.

    ``particle_axis``: under particle sharding a draw without block
    generators would hand every shard the same rows, so it raises."""

    def draw(generator, shape, block_generators=()):
        if not block_generators:
            if particle_axis is not None:
                raise ValueError(
                    "a particle-sharded u-shaped draw needs the state's "
                    "block_generators (see core/state.make_generators)")
            return torch.randn(shape, generator=generator,
                               dtype=torch.float32, device=target.device)
        rows, nb = shape[-2], len(block_generators)
        if rows % nb:
            raise ValueError(f"{rows} rows do not split into {nb} blocks")
        block_shape = (*shape[:-2], rows // nb, shape[-1])
        return torch.cat(
            [torch.randn(block_shape, generator=g, dtype=torch.float32,
                         device=target.device) for g in block_generators],
            dim=-2)

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
    estimator.

    Args:
      seed: integer seed of the state's generators.
      target: an ``auxpm_tpu_torch.models.base.Target``.
      n_chains: chains of THIS state (a chain shard's share under ``mesh``).
      theta0: optional initial parameters ``(d,)``; defaults to the target's
        ``theta_init``.  A chain-specific jitter ``N(0, jitter_scale^2)`` is
        added so chains start overdispersed.
      with_cache: populate ``extras["target_cache"]`` via
        ``target.cache_init`` (the carried-factor path).
      device: defaults to the target's device; must agree with it.
      mesh: this rank's ``parallel.mesh.Mesh`` when ``target`` is particle
        sharded: the state then holds the rank's ``S / K`` rows of u, built
        here from its own block generators, and theta is the same on every
        rank of the particle group.
    """
    device = resolve_device(target.device if device is None else device)
    if device.type != target.device.type:
        raise ValueError(
            f"state device {device} differs from the target's {target.device}"
        )
    generator, block_generators = make_generators(seed, target, mesh)
    if theta0 is None:
        theta0 = target.theta_init
    theta = torch.as_tensor(theta0, dtype=torch.float32,
                            device=target.device).expand(n_chains, target.d)
    if jitter_scale:
        theta = theta + jitter_scale * torch.randn(
            (n_chains, target.d), generator=generator, dtype=torch.float32,
            device=target.device)
    theta = theta.contiguous()
    sharded = mesh is not None and mesh.n_particle_shards > 1
    u = make_u_normal(target, mesh if sharded else None)(
        generator, (n_chains, local_rows(target, mesh), *target.u_shape[1:]),
        block_generators)
    extras = {}
    if with_cache and target.cache_init is not None:
        extras = {"target_cache": target.cache_init(theta)}
        log_lik = target.log_lik_est_u(
            target.prepare_c(theta, extras["target_cache"]), u)
    else:
        log_lik = target.log_lik_est(theta, u)
    return ChainState(theta=theta, u=u, log_lik_hat=log_lik,
                      generator=generator, extras=extras,
                      block_generators=block_generators)
