"""Chain state: one dataclass of batched tensors.

Counterpart of ``auxpm_tpu/core/state.py``.  Where the JAX package keeps a
per-chain pytree and ``vmap``s over it, here every leaf carries the chains on
its LEADING axis and the transitions are written for the batch.  Randomness
comes from one explicit ``torch.Generator`` on the state's device, carried by
the state and advanced by every draw (there is no per-chain key; the
reference's counter-based keys are a later piece of the port, needed by the
SMC mode that regenerates u from a key).
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
      generator: the ``torch.Generator`` every draw of these chains uses.
      extras: carried quantities as a dict (``"target_cache"``: the
        sigma-independent Cholesky factor of the GP target).
    """

    theta: torch.Tensor
    u: torch.Tensor
    log_lik_hat: torch.Tensor
    generator: torch.Generator
    extras: dict[str, Any] = dataclasses.field(default_factory=dict)

    def replace(self, **kw) -> "ChainState":
        return dataclasses.replace(self, **kw)


def make_u_normal(target):
    """Returns ``draw(generator, shape) -> fresh N(0, I)`` on the target's
    device: a plain generator draw."""

    def draw(generator, shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=target.device)

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
                      with_cache=False, device=None):
    """Initialise ``n_chains`` chains: draw ``u ~ N(0, I)``, evaluate the
    estimator.

    Args:
      seed: integer seed of the state's ``torch.Generator``.
      target: an ``auxpm_tpu_torch.models.base.Target``.
      theta0: optional initial parameters ``(d,)``; defaults to the target's
        ``theta_init``.  A chain-specific jitter ``N(0, jitter_scale^2)`` is
        added so chains start overdispersed.
      with_cache: populate ``extras["target_cache"]`` via
        ``target.cache_init`` (the carried-factor path).
      device: defaults to the target's device; must agree with it.
    """
    device = resolve_device(target.device if device is None else device)
    if device.type != target.device.type:
        raise ValueError(
            f"state device {device} differs from the target's {target.device}"
        )
    generator = torch.Generator(device=target.device)
    generator.manual_seed(int(seed))
    if theta0 is None:
        theta0 = target.theta_init
    theta = torch.as_tensor(theta0, dtype=torch.float32,
                            device=target.device).expand(n_chains, target.d)
    if jitter_scale:
        theta = theta + jitter_scale * torch.randn(
            (n_chains, target.d), generator=generator, dtype=torch.float32,
            device=target.device)
    theta = theta.contiguous()
    u = make_u_normal(target)(generator, (n_chains, *target.u_shape))
    extras = {}
    if with_cache and target.cache_init is not None:
        extras = {"target_cache": target.cache_init(theta)}
        log_lik = target.log_lik_est_u(
            target.prepare_c(theta, extras["target_cache"]), u)
    else:
        log_lik = target.log_lik_est(theta, u)
    return ChainState(theta=theta, u=u, log_lik_hat=log_lik,
                      generator=generator, extras=extras)
