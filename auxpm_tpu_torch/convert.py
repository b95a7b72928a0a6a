"""Carry state across from the JAX package, as NumPy.

The JAX package's ``ChainState`` (already batched over chains by ``vmap``)
has the same leaves as the port's; this module turns their NumPy copies into
the port's types.  The JAX PRNG key is not convertible and is dropped: the
port's state carries a ``torch.Generator`` (seeded here).  Nothing here
depends on theta's length, so an ARD state (theta of d+1, one width per
coordinate in the params) crosses like an isotropic one.  Targets are built
on both sides from the same NumPy arrays: ``(x, y)`` for the GP target, from
which each side derives its padded ``x_pad`` and mask; ``y`` and ``sigma_y``
for the Gaussian toy.
"""

from __future__ import annotations

import numpy as np
import torch

from auxpm_tpu_torch._device import resolve_device
from auxpm_tpu_torch.core.state import ChainState

_STATIC_PARAM_KEYS = ("max_step_out", "max_shrink", "max_shrink_chol")


def chain_states_from_numpy(d, device="cuda", seed=0):
    """``d``: dict with ``theta (B, d)``, ``u (B, S, n)``, ``log_lik_hat
    (B,)`` and, for the carried-factor path, ``chol_r (B, n, n)`` (the
    reference's ``extras["target_cache"]["chol_r"]``; absent or None gives a
    state without a cache, which takes the uncached paths)."""
    device = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a, dtype=np.float32), device=device)

    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed))
    extras = {}
    if d.get("chol_r") is not None:
        extras = {"target_cache": {"chol_r": t(d["chol_r"])}}
    return ChainState(theta=t(d["theta"]), u=t(d["u"]),
                      log_lik_hat=t(d["log_lik_hat"]), generator=generator,
                      extras=extras)


def params_from_numpy(params, device="cuda"):
    """The reference's sampler params dict (groups of arrays and static
    integer caps) with arrays as float32 tensors and caps as ints."""
    device = resolve_device(device)
    out = {}
    for group, sub in params.items():
        if not isinstance(sub, dict):
            raise ValueError(f"param group {group!r} is not a dict")
        out[group] = {
            k: int(v) if k in _STATIC_PARAM_KEYS
            else torch.as_tensor(np.array(v, dtype=np.float32), device=device)
            for k, v in sub.items()
        }
    return out
