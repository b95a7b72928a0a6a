"""Carry state across from the JAX package, as NumPy.

The JAX package's ``ChainState`` (already batched over chains by ``vmap``)
has the same leaves as the port's; this module turns their NumPy copies into
the port's types.  The PRNG key crosses as its two words
(``jax.random.key_data``), which the port's ``core/prng.py`` reads as the same
key, so both packages can start from one state and draw the same numbers.
Nothing here
depends on theta's length, so an ARD state (theta of d+1, one width per
coordinate in the params) crosses like an isotropic one.  Targets are built
on both sides from the same NumPy arrays: ``(x, y)`` for the GP target, from
which each side derives its padded ``x_pad`` and mask; ``y`` and ``sigma_y``
for the Gaussian toy.

For the particle-sharded path ``shard_numpy_state`` cuts the reference's whole
state into the shares of the ranks of a (chains, particles) mesh, so that both
packages start from the same state: rank ``ci * K + pi`` gets the chains of
chain shard ci and, of each chain's u, the rows of particle shard pi.
"""

from __future__ import annotations

import numpy as np
import torch

from auxpm_tpu_torch._device import resolve_device
from auxpm_tpu_torch.core.state import ChainState

_STATIC_PARAM_KEYS = ("max_step_out", "max_shrink", "max_shrink_chol")


def shard_numpy_state(d, n_chain_shards, n_particle_shards):
    """Split the dict ``d`` of ``chain_states_from_numpy`` (a whole state)
    into the list of per-rank dicts of an ``n_chain_shards`` x
    ``n_particle_shards`` mesh, in rank order."""
    b, s = d["u"].shape[:2]
    if b % n_chain_shards or s % n_particle_shards:
        raise ValueError(f"{b} chains x {s} rows do not split over a "
                         f"{n_chain_shards} x {n_particle_shards} mesh")
    per, rows = b // n_chain_shards, s // n_particle_shards
    out = []
    for ci in range(n_chain_shards):
        cs = slice(ci * per, (ci + 1) * per)
        for pi in range(n_particle_shards):
            share = {k: np.asarray(v)[cs] for k, v in d.items()
                     if v is not None}
            share["u"] = np.asarray(d["u"])[cs, pi * rows:(pi + 1) * rows]
            out.append(share)
    return out


def chain_states_from_numpy(d, device="cuda"):
    """``d``: dict with ``theta (B, d)``, ``u (B, S, n)``, ``log_lik_hat
    (B,)``, ``key (B, 2)`` (the reference's ``jax.random.key_data`` words;
    absent: zero keys, for a state that only meets ``apply`` with rows fed
    by the caller) and, for the carried-factor path, ``chol_r (B, n, n)``
    (the reference's ``extras["target_cache"]["chol_r"]``; absent or None
    gives a state without a cache, which takes the uncached paths).  A
    rank's share is one entry of ``shard_numpy_state``."""
    device = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a, dtype=np.float32), device=device)

    b = np.asarray(d["theta"]).shape[0]
    key = d.get("key")
    key = (np.zeros((b, 2), np.int64) if key is None
           else np.asarray(key).astype(np.uint32).astype(np.int64))
    extras = {}
    if d.get("chol_r") is not None:
        extras = {"target_cache": {"chol_r": t(d["chol_r"])}}
    return ChainState(theta=t(d["theta"]), u=t(d["u"]),
                      log_lik_hat=t(d["log_lik_hat"]),
                      key=torch.as_tensor(key, device=device), extras=extras)


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
