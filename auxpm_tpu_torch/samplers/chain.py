"""Chain runner: a Python loop over steps on a batch of chains.

Counterpart of ``auxpm_tpu/samplers/chain.py``.  PyTorch runs eagerly, so the
step loop is host code that enqueues device work; the recorded history stays
on the device (preallocated, written in place) and the caller copies it to
the host once per window.  Thinning records the last state of every block of
``thin`` steps and averages the per-step info inside the block.
"""

from __future__ import annotations

import torch

from auxpm_tpu_torch.core.state import ChainState


def run_chains(transition, states: ChainState, params: dict, n_steps: int,
               thin: int = 1, record_u: bool = False):
    """Run ``n_steps`` of ``transition`` on a batch of chains.

    Args:
      transition: batched ``(state, params) -> (state, info)``.
      states: batched ``ChainState`` (leading chains axis on every leaf).
      params: sampler hyperparameters, shared across chains.
      n_steps: total steps; must be divisible by ``thin``.
      thin: record every ``thin``-th state.
      record_u: also record the auxiliary block (large; off by default).

    Returns:
      ``(final_states, records, infos)``: ``records["theta"]`` is
      ``(chains, n_steps // thin, d)``, ``records["log_lik_hat"]`` and each
      info leaf ``(chains, n_steps // thin)``; all on the states' device.
    """
    if n_steps % thin:
        raise ValueError(f"n_steps={n_steps} not divisible by thin={thin}")
    n_out = n_steps // thin
    b, d = states.theta.shape
    dev, dt = states.theta.device, states.theta.dtype
    recs = {
        "theta": torch.empty((b, n_out, d), dtype=dt, device=dev),
        "log_lik_hat": torch.empty((b, n_out), dtype=dt, device=dev),
    }
    if record_u:
        recs["u"] = torch.empty((b, n_out, *states.u.shape[1:]), dtype=dt,
                                device=dev)
    infos = {}
    for t in range(n_out):
        block = {}
        for _ in range(thin):
            states, info = transition(states, params)
            for k, v in info.items():
                block[k] = block[k] + v if k in block else v
        recs["theta"][:, t] = states.theta
        recs["log_lik_hat"][:, t] = states.log_lik_hat
        if record_u:
            recs["u"][:, t] = states.u
        for k, v in block.items():
            if k not in infos:
                infos[k] = torch.empty((b, n_out), dtype=dt, device=dev)
            infos[k][:, t] = v / thin
    return states, recs, infos
