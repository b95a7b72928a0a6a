"""Random-walk MH update of theta | u (auxiliary variant).

Counterpart of ``auxpm_tpu/samplers/mh_theta.py``.  Unlike PM-MH, the
auxiliary draws u are held fixed, so the accept ratio compares the same
estimator noise on both sides:

    theta' = theta + step_size * N(0, I_d)
    log a  = log p(theta') + log L̂(theta', u) - log p(theta) - log L̂(theta, u)

which removes the stick-on-lucky-estimate pathology at the price of a
separate u refresh (ESS) to mix over the auxiliary block (``aux_mh``).

Params:
  step_size: scalar or (d,) random-walk scale.
"""

from __future__ import annotations

import torch

from auxpm_tpu_torch.core import prng
from auxpm_tpu_torch.core.state import ChainState
from auxpm_tpu_torch.samplers.pm_mh import random_walk_move


def make_mh_theta(target):
    def draw(generator, state: ChainState):
        """``eps (B, d)`` proposal noise and ``log_unif (B,)``."""
        b, d = state.theta.shape
        dev = state.theta.device
        eps = torch.randn((b, d), generator=generator, dtype=torch.float32,
                          device=dev)
        unif = torch.rand((b,), generator=generator, dtype=torch.float32,
                          device=dev)
        return {"eps": eps, "log_unif": torch.log(unif)}

    def draw_keyed(keys, state: ChainState, params=None):
        """The same rows from each chain's key ``(B, 2)``, as the reference
        draws them (``key, k_prop, k_acc = split(key, 3)``); returns the
        advanced keys too."""
        del params
        k = prng.split(keys, 3)
        return k[:, 0], {
            "eps": prng.normal(k[:, 1], (state.theta.shape[1],)),
            "log_unif": torch.log(prng.uniform(k[:, 2]))}

    def apply(state: ChainState, rows: dict, params: dict):
        new_state, accept, _ = random_walk_move(
            target, state, rows["eps"], rows["log_unif"],
            params.get("step_size", 0.5), state.u)
        return new_state, {"accept": accept.to(torch.float32)}

    def step(state: ChainState, params: dict):
        return apply(state, draw(state.generator, state), params)

    step.draw = draw
    step.draw_keyed = draw_keyed
    step.apply = apply
    return step
