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
from auxpm_tpu_torch.core.transition import keyed
from auxpm_tpu_torch.samplers.pm_mh import random_walk_move


def make_mh_theta(target):
    def draw(state: ChainState, params=None):
        """``eps (B, d)`` proposal noise and ``log_unif (B,)``, as the
        reference draws them: ``key, k_prop, k_acc = split(key, 3)``.
        Returns the advanced keys too."""
        del params
        k = prng.split(state.key, 3)
        return ({"eps": prng.normal(k[:, 1], (state.theta.shape[1],)),
                 "log_unif": torch.log(prng.uniform(k[:, 2]))}, k[:, 0])

    def apply(state: ChainState, rows: dict, params: dict):
        new_state, accept, _ = random_walk_move(
            target, state, rows["eps"], rows["log_unif"],
            params.get("step_size", 0.5), state.u)
        return new_state, {"accept": accept.to(torch.float32)}

    return keyed(draw, apply)
