"""Debug modes: finiteness checks on the sampler state.

Counterpart of ``auxpm_tpu/utils/debug.py``.  The failure mode these catch is
a NaN or Inf escaping a kernel into the chain state:

- ``checked_step(step)`` wraps a transition; the wrapped step's info carries
  an ``error_flags`` bitmask per chain (0 = clean), computed on the device
  with no host synchronisation, which the chain runner records and the
  windowed metrics average like any other info;
- ``throw_on_errors(info)``: host side, raise if any chain of any step set a
  flag;
- ``assert_finite_state(state)``: host side, check every floating tensor of
  a state (call it between windows).

For interactive debugging ``torch.autograd.set_detect_anomaly`` and
``CUDA_LAUNCH_BLOCKING=1`` remain the process-wide switches.
"""

from __future__ import annotations

import torch

# error_flags bit assignments, as in the reference
ERR_LOGLIK_NONFINITE = 1
ERR_THETA_NONFINITE = 2
ERR_U_NONFINITE = 4


def error_flags(state):
    """``(B,)`` int32 bitmask of the non-finite parts of each chain."""
    b = state.theta.shape[0]
    flags = torch.where(torch.isfinite(state.log_lik_hat), 0,
                        ERR_LOGLIK_NONFINITE)
    flags = flags + torch.where(
        torch.isfinite(state.theta).all(dim=1), 0, ERR_THETA_NONFINITE)
    flags = flags + torch.where(
        torch.isfinite(state.u.reshape(b, -1)).all(dim=1), 0, ERR_U_NONFINITE)
    return flags.to(torch.int32)


def checked_step(step):
    """Wrap ``step(state, params) -> (state, info)`` with finiteness checks:
    the returned step adds ``info["error_flags"]`` (see the module
    constants).  The wrapped step keeps ``draw``; its ``apply`` adds the
    flags too, and ``stages`` / ``stage_names`` are passed on."""

    def flagged(out):
        new_state, info = out
        return new_state, {**info, "error_flags": error_flags(new_state)}

    def wrapped(state, params):
        return flagged(step(state, params))

    for attr in ("draw", "stages", "stage_names"):
        if hasattr(step, attr):
            setattr(wrapped, attr, getattr(step, attr))
    if hasattr(step, "apply"):
        wrapped.apply = lambda state, rows, params: flagged(
            step.apply(state, rows, params))
    return wrapped


def throw_on_errors(info):
    """Host side: raise if any chain or step recorded error flags."""
    flags = info.get("error_flags", 0)
    total = int(flags.sum()) if torch.is_tensor(flags) else int(flags)
    if total:
        raise FloatingPointError(
            f"transition produced non-finite values (summed error_flags="
            f"{total}; bits: 1=log_lik 2=theta 4=u)")


def _floating_leaves(tree, prefix):
    if torch.is_tensor(tree):
        if tree.is_floating_point():
            yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _floating_leaves(v, f"{prefix}[{k!r}]")


def assert_finite_state(state):
    """Host side: raise if any floating tensor of the state is not finite."""
    for name in ("theta", "u", "log_lik_hat"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise FloatingPointError(f"non-finite values in state.{name}")
    for name, leaf in _floating_leaves(state.extras, "extras"):
        if not bool(torch.isfinite(leaf).all()):
            raise FloatingPointError(f"non-finite values in state.{name}")
