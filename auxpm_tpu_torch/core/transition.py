"""Composable transition protocol.

Counterpart of ``auxpm_tpu/core/transition.py``.  A *transition* is a function

    transition(state: ChainState, params: dict) -> (ChainState, info: dict)

on a BATCH of chains, split into two halves it also exposes as attributes:

    transition.draw(state, params) -> (rows, new_key)   (all the randomness)
    transition.apply(state, rows, params)               (deterministic)

``draw`` computes every random row of the step from the chains' keys
(``state.key``, split as the reference splits them) and returns the advanced
keys; ``apply`` leaves the key alone, and the transition puts the advanced key
into the state it returns (``keyed``).  The split is what lets a test feed the
reference implementation's own random numbers to ``apply``.  ``params`` holds
tunable hyperparameters kept outside the state so the adaptation loop can
rewrite them between windows; ``info`` holds per-step diagnostics, each
``(B,)``.
"""

from __future__ import annotations

from typing import Callable, Sequence

from auxpm_tpu_torch.core.state import ChainState

Transition = Callable[[ChainState, dict], tuple[ChainState, dict]]


def keyed(draw, apply):
    """The transition of a ``draw`` / ``apply`` pair, with both halves as
    attributes."""

    def step(state: ChainState, params: dict):
        rows, key = draw(state, params)
        new_state, info = apply(state, rows, params)
        return new_state.replace(key=key), info

    step.draw = draw
    step.apply = apply
    return step


def compose(named_transitions: Sequence[tuple[str, Transition]]) -> Transition:
    """Sequential composition; info keys are prefixed with the stage name.

    ``params`` holds one sub-dict per stage name; a stage sees only its own
    (missing -> {}).  ``composed.stages`` maps each name to its transition
    (with its ``draw`` / ``apply``)."""

    stage_names = [name for name, _ in named_transitions]

    def composed(state: ChainState, params: dict):
        unknown = set(params) - set(stage_names)
        if unknown:
            # a typo'd group name would otherwise be silently ignored and the
            # stage would run on defaults
            raise ValueError(
                f"unknown param group(s) {sorted(unknown)}; stages are "
                f"{stage_names}"
            )
        info_all = {}
        for name, t in named_transitions:
            state, info = t(state, params.get(name, {}))
            for k, v in info.items():
                info_all[f"{name}/{k}"] = v
        return state, info_all

    composed.stage_names = tuple(stage_names)
    composed.stages = dict(named_transitions)
    return composed


def repeat(transition: Transition, n: int) -> Transition:
    """Apply a transition ``n`` times; the info of the last application is
    returned."""

    def repeated(state: ChainState, params: dict):
        info = {}
        for _ in range(n):
            state, info = transition(state, params)
        return state, info

    return repeated
