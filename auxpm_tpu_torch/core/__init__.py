"""Chain state and the composable transition protocol."""

from auxpm_tpu_torch.core.state import ChainState, init_chain_state  # noqa: F401
from auxpm_tpu_torch.core.transition import (  # noqa: F401
    Transition,
    compose,
    repeat,
)
