"""auxpm_tpu_torch — the PyTorch / CUDA port of ``auxpm_tpu``.

Auxiliary pseudo-marginal MCMC (Murray & Graham 2016) on one NVIDIA Hopper
card.  The package mirrors the layout of the JAX package (``core/``,
``models/``, ``ops/``, ``samplers/``, ``utils/``, ``run.py``) so that a reader
finds each counterpart by name, and differs inside:

- chains are the leading tensor axis of every state leaf (no ``vmap``);
- every chain carries the reference's counter-based threefry key and each
  transition splits it as the reference does (no ``torch.Generator`` is
  left on any chain path: a chain's draws depend on its own key, not on the
  layout), on the card through the kernel ``csrc/threefry.cu``;
- each transition is split into ``draw`` (random rows and the advanced
  keys) and a deterministic ``apply``, so a test can also feed the
  reference's own random numbers;
- the hot loops are hand-written CUDA kernels under ``csrc/``, built with
  ``nvcc`` at first use (``ops/_build.py``); on a CPU tensor every wrapper
  takes its plain PyTorch version instead.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"`` and
raises when no card is present: nothing carries on silently on the CPU.

The package imports ``torch`` and ``numpy`` only.
"""

__version__ = "0.1.0"
