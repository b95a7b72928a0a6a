"""Numerical building blocks and the wrappers of the CUDA kernels.

Exact float32 is part of the estimator's definition: reduced-precision
matrix products make squared-exponential Gram matrices indefinite (the JAX
package asks for ``Precision.HIGHEST`` in the same places).  TF32 therefore
has to be off for every ``torch.matmul`` the port issues; importing this
package checks it.  bfloat16 appears only behind ``whiten_dtype="bfloat16"``.
"""

import torch

if torch.backends.cuda.matmul.allow_tf32:
    raise RuntimeError(
        "torch.backends.cuda.matmul.allow_tf32 is True; auxpm_tpu_torch needs "
        "exact float32 matrix products (set it to False before importing)"
    )

from auxpm_tpu_torch.ops.logsumexp import (  # noqa: E402,F401
    blocked_logsumexp,
    logsumexp,
    masked_logsumexp,
)
