"""The reference's v1 and v2 Cholesky panel bodies in interpret mode.

Shared by ``test_torch_chol_variants.py`` and ``test_torch_sweep_rounds.py``;
holds no tests.  The reference's panels are Pallas kernels for the TPU: each
wrapper runs a BODY (``_chol_panel_kernel``, ``_chol_panel_kernel2``) in its
own ``pl.pallas_call(..., interpret=True)`` over the whole (B, 128, 128)
batch, as the reference's tests run the v3 kernel.
"""

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from auxpm_tpu.ops import chol_pallas as cp


def interpret_v1(tiles):
    """-> (L, inv(L)), both lower."""
    spec = pl.BlockSpec(tiles.shape, lambda i: (0, 0, 0))
    shape = jax.ShapeDtypeStruct(tiles.shape, tiles.dtype)
    return pl.pallas_call(cp._chol_panel_kernel, grid=(1,), in_specs=[spec],
                          out_specs=(spec, spec), out_shape=(shape, shape),
                          interpret=True)(tiles)


def interpret_v2(tiles):
    """-> L (the body writes L^T; swapped back, as the reference's wrapper
    does)."""
    from jax.experimental.pallas import tpu as pltpu

    spec = pl.BlockSpec(tiles.shape, lambda i: (0, 0, 0))
    lt = pl.pallas_call(
        cp._chol_panel_kernel2, grid=(1,), in_specs=[spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct(tiles.shape, tiles.dtype),
        scratch_shapes=[pltpu.VMEM(tiles.shape, jnp.float32)],
        interpret=True)(tiles)
    return jnp.swapaxes(lt, -1, -2)
