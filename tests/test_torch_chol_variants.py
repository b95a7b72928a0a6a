"""PyTorch port vs the JAX package: the v1 and v2 factorisation routes (CPU).

The reference's panel kernels are Pallas kernels for the TPU; here their
BODIES (``_chol_panel_kernel``, ``_chol_panel_kernel2``) run in interpret mode
(``test_torch_panel_bodies.py``), as the reference's tests run the v3 kernel,
and the port's panel functions are held to them.  The reference's
blocked loops call the kernels without interpret mode and cannot run here;
off the TPU ``cholesky_fast`` IS ``jnp.linalg.cholesky``, so the port's
blocked loops are held to that.  The plain-JAX helpers (``tri_inv_newton``,
``pad_gram``) are compared directly.

Tolerances: two float32 factors of one matrix differ elementwise by more than
either differs from the matrix it reproduces, so factors are held to the
backward error max |L L^T - K| <= 1e-5 (entries of K are <= 1.01) and, for
the well-conditioned bench matrices used here (jitter 1e-2), elementwise to
5e-4, the bar of the reference's Cholesky tests; inverses to
max |inv(L) L - I| <= 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auxpm_tpu.ops import chol_pallas as cp
from auxpm_tpu_torch.ops import chol_hopper as ch
from auxpm_tpu_torch.utils import chol_bench
from tests.test_torch_panel_bodies import interpret_v1, interpret_v2

BACK_TOL, L_TOL, INV_TOL = 1e-5, 5e-4, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs several workers
    on the same cores, where multi-threaded small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(scope="module")
def batch():
    """The bench's SE-Gram batch, small: (3, 256, 256), jitter 1e-2."""
    return chol_bench.make_batch(3, 256, seed=0)


def _backward(l, k):
    return float((torch.bmm(l, l.mT) - k).abs().max())


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_panel_functions_match_the_reference_bodies(batch, version):
    tiles = np.ascontiguousarray(batch[:, :128, :128])
    eye = torch.eye(128)
    if version == "v1":
        l_t, x_t = ch.chol_panel_batched(_t(tiles))
        l_j, x_j = interpret_v1(jnp.asarray(tiles))
        np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=0,
                                   atol=L_TOL)
        assert float((torch.bmm(x_t, l_t) - eye).abs().max()) <= INV_TOL
        assert float(torch.triu(x_t, 1).abs().max()) == 0.0
    else:
        l_t = ch.chol_panel_batched2(_t(tiles))
        l_j = interpret_v2(jnp.asarray(tiles))
    np.testing.assert_allclose(l_t.numpy(), np.tril(np.asarray(l_j)), rtol=0,
                               atol=L_TOL)
    assert _backward(l_t, _t(tiles)) <= BACK_TOL
    assert float(torch.triu(l_t, 1).abs().max()) == 0.0
    # failure is NaN on L's diagonal, for the failing tile alone
    sick = _t(tiles)
    sick[1] -= 0.5 * eye
    fn = ch.chol_panel_batched if version == "v1" else ch.chol_panel_batched2
    out = fn(sick)
    d = torch.diagonal(out[0] if version == "v1" else out, dim1=-2, dim2=-1)
    assert torch.isnan(d[1]).any() and torch.isfinite(d[[0, 2]]).all()
    with pytest.raises(ValueError, match="tiles"):
        ch._require_tiles(_t(tiles)[:, :64, :64])


def test_tri_inv_newton_and_pad_gram_match_the_reference(batch):
    l = np.linalg.cholesky(batch[:, :128, :128].astype(np.float64)).astype(
        np.float32)
    x_t = ch.tri_inv_newton(_t(l))
    x_j = cp.tri_inv_newton(jnp.asarray(l))
    # the same iteration in the same order: float32 products in another
    # summation order only
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=0, atol=2e-5)
    assert float((torch.bmm(x_t, _t(l)) - torch.eye(128)).abs().max()) \
        <= INV_TOL
    assert float(torch.triu(x_t, 1).abs().max()) <= 1e-6
    k = batch[:, :200, :200]
    np.testing.assert_array_equal(ch.pad_gram(_t(k), 256).numpy(),
                                  np.asarray(cp.pad_gram(jnp.asarray(k), 256)))
    assert ch.pad_gram(_t(k), 200) is not None
    assert ch.pad_gram(_t(k), 200).shape == k.shape


@pytest.mark.parametrize("route", ["cholesky_batched", "cholesky_batched2",
                                   "cholesky_batched3"])
def test_blocked_routes_match_the_reference_factor(batch, route):
    k = _t(batch)
    l = getattr(ch, route)(k)
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(batch)))
    np.testing.assert_allclose(l.numpy(), want, rtol=0, atol=L_TOL)
    assert _backward(l, k) <= BACK_TOL
    assert float(torch.triu(l, 1).abs().max()) == 0.0
    with pytest.raises(ValueError, match="pad_gram"):
        getattr(ch, route)(k[:, :200, :200])


@pytest.mark.parametrize("shape", [(3, 200, 200), (2, 2, 70, 70),
                                   (1, 256, 256)])
def test_cholesky_fast_any_size_and_batch_dims(shape):
    n = shape[-1]
    flat = chol_bench.make_batch(int(np.prod(shape[:-2])), n, seed=2)
    k = flat.reshape(shape)
    l = ch.cholesky_fast(_t(k))
    assert l.shape == shape
    # off the TPU the reference's cholesky_fast is jnp.linalg.cholesky
    want = np.asarray(cp.cholesky_fast(jnp.asarray(k)))
    np.testing.assert_allclose(l.numpy(), want, rtol=0, atol=L_TOL)
    assert _backward(l.reshape(-1, n, n), _t(flat)) <= BACK_TOL


def test_chol_bench_reports_every_route_on_the_cpu(capsys):
    assert chol_bench.main(["--batch", "2", "--n", "200", "--reps", "1",
                            "--device", "cpu"]) == 0
    import json

    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(report["routes"]) == ["library", "v1", "v2", "v3"]
    for name, r in report["routes"].items():
        assert r["ms"] is None            # no time is taken on the CPU
        assert r["finite"] and r["lower"] and r["backward_err_rel"] <= BACK_TOL
    assert max(report["panel_inverse_residual"].values()) <= INV_TOL
    assert report["device"] == "cpu" and report["n_padded"] == 256

