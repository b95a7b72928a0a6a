"""PyTorch port vs the JAX package: the GP-classification target (CPU).

Both targets are built from the same ``(x, y)`` NumPy arrays (200 points of
the Pima stand-in, padded to n=256, S=16) and evaluated at the same theta and
u.  Tolerances: prepare() is an f32 Cholesky of a Gram with condition number
~1e5 computed by two different LAPACK-style routines (5e-4, the bar of the
reference's Cholesky tests); the estimate sums ~n O(1) f32 terms in a
different order on each side (2e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auxpm_tpu.models.datasets import load as jload
from auxpm_tpu.models.gp_classification import (
    make_gp_classification as jmake,
)
from auxpm_tpu.ops.sigma_sweep import make_fused_sigma_sweep as j_sigma_sweep
from auxpm_tpu_torch.core import prng
from auxpm_tpu_torch.core.state import init_chain_states, refresh_target_cache
from auxpm_tpu_torch.models.datasets import load as tload
from auxpm_tpu_torch.models.gp_classification import (
    make_gp_classification as tmake,
)

S = 16
THETAS = np.float32([[0.0, 0.0], [-0.6, 0.4], [0.7, -0.5]])


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


def _data():
    x, y = tload("pima", subsample=200)
    xj, yj = jload("pima", subsample=200)
    np.testing.assert_array_equal(x, xj)
    np.testing.assert_array_equal(y, yj)
    return x, y


@pytest.fixture(scope="module")
def targets():
    x, y = _data()
    return {
        lik: (jmake(x, y, n_importance=S, likelihood=lik),
              tmake(x, y, n_importance=S, likelihood=lik, device="cpu"))
        for lik in ("logistic", "probit")
    }


def test_dataset_copy_is_bit_identical_and_unknown_names_raise():
    _data()
    with pytest.raises(ValueError, match="unknown dataset"):
        tload("no_such_dataset")


@pytest.mark.parametrize("likelihood", ["logistic", "probit"])
def test_target_matches_jax(targets, likelihood):
    tj, tt = targets[likelihood]
    assert tt.u_shape == tj.u_shape == (S, 256)
    assert tt.d == tj.d == 2 and tt.n_weight_blocks == tj.n_weight_blocks == 8
    assert tt.name == tj.name
    u = np.random.default_rng(0).standard_normal((3, S, 256)).astype(np.float32)

    lp_j = jax.vmap(tj.log_prior)(jnp.asarray(THETAS))
    np.testing.assert_allclose(tt.log_prior(_t(THETAS)).numpy(),
                               np.asarray(lp_j), rtol=1e-6, atol=1e-6)

    prep_j = jax.jit(jax.vmap(tj.prepare))(jnp.asarray(THETAS))
    prep_t = tt.prepare(_t(THETAS))
    np.testing.assert_allclose(prep_t.numpy(), np.asarray(prep_j), atol=5e-4)

    cache_j = jax.jit(jax.vmap(tj.cache_init))(jnp.asarray(THETAS))
    cache_t = tt.cache_init(_t(THETAS))
    np.testing.assert_allclose(cache_t["chol_r"].numpy(),
                               np.asarray(cache_j["chol_r"]), atol=5e-4)
    # the cache contract: prepare_c off the cache == prepare
    assert torch.equal(tt.prepare_c(_t(THETAS), cache_t), prep_t)

    ll_j = jax.jit(jax.vmap(tj.log_lik_est))(jnp.asarray(THETAS),
                                             jnp.asarray(u))
    ll_t = tt.log_lik_est(_t(THETAS), _t(u))
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(
        tt.log_joint(_t(THETAS), _t(u)).numpy(),
        np.asarray(lp_j) + np.asarray(ll_j), rtol=0, atol=2e-4)


def test_padding_is_exact(targets):
    """Padded rows change nothing: the padded target's estimate equals the
    unpadded one's on the real block of u."""
    x, y = _data()
    _, tt = targets["logistic"]
    t_raw = tmake(x, y, n_importance=S, pad_to_tiles=False, device="cpu")
    assert t_raw.u_shape == (S, 200)
    u = np.random.default_rng(1).standard_normal((3, S, 256)).astype(np.float32)
    ll_pad = tt.log_lik_est(_t(THETAS), _t(u))
    ll_raw = t_raw.log_lik_est(_t(THETAS), _t(u[:, :, :200]))
    np.testing.assert_allclose(ll_pad.numpy(), ll_raw.numpy(), rtol=0,
                               atol=2e-4)


def test_sigma_sweep_factory_builds_the_reference_chain_row(targets):
    """The port's sigma_sweep_factory (chain row + sweep) against the JAX
    sweep fed the chain row the JAX factory builds (off the TPU that factory
    returns None, so the row is spelled here as in the reference)."""
    tj, tt = targets["logistic"]
    rng = np.random.default_rng(2)
    u = rng.standard_normal((3, S, 256)).astype(np.float32)
    rep = rng.uniform(size=(3, 2, 34)).astype(np.float32)
    rep[:, :, 0] = np.log(rep[:, :, 0])
    width = np.float32(1.1)
    theta_t = _t(THETAS)
    cache_t = tt.cache_init(theta_t)
    ll0 = tt.log_lik_est_u(tt.prepare_c(theta_t, cache_t), _t(u))
    lp0 = tt.log_prior(theta_t) + ll0
    out_t = tt.sigma_sweep_factory(2)(theta_t, _t(u), cache_t, ll0, lp0,
                                      _t(width), _t(rep))

    hiv = 0.5 / 1.5**2
    y_pad = np.concatenate([_data()[1], np.ones(56, np.float32)])
    mask = np.concatenate([np.ones(200, np.float32), np.zeros(56, np.float32)])
    sweep_j = j_sigma_sweep(jnp.asarray(y_pad), jnp.asarray(mask), "logistic",
                            force=False, n_blocks=8, n_reps=2)

    def one(theta, u_c, chol_r, ll0_c, lp0_c, rep_c):
        d0 = theta[1] - 0.0
        lp_rest = tj.log_prior(theta) + hiv * d0 * d0
        chain = jnp.stack([ll0_c, lp0_c, theta[1], jnp.float32(width),
                           jnp.float32(0.0), jnp.float32(hiv), lp_rest,
                           jnp.float32(0.0)])[None, :]
        return sweep_j(chol_r, u_c, chain, rep_c)

    out_j = jax.jit(jax.vmap(one))(
        jnp.asarray(THETAS), jnp.asarray(u),
        jnp.asarray(cache_t["chol_r"].numpy()), jnp.asarray(ll0.numpy()),
        jnp.asarray(lp0.numpy()), jnp.asarray(rep))
    sig_t, ll_t, lp_t, ns_t, mv_t = (o.numpy() for o in out_t)
    sig_j, ll_j, lp_j, ns_j, mv_j = (np.asarray(o) for o in out_j)
    np.testing.assert_array_equal(ns_t, ns_j)
    np.testing.assert_array_equal(mv_t, mv_j)
    np.testing.assert_allclose(sig_t, sig_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ll_t, ll_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(lp_t, lp_j, rtol=0, atol=1e-4)


def test_init_chain_states_holds_the_cache_invariant(targets):
    _, tt = targets["logistic"]
    st = init_chain_states(5, tt, 4, jitter_scale=0.3, with_cache=True)
    assert st.theta.shape == (4, 2) and st.u.shape == (4, S, 256)
    assert st.log_lik_hat.shape == (4,)
    assert torch.isfinite(st.log_lik_hat).all()
    assert st.theta.std() > 0  # overdispersed starts
    assert torch.equal(st.extras["target_cache"]["chol_r"],
                       tt.cache_init(st.theta)["chol_r"])
    assert torch.equal(st.log_lik_hat, tt.log_lik_est(st.theta, st.u))
    # same seed, same chains
    st2 = init_chain_states(5, tt, 4, jitter_scale=0.3, with_cache=True)
    assert torch.equal(st.u, st2.u) and torch.equal(st.theta, st2.theta)
    # a theta-changing kernel that is not cache-aware refreshes the factor
    ex = refresh_target_cache(tt, st.extras, st.theta + 0.1)
    assert not torch.equal(ex["target_cache"]["chol_r"],
                           st.extras["target_cache"]["chol_r"])
    assert refresh_target_cache(tt, {}, st.theta) == {}
    # without the cache the extras stay empty
    assert init_chain_states(5, tt, 2).extras == {}
    draws = tt.sample_prior_key(prng.split(prng.key(0), 1000))
    assert draws.shape == (1000, 2) and abs(float(draws.std()) - 1.5) < 0.15


@pytest.mark.parametrize("kwargs", [
    {"proposal": "laplace", "whiten_dtype": "bfloat16"},
    {"proposal": "laplace", "particle_axis": "mesh"},
    {"particle_axis": "particles"},
])
def test_unported_options_stop_loudly(kwargs):
    x, y = _data()
    if kwargs.get("particle_axis") == "particles":
        # particle sharding is ported: the axis is a parallel.mesh.Mesh (it
        # carries the process group); the reference's axis NAME is refused
        with pytest.raises(TypeError, match="Mesh"):
            tmake(x, y, n_importance=S, device="cpu", **kwargs)
        return
    if "whiten_dtype" in kwargs:
        # the reference's refusal: bf16 whitening is a prior-proposal option
        with pytest.raises(ValueError, match="prior proposal"):
            tmake(x, y, n_importance=S, device="cpu", **kwargs)
        return
    # the Laplace proposal on a particle-sharded target is ported: it builds
    # (the collectives run only when it estimates, on two ranks in
    # tests/test_torch_sharded_grad.py)
    from auxpm_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(rank=0, world=2, n_chain_shards=1, n_particle_shards=2,
                chain_index=0, particle_index=0, particle_group=None,
                chain_group=None)
    target = tmake(x, y, n_importance=S, device="cpu",
                   **{**kwargs, "particle_axis": mesh})
    assert target.name.endswith("_laplace@particles")
    assert target.make_sharded is None and target.ess_sweep_factory is None


def test_cuda_device_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = _data()
    with pytest.raises(RuntimeError, match="cuda"):
        tmake(x, y, n_importance=S)  # device defaults to "cuda"
