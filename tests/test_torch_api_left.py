"""The last public names of the JAX package, held to the reference (CPU).

- ``ops/logsumexp.masked_logsumexp`` against the reference's on the same
  NumPy inputs, over every axis and all of them, with and without kept
  axes; an all-masked row gives -inf;
- ``ops/cholesky.chol_with_jitter`` at jitter 0 and 1e-3 within 1e-5;
- ``core/transition.repeat`` of a toy ``aux_slice`` step, n = 3, against the
  reference's under ``vmap``: keys bitwise, the last step's decisions equal,
  theta and log L-hat within 1e-5 (the bars of ``tests/test_torch_keys.py``);
- ``core/state.init_chain_state`` key for key on the Gaussian toy and on a
  small GP target, with and without the carried factor, and equal bit for
  bit to its chain of ``init_chain_states``;
- ``utils/profiling.timed`` and ``device_sync`` as the reference's are
  tested (``tests/test_distributed.py``), and ``cost_analysis``'s FLOPs equal
  to XLA's on the CPU;
- the packages' ``__init__`` files export what the reference's do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import auxpm_tpu.core as j_core
import auxpm_tpu.ops as j_ops
from auxpm_tpu.core.state import init_chain_state as j_init_one
from auxpm_tpu.core.transition import repeat as j_repeat
from auxpm_tpu.models.datasets import load as jload
from auxpm_tpu.models.gaussian_toy import make_gaussian_toy as j_toy
from auxpm_tpu.models.gp_classification import make_gp_classification as jmake
from auxpm_tpu.ops.cholesky import chol_with_jitter as j_chol
from auxpm_tpu.ops.logsumexp import masked_logsumexp as j_mlse
from auxpm_tpu.samplers.composite import SAMPLERS as J_SAMPLERS
from auxpm_tpu.utils.profiling import cost_analysis as j_cost
import auxpm_tpu_torch.core as t_core
import auxpm_tpu_torch.ops as t_ops
from auxpm_tpu_torch.core import prng
from auxpm_tpu_torch.core.state import init_chain_states as t_init_many
from auxpm_tpu_torch.core.transition import repeat as t_repeat
from auxpm_tpu_torch.models.gaussian_toy import make_gaussian_toy as t_toy
from auxpm_tpu_torch.models.gp_classification import (
    make_gp_classification as tmake,
)
from auxpm_tpu_torch.ops.cholesky import chol_with_jitter as t_chol
from auxpm_tpu_torch.ops.logsumexp import masked_logsumexp as t_mlse
from auxpm_tpu_torch.samplers.composite import SAMPLERS
from auxpm_tpu_torch.utils.profiling import cost_analysis, device_sync, timed

SEED = 5
U_ULP = 4
TOL = {"toy": {"theta": 1e-5, "ll": 1e-5}, "gp": {"theta": 1e-4, "ll": 2e-4}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def targets():
    x, y = jload("pima", subsample=100)
    return {
        "toy": (j_toy(n_importance=16, noise_frac=0.5),
                t_toy(n_importance=16, noise_frac=0.5, device="cpu")),
        "gp": (jmake(x, y, n_importance=16),
               tmake(x, y, n_importance=16, device="cpu")),
    }


def _words(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


# ------------------------------------------------------------- logsumexp


@pytest.mark.parametrize("dim", [None, 0, 1, -1])
@pytest.mark.parametrize("keepdim", [False, True])
def test_masked_logsumexp_matches_the_reference(dim, keepdim):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((5, 7)) * 30.0).astype(np.float32)
    mask = rng.random((5, 7)) < 0.6
    mask[2] = False                      # an all-masked row
    mask[:, 3] = False                   # and an all-masked column
    want = np.asarray(j_mlse(jnp.asarray(x), jnp.asarray(mask), axis=dim,
                             keepdims=keepdim))
    got = t_mlse(torch.tensor(x), torch.tensor(mask), dim=dim,
                 keepdim=keepdim).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if dim in (1, -1):
        assert np.isneginf(got.reshape(5)[2])
    if dim == 0:
        assert np.isneginf(got.reshape(7)[3])


def test_masked_logsumexp_all_masked_is_minus_inf():
    x = torch.tensor([1.0, -2.0, 3.0])
    got = t_mlse(x, torch.zeros(3, dtype=torch.bool))
    want = j_mlse(jnp.asarray(x.numpy()), jnp.zeros(3, bool))
    assert float(got) == float(want) == -np.inf


# ---------------------------------------------------------------- cholesky


@pytest.mark.parametrize("jitter", [0.0, 1e-3])
def test_chol_with_jitter_matches_the_reference(jitter):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((4, 48, 48))
    gram = (a @ a.transpose(0, 2, 1) / 48 + 0.5 * np.eye(48)).astype(
        np.float32)
    want = np.asarray(j_chol(jnp.asarray(gram), jitter))
    got = t_chol(torch.tensor(gram), jitter).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np.triu(got, 1), 0.0)


# ------------------------------------------------------------------ repeat


def test_repeat_of_a_toy_aux_slice_step_matches_the_reference(targets):
    tj, tt = targets["toy"]
    n_chains, n = 4, 3
    kw = {"n_ess": 2}
    pj = {"ess_u": {}, "slice_theta": {
        "widths": jnp.asarray([1.0, 0.8], jnp.float32), "max_step_out": 0}}
    pt = {"ess_u": {}, "slice_theta": {
        "widths": torch.tensor([1.0, 0.8]), "max_step_out": 0}}
    from auxpm_tpu.core.state import init_chain_states as j_init_many

    sj = j_init_many(jax.random.key(SEED), tj, n_chains, jitter_scale=0.3)
    st = t_init_many(SEED, tt, n_chains, jitter_scale=0.3)
    rep_j = j_repeat(J_SAMPLERS["aux_slice"](tj, **kw), n)
    rep_t = t_repeat(SAMPLERS["aux_slice"](tt, **kw), n)
    sj, info_j = jax.vmap(lambda c: rep_j(c, pj))(sj)
    st, info_t = rep_t(st, pt)
    np.testing.assert_array_equal(st.key.numpy(), _words(sj.key))
    assert set(info_t) == set(info_j)
    for k in ("ess_u/moved", "ess_u/n_shrink", "slice_theta/n_probe"):
        np.testing.assert_array_equal(info_t[k].numpy(), np.asarray(info_j[k]),
                                      err_msg=k)
    np.testing.assert_allclose(st.theta.numpy(), np.asarray(sj.theta),
                               rtol=0, atol=TOL["toy"]["theta"])
    np.testing.assert_allclose(st.log_lik_hat.numpy(),
                               np.asarray(sj.log_lik_hat), rtol=0,
                               atol=TOL["toy"]["ll"])
    # n applications of the step itself, the same bits
    st2 = t_init_many(SEED, tt, n_chains, jitter_scale=0.3)
    step = SAMPLERS["aux_slice"](tt, **kw)
    for _ in range(n):
        st2, _ = step(st2, pt)
    assert torch.equal(st2.theta, st.theta) and torch.equal(st2.u, st.u)


# -------------------------------------------------------- init_chain_state


@pytest.mark.parametrize("name", ["toy", "gp"])
@pytest.mark.parametrize("with_cache", [False, True])
def test_init_chain_state_matches_the_reference_key_for_key(targets, name,
                                                            with_cache):
    tj, tt = targets[name]
    kj = jax.random.split(jax.random.key(SEED), 3)[1]
    kt = prng.split(prng.key(SEED), 3)[1]
    np.testing.assert_array_equal(kt.numpy(), _words(kj))
    sj = j_init_one(kj, tj, jitter_scale=0.3, with_cache=with_cache)
    st = t_core.init_chain_state(kt, tt, jitter_scale=0.3,
                                 with_cache=with_cache)
    assert st.theta.shape == (1, *sj.theta.shape)
    assert st.u.shape == (1, *sj.u.shape)
    np.testing.assert_array_equal(st.key.numpy()[0], _words(sj.key))
    assert _ulps(st.u.numpy()[0], np.asarray(sj.u)).max() <= U_ULP
    assert _ulps(st.theta.numpy()[0], np.asarray(sj.theta)).max() <= U_ULP
    np.testing.assert_allclose(st.log_lik_hat.numpy()[0],
                               np.asarray(sj.log_lik_hat), rtol=0,
                               atol=TOL[name]["ll"])
    has_cache = with_cache and tj.cache_init is not None
    assert ("target_cache" in st.extras) == has_cache
    assert ("target_cache" in sj.extras) == has_cache
    if has_cache:
        for k, v in sj.extras["target_cache"].items():
            np.testing.assert_allclose(
                st.extras["target_cache"][k].numpy()[0], np.asarray(v),
                rtol=0, atol=1e-5, err_msg=k)
    # the same chain as row 1 of init_chain_states, bit for bit
    many = t_init_many(SEED, tt, 3, jitter_scale=0.3, with_cache=with_cache)
    for f in ("theta", "u", "log_lik_hat", "key"):
        assert torch.equal(getattr(st, f)[0], getattr(many, f)[1]), f


def test_init_chain_state_defaults_take_theta_init(targets):
    tj, tt = targets["toy"]
    st = t_core.init_chain_state(prng.key(SEED), tt)
    sj = j_init_one(jax.random.key(SEED), tj)
    np.testing.assert_array_equal(st.theta.numpy()[0], np.asarray(sj.theta))
    np.testing.assert_array_equal(st.key.numpy()[0], _words(sj.key))


# --------------------------------------------------------------- profiling


def test_timed_and_device_sync():
    f = lambda a: a @ a.T   # noqa: E731
    a = torch.tensor(np.random.default_rng(0).standard_normal((128, 128)),
                     dtype=torch.float32)
    dt, out = timed(f, a, reps=2)
    assert dt > 0 and out.shape == (128, 128)
    st = t_init_many(0, t_toy(device="cpu"), 2)
    assert device_sync(st) is st
    assert device_sync({"a": [a, (a, 3)], "b": None}) is not None


def test_cost_analysis_flops_equal_xla():
    a = np.random.default_rng(1).standard_normal((128, 96)).astype(np.float32)
    want = j_cost(lambda m: m @ m.T, jnp.asarray(a))["flops"]
    got = cost_analysis(lambda m: m @ m.T, torch.tensor(a))
    assert set(got) == {"flops"}
    assert got["flops"] == want == 2 * 128 * 128 * 96


# ----------------------------------------------------------------- exports


@pytest.mark.parametrize("pkg", ["core", "ops"])
def test_init_files_export_what_the_reference_exports(pkg):
    j_mod, t_mod = {"core": (j_core, t_core), "ops": (j_ops, t_ops)}[pkg]
    names = {n for n in vars(j_mod) if not n.startswith("_")
             and not isinstance(getattr(j_mod, n), type(j_mod))}
    assert names, pkg
    for n in names:
        assert callable(getattr(t_mod, n)), n
