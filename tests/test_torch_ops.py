"""PyTorch port vs the JAX package: the ops layer (CPU, plain versions).

Every test makes its inputs with ``np.random.default_rng(seed)`` and hands the
same arrays to the JAX function and to its counterpart in ``auxpm_tpu_torch``
(on ``device="cpu"``, where each kernel wrapper takes its plain PyTorch
version).  Where the JAX function reaches a Pallas kernel it runs in
interpret mode, as the JAX package's own tests run it.

Tolerances: both sides work in float32 and sum ~n O(1) terms in different
orders (XLA vs PyTorch's CPU kernels), so values agree to ~1e-5 relative,
never bitwise; decisions (shrink counts, moved flags) must be EQUAL, and the
sweep tests assert that no decision of the run sat within the value tolerance
of its boundary, so a flipped decision cannot hide.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auxpm_tpu.models import likelihoods as jlik
from auxpm_tpu.ops import chol_pallas as jchol
from auxpm_tpu.ops import ess_sweep as jess
from auxpm_tpu.ops import fused_estimator as jfe
from auxpm_tpu.ops import gram as jgram
from auxpm_tpu.ops import sigma_sweep as jsig
from auxpm_tpu.ops.cholesky import _robust_cholesky_impl as j_robust_impl
from auxpm_tpu.ops.logsumexp import blocked_logsumexp as j_blocked_lse
from auxpm_tpu_torch.models import likelihoods as tlik
from auxpm_tpu_torch.ops import chol_hopper as tchol
from auxpm_tpu_torch.ops import cholesky as tcholesky
from auxpm_tpu_torch.ops import ess_sweep as tess
from auxpm_tpu_torch.ops import fused_estimator as tfe
from auxpm_tpu_torch.ops import gram as tgram
from auxpm_tpu_torch.ops import sigma_sweep as tsig
from auxpm_tpu_torch.ops.logsumexp import block_partials, blocked_logsumexp

S, N, B = 16, 256, 3


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


# ---------------------------------------------------------------- likelihoods


def test_log_ndtr_matches_jax_over_wide_range():
    z = np.concatenate([np.linspace(-30.0, 30.0, 2001),
                        np.random.default_rng(0).normal(size=500) * 3.0])
    z = z.astype(np.float32)
    got = tlik.log_ndtr(_t(z)).numpy()
    want = np.asarray(jlik.log_ndtr(jnp.asarray(z)))
    # same polynomial in f32 on both sides; exp/log differ by ulps
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("likelihood", ["logistic", "probit"])
def test_log_lik_matches_jax(likelihood):
    rng = np.random.default_rng(1)
    f = (rng.standard_normal((5, 64)) * 4.0).astype(np.float32)
    y = rng.choice([-1.0, 1.0], 64).astype(np.float32)
    mask = (rng.uniform(size=64) > 0.2).astype(np.float32)
    got = tlik.LIKELIHOODS[likelihood](_t(f), _t(y), _t(mask)).numpy()
    want = np.asarray(jlik.LIKELIHOODS[likelihood](
        jnp.asarray(f), jnp.asarray(y), jnp.asarray(mask)))
    # rtol 2e-6 on a sum of 64 O(1) terms
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-5)


# ------------------------------------------------------------------ logsumexp


@pytest.mark.parametrize("n_blocks", [1, 8])
def test_blocked_logsumexp_matches_jax(n_blocks):
    rng = np.random.default_rng(2)
    lw = (rng.standard_normal((4, 64)) * 5.0 - 40.0).astype(np.float32)
    lw[1, 8:24] = -np.inf          # two all--inf blocks in the middle
    lw[2, :] = -np.inf             # everything -inf
    lw[3, :8] = -np.inf            # first block -inf
    got = blocked_logsumexp(_t(lw), n_blocks).numpy()
    want = np.stack([
        np.asarray(j_blocked_lse(jnp.asarray(row), n_blocks))
        for row in lw
    ])
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


def test_block_partials_reject_ragged_blocks():
    with pytest.raises(ValueError):
        block_partials(torch.zeros(10), 4)


# ----------------------------------------------------------------------- gram


def test_se_gram_iso_and_sqdist_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((40, 5)).astype(np.float32)
    sq_t = tgram.pairwise_sqdist(_t(x))
    sq_j = jgram.pairwise_sqdist(jnp.asarray(x))
    # cancellation in |xi|^2 + |xj|^2 - 2 xi.xj: absolute error ~1e-5
    np.testing.assert_allclose(sq_t.numpy(), np.asarray(sq_j), atol=2e-5)
    log_ell = np.float32([-0.3, 0.4])
    log_sigma = np.float32([0.2, -0.1])
    got = tgram.se_gram_iso(_t(np.asarray(sq_j)), _t(log_ell), _t(log_sigma),
                            1e-5).numpy()
    for b in range(2):
        want = np.asarray(jgram.se_gram_iso(sq_j, log_ell[b], log_sigma[b],
                                            1e-5))
        np.testing.assert_allclose(got[b], want, rtol=2e-6, atol=1e-7)


# ------------------------------------------------------------------ estimator


def _estimator_inputs(seed, b=B, s=S, n=N):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, s, n)).astype(np.float32)
    chol = (np.tril(rng.standard_normal((b, n, n)) * 0.05)
            + np.eye(n)).astype(np.float32)
    y = rng.choice([-1.0, 1.0], n).astype(np.float32)
    mask = np.ones(n, np.float32)
    mask[-37:] = 0.0
    return chol, u, y, mask


@pytest.mark.parametrize("likelihood", ["logistic", "probit"])
def test_estimator_matches_jax_ref_and_interpret_kernel(likelihood):
    chol, u, y, mask = _estimator_inputs(4)
    got = tfe.fused_estimate(_t(chol), _t(u), _t(y), _t(mask), likelihood,
                             n_blocks=8).numpy()
    ref = np.stack([
        np.asarray(jfe._ref_estimate(jnp.asarray(chol[b]), jnp.asarray(u[b]),
                                     jnp.asarray(y), jnp.asarray(mask),
                                     likelihood, n_blocks=8))
        for b in range(B)
    ])
    pallas = np.asarray(jfe._pallas_estimate(
        jnp.asarray(chol[0]), jnp.asarray(u[0]), jnp.asarray(y),
        jnp.asarray(mask), likelihood, n_blocks=8, interpret=True))
    # 1e-4: the reference's own interpret-vs-ref bar (f32 sums of n terms,
    # column-blocked differently on each side)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[0], pallas, rtol=0, atol=1e-4)


def test_estimator_bfloat16_matches_jax_ref():
    chol, u, y, mask = _estimator_inputs(5)
    got = tfe.fused_estimate(_t(chol), _t(u), _t(y), _t(mask), "logistic",
                             n_blocks=8, whiten_dtype="bfloat16").numpy()
    ref = np.stack([
        np.asarray(jfe._ref_estimate(jnp.asarray(chol[b]), jnp.asarray(u[b]),
                                     jnp.asarray(y), jnp.asarray(mask),
                                     "logistic", n_blocks=8,
                                     whiten_dtype=jnp.bfloat16))
        for b in range(B)
    ])
    # both round the operands to bf16 and accumulate exact products in f32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_probe_shape_checks_raise():
    tfe.check_probe_shapes(64, 640, 8)
    tfe.check_probe_shapes(64, 600, 8)         # a partial last column tile
    tfe.check_probe_shapes(128, 640, 8)        # two row blocks
    tfe.check_probe_shapes(tfe.MAX_SAMPLES, 640, 8)
    with pytest.raises(ValueError, match="importance samples"):
        tfe.check_probe_shapes(tfe.MAX_SAMPLES + 1, 640)   # past the limit
    with pytest.raises(ValueError):
        tfe.check_probe_shapes(64, 640, 7)     # blocks do not divide S
    with pytest.raises(ValueError):
        tfe.check_probe_shapes(0, 640, 8)      # no rows
    with pytest.raises(ValueError):
        tfe.fused_estimate(torch.zeros(1, 64, 64), torch.zeros(1, 8, 64),
                           torch.ones(64), torch.ones(64), "cauchy")


def test_sweep_body_shape_checks_take_any_n():
    # every estimator kernel runs on csrc/sweep_body.cuh, whose shared
    # memory depends on neither n nor S: any n, S up to MAX_SAMPLES; the
    # sweeps, which only padded targets get, take n a multiple of 64
    tfe.check_probe_shapes(64, 4096, 8)
    tfe.check_probe_shapes(64, 4000, 8)
    tfe.check_probe_shapes(65, 4096)
    tfe.check_probe_shapes(100, 531, 1)
    for n in (1, 101, 4177):
        assert tfe.probe_shape_error(512, n, 8) is None
        assert not tfe.fits_sweep_body(512, n, 8)
    assert tfe.fits_sweep_body(512, 640, 8)
    with pytest.raises(ValueError):
        tfe.check_probe_shapes(4097, 4096, 1)
    with pytest.raises(ValueError):
        tfe.check_probe_shapes(64, 0, 8)


@pytest.mark.parametrize("s,n,n_blocks", [
    (16, 1024, 8),    # n above the old left-operand limit (~880)
    (64, 256, 8),
    (80, 256, 8),     # two row blocks, the second partial
    (16, 200, 8),     # a partial last column tile: the entries only
    (16, 256, 3),     # a reduction tree that does not divide S
    (4097, 64, 1),    # more importance samples than the kernels take
])
def test_sweep_wrappers_refuse_exactly_where_the_gate_says(s, n, n_blocks):
    """The sweeps' wrappers refuse exactly where ``sweep_shape_error`` (the
    gate ``fits_sweep_body``) says, the entries' exactly where
    ``probe_shape_error`` says, each with that message; where the shapes
    are taken they stop only at the CPU tensor."""
    sweep_err = tfe.sweep_shape_error(s, n, n_blocks)
    assert tfe.fits_sweep_body(s, n, n_blocks) == (sweep_err is None)
    if s > tfe.MAX_SAMPLES:
        assert "importance samples" in sweep_err
    z = torch.zeros
    # (call, why it refuses or None): the weights have no reduction tree
    calls = {
        "ess": (lambda: tess._cuda_ess_sweep(
            z(1, n, n), z(1, s, n), z(1, 1, 35), z(1, 1, s, n), z(n), z(n),
            "logistic", n_blocks, None, 1, "float32"), sweep_err),
        "sigma": (lambda: tsig._cuda_sigma_sweep(
            z(1, n, n), z(1, s, n), z(1, 8), z(1, 1, 34), z(n), z(n),
            "logistic", n_blocks, None, 1, "float32"), sweep_err),
        "rot_weights": (lambda: tfe._cuda_rot_weights(
            z(1, n, n), z(1, s, n), z(1, s, n), z(1), z(n), z(n),
            "logistic", "float32", None), tfe.probe_shape_error(s, n)),
        "weights": (lambda: tfe._cuda_weights(
            z(1, n, n), z(1, s, n), z(n), z(n), "logistic", "float32"),
            tfe.probe_shape_error(s, n)),
        "estimate_rot": (lambda: tfe._cuda_estimate_rot(
            z(1, n, n), z(1, s, n), z(1, s, n), z(1), z(n), z(n),
            "logistic", n_blocks, None, "float32", None),
            tfe.probe_shape_error(s, n, n_blocks)),
    }
    for name, (call, why) in calls.items():
        with pytest.raises(ValueError) as err:
            call()
        if why is None:
            assert "expected a CUDA tensor" in str(err.value), name
        else:
            assert str(err.value) == why, (name, str(err.value))


@pytest.mark.parametrize("s,pad", [(16, True), (80, True), (16, False)])
def test_sweep_factories_return_none_past_the_gate(s, pad):
    """The GP target's sweep factories return None exactly where the sweep
    body refuses its shapes or the target is unpadded (the reference's
    ``use_fused``); the step then takes the per-probe path."""
    from auxpm_tpu_torch.models.datasets import load
    from auxpm_tpu_torch.models.gp_classification import (
        make_gp_classification,
    )
    from auxpm_tpu_torch.samplers.composite import make_aux_slice

    x, y = load("pima", subsample=100)
    target = make_gp_classification(x, y, n_importance=s, pad_to_tiles=pad,
                                    device="cpu")
    assert tfe.fits_sweep_body(s, target.u_shape[1],
                               target.n_weight_blocks) == pad
    for factory in (target.ess_sweep_factory, target.sigma_sweep_factory):
        assert (factory(2) is not None) == pad
    step = make_aux_slice(target, n_ess=2)
    assert step.stages["ess_u"].uses_sweep == pad


@pytest.mark.parametrize("kernel", ["ess", "sigma", "rot_weights",
                                    "estimate_rot"])
def test_chain_slices_give_the_unsplit_result(kernel):
    """``over_chain_slices``, the split that the four wrappers with an
    active list make past ``MAX_CHAINS`` chains, on the plain versions with
    a limit of 2 chains: each chain's result is its unsplit one."""
    chol, u, scal, v, y, mask = (_t(a) for a in _ess_inputs(40, 2,
                                                             "logistic"))
    if kernel == "ess":
        fn = lambda c, u_, sc, v_: tess._ref_ess_sweep(  # noqa: E731
            c, u_, sc, v_, y, mask, "logistic", 8, None, 2, "float32")
        chained = (chol, u, scal, v)
    elif kernel == "sigma":
        rng = np.random.default_rng(41)
        chain = np.zeros((B, 8), np.float32)
        chain[:, 0] = scal[:, 0, 0].numpy()
        chain[:, 1] = chain[:, 0] - 3.0
        chain[:, 3], chain[:, 5] = 1.3, 0.2
        rep = rng.uniform(size=(B, 2, 34)).astype(np.float32)
        rep[:, :, 0] = np.log(rep[:, :, 0])
        fn = lambda c, u_, ch, r: tsig._ref_sigma_sweep(  # noqa: E731
            c, u_, ch, r, y, mask, "logistic", 8, None, 2, "float32")
        chained = (chol, u, _t(chain), _t(rep))
    else:
        angle = _t(np.float32([0.3, -2.0, 1.1]))
        active = _t(np.float32([1.0, 0.0, 1.0]))
        if kernel == "rot_weights":
            fn = lambda c, u_, v_, a, act: tfe._ref_rot_weights(  # noqa: E731
                c, u_, v_, a, y, mask, "logistic", "float32", act)
        else:
            fn = lambda c, u_, v_, a, act: tfe._ref_estimate_rot(  # noqa: E731
                c, u_, v_, a, y, mask, "logistic", 8, None, "float32", act)
        chained = (chol, u, v[:, 0], angle, active)
    whole = fn(*chained)
    split = tfe.over_chain_slices(fn, chained, limit=2)
    for a, b in zip(whole if isinstance(whole, tuple) else (whole,),
                    split if isinstance(split, tuple) else (split,)):
        assert a.shape == b.shape and torch.equal(a, b)


# ------------------------------------------------------------------- cholesky


def _spd_batch(b, n, seed, jitter=1e-2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 3))
    sq = ((x[:, None] - x[None]) ** 2).sum(-1)
    ells = rng.uniform(0.5, 3.0, b)
    k = np.exp(-0.5 * sq[None] / ells[:, None, None] ** 2) + jitter * np.eye(n)
    return k.astype(np.float32)


def test_blocked_cholesky_matches_pallas_interpret_and_numpy():
    k = _spd_batch(2, 384, seed=6)
    got = tchol.cholesky_batched3(_t(k)).numpy()
    pallas = np.asarray(jchol.cholesky_batched3(jnp.asarray(k), bt=2,
                                                interpret=True))
    l_ref = np.linalg.cholesky(k.astype(np.float64))
    # 5e-4: the bar of the reference's own v3 test (f32 factor of an SE Gram
    # with condition number ~1e4, blocked in 128-panels)
    np.testing.assert_allclose(got, np.tril(l_ref), atol=5e-4)
    np.testing.assert_allclose(got, pallas, atol=5e-4)
    assert np.all(np.triu(got, 1) == 0.0)


def test_panel_returns_factor_and_transposed_inverse():
    k = _spd_batch(4, 128, seed=7)
    l, xt = tchol.chol_panel_batched3(_t(k))
    l_j, xt_j = jchol.chol_panel_batched3(jnp.asarray(k), bt=2, interpret=True)
    np.testing.assert_allclose(l.numpy(), np.asarray(l_j), atol=2e-4)
    # inv(L) @ L == I, to the reference test's 2e-4
    resid = np.einsum("bij,bjk->bik", xt.numpy().transpose(0, 2, 1), l.numpy())
    np.testing.assert_allclose(resid, np.broadcast_to(np.eye(128), resid.shape),
                               atol=2e-4)
    assert np.allclose(np.tril(xt.numpy(), -1), 0.0)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xt_j), atol=2e-3,
                               rtol=2e-3)


def test_panel_failure_is_nan_not_garbage():
    k = _spd_batch(2, 128, seed=8)
    k[1] -= 0.5 * np.eye(128, dtype=np.float32)  # indefinite
    l, xt = tchol.chol_panel_batched3(_t(k))
    assert torch.isfinite(l[0]).all() and torch.isfinite(xt[0]).all()
    assert torch.isnan(torch.diagonal(l[1])).any()


def test_robust_cholesky_escalates_per_matrix():
    k = _spd_batch(3, 128, seed=9, jitter=1e-3)
    # make matrix 1 slightly indefinite: shift below its smallest eigenvalue
    lam = np.linalg.eigvalsh(k[1].astype(np.float64))[0]
    k[1] -= np.float32(lam + 2e-4) * np.eye(128, dtype=np.float32)
    assert np.linalg.eigvalsh(k[1].astype(np.float64))[0] < 0
    l, extra = tcholesky._robust_cholesky_impl(_t(k), jitter0=1e-4)
    l_j, extra_j = jax.jit(lambda g: j_robust_impl(g, 1e-4, 10.0, 3))(
        jnp.asarray(k))
    extra = extra.numpy()
    assert extra[0] == 0.0 and extra[2] == 0.0     # healthy mates untouched
    assert extra[1] > 0.0
    np.testing.assert_allclose(extra, np.asarray(extra_j), rtol=1e-6)
    assert torch.isfinite(l).all()
    np.testing.assert_allclose(l.numpy()[[0, 2]], np.asarray(l_j)[[0, 2]],
                               atol=5e-4)
    # default base: 1e-6 * mean diag
    _, extra0 = tcholesky._robust_cholesky_impl(_t(k), jitter0=0.0,
                                                max_tries=1)
    np.testing.assert_allclose(extra0.numpy()[1],
                               1e-6 * np.diag(k[1]).mean(), rtol=1e-5)
    # whiten / logdet helpers
    u = _t(np.random.default_rng(0).standard_normal((3, 4, 128)))
    np.testing.assert_allclose(tcholesky.whiten(l, u).numpy(),
                               np.einsum("bsk,bik->bsi", u.numpy(), l.numpy()),
                               atol=1e-4)
    np.testing.assert_allclose(
        tcholesky.chol_logdet(l[0]).item(),
        np.linalg.slogdet(k[0].astype(np.float64))[1], rtol=1e-4)


# ------------------------------------------------------------------ ESS sweep


def _ess_inputs(seed, n_repeats, likelihood):
    chol, u, y, mask = _estimator_inputs(seed)
    rng = np.random.default_rng(seed + 100)
    v = rng.standard_normal((B, n_repeats, S, N)).astype(np.float32)
    ll0 = tfe._ref_estimate(_t(chol), _t(u), _t(y), _t(mask), likelihood,
                            n_blocks=8).numpy()
    scal = np.zeros((B, n_repeats, 3 + 32), np.float32)
    scal[:, 0, 0] = ll0
    scal[:, :, 1] = np.log(rng.uniform(size=(B, n_repeats)))
    scal[:, :, 2] = rng.uniform(size=(B, n_repeats)) * 2.0 * np.pi
    scal[:, :, 3:] = rng.uniform(size=(B, n_repeats, 32))
    return chol, u, scal, v, y, mask


def _assert_margins(probe_log, tol):
    """No decision of the run may sit within ``tol`` of its boundary."""
    margins = torch.cat([m[active].abs() for active, m in probe_log])
    assert margins.numel() > 0
    assert float(margins.min()) > tol, (
        f"a probe came within {float(margins.min()):.2e} of its slice level; "
        "pick another seed")


@pytest.mark.parametrize("n_repeats,likelihood",
                         [(1, "logistic"), (4, "logistic"), (2, "probit")])
def test_ess_sweep_matches_jax(n_repeats, likelihood):
    chol, u, scal, v, y, mask = _ess_inputs(10 + n_repeats, n_repeats,
                                            likelihood)
    probe_log = []
    u_t, ll_t, ns_t, mv_t = tess._ref_ess_sweep(
        _t(chol), _t(u), _t(scal), _t(v), _t(y), _t(mask), likelihood, 8, None,
        n_repeats, "float32", probe_log=probe_log)
    # and the public wrapper takes the same plain version on CPU tensors
    u_w, ll_w, ns_w, mv_w = tess.make_fused_ess_sweep(
        _t(y), _t(mask), likelihood, n_blocks=8, n_repeats=n_repeats)(
            _t(chol), _t(u), _t(scal), _t(v))
    assert torch.equal(u_w, u_t) and torch.equal(ll_w, ll_t)

    ref = jess.make_fused_ess_sweep(jnp.asarray(y), jnp.asarray(mask),
                                    likelihood, force=False, n_blocks=8,
                                    n_repeats=n_repeats)
    u_j, ll_j, ns_j, mv_j = jax.jit(jax.vmap(ref))(
        jnp.asarray(chol), jnp.asarray(u), jnp.asarray(scal), jnp.asarray(v))
    _assert_margins(probe_log, 1e-4)
    np.testing.assert_array_equal(ns_t.numpy(), np.asarray(ns_j))
    np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_j))
    # u' = u cos a + v sin a with a equal up to f32 rounding of the bracket
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=0,
                               atol=1e-4)
    assert float(ns_t.sum()) > 0 and float(mv_t.sum()) > 0

    if n_repeats == 4:
        # once against the Pallas kernel itself, in interpret mode
        pallas = jess.make_fused_ess_sweep(
            jnp.asarray(y), jnp.asarray(mask), likelihood, force=True,
            n_blocks=8, n_repeats=n_repeats, interpret=True)
        u_p, ll_p, ns_p, mv_p = pallas(jnp.asarray(chol[0]), jnp.asarray(u[0]),
                                       jnp.asarray(scal[0]), jnp.asarray(v[0]))
        np.testing.assert_allclose(u_t[0].numpy(), np.asarray(u_p), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(float(ll_t[0]), float(ll_p), atol=1e-4)
        assert float(ns_t[0]) == float(ns_p) and float(mv_t[0]) == float(mv_p)


def test_ess_sweep_cap_hit_keeps_state():
    chol, u, scal, v, y, mask = _ess_inputs(20, 1, "logistic")
    scal[:, 0, 1] = 50.0  # slice level far above anything reachable
    u_t, ll_t, ns_t, mv_t = tess._ref_ess_sweep(
        _t(chol), _t(u), _t(scal), _t(v), _t(y), _t(mask), "logistic", 8, None,
        1, "float32")
    assert torch.equal(u_t, _t(u))
    np.testing.assert_array_equal(ll_t.numpy(), scal[:, 0, 0])
    assert (ns_t == 32).all() and (mv_t == 0).all()


# ---------------------------------------------------------------- sigma sweep


@pytest.mark.parametrize("likelihood", ["logistic", "probit"])
def test_sigma_sweep_matches_jax(likelihood):
    n_reps = 2
    chol, u, y, mask = _estimator_inputs(30)
    rng = np.random.default_rng(31)
    sigma0 = rng.normal(size=B).astype(np.float32) * 0.3
    mu_p, std_p = 0.0, 1.5
    hiv = 0.5 / std_p**2
    ll0 = tfe._ref_estimate(_t(np.exp(sigma0)[:, None, None] * chol), _t(u),
                            _t(y), _t(mask), likelihood, n_blocks=8).numpy()
    lp_rest = rng.normal(size=B).astype(np.float32) - 3.0
    lp0 = (lp_rest - hiv * (sigma0 - mu_p) ** 2 + ll0).astype(np.float32)
    chain = np.zeros((B, 8), np.float32)
    chain[:, 0], chain[:, 1], chain[:, 2] = ll0, lp0, sigma0
    chain[:, 3], chain[:, 4], chain[:, 5], chain[:, 6] = 1.3, mu_p, hiv, lp_rest
    rep = rng.uniform(size=(B, n_reps, 2 + 32)).astype(np.float32)
    rep[:, :, 0] = np.log(rep[:, :, 0])

    probe_log = []
    out_t = tsig._ref_sigma_sweep(_t(chol), _t(u), _t(chain), _t(rep), _t(y),
                                  _t(mask), likelihood, 8, None, n_reps,
                                  "float32", probe_log=probe_log)
    out_w = tsig.make_fused_sigma_sweep(_t(y), _t(mask), likelihood,
                                        n_blocks=8, n_reps=n_reps)(
        _t(chol), _t(u), _t(chain), _t(rep))
    for a, b in zip(out_w, out_t):
        assert torch.equal(a, b)

    # off the TPU the JAX chain never takes the sweep, so the reference here
    # is the sweep's own jnp version, called directly
    ref = jsig.make_fused_sigma_sweep(jnp.asarray(y), jnp.asarray(mask),
                                      likelihood, force=False, n_blocks=8,
                                      n_reps=n_reps)
    out_j = jax.jit(jax.vmap(ref))(jnp.asarray(chol), jnp.asarray(u),
                                   jnp.asarray(chain[:, None, :]),
                                   jnp.asarray(rep))
    sig_t, ll_t, lp_t, ns_t, mv_t = (o.numpy() for o in out_t)
    sig_j, ll_j, lp_j, ns_j, mv_j = (np.asarray(o) for o in out_j)
    _assert_margins(probe_log, 1e-4)
    np.testing.assert_array_equal(ns_t, ns_j)
    np.testing.assert_array_equal(mv_t, mv_j)
    np.testing.assert_allclose(sig_t, sig_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ll_t, ll_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(lp_t, lp_j, rtol=0, atol=1e-4)
    assert ns_t.sum() > 0 and mv_t.sum() > 0


def test_body_ab_runs_each_tree_on_its_own_package(tmp_path):
    """``utils/body_ab`` runs its steps in a process whose
    ``auxpm_tpu_torch`` is the named tree's: a stub tree's ``_build`` is the
    one called."""
    import subprocess

    from auxpm_tpu_torch.utils import body_ab

    ops = tmp_path / "auxpm_tpu_torch" / "ops"
    ops.mkdir(parents=True)
    (tmp_path / "auxpm_tpu_torch" / "__init__.py").write_text("")
    (ops / "__init__.py").write_text("")
    (ops / "_build.py").write_text(
        "def build():\n    print('STUB TREE')\n\n\n"
        "def load_library():\n    pass\n")
    out = subprocess.run(body_ab._in_tree(tmp_path, ["--build"]),
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["STUB", "TREE", "BUILT"]


def test_body_ab_reads_registers_and_spills_from_the_nvcc_log(tmp_path):
    """Each kernel's registers, stack and spills, not those of a function
    it calls."""
    from auxpm_tpu_torch.utils import body_ab

    log = tmp_path / "nvcc.log"
    log.write_text(
        "ptxas info    : Compiling entry function "
        "'_ZN5auxpm16ess_sweep_kernelILi1ELb1EEEvPKfS2_' for 'sm_90a'\n"
        "ptxas info    : Function properties for "
        "_ZN5auxpm5sweep17copy_ragged_chunkEPf\n"
        "    16 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Function properties for "
        "_ZN5auxpm16ess_sweep_kernelILi1ELb1EEEvPKfS2_\n"
        "    40 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 2 barriers\n"
        "ptxas info    : Compiling entry function "
        "'_ZN5auxpm18se_gram_ard_kernelILb1EEEvPKf' for 'sm_90a'\n"
        "ptxas info    : Function properties for "
        "_ZN5auxpm18se_gram_ard_kernelILb1EEEvPKf\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 55 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function "
        "'_ZN5auxpm17chol_panel_kernelEPf' for 'sm_90a'\n"
        "ptxas info    : Used 90 registers\n")
    assert body_ab.ptxas_info(log) == {
        "ess_sweep_kernelILi1ELb1E": [168, 40, 8, 8],
        "se_gram_ard_kernelILb1E": [55, 0, 0, 0],
    }
