"""PyTorch port vs the JAX package: the ARD Gram, the rotated estimator and
the ARD GP target (CPU, plain versions), and a NumPy model of the ARD Gram
kernel's schedule (``gram_schedule_model``: tile pairs i >= j, each written
with its mirror).

Inputs come from ``np.random.default_rng(seed)`` and go to both sides.  Where
the JAX function reaches a Pallas kernel it runs in interpret mode, as the
JAX package's own tests run it.

Tolerances.  Gram: both sides compute exp(-0.5 d2) with d2 from the expansion
sq_i + sq_j - 2 xs_i.xs_j in f32; d2 carries a few ulp of its largest term
(sq up to ~60 here, 1 ulp = 4e-6) and exp(-0.5 .) <= 1 halves it: 2e-5.
Estimator: f32 sums of n O(1) terms in different orders, 1e-4 (the
reference's own interpret-vs-ref bar).  Factor of an ARD Gram (condition
number ~1e5) by two LAPACK-style routines: 5e-4, the bar of the reference's
Cholesky tests.  An estimate through such a factor at the default jitter of
1e-5: 5e-3, far looser than the isotropic target's 2e-4, because here the two
sides also BUILD the Gram with different routines (the isotropic Gram is an
elementwise transform of one shared squared-distance matrix): entries differ
by ~1e-6, which against the smallest eigenvalues (the jitter) moves f = C u
by ~1e-4 per direction, more at long lengthscales.  That this is conditioning
and not logic is shown by the same comparisons at jitter 1e-3, which hold to
5e-4 (``JITTER_WC``; the probe-factory test runs there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auxpm_tpu.models.gp_classification import (
    make_gp_classification as jmake,
)
from auxpm_tpu.ops import fused_estimator as jfe
from auxpm_tpu.ops import gram as jgram
from auxpm_tpu_torch.core.state import init_chain_states
from auxpm_tpu_torch.models.gp_classification import (
    make_gp_classification as tmake,
)
from auxpm_tpu_torch.ops import fused_estimator as tfe
from auxpm_tpu_torch.ops import gram as tgram
from auxpm_tpu_torch.samplers.adaptation import adapt_params

S, N_RAW, N, D, B = 8, 100, 128, 3, 3
GRAM_TOL, EST_TOL, CHOL_TOL, LL_TOL, LL_TOL_WC = 2e-5, 1e-4, 5e-4, 5e-3, 5e-4
JITTER_WC = 1e-3  # a well-conditioned R(ell) + jitter I
_WD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


F32 = np.float32


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


def _xy(n=N_RAW, d=D, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal(d)
    y = np.where(x @ w + 0.3 * rng.standard_normal(n) > 0, 1.0, -1.0)
    return x, y.astype(np.float32)


THETAS = np.float32([[0.0, 0.0, 0.0, 0.0], [-0.6, 0.4, 0.9, 0.3],
                     [0.7, -0.5, -0.2, -0.4]])

# ----------------------------------------------------------------------- Gram


@pytest.mark.parametrize("n", [N, 77])
def test_se_gram_ard_matches_jax_and_interpret_kernel(n):
    """Batched plain version against the jnp version and the Pallas kernel in
    interpret mode, at a tile-aligned and at a ragged n."""
    x, _ = _xy(n)
    log_ells = THETAS[:, :D]
    got = tgram.se_gram_ard(_t(x), _t(log_ells), 0.0, 1e-5).numpy()
    assert got.shape == (B, n, n)
    for b in range(B):
        ref = np.asarray(jgram.se_gram_ard(jnp.asarray(x), log_ells[b], 0.0,
                                           1e-5))
        pallas = np.asarray(jgram.se_gram_ard_pallas(
            jnp.asarray(x), log_ells[b], 0.0, 1e-5, interpret=True))
        np.testing.assert_allclose(got[b], ref, rtol=0, atol=GRAM_TOL)
        np.testing.assert_allclose(got[b], pallas, rtol=0, atol=GRAM_TOL)
    # a single (d,) lengthscale vector gives one matrix; log_sigma scales
    one = tgram.se_gram_ard(_t(x), _t(log_ells[1]), 0.3, 1e-5).numpy()
    ref = np.asarray(jgram.se_gram_ard(jnp.asarray(x), log_ells[1], 0.3, 1e-5))
    np.testing.assert_allclose(one, ref, rtol=2e-5, atol=GRAM_TOL)


def gram_schedule_model(x, log_ells, jitter, mask, grid=7, tile=64):
    """``csrc/se_gram.cu``: the items (chain, tile pair ti >= tj) in
    contiguous runs over ``grid`` blocks; a block stages each chain's
    xs = x exp(-log_ell) and squared norms once; an item computes its tile
    (cross term and norms summed over k ascending, the clamp, exp, jitter,
    pad fix-up) and writes it, and an off-diagonal tile also its mirror
    with the mask product in the mirror's order.  Returns the Gram and how
    often each element was written."""
    n, d = x.shape
    b_total = len(log_ells)
    n_tiles = -(-n // tile)
    n_pad = n_tiles * tile
    pairs = [(ti, tj) for ti in range(n_tiles) for tj in range(ti + 1)]
    items = [(b, ti, tj) for b in range(b_total) for ti, tj in pairs]
    out = np.full((b_total, n, n), np.nan, F32)
    written = np.zeros((b_total, n, n), int)
    m = np.ones(n_pad, F32) if mask is None else np.concatenate(
        [mask, np.ones(n_pad - n, F32)])
    for g in range(grid):
        staged = None
        for b, ti, tj in items[len(items) * g // grid:
                               len(items) * (g + 1) // grid]:
            if b != staged:
                xs = np.zeros((n_pad, d), F32)
                xs[:n] = x * np.exp(-log_ells[b])
                sq = np.zeros(n_pad, F32)
                for k in range(d):
                    sq = sq + xs[:, k] * xs[:, k]
                staged = b
            ri = slice(ti * tile, (ti + 1) * tile)
            rj = slice(tj * tile, (tj + 1) * tile)
            cross = np.zeros((tile, tile), F32)
            for k in range(d):
                cross = cross + xs[ri, k, None] * xs[None, rj, k]
            d2 = np.maximum(sq[ri, None] + sq[None, rj] - F32(2) * cross, 0)
            v = np.exp(F32(-0.5) * d2)
            gi, gj = np.arange(n_pad)[ri, None], np.arange(n_pad)[None, rj]
            v = np.where(gi == gj, v + F32(jitter), v).astype(F32)
            vt = v
            if mask is not None:
                vt = v * m[None, rj] * m[ri, None]
                v = v * m[ri, None] * m[None, rj]
                v = np.where(gi == gj, v + (F32(1) - m[ri, None]), v)
            keep = (gi < n) & (gj < n)
            ii, jj = np.broadcast_to(gi, keep.shape)[keep], \
                np.broadcast_to(gj, keep.shape)[keep]
            out[b, ii, jj] = v[keep]
            written[b, ii, jj] += 1
            if ti != tj:
                out[b, jj, ii] = vt[keep]
                written[b, jj, ii] += 1
    return out, written


@pytest.mark.parametrize("n,n_real", [(256, 200), (100, 90)])
def test_gram_schedule_model_matches_jax_interpret(n, n_real):
    """The mirrored-tile schedule of the ARD Gram kernel writes every
    element once, is exactly symmetric, keeps the pad fix-up, and agrees
    with the Pallas kernel in interpret mode (n = 256; the reference kernel
    takes 128-aligned n) and with the plain version (n = 100, a partial
    tile)."""
    x, _ = _xy(n_real)
    x_pad = np.concatenate([x, np.zeros((n - n_real, D), np.float32)])
    mask = (np.arange(n) < n_real).astype(np.float32)
    log_ells = THETAS[:, :D]
    got, written = gram_schedule_model(x_pad, log_ells, 1e-5, mask)
    assert (written == 1).all()
    assert np.array_equal(got, got.transpose(0, 2, 1))
    diag = np.diagonal(got, axis1=1, axis2=2)
    assert (diag[:, n_real:] == 1.0).all()
    assert (got[:, n_real:, :n_real] == 0).all()
    plain = tgram.se_gram_ard_masked(_t(x_pad), _t(log_ells), 1e-5,
                                     _t(mask)).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=GRAM_TOL)
    if n % 128:
        return
    m = jnp.asarray(mask)
    for b in range(B):
        r = jgram._se_gram_ard_pallas(jnp.asarray(x_pad),
                                      jnp.asarray(log_ells[b]), 0.0, 1e-5,
                                      interpret=True)
        want = np.asarray(r * m[:, None] * m[None, :] + jnp.diag(1.0 - m))
        np.testing.assert_allclose(got[b], want, rtol=0, atol=GRAM_TOL)


def test_se_gram_ard_wrapper_applies_the_pad_fixup():
    """The wrapper's function on a CPU tensor: real rows get 1 + jitter on
    the diagonal, pad rows exactly 1 and zero covariance, as the reference's
    r_matrix masks its Gram."""
    x, _ = _xy()
    x_pad = np.concatenate([x, np.zeros((N - N_RAW, D), np.float32)])
    mask = np.concatenate([np.ones(N_RAW), np.zeros(N - N_RAW)]).astype(
        np.float32)
    log_ells = THETAS[:, :D]
    got = tgram.se_gram_ard_hopper(_t(x_pad), _t(log_ells), 1e-5,
                                   _t(mask)).numpy()
    for b in range(B):
        r = jgram.se_gram_ard(jnp.asarray(x_pad), log_ells[b], 0.0, 1e-5)
        m = jnp.asarray(mask)
        want = np.asarray(r * m[:, None] * m[None, :] + jnp.diag(1.0 - m))
        np.testing.assert_allclose(got[b], want, rtol=0, atol=GRAM_TOL)
    diag = np.diagonal(got, axis1=1, axis2=2)
    np.testing.assert_allclose(diag[:, :N_RAW], 1.0 + 1e-5, rtol=0, atol=1e-6)
    assert (diag[:, N_RAW:] == 1.0).all()
    assert (got[:, N_RAW:, :N_RAW] == 0).all()
    assert (got[:, :N_RAW, N_RAW:] == 0).all()
    # without a mask: the plain Gram, pad block of ones (x_pad rows are 0)
    bare = tgram.se_gram_ard_hopper(_t(x_pad), _t(log_ells), 1e-5).numpy()
    np.testing.assert_allclose(bare[:, N_RAW:, N_RAW + 1:][:, 0], 1.0,
                               atol=1e-6)
    assert torch.equal(
        tgram.se_gram_ard_hopper(_t(x_pad), _t(log_ells), 1e-5),
        tgram.se_gram_ard(_t(x_pad), _t(log_ells), 0.0, 1e-5))


# ---------------------------------------------------------- rotated estimator


def _rot_inputs(seed):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, S, N)).astype(np.float32)
    v = rng.standard_normal((B, S, N)).astype(np.float32)
    chol = (np.tril(rng.standard_normal((B, N, N)) * 0.05)
            + np.eye(N)).astype(np.float32)
    y = rng.choice([-1.0, 1.0], N).astype(np.float32)
    mask = np.ones(N, np.float32)
    mask[-28:] = 0.0
    angle = rng.uniform(-np.pi, np.pi, B).astype(np.float32)
    return chol, u, v, angle, y, mask


@pytest.mark.parametrize("likelihood,n_blocks,whiten_dtype", [
    ("logistic", 8, "float32"), ("probit", 8, "float32"),
    ("logistic", 1, "float32"), ("logistic", 8, "bfloat16"),
    ("probit", 1, "bfloat16"),
])
def test_rot_estimator_matches_jax_ref_and_interpret_kernel(
        likelihood, n_blocks, whiten_dtype):
    chol, u, v, angle, y, mask = _rot_inputs(6)
    est_t = tfe.make_fused_rot_estimator(_t(y), _t(mask), likelihood,
                                         n_blocks, whiten_dtype)
    got = est_t(_t(chol), _t(u), _t(v), _t(angle)).numpy()
    est_j = jfe.make_fused_rot_estimator(jnp.asarray(y), jnp.asarray(mask),
                                         likelihood, force=False,
                                         n_blocks=n_blocks,
                                         whiten_dtype=whiten_dtype)
    ref = np.asarray(jax.vmap(est_j)(jnp.asarray(chol), jnp.asarray(u),
                                     jnp.asarray(v), jnp.asarray(angle)))
    pallas = np.asarray(jfe._pallas_estimate_rot(
        jnp.asarray(chol[0]), jnp.asarray(u[0]), jnp.asarray(v[0]),
        jnp.asarray(angle[0]), jnp.asarray(y), jnp.asarray(mask), likelihood,
        n_blocks=n_blocks, whiten_dtype=_WD[whiten_dtype], interpret=True))
    # bfloat16: u' is rounded to bf16 after an f32 rotation on both sides; a
    # last-bit difference in cos/sin moves a few of the S*n elements across a
    # bf16 boundary (2^-8 relative each): a looser, stated bar
    tol = EST_TOL if whiten_dtype == "float32" else 5e-3
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    np.testing.assert_allclose(got[0], pallas, rtol=0, atol=tol)


def test_rot_estimator_is_the_estimator_at_the_rotated_point_and_masks():
    chol, u, v, angle, y, mask = _rot_inputs(7)
    args = (_t(chol), _t(u), _t(v), _t(angle), _t(y), _t(mask), "logistic", 8)
    rot = tfe.fused_estimate_rot(*args)
    u_rot = tfe.rotate(_t(u), _t(v), _t(angle))
    assert torch.equal(rot, tfe.fused_estimate(_t(chol), u_rot, _t(y),
                                               _t(mask), "logistic", 8))
    # angle 0 gives the estimate at u itself
    at0 = tfe.fused_estimate_rot(_t(chol), _t(u), _t(v), torch.zeros(B),
                                 _t(y), _t(mask), "logistic", 8)
    assert torch.equal(at0, tfe.fused_estimate(_t(chol), _t(u), _t(y),
                                               _t(mask), "logistic", 8))
    # chains that are not wanted give 0, the others are untouched
    active = torch.tensor([1.0, 0.0, 1.0])
    part = tfe.fused_estimate_rot(*args, active=active)
    assert part[1] == 0 and torch.equal(part[[0, 2]], rot[[0, 2]])
    with pytest.raises(ValueError, match="likelihood"):
        tfe.fused_estimate_rot(*args[:6], "poisson")


# ------------------------------------------------------------- the ARD target


@pytest.fixture(scope="module")
def ard_targets():
    x, y = _xy()
    return (jmake(x, y, n_importance=S, ard=True),
            tmake(x, y, n_importance=S, ard=True, device="cpu"))


@pytest.fixture(scope="module")
def ard_targets_wc():
    x, y = _xy()
    return (jmake(x, y, n_importance=S, ard=True, jitter=JITTER_WC),
            tmake(x, y, n_importance=S, ard=True, jitter=JITTER_WC,
                  device="cpu"))


def test_ard_target_matches_jax(ard_targets, ard_targets_wc):
    tj, tt = ard_targets
    assert tt.d == tj.d == D + 1 and tt.u_shape == tj.u_shape == (S, N)
    assert tt.name == tj.name and tt.theta_init.shape == (D + 1,)
    assert len(tt.coord_estimators) == len(tt.coord_estimators_c) == D + 1
    u = np.random.default_rng(8).standard_normal((B, S, N)).astype(np.float32)
    th_j, th_t = jnp.asarray(THETAS), _t(THETAS)

    lp_j = np.asarray(jax.vmap(tj.log_prior)(th_j))
    np.testing.assert_allclose(tt.log_prior(th_t).numpy(), lp_j, rtol=1e-6,
                               atol=1e-6)
    cache_j = jax.jit(jax.vmap(tj.cache_init))(th_j)
    cache_t = tt.cache_init(th_t)
    np.testing.assert_allclose(cache_t["chol_r"].numpy(),
                               np.asarray(cache_j["chol_r"]), atol=CHOL_TOL)
    # the pad block of the factor is the identity: pad diagonal exactly 1
    pad_block = cache_t["chol_r"][:, N_RAW:, :]
    assert torch.equal(pad_block[:, :, N_RAW:],
                       torch.eye(N - N_RAW).expand(B, -1, -1))
    assert (pad_block[:, :, :N_RAW] == 0).all()
    prep_t = tt.prepare(th_t)
    np.testing.assert_allclose(
        prep_t.numpy(), np.asarray(jax.jit(jax.vmap(tj.prepare))(th_j)),
        atol=CHOL_TOL)
    assert torch.equal(tt.prepare_c(th_t, cache_t), prep_t)
    ll_j = np.asarray(jax.jit(jax.vmap(tj.log_lik_est))(th_j, jnp.asarray(u)))
    ll_t = tt.log_lik_est(th_t, _t(u))
    np.testing.assert_allclose(ll_t.numpy(), ll_j, rtol=0, atol=LL_TOL)
    tj_wc, tt_wc = ard_targets_wc
    np.testing.assert_allclose(
        tt_wc.log_lik_est(th_t, _t(u)).numpy(),
        np.asarray(jax.jit(jax.vmap(tj_wc.log_lik_est))(th_j, jnp.asarray(u))),
        rtol=0, atol=LL_TOL_WC)
    # the rotated estimator of the target, off the prepared factor
    v = np.random.default_rng(9).standard_normal((B, S, N)).astype(np.float32)
    ang = np.float32([0.3, -1.2, 2.5])
    rot_j = jax.jit(jax.vmap(tj.log_lik_est_rot))(
        jnp.asarray(prep_t.numpy()), jnp.asarray(u), jnp.asarray(v),
        jnp.asarray(ang))
    np.testing.assert_allclose(
        tt.log_lik_est_rot(prep_t, _t(u), _t(v), _t(ang)).numpy(),
        np.asarray(rot_j), rtol=0, atol=EST_TOL)


@pytest.mark.parametrize("cached", [True, False])
def test_ard_coordinate_factories_match_jax(ard_targets_wc, cached):
    """Every coordinate's 1-point probe f and 2-point probe f2 (both bracket
    ends as one batch of 2B) against the reference's f and vmap(f)."""
    tj, tt = ard_targets_wc
    u = np.random.default_rng(10).standard_normal((B, S, N)).astype(np.float32)
    th_t = _t(THETAS)
    cache_t = tt.cache_init(th_t)
    x1 = np.float32([0.2, -0.3, 0.5])
    xs = np.float32([[-0.4, 0.1, 0.8], [0.6, 0.9, 1.4]])  # (2, B)
    for i in range(D + 1):
        if cached:
            f, f2 = tt.coord_estimators_c[i](th_t, _t(u), cache_t)
        else:
            f, f2 = tt.coord_estimators[i](th_t, _t(u))

        def probes_j(theta, u_c, chol_r, x, x2, i=i):
            if cached:
                fj, f2j = tj.coord_estimators_c[i](theta, u_c,
                                                   {"chol_r": chol_r})
            else:
                fj, f2j = tj.coord_estimators[i](theta, u_c)
            return fj(x), f2j(x2)

        (lp_j, ll_j), (lp2_j, ll2_j) = jax.jit(jax.vmap(probes_j))(
            jnp.asarray(THETAS), jnp.asarray(u),
            jnp.asarray(cache_t["chol_r"].numpy()), jnp.asarray(x1),
            jnp.asarray(xs.T))
        lp, ll = f(_t(x1))
        lp2, ll2 = f2(_t(xs))
        assert lp2.shape == ll2.shape == (2, B)
        np.testing.assert_allclose(ll.numpy(), np.asarray(ll_j), atol=LL_TOL_WC)
        np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j), atol=LL_TOL_WC)
        np.testing.assert_allclose(ll2.numpy(), np.asarray(ll2_j).T,
                                   atol=LL_TOL_WC)
        np.testing.assert_allclose(lp2.numpy(), np.asarray(lp2_j).T,
                                   atol=LL_TOL_WC)
        # the 2-point probe is the 1-point probe at each end
        for e in range(2):
            lp_e, ll_e = f(_t(xs[e]))
            np.testing.assert_allclose(ll2[e].numpy(), ll_e.numpy(),
                                       rtol=0, atol=2e-5)
            np.testing.assert_allclose(lp2[e].numpy(), lp_e.numpy(),
                                       rtol=0, atol=2e-5)


def test_ard_init_and_width_rule(ard_targets):
    _, tt = ard_targets
    st = init_chain_states(4, tt, 3, jitter_scale=0.3, with_cache=True)
    assert st.theta.shape == (3, D + 1)
    assert torch.equal(st.extras["target_cache"]["chol_r"],
                       tt.cache_init(st.theta)["chol_r"])
    assert torch.equal(st.log_lik_hat, tt.log_lik_est(st.theta, st.u))
    # the width rule on a (d+1)-vector of widths: 2 x the pooled std
    rng = np.random.default_rng(11)
    theta = (rng.standard_normal((4, 10, D + 1))
             * [0.3, 2.0, 1.0, 0.1]).astype(np.float32)
    new = adapt_params(
        {"slice_theta": {"widths": torch.ones(D + 1), "max_step_out": 8}},
        {"theta": _t(theta)}, {"slice_theta/n_probe": torch.ones(4, 10)})
    np.testing.assert_allclose(
        new["slice_theta"]["widths"].numpy(),
        2.0 * theta.reshape(-1, D + 1).std(0), rtol=1e-5)
    assert new["slice_theta"]["max_step_out"] == 8
