"""PyTorch port vs the JAX package: the Laplace importance proposal
(``models/laplace.py``, the likelihoods' gradient / Hessian helpers, the GP
target's ``proposal="laplace"`` branch) and ``models/exact.py`` (CPU).

Same inputs on both sides, made from a seed with NumPy; the JAX functions
are per chain, so they are ``vmap``ped over the port's leading axis.  Σ_q =
K - K W^½ B⁻¹ W^½ K inherits the near-singularity of R(ell) + jitter I: at
the default jitter 1e-5 two f32 routines may settle on different escalated
jitters for its factorisation, so every parity case here builds K at jitter
1e-3, where both sides factor every matrix at the first try (asserted
through the finite factors).  B = I + W^½ K W^½ is well conditioned (≥ I).

Tolerances: the gradient and Hessian 1e-6 (logistic: the same closed form;
probit: the port's log Φ is its own erfc form, ~1.2e-7 relative, so 1e-5
relative); f̂ 2e-4, chol_q 5e-4 (six Newton iterations, each an f32
factorisation and solve by another routine on each side), ½ log|Σ_q| 2e-3
(a sum of n logs of those diagonals); the estimate 2e-3 (the extra term
-½ fᵀK⁻¹f sums n products through a solve with the factor of K).

Then the four checks of ``tests/test_laplace_proposal.py`` on the port: the
Newton mode is stationary, the Laplace estimator is unbiased with a lower
variance than the prior's, padding is exact, and ``aux_slice`` with the
Laplace proposal finds the prior proposal's posterior at a small size.

Reverse mode (HMC and NUTS on a Laplace target): each step the gradient runs
through (``robust_cholesky``, the unrolled Newton fit with its
``cholesky_solve`` calls, ``gaussian_half_logdet``, the weight terms) under
``torch.autograd.gradcheck`` in float64 at n = 6 with a padded row; the
target's gradient against ``jax.grad`` of the reference's on unpadded Pima
(n = 40, S = 16), iso and ARD, logistic and probit, 1e-4 relative to the
largest entry (measured up to 8.6e-6: f32 sums in other orders through six
Newton iterations); on a padded target the port's gradient is finite and
equal to the unpadded one within ``test_laplace_padding_exact``'s bar
(5e-2 of max(|g|, 1); measured ~2e-6), where the reference's is NaN (known
difference 8 of ROADMAP.md: ``jnp.sqrt``'s derivative at w = 0); ``aux_hmc``
and ``aux_nuts`` from one seed on an unpadded Laplace target key for key
with the reference for 2 steps; the CLI of both gradient samplers on the
Laplace proposal, the sharded SMC with NUTS rejuvenation included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auxpm_tpu.core.state import init_chain_states as j_init
from auxpm_tpu.models import laplace as j_laplace
from auxpm_tpu.models.datasets import load as jload
from auxpm_tpu.models.exact import make_mvn_target as j_mvn
from auxpm_tpu.models.gp_classification import (
    make_gp_classification as jmake,
)
from auxpm_tpu.models.likelihoods import LIKELIHOOD_GRAD_HESS as J_GH
from auxpm_tpu.samplers.chain import run_chains as j_run_chains
from auxpm_tpu.samplers.composite import SAMPLERS as J_SAMPLERS
from auxpm_tpu_torch import run as trun
from auxpm_tpu_torch.core.state import init_chain_states as t_init
from auxpm_tpu_torch.models import laplace as t_laplace
from auxpm_tpu_torch.models.exact import make_mvn_target as t_mvn
from auxpm_tpu_torch.models.gp_classification import (
    make_gp_classification as tmake,
)
from auxpm_tpu_torch.models.likelihoods import LIKELIHOOD_GRAD_HESS as T_GH
from auxpm_tpu_torch.ops.gram import pairwise_sqdist, se_gram_iso
from auxpm_tpu_torch.samplers.chain import run_chains
from auxpm_tpu_torch.ops.cholesky import robust_cholesky
from auxpm_tpu_torch.parallel import rank_jobs
from auxpm_tpu_torch.parallel.launch import spawn
from auxpm_tpu_torch.parallel.mesh import Mesh
from auxpm_tpu_torch.samplers.composite import SAMPLERS, make_aux_slice

S, JITTER, NEWTON = 16, 1e-3, 6
THETAS = np.float32([[0.0, 0.0], [-0.6, 0.4], [0.7, -0.5]])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its tests run many small ops,
    and the suite runs several workers on the same cores, where
    multi-threaded small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _toy_data(n=24, d=2, seed=0):
    """``tests/test_laplace_proposal.py``'s separable toy data."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = np.array([1.0, -0.7], np.float32)[:d]
    y = np.where(x @ w + 0.3 * rng.standard_normal(n) > 0, 1.0,
                 -1.0).astype(np.float32)
    return x, y


@pytest.mark.parametrize("likelihood", ["logistic", "probit"])
def test_grad_hess_matches_jax(likelihood):
    rng = np.random.default_rng(1)
    f = np.concatenate([rng.standard_normal(200) * 3,
                        [-40.0, -12.0, 0.0, 12.0, 40.0]]).astype(np.float32)
    y = rng.choice([-1.0, 1.0], f.size).astype(np.float32)
    mask = (np.arange(f.size) < f.size - 20).astype(np.float32)
    g_j, w_j = J_GH[likelihood](jnp.asarray(f), jnp.asarray(y),
                                jnp.asarray(mask))
    g_t, w_t = T_GH[likelihood](_t(f)[None], _t(y), _t(mask))   # batched
    assert g_t.shape == (1, f.size)
    rtol = 1e-5 if likelihood == "probit" else 0.0
    np.testing.assert_allclose(g_t[0].numpy(), np.asarray(g_j), rtol=rtol,
                               atol=1e-6)
    np.testing.assert_allclose(w_t[0].numpy(), np.asarray(w_j), rtol=rtol,
                               atol=1e-6)
    # mask 0 gives g = W = 0; W >= 0 everywhere
    assert (g_t[0, mask == 0] == 0).all() and (w_t[0, mask == 0] == 0).all()
    assert (w_t >= 0).all()


@pytest.fixture(scope="module")
def pima():
    x, y = jload("pima", subsample=120)
    n = 128
    y_pad = np.concatenate([y, np.ones(n - len(y))]).astype(np.float32)
    mask = (np.arange(n) < len(y)).astype(np.float32)
    x_pad = np.concatenate([x, np.zeros((n - len(y), x.shape[1]))])
    sq = pairwise_sqdist(_t(x_pad))
    sq[len(y):, :] = 1e30
    sq[:, len(y):] = 1e30
    sq.fill_diagonal_(0.0)
    return x, y, y_pad, mask, sq


@pytest.mark.parametrize("likelihood", ["logistic", "probit"])
def test_laplace_fit_matches_jax(pima, likelihood):
    """f̂, chol_q and ½ log|Σ_q| over a batch of three K (sigma^2 (R + 1e-3
    I) at three theta) against the reference's per-matrix fit."""
    _, _, y_pad, mask, sq = pima
    th = _t(THETAS)
    k = torch.exp(2 * th[:, 1])[:, None, None] * se_gram_iso(
        sq, th[:, 0], 0.0, JITTER)
    f_t, cq_t, hl_t = t_laplace.laplace_fit(k, _t(y_pad), _t(mask),
                                            likelihood, NEWTON)
    f_j, cq_j, hl_j = jax.vmap(lambda kk: j_laplace.laplace_fit(
        kk, jnp.asarray(y_pad), jnp.asarray(mask), likelihood, NEWTON))(
            jnp.asarray(k.numpy()))
    assert torch.isfinite(cq_t).all() and np.isfinite(np.asarray(cq_j)).all()
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(cq_t.numpy(), np.asarray(cq_j), rtol=0,
                               atol=5e-4)
    np.testing.assert_allclose(hl_t.numpy(), np.asarray(hl_j), rtol=0,
                               atol=2e-3)
    # the pad block: f̂ = 0 and Σ_q = K there (plus the 1e-6 relative floor)
    pad = mask == 0
    assert (f_t[:, pad] == 0).all()
    np.testing.assert_allclose(
        torch.diagonal(cq_t, dim1=-2, dim2=-1)[:, pad].numpy() ** 2,
        torch.diagonal(k, dim1=-2, dim2=-1)[:, pad].numpy(), rtol=1e-5)
    # the weight terms on the same u
    u = np.random.default_rng(3).standard_normal((3, S, 128)).astype(
        np.float32)
    chol_k = torch.linalg.cholesky(k)
    fs_t, ex_t = t_laplace.laplace_log_weight_terms(chol_k, f_t, cq_t, hl_t,
                                                    _t(u))
    fs_j, ex_j = jax.vmap(j_laplace.laplace_log_weight_terms)(
        jnp.asarray(chol_k.numpy()), jnp.asarray(f_t.numpy()),
        jnp.asarray(cq_t.numpy()), jnp.asarray(hl_t.numpy()), jnp.asarray(u))
    np.testing.assert_allclose(fs_t.numpy(), np.asarray(fs_j), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(ex_t.numpy(), np.asarray(ex_j), rtol=0,
                               atol=2e-3)


@pytest.mark.parametrize("ard", [False, True], ids=["iso", "ard"])
def test_laplace_target_matches_jax(pima, ard):
    """The whole target: prepare and the estimate on the same theta and u,
    isotropic and ARD (the port's ARD Gram through its plain version)."""
    x, y, *_ = pima
    tj = jmake(x, y, n_importance=S, proposal="laplace", ard=ard,
               jitter=JITTER)
    tt = tmake(x, y, n_importance=S, proposal="laplace", ard=ard,
               jitter=JITTER, device="cpu")
    assert tt.name == tj.name and tt.name.endswith("_laplace")
    for field in ("coord_estimators", "coord_estimators_c", "cache_init",
                  "prepare_c", "log_lik_est_rot", "ess_sweep_factory",
                  "sigma_sweep_factory"):
        assert getattr(tt, field) is None, field
    rng = np.random.default_rng(4)
    theta = (rng.standard_normal((3, tt.d)) * 0.4).astype(np.float32)
    u = rng.standard_normal((3, *tt.u_shape)).astype(np.float32)
    prep_t = tt.prepare(_t(theta))
    prep_j = jax.vmap(tj.prepare)(jnp.asarray(theta))
    for a, b, tol in zip(prep_t, prep_j, (5e-4, 2e-4, 5e-4, 2e-3)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=tol)
    ll_t = tt.log_lik_est(_t(theta), _t(u))
    ll_j = jax.vmap(tj.log_lik_est)(jnp.asarray(theta), jnp.asarray(u))
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=0,
                               atol=2e-3)
    # prepare once, estimate per u: the split the ESS update relies on
    assert torch.equal(tt.log_lik_est_u(prep_t, _t(u)), ll_t)
    lw = tt.log_weights_u(prep_t, _t(u))
    assert lw.shape == (3, S)


# --------------------------------------- the reference's four Laplace checks


def test_newton_mode_is_stationary():
    x, y = _toy_data()
    n = len(y)
    k = se_gram_iso(pairwise_sqdist(_t(x)), torch.zeros(1), 0.2, 1e-5)
    mask = torch.ones(n)
    for lik in ("logistic", "probit"):
        f_hat, chol_q, _ = t_laplace.laplace_fit(k, _t(y), mask, lik, 20)
        # f̂ = K grad log p(y|f̂), the well-conditioned fixed-point form
        g, _ = T_GH[lik](f_hat, _t(y), mask)
        resid = f_hat - (k @ g[..., None])[..., 0]
        assert float(resid.abs().max()) < 1e-3, lik
        # Σ_q is SPD with its diagonal below K's (Σ_q ≼ K)
        sq = (chol_q @ chol_q.mT)[0]
        assert (torch.diagonal(sq) > 0).all()
        assert (torch.diagonal(sq) <= torch.diagonal(k[0]) + 1e-4).all()


def test_laplace_estimator_unbiased_and_lower_variance():
    x, y = _toy_data(n=20)
    kw = dict(n_importance=16, pad_to_tiles=False, jitter=1e-5, device="cpu")
    t_prior = tmake(x, y, **kw)
    t_lap = tmake(x, y, proposal="laplace", **kw)
    n_rep = 512
    theta = _t([[0.1, 0.3]]).expand(n_rep, 2)
    gen = torch.Generator().manual_seed(1)
    u = torch.randn((n_rep, *t_prior.u_shape), generator=gen)
    ll_prior = t_prior.log_lik_est(theta, u).double().numpy()
    ll_lap = t_lap.log_lik_est(theta, u).double().numpy()
    # unbiased in L (not log L): MC means of exp(log L̂), relative to a shift
    shift = ll_lap.mean()
    m_prior = np.exp(ll_prior - shift).mean()
    m_lap = np.exp(ll_lap - shift).mean()
    se_prior = np.exp(ll_prior - shift).std() / np.sqrt(n_rep)
    se_lap = np.exp(ll_lap - shift).std() / np.sqrt(n_rep)
    assert abs(m_prior - m_lap) < 4.0 * np.hypot(se_prior, se_lap)
    assert ll_lap.std() < 0.5 * ll_prior.std(), (ll_lap.std(), ll_prior.std())


def test_laplace_padding_exact():
    x, y = _toy_data(n=30)
    kw = dict(n_importance=8, jitter=1e-5, proposal="laplace", device="cpu")
    t_pad = tmake(x, y, pad_to_tiles=True, **kw)
    t_raw = tmake(x, y, pad_to_tiles=False, **kw)
    theta = _t([[0.0, 0.2]])
    gen = torch.Generator().manual_seed(2)
    u_raw = torch.randn((1, *t_raw.u_shape), generator=gen)
    u_pad = torch.randn((1, *t_pad.u_shape), generator=gen)
    u_pad[:, :, : u_raw.shape[-1]] = u_raw
    ll_raw = float(t_raw.log_lik_est(theta, u_raw))
    ll_pad = float(t_pad.log_lik_est(theta, u_pad))
    assert abs(ll_raw - ll_pad) < 5e-2 * max(1.0, abs(ll_raw)), (ll_raw,
                                                                 ll_pad)


def test_aux_slice_laplace_matches_prior_posterior():
    """aux_slice at 48 Pima points: prior proposal (S=64) and Laplace (S=8),
    16 chains, the reference's bar on the posterior means.  The reference
    runs 220 steps with stepping out (60 of burn-in); a Laplace probe here
    costs nine batched factorisations on the CPU, so this runs the
    shrinkage-only slice (``max_step_out=0``, widths 2.5, as the reference's
    ``aux_slice_noso`` Geweke case) for 100 steps (40 of burn-in): each
    coordinate's min ESS is ~100 on both sides, the bar ~4 standard errors
    of the difference."""
    x, y = jload("pima", subsample=48)
    posts = {}
    for proposal, s in (("prior", 64), ("laplace", 8)):
        target = tmake(x, y, n_importance=s, proposal=proposal,
                       pad_to_tiles=False, device="cpu")
        step = make_aux_slice(target)
        states = t_init(4, target, 16, jitter_scale=0.3)
        params = {"slice_theta": {"widths": torch.full((2,), 2.5),
                                  "max_step_out": 0}}
        _, recs, _ = run_chains(step, states, params, 100)
        theta = recs["theta"].numpy()[:, 40:]
        posts[proposal] = theta.reshape(-1, theta.shape[-1])
    mp, ml = posts["prior"].mean(0), posts["laplace"].mean(0)
    sp = posts["prior"].std(0)
    assert np.all(np.abs(mp - ml) < 0.35 * sp + 0.15), (mp, ml, sp)


# --------------------------------------------------------- the CLI and exact


def test_cli_runs_the_laplace_proposal_on_cpu():
    out = {}
    assert trun.main(["--device", "cpu", "--proposal", "laplace", "--chains",
                      "3", "--subsample", "60", "--n-importance", "8",
                      "--steps", "4", "--window-steps", "2",
                      "--warmup-windows", "1"], result=out) == 0
    assert out["target"].name.endswith("_laplace")
    assert out["states"].extras == {}   # no carried factor to carry
    assert np.isfinite(out["theta"]).all()
    # on a particle axis the Laplace target builds (its Newton fit
    # replicated, its log-weights through the collective fold; run on two
    # ranks in tests/test_torch_sharded_grad.py)
    mesh = Mesh(rank=0, world=2, n_chain_shards=1, n_particle_shards=2,
                chain_index=0, particle_index=0, particle_group=None,
                chain_group=None)
    sharded = out["target"].make_sharded(mesh)
    assert sharded.name.endswith("_laplace@particles")
    assert sharded.make_sharded is None and sharded.log_lik_est_rot is None


def test_mvn_target_matches_jax():
    mean = np.array([0.5, -1.0, 0.2])
    a = np.random.default_rng(5).standard_normal((3, 3))
    cov = a @ a.T + np.eye(3)
    tj, tt = j_mvn(mean, cov), t_mvn(mean, cov, device="cpu")
    theta = np.random.default_rng(6).standard_normal((7, 3)).astype(
        np.float32)
    np.testing.assert_allclose(tt.log_prior(_t(theta)).numpy(),
                               np.asarray(jax.vmap(tj.log_prior)(theta)),
                               rtol=1e-5, atol=1e-5)
    assert tt.u_shape == (1, 1) and tt.name == tj.name
    u = torch.zeros((7, 1, 1))
    assert torch.equal(tt.log_lik_est(_t(theta), u), torch.zeros(7))
    np.testing.assert_allclose(tt.posterior_mean.numpy(), mean, rtol=1e-6)
    np.testing.assert_allclose(tt.posterior_cov.numpy(), cov, rtol=1e-6)


# ------------------------------------------------------------- reverse mode


def _tiny_k(theta, pad=True):
    """``sigma^2 (R(ell) + 1e-3 I)`` in float64 at n = 6, the last row a
    padded one (zero covariance, unit variance) as the target pads."""
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.standard_normal((6, 2)))
    sq = pairwise_sqdist(x)
    if pad:
        sq[-1, :] = 1e30
        sq[:, -1] = 1e30
        sq[-1, -1] = 0.0
    r = se_gram_iso(sq, theta[:, 0], 0.0, 1e-3)
    return torch.exp(2.0 * theta[:, 1])[:, None, None] * r


_Y6 = torch.tensor([1.0, -1.0, -1.0, 1.0, 1.0, 1.0], dtype=torch.float64)
_MASK6 = torch.tensor([1.0, 1.0, 1.0, 1.0, 1.0, 0.0], dtype=torch.float64)
_U6 = torch.as_tensor(np.random.default_rng(8).standard_normal((2, 3, 6)))


def _fit6(theta, likelihood="logistic"):
    return t_laplace.laplace_fit(_tiny_k(theta), _Y6, _MASK6, likelihood, 4)


_PIECES = {
    "robust_cholesky": lambda th: robust_cholesky(_tiny_k(th)),
    "gaussian_half_logdet": lambda th: t_laplace.gaussian_half_logdet(
        robust_cholesky(_tiny_k(th))),
    "laplace_fit_logistic": lambda th: _fit6(th),
    "laplace_fit_probit": lambda th: _fit6(th, "probit"),
    "laplace_log_weight_terms": lambda th: t_laplace.laplace_log_weight_terms(
        robust_cholesky(_tiny_k(th)), *_fit6(th), _U6)[1],
}


@pytest.mark.parametrize("piece", sorted(_PIECES))
def test_laplace_pieces_pass_gradcheck(piece):
    """Each step of the Laplace gradient in float64 against central
    differences (``torch.autograd.gradcheck``), at n = 6 with a padded row:
    w = 0 there, where ``_sqrt_w`` takes its limit as the derivative."""
    theta = torch.tensor([[0.2, 0.1], [-0.4, 0.3]], dtype=torch.float64,
                         requires_grad=True)
    assert torch.autograd.gradcheck(_PIECES[piece], (theta,), eps=1e-6,
                                    atol=1e-6, rtol=1e-5)


def test_sqrt_w_is_sqrt_with_a_finite_derivative_at_zero():
    w = torch.tensor([0.0, -0.0, 1e-30, 0.25, 3.0, float("nan")],
                     requires_grad=True)
    sw = t_laplace._sqrt_w(w)
    ref = torch.sqrt(w.detach())
    assert torch.equal(sw.detach().view(torch.int32)[:5],
                       ref.view(torch.int32)[:5])         # bitwise
    assert torch.isnan(sw[5])
    (g,) = torch.autograd.grad(sw[:5].sum(), w)
    assert g[0] == 0 and g[1] == 0 and torch.isfinite(g).all()
    np.testing.assert_allclose(g[3:5].numpy(), [1.0, 0.5 / 3.0 ** 0.5],
                               rtol=1e-6)


LAP_S = 16


@pytest.fixture(scope="module")
def pima40():
    return jload("pima", subsample=40)


def _grad_t(target, theta, u):
    th = _t(theta).requires_grad_(True)
    (g,) = torch.autograd.grad(target.log_lik_est(th, _t(u)).sum(), th)
    return g.numpy()


@pytest.mark.parametrize("likelihood", ["logistic", "probit"])
@pytest.mark.parametrize("ard", [False, True], ids=["iso", "ard"])
def test_laplace_gradient_matches_jax(pima40, ard, likelihood):
    """d log L-hat / d theta of the Laplace target against ``jax.grad`` of
    the reference's on the same theta and u, unpadded (n = 40)."""
    x, y = pima40
    kw = dict(n_importance=LAP_S, proposal="laplace", ard=ard,
              likelihood=likelihood, jitter=JITTER, pad_to_tiles=False)
    tj, tt = jmake(x, y, **kw), tmake(x, y, device="cpu", **kw)
    rng = np.random.default_rng(4)
    theta = (rng.standard_normal((3, tt.d)) * 0.4).astype(np.float32)
    u = rng.standard_normal((3, *tt.u_shape)).astype(np.float32)
    gj = np.asarray(jax.jit(jax.vmap(jax.grad(tj.log_lik_est)))(
        jnp.asarray(theta), jnp.asarray(u)))
    gt = _grad_t(tt, theta, u)
    rel = np.abs(gt - gj).max() / np.abs(gj).max()
    assert rel < 1e-4, rel


@pytest.fixture(scope="module")
def padded_pair(pima40):
    """The Laplace target on Pima n = 40 unpadded and padded to 128, u equal
    on the real coordinates."""
    x, y = pima40
    kw = dict(n_importance=8, proposal="laplace", jitter=JITTER)
    t_raw = tmake(x, y, pad_to_tiles=False, device="cpu", **kw)
    t_pad = tmake(x, y, pad_to_tiles=True, device="cpu", **kw)
    rng = np.random.default_rng(2)
    u_raw = rng.standard_normal((3, *t_raw.u_shape)).astype(np.float32)
    u_pad = rng.standard_normal((3, *t_pad.u_shape)).astype(np.float32)
    u_pad[:, :, : u_raw.shape[-1]] = u_raw
    theta = np.float32([[0.1, 0.2], [-0.3, 0.4], [0.5, -0.2]])
    return x, y, kw, theta, (t_raw, u_raw), (t_pad, u_pad)


def test_laplace_gradient_is_finite_on_a_padded_target(padded_pair):
    """Padded rows have w = 0: the port's gradient there is finite and the
    unpadded one, within the bar of ``test_laplace_padding_exact``."""
    *_, theta, (t_raw, u_raw), (t_pad, u_pad) = padded_pair
    assert t_pad.u_shape[1] == 128
    g_pad, g_raw = _grad_t(t_pad, theta, u_pad), _grad_t(t_raw, theta, u_raw)
    assert np.isfinite(g_pad).all()
    assert np.all(np.abs(g_pad - g_raw) < 5e-2 * np.maximum(np.abs(g_raw),
                                                             1.0))


def test_reference_laplace_gradient_is_nan_on_a_padded_target(padded_pair):
    """The known difference (ROADMAP.md, known difference 8): the
    reference's ``jnp.sqrt(w)`` has an infinite derivative at the padded
    rows' w = 0, which meets a cotangent of exactly 0 there."""
    x, y, kw, theta, _, (_, u_pad) = padded_pair
    tj = jmake(x, y, pad_to_tiles=True, **kw)
    gj = np.asarray(jax.jit(jax.grad(tj.log_lik_est))(
        jnp.asarray(theta[0]), jnp.asarray(u_pad[0])))
    assert np.isnan(gj).all()


GRAD_KEY_STEPS = 2
GRAD_KEY_PARAMS = {"aux_hmc": {"ess_u": {}, "hmc": {"step_size": 0.15,
                                                    "n_leapfrog": 6}},
                   "aux_nuts": {"ess_u": {}, "nuts": {"step_size": 0.3}}}
GRAD_KEY_DECISIONS = {
    "aux_hmc": ("ess_u/moved", "ess_u/n_shrink", "hmc/accept",
                "hmc/diverged"),
    "aux_nuts": ("ess_u/moved", "ess_u/n_shrink", "nuts/depth",
                 "nuts/n_leapfrog", "nuts/diverged"),
}


@pytest.mark.parametrize("sampler", ["aux_hmc", "aux_nuts"])
def test_gradient_sampler_on_laplace_matches_the_reference(pima40, sampler):
    """From one seed on the unpadded Laplace target (n = 40, S = 8, 4
    chains), both packages free-running for 2 steps: keys bitwise, the
    decisions identical, theta within 5e-4 and log L-hat within 1e-2 (the
    bars ``tests/test_torch_keys.py`` holds ``aux_hmc`` to on the prior
    proposal: a trajectory integrates f32 gradient differences)."""
    x, y = pima40
    kw = dict(n_importance=8, proposal="laplace", jitter=JITTER,
              pad_to_tiles=False)
    tj, tt = jmake(x, y, **kw), tmake(x, y, device="cpu", **kw)
    sj = j_init(jax.random.key(3), tj, 4, jitter_scale=0.3)
    st = t_init(3, tt, 4, jitter_scale=0.3)
    step_j, step_t = J_SAMPLERS[sampler](tj), SAMPLERS[sampler](tt)
    pt = GRAD_KEY_PARAMS[sampler]
    for k in range(GRAD_KEY_STEPS):
        sj, _, info_j = j_run_chains(step_j, sj, pt, 1)
        st, info_t = step_t(st, pt)
        np.testing.assert_array_equal(
            st.key.numpy(),
            np.asarray(jax.random.key_data(sj.key)).astype(np.int64))
        for name in GRAD_KEY_DECISIONS[sampler]:
            np.testing.assert_array_equal(info_t[name].numpy(),
                                          np.asarray(info_j[name])[:, 0],
                                          err_msg=f"step {k} {name}")
        np.testing.assert_allclose(st.theta.numpy(), np.asarray(sj.theta),
                                   rtol=0, atol=5e-4, err_msg=f"step {k}")
        np.testing.assert_allclose(st.log_lik_hat.numpy(),
                                   np.asarray(sj.log_lik_hat), rtol=0,
                                   atol=1e-2, err_msg=f"step {k}")


LAP_CLI = ["--device", "cpu", "--proposal", "laplace", "--subsample", "40",
           "--n-importance", "8"]


def test_cli_runs_aux_nuts_on_the_laplace_proposal():
    out = {}
    assert trun.main(LAP_CLI + ["--sampler", "aux_nuts", "--chains", "2",
                                "--steps", "2", "--window-steps", "1",
                                "--warmup-windows", "1"], result=out) == 0
    assert out["target"].name.endswith("_laplace")
    assert np.isfinite(out["theta"]).all() and out["theta"].shape == (2, 2, 2)
    assert 0 < out["params"]["nuts"]["step_size"] < 10


def test_cli_runs_the_sharded_smc_with_nuts_on_the_laplace_proposal():
    """``--sampler smc --sharded true --smc-rejuvenation aux_nuts`` on a
    world of one gloo rank: u carried, NUTS on the tempered Laplace
    target."""
    (r,) = spawn(rank_jobs.cli, 1, LAP_CLI + [
        "--sampler", "smc", "--sharded", "true", "--smc-rejuvenation",
        "aux_nuts", "--particles", "16", "--smc-n-mcmc", "1"],
        timeout_s=300)
    s = r["summary"]
    assert r["target"].endswith("_laplace")
    assert s["phase"] == "smc_summary" and s["betas"][-1] == 1.0
    assert np.isfinite(s["log_z"]) and np.isfinite(r["theta"]).all()
