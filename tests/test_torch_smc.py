"""PyTorch port vs the JAX package: single-device tempering SMC (CPU).

- ``ess_of_logw``, ``next_beta`` and ``systematic_resample_indices`` against
  the reference on the same inputs (the indices identical, ESS and beta to
  f32 rounding);
- ``smc_toy`` (the preset: Gaussian toy, S=16, 2048 particles, ``aux_slice``
  rejuvenation): logZ within the reference's 0.15 nats of the closed form
  and the final population's moments at the reference's bars
  (``tests/test_smc.py:28-100``); NUTS rejuvenation on the toy;
- the tempered target: on a padded GP target every estimator closure left on
  ``tempered_target(t, 0.5)`` returns 0.5 x the untempered one, and the
  sweep factories, the coordinate probes and the carried-factor hooks are
  gone (the reference keeps its ESS sweep factory there, which folds
  untempered estimates: a known difference, ``samplers/smc.py``);
- SMC on a small GP target with ``aux_slice`` and ``aux_nuts``
  rejuvenation, and the CLI (``--preset smc_toy``; of the sharded modes
  only the reference's own refusals are left).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auxpm_tpu.models.datasets import load as jload
from auxpm_tpu.parallel.resampling import (
    systematic_resample_indices as j_resample,
)
from auxpm_tpu.samplers.smc import ess_of_logw as j_ess
from auxpm_tpu.samplers.smc import next_beta as j_next_beta
from auxpm_tpu_torch import run as trun
from auxpm_tpu_torch.models.gaussian_toy import make_gaussian_toy
from auxpm_tpu_torch.models.gp_classification import make_gp_classification
from auxpm_tpu_torch.parallel.resampling import systematic_resample_indices
from auxpm_tpu_torch.samplers.composite import make_aux_nuts, make_aux_slice
from auxpm_tpu_torch.samplers.smc import (
    ess_of_logw,
    make_smc,
    next_beta,
    tempered_target,
)
from auxpm_tpu_torch.utils.config import PRESETS, RunConfig, unsupported


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its tests run many small ops,
    and the suite runs several workers on the same cores, where
    multi-threaded small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy_log_evidence():
    """Z = N(y; 0, prior_var I + Sigma_y) for the toy's constants."""
    y = np.array([1.0, -0.5])
    c = 4.0 * np.eye(2) + np.array([[1.0, 0.4], [0.4, 0.8]])
    return float(-0.5 * y @ np.linalg.solve(c, y)
                 - 0.5 * np.linalg.slogdet(2 * np.pi * c)[1])


# ------------------------------------------------ the pieces vs the reference


def test_ess_next_beta_and_resampling_match_jax():
    rng = np.random.default_rng(2)
    for seed in range(4):
        ll = (rng.standard_normal(512) * 3.0).astype(np.float32)
        for beta in (0.0, 0.3):
            b_j = float(j_next_beta(jnp.asarray(ll), jnp.float32(beta), 0.5))
            b_t = float(next_beta(torch.from_numpy(ll),
                                  torch.tensor(beta), 0.5))
            assert b_t == pytest.approx(b_j, abs=1e-6), (seed, beta)
            lw = (b_j - beta) * ll
            assert float(ess_of_logw(torch.from_numpy(lw))) == pytest.approx(
                float(j_ess(jnp.asarray(lw))), rel=1e-5)
        log_w = (rng.standard_normal(64) * 3.0).astype(np.float32)
        for u01 in (0.0, 0.37, 0.999):
            want = np.asarray(j_resample(jnp.asarray(log_w), jnp.float32(u01)))
            got = systematic_resample_indices(torch.from_numpy(log_w),
                                              torch.tensor(u01))
            np.testing.assert_array_equal(got.numpy(), want)
    # nearly flat weights jump straight to 1; the threshold holds
    ll = torch.from_numpy((rng.standard_normal(512) * 3.0).astype(np.float32))
    assert float(next_beta(0.001 * ll, torch.tensor(0.0), 0.5)) == 1.0
    b1 = next_beta(ll, torch.tensor(0.0), 0.5)
    assert float(ess_of_logw(b1 * ll)) >= 0.5 * 512 * 0.95


def test_systematic_resample_counts():
    log_w = torch.log(torch.tensor([0.1, 0.4, 0.2, 0.3]))
    gen = torch.Generator().manual_seed(0)
    counts = np.zeros(4)
    for _ in range(200):
        idx = systematic_resample_indices(log_w, torch.rand((), generator=gen))
        counts += np.bincount(idx.numpy(), minlength=4)
    np.testing.assert_allclose(counts / counts.sum(), [0.1, 0.4, 0.2, 0.3],
                               atol=0.02)


# ------------------------------------------------------------- the toy runs


def test_smc_toy_evidence_and_moments():
    cfg = PRESETS["smc_toy"]
    target = make_gaussian_toy(n_importance=cfg.n_importance, noise_frac=0.5,
                               device="cpu")
    run = make_smc(target, make_aux_slice, n_particles=cfg.particles,
                   n_mcmc=cfg.smc_n_mcmc)
    states, diag = run(3)
    assert diag["betas"][-1] == 1.0
    assert 2 <= diag["n_stages"] < 50
    th = states.theta.double().numpy()
    exp_mean = target.posterior_mean.double().numpy()
    exp_var = np.diag(target.posterior_cov.double().numpy())
    se = np.sqrt(exp_var / cfg.particles) * 4   # particles correlate a bit
    assert np.all(np.abs(th.mean(0) - exp_mean) < 5 * se), th.mean(0)
    assert np.all(np.abs(th.var(0) - exp_var) < 0.3 * exp_var)
    assert abs(diag["log_z"] - _toy_log_evidence()) < 0.15, diag["log_z"]


def test_smc_nuts_rejuvenation():
    target = make_gaussian_toy(n_importance=8, noise_frac=0.5, device="cpu")
    run = make_smc(target, make_aux_nuts, n_particles=512, n_mcmc=2)
    stages = []
    states, diag = run(4, on_stage=lambda s, b, st, info: stages.append(
        float(info["nuts/n_leapfrog"].mean())))
    assert diag["betas"][-1] == 1.0
    assert len(stages) == diag["n_stages"] and min(stages) >= 1
    exp_mean = target.posterior_mean.double().numpy()
    assert np.all(np.abs(states.theta.double().numpy().mean(0) - exp_mean)
                  < 0.25)


# --------------------------------------------------------- the GP target


@pytest.fixture(scope="module")
def gp():
    x, y = jload("pima", subsample=48)
    return make_gp_classification(x, y, n_importance=8, device="cpu")


def test_tempered_target_scales_every_estimator_left(gp):
    """On a padded GP target (which has both sweep factories, the coordinate
    probes and the carried-factor hooks) every estimator closure left on
    ``tempered_target(t, 0.5)`` returns 0.5 x the untempered one; no sweep
    factory is left."""
    tt = tempered_target(gp, torch.tensor(0.5))
    assert gp.ess_sweep_factory is not None and gp.sigma_sweep_factory
    for name in ("ess_sweep_factory", "sigma_sweep_factory",
                 "coord_estimators", "coord_estimators_c", "cache_init",
                 "prepare_c", "log_lik_est_rot", "log_weights_u"):
        assert getattr(tt, name) is None, name
    rng = np.random.default_rng(0)
    theta = torch.from_numpy(rng.standard_normal((3, 2)).astype(np.float32)
                             * 0.3)
    u = torch.from_numpy(rng.standard_normal((3, *gp.u_shape))
                         .astype(np.float32))
    torch.testing.assert_close(tt.log_lik_est(theta, u),
                               0.5 * gp.log_lik_est(theta, u), rtol=0, atol=0)
    prepared = tt.prepare(theta)
    torch.testing.assert_close(tt.log_lik_est_u(prepared, u),
                               0.5 * gp.log_lik_est_u(prepared, u), rtol=0,
                               atol=0)
    torch.testing.assert_close(tt.log_prior(theta), gp.log_prior(theta))
    # every callable field left is the prior, a prepare, a draw, or scaled
    left = {f for f in ("log_lik_est", "log_lik_est_u", "prepare",
                        "log_prior", "sample_prior_key",
                        "exact_log_post")
            if getattr(tt, f) is not None}
    callables = {f for f, v in vars(tt).items() if callable(v)}
    assert callables == left


@pytest.mark.parametrize("rejuvenation", ["aux_slice", "aux_nuts"])
def test_smc_on_a_gp_target(gp, rejuvenation):
    from auxpm_tpu_torch.samplers.composite import SAMPLERS

    run = make_smc(gp, SAMPLERS[rejuvenation], n_particles=48, n_mcmc=1)
    states, diag = run(5)
    assert diag["betas"][-1] == 1.0 and np.isfinite(diag["log_z"])
    assert np.all(np.diff(diag["betas"]) > 0)
    assert torch.isfinite(states.theta).all()
    # the state carries the UNtempered estimate of its own (theta, u)
    torch.testing.assert_close(states.log_lik_hat,
                               gp.log_lik_est(states.theta, states.u),
                               rtol=0, atol=2e-4)


# ------------------------------------------------------------------- the CLI


def test_cli_smc_toy(capsys):
    out = {}
    assert trun.main(["--preset", "smc_toy", "--device", "cpu",
                      "--particles", "256"], result=out) == 0
    summary = out["summary"]
    assert summary["phase"] == "smc_summary"
    assert summary["betas"][-1] == 1.0 and np.isfinite(summary["log_z"])
    assert '"smc_summary"' in capsys.readouterr().out
    want = {"target": "gaussian_toy", "n_importance": 16, "sampler": "smc",
            "smc_rejuvenation": "aux_slice", "particles": 2048}
    assert {k: getattr(PRESETS["smc_toy"], k) for k in want} == want


@pytest.mark.parametrize("overrides", [
    {"sampler": "smc", "sharded": True},
    {"sampler": "smc", "smc_carry_u": False},
    {"sampler": "smc", "smc_rejuvenation": "aux_nuts", "sharded": True,
     "particle_shards": 2},
])
def test_sharded_smc_is_refused(overrides):
    """Since the sharded SMC is ported (``samplers/smc_sharded.py``, tested
    in ``test_torch_smc_sharded.py``) only the reference's own refusals
    stay: ``--particle-shards > 1`` with SMC, and the key-as-u mode needs
    ``--sharded true``; no ``NotImplementedError`` is left for items 7b and
    7c."""
    cfg = RunConfig().replace(**overrides)
    if cfg.particle_shards > 1:
        with pytest.raises(ValueError, match="not supported with --sampler "
                                             "smc"):
            unsupported(cfg)
    elif not cfg.smc_carry_u:
        with pytest.raises(ValueError, match="add --sharded true"):
            unsupported(cfg)
        unsupported(cfg.replace(sharded=True))
    else:
        unsupported(cfg)
    unsupported(PRESETS["smc_gp_nuts"])
    for name in ("aux_mh", "aux_slice_rd", "nuts", "slice_theta"):
        # the key-as-u mode maps a composite to its theta-only kernel
        unsupported(PRESETS["smc_gp_nuts"].replace(smc_rejuvenation=name))
    with pytest.raises(ValueError, match="smc_rejuvenation"):
        unsupported(RunConfig().replace(sampler="smc",
                                        smc_rejuvenation="aux_mh"))
