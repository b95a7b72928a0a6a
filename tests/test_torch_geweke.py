"""Geweke-style joint invariance of every sampler of the port (CPU).

The port's counterpart of ``tests/test_geweke_invariance.py``, over the
port's ``SAMPLERS`` plus ``aux_slice_noso`` (shrinkage-only slice) and
``aux_slice_ess4`` (four ESS repeats per step), at the reference's size:
4096 chains x 25 steps, theta in 2-D, u of (4, 8).

Constant-likelihood target (log L̂ = 0): the stationary joint is N(theta;
0, I) x N(u; 0, I).  The initial population is drawn exactly from it, and
after 25 steps theta's first, second and fourth moments, u's first and
second and the theta-u correlation must still match, each within 5 CLT
standard errors.

Noisy-estimator target (log L̂ = -eps/2 ||u||², eps = 1): the joint is
N(theta; 0, I) x N(u; 0, (1 + eps)^-1 I), and the bracket-shrink and slice
loops genuinely iterate under the check (asserted: mean ESS shrinks > 0.05,
mean slice probes > 1).

Seeds are ``crc32`` of the case name, as in the reference, fed to NumPy for
the population and to the chains' keys (``prng.split(prng.key(seed), N)``)
for the steps.
"""

import zlib

import numpy as np
import pytest
import torch

from auxpm_tpu_torch.core import prng
from auxpm_tpu_torch.core.state import ChainState
from auxpm_tpu_torch.models.base import Target
from auxpm_tpu_torch.samplers.chain import run_chains
from auxpm_tpu_torch.samplers.composite import SAMPLERS, make_aux_slice

D, U_SHAPE, N_CHAINS, N_STEPS, EPS = 2, (4, 8), 4096, 25, 1.0
LOG_NORM = 0.5 * D * float(np.log(2.0 * np.pi))

PARAMS = {
    "pm_mh": {"step_size": 0.8},
    "aux_slice": {"slice_theta": {"widths": 2.0}},
    "aux_slice_rd": {"slice_theta": {"widths": 2.0}},
    "aux_slice_pcrd": {"slice_theta": {"widths": 2.0},
                       "slice_theta_rd": {"widths": 2.0}},
    "aux_slice_joint": {"slice_theta": {"widths": 2.0},
                        "joint_slice": {"width": 2.0}},
    "aux_mh": {"mh_theta": {"step_size": 0.8}},
    "joint_slice": {"joint_slice": {"width": 2.0, "angle_scale": 1.2}},
    "joint_mh": {"joint_mh": {"step_size": 0.8, "rho": 0.5}},
    "aux_hmc": {"hmc": {"step_size": 0.5, "n_leapfrog": 4}},
    "aux_nuts": {"nuts": {"step_size": 0.6}},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its tests run many small ops,
    and the suite runs several workers on the same cores, where
    multi-threaded small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _target(log_lik_est, name):
    return Target(
        d=D, u_shape=U_SHAPE,
        log_prior=lambda theta: -0.5 * (theta * theta).sum(-1) - LOG_NORM,
        log_lik_est=log_lik_est,
        theta_init=torch.zeros(D), device=torch.device("cpu"), name=name)


def _const(theta, u):
    return torch.zeros(theta.shape[0])


def _noisy(theta, u):
    return -0.5 * EPS * (u * u).sum((-2, -1))


def _step_and_params(name, target):
    if name == "aux_slice_noso":
        return make_aux_slice(target), {"slice_theta": {"widths": 2.5,
                                                        "max_step_out": 0}}
    if name == "aux_slice_ess4":
        return make_aux_slice(target, n_ess=4), {"slice_theta":
                                                 {"widths": 2.0}}
    return SAMPLERS[name](target), PARAMS[name]


def _population(seed, target, u_scale):
    rng = np.random.default_rng(seed)
    theta = torch.as_tensor(rng.standard_normal((N_CHAINS, D)),
                            dtype=torch.float32)
    u = torch.as_tensor(rng.standard_normal((N_CHAINS, *U_SHAPE)) * u_scale,
                        dtype=torch.float32)
    return ChainState(theta=theta, u=u,
                      log_lik_hat=target.log_lik_est(theta, u),
                      key=prng.split(prng.key(seed), N_CHAINS))


def _check_moments(states, u_var):
    theta = states.theta.double().numpy()
    u = states.u.double().numpy().reshape(N_CHAINS, -1)
    se = 1.0 / np.sqrt(N_CHAINS)
    assert np.all(np.abs(theta.mean(0)) < 5 * se), theta.mean(0)
    assert np.all(np.abs(theta.var(0) - 1.0) < 5 * np.sqrt(2) * se), \
        theta.var(0)
    se_u = 1.0 / np.sqrt(u.size)
    assert abs(u.mean()) < 5 * np.sqrt(u_var) * se_u, u.mean()
    assert abs(u.var() - u_var) < 5 * np.sqrt(2) * u_var * se_u, u.var()
    r = np.corrcoef(theta[:, 0], u.mean(1))[0, 1]
    assert abs(r) < 5 * se
    return theta


@pytest.mark.parametrize(
    "name", sorted(SAMPLERS) + ["aux_slice_noso", "aux_slice_ess4"])
def test_prior_invariance(name):
    target = _target(_const, "const_lik")
    step, params = _step_and_params(name, target)
    states = _population(zlib.crc32(name.encode()) % 2**31, target, 1.0)
    states, _, _ = run_chains(step, states, params, N_STEPS)
    theta = _check_moments(states, 1.0)
    se = 1.0 / np.sqrt(N_CHAINS)
    assert np.all(np.abs((theta ** 4).mean(0) - 3.0) < 5 * np.sqrt(96) * se)


@pytest.mark.parametrize("name", sorted(SAMPLERS) + ["aux_slice_ess4"])
def test_noisy_estimator_invariance(name):
    target = _target(_noisy, "noisy_lik")
    step, params = _step_and_params(name, target)
    states = _population(zlib.crc32(("noisy:" + name).encode()) % 2**31,
                         target, 1.0 / np.sqrt(1.0 + EPS))
    states, _, infos = run_chains(step, states, params, N_STEPS)
    # the loops under the check must actually iterate
    if "ess_u/n_shrink" in infos:
        ns = float(infos["ess_u/n_shrink"].double().mean())
        assert ns > 0.05, f"ESS bracket never shrank (mean {ns})"
    for key in ("slice_theta/n_probe", "joint_slice/n_probe"):
        if key in infos:
            npb = float(infos[key].double().mean())
            assert npb > 1.0, f"{key}: the slice loop never iterated ({npb})"
    _check_moments(states, 1.0 / (1.0 + EPS))
