"""The port's bounded batched loops against the scalar NumPy oracle (CPU).

The port's counterpart of ``tests/test_oracle_equivalence.py``: ``pm_mh``,
the elliptical-slice update's per-probe loop, the per-coordinate slice
(``max_step_out`` 8 and 0) and the random-direction slice, each on 8 chains
of the Gaussian toy for 10 steps, must give the samples of the plain
single-chain Python loops of ``tests/oracle/oracle.py`` when both consume the
same random numbers.  The port draws its rows (``step.draw``); each chain's
rows become the oracle's ``ScriptedDraws`` table (a stored log-uniform is
handed over as its exponential, a stored angle divided by 2 pi), and the
oracle evaluates the port's own target one chain at a time.

The oracle has no random-direction slice: the test runs its ``_slice_1d``
along the drawn direction, from t = 0, with the mean width as bracket,
exactly what ``make_slice_theta_rd`` does.

The port runs in float32 and the oracle in float64 on the same float32
target values, so the bar is 1e-5 on theta, u and log L̂ (f32 rounding of
theta + t e and of the bracket arithmetic) while every decision (accepts,
probe counts, moves) must be EQUAL.
"""

import math

import numpy as np
import pytest
import torch

from auxpm_tpu_torch.core.state import init_chain_states
from auxpm_tpu_torch.models.gaussian_toy import make_gaussian_toy
from auxpm_tpu_torch.samplers.ess_u import make_ess_u
from auxpm_tpu_torch.samplers.pm_mh import make_pm_mh
from auxpm_tpu_torch.samplers.slice_theta import (
    make_slice_theta,
    make_slice_theta_rd,
)
from tests.oracle.oracle import (
    OracleState,
    ScriptedDraws,
    _slice_1d,
    ess_update_u,
    pm_mh_step,
    slice_update_theta,
)

CHAINS, STEPS, TOL = 8, 10, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its tests run many small ops,
    and the suite runs several workers on the same cores, where
    multi-threaded small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class NpTarget:
    """One chain of the port's (CPU) target, as the oracle calls it."""

    def __init__(self, target):
        self.t = target

    def log_prior(self, theta):
        return float(self.t.log_prior(torch.as_tensor(
            np.float32(theta))[None])[0])

    def log_lik_est(self, theta, u):
        return float(self.t.log_lik_est(
            torch.as_tensor(np.float32(theta))[None],
            torch.as_tensor(np.float32(u))[None])[0])


@pytest.fixture(scope="module")
def toy():
    return make_gaussian_toy(n_importance=8, device="cpu")


def _oracle_state(state, c):
    return OracleState(state.theta[c].double().numpy(),
                       state.u[c].double().numpy(),
                       float(state.log_lik_hat[c]))


def _slice_table(prefix, rep):
    """``rep (34,)`` = [log U, U1, 32 shrink uniforms] as oracle draws."""
    rep = rep.double().numpy()
    table = {f"{prefix}_h": math.exp(rep[0]), f"{prefix}_init": rep[1]}
    table.update({f"{prefix}_shrink_{j}": rep[2 + j] for j in range(32)})
    return table


def _assert_chain(state, c, want, what):
    np.testing.assert_allclose(state.theta[c].double().numpy(), want.theta,
                               rtol=0, atol=TOL, err_msg=what)
    np.testing.assert_allclose(state.u[c].double().numpy(), want.u, rtol=0,
                               atol=TOL, err_msg=what)
    np.testing.assert_allclose(float(state.log_lik_hat[c]), want.log_lik_hat,
                               rtol=0, atol=TOL, err_msg=what)


def _run(toy, step, params, oracle_step, seed):
    """``STEPS`` port steps from ``step.draw`` rows; each chain held to
    ``oracle_step(oracle_state, chain rows) -> (state, decision)``.  Returns
    every step's decisions of both sides."""
    state = init_chain_states(seed, toy, CHAINS, jitter_scale=0.5)
    ora = NpTarget(toy)
    got, want = [], []
    for k in range(STEPS):
        rows, key = step.draw(state)
        new, info = step.apply(state, rows, params)
        new = new.replace(key=key)
        for c in range(CHAINS):
            o_new, decision = oracle_step(ora, _oracle_state(state, c), rows,
                                          c)
            _assert_chain(new, c, o_new, f"step {k} chain {c}")
            want.append(decision)
        got.append(info)
        state = new
    return got, want


def test_pm_mh_matches_oracle(toy):
    def oracle(ora, o_state, rows, c):
        table = {"prop": rows["eps"][c].double().numpy(),
                 "u": rows["u"][c].double().numpy(),
                 "acc": math.exp(float(rows["log_unif"][c]))}
        return pm_mh_step(o_state, ora, 0.5, ScriptedDraws(table))

    got, want = _run(toy, make_pm_mh(toy), {"step_size": 0.5}, oracle, 7)
    acc = [bool(a) for info in got for a in info["accept"]]
    assert acc == want and 0 < sum(acc) < len(acc)


def test_ess_loop_matches_oracle(toy):
    step = make_ess_u(toy)
    assert not step.uses_sweep   # the toy has no sweep: the per-probe loop

    def oracle(ora, o_state, rows, c):
        scal = rows["scal"][c, 0].double().numpy()
        table = {"v": rows["v"][c, 0].double().numpy(),
                 "h": math.exp(scal[1]), "a0": scal[2] / (2.0 * math.pi)}
        table.update({f"shrink_{i}": scal[3 + i] for i in range(32)})
        return ess_update_u(o_state, ora, ScriptedDraws(table))

    got, want = _run(toy, step, {}, oracle, 3)
    n_shrink = [int(n) for info in got for n in info["n_shrink"]]
    assert n_shrink == want and sum(n_shrink) > 0


@pytest.mark.parametrize("max_step_out", [8, 0])
def test_slice_theta_matches_oracle(toy, max_step_out):
    widths = 1.3 if max_step_out else 3.0

    def oracle(ora, o_state, rows, c):
        table = {}
        for i, rep in enumerate(rows):
            table.update(_slice_table(f"c{i}", rep[c, 0]))
        return slice_update_theta(o_state, ora, widths, ScriptedDraws(table),
                                  max_step_out=max_step_out)

    got, want = _run(toy, make_slice_theta(toy),
                     {"widths": widths, "max_step_out": max_step_out},
                     oracle, 11)
    probes = [int(n) for info in got for n in info["n_probe"]]
    assert probes == want


@pytest.mark.parametrize("max_step_out", [8, 0])
def test_slice_theta_rd_matches_oracle_along_the_direction(toy,
                                                           max_step_out):
    widths = torch.tensor([1.1, 1.5]) if max_step_out else 3.0
    w = float(torch.as_tensor(widths).mean())

    def oracle(ora, o_state, rows, c):
        e = rows["direction"][c].double().numpy()
        theta0 = o_state.theta

        def f(t):
            th = theta0 + t * e
            ll = ora.log_lik_est(th, o_state.u)
            return ora.log_prior(th) + ll, ll

        log_post0 = ora.log_prior(theta0) + o_state.log_lik_hat
        t_new, _lp, ll_new, done, k = _slice_1d(
            0.0, log_post0, f, w, ScriptedDraws(_slice_table(
                "rd", rows["rep"][c])), "rd", max_step_out)
        new = OracleState(theta0 + t_new * e, o_state.u,
                          ll_new if done else o_state.log_lik_hat)
        return new, (k, done)

    got, want = _run(toy, make_slice_theta_rd(toy),
                     {"widths": widths, "max_step_out": max_step_out},
                     oracle, 13)
    decisions = [(int(n), bool(m)) for info in got
                 for n, m in zip(info["n_probe"], info["moved"])]
    assert decisions == want
    assert any(m for _, m in decisions)
