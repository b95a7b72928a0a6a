"""PyTorch port vs the JAX package: stepping-out slices, the per-probe
elliptical-slice loop, the uncached and the generic slice paths, and the
Gaussian toy target (CPU).

The step tests run the JAX ``make_aux_slice`` for a few steps on 4 chains,
recompute with ``jax.random`` the random rows every step consumed (the key
discipline of ``samplers/ess_u.py`` and ``samplers/slice_theta.py``: stepping
out draws nothing of its own), convert the JAX state with
``auxpm_tpu_torch.convert`` and feed state and rows to the port's
deterministic ``apply`` halves, each port step starting from the JAX state of
that step (teacher-forced).

Which JAX path each piece is compared with:
- ``loop_run``: ARD target, carried factor, ``max_step_out=8``, both sides
  built under ``AUXPM_ESS_SWEEP=0``, so the elliptical-slice update is the
  per-probe loop on both sides (rotated estimator against rotated
  estimator); log_sigma per probe with stepping out, two repeats;
- ``uncached_run``: ARD target, no carried factor, ``max_step_out=2`` with
  narrow widths (the step-out cap binds), the reference's whole-sweep ESS in
  its jnp version;
- ``toy_run``: the Gaussian toy: the generic per-coordinate slice branch and
  the loop's ``log_lik_est_u`` route.

Tolerances: theta 1e-5 (an accepted point is l + (r - l) U with identical
U's and identical step-out counts); u 1e-5; counts EQUAL.  log L̂ on the ARD
target 1e-3: both sides build and factor the Gram by different routines
(largest difference seen in these runs 5e-4), and the fixtures use jitter
1e-3 so that this difference stays far below the slice margins and no
decision of these seeded runs falls the other way (see
``tests/test_torch_ard.py`` for the sensitivity at the default jitter).  The
toy has no factorisation: 2e-5.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auxpm_tpu.core.state import blocked_normal
from auxpm_tpu.core.state import init_chain_states as j_init
from auxpm_tpu.models.gaussian_toy import make_gaussian_toy as j_toy
from auxpm_tpu.models.gp_classification import (
    make_gp_classification as jmake,
)
from auxpm_tpu.samplers.chain import run_chains as j_run_chains
from auxpm_tpu.samplers.composite import make_aux_slice as j_aux_slice
from auxpm_tpu_torch import convert
from auxpm_tpu_torch import run as trun
from auxpm_tpu_torch.core import prng
from auxpm_tpu_torch.core.state import init_chain_states as t_init
from auxpm_tpu_torch.models.gaussian_toy import make_gaussian_toy as t_toy
from auxpm_tpu_torch.models.gp_classification import (
    make_gp_classification as tmake,
)
from auxpm_tpu_torch.samplers.chain import run_chains as t_run_chains
from auxpm_tpu_torch.samplers.composite import make_aux_slice
from auxpm_tpu_torch.samplers.ess_u import make_ess_u
from auxpm_tpu_torch.samplers.slice_theta import make_slice_theta
from auxpm_tpu_torch.utils.config import PRESETS, RunConfig, build_target
from auxpm_tpu_torch.utils.diagnostics import (
    effective_sample_size,
    potential_scale_reduction,
)

S, CHAINS, N_RAW, N, D = 8, 4, 60, 128, 3
JITTER = 1e-3
ARD_LL_TOL = 1e-3
INFO_KEYS = ("ess_u/n_shrink", "ess_u/moved", "slice_theta/n_probe",
             "slice_theta/n_probe_chol")


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


def _xy():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N_RAW, D)).astype(np.float32)
    w = rng.standard_normal(D)
    y = np.where(x @ w + 0.3 * rng.standard_normal(N_RAW) > 0, 1.0, -1.0)
    return x, y.astype(np.float32)


@pytest.fixture
def sweep_switch():
    """Set or clear AUXPM_ESS_SWEEP for the time a transition is built."""
    saved = os.environ.get("AUXPM_ESS_SWEEP")

    def switch(value):
        if value is None:
            os.environ.pop("AUXPM_ESS_SWEEP", None)
        else:
            os.environ["AUXPM_ESS_SWEEP"] = value

    yield switch
    switch(saved)


# ------------------------------------------------- the reference's random rows


def _uniform_rows(k_loop, offset):
    return jax.vmap(lambda i: jax.random.uniform(
        jax.random.fold_in(k_loop, i + offset), (), jnp.float32))(
            jnp.arange(32))


def _ess_rows(key, ll, u_shape, n_ess, n_blocks):
    """samplers/ess_u.py, one chain (both of its paths split the key alike):
    -> (key', scal (R, 35), v (R, S, n))."""
    vs, rows = [], []
    for r in range(n_ess):
        key, k_v, k_h, k_loop = jax.random.split(key, 4)
        if n_blocks > 1:
            vs.append(blocked_normal(k_v, u_shape, jnp.float32, n_blocks,
                                     u_shape[0]))
        else:
            vs.append(jax.random.normal(k_v, u_shape, jnp.float32))
        log_h = jnp.log(jax.random.uniform(k_h, (), jnp.float32))
        a0 = jax.random.uniform(k_loop, (), jnp.float32) * (2.0 * jnp.pi)
        ll0 = ll if r == 0 else jnp.float32(0.0)
        rows.append(jnp.concatenate([jnp.stack([ll0, log_h, a0]),
                                     _uniform_rows(k_loop, 1)]))
    return key, jnp.stack(rows), jnp.stack(vs)


def _slice_rows(key, d, n_sigma_extra):
    """samplers/slice_theta.py, one chain: one (reps_i, 34) block per
    coordinate with the three-way split of _slice_1d; the last coordinate's
    extra repeats fold their index into its key."""
    _, *coord_keys = jax.random.split(key, d + 1)

    def row(k_rep):
        k_h, k_init, k_loop = jax.random.split(k_rep, 3)
        log_u = jnp.log(jax.random.uniform(k_h, (), jnp.float32))
        u1 = jax.random.uniform(k_init, (), jnp.float32)
        return jnp.concatenate([jnp.stack([log_u, u1]),
                                _uniform_rows(k_loop, 0)])

    out = []
    for i, k in enumerate(coord_keys):
        reps = 1 + (n_sigma_extra if i == d - 1 else 0)
        out.append(jnp.stack([
            row(k if rep == 0 else jax.random.fold_in(k, rep))
            for rep in range(reps)]))
    return tuple(out)


def _reference_run(tj, tt, n_ess, n_sigma_extra, params_j, n_steps, with_cache,
                   seed):
    """Run the JAX composite ``n_steps`` times one step; return its states,
    per-step infos and rows, the port's params and the port's composite."""
    step_j = j_aux_slice(tj, n_ess=n_ess, n_sigma_extra=n_sigma_extra)
    step_t = make_aux_slice(tt, n_ess=n_ess, n_sigma_extra=n_sigma_extra)
    states = [j_init(jax.random.key(seed), tj, CHAINS, jitter_scale=0.3,
                     with_cache=with_cache)]
    infos = []
    for _ in range(n_steps):  # one jitted one-step program
        s, _recs, info = j_run_chains(step_j, states[-1], params_j, 1)
        states.append(s)
        infos.append({k: np.asarray(v)[:, 0] for k, v in info.items()})

    def rows_of_step(key, ll):
        key_mid, scal, v = _ess_rows(key, ll, tj.u_shape, n_ess,
                                     tj.n_weight_blocks)
        return (scal, v) + _slice_rows(key_mid, tj.d, n_sigma_extra)

    rows_fn = jax.jit(jax.vmap(rows_of_step))
    rows = [tuple(np.asarray(r) for r in rows_fn(s.key, s.log_lik_hat))
            for s in states[:-1]]
    params_t = convert.params_from_numpy(
        {g: {k: np.asarray(v) for k, v in sub.items()}
         for g, sub in params_j.items()}, device="cpu")
    return states, infos, rows, params_t, step_t


def _to_port(state_j):
    extras = state_j.extras if isinstance(state_j.extras, dict) else {}
    cache = extras.get("target_cache")
    return convert.chain_states_from_numpy(
        {"theta": np.asarray(state_j.theta), "u": np.asarray(state_j.u),
         "log_lik_hat": np.asarray(state_j.log_lik_hat),
         "chol_r": None if cache is None else np.asarray(cache["chol_r"])},
        device="cpu")


def _apply_step(step_t, state, rows, params):
    scal, v, *reps = (_t(r) for r in rows)
    ess, sl = step_t.stages["ess_u"], step_t.stages["slice_theta"]
    state, info_e = ess.apply(state, {"scal": scal, "v": v}, params["ess_u"])
    state, info_s = sl.apply(state, tuple(reps), params["slice_theta"])
    return state, {**{f"ess_u/{k}": v for k, v in info_e.items()},
                   **{f"slice_theta/{k}": v for k, v in info_s.items()}}


def _assert_step_matches(state_t, info_t, state_j, info_j, ll_tol):
    for k in INFO_KEYS:
        np.testing.assert_array_equal(info_t[k].numpy(), info_j[k], err_msg=k)
    np.testing.assert_allclose(state_t.theta.numpy(),
                               np.asarray(state_j.theta), rtol=0, atol=1e-5)
    np.testing.assert_allclose(state_t.log_lik_hat.numpy(),
                               np.asarray(state_j.log_lik_hat), rtol=0,
                               atol=ll_tol)
    np.testing.assert_allclose(state_t.u.numpy(), np.asarray(state_j.u),
                               rtol=0, atol=1e-5)


# ------------------------------- ARD, carried factor, stepping out, loop ESS

LOOP_STEPS = 3


@pytest.fixture(scope="module")
def ard_pair():
    x, y = _xy()
    return (jmake(x, y, n_importance=S, ard=True, jitter=JITTER),
            tmake(x, y, n_importance=S, ard=True, jitter=JITTER,
                  device="cpu"))


@pytest.fixture(scope="module")
def loop_run(ard_pair):
    tj, tt = ard_pair
    params_j = {"ess_u": {}, "slice_theta": {
        "widths": jnp.asarray([1.0, 0.8, 1.2, 0.6], jnp.float32),
        "max_step_out": 8, "max_shrink_chol": 5}}
    saved = os.environ.get("AUXPM_ESS_SWEEP")
    os.environ["AUXPM_ESS_SWEEP"] = "0"   # read when the transitions are built
    try:
        out = _reference_run(tj, tt, 2, 1, params_j, LOOP_STEPS, True, seed=3)
    finally:
        if saved is None:
            del os.environ["AUXPM_ESS_SWEEP"]
        else:
            os.environ["AUXPM_ESS_SWEEP"] = saved
    return out + (tt,)


@pytest.mark.parametrize("k", range(LOOP_STEPS))
def test_stepout_ard_loop_ess_teacher_forced(loop_run, k):
    states, infos, rows, params_t, step_t, tt = loop_run
    assert not step_t.stages["ess_u"].uses_sweep
    state_t, info_t = _apply_step(step_t, _to_port(states[k]), rows[k],
                                  params_t)
    _assert_step_matches(state_t, info_t, states[k + 1], infos[k],
                         ARD_LL_TOL)
    np.testing.assert_allclose(
        state_t.extras["target_cache"]["chol_r"].numpy(),
        np.asarray(states[k + 1].extras["target_cache"]["chol_r"]), atol=5e-4)
    # the carried factor is the factor of the new theta
    assert torch.equal(state_t.extras["target_cache"]["chol_r"],
                       tt.cache_init(state_t.theta)["chol_r"])


def test_stepout_run_really_stepped_out_and_shrank(loop_run):
    """The fixture exercises what it is for: some chain stepped out (a probe
    count above its shrinks alone), and the ell coordinates kept their own
    cap."""
    _, infos, *_ = loop_run
    n_probe = np.stack([i["slice_theta/n_probe"] for i in infos])
    n_chol = np.stack([i["slice_theta/n_probe_chol"] for i in infos])
    # 4 coordinates (+1 repeat), each at least 2 step-out probes and 1 shrink
    assert (n_probe >= 3 * (D + 2)).all() and n_probe.max() > 3 * (D + 2)
    assert (n_chol <= D * (2 * 8 + 5)).all() and (n_chol < n_probe).all()
    assert np.stack([i["ess_u/moved"] for i in infos]).mean() > 0.5


# ------------------------ ARD, no carried factor, a binding step-out cap


@pytest.fixture(scope="module")
def uncached_run(ard_pair):
    tj, tt = ard_pair
    params_j = {"ess_u": {}, "slice_theta": {
        "widths": jnp.asarray([0.3, 0.3, 0.3, 0.2], jnp.float32),
        "max_step_out": 2}}
    return _reference_run(tj, tt, 1, 0, params_j, 1, False, seed=5)


def test_stepout_ard_uncached_teacher_forced(uncached_run):
    states, infos, rows, params_t, step_t = uncached_run
    assert step_t.stages["ess_u"].uses_sweep
    state_t, info_t = _apply_step(step_t, _to_port(states[0]), rows[0],
                                  params_t)
    assert state_t.extras == {}
    _assert_step_matches(state_t, info_t, states[1], infos[0], ARD_LL_TOL)
    # narrow widths: some coordinate of some chain ran into the cap of 2
    assert info_t["slice_theta/n_probe"].max() >= 2 * 2 * (D + 1)


def test_cached_and_uncached_paths_agree_bitwise(ard_pair):
    """Carrying the factor changes where it is computed, not what is
    computed: same seeds, same draws, the same values on both paths."""
    _, tt = ard_pair
    step = make_aux_slice(tt, n_ess=2, n_sigma_extra=1)
    params = {"ess_u": {}, "slice_theta": {
        "widths": _t([1.0, 0.8, 1.2, 0.6]), "max_step_out": 8,
        "max_shrink_chol": 5}}
    s_c = t_init(7, tt, 3, jitter_scale=0.3, with_cache=True)
    s_nc = t_init(7, tt, 3, jitter_scale=0.3)
    assert "target_cache" in s_c.extras and not s_nc.extras
    out_c, recs_c, infos_c = t_run_chains(step, s_c, params, 3)
    out_nc, recs_nc, infos_nc = t_run_chains(step, s_nc, params, 3)
    assert torch.equal(recs_c["theta"], recs_nc["theta"])
    assert torch.equal(recs_c["log_lik_hat"], recs_nc["log_lik_hat"])
    assert torch.equal(out_c.u, out_nc.u)
    for k in infos_c:
        assert torch.equal(infos_c[k], infos_nc[k]), k
    assert not out_nc.extras
    assert torch.equal(out_c.extras["target_cache"]["chol_r"],
                       tt.cache_init(out_c.theta)["chol_r"])


def test_loop_and_sweep_paths_agree(ard_pair, sweep_switch):
    """The per-probe loop and the whole sweep make the same decisions on the
    same rows and agree in values to rounding."""
    _, tt = ard_pair
    sweep_switch(None)
    ess_sweep = make_ess_u(tt, n_repeats=2)
    sweep_switch("0")
    ess_loop = make_ess_u(tt, n_repeats=2)
    sweep_switch("1")
    assert make_ess_u(tt).uses_sweep
    assert ess_sweep.uses_sweep and not ess_loop.uses_sweep
    st = t_init(9, tt, CHAINS, jitter_scale=0.3, with_cache=True)
    rows, _ = ess_sweep.draw(st)
    a, info_a = ess_sweep.apply(st, rows, {})
    b, info_b = ess_loop.apply(st, rows, {})
    assert torch.equal(info_a["n_shrink"], info_b["n_shrink"])
    assert torch.equal(info_a["moved"], info_b["moved"])
    np.testing.assert_allclose(a.u.numpy(), b.u.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(a.log_lik_hat.numpy(), b.log_lik_hat.numpy(),
                               rtol=0, atol=2e-5)
    # the carried estimate is the estimate of the carried u
    np.testing.assert_allclose(
        b.log_lik_hat.numpy(),
        tt.log_lik_est_u(tt.prepare_c(b.theta, b.extras["target_cache"]),
                         b.u).numpy(), rtol=0, atol=2e-5)


def test_a_cached_target_on_the_generic_branch_keeps_the_cache_invariant(
        ard_pair):
    """A target without factories takes the generic branch; the carried
    factor is refreshed behind it."""
    _, tt = ard_pair
    bare = dataclasses.replace(tt, coord_estimators=None,
                               coord_estimators_c=None,
                               sigma_sweep_factory=None)
    with pytest.warns(UserWarning, match="n_sigma_extra"):
        sl = make_slice_theta(bare, n_sigma_extra=1)
    st = t_init(2, tt, 2, jitter_scale=0.3, with_cache=True)
    rows, _ = sl.draw(st)
    assert [tuple(r.shape) for r in rows] == [(2, 1, 34)] * (D + 1)
    probe_log = []   # every decision's margin, for a caller that wants them
    out, info = sl.apply(st, rows, {"widths": 0.8, "max_step_out": 2,
                                    "probe_log": probe_log})
    assert torch.equal(info["n_probe"], info["n_probe_chol"])
    assert len(probe_log) >= 3 * (D + 1)   # two ends + a shrink per coordinate
    assert all(c.dtype == torch.bool and m.shape == (2,)
               for c, m in probe_log)
    assert torch.equal(out.extras["target_cache"]["chol_r"],
                       tt.cache_init(out.theta)["chol_r"])
    # the structure-aware branch on the same rows makes the same moves: the
    # probes are the same function of (theta, u)
    full, info_f = make_slice_theta(tt).apply(
        st, rows, {"widths": 0.8, "max_step_out": 2})
    np.testing.assert_allclose(out.theta.numpy(), full.theta.numpy(), rtol=0,
                               atol=1e-5)
    assert torch.equal(info["n_probe"], info_f["n_probe"])


# ------------------------------------------------------------ the Gaussian toy


def test_toy_estimator_and_moments_match_jax(monkeypatch):
    tj = j_toy(n_importance=16, noise_frac=0.3)
    tt = t_toy(n_importance=16, noise_frac=0.3, device="cpu")
    assert tt.d == tj.d == 2 and tt.u_shape == tj.u_shape == (16, 2)
    assert tt.name == tj.name and tt.coord_estimators is None
    np.testing.assert_allclose(tt.posterior_mean.numpy(),
                               np.asarray(tj.posterior_mean), rtol=1e-6)
    np.testing.assert_allclose(tt.posterior_cov.numpy(),
                               np.asarray(tj.posterior_cov), rtol=1e-6)
    rng = np.random.default_rng(12)
    theta = (rng.standard_normal((5, 2)) * 1.5).astype(np.float32)
    u = rng.standard_normal((5, 16, 2)).astype(np.float32)
    for name in ("log_prior", "exact_log_post"):
        want = jax.vmap(getattr(tj, name))(jnp.asarray(theta))
        np.testing.assert_allclose(getattr(tt, name)(_t(theta)).numpy(),
                                   np.asarray(want), rtol=2e-6, atol=2e-6)
    want = jax.vmap(tj.log_lik_est)(jnp.asarray(theta), jnp.asarray(u))
    got = tt.log_lik_est(_t(theta), _t(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)
    # prepare is the identity and log_lik_est_u takes theta in its place
    assert torch.equal(tt.prepare(_t(theta)), _t(theta))
    assert torch.equal(tt.log_lik_est_u(_t(theta), _t(u)), got)
    # other constants than the defaults, carried across as NumPy arrays
    y = np.float32([0.3, 0.9])
    sig = np.float32([[0.7, -0.2], [-0.2, 1.1]])
    tj2 = j_toy(n_importance=4, noise_frac=0.1, prior_var=2.0, y=y,
                sigma_y=sig)
    tt2 = t_toy(n_importance=4, noise_frac=0.1, prior_var=2.0, y=y,
                sigma_y=sig, device="cpu")
    np.testing.assert_allclose(
        tt2.log_lik_est(_t(theta), _t(u[:, :4])).numpy(),
        np.asarray(jax.vmap(tj2.log_lik_est)(jnp.asarray(theta),
                                             jnp.asarray(u[:, :4]))),
        rtol=0, atol=5e-5)
    np.testing.assert_allclose(tt2.posterior_mean.numpy(),
                               np.asarray(tj2.posterior_mean), rtol=1e-6)
    draws = tt.sample_prior_key(prng.split(prng.key(0), 4000))
    assert abs(float(draws.std()) - 2.0) < 0.1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        t_toy()  # device defaults to "cuda"


TOY_STEPS = 3


@pytest.fixture(scope="module")
def toy_run():
    tj = j_toy(n_importance=16, noise_frac=0.3)
    tt = t_toy(n_importance=16, noise_frac=0.3, device="cpu")
    params_j = {"ess_u": {}, "slice_theta": {
        "widths": jnp.asarray([1.5, 0.7], jnp.float32), "max_step_out": 8}}
    return _reference_run(tj, tt, 2, 0, params_j, TOY_STEPS, False,
                          seed=1) + (tt,)


@pytest.mark.parametrize("k", range(TOY_STEPS))
def test_toy_aux_slice_teacher_forced(toy_run, k):
    """The generic slice branch (all coordinates with max_shrink,
    n_probe_chol = n_probe) and the loop's log_lik_est_u route."""
    states, infos, rows, params_t, step_t, _ = toy_run
    assert not step_t.stages["ess_u"].uses_sweep
    state_t, info_t = _apply_step(step_t, _to_port(states[k]), rows[k],
                                  params_t)
    _assert_step_matches(state_t, info_t, states[k + 1], infos[k], 2e-5)
    assert torch.equal(info_t["slice_theta/n_probe"],
                       info_t["slice_theta/n_probe_chol"])


def test_ess_loop_routes_agree_on_the_toy(toy_run):
    """A target without ``prepare`` goes through ``log_lik_est``: the same
    numbers as the ``log_lik_est_u`` route."""
    states, _, rows, _, step_t, tt = toy_run
    bare = dataclasses.replace(tt, prepare=None, log_lik_est_u=None)
    st = _to_port(states[0])
    r = {"scal": _t(rows[0][0]), "v": _t(rows[0][1])}
    a, info_a = step_t.stages["ess_u"].apply(st, r, {})
    b, info_b = make_ess_u(bare, n_repeats=2).apply(st, r, {})
    assert torch.equal(a.u, b.u) and torch.equal(a.log_lik_hat, b.log_lik_hat)
    assert torch.equal(info_a["n_shrink"], info_b["n_shrink"])


def test_toy_aux_slice_with_stepping_out_recovers_posterior():
    """Closed-form moments within MC error, the bars of the reference's own
    toy test (5 standard errors on the mean, 40 % on the variance, R-hat
    below 1.15), with the default stepping out.  Fixed seed."""
    tt = t_toy(n_importance=16, noise_frac=0.3, device="cpu")
    step = make_aux_slice(tt)
    states = t_init(0, tt, 32, jitter_scale=0.5)
    params = {"slice_theta": {"widths": 2.0}}
    states, recs, infos = t_run_chains(step, states, params, 700)
    theta = recs["theta"].numpy()[:, 100:, :]
    flat = theta.reshape(-1, 2)
    ess = effective_sample_size(theta)
    exp_mean = tt.posterior_mean.numpy().astype(np.float64)
    exp_var = np.diag(tt.posterior_cov.numpy().astype(np.float64))
    se = np.sqrt(exp_var / np.maximum(ess, 1.0))
    assert np.all(np.abs(flat.mean(0) - exp_mean) < 5 * se), (flat.mean(0), se)
    assert np.all(potential_scale_reduction(theta) < 1.15)
    assert np.all(np.abs(flat.var(0) - exp_var) < 0.4 * exp_var)
    assert np.all(ess > 100)
    assert float(infos["ess_u/moved"].mean()) > 0.9
    # stepping out happened: more probes than one shrink per coordinate
    assert float(infos["slice_theta/n_probe"].mean()) > 2 * 2 + 2


# ------------------------------------------------------------------- the CLI


def test_cli_runs_the_ard_preset_and_the_toy_on_cpu(capsys, sweep_switch):
    cfg = PRESETS["pima_ard_aux"]
    assert (cfg.ard, cfg.chains, cfg.n_importance, cfg.max_step_out,
            cfg.n_ess, cfg.n_sigma_extra, cfg.max_shrink_chol,
            cfg.chol_cache, cfg.device) == (True, 64, 64, 8, 1, 0, 32, True,
                                            "cuda")
    small = ["--device", "cpu", "--chains", "2", "--subsample", "40",
             "--n-importance", "8", "--steps", "2", "--window-steps", "1",
             "--warmup-windows", "1"]
    for switch, cache in (("0", "true"), (None, "false")):
        sweep_switch(switch)
        out = {}
        assert trun.main(["--preset", "pima_ard_aux", *small,
                          "--chol-cache", cache], result=out) == 0
        assert out["theta"].shape == (2, 2, 8)
        assert np.isfinite(out["theta"]).all()
        assert out["params"]["slice_theta"]["widths"].shape == (8,)
        assert ("target_cache" in out["states"].extras) == (cache == "true")
        assert out["windows"][-1]["slice_theta/n_probe"] >= 3 * 8
    sweep_switch(None)
    out = {}
    assert trun.main(["--target", "gaussian_toy", "--device", "cpu",
                      "--chains", "3", "--steps", "4", "--window-steps", "2",
                      "--warmup-windows", "1", "--widths", "2.0"],
                     result=out) == 0
    assert out["theta"].shape == (3, 4, 2) and out["target"].name == \
        "gaussian_toy"
    capsys.readouterr()
    assert build_target(RunConfig(target="gaussian_toy", device="cpu",
                                  noise_frac=0.1)).u_shape == (16, 2)
    with pytest.raises(ValueError, match="unknown target"):
        build_target(RunConfig(target="banana", device="cpu"))
