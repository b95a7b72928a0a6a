"""PyTorch port vs the JAX package: PM-MH, MH on theta and ``aux_mh``
(config 1 and the GP target), the step-size rule and the cache gate (CPU).

Each step test runs the JAX transition for ``STEPS`` steps on 4 chains, one
step per call, recomputes with ``jax.random`` the random rows every step
consumed (the key discipline of ``samplers/pm_mh.py``, ``mh_theta.py`` and
``ess_u.py``), converts the JAX state with ``auxpm_tpu_torch.convert`` and
feeds state and rows to the port's deterministic ``apply`` (teacher-forced:
each port step starts from the JAX state of that step).

Targets: the Gaussian toy (S=16, n=2; its u rows are one plain normal draw)
and the GP target on Pima subsampled to 128 points (S=16, n=128; its u rows
are drawn per row block, ``blocked_normal`` with 8 blocks).

Tolerances: the accept decisions EQUAL.  theta 1e-6 (theta + step * eps in
f32 on both sides).  u 0 (a fresh u' is the reference's own rows, copied).
log L̂: the toy 2e-5 (a log-sum-exp of 16 terms in another order); the GP
target 2e-4, as in ``tests/test_torch_slice.py`` (the proposal's estimate
factors its own Gram, by another routine on each side, and sums ~n O(1)
terms in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auxpm_tpu.core.state import blocked_normal
from auxpm_tpu.core.state import init_chain_states as j_init
from auxpm_tpu.models.datasets import load as jload
from auxpm_tpu.models.gaussian_toy import make_gaussian_toy as j_toy
from auxpm_tpu.models.gp_classification import (
    make_gp_classification as jmake,
)
from auxpm_tpu.samplers.adaptation import adapt_params as j_adapt
from auxpm_tpu.samplers.chain import run_chains as j_run_chains
from auxpm_tpu.samplers.composite import make_aux_mh as j_aux_mh
from auxpm_tpu.samplers.mh_theta import make_mh_theta as j_mh_theta
from auxpm_tpu.samplers.pm_mh import make_pm_mh as j_pm_mh
from auxpm_tpu_torch import convert
from auxpm_tpu_torch import run as trun
from auxpm_tpu_torch.core.state import init_chain_states as t_init
from auxpm_tpu_torch.models.gaussian_toy import make_gaussian_toy as t_toy
from auxpm_tpu_torch.models.gp_classification import (
    make_gp_classification as tmake,
)
from auxpm_tpu_torch.samplers.adaptation import adapt_params as t_adapt
from auxpm_tpu_torch.samplers.chain import run_chains as t_run_chains
from auxpm_tpu_torch.samplers.composite import SAMPLERS
from auxpm_tpu_torch.samplers.mh_theta import make_mh_theta
from auxpm_tpu_torch.samplers.pm_mh import make_pm_mh
from auxpm_tpu_torch.utils.diagnostics import effective_sample_size

S, CHAINS, STEPS, STEP_SIZE = 16, 4, 3, 0.5
LL_TOL = {"toy": 2e-5, "gp": 2e-4}


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
def targets():
    x, y = jload("pima", subsample=128)
    return {
        "toy": (j_toy(n_importance=S), t_toy(n_importance=S, device="cpu")),
        "gp": (jmake(x, y, n_importance=S),
               tmake(x, y, n_importance=S, device="cpu")),
    }


# ------------------------------------------------- the reference's random rows


def _normal_u(key, tj):
    if tj.n_weight_blocks > 1:
        return blocked_normal(key, tj.u_shape, jnp.float32, tj.n_weight_blocks,
                              tj.u_shape[0])
    return jax.random.normal(key, tj.u_shape, jnp.float32)


def _pm_mh_rows(key, tj):
    """samplers/pm_mh.py, one chain."""
    key, k_prop, k_u, k_acc = jax.random.split(key, 4)
    return key, {"eps": jax.random.normal(k_prop, (tj.d,), jnp.float32),
                 "u": _normal_u(k_u, tj),
                 "log_unif": jnp.log(jax.random.uniform(k_acc, (),
                                                        jnp.float32))}


def _mh_theta_rows(key, tj):
    """samplers/mh_theta.py, one chain."""
    key, k_prop, k_acc = jax.random.split(key, 3)
    return key, {"eps": jax.random.normal(k_prop, (tj.d,), jnp.float32),
                 "log_unif": jnp.log(jax.random.uniform(k_acc, (),
                                                        jnp.float32))}


def _ess_rows(key, ll, tj):
    """samplers/ess_u.py with one repeat, one chain."""
    key, k_v, k_h, k_loop = jax.random.split(key, 4)
    log_h = jnp.log(jax.random.uniform(k_h, (), jnp.float32))
    a0 = jax.random.uniform(k_loop, (), jnp.float32) * (2.0 * jnp.pi)
    shrink = jax.vmap(lambda i: jax.random.uniform(
        jax.random.fold_in(k_loop, i + 1), (), jnp.float32))(jnp.arange(32))
    scal = jnp.concatenate([jnp.stack([ll, log_h, a0]), shrink])[None]
    return key, {"scal": scal, "v": _normal_u(k_v, tj)[None]}


def _rows_fn(kind, tj):
    def rows(key, ll):
        if kind == "pm_mh":
            return _pm_mh_rows(key, tj)[1]
        if kind == "mh_theta":
            return _mh_theta_rows(key, tj)[1]
        key, ess = _ess_rows(key, ll, tj)
        return {"ess_u": ess, "mh_theta": _mh_theta_rows(key, tj)[1]}

    return jax.jit(jax.vmap(rows))


def _to_port(state_j):
    return convert.chain_states_from_numpy(
        {"theta": np.asarray(state_j.theta), "u": np.asarray(state_j.u),
         "log_lik_hat": np.asarray(state_j.log_lik_hat)}, device="cpu")


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return _t(np.asarray(tree))


J_MAKERS = {"pm_mh": j_pm_mh, "mh_theta": j_mh_theta, "aux_mh": j_aux_mh}
T_MAKERS = {"pm_mh": make_pm_mh, "mh_theta": make_mh_theta,
            "aux_mh": SAMPLERS["aux_mh"]}


def _params(kind):
    if kind == "aux_mh":
        return {"ess_u": {}, "mh_theta": {"step_size": STEP_SIZE}}
    return {"step_size": STEP_SIZE}


@pytest.fixture(scope="module")
def reference_runs(targets):
    """kind x target -> (JAX states per step, infos per step, rows per
    step), computed once per pair when first asked for."""
    cache = {}

    def get(kind, name):
        if (kind, name) not in cache:
            tj, _ = targets[name]
            step_j = J_MAKERS[kind](tj)
            states = [j_init(jax.random.key(4), tj, CHAINS, jitter_scale=0.3)]
            infos = []
            for _ in range(STEPS):   # one jitted one-step program
                s, _recs, info = j_run_chains(step_j, states[-1],
                                              _params(kind), 1)
                states.append(s)
                infos.append({k: np.asarray(v)[:, 0] for k, v in info.items()})
            fn = _rows_fn(kind, tj)
            rows = [_np_tree(fn(s.key, s.log_lik_hat)) for s in states[:-1]]
            cache[kind, name] = (states, infos, rows)
        return cache[kind, name]

    return get


def _apply(kind, step_t, state, rows):
    if kind != "aux_mh":
        return step_t.apply(state, rows, _params(kind))
    ess, mh = step_t.stages["ess_u"], step_t.stages["mh_theta"]
    mid, info_e = ess.apply(state, rows["ess_u"], {})
    out, info_m = mh.apply(mid, rows["mh_theta"], {"step_size": STEP_SIZE})
    return out, {**{f"ess_u/{k}": v for k, v in info_e.items()},
                 **{f"mh_theta/{k}": v for k, v in info_m.items()}}


@pytest.mark.parametrize("kind", ["pm_mh", "mh_theta", "aux_mh"])
@pytest.mark.parametrize("name", ["toy", "gp"])
def test_step_matches_jax(targets, reference_runs, kind, name):
    """Every step, teacher-forced: decisions equal, values within the
    module's bars; the run accepted some proposals and refused others."""
    _, tt = targets[name]
    states, infos, rows = reference_runs(kind, name)
    step_t = T_MAKERS[kind](tt)
    for k in range(STEPS):
        out, info = _apply(kind, step_t, _to_port(states[k]), rows[k])
        want = states[k + 1]
        assert set(info) == set(infos[k])
        for key in info:
            if key.endswith("accept") or key.startswith("ess_u/"):
                np.testing.assert_array_equal(info[key].numpy(),
                                              infos[k][key], err_msg=key)
            else:   # log_accept_ratio
                np.testing.assert_allclose(info[key].numpy(), infos[k][key],
                                           rtol=0, atol=LL_TOL[name])
        np.testing.assert_allclose(out.theta.numpy(), np.asarray(want.theta),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(out.log_lik_hat.numpy(),
                                   np.asarray(want.log_lik_hat), rtol=0,
                                   atol=LL_TOL[name])
        u_tol = 1e-5 if kind == "aux_mh" else 0.0   # ESS rotates u in f32
        np.testing.assert_allclose(out.u.numpy(), np.asarray(want.u), rtol=0,
                                   atol=u_tol)
        assert out.extras == {}
    acc = np.stack([i["mh_theta/accept" if kind == "aux_mh" else "accept"]
                    for i in infos])
    assert 0 < acc.mean() < 1


def test_pm_mh_is_draw_then_apply(targets):
    _, tt = targets["gp"]
    a = t_init(3, tt, 3, jitter_scale=0.3)
    b = t_init(3, tt, 3, jitter_scale=0.3)
    step = make_pm_mh(tt)
    out_a, info_a = step(a, {"step_size": 0.3})
    rows, key = step.draw(b)
    assert torch.equal(out_a.key, key)
    assert rows["eps"].shape == (3, 2) and rows["log_unif"].shape == (3,)
    assert rows["u"].shape == (3, S, 128)
    out_b, info_b = step.apply(b, rows, {"step_size": 0.3})
    assert torch.equal(out_a.theta, out_b.theta)
    assert torch.equal(out_a.u, out_b.u)
    assert torch.equal(info_a["accept"], info_b["accept"])
    assert (info_a["log_accept_ratio"] <= 0).all()
    # a (d,) step size scales each coordinate of the proposal
    out_c, _ = step.apply(b, {**rows, "log_unif": torch.full((3,), -1e9)},
                          {"step_size": torch.tensor([0.0, 1.0])})
    assert torch.equal(out_c.theta[:, 0], b.theta[:, 0])
    assert torch.equal(out_c.theta[:, 1], b.theta[:, 1] + rows["eps"][:, 1])
    # the particle axis is a Mesh; the reference's axis name is refused
    with pytest.raises(TypeError, match="Mesh"):
        make_pm_mh(tt, particle_axis="particles")


@pytest.mark.parametrize("groups", [("pm_mh",), ("mh_theta",),
                                    ("pm_mh", "mh_theta")])
def test_step_size_rule_matches_jax(groups):
    rng = np.random.default_rng(7)
    infos = {}
    params_j, params_t = {}, {}
    if "pm_mh" in groups:
        infos["accept"] = (rng.random((4, 25)) < 0.6).astype(np.float32)
        params_j["step_size"] = params_t["step_size"] = 0.6
    if "mh_theta" in groups:
        infos["mh_theta/accept"] = (rng.random((4, 25)) < 0.1).astype(
            np.float32)
        params_j["mh_theta"] = {"step_size": 0.4}
        params_t["mh_theta"] = {"step_size": 0.4}
    theta = rng.standard_normal((4, 25, 2)).astype(np.float32)
    new_j = j_adapt(params_j, {"theta": jnp.asarray(theta)},
                    {k: jnp.asarray(v) for k, v in infos.items()})
    new_t = t_adapt(params_t, {"theta": _t(theta)},
                    {k: _t(v) for k, v in infos.items()})
    if "pm_mh" in groups:
        assert isinstance(new_t["step_size"], float)
        np.testing.assert_allclose(new_t["step_size"], new_j["step_size"],
                                   rtol=1e-6)
        assert new_t["step_size"] > 0.6   # accepted above 0.234: wider
    if "mh_theta" in groups:
        np.testing.assert_allclose(new_t["mh_theta"]["step_size"],
                                   new_j["mh_theta"]["step_size"], rtol=1e-6)
        assert new_t["mh_theta"]["step_size"] < 0.4
    assert set(new_t) == set(new_j)


def test_pm_mh_toy_matches_closed_form_moments():
    """PM-MH on the toy, 64 chains x 1500 steps after 500 of burn-in, at the
    preset's step size: each posterior mean within 4 Monte Carlo standard
    errors (from the chains' ESS), each std within 10 %."""
    tt = t_toy(n_importance=S, device="cpu")
    step = make_pm_mh(tt)
    st = t_init(0, tt, 64, jitter_scale=1.0)
    st, _, _ = t_run_chains(step, st, {"step_size": 0.6}, 500)
    _, recs, infos = t_run_chains(step, st, {"step_size": 0.6}, 1500)
    theta = recs["theta"].numpy().astype(np.float64)
    flat = theta.reshape(-1, 2)
    ess = effective_sample_size(theta)
    mean, cov = tt.posterior_mean.numpy(), tt.posterior_cov.numpy()
    sd = np.sqrt(np.diag(cov))
    assert (ess > 200).all()
    assert (np.abs(flat.mean(0) - mean) < 4 * sd / np.sqrt(ess)).all()
    np.testing.assert_allclose(flat.std(0), sd, rtol=0.1)
    assert 0.1 < float(infos["accept"].mean()) < 0.9


@pytest.mark.parametrize("sampler,cached", [("pm_mh", False),
                                            ("aux_mh", False),
                                            ("aux_slice", True)])
def test_cache_gate_follows_the_sampler_family(sampler, cached):
    """The carried factor is for the aux_slice family only, as the
    reference's run.py gates it; PM-MH and aux_mh states carry no chol_r,
    and their params have the reference's groups."""
    out = {}
    rc = trun.main(["--device", "cpu", "--sampler", sampler, "--chains", "2",
                    "--subsample", "60", "--n-importance", "8", "--steps",
                    "4", "--window-steps", "2", "--warmup-windows", "1",
                    "--max-step-out", "0"], result=out)
    assert rc == 0
    assert ("target_cache" in out["states"].extras) == cached
    groups = {"pm_mh": {"step_size"}, "aux_mh": {"mh_theta"},
              "aux_slice": {"ess_u", "slice_theta"}}[sampler]
    assert set(out["params"]) == groups
    assert np.isfinite(out["theta"]).all()


SHARDED_DECISIONS = {"pm_mh": ("accept",), "aux_mh": ("mh_theta/accept",),
                     "joint_mh": ("joint_mh/accept",),
                     "aux_slice_joint": ("ess_u/moved", "slice_theta/n_probe",
                                         "joint_slice/moved",
                                         "joint_slice/n_probe")}


@pytest.mark.parametrize("sampler", sorted(SHARDED_DECISIONS))
def test_particle_sharded_run_matches_the_unsharded_run(sampler):
    """``--sharded true --particle-shards 2`` on two gloo ranks: the ranks
    hold 8 of every chain's 16 rows, draw the rows the unsharded state
    draws there (blocked per-chain keys; the joint kernels' v too) and fold the
    estimate with a collective; both ranks end bitwise equal, and the run
    follows the unsharded run's chains to rounding (the collective folds in
    another order than the estimator), with the same decisions (window means
    of the accepts, moves and probe counts)."""
    from auxpm_tpu_torch.parallel import rank_jobs
    from auxpm_tpu_torch.parallel.launch import spawn

    argv = ["--device", "cpu", "--sampler", sampler, "--chains", "3",
            "--subsample", "60", "--n-importance", "16", "--warmup-windows",
            "1", "--window-steps", "3", "--steps", "6", "--step-size", "0.3",
            "--max-step-out", "0"]
    ranks = spawn(rank_jobs.cli, 2, ["--sharded", "true", "--particle-shards",
                                     "2", *argv], timeout_s=180)
    whole = {}
    assert trun.main(argv, result=whole) == 0
    for r in ranks:
        assert r["u_shape"] == (3, 8, 128)
        assert (r["widths"] is None) == (sampler != "aux_slice_joint")
        np.testing.assert_array_equal(r["theta"], ranks[0]["theta"])
        np.testing.assert_array_equal(r["log_lik_hat"],
                                      ranks[0]["log_lik_hat"])
    for key in SHARDED_DECISIONS[sampler]:
        assert [w[key] for w in ranks[0]["windows"]] == [
            w[key] for w in whole["windows"]], key
    np.testing.assert_allclose(ranks[0]["recorded_theta"], whole["theta"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(ranks[0]["log_lik_hat"],
                               whole["states"].log_lik_hat.numpy(), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("sampler", ["joint_mh", "aux_slice_joint"])
def test_keyed_step_job_on_two_ranks_matches_one_process(sampler):
    """``rank_jobs`` job ``keyed_step`` (what ``chip_smoke.py``'s
    ``main_path_joint_sharded`` runs on the card): one step from a fixed
    state on two particle-sharded gloo ranks, each rank's rows drawn from
    the chains' keys, against the same step in one process: both ranks
    bitwise equal, every per-chain count equal and theta / log L-hat within
    1e-4 (the bar of the sharded path parity), with stepping out on."""
    from auxpm_tpu_torch.parallel import rank_jobs
    from auxpm_tpu_torch.parallel.launch import spawn
    from auxpm_tpu_torch.utils.config import PRESETS, initial_params

    x, y = jload("pima", subsample=60)
    tt = tmake(x, y, n_importance=S, device="cpu")
    st = t_init(3, tt, CHAINS, jitter_scale=0.3)
    cfg = PRESETS["pima_aux_slice"].replace(sampler=sampler, max_step_out=8)
    par = initial_params(cfg, tt)
    par_np = {g: {k: (v.numpy() if torch.is_tensor(v) else v)
                  for k, v in sub.items()} for g, sub in par.items()}
    state_np = {"theta": st.theta.numpy(), "u": st.u.numpy(),
                "log_lik_hat": st.log_lik_hat.numpy(), "key": st.key.numpy()}
    ranks = [r[0] for r in spawn(
        rank_jobs.run_all, 2,
        [("keyed_step", ("gp", x, y, {"n_importance": S}), sampler,
          state_np, par_np)], 2, "cpu", timeout_s=180)]
    whole, info = SAMPLERS[sampler](tt)(st, par)
    for r in ranks:
        np.testing.assert_array_equal(r["theta"], ranks[0]["theta"])
        np.testing.assert_array_equal(r["log_lik_hat"],
                                      ranks[0]["log_lik_hat"])
        assert r["counts"]["collectives"] > 0
    assert set(ranks[0]["info"]) == set(info)
    for k, v in info.items():
        np.testing.assert_array_equal(ranks[0]["info"][k], v.numpy(), k)
    np.testing.assert_allclose(ranks[0]["theta"], whole.theta.numpy(),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(ranks[0]["log_lik_hat"],
                               whole.log_lik_hat.numpy(), rtol=0, atol=1e-4)


def test_joint_mh_logs_its_accept_margin():
    x, y = jload("pima", subsample=60)
    tt = tmake(x, y, n_importance=S, device="cpu")
    st = t_init(4, tt, CHAINS, jitter_scale=0.3)
    step = SAMPLERS["joint_mh"](tt).stages["joint_mh"]
    rows, _ = step.draw(st)
    log = []
    _, info = step.apply(st, rows, {"step_size": 0.3, "probe_log": log})
    (counted, margin), = log
    assert bool(counted.all())
    np.testing.assert_array_equal((margin > 0).numpy(),
                                  info["accept"].numpy() > 0)
