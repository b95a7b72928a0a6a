"""PyTorch port vs the JAX package: HMC, NUTS, their composites and dual
averaging (CPU).

Parity: each step test runs the reference's kernel one step per call,
recomputes with ``jax.random`` the draws every chain consumed
(``samplers/hmc.make_hmc``: ``split(key, 4)``, the trajectory length by
``randint``, the momentum by ``normal``, the accept uniform;
``samplers/nuts.make_nuts``: ``split(key, 3)``, the momentum, then per depth
``split(kkey, 4)``: the direction by ``bernoulli``, the biased take's
uniform, and per leaf ``uniform(fold_in(ks, s))``), converts the JAX state
with ``auxpm_tpu_torch.convert`` and feeds state and draws to the port's
deterministic ``apply`` (teacher-forced: each port step starts from the JAX
state of that step).  Targets: the reference's exact MVN (d=3) and the GP
target on Pima subsampled to 32 points (S=8, padded to 128, jitter 1e-3).

Tolerances: decisions EQUAL (``accept``, ``diverged``, ``depth``,
``n_leapfrog``).  theta 1e-5 on the MVN and 1e-4 on the GP target (a
trajectory of up to 16 leapfrog steps through gradients that differ by f32
rounding); log L̂ 1e-5 / 2e-4 (the GP estimate is a sum of ~n O(1) terms
taken in another order); ``accept_prob`` 1e-5 / 1e-3.

Then the reference's own checks, run on the port: MVN moments of HMC and
NUTS, the dual-averaging warm-up from ``step_size=5.0`` on the 25:1 MVN
(``tests/test_hmc_nuts.py:116-148``, the reference's bars) and on a small
GP target (``:151-173``), the dual-averaging pieces against the reference
on the same numbers, the theta-only factories, and a bitwise resume of
``aux_hmc`` through ``utils/checkpoint``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auxpm_tpu.core.state import init_chain_states as j_init
from auxpm_tpu.models.datasets import load as jload
from auxpm_tpu.models.exact import make_mvn_target as j_mvn
from auxpm_tpu.models.gp_classification import make_gp_classification as jmake
from auxpm_tpu.samplers import adaptation as j_adapt
from auxpm_tpu.samplers.chain import run_chains as j_run_chains
from auxpm_tpu.samplers.hmc import make_hmc as j_hmc
from auxpm_tpu.samplers.nuts import make_nuts as j_nuts
from auxpm_tpu_torch import convert
from auxpm_tpu_torch.core.state import init_chain_states as t_init
from auxpm_tpu_torch.models.exact import make_mvn_target as t_mvn
from auxpm_tpu_torch.models.gp_classification import (
    make_gp_classification as tmake,
)
from auxpm_tpu_torch.samplers import adaptation as t_adapt
from auxpm_tpu_torch.samplers.chain import run_chains
from auxpm_tpu_torch.samplers.composite import SAMPLERS, THETA_ONLY
from auxpm_tpu_torch.samplers.hmc import make_hmc
from auxpm_tpu_torch.samplers.nuts import make_nuts
from auxpm_tpu_torch.utils.diagnostics import (
    effective_sample_size,
    potential_scale_reduction,
)

MEAN = np.array([1.0, -2.0, 0.5])
COV = np.array([[1.0, 0.6, 0.2], [0.6, 1.5, -0.3], [0.2, -0.3, 0.8]])
CHAINS, STEPS, MAX_DEPTH, N_LEAPFROG = 6, 3, 4, 6
TOL = {"mvn": {"theta": 1e-5, "ll": 1e-5, "accept_prob": 1e-5},
       "gp": {"theta": 1e-4, "ll": 2e-4, "accept_prob": 1e-3}}
PARAMS = {"mvn": {"hmc": {"step_size": 0.4, "n_leapfrog": N_LEAPFROG},
                  "nuts": {"step_size": 0.5}},
          "gp": {"hmc": {"step_size": 0.15, "n_leapfrog": N_LEAPFROG},
                 "nuts": {"step_size": 0.15}}}
DECISIONS = ("accept", "diverged", "depth", "n_leapfrog")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its tests run many small ops,
    and the suite runs several workers on the same cores, where
    multi-threaded small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def targets():
    x, y = jload("pima", subsample=32)
    return {
        "mvn": (j_mvn(MEAN, COV), t_mvn(MEAN, COV, device="cpu")),
        "gp": (jmake(x, y, n_importance=8, jitter=1e-3),
               tmake(x, y, n_importance=8, jitter=1e-3, device="cpu")),
    }


def _to_port(state_j):
    return convert.chain_states_from_numpy(
        {"theta": np.asarray(state_j.theta), "u": np.asarray(state_j.u),
         "log_lik_hat": np.asarray(state_j.log_lik_hat)}, device="cpu")


def _hmc_rows(key, d):
    key, k_mom, k_acc, k_traj = jax.random.split(key, 4)
    return {"n_steps": jax.random.randint(k_traj, (), 1, N_LEAPFROG + 1),
            "r0": jax.random.normal(k_mom, (d,), jnp.float32),
            "log_u": jnp.log(jax.random.uniform(k_acc, (), jnp.float32))}


def _nuts_rows(key, d):
    key, k_mom, k_loop = jax.random.split(key, 3)
    rows = {"direction": [], "u_biased": [], "leaf_keys": []}
    for _ in range(MAX_DEPTH):
        kd, kb, ks, k_loop = jax.random.split(k_loop, 4)
        rows["direction"].append(
            jnp.where(jax.random.bernoulli(kd), 1.0, -1.0))
        rows["u_biased"].append(jax.random.uniform(kb, (), jnp.float32))
        # the subtree's key: leaf s takes uniform(fold_in(ks, s))
        rows["leaf_keys"].append(jax.random.key_data(ks))
    return {"r0": jax.random.normal(k_mom, (d,), jnp.float32),
            **{k: jnp.stack(v) for k, v in rows.items()}}


KERNELS = {
    "hmc": (j_hmc, make_hmc, _hmc_rows),
    "nuts": (lambda t: j_nuts(t, max_depth=MAX_DEPTH),
             lambda t: make_nuts(t, max_depth=MAX_DEPTH), _nuts_rows),
}


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("name", ["mvn", "gp"])
def test_apply_on_the_reference_draws(targets, kernel, name):
    tj, tt = targets[name]
    j_make, t_make, rows_one = KERNELS[kernel]
    params = PARAMS[name][kernel]
    step_j, step_t = j_make(tj), t_make(tt)
    rows_fn = jax.jit(jax.vmap(lambda k: rows_one(k, tj.d)))
    state = j_init(jax.random.key(7), tj, CHAINS, jitter_scale=0.5)
    tol = TOL[name]
    seen = {}
    for _ in range(STEPS):
        nxt, _, info = j_run_chains(step_j, state, params, 1)
        rows = {k: torch.from_numpy(np.array(v, dtype=np.int64
                                             if k == "leaf_keys" else None))
                for k, v in rows_fn(state.key).items()}
        out, info_t = step_t.apply(_to_port(state), rows, params)
        assert set(info_t) == set(info)
        for key in info_t:
            want = np.asarray(info[key])[:, 0]
            if key in DECISIONS:
                np.testing.assert_array_equal(info_t[key].numpy(), want,
                                              err_msg=key)
                seen.setdefault(key, []).append(want)
            else:
                np.testing.assert_allclose(info_t[key].numpy(), want, rtol=0,
                                           atol=tol["accept_prob"],
                                           err_msg=key)
        np.testing.assert_allclose(out.theta.numpy(), np.asarray(nxt.theta),
                                   rtol=0, atol=tol["theta"])
        np.testing.assert_allclose(out.log_lik_hat.numpy(),
                                   np.asarray(nxt.log_lik_hat), rtol=0,
                                   atol=tol["ll"])
        assert torch.equal(out.u, _to_port(state).u)   # u held fixed
        state = nxt
    if kernel == "hmc":   # some chains accepted, and not by rule
        assert 0 < np.mean(seen["accept"]) <= 1
    else:                 # the trees had more than one depth
        assert len(np.unique(np.concatenate(seen["depth"]))) > 1


def test_draw_then_apply_and_the_draw_tables(targets):
    _, tt = targets["gp"]
    for kernel, (_, t_make, _) in sorted(KERNELS.items()):
        params = PARAMS["gp"][kernel]
        a = t_init(3, tt, 3, jitter_scale=0.3)
        b = t_init(3, tt, 3, jitter_scale=0.3)
        step = t_make(tt)
        out_a, _ = step(a, params)
        rows, key = step.draw(b, params)
        out_b, _ = step.apply(b, rows, params)
        assert torch.equal(out_a.theta, out_b.theta), kernel
        assert torch.equal(out_a.key, key), kernel
        assert rows["r0"].shape == (3, 2)
    rows, _ = KERNELS["nuts"][1](tt).draw(b)
    assert rows["leaf_keys"].shape == (3, MAX_DEPTH, 2)
    assert set(rows["direction"].unique().tolist()) <= {-1.0, 1.0}
    counts = make_hmc(tt).draw(b, {"n_leapfrog": 3})[0]["n_steps"]
    assert counts.min() >= 1 and counts.max() <= 3


# ------------------------------------------------- the reference's own checks


def _moment_check(theta, mean, cov, label):
    flat = theta.reshape(-1, theta.shape[-1])
    ess = effective_sample_size(theta)
    se = np.sqrt(np.diag(cov) / np.maximum(ess, 1.0))
    assert np.all(np.abs(flat.mean(0) - mean) < 5 * se), (
        label, flat.mean(0), mean, se, ess)
    assert np.all(np.abs(flat.var(0) - np.diag(cov)) < 0.35 * np.diag(cov)), \
        (label, flat.var(0), np.diag(cov))
    assert np.all(potential_scale_reduction(theta) < 1.15)


@pytest.mark.parametrize("kernel", ["hmc", "nuts"])
def test_exact_mvn_moments(targets, kernel):
    _, tt = targets["mvn"]
    states = t_init(0, tt, 16, jitter_scale=1.0)
    if kernel == "hmc":
        step, params = make_hmc(tt), {"step_size": 0.4, "n_leapfrog": 8}
    else:
        step, params = make_nuts(tt, max_depth=6), {"step_size": 0.5}
    _, recs, infos = run_chains(step, states, params, 400)
    if kernel == "hmc":
        assert float(infos["accept"].mean()) > 0.6
    else:
        assert float(infos["diverged"].mean()) < 0.01
        assert 1.0 < float(infos["depth"].mean()) < 6.0
    _moment_check(recs["theta"][:, 100:].double().numpy(), MEAN, COV, kernel)


def test_hmc_energy_conservation(targets):
    _, tt = targets["mvn"]
    _, _, infos = run_chains(make_hmc(tt), t_init(1, tt, 8),
                             {"step_size": 0.01, "n_leapfrog": 4}, 50)
    assert float(infos["accept_prob"].mean()) > 0.999


def _warmup(step, states, params, windows, steps):
    def run_fn(t, s, p, n):
        return run_chains(t, s, p, n)

    return t_adapt.warmup(run_fn, states, params, windows, steps, step=step)


def test_dual_averaging_warmup_mvn():
    """The reference's bars (``tests/test_hmc_nuts.py:116-148``): from a
    hopeless step size the learned mass is within 3x of the posterior
    variances, the frozen kernel accepts > 0.6 with no divergence."""
    cov = np.diag([25.0, 1.0, 0.04])
    tt = t_mvn(np.zeros(3), cov, device="cpu")
    states = t_init(2, tt, 64, jitter_scale=1.0)
    step = THETA_ONLY["nuts"](tt)
    states, params, _ = _warmup(step, states, {"nuts": {"step_size": 5.0}},
                                4, 60)
    assert not any(k.startswith("da_") for k in states.extras)
    ratio = params["nuts"]["inv_mass"].double().numpy() / np.diag(cov)
    assert np.all(ratio > 0.33) and np.all(ratio < 3.0), ratio
    assert 0.05 < params["nuts"]["step_size"] < 5.0
    _, recs, infos = run_chains(step, states, params, 400)
    assert float(infos["nuts/accept_prob"].mean()) > 0.6
    assert float(infos["nuts/diverged"].sum()) == 0.0
    _moment_check(recs["theta"][:, 100:].double().numpy(), np.zeros(3), cov,
                  "da_nuts")


def test_dual_averaging_warmup_gp_nuts():
    """The reference's GP check (``:151-173``): NUTS on a small GP target
    self-tunes from step_size=1.0 to a mean accept statistic >= 0.6 with
    zero divergences."""
    x, y = jload("pima", subsample=48)
    tt = tmake(x, y, n_importance=8, pad_to_tiles=False, name="gp_da",
               device="cpu")
    states = t_init(3, tt, 16, jitter_scale=0.3)
    step = SAMPLERS["aux_nuts"](tt)
    states, params, _ = _warmup(step, states, {"nuts": {"step_size": 1.0}},
                                3, 25)
    _, _, infos = run_chains(step, states, params, 50)
    assert float(infos["nuts/accept_prob"].mean()) >= 0.6, params["nuts"]
    assert float(infos["nuts/diverged"].sum()) == 0.0


def test_dual_averaging_pieces_match_jax():
    """init / one wrapped update / restart / finalize and the regularised
    mass against the reference on the same numbers."""
    rng = np.random.default_rng(8)
    acc = rng.uniform(size=(5,)).astype(np.float32)
    theta_rec = rng.standard_normal((5, 7, 3)).astype(np.float32) * 2.0

    class _Stub:   # a transition that reports a fixed accept statistic
        stage_names = ("nuts",)

    def t_transition(state, params):
        return state, {"nuts/accept_prob": torch.from_numpy(acc)}

    def j_transition(state, params):
        return state, {"nuts/accept_prob": jnp.asarray(acc)}

    for fn in (t_transition, j_transition):
        fn.stage_names = _Stub.stage_names
    tt = t_mvn(np.zeros(3), np.eye(3), device="cpu")
    tj = j_mvn(np.zeros(3), np.eye(3))
    params = {"nuts": {"step_size": 0.3}}
    st_t = t_adapt.init_dual_averaging(t_init(0, tt, 5), params, ("nuts",))
    st_j = j_adapt.init_dual_averaging(
        j_init(jax.random.key(0), tj, 5), params, ("nuts",))
    for _ in range(3):
        st_t, _ = t_adapt.wrap_dual_averaging(t_transition, ("nuts",))(
            st_t, params)
        st_j, _ = j_adapt.wrap_dual_averaging(j_transition, ("nuts",))(
            st_j, params)
    for st_t, st_j in ((st_t, st_j),
                       (t_adapt.restart_dual_averaging(st_t, ("nuts",)),
                        j_adapt.restart_dual_averaging(st_j, ("nuts",)))):
        for f in ("log_eps", "log_eps_bar", "h_bar", "t", "mu"):
            key = f"da_nuts_{f}"
            np.testing.assert_allclose(st_t.extras[key].numpy(),
                                       np.asarray(st_j.extras[key]),
                                       rtol=1e-6, atol=1e-6, err_msg=key)
    _, p_t = t_adapt.finalize_dual_averaging(st_t, params, ("nuts",))
    _, p_j = j_adapt.finalize_dual_averaging(st_j, params, ("nuts",))
    assert p_t["nuts"]["step_size"] == pytest.approx(p_j["nuts"]["step_size"],
                                                     rel=1e-6)
    np.testing.assert_allclose(
        t_adapt.regularized_inv_mass(torch.from_numpy(theta_rec)).numpy(),
        np.asarray(j_adapt.regularized_inv_mass(theta_rec), np.float32),
        rtol=1e-6)


@pytest.mark.parametrize("kind", ["hmc", "nuts"])
def test_theta_only_gradient_kernels(targets, kind):
    _, tt = targets["gp"]
    step = THETA_ONLY[kind](tt)
    assert step.stage_names == (kind,)
    st = t_init(2, tt, 3, jitter_scale=0.3)
    out, info = step(st, {kind: PARAMS["gp"][kind]})
    assert torch.equal(out.u, st.u)   # no u-update
    assert f"{kind}/accept_prob" in info
    torch.testing.assert_close(
        out.log_lik_hat, tt.log_lik_est(out.theta, out.u), rtol=0, atol=1e-4)


def test_aux_hmc_resumes_bitwise(tmp_path, targets):
    """K steps, a checkpoint saved and loaded into a fresh state, K more:
    bitwise the 2K steps without a break (the dual averaging's frozen step
    and mass cross as params)."""
    from auxpm_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    _, tt = targets["gp"]
    step = SAMPLERS["aux_hmc"](tt)
    states0 = t_init(5, tt, 4, jitter_scale=0.3)
    states0, params, _ = _warmup(step, states0, {"hmc": {"step_size": 0.2}},
                                 1, 4)
    assert isinstance(params["hmc"]["step_size"], float)
    k = 3

    def fresh():
        return t_init(9, tt, 4, jitter_scale=0.3)

    whole, _, _ = run_chains(step, fresh(), params, 2 * k)
    half, _, _ = run_chains(step, fresh(), params, k)
    save_checkpoint(str(tmp_path), half, step=k, config={"t": 1},
                    params=params)
    loaded, at, params_l = load_checkpoint(str(tmp_path), fresh(),
                                           config={"t": 1})
    assert at == k
    torch.testing.assert_close(params_l["hmc"]["inv_mass"],
                               params["hmc"]["inv_mass"], rtol=0, atol=0)
    rest, _, _ = run_chains(step, loaded, params_l, k)
    assert torch.equal(rest.theta, whole.theta)
    assert torch.equal(rest.u, whole.u)
    assert torch.equal(rest.log_lik_hat, whole.log_lik_hat)
    assert not torch.equal(whole.theta, fresh().theta)


@pytest.mark.parametrize("sampler", ["aux_hmc", "aux_nuts"])
def test_cli_and_initial_params(targets, sampler):
    """``initial_params`` as the reference's; the CLI warms up (dual
    averaging, mass) and samples on the CPU; the frozen step size is a
    number and the mass a ``(d,)`` tensor."""
    from auxpm_tpu.utils import config as j_config
    from auxpm_tpu_torch import run as trun
    from auxpm_tpu_torch.utils import config as t_config

    tj, tt = targets["gp"]
    over = {"sampler": sampler, "nuts_step_size": 0.25}
    want = j_config.initial_params(j_config.RunConfig(**over), tj)
    assert t_config.initial_params(t_config.RunConfig(**over), tt) == want
    out = {}
    rc = trun.main(["--device", "cpu", "--sampler", sampler, "--chains", "3",
                    "--subsample", "40", "--n-importance", "8",
                    "--warmup-windows", "2", "--window-steps", "3",
                    "--steps", "3"], result=out)
    assert rc == 0 and np.isfinite(out["theta"]).all()
    group = sampler[4:]
    assert isinstance(out["params"][group]["step_size"], float)
    assert out["params"][group]["inv_mass"].shape == (2,)
    assert not out["states"].extras   # no carried factor, no DA state
    assert len(out["history"]) == 2
    assert f"{group}/accept_prob" in out["windows"][0]
