"""PyTorch port vs the JAX package: the random-direction slice, the joint
(theta, u) slice and joint MH, their composites ``aux_slice_rd``,
``aux_slice_pcrd`` and ``aux_slice_joint``, the theta-only factories, their
adaptation groups, ``initial_params`` and the CLI (CPU).

Each step test runs the JAX transition one step per call, recomputes with
``jax.random`` the rows every step consumed (the key discipline of
``samplers/slice_theta.make_slice_theta_rd``: ``split(key, 3)``, direction
then ``_slice_1d``'s draws; ``samplers/joint_slice.make_joint_slice``:
``split(key, 4)``, e, v through ``make_u_normal``, then the slice draws;
``make_joint_mh``: ``split(key, 4)``, xi, v, the accept uniform), converts
the JAX state with ``auxpm_tpu_torch.convert`` and feeds state and rows to
the port's deterministic ``apply`` (teacher-forced: each port step starts
from the JAX state of that step).

Targets: the Gaussian toy (S=16, n=2) and the GP target on Pima subsampled
to 128 points (S=16, n=128, the carried factor on so that its refresh is
held too, jitter 1e-3: a random direction moves log_ell and log_sigma
together, and at the default 1e-5 two f32 factorisations of one near-singular
Gram move log L̂ by up to ~4e-4, as ``tests/test_torch_stepout.py`` notes
for its fixtures).  The composites run three steps on the GP target with
``n_ess=4``, ``n_sigma_extra=1``, ``max_step_out=0`` and
``max_shrink_chol=3``; there the reference's log_sigma slice takes its
per-probe loop and the port its sigma sweep, as in
``tests/test_torch_slice.py``.

Tolerances: decisions EQUAL (``n_probe``, ``moved``, ``accept``, the ESS
counts).  theta 1e-5 (theta + t e with the same t up to f32 rounding of the
bracket).  u 1e-5 (one f32 rotation, or the ESS sweep's).  log L̂: the toy
2e-5, the GP target 2e-4 (each probe factors its own Gram by another routine
on each side and sums ~n O(1) terms in another order).  The carried factor
5e-4 (two f32 factorisations of one Gram).
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
from auxpm_tpu.samplers import composite as j_composite
from auxpm_tpu.samplers.adaptation import adapt_params as j_adapt
from auxpm_tpu.samplers.chain import run_chains as j_run_chains
from auxpm_tpu.samplers.joint_slice import make_joint_mh as j_joint_mh
from auxpm_tpu.samplers.joint_slice import make_joint_slice as j_joint_slice
from auxpm_tpu.samplers.slice_theta import make_slice_theta_rd as j_rd
from auxpm_tpu.utils import config as j_config
from auxpm_tpu_torch import convert
from auxpm_tpu_torch import run as trun
from auxpm_tpu_torch.core.state import init_chain_states as t_init
from auxpm_tpu_torch.models.gaussian_toy import make_gaussian_toy as t_toy
from auxpm_tpu_torch.models.gp_classification import (
    make_gp_classification as tmake,
)
from auxpm_tpu_torch.samplers.adaptation import adapt_params as t_adapt
from auxpm_tpu_torch.samplers.composite import SAMPLERS, THETA_ONLY
from auxpm_tpu_torch.samplers.joint_slice import make_joint_mh, make_joint_slice
from auxpm_tpu_torch.samplers.slice_theta import make_slice_theta_rd
from auxpm_tpu_torch.utils import config as t_config
from tests.test_torch_slice import N_ESS, N_SIGMA_EXTRA, _ess_rows, _slice_rows

S, CHAINS, STEPS, JITTER = 16, 4, 3, 1e-3
LL_TOL = {"toy": 2e-5, "gp": 2e-4}
NEW_SAMPLERS = ("aux_slice_rd", "aux_slice_pcrd", "aux_slice_joint",
                "joint_slice", "joint_mh")


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


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return _t(np.asarray(tree))


@pytest.fixture(scope="module")
def targets():
    x, y = jload("pima", subsample=128)
    return {
        "toy": (j_toy(n_importance=S), t_toy(n_importance=S, device="cpu")),
        "gp": (jmake(x, y, n_importance=S, jitter=JITTER),
               tmake(x, y, n_importance=S, jitter=JITTER, device="cpu")),
    }


# ------------------------------------------------- the reference's random rows


def _normal_u(key, tj):
    if tj.n_weight_blocks > 1:
        return blocked_normal(key, tj.u_shape, jnp.float32, tj.n_weight_blocks,
                              tj.u_shape[0])
    return jax.random.normal(key, tj.u_shape, jnp.float32)


def _direction(key, d):
    e = jax.random.normal(key, (d,), jnp.float32)
    return e / jnp.linalg.norm(e)


def _rep(key):
    """``_slice_1d``'s row: [log U, U1, 32 shrink uniforms]."""
    k_h, k_init, k_loop = jax.random.split(key, 3)
    shrink = jax.vmap(lambda i: jax.random.uniform(
        jax.random.fold_in(k_loop, i), (), jnp.float32))(jnp.arange(32))
    return jnp.concatenate([
        jnp.stack([jnp.log(jax.random.uniform(k_h, (), jnp.float32)),
                   jax.random.uniform(k_init, (), jnp.float32)]), shrink])


def _rd_rows(key, tj):
    key, k_dir, k_slice = jax.random.split(key, 3)
    return key, {"direction": _direction(k_dir, tj.d), "rep": _rep(k_slice)}


def _joint_slice_rows(key, tj):
    key, k_dir, k_v, k_slice = jax.random.split(key, 4)
    return key, {"direction": _direction(k_dir, tj.d),
                 "v": _normal_u(k_v, tj), "rep": _rep(k_slice)}


def _joint_mh_rows(key, tj):
    key, k_xi, k_v, k_acc = jax.random.split(key, 4)
    return key, {"xi": jax.random.normal(k_xi, (tj.d,), jnp.float32),
                 "v": _normal_u(k_v, tj),
                 "log_unif": jnp.log(jax.random.uniform(k_acc, (),
                                                        jnp.float32))}


KERNELS = {
    # name -> (JAX maker, port maker, rows, params)
    "slice_theta_rd": (j_rd, make_slice_theta_rd, _rd_rows,
                       {"widths": 1.2, "max_step_out": 4}),
    "joint_slice": (j_joint_slice, make_joint_slice, _joint_slice_rows,
                    {"width": 1.2, "angle_scale": 1.1, "max_step_out": 4}),
    "joint_mh": (j_joint_mh, make_joint_mh, _joint_mh_rows,
                 {"step_size": 0.4, "rho": 0.5}),
}


def _composite_rows(name, tj):
    """Rows of one ``aux_slice_pcrd`` / ``aux_slice_joint`` step, one chain:
    the ESS stage's, the per-coordinate slice's, then the appended stage's
    from the key the slice stage leaves (``split(key, d + 1)[0]``)."""
    extra = _rd_rows if name == "aux_slice_pcrd" else _joint_slice_rows

    def rows(key, ll):
        key, scal, v = _ess_rows(key, ll, tj.u_shape)
        rep_ell, rep_sigma = _slice_rows(key)
        _, last = extra(jax.random.split(key, tj.d + 1)[0], tj)
        return {"ess_u": {"scal": scal, "v": v},
                "slice_theta": (rep_ell, rep_sigma), "last": last}

    return jax.jit(jax.vmap(rows))


def _to_port(state_j):
    cache = state_j.extras.get("target_cache")
    return convert.chain_states_from_numpy(
        {"theta": np.asarray(state_j.theta), "u": np.asarray(state_j.u),
         "log_lik_hat": np.asarray(state_j.log_lik_hat),
         "chol_r": None if cache is None else np.asarray(cache["chol_r"])},
        device="cpu")


def _run_reference(step_j, state, params, steps, rows_fn):
    """JAX states and infos per step, and the rows each step consumed."""
    states, infos = [state], []
    for _ in range(steps):   # one jitted one-step program
        s, _recs, info = j_run_chains(step_j, states[-1], params, 1)
        states.append(s)
        infos.append({k: np.asarray(v)[:, 0] for k, v in info.items()})
    rows = [rows_fn(s.key, s.log_lik_hat) for s in states[:-1]]
    return states, infos, rows


def _assert_state(out, want, ll_tol):
    np.testing.assert_allclose(out.theta.numpy(), np.asarray(want.theta),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.u.numpy(), np.asarray(want.u), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(out.log_lik_hat.numpy(),
                               np.asarray(want.log_lik_hat), rtol=0,
                               atol=ll_tol)
    cache = want.extras.get("target_cache")
    assert ("target_cache" in out.extras) == (cache is not None)
    if cache is not None:
        np.testing.assert_allclose(out.extras["target_cache"]["chol_r"].numpy(),
                                   np.asarray(cache["chol_r"]), rtol=0,
                                   atol=5e-4)


# ------------------------------------------------------------ single kernels


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("name", ["toy", "gp"])
def test_kernel_step_matches_jax(targets, kernel, name):
    """Three teacher-forced steps: decisions equal, values within the
    module's bars; over the run some chains moved and some did not."""
    tj, tt = targets[name]
    j_make, t_make, rows_one, params = KERNELS[kernel]
    states, infos, rows = _run_reference(
        j_make(tj), j_init(jax.random.key(6), tj, CHAINS, jitter_scale=0.3,
                           with_cache=name == "gp"),
        params, STEPS, jax.jit(jax.vmap(lambda k, ll: rows_one(k, tj)[1])))
    step_t = t_make(tt)
    for k in range(STEPS):
        out, info = step_t.apply(_to_port(states[k]), _np_tree(rows[k]),
                                 params)
        assert set(info) == set(infos[k])
        for key in info:
            np.testing.assert_array_equal(info[key].numpy(), infos[k][key],
                                          err_msg=key)
        _assert_state(out, states[k + 1], LL_TOL[name])
    key = "accept" if kernel == "joint_mh" else "moved"
    share = np.stack([i[key] for i in infos]).mean()
    assert 0 < share <= 1
    if kernel != "joint_mh":
        assert np.stack([i["n_probe"] for i in infos]).min() >= 1


def test_kernel_draw_shapes_and_step_is_draw_then_apply(targets):
    _, tt = targets["gp"]
    for kernel, (_, t_make, _, params) in sorted(KERNELS.items()):
        a = t_init(3, tt, 3, jitter_scale=0.3, with_cache=True)
        b = t_init(3, tt, 3, jitter_scale=0.3, with_cache=True)
        step = t_make(tt)
        out_a, info_a = step(a, params)
        rows, key = step.draw(b)
        out_b, info_b = step.apply(b, rows, params)
        assert torch.equal(out_a.key, key), kernel
        assert torch.equal(out_a.theta, out_b.theta), kernel
        assert torch.equal(out_a.u, out_b.u), kernel
        assert info_a.keys() == info_b.keys()
        if "direction" in rows:
            assert rows["direction"].shape == (3, 2)
            torch.testing.assert_close(
                torch.linalg.vector_norm(rows["direction"], dim=-1),
                torch.ones(3))
            assert rows["rep"].shape == (3, 34)
        if "v" in rows:
            assert rows["v"].shape == (3, S, 128)
        # the carried factor is the factor of the new theta
        assert torch.equal(out_b.extras["target_cache"]["chol_r"],
                           tt.cache_init(out_b.theta)["chol_r"])
    with pytest.raises(ValueError, match="shrink uniforms"):
        make_slice_theta_rd(tt)(a, {"max_shrink": 64})
    with pytest.raises(TypeError, match="Mesh"):
        make_joint_slice(tt, particle_axis="particles")


# ---------------------------------------------------------------- composites


COMPOSITE_PARAMS = {
    "ess_u": {},
    "slice_theta": {"widths": [1.0, 0.8], "max_step_out": 0,
                    "max_shrink_chol": 3},
    "slice_theta_rd": {"widths": [1.0, 0.8], "max_step_out": 0},
    "joint_slice": {"width": 0.9, "max_step_out": 0},
}


@pytest.mark.parametrize("name", ["aux_slice_pcrd", "aux_slice_joint"])
def test_composite_teacher_forced(targets, name):
    """Three steps of the composite as a whole on the GP target."""
    tj, tt = targets["gp"]
    last = "slice_theta_rd" if name == "aux_slice_pcrd" else "joint_slice"
    groups = ("ess_u", "slice_theta", last)
    params = {g: COMPOSITE_PARAMS[g] for g in groups}
    step_j = getattr(j_composite, f"make_{name}")(
        tj, n_ess=N_ESS, n_sigma_extra=N_SIGMA_EXTRA)
    params_j = {g: {k: jnp.asarray(v) if isinstance(v, list) else v
                    for k, v in sub.items()} for g, sub in params.items()}
    states, infos, rows = _run_reference(
        step_j, j_init(jax.random.key(3), tj, CHAINS, jitter_scale=0.3,
                       with_cache=True), params_j, STEPS,
        _composite_rows(name, tj))
    params_t = convert.params_from_numpy(
        {g: {k: np.asarray(v) for k, v in sub.items()}
         for g, sub in params.items()}, device="cpu")
    step_t = SAMPLERS[name](tt, n_ess=N_ESS, n_sigma_extra=N_SIGMA_EXTRA)
    assert step_t.stage_names == groups
    for k in range(STEPS):
        state, info = _to_port(states[k]), {}
        r = rows[k]
        for stage, stage_rows in (("ess_u", _np_tree(r["ess_u"])),
                                  ("slice_theta", tuple(
                                      _t(a) for a in r["slice_theta"])),
                                  (last, _np_tree(r["last"]))):
            state, i = step_t.stages[stage].apply(state, stage_rows,
                                                  params_t[stage])
            info.update({f"{stage}/{k_}": v for k_, v in i.items()})
        assert set(info) == set(infos[k])
        for key in info:
            np.testing.assert_array_equal(info[key].numpy(), infos[k][key],
                                          err_msg=key)
        _assert_state(state, states[k + 1], LL_TOL["gp"])
    assert np.stack([i[f"{last}/moved"] for i in infos]).sum() > 0


def test_aux_slice_rd_names_its_stage_slice_theta(targets):
    _, tt = targets["gp"]
    step = SAMPLERS["aux_slice_rd"](tt, n_ess=2)
    assert step.stage_names == ("ess_u", "slice_theta")
    st = t_init(1, tt, 2, jitter_scale=0.3, with_cache=True)
    out, info = step(st, {"slice_theta": {"widths": torch.ones(2),
                                          "max_step_out": 0,
                                          "max_shrink_chol": 3}})
    assert set(info) == {"ess_u/n_shrink", "ess_u/moved",
                         "slice_theta/n_probe", "slice_theta/moved"}
    assert torch.equal(out.extras["target_cache"]["chol_r"],
                       tt.cache_init(out.theta)["chol_r"])
    with pytest.raises(TypeError):
        SAMPLERS["aux_slice_rd"](tt, n_sigma_extra=1)


def test_theta_only_factories(targets):
    _, tt = targets["toy"]
    for kind in ("slice_theta", "mh_theta"):
        step = THETA_ONLY[kind](tt)
        assert step.stage_names == (kind,)
        st = t_init(2, tt, 3, jitter_scale=0.3)
        out, _ = step(st, {})
        assert torch.equal(out.u, st.u)   # no u-update
    for kind in ("nuts", "hmc"):   # ported: tests/test_torch_hmc_nuts.py
        step = THETA_ONLY[kind](tt)
        assert step.stage_names == (kind,)
        st = t_init(2, tt, 3, jitter_scale=0.3)
        out, _ = step(st, {kind: {"step_size": 0.3}})
        assert torch.equal(out.u, st.u)   # no u-update
    assert sorted(THETA_ONLY) == sorted(j_composite.THETA_ONLY)


# ------------------------------------------------- adaptation, params, convert


def test_adapt_params_rd_and_joint_width_rules_match_jax():
    rng = np.random.default_rng(9)
    theta = (rng.standard_normal((4, 10, 2)) * [0.3, 2.0]).astype(np.float32)
    infos = {"slice_theta_rd/n_probe": np.ones((4, 10), np.float32),
             "joint_slice/moved": np.ones((4, 10), np.float32)}
    params = {"slice_theta_rd": {"widths": np.ones(2, np.float32),
                                 "max_step_out": 0},
              "joint_slice": {"width": 1.0, "max_step_out": 0}}
    new_j = j_adapt(params, {"theta": jnp.asarray(theta)},
                    {k: jnp.asarray(v) for k, v in infos.items()})
    new_t = t_adapt(params, {"theta": _t(theta)},
                    {k: _t(v) for k, v in infos.items()})
    np.testing.assert_allclose(new_t["slice_theta_rd"]["widths"].numpy(),
                               np.asarray(new_j["slice_theta_rd"]["widths"]),
                               rtol=1e-5)
    assert isinstance(new_t["joint_slice"]["width"], float)
    np.testing.assert_allclose(new_t["joint_slice"]["width"],
                               new_j["joint_slice"]["width"], rtol=1e-5)
    assert new_t["joint_slice"]["max_step_out"] == 0
    # joint_mh has no step-size rule, as in the reference
    acc = {"joint_mh/accept": _t(np.zeros((4, 10)))}
    assert t_adapt({"joint_mh": {"step_size": 0.3}}, {"theta": _t(theta)},
                   acc) == {"joint_mh": {"step_size": 0.3}}


def _plain(tree):
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (int, float)):
        return tree
    return np.asarray(tree).tolist()


@pytest.mark.parametrize("sampler", ["pm_mh", "aux_slice", "aux_mh",
                                     *NEW_SAMPLERS])
def test_initial_params_match_jax(targets, sampler):
    tj, tt = targets["gp"]
    over = {"sampler": sampler, "widths": 0.7, "max_step_out": 3,
            "max_shrink_chol": 5, "step_size": 0.45}
    want = j_config.initial_params(j_config.RunConfig(**over), tj)
    got = t_config.initial_params(t_config.RunConfig(**over), tt)
    assert _plain(got) == _plain(want)


def test_params_from_numpy_carries_the_new_groups():
    out = convert.params_from_numpy({
        "slice_theta_rd": {"widths": np.float32([0.5, 2.0]),
                           "max_step_out": np.int32(0)},
        "joint_slice": {"width": 1.5, "angle_scale": np.pi / 3,
                        "max_step_out": 4},
        "joint_mh": {"step_size": 0.2, "rho": np.float64(0.4)},
    }, device="cpu")
    assert out["slice_theta_rd"]["max_step_out"] == 0
    assert out["joint_slice"]["max_step_out"] == 4
    for g, k in (("slice_theta_rd", "widths"), ("joint_slice", "width"),
                 ("joint_slice", "angle_scale"), ("joint_mh", "step_size"),
                 ("joint_mh", "rho")):
        assert out[g][k].dtype == torch.float32, (g, k)
    assert float(out["joint_mh"]["rho"]) == pytest.approx(0.4)


# ------------------------------------------------------------------- the CLI


@pytest.mark.parametrize("sampler", NEW_SAMPLERS)
def test_cli_runs_each_new_sampler_on_cpu(sampler):
    """One CPU run per new sampler; ``aux_slice_rd`` gets no
    ``n_sigma_extra`` (its factory takes none), the carried factor goes with
    the ``aux_slice`` family only, and the params have the reference's
    groups."""
    out = {}
    rc = trun.main(["--device", "cpu", "--sampler", sampler, "--chains", "3",
                    "--subsample", "60", "--n-importance", "8", "--steps",
                    "4", "--window-steps", "2", "--warmup-windows", "1",
                    "--max-step-out", "0", "--n-ess", "2", "--n-sigma-extra",
                    "1", "--max-shrink-chol", "3"], result=out)
    assert rc == 0
    assert out["theta"].shape == (3, 4, 2) and np.isfinite(out["theta"]).all()
    st = out["states"]
    assert ("target_cache" in st.extras) == sampler.startswith("aux_slice")
    if "target_cache" in st.extras:
        assert torch.equal(st.extras["target_cache"]["chol_r"],
                           out["target"].cache_init(st.theta)["chol_r"])
    want = j_config.initial_params(j_config.RunConfig(sampler=sampler),
                                   out["target"])
    assert set(out["params"]) == set(want)
    moved = [w_ for w in out["windows"] for k, w_ in w.items()
             if k.endswith("/moved") or k.endswith("/accept")]
    assert moved and all(np.isfinite(moved))
