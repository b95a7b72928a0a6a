"""PyTorch port vs the JAX package: the aux_slice step as a whole (CPU), the
chain runner, adaptation, the CLI and the port's import hygiene.

The slice test runs the JAX ``make_aux_slice(target, n_ess=4,
n_sigma_extra=1)`` for 3 steps on 4 chains (carried factor on, static
``max_step_out=0``, ``max_shrink_chol=3``), recomputes with ``jax.random``
the random rows every step consumed (the key discipline of
``samplers/ess_u.py`` and ``samplers/slice_theta.py``), converts the JAX
state with ``auxpm_tpu_torch.convert`` and feeds state and rows to the port's
deterministic ``apply`` halves.

Which JAX path each piece is compared with, on the CPU:
- ESS update: the reference's whole-sweep path in its jnp version
  (``ops/ess_sweep._ref_ess_sweep``);
- log_ell slice: the per-probe loop ``_slice_1d`` (both sides refactor per
  probe);
- log_sigma slice: the reference's per-probe LOOP path, because off the TPU
  its sweep factory returns None.  The port always takes the sweep, whose
  prior term is decomposed as lp_rest - hiv (x - mu)^2: ~1 ulp apart, same
  decisions.

Tolerances: theta 1e-5 (an accepted point is l + (r - l) U with identical
U's, so only f32 rounding of the bracket differs), log L̂ 2e-4 (f32 sums of
~n O(1) terms in different orders, after an f32 Cholesky by different
routines); probe/shrink/moved counts EQUAL.
"""

import ast
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auxpm_tpu.core.state import blocked_normal
from auxpm_tpu.core.state import init_chain_states as j_init
from auxpm_tpu.models.datasets import load as jload
from auxpm_tpu.models.gp_classification import (
    make_gp_classification as jmake,
)
from auxpm_tpu.samplers.adaptation import adapt_params as j_adapt
from auxpm_tpu.samplers.chain import run_chains as j_run_chains
from auxpm_tpu.samplers.composite import make_aux_slice as j_aux_slice
from auxpm_tpu_torch import convert
from auxpm_tpu_torch import run as trun
from auxpm_tpu_torch._device import resolve_device
from auxpm_tpu_torch.core.state import init_chain_states as t_init
from auxpm_tpu_torch.core.transition import compose
from auxpm_tpu_torch.models.gp_classification import (
    make_gp_classification as tmake,
)
from auxpm_tpu_torch.ops import sigma_sweep as tsig
from auxpm_tpu_torch.samplers.adaptation import adapt_params as t_adapt
from auxpm_tpu_torch.samplers.adaptation import warmup as t_warmup
from auxpm_tpu_torch.samplers.chain import run_chains as t_run_chains
from auxpm_tpu_torch.samplers.composite import SAMPLERS, make_aux_slice
from auxpm_tpu_torch.utils.config import PRESETS, RunConfig, unsupported

S, CHAINS, N_ESS, N_SIGMA_EXTRA, STEPS = 16, 4, 4, 1, 3
REPO = pathlib.Path(__file__).resolve().parent.parent


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


# ------------------------------------------------- the reference's random rows


def _uniform_rows(k_loop, offset):
    return jax.vmap(lambda i: jax.random.uniform(
        jax.random.fold_in(k_loop, i + offset), (), jnp.float32))(
            jnp.arange(32))


def _ess_rows(key, ll, u_shape):
    """samplers/ess_u.py sweep path, one chain: -> (key', scal, v)."""
    vs, rows = [], []
    for r in range(N_ESS):
        key, k_v, k_h, k_loop = jax.random.split(key, 4)
        vs.append(blocked_normal(k_v, u_shape, jnp.float32, 8, u_shape[0]))
        log_h = jnp.log(jax.random.uniform(k_h, (), jnp.float32))
        a0 = jax.random.uniform(k_loop, (), jnp.float32) * (2.0 * jnp.pi)
        ll0 = ll if r == 0 else jnp.float32(0.0)
        rows.append(jnp.concatenate([jnp.stack([ll0, log_h, a0]),
                                     _uniform_rows(k_loop, 1)]))
    return key, jnp.stack(rows), jnp.stack(vs)


def _slice_rows(key):
    """samplers/slice_theta.py, one chain: -> (rep_ell (1,34), rep_sigma
    (1 + n_sigma_extra, 34)) with the three-way split of _slice_1d."""
    _, k_ell, k_sigma = jax.random.split(key, 3)

    def row(k_rep):
        k_h, k_init, k_loop = jax.random.split(k_rep, 3)
        log_u = jnp.log(jax.random.uniform(k_h, (), jnp.float32))
        u1 = jax.random.uniform(k_init, (), jnp.float32)
        return jnp.concatenate([jnp.stack([log_u, u1]),
                                _uniform_rows(k_loop, 0)])

    rep_sigma = [row(k_sigma if rep == 0 else jax.random.fold_in(k_sigma, rep))
                 for rep in range(1 + N_SIGMA_EXTRA)]
    return row(k_ell)[None], jnp.stack(rep_sigma)


def _rows_of_step(key, ll, u_shape):
    key_mid, scal, v = _ess_rows(key, ll, u_shape)
    rep_ell, rep_sigma = _slice_rows(key_mid)
    return scal, v, rep_ell, rep_sigma


# ------------------------------------------------------------------ the slice


@pytest.fixture(scope="module")
def slice_run():
    x, y = jload("pima", subsample=200)
    tj = jmake(x, y, n_importance=S)
    tt = tmake(x, y, n_importance=S, device="cpu")
    step_j = j_aux_slice(tj, n_ess=N_ESS, n_sigma_extra=N_SIGMA_EXTRA)
    params_j = {"ess_u": {}, "slice_theta": {
        "widths": jnp.asarray([1.0, 0.8], jnp.float32),
        "max_step_out": 0, "max_shrink_chol": 3}}
    states = [j_init(jax.random.key(3), tj, CHAINS, jitter_scale=0.3,
                     with_cache=True)]
    infos = []
    for _ in range(STEPS):  # one jitted one-step program, called three times
        s, _recs, info = j_run_chains(step_j, states[-1], params_j, 1)
        states.append(s)
        infos.append({k: np.asarray(v)[:, 0] for k, v in info.items()})
    rows_fn = jax.jit(jax.vmap(
        lambda k, ll: _rows_of_step(k, ll, tj.u_shape)))
    rows = [tuple(np.asarray(r) for r in rows_fn(s.key, s.log_lik_hat))
            for s in states[:-1]]
    params_t = convert.params_from_numpy(
        {g: {k: np.asarray(v) for k, v in sub.items()}
         for g, sub in params_j.items()}, device="cpu")
    step_t = make_aux_slice(tt, n_ess=N_ESS, n_sigma_extra=N_SIGMA_EXTRA)
    return states, infos, rows, params_t, step_t, tt


def _to_port(state_j):
    return convert.chain_states_from_numpy(
        {"theta": np.asarray(state_j.theta), "u": np.asarray(state_j.u),
         "log_lik_hat": np.asarray(state_j.log_lik_hat),
         "chol_r": np.asarray(state_j.extras["target_cache"]["chol_r"])},
        device="cpu")


def _apply_step(step_t, state, rows, params, ll0=None):
    scal, v, rep_ell, rep_sigma = (_t(r) for r in rows)
    if ll0 is not None:  # free-running: the sweep starts from the port's ll
        scal[:, 0, 0] = ll0
    ess, sl = step_t.stages["ess_u"], step_t.stages["slice_theta"]
    state, info_e = ess.apply(state, {"scal": scal, "v": v}, params["ess_u"])
    state, info_s = sl.apply(state, (rep_ell, rep_sigma),
                             params["slice_theta"])
    return state, {**{f"ess_u/{k}": v for k, v in info_e.items()},
                   **{f"slice_theta/{k}": v for k, v in info_s.items()}}


def _assert_step_matches(state_t, info_t, state_j, info_j, scale):
    for k in ("ess_u/n_shrink", "ess_u/moved", "slice_theta/n_probe",
              "slice_theta/n_probe_chol"):
        np.testing.assert_array_equal(info_t[k].numpy(), info_j[k], err_msg=k)
    np.testing.assert_allclose(state_t.theta.numpy(),
                               np.asarray(state_j.theta), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(state_t.log_lik_hat.numpy(),
                               np.asarray(state_j.log_lik_hat), rtol=0,
                               atol=2e-4 * scale)
    np.testing.assert_allclose(state_t.u.numpy(), np.asarray(state_j.u),
                               rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(
        state_t.extras["target_cache"]["chol_r"].numpy(),
        np.asarray(state_j.extras["target_cache"]["chol_r"]), atol=5e-4)


@pytest.mark.parametrize("k", range(STEPS))
def test_slice_teacher_forced(slice_run, k):
    """Each port step starts from the JAX state of that step."""
    states, infos, rows, params_t, step_t, _ = slice_run
    state_t, info_t = _apply_step(step_t, _to_port(states[k]), rows[k],
                                  params_t)
    _assert_step_matches(state_t, info_t, states[k + 1], infos[k], scale=1)


def test_slice_free_running(slice_run):
    """The port runs the 3 steps on its own state, fed the same rows."""
    states, infos, rows, params_t, step_t, tt = slice_run
    state_t = _to_port(states[0])
    for k in range(STEPS):
        state_t, info_t = _apply_step(step_t, state_t, rows[k], params_t,
                                      ll0=state_t.log_lik_hat)
        _assert_step_matches(state_t, info_t, states[k + 1], infos[k],
                             scale=3)
    # the carried factor is the factor of the final theta
    assert torch.equal(state_t.extras["target_cache"]["chol_r"],
                       tt.cache_init(state_t.theta)["chol_r"])
    assert any(info["slice_theta/n_probe"].sum() > 0 for info in infos)


def test_sigma_sweep_switch(slice_run, monkeypatch):
    """``AUXPM_SIGMA_SWEEP=0`` is read when the step is built: the target's
    sweep factory is not called and the log_sigma repeats take the per-probe
    path; otherwise the factory is called once, for 1 + n_sigma_extra
    repeats.  Under ``=0`` one cached step is held to the reference's step on
    the same rows.  The reference reads the same switch; off the TPU its
    sweep factory returns None whatever the setting, so the fixture's JAX
    step is the step it builds under ``=0``."""
    import dataclasses

    states, infos, rows, params_t, _, tt = slice_run
    calls = []

    def factory(n_reps):
        calls.append(n_reps)
        return tt.sigma_sweep_factory(n_reps)

    stubbed = dataclasses.replace(tt, sigma_sweep_factory=factory)
    monkeypatch.setenv("AUXPM_SIGMA_SWEEP", "0")
    make_aux_slice(stubbed, n_ess=N_ESS, n_sigma_extra=N_SIGMA_EXTRA)
    assert calls == []
    step_off = make_aux_slice(tt, n_ess=N_ESS, n_sigma_extra=N_SIGMA_EXTRA)
    monkeypatch.setenv("AUXPM_SIGMA_SWEEP", "1")
    make_aux_slice(stubbed, n_ess=N_ESS, n_sigma_extra=N_SIGMA_EXTRA)
    monkeypatch.delenv("AUXPM_SIGMA_SWEEP")
    make_aux_slice(stubbed, n_ess=N_ESS, n_sigma_extra=N_SIGMA_EXTRA)
    assert calls == [1 + N_SIGMA_EXTRA] * 2

    def no_sweep(*args, **kwargs):
        raise AssertionError("the sigma sweep ran under AUXPM_SIGMA_SWEEP=0")

    monkeypatch.setattr(tsig, "_ref_sigma_sweep", no_sweep)
    state_t, info_t = _apply_step(step_off, _to_port(states[0]), rows[0],
                                  params_t)
    _assert_step_matches(state_t, info_t, states[1], infos[0], scale=1)


def test_step_is_draw_then_apply(slice_run):
    *_, step_t, tt = slice_run
    a = t_init(11, tt, 3, jitter_scale=0.3, with_cache=True)
    b = t_init(11, tt, 3, jitter_scale=0.3, with_cache=True)
    params = {"ess_u": {}, "slice_theta": {"widths": _t([1.0, 1.0]),
                                           "max_step_out": 0}}
    s1, info1 = step_t(a, params)
    ess, sl = step_t.stages["ess_u"], step_t.stages["slice_theta"]
    rows_e, key = ess.draw(b)
    mid, _ = ess.apply(b, rows_e, {})
    rows_s, key = sl.draw(mid.replace(key=key))
    s2, _ = sl.apply(mid, rows_s, params["slice_theta"])
    assert torch.equal(s1.theta, s2.theta) and torch.equal(s1.u, s2.u)
    assert torch.equal(s1.key, key)
    rows, _ = ess.draw(s2)
    assert rows["scal"].shape == (3, N_ESS, 35)
    assert rows["v"].shape == (3, N_ESS, S, 256)
    assert torch.equal(rows["scal"][:, 0, 0], s2.log_lik_hat)
    assert (rows["scal"][:, 1:, 0] == 0).all()
    reps, _ = sl.draw(s2)
    assert [tuple(r.shape) for r in reps] == [(3, 1, 34), (3, 2, 34)]
    assert set(info1) == {"ess_u/n_shrink", "ess_u/moved",
                          "slice_theta/n_probe", "slice_theta/n_probe_chol"}


def test_unported_paths_stop_loudly(slice_run):
    *_, step_t, tt = slice_run
    st = t_init(1, tt, 2, with_cache=True)
    # particle sharding is ported (tests/test_torch_parallel.py); the axis is
    # a parallel.mesh.Mesh, the reference's axis NAME is refused
    with pytest.raises(TypeError, match="Mesh"):
        make_aux_slice(tt, particle_axis="particles")
    with pytest.raises(ValueError, match="shrink uniforms"):
        step_t(st, {"slice_theta": {"max_shrink": 64}})
    with pytest.raises(ValueError, match="unknown param group"):
        step_t(st, {"slice_thet": {}})
    assert compose([]).stage_names == ()
    assert sorted(SAMPLERS) == [
        "aux_hmc", "aux_mh", "aux_nuts", "aux_slice", "aux_slice_joint",
        "aux_slice_pcrd", "aux_slice_rd", "joint_mh", "joint_slice", "pm_mh"]
    # what used to stop here now runs (held against the reference in
    # test_torch_stepout.py): stepping out with the per-probe log_sigma
    # coordinate, and the uncached path
    for state in (st, t_init(1, tt, 2)):
        out, info = step_t(state, {"slice_theta": {"max_step_out": 8}})
        assert torch.isfinite(out.theta).all()
        assert (info["slice_theta/n_probe"] >= 2).all()
    f, f2 = tt.coord_estimators_c[-1](st.theta, st.u,
                                      st.extras["target_cache"])
    lp, ll = f(st.theta[:, 1])
    lp2, ll2 = f2(torch.stack([st.theta[:, 1], st.theta[:, 1] + 0.5]))
    assert torch.allclose(ll2[0], ll, atol=1e-5) and lp2.shape == (2, 2)
    assert torch.allclose(ll, st.log_lik_hat, atol=1e-5)


# ------------------------------------------------------ runner and adaptation


def test_run_chains_thin_and_record_u(slice_run):
    *_, step_t, tt = slice_run
    st = t_init(2, tt, 2, jitter_scale=0.3, with_cache=True)
    params = {"slice_theta": {"max_step_out": 0, "max_shrink_chol": 3}}
    out, recs, infos = t_run_chains(step_t, st, params, 4, thin=2,
                                    record_u=True)
    assert recs["theta"].shape == (2, 2, 2)
    assert recs["log_lik_hat"].shape == (2, 2)
    assert recs["u"].shape == (2, 2, S, 256)
    assert infos["ess_u/moved"].shape == (2, 2)
    assert torch.equal(recs["theta"][:, -1], out.theta)
    assert torch.equal(recs["u"][:, -1], out.u)
    with pytest.raises(ValueError):
        t_run_chains(step_t, st, params, 3, thin=2)


def test_adapt_params_matches_jax_width_rule():
    rng = np.random.default_rng(5)
    theta = (rng.standard_normal((4, 10, 2)) * [0.3, 2.0]).astype(np.float32)
    infos = {"slice_theta/n_probe": np.ones((4, 10), np.float32)}
    new_j = j_adapt({"slice_theta": {"widths": jnp.ones(2), "max_step_out": 0}},
                    {"theta": jnp.asarray(theta)},
                    {k: jnp.asarray(v) for k, v in infos.items()})
    new_t = t_adapt({"slice_theta": {"widths": torch.ones(2),
                                     "max_step_out": 0}, "ess_u": {}},
                    {"theta": _t(theta)}, {k: _t(v) for k, v in infos.items()})
    np.testing.assert_allclose(new_t["slice_theta"]["widths"].numpy(),
                               np.asarray(new_j["slice_theta"]["widths"]),
                               rtol=1e-5)
    assert new_t["slice_theta"]["max_step_out"] == 0 and new_t["ess_u"] == {}
    # no slice stage reported -> params untouched
    same = t_adapt({"ess_u": {}}, {"theta": _t(theta)}, {})
    assert same == {"ess_u": {}}


def test_warmup_adapts_widths(slice_run):
    *_, step_t, tt = slice_run
    st = t_init(3, tt, 3, jitter_scale=0.3, with_cache=True)
    params = {"ess_u": {}, "slice_theta": {"widths": torch.ones(2),
                                           "max_step_out": 0,
                                           "max_shrink_chol": 3}}
    st, new, hist = t_warmup(lambda t, s, p, n: t_run_chains(t, s, p, n), st,
                             params, 2, 2, step=step_t)
    assert len(hist) == 2 and hist[1]["window"] == 1
    assert "ess_u/moved" in hist[0]
    assert not torch.equal(new["slice_theta"]["widths"], torch.ones(2))
    assert new["slice_theta"]["max_shrink_chol"] == 3


# ------------------------------------------------------------------- the CLI


def test_cli_runs_on_cpu_and_prints_summary(capsys, tmp_path):
    out = {}
    rc = trun.main([
        "--device", "cpu", "--chains", "3", "--subsample", "100",
        "--n-importance", "8", "--steps", "4", "--window-steps", "2",
        "--warmup-windows", "1", "--max-step-out", "0", "--n-ess", "2",
        "--n-sigma-extra", "1", "--max-shrink-chol", "3",
        "--metrics-path", str(tmp_path / "m.jsonl"),
        "--out", str(tmp_path / "theta.npz"),
    ], result=out)
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["phase"] == "summary" and summary["device"] == "cpu"
    assert summary["chain_steps_per_sec"] > 0
    assert len(summary["posterior_mean"]) == 2
    assert out["theta"].shape == (3, 4, 2) and np.isfinite(out["theta"]).all()
    assert np.load(tmp_path / "theta.npz")["theta"].shape == (3, 4, 2)
    lines = (tmp_path / "m.jsonl").read_text().splitlines()
    assert [json.loads(l)["phase"] for l in lines] == [
        "warmup", "sample", "sample", "summary"]
    st = out["states"]
    assert torch.equal(st.extras["target_cache"]["chol_r"],
                       out["target"].cache_init(st.theta)["chol_r"])


def test_cli_lists_presets(capsys):
    assert trun.main(["--list-presets"]) == 0
    assert "pima_aux_slice" in capsys.readouterr().out
    cfg = PRESETS["pima_aux_slice"]
    assert (cfg.n_importance, cfg.chains, cfg.device) == (64, 128, "cuda")


@pytest.mark.parametrize("overrides", [
    {"sampler": "aux_hmc", "sharded": True, "particle_shards": 2},
    {"sampler": "aux_nuts", "proposal": "laplace"},
    {"sampler": "aux_hmc", "proposal": "laplace"},
    {"sampler": "smc", "sharded": True, "smc_rejuvenation": "aux_nuts",
     "proposal": "laplace"},
    {"proposal": "laplace", "sharded": True, "particle_shards": 2},
])
def test_config_refuses_unported_parts(overrides):
    """Each combination that the port refused until the gradient samplers
    took particle-sharded and Laplace targets now passes ``unsupported``,
    and its step (or sharded SMC) builds on the CPU: on a particle axis of
    two (the mesh only; its collectives run on two ranks in
    tests/test_torch_sharded_grad.py), or on a flat mesh for the SMC."""
    from auxpm_tpu_torch.parallel.mesh import Mesh
    from auxpm_tpu_torch.samplers.smc_sharded import make_smc_sharded

    cfg = RunConfig().replace(**overrides)
    unsupported(cfg)
    x, y = jload("pima", subsample=32)
    target = tmake(x, y, n_importance=S, proposal=cfg.proposal,
                   device="cpu")
    k = cfg.particle_shards
    mesh = Mesh(rank=0, world=k, n_chain_shards=1, n_particle_shards=k,
                chain_index=0, particle_index=0, particle_group=None,
                chain_group=None)
    if cfg.sampler == "smc":
        run = make_smc_sharded(target, SAMPLERS[cfg.smc_rejuvenation], 16,
                               mesh)
        assert callable(run)
    else:
        if k > 1:
            target = target.make_sharded(mesh)
            assert target.name.endswith("@particles")
        step = SAMPLERS[cfg.sampler](target,
                                     particle_axis=mesh if k > 1 else None)
        assert step.stage_names[0] == "ess_u"
    assert ("_laplace" in target.name) == (cfg.proposal == "laplace")
    # sharding needs a world to run in; --particle-shards alone is an error
    unsupported(RunConfig().replace(sharded=True, particle_shards=2))
    with pytest.raises(ValueError, match="--sharded"):
        unsupported(RunConfig().replace(particle_shards=2))


def test_default_device_is_the_gpu_and_is_never_replaced(monkeypatch):
    assert resolve_device("cpu").type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        trun.main(["--chains", "2", "--steps", "2"])  # --device defaults to cuda
    with pytest.raises(RuntimeError, match="cuda"):
        convert.chain_states_from_numpy({})


# ------------------------------------------------------------ import hygiene


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "auxpm_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for new in ("core/prng.py", "samplers/smc_sharded.py",
                "parallel/resampling.py", "parallel/collectives.py",
                "utils/smc_scale.py", "utils/smc_init.py", "utils/scaling.py",
                "utils/dryrun.py"):
        assert REPO / "auxpm_tpu_torch" / new in files
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "auxpm_tpu"}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_every_port_module_imports_without_cuda():
    import importlib

    for path in sorted((REPO / "auxpm_tpu_torch").rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        name = ".".join(rel.parts)
        if name.endswith(".__init__"):
            name = name[: -len(".__init__")]
        importlib.import_module(name)
    assert not torch.backends.cuda.matmul.allow_tf32
