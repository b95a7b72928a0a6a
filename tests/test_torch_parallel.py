"""PyTorch port vs the JAX package: the particle-sharded path (CPU, gloo).

The port's sharded code runs on real ``torch.distributed`` ranks: each case
spawns 2 or 4 processes (``parallel/launch.spawn``, gloo, one CPU thread
each) that run a job of ``parallel/rank_jobs`` and hand NumPy back.  The JAX
side runs in this process, under ``shard_map`` on the virtual CPU devices
where the comparison is with the reference's sharded target.

What is held to what:
- the weights wrappers against the reference's Pallas weights kernels in
  interpret mode (rtol 2e-6 + atol 2e-5, the bar of the reference's own
  kernel test: two float32 orders of a sum of n terms of size O(1));
- the sharded estimate on 2 and 4 ranks against the reference's
  ``shard_target_particles`` target under ``shard_map`` (rtol 1e-5, the
  reference's own bar between its sharded and unsharded estimates) and
  against the port's unsharded estimate (rtol 2e-6: the same fold of the same
  block partials; the matrix product runs on S/K instead of S rows, and the
  CPU's GEMM may then sum in another order, so bitwise equality is reported
  by the test's message but not required); the same for an S that does not
  fit the 8-block tree (the generic collective) and for the Gaussian toy (the
  generic wrap);
- one sharded ``aux_slice`` step, fed the reference's own random rows
  (recomputed with ``jax.random``), against the reference's step on the
  per-probe path: EQUAL counts, theta and u within 1e-5, log L-hat within
  1e-3 (both sides factor the same Gram with different routines, seen here
  up to 1.4e-4; jitter 1e-3 keeps that far below the slice margins: the bar
  and the jitter of ``test_torch_stepout.py``);
  every rank of a particle group bitwise equal to the others; K=2, K=4 and
  the unsharded port against each other: equal counts, values within 1e-5;
- the command line on 2 ranks (1 x 2) and on 4 (2 x 2, with adaptation over
  the chain shards).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from auxpm_tpu.models.gaussian_toy import make_gaussian_toy as j_toy
from auxpm_tpu.models.gp_classification import (
    make_gp_classification as jmake,
)
from auxpm_tpu.ops import fused_estimator as jfe
from auxpm_tpu.parallel.mesh import make_mesh as j_make_mesh
from auxpm_tpu.parallel.particle_shard import (
    shard_target_particles as j_shard_target,
)
from auxpm_tpu_torch import convert
from auxpm_tpu_torch.core import prng
from auxpm_tpu_torch.core.state import init_chain_states, make_u_normal
from auxpm_tpu_torch.models.gaussian_toy import make_gaussian_toy as t_toy
from auxpm_tpu_torch.models.gp_classification import (
    make_gp_classification as tmake,
)
from auxpm_tpu_torch.ops import fused_estimator as tfe
from auxpm_tpu_torch.parallel import rank_jobs
from auxpm_tpu_torch.parallel.launch import spawn
from auxpm_tpu_torch.parallel.mesh import distributed_init
from auxpm_tpu_torch.parallel.sharded_chain import shard_states
from auxpm_tpu_torch.samplers.composite import make_aux_slice
from tests.test_torch_stepout import (
    INFO_KEYS,
    _apply_step,
    _reference_run,
    _to_port,
    _xy,
)

S, N, CHAINS = 16, 128, 4
JITTER = 1e-3
LL_TOL = 1e-3            # through two factorisations of one Gram, see above
MESHES = [(2, 2), (4, 4), (4, 2)]          # (world, particle shards)
N_ESS, N_SIGMA_EXTRA = 2, 1


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


# --------------------------------------------------------- weights kernels


@pytest.mark.parametrize("likelihood", ["logistic", "probit"])
def test_weights_wrappers_match_the_pallas_kernels(likelihood):
    rng = np.random.default_rng(11)
    b, s, n = 3, 8, N
    u = rng.standard_normal((b, s, n)).astype(np.float32)
    v = rng.standard_normal((b, s, n)).astype(np.float32)
    chol = (np.tril(rng.standard_normal((b, n, n)) * 0.05)
            + np.eye(n)).astype(np.float32)
    y = rng.choice([-1.0, 1.0], n).astype(np.float32)
    mask = (np.arange(n) < 100).astype(np.float32)
    angle = np.array([0.7, -2.1, 3.0], np.float32)
    got = tfe.fused_weights(_t(chol), _t(u), _t(y), _t(mask), likelihood)
    got_rot = tfe.fused_rot_weights(_t(chol), _t(u), _t(v), _t(angle), _t(y),
                                    _t(mask), likelihood)
    assert got.shape == got_rot.shape == (b, s)
    for i in range(b):
        want = jfe._pallas_weights(jnp.asarray(chol[i]), jnp.asarray(u[i]),
                                   jnp.asarray(y), jnp.asarray(mask),
                                   likelihood, interpret=True)
        want_rot = jfe._pallas_rot_weights(
            jnp.asarray(chol[i]), jnp.asarray(u[i]), jnp.asarray(v[i]),
            jnp.float32(angle[i]), jnp.asarray(y), jnp.asarray(mask),
            likelihood, interpret=True)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   rtol=2e-6, atol=2e-5)
        np.testing.assert_allclose(got_rot[i].numpy(), np.asarray(want_rot),
                                   rtol=2e-6, atol=2e-5)
    # chains that are not wanted give 0, the others are untouched
    active = _t([1.0, 0.0, 1.0])
    masked = tfe.fused_rot_weights(_t(chol), _t(u), _t(v), _t(angle), _t(y),
                                   _t(mask), likelihood, active=active)
    assert torch.equal(masked[[0, 2]], got_rot[[0, 2]])
    assert (masked[1] == 0).all()
    # a row's weight does not depend on the rows that share its call
    part = tfe.fused_weights(_t(chol), _t(u[:, 2:6]), _t(y), _t(mask),
                             likelihood)
    np.testing.assert_allclose(part.numpy(), got[:, 2:6].numpy(), rtol=2e-6,
                               atol=2e-5)


# ------------------------------------------------------- the sharded jobs


def _estimate_inputs():
    rng = np.random.default_rng(5)
    theta = (rng.normal(size=(CHAINS, 2)) * 0.3).astype(np.float32)
    return {
        "gp": (theta, rng.standard_normal((CHAINS, S, N)).astype(np.float32)),
        "gp_s12": (theta,
                   rng.standard_normal((CHAINS, 12, N)).astype(np.float32)),
        "toy": (theta, rng.standard_normal((CHAINS, 8, 2)).astype(np.float32)),
    }


def _specs():
    x, y = _xy()
    return {"gp": ("gp", x, y, {"n_importance": S, "jitter": JITTER}),
            "gp_s12": ("gp", x, y, {"n_importance": 12, "jitter": JITTER}),
            "toy": ("gaussian_toy", {"n_importance": 8})}


@pytest.fixture(scope="module")
def reference_step():
    """One step of the reference on its per-probe path (the path the sharded
    chain runs), with the rows it consumed."""
    x, y = _xy()
    tj = jmake(x, y, n_importance=S, jitter=JITTER)
    tt = tmake(x, y, n_importance=S, jitter=JITTER, device="cpu")
    params_j = {"ess_u": {}, "slice_theta": {
        "widths": jnp.asarray([1.0, 0.8], jnp.float32), "max_step_out": 2,
        "max_shrink_chol": 5}}
    saved = os.environ.get("AUXPM_ESS_SWEEP")
    os.environ["AUXPM_ESS_SWEEP"] = "0"   # read when the transitions are built
    try:
        states, infos, rows, params_t, step_t = _reference_run(
            tj, tt, N_ESS, N_SIGMA_EXTRA, params_j, 1, True, seed=3)
    finally:
        if saved is None:
            del os.environ["AUXPM_ESS_SWEEP"]
        else:
            os.environ["AUXPM_ESS_SWEEP"] = saved
    assert not step_t.stages["ess_u"].uses_sweep
    return states, infos[0], rows[0], params_t, step_t


@pytest.fixture(scope="module")
def sharded_results(reference_step):
    """Every mesh's answers: one spawn per mesh runs all its jobs."""
    states, _, rows, params_t, _ = reference_step
    state_np = {"theta": np.asarray(states[0].theta),
                "u": np.asarray(states[0].u),
                "log_lik_hat": np.asarray(states[0].log_lik_hat),
                "chol_r": np.asarray(
                    states[0].extras["target_cache"]["chol_r"])}
    scal, v, *reps = rows
    rows_np = {"scal": scal, "v": v, "reps": tuple(reps)}
    params_np = {g: {k: (v_.numpy() if torch.is_tensor(v_) else v_)
                     for k, v_ in sub.items()}
                 for g, sub in params_t.items()}
    specs, inputs = _specs(), _estimate_inputs()
    out = {}
    for world, k in MESHES:
        jobs = [("step", specs["gp"], state_np, rows_np, params_np,
                 {"n_ess": N_ESS, "n_sigma_extra": N_SIGMA_EXTRA}),
                ("estimate", specs["gp"], *inputs["gp"])]
        if k == 2:
            jobs += [("estimate", specs["gp_s12"], *inputs["gp_s12"]),
                     ("estimate", specs["toy"], *inputs["toy"])]
        per_rank = spawn(rank_jobs.run_all, world, jobs, k, "cpu",
                         timeout_s=180)
        out[(world, k)] = {
            "step": [r[0] for r in per_rank],
            "gp": [r[1] for r in per_rank],
            "gp_s12": [r[2] for r in per_rank] if k == 2 else None,
            "toy": [r[3] for r in per_rank] if k == 2 else None,
        }
    return out


def _stack_chain_shards(per_rank, key, k):
    """The chain shards' arrays in shard order, from the first rank of each
    particle group."""
    return np.concatenate([r[key] for r in per_rank[::k]])


def _group_is_bitwise(per_rank, keys, k):
    for g0 in range(0, len(per_rank), k):
        for r in per_rank[g0 + 1:g0 + k]:
            for key in keys:
                np.testing.assert_array_equal(r[key], per_rank[g0][key],
                                              err_msg=f"rank {r['rank']} "
                                                      f"{key}")


# ----------------------------------------------------------- the estimator


def _reference_sharded_estimates(tj, theta, u, k):
    sh, s_global = j_shard_target(tj, "particles")
    assert s_global == u.shape[1]
    mesh = j_make_mesh(n_chains_shards=1, n_particle_shards=k)
    f = jax.jit(shard_map(
        lambda th, u_l: sh.log_lik_est(th, u_l), mesh=mesh,
        in_specs=(P(), P("particles", None)), out_specs=P(), check_vma=False))
    return np.array([float(f(jnp.asarray(theta[i]), jnp.asarray(u[i])))
                     for i in range(theta.shape[0])])


@pytest.mark.parametrize("world,k", MESHES)
def test_sharded_estimator_matches_reference_and_unsharded(sharded_results,
                                                           world, k):
    x, y = _xy()
    theta, u = _estimate_inputs()["gp"]
    per_rank = sharded_results[(world, k)]["gp"]
    assert per_rank[0]["target"].endswith("@particles")
    _group_is_bitwise(per_rank, ["estimate"], k)
    got = _stack_chain_shards(per_rank, "estimate", k)
    assert got.shape == (CHAINS,)
    tt = tmake(x, y, n_importance=S, jitter=JITTER, device="cpu")
    unsharded = tt.log_lik_est(_t(theta), _t(u)).numpy()
    np.testing.assert_allclose(
        got, unsharded, rtol=2e-6,
        err_msg=f"bitwise equal: {np.array_equal(got, unsharded)}")
    want = _reference_sharded_estimates(
        jmake(x, y, n_importance=S, jitter=JITTER), theta, u, k)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # one collective per estimate (the gathered block partials)
    assert per_rank[0]["counts"]["collectives"] >= 1


@pytest.mark.parametrize("case", ["gp_s12", "toy"])
def test_sharded_estimator_generic_collective(sharded_results, case):
    """S = 12 does not fit the 8-block tree (the target's fallback); the toy
    has no sharded rebuild (the generic wrap).  Both reduce with the generic
    collective log-sum-exp: exact, the same on every rank."""
    x, y = _xy()
    theta, u = _estimate_inputs()[case]
    per_rank = sharded_results[(2, 2)][case]
    _group_is_bitwise(per_rank, ["estimate"], 2)
    got = per_rank[0]["estimate"]
    if case == "toy":
        tt, tj = t_toy(n_importance=8, device="cpu"), j_toy(n_importance=8)
        assert per_rank[0]["target"] == "gaussian_toy@particles"
    else:
        tt = tmake(x, y, n_importance=12, jitter=JITTER, device="cpu")
        tj = jmake(x, y, n_importance=12, jitter=JITTER)
        assert tt.n_weight_blocks == 1
    np.testing.assert_allclose(got, tt.log_lik_est(_t(theta), _t(u)).numpy(),
                               rtol=2e-6)
    np.testing.assert_allclose(
        got, _reference_sharded_estimates(tj, theta, u, 2), rtol=1e-5)


# ---------------------------------------------------------------- the step


@pytest.mark.parametrize("world,k", MESHES)
def test_sharded_step_matches_the_reference_step(reference_step,
                                                 sharded_results, world, k):
    states, info_j, *_ = reference_step
    per_rank = sharded_results[(world, k)]["step"]
    _group_is_bitwise(per_rank, ["theta", "log_lik_hat", "chol_r"], k)
    for key in INFO_KEYS:
        np.testing.assert_array_equal(
            _stack_chain_shards([r["info"] for r in per_rank], key, k),
            info_j[key], err_msg=key)
    np.testing.assert_allclose(_stack_chain_shards(per_rank, "theta", k),
                               np.asarray(states[1].theta), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        _stack_chain_shards(per_rank, "log_lik_hat", k),
        np.asarray(states[1].log_lik_hat), rtol=0, atol=LL_TOL)
    # the rows of u: a group's ranks in particle order, groups in chain order
    u = np.concatenate([np.concatenate([r["u"] for r in per_rank[g:g + k]], 1)
                        for g in range(0, world, k)])
    np.testing.assert_allclose(u, np.asarray(states[1].u), rtol=0, atol=1e-5)
    # the per-probe path: only the collective estimator ran
    assert per_rank[0]["counts"]["collectives"] > 0


def test_particle_shard_counts_do_not_depend_on_k(reference_step,
                                                  sharded_results):
    """K=2, K=4 and the unsharded port on the same state and rows: equal
    counts, values within 1e-5 (see the module note on bitwise equality)."""
    states, _, rows, params_t, step_t = reference_step
    un, info_un = _apply_step(step_t, _to_port(states[0]), rows, params_t)
    for world, k in MESHES:
        per_rank = sharded_results[(world, k)]["step"]
        for key in INFO_KEYS:
            np.testing.assert_array_equal(
                _stack_chain_shards([r["info"] for r in per_rank], key, k),
                info_un[key].numpy(), err_msg=f"K={k} {key}")
        for key, ref in (("theta", un.theta), ("log_lik_hat", un.log_lik_hat)):
            np.testing.assert_allclose(
                _stack_chain_shards(per_rank, key, k), ref.numpy(), rtol=0,
                atol=1e-5, err_msg=f"K={k} {key}")


class _FakeMesh:
    """The coordinates that the state code reads from a ``Mesh``."""

    def __init__(self, n_chain_shards, n_particle_shards, rank):
        self.n_chain_shards = n_chain_shards
        self.n_particle_shards = n_particle_shards
        self.chain_index, self.particle_index = divmod(rank,
                                                       n_particle_shards)


def test_u_shaped_draws_do_not_depend_on_k():
    """A row's draw is a fixed function of the chain's key and the row: a
    particle shard's u at init (the counters of its rows of a plain draw)
    and its v (global row blocks from ``fold_in(key, block)``) are exactly
    the rows the whole state draws there."""

    def Shard(k, pi):
        return _FakeMesh(1, k, rank=pi)

    x, y = _xy()
    tt = tmake(x, y, n_importance=S, device="cpu")
    whole = init_chain_states(7, tt, 3, with_cache=False)
    keys = prng.split(whole.key, 2)                 # two draws per chain
    v = make_u_normal(tt)(keys, S)
    assert v.shape == (3, 2, S, N)
    # a shard's estimate is a collective; here only its rows matter
    rows_only = dataclasses.replace(
        tt, log_lik_est=lambda theta, u: torch.zeros(theta.shape[0]))
    for k in (2, 4):
        rows = S // k
        for pi in range(k):
            share = init_chain_states(7, rows_only, 3, with_cache=False,
                                      mesh=Shard(k, pi))
            v_l = make_u_normal(tt, particle_axis=Shard(k, pi))(keys, rows)
            sl = slice(pi * rows, (pi + 1) * rows)
            assert torch.equal(share.u, whole.u[:, sl])
            assert torch.equal(share.key, whole.key)
            assert torch.equal(share.theta, whole.theta)
            assert torch.equal(v_l, v[:, :, sl])


def test_split_of_a_reference_state():
    rng = np.random.default_rng(0)
    d = {"theta": rng.normal(size=(4, 2)), "u": rng.normal(size=(4, 8, 6)),
         "log_lik_hat": rng.normal(size=4), "chol_r": None}
    shares = convert.shard_numpy_state(d, 2, 4)
    assert len(shares) == 8 and "chol_r" not in shares[0]
    np.testing.assert_array_equal(shares[5]["u"], d["u"][2:4, 2:4])
    np.testing.assert_array_equal(shares[5]["theta"], d["theta"][2:4])
    with pytest.raises(ValueError, match="do not split"):
        convert.shard_numpy_state(d, 3, 2)
    # the same cut of a whole port state, keys included
    x, y = _xy()
    tt = tmake(x, y, n_importance=S, device="cpu")
    whole = init_chain_states(3, tt, 4, with_cache=True)
    mesh = _FakeMesh(2, 4, rank=5)
    share = shard_states(whole, tt, mesh)
    assert torch.equal(share.u, whole.u[2:4, 4:8])
    assert torch.equal(share.extras["target_cache"]["chol_r"],
                       whole.extras["target_cache"]["chol_r"][2:4])
    assert share.theta.shape == (2, 2)
    assert torch.equal(share.key, whole.key[2:4])


# ---------------------------------------------------------------- the CLI


@pytest.mark.parametrize("world", [2, 4])
def test_cli_on_gloo_ranks(world):
    """``--sharded true --particle-shards 2`` on 2 ranks (1 x 2) and on 4
    (2 x 2: the widths are adapted from the moments of both chain shards)."""
    argv = ["--sharded", "true", "--particle-shards", "2", "--device", "cpu",
            "--chains", "4", "--subsample", "60", "--n-importance", "16",
            "--warmup-windows", "2", "--window-steps", "3", "--steps", "3",
            "--max-step-out", "2", "--n-ess", "2", "--n-sigma-extra", "1"]
    ranks = spawn(rank_jobs.cli, world, argv, timeout_s=180)
    chains_local = 4 // (world // 2)
    for r in ranks:
        assert r["u_shape"] == (chains_local, 8, 128)
        assert r["target"].endswith("@particles")
        assert np.isfinite(r["recorded_theta"]).all()
        assert r["recorded_theta"].shape == (4, 3, 2)   # every chain shard's
        np.testing.assert_array_equal(r["widths"], ranks[0]["widths"])
        np.testing.assert_array_equal(r["recorded_theta"],
                                      ranks[0]["recorded_theta"])
        assert r["cache_max_abs_err"] == 0.0
        assert r["counts"]["collectives"] > 0
    _group_is_bitwise(ranks, ["theta", "log_lik_hat"], 2)
    assert not np.array_equal(ranks[0]["widths"], np.ones(2, np.float32))
    if world == 4:   # chain shards hold different chains
        assert not np.array_equal(ranks[0]["theta"], ranks[2]["theta"])
    assert ranks[0]["summary"]["chain_steps_per_sec"] > 0


def test_a_sharded_run_needs_its_world(monkeypatch):
    from auxpm_tpu_torch import run as trun

    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        distributed_init("cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        trun.main(["--sharded", "true", "--particle-shards", "2", "--device",
                   "cpu"])
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        trun.main(["--sharded", "true", "--particle-shards", "2", "--device",
                   "cpu"])
    x, y = _xy()
    tt = tmake(x, y, n_importance=S, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        make_aux_slice(tt, particle_axis="particles")
    assert tt.make_sharded is not None and tt.ess_sweep_factory is not None
