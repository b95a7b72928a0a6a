"""PyTorch port vs the JAX package: the mesh-sharded SMC (CPU, gloo ranks).

- keyed draws: ``sample_prior_key`` of the toy and the GP target and
  ``draw`` of the four theta-only kernels gives the rows
  the reference's transitions consume (recomputed here with ``jax.random``:
  integers and uniforms bitwise, normals within 4 ulp), and a ``THETA_ONLY``
  step on per-chain keys takes the reference's decisions and hands back its
  keys, on the toy and on Pima n=32;
- resampling: ``distributed_systematic_resample_indices`` on 2 and 4 ranks
  against the reference's under ``shard_map`` and the single-device function
  (identical indices), ``gather_resampled`` and the population collectives;
- whole runs: the key-as-u mode on the toy on 2 ranks against the
  reference's ``make_smc_sharded`` on a 2-device mesh, both from
  ``jax.random.key(seed)`` (``mh_theta``; ``slice_theta`` with ``u_blocks =
  8``): betas within 1e-6, u key words identical, ``u_mh_accept`` equal,
  theta and log L-hat within 1e-5; the reference's logZ and moment bars for
  ``carry_u=True`` (2048 particles) and ``u_blocks = 8`` (2^15 particles);
  re-chunking (``rejuv_batch`` 64 vs 256, ``rejuv_dispatches`` 1 vs 4)
  bitwise; per-stage checkpoints (stop after 2 stages, resume with a fresh
  runner: bitwise, also from a run saving every second stage; another key
  or ``u_blocks`` refused; another ``rejuv_dispatches`` resumes); the
  reference's refusals;
- the CLI: ``--preset smc_gp_nuts --device cpu`` at small size on 2 ranks,
  and ``--sampler smc --particle-shards 2`` refused.

The 2-rank cases run in ONE spawn of two gloo ranks (``tests/
torch_smc_ranks.py``), the 4-rank resampling in another.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from auxpm_tpu.core.state import init_chain_states as j_init
from auxpm_tpu.models.datasets import load as jload
from auxpm_tpu.models.gaussian_toy import make_gaussian_toy as j_toy
from auxpm_tpu.models.gp_classification import make_gp_classification as jmake
from auxpm_tpu.parallel.mesh import make_mesh as j_mesh
from auxpm_tpu.parallel.resampling import (
    distributed_systematic_resample_indices as j_dist_resample,
)
from auxpm_tpu.parallel.resampling import (
    systematic_resample_indices as j_resample,
)
from auxpm_tpu.samplers.chain import run_chains as j_run_chains
from auxpm_tpu.samplers.composite import THETA_ONLY as J_THETA_ONLY
from auxpm_tpu.samplers.smc_sharded import make_smc_sharded as j_smc_sharded
from auxpm_tpu_torch import convert
from auxpm_tpu_torch import run as trun
from auxpm_tpu_torch.core import prng
from auxpm_tpu_torch.models.gaussian_toy import make_gaussian_toy as t_toy
from auxpm_tpu_torch.models.gp_classification import (
    make_gp_classification as tmake,
)
from auxpm_tpu_torch.parallel.launch import spawn
from auxpm_tpu_torch.parallel.mesh import Mesh
from auxpm_tpu_torch.parallel.resampling import systematic_resample_indices
from auxpm_tpu_torch.samplers.composite import THETA_ONLY
from auxpm_tpu_torch.samplers.slice_theta import MAX_SHRINK
from auxpm_tpu_torch.samplers.smc_sharded import make_smc_sharded, u_of_keys
from auxpm_tpu_torch.utils.config import RunConfig, unsupported
from tests.torch_smc_ranks import run_jobs

TOY = ("toy", {"n_importance": 16, "noise_frac": 0.5})
ULP_BAR = 4
CHAINS = 6
PARAMS = {"mh_theta": {"step_size": 0.3},
          "slice_theta": {"widths": 1.0, "max_step_out": 4},
          "hmc": {"step_size": 0.15, "n_leapfrog": 6},
          "nuts": {"step_size": 0.15}}
DECISIONS = {"mh_theta": ("accept",), "slice_theta": ("n_probe",),
             "hmc": ("accept", "diverged"),
             "nuts": ("depth", "n_leapfrog", "diverged")}
TOL = {"toy": {"theta": 1e-5, "ll": 1e-5}, "gp": {"theta": 1e-4, "ll": 2e-4}}
N_PARITY = 256
PARITY_RUNS = {   # name -> (kernel, u_blocks, n_u_mh, seed)
    "mh": ("mh_theta", 1, 2, 5),
    "slice_ub8": ("slice_theta", 8, 1, 7),
}
RESAMPLE_U01 = (0.37, 0.0, 0.999)
CLI_ARGV = ["--preset", "smc_gp_nuts", "--device", "cpu", "--subsample",
            "48", "--particles", "64", "--smc-rejuv-batch", "16"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy_log_evidence():
    y = np.array([1.0, -0.5])
    c = 4.0 * np.eye(2) + np.array([[1.0, 0.4], [0.4, 0.8]])
    return float(-0.5 * y @ np.linalg.solve(c, y)
                 - 0.5 * np.linalg.slogdet(2 * np.pi * c)[1])


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _words(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


# ---------------------------------------------------------------- the ranks


def _resample_inputs(n=64):
    rng = np.random.default_rng(1)
    return (3.0 * rng.standard_normal(n)).astype(np.float32), \
        rng.standard_normal((n, 3)).astype(np.float32)


def _smc_job(**kw):
    return ("smc", {"target": TOY, **kw})


def _jobs2(ckpt_dir):
    log_w, payload = _resample_inputs()
    base = dict(n_particles=2048, n_mcmc=1, carry_u=False, n_u_mh=2,
                rejuvenation="slice_theta")
    ck = dict(base, ess_frac=0.8, rejuv_batch=64, seed=21)
    ck_a, ck_b = str(ckpt_dir / "a"), str(ckpt_dir / "b")
    jobs = {f"resample_{u}": ("resample", {"log_w": log_w, "u01": u,
                                           "payload": payload})
            for u in RESAMPLE_U01}
    for name, (kind, ub, n_u_mh, seed) in PARITY_RUNS.items():
        jobs[f"parity_{name}"] = _smc_job(
            rejuvenation=kind, n_particles=N_PARITY, seed=seed, stop_after=2,
            n_mcmc=1, carry_u=False, n_u_mh=n_u_mh, u_blocks=ub,
            rejuv_batch=64)
    jobs.update({
        "bars_carry_u": _smc_job(rejuvenation="aux_slice", n_particles=2048,
                                 seed=3, n_mcmc=2),
        "bars_u_blocks": _smc_job(**dict(base, n_particles=2**15, n_u_mh=1,
                                         u_blocks=8, rejuv_batch=2048,
                                         seed=31)),
        "chunk_64": _smc_job(**base, rejuv_batch=64, seed=12),
        "chunk_256": _smc_job(**base, rejuv_batch=256, seed=12),
        "dispatch_4": _smc_job(**base, rejuv_batch=64, rejuv_dispatches=4,
                               seed=12),
        "ckpt_ref": _smc_job(**ck),
        "ckpt_a_stop": _smc_job(**ck, checkpoint_dir=ck_a, stop_after=2),
        "ckpt_a_resume": _smc_job(**ck, checkpoint_dir=ck_a),
        "ckpt_a_other_key": _smc_job(**dict(ck, seed=22), checkpoint_dir=ck_a,
                                     expect_error=True),
        "ckpt_a_other_blocks": _smc_job(**ck, checkpoint_dir=ck_a, u_blocks=8,
                                        expect_error=True),
        "ckpt_b_stop": _smc_job(**ck, checkpoint_dir=ck_b, stop_after=2,
                                checkpoint_every=2),
        "ckpt_b_redispatched": _smc_job(**dict(ck, rejuv_batch=128),
                                        checkpoint_dir=ck_b,
                                        rejuv_dispatches=4),
        "cli": ("cli", {"argv": CLI_ARGV}),
    })
    return jobs


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    """Every 2-rank case, one spawn: ``{job name: [rank 0, rank 1]}``."""
    jobs = _jobs2(tmp_path_factory.mktemp("smc_ckpt"))
    out = spawn(run_jobs, 2, list(jobs.values()), timeout_s=400)
    return {name: [r[i] for r in out] for i, name in enumerate(jobs)}


@pytest.fixture(scope="module")
def ranks4():
    log_w, payload = _resample_inputs()
    jobs = [("resample", {"log_w": log_w, "u01": u, "payload": payload})
            for u in RESAMPLE_U01]
    out = spawn(run_jobs, 4, jobs, timeout_s=200)
    return [[r[i] for r in out] for i in range(len(jobs))]


def _cat(results, key):
    return np.concatenate([r[key] for r in results])


# ------------------------------------------------------------ keyed draws


@pytest.fixture(scope="module")
def targets():
    x, y = jload("pima", subsample=32)
    return {
        "toy": (j_toy(n_importance=16, noise_frac=0.5),
                t_toy(n_importance=16, noise_frac=0.5, device="cpu")),
        "gp": (jmake(x, y, n_importance=8, jitter=1e-3),
               tmake(x, y, n_importance=8, jitter=1e-3, device="cpu")),
    }


def _recipe(kind, key, d):
    """The rows the reference's transition draws from one chain's key, and
    the key it hands back."""
    if kind == "mh_theta":
        key, k_prop, k_acc = jax.random.split(key, 3)
        return key, {"eps": jax.random.normal(k_prop, (d,)),
                     "log_unif": jnp.log(jax.random.uniform(k_acc, ()))}
    if kind == "hmc":
        key, k_mom, k_acc, k_traj = jax.random.split(key, 4)
        return key, {"n_steps": jax.random.randint(k_traj, (), 1, 7),
                     "r0": jax.random.normal(k_mom, (d,)),
                     "log_u": jnp.log(jax.random.uniform(k_acc, ()))}
    if kind == "nuts":
        key, k_mom, k_loop = jax.random.split(key, 3)
        rows = {"direction": [], "u_biased": [], "leaf_keys": []}
        for _ in range(8):
            kd, kb, ks, k_loop = jax.random.split(k_loop, 4)
            rows["direction"].append(
                jnp.where(jax.random.bernoulli(kd), 1.0, -1.0))
            rows["u_biased"].append(jax.random.uniform(kb, ()))
            # the subtree's key: leaf s takes uniform(fold_in(ks, s))
            rows["leaf_keys"].append(jax.random.key_data(ks))
        return key, {"r0": jax.random.normal(k_mom, (d,)),
                     **{k: jnp.stack(v) for k, v in rows.items()}}
    key, *coord_keys = jax.random.split(key, d + 1)

    def row(k_rep):
        k_h, k_init, k_loop = jax.random.split(k_rep, 3)
        shrink = jax.vmap(lambda j: jax.random.uniform(
            jax.random.fold_in(k_loop, j), ()))(jnp.arange(MAX_SHRINK))
        return jnp.concatenate([
            jnp.stack([jnp.log(jax.random.uniform(k_h, ())),
                       jax.random.uniform(k_init, ())]), shrink])

    return key, {f"coord{i}": row(k)[None] for i, k in enumerate(coord_keys)}


def _toy_state(tt):
    from auxpm_tpu_torch.core.state import init_chain_states

    return init_chain_states(0, tt, CHAINS, jitter_scale=0.5)


@pytest.mark.parametrize("name", ["toy", "gp"])
def test_sample_prior_key_matches_the_reference(targets, name):
    tj, tt = targets[name]
    keys = jax.random.split(jax.random.key(4), 100)
    want = np.asarray(jax.vmap(tj.sample_prior)(keys))
    got = tt.sample_prior_key(torch.from_numpy(_words(keys))).numpy()
    assert got.shape == (100, tt.d)
    assert _ulps(got, want).max() <= ULP_BAR


@pytest.mark.parametrize("kind", sorted(PARAMS))
def test_draw_keyed_gives_the_reference_rows(targets, kind):
    _, tt = targets["toy"]
    keys = jax.random.split(jax.random.key(3), CHAINS)
    want_keys, want = jax.vmap(lambda k: _recipe(kind, k, tt.d))(keys)
    state = _toy_state(tt).replace(key=torch.from_numpy(_words(keys)))
    stage = THETA_ONLY[kind](tt).stages[kind]
    rows, got_keys = stage.draw(state, PARAMS[kind])
    np.testing.assert_array_equal(got_keys.numpy(), _words(want_keys))
    if kind == "slice_theta":
        rows = {f"coord{i}": r for i, r in enumerate(rows)}
    assert set(rows) == set(want)
    for name, w in want.items():
        g, w = rows[name].numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        if name in ("eps", "r0"):                       # normals
            assert _ulps(g, w).max() <= ULP_BAR, name
        elif name in ("log_unif", "log_u"):             # log of a uniform
            assert _ulps(g, w).max() <= 1, name
        elif name.startswith("coord"):                 # [log U, U1, U...]
            np.testing.assert_array_equal(g[..., 1:], w[..., 1:])
            assert _ulps(g[..., 0], w[..., 0]).max() <= 1, name
        else:                                   # ints, keys, uniforms, +-1
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)


@pytest.mark.parametrize("kind", sorted(PARAMS))
@pytest.mark.parametrize("name", ["toy", "gp"])
def test_keyed_theta_only_step_matches_the_reference(targets, kind, name):
    tj, tt = targets[name]
    state_j = j_init(jax.random.key(11), tj, CHAINS, jitter_scale=0.5)
    step_j, step_t = J_THETA_ONLY[kind](tj), THETA_ONLY[kind](tt)
    params = {kind: PARAMS[kind]}
    seen = []
    for _ in range(2):
        nxt, _, info = j_run_chains(step_j, state_j, params, 1)
        st = convert.chain_states_from_numpy(
            {"theta": np.asarray(state_j.theta), "u": np.asarray(state_j.u),
             "log_lik_hat": np.asarray(state_j.log_lik_hat),
             "key": _words(state_j.key)}, device="cpu")
        out, info_t = step_t(st, params)
        np.testing.assert_array_equal(out.key.numpy(), _words(nxt.key))
        for dec in DECISIONS[kind]:
            np.testing.assert_array_equal(
                info_t[f"{kind}/{dec}"].numpy(),
                np.asarray(info[f"{kind}/{dec}"])[:, 0], err_msg=dec)
            seen.append(info_t[f"{kind}/{dec}"].numpy())
        np.testing.assert_allclose(out.theta.numpy(), np.asarray(nxt.theta),
                                   rtol=0, atol=TOL[name]["theta"])
        np.testing.assert_allclose(out.log_lik_hat.numpy(),
                                   np.asarray(nxt.log_lik_hat), rtol=0,
                                   atol=TOL[name]["ll"])
        state_j = nxt
    assert len(np.unique(np.concatenate(seen))) > 1   # not all one way


def test_unkeyed_theta_only_step_still_draws_from_the_generator(targets):
    """Every state carries its keys now (no generator is left): a
    theta-only step is its stage's draw from ``state.key`` then apply, and
    hands the advanced keys back."""
    _, tt = targets["toy"]
    a, b = _toy_state(tt), _toy_state(tt)
    step = THETA_ONLY["mh_theta"](tt)
    out, info = step(a, {"mh_theta": {"step_size": 0.3}})
    rows, key = step.stages["mh_theta"].draw(b)
    want, _ = step.stages["mh_theta"].apply(b, rows, {"step_size": 0.3})
    assert torch.equal(out.theta, want.theta) and torch.equal(out.key, key)
    assert not torch.equal(out.key, a.key)
    with pytest.raises(ValueError, match="unknown param group"):
        step(a, {"nuts": {}})


# ------------------------------------------------------------- resampling


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_resample_matches_the_reference(ranks2, ranks4, world):
    log_w, payload = _resample_inputs()
    mesh = j_mesh(n_chains_shards=world)
    results = ([ranks2[f"resample_{u}"] for u in RESAMPLE_U01] if world == 2
               else ranks4)
    ref = jax.jit(shard_map(
        lambda w, u: j_dist_resample(w, u, "chains"), mesh=mesh,
        in_specs=(P("chains"), P()), out_specs=P("chains"), check_vma=False))
    for u01, res in zip(RESAMPLE_U01, results):
        u = jnp.asarray(u01, jnp.float32)
        want = np.asarray(ref(jnp.asarray(log_w), u))
        single = np.asarray(jax.jit(j_resample)(jnp.asarray(log_w), u))
        idx = _cat(res, "idx")
        np.testing.assert_array_equal(idx, want)
        np.testing.assert_array_equal(idx, single)
        np.testing.assert_array_equal(
            idx, systematic_resample_indices(torch.from_numpy(log_w),
                                             torch.tensor(u01)).numpy())
        # the gathered payload is the source rows, nested dicts too
        np.testing.assert_array_equal(_cat(res, "a"), payload[idx])
        np.testing.assert_array_equal(_cat(res, "c"), idx)
        m = log_w.max()
        lse = np.log(np.exp(log_w.astype(np.float64) - m).sum()) + m
        ess = np.exp(2 * lse - (np.log(np.exp(2.0 * log_w.astype(
            np.float64) - 2 * m).sum()) + 2 * m))
        n_local = len(log_w) // world
        for r in res:   # every rank the same bits
            assert (r["lse"], r["ess"], r["pmax"]) == (
                res[0]["lse"], res[0]["ess"], res[0]["pmax"])
            assert r["pmax"] == m
            np.testing.assert_allclose(r["lse"], lse, rtol=1e-6)
            np.testing.assert_allclose(r["ess"], ess, rtol=1e-5)
            np.testing.assert_allclose(
                r["pmean"], log_w.reshape(world, n_local)[:, :3].mean(0),
                rtol=1e-6, atol=1e-6)


# -------------------------------------------------------- whole-run parity


@pytest.mark.parametrize("run", sorted(PARITY_RUNS))
def test_keyed_run_matches_the_reference(ranks2, run):
    kind, ub, n_u_mh, seed = PARITY_RUNS[run]
    ref = j_smc_sharded(j_toy(n_importance=16, noise_frac=0.5),
                        J_THETA_ONLY[kind], N_PARITY, j_mesh(n_chains_shards=2),
                        n_mcmc=1, carry_u=False, n_u_mh=n_u_mh, u_blocks=ub,
                        rejuv_batch=64)
    states_j, diag_j = ref(jax.random.key(seed), stop_after=2)
    res = ranks2[f"parity_{run}"]
    diag = res[0]["diag"]
    for key in ("betas", "log_z", "u_mh_accept"):   # every rank the same
        assert res[1]["diag"][key] == diag[key]
    assert diag["n_stages"] == diag_j["n_stages"] == 2
    np.testing.assert_allclose(diag["betas"], diag_j["betas"], rtol=0,
                               atol=1e-6)
    assert diag["u_mh_accept"] == [float(a) for a in diag_j["u_mh_accept"]]
    np.testing.assert_allclose(diag["log_z"], diag_j["log_z"], rtol=0,
                               atol=1e-5)
    u = _cat(res, "u")
    assert u.shape == ((N_PARITY, 2) if ub == 1 else (N_PARITY, ub, 2))
    np.testing.assert_array_equal(u, np.asarray(states_j.u).astype(np.int64))
    np.testing.assert_array_equal(_cat(res, "key"), _words(states_j.key))
    np.testing.assert_allclose(_cat(res, "theta"), np.asarray(states_j.theta),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(_cat(res, "log_lik_hat"),
                               np.asarray(states_j.log_lik_hat), rtol=0,
                               atol=1e-5)


def test_key_as_u_invariant(ranks2):
    """log L-hat is the estimate at the u its stored keys generate."""
    tt = t_toy(n_importance=16, noise_frac=0.5, device="cpu")
    for name, ub in (("parity_mh", 1), ("parity_slice_ub8", 8),
                     ("bars_u_blocks", 8)):
        r = ranks2[name][0]
        u = u_of_keys(torch.from_numpy(r["u"][:64]), tt.u_shape, ub)
        torch.testing.assert_close(
            tt.log_lik_est(torch.from_numpy(r["theta"][:64]), u),
            torch.from_numpy(r["log_lik_hat"][:64]), rtol=0, atol=2e-5)


# ------------------------------------------------------ the reference's bars


def test_carry_u_toy_evidence_and_moments(ranks2):
    """``tests/test_smc.py::test_smc_sharded_matches_moments_and_logz``:
    2048 particles, ``aux_slice`` rejuvenation, carry_u."""
    res = ranks2["bars_carry_u"]
    diag, th = res[0]["diag"], _cat(res, "theta")
    assert diag["betas"][-1] == 1.0 and "u_mh_accept" not in diag
    assert _cat(res, "u").shape == (2048, 16, 2)
    tt = t_toy(n_importance=16, noise_frac=0.5, device="cpu")
    mean, cov = tt.posterior_mean.numpy(), tt.posterior_cov.numpy()
    assert np.all(np.abs(th.mean(0) - mean) < 0.15), th.mean(0)
    assert np.all(np.abs(th.var(0) - np.diag(cov)) < 0.3 * np.diag(cov))
    assert abs(diag["log_z"] - _toy_log_evidence()) < 0.2, diag["log_z"]


def test_u_blocks_toy_exact(ranks2):
    """``tests/test_smc.py::test_smc_light_u_blocks_toy_exact``: 2^15
    particles, u_blocks = 8, one blocked proposal per block."""
    res = ranks2["bars_u_blocks"]
    diag, th = res[0]["diag"], _cat(res, "theta")
    assert diag["betas"][-1] == 1.0
    u = _cat(res, "u")
    assert u.shape == (2**15, 8, 2) and u.dtype == np.int64
    assert u.min() >= 0 and u.max() < 2**32
    tt = t_toy(n_importance=16, noise_frac=0.5, device="cpu")
    mean, cov = tt.posterior_mean.numpy(), tt.posterior_cov.numpy()
    assert np.all(np.abs(th.mean(0) - mean) < 0.08), th.mean(0)
    assert np.all(np.abs(th.var(0) - np.diag(cov)) < 0.25 * np.diag(cov))
    assert abs(diag["log_z"] - _toy_log_evidence()) < 0.15, diag["log_z"]
    assert all(0.0 < a <= 1.0 for a in diag["u_mh_accept"])


def _assert_bitwise(a, b):
    assert a[0]["diag"]["betas"] == b[0]["diag"]["betas"]
    assert a[0]["diag"]["log_z"] == b[0]["diag"]["log_z"]
    assert a[0]["diag"]["u_mh_accept"] == b[0]["diag"]["u_mh_accept"]
    for key in ("theta", "u", "log_lik_hat", "key"):
        np.testing.assert_array_equal(_cat(a, key), _cat(b, key), err_msg=key)


def test_rechunking_is_bitwise(ranks2):
    """rejuv_batch 64 vs 256 and rejuv_dispatches 1 vs 4: the same run."""
    _assert_bitwise(ranks2["chunk_64"], ranks2["chunk_256"])
    _assert_bitwise(ranks2["chunk_64"], ranks2["dispatch_4"])
    assert ranks2["chunk_64"][0]["diag"]["betas"][-1] == 1.0


def test_checkpoint_resume_is_bitwise(ranks2):
    ref = ranks2["ckpt_ref"]
    assert ref[0]["diag"]["n_stages"] >= 3
    assert ranks2["ckpt_a_stop"][0]["diag"]["n_stages"] == 2
    _assert_bitwise(ranks2["ckpt_a_resume"], ref)
    # a resume may re-chunk: rejuv_batch and rejuv_dispatches are not hashed
    _assert_bitwise(ranks2["ckpt_b_redispatched"], ref)
    for name in ("ckpt_a_other_key", "ckpt_a_other_blocks"):
        assert ranks2[name][0] == {"error": "checkpoint config hash mismatch"}


def _flat_mesh(world=2, k=1):
    return Mesh(rank=0, world=world, n_chain_shards=world // k,
                n_particle_shards=k, chain_index=0, particle_index=0,
                particle_group=None, chain_group=None)


def test_the_reference_refusals():
    """``tests/test_smc.py::test_smc_u_blocks_validation`` and the other
    refusals of the reference's ``make_smc_sharded``."""
    tt = t_toy(n_importance=16, device="cpu")
    make = THETA_ONLY["slice_theta"]
    with pytest.raises(ValueError, match="carry_u=False"):
        make_smc_sharded(tt, make, 64, _flat_mesh(), u_blocks=8)
    with pytest.raises(ValueError, match="not divisible"):
        make_smc_sharded(tt, make, 64, _flat_mesh(), carry_u=False,
                         u_blocks=7)
    with pytest.raises(ValueError, match="63 particles not divisible by 2"):
        make_smc_sharded(tt, make, 63, _flat_mesh())
    with pytest.raises(ValueError, match="log_weights_u"):
        make_smc_sharded(dataclasses.replace(tt, log_weights_u=None), make,
                         64, _flat_mesh(), carry_u=False, u_blocks=8)
    with pytest.raises(ValueError, match="flat mesh"):
        make_smc_sharded(tt, make, 64, _flat_mesh(4, 2))
    with pytest.raises(ValueError, match="sample_prior_key"):
        make_smc_sharded(dataclasses.replace(tt, sample_prior_key=None), make,
                         64, _flat_mesh())


# ------------------------------------------------------------------ the CLI


def test_cli_smc_gp_nuts_on_two_ranks(ranks2):
    res = ranks2["cli"]
    for r in res:
        s = r["summary"]
        assert s["phase"] == "smc_summary" and s["betas"][-1] == 1.0
        assert np.isfinite(s["log_z"]) and len(s["u_mh_accept"]) == \
            s["n_stages"]
        assert all(0.0 < a <= 1.0 for a in s["u_mh_accept"])
        assert r["u_shape"] == (32, 2)            # 64 particles, key words
        assert r["key_u_invariant_max_abs_err"] < 1e-3
    timing = ("wall", "stage_seconds")
    assert ({k: v for k, v in res[0]["summary"].items() if k not in timing}
            == {k: v for k, v in res[1]["summary"].items() if k not in timing})


@pytest.mark.parametrize("overrides", [
    {"sampler": "smc", "sharded": True, "particle_shards": 2},
    {"sampler": "smc", "particle_shards": 2},
])
def test_smc_with_particle_shards_is_refused(overrides):
    with pytest.raises(ValueError, match="--particle-shards > 1 is not "
                                         "supported with --sampler smc"):
        unsupported(RunConfig().replace(**overrides))
    with pytest.raises(ValueError, match="--particle-shards"):
        trun.main(["--sampler", "smc", "--sharded", "true",
                   "--particle-shards", "2", "--device", "cpu"])
