"""Per-chain keys: whole port chains against the reference's, and chains that
do not depend on the layout (CPU).

Every chain of the port carries the reference's counter-based key
(``core/prng.py``) and splits it as the reference does, so from one seed:

- ``aux_slice`` on the Gaussian toy and on a GP target (Pima n=200 -> 256,
  S=16, 4 chains) for 5 steps, both packages free-running: the keys after
  every step bitwise ``jax.random.key_data`` of the reference's, u at init
  within 4 ulp, the decisions (``moved``, ``n_shrink``, ``n_probe``)
  identical and theta within 1e-5 (toy) / 1e-4 (GP, f32 sums of n terms in
  other orders through an f32 Cholesky), log L-hat within 1e-5 / 2e-4;
- one step of ``pm_mh``, ``joint_slice`` and ``aux_hmc`` on the GP target,
  held the same way;
- the single-device SMC on the toy (``smc_toy``'s rejuvenation, 64
  particles): betas within 1e-6, the resampling indices of each of 3
  stages identical and the particles' keys after them bitwise;
- chain-shard invariance: records of the toy on 1, 2 and 4 spawned gloo
  chain shards bitwise equal (the counterpart of
  ``tests/test_distributed.py::test_mesh_shape_invariance_bitwise``), and a
  checkpoint written on 2 shards resumed on 4, bitwise an uninterrupted
  4-shard run (``test_checkpoint_resume_sharded_reshard_bitwise``);
- a 2-rank particle-sharded GP run against one process: keys bitwise,
  decisions identical, values to rounding (the collective folds the
  estimate in another order);
- ``--multihost`` on two emulated nodes of one rank each, with the preset
  ``gp_4096_sharded`` at ``--chains 8 --subsample 128``: records bitwise one
  process's (``tests/test_multiprocess.py``); without a world that spans
  nodes it raises;
- the threefry wrapper on CPU keys is its plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auxpm_tpu.core.state import init_chain_states as j_init
from auxpm_tpu.models.datasets import load as jload
from auxpm_tpu.models.gaussian_toy import make_gaussian_toy as j_toy
from auxpm_tpu.models.gp_classification import make_gp_classification as jmake
from auxpm_tpu.samplers import smc as j_smc_mod
from auxpm_tpu.samplers.chain import run_chains as j_run_chains
from auxpm_tpu.samplers.composite import SAMPLERS as J_SAMPLERS
from auxpm_tpu.utils.config import PRESETS as J_PRESETS
from auxpm_tpu_torch import run as trun
from auxpm_tpu_torch.core import prng
from auxpm_tpu_torch.core.state import init_chain_states as t_init
from auxpm_tpu_torch.models.gaussian_toy import make_gaussian_toy as t_toy
from auxpm_tpu_torch.models.gp_classification import (
    make_gp_classification as tmake,
)
from auxpm_tpu_torch.ops import threefry as tfk
from auxpm_tpu_torch.parallel.launch import spawn
from auxpm_tpu_torch.parallel.mesh import distributed_init
from auxpm_tpu_torch.samplers import smc as t_smc_mod
from auxpm_tpu_torch.samplers.chain import run_chains as t_run_chains
from auxpm_tpu_torch.samplers.composite import SAMPLERS
from auxpm_tpu_torch.utils.config import PRESETS, RunConfig, unsupported
from tests import torch_key_ranks as key_ranks

SEED, CHAINS, STEPS = 3, 4, 5
S_GP = 16
U_ULP = 4
TOL = {"toy": {"theta": 1e-5, "ll": 1e-5}, "gp": {"theta": 1e-4, "ll": 2e-4},
       # a leapfrog trajectory integrates the f32 gradients' differences
       # (through the f32 Cholesky) over up to 6 steps: 1.3e-4 seen on one
       # chain at log_ell ~1.9, where R(ell) is near singular
       "gp_hmc": {"theta": 5e-4, "ll": 1e-2}}
PARAMS = {
    "aux_slice": {"ess_u": {}, "slice_theta": {
        "widths": [1.0, 0.8], "max_step_out": 0, "max_shrink_chol": 3}},
    "pm_mh": {"step_size": 0.3},
    "joint_slice": {"joint_slice": {"width": 0.5, "max_step_out": 2}},
    "aux_hmc": {"ess_u": {}, "hmc": {"step_size": 0.15, "n_leapfrog": 6}},
}
DECISIONS = {
    "aux_slice": ("ess_u/moved", "ess_u/n_shrink", "slice_theta/n_probe",
                  "slice_theta/n_probe_chol"),
    "pm_mh": ("accept",),
    "joint_slice": ("joint_slice/moved", "joint_slice/n_probe"),
    "aux_hmc": ("ess_u/moved", "ess_u/n_shrink", "hmc/accept",
                "hmc/diverged"),
}
SAMPLER_KW = {"aux_slice": {"n_ess": 2, "n_sigma_extra": 1}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its tests run many small ops,
    and the suite runs several workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.fixture(scope="module")
def targets():
    x, y = jload("pima", subsample=200)
    return {
        "toy": (j_toy(n_importance=16, noise_frac=0.5),
                t_toy(n_importance=16, noise_frac=0.5, device="cpu")),
        "gp": (jmake(x, y, n_importance=S_GP),
               tmake(x, y, n_importance=S_GP, device="cpu")),
    }


def _params(sampler):
    p = PARAMS[sampler]
    j = {g: ({k: jnp.asarray(v, jnp.float32) if isinstance(v, list) else v
              for k, v in sub.items()} if isinstance(sub, dict) else sub)
         for g, sub in p.items()}
    t = {g: ({k: torch.tensor(v) if isinstance(v, list) else v
              for k, v in sub.items()} if isinstance(sub, dict) else sub)
         for g, sub in p.items()}
    return j, t


def _pair(name, sampler, targets):
    tj, tt = targets[name]
    cached = sampler == "aux_slice"
    sj = j_init(jax.random.key(SEED), tj, CHAINS, jitter_scale=0.3,
                with_cache=cached)
    st = t_init(SEED, tt, CHAINS, jitter_scale=0.3, with_cache=cached)
    np.testing.assert_array_equal(st.key.numpy(), _words(sj.key))
    assert _ulps(st.u.numpy(), np.asarray(sj.u)).max() <= U_ULP
    assert _ulps(st.theta.numpy(), np.asarray(sj.theta)).max() <= U_ULP
    kw = SAMPLER_KW.get(sampler, {})
    return sj, st, J_SAMPLERS[sampler](tj, **kw), SAMPLERS[sampler](tt, **kw)


def _hold(sampler, name, sj, st, info_j, info_t, what):
    if sampler == "aux_hmc":
        name = "gp_hmc"
    np.testing.assert_array_equal(st.key.numpy(), _words(sj.key),
                                  err_msg=what)
    for k in DECISIONS[sampler]:
        np.testing.assert_array_equal(info_t[k].numpy(),
                                      np.asarray(info_j[k])[:, 0],
                                      err_msg=f"{what} {k}")
    np.testing.assert_allclose(st.theta.numpy(), np.asarray(sj.theta),
                               rtol=0, atol=TOL[name]["theta"], err_msg=what)
    np.testing.assert_allclose(st.log_lik_hat.numpy(),
                               np.asarray(sj.log_lik_hat), rtol=0,
                               atol=TOL[name]["ll"], err_msg=what)


@pytest.mark.parametrize("name", ["toy", "gp"])
def test_aux_slice_chain_matches_the_reference_key_for_key(targets, name):
    sj, st, step_j, step_t = _pair(name, "aux_slice", targets)
    pj, pt = _params("aux_slice")
    moved = []
    for k in range(STEPS):
        sj, _, info_j = j_run_chains(step_j, sj, pj, 1)
        st, info_t = step_t(st, pt)
        _hold("aux_slice", name, sj, st, info_j, info_t, f"step {k}")
        moved.append(info_t["slice_theta/n_probe"].numpy())
    assert len(np.unique(np.concatenate(moved))) > 1   # the loops iterated


@pytest.mark.parametrize("sampler", ["pm_mh", "joint_slice", "aux_hmc"])
def test_one_step_matches_the_reference(targets, sampler):
    sj, st, step_j, step_t = _pair("gp", sampler, targets)
    pj, pt = _params(sampler)
    sj, _, info_j = j_run_chains(step_j, sj, pj, 1)
    st, info_t = step_t(st, pt)
    _hold(sampler, "gp", sj, st, info_j, info_t, sampler)


def test_smc_toy_matches_the_reference_for_three_stages(targets,
                                                        monkeypatch):
    """``smc_toy``'s recipe (``aux_slice`` rejuvenation, 2 MCMC steps) at
    64 particles, ``ess_frac`` 0.9 for small steps of beta: each stage's
    resampling indices, the betas and the particles' keys after 3
    stages."""
    tj, tt = targets["toy"]
    n, stages = 64, 3
    seen_j, seen_t = [], []
    j_resample = j_smc_mod.systematic_resample_indices

    def j_recording(log_w, u01):
        idx = j_resample(log_w, u01)
        jax.debug.callback(lambda i: seen_j.append(np.asarray(i)), idx,
                           ordered=True)
        return idx

    t_resample = t_smc_mod.systematic_resample_indices

    def t_recording(log_w, u01):
        idx = t_resample(log_w, u01)
        seen_t.append(idx.numpy())
        return idx

    monkeypatch.setattr(j_smc_mod, "systematic_resample_indices",
                        j_recording)
    monkeypatch.setattr(t_smc_mod, "systematic_resample_indices",
                        t_recording)
    monkeypatch.setattr(t_smc_mod, "_MAX_STAGES", stages)
    run_j = j_smc_mod.make_smc(tj, J_SAMPLERS["aux_slice"], n,
                               ess_frac=0.9, max_stages=stages)
    states_j, diag_j = run_j(jax.random.key(SEED))
    jax.effects_barrier()
    keys_t = []
    run_t = t_smc_mod.make_smc(tt, SAMPLERS["aux_slice"], n, ess_frac=0.9)
    states_t, diag_t = run_t(
        SEED, on_stage=lambda s, b, st_, info: keys_t.append(st_.key))
    assert diag_j["n_stages"] == diag_t["n_stages"] == stages, (
        diag_j["betas"], diag_t["betas"])
    assert diag_t["betas"][-1] < 1.0
    np.testing.assert_allclose(diag_t["betas"], diag_j["betas"], rtol=0,
                               atol=1e-6)
    assert len(seen_j) == len(seen_t) == stages
    for s in range(stages):
        np.testing.assert_array_equal(seen_t[s], seen_j[s],
                                      err_msg=f"stage {s}")
    np.testing.assert_array_equal(keys_t[-1].numpy(), _words(states_j.key))
    np.testing.assert_allclose(states_t.theta.numpy(),
                               np.asarray(states_j.theta), rtol=0,
                               atol=1e-4)


# ------------------------------------------------------ layouts (spawned)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ckpt"))


@pytest.fixture(scope="module")
def toy_layouts(ckpt_dir):
    """The toy's 8 chains x 6 steps on 1, 2 and 4 chain shards; the 2-shard
    run checkpoints its state after 3 steps into ``ckpt_dir``."""
    return {w: spawn(key_ranks.toy_chains, w, 8, 6,
                     *((ckpt_dir, 3) if w == 2 else ()), timeout_s=300)
            for w in (1, 2, 4)}


def test_records_are_bitwise_equal_on_1_2_and_4_chain_shards(toy_layouts):
    base = toy_layouts[1][0]
    tt = t_toy(device="cpu", **key_ranks.TOY)
    whole = t_init(key_ranks.SEED, tt, 8, jitter_scale=0.5)
    from auxpm_tpu_torch.samplers.composite import make_aux_slice

    _, recs, _ = t_run_chains(make_aux_slice(tt, n_ess=2), whole,
                              key_ranks.TOY_PARAMS, 6)
    np.testing.assert_array_equal(base["theta"], recs["theta"].numpy())
    assert len(np.unique(base["n_probe"])) > 1
    for world in (2, 4):
        ranks = toy_layouts[world]
        for r in ranks:
            np.testing.assert_array_equal(r["theta"], base["theta"])
            np.testing.assert_array_equal(r["log_lik_hat"],
                                          base["log_lik_hat"])
        np.testing.assert_array_equal(
            np.concatenate([r["key"] for r in ranks]), base["key"])


def test_checkpoint_resumes_on_another_layout(toy_layouts, ckpt_dir):
    """3 steps on 2 chain shards, checkpoint, 3 more on 4 shards: bitwise
    the uninterrupted 4-shard run."""
    rest = spawn(key_ranks.toy_chains, 4, 8, 3, None, 0, ckpt_dir,
                 timeout_s=300)
    first, whole = toy_layouts[2][0], toy_layouts[4]
    for r in rest:
        np.testing.assert_array_equal(
            np.concatenate([first["theta"][:, :3], r["theta"]], axis=1),
            whole[r["rank"]]["theta"])
        np.testing.assert_array_equal(r["key"], whole[r["rank"]]["key"])


GP_KW = {"n_importance": 16, "jitter": 1e-3}
GP_PARAMS = {"ess_u": {}, "slice_theta": {"widths": 1.0, "max_step_out": 2,
                                          "max_shrink_chol": 3}}
MULTIHOST_ARGV = ["--preset", "gp_4096_sharded", "--device", "cpu",
                  "--chains", "8", "--subsample", "128", "--warmup-windows",
                  "0", "--window-steps", "2", "--steps", "2"]


@pytest.fixture(scope="module")
def two_nodes():
    """One spawn of two ranks on two emulated nodes (``GROUP_RANK`` 0 and
    1, ``LOCAL_WORLD_SIZE`` 1 of a world of 2): the particle-sharded GP
    chains, then ``--multihost`` through the CLI."""
    x, y = jload("pima", subsample=60)
    return x, y, spawn(key_ranks.two_nodes, 2,
                       (x, y, GP_KW, GP_PARAMS, 4, 3, 2),
                       MULTIHOST_ARGV + ["--multihost", "true"],
                       timeout_s=300, nodes=2)


def test_particle_sharded_run_matches_one_process(two_nodes, monkeypatch):
    """2 particle shards hold 8 of each chain's 16 rows: the same keys, the
    same u rows, the same decisions; values to rounding (the collective
    folds the estimate in another order)."""
    x, y, results = two_nodes
    ranks = [r[0] for r in results]
    monkeypatch.setenv("AUXPM_ESS_SWEEP", "0")
    monkeypatch.setenv("AUXPM_SIGMA_SWEEP", "0")
    tt = tmake(x, y, device="cpu", **GP_KW)
    st = t_init(key_ranks.SEED, tt, 4, jitter_scale=0.3)
    st, recs, infos = t_run_chains(SAMPLERS["aux_slice"](tt, n_ess=2), st,
                                   GP_PARAMS, 3)
    for r in ranks:
        np.testing.assert_array_equal(r["key"], st.key.numpy())
        for k, v in infos.items():
            np.testing.assert_array_equal(r["infos"][k], v.numpy(),
                                          err_msg=k)
        np.testing.assert_allclose(r["theta"], recs["theta"].numpy(),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(r["log_lik_hat"],
                                   recs["log_lik_hat"].numpy(), rtol=0,
                                   atol=2e-4)
        rows = slice(8 * r["rank"], 8 * (r["rank"] + 1))
        np.testing.assert_allclose(r["u"], st.u[:, rows].numpy(), rtol=0,
                                   atol=1e-5)
    np.testing.assert_array_equal(ranks[0]["theta"], ranks[1]["theta"])


def test_multihost_two_nodes_equal_one_process(two_nodes, capsys):
    """``--multihost true`` on the two emulated nodes, the preset
    ``gp_4096_sharded`` at a CPU size: records bitwise one process's."""
    port = dataclasses.asdict(PRESETS["gp_4096_sharded"])
    assert port.pop("device") == "cuda"
    assert port == dataclasses.asdict(J_PRESETS["gp_4096_sharded"])
    ranks = [r[1] for r in two_nodes[2]]
    one = {}
    assert trun.main(MULTIHOST_ARGV + ["--sharded", "false"], result=one) == 0
    capsys.readouterr()
    assert one["theta"].shape == (8, 2, 2)
    for r in ranks:
        np.testing.assert_array_equal(r["recorded_theta"], one["theta"])
        assert r["counts"]["threefry_calls"] > 0
    np.testing.assert_array_equal(
        np.concatenate([r["log_lik_hat"] for r in ranks]),
        one["states"].log_lik_hat.numpy())


def test_multihost_needs_a_world_that_spans_nodes(monkeypatch):
    with pytest.raises(ValueError, match="--sharded true"):
        unsupported(RunConfig().replace(multihost=True))
    unsupported(RunConfig().replace(multihost=True, sharded=True))
    for env in ({"RANK": "0", "WORLD_SIZE": "2", "LOCAL_WORLD_SIZE": "2",
                 "GROUP_RANK": "0"},                      # one node of two
                {"RANK": "0", "WORLD_SIZE": "2"}):        # no node at all
        for var in ("LOCAL_WORLD_SIZE", "GROUP_RANK", "LOCAL_RANK"):
            monkeypatch.delenv(var, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        with pytest.raises(RuntimeError, match="--nnodes"):
            distributed_init("cpu", multihost=True)
        with pytest.raises(RuntimeError, match="--nnodes"):
            trun.main(["--preset", "gp_4096_sharded", "--device", "cpu",
                       "--multihost", "true"])


def test_threefry_wrapper_on_cpu_keys_is_the_plain_version():
    keys = prng.split(prng.key(9), (2, 3))
    before = tfk.launches
    for mode in tfk.MODES:
        np.testing.assert_array_equal(
            tfk.threefry(keys, (4, 5), mode, offset=7).numpy(),
            tfk.draw_plain(keys, (4, 5), mode, offset=7).numpy())
    np.testing.assert_array_equal(
        tfk.threefry(keys[..., None, :], (), "words",
                     data=torch.arange(6)).numpy(),
        prng.fold_in(keys[..., None, :], torch.arange(6)).numpy())
    np.testing.assert_array_equal(prng.fold_in(keys, 2**32 + 3).numpy(),
                                  prng.fold_in(keys, 3).numpy())
    assert tfk.launches == before    # no kernel on the CPU
    # every public draw of core/prng on CPU keys is the plain version (what
    # the kernel is held to on the card), one plain cipher call each
    for fn, args, mode, lo, hi, off in (
            (prng.split, ((40, 50),), "words", 0.0, 1.0, 0),
            (prng.bits, ((40, 50), 3), "bits", 0.0, 1.0, 3),
            (prng.uniform, ((40, 50),), "uniform", 0.0, 1.0, 0),
            (prng.uniform, ((40, 50), -2.5, 3.7, 5), "uniform", -2.5, 3.7,
             5),
            (prng.normal, ((40, 50), 7), "normal", 0.0, 1.0, 7)):
        calls = tfk.plain_calls
        got = fn(keys, *args)
        assert tfk.plain_calls == calls + 1, mode
        assert torch.equal(got, tfk.draw_plain(keys, (40, 50), mode, lo, hi,
                                               off)), mode
    data = torch.arange(-3, 5)
    assert torch.equal(prng.fold_in(keys[..., None, :], data),
                       tfk.draw_plain(keys[..., None, :], (), "words",
                                      data=data))
    # a slice of a draw is the draw of the slice's counters
    full = prng.normal(keys, (6, 5))
    np.testing.assert_array_equal(prng.normal(keys, (2, 5), offset=15)
                                  .numpy(), full[..., 3:5, :].numpy())


def test_two_point_probe_in_two_calls_is_bitwise_one_call(monkeypatch):
    """Past ``MAX_PROBE_BATCH`` chains the step-out probe goes as two calls
    (config 4's 2 x 4096 Grams would not fit the card at once): the same
    numbers as one call, for the ell and the log_sigma probes."""
    from auxpm_tpu_torch.models import base as t_base
    from auxpm_tpu_torch.models import gp_classification as t_gp

    x, y = jload("pima", subsample=60)
    tt = tmake(x, y, n_importance=8, device="cpu")
    st = t_init(0, tt, 6, jitter_scale=0.3, with_cache=True)
    for i, (f, f2) in enumerate((
            tt.coord_estimators[0](st.theta, st.u),
            tt.coord_estimators_c[1](st.theta, st.u,
                                     st.extras["target_cache"]))):
        xs = torch.stack([st.theta[:, i] - 0.3, st.theta[:, i] + 0.2])
        one = f2(xs)
        with monkeypatch.context() as m:
            m.setattr(t_base, "MAX_PROBE_BATCH", 4)
            m.setattr(t_gp, "MAX_PROBE_BATCH", 4)
            two = f2(xs)
        assert all(torch.equal(a, b) for a, b in zip(one, two)), i
