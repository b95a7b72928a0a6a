"""PyTorch port vs the JAX package: ``utils/smc_scale`` (config 5 at scale).

- the toy at 1024 key-as-u particles (``--rejuv aux_slice``, ``--device
  cpu``, one spawned gloo rank) against the reference's ``make_smc_sharded``
  built with the arguments ``smc_1m_bench.py`` passes, on a one-device JAX
  mesh, from the same seed: the stage count equal, betas within 1e-6, logZ
  within 1e-5 (the bars of ``test_keyed_run_matches_the_reference``), the
  refresh acceptances equal; the line's keys are the reference script's
  (read from its source) plus the port's named additions;
- the GP path (Pima subsample 32, S = 32, ``aux_nuts``) at 64 particles:
  finite, the last beta 1;
- the refusals: ``--device cuda`` without a GPU, no particles, more
  particles than the resampling's float32 positions count exactly
  (``--no-pad`` is taken on the card);
- ``utils/smc_init``: the first beta it reports is the runner's own, and the
  highest particle of the GP path's seed-0 population at 2^20 (slot 723769,
  log L-hat -7.52, which sets that run's first beta: ``PERF.md`` §6)
  is the reference's particle too.
"""

import ast
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from auxpm_tpu.models.datasets import load as jload
from auxpm_tpu.models.gaussian_toy import make_gaussian_toy as j_toy
from auxpm_tpu.models.gp_classification import make_gp_classification as jmake
from auxpm_tpu.parallel.mesh import make_mesh as j_mesh
from auxpm_tpu.samplers.composite import THETA_ONLY as J_THETA_ONLY
from auxpm_tpu.samplers.smc_sharded import make_smc_sharded as j_smc_sharded
from auxpm_tpu_torch.core import prng
from auxpm_tpu_torch.models.gaussian_toy import make_gaussian_toy as t_toy
from auxpm_tpu_torch.models.gp_classification import (
    make_gp_classification as tmake,
)
from auxpm_tpu_torch.parallel.mesh import Mesh
from auxpm_tpu_torch.parallel.resampling import (
    MAX_PARTICLES,
    systematic_resample_indices,
)
from auxpm_tpu_torch.samplers.composite import THETA_ONLY
from auxpm_tpu_torch.samplers.smc_sharded import make_smc_sharded
from auxpm_tpu_torch.utils import smc_init, smc_scale

REPO = Path(__file__).resolve().parents[1]
TOY_ARGV = ["--target", "toy", "--particles", "1024", "--rejuv", "aux_slice",
            "--device", "cpu"]
GP_ARGV = ["--target", "gp", "--subsample", "32", "--n-importance", "32",
           "--rejuv", "aux_nuts", "--particles", "64", "--rejuv-batch", "32",
           "--device", "cpu"]
PORT_KEYS = {"device", "rejuv_batch", "chunks_per_stage", "peak_memory_gb",
             "per_stage", "padded"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_keys():
    """The keys of the JSON line ``smc_1m_bench.py`` prints: its ``out``
    dict literal and the keys it adds for the toy."""
    tree = ast.parse((REPO / "smc_1m_bench.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name) and tgt.id == "out" and \
                    isinstance(node.value, ast.Dict):
                keys.update(k.value for k in node.value.keys)
            if isinstance(tgt, ast.Subscript) and \
                    isinstance(tgt.value, ast.Name) and tgt.value.id == "out":
                keys.add(tgt.slice.value)
    return keys


def _run(argv, capsys):
    result = {}
    assert smc_scale.main(argv, result=result) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == result["out"]
    return result


def test_toy_matches_the_reference(capsys):
    res = _run(TOY_ARGV, capsys)
    out, diag = res["out"], res["diag"]
    # smc_1m_bench.py: make_gaussian_toy(n_importance=16), THETA_ONLY
    # ["slice_theta"], make_mesh(n_particle_shards=1) (here one device),
    # n_mcmc 1, ess_frac 0.5, carry_u False, n_u_mh 2, rejuv_batch 4096,
    # time_stages, rejuv_dispatches 1, u_blocks 1, no checkpoint
    ref = j_smc_sharded(
        j_toy(n_importance=16), J_THETA_ONLY["slice_theta"], 1024,
        j_mesh(n_chains_shards=1, devices=jax.devices()[:1]), n_mcmc=1,
        ess_frac=0.5, carry_u=False, n_u_mh=2, rejuv_batch=4096,
        time_stages=True, rejuv_dispatches=1, u_blocks=1,
        checkpoint_dir=None)
    _, diag_j = ref(jax.random.key(0))
    assert diag["n_stages"] == diag_j["n_stages"] == out["n_stages"]
    np.testing.assert_allclose(diag["betas"], diag_j["betas"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(diag["log_z"], diag_j["log_z"], rtol=0,
                               atol=1e-5)
    assert diag["u_mh_accept"] == [float(a) for a in diag_j["u_mh_accept"]]
    assert set(out) == _reference_keys() | PORT_KEYS
    assert out["log_z_true"] == round(smc_scale.toy_log_evidence(), 4) \
        == -3.5588                                   # SMC_1M_toy.json
    assert out["rejuvenation"] == "slice_theta (theta-only, carry_u=False)"
    assert out["devices"] == 1 and out["particles"] == 1024
    assert out["rejuv_batch"] == 1024 and out["chunks_per_stage"] == 1
    assert out["peak_memory_gb"] is None and out["device"] == "cpu"
    assert [s["stage"] for s in out["per_stage"]] == \
        list(range(-1, out["n_stages"]))
    assert len(out["stage_wall"]) == out["n_stages"] and out["init_wall"] > 0


def test_gp_path_is_finite(capsys):
    out = _run(GP_ARGV, capsys)["out"]
    assert out["target"] == "gp_logistic_n32"
    assert out["betas"][-1] == 1.0 and np.isfinite(out["log_z"])
    assert np.isfinite(out["posterior_mean"]).all()
    assert np.isfinite(out["posterior_std"]).all()
    assert len(out["u_mh_accept"]) == out["n_stages"]
    assert "log_z_true" not in out
    assert out["rejuv_batch"] == 32 and out["chunks_per_stage"] == 2
    assert out["rejuvenation"] == "nuts (theta-only, carry_u=False)"
    # NUTS counts its host reads (one per tree depth)
    assert sum(s["host_reads"] for s in out["per_stage"]) > 0


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        smc_scale.main(["--target", "toy", "--particles", "64"])


def test_unpadded_gp_is_taken_on_the_card():
    """``--no-pad`` runs on the card as on the CPU (the estimator kernels
    take any n, the factorisation pads with the identity); what stays
    refused is a run with no particles."""
    args = smc_scale.parse_args(["--target", "gp", "--no-pad"])
    smc_scale.check_args(args)
    for bad in (["--particles", "0"], ["--rejuv-batch", "0"]):
        with pytest.raises(ValueError, match="positive"):
            smc_scale.check_args(smc_scale.parse_args(
                ["--target", "gp", "--no-pad", *bad]))


def test_past_the_float32_positions_is_refused():
    mesh = Mesh(rank=0, world=1, n_chain_shards=1, n_particle_shards=1,
                chain_index=0, particle_index=0, particle_group=None,
                chain_group=None)
    with pytest.raises(ValueError, match="exact only up to"):
        make_smc_sharded(t_toy(device="cpu"), THETA_ONLY["slice_theta"],
                         MAX_PARTICLES + 1, mesh, carry_u=False)
    with pytest.raises(ValueError, match="exact only up to"):
        systematic_resample_indices(torch.zeros(MAX_PARTICLES + 1),
                                    torch.tensor(0.5))


def test_smc_init_reports_the_runners_first_beta(capsys):
    assert smc_init.main(TOY_ARGV) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    res = _run(TOY_ARGV, capsys)
    assert out["first_beta"] == res["diag"]["betas"][1]
    assert 0 < out["first_beta_without_the_top_particle"] < 1
    assert len(out["top"]) == smc_init.TOP and out["top"][0]["log_lik"] == \
        out["log_lik_quantiles"]["1.0"]
    assert out["top"][0]["expected_copies_at_first_beta"] > 1


OUTLIER_SLOT = 723769   # the GP path's seed-0 population at 2^20


def test_the_seed0_outlier_is_the_references_particle():
    """Slot g of the key-as-u init: ``k = fold_in(k_init, g)``, ``k_t, k_u,
    k_carry = split(k, 3)``, theta from ``k_t``, u = ``normal(k_u)``, in
    both packages (``k_init`` the first half of ``split(key(seed))``)."""
    x, y = jload("pima", subsample=32, seed=0)
    tj = jmake(x, y, n_importance=32)
    k_init = jax.random.split(jax.random.key(0))[0]
    kj = jax.random.split(jax.random.fold_in(k_init, OUTLIER_SLOT), 3)
    th_j = tj.sample_prior(kj[0])
    ll_j = float(tj.log_lik_est(th_j, jax.random.normal(kj[1], tj.u_shape)))
    tt = tmake(x, y, n_importance=32, device="cpu")
    k_init_t = prng.split(prng.key(0), 2)[0]
    kt = prng.split(prng.fold_in(k_init_t, torch.tensor([OUTLIER_SLOT])), 3)
    th_t = tt.sample_prior_key(kt[:, 0])
    ll_t = float(tt.log_lik_est(th_t, prng.normal(kt[:, 1], tt.u_shape))[0])
    np.testing.assert_allclose(th_t[0].numpy(), np.asarray(th_j), rtol=0,
                               atol=1e-6)
    assert abs(ll_t - ll_j) < 2e-4 and abs(ll_t + 7.5215) < 1e-3
