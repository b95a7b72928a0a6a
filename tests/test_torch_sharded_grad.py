"""PyTorch port vs the JAX package: gradients through the particle-group fold
(CPU, gloo).

HMC and NUTS on a particle-sharded target differentiate the collective
estimate: the fold's backward reaches each rank's own rows
(``parallel/collectives.py``: ``exp(lw_local - L)``, no collective) and
``particle_grad_sum`` adds the ranks' theta cotangents (one ``all_reduce``),
so every rank of a particle group holds bitwise the same gradient.  Every
2-rank case here runs in ONE spawn of two gloo ranks (one CPU thread each,
``tests/torch_grad_ranks.py``), fed inputs made here from seeds; the JAX side
runs in this process.

What is held to what:
- the fold's backward: the gradients of ``psum_logsumexp`` (S = 16, and
  S = 12, the GP target's fallback where S does not fit the 8-block tree)
  and ``allgather_blocked_logsumexp`` (S = 16, 4 local blocks) with respect
  to each rank's rows against ``torch.logsumexp``'s over the gathered rows,
  within 1e-6, and no collective in the backward;
- the sharded GP gradient (Pima n = 32 padded to 128, S = 16, 4 chains,
  jitter 1e-3; isotropic, ARD and S = 12): bitwise equal on both ranks;
  within 1e-5 of the largest entry of the port's unsharded gradient on the
  same u (measured ~1e-6: the theta sum adds two partials in gloo's order)
  and of ``jax.grad`` of the reference's UNSHARDED ``log_lik_est`` (the same
  function; ``jax.grad`` is not taken through ``shard_map``), the bar of
  ``tests/test_torch_grad.py``; the prior's part of the gradient is not
  summed over ranks; 2 collectives per gradient call (the fold and the theta
  sum), 3 at S = 12 (the generic fold's two);
- the Gaussian toy through the generic wrapper: bitwise on both ranks, the
  unsharded gradient within 1e-5; ``aux_hmc`` on it over two ranks through
  the CLI (128 chains, dual averaging) finds the exact posterior moments
  (the bars of ``tests/test_torch_hmc_nuts.py``: 5 standard errors on the
  mean, 35 % on the variance, R-hat < 1.15);
- one HMC and one NUTS ``apply`` per step on two ranks, fed the reference's
  states and draws for 3 steps (``tests/test_torch_hmc_nuts.py::
  test_apply_on_the_reference_draws``'s GP target, Pima n = 32, S = 8 split
  4 + 4): decisions identical to the reference's unsharded ``apply``, theta
  within 1e-4 and log L-hat within 2e-4, that test's bars;
- the Laplace estimator on two ranks (the counterpart of
  ``tests/test_distributed.py::test_particle_sharded_laplace_estimator_
  matches``: Pima n = 40 unpadded, S = 16): against the reference's
  ``shard_map`` estimate and the unsharded estimate, rtol 1e-4; its
  gradient bitwise on both ranks and within 1e-5 of the unsharded one;
- the CLI: ``--sharded true --particle-shards 2 --sampler aux_nuts`` with
  warm-up on two ranks: the ranks end bitwise equal, step sizes included;
  ``--proposal laplace`` with ``joint_mh`` on two ranks, bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auxpm_tpu.core.state import init_chain_states as j_init
from auxpm_tpu.models.datasets import load as jload
from auxpm_tpu.models.gaussian_toy import make_gaussian_toy as j_toy
from auxpm_tpu.models.gp_classification import make_gp_classification as jmake
from auxpm_tpu.samplers.chain import run_chains as j_run_chains
from auxpm_tpu_torch.models.gaussian_toy import make_gaussian_toy as t_toy
from auxpm_tpu_torch.models.gp_classification import (
    make_gp_classification as tmake,
)
from auxpm_tpu_torch.parallel.launch import spawn
from tests import torch_grad_ranks
from tests.test_torch_hmc_nuts import (
    CHAINS as APPLY_CHAINS,
    DECISIONS,
    KERNELS,
    MAX_DEPTH,
    PARAMS,
    STEPS as APPLY_STEPS,
    TOL,
    _moment_check,
)
from tests.test_torch_parallel import _reference_sharded_estimates

S, CHAINS, JITTER, K = 16, 4, 1e-3, 2
GRAD_RTOL = 1e-5          # of the largest entry (see the module note)
FOLD_TOL = 1e-6
LAPLACE_RTOL = 1e-4
TOY_CHAINS, TOY_WINDOW, TOY_STEPS = 128, 5, 30
CLI_ARGV = ["--sharded", "true", "--particle-shards", str(K), "--device",
            "cpu", "--sampler", "aux_nuts", "--chains", "2", "--subsample",
            "60", "--n-importance", str(S), "--warmup-windows", "1",
            "--window-steps", "2", "--steps", "2"]
LAPLACE_ARGV = ["--sharded", "true", "--particle-shards", str(K), "--device",
                "cpu", "--proposal", "laplace", "--subsample", "40",
                "--n-importance", "8", "--chains", "2", "--sampler",
                "joint_mh", "--warmup-windows", "0", "--window-steps", "2",
                "--steps", "2"]
TOY_ARGV = ["--sharded", "true", "--particle-shards", str(K), "--device",
            "cpu", "--target", "gaussian_toy", "--sampler", "aux_hmc",
            "--n-importance", str(S), "--chains", str(TOY_CHAINS),
            "--warmup-windows", "2", "--window-steps", str(TOY_WINDOW),
            "--steps", str(TOY_STEPS)]


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


def _grad(target, theta, u):
    th = _t(theta).requires_grad_(True)
    (g,) = torch.autograd.grad(target.log_lik_est(th, _t(u)).sum(), th)
    return g.numpy()


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ------------------------------------------------------------------ inputs


def _fold_cases():
    rng = np.random.default_rng(1)
    lw16 = (rng.standard_normal((CHAINS, 16)) * 3 - 40).astype(np.float32)
    lw12 = (rng.standard_normal((CHAINS, 12)) * 3 - 40).astype(np.float32)
    cot = rng.standard_normal(CHAINS).astype(np.float32)
    return {"psum_s16": (lw16, None, cot), "blocked_s16": (lw16, 4, cot),
            "psum_s12": (lw12, None, cot)}


def _grad_cases():
    x, y = jload("pima", subsample=32)
    x40, y40 = jload("pima", subsample=40)
    rng = np.random.default_rng(5)
    th2 = (rng.normal(size=(CHAINS, 2)) * 0.3).astype(np.float32)
    th8 = (rng.normal(size=(CHAINS, 8)) * 0.3).astype(np.float32)

    def u(s, n):
        return rng.standard_normal((CHAINS, s, n)).astype(np.float32)

    kw = {"n_importance": S, "jitter": JITTER}
    lap = {"n_importance": S, "jitter": JITTER, "proposal": "laplace",
           "pad_to_tiles": False}
    return {   # name -> (target spec, theta, u)
        "iso": (("gp", x, y, kw), th2, u(S, 128)),
        "ard": (("gp", x, y, {**kw, "ard": True}), th8, u(S, 128)),
        "s12": (("gp", x, y, {**kw, "n_importance": 12}), th2, u(12, 128)),
        "toy": (("gaussian_toy", {"n_importance": 8}), th2, u(8, 2)),
        "laplace": (("gp", x40, y40, lap), th2, u(S, 40)),
    }


@pytest.fixture(scope="module")
def apply_cases():
    """The reference's HMC and NUTS on ``test_torch_hmc_nuts``'s GP target,
    one step per call for 3 steps: per kernel and step the state fed in,
    the draws it consumed, the next state and the infos."""
    x, y = jload("pima", subsample=32)
    tj = jmake(x, y, n_importance=8, jitter=1e-3)
    spec = ("gp", x, y, {"n_importance": 8, "jitter": 1e-3})
    cases = {}
    for kernel in sorted(KERNELS):
        j_make, _, rows_one = KERNELS[kernel]
        params = PARAMS["gp"][kernel]
        step_j = j_make(tj)
        rows_fn = jax.jit(jax.vmap(lambda k: rows_one(k, tj.d)))
        state = j_init(jax.random.key(7), tj, APPLY_CHAINS, jitter_scale=0.5)
        for s in range(APPLY_STEPS):
            nxt, _, info = j_run_chains(step_j, state, params, 1)
            cases[(kernel, s)] = {
                "state": {"theta": np.asarray(state.theta),
                          "u": np.asarray(state.u),
                          "log_lik_hat": np.asarray(state.log_lik_hat)},
                "rows": torch_grad_ranks.as_int64(rows_fn(state.key)),
                "next": nxt, "info": info, "params": params}
            state = nxt
    kw = {"max_depth": MAX_DEPTH}
    jobs = [("apply", spec, kernel, c["state"], c["rows"], c["params"],
             kw if kernel == "nuts" else None)
            for (kernel, _), c in sorted(cases.items())]
    return cases, jobs


@pytest.fixture(scope="module")
def ranks(apply_cases):
    """Every 2-rank case, one spawn: ``{job name: [rank 0, rank 1]}``."""
    _, apply_jobs = apply_cases
    jobs = {f"fold_{k}": ("fold", *v) for k, v in _fold_cases().items()}
    for name, (spec, theta, u) in _grad_cases().items():
        jobs[f"grad_{name}"] = ("grad", spec, theta, u)
    spec, theta, u = _grad_cases()["laplace"]
    jobs["estimate_laplace"] = ("estimate", spec, theta, u)
    for i, job in enumerate(apply_jobs):
        jobs[f"apply_{i}"] = job
    jobs["cli_nuts"] = ("cli", CLI_ARGV)
    jobs["cli_toy"] = ("cli", TOY_ARGV)
    jobs["cli_laplace"] = ("cli", LAPLACE_ARGV)
    out = spawn(torch_grad_ranks.run_jobs, K, list(jobs.values()), K,
                timeout_s=500)
    return {name: [r[i] for r in out] for i, name in enumerate(jobs)}


def _bitwise(per_rank, keys):
    for r in per_rank[1:]:
        for key in keys:
            np.testing.assert_array_equal(r[key], per_rank[0][key],
                                          err_msg=key)


# ---------------------------------------------------------------- the fold


@pytest.mark.parametrize("case", sorted(_fold_cases()))
def test_fold_backward_is_the_global_softmax_on_local_rows(ranks, case):
    lw, _, cot = _fold_cases()[case]
    full = torch.tensor(lw, requires_grad=True)
    want = torch.logsumexp(full, -1)
    (g_want,) = torch.autograd.grad(want, full, torch.tensor(cot))
    per_rank = ranks[f"fold_{case}"]
    _bitwise(per_rank, ["value"])
    for r in per_rank:
        a, b = r["rows"]
        np.testing.assert_allclose(r["value"], want.detach().numpy(),
                                   rtol=FOLD_TOL)
        np.testing.assert_allclose(r["grad"], g_want[:, a:b].numpy(),
                                   rtol=0, atol=FOLD_TOL)
        assert r["backward_collectives"] == 0
    assert [r["rows"] for r in per_rank] == [(0, lw.shape[1] // 2),
                                             (lw.shape[1] // 2, lw.shape[1])]


# ------------------------------------------------------- the GP gradient


@pytest.mark.parametrize("name", ["iso", "ard", "s12"])
def test_sharded_gp_gradient(ranks, name):
    spec, theta, u = _grad_cases()[name]
    _, x, y, kw = spec
    per_rank = ranks[f"grad_{name}"]
    assert per_rank[0]["target"].endswith("@particles")
    _bitwise(per_rank, ["estimate", "grad", "grad_post"])
    got = per_rank[0]["grad"]
    assert got.shape == theta.shape and np.isfinite(got).all()
    tt = tmake(x, y, device="cpu", **kw)
    assert _rel(got, _grad(tt, theta, u)) < GRAD_RTOL
    tj = jmake(x, y, **kw)
    gj = np.asarray(jax.jit(jax.vmap(jax.grad(tj.log_lik_est)))(
        jnp.asarray(theta), jnp.asarray(u)))
    assert _rel(got, gj) < GRAD_RTOL, _rel(got, gj)
    # the prior's gradient is added once, not once per rank
    th = _t(theta).requires_grad_(True)
    (g_prior,) = torch.autograd.grad(tt.log_prior(th).sum(), th)
    np.testing.assert_allclose(per_rank[0]["grad_post"] - got,
                               g_prior.numpy(), rtol=0, atol=1e-5)
    # per gradient call (the job makes two): the fold and the theta sum,
    # the generic fold's max and sum at S = 12
    per_call = 3 if name == "s12" else 2
    assert per_rank[0]["counts"]["collectives"] == 2 * per_call


def test_toy_gradient_through_the_generic_wrapper(ranks):
    _, theta, u = _grad_cases()["toy"]
    per_rank = ranks["grad_toy"]
    assert per_rank[0]["target"] == "gaussian_toy@particles"
    _bitwise(per_rank, ["estimate", "grad", "grad_post"])
    tt, tj = t_toy(n_importance=8, device="cpu"), j_toy(n_importance=8)
    assert _rel(per_rank[0]["grad"], _grad(tt, theta, u)) < GRAD_RTOL
    gj = np.asarray(jax.jit(jax.vmap(jax.grad(tj.log_lik_est)))(
        jnp.asarray(theta), jnp.asarray(u)))
    assert _rel(per_rank[0]["grad"], gj) < GRAD_RTOL


def test_aux_hmc_on_the_sharded_toy_finds_the_exact_moments(ranks):
    per_rank = ranks["cli_toy"]
    _bitwise(per_rank, ["theta", "log_lik_hat", "recorded_theta"])
    r = per_rank[0]
    assert r["target"] == "gaussian_toy@particles"
    assert r["u_shape"] == (TOY_CHAINS, S // K, 2)
    assert r["step_sizes"]["hmc"] == per_rank[1]["step_sizes"]["hmc"]
    # the fold's two collectives and the theta sum per gradient call
    assert r["grad_collectives"] == 3 * r["grad_calls"] > 0
    tt = t_toy(n_importance=S, device="cpu")
    theta = r["recorded_theta"].astype(np.float64)
    assert theta.shape == (TOY_CHAINS, TOY_STEPS, 2)
    _moment_check(theta, tt.posterior_mean.double().numpy(),
                  tt.posterior_cov.double().numpy(), "sharded toy aux_hmc")


# ------------------------------------------- HMC and NUTS apply, two ranks


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_apply_on_the_reference_draws_on_two_ranks(ranks, apply_cases,
                                                   kernel):
    cases, _ = apply_cases
    names = sorted(cases)
    seen = []
    for s in range(APPLY_STEPS):
        c = cases[(kernel, s)]
        per_rank = ranks[f"apply_{names.index((kernel, s))}"]
        _bitwise(per_rank, ["theta", "log_lik_hat"])
        _bitwise([r["info"] for r in per_rank], list(per_rank[0]["info"]))
        r = per_rank[0]
        assert set(r["info"]) == set(c["info"])
        for key, got in r["info"].items():
            want = np.asarray(c["info"][key])[:, 0]
            if key in DECISIONS:
                np.testing.assert_array_equal(got, want, err_msg=key)
                seen.append(want)
            else:
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=TOL["gp"]["accept_prob"],
                                           err_msg=key)
        np.testing.assert_allclose(r["theta"], np.asarray(c["next"].theta),
                                   rtol=0, atol=TOL["gp"]["theta"])
        np.testing.assert_allclose(r["log_lik_hat"],
                                   np.asarray(c["next"].log_lik_hat),
                                   rtol=0, atol=TOL["gp"]["ll"])
        # two collectives per gradient call on both ranks
        assert r["grad_collectives"] == 2 * r["grad_calls"] > 0
        assert per_rank[1]["grad_calls"] == r["grad_calls"]
    assert len(np.unique(np.concatenate(seen))) > 1   # not all one decision


# ------------------------------------------------------------ Laplace


def test_sharded_laplace_estimator_matches_reference_and_unsharded(ranks):
    spec, theta, u = _grad_cases()["laplace"]
    _, x, y, kw = spec
    per_rank = ranks["estimate_laplace"]
    assert per_rank[0]["target"].endswith("_laplace@particles")
    _bitwise(per_rank, ["estimate"])
    got = per_rank[0]["estimate"]
    tt = tmake(x, y, device="cpu", **kw)
    with torch.no_grad():
        unsharded = tt.log_lik_est(_t(theta), _t(u)).numpy()
    np.testing.assert_allclose(got, unsharded, rtol=LAPLACE_RTOL)
    want = _reference_sharded_estimates(jmake(x, y, **kw), theta, u, K)
    np.testing.assert_allclose(got, want, rtol=LAPLACE_RTOL)
    # its gradient (the Newton fit replicated, the rows folded)
    grads = ranks["grad_laplace"]
    _bitwise(grads, ["estimate", "grad"])
    np.testing.assert_array_equal(grads[0]["estimate"], got)
    assert _rel(grads[0]["grad"], _grad(tt, theta, u)) < GRAD_RTOL


def test_cli_sharded_laplace_with_a_non_gradient_sampler(ranks):
    """``--proposal laplace --sharded true --particle-shards 2`` through the
    CLI with ``joint_mh`` (a pCN move of u on each rank's rows, one
    collective estimate per proposal)."""
    per_rank = ranks["cli_laplace"]
    _bitwise(per_rank, ["theta", "log_lik_hat", "recorded_theta"])
    r = per_rank[0]
    assert r["target"].endswith("_laplace@particles")
    assert r["u_shape"] == (2, 4, 128)
    assert np.isfinite(r["recorded_theta"]).all()
    assert r["counts"]["collectives"] > 0 and r["grad_calls"] == 0


# ---------------------------------------------------------------- the CLI


def test_cli_sharded_aux_nuts_with_warmup(ranks):
    per_rank = ranks["cli_nuts"]
    _bitwise(per_rank, ["theta", "log_lik_hat", "recorded_theta"])
    r = per_rank[0]
    assert r["target"].endswith("@particles")
    assert r["u_shape"] == (2, S // K, 128)
    assert np.isfinite(r["recorded_theta"]).all()
    assert r["recorded_theta"].shape == (2, 2, 2)
    eps = [p["step_sizes"]["nuts"] for p in per_rank]
    assert eps[0] == eps[1] and eps[0] != 0.3      # adapted, the same
    assert r["grad_collectives"] == 2 * r["grad_calls"] > 0
    assert r["counts"]["collectives"] > r["grad_collectives"]   # + the ESS
    assert r["summary"]["chain_steps_per_sec"] > 0
