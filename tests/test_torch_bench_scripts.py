"""The reference's three measuring scripts and their counterparts (CPU).

``scripts/tau_sweep.py``, ``scripts/theta_bench.py`` and
``scripts/ess_sweep_bench.py`` are loaded as they are (their module-level
compilation-cache settings are not applied: nothing is written outside the
checkout) and held against ``auxpm_tpu_torch/utils/{tau_sweep, theta_bench,
ess_sweep_bench}.py`` on a Pima subsample of 100 points padded to 128:

- ``initial_params`` and ``post_adapt`` of the port against the script's
  own functions for the three variants, quirks included (which groups are
  kept, which widths are mirrored);
- ``run_variant("aux_slice")`` of the port against the script's, with its
  globals ``CHAINS``, ``STEPS``, ``WARM_WINDOWS`` at 4, 50 and 1: both draw
  from seed 0 and the chains take the reference's keys, so the timed theta
  records agree within the bars of ``tests/test_torch_keys.py`` (1e-4) and
  tau and ESS to the rounding of the printed line; a failing variant prints
  ``FAILED`` and makes the port's ``main`` return 1;
- theta_bench: (a) against (b) bitwise on the port, the environment switch
  restored, and one step of the port's no-sweep ``aux_slice`` against the
  reference's on the same states (keys bitwise, decisions equal, values
  within 1e-4 / 2e-4), with and without the carried factor;
- ess_sweep_bench: the port's sweep against its per-probe path (shrink
  counts equal, u within 1e-5 and log L-hat within 2e-4 + 2e-6 |ll|: the
  ulp-level known difference of the two paths), and the port's per-probe
  step against the reference's ``make_ess_u`` on a target without the sweep.
"""

import dataclasses
import importlib.util
import os
import pathlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auxpm_tpu.core.state import init_chain_states as j_init
from auxpm_tpu.models.datasets import load as jload
from auxpm_tpu.models.gp_classification import make_gp_classification as jmake
from auxpm_tpu.samplers.composite import make_aux_slice as j_aux_slice
from auxpm_tpu.samplers.ess_u import make_ess_u as j_ess_u
from auxpm_tpu.utils.diagnostics import effective_sample_size as j_ess
from auxpm_tpu_torch.core.state import init_chain_states as t_init
from auxpm_tpu_torch.models.gp_classification import (
    make_gp_classification as tmake,
)
from auxpm_tpu_torch.samplers.ess_u import make_ess_u as t_ess_u
from auxpm_tpu_torch.utils import ess_sweep_bench, tau_sweep, theta_bench

ROOT = pathlib.Path(__file__).resolve().parent.parent
SUB = 100                         # Pima subsample, padded to 128
VARIANTS = ("aux_slice", "aux_slice_pcrd", "aux_slice_joint")
THETA_TOL, LL_TOL = 1e-4, 2e-4    # tests/test_torch_keys.py's GP bars
U_TOL, LL_RTOL = 1e-5, 2e-6       # sweep against loop: about an ulp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load_script(name):
    """``scripts/<name>.py`` as a module, its jax cache settings not
    applied."""
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.object(jax.config, "update"), \
            mock.patch.object(os, "makedirs"):
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return {n: _load_script(n) for n in ("tau_sweep", "theta_bench",
                                         "ess_sweep_bench")}


@pytest.fixture(scope="module")
def data():
    return jload("pima", subsample=SUB)


def _words(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _np(tree):
    """Params with every array as NumPy, for comparison."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    if isinstance(tree, jax.Array):
        return np.asarray(tree)
    return tree


def _assert_same_params(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_same_params(got[k], want[k])
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --------------------------------------------------------------- tau_sweep


@pytest.mark.parametrize("name", VARIANTS)
def test_initial_params_and_post_adapt_match_the_script(scripts, data, name):
    ref = scripts["tau_sweep"]
    x, y = data
    tj, tt = jmake(x, y, n_importance=8), tmake(x, y, n_importance=8,
                                                device="cpu")
    pj, pt = ref.initial_params(tj, name), tau_sweep.initial_params(tt, name)
    _assert_same_params(_np(pt), _np(pj))
    # what adapt_params hands over: every group a variant can have, with
    # adapted widths and stepping out switched on
    w = np.asarray([0.7, 1.3], np.float32)
    for groups in (("ess_u", "slice_theta"),
                   ("ess_u", "slice_theta", "slice_theta_rd"),
                   ("ess_u", "slice_theta", "joint_slice"),
                   ("ess_u", "slice_theta", "slice_theta_rd", "joint_slice")):
        def adapted(arr):
            p = {"ess_u": {},
                 "slice_theta": {"widths": arr(w), "max_step_out": 8}}
            if "slice_theta_rd" in groups:
                p["slice_theta_rd"] = {"widths": arr(2 * w),
                                       "max_step_out": 8}
            if "joint_slice" in groups:
                p["joint_slice"] = {"width": 1.7, "max_step_out": 8}
            return p

        got = tau_sweep.post_adapt(adapted(torch.tensor), name)
        want = ref.post_adapt(adapted(jnp.asarray), name)
        _assert_same_params(_np(got), _np(want))
    # a joint group without a width is given 2.0
    def widthless():
        return {"ess_u": {}, "slice_theta": {"widths": w, "max_step_out": 8},
                "joint_slice": {"max_step_out": 8}}

    _assert_same_params(tau_sweep.post_adapt(widthless(), name),
                        ref.post_adapt(widthless(), name))


def _recording(fn, into):
    def wrapped(theta):
        into.append(np.asarray(theta))
        return fn(theta)
    return wrapped


def test_run_variant_matches_the_script(scripts, data, monkeypatch, capsys):
    ref = scripts["tau_sweep"]
    x, y = data
    chains, steps, windows = 4, 50, 1
    monkeypatch.setattr(ref, "CHAINS", chains)
    monkeypatch.setattr(ref, "STEPS", steps)
    monkeypatch.setattr(ref, "WARM_WINDOWS", windows)
    seen_j, seen_t = [], []
    monkeypatch.setattr(ref, "effective_sample_size",
                        _recording(ref.effective_sample_size, seen_j))
    monkeypatch.setattr(tau_sweep, "effective_sample_size",
                        _recording(tau_sweep.effective_sample_size, seen_t))
    ref.run_variant("aux_slice", x, y)
    line_j = capsys.readouterr().out.strip().splitlines()[-1]
    got = tau_sweep.run_variant("aux_slice", x, y, chains=chains, steps=steps,
                                warm_windows=windows, device="cpu")
    line_t = capsys.readouterr().out.strip().splitlines()[-1]
    (th_j,), (th_t,) = seen_j, seen_t
    assert th_t.shape == th_j.shape == (chains, steps, 2)
    np.testing.assert_allclose(th_t, th_j, rtol=0, atol=THETA_TOL)
    ess_j = j_ess(th_j)
    np.testing.assert_allclose(got["ess"], ess_j, rtol=0, atol=0.05)
    np.testing.assert_allclose(got["tau"], chains * steps / ess_j, rtol=0,
                               atol=0.5)
    assert line_t.split("steps/s")[0] == line_j.split("steps/s")[0]


def test_a_failing_variant_prints_failed_and_main_exits_non_zero(
        monkeypatch, capsys):
    monkeypatch.setenv("TAU_VARIANTS", "no_such_sampler")
    assert tau_sweep.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert out.startswith("no_such_sampler    FAILED KeyError")


# ------------------------------------------------------------- theta_bench


@pytest.fixture(scope="module")
def gp_pair(data):
    x, y = data
    return jmake(x, y, n_importance=16), tmake(x, y, n_importance=16,
                                               device="cpu")


def test_theta_bench_cache_parity_is_bitwise_and_restores_the_switch(
        data, monkeypatch):
    monkeypatch.delenv("AUXPM_SIGMA_SWEEP", raising=False)
    x, y = data
    r = theta_bench.bench(x, y, chains=4, s=16, steps=2, device="cpu")
    assert r["parity_dth"] == 0.0 and r["parity_dll"] == 0.0
    assert "AUXPM_SIGMA_SWEEP" not in os.environ
    line = theta_bench.result_line(r)
    assert list(eval(line)) == [   # the reference's keys, in its order
        "baseline_ms", "cache_ms", "sigma_sweep_ms", "cap_ms",
        "cache_speedup", "total_speedup", "parity_dth", "parity_dll"]
    monkeypatch.setenv("AUXPM_SIGMA_SWEEP", "7")
    theta_bench.build_step(tmake(x, y, n_importance=8, device="cpu"), 1, 1,
                           sigma_sweep=False)
    assert os.environ["AUXPM_SIGMA_SWEEP"] == "7"


@pytest.mark.parametrize("with_cache", [False, True])
def test_theta_bench_nosweep_step_matches_the_reference(gp_pair, monkeypatch,
                                                        with_cache):
    tj, tt = gp_pair
    n_ess, extra = 4, 1
    monkeypatch.setenv("AUXPM_SIGMA_SWEEP", "0")
    step_j = j_aux_slice(tj, n_ess=n_ess, n_sigma_extra=extra)
    step_t = theta_bench.build_step(tt, n_ess, extra, sigma_sweep=False)
    pj = {"slice_theta": {"widths": jnp.asarray([0.24, 0.52], jnp.float32),
                          "max_step_out": 0}, "ess_u": {}}
    pt = {"slice_theta": {"widths": torch.tensor([0.24, 0.52]),
                          "max_step_out": 0}, "ess_u": {}}
    sj = j_init(jax.random.key(0), tj, 4, jitter_scale=0.3,
                with_cache=with_cache)
    st = t_init(0, tt, 4, jitter_scale=0.3, with_cache=with_cache)
    oj, ij = jax.vmap(lambda c: step_j(c, pj))(sj)
    ot, it = step_t(st, pt)
    np.testing.assert_array_equal(ot.key.numpy(), _words(oj.key))
    for k in ("ess_u/n_shrink", "ess_u/moved", "slice_theta/n_probe",
              "slice_theta/n_probe_chol"):
        np.testing.assert_array_equal(it[k].numpy(), np.asarray(ij[k]),
                                      err_msg=k)
    np.testing.assert_allclose(ot.theta.numpy(), np.asarray(oj.theta),
                               rtol=0, atol=THETA_TOL)
    np.testing.assert_allclose(ot.log_lik_hat.numpy(),
                               np.asarray(oj.log_lik_hat), rtol=0,
                               atol=LL_TOL)


# --------------------------------------------------------- ess_sweep_bench


def test_ess_sweep_bench_sweep_against_per_probe(data):
    x, y = data
    r = ess_sweep_bench.bench(x, y, chains=8, s=16, n_ess=4, steps=2,
                              device="cpu")
    assert r["max_dns"] == 0.0 and r["n_shrink_mean"] > 0
    assert r["max_du"] <= U_TOL
    assert r["max_dll"] <= LL_TOL + LL_RTOL * r["max_abs_ll"]
    assert list(eval(ess_sweep_bench.result_line(r))) == [
        "ess_only_sweep_ms", "ess_only_probe_ms", "aux_slice_sweep_ms",
        "aux_slice_probe_ms", "ess_speedup", "step_speedup", "max_du",
        "max_dll"]


def test_per_probe_ess_step_matches_the_reference(gp_pair):
    tj, tt = gp_pair
    lj = dataclasses.replace(tj, ess_sweep_factory=None)
    lt = dataclasses.replace(tt, ess_sweep_factory=None)
    step_j, step_t = j_ess_u(lj, n_repeats=4), t_ess_u(lt, n_repeats=4)
    assert not step_j.uses_sweep and not step_t.uses_sweep
    sj = j_init(jax.random.key(0), tj, 4, jitter_scale=0.3)
    st = t_init(0, tt, 4, jitter_scale=0.3)
    oj, ij = jax.vmap(lambda c: step_j(c, {}))(sj)
    ot, it = step_t(st, {})
    np.testing.assert_array_equal(ot.key.numpy(), _words(oj.key))
    for k in ("n_shrink", "moved"):
        np.testing.assert_array_equal(it[k].numpy(), np.asarray(ij[k]),
                                      err_msg=k)
    np.testing.assert_allclose(ot.u.numpy(), np.asarray(oj.u), rtol=0,
                               atol=U_TOL)
    np.testing.assert_allclose(ot.log_lik_hat.numpy(),
                               np.asarray(oj.log_lik_hat), rtol=0,
                               atol=LL_TOL)
