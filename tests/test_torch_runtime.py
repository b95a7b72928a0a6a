"""The port's run-time tools (CPU): checkpoint and bitwise resume, the debug
checks, the figures and the profiler trace, and the CLI with all of them.

Resume: k steps, save, load into a fresh state and k more steps must give
bitwise the theta, u, log L̂ and carried factor of 2k uninterrupted steps,
because every chain's key is in the checkpoint.  The debug tests are
those of ``tests/test_debug_modes.py``, ported.  The CLI test is the port's
counterpart of ``tests/test_cli_and_plots.py::test_cli_toy_preset_end_to_end``
with ``--profile-dir`` added.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from auxpm_tpu.models.datasets import load as jload
from auxpm_tpu_torch import run as trun
from auxpm_tpu_torch.core.state import init_chain_states
from auxpm_tpu_torch.models.gaussian_toy import make_gaussian_toy
from auxpm_tpu_torch.models.gp_classification import make_gp_classification
from auxpm_tpu_torch.samplers.chain import run_chains
from auxpm_tpu_torch.samplers.composite import SAMPLERS, make_aux_slice
from auxpm_tpu_torch.utils import plots
from auxpm_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from auxpm_tpu_torch.utils.debug import (
    ERR_LOGLIK_NONFINITE,
    ERR_THETA_NONFINITE,
    ERR_U_NONFINITE,
    assert_finite_state,
    checked_step,
    throw_on_errors,
)

K = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs several workers
    on the same cores, where multi-threaded small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gp():
    x, y = jload("pima", subsample=100)
    return make_gp_classification(x, y, n_importance=8, device="cpu")


CASES = {
    # name: (target factory, sampler, sampler kwargs, params, carried factor)
    "toy_pm_mh": (lambda: make_gaussian_toy(n_importance=16, device="cpu"),
                  "pm_mh", {}, {"step_size": 0.6}, False),
    "gp_aux_slice": (_gp, "aux_slice", {"n_ess": 2, "n_sigma_extra": 1},
                     {"ess_u": {}, "slice_theta": {
                         "widths": torch.tensor([1.0, 0.8]),
                         "max_step_out": 2, "max_shrink_chol": 3}}, True),
    "gp_aux_mh": (_gp, "aux_mh", {}, {"ess_u": {},
                                      "mh_theta": {"step_size": 0.3}}, False),
}


def _assert_states_bitwise(a, b):
    for name in ("theta", "u", "log_lik_hat"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert a.extras.keys() == b.extras.keys()
    if "target_cache" in a.extras:
        assert torch.equal(a.extras["target_cache"]["chol_r"],
                           b.extras["target_cache"]["chol_r"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_resume_is_bitwise(case, tmp_path):
    make_target, sampler, kw, params, cached = CASES[case]
    target = make_target()
    step = SAMPLERS[sampler](target, **kw)

    def fresh():
        return init_chain_states(5, target, 3, jitter_scale=0.3,
                                 with_cache=cached)

    whole, recs_whole, _ = run_chains(step, fresh(), params, 2 * K)
    half, _, _ = run_chains(step, fresh(), params, K)
    config = {"case": case, "chains": 3}
    save_checkpoint(tmp_path, half, step=K, config=config, params=params)
    del half
    # the example state is another seed's: nothing of it may leak through
    example = init_chain_states(99, target, 3, with_cache=cached)
    loaded, at, params_l = load_checkpoint(tmp_path, example, config=config)
    assert at == K and os.listdir(tmp_path) == ["shard_0.npz"]
    assert params_l.keys() == params.keys()
    for group, sub in params.items():
        if isinstance(sub, dict):
            for k_, v in sub.items():
                got = params_l[group][k_]
                assert (torch.equal(got, v) if torch.is_tensor(v)
                        else got == v), (group, k_)
    assert not torch.equal(loaded.key, example.key)   # the keys came back
    rest, recs_rest, _ = run_chains(step, loaded, params_l, K)
    _assert_states_bitwise(rest, whole)
    assert torch.equal(recs_rest["theta"], recs_whole["theta"][:, K:])
    assert not torch.equal(whole.theta, fresh().theta)   # the chains moved


def test_checkpoint_refuses_another_config_or_layout(tmp_path):
    target = make_gaussian_toy(n_importance=16, device="cpu")
    st = init_chain_states(1, target, 2)
    save_checkpoint(tmp_path, st, step=4, config={"seed": 1})
    with pytest.raises(ValueError, match="config hash mismatch"):
        load_checkpoint(tmp_path, st, config={"seed": 2})
    # the same config loads; no config skips the check
    assert load_checkpoint(tmp_path, st, config={"seed": 1})[1] == 4
    assert load_checkpoint(tmp_path, st)[1] == 4
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(tmp_path, init_chain_states(1, target, 3))


def test_cli_checkpoint_resumes_bitwise(tmp_path, capsys):
    """The CLI's checkpoint (every window, the last one kept) of a 4-step
    run, loaded and run 4 more steps with the checkpoint's params, is
    bitwise the final state of the same run at 8 steps."""
    common = ["--device", "cpu", "--chains", "3", "--subsample", "100",
              "--n-importance", "8", "--window-steps", "2",
              "--warmup-windows", "1", "--max-step-out", "0", "--n-ess", "2",
              "--n-sigma-extra", "1", "--max-shrink-chol", "3"]
    short, long_ = {}, {}
    ckpt = tmp_path / "ckpt"
    assert trun.main(common + ["--steps", "4", "--checkpoint-dir", str(ckpt),
                               "--checkpoint-every", "1"], result=short) == 0
    assert trun.main(common + ["--steps", "8"], result=long_) == 0
    capsys.readouterr()
    loaded, at, params = load_checkpoint(ckpt, short["states"],
                                         config=short["config"])
    assert at == 4
    _assert_states_bitwise(loaded, short["states"])
    rest, _, _ = run_chains(short["step"], loaded, params, 4)
    _assert_states_bitwise(rest, long_["states"])


# ------------------------------------------------------------------- debug


PARAMS = {"slice_theta": {"widths": 1.0}}


def _toy_states():
    target = make_gaussian_toy(n_importance=8, device="cpu")
    return target, init_chain_states(0, target, 4)


def test_checked_step_clean_run():
    target, states = _toy_states()
    step = checked_step(make_aux_slice(target))
    new_states, info = step(states, PARAMS)
    throw_on_errors(info)  # no error on a healthy kernel
    assert torch.isfinite(new_states.theta).all()
    assert (info["error_flags"] == 0).all()
    assert info["error_flags"].dtype == torch.int32
    # the wrapper keeps the transition's halves, and apply adds the flags
    rows, _ = step.stages["ess_u"].draw(states)
    assert rows["scal"].shape[0] == 4
    _, run_infos = run_chains(step, states, PARAMS, 2)[1:]
    assert (run_infos["error_flags"] == 0).all()


def test_checked_step_catches_nan():
    target, states = _toy_states()
    step = checked_step(make_aux_slice(target))
    # poison the cached estimate -> log_y = nan -> slice never accepts and
    # the carried log_lik_hat stays non-finite
    states = states.replace(
        log_lik_hat=torch.full_like(states.log_lik_hat, float("nan")))
    _, info = step(states, PARAMS)
    assert ((info["error_flags"] & ERR_LOGLIK_NONFINITE) != 0).all()
    with pytest.raises(FloatingPointError):
        throw_on_errors(info)
    # each part of the state has its own bit
    bad = states.replace(
        log_lik_hat=torch.zeros(4),
        theta=states.theta.index_put((torch.tensor([1]), torch.tensor([0])),
                                     torch.tensor(float("inf"))),
        u=states.u.index_put((torch.tensor([2]),), torch.tensor(float("nan"))))
    ident = checked_step(lambda s, p: (s, {}))
    flags = ident(bad, {})[1]["error_flags"]
    assert flags.tolist() == [0, ERR_THETA_NONFINITE, ERR_U_NONFINITE, 0]


def test_assert_finite_state():
    target, states = _toy_states()
    assert_finite_state(states)  # clean
    bad = states.replace(theta=states.theta.index_put(
        (torch.tensor([0]), torch.tensor([0])), torch.tensor(float("inf"))))
    with pytest.raises(FloatingPointError, match="theta"):
        assert_finite_state(bad)
    gp = _gp()
    cached = init_chain_states(0, gp, 2, with_cache=True)
    assert_finite_state(cached)
    chol = cached.extras["target_cache"]["chol_r"].clone()
    chol[0, 0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="chol_r"):
        assert_finite_state(cached.replace(
            extras={"target_cache": {"chol_r": chol}}))


# ------------------------------------------------------- figures and the CLI


def test_cli_toy_preset_end_to_end(tmp_path, capsys):
    metrics = tmp_path / "metrics.jsonl"
    figs = tmp_path / "fig"
    prof = tmp_path / "prof"
    rc = trun.main([
        "--preset", "toy_pm_mh", "--device", "cpu",
        "--chains", "8",
        "--steps", "200",
        "--window-steps", "50",
        "--warmup-windows", "1",
        "--metrics-path", str(metrics),
        "--plots", str(figs),
        "--profile-dir", str(prof),
    ])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["phase"] == "summary"
    assert len(summary["posterior_mean"]) == 2
    assert summary["ess_per_sec"] > 0
    assert all(np.isfinite(summary["posterior_mean"]))
    # JSONL metrics written for warmup + sample windows + summary
    lines = [json.loads(l) for l in metrics.read_text().splitlines()]
    assert [l["phase"] for l in lines] == ["warmup"] + ["sample"] * 4 + [
        "summary"]
    assert 0 < lines[1]["accept"] < 1 and lines[1]["log_accept_ratio"] <= 0
    # figures on disk
    for suffix in ("trace", "density", "autocorr"):
        p = f"{figs}_{suffix}.png"
        assert os.path.exists(p) and os.path.getsize(p) > 1000, p
    # the Chrome trace of the main run holds its operators
    trace = json.loads((prof / "trace_rank0.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)


def test_plots_without_matplotlib_name_it(monkeypatch):
    for mod in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        plots.trace_plot(np.zeros((2, 10, 2)))
    # the autocorrelation is NumPy only
    ac = plots.autocorrelation(np.sin(np.arange(100.0)), max_lag=5)
    assert ac.shape == (6,) and ac[0] == 1.0
