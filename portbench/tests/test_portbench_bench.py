"""The benchmark's CPU tests: lookup by name, the yardstick's arithmetic,
the reference against the port, the result line, the controls and the
faults, and that nothing loads JAX.  Run: ``python -m pytest
portbench/tests -q`` (about a minute on four threads)."""

from __future__ import annotations

import ast
import copy
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check, control, harness, run, yardstick
from portbench.reference import threefry as rtf
from portbench.reference.data import make_data
from portbench.reference.gp import GPProblem, tf32_round

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
SEED = 2**31 + 1234      # past 32 signed bits, as the benchmark's seeds are


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def tiny(cell="pima.bench128", rows=100, s=16):
    """A cell's files cut to a CPU test's size: ``rows`` rows (padded to a
    multiple of 128), S = ``s``, 4 chains, one warm-up window and blocks of
    3 steps."""
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    _, wl, _, conf = harness.find_cell(bench, cell, ROOT)
    conf, wl = copy.deepcopy(conf), copy.deepcopy(wl)
    conf["data"].update(subsample=rows, subsample_seed=0)
    conf["target"]["n_importance"] = s
    conf["warmup"] = {"windows": 1, "steps": 3}
    wl.update(chains=4, copy_steps=3, trace_steps=2)
    wl["check"]["max_chain_steps"] = 8
    return conf, wl


def quiet(msg):
    del msg


def judged(conf, wl, seed=SEED, **kw):
    out = harness.run_cell(conf, wl, seed, 0.5, 0, device="cpu", log=quiet,
                           **kw)
    return out, check.judge(out, conf, wl, seed, "cpu")[0]


# --- lookup by name, and an entry added as files only ----------------------

def test_cells_configs_and_metrics_are_found_by_name():
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    for cell in bench["workloads"]:
        c, wl, conf_entry, conf = harness.find_cell(bench, cell["name"], ROOT)
        assert wl["config"] == c["config"] == conf["name"]
        assert conf_entry["file"] == f"portbench/configs/{conf['name']}.json"
        assert wl["check"]["limits"].keys() == set(check.NUMBERS)
    for m in bench["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
    for m in bench["end_to_end"]:
        assert m["name"].split(".")[0] in ("chain_steps_per_s", "step_ms_p95",
                                           "setup_s")


def test_a_cell_config_and_metric_added_as_files_only(tmp_path):
    pb = tmp_path / "portbench"
    shutil.copytree(PB, pb, ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    conf, wl = tiny()
    conf["name"] = "pima_small"
    (pb / "configs" / "pima_small.json").write_text(json.dumps(conf))
    wl.update(name="pima_small.c4", config="pima_small")
    (pb / "workloads" / "pima_small.c4.json").write_text(json.dumps(wl))
    (pb / "metrics" / "probes_per_chain_step.py").write_text(
        "def read(ctx):\n"
        "    return ctx['work']['slice_theta/n_probe'] / "
        "(ctx['chains'] * ctx['k'])\n")
    bench["configs"].append({"name": "pima_small", "source": "a test",
                             "file": "portbench/configs/pima_small.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "pima_small.c4",
                               "config": "pima_small", "traffic": "c4",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({
        "name": "probes_per_chain_step", "unit": "probes", "better": "lower",
        "source": "program_counter", "layer": "samplers",
        "moves": "chain_steps_per_s", "workloads": ["pima_small.c4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell, wl2, _, conf2 = harness.find_cell(bench, "pima_small.c4", tmp_path,
                                            pb_dir=pb)
    assert conf2 == conf and wl2 == wl
    names = [m["name"] for m in harness.cell_metrics(bench, "pima_small.c4",
                                                     "per_layer")]
    assert names == ["probes_per_chain_step"]
    out = harness.run_cell(conf2, wl2, 5, 0.2, 1, device="cpu", log=quiet)
    out.update(device_kind="cpu", conf=conf2, wl=wl2)
    value = harness.metric_reader("probes_per_chain_step", pb)(
        run.context(out, cell))
    assert value > 0


# --- the yardstick's arithmetic on fixed numbers ---------------------------

def test_bounds_and_percentiles_on_fixed_numbers():
    n = 640
    assert yardstick.factor_flops(n) == pytest.approx(640**3 / 3)
    assert yardstick.factor_bound_s(n) == pytest.approx(
        640**3 / 3 / 67e12)                                  # FLOP-bound
    assert 128 * yardstick.factor_bound_s(n) == pytest.approx(1.669e-4,
                                                              rel=1e-3)
    assert yardstick.probe_flops(64, n) == 64 * 640 * 641
    assert yardstick.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert yardstick.percentile(list(range(1, 201)), 95) == pytest.approx(
        190.05)
    total, gaps = yardstick.union_seconds([(0, 2), (1, 3), (5, 6)])
    assert total == 4 and gaps == [(3, 5)]


def fixed_context():
    trace = {"syncs": 90, "launches": 4700, "busy_s": 0.18, "window_s": 0.3,
             "device_s_by_name": {"void ess_sweep_kernel<0, false>()": 0.05,
                                  "chol_panel_kernel<0>": 0.01,
                                  "sm80_xmma_gemm_f32f32": 0.03,
                                  "threefry_kernel": 0.002},
             "gaps": [], "gemm_names": ["sm80_xmma_gemm_f32f32"]}
    work = {"ess_u/n_shrink": 2.5 * 1280, "slice_theta/n_probe": 9.0 * 1280,
            "slice_theta/n_probe_chol": 2.0 * 1280}
    return {"k": 10, "wall_s": 0.2, "trace": trace, "work": work,
            "chol_launches": 215, "n": 532, "n_pad": 640, "s": 64,
            "n_ess": 4, "chains": 128}


def test_metric_readers_on_a_fixed_context():
    ctx = fixed_context()
    read = {m: harness.metric_reader(m)(ctx) for m in (
        "host.syncs_per_step", "host.launches_per_step",
        "ops.factor_rounds_per_step", "ops.factor_roofline",
        "kernel.ess_sweep_roofline", "step_mfu", "device.idle_share")}
    assert read["host.syncs_per_step"] == 9
    assert read["host.launches_per_step"] == 470
    assert read["ops.factor_rounds_per_step"] == pytest.approx(4.3)  # 5 panels
    per = 532**3 / 3 / 67e12          # the data's rows, not the padding
    assert read["ops.factor_roofline"] == pytest.approx(
        100 * 3 * 1280 * per / 0.04)
    probes = 4 * 1280 * 3.5
    assert read["kernel.ess_sweep_roofline"] == pytest.approx(
        100 * probes * 64 * 532 * 533 / 67e12 / 0.05)
    flops = (probes + 9 * 1280) * 64 * 532 * 533 + 3 * 1280 * 532**3 / 3
    assert read["step_mfu"] == pytest.approx(100 * flops / (0.2 * 67e12))
    assert read["device.idle_share"] == pytest.approx(10.0)
    ctx["trace"]["device_s_by_name"] = {}
    ctx["trace"]["busy_s"] = 0.0
    for m in ("ops.factor_roofline", "kernel.ess_sweep_roofline",
              "device.idle_share"):
        assert harness.metric_reader(m)(ctx) is None    # nothing to read


def test_result_line_has_the_contracts_keys_and_check_last():
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = bench["workloads"][0]
    nums = {k: 0.0 for k in check.NUMBERS}
    limits = {k: 1.0 for k in check.NUMBERS}
    out = {"chain_steps": 1280, "failed": 0, "window_s": 0.2,
           "step_ms": [1.0] * 250, "setup_s": 9.0, "device_kind": "cpu",
           "memory_peak_bytes": 0}
    line = run.result_line(bench, cell, out, nums, limits, "cuda", 0)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "check"]
    assert set(line["metrics"]) == {"chain_steps_per_s", "step_ms_p95",
                                    "setup_s"}
    ab = next(c for c in bench["workloads"] if c["name"] == "abalone.n1024")
    line_ab = run.result_line(bench, ab, out, nums, limits, "cuda", 0)
    assert set(line_ab["metrics"]) == set(line["metrics"])
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["correct"]
    out.update(trace_k=10, wall_s=0.2, trace=fixed_context()["trace"],
               work=fixed_context()["work"], chol_launches=215, n=532,
               n_pad=640,
               conf={"target": {"n_importance": 64},
                     "sampler": {"n_ess": 4}}, wl={"chains": 128})
    line = run.result_line(bench, cell, out, nums, limits, "cuda", 1)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "check"]
    assert set(line["metrics"]) == {m["name"] for m in bench["per_layer"]
                                    if cell["name"] in m["workloads"]}
    assert {"busy_s", "window_s"} <= set(line["device"])
    json.dumps(line)


# --- the reference against the port (CPU path, tiny target) ---------------

def test_reference_draws_and_data_are_the_ports():
    from auxpm_tpu_torch.core import prng
    from auxpm_tpu_torch.models.datasets import load

    x, y = make_data({"n": 4177, "d": 8, "seed": 4177, "subsample": 1024,
                      "subsample_seed": 0})
    a, b = load("abalone", subsample=1024, seed=0)
    assert np.array_equal(x, a) and np.array_equal(y, b)
    k = prng.split(prng.key(SEED), 6)
    assert torch.equal(rtf.split(rtf.key(SEED), 6), k)
    assert torch.equal(rtf.normal(k, (4, 40)), prng.normal(k, (4, 40)))
    assert torch.equal(rtf.blocked_normal(k, (16, 8), 8),
                       prng.blocked_normal(k, (16, 8), 8, 16))


def test_reference_estimate_matches_the_ports_target():
    from auxpm_tpu_torch.models.gp_classification import (
        make_gp_classification,
    )

    conf, _ = tiny()
    x, y = make_data(conf["data"])
    t = conf["target"]
    target = make_gp_classification(x, y, n_importance=t["n_importance"],
                                    device="cpu")
    prob = GPProblem(x, y, t, "cpu")
    theta = torch.tensor([[0.3, 0.2], [-0.4, 0.7]])
    u = torch.randn(2, 16, prob.n_pad, generator=torch.Generator().manual_seed(0))
    port = target.log_lik_est(theta, u)
    for b in range(2):
        ref = prob.log_lik(theta[b].double(), prob.chol(float(theta[b, 0])),
                           u[b].double())
        assert abs(float(port[b]) - ref) < 1e-4
        cache = target.cache_init(theta[b:b + 1])["chol_r"][0]
        assert prob.factor_resid(cache, float(theta[b, 0])) < 1e-6


@pytest.mark.parametrize("cell", ["pima.bench128", "abalone.n1024"])
def test_sound_runs_pass_the_check(cell):
    from auxpm_tpu_torch.models import gp_classification as gp

    real = gp.robust_cholesky
    conf, wl = tiny(cell)
    for seed in (SEED, 7):
        out, nums = judged(conf, wl, seed)
        assert check.verdict(nums, check.limits_of(wl)), nums
        assert nums["key_gap"] == 0 and out["failed"] == 0
        kept = [k for _, k in out["kept"]]
        assert 1 <= len(kept) <= 2              # 8 chain-steps of 4 chains
        # every kept chain logged its log_ell decisions, one factor each
        assert all(len(e) >= 1 for k in kept for e in k["ell"])
        assert all(len(m) >= len(e) for k in kept
                   for e, m in zip(k["ell"], k["margins"]))
    assert gp.robust_cholesky is real           # the tap is taken off


# --- controls and faults make correct false --------------------------------

def test_lower_precision_controls_fail_the_check():
    # three panels of 128, so that the TF32 products of the blocked
    # factorisation's trailing update take part
    conf, wl = tiny(rows=300, s=32)
    limits = check.limits_of(wl)
    out, _ = judged(conf, wl)
    tf = control.tf32_control(out, conf, wl, "cpu")
    assert not check.verdict(tf, limits), tf
    _, bf = judged(conf, wl, whiten_dtype="bfloat16")
    assert not check.verdict(bf, limits), bf


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-12, 3.0], dtype=torch.float32)
    assert tf32_round(x).tolist() == [1.0 + 2**-10, 1.0, 3.0]


def _faulty(monkeypatch, fault):
    """Break the program's step underneath the harness (``build_program``
    hands the broken step to the runner)."""
    real = harness.build_program

    def build(*a, **kw):
        target, step, states, params = real(*a, **kw)

        def broken(state, p):
            new, info = step(state, p)
            if fault == "unchanged":
                return state, info
            if fault == "half_batch":
                half = state.theta.shape[0] // 2
                keep = torch.arange(state.theta.shape[0]) < half

                def mix(a_, b_):
                    m = keep.view(-1, *([1] * (a_.dim() - 1)))
                    return torch.where(m, a_, b_)
                return new.replace(
                    theta=mix(new.theta, state.theta), u=mix(new.u, state.u),
                    log_lik_hat=mix(new.log_lik_hat, state.log_lik_hat),
                    key=mix(new.key, state.key),
                    extras={"target_cache": {"chol_r": mix(
                        new.extras["target_cache"]["chol_r"],
                        state.extras["target_cache"]["chol_r"])}}), info
            if fault in ("answer_altered", "ell_accepts_first"):
                return (new.replace(u=new.u * (1 + 1e-3)) if fault ==
                        "answer_altered" else new), info
            raise ValueError(fault)

        return target, broken, states, params

    monkeypatch.setattr(harness, "build_program", build)
    if fault == "ell_accepts_first":
        from auxpm_tpu_torch.samplers import slice_theta

        monkeypatch.setattr(slice_theta, "_slice_1d", _accepts_first)


def _accepts_first(rep, x0, log_fx0, f, f2, w, max_step_out, max_shrink,
                   probe_log=None):
    """A shrinkage-only slice update that accepts its first candidate
    whatever its margin, and logs the margin truly."""
    assert max_step_out == 0
    del f2, max_shrink
    log_y = log_fx0 + rep[:, 0]
    l = x0 - w * rep[:, 1]
    x = l + w * rep[:, 2]
    lp, ll = f(x)
    yes = torch.ones_like(x0, dtype=torch.bool)
    if probe_log is not None:
        probe_log.append((yes, lp - log_y))
    return x, lp, ll, yes, torch.ones_like(x0)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "answer_altered", "ell_accepts_first"])
def test_faults_in_the_timed_path_make_correct_false(monkeypatch, fault):
    conf, wl = tiny()
    wl["check"]["random_chains"] = 4        # every chain of a kept step
    if fault == "ell_accepts_first":
        # brackets far wider than the slice, so that a sound update
        # rejects most first candidates (a 3-step warm-up adapts them
        # narrow enough to accept nearly all)
        conf["sampler"]["width_scale"] = 40.0
        wl["check"]["max_chain_steps"] = 16
    _faulty(monkeypatch, fault)
    _, nums = judged(conf, wl)
    assert not check.verdict(nums, check.limits_of(wl)), nums


# --- nothing loads JAX; the CLI refuses without a card ---------------------

FORBIDDEN = {"jax", "jaxlib", "flax", "auxpm_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_and_the_reference_imports_no_port():
    for path in PB.rglob("*.py"):
        assert not set(_imports(path)) & FORBIDDEN, path
    for path in (PB / "reference").rglob("*.py"):
        assert "auxpm_tpu_torch" not in set(_imports(path)), path


def test_a_run_loads_no_jax_module():
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "import torch; torch.set_num_threads(2)\n"
        "from portbench.tests.test_portbench_bench import tiny\n"
        "from portbench import harness, check, run\n"
        "conf, wl = tiny()\n"
        "out = harness.run_cell(conf, wl, 3, 0.2, 0, device='cpu', "
        "log=lambda m: None)\n"
        "check.judge(out, conf, wl, 3, 'cpu')\n"
        "print(json.dumps(run.forbidden_modules()))\n" % str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []
    assert run.FORBIDDEN == tuple(sorted(FORBIDDEN, key=run.FORBIDDEN.index))


def test_cli_exits_nonzero_without_a_card_and_in_a_bare_checkout(tmp_path):
    args = ["--workload", "pima.bench128", "--seed", str(SEED), "--seconds",
            "1", "--trace", "0"]
    if not torch.cuda.is_available():
        r = subprocess.run([sys.executable, "portbench/run.py", *args],
                           capture_output=True, text=True, cwd=ROOT,
                           timeout=300)
        assert r.returncode != 0 and r.stdout.strip() == ""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "portbench/run.py", *args],
                       capture_output=True, text=True, cwd=tmp_path,
                       timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.chip
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "pima.bench128", "--seed", str(SEED), "--seconds",
                        "5", "--trace", "0"], capture_output=True, text=True,
                       cwd=ROOT, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["correct"]


# --- BENCHMARK.json keeps to the contract's form ---------------------------

def test_benchmark_json_form():
    import re

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

    def line(s):
        return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s

    names = [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert name.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith(
            "portbench/")
        assert all(name.match(k) for k in c["reduced"])
    cells = [w["name"] for w in bench["workloads"]]
    assert len(set(cells)) == len(cells) and 1 <= len(cells) <= 24
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert name.match(w["name"]) and name.match(w["traffic"])
        assert w["config"] in names and w["chips"] == 1 and line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in metrics:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert all(c in cells for c in m.get("workloads", cells))
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert line(m["layer"]) and m["moves"] in e2e
        for c in m["workloads"]:
            assert c in e2e[m["moves"]].get("workloads", cells)
        assert (PB / "metrics" / f"{m['name']}.py").is_file()
    for c in cells:     # every cell: setup_s, one more end-to-end, a layer
        reported = [m for m in bench["end_to_end"]
                    if c in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(c in m["workloads"] for m in bench["per_layer"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
