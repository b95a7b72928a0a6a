"""One cell of the benchmark: set-up, measured window, traced steps.

Everything that belongs to a configuration, a cell or a per-layer metric is
read from its own file, found by name (``find_cell``, ``metric_reader``):
``configs/<config>.json`` (the target, sampler and data), ``workloads/
<cell>.json`` (chains, warm-up, window blocks, traced steps, the check's
sample and limits) and ``metrics/<metric>.py`` (a ``read(ctx)``).

The system under test is ``auxpm_tpu_torch`` alone: its target
(``models/gp_classification.make_gp_classification``), chains
(``core/state.init_chain_states``), step (``samplers/composite.SAMPLERS``),
warm-up (``samplers/adaptation.warmup``, at the configuration's initial
widths, width scale and windows) and runner (``samplers/chain.run_chains``).
The harness wraps the step to record a CUDA event at each step boundary
and, at one step of each block of the window, to keep what the check
replays for chains drawn from the seed: their states before and after the
step, the margins of their slice decisions (the step's own ``probe_log``
parameter) and the factor each of their log_ell probes made (``FactorTap``,
over the target's factorisation entry).  On the other steps both pass
through.
"""

from __future__ import annotations

import importlib.util
import json
import time
from pathlib import Path

import numpy as np

PB_DIR = Path(__file__).resolve().parent


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def find_cell(bench, name, repo_root, pb_dir=PB_DIR):
    """``(cell entry, workload file, config entry, config file)`` of the
    cell ``name`` of ``bench`` (a parsed ``BENCHMARK.json``)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[cell["config"]]
    wl = load_json(Path(pb_dir) / "workloads" / f"{name}.json")
    if wl["config"] != cell["config"]:
        raise SystemExit(f"workloads/{name}.json names config "
                         f"{wl['config']!r}, BENCHMARK.json {cell['config']!r}")
    return cell, wl, conf, load_json(Path(repo_root) / conf["file"])


def cell_metrics(bench, name, kind):
    """The ``end_to_end`` or ``per_layer`` entries that cell ``name``
    reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or name in m["workloads"]]


def metric_reader(name, pb_dir=PB_DIR):
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = Path(pb_dir) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class FactorTap:
    """The target's factorisation entry (``robust_cholesky`` as
    ``auxpm_tpu_torch/models/gp_classification.py`` calls it), wrapped for
    one run: while armed with chains ``idx`` of a batch of ``b``, each
    call's factor rows of those chains are kept (a call of ``2 b`` matrices,
    the 2-point probe of a step-out, holds each chain's left end, then its
    right); unarmed, every call passes through."""

    def __init__(self):
        self.armed = None
        self.calls = []
        self.module = self.real = None

    def install(self):
        import torch

        from auxpm_tpu_torch.models import gp_classification as gp

        self.module, self.real = gp, gp.robust_cholesky

        def tapped(gram, *args, **kw):
            out = self.real(gram, *args, **kw)
            if self.armed is not None:
                idx, b = self.armed
                if out.shape[0] == 2 * b:
                    self.calls.append((2, out[torch.cat([idx, idx + b])]))
                elif out.shape[0] == b:
                    self.calls.append((1, out[idx]))
                else:
                    raise RuntimeError(f"a factorisation of {out.shape[0]} "
                                       f"matrices in a step of {b} chains")
            return out

        gp.robust_cholesky = tapped

    def remove(self):
        if self.module is not None:
            self.module.robust_cholesky = self.real
            self.module = None

    def arm(self, idx, b):
        self.armed, self.calls = (idx, b), []

    def disarm(self):
        calls, self.armed, self.calls = self.calls, None, []
        return calls


class Stepper:
    """The step as the runner sees it, plus step-boundary events and the
    kept steps.  ``plan(i)`` marks global step ``i`` for keeping;
    ``events`` (a list, or None) receives one CUDA event at the start of
    every step.  ``settle()``, called where the host has waited for the
    device, trims each kept step's probe factors to the ones its chains
    decided on and holds it among ``keep`` kept steps at most (the newest
    always; which older one makes room is drawn from the seed)."""

    def __init__(self, step, n_random, seed, chains, keep, tap):
        self.step = step
        self.n_random = min(n_random, chains)
        self.rng = np.random.default_rng([seed, 1])
        self.chains = chains
        self.keep = keep
        self.tap = tap
        self.count = 0
        self.planned = set()
        self.pending = []
        self.kept = []
        self.events = None

    def plan(self, i):
        self.planned.add(i)

    def __call__(self, state, params):
        import torch

        if self.events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
        if self.count not in self.planned:
            new, info = self.step(state, params)
        else:
            idx = torch.as_tensor(self.rng.choice(
                self.chains, self.n_random, replace=False),
                device=state.theta.device)
            log = []
            p = {**params, "slice_theta": {**params["slice_theta"],
                                           "probe_log": log}}
            self.tap.arm(idx, self.chains)
            try:
                new, info = self.step(state, p)
            finally:
                calls = self.tap.disarm()
            self.pending.append((self.count, {
                "idx": idx, "pre": state_rows(state, idx),
                "post": state_rows(new, idx)}, calls,
                [(m[idx], g[idx]) for m, g in log]))
        self.count += 1
        return new, info

    def settle(self):
        import torch

        for count, kept, calls, log in self.pending:
            k = len(kept["idx"])
            masks = torch.stack([m for m, _ in log]).cpu().numpy()
            margins = torch.stack([g for _, g in log]).double().cpu().numpy()
            kept["ell"], kept["margins"] = [], []
            for j in range(k):
                rows, e = [], 0
                for width, t in calls[:-1]:     # the last: the refresh
                    for side in range(width):
                        if masks[e, j]:
                            rows.append(t[side * k + j])
                        e += 1
                # a copy of its own, so that the calls' batches are freed
                kept["ell"].append(torch.stack(rows) if rows else rows)
                kept["margins"].append(
                    [float(g) for g, m in zip(margins[:, j], masks[:, j])
                     if m])
            self.kept.append((count, kept))
            if len(self.kept) > self.keep:
                del self.kept[int(self.rng.integers(len(self.kept) - 1))]
        self.pending = []


def state_rows(state, idx):
    """theta, u, key, log L-hat and the carried factor of chains ``idx``."""
    return {"theta": state.theta[idx], "u": state.u[idx],
            "key": state.key[idx], "ll": state.log_lik_hat[idx],
            "chol": state.extras["target_cache"]["chol_r"][idx]}


def chain_order(seed, n):
    """The order of the cell's chains in the batch, drawn from ``seed``."""
    return np.random.default_rng([seed, 0]).permutation(n)


def build_program(conf, wl, seed, device, x, y, whiten_dtype=None):
    """Target, step, initial chains and params of the cell: the program's
    own functions at the configuration's settings.  The chains are the same
    set for every seed, the program's chains of the key ``wl["chain_seed"]``,
    in an order drawn from ``seed``: the work of a step is a maximum over
    chains, and at 4096 chains the chains of different keys made it differ
    by a third from seed to seed."""
    import torch

    from auxpm_tpu_torch.core.state import init_chain_states
    from auxpm_tpu_torch.models.gp_classification import (
        make_gp_classification,
    )
    from auxpm_tpu_torch.samplers.composite import SAMPLERS

    t, s = conf["target"], conf["sampler"]
    target = make_gp_classification(
        x, y, n_importance=t["n_importance"], likelihood=t["likelihood"],
        ard=t["ard"], jitter=t["jitter"], prior_mean=t["prior_mean"],
        prior_std=t["prior_std"], pad_to_tiles=t["pad_to_tiles"],
        proposal=t["proposal"],
        whiten_dtype=whiten_dtype or t["whiten_dtype"], device=device)
    states = init_chain_states(wl["chain_seed"], target, wl["chains"],
                               jitter_scale=s["jitter_scale"],
                               with_cache=s["chol_cache"])
    order = torch.as_tensor(chain_order(seed, wl["chains"]),
                            device=states.theta.device)
    states = states.replace(
        theta=states.theta[order], u=states.u[order],
        log_lik_hat=states.log_lik_hat[order], key=states.key[order],
        extras={"target_cache": {
            "chol_r": states.extras["target_cache"]["chol_r"][order]}})
    step = SAMPLERS[s["name"]](target, n_ess=s["n_ess"],
                               n_sigma_extra=s["n_sigma_extra"])
    params = {"ess_u": {},
              "slice_theta": {
                  "widths": torch.full((target.d,), float(s["widths"]),
                                       dtype=torch.float32, device=device),
                  "max_step_out": s["max_step_out"],
                  "max_shrink_chol": s["max_shrink_chol"]}}
    return target, step, states, params


def sync(device):
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def run_cell(conf, wl, seed, seconds, trace, device="cuda", t_start=None,
             whiten_dtype=None, log=print):
    """Set up the cell, run its window (``trace`` 0) or its traced steps
    (``trace`` 1), and return everything the check and the metrics read.
    The program's state is dropped before returning."""
    tap = FactorTap()
    tap.install()
    try:
        return _run_cell(conf, wl, seed, seconds, trace, device, t_start,
                         whiten_dtype, log, tap)
    finally:
        tap.remove()


def _run_cell(conf, wl, seed, seconds, trace, device, t_start, whiten_dtype,
              log, tap):
    import torch

    from auxpm_tpu_torch.samplers.adaptation import warmup
    from auxpm_tpu_torch.samplers.chain import run_chains
    from portbench.reference.data import make_data

    t_start = time.time() if t_start is None else t_start
    on_gpu = str(device).startswith("cuda")
    if on_gpu:
        torch.cuda.reset_peak_memory_stats()
    log(f"setup: cuda initialised at {time.time() - t_start:.3f} s")
    x, y = make_data(conf["data"])
    log(f"setup: data made at {time.time() - t_start:.3f} s")
    target, step, states, params = build_program(
        conf, wl, seed, device, x, y, whiten_dtype)
    sync(device)
    log(f"setup: target and chains at {time.time() - t_start:.3f} s")
    chk = wl["check"]
    stepper = Stepper(step, chk["random_chains"], seed, wl["chains"],
                      -(-chk["max_chain_steps"] // chk["random_chains"]), tap)
    idx0 = torch.as_tensor(np.random.default_rng([seed, 2]).choice(
        wl["chains"], min(chk["init_chains"], wl["chains"]), replace=False),
        device=states.theta.device)
    out = {"init": {"idx": idx0, "state": state_rows(states, idx0)},
           "x": x, "y": y, "n": len(x), "n_pad": target.u_shape[1]}

    last = {}

    def run_fn(transition, s, p, n):
        del transition                 # the stepper wraps the same step
        s, recs, infos = run_chains(stepper, s, p, n)
        last["theta"] = recs["theta"]
        return s, recs, infos

    # warm-up: the configuration's adaptation windows, every kernel built
    # and loaded; one kept step and the event path exercised on its last
    # step
    warm = conf["warmup"]
    n_warm = warm["windows"] * warm["steps"]
    stepper.plan(n_warm - 1)
    stepper.events = [] if on_gpu else None
    states, params, _ = warmup(run_fn, states, params, warm["windows"],
                               warm["steps"], step=step,
                               width_scale=conf["sampler"]["width_scale"])
    out["warm_theta"] = last["theta"]
    out["widths"] = params["slice_theta"]["widths"]
    sync(device)
    stepper.settle()
    stepper.kept.clear()
    stepper.events = None
    out["setup_s"] = time.time() - t_start
    log(f"setup done in {out['setup_s']:.3f} s (warm-up {n_warm} steps)")

    if trace:
        out.update(_traced(run_chains, stepper, states, params, wl, device,
                           log))
    else:
        out.update(_window(run_chains, stepper, states, params, wl, seconds,
                           device, seed))
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if on_gpu else 0)
    out["kept"] = stepper.kept
    del states, target, step, stepper, run_fn
    if on_gpu:
        torch.cuda.empty_cache()
    return out


def _window(run_chains, stepper, states, params, wl, seconds, device, seed):
    """The measured window: blocks of ``copy_steps`` steps, one host copy of
    the records per block, until ``seconds`` have passed; then the stream is
    drained."""
    import torch

    on_gpu = str(device).startswith("cuda")
    rng = np.random.default_rng([seed, 3])
    block = wl["copy_steps"]
    events = [] if on_gpu else None
    stepper.events = events
    thetas, n_bad = [], 0
    first = stepper.count
    t0 = time.perf_counter()
    while True:
        stepper.plan(stepper.count + int(rng.integers(block)))
        states, recs, _ = run_chains(stepper, states, params, block)
        th = recs["theta"].cpu().numpy()          # the block's host copy
        ll = recs["log_lik_hat"].cpu().numpy()
        thetas.append(th)
        n_bad += int((~np.isfinite(th).all(-1) | ~np.isfinite(ll)).sum())
        stepper.settle()
        if time.perf_counter() - t0 >= seconds:
            break
    if on_gpu:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        events.append(end)
    sync(device)
    window_s = time.perf_counter() - t0
    stepper.events = None
    n_steps = stepper.count - first
    step_ms = ([a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])]
               if on_gpu else [])
    return {"window_s": window_s, "steps": n_steps,
            "chain_steps": n_steps * wl["chains"], "failed": n_bad,
            "step_ms": step_ms, "theta_window": np.concatenate(thetas, 1)}


def _traced(run_chains, stepper, states, params, wl, device, log):
    """K steps untraced (wall time, two kept steps), then the same K steps
    from the same states and keys under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from auxpm_tpu_torch.ops import chol_hopper
    from portbench.tracing import summarise

    k = wl["trace_steps"]
    on_gpu = str(device).startswith("cuda")
    stepper.plan(stepper.count + k - 1)           # kept: the last step
    stepper.plan(stepper.count + k // 2)          # and one in the middle
    start = states
    sync(device)
    t0 = time.perf_counter()
    end_a, _, infos = run_chains(stepper, start, params, k)
    sync(device)
    wall_s = time.perf_counter() - t0
    stepper.settle()
    work = {key: float(v.double().sum()) for key, v in infos.items()}
    n_bad = int((~torch.isfinite(end_a.theta).all(-1)
                 | ~torch.isfinite(end_a.log_lik_hat)).sum())
    del end_a
    c0 = chol_hopper.launches
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_gpu
                                     else [])
    t1 = time.perf_counter()
    with profile(activities=acts) as prof:
        with record_function("portbench.traced_steps"):
            run_chains(stepper.step, start, params, k)
            sync(device)
    traced_wall_s = time.perf_counter() - t1
    chol_launches = chol_hopper.launches - c0
    t2 = time.perf_counter()
    summary = summarise(prof, "portbench.traced_steps")
    log(f"trace read in {time.perf_counter() - t2:.3f} s; untraced "
        f"{wall_s:.4f} s, traced {traced_wall_s:.4f} s for {k} steps")
    return {"trace_k": k, "wall_s": wall_s, "trace": summary,
            "work": work, "chol_launches": chol_launches, "failed": n_bad,
            "chain_steps": k * wl["chains"],
            "traced_wall_s": traced_wall_s}
