"""A/B micro-benchmark: the whole-ESS-sweep kernel against the per-probe path.

    python -m auxpm_tpu_torch.utils.ess_sweep_bench [--device cpu]

Counterpart of ``scripts/ess_sweep_bench.py``.  At the bench shape (Pima
n=532 padded to 640, S=64, 128 chains, ``n_repeats=4``, seed 0,
``jitter_scale=0.3``) it measures

  (a) ms per ESS-only step: the per-probe loop (each probe one launch of the
      rotated estimator, ``csrc/fused_estimator.cu``'s second entry) against
      ONE launch of the whole sweep (``csrc/ess_sweep.cu``);
  (b) one-step parity of the two paths on the same rows: max |du|, max
      |dlog L-hat| and the shrink counts;
  (c) ms per FULL ``aux_slice`` step (ESS + slice-theta, widths 0.7,
      ``max_step_out=0``) both ways.

The per-probe path is the target without its sweep factory
(``dataclasses.replace(target, ess_sweep_factory=None)``), as in the
reference; each side asserts ``step.uses_sweep``.  Each timed run takes
``AB_STEPS`` steps from the same initial states twice (warm-up, then timed),
each closed by ``utils/profiling.device_sync``.  Prints the reference's one
JSON line (same keys); progress, with kernel launches per step, goes to
stderr.

Env, as the reference's: ``BENCH_CHAINS`` (128), ``BENCH_S`` (64),
``BENCH_N_ESS`` (4), ``AB_STEPS`` (60).  Runs on the card unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def time_step(step, states, params, label, steps):
    """Seconds per step of ``steps`` steps from ``states`` (warm-up, then
    timed, each closed by ``device_sync``); returns ``(seconds per step,
    launches per step of the timed run)``."""
    from auxpm_tpu_torch.utils.profiling import (
        device_sync,
        launch_counts,
        launches_since,
    )

    def many(ss):
        for _ in range(steps):
            ss, _ = step(ss, params)
        return ss

    device_sync(many(states).theta)
    before = launch_counts()
    t0 = time.perf_counter()
    out = many(states)
    device_sync(out.theta)
    dt = time.perf_counter() - t0
    launches = launches_since(before, steps)
    log(f"{label}: {1e3 * dt / steps:.3f} ms/step ({steps} steps, "
        f"{states.theta.shape[0]} chains) launches/step "
        f"{json.dumps(launches)}")
    return dt / steps, launches


def bench(x, y, chains=128, s=64, n_ess=4, steps=60, device="cuda"):
    """Returns the reference's keys (unrounded) plus ``"max_dns"`` (the
    largest shrink-count difference), ``"max_abs_ll"`` (the largest |log
    L-hat| after the per-probe step, the scale of ``max_dll``),
    ``"n_shrink_mean"`` and ``"launches_per_step"`` by run."""
    import torch

    from auxpm_tpu_torch._device import resolve_device
    from auxpm_tpu_torch.core.state import init_chain_states
    from auxpm_tpu_torch.models.gp_classification import (
        make_gp_classification,
    )
    from auxpm_tpu_torch.samplers.composite import make_aux_slice
    from auxpm_tpu_torch.samplers.ess_u import make_ess_u

    dev = resolve_device(device)
    log("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu")
    target = make_gp_classification(x, y, n_importance=s, device=dev)
    assert target.ess_sweep_factory is not None
    t_loop = dataclasses.replace(target, ess_sweep_factory=None)
    states = init_chain_states(0, target, chains, jitter_scale=0.3)

    # --- (b) one-step parity ----------------------------------------------
    step_sw = make_ess_u(target, n_repeats=n_ess)
    step_lp = make_ess_u(t_loop, n_repeats=n_ess)
    assert step_sw.uses_sweep and not step_lp.uses_sweep
    s1, i1 = step_sw(states, {})
    s2, i2 = step_lp(states, {})
    du = float((s1.u - s2.u).abs().max())
    dll = float((s1.log_lik_hat - s2.log_lik_hat).abs().max())
    dns = float((i1["n_shrink"] - i2["n_shrink"]).abs().max())
    log(f"one-step parity: max|du|={du:.3e} max|dll|={dll:.3e} "
        f"max|dns|={dns}")

    # --- (a) ESS-only step --------------------------------------------------
    launches = {}
    ms_sw, launches["ess_only_sweep"] = time_step(step_sw, states, {},
                                                  "ess-only  sweep", steps)
    ms_lp, launches["ess_only_probe"] = time_step(step_lp, states, {},
                                                  "ess-only  per-probe",
                                                  steps)

    # --- (c) full aux-slice step --------------------------------------------
    params = {
        "slice_theta": {"widths": torch.full((target.d,), 0.7,
                                             dtype=torch.float32, device=dev),
                        "max_step_out": 0},
        "ess_u": {},
    }
    full_sw = make_aux_slice(target, n_ess=n_ess)
    full_lp = make_aux_slice(t_loop, n_ess=n_ess)
    ms_fsw, launches["aux_slice_sweep"] = time_step(
        full_sw, states, params, "aux-slice sweep", steps)
    ms_flp, launches["aux_slice_probe"] = time_step(
        full_lp, states, params, "aux-slice per-probe", steps)
    return {"ess_only_sweep_ms": 1e3 * ms_sw, "ess_only_probe_ms": 1e3 * ms_lp,
            "aux_slice_sweep_ms": 1e3 * ms_fsw,
            "aux_slice_probe_ms": 1e3 * ms_flp,
            "ess_speedup": ms_lp / ms_sw, "step_speedup": ms_flp / ms_fsw,
            "max_du": du, "max_dll": dll, "max_dns": dns,
            "max_abs_ll": float(s2.log_lik_hat.abs().max()),
            "n_shrink_mean": float(i1["n_shrink"].mean()),
            "launches_per_step": launches}


def result_line(r):
    """The reference's JSON line, its formats and keys."""
    return (
        f'{{"ess_only_sweep_ms": {r["ess_only_sweep_ms"]:.3f}, '
        f'"ess_only_probe_ms": {r["ess_only_probe_ms"]:.3f}, '
        f'"aux_slice_sweep_ms": {r["aux_slice_sweep_ms"]:.3f}, '
        f'"aux_slice_probe_ms": {r["aux_slice_probe_ms"]:.3f}, '
        f'"ess_speedup": {r["ess_speedup"]:.3f}, '
        f'"step_speedup": {r["step_speedup"]:.3f}, '
        f'"max_du": {r["max_du"]:.3e}, "max_dll": {r["max_dll"]:.3e}}}'
    )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from auxpm_tpu_torch.models.datasets import load

    x, y = load("pima")
    r = bench(x, y,
              chains=int(os.environ.get("BENCH_CHAINS", 128)),
              s=int(os.environ.get("BENCH_S", 64)),
              n_ess=int(os.environ.get("BENCH_N_ESS", 4)),
              steps=int(os.environ.get("AB_STEPS", 60)),
              device=args.device)
    print(result_line(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
