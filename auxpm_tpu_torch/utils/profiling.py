"""Where a step's time goes on the card.

    python -m auxpm_tpu_torch.utils.profiling --chains 128 --steps 10
    python -m auxpm_tpu_torch.utils.profiling --preset pima_ard_aux --steps 5

Builds the preset's target at full width (Pima n=532 padded to 640, S=64),
warms the ``aux_slice`` step up, then runs ``--steps`` steps under
``torch.profiler`` and prints one JSON line: wall time per step (from an
untraced run of the same steps), the device's busy and idle share, kernel
launches and host synchronisations per step, and device time per step grouped
by kernel name.  ``pima_aux_slice`` (the default) runs with the bench
settings (``max_step_out=0, n_ess=4, n_sigma_extra=1, max_shrink_chol=3``),
``pima_ard_aux`` as the CLI runs it; ``AUXPM_ESS_SWEEP=0`` in the environment
selects the per-probe elliptical-slice loop.  Needs a GPU (it raises without
one); nothing here is a CPU number.
"""

from __future__ import annotations

import argparse
import json
import time


def profile_steps(step, states, params, n_steps):
    """Run ``n_steps`` of ``step`` under ``torch.profiler``; returns
    ``(states, report)`` with times in milliseconds per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from torch.autograd import DeviceType

    # wall time from an untraced run of the same length: tracing the host
    # side slows the Python loop many times over
    generator_state = states.generator.get_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probe_states = states
    for _ in range(n_steps):
        probe_states, _ = step(probe_states, params)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    states.generator.set_state(generator_state)  # trace the same steps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            states, _ = step(states, params)
        torch.cuda.synchronize()
    by_kernel = {}
    # a host synchronisation on this path is a scalar read (``bool(flag)``)
    host_syncs = 0
    for evt in prof.key_averages():
        if evt.key == "aten::_local_scalar_dense":
            host_syncs += evt.count
        # kernels only: an operator's device time repeats its kernels'
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0:
            by_kernel[evt.key] = (by_kernel.get(evt.key, 0.0)
                                  + evt.self_device_time_total / 1e3)
    if not by_kernel:
        raise RuntimeError("torch.profiler recorded no device time")
    busy_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    report = {
        "steps": n_steps,
        "wall_ms_per_step": wall_ms / n_steps,
        "device_busy_ms_per_step": busy_ms / n_steps,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "kernel_launches_per_step": sum(
            evt.count for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA) / n_steps,
        "host_syncs_per_step": host_syncs / n_steps,
        "device_ms_per_step_by_kernel": {
            k[:80]: round(v / n_steps, 4) for k, v in top
        },
    }
    return states, report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", default="pima_aux_slice",
                   choices=["pima_aux_slice", "pima_ard_aux"])
    p.add_argument("--chains", type=int, default=None,
                   help="default: the preset's")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--warm-steps", type=int, default=5)
    args = p.parse_args(argv)

    import torch

    from auxpm_tpu_torch.core.state import init_chain_states
    from auxpm_tpu_torch.samplers.composite import SAMPLERS
    from auxpm_tpu_torch.utils.config import (
        PRESETS,
        build_target,
        initial_params,
    )

    cfg = PRESETS[args.preset]
    if args.preset == "pima_aux_slice":  # the bench settings
        cfg = cfg.replace(max_step_out=0, n_ess=4, n_sigma_extra=1,
                          max_shrink_chol=3)
    if args.chains:
        cfg = cfg.replace(chains=args.chains)
    target = build_target(cfg)  # raises without a GPU
    params = initial_params(cfg, target)
    states = init_chain_states(cfg.seed, target, cfg.chains,
                               jitter_scale=cfg.jitter_scale, with_cache=True)
    step = SAMPLERS[cfg.sampler](target, n_ess=cfg.n_ess,
                                 n_sigma_extra=cfg.n_sigma_extra)
    for _ in range(args.warm_steps):
        states, _ = step(states, params)
    _, report = profile_steps(step, states, params, args.steps)
    report["device"] = torch.cuda.get_device_name(0)
    report["preset"] = args.preset
    report["chains"] = cfg.chains
    report["ess_uses_sweep"] = step.stages["ess_u"].uses_sweep
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
