"""Where a step's time goes on the card.

    python -m auxpm_tpu_torch.utils.profiling --chains 128 --steps 10
    python -m auxpm_tpu_torch.utils.profiling --preset pima_ard_aux --steps 5
    torchrun --nproc-per-node 4 -m auxpm_tpu_torch.utils.profiling \
        --particle-shards 2 --steps 3

Builds the preset's target at full width (Pima n=532 padded to 640, S=64),
warms the ``aux_slice`` step up, then runs ``--steps`` steps under
``torch.profiler`` and prints one JSON line: wall time per step (from an
untraced run of the same steps), the device's busy and idle share, kernel
launches and host synchronisations per step, and device time per step grouped
by kernel name.  ``pima_aux_slice`` (the default) runs with the bench
settings (``max_step_out=0, n_ess=4, n_sigma_extra=1, max_shrink_chol=3``),
``pima_ard_aux`` as the CLI runs it; ``AUXPM_ESS_SWEEP=0`` in the environment
selects the per-probe elliptical-slice loop.  ``--particle-shards K`` profiles
the sharded run on the world ``torchrun`` started (``world / K`` chain shards
by K particle shards, through ``run.main``): rank 0 prints its own view of its
card, with the run's chain-steps/s, the collectives per step, the time of one
collective estimate and whether the ranks of every particle group ended with
bitwise the same theta and log L-hat.  Needs a GPU (it raises without
one); nothing here is a CPU number.

``trace(logdir)`` is the context manager behind ``run.py --profile-dir``:
everything run inside it is recorded by ``torch.profiler`` (host operators,
and the card's kernels on a GPU) and written as a Chrome trace,
``<logdir>/trace_rank<rank>.json``, readable in Perfetto or
``chrome://tracing``.

The reference's three helpers, for timing from Python: ``device_sync(x)``
waits for the card to finish whatever produced ``x``, ``timed(fn, *args)``
times calls closed by one ``device_sync`` and ``cost_analysis(fn, *args)``
counts the FLOPs of one call.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time


@contextlib.contextmanager
def trace(logdir):
    """Record what runs inside under ``torch.profiler``; on exit write the
    Chrome trace ``<logdir>/trace_rank<rank>.json`` (rank 0 unless a
    ``torch.distributed`` world is up).  Yields the trace file's path."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_rank{rank}.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def _tensors(x):
    """The tensor leaves of ``x`` (nested tuples, lists, dicts and
    dataclasses such as ``ChainState``)."""
    import dataclasses

    import torch

    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))


def device_sync(x):
    """Wait until the card has finished everything that produced ``x``:
    ``torch.cuda.synchronize`` on the device of each CUDA tensor leaf of
    ``x`` (each device once).  Nothing happens for CPU tensors.  Returns
    ``x``."""
    import torch

    seen = set()
    for leaf in _tensors(x):
        if leaf.is_cuda and leaf.device not in seen:
            seen.add(leaf.device)
            torch.cuda.synchronize(leaf.device)
    return x


def timed(fn, *args, reps=1, warmup=1, **kw):
    """Returns ``(seconds_per_call, last_result)``: ``warmup`` calls and one
    ``device_sync``, then ``reps`` calls closed by a single ``device_sync``
    of the last result (a stream runs its work in order, so that one sync
    covers every call)."""
    r = None
    for _ in range(warmup):
        r = fn(*args, **kw)
    device_sync(r)
    t0 = time.perf_counter()
    for _ in range(reps):
        r = fn(*args, **kw)
    device_sync(r)
    return (time.perf_counter() - t0) / reps, r


def cost_analysis(fn, *args, **kw):
    """FLOPs of one call of ``fn`` at these arguments, as a dict with XLA's
    key: ``{"flops": n}``, counted by ``torch.utils.flop_counter.
    FlopCounterMode`` over the PyTorch operators the call runs.

    The count leaves out the port's hand-written kernels (the estimator,
    the sweeps, the Cholesky panels, the ARD Gram, threefry): they are not
    PyTorch operators.  Their work is counted where their bounds are:
    ``ops/fused_estimator.probe_flops`` per probe, and ``bound`` in
    ``chip_smoke.py`` per kernel."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kw)
    return {"flops": float(counter.get_total_flops())}


# (name, module under auxpm_tpu_torch.ops, counter): every kernel wrapper's
# launch count, as the wrappers keep them
LAUNCH_COUNTERS = (
    ("fused_estimator", "fused_estimator", "launches"),
    ("chol_panel", "chol_hopper", "launches"),
    ("ess_sweep", "ess_sweep", "launches"),
    ("sigma_sweep", "sigma_sweep", "launches"),
    ("fused_estimator_rot", "fused_estimator", "launches_rot"),
    ("se_gram_ard", "gram", "launches"),
    ("fused_weights", "fused_estimator", "launches_w"),
    ("fused_rot_weights", "fused_estimator", "launches_rot_w"),
    ("chol_panel_v1", "chol_hopper", "launches_v1"),
    ("chol_panel_v2", "chol_hopper", "launches_v2"),
    ("threefry", "threefry", "launches"),
)


def launch_counters():
    """``{kernel name: (wrapper module, counter attribute)}`` of
    ``LAUNCH_COUNTERS``, the modules imported."""
    import importlib

    return {name: (importlib.import_module(f"auxpm_tpu_torch.ops.{mod}"), attr)
            for name, mod, attr in LAUNCH_COUNTERS}


def launch_counts():
    """The launch counts of every kernel wrapper now, by kernel name (all 0
    on the CPU, where the wrappers take their plain versions)."""
    return {name: getattr(m, attr)
            for name, (m, attr) in launch_counters().items()}


def launches_since(before, per=1):
    """Launches of each kernel since ``before`` (a ``launch_counts()``),
    divided by ``per``; kernels that did not launch are left out."""
    return {k: (v - before[k]) / per for k, v in launch_counts().items()
            if v != before[k]}


def profile_steps(step, states, params, n_steps):
    """Run ``n_steps`` of ``step`` under ``torch.profiler``; returns
    ``(states, report)`` with times in milliseconds per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from torch.autograd import DeviceType

    # wall time from an untraced run of the same length: tracing the host
    # side slows the Python loop many times over; the traced run repeats
    # the same steps (they are a function of the states' keys)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probe_states = states
    for _ in range(n_steps):
        probe_states, _ = step(probe_states, params)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            states, _ = step(states, params)
        torch.cuda.synchronize()
    by_kernel = {}
    n_launches = 0
    # a host synchronisation on this path is a scalar read (``bool(flag)``)
    host_syncs = 0
    for evt in prof.key_averages():
        if evt.key == "aten::_local_scalar_dense":
            host_syncs += evt.count
        # kernels only: an operator's device time repeats its kernels', and
        # so does the "nccl:..." range that wraps a collective's kernel
        if evt.device_type != DeviceType.CUDA or evt.key.startswith("nccl:"):
            continue
        n_launches += evt.count
        if evt.self_device_time_total > 0:
            by_kernel[evt.key] = (by_kernel.get(evt.key, 0.0)
                                  + evt.self_device_time_total / 1e3)
    if not by_kernel:
        raise RuntimeError("torch.profiler recorded no device time")
    busy_ms = sum(by_kernel.values())
    # the 12 longest kernels, and every kernel of this package whatever its
    # rank
    top = [kv for i, kv in enumerate(sorted(by_kernel.items(),
                                            key=lambda kv: -kv[1]))
           if i < 12 or "auxpm::" in kv[0]]
    report = {
        "steps": n_steps,
        "wall_ms_per_step": wall_ms / n_steps,
        "device_busy_ms_per_step": busy_ms / n_steps,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "kernel_launches_per_step": n_launches / n_steps,
        "host_syncs_per_step": host_syncs / n_steps,
        "device_ms_per_step_by_kernel": {
            k[:80]: round(v / n_steps, 4) for k, v in top
        },
    }
    return states, report


def time_collective(states, mesh, n_blocks, reps=20):
    """Milliseconds of one blocked log-sum-exp over the particle group at the
    estimator's shape (block partials, the collective, the fold), the stream
    drained before and after."""
    import torch

    from auxpm_tpu_torch.parallel.collectives import (
        allgather_blocked_logsumexp,
    )

    lw = states.u[:, :, 0].contiguous()              # (B, S_local) floats
    nb_local = n_blocks // mesh.n_particle_shards

    def sync():
        if lw.is_cuda:
            torch.cuda.synchronize(lw.device)

    allgather_blocked_logsumexp(lw, nb_local, mesh)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        allgather_blocked_logsumexp(lw, nb_local, mesh)
    sync()
    return (time.perf_counter() - t0) * 1e3 / reps


def profile_run(result, n_steps):
    """``profile_steps`` on ``n_steps`` more steps of a finished
    ``run.main(argv, result=result)``; a sharded run's report also has the
    collectives entered per step and, with particle shards, the time of one
    collective estimate.  Every rank of the world must call it."""
    from auxpm_tpu_torch.parallel import collectives

    states, mesh = result["states"], result["mesh"]
    c0 = collectives.calls
    _, report = profile_steps(result["step"], states, result["params"],
                              n_steps)
    if mesh is not None:
        # the window runs twice (untraced for the wall time, then traced)
        report["collectives_per_step"] = (
            (collectives.calls - c0) / (2 * n_steps))
        if mesh.n_particle_shards > 1:
            report["collective_ms"] = time_collective(
                states, mesh, result["target"].n_weight_blocks)
    return report


def _main_sharded(args):
    """The ``--particle-shards`` branch of ``main``, on one rank of the
    world."""
    import torch
    import torch.distributed as dist

    from auxpm_tpu_torch import run as port_run

    argv = ["--sharded", "true", "--particle-shards",
            str(args.particle_shards), "--preset", args.preset,
            "--warmup-windows", "1", "--window-steps", str(args.warm_steps),
            "--steps", str(args.warm_steps)]
    if args.preset == "pima_aux_slice":  # the bench settings
        argv += ["--max-step-out", "0", "--n-ess", "4", "--n-sigma-extra",
                 "1", "--max-shrink-chol", "3"]
    if args.chains:
        argv += ["--chains", str(args.chains)]
    result = {}
    with contextlib.redirect_stdout(sys.stderr):   # rank 0's summary line
        port_run.main(argv, result=result)
    states, mesh = result["states"], result["mesh"]
    report = profile_run(result, args.steps)
    equal = torch.ones((), device=states.theta.device)
    for x in (states.theta, states.log_lik_hat):
        hi, lo = x.clone(), x.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=mesh.particle_group)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=mesh.particle_group)
        equal *= float(torch.equal(hi, lo))
    dist.all_reduce(equal, op=dist.ReduceOp.MIN)       # over every group
    report.update(
        device=torch.cuda.get_device_name(states.theta.device),
        preset=args.preset, chains=result["theta"].shape[0],
        mesh=[mesh.n_chain_shards, mesh.n_particle_shards],
        backend=dist.get_backend(), u_shape_per_rank=list(states.u.shape),
        chain_steps_per_sec=result["summary"]["chain_steps_per_sec"],
        particle_groups_bitwise_equal=bool(equal))
    if mesh.rank == 0:
        print(json.dumps(report))
    dist.destroy_process_group()
    return 0 if bool(equal) else 1


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", default="pima_aux_slice",
                   choices=["pima_aux_slice", "pima_ard_aux"])
    p.add_argument("--chains", type=int, default=None,
                   help="default: the preset's")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--warm-steps", type=int, default=5)
    p.add_argument("--particle-shards", type=int, default=0,
                   help="K > 0: the sharded run, one rank of torchrun's world")
    args = p.parse_args(argv)
    if args.particle_shards:
        return _main_sharded(args)

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
