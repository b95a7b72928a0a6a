"""Sampler-variant tau sweep on the bench config (Pima, S=64, 128 chains).

    python -m auxpm_tpu_torch.utils.tau_sweep [--device cpu]

Counterpart of ``scripts/tau_sweep.py``.  Per theta sampler of the
``aux_slice`` family it measures chain-steps/s (the timed window closed by
``utils/profiling.device_sync``), tau per dimension (``n_total / ESS``, the
multi-chain Geyer ESS of ``utils/diagnostics.effective_sample_size``) and
ESS/s over the worst dimension: the quantity a user of the sampler pays
for.  Each variant: the GP target at S=64, ``make_step`` (``n_ess=4``), 128
chains from seed 0 with ``jitter_scale=0.3``, ``TAU_WARM_WINDOWS`` warm-up
windows of 25 steps, each followed by ``adapt_params(width_scale=2.5)`` and
``post_adapt``, then ``TAU_STEPS // 25`` timed chunks of 25 steps with one
``device_sync`` per chunk; the records are copied to the host after the
window and the ESS is computed there.  Prints the reference's text line per
variant on stdout; progress goes to stderr.

``make_step``, ``initial_params`` and ``post_adapt`` are the reference's,
quirks included: ``post_adapt`` mirrors the adapted widths into
``slice_theta_rd`` for ``aux_slice_pcrd`` only, forces ``max_step_out`` to 0
and keeps only the groups of the variant.

As in the reference, a variant that raises prints its ``FAILED`` line and the
sweep goes on to the next.  Unlike the reference, ``main`` then returns 1, so
that ``python -m`` exits non-zero when any variant failed.

Env, as the reference's: ``TAU_VARIANTS`` (``aux_slice,aux_slice_pcrd,
aux_slice_joint``), ``TAU_STEPS`` (800), ``TAU_CHAINS`` (128),
``TAU_WARM_WINDOWS`` (6).  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from auxpm_tpu_torch.utils.diagnostics import effective_sample_size

CHUNK = 25
VARIANTS = "aux_slice,aux_slice_pcrd,aux_slice_joint"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_step(name, target):
    from auxpm_tpu_torch.samplers import composite

    if name.startswith("aux_slice"):
        return composite.SAMPLERS[name](target, n_ess=4)
    return composite.SAMPLERS[name](target)


def initial_params(target, name):
    import torch

    def widths():
        return torch.full((target.d,), 2.0, dtype=torch.float32,
                          device=target.device)

    p = {
        "ess_u": {},
        "slice_theta": {"widths": widths(), "max_step_out": 0},
    }
    if name == "aux_slice_pcrd":
        p["slice_theta_rd"] = {"widths": widths(), "max_step_out": 0}
    if name == "aux_slice_joint":
        p["joint_slice"] = {"width": 2.0, "max_step_out": 0}
    return p


def post_adapt(params, name):
    # mirror adapted per-coordinate widths into groups adapt_params skips
    w = params.get("slice_theta", {}).get("widths")
    if w is not None and name == "aux_slice_pcrd":
        params["slice_theta_rd"] = {"widths": w, "max_step_out": 0}
    params["slice_theta"]["max_step_out"] = 0
    if "joint_slice" in params:
        params["joint_slice"]["max_step_out"] = 0
        params["joint_slice"].setdefault("width", 2.0)
    if name != "aux_slice_joint":
        params.pop("joint_slice", None)
    return {k: v for k, v in params.items()
            if k in ("ess_u", "slice_theta")
            or (k == "slice_theta_rd" and name == "aux_slice_pcrd")
            or (k == "joint_slice" and name == "aux_slice_joint")}


def run_variant(name, x, y, chains=128, steps=800, warm_windows=6,
                device="cuda"):
    """Warm up, adapt, time ``steps // 25`` chunks; prints the variant's line
    and returns ``{"name", "steps_per_s", "tau", "ess", "ess_per_s",
    "wall_s", "warmup_s", "widths", "launches_per_step"}`` (tau and ESS per
    dimension; steps/s counts chain-steps)."""
    from auxpm_tpu_torch._device import resolve_device
    from auxpm_tpu_torch.core.state import init_chain_states
    from auxpm_tpu_torch.models.gp_classification import (
        make_gp_classification,
    )
    from auxpm_tpu_torch.samplers.adaptation import adapt_params
    from auxpm_tpu_torch.samplers.chain import run_chains
    from auxpm_tpu_torch.utils.profiling import (
        device_sync,
        launch_counts,
        launches_since,
    )

    dev = resolve_device(device)
    target = make_gp_classification(x, y, n_importance=64, device=dev)
    step = make_step(name, target)
    states = init_chain_states(0, target, chains, jitter_scale=0.3)
    params = initial_params(target, name)

    t0 = time.perf_counter()
    for _ in range(warm_windows):
        states, recs, infos = run_chains(step, states, params, CHUNK)
        device_sync(states.theta)
        params = post_adapt(adapt_params(params, recs, infos, width_scale=2.5),
                            name)
    warmup_s = time.perf_counter() - t0
    widths = params["slice_theta"]["widths"].cpu().numpy()
    log(f"[{name}] warmup {warmup_s:.1f}s  widths {widths} "
        f"joint_w {params.get('joint_slice', {}).get('width')}")

    thetas = []
    before = launch_counts()
    t0 = time.perf_counter()
    for _ in range(steps // CHUNK):
        states, recs, infos = run_chains(step, states, params, CHUNK)
        thetas.append(recs["theta"])
        device_sync(recs["theta"])
    wall = time.perf_counter() - t0
    n_timed = (steps // CHUNK) * CHUNK
    launches = launches_since(before, n_timed)
    theta = np.concatenate([t.cpu().numpy() for t in thetas], axis=1)
    ess = effective_sample_size(theta)
    n_tot = theta.shape[0] * theta.shape[1]
    tau = n_tot / ess
    sps = n_tot / wall
    essps = float(np.min(ess)) / wall
    print(
        f"{name:18s} steps/s {sps:7.0f}  tau {np.round(tau,0)}  "
        f"ESS {np.round(ess,1)}  ESS/s {essps:5.2f}",
        flush=True,
    )
    log(f"[{name}] launches/step {json.dumps(launches)}")
    return {"name": name, "steps_per_s": sps, "tau": tau.tolist(),
            "ess": ess.tolist(), "ess_per_s": essps, "wall_s": wall,
            "warmup_s": warmup_s, "widths": widths.tolist(),
            "launches_per_step": launches}


def sweep(names, x, y, **kw):
    """``run_variant`` of each name; a variant that raises prints the
    reference's ``FAILED`` line and the sweep goes on.  Returns ``(results,
    failed names)``."""
    results, failed = [], []
    for name in names:
        try:
            results.append(run_variant(name, x, y, **kw))
        except Exception as e:
            print(f"{name:18s} FAILED {type(e).__name__}: {str(e)[:200]}",
                  flush=True)
            failed.append(name)
    return results, failed


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    from auxpm_tpu_torch.models.datasets import load

    if args.device.startswith("cuda") and torch.cuda.is_available():
        log(f"device: {torch.cuda.get_device_name(0)}")
    x, y = load("pima")
    _, failed = sweep(
        os.environ.get("TAU_VARIANTS", VARIANTS).split(","), x, y,
        chains=int(os.environ.get("TAU_CHAINS", 128)),
        steps=int(os.environ.get("TAU_STEPS", 800)),
        warm_windows=int(os.environ.get("TAU_WARM_WINDOWS", 6)),
        device=args.device)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
