"""A/B micro-benchmark: the slice-theta levers of ``aux_slice``, one at a time.

    python -m auxpm_tpu_torch.utils.theta_bench [--device cpu]

Counterpart of ``scripts/theta_bench.py``.  Measures ms per FULL
``aux_slice`` step (ESS + slice-theta) at the bench shape (Pima n=532 padded
to 640, S=64, 128 chains, ``n_ess=4``, ``n_sigma_extra=1``, widths [0.24,
0.52], ``max_step_out=0``, seed 0, ``jitter_scale=0.3``) for the ladder

  (a) no carried factor (``with_cache=False``), log_sigma probed one probe
      at a time (``AUXPM_SIGMA_SWEEP=0``), no cap;
  (b) + the carried factor (the same trajectory, bit for bit);
  (c) + the whole-sigma-slice sweep (``csrc/sigma_sweep.cu``);
  (d) + ``max_shrink_chol = AB_CAP``;

plus a one-step parity check of (a) against (b), both with
``AUXPM_SIGMA_SWEEP=0``: the carried factor must not change a bit.  Each rung
runs ``AB_STEPS`` steps from the same initial states twice, once to warm up
and once timed, each closed by ``utils/profiling.device_sync``.  Prints the
reference's one JSON line (same keys); the progress lines, with each rung's
kernel launches per step, go to stderr.  The environment switch is set only
while a step is built (where the samplers read it) and restored after.

Env, as the reference's: ``BENCH_CHAINS`` (128), ``BENCH_S`` (64),
``BENCH_N_ESS`` (4), ``BENCH_SIGMA_EXTRA`` (1), ``AB_STEPS`` (40), ``AB_CAP``
(4).  Runs on the card unless ``--device cpu`` (the plain versions of the
kernels; the times are then CPU times).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


@contextlib.contextmanager
def environ(name, value):
    """``os.environ[name] = value`` inside the block, the old value (or its
    absence) restored after it."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def build_step(target, n_ess, sigma_extra, sigma_sweep):
    """``aux_slice`` built with ``AUXPM_SIGMA_SWEEP`` set as asked."""
    from auxpm_tpu_torch.samplers.composite import make_aux_slice

    with environ("AUXPM_SIGMA_SWEEP", "1" if sigma_sweep else "0"):
        return make_aux_slice(target, n_ess=n_ess, n_sigma_extra=sigma_extra)


def time_step(step, states, params, label, steps):
    """Seconds per step of ``steps`` steps from ``states``: a first run to
    warm up, then the timed one, each closed by ``device_sync``.  Returns
    ``(seconds per step, launches per step of the timed run)``."""
    import torch

    from auxpm_tpu_torch.utils.profiling import (
        device_sync,
        launch_counts,
        launches_since,
    )

    def many(ss):
        n_probe = []
        for _ in range(steps):
            ss, info = step(ss, params)
            n_probe.append(info["slice_theta/n_probe"])
        return ss, torch.stack(n_probe)

    t0 = time.perf_counter()
    out, _ = many(states)
    device_sync(out.theta)
    log(f"{label}: warm-up {time.perf_counter() - t0:.1f}s")
    before = launch_counts()
    t0 = time.perf_counter()
    out, npb = many(states)
    device_sync(out.theta)
    dt = time.perf_counter() - t0
    launches = launches_since(before, steps)
    log(f"{label}: {1e3 * dt / steps:.2f} ms/step "
        f"(mean slice probes {float(npb.mean()):.2f}) launches/step "
        f"{json.dumps(launches)}")
    return dt / steps, launches


def bench(x, y, chains=128, s=64, n_ess=4, sigma_extra=1, steps=40, cap=4,
          device="cuda"):
    """The ladder on the target of ``(x, y)``; returns the reference's keys
    (unrounded) plus ``"launches_per_step"`` by rung."""
    import torch

    from auxpm_tpu_torch._device import resolve_device
    from auxpm_tpu_torch.core.state import init_chain_states
    from auxpm_tpu_torch.models.gp_classification import (
        make_gp_classification,
    )

    dev = resolve_device(device)
    log("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu")
    target = make_gp_classification(x, y, n_importance=s, device=dev)
    params = {
        "slice_theta": {"widths": torch.tensor([0.24, 0.52],
                                               dtype=torch.float32,
                                               device=dev),
                        "max_step_out": 0},
        "ess_u": {},
    }
    params_cap = {
        "slice_theta": {**params["slice_theta"], "max_shrink_chol": cap},
        "ess_u": {},
    }
    s_nc = init_chain_states(0, target, chains, jitter_scale=0.3)
    s_c = init_chain_states(0, target, chains, jitter_scale=0.3,
                            with_cache=True)

    # one-step parity (a) vs (b): the carried factor must not change a bit.
    # Both take the per-probe log_sigma path (the sweep is lever (c))
    step_nosweep = build_step(target, n_ess, sigma_extra, sigma_sweep=False)
    o1, _ = step_nosweep(s_nc, params)
    o2, _ = step_nosweep(s_c, params)
    dth = float((o1.theta - o2.theta).abs().max())
    dll = float((o1.log_lik_hat - o2.log_lik_hat).abs().max())
    log(f"cache parity (sigma sweep off): max|dth|={dth:.3e} "
        f"max|dll|={dll:.3e}")

    launches = {}
    ms_a, launches["a"] = time_step(step_nosweep, s_nc, params,
                                    "(a) no carried factor ", steps)
    ms_b, launches["b"] = time_step(step_nosweep, s_c, params,
                                    "(b) + carried factor  ", steps)
    step_sweep = build_step(target, n_ess, sigma_extra, sigma_sweep=True)
    ms_c, launches["c"] = time_step(step_sweep, s_c, params,
                                    "(c) + sigma sweep     ", steps)
    ms_d, launches["d"] = time_step(step_sweep, s_c, params_cap,
                                    f"(d) + chol cap {cap}      ", steps)
    return {"baseline_ms": 1e3 * ms_a, "cache_ms": 1e3 * ms_b,
            "sigma_sweep_ms": 1e3 * ms_c, "cap_ms": 1e3 * ms_d,
            "cache_speedup": ms_a / ms_b, "total_speedup": ms_a / ms_d,
            "parity_dth": dth, "parity_dll": dll,
            "launches_per_step": launches}


def result_line(r):
    """The reference's JSON line, its formats and keys."""
    return (
        f'{{"baseline_ms": {r["baseline_ms"]:.2f}, '
        f'"cache_ms": {r["cache_ms"]:.2f}, '
        f'"sigma_sweep_ms": {r["sigma_sweep_ms"]:.2f}, '
        f'"cap_ms": {r["cap_ms"]:.2f}, '
        f'"cache_speedup": {r["cache_speedup"]:.3f}, '
        f'"total_speedup": {r["total_speedup"]:.3f}, '
        f'"parity_dth": {r["parity_dth"]:.3e}, '
        f'"parity_dll": {r["parity_dll"]:.3e}}}'
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
              sigma_extra=int(os.environ.get("BENCH_SIGMA_EXTRA", 1)),
              steps=int(os.environ.get("AB_STEPS", 40)),
              cap=int(os.environ.get("AB_CAP", 4)),
              device=args.device)
    print(result_line(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
