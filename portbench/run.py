"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload pima.bench128 --seed 7 \
        --seconds 30 --trace 0

From the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and ``auxpm_tpu_torch/``, on a machine with the cards the cell asks for
(it exits non-zero, printing no result, without them).  ``--trace 0``
measures the cell's end-to-end metrics over a window of ``--seconds``;
``--trace 1`` runs the cell's traced steps and reports its per-layer
metrics.  Either way the sampled chain-steps are then judged by the plain
reference (``check.py``) and the last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(and ``breakdown`` when traced), ``check`` last.  The numbers compared are
also the last lines of standard error.  The program's kernels are built on
the first run into the checkout's ``build/``.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

PB_DIR = Path(__file__).resolve().parent
ROOT = PB_DIR.parent
if sys.path and Path(sys.path[0]).resolve() == PB_DIR:
    sys.path[0] = str(ROOT)          # import the benchmark as ``portbench``
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "auxpm_tpu")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark must not load
    (compared whole: ``auxpm_tpu_torch`` is not ``auxpm_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line():
    """The card's name, power limit, clocks and power draw (nvidia-smi)."""
    q = ("name,power.limit,power.draw,clocks.sm,clocks.max.sm,clocks.mem,"
         "temperature.gpu")
    try:
        r = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(bench, cell, out, nums, limits, device, trace):
    """The result's JSON object (``check`` last)."""
    from portbench import check, harness

    name = cell["name"]
    metrics = {}
    if trace:
        ctx = context(out, cell)
        for m in harness.cell_metrics(bench, name, "per_layer"):
            v = harness.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in harness.cell_metrics(bench, name, "end_to_end"):
            v = end_to_end(m["name"], out)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": out["device_kind"], "count": 1,
           "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": check.verdict(nums, limits) and out["failed"] == 0,
            "attempted": out["chain_steps"], "failed": out["failed"],
            "metrics": metrics, "device": dev}
    if trace:
        tr = out["trace"]
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        top = sorted(tr["device_s_by_name"].items(), key=lambda kv: -kv[1])
        line["breakdown"] = {"device_ops": [[k, v] for k, v in top[:10]],
                             "idle_gaps": [[h, s] for s, h in tr["gaps"]]}
    line["check"] = {k: {"value": nums[k], "limit": limits[k]}
                     for k in check.NUMBERS}
    return line


def end_to_end(name, out):
    """An end-to-end metric by its name."""
    from portbench.yardstick import percentile

    if name == "chain_steps_per_s":
        return out["chain_steps"] / out["window_s"]
    if name == "step_ms_p95":
        return percentile(out["step_ms"], 95) if len(out["step_ms"]) >= 200 \
            else None
    if name == "setup_s":
        return out["setup_s"]
    raise KeyError(f"no end-to-end metric {name!r} in run.py")


def context(out, cell):
    """What a per-layer reader reads (``metrics/<name>.py``): ``n`` is the
    data's rows (what operations and bytes are counted for), ``n_pad`` the
    width the program pads them to (its launch shape)."""
    return {"k": out["trace_k"], "wall_s": out["wall_s"],
            "trace": out["trace"], "work": out["work"],
            "chol_launches": out["chol_launches"], "n": out["n"],
            "n_pad": out["n_pad"],
            "s": out["conf"]["target"]["n_importance"],
            "n_ess": out["conf"]["sampler"]["n_ess"],
            "chains": out["wl"]["chains"]}


def main(argv=None):
    args = parse(argv)
    os.environ.setdefault("USE_FLAX", "0")
    bench_path = ROOT / "BENCHMARK.json"
    if not bench_path.exists():
        log(f"no {bench_path}")
        return 2
    from portbench import check, harness

    log(f"setup: imports done at {time.time() - T_START:.3f} s")
    bench = harness.load_json(bench_path)
    cell, wl, _, conf = harness.find_cell(bench, args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        log(f"cell {cell['name']} needs {cell['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card_line()}")
    log(f"cell {cell['name']} seed {args.seed} seconds {args.seconds} "
        f"trace {args.trace} on {kind}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    out = harness.run_cell(conf, wl, args.seed, args.seconds, args.trace,
                           device="cuda", t_start=T_START, log=log)
    out.update(device_kind=kind, conf=conf, wl=wl)
    log(f"card after: {card_line()}")
    if not args.trace:
        from portbench.yardstick import effective_sample_size

        ess = effective_sample_size(out["theta_window"])
        log(f"window: {out['steps']} steps in {out['window_s']:.4f} s; "
            f"min-ESS {float(ess.min()):.2f} ({out['theta_window'].shape[1]} "
            f"steps x {wl['chains']} chains), min-ESS/s "
            f"{float(ess.min()) / out['window_s']:.4f} (a diagnostic)")
    else:
        tr = out["trace"]
        log(f"trace: gemm kernels {tr['gemm_names']}; chol panel launches "
            f"{out['chol_launches']} in {out['trace_k']} steps")
    log(f"memory peak {out['memory_peak_bytes']} bytes")
    nums, details = check.judge(out, conf, wl, args.seed, "cuda")
    limits = check.limits_of(wl)
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        return 3
    line = result_line(bench, cell, out, nums, limits, "cuda", args.trace)
    log("check details: " + json.dumps(details))
    for k in check.NUMBERS:
        log(f"check {k} {nums[k]!r} limit {limits[k]!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
