"""The check's controls, on the chip at a cell's own size (not part of a
benchmark run).

    python3 portbench/control.py --workload pima.bench128 \
        --seeds 11,12,13 --seconds 10

For each seed, in one process: a sound run of the cell (its check numbers
are the lower readings), the reference put in the program's place at the
next precision below the configuration's (TF32 products, ``reference/
gp.py``) on that run's sampled chain-steps, and the program with its own
lower-precision path switched on (``whiten_dtype`` of the configuration's
``precision.control_whiten_dtype``).  Each control's numbers come from the
same judge as the program's.  One JSON line per seed and control on
standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "portbench":
    sys.path[0] = str(ROOT)


def pad_factor(prob, l):
    """A real-row factor embedded at the program's padded width."""
    import torch

    out = torch.eye(prob.n_pad, dtype=torch.float64, device=prob.device)
    out *= (1.0 + prob.jitter) ** 0.5
    out[:prob.n, :prob.n] = l.double()
    return out


def tf32_control(out, conf, wl, device):
    """The reference at TF32 in the program's place on ``out``'s sampled
    chain-steps (from the program's state before each), judged as the
    program is judged."""
    from portbench import check
    from portbench.reference.gp import GPProblem
    from portbench.reference.step import replay

    t, s = conf["target"], conf["sampler"]
    ref = GPProblem(out["x"], out["y"], t, device)
    low = GPProblem(out["x"], out["y"], t, device, prec="tf32")
    chk = wl["check"]
    params = {"widths": out["widths"].float().cpu().tolist(),
              "max_step_out": s["max_step_out"],
              "max_shrink_chol": s["max_shrink_chol"]}
    nums = {k: 0.0 for k in check.NUMBERS}
    for c, j in check.select(out["kept"], chk["max_chain_steps"]):
        pre = {k: v[j] for k, v in out["kept"][c][1]["pre"].items()}
        l_pre = pad_factor(ref, low.chol(float(pre["theta"][0])))
        post, dec = replay(low, pre, params, s)
        post_pad = {"theta": post["theta"], "u": post["u"],
                    "key": post["key"], "ll": post["ll"],
                    "chol": pad_factor(ref, post["chol"]),
                    "ell": [pad_factor(ref, l) for _, l in post["ell"]],
                    "margins": dec.margins[post["slice_from"]:]}
        th = post["theta"].double()
        nums["factor_resid"] = max(
            nums["factor_resid"],
            ref.factor_resid(post_pad["chol"], float(th[0])))
        nums["ll_gap"] = max(nums["ll_gap"], abs(post["ll"] - ref.log_lik(
            th, post["chol"].double(), post["u"].double())))
        gap, key_ok, m_gap, resid, _ = check.judge_step(
            ref, {**pre, "chol": l_pre}, post_pad, params, s, chk)
        nums["state_gap"] = max(nums["state_gap"], gap)
        nums["key_gap"] += 0 if key_ok else 1
        nums["ll_gap"] = max(nums["ll_gap"], m_gap)
        nums["factor_resid"] = max(nums["factor_resid"], resid)
    return nums


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from portbench import check, harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    _, wl, _, conf = harness.find_cell(bench, args.workload, ROOT)
    low_dtype = conf["precision"]["control_whiten_dtype"]

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    for seed in [int(x) for x in args.seeds.split(",")]:
        for kind in ("program", low_dtype):
            out = harness.run_cell(
                conf, wl, seed, args.seconds, 0, device=args.device,
                whiten_dtype=None if kind == "program" else kind, log=log)
            nums, det = check.judge(out, conf, wl, seed, args.device)
            print(json.dumps({"seed": seed, "run": kind, **nums,
                              "details": det}), flush=True)
            if kind == "program":
                tnums = tf32_control(out, conf, wl, args.device)
                print(json.dumps({"seed": seed, "run": "tf32_reference",
                                  **tnums}), flush=True)
            del out
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
