"""Side by side on one card: the sweep-body kernels and the ARD Gram of two
trees of the port.

    python -m auxpm_tpu_torch.utils.body_ab --parent DIR [--rounds 2]
        [--out chiprun_out/body_ab.json]

``DIR`` is the root of another checkout of the repo (for example the parent
commit, unpacked with ``git archive``); the other tree is the one this file
belongs to.  Both trees build their kernels at once (each into its own
``build/``), then each tree runs in a process of its own, in the order
parent, change, change, parent (``--rounds`` times), and times at config 2's
shapes (B = 128, S = 64, n = 640 with 532 real points, logistic, 8 weight
blocks): the four entries of ``csrc/fused_estimator.cu``, the ESS sweep
(4 repeats) and the sigma sweep (2 repeats), and the ARD Gram of
``csrc/se_gram.cu`` (d = 8, B = 64 and 128).  Two times each: ``ms``, the
median of CUDA-event times over ``--reps`` single calls (sweeps: a third as
many), each after a 256 MB write that evicts the L2 (the wrapper's host work
inside the window, as a caller sees it); and ``stream_ms``, the median over
5 windows of 20 calls queued back to back, per call (the card's own time:
the host queues faster than the kernels run; C, 210 MB, does not fit in the
50 MB L2 either way).  Each tree's registers, stack and spills per kernel
come from its ``build/nvcc.log``.  The first run of each tree also
saves every kernel's outputs at the shapes earlier slices ran (S <= 64, n a
multiple of 64) on fixed-seed inputs, and the two trees' outputs are
compared bit for bit.  Prints the card (``nvidia-smi``) and one JSON line:
the per-run times, each kernel's median over a tree's runs, change / parent,
and the bitwise verdicts.  Needs a GPU and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

THIS_TREE = Path(__file__).resolve().parents[2]

# config 2's shapes
B, S, N, N_REAL, N_BLOCKS = 128, 64, 640, 532, 8
# the shapes earlier slices ran, for the bitwise comparison: (B, S, n)
OLD_SHAPES = ((128, 64, 640), (8, 64, 1024), (128, 32, 640), (128, 40, 640),
              (4, 8, 128))


def _in_tree(root, argv):
    """Runs this file in a process whose ``auxpm_tpu_torch`` is ``root``'s."""
    code = ("import runpy, sys; sys.path.insert(0, sys.argv[1]); "
            "sys.argv = [sys.argv[2]] + sys.argv[3:]; "
            "runpy.run_path(sys.argv[0], run_name='__main__')")
    return [sys.executable, "-c", code, str(root), __file__, *argv]


def _inputs(torch, np, rng, dev, b, s, n, n_real):
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    chol = t(np.tril(rng.standard_normal((b, n, n)) * 0.03) + np.eye(n))
    u = t(rng.standard_normal((b, s, n)))
    v = t(rng.standard_normal((b, s, n)))
    ang = t(rng.uniform(-3.0, 3.0, b))
    y = t(rng.choice([-1.0, 1.0], n))
    mask = t((np.arange(n) < n_real).astype(np.float32))
    return t, chol, u, v, ang, y, mask


def _sweep_inputs(torch, np, rng, t, est, b, s, n, n_ess=4, n_sigma=2):
    dev = est.device
    vv = t(rng.standard_normal((b, n_ess, s, n)))
    scal = t(np.concatenate([
        np.zeros((b, n_ess, 1)), np.log(rng.uniform(size=(b, n_ess, 1))),
        rng.uniform(size=(b, n_ess, 1)) * 6.28,
        rng.uniform(size=(b, n_ess, 32))], axis=2))
    scal[:, 0, 0] = est
    rep = t(rng.uniform(size=(b, n_sigma, 34)))
    rep[:, :, 0] = torch.log(rep[:, :, 0])
    z = torch.zeros(b, device=dev)
    chain = torch.stack([est, est - 2.0, z, z + 1.2, z, z + 0.22, z - 1.0, z],
                        1).contiguous()
    return vv, scal, chain, rep


def _gram_inputs(torch, np, rng, t, b, n, n_real, d=8):
    x = np.zeros((n, d), np.float32)
    x[:n_real] = rng.standard_normal((n_real, d))
    le = t(rng.normal(size=(b, d)) * 0.5)
    mask = t((np.arange(n) < n_real).astype(np.float32))
    return t(x), le, mask


def measure(reps, dump):
    """One tree's kernel ms at config 2's shapes (and its outputs at the
    old shapes into ``dump`` if given); prints one JSON line."""
    import numpy as np
    import torch

    from auxpm_tpu_torch.ops import ess_sweep as ess
    from auxpm_tpu_torch.ops import fused_estimator as fe
    from auxpm_tpu_torch.ops import gram as gr
    from auxpm_tpu_torch.ops import sigma_sweep as sig

    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)

    def window(fn, calls):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        z.record()
        torch.cuda.synchronize()
        return a.elapsed_time(z) / calls

    def ms(fn, n_reps):
        fn()
        torch.cuda.synchronize()
        single = []
        for _ in range(n_reps):
            flush.zero_()
            single.append(window(fn, 1))
        stream = [window(fn, 20) for _ in range(5)]
        return [float(np.median(single)), float(np.median(stream))]

    rng = np.random.default_rng(16)
    t, chol, u, v, ang, y, mask = _inputs(torch, np, rng, dev, B, S, N,
                                          N_REAL)
    est = fe.fused_estimate(chol, u, y, mask, "logistic", N_BLOCKS)
    vv, scal, chain, rep = _sweep_inputs(torch, np, rng, t, est, B, S, N)
    res = {
        "fused_estimate": ms(lambda: fe.fused_estimate(
            chol, u, y, mask, "logistic", N_BLOCKS), reps),
        "fused_estimate_rot": ms(lambda: fe.fused_estimate_rot(
            chol, u, v, ang, y, mask, "logistic", N_BLOCKS), reps),
        "fused_weights": ms(lambda: fe.fused_weights(chol, u, y, mask),
                            reps),
        "fused_rot_weights": ms(lambda: fe.fused_rot_weights(
            chol, u, v, ang, y, mask), reps),
        "ess_sweep": ms(lambda: ess.ess_sweep(
            chol, u, scal, vv, y, mask, "logistic", N_BLOCKS, None, 4),
            max(1, reps // 3)),
        "sigma_sweep": ms(lambda: sig.sigma_sweep(
            chol, u, chain, rep, y, mask, "logistic", N_BLOCKS, None, 2),
            max(1, reps // 3)),
    }
    for b_gram in (64, 128):
        x, le, gmask = _gram_inputs(torch, np, rng, t, b_gram, N, N_REAL)
        res[f"se_gram_ard B={b_gram}"] = ms(
            lambda: gr.se_gram_ard_hopper(x, le, 1e-3, gmask), reps)
    if dump:
        torch.save(_old_shape_outputs(torch, np, dev), dump)
    print("MEASURED " + json.dumps(res), flush=True)


def ptxas_info(log_path):
    """{kernel: [registers, stack bytes, spill store bytes, spill load
    bytes]} of the sweep-body and Gram kernels in an nvcc log."""
    import re

    info, entry, props = {}, None, None
    for line in Path(log_path).read_text().splitlines():
        m = re.search(r"Compiling entry function '(_Z\w+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Function properties for (_Z\w+)", line)
        if m:
            props = m.group(1)
            continue
        k = entry and re.search(
            r"\d+((?:fused|ess|sigma|se)_\w*?kernel)(I(?:L[ib]\d+E)+)?",
            entry)
        if not k:
            continue
        name = k.group(1) + (k.group(2) or "")
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props == entry:
            info[name] = [None, *map(int, m.groups())]
        m = re.search(r"Used (\d+) registers", line)
        if m and name in info:
            info[name][0] = int(m.group(1))
            entry = None
    return info


def _old_shape_outputs(torch, np, dev):
    """Every kernel's outputs at ``OLD_SHAPES`` on fixed-seed inputs."""
    from auxpm_tpu_torch.ops import ess_sweep as ess
    from auxpm_tpu_torch.ops import fused_estimator as fe
    from auxpm_tpu_torch.ops import gram as gr
    from auxpm_tpu_torch.ops import sigma_sweep as sig

    rng = np.random.default_rng(7)
    out = {}
    for b, s, n in OLD_SHAPES:
        t, chol, u, v, ang, y, mask = _inputs(torch, np, rng, dev, b, s, n,
                                              n - 37)
        act = (torch.arange(b, device=dev) % 3 != 0).float()
        nb = 8 if s % 8 == 0 else 1
        k = f"B={b} S={s} n={n}"
        est = fe.fused_estimate(chol, u, y, mask, "logistic", nb)
        out[k + " estimate"] = est
        out[k + " estimate probit"] = fe.fused_estimate(
            chol, u, y, mask, "probit", nb)
        out[k + " estimate bf16"] = fe.fused_estimate(
            chol, u, y, mask, "logistic", nb, None, "bfloat16")
        out[k + " estimate_rot"] = fe.fused_estimate_rot(
            chol, u, v, ang, y, mask, "logistic", nb, None, "float32", act)
        out[k + " weights"] = fe.fused_weights(chol, u, y, mask)
        out[k + " rot_weights"] = fe.fused_rot_weights(
            chol, u, v, ang, y, mask, "logistic", "float32", act)
        vv, scal, chain, rep = _sweep_inputs(torch, np, rng, t, est, b, s, n,
                                             n_ess=3)
        for i, o in enumerate(ess.ess_sweep(chol, u, scal, vv, y, mask,
                                            "logistic", nb, None, 3)):
            out[f"{k} ess_sweep {i}"] = o
        for i, o in enumerate(sig.sigma_sweep(chol, u, chain, rep, y, mask,
                                              "logistic", nb, None, 2)):
            out[f"{k} sigma_sweep {i}"] = o
    x, le, gmask = _gram_inputs(torch, np, rng, t, 64, 640, 600, d=7)
    out["se_gram_ard masked"] = gr.se_gram_ard_hopper(x, le, 1e-5, gmask)
    out["se_gram_ard"] = gr.se_gram_ard_hopper(x, le, 1e-5)
    torch.cuda.synchronize()
    return {k_: v_.cpu() for k_, v_ in out.items()}


def build():
    from auxpm_tpu_torch.ops import _build
    _build.build()
    _build.load_library()
    print("BUILT", flush=True)


def compare(parent, rounds, reps, work):
    """Builds both trees at once, runs them in turns; the report dict."""
    import torch

    trees = {"parent": Path(parent).resolve(), "change": THIS_TREE}
    builds = {name: subprocess.Popen(_in_tree(root, ["--build"]), cwd=root,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
              for name, root in trees.items()}
    for name, proc in builds.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name} tree did not build:\n{log[-4000:]}")
    order = ["parent", "change", "change", "parent"] * rounds
    runs, dumps = [], {}
    for name in order:
        argv = ["--measure", "--reps", str(reps)]
        if name not in dumps:
            dumps[name] = os.path.join(work, f"{name}.pt")
            argv += ["--dump", dumps[name]]
        proc = subprocess.run(_in_tree(trees[name], argv), cwd=trees[name],
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("MEASURED ")]
        if proc.returncode != 0 or not lines:
            raise RuntimeError(f"{name} run failed:\n{proc.stdout[-2000:]}"
                               f"\n{proc.stderr[-4000:]}")
        runs.append({"tree": name, "ms": json.loads(lines[-1][9:])})
    median = {}
    for name in trees:
        per = [r["ms"] for r in runs if r["tree"] == name]
        median[name] = {
            k: [float(torch.tensor([p[k][i] for p in per]).median())
                for i in range(2)] for k in per[0]}
    ratio = {k: [median["change"][k][i] / median["parent"][k][i]
                 for i in range(2)] for k in median["parent"]}
    a, b = (torch.load(dumps[n]) for n in ("parent", "change"))
    bitwise = {k: bool(k in b and a[k].shape == b[k].shape
                       and torch.equal(a[k].view(torch.int32)
                                       if a[k].dtype == torch.float32
                                       else a[k],
                                       b[k].view(torch.int32)
                                       if b[k].dtype == torch.float32
                                       else b[k]))
               for k in a}
    return {"parent": str(trees["parent"]), "order": order,
            "times": "[ms, stream_ms]", "runs": runs,
            "median_ms": median, "change_over_parent": ratio,
            "ptxas": {name: ptxas_info(root / "build" / "nvcc.log")
                      for name, root in trees.items()},
            "outputs_compared": len(bitwise),
            "outputs_bitwise_equal": sum(bitwise.values()),
            "outputs_differing": [k for k, v in bitwise.items() if not v]}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--parent", help="root of the other tree")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--reps", type=int, default=15)
    p.add_argument("--out", default=None, help="also write the JSON here")
    p.add_argument("--build", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--dump", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.build:
        return build()
    if args.measure:
        return measure(args.reps, args.dump)
    if not args.parent:
        p.error("--parent is required")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as work:
        report = compare(args.parent, args.rounds, args.reps, work)
    report["card"] = card
    line = json.dumps(report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0 if not report["outputs_differing"] else 1


if __name__ == "__main__":
    sys.exit(main())
