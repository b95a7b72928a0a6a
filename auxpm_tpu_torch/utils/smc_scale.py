"""Config 5 at scale: key-as-u SMC over 2^20 particles on one card.

    python -m auxpm_tpu_torch.utils.smc_scale --target toy
    python -m auxpm_tpu_torch.utils.smc_scale --target gp --subsample 32 \
        --n-importance 32 --rejuv aux_nuts --rejuv-batch 16384
    python -m auxpm_tpu_torch.utils.smc_scale --target gp --subsample 0 \
        --u-blocks 8 --particles 16384          # config 5 at full n
    python -m auxpm_tpu_torch.utils.smc_scale --target gp --no-pad \
        --subsample 32 --particles 16384        # n = 32 unpadded
    python -m auxpm_tpu_torch.utils.smc_scale --target toy --particles 1024 \
        --rejuv aux_slice --device cpu          # the CPU, small
    torchrun --nproc-per-node 4 -m auxpm_tpu_torch.utils.smc_scale ...

Counterpart of the reference's ``smc_1m_bench.py``: the same flags and
defaults, the same targets and the same JSON line, key for key.  The run is
``samplers/smc_sharded.make_smc_sharded(..., carry_u=False)``: every particle
keeps the threefry key that generates its u, so the state is ~40 bytes a
particle; u is materialised a chunk of ``--rejuv-batch`` particles at a time
for the independence-MH refresh and the theta-only rejuvenation
(``THETA_ONLY`` of ``--rejuv``: ``aux_nuts`` -> ``nuts``, ``aux_hmc`` ->
``hmc``, ``aux_slice`` -> ``slice_theta``, ``aux_mh`` -> ``mh_theta``).
``--rejuv-batch`` and ``--rejuv-dispatches`` re-chunk the same computation
and change no bit of the result.

The particles are sharded over every rank of the world as chain shards.
Under ``torchrun`` (or any launcher that sets ``RANK`` and ``WORLD_SIZE``)
the world is the launcher's; otherwise ``parallel/launch.spawn`` starts one
rank per visible card (one on the CPU), as the reference's mesh takes every
device.  Rank 0 prints the line and writes ``--out``.

Beside the reference's keys the line holds the card (``device``), the
``rejuv_batch`` used and its ``chunks_per_stage``, ``peak_memory_gb`` (the
card's peak allocation over the run on rank 0; null on the CPU) and
``per_stage``: rank 0's launches of the estimator kernel, the v3 panel, the
weights kernel and the threefry kernel, its collectives and their
milliseconds, and the host reads that NUTS / HMC and ``robust_cholesky``
count, for the init (stage -1) and each stage.

The toy's closed-form log evidence is ``log N(y; 0, prior_var I +
Sigma_y)`` with the toy's default pieces.  A GP target with ``--no-pad``
keeps its n data points (``pad_to_tiles=False``): on the card its estimates
go through the estimator kernels at that n and its factorisations through
the panel route padded with the identity; the line's ``padded`` says which
target ran.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

REJUV_KERNELS = {"aux_nuts": "nuts", "aux_hmc": "hmc",
                 "aux_slice": "slice_theta", "aux_mh": "mh_theta"}
# rank 0's counters reported per stage
STAGE_COUNTS = ("fused_estimator", "chol_panel", "fused_weights",
                "threefry_launches", "collectives", "collective_ms",
                "host_reads")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="auxpm_tpu_torch.utils.smc_scale",
                                description=__doc__)
    p.add_argument("--target", choices=("toy", "gp"), default="toy")
    p.add_argument("--particles", type=int, default=2**20)
    p.add_argument("--subsample", type=int, default=128,
                   help="GP dataset size; 0 = FULL dataset (config-5 full-n)")
    p.add_argument("--no-pad", action="store_true",
                   help="GP: pad_to_tiles=False")
    p.add_argument("--n-importance", type=int, default=32)
    p.add_argument("--rejuv", default="aux_nuts", choices=tuple(REJUV_KERNELS))
    p.add_argument("--n-mcmc", type=int, default=1)
    p.add_argument("--n-u-mh", type=int, default=2)
    p.add_argument("--u-blocks", type=int, default=1,
                   help="blocked u-refresh: one generating key per u "
                        "row-block, IMH-within-Gibbs per block")
    p.add_argument("--rejuv-batch", type=int, default=4096)
    p.add_argument("--rejuv-dispatches", type=int, default=1,
                   help="split each stage's rejuvenation into K contiguous "
                        "groups (changes no bit)")
    p.add_argument("--ess-frac", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="JSON artifact path")
    p.add_argument("--checkpoint-dir", default=None,
                   help="per-stage checkpoint/resume directory")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p.parse_args(argv)


def toy_log_evidence(prior_var=4.0, y=(1.0, -0.5),
                     sigma_y=((1.0, 0.4), (0.4, 0.8))):
    """log Z of the Gaussian toy: ``log N(y; 0, prior_var I + Sigma_y)``."""
    y = np.asarray(y, np.float64)
    c = prior_var * np.eye(len(y)) + np.asarray(sigma_y, np.float64)
    return float(-0.5 * y @ np.linalg.solve(c, y)
                 - 0.5 * np.linalg.slogdet(2 * np.pi * c)[1])


def check_args(args):
    """Refuse what the run cannot do (nothing that the reference runs)."""
    if args.particles < 1 or args.rejuv_batch < 1:
        raise ValueError("--particles and --rejuv-batch must be positive")


def build_target(args, device):
    """The reference's targets (``smc_1m_bench.py``): the toy at S = 16, or
    Pima (``--subsample`` points, 0 = all) at ``--n-importance``."""
    if args.target == "toy":
        from auxpm_tpu_torch.models.gaussian_toy import make_gaussian_toy

        return make_gaussian_toy(n_importance=16, device=str(device))
    from auxpm_tpu_torch.models.datasets import load
    from auxpm_tpu_torch.models.gp_classification import make_gp_classification

    x, y = load("pima", subsample=args.subsample or None, seed=args.seed)
    return make_gp_classification(x, y, n_importance=args.n_importance,
                                  pad_to_tiles=not args.no_pad,
                                  device=str(device))


def rank_run(args):
    """The run on this rank of the launcher's world; returns rank 0's JSON
    line as a dict (with ``_diag``, the unrounded diag), None on the other
    ranks."""
    import torch

    from auxpm_tpu_torch.parallel.collectives import allgather_chains
    from auxpm_tpu_torch.parallel.mesh import distributed_init, make_mesh
    from auxpm_tpu_torch.parallel.rank_jobs import counts
    from auxpm_tpu_torch.samplers.composite import THETA_ONLY
    from auxpm_tpu_torch.samplers.smc_sharded import (
        chunk_size,
        make_smc_sharded,
    )

    dev = distributed_init(args.device)
    check_args(args)
    mesh = make_mesh(1)
    on_gpu = dev.type == "cuda"
    target = build_target(args, dev)
    kind = REJUV_KERNELS[args.rejuv]
    run = make_smc_sharded(
        target, THETA_ONLY[kind], args.particles, mesh, n_mcmc=args.n_mcmc,
        ess_frac=args.ess_frac, carry_u=False, n_u_mh=args.n_u_mh,
        rejuv_batch=args.rejuv_batch, rejuv_dispatches=args.rejuv_dispatches,
        u_blocks=args.u_blocks, checkpoint_dir=args.checkpoint_dir)
    n_local = args.particles // mesh.n_chain_shards
    # the chunk make_smc_sharded takes (inside its dispatch groups)
    group = chunk_size(n_local, max(1, n_local // max(1, args.rejuv_dispatches)))
    chunk = chunk_size(group, args.rejuv_batch)

    def sync():
        if on_gpu:
            torch.cuda.synchronize(dev)

    stages, marks = [], {}

    def on_stage(stage, beta):
        sync()
        now, at = counts(), time.perf_counter()
        if stage == -1:
            marks["init_wall"] = at - marks["t0"]
        prev = marks.get("counts", before)
        stages.append({"stage": stage, "beta": round(float(beta), 4),
                       **{k: (round(now[k] - prev[k], 3)
                              if isinstance(now[k], float)
                              else now[k] - prev[k]) for k in STAGE_COUNTS}})
        marks["counts"] = now

    if on_gpu:
        torch.cuda.reset_peak_memory_stats(dev)
    sync()
    before = counts()
    marks["t0"] = time.perf_counter()
    states, diag = run(args.seed, on_stage=on_stage)
    sync()
    wall = time.perf_counter() - marks["t0"]
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if on_gpu else None
    theta = allgather_chains(states.theta, mesh)
    if mesh.rank != 0:
        return None
    theta = theta.cpu().numpy().astype(np.float64)
    out = {
        "metric": "smc_1m_particles",
        "target": target.name,
        "particles": args.particles,
        "devices": mesh.world,
        "rejuvenation": f"{kind} (theta-only, carry_u=False)",
        "u_blocks": args.u_blocks,
        "padded": not args.no_pad if args.target == "gp" else None,
        "n_stages": diag["n_stages"],
        "wall_total": round(wall, 2),
        "init_wall": round(marks["init_wall"], 3),
        "stage_wall": [round(s, 3) for s in diag["stage_seconds"]],
        "log_z": round(diag["log_z"], 4),
        "betas": [round(b, 4) for b in diag["betas"]],
        "u_mh_accept": [round(a, 4) for a in diag["u_mh_accept"]],
        "posterior_mean": np.round(theta.mean(0), 4).tolist(),
        "posterior_std": np.round(theta.std(0), 4).tolist(),
    }
    if args.target == "toy":
        log_z_true = toy_log_evidence()
        out["log_z_true"] = round(log_z_true, 4)
        out["log_z_abs_err"] = round(abs(diag["log_z"] - log_z_true), 4)
    out.update({
        "device": torch.cuda.get_device_name(dev) if on_gpu else "cpu",
        "rejuv_batch": chunk, "chunks_per_stage": n_local // chunk,
        "peak_memory_gb": peak, "per_stage": stages,
        "_diag": diag})
    return out


def main(argv=None, result=None):
    """Run, print rank 0's JSON line and write ``--out``; returns 0.
    ``result``: an optional dict that gets the line (``out``) and the
    unrounded diag (``diag``)."""
    args = parse_args(argv)
    from auxpm_tpu_torch._device import resolve_device

    device = resolve_device(args.device)    # no GPU: raises, never the CPU
    check_args(args)
    import torch

    from auxpm_tpu_torch.parallel.launch import on_world

    on_gpu = device.type == "cuda"     # spawned: a rank per card, one on CPU
    out = on_world(rank_run, torch.cuda.device_count() if on_gpu else 1,
                   args, timeout_s=24 * 3600, threads=0 if on_gpu else 1)
    if out is None:                          # not rank 0
        return 0
    diag = out.pop("_diag")
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        log(f"artifact written to {args.out}")
    if result is not None:
        result.update(out=out, diag=diag)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
