"""CLI entry point.

    python -m auxpm_tpu_torch.run --preset pima_aux_slice --chains 128 \
        --max-step-out 0 --n-ess 4 --n-sigma-extra 1 --max-shrink-chol 3
    python -m auxpm_tpu_torch.run --preset pima_ard_aux
    AUXPM_ESS_SWEEP=0 python -m auxpm_tpu_torch.run --preset pima_ard_aux
    python -m auxpm_tpu_torch.run --preset toy_pm_mh --device cpu
    python -m auxpm_tpu_torch.run --preset abalone_aux [--subsample 0]
    python -m auxpm_tpu_torch.run --sampler pm_mh       # or aux_mh, on Pima
    python -m auxpm_tpu_torch.run --sampler aux_slice_pcrd  # or aux_slice_rd,
        # aux_slice_joint, joint_slice, joint_mh
    python -m auxpm_tpu_torch.run --proposal laplace --n-importance 16
    python -m auxpm_tpu_torch.run --sampler aux_nuts --chains 128  # aux_hmc
    python -m auxpm_tpu_torch.run --sampler smc --particles 1024 \
        --smc-rejuvenation aux_nuts          # aux_slice, aux_hmc
    python -m auxpm_tpu_torch.run --preset smc_toy --device cpu
    torchrun --nproc-per-node 2 -m auxpm_tpu_torch.run --preset smc_gp_nuts
    torchrun --nproc-per-node 2 -m auxpm_tpu_torch.run --sampler smc \
        --sharded true --smc-rejuvenation aux_slice     # u carried
    python -m auxpm_tpu_torch.run --preset pima_aux_slice \
        --checkpoint-dir ckpt --checkpoint-every 2 --profile-dir prof \
        --plots fig --metrics-path metrics.jsonl
    python -m auxpm_tpu_torch.run --list-presets
    torchrun --nproc-per-node 2 -m auxpm_tpu_torch.run --sharded true \
        --particle-shards 2 --preset pima_aux_slice --max-step-out 0 ...
    torchrun --nproc-per-node 2 -m auxpm_tpu_torch.run --sharded true \
        --particle-shards 2 --sampler aux_nuts      # or aux_hmc
    python -m auxpm_tpu_torch.run --proposal laplace --n-importance 16 \
        --sampler aux_nuts     # aux_hmc; --sampler smc --smc-rejuvenation
    torchrun --nproc-per-node 2 -m auxpm_tpu_torch.run --proposal laplace \
        --n-importance 16 --sharded true --particle-shards 2
    torchrun --nproc-per-node 4 -m auxpm_tpu_torch.run --preset gp_4096_sharded
    torchrun --nnodes 2 --node-rank 0 --nproc-per-node 4 \
        --rdzv-endpoint HOST:PORT -m auxpm_tpu_torch.run --multihost true \
        --preset gp_4096_sharded      # and --node-rank 1 on the other node

``--sharded true`` runs on the ``torch.distributed`` world that ``torchrun``
started: ``world / K`` chain shards by ``--particle-shards K`` particle shards
(``parallel/mesh.py``).  With K > 1 each chain's S importance samples are
split over the K ranks of a particle group and the estimator's log-sum-exp is
a collective; global rank 0 alone prints and writes ``--out`` and the
metrics, and checkpoint shards land in one shared directory.  Every chain
draws from its own key, so the records are the same on any number of chain
shards.  One card per rank runs on NCCL; ranks that share a card (or the CPU)
on gloo.  ``--multihost true`` (with ``--sharded true``) runs the same path
over several nodes, each started by ``torchrun --nnodes N --node-rank i
--nproc-per-node M --rdzv-endpoint HOST:PORT``; it refuses a world that does
not span several nodes.  ``--preset gp_4096_sharded`` is config 4: 4096
chains, chain-sharded.  Every sampler runs on particle shards, ``aux_hmc``
and ``aux_nuts`` too (their gradient's theta cotangent is summed over the
group, ``parallel/collectives.particle_grad_sum``; warm-up adapts each
chain's step size from statistics that are bitwise the same on every rank of
its group), and so does ``--proposal laplace``, whose Newton fit runs
replicated on every rank.  The gradient samplers take the Laplace proposal
too, single-device, on particle shards and as SMC rejuvenation (sharded SMC
included).

``AUXPM_ESS_SWEEP=0`` in the environment sends the elliptical-slice update
through its per-probe loop instead of the whole-sweep kernel.

Counterpart of ``auxpm_tpu/run.py``: warm-up windows with global adaptation,
a main run with windowed metrics (optionally under a ``torch.profiler``
trace, ``--profile-dir``, and checkpointed every ``--checkpoint-every``
windows into ``--checkpoint-dir``; ``utils/checkpoint.load_checkpoint``
resumes from it bit for bit), posterior summaries and ESS/sec on exit as one
JSON line, and with ``--plots PREFIX`` the trace, density and autocorrelation
figures (matplotlib).  The carried Cholesky factor is used by the
``aux_slice`` family only, as in the reference: the other samplers would
only refresh it, one more factorisation per step.  ``aux_hmc`` and
``aux_nuts`` warm up with per-chain dual averaging of the step size and a
diagonal mass per window (``samplers/adaptation.warmup``).  ``--sampler
smc`` runs the single-device tempering SMC (``samplers/smc.py``) with the
rejuvenation ``--smc-rejuvenation`` and prints one ``smc_summary`` line;
with ``--sharded true`` the population is sharded over the ranks
(``samplers/smc_sharded.py``), with u carried or, under ``--smc-carry-u
false`` (the preset ``smc_gp_nuts``), kept as its generating keys and the
rejuvenation mapped to its theta-only kernel (``aux_nuts`` -> ``nuts``,
``aux_hmc`` -> ``hmc``, ``aux_mh`` -> ``mh_theta``, ``aux_slice`` and
``aux_slice_rd`` -> ``slice_theta``); ``--particle-shards`` must then be 1.
Runs on the GPU unless ``--device cpu`` is given; without a GPU and without
that flag it raises.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time

import numpy as np


def parse_args(argv=None):
    from auxpm_tpu_torch.utils.config import PRESETS, RunConfig

    p = argparse.ArgumentParser(prog="auxpm_tpu_torch.run", description=__doc__)
    p.add_argument("--preset", default="pima_aux_slice", choices=sorted(PRESETS))
    p.add_argument("--list-presets", action="store_true")
    for f in dataclasses.fields(RunConfig):
        if f.name == "preset":
            continue
        arg = "--" + f.name.replace("_", "-")
        if f.type in ("bool", bool):
            p.add_argument(arg, type=lambda s: s.lower() in ("1", "true", "yes"),
                           default=None)
        elif f.type in ("int", int, "Optional[int]"):
            p.add_argument(arg, type=int, default=None)
        elif f.type in ("float", float):
            p.add_argument(arg, type=float, default=None)
        else:
            p.add_argument(arg, type=str, default=None)
    return p.parse_args(argv)


def main(argv=None, result=None):
    """Run the configured sampler; returns the exit code.

    ``result``: optional dict that is filled with the final ``states``,
    ``params``, the ``target``, the ``step``, the recorded ``theta``, the
    per-window metrics (``windows``) and the warm-up's (``history``), the
    ``summary``, the checkpoint's
    ``config`` (what ``load_checkpoint`` hashes) and, for a sharded run,
    this rank's ``mesh`` (states and target are then the rank's share), for
    a caller that drives the CLI from Python."""
    args = parse_args(argv)
    from auxpm_tpu_torch.utils.config import (
        PRESETS,
        build_target,
        initial_params,
        unsupported,
    )

    if args.list_presets:
        for name, cfg in sorted(PRESETS.items()):
            print(f"{name}: {cfg}")
        return 0

    cfg = PRESETS[args.preset]
    overrides = {
        k: v
        for k, v in vars(args).items()
        if k not in ("preset", "list_presets") and v is not None
    }
    cfg = cfg.replace(**overrides)
    unsupported(cfg)   # before a world is joined or a target built

    import torch

    from auxpm_tpu_torch._device import resolve_device
    from auxpm_tpu_torch.core.state import init_chain_states
    from auxpm_tpu_torch.samplers.adaptation import warmup
    from auxpm_tpu_torch.samplers.chain import run_chains
    from auxpm_tpu_torch.samplers.composite import SAMPLERS
    from auxpm_tpu_torch.utils.diagnostics import (
        effective_sample_size,
        potential_scale_reduction,
    )
    from auxpm_tpu_torch.utils.metrics import MetricsWriter, logger

    mesh = None
    if cfg.sharded:
        from auxpm_tpu_torch.parallel.mesh import distributed_init, make_mesh

        world = int(os.environ.get("WORLD_SIZE", "0"))
        if 0 < world < cfg.particle_shards:
            raise RuntimeError(
                f"--particle-shards {cfg.particle_shards} needs at least "
                f"that many ranks, the world has {world}; start them with "
                f"`torchrun --nproc-per-node {cfg.particle_shards} -m "
                "auxpm_tpu_torch.run --sharded true ...`")
        # raises without a world (or, with --multihost, without one that
        # spans several nodes)
        device = distributed_init(cfg.device, multihost=cfg.multihost)
        cfg = cfg.replace(device=str(device))
        mesh = make_mesh(cfg.particle_shards)
    else:
        device = resolve_device(cfg.device)
    lead = mesh is None or mesh.rank == 0      # the rank that reports
    on_gpu = device.type == "cuda"
    device_name = torch.cuda.get_device_name(device) if on_gpu else "cpu"
    if lead:
        logger.info(f"preset={cfg.preset} device={device} ({device_name})"
                    + ("" if mesh is None else
                       f" mesh={mesh.n_chain_shards}x{mesh.n_particle_shards}"))

    def sync():
        if on_gpu:
            torch.cuda.synchronize(device)

    target = build_target(cfg)
    metrics = MetricsWriter(cfg.metrics_path if lead else None,
                            quiet=not lead)
    if cfg.sampler == "smc":
        return _run_smc(cfg, target, metrics, device_name, sync, result, mesh)
    params = initial_params(cfg, target)
    particle_axis = None
    if mesh is not None:
        from auxpm_tpu_torch.parallel.sharded_chain import run_chains_sharded

        if cfg.chains % mesh.n_chain_shards:
            raise ValueError(f"--chains {cfg.chains} does not split over "
                             f"{mesh.n_chain_shards} chain shards")
        if mesh.n_particle_shards > 1:
            from auxpm_tpu_torch.parallel.particle_shard import (
                shard_target_particles,
            )

            target, _ = shard_target_particles(target, mesh)
            particle_axis = mesh
    aux_slice = cfg.sampler.startswith("aux_slice")
    # the chains of the whole run, each from its own key; a rank holds its
    # chain shard's slice, so the records do not depend on the layout
    states = init_chain_states(
        cfg.seed, target, cfg.chains, jitter_scale=cfg.jitter_scale,
        with_cache=cfg.chol_cache and aux_slice, mesh=mesh,
    )
    slice_kw = {}
    if aux_slice:   # aux_slice_rd has no per-coordinate sweep to repeat
        slice_kw = {"n_ess": cfg.n_ess,
                    **({"n_sigma_extra": cfg.n_sigma_extra}
                       if cfg.sampler != "aux_slice_rd" else {})}
    step = SAMPLERS[cfg.sampler](target, particle_axis=particle_axis,
                                 **slice_kw)

    def run_step_fn(t, s, p, n, gather=False):
        if mesh is not None:
            return run_chains_sharded(t, s, p, n, mesh, thin=cfg.thin,
                                      gather=gather)
        return run_chains(t, s, p, n, thin=cfg.thin)

    t0 = time.time()
    states, params, history = warmup(
        run_step_fn, states, params, cfg.warmup_windows, cfg.window_steps,
        step=step, mesh=mesh,
    )
    sync()
    for h in history:
        metrics.write({"phase": "warmup", **h})
    if lead:
        logger.info(f"warmup done in {time.time()-t0:.1f}s; params={params}")

    if cfg.profile_dir:
        from auxpm_tpu_torch.utils.profiling import trace

        profile_cm = trace(cfg.profile_dir)
    else:
        profile_cm = contextlib.nullcontext()
    ckpt_cfg = {**dataclasses.asdict(cfg),
                # the switches that choose a path with its own rounding
                **{k: os.environ.get(k, "")
                   for k in ("AUXPM_ESS_SWEEP", "AUXPM_SIGMA_SWEEP")}}

    all_theta, windows = [], []
    t0 = time.time()
    n_windows = max(cfg.steps // cfg.window_steps, 1)
    with profile_cm:
        for w in range(n_windows):
            # every chain shard's records, for the report
            states, recs, infos = run_step_fn(step, states, params,
                                              cfg.window_steps, gather=True)
            # one copy to the host per window (it also waits for the device)
            all_theta.append(recs["theta"].cpu().numpy())
            windows.append(
                {"phase": "sample", "window": w,
                 "wall": round(time.time() - t0, 2),
                 "log_lik_mean": float(recs["log_lik_hat"].mean()),
                 **{k: float(v.mean()) for k, v in infos.items()}}
            )
            metrics.write(windows[-1])
            if cfg.checkpoint_dir and cfg.checkpoint_every and (
                    (w + 1) % cfg.checkpoint_every == 0):
                from auxpm_tpu_torch.utils.checkpoint import save_checkpoint

                save_checkpoint(cfg.checkpoint_dir, states,
                                step=(w + 1) * cfg.window_steps,
                                config=ckpt_cfg, params=params, mesh=mesh)
        sync()
    wall = time.time() - t0

    theta = np.concatenate(all_theta, axis=1)  # (chains, steps, d)
    ess = effective_sample_size(theta)
    rhat = potential_scale_reduction(theta)
    flat = theta.reshape(-1, theta.shape[-1]).astype(np.float64)
    summary = {
        "phase": "summary",
        "device": device_name,
        "wall": round(wall, 2),
        "chain_steps_per_sec": round(theta.shape[0] * theta.shape[1] / wall, 1),
        "posterior_mean": np.round(flat.mean(0), 4).tolist(),
        "posterior_std": np.round(flat.std(0), 4).tolist(),
        "ess": np.round(np.atleast_1d(ess), 1).tolist(),
        "ess_per_sec": round(float(np.min(ess)) / wall, 2),
        "rhat": np.round(np.atleast_1d(rhat), 4).tolist(),
    }
    metrics.write(summary)
    metrics.close()
    if lead:
        print(json.dumps(summary))
    if cfg.out and lead:
        np.savez(cfg.out, theta=theta)
        logger.info(f"chains saved to {cfg.out}")
    if cfg.plots and lead:
        from auxpm_tpu_torch.utils.plots import experiment_report

        truth = (None if target.posterior_mean is None
                 else target.posterior_mean.cpu().numpy())
        paths = experiment_report(theta, cfg.plots, truth=truth)
        logger.info(f"figures: {paths}")
    if result is not None:
        result.update(states=states, params=params, target=target,
                      theta=theta, windows=windows, summary=summary,
                      mesh=mesh, step=step, config=ckpt_cfg, history=history)
    return 0


def _run_smc(cfg, target, metrics, device_name, sync, result, mesh=None):
    """The SMC run, single device or (``mesh``) sharded: one ``smc_summary``
    line, as the reference's ``_run_smc`` prints it (plus the device and the
    seconds of each stage), from rank 0.  ``result["on_stage"]``, where a
    caller set it, is called after each stage of a sharded run."""
    from auxpm_tpu_torch.samplers.composite import SAMPLERS, THETA_ONLY

    if mesh is None:
        from auxpm_tpu_torch.samplers.smc import make_smc

        run = make_smc(target, SAMPLERS[cfg.smc_rejuvenation], cfg.particles,
                       n_mcmc=cfg.smc_n_mcmc, ess_frac=cfg.smc_ess_frac)
        kwargs = {}
    else:
        from auxpm_tpu_torch.samplers.smc_sharded import make_smc_sharded
        from auxpm_tpu_torch.utils.config import KEYED_REJUVENATION

        rejuv = (SAMPLERS[cfg.smc_rejuvenation] if cfg.smc_carry_u else
                 THETA_ONLY[KEYED_REJUVENATION[cfg.smc_rejuvenation]])
        run = make_smc_sharded(
            target, rejuv, cfg.particles, mesh, n_mcmc=cfg.smc_n_mcmc,
            ess_frac=cfg.smc_ess_frac, carry_u=cfg.smc_carry_u,
            n_u_mh=cfg.smc_n_u_mh, rejuv_batch=cfg.smc_rejuv_batch,
            rejuv_dispatches=cfg.smc_rejuv_dispatches,
            u_blocks=cfg.smc_u_blocks,
            checkpoint_dir=cfg.smc_checkpoint_dir or None)
        kwargs = {"on_stage": (result or {}).get("on_stage")}
    t0 = time.time()
    states, diag = run(cfg.seed, **kwargs)
    sync()
    wall = time.time() - t0
    theta = states.theta
    if mesh is not None:   # the whole population, for the summary
        from auxpm_tpu_torch.parallel.collectives import allgather_chains

        theta = allgather_chains(theta, mesh)
    theta = theta.cpu().numpy().astype(np.float64)
    summary = {
        "phase": "smc_summary",
        "device": device_name,
        "wall": round(wall, 2),
        "n_stages": diag["n_stages"],
        "log_z": round(diag["log_z"], 4),
        "betas": [round(b, 4) for b in diag["betas"]],
        "stage_seconds": [round(x, 3) for x in diag["stage_seconds"]],
        "posterior_mean": np.round(theta.mean(0), 4).tolist(),
        "posterior_std": np.round(theta.std(0), 4).tolist(),
    }
    if "u_mh_accept" in diag:
        summary["u_mh_accept"] = [round(a, 3) for a in diag["u_mh_accept"]]
    lead = mesh is None or mesh.rank == 0
    metrics.write(summary)
    metrics.close()
    if lead:
        print(json.dumps(summary))
    if cfg.out and lead:
        np.savez(cfg.out, theta=theta)
    if result is not None:
        result.update(states=states, target=target, diag=diag,
                      summary=summary, mesh=mesh)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
