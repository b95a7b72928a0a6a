"""Dry run of the two collective paths on a world of several ranks.

    torchrun --nproc-per-node 4 -m auxpm_tpu_torch.utils.dryrun
    torchrun --nproc-per-node 4 -m auxpm_tpu_torch.utils.dryrun --device cpu

From Python, ``parallel/launch.spawn(dryrun_mesh, 4, 4)`` starts the world
and runs it (``tests/test_torch_dryrun.py``, ``chip_smoke.py``).

Counterpart of ``dryrun_multichip`` in the reference's ``__graft_entry__.py``:
one ``aux_slice`` step on a 2-D mesh (``world / 2`` chain shards x 2
particle shards; one particle shard when the world is odd) with Pima
subsampled to 32 points and S = 4 x 2 importance samples, and then the
key-as-u sharded SMC on the Gaussian toy over a chain-only mesh of every
rank, ``64 x world`` particles.  It raises where the reference asserts: a
non-finite theta after the step; a last beta short of 1, a non-finite logZ,
theta or log L-hat after the SMC, or a u that is not key words (int64 here,
uint32 there).

The reference's ``entry()`` has no counterpart: it hands a function to
``jax.jit`` to check that the step compiles for one chip, and the port
compiles nothing at run time but its CUDA kernels, which ``chip_smoke.py``
builds and holds to their plain versions.  The world is the caller's: a
world of one never stands in for a missing one (``parallel/mesh.py``
raises).
"""

from __future__ import annotations

import argparse
import json
import math
import os


def dryrun_mesh(world, device="cuda"):
    """Run the dry run on this rank of a world of ``world`` ranks that the
    caller started; returns what rank 0 checked (every rank raises on a
    failed check)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from auxpm_tpu_torch.core.state import init_chain_states
    from auxpm_tpu_torch.models.datasets import load
    from auxpm_tpu_torch.models.gaussian_toy import make_gaussian_toy
    from auxpm_tpu_torch.models.gp_classification import make_gp_classification
    from auxpm_tpu_torch.parallel.mesh import distributed_init, make_mesh
    from auxpm_tpu_torch.parallel.particle_shard import shard_target_particles
    from auxpm_tpu_torch.parallel.sharded_chain import run_chains_sharded
    from auxpm_tpu_torch.samplers.composite import THETA_ONLY, make_aux_slice
    from auxpm_tpu_torch.samplers.smc_sharded import make_smc_sharded

    dev = distributed_init(device)
    if dist.get_world_size() != world:
        raise RuntimeError(f"dryrun_mesh({world}) on a world of "
                           f"{dist.get_world_size()} ranks")
    # 2-D mesh: the particles axis gets 2 shards when it can, chains the rest
    n_tp = 2 if world % 2 == 0 else 1
    n_dp = world // n_tp
    mesh = make_mesh(n_tp)
    x, y = load("pima", subsample=32)          # tiny shapes for the dry run
    target = make_gp_classification(x, y, n_importance=4 * n_tp,
                                    device=str(dev))
    if n_tp > 1:
        target, _ = shard_target_particles(target, mesh)
    step = make_aux_slice(target, particle_axis=mesh if n_tp > 1 else None)
    states = init_chain_states(0, target, 2 * n_dp, jitter_scale=0.1,
                               mesh=mesh)
    _, recs, _ = run_chains_sharded(step, states,
                                    {"slice_theta": {"widths": 1.0}}, 1, mesh,
                                    gather=True)
    theta = recs["theta"].cpu().numpy()
    if not np.isfinite(theta).all():
        raise AssertionError("dryrun produced non-finite theta")

    # the other collective path: adaptive tempering with the population
    # log-sum-exp, distributed systematic resampling and theta-only
    # rejuvenation, key-as-u, on a chain-only mesh of every rank
    smc_mesh = make_mesh(1)
    toy = make_gaussian_toy(n_importance=8, noise_frac=0.5, device=str(dev))
    smc_run = make_smc_sharded(toy, THETA_ONLY["slice_theta"], 64 * world,
                               smc_mesh, n_mcmc=1, carry_u=False, n_u_mh=1,
                               rejuv_batch=64)
    smc_states, diag = smc_run(1)
    if diag["betas"][-1] != 1.0:
        raise AssertionError(f"tempering stalled: {diag['betas']}")
    if not math.isfinite(diag["log_z"]):
        raise AssertionError("dryrun SMC produced non-finite logZ")
    if not (bool(torch.isfinite(smc_states.theta).all())
            and bool(torch.isfinite(smc_states.log_lik_hat).all())):
        raise AssertionError("dryrun SMC produced non-finite particles")
    if smc_states.u.dtype != torch.int64:
        raise AssertionError("key-as-u particles hold u of "
                             f"{smc_states.u.dtype}, not key words")
    return {"rank": mesh.rank, "world": world,
            "mesh": [mesh.n_chain_shards, mesh.n_particle_shards],
            "backend": dist.get_backend(), "device": str(dev),
            "step_theta_shape": list(theta.shape),
            "smc": {"particles": 64 * world, "n_stages": diag["n_stages"],
                    "betas": diag["betas"], "log_z": diag["log_z"],
                    "u_dtype": str(smc_states.u.dtype),
                    "u_shape_per_rank": list(smc_states.u.shape)}}


def main(argv=None):
    p = argparse.ArgumentParser(prog="auxpm_tpu_torch.utils.dryrun",
                                description=__doc__)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    # raises without a world: start one with torchrun
    out = dryrun_mesh(int(os.environ.get("WORLD_SIZE", "0")), args.device)
    if out["rank"] == 0:
        print(json.dumps({"dryrun_mesh": "ok", **out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
