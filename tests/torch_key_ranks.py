"""Rank jobs of ``tests/test_torch_keys.py`` (imports the port only).

Each function is what one spawned gloo rank on the CPU does: join the world
(``parallel/launch.spawn`` set its environment), build its share of a target
and of the chains, run, and return NumPy.  Records are gathered over the chain
shards, so every rank returns the records of all chains.
"""

from __future__ import annotations

import os

TOY = {"n_importance": 16, "noise_frac": 0.5}
_LOOPS = {"AUXPM_ESS_SWEEP": "0", "AUXPM_SIGMA_SWEEP": "0"}
TOY_PARAMS = {"ess_u": {}, "slice_theta": {"widths": 1.0, "max_step_out": 4}}
SEED = 5


def _np(t):
    return t.detach().cpu().numpy()


def toy_chains(n_chains, n_steps, save_dir=None, save_at=0, load_dir=None):
    """``aux_slice`` (two ESS repeats) on the Gaussian toy over the world's
    chain shards, fixed params: ``n_steps`` from the chains of ``SEED`` or,
    with ``load_dir``, from a checkpoint of any layout; with ``save_dir``
    the state after ``save_at`` of the steps is checkpointed there."""
    import torch

    from auxpm_tpu_torch.core.state import init_chain_states
    from auxpm_tpu_torch.models.gaussian_toy import make_gaussian_toy
    from auxpm_tpu_torch.parallel.mesh import distributed_init, make_mesh
    from auxpm_tpu_torch.parallel.sharded_chain import run_chains_sharded
    from auxpm_tpu_torch.samplers.composite import make_aux_slice
    from auxpm_tpu_torch.utils.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )

    distributed_init("cpu")
    mesh = make_mesh(1)
    target = make_gaussian_toy(device="cpu", **TOY)
    states = init_chain_states(SEED, target, n_chains, jitter_scale=0.5,
                               mesh=mesh)
    config = {"toy": TOY, "seed": SEED, "chains": n_chains}
    if load_dir is not None:
        states, _, _ = load_checkpoint(load_dir, states, config=config,
                                       mesh=mesh)
    step = make_aux_slice(target, n_ess=2)
    theta, ll, n_probe = [], [], []
    for n in ([save_at, n_steps - save_at] if save_dir else [n_steps]):
        states, recs, infos = run_chains_sharded(step, states, TOY_PARAMS,
                                                 n, mesh, gather=True)
        if save_dir and not theta:
            save_checkpoint(save_dir, states, n, config=config, mesh=mesh)
        theta.append(recs["theta"])
        ll.append(recs["log_lik_hat"])
        n_probe.append(infos["slice_theta/n_probe"])
    return {"rank": mesh.rank, "theta": _np(torch.cat(theta, 1)),
            "log_lik_hat": _np(torch.cat(ll, 1)), "key": _np(states.key),
            "n_probe": _np(torch.cat(n_probe, 1))}


def gp_particle_chains(x, y, gp_kwargs, params, n_chains, n_steps,
                       n_particle_shards):
    """``aux_slice`` on a GP target over ``n_particle_shards`` particle
    shards (one chain shard), every ESS and log_sigma update through the
    per-probe loops (``AUXPM_ESS_SWEEP=0``, ``AUXPM_SIGMA_SWEEP=0``): the
    rank's records, infos and final keys."""
    from auxpm_tpu_torch.core.state import init_chain_states
    from auxpm_tpu_torch.models.gp_classification import (
        make_gp_classification,
    )
    from auxpm_tpu_torch.parallel.mesh import distributed_init, make_mesh
    from auxpm_tpu_torch.parallel.particle_shard import shard_target_particles
    from auxpm_tpu_torch.parallel.sharded_chain import run_chains_sharded
    from auxpm_tpu_torch.samplers.composite import make_aux_slice

    distributed_init("cpu")
    mesh = make_mesh(n_particle_shards)
    target, _ = shard_target_particles(
        make_gp_classification(x, y, device="cpu", **gp_kwargs), mesh)
    states = init_chain_states(SEED, target, n_chains, jitter_scale=0.3,
                               mesh=mesh)
    saved = {k: os.environ.get(k) for k in _LOOPS}
    os.environ.update(_LOOPS)       # read when the step is built
    try:
        step = make_aux_slice(target, mesh, n_ess=2)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    states, recs, infos = run_chains_sharded(step, states, params, n_steps,
                                             mesh)
    return {"rank": mesh.rank, "theta": _np(recs["theta"]),
            "log_lik_hat": _np(recs["log_lik_hat"]), "key": _np(states.key),
            "u": _np(states.u),
            "infos": {k: _np(v) for k, v in infos.items()}}


def two_nodes(gp_args, cli_argv):
    """One world of two ranks on two emulated nodes: the particle-sharded
    GP chains (``gp_particle_chains(*gp_args)``), then the CLI with
    ``--multihost`` (``rank_jobs.cli(cli_argv)``)."""
    from auxpm_tpu_torch.parallel import rank_jobs

    return gp_particle_chains(*gp_args), rank_jobs.cli(cli_argv)
