"""Chain-scaling efficiency: one rank against the whole world.

    python -m auxpm_tpu_torch.utils.scaling            # a rank per card
    torchrun --nproc-per-node 8 -m auxpm_tpu_torch.utils.scaling
    torchrun --nnodes 2 --node-rank i --nproc-per-node 8 \
        --rdzv-endpoint HOST:PORT -m auxpm_tpu_torch.utils.scaling --multihost
    python -m auxpm_tpu_torch.utils.scaling --device cpu   # two gloo ranks

Counterpart of the reference's ``scaling_bench.py`` (BASELINE Target 2: at
least 80 % samples/s efficiency from 1 to N): the ``aux_slice`` chain runner
on a one-rank world and on all ``world`` ranks with the SAME chains per rank,

    efficiency = (chain-steps/s on N ranks) / (N x chain-steps/s on 1 rank),

with the reference's flags (``--cpu-mesh`` and ``--real-devices`` become
``--device cpu|cuda``) and its fixed params (``widths`` 0.5, ``max_step_out``
0; no adaptation, so chain shards never talk).  Each window runs ``--warm``
steps, then ``--steps`` timed steps that end in ``torch.cuda.synchronize``;
the N-rank window's wall is the slowest rank's.  The one-rank world is rank 0
alone on a one-rank group while the others wait; then every rank runs its
chain shard of ``chains-per-device x world`` chains.

The world is the launcher's (``torchrun``, or ``parallel/launch.spawn``,
which sets ``RANK`` and ``WORLD_SIZE``); without one this starts one rank per
visible card, or two gloo ranks with ``--device cpu``.  Rank 0 prints the
reference's JSON line plus ``ranks_per_card``: the ranks of a node over its
cards (null on the CPU).  Above 1 the ranks share cards, and the line checks
the code path, not scaling over cards.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BASELINE_EFFICIENCY = 0.8      # BASELINE Target 2


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="auxpm_tpu_torch.utils.scaling",
                                description=__doc__)
    p.add_argument("--chains-per-device", type=int, default=32)
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--warm", type=int, default=10)
    p.add_argument("--subsample", type=int, default=128,
                   help="GP dataset subsample")
    p.add_argument("--n-importance", type=int, default=16)
    p.add_argument("--multihost", action="store_true")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--out", default=None, help="JSON artifact path")
    return p.parse_args(argv)


def measure(step, target, params, chains, steps, warm, mesh, dev, seed=0):
    """Chain-steps/s of ``chains`` chains (this rank's shard of them on
    ``mesh``) over ``steps`` steps after ``warm``; the timed window starts
    and ends with the card drained, and under a group of several ranks its
    wall is the slowest rank's."""
    import torch
    import torch.distributed as dist

    from auxpm_tpu_torch.core.state import init_chain_states
    from auxpm_tpu_torch.parallel.sharded_chain import run_chains_sharded

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    states = init_chain_states(seed, target, chains, jitter_scale=0.3,
                               mesh=mesh)
    if warm:
        states, _, _ = run_chains_sharded(step, states, params, warm, mesh)
    sync()
    group = mesh.chain_group
    dist.barrier(group=group)
    t0 = time.perf_counter()
    states, recs, _ = run_chains_sharded(step, states, params, steps, mesh)
    sync()
    wall = torch.tensor([time.perf_counter() - t0], dtype=torch.float32,
                        device=dev)
    dist.all_reduce(wall, op=dist.ReduceOp.MAX, group=group)
    return chains * steps / float(wall)


def _one_rank_mesh(mesh):
    """Rank 0's mesh of a world of one: every rank creates the group (a
    collective call), rank 0 gets the mesh, the others None."""
    import torch.distributed as dist

    from auxpm_tpu_torch.parallel.mesh import Mesh

    group = dist.new_group(ranks=[0])
    if mesh.rank != 0:
        return None
    return Mesh(rank=0, world=1, n_chain_shards=1, n_particle_shards=1,
                chain_index=0, particle_index=0, particle_group=group,
                chain_group=group)


def rank_run(args):
    """The measurement on this rank of the launcher's world; rank 0 returns
    the JSON line as a dict, the others None."""
    import torch
    import torch.distributed as dist

    from auxpm_tpu_torch.models.datasets import load
    from auxpm_tpu_torch.models.gp_classification import make_gp_classification
    from auxpm_tpu_torch.parallel.mesh import distributed_init, make_mesh
    from auxpm_tpu_torch.samplers.composite import make_aux_slice

    dev = distributed_init(args.device, multihost=args.multihost)
    mesh = make_mesh(1)
    world = mesh.world
    on_gpu = dev.type == "cuda"
    ranks_per_card = None
    if on_gpu:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        ranks_per_card = local / torch.cuda.device_count()
    x, y = load("pima", subsample=args.subsample)
    target = make_gp_classification(x, y, n_importance=args.n_importance,
                                    device=str(dev))
    params = {"slice_theta": {
        "widths": torch.full((target.d,), 0.5, dtype=torch.float32,
                             device=dev),
        "max_step_out": 0}}
    step = make_aux_slice(target)
    if mesh.rank == 0:
        log(f"devices: {world} ranks on {dev.type}"
            + (f", {ranks_per_card} per card" if on_gpu else ""))
    one = _one_rank_mesh(mesh)
    tput1 = None
    if one is not None:
        tput1 = measure(step, target, params, args.chains_per_device,
                        args.steps, args.warm, one, dev)
    dist.barrier()
    tput_n = measure(step, target, params, args.chains_per_device * world,
                     args.steps, args.warm, mesh, dev)
    if mesh.rank != 0:
        return None
    eff = tput_n / (world * tput1)
    log(f"1 rank: {tput1:.1f} chain-steps/s; {world} ranks: {tput_n:.1f}; "
        f"efficiency {eff:.3f}")
    return {
        "metric": "chain_scaling_efficiency",
        "value": round(eff, 3),
        "unit": "ratio",
        "n_devices": world,
        "platform": "gpu" if on_gpu else "cpu",
        "tput_1dev": round(tput1, 1),
        "tput_ndev": round(tput_n, 1),
        "vs_baseline": round(eff / BASELINE_EFFICIENCY, 2),
        "ranks_per_card": ranks_per_card,
    }


def main(argv=None, result=None):
    """Measure, print rank 0's JSON line and write ``--out``; returns 0.
    ``result``: an optional dict that gets the line (``out``)."""
    args = parse_args(argv)
    from auxpm_tpu_torch._device import resolve_device

    device = resolve_device(args.device)    # no GPU: raises, never the CPU
    if args.multihost and "RANK" not in os.environ:
        raise RuntimeError("--multihost runs on the world torchrun starts on "
                           "every node (see the module note)")
    import torch

    from auxpm_tpu_torch.parallel.launch import on_world

    world = torch.cuda.device_count() if device.type == "cuda" else 2
    out = on_world(rank_run, world, args,
                   threads=0 if device.type == "cuda" else 1)
    if out is None:
        return 0
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    if result is not None:
        result["out"] = out
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
