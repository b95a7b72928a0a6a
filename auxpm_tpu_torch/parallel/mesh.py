"""The (chains, particles) mesh over the ranks of a ``torch.distributed`` world.

Counterpart of ``auxpm_tpu/parallel/mesh.py``.  The two axes:

- ``chains``: independent chains; the shards never communicate except for the
  windowed adaptation statistics;
- ``particles``: the S importance samples of ONE estimate split over K ranks;
  the blocked log-sum-exp is the collective.

Rank r sits at ``(ci, pi) = divmod(r, K)``.  A ``Mesh`` holds this rank's
coordinates and its two sub-groups: ``particle_group`` (the K ranks of its
chain shard, which together hold one set of chains) and ``chain_group`` (the
ranks with its particle index, one per chain shard).  The samplers and the GP
target take the ``Mesh`` itself as their ``particle_axis``.

One process per rank, started by ``torchrun`` (or ``parallel/launch.spawn``),
which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``;
across several nodes (``torchrun --nnodes N --node-rank i --rdzv-endpoint
host:port``, the CLI's ``--multihost``) also ``GROUP_RANK``, the node.  A
multi-node world is the same mesh: ranks in global order, chain shards never
talking, so nothing else changes.  With one card per rank the backend is
NCCL.  When the ranks of a host outnumber its cards they
share cards, which NCCL refuses; the backend is then gloo, as it is on the
CPU, and ``parallel/collectives.py`` keeps to the operations gloo has for CUDA
tensors.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any

import torch
import torch.distributed as dist

INIT_METHOD_ENV = "AUXPM_DIST_INIT_METHOD"
_TIMEOUT = datetime.timedelta(seconds=600)   # of the rendezvous and each collective


@dataclasses.dataclass(frozen=True)
class Mesh:
    rank: int
    world: int
    n_chain_shards: int
    n_particle_shards: int
    chain_index: int
    particle_index: int
    particle_group: Any
    chain_group: Any

    @property
    def name(self):
        return "particles"


def distributed_init(device="cuda", multihost=False):
    """Join the world that the launcher described in the environment and
    return this rank's ``torch.device``.  Idempotent.

    A missing or failed world is an error, never a quiet world of one: a rank
    that went on alone would compute on a wrong, local-only mesh.  So is,
    with ``multihost``, a world that does not span several nodes (the
    reference's ``distributed_init(require=True)``).  ``device`` "cuda" gives
    rank r the card ``LOCAL_RANK % device_count``.  The rendezvous is
    ``$AUXPM_DIST_INIT_METHOD`` where the launcher set it, else ``env://``
    (what ``torchrun`` provides)."""
    missing = [k for k in ("RANK", "WORLD_SIZE") if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"no torch.distributed world: {', '.join(missing)} not set; "
            "start one process per rank with torchrun, e.g. `torchrun "
            "--nproc-per-node K -m auxpm_tpu_torch.run --sharded true "
            "--particle-shards K ...`"
        )
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if multihost and ("GROUP_RANK" not in os.environ or local_world >= world):
        raise RuntimeError(
            f"--multihost needs a world that spans several nodes; this one "
            f"has {world} ranks, {local_world} on this node"
            f"{'' if 'GROUP_RANK' in os.environ else ' and no GROUP_RANK'}: "
            "start it on every node with `torchrun --nnodes N --node-rank i "
            "--nproc-per-node M --rdzv-endpoint HOST:PORT -m "
            "auxpm_tpu_torch.run --multihost true --sharded true ...`")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' explicitly")
        n_cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
        backend = "nccl" if local_world <= n_cards else "gloo"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device type {dev.type!r}")
    if dist.is_initialized():
        return dev
    dist.init_process_group(
        backend=backend,
        init_method=os.environ.get(INIT_METHOD_ENV, "env://"),
        world_size=world, rank=rank, timeout=_TIMEOUT,
    )
    return dev


def make_mesh(n_particle_shards=1):
    """Build this rank's ``Mesh``: all ranks of the world, ``world / K`` chain
    shards by K particle shards.  Every rank must call it (it creates the
    sub-groups, a collective operation)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs distributed_init() first")
    rank, world = dist.get_rank(), dist.get_world_size()
    k = int(n_particle_shards)
    if k < 1 or world % k:
        raise ValueError(
            f"a world of {world} ranks is not divisible into particle groups "
            f"of {k}; start K (or a multiple of K) processes with torchrun "
            "--nproc-per-node")
    c = world // k
    ci, pi = divmod(rank, k)
    particle_group = chain_group = None
    for a in range(c):           # every rank creates every group, same order
        g = dist.new_group(ranks=[a * k + b for b in range(k)])
        if a == ci:
            particle_group = g
    for b in range(k):
        g = dist.new_group(ranks=[a * k + b for a in range(c)])
        if b == pi:
            chain_group = g
    return Mesh(rank=rank, world=world, n_chain_shards=c, n_particle_shards=k,
                chain_index=ci, particle_index=pi,
                particle_group=particle_group, chain_group=chain_group)


def require_mesh(particle_axis):
    """Raise unless ``particle_axis`` is None or a ``Mesh`` (the reference
    names a mesh axis with a string; here the axis is the mesh object, which
    carries the process group)."""
    if particle_axis is not None and not isinstance(particle_axis, Mesh):
        raise TypeError(
            f"particle_axis must be a parallel.mesh.Mesh (from make_mesh), "
            f"got {particle_axis!r}")
    return particle_axis
