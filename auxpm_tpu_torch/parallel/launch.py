"""Start the ranks of a sharded run from Python.

``spawn(fn, world, *args)`` starts ``world`` processes with
``torch.multiprocessing`` (start method ``spawn``, so it is safe after CUDA
was initialised), gives each the environment ``torchrun`` would give it
(``RANK``, ``WORLD_SIZE``, ``GROUP_RANK``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``; ``nodes > 1`` emulates ``torchrun --nnodes nodes``, the
ranks in blocks of ``world / nodes`` per node, on this one machine) plus a
``file://`` rendezvous in a temporary directory (no port to collide on, no
name to resolve), runs ``fn(*args)`` in each and returns the list of their
return values in rank order.  ``fn`` must be importable by the children (a
module-level function) and joins the world itself with
``parallel.mesh.distributed_init``.  A rank that raises, or a run that
outlasts ``timeout_s``, ends every rank and raises here.

The command line does not need this: ``torchrun --nproc-per-node K -m
auxpm_tpu_torch.run --sharded true --particle-shards K`` starts the ranks.
``on_world`` runs a function on the launcher's world when there is one and
spawns one otherwise (the ``utils`` entry points).
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from pathlib import Path

from auxpm_tpu_torch.parallel.mesh import INIT_METHOD_ENV


def _entry(rank, fn, world, nodes, init_method, out_dir, threads, args):
    import torch
    import torch.distributed as dist

    per_node = world // nodes
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      GROUP_RANK=str(rank // per_node),
                      LOCAL_RANK=str(rank % per_node),
                      LOCAL_WORLD_SIZE=str(per_node))
    os.environ[INIT_METHOD_ENV] = init_method
    if threads:
        torch.set_num_threads(threads)
    try:
        result = fn(*args)
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as fh:
            pickle.dump(result, fh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world, *args, timeout_s=600, threads=1, nodes=1):
    """Run ``fn(*args)`` on ``world`` ranks; returns their results in rank
    order.  ``threads``: intra-op CPU threads per rank (0 leaves PyTorch's
    default); ``nodes``: emulated nodes (environment only)."""
    import torch.multiprocessing as mp

    if world % nodes:
        raise ValueError(f"{world} ranks do not split over {nodes} nodes")
    with tempfile.TemporaryDirectory(prefix="auxpm_ranks_") as tmp:
        init_method = f"file://{tmp}/rendezvous"
        ctx = mp.spawn(_entry, args=(fn, world, nodes, init_method, tmp,
                                     threads, args),
                       nprocs=world, join=False)
        deadline = time.monotonic() + timeout_s
        try:
            # join() returns True once every rank has ended and raises if one
            # failed (after ending the others)
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world} ranks did not finish in {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        out = []
        for rank in range(world):
            with open(Path(tmp) / f"rank{rank}.pkl", "rb") as fh:
                out.append(pickle.load(fh))
        return out


def on_world(fn, world, *args, timeout_s=3600, threads=1):
    """``fn(*args)`` on the launcher's world where this process is one of its
    ranks (``RANK`` and ``WORLD_SIZE`` set, as ``torchrun`` sets them), else
    on ``world`` ranks started by ``spawn``.  Returns this rank's result, or
    rank 0's of the spawned ones."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return fn(*args)
    return spawn(fn, world, *args, timeout_s=timeout_s, threads=threads)[0]
