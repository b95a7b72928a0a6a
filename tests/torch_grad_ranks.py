"""Rank jobs of ``tests/test_torch_sharded_grad.py`` (imports the port only).

``run_jobs(jobs, n_particle_shards)`` is what one spawned gloo rank on the
CPU does: the ``parallel/rank_jobs.run_all`` jobs (``grad``, ``estimate``,
``apply``, ``cli``) on a mesh of ``n_particle_shards`` particle shards, then
the fold jobs of this module, in the order given.
"""

from __future__ import annotations

import numpy as np
import torch


def _fold(mesh, lw, n_blocks_local, cotangent):
    """One particle-group fold of the whole ``lw (B, S)`` (this rank takes
    its S / K rows) and its gradient with respect to those rows for the
    cotangent ``(B,)``: ``n_blocks_local`` None is ``psum_logsumexp``, a
    number ``allgather_blocked_logsumexp``.  Also the collectives that the
    backward entered (none)."""
    from auxpm_tpu_torch.parallel import collectives

    k, pi = mesh.n_particle_shards, mesh.particle_index
    rows = lw.shape[-1] // k
    local = torch.tensor(lw[:, pi * rows:(pi + 1) * rows], requires_grad=True)
    if n_blocks_local is None:
        value = collectives.psum_logsumexp(local, mesh)
    else:
        value = collectives.allgather_blocked_logsumexp(local, n_blocks_local,
                                                        mesh)
    calls = collectives.calls
    (g,) = torch.autograd.grad(value, local, torch.tensor(cotangent))
    return {"value": value.detach().numpy(), "grad": g.numpy(),
            "rows": (pi * rows, (pi + 1) * rows),
            "backward_collectives": collectives.calls - calls}


def run_jobs(jobs, n_particle_shards):
    from auxpm_tpu_torch.parallel import rank_jobs
    from auxpm_tpu_torch.parallel.mesh import make_mesh

    kinds = [job[0] for job in jobs]
    done = iter(rank_jobs.run_all([j for j in jobs if j[0] != "fold"],
                                  n_particle_shards, "cpu"))
    mesh = make_mesh(n_particle_shards)
    out = []
    for kind, job in zip(kinds, jobs):
        out.append(_fold(mesh, *job[1:]) if kind == "fold" else next(done))
    return out


def as_int64(rows):
    """Draw rows as NumPy, key words as int64 (the port's key dtype)."""
    return {k: np.array(v, dtype=np.int64 if k == "leaf_keys" else None)
            for k, v in rows.items()}
