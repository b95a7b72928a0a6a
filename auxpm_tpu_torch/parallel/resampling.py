"""Systematic resampling, single device and distributed.

Counterpart of ``auxpm_tpu/parallel/resampling.py``: one uniform, n evenly
spaced positions through the weight CDF.  The lowest-variance standard
scheme, and a deterministic function of (weights, one uniform), which makes
the distributed version equal to the single-device one on the concatenated
weights given the same uniform.

Distributed scheme (the particles of a population are sharded over the
mesh's CHAIN group, rank order = global particle order, as the reference
shards them over its ``chains`` axis):

1. the global max of the log-weights (one ``MAX`` all-reduce) is the shared
   exponent shift;
2. every rank's local cumulative sums are gathered in rank order (one
   zeroed-buffer ``SUM`` all-reduce, ``collectives.allgather_chains``): their
   last entries are the shard sums, whose exclusive prefix places each local
   CDF inside the global one;
3. every rank inverts that global CDF at its OWN output slots' positions
   ``(u + k) / N`` for its contiguous slot range;
4. ``gather_resampled`` fetches the source particles by global index from
   the payload gathered the same way (``SUM`` into a zeroed buffer: gloo has
   no ``all_gather`` for CUDA tensors).
"""

from __future__ import annotations

import torch

from auxpm_tpu_torch.parallel import collectives

# the positions (u + k) / N take k as a float32 count, exact up to 2^24
MAX_PARTICLES = 2**24


def check_particles(n):
    """Raise past ``MAX_PARTICLES``."""
    if n > MAX_PARTICLES:
        raise ValueError(
            f"{n} particles: systematic resampling counts its positions in "
            f"float32, exact only up to {MAX_PARTICLES}")


def systematic_resample_indices(log_w, u01):
    """``log_w (n,)`` unnormalised log-weights and one uniform ``u01`` in
    [0, 1) -> ``(n,)`` int64 source indices, non-decreasing.  ``n`` at
    most ``MAX_PARTICLES``."""
    n = log_w.shape[0]
    check_particles(n)
    w = torch.exp(log_w - log_w.max())
    cdf = torch.cumsum(w, 0)
    pos = (u01 + torch.arange(n, dtype=log_w.dtype, device=log_w.device)) \
        / n * cdf[-1]
    return torch.clamp(torch.searchsorted(cdf, pos), 0, n - 1)


def distributed_systematic_resample_indices(log_w_local, u01, mesh):
    """GLOBAL source indices ``(n_local,)`` int64 of this rank's output
    slots; ``log_w_local (n_local,)`` is this rank's block of the population
    (ranks of ``mesh.chain_group`` in order).  Equals
    ``systematic_resample_indices`` on the concatenated weights (same
    ``u01``) up to the rounding of the cumulative sums.  The global count
    at most ``MAX_PARTICLES``: the slot numbers ``k`` are float32."""
    n_local = log_w_local.shape[0]
    p, r = mesh.n_chain_shards, mesh.chain_index
    n_global = n_local * p
    check_particles(n_global)
    m = collectives.pmax(log_w_local.max(), mesh)
    local_cum = torch.cumsum(torch.exp(log_w_local - m), 0)
    all_cum = collectives.allgather_chains(local_cum, mesh).view(p, n_local)
    sums = all_cum[:, -1]
    total = sums.sum()
    k = r * n_local + torch.arange(n_local, dtype=log_w_local.dtype,
                                   device=log_w_local.device)
    pos = (u01 + k) / n_global * total
    global_cum = (all_cum + (torch.cumsum(sums, 0) - sums)[:, None]).reshape(-1)
    return torch.clamp(torch.searchsorted(global_cum, pos), 0, n_global - 1)


def gather_resampled(tree_local, global_idx, mesh):
    """The particles ``global_idx`` of the population: every tensor of the
    dict ``tree_local`` (leading axis n_local, nested dicts allowed) is
    gathered over the chain group in rank order and indexed."""

    def fetch(x):
        if isinstance(x, dict):
            return {k: fetch(v) for k, v in x.items()}
        return collectives.allgather_chains(x, mesh)[global_idx]

    return fetch(tree_local)
