"""Chain execution on a (chains, particles) mesh.

Counterpart of ``auxpm_tpu/parallel/sharded_chain.py``.  Every rank runs the
ordinary chain runner on ITS share: the chains of its chain shard, and of
each chain's u the ``S / K`` rows of its particle index.  Chain shards never
talk during a run (the adaptation windows average their statistics, see
``samplers/adaptation.py``); the ranks of a particle group meet in the
estimator's collective at every probe and otherwise run in lockstep because
they take the same decisions from the same numbers.

Every chain carries its own key, so a chain's draws do not depend on the
layout: records are bitwise the same on any number of chain shards (with
fixed params; the adaptation's averages over chain shards are sums in another
order).  ``shard_states`` cuts a whole batched state down to a rank's share;
``run_chains_sharded`` runs a window on that share and, when asked, stacks
the window's records of ALL chain shards, so that whoever reports (rank 0)
sees every chain.
"""

from __future__ import annotations

from auxpm_tpu_torch.core.state import ChainState, local_rows
from auxpm_tpu_torch.parallel.collectives import allgather_chains
from auxpm_tpu_torch.samplers.chain import run_chains


def chain_slice(n_chains, mesh):
    """This rank's slice of a batch of ``n_chains`` chains."""
    c = mesh.n_chain_shards
    if n_chains % c:
        raise ValueError(f"{n_chains} chains do not split over {c} chain "
                         "shards")
    per = n_chains // c
    return slice(mesh.chain_index * per, (mesh.chain_index + 1) * per)


def shard_states(states: ChainState, target, mesh):
    """A rank's share of a whole batched state: every leaf cut on the chains
    axis, keys included, u also on its rows.  Nothing is re-seeded: the
    rank's chains are the same chains, with the same keys, on any layout."""
    cs = chain_slice(states.theta.shape[0], mesh)
    rows = local_rows(target, mesh)
    r0 = mesh.particle_index * rows

    def cut(x):
        return x[cs].contiguous()

    def cut_tree(tree):
        return {k: cut_tree(v) if isinstance(v, dict) else cut(v)
                for k, v in tree.items()}

    return ChainState(
        theta=cut(states.theta),
        u=states.u[cs, r0:r0 + rows].contiguous(),
        log_lik_hat=cut(states.log_lik_hat),
        key=cut(states.key),
        extras=cut_tree(states.extras),
    )


def run_chains_sharded(transition, states: ChainState, params: dict,
                       n_steps: int, mesh, thin: int = 1, gather=False):
    """Sharded analogue of ``samplers.chain.run_chains`` (no u recording):
    this rank's chains.  Records and infos are those of its chain shard, or
    with ``gather`` those of ALL chain shards stacked in shard order (on
    every rank), for whoever reports."""
    if mesh is None:
        raise ValueError("run_chains_sharded needs this rank's Mesh")
    states, recs, infos = run_chains(transition, states, params, n_steps,
                                     thin=thin)
    if gather:
        recs = {k: allgather_chains(v, mesh) for k, v in recs.items()}
        infos = {k: allgather_chains(v, mesh) for k, v in infos.items()}
    return states, recs, infos
