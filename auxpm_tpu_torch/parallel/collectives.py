"""Cross-rank reductions, batched over a leading chains axis.

Counterpart of ``auxpm_tpu/parallel/collectives.py`` on a process group of
``torch.distributed``.  Every function leaves bitwise the same result on every
rank of its group: the ranks of a particle group take their accept and shrink
decisions, and so the trip counts of their batched loops, from these values,
and a rank that decided otherwise would wait in a collective the others never
enter.

The gather of block partials is written as ``all_reduce(SUM)`` into a zeroed
buffer in which each rank filled only its own row.  Adding 0.0 is exact (a
``-0.0`` max comes back as ``+0.0``, which no sum or comparison downstream
tells apart), the rows come back in rank order by construction, and
``all_reduce`` is the one collective that both NCCL and gloo provide for CUDA
tensors (gloo has no ``all_gather`` for them), so one code path serves one
card per rank, ranks sharing a card, and the CPU.

The population reductions of the sharded SMC (``pmax``,
``population_logsumexp``, ``population_ess``, ``pmean``) run over the CHAIN
group, which the particles of a population are sharded over.

Reverse mode.  The two folds of a particle group (``psum_logsumexp``,
``allgather_blocked_logsumexp``) are ``torch.autograd.Function``s whose
forward is the collective above and whose backward needs none: the global
log-sum-exp L is the same on every rank, so its derivative with respect to
this rank's own rows is ``exp(lw_local - L)``.  Each rank's backward thus
reaches only its own S / K rows, and a factor replicated over the group (the
GP's C) gets a partial cotangent on each rank.  ``particle_grad_sum(theta,
mesh)`` is the identity forward; its backward adds the theta cotangents of
the group (one ``all_reduce`` of ``(B, d)``, not of C's ``(B, n, n)``), so
every rank holds bitwise the same gradient and takes the same HMC / NUTS
decisions.  Nothing between the fold and theta may branch on the rank: the
ranks enter the backward's collective in graph order, which is the same
graph on every rank.

``calls`` counts the collectives this rank has entered, backward ones
included; ``seconds`` adds up their wall time (host clock, each call waited
for; a caller that wants their time reads it).
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from auxpm_tpu_torch.ops.logsumexp import (
    _finite_or_zero,
    block_partials,
    combine_block_partials,
)

calls = 0
seconds = 0.0


def _all_reduce(x, op, group):
    global calls, seconds
    t0 = time.perf_counter()
    dist.all_reduce(x, op=op, group=group)
    calls += 1
    seconds += time.perf_counter() - t0
    return x


class _PsumLogsumexp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_w_local, mesh):
        group = mesh.particle_group
        m = _all_reduce(log_w_local.max(dim=-1).values.contiguous(),
                        dist.ReduceOp.MAX, group)
        m_safe = _finite_or_zero(m)
        s = _all_reduce(torch.exp(log_w_local - m_safe[..., None]).sum(-1),
                        dist.ReduceOp.SUM, group)
        lse = torch.log(s) + m_safe
        ctx.save_for_backward(log_w_local, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        return _fold_pullback(ctx, g), None


class _AllgatherBlockedLogsumexp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logw_local, n_blocks_local, mesh):
        k, pi = mesh.n_particle_shards, mesh.particle_index
        m, se = block_partials(logw_local, n_blocks_local)  # (B, nb_local)
        buf = torch.zeros((k, 2, *m.shape), dtype=m.dtype, device=m.device)
        buf[pi, 0] = m
        buf[pi, 1] = se
        _all_reduce(buf, dist.ReduceOp.SUM, mesh.particle_group)
        # (K, B, nb_local) -> (B, K * nb_local): shard-major is global order
        m_all = buf[:, 0].movedim(0, -2).reshape(*m.shape[:-1], -1)
        se_all = buf[:, 1].movedim(0, -2).reshape(*m.shape[:-1], -1)
        lse = combine_block_partials(m_all, se_all)
        ctx.save_for_backward(logw_local, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        return _fold_pullback(ctx, g), None, None


def _fold_pullback(ctx, g):
    """``g dL/dlw_local = g exp(lw_local - L)``: the global softmax restricted
    to this rank's rows, with no collective (L is the same everywhere)."""
    lw, lse = ctx.saved_tensors
    return g[..., None] * torch.exp(lw - lse[..., None])


def psum_logsumexp(log_w_local, mesh):
    """Global log-sum-exp over the last axis AND the particle group of
    ``log_w_local (..., S_local)``: global max, then the sum of the shifted
    exponential sums.  Two small collectives; the association of the sum is
    the backend's, so this is exact but not the blocked tree.
    Differentiable in ``log_w_local`` (see the module note)."""
    return _PsumLogsumexp.apply(log_w_local, mesh)


def allgather_blocked_logsumexp(logw_local, n_blocks_local, mesh):
    """Global blocked log-sum-exp of ``logw_local (B, S_local)``: the same
    value on every rank, and the same fold as the unsharded
    ``ops.logsumexp.blocked_logsumexp`` at ``K * n_blocks_local`` blocks.

    Each rank computes the (max, shifted sum) partials of its own contiguous
    blocks, the partials of all ranks are gathered in rank order (which is
    global block order: a rank's rows are one contiguous slice), and every
    rank folds them left to right.  Differentiable in ``logw_local`` (see
    the module note)."""
    return _AllgatherBlockedLogsumexp.apply(logw_local, n_blocks_local, mesh)


class _ParticleGradSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, theta, mesh):
        ctx.mesh = mesh
        return theta.view_as(theta)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _all_reduce(g, dist.ReduceOp.SUM, ctx.mesh.particle_group)
        return g, None


def particle_grad_sum(theta, mesh):
    """``theta`` unchanged; in reverse mode the theta cotangents of the
    particle group summed (one ``all_reduce``), so that each rank's share of
    dL/dtheta, which reaches theta through the replicated prepare, adds up
    to the whole on every rank (see the module note)."""
    return _ParticleGradSum.apply(theta, mesh)


def pmean_tree(tree, group, size):
    """Mean over the ``size`` ranks of ``group`` of every tensor in the dict
    ``tree`` (one collective for the whole dict)."""
    if size == 1 or not tree:
        return dict(tree)
    keys = sorted(tree)
    flat = torch.cat([tree[k].reshape(-1).to(torch.float32) for k in keys])
    _all_reduce(flat, dist.ReduceOp.SUM, group)
    flat = flat / size
    out, at = {}, 0
    for k in keys:
        n = tree[k].numel()
        out[k] = flat[at:at + n].reshape(tree[k].shape)
        at += n
    return out


def allgather_chains(x, mesh):
    """``x (B_local, ...)`` of every chain shard stacked in shard order,
    ``(C * B_local, ...)``, on every rank of the chain group."""
    c, ci = mesh.n_chain_shards, mesh.chain_index
    if c == 1:
        return x
    buf = torch.zeros((c, *x.shape), dtype=x.dtype, device=x.device)
    buf[ci] = x
    _all_reduce(buf, dist.ReduceOp.SUM, mesh.chain_group)
    return buf.reshape(-1, *x.shape[1:])


def pmax(x, mesh):
    """Elementwise max of ``x`` over the chain group (a copy)."""
    if mesh.n_chain_shards == 1:
        return x.clone()
    return _all_reduce(x.detach().clone().contiguous(), dist.ReduceOp.MAX,
                       mesh.chain_group)


def population_logsumexp(log_w_local, mesh):
    """Log-sum-exp over the last axis of a population sharded over the chain
    group: ``(..., N_local)`` on every rank -> the same ``(...)`` on every
    rank.  Global max, then the sum of the shifted exponential sums (two
    collectives, whatever the leading axes)."""
    m = _finite_or_zero(pmax(log_w_local.max(dim=-1).values, mesh))
    s = torch.exp(log_w_local - m[..., None]).sum(-1)
    if mesh.n_chain_shards > 1:
        s = _all_reduce(s.contiguous(), dist.ReduceOp.SUM, mesh.chain_group)
    return torch.log(s) + m


def population_ess(log_w_local, mesh):
    """Kish effective sample size of the sharded population's weights
    ``(N_local,)``: the log-sum-exps of w and of w^2, both in the same two
    collectives."""
    lse = population_logsumexp(torch.stack([log_w_local, 2.0 * log_w_local]),
                               mesh)
    return torch.exp(2.0 * lse[0] - lse[1])


def pmean(x, mesh):
    """Mean of ``x`` over the ranks of the chain group."""
    if mesh.n_chain_shards == 1:
        return x
    return _all_reduce(x.detach().clone().contiguous(), dist.ReduceOp.SUM,
                       mesh.chain_group) / mesh.n_chain_shards
