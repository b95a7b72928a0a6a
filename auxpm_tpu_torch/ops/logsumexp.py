"""Numerically-stable log-sum-exp reductions over the LAST axis.

Counterpart of ``auxpm_tpu/ops/logsumexp.py``; any leading axes (chains) are
batch axes (``masked_logsumexp`` takes the axis as an argument, as the
reference's does).  ``blocked_logsumexp`` fixes the reduction tree (block
partials combined left to right in index order): that associativity is part
of the estimator's definition and is what the CUDA probe body reproduces.
"""

from __future__ import annotations

import math

import torch


def _finite_or_zero(m):
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def logsumexp(x):
    """Max-shifted logsumexp over the last axis; safe when all are -inf."""
    m = _finite_or_zero(x.max(dim=-1, keepdim=True).values)
    return (torch.log(torch.exp(x - m).sum(-1, keepdim=True)) + m).squeeze(-1)


def masked_logsumexp(x, mask, dim=None, keepdim=False):
    """logsumexp over the entries where ``mask`` is True, the others taken as
    -inf (an all-masked reduction gives -inf); over every entry when ``dim``
    is None, else over axis ``dim``."""
    x = torch.where(mask, x, torch.full((), -math.inf, dtype=x.dtype))
    if dim is None:
        out = logsumexp(x.reshape(-1))
        return out.reshape((1,) * x.ndim) if keepdim else out
    out = logsumexp(x.movedim(dim, -1))
    return out.unsqueeze(dim) if keepdim else out


def block_partials(logw, n_blocks):
    """``logw (..., S) -> (m, se)`` each ``(..., n_blocks)``: per-block max and
    shifted exp-sum over fixed contiguous blocks.  ``m`` keeps -inf for an
    all--inf block (``se`` is 0 there); the combine handles it."""
    s = logw.shape[-1]
    if s % n_blocks:
        raise ValueError(f"S={s} is not divisible by n_blocks={n_blocks}")
    blocks = logw.reshape(*logw.shape[:-1], n_blocks, s // n_blocks)
    m = blocks.max(dim=-1).values
    se = torch.exp(blocks - _finite_or_zero(m)[..., None]).sum(-1)
    return m, se


def combine_block_partials(m, se):
    """Sequential left fold of block partials in index order."""
    cm, cs = m[..., 0], se[..., 0]
    for b in range(1, m.shape[-1]):
        bm, bs = m[..., b], se[..., b]
        nm = torch.maximum(cm, bm)
        nm_safe = _finite_or_zero(nm)
        cs = cs * torch.exp(cm - nm_safe) + bs * torch.exp(bm - nm_safe)
        cm = nm
    return torch.log(cs) + _finite_or_zero(cm)


def blocked_logsumexp(logw, n_blocks):
    """logsumexp over the last axis with the fixed blocked reduction tree."""
    if n_blocks <= 1:
        return logsumexp(logw)
    return combine_block_partials(*block_partials(logw, n_blocks))
