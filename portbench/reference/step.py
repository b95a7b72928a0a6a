"""Plain reference of one ``aux_slice`` step of one chain, replayed.

The step, as ``auxpm_tpu_torch/samplers/{ess_u,slice_theta}.py`` and
``composite.make_aux_slice`` define it (written again here, nothing
imported):

1. ``n_ess`` elliptical-slice updates of u | theta: per repeat ``key, k_v,
   k_h, k_loop = split(key, 4)``, v block-normal from ``k_v``, log_y = ll +
   log U(k_h), angle U(k_loop) 2 pi, shrink i from ``fold_in(k_loop, i +
   1)``, at most 32 shrinks (a cap-hit keeps u);
2. ``key, k_ell, k_sigma = split(key, 3)``; a slice update of log_ell
   (stepping out to ``max_step_out`` each side, shrinking to
   ``max_shrink_chol``), every probe factoring its own Gram; the factor
   refreshed at the new log_ell; then ``1 + n_sigma_extra`` slice updates of
   log_sigma off that factor (repeat r from ``fold_in(k_sigma, r)``, at most
   32 shrinks).  A row is ``k_h, k_init, k_loop = split(k, 3)``: log U(k_h),
   U(k_init), U(fold_in(k_loop, j)) for j < 32.

A replay follows the program's step from the program's state before it
(theta, u, key).  Its probes are computed here; the factors it probes with
are ``given`` (the program's: its carried factors at the old and at the new
log_ell, and the factor each log_ell probe made, in the order the chain
decided on them; each judged by ``GPProblem.factor_resid``) or, with
``given=None``, its own.  Every accept or reject is a decision on the sign
of a margin.  Where a margin on a given factor is within ``delta`` of 0 the
program's rounding could have taken the other side: the decision is
recorded as open, and ``overrides`` (index -> outcome) can force it.
Bracket and shrink positions are computed in float32, as the program
computes them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import threefry as tf

MAX_SHRINK = 32


class Decisions:
    """Decision sequence of one replay: each decision's margin, in order,
    and the open ones."""

    def __init__(self, overrides=None, delta=0.0):
        self.overrides = overrides or {}
        self.delta = delta                   # for decisions on given factors
        self.margins = []
        self.open = []                       # (index, margin)

    def __call__(self, margin, given):
        i = len(self.margins)
        self.margins.append(margin)
        if given and abs(margin) <= self.delta:
            self.open.append((i, margin))
        return self.overrides.get(i, margin > 0)


def _rep(k):
    """One slice row from key ``k (2,)``: [log U, U, 32 shrink uniforms]."""
    k3 = tf.split(k, 3)
    shrink = tf.uniform(tf.fold_in(k3[2][None], torch.arange(
        MAX_SHRINK, device=k.device)))
    head = tf.uniform(k3[:2])
    return [math.log(float(head[0])), float(head[1])] + shrink.tolist()


def _slice_1d(rep, x0, lp0, f, w, max_step_out, cap, decide):
    """One 1-D slice update, positions in float32 as the program computes
    them; ``f(x) -> (log_post, log_lik, given)``.  Returns ``(x, ll or
    None, moved)``."""
    f32 = np.float32
    log_y = lp0 + rep[0]

    def passes(x):
        lp, ll, given = f(float(x))
        return decide(lp - log_y, given), ll

    x0, w = f32(x0), f32(w)
    l = f32(x0 - f32(w * f32(rep[1])))
    r = f32(l + w)
    el = er = max_step_out > 0
    for _ in range(max_step_out):
        if not (el or er):
            break
        if el:
            el = passes(l)[0]
        if er:
            er = passes(r)[0]
        l = f32(l - w) if el else l
        r = f32(r + w) if er else r
    for i in range(cap):
        x = f32(l + f32(f32(r - l) * f32(rep[2 + i])))
        ok, ll = passes(x)
        if ok:
            return float(x), ll, True
        if x < x0:
            l = x
        else:
            r = x
    return float(x0), None, False


def draw_ess(prob, key, n_ess):
    """The ESS rows of one chain from its key: ``(rows, advanced key)``."""
    rows = []
    shape = (prob.s, prob.n_pad)
    for _ in range(n_ess):
        k = tf.split(key, 4)
        key = k[0]
        if prob.n_blocks > 1:
            v = tf.blocked_normal(k[1], shape, prob.n_blocks)
        else:
            v = tf.normal(k[1], shape)
        head = tf.uniform(k[2:4])
        shrink = tf.uniform(tf.fold_in(k[3][None], torch.arange(
            1, MAX_SHRINK + 1, device=key.device)))
        rows.append((v, math.log(float(head[0])),
                     float(head[1]) * 2.0 * math.pi, shrink.tolist()))
    return rows, key


def replay(prob, pre, params, sampler, given=None, overrides=None,
           delta=0.0):
    """One step of one chain from ``pre`` (``theta (2,)``, ``u (S, n_pad)``,
    ``key (2,)`` int64).  ``given``: None, or the program's real-row factors
    ``{"pre": L, "post": L, "ell": [L, ...]}`` (the carried factor before
    the step, the refreshed one after log_ell, and one a log_ell probe in
    the order the chain decided).  Returns ``(post, decisions)``; ``post``
    has ``theta``, ``u``, ``key``, ``ll``, ``chol`` (the factor log_sigma
    probed with), ``ell`` (the log_ell probes' ``(x, factor)``, in order)
    and ``slice_from`` (the index of the first slice decision: the ESS
    decisions come before it)."""
    dec = Decisions(overrides, delta)
    dt = prob.num.dtype
    theta = pre["theta"].to(prob.device, torch.float64).clone()
    u = pre["u"].to(prob.device, dt)
    key = pre["key"].to(prob.device)
    w = [float(x) for x in params["widths"]]
    on_given = given is not None
    chol_ess = given["pre"] if on_given else prob.chol(theta[0])
    sig = math.exp(float(theta[1]))

    rows, key = draw_ess(prob, key, int(sampler["n_ess"]))
    ll = prob.estimate(sig * chol_ess, u)
    for v, log_u, a0, shrink in rows:
        v = v.to(dt)
        log_y = ll + log_u

        def rot(a, u=u, v=v):
            return u * math.cos(a) + v * math.sin(a)

        a = a0
        a_min, a_max = a - 2.0 * math.pi, a
        ll_p = prob.estimate(sig * chol_ess, rot(a))
        done = dec(ll_p - log_y, on_given)
        i = 0
        while not done and i < MAX_SHRINK:
            if a < 0:
                a_min = a
            else:
                a_max = a
            a = a_min + (a_max - a_min) * shrink[i]
            ll_p = prob.estimate(sig * chol_ess, rot(a))
            done = dec(ll_p - log_y, on_given)
            i += 1
        if done:
            u, ll = rot(a), ll_p

    slice_from = len(dec.margins)
    k = tf.split(key, 3)
    key_out = k[0]
    n_sig = 1 + int(sampler["n_sigma_extra"])
    sig_rows = [_rep(k[2])] + [_rep(tf.fold_in(k[2], r))
                               for r in range(1, n_sig)]
    max_step_out = int(params["max_step_out"])

    def at(i, x):
        th = theta.clone()
        th[i] = x
        return th

    # log_ell: every probe factors its own Gram (the program's factor of
    # that probe where given; past the given ones, the reference's own)
    ell = []

    def f_ell(x):
        mine = not on_given or len(ell) >= len(given["ell"])
        lf = prob.chol(x) if mine else given["ell"][len(ell)]
        ell.append((x, lf))
        ll_x = prob.estimate(math.exp(float(theta[1])) * lf, u)
        return prob.log_prior(at(0, x)) + ll_x, ll_x, not mine

    lp0, cap_chol = prob.log_prior(theta) + ll, int(params["max_shrink_chol"])
    x, ll_x, moved = _slice_1d(_rep(k[1]), float(theta[0]), lp0, f_ell,
                               w[0], max_step_out, cap_chol, dec)
    theta = at(0, x)
    if moved:
        ll = ll_x
    chol_sig = given["post"] if on_given else prob.chol(theta[0])

    def f_sig(x):
        ll_x = prob.estimate(math.exp(x) * chol_sig, u)
        return prob.log_prior(at(1, x)) + ll_x, ll_x, on_given

    for rep in sig_rows:
        x, ll_x, moved = _slice_1d(
            rep, float(theta[1]), prob.log_prior(theta) + ll, f_sig, w[1],
            max_step_out, MAX_SHRINK, dec)
        theta = at(1, x)
        if moved:
            ll = ll_x
    return ({"theta": theta, "u": u, "key": key_out, "ll": ll,
             "chol": chol_sig, "ell": ell, "slice_from": slice_from}, dec)
