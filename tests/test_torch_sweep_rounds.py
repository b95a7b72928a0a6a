"""CPU models of the schedules of the CUDA kernels of the port.

No CUDA kernel runs on the CPU, so the order in which each kernel does its
work is written out here in NumPy, step for step, and held to the JAX
package (and to the port's plain versions) on the same NumPy-seeded inputs:

(a) ``csrc/ess_sweep.cu``: the ESS sweep in ROUNDS.  In each round every
    active chain makes its next probe, whatever repeat it is at; f = left C^T
    is computed tile by tile over column tiles of the kernel's width w, tile t
    contracting only k < w (t + 1) (C is lower-triangular), the tiles' row
    sums folded in tile order, then the fixed 8-block log-sum-exp and the
    bracket decision.  The model must give exactly the shrink and moved
    counts of the plain sweep ``ops/ess_sweep._ref_ess_sweep``, and u', ll' within the bars the kernels
    phase of ``chip_smoke.py`` uses (u' 1e-5, ll' 2e-4 + 2e-6 |ll|) against
    the reference's per-probe loop path, built under ``AUXPM_ESS_SWEEP=0``
    as ``tests/test_torch_stepout.py`` builds it, with the random rows of
    ``samplers/ess_u.py``.
(b) ``csrc/chol_panel.cu``: the 128-tile factor in 32-wide column blocks
    (diagonal block unblocked, rows below by forward substitution, trailing
    update over the lower blocks only, inv(L) by block forward
    substitution), against ``chol_panel_batched3(..., interpret=True)`` of
    the JAX package within 5e-4, with the NaN contract: a tile made
    indefinite at column c has NaN on L's diagonal from c on and finite
    values before.  The kernel's v1 and v2 output modes (L and inv(L); L
    alone, without the inverse phase) likewise against the reference's v1
    and v2 bodies in ``pl.pallas_call(..., interpret=True)``, L within 5e-4,
    |inv(L) L - I| <= 2e-4, L bitwise the v3 mode's.
(c) ``csrc/sigma_sweep.cu``: the log_sigma sweep in ROUNDS on the same body:
    every active chain probes its next candidate x in each round, whatever
    repeat it is at, with exp(x) applied to C0 BEFORE the product and f
    folded tile by tile over the triangular k range; then lp(x) and the
    bracket decision.  The model must give exactly the shrink and moved
    counts of the port's ``_ref_sigma_sweep`` and of the JAX package's, and
    sigma', ll', lp' within the bars of ``chip_smoke.py``'s kernels phase
    (1e-5; 2e-4 + 2e-6 |ll|); at the 32-probe cap it keeps the point
    bitwise.
(d) ``fused_estimate_kernel`` of ``csrc/fused_estimator.cu``: ONE round of
    the body over all chains, the block that completes a chain's last item
    folding it, against the JAX package's ``_pallas_estimate(...,
    interpret=True)`` and ``_ref_estimate`` within 2e-4 + 2e-6 |ll|.
(e) ``fused_rot_weights_kernel`` of the same source: one round over the
    ACTIVE chains only (the list built from ``active`` in ascending order),
    items in the body's order, each row's tile sums folded in tile order,
    against the JAX package's ``_pallas_rot_weights(..., interpret=True)``
    and the port's ``_ref_rot_weights`` within the same bar; inactive chains
    give 0, and a row's weights are bitwise those it has in a call of all
    64 rows at S_local = 8, 16 and 32.
(f) ``fused_weights_kernel``: the same round at u over every chain, against
    ``_pallas_weights(..., interpret=True)`` and ``_ref_weights`` within the
    same bar, rows bitwise independent at S_local = 8, 16 and 32.
(g) ``fused_estimate_rot_kernel``: the rotated round over the active chains
    with the estimate's fold, against ``_pallas_estimate_rot(...,
    interpret=True)`` and ``_ref_estimate_rot`` within the same bar;
    ``active`` zeroes the unwanted chains and leaves the others bitwise as
    they were.  Both (f) and (g) also at n = 1024 (S = 8, 2 chains), against
    the plain versions of both packages.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auxpm_tpu.core.state import init_chain_states as j_init
from auxpm_tpu.models.gp_classification import make_gp_classification as jmake
from auxpm_tpu.ops import chol_pallas as jchol
from auxpm_tpu.ops import fused_estimator as jfe
from auxpm_tpu.ops import sigma_sweep as jsig
from auxpm_tpu.samplers.ess_u import make_ess_u as j_make_ess_u
from auxpm_tpu_torch.models.likelihoods import log_ndtr, log_sigmoid
from auxpm_tpu_torch.ops import ess_sweep as tess
from auxpm_tpu_torch.ops import fused_estimator as tfe
from auxpm_tpu_torch.ops import sigma_sweep as tsig
from tests.test_torch_panel_bodies import interpret_v1, interpret_v2
from tests.test_torch_stepout import _ess_rows

B, S, N_RAW, N, N_BLOCKS = 6, 64, 200, 256, 8
TILE = tess._TILE   # columns of f per work item of the kernel
LL_TOL, LL_RTOL, U_TOL, CHOL_TOL, SIGMA_TOL = 2e-4, 2e-6, 1e-5, 5e-4, 1e-5
F32 = np.float32
TWO_PI = F32(2.0 * np.pi)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs several workers
    on the same cores, where multi-threaded small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ------------------------------------------------- (a) the sweep's rounds


def _log_lik(z, likelihood):
    fn = log_sigmoid if likelihood == "logistic" else log_ndtr
    return fn(torch.from_numpy(z)).numpy()


def _blocked_lse(lw, n_blocks):
    """The kernel's fixed combine (probe.cuh blocked_lse), float32."""
    parts = lw.reshape(n_blocks, -1)
    bm = parts.max(1)
    safe = np.where(np.isfinite(bm), bm, F32(0))
    bsum = np.exp(parts - safe[:, None]).sum(1, dtype=F32)
    cm, cs = bm[0], bsum[0]
    for m_b, s_b in zip(bm[1:], bsum[1:]):
        nm = max(cm, m_b)
        safe = nm if np.isfinite(nm) else F32(0)
        cs = cs * np.exp(cm - safe) + s_b * np.exp(m_b - safe)
        cm = nm
    return np.log(cs) + (cm if np.isfinite(cm) else F32(0))


def _tile_row_sums(left, c, y, mask, likelihood):
    """Phase A of the sweep body for a batch of probes: for each 64-column
    tile t of f = left c^T, contracting k < 64 (t + 1) only, every row's
    log-likelihood summed over the tile's columns -> (batch, tiles, S)."""
    n_tiles = left.shape[-1] // TILE
    out = np.zeros((len(left), n_tiles, left.shape[1]), F32)
    for t in reversed(range(n_tiles)):      # largest k range first
        cols, k_end = slice(t * TILE, (t + 1) * TILE), (t + 1) * TILE
        f = left[:, :, :k_end] @ c[:, cols, :k_end].transpose(0, 2, 1)
        out[:, t] = (_log_lik(y[cols] * f, likelihood)
                     * mask[cols]).sum(-1, dtype=F32)
    return out


def _fold_estimate(rowsum, log_s):
    """fold_estimate of the body: one chain's tile sums folded in tile
    order, the fixed 8-block log-sum-exp, minus log S."""
    lw = np.zeros(rowsum.shape[-1], F32)
    for t in range(len(rowsum)):
        lw = lw + rowsum[t]
    return _blocked_lse(lw, N_BLOCKS) - log_s


def sweep_rounds_model(chol, u, scal, v, y, mask, likelihood):
    """The round schedule of csrc/ess_sweep.cu.  Returns u', ll', n_shrink,
    moved and, per round, the repeat index of every chain probed in it."""
    n_chains, s, n = u.shape
    n_rep, n_tiles = scal.shape[1], n // TILE
    log_s = np.log(F32(s))
    uo = u.copy()
    r = np.zeros(n_chains, int)
    i = np.zeros(n_chains, int)
    a = scal[:, 0, 2].copy()
    a_min, a_max = a - TWO_PI, a.copy()
    ll = scal[:, 0, 0].copy()
    log_y = ll + scal[:, 0, 1]
    n_shrink = np.zeros(n_chains, F32)
    moved = np.zeros(n_chains, F32)
    active = np.ones(n_chains, bool)
    rounds = []
    while active.any():
        act = np.flatnonzero(active)
        rounds.append(r[act].copy())
        # phase A: items (chain, tile), largest k range first
        rowsum = np.zeros((n_chains, n_tiles, s), F32)
        left = (uo[act] * np.cos(a[act])[:, None, None]
                + v[act, r[act]] * np.sin(a[act])[:, None, None])
        rowsum[act] = _tile_row_sums(left, chol[act], y, mask, likelihood)
        # phase B: fold in tile order, decide
        for b in act:
            ll_p = _fold_estimate(rowsum[b], log_s)
            row = scal[b, r[b]]
            next_repeat = False
            if ll_p > log_y[b]:
                uo[b] = uo[b] * np.cos(a[b]) + v[b, r[b]] * np.sin(a[b])
                ll[b] = ll_p
                n_shrink[b] += i[b]
                moved[b] += 1
                next_repeat = True
            elif i[b] < tess.MAX_SHRINK:
                if a[b] < 0:
                    a_min[b] = a[b]
                else:
                    a_max[b] = a[b]
                a[b] = a_min[b] + (a_max[b] - a_min[b]) * row[3 + i[b]]
                i[b] += 1
            else:
                n_shrink[b] += i[b]
                next_repeat = True
            if next_repeat:
                r[b] += 1
                if r[b] < n_rep:
                    row = scal[b, r[b]]
                    a[b] = row[2]
                    a_min[b], a_max[b] = a[b] - TWO_PI, a[b]
                    log_y[b] = ll[b] + row[1]
                    i[b] = 0
                else:
                    active[b] = False
    return uo, ll, n_shrink, moved, rounds


def _data(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N_RAW, 3)).astype(F32)
    w = rng.standard_normal(3)
    y = np.where(x @ w + 0.5 * rng.standard_normal(N_RAW) > 0, 1.0, -1.0)
    return x, y.astype(F32)


def _reference_step(likelihood, n_rep, seed):
    """One ESS step of the JAX package's per-probe loop path on B chains, the
    random rows it drew, its prepared factor and its padded y and mask."""
    x, y = _data(seed)
    tj = jmake(x, y, n_importance=S, likelihood=likelihood)
    assert tj.u_shape == (S, N) and tj.n_weight_blocks == N_BLOCKS
    saved = os.environ.get("AUXPM_ESS_SWEEP")
    os.environ["AUXPM_ESS_SWEEP"] = "0"   # read when the transition is built
    try:
        step = j_make_ess_u(tj, n_repeats=n_rep)
    finally:
        if saved is None:
            del os.environ["AUXPM_ESS_SWEEP"]
        else:
            os.environ["AUXPM_ESS_SWEEP"] = saved
    assert not step.uses_sweep
    states = j_init(jax.random.key(seed), tj, B, jitter_scale=0.3)
    out, info = jax.jit(jax.vmap(lambda st: step(st, {})))(states)
    _, scal, v = jax.jit(jax.vmap(
        lambda k, ll: _ess_rows(k, ll, tj.u_shape, n_rep, N_BLOCKS)))(
            states.key, states.log_lik_hat)
    chol = jax.jit(jax.vmap(tj.prepare))(states.theta)
    y_pad = np.ones(N, F32)
    y_pad[:N_RAW] = y
    mask = (np.arange(N) < N_RAW).astype(F32)
    arrays = [np.array(a, F32) for a in (chol, states.u, scal, v)]
    return arrays + [y_pad, mask], out, info


def _numpy_inputs(seed, n_rep, likelihood, level=None):
    """NumPy-made sweep inputs at the same shapes: an SE factor, u, rows."""
    rng = np.random.default_rng(seed)
    x, y = _data(seed)
    x_pad = np.concatenate([x, rng.standard_normal((N - N_RAW, 3))])
    sq = ((x_pad[:, None] - x_pad[None]) ** 2).sum(-1)
    ells = rng.uniform(1.0, 2.0, B)
    k = np.exp(-0.5 * sq[None] / ells[:, None, None] ** 2) + 1e-3 * np.eye(N)
    chol = (1.5 * np.linalg.cholesky(k)).astype(F32)
    u = rng.standard_normal((B, S, N)).astype(F32)
    v = rng.standard_normal((B, n_rep, S, N)).astype(F32)
    y_pad = np.ones(N, F32)
    y_pad[:N_RAW] = y
    mask = (np.arange(N) < N_RAW).astype(F32)
    scal = np.zeros((B, n_rep, 3 + tess.MAX_SHRINK), F32)
    scal[:, 0, 0] = tess._ref_estimate(*map(_t, (chol, u, y_pad, mask)),
                                       likelihood, N_BLOCKS).numpy()
    scal[:, :, 1] = (np.log(rng.uniform(size=(B, n_rep))) if level is None
                     else level)
    scal[:, :, 2] = rng.uniform(size=(B, n_rep)) * 2.0 * np.pi
    scal[:, :, 3:] = rng.uniform(size=(B, n_rep, tess.MAX_SHRINK))
    return chol, u, scal, v, y_pad, mask


def _check_against_plain(inputs, likelihood, n_rep):
    """The model on ``inputs``: counts equal to the plain sweep's, values
    within the kernel bars, and the schedule the kernel relies on (one probe
    per active chain per round, so the rounds are the largest probe count;
    with several repeats, chains at different repeats share a round).
    Returns the model's output."""
    u_m, ll_m, ns_m, mv_m, rounds = out = sweep_rounds_model(
        *inputs, likelihood)
    probe_log = []
    u_p, ll_p, ns_p, mv_p = tess._ref_ess_sweep(
        *map(_t, inputs), likelihood, N_BLOCKS, None, n_rep, "float32",
        probe_log=probe_log)
    margins = torch.cat([m[act].abs() for act, m in probe_log])
    assert float(margins.min()) > LL_TOL, "a decision sat on its boundary"
    np.testing.assert_array_equal(ns_m, ns_p.numpy())
    np.testing.assert_array_equal(mv_m, mv_p.numpy())
    ll_p = ll_p.numpy()
    assert np.all(np.abs(ll_m - ll_p) <= LL_TOL + LL_RTOL * np.abs(ll_p))
    np.testing.assert_allclose(u_m, u_p.numpy(), rtol=0, atol=U_TOL)
    probes = n_rep + ns_m
    assert len(rounds) == int(probes.max())
    assert sum(len(r) for r in rounds) == int(probes.sum())
    assert n_rep == 1 or any(len(set(r.tolist())) > 1 for r in rounds)
    assert ns_m.sum() > 0 and mv_m.sum() > 0
    return out


def test_round_model_matches_plain_sweep_and_jax_loop():
    n_rep = 1   # one repeat keeps the reference's compile short
    inputs, out_j, info_j = _reference_step("logistic", n_rep, seed=3)
    u_m, ll_m, ns_m, mv_m, _ = _check_against_plain(inputs, "logistic", n_rep)
    # the reference's loop path: counts, then values within the kernel bars
    np.testing.assert_array_equal(ns_m, np.asarray(info_j["n_shrink"]) * n_rep)
    np.testing.assert_array_equal(mv_m, np.asarray(info_j["moved"]) * n_rep)
    ll_j = np.asarray(out_j.log_lik_hat)
    assert np.all(np.abs(ll_m - ll_j) <= LL_TOL + LL_RTOL * np.abs(ll_j))
    np.testing.assert_allclose(u_m, np.asarray(out_j.u), rtol=0, atol=U_TOL)


@pytest.mark.parametrize("likelihood", ["logistic", "probit"])
def test_round_model_matches_plain_sweep(likelihood):
    n_rep = 3
    _check_against_plain(_numpy_inputs(21, n_rep, likelihood), likelihood,
                         n_rep)


def test_round_model_keeps_the_state_at_the_shrink_cap():
    chol, u, scal, v, y, mask = inputs = _numpy_inputs(
        22, 1, "logistic", level=50.0)   # a slice level no probe reaches
    u_m, ll_m, ns_m, mv_m, rounds = sweep_rounds_model(*inputs, "logistic")
    assert np.array_equal(u_m, u) and np.array_equal(ll_m, scal[:, 0, 0])
    assert np.all(ns_m == tess.MAX_SHRINK) and np.all(mv_m == 0)
    assert len(rounds) == tess.MAX_SHRINK + 1
    u_p, ll_p, ns_p, mv_p = tess._ref_ess_sweep(
        *map(_t, inputs), "logistic", N_BLOCKS, None, 1, "float32")
    np.testing.assert_array_equal(ns_m, ns_p.numpy())
    assert torch.equal(u_p, _t(u))


# ------------------------------------- (c) the sigma sweep's rounds


def sigma_rounds_model(chol0, u, chain, rep, y, mask, likelihood):
    """The round schedule of csrc/sigma_sweep.cu.  Returns sigma', ll', lp',
    n_shrink, moved and, per round, the repeat index of every chain probed
    in it."""
    n_chains, s, _ = u.shape
    n_rep = rep.shape[1]
    log_s = np.log(F32(s))
    ll, lp, sig = (chain[:, k].copy() for k in (0, 1, 2))
    w, mu, hiv, lp_rest = (chain[:, k] for k in (3, 4, 5, 6))
    r = np.zeros(n_chains, int)
    i = np.zeros(n_chains, int)
    l = sig - w * rep[:, 0, 1]
    rt = l + w
    x = l + (rt - l) * rep[:, 0, 2]          # each chain's next candidate
    log_y = lp + rep[:, 0, 0]
    n_shrink = np.zeros(n_chains, F32)
    moved = np.zeros(n_chains, F32)
    active = np.ones(n_chains, bool)
    rounds = []
    while active.any():
        act = np.flatnonzero(active)
        rounds.append(r[act].copy())
        # phase A: u against exp(x) C0, the scale applied BEFORE the product
        c_x = np.exp(x[act])[:, None, None] * chol0[act]
        rowsum = _tile_row_sums(u[act], c_x, y, mask, likelihood)
        # phase B: fold, lp(x), the bracket
        for j, b in enumerate(act):
            ll_x = _fold_estimate(rowsum[j], log_s)
            d = x[b] - mu[b]
            lp_x = lp_rest[b] - hiv[b] * d * d + ll_x
            done = lp_x > log_y[b]
            if not (done or x[b] >= sig[b]):
                l[b] = x[b]
            if not (done or x[b] < sig[b]):
                rt[b] = x[b]
            i[b] += 1
            if done or i[b] == tsig.MAX_SHRINK:   # this repeat ends
                if done:                          # at the cap the point stays
                    sig[b], lp[b], ll[b] = x[b], lp_x, ll_x
                    moved[b] += 1
                n_shrink[b] += i[b]
                r[b] += 1
                if r[b] == n_rep:
                    active[b] = False
                    continue
                log_y[b] = lp[b] + rep[b, r[b], 0]
                l[b] = sig[b] - w[b] * rep[b, r[b], 1]
                rt[b] = l[b] + w[b]
                i[b] = 0
            x[b] = l[b] + (rt[b] - l[b]) * rep[b, r[b], 2 + i[b]]
    return sig, ll, lp, n_shrink, moved, rounds


def _sigma_inputs(seed, n_rep, likelihood, level=None):
    """NumPy-made sweep inputs: the sigma-free factor C0 of an SE Gram, u,
    the chains' scalars at sigma0 and the per-repeat rows."""
    rng = np.random.default_rng(seed)
    chol, u, _, _, y, mask = _numpy_inputs(seed, 1, likelihood)
    chol0 = (chol / F32(1.5)).astype(F32)
    sigma0 = (np.log(1.5) + 0.3 * rng.standard_normal(B)).astype(F32)
    hiv = F32(0.5 / 1.5**2)
    ll0 = tsig._ref_estimate(_t(np.exp(sigma0)[:, None, None] * chol0), _t(u),
                             _t(y), _t(mask), likelihood, N_BLOCKS).numpy()
    lp_rest = (rng.standard_normal(B) - 3.0).astype(F32)
    chain = np.zeros((B, 8), F32)
    chain[:, 0], chain[:, 2] = ll0, sigma0
    chain[:, 1] = lp_rest - hiv * sigma0 * sigma0 + ll0
    chain[:, 3], chain[:, 4], chain[:, 5], chain[:, 6] = 1.3, 0.0, hiv, lp_rest
    rep = rng.uniform(size=(B, n_rep, tsig.REP_COLS)).astype(F32)
    rep[:, :, 0] = np.log(rep[:, :, 0]) if level is None else level
    return chol0, u, chain, rep, y, mask


def test_sigma_round_model_matches_plain_and_jax_sweeps():
    n_rep, lik = 3, "logistic"
    inputs = _sigma_inputs(23, n_rep, lik)
    sig_m, ll_m, lp_m, ns_m, mv_m, rounds = sigma_rounds_model(*inputs, lik)
    probe_log = []
    out_p = tsig._ref_sigma_sweep(*map(_t, inputs), lik, N_BLOCKS, None,
                                  n_rep, "float32", probe_log=probe_log)
    margins = torch.cat([m[act].abs() for act, m in probe_log])
    assert float(margins.min()) > LL_TOL, "a decision sat on its boundary"
    ref = jsig.make_fused_sigma_sweep(jnp.asarray(inputs[4]),
                                      jnp.asarray(inputs[5]), lik,
                                      force=False, n_blocks=N_BLOCKS,
                                      n_reps=n_rep)
    out_j = jax.jit(jax.vmap(ref))(*(jnp.asarray(a) for a in (
        inputs[0], inputs[1], inputs[2][:, None, :], inputs[3])))
    for other in (out_p, out_j):
        sig_o, ll_o, lp_o, ns_o, mv_o = (np.asarray(o) for o in other)
        np.testing.assert_array_equal(ns_m, ns_o)
        np.testing.assert_array_equal(mv_m, mv_o)
        np.testing.assert_allclose(sig_m, sig_o, rtol=0, atol=SIGMA_TOL)
        for got, want in ((ll_m, ll_o), (lp_m, lp_o)):
            assert np.all(np.abs(got - want)
                          <= LL_TOL + LL_RTOL * np.abs(want))
    # one probe per active chain per round; chains at different repeats
    # share a round
    assert len(rounds) == int(ns_m.max())
    assert sum(len(r) for r in rounds) == int(ns_m.sum())
    assert any(len(set(r.tolist())) > 1 for r in rounds)
    assert mv_m.sum() > 0 and ns_m.max() > n_rep


def test_sigma_round_model_keeps_the_point_at_the_shrink_cap():
    n_rep = 2
    inputs = _sigma_inputs(24, n_rep, "logistic", level=50.0)
    chain = inputs[2]
    sig_m, ll_m, lp_m, ns_m, mv_m, rounds = sigma_rounds_model(*inputs,
                                                               "logistic")
    for got, col in ((sig_m, 2), (ll_m, 0), (lp_m, 1)):
        assert np.array_equal(got, chain[:, col])
    assert np.all(ns_m == tsig.MAX_SHRINK * n_rep) and np.all(mv_m == 0)
    assert len(rounds) == tsig.MAX_SHRINK * n_rep
    out_p = tsig._ref_sigma_sweep(*map(_t, inputs), "logistic", N_BLOCKS,
                                  None, n_rep, "float32")
    for got, col in zip(out_p[:3], (2, 0, 1)):
        assert torch.equal(got, _t(chain[:, col]))
    np.testing.assert_array_equal(ns_m, out_p[3].numpy())


# ------------------------------------- (d) the estimator's one round


def estimate_round_model(chol, u, y, mask, likelihood):
    """fused_estimate_kernel: the items (chain, tile) of all chains in the
    kernel's order, tile descending; the item that completes a chain's
    tiles folds it (the fold's order does not depend on which that is)."""
    n_chains, s, n = u.shape
    n_tiles = n // TILE
    log_s = np.log(F32(s))
    rowsum = np.zeros((n_chains, n_tiles, s), F32)
    arrivals = np.zeros(n_chains, int)
    out = np.full(n_chains, np.nan, F32)
    for w in range(n_chains * n_tiles):
        t, b = n_tiles - 1 - w // n_chains, w % n_chains
        cols, k_end = slice(t * TILE, (t + 1) * TILE), (t + 1) * TILE
        f = u[b, :, :k_end] @ chol[b, cols, :k_end].T
        rowsum[b, t] = (_log_lik(y[cols] * f, likelihood)
                        * mask[cols]).sum(-1, dtype=F32)
        arrivals[b] += 1
        if arrivals[b] == n_tiles:
            out[b] = _fold_estimate(rowsum[b], log_s)
    return out


@pytest.mark.parametrize("likelihood", ["logistic", "probit"])
def test_estimate_round_model_matches_jax(likelihood):
    chol, u, _, _, y, mask = _numpy_inputs(25, 1, likelihood)
    chol, u = chol[:3], u[:3]
    got = estimate_round_model(chol, u, y, mask, likelihood)
    j = [jnp.asarray(a) for a in (y, mask)]
    for b in range(len(u)):
        for want in (
                jfe._pallas_estimate(jnp.asarray(chol[b]), jnp.asarray(u[b]),
                                     *j, likelihood, n_blocks=N_BLOCKS,
                                     interpret=True),
                jfe._ref_estimate(jnp.asarray(chol[b]), jnp.asarray(u[b]), *j,
                                  likelihood, n_blocks=N_BLOCKS)):
            want = float(want)
            assert abs(got[b] - want) <= LL_TOL + LL_RTOL * abs(want)


# ------------------------------ (e) the rotated weights' one round


def one_round_model(chol, u, v, angle, active, y, mask, likelihood, fold):
    """The round of every entry of csrc/fused_estimator.cu but the plain
    estimate's (``estimate_round_model``): the list of ACTIVE chains in
    ascending order (compact_active; all chains where ``active`` is None),
    the items (list entry, tile) in the body's order (tile descending, then
    the list), the probe u, or u cos a + v sin a formed from the streamed
    rows (``v`` not None), each f element a sum over k of that row alone,
    each row's tile sum over the tile's columns; the item that completes a
    chain's tiles folds its rows in tile order and hands them to ``fold``.
    Returns {chain: fold(rows)} and the chains of the items in order."""
    n_chains, s, n = u.shape
    n_tiles = n // TILE
    chains = [b for b in range(n_chains) if active is None or active[b] != 0]
    rowsum = np.zeros((n_chains, n_tiles, s), F32)
    arrivals = np.zeros(n_chains, int)
    out, items = {}, []
    for w in range(len(chains) * n_tiles):
        t, b = n_tiles - 1 - w // len(chains), chains[w % len(chains)]
        items.append(b)
        cols, k_end = slice(t * TILE, (t + 1) * TILE), (t + 1) * TILE
        left = u[b, :, :k_end]
        if v is not None:
            left = left * np.cos(angle[b]) + v[b, :, :k_end] * np.sin(angle[b])
        # row by row: a row's sums never see another row
        f = (left[:, None, :] * chol[b, cols, :k_end][None]).sum(-1, dtype=F32)
        rowsum[b, t] = (_log_lik(y[cols] * f, likelihood)
                        * mask[cols]).sum(-1, dtype=F32)
        arrivals[b] += 1
        if arrivals[b] == n_tiles:
            lw = np.zeros(s, F32)
            for t_ in range(n_tiles):
                lw = lw + rowsum[b, t_]
            out[b] = fold(lw)
    return out, items


def rot_weights_round_model(chol, u, v, angle, active, y, mask, likelihood):
    """fused_rot_weights_kernel: ``one_round_model`` at the rotated
    proposal, the folded rows written out; inactive chains' rows are 0.
    Returns the weights and the chains of the items in order."""
    folded, items = one_round_model(chol, u, v, angle, active, y, mask,
                                    likelihood, lambda lw: lw)
    out = np.zeros(u.shape[:2], F32)
    for b, lw in folded.items():
        out[b] = lw
    return out, items


def weights_round_model(chol, u, y, mask, likelihood):
    """fused_weights_kernel: ``one_round_model`` at u over every chain, the
    folded rows written out.  Returns the weights and the items' chains."""
    folded, items = one_round_model(chol, u, None, None, None, y, mask,
                                    likelihood, lambda lw: lw)
    return np.stack([folded[b] for b in range(len(u))]), items


def estimate_rot_round_model(chol, u, v, angle, active, y, mask, likelihood):
    """fused_estimate_rot_kernel: ``one_round_model`` at the rotated
    proposal over the active chains, each folded chain's fixed 8-block
    log-sum-exp minus log S written out; inactive chains give 0.  Returns
    the estimates and the items' chains."""
    log_s = np.log(F32(u.shape[1]))
    folded, items = one_round_model(
        chol, u, v, angle, active, y, mask, likelihood,
        lambda lw: _blocked_lse(lw, N_BLOCKS) - log_s)
    out = np.zeros(len(u), F32)
    for b, est in folded.items():
        out[b] = est
    return out, items


def test_rot_weights_round_model_matches_jax():
    chol, u, scal, v, y, mask = _numpy_inputs(27, 1, "logistic")
    chol, u, v = chol[:5], u[:5, :32], v[:5, 0, :32]
    angle = (scal[:5, 0, 2] - np.pi).astype(F32)
    active = np.float32([1, 0, 1, 1, 0])
    got, items = rot_weights_round_model(chol, u, v, angle, active, y, mask,
                                         "logistic")
    n_tiles = N // TILE
    assert items == [0, 2, 3] * n_tiles
    assert (got[active == 0] == 0).all()
    plain = tfe._ref_rot_weights(*map(_t, (chol, u, v, angle, y, mask)),
                                 "logistic", active=_t(active)).numpy()
    np.testing.assert_allclose(got, plain, rtol=LL_RTOL, atol=LL_TOL)
    j = [jnp.asarray(a) for a in (y, mask)]
    for b in (0, 2, 3):
        want = np.asarray(jfe._pallas_rot_weights(
            jnp.asarray(chol[b]), jnp.asarray(u[b]), jnp.asarray(v[b]),
            jnp.asarray(angle[b]), *j, "logistic", interpret=True))
        np.testing.assert_allclose(got[b], want, rtol=LL_RTOL, atol=LL_TOL)


@pytest.mark.parametrize("s_local", [8, 16, 32])
def test_rot_weights_round_model_rows_are_independent(s_local):
    """A row's weight has the same bits whichever rows share its call: the
    sharded ranks, each with S / K rows, rest on it."""
    chol, u, scal, v, y, mask = _numpy_inputs(28, 1, "probit")
    chol, u, v = chol[:2], u[:2], v[:2, 0]
    angle = scal[:2, 0, 2].astype(F32)
    active = np.ones(2, F32)
    full, _ = rot_weights_round_model(chol, u, v, angle, active, y, mask,
                                      "probit")
    for r0 in range(0, S, s_local):
        rows = slice(r0, r0 + s_local)
        part, _ = rot_weights_round_model(chol, u[:, rows], v[:, rows], angle,
                                          active, y, mask, "probit")
        assert np.array_equal(part, full[:, rows])


# ------------------------ (f), (g) the weights and the rotated estimate


@pytest.mark.parametrize("s_local", [8, 16, 32])
def test_weights_round_model_matches_jax(s_local):
    """The weights' round: each S_local slice of rows bitwise the same rows
    of a call of all 64 (the sharded ranks rest on it), and within
    LL_TOL + LL_RTOL |lw| of both packages' weights."""
    chol, u, _, _, y, mask = _numpy_inputs(29, 1, "logistic")
    chol, u = chol[:2], u[:2]
    full, items = weights_round_model(chol, u, y, mask, "logistic")
    assert items == [0, 1] * (N // TILE)
    for r0 in range(0, S, s_local):
        rows = slice(r0, r0 + s_local)
        part, _ = weights_round_model(chol, u[:, rows], y, mask, "logistic")
        assert np.array_equal(part, full[:, rows])
    u_loc = u[:, :s_local]
    got = full[:, :s_local]
    plain = tfe._ref_weights(*map(_t, (chol, u_loc, y, mask)),
                             "logistic").numpy()
    np.testing.assert_allclose(got, plain, rtol=LL_RTOL, atol=LL_TOL)
    j = [jnp.asarray(a) for a in (y, mask)]
    for b in range(len(u)):
        want = np.asarray(jfe._pallas_weights(
            jnp.asarray(chol[b]), jnp.asarray(u_loc[b]), *j, "logistic",
            interpret=True))
        np.testing.assert_allclose(got[b], want, rtol=LL_RTOL, atol=LL_TOL)


def test_estimate_rot_round_model_matches_jax():
    """The rotated estimate's round over the active chains: within
    LL_TOL + LL_RTOL |ll| of both packages' rotated estimate; the chains
    not wanted give 0 and the others keep the bits of a call with every
    chain active."""
    chol, u, scal, v, y, mask = _numpy_inputs(30, 1, "probit")
    chol, u, v = chol[:5], u[:5], v[:5, 0]
    angle = (scal[:5, 0, 2] - np.pi).astype(F32)
    active = np.float32([1, 0, 1, 1, 0])
    got, items = estimate_rot_round_model(chol, u, v, angle, active, y, mask,
                                          "probit")
    assert items == [0, 2, 3] * (N // TILE)
    every, _ = estimate_rot_round_model(chol, u, v, angle, None, y, mask,
                                        "probit")
    assert (got[active == 0] == 0).all()
    assert np.array_equal(got[active != 0], every[active != 0])
    plain = tfe._ref_estimate_rot(*map(_t, (chol, u, v, angle, y, mask)),
                                  "probit", N_BLOCKS,
                                  active=_t(active)).numpy()
    assert np.all(np.abs(got - plain) <= LL_TOL + LL_RTOL * np.abs(plain))
    j = [jnp.asarray(a) for a in (y, mask)]
    for b in (0, 2, 3):
        want = float(jfe._pallas_estimate_rot(
            jnp.asarray(chol[b]), jnp.asarray(u[b]), jnp.asarray(v[b]),
            jnp.asarray(angle[b]), *j, "probit", n_blocks=N_BLOCKS,
            interpret=True))
        assert abs(got[b] - want) <= LL_TOL + LL_RTOL * abs(want)


@pytest.mark.parametrize("entry", ["weights", "estimate_rot"])
def test_round_models_at_n1024(entry):
    """n = 1024, past the left operand that bounded the earlier design: both
    models against the plain versions of both packages (S = 8, 2 chains)."""
    n, s = 1024, 8
    rng = np.random.default_rng(31)
    chol = (np.tril(rng.standard_normal((2, n, n)) * 0.03)
            + np.eye(n)).astype(F32)
    u = rng.standard_normal((2, s, n)).astype(F32)
    v = rng.standard_normal((2, s, n)).astype(F32)
    angle = np.float32([0.7, -2.5])
    y = rng.choice([-1.0, 1.0], n).astype(F32)
    mask = (np.arange(n) < n - 37).astype(F32)
    j = [jnp.asarray(a) for a in (y, mask)]
    if entry == "weights":
        got, _ = weights_round_model(chol, u, y, mask, "logistic")
        plain = tfe._ref_weights(*map(_t, (chol, u, y, mask)),
                                 "logistic").numpy()
        jax_ref = np.stack([np.asarray(jfe._ref_weights(
            jnp.asarray(chol[b]), jnp.asarray(u[b]), *j, "logistic"))
            for b in range(2)])
    else:
        got, _ = estimate_rot_round_model(chol, u, v, angle, None, y, mask,
                                          "logistic")
        plain = tfe._ref_estimate_rot(*map(_t, (chol, u, v, angle, y, mask)),
                                      "logistic", N_BLOCKS).numpy()
        jax_ref = np.stack([np.asarray(jfe._ref_estimate(
            jnp.asarray(chol[b]),
            jnp.asarray(u[b] * np.cos(angle[b]) + v[b] * np.sin(angle[b])),
            *j, "logistic", n_blocks=N_BLOCKS)) for b in range(2)])
    for want in (plain, jax_ref):
        assert np.all(np.abs(got - want) <= LL_TOL + LL_RTOL * np.abs(want))


# ------------------------------------------------ (b) the 32-block panel

NB = 32


def panel_model(a, out="v3"):
    """The schedule of csrc/chol_panel.cu on one (128,128) tile, float32, in
    the kernel's output modes: ``out="v3"`` -> (L lower, inv(L)^T upper),
    ``"v1"`` -> (L, inv(L)), both lower, ``"v2"`` -> L (no inverse phase)."""
    inverse = out != "v2"
    a = a.astype(F32).copy()
    x = np.zeros_like(a)
    inv_d = np.zeros(128, F32)
    blk = [slice(j * NB, (j + 1) * NB) for j in range(128 // NB)]
    with np.errstate(invalid="ignore"):
        for j, s in enumerate(blk):
            d_blk = a[s, s].copy()     # diagonal block, column by column
            for k in range(NB):
                pivot = d_blk[k, k]
                d = np.sqrt(pivot) if pivot > 0 else F32(np.nan)
                inv_d[j * NB + k] = F32(1) / d
                col = d_blk[k + 1:, k] * inv_d[j * NB + k]
                d_blk[k + 1:, k + 1:] -= np.outer(col, col)
                d_blk[k + 1:, k], d_blk[k, k] = col, d
            l_jj = np.tril(d_blk)
            a[s, s] = l_jj
            if inverse:
                x_jj = np.zeros((NB, NB), F32)     # forward substitution
                for r in range(NB):
                    x_jj[r] = (np.eye(NB, dtype=F32)[r]
                               - l_jj[r, :r] @ x_jj[:r]) * inv_d[j * NB + r]
                x[s, s] = x_jj
            below = slice((j + 1) * NB, 128)   # rows below, one per thread
            p = a[below, s].copy()
            for k in range(NB):
                p[:, k] *= inv_d[j * NB + k]
                p[:, k + 1:] -= np.outer(p[:, k], l_jj[k + 1:, k])
            a[below, s] = p
            for pp in range(j + 1, len(blk)):  # trailing, lower blocks only
                for q in range(j + 1, pp + 1):
                    a[blk[pp], blk[q]] -= a[blk[pp], s] @ a[blk[q], s].T
        for i in range(1, len(blk)) if inverse else ():   # inv(L), by rows
            t = {j: sum(a[blk[i], blk[k]] @ x[blk[k], blk[j]]
                        for k in range(j, i)) for j in range(i)}
            for j in range(i):
                x[blk[i], blk[j]] = -(x[blk[i], blk[i]] @ t[j])
    if out == "v2":
        return np.tril(a)
    return np.tril(a), (np.tril(x) if out == "v1" else np.triu(x.T))


def _spd_tiles(b, seed, jitter=1e-2):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((128, 3))
    sq = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    ells = rng.uniform(0.5, 3.0, b)
    k = (np.exp(-0.5 * sq[None] / ells[:, None, None] ** 2)
         + jitter * np.eye(128))
    return k.astype(F32)


def _indefinite_at(tile, col):
    """The tile with its pivot at ``col`` made -0.5 (earlier pivots kept)."""
    tile = tile.copy()
    l64 = np.linalg.cholesky(tile.astype(np.float64))
    tile[col, col] = F32((l64[col, :col] ** 2).sum() - 0.5)
    return tile


def test_panel_model_matches_jax_interpret():
    tiles = _spd_tiles(3, seed=11)
    l_j, xt_j = (np.asarray(o) for o in jchol.chol_panel_batched3(
        jnp.asarray(tiles), bt=1, interpret=True))
    for b in range(len(tiles)):
        l_m, xt_m = panel_model(tiles[b])
        np.testing.assert_allclose(l_m, l_j[b], rtol=0, atol=CHOL_TOL)
        np.testing.assert_allclose(xt_m, xt_j[b], rtol=2e-3, atol=2e-3)
        resid = xt_m.T @ l_m - np.eye(128)
        assert np.abs(resid).max() <= 2e-4
        assert np.all(np.triu(l_m, 1) == 0) and np.all(np.tril(xt_m, -1) == 0)


@pytest.mark.parametrize("col", [40, 100])
def test_panel_model_nan_from_the_failing_column(col):
    tile = _indefinite_at(_spd_tiles(1, seed=12 + col)[0], col)
    l_m, _ = panel_model(tile)
    l_j, _ = (np.asarray(o)[0] for o in jchol.chol_panel_batched3(
        jnp.asarray(tile[None]), bt=1, interpret=True))
    for l in (l_m, l_j):
        diag = np.diagonal(l)
        assert np.all(np.isfinite(diag[:col])) and np.all(np.isnan(diag[col:]))
    np.testing.assert_allclose(l_m[:, :col], l_j[:, :col], rtol=0,
                               atol=CHOL_TOL)


def _reference_body(tiles, body):
    """The reference's v1 or v2 panel body in interpret mode: v1 -> (L,
    inv(L)), v2 -> L (its transposed output swapped back, as its wrapper
    does)."""
    out = (interpret_v1 if body == "v1" else interpret_v2)(jnp.asarray(tiles))
    if body == "v1":
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


@pytest.mark.parametrize("body", ["v1", "v2"])
def test_panel_model_matches_the_v1_v2_bodies(body):
    tiles = _spd_tiles(2, seed=21)
    got_j = _reference_body(tiles, body)
    for b in range(len(tiles)):
        got_m = panel_model(tiles[b], out=body)
        if body == "v1":
            (l_m, x_m), (l_j, x_j) = got_m, (o[b] for o in got_j)
            np.testing.assert_allclose(x_m, x_j, rtol=2e-3, atol=2e-3)
            assert np.abs(x_m @ l_m - np.eye(128)).max() <= 2e-4
            assert np.all(np.triu(x_m, 1) == 0)
        else:
            l_m, l_j = got_m, got_j[b]
        np.testing.assert_allclose(l_m, np.tril(l_j), rtol=0, atol=CHOL_TOL)
        assert np.all(np.triu(l_m, 1) == 0)
        # one factor code: the mode changes no bit of L
        np.testing.assert_array_equal(l_m, panel_model(tiles[b])[0])


@pytest.mark.parametrize("col", [40, 100])
@pytest.mark.parametrize("body", ["v1", "v2"])
def test_panel_model_nan_from_the_failing_column_in_v1_v2(body, col):
    tile = _indefinite_at(_spd_tiles(1, seed=12 + col)[0], col)
    l_m = panel_model(tile, out=body)
    l_j = _reference_body(tile[None], body)
    l_m, l_j = (l_m[0], l_j[0][0]) if body == "v1" else (l_m, l_j[0])
    for l in (l_m, l_j):
        diag = np.diagonal(l)
        assert np.all(np.isfinite(diag[:col])) and np.all(np.isnan(diag[col:]))
    np.testing.assert_allclose(l_m[:, :col], l_j[:, :col], rtol=0,
                               atol=CHOL_TOL)
