"""PyTorch port vs the JAX package at every shape the reference runs (CPU).

On the card the port's estimator kernels take any S up to 4096 (row blocks
of 64 rows a work item) and any n (a partial last column tile), the
factorisation takes any n (identity padding to the panel route) and the ARD
Gram any n (scalar stores off a multiple of 4).  Here, on the CPU, each
wrapper takes its plain version, held to the JAX package on the same
NumPy-seeded inputs, and the kernels' new index arithmetic is written out
in NumPy:

- S = 128 and S = 100: the estimate, the rotated estimate, the weights and
  the rotated weights against ``_pallas_*(..., interpret=True)`` within
  1e-4 (the reference's own interpret-vs-ref bar); the ESS sweep against
  ``make_fused_ess_sweep(force=False)`` (decisions equal, no decision within
  1e-4 of its level, u' 1e-5, ll' 1e-4);
- the sweep body's items (chain, row block, column tile) in the kernel's
  order, into rowsum[chain][tile][S] by the kernel's offsets, partial tiles
  and zero-filled chunks included, folded in tile order: every slot written
  once, the fold against ``_pallas_weights(..., interpret=True)`` and
  ``_ref_estimate`` within 2e-4 + 2e-6 |ll|, a row's weight bitwise the
  same in any row block;
- a keyed ``aux_slice`` run of 3 steps at S = 128 (8 chains): keys bitwise,
  decisions equal, theta within 1e-4 and log L-hat within 2e-4 + 2e-6 |ll|;
- unpadded targets (n = 100 and 101, isotropic and ARD at jitter 1e-3)
  against the reference's ``pad_to_tiles=False`` target: ``log_lik_est`` and
  the rotated estimate at fixed (theta, u) within 2e-4 (iso) and 5e-4
  (ARD), and the sweep factories None on both sides;
- the factorisation padded with the identity (``cholesky_padded3``) at
  n = 131: the pad block exactly the identity, the factor within 5e-4 of
  NumPy's; the ARD Gram's schedule at n = 101 unmasked;
- ``utils/smc_scale --target gp --no-pad`` (n = 32) at 1024 particles
  against the reference's ``make_smc_sharded`` on the same target: betas
  within 1e-6 and logZ within 1e-5, as ``tests/test_torch_smc_scale.py``
  holds the toy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auxpm_tpu.core.state import init_chain_states as j_init
from auxpm_tpu.models.datasets import load as jload
from auxpm_tpu.models.gp_classification import make_gp_classification as jmake
from auxpm_tpu.ops import ess_sweep as jess
from auxpm_tpu.ops import fused_estimator as jfe
from auxpm_tpu.parallel.mesh import make_mesh as j_mesh
from auxpm_tpu.samplers.chain import run_chains as j_run_chains
from auxpm_tpu.samplers.composite import SAMPLERS as J_SAMPLERS
from auxpm_tpu.samplers.composite import THETA_ONLY as J_THETA_ONLY
from auxpm_tpu.samplers.smc_sharded import make_smc_sharded as j_smc_sharded
from auxpm_tpu_torch.core.state import init_chain_states as t_init
from auxpm_tpu_torch.models.gp_classification import (
    make_gp_classification as tmake,
)
from auxpm_tpu_torch.models.likelihoods import log_sigmoid
from auxpm_tpu_torch.ops import chol_hopper as tchol
from auxpm_tpu_torch.ops import ess_sweep as tess
from auxpm_tpu_torch.ops import fused_estimator as tfe
from auxpm_tpu_torch.samplers.composite import SAMPLERS
from auxpm_tpu_torch.utils import smc_scale
from tests.test_torch_ard import gram_schedule_model
from tests.test_torch_keys import _params, _words

F32 = np.float32
N, B = 256, 2
EST_TOL = 1e-4           # the reference's interpret-vs-ref bar
LL_TOL, LL_RTOL = 2e-4, 2e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs several workers
    on the same cores, where multi-threaded small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=F32))


def _inputs(seed, s, n=N, b=B):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, s, n)).astype(F32)
    v = rng.standard_normal((b, s, n)).astype(F32)
    chol = (np.tril(rng.standard_normal((b, n, n)) * 0.05)
            + np.eye(n)).astype(F32)
    y = rng.choice([-1.0, 1.0], n).astype(F32)
    mask = np.ones(n, F32)
    mask[-37:] = 0.0
    angle = rng.uniform(-np.pi, np.pi, b).astype(F32)
    return chol, u, v, angle, y, mask


def _n_blocks(s):
    return 8 if s % 8 == 0 else 1


# ------------------------------------------- S past one block of 64 rows


@pytest.mark.parametrize("s", [128, 100])
def test_estimator_entries_match_the_interpret_kernels(s):
    chol, u, v, angle, y, mask = _inputs(s, s)
    nb = _n_blocks(s)
    tc, tu, tv, ta, ty, tm = (_t(a) for a in (chol, u, v, angle, y, mask))
    got = {
        "estimate": tfe.fused_estimate(tc, tu, ty, tm, "logistic", nb),
        "estimate_rot": tfe.fused_estimate_rot(tc, tu, tv, ta, ty, tm,
                                               "logistic", nb),
        "weights": tfe.fused_weights(tc, tu, ty, tm),
        "rot_weights": tfe.fused_rot_weights(tc, tu, tv, ta, ty, tm),
    }
    jy, jm = jnp.asarray(y), jnp.asarray(mask)
    for b in range(B):
        jc, ju, jv = (jnp.asarray(a[b]) for a in (chol, u, v))
        ja = jnp.asarray(angle[b])
        want = {
            "estimate": jfe._pallas_estimate(jc, ju, jy, jm, "logistic",
                                             n_blocks=nb, interpret=True),
            "estimate_rot": jfe._pallas_estimate_rot(
                jc, ju, jv, ja, jy, jm, "logistic", n_blocks=nb,
                interpret=True),
            "weights": jfe._pallas_weights(jc, ju, jy, jm, "logistic",
                                           interpret=True),
            "rot_weights": jfe._pallas_rot_weights(jc, ju, jv, ja, jy, jm,
                                                   "logistic",
                                                   interpret=True),
        }
        for name, w in want.items():
            np.testing.assert_allclose(got[name][b].numpy(), np.asarray(w),
                                       rtol=0, atol=EST_TOL, err_msg=name)
    assert got["weights"].shape == (B, s)


def _ess_inputs(seed, s, n_repeats):
    chol, u, _, _, y, mask = _inputs(seed, s)
    rng = np.random.default_rng(seed + 100)
    v = rng.standard_normal((B, n_repeats, s, N)).astype(F32)
    ll0 = tfe._ref_estimate(_t(chol), _t(u), _t(y), _t(mask), "logistic",
                            _n_blocks(s)).numpy()
    scal = np.zeros((B, n_repeats, tess.SCAL_COLS), F32)
    scal[:, 0, 0] = ll0
    scal[:, :, 1] = np.log(rng.uniform(size=(B, n_repeats)))
    scal[:, :, 2] = rng.uniform(size=(B, n_repeats)) * 2.0 * np.pi
    scal[:, :, 3:] = rng.uniform(size=(B, n_repeats, tess.MAX_SHRINK))
    return chol, u, scal, v, y, mask


@pytest.mark.parametrize("s", [128, 100])
def test_ess_sweep_matches_the_reference(s):
    n_repeats, nb = 2, _n_blocks(s)
    chol, u, scal, v, y, mask = _ess_inputs(40 + s, s, n_repeats)
    probe_log = []
    u_t, ll_t, ns_t, mv_t = tess._ref_ess_sweep(
        _t(chol), _t(u), _t(scal), _t(v), _t(y), _t(mask), "logistic", nb,
        None, n_repeats, "float32", probe_log=probe_log)
    ref = jess.make_fused_ess_sweep(jnp.asarray(y), jnp.asarray(mask),
                                    "logistic", force=False, n_blocks=nb,
                                    n_repeats=n_repeats)
    u_j, ll_j, ns_j, mv_j = jax.jit(jax.vmap(ref))(
        jnp.asarray(chol), jnp.asarray(u), jnp.asarray(scal), jnp.asarray(v))
    margins = torch.cat([m[a].abs() for a, m in probe_log])
    assert float(margins.min()) > 1e-4, "a decision sat within 1e-4"
    np.testing.assert_array_equal(ns_t.numpy(), np.asarray(ns_j))
    np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_j))
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=0,
                               atol=1e-4)
    assert float(ns_t.sum()) > 0 and float(mv_t.sum()) > 0


# ----------------------------- the sweep body's items, written out in NumPy


def body_round_model(chol, left, y, mask, rows=64, cols=64, depth=32):
    """One round of ``csrc/sweep_body.cuh`` over every chain: items w in the
    kernel's order (tile t descending, then chains, then row blocks), each
    the row block's f over tile t's columns, contracting 32-deep chunks of
    k < min(64 (t + 1), n) (the copies zero-fill k >= n and the rows of C
    past n), each element summed over k ascending in one accumulator; the
    likelihood on the columns j < n, each row's sum into rowsum at the
    kernel's offset (b n_tiles + t) S + 64 rb + r.  Returns the flat
    rowsum, how often each slot was written, and the per-chain item
    counts (the estimate's arrival counters)."""
    b_total, s, n = left.shape
    n_tiles, n_rb = -(-n // cols), -(-s // rows)
    per_tile = b_total * n_rb
    rowsum = np.full(b_total * n_tiles * s, np.nan, F32)
    written = np.zeros(rowsum.shape, int)
    arrivals = np.zeros(b_total, int)
    for w in range(n_tiles * per_tile):
        t = n_tiles - 1 - w // per_tile
        rem = w - (n_tiles - 1 - t) * per_tile
        rb, b = rem % n_rb, rem // n_rb
        n_rows = min(rows, s - rb * rows)
        k_end = min(cols * (t + 1), n)
        n_chunks = -(-k_end // depth)
        a = np.zeros((rows, n_chunks * depth), F32)     # a stage's rows
        c = np.zeros((cols, n_chunks * depth), F32)     # rows of C
        k_in = min(n_chunks * depth, n)
        a[:n_rows, :k_in] = left[b, rb * rows:rb * rows + n_rows, :k_in]
        c_rows = chol[b, t * cols:min((t + 1) * cols, n), :k_in]
        c[:len(c_rows), :k_in] = c_rows
        acc = np.zeros((rows, cols), F32)
        for k in range(n_chunks * depth):
            acc = (acc + a[:, k, None] * c[None, :, k]).astype(F32)
        j = t * cols + np.arange(cols)
        keep = j < n
        ll = log_sigmoid(torch.from_numpy(y[j[keep]] * acc[:, keep])).numpy()
        sums = (ll * mask[j[keep]]).sum(-1, dtype=F32)
        off = (b * n_tiles + t) * s + rb * rows
        rowsum[off:off + n_rows] = sums[:n_rows]
        written[off:off + n_rows] += 1
        arrivals[b] += 1
    return rowsum, written, arrivals


def _fold_rows(rowsum, b, n_tiles, s):
    """fold_rows: chain b's tile sums at the kernel's offsets, in tile
    order."""
    acc = np.zeros(s, F32)
    for t in range(n_tiles):
        acc = acc + rowsum[(b * n_tiles + t) * s:(b * n_tiles + t + 1) * s]
    return acc


@pytest.mark.parametrize("s,n", [(100, 128), (128, 101), (72, 64), (8, 100)])
def test_body_round_model_row_blocks_and_partial_tiles(s, n):
    chol, u, _, _, y, mask = _inputs(7 + s + n, s, n)
    rowsum, written, arrivals = body_round_model(chol, u, y, mask)
    n_tiles = -(-n // 64)
    assert (written == 1).all()
    assert (arrivals == n_tiles * -(-s // 64)).all()
    lw = np.stack([_fold_rows(rowsum, b, n_tiles, s) for b in range(B)])
    ref_w = tfe._ref_weights(_t(chol), _t(u), _t(y), _t(mask), "logistic")
    np.testing.assert_allclose(lw, ref_w.numpy(), rtol=LL_RTOL, atol=LL_TOL)
    nb = _n_blocks(s)
    est = tfe._ref_estimate(_t(chol), _t(u), _t(y), _t(mask), "logistic", nb)
    got = torch.stack([tfe.blocked_logsumexp(_t(lw[b]), nb) for b in
                       range(B)]) - float(np.log(F32(s)))
    np.testing.assert_allclose(got.numpy(), est.numpy(), rtol=LL_RTOL,
                               atol=LL_TOL)
    if n % 128 == 0:   # the reference kernel takes 128-aligned n
        jy, jm = jnp.asarray(y), jnp.asarray(mask)
        for b in range(B):
            want = jfe._pallas_weights(jnp.asarray(chol[b]),
                                       jnp.asarray(u[b]), jy, jm, "logistic",
                                       interpret=True)
            np.testing.assert_allclose(lw[b], np.asarray(want),
                                       rtol=LL_RTOL, atol=LL_TOL)
    # a row's weight has the same bits whichever row block holds it
    if s > 64:
        tail, _, _ = body_round_model(chol, u[:, 64:].copy(), y, mask)
        lw_tail = np.stack([_fold_rows(tail, b, n_tiles, s - 64)
                            for b in range(B)])
        assert np.array_equal(lw_tail, lw[:, 64:])


# ---------------------------------------- a keyed run at 128 samples a chain


def test_keyed_aux_slice_at_128_samples_matches_the_reference():
    s, chains, steps = 128, 8, 3
    x, y = jload("pima", subsample=200)
    tj = jmake(x, y, n_importance=s)
    tt = tmake(x, y, n_importance=s, device="cpu")
    assert tt.ess_sweep_factory(2) is not None       # padded: the sweeps
    kw = {"n_ess": 2, "n_sigma_extra": 1}
    step_j, step_t = J_SAMPLERS["aux_slice"](tj, **kw), \
        SAMPLERS["aux_slice"](tt, **kw)
    assert step_t.stages["ess_u"].uses_sweep
    sj = j_init(jax.random.key(5), tj, chains, jitter_scale=0.3,
                with_cache=True)
    st = t_init(5, tt, chains, jitter_scale=0.3, with_cache=True)
    pj, pt = _params("aux_slice")
    for k in range(steps):
        sj, _, info_j = j_run_chains(step_j, sj, pj, 1)
        st, info_t = step_t(st, pt)
        np.testing.assert_array_equal(st.key.numpy(), _words(sj.key))
        for name in ("ess_u/moved", "ess_u/n_shrink", "slice_theta/n_probe",
                     "slice_theta/n_probe_chol"):
            np.testing.assert_array_equal(info_t[name].numpy(),
                                          np.asarray(info_j[name])[:, 0],
                                          err_msg=f"step {k} {name}")
        np.testing.assert_allclose(st.theta.numpy(), np.asarray(sj.theta),
                                   rtol=0, atol=1e-4)
        # the estimator's bar: f32 sums of n terms and of S weights in
        # other orders (~2e-6 relative at |ll| ~130)
        np.testing.assert_allclose(st.log_lik_hat.numpy(),
                                   np.asarray(sj.log_lik_hat), rtol=LL_RTOL,
                                   atol=LL_TOL)


# ------------------------------------------------------- unpadded targets


@pytest.mark.parametrize("n_raw", [100, 101])
@pytest.mark.parametrize("ard", [False, True])
def test_unpadded_target_matches_the_reference(n_raw, ard):
    s = 16
    x, y = jload("pima", subsample=n_raw)
    x = x[:, :3] if ard else x
    kw = dict(n_importance=s, ard=ard, pad_to_tiles=False,
              jitter=1e-3 if ard else 1e-5)
    tj = jmake(x, y, **kw)
    tt = tmake(x, y, device="cpu", **kw)
    assert tt.u_shape == tj.u_shape == (s, n_raw)
    assert tj.ess_sweep_factory is None and tj.sigma_sweep_factory is None
    assert tt.ess_sweep_factory(2) is None
    assert tt.sigma_sweep_factory(2) is None
    rng = np.random.default_rng(n_raw)
    theta = rng.normal(size=(3, tt.d)).astype(F32) * 0.4
    u = rng.standard_normal((3, s, n_raw)).astype(F32)
    v = rng.standard_normal((3, s, n_raw)).astype(F32)
    ang = np.float32([0.4, -1.9, 2.8])
    tol = 5e-4 if ard else LL_TOL
    ll_j = jax.jit(jax.vmap(tj.log_lik_est))(jnp.asarray(theta),
                                             jnp.asarray(u))
    np.testing.assert_allclose(tt.log_lik_est(_t(theta), _t(u)).numpy(),
                               np.asarray(ll_j), rtol=0, atol=tol)
    # the rotated estimate (the per-probe ESS), off the port's factor
    prep = tt.prepare(_t(theta))
    rot = u * np.cos(ang)[:, None, None] + v * np.sin(ang)[:, None, None]
    want = jax.vmap(tj.log_lik_est_u)(jnp.asarray(prep.numpy()),
                                      jnp.asarray(rot))
    np.testing.assert_allclose(
        tt.log_lik_est_rot(prep, _t(u), _t(v), _t(ang)).numpy(),
        np.asarray(want), rtol=0, atol=EST_TOL)


def test_identity_padded_factorisation_is_exact():
    rng = np.random.default_rng(3)
    n = 131
    z = rng.standard_normal((n, 3))
    sq = ((z[:, None] - z[None]) ** 2).sum(-1)
    k = np.stack([np.exp(-0.5 * sq / ell ** 2) + 1e-2 * np.eye(n)
                  for ell in (0.7, 1.9)]).astype(F32)
    l = tchol.cholesky_padded3(_t(k))
    assert l.shape == (2, n, n) and l.is_contiguous()
    np.testing.assert_allclose(l.numpy(), np.linalg.cholesky(
        k.astype(np.float64)), rtol=0, atol=5e-4)
    full = tchol.cholesky_batched3(tchol.pad_gram(_t(k), 256))
    assert torch.equal(full[:, :n, :n], l)
    assert torch.equal(full[:, n:, n:], torch.eye(256 - n).expand(2, -1, -1))
    assert (full[:, n:, :n] == 0).all()


def test_ard_gram_schedule_at_an_n_off_a_multiple_of_4():
    rng = np.random.default_rng(12)
    n, d = 101, 3
    x = rng.standard_normal((n, d)).astype(F32)
    log_ells = rng.normal(size=(2, d)).astype(F32) * 0.3
    got, written = gram_schedule_model(x, log_ells, 1e-5, None)
    assert (written == 1).all()
    assert np.array_equal(got, got.transpose(0, 2, 1))
    from auxpm_tpu_torch.ops import gram as tgram

    plain = tgram.se_gram_ard_masked(_t(x), _t(log_ells), 1e-5).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=2e-5)


# ------------------------------------------- the unpadded GP through SMC


def test_smc_scale_unpadded_gp_matches_the_reference(capsys):
    import json

    argv = ["--target", "gp", "--no-pad", "--subsample", "32",
            "--rejuv", "aux_mh", "--particles", "1024", "--device", "cpu"]
    result = {}
    assert smc_scale.main(argv, result=result) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    diag = result["diag"]
    assert out["padded"] is False and out["target"] == "gp_logistic_n32"
    x, y = jload("pima", subsample=32, seed=0)
    ref = j_smc_sharded(
        jmake(x, y, n_importance=32, pad_to_tiles=False),
        J_THETA_ONLY["mh_theta"], 1024,
        j_mesh(n_chains_shards=1, devices=jax.devices()[:1]), n_mcmc=1,
        ess_frac=0.5, carry_u=False, n_u_mh=2, rejuv_batch=4096,
        time_stages=True, rejuv_dispatches=1, u_blocks=1,
        checkpoint_dir=None)
    _, diag_j = ref(jax.random.key(0))
    assert diag["n_stages"] == diag_j["n_stages"]
    np.testing.assert_allclose(diag["betas"], diag_j["betas"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(diag["log_z"], diag_j["log_z"], rtol=0,
                               atol=1e-5)
    assert diag["betas"][-1] == 1.0 and np.isfinite(diag["log_z"])
