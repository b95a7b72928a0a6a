#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the port's main path (BASELINE config 2: ``aux_slice`` on the GP
classification posterior, Pima n=532 padded to 640, S=64, 128 chains) through
``auxpm_tpu_torch.run.main`` and holds each of its four hand-written CUDA
kernels against its plain PyTorch version on the card.  Phases, one JSON line
each; any failure raises and the script exits non-zero:

1. ``device``     the card (name and power limit from ``nvidia-smi``) and the
                  build of ``auxpm_tpu_torch/csrc/*.cu`` with ``nvcc``;
2. ``kernels``    each kernel vs its plain version at the main path's shapes
                  (B=128, S=64, n=640), timed with CUDA events between L2
                  flushes, beside the least time the card could take;
3. ``main_path``  the CLI run; every kernel's launch count must rise, the
                  chains must be finite and moving, and the carried factor
                  must equal ``cache_init(theta)`` on the final state;
4. ``path_parity`` one step from the final state with the same random rows,
                  kernels vs plain versions: decisions equal, values within
                  the bars stated where they are checked.

Then one line ``{"kernels": [...]}``, the ``nvidia-smi`` line, and the last
line ``{"ok": true, "device": {...}}``.  Exits non-zero without a GPU.

Tolerances (kernel vs plain version, both float32 on the card): the estimate
is a sum of n=640 O(1) terms per sample, ~-350 in total (thousands at large
sigma), taken in another order (one ulp at 350 is 3e-5): 2e-4 + 2e-6 |ll|.  The factor of a 128-tile: 5e-4, the
bar of the reference's Cholesky tests.  u' after a sweep: 1e-5.  Shrink and
moved counts must be EQUAL on every chain whose decisions all sat further
than the value tolerance from their slice level (the plain version records
the margins); a chain with a decision inside the tolerance may fall either
way and is reported, and more than two such chains fail the run.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from unittest import mock

B, S, N, N_ESS, N_SIGMA = 128, 64, 640, 4, 2
LL_TOL, LL_RTOL, U_TOL, CHOL_TOL, SIGMA_TOL = 2e-4, 2e-6, 1e-5, 5e-4, 1e-5
BF16_SCALED_TOL = 2e-2
PATH_CHOL_TOL, PATH_LL_TOL = 1e-2, 5e-2   # through a refactorisation
MAX_AMBIGUOUS = 2
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
FP32_FLOPS = 67e12          # H100 SXM, float32 outside the tensor cores
CLI_ARGS = [
    "--preset", "pima_aux_slice", "--chains", str(B), "--max-step-out", "0",
    "--n-ess", str(N_ESS), "--n-sigma-extra", str(N_SIGMA - 1),
    "--max-shrink-chol", "3", "--warmup-windows", "2", "--window-steps", "10",
    "--steps", "20",
]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def bound(bytes_moved, flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def main():
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this script "
            "needs one NVIDIA GPU")
        return 1

    import numpy as np

    from auxpm_tpu_torch import run as port_run
    from auxpm_tpu_torch.models.datasets import load
    from auxpm_tpu_torch.models.gp_classification import make_gp_classification
    from auxpm_tpu_torch.ops import _build, chol_hopper, cholesky
    from auxpm_tpu_torch.ops import ess_sweep as ess
    from auxpm_tpu_torch.ops import fused_estimator as fe
    from auxpm_tpu_torch.ops import sigma_sweep as sig
    from auxpm_tpu_torch.ops.gram import se_gram_iso

    dev = torch.device("cuda")
    t_start = time.time()

    # ---------------------------------------------------------------- device
    smi = nvidia_smi_line()
    t0 = time.time()
    lib_path = _build.build(force=True)
    _build.load_library()
    build_s = time.time() - t0
    emit({"phase": "device", "card": smi, "kind": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "library": str(lib_path.relative_to(lib_path.parents[1])),
          "build_seconds": round(build_s, 2)})

    flush_buf = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)

    def time_ms(fn, reps=5):
        """Median milliseconds of ``fn`` over ``reps`` launches, each after a
        256 MB write that evicts the 50 MB L2."""
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            flush_buf.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    def t(a):
        return torch.as_tensor(np.array(a, dtype=np.float32), device=dev)

    def max_err(a, b):
        return float((a - b).abs().max())

    # ---------------------------------------------------------------- inputs
    rng = np.random.default_rng(2026)
    x, y_np = load("pima")
    target = make_gp_classification(x, y_np, n_importance=S, device="cuda")
    assert target.u_shape == (S, N)
    y = t(np.concatenate([y_np, np.ones(N - len(y_np))]))
    mask = t(np.concatenate([np.ones(len(y_np)), np.zeros(N - len(y_np))]))
    theta = t(rng.normal(size=(B, 2)) * 0.5)
    sqdist = t(_pima_sqdist(np, x, N))
    gram = se_gram_iso(sqdist, theta[:, 0], 0.0, 1e-5)        # (B, n, n)
    chol_r = torch.linalg.cholesky(gram).contiguous()          # inputs only
    assert torch.isfinite(chol_r).all()
    chol = torch.exp(theta[:, 1])[:, None, None] * chol_r
    u = t(rng.standard_normal((B, S, N)))

    def ambiguous_chains(probe_log, tol):
        amb = torch.zeros(B, dtype=torch.bool, device=dev)
        for active, margin in probe_log:
            amb |= active & (margin.abs() <= tol)
        return amb

    def check_counts(name, pairs, amb):
        n_amb = int(amb.sum())
        if n_amb > MAX_AMBIGUOUS:
            failures.append(f"{name}: {n_amb} chains had a decision within "
                            "tolerance of its slice level")
        for what, k, p in pairs:
            if not torch.equal(k[~amb], p[~amb]):
                bad = int((k[~amb] != p[~amb]).sum())
                failures.append(f"{name}: {what} differs on {bad} chains")
        return n_amb

    failures = []   # checked after each phase's line is printed

    def check_close(name, what, k, p, tol, keep=None, rtol=0.0):
        """Record a failure unless |k - p| <= tol + rtol |p| everywhere;
        returns the largest absolute difference."""
        if keep is not None:
            k, p = k[keep], p[keep]
        err = max_err(k, p)
        within = bool(((k - p).abs() <= tol + rtol * p.abs()).all())
        if not within or not bool(torch.isfinite(k).all()):
            failures.append(f"{name}: {what} max abs err {err:.3e} exceeds "
                            f"{tol} + {rtol} |ref|")
        return err

    def end_phase():
        if failures:
            raise AssertionError("; ".join(failures))

    kernels = {}

    # ------------------------------------------------------- fused estimator
    log("kernels: fused estimator")
    variants = {}
    for lik, wd in (("logistic", "float32"), ("probit", "float32"),
                    ("logistic", "bfloat16")):
        k_out = fe.fused_estimate(chol, u, y, mask, lik, 8, None, wd)
        p_out = fe._ref_estimate(chol, u, y, mask, lik, 8, None, wd)
        torch.cuda.synchronize()
        variants[f"{lik}/{wd}"] = check_close("fused_estimator", f"{lik}/{wd}",
                                              k_out, p_out, LL_TOL, rtol=LL_RTOL)
    b_ms, b_by = bound(4 * (B * (N * N + S * N) + 2 * N + B),
                       B * fe.probe_flops(S, N))
    kernels["fused_estimator"] = {
        "name": "fused_estimator", "route": "cuda",
        "source": "auxpm_tpu_torch/csrc/fused_estimator.cu",
        "replaces": "auxpm_tpu/ops/fused_estimator.py:265",
        "max_abs_err": variants["logistic/float32"], "tol": LL_TOL,
        "variants_max_abs_err": variants,
        "ms": time_ms(lambda: fe.fused_estimate(chol, u, y, mask, "logistic", 8)),
        "plain_ms": time_ms(lambda: fe._ref_estimate(chol, u, y, mask,
                                                     "logistic", 8)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }

    # ------------------------------------------------------- Cholesky panel
    log("kernels: Cholesky panel")
    tiles = gram[:, :128, :128].contiguous()
    l_k, xt_k = chol_hopper.chol_panel_batched3(tiles)
    l_p, xt_p = chol_hopper._ref_chol_panel(tiles)
    torch.cuda.synchronize()
    err_l = check_close("chol_panel", "L", l_k, l_p, CHOL_TOL)
    eye = torch.eye(128, device=dev)
    resid = max_err(torch.bmm(xt_k.mT, l_k), eye.expand(B, 128, 128))
    resid_plain = max_err(torch.bmm(xt_p.mT, l_p), eye.expand(B, 128, 128))
    inv_scale = float(xt_p.abs().max())
    # inv(L) L = I to the reference test's 2e-4, scaled by the size of the
    # inverse's entries on these tiles
    if not resid <= 2e-4 * max(1.0, inv_scale):
        raise AssertionError(f"chol_panel: |inv(L) L - I| = {resid:.3e}")
    if float(torch.triu(l_k, 1).abs().max()) != 0.0 or \
            float(torch.tril(xt_k, -1).abs().max()) != 0.0:
        raise AssertionError("chol_panel: L not lower or inv(L)^T not upper")
    # NaN contract: an indefinite tile fails alone, as NaN on L's diagonal
    sick = tiles.clone()
    sick[5] -= 0.5 * eye
    l_s, _ = chol_hopper.chol_panel_batched3(sick)
    d_s = torch.diagonal(l_s, dim1=-2, dim2=-1)
    if not bool(torch.isnan(d_s[5]).any()) or \
            not bool(torch.isfinite(torch.cat([d_s[:5], d_s[6:]])).all()):
        raise AssertionError("chol_panel: NaN contract broken")
    # the blocked factorisation at the main path's shape.  Two f32 factorisations of
    # a Gram with condition number up to ~1e7 differ elementwise by far more
    # than any fixed bar, so it is held to the backward error
    # |L L^T - K| (entries of K are <= 1) on the matrices it factors, and a
    # matrix it fails on (NaN) must be one robust_cholesky repairs.
    l_drv = chol_hopper.cholesky_batched3(gram)
    ok_drv = torch.isfinite(torch.diagonal(l_drv, dim1=-2, dim2=-1)).all(-1)
    n_failed = int((~ok_drv).sum())
    if n_failed > B // 4:
        raise AssertionError(f"cholesky_batched3 failed on {n_failed} of {B}")
    back_drv = max_err(torch.bmm(l_drv[ok_drv], l_drv[ok_drv].mT), gram[ok_drv])
    back_lib = max_err(torch.bmm(chol_r, chol_r.mT), gram)
    if not back_drv <= 1e-4:
        raise AssertionError(f"cholesky_batched3: |L L^T - K| = {back_drv:.3e}")
    diff_drv = max_err(l_drv[ok_drv], chol_r[ok_drv])
    l_r, extra = cholesky._robust_cholesky_impl(gram, jitter0=1e-5)
    if not bool(torch.isfinite(l_r).all()) or \
            not torch.equal(extra > 0, ~ok_drv):
        raise AssertionError("robust_cholesky: did not repair exactly the "
                             "matrices the blocked factorisation failed on")
    # escalation is per matrix: make one healthy matrix indefinite
    h = int(torch.nonzero(extra == 0)[0])
    sick_gram = gram.clone()
    lam = float(torch.linalg.eigvalsh(gram[h].double())[0])
    sick_gram[h] -= (lam + 3e-4) * torch.eye(N, device=dev)
    l_s2, extra_s = cholesky._robust_cholesky_impl(sick_gram, jitter0=1e-5)
    others = torch.arange(B, device=dev) != h
    if not bool(torch.isfinite(l_s2).all()) or float(extra_s[h]) <= 0 or \
            not torch.equal(extra_s[others], extra[others]):
        raise AssertionError("robust_cholesky: escalation not per matrix")
    b_ms, b_by = bound(4 * 3 * B * 128 * 128, B * 2 * 128**3 / 3.0)
    kernels["chol_panel"] = {
        "name": "chol_panel_v3", "route": "cuda",
        "source": "auxpm_tpu_torch/csrc/chol_panel.cu",
        "replaces": "auxpm_tpu/ops/chol_pallas.py:451",
        "max_abs_err": err_l, "tol": CHOL_TOL,
        "inverse_residual": resid, "plain_inverse_residual": resid_plain,
        "blocked_backward_err": back_drv, "library_backward_err": back_lib,
        "blocked_vs_library_max_abs_diff": diff_drv,
        "blocked_failed_before_escalation": n_failed,
        "ms": time_ms(lambda: chol_hopper.chol_panel_batched3(tiles)),
        "plain_ms": time_ms(lambda: chol_hopper._ref_chol_panel(tiles)),
        "bound_ms": b_ms, "bound_by": b_by,
        # one PyTorch call for the same tiles (the factor only, no inverse)
        "library_ms": time_ms(lambda: torch.linalg.cholesky(tiles)),
        "blocked_ms": time_ms(lambda: chol_hopper.cholesky_batched3(gram), 3),
        "blocked_library_ms": time_ms(lambda: torch.linalg.cholesky(gram), 3),
    }

    # ------------------------------------------------------------ ESS sweep
    log("kernels: ESS sweep")
    v = t(rng.standard_normal((B, N_ESS, S, N)))
    scal_np = np.zeros((B, N_ESS, 3 + 32), np.float32)
    scal_np[:, :, 1] = np.log(rng.uniform(size=(B, N_ESS)))
    scal_np[:, :, 2] = rng.uniform(size=(B, N_ESS)) * 2.0 * np.pi
    scal_np[:, :, 3:] = rng.uniform(size=(B, N_ESS, 32))
    ess_err = {}
    for lik in ("logistic", "probit"):
        scal = t(scal_np)
        scal[:, 0, 0] = fe._ref_estimate(chol, u, y, mask, lik, 8)
        probe_log = []
        u_k, ll_k, ns_k, mv_k = ess.ess_sweep(chol, u, scal, v, y, mask, lik,
                                              8, None, N_ESS)
        u_p, ll_p, ns_p, mv_p = ess._ref_ess_sweep(
            chol, u, scal, v, y, mask, lik, 8, None, N_ESS, "float32",
            probe_log=probe_log)
        torch.cuda.synchronize()
        amb = ambiguous_chains(probe_log, LL_TOL)
        n_amb = check_counts("ess_sweep", [("n_shrink", ns_k, ns_p),
                                           ("moved", mv_k, mv_p)], amb)
        ess_err[lik] = {
            "u": check_close("ess_sweep", "u'", u_k, u_p, U_TOL, ~amb),
            "ll": check_close("ess_sweep", f"ll ({lik})", ll_k, ll_p, LL_TOL,
                              ~amb, LL_RTOL),
            "ambiguous_chains": n_amb,
            "probes": float(ns_p.sum()) + B * N_ESS,
            "moved": float(mv_p.sum()),
        }
        if lik == "logistic":
            scal_logistic = scal
    probes = ess_err["logistic"]["probes"]
    b_ms, b_by = bound(
        4 * B * (N * N + (2 + N_ESS) * S * N + N_ESS * 35 + 4),
        probes * fe.probe_flops(S, N))
    kernels["ess_sweep"] = {
        "name": "ess_sweep", "route": "cuda",
        "source": "auxpm_tpu_torch/csrc/ess_sweep.cu",
        "replaces": "auxpm_tpu/ops/ess_sweep.py:156",
        "max_abs_err": ess_err["logistic"]["ll"], "tol": LL_TOL,
        "u_max_abs_err": ess_err["logistic"]["u"], "u_tol": U_TOL,
        "variants": ess_err, "probes": probes,
        "ms": time_ms(lambda: ess.ess_sweep(chol, u, scal_logistic, v, y, mask,
                                            "logistic", 8, None, N_ESS), 3),
        "plain_ms": time_ms(lambda: ess._ref_ess_sweep(
            chol, u, scal_logistic, v, y, mask, "logistic", 8, None, N_ESS,
            "float32"), 3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }

    # ---------------------------------------------------------- sigma sweep
    log("kernels: sigma sweep")
    rep = t(rng.uniform(size=(B, N_SIGMA, 2 + 32)))
    rep[:, :, 0] = torch.log(rep[:, :, 0])
    hiv = 0.5 / 1.5**2
    sig_err = {}
    for wd in ("float32", "bfloat16"):
        ll0 = fe._ref_estimate(chol, u, y, mask, "logistic", 8, None, wd)
        d0 = theta[:, 1]
        lp_rest = target.log_prior(theta) + hiv * d0 * d0
        chain = torch.stack(
            [ll0, target.log_prior(theta) + ll0, theta[:, 1],
             torch.full_like(ll0, 1.2), torch.zeros_like(ll0),
             torch.full_like(ll0, hiv), lp_rest, torch.zeros_like(ll0)],
            dim=1).contiguous()
        probe_log = []
        out_k = sig.sigma_sweep(chol_r, u, chain, rep, y, mask, "logistic", 8,
                                None, N_SIGMA, wd)
        out_p = sig._ref_sigma_sweep(chol_r, u, chain, rep, y, mask,
                                     "logistic", 8, None, N_SIGMA, wd,
                                     probe_log=probe_log)
        torch.cuda.synchronize()
        # bfloat16: exp(x) from expf and from torch.exp may differ by an ulp,
        # which moves a few of the n*n scaled elements across a bf16 rounding
        # boundary (a 2^-8 relative step each): a looser bar, stated
        ll_tol = LL_TOL if wd == "float32" else BF16_SCALED_TOL
        amb = ambiguous_chains(probe_log, ll_tol)
        n_amb = check_counts("sigma_sweep", [("n_shrink", out_k[3], out_p[3]),
                                             ("moved", out_k[4], out_p[4])],
                             amb)
        sig_err[wd] = {
            "sigma": check_close("sigma_sweep", "sigma'", out_k[0], out_p[0],
                                 SIGMA_TOL, ~amb),
            "ll": check_close("sigma_sweep", f"ll ({wd})", out_k[1], out_p[1],
                              ll_tol, ~amb, LL_RTOL),
            "lp": check_close("sigma_sweep", f"lp ({wd})", out_k[2], out_p[2],
                              ll_tol, ~amb, LL_RTOL),
            "ambiguous_chains": n_amb,
            "probes": float(out_p[3].sum()), "moved": float(out_p[4].sum()),
        }
        if wd == "float32":
            chain_f32 = chain
    probes = sig_err["float32"]["probes"]
    b_ms, b_by = bound(4 * B * (N * N + S * N + 8 + N_SIGMA * 34 + 8),
                       probes * fe.probe_flops(S, N))
    kernels["sigma_sweep"] = {
        "name": "sigma_sweep", "route": "cuda",
        "source": "auxpm_tpu_torch/csrc/sigma_sweep.cu",
        "replaces": "auxpm_tpu/ops/sigma_sweep.py:157",
        "max_abs_err": sig_err["float32"]["ll"], "tol": LL_TOL,
        "sigma_max_abs_err": sig_err["float32"]["sigma"],
        "sigma_tol": SIGMA_TOL, "variants": sig_err, "probes": probes,
        "ms": time_ms(lambda: sig.sigma_sweep(chol_r, u, chain_f32, rep, y,
                                              mask, "logistic", 8, None,
                                              N_SIGMA), 3),
        "plain_ms": time_ms(lambda: sig._ref_sigma_sweep(
            chol_r, u, chain_f32, rep, y, mask, "logistic", 8, None, N_SIGMA,
            "float32"), 3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }

    # ------------------------------------------- a small shape, the shrink cap
    log("kernels: a small shape and the shrink cap")
    bs, ss, ns = 5, 16, 256
    chol_s = chol[:bs, :ns, :ns].contiguous()
    u_s = u[:bs, :ss, :ns].contiguous()
    y_s, mask_s = y[:ns], mask[:ns]
    edge = {}
    for nb in (1, 8):
        edge[f"estimate_n_blocks_{nb}"] = check_close(
            "fused_estimator", f"S={ss} n={ns} n_blocks={nb}",
            fe.fused_estimate(chol_s, u_s, y_s, mask_s, "logistic", nb),
            fe._ref_estimate(chol_s, u_s, y_s, mask_s, "logistic", nb),
            LL_TOL, rtol=LL_RTOL)
    # a slice level no probe can reach: 32 shrinks, then the state is kept
    # exactly (bitwise)
    scal_s = t(scal_np[:bs, :1])
    scal_s[:, 0, 0] = fe._ref_estimate(chol_s, u_s, y_s, mask_s, "logistic", 8)
    scal_s[:, 0, 1] = 1e4
    u_c, ll_c, ns_c, mv_c = ess.ess_sweep(
        chol_s, u_s, scal_s, v[:bs, :1, :ss, :ns].contiguous(), y_s, mask_s,
        "logistic", 8, None, 1)
    if not (torch.equal(u_c, u_s) and torch.equal(ll_c, scal_s[:, 0, 0])
            and bool((ns_c == 32).all()) and bool((mv_c == 0).all())):
        failures.append("ess_sweep: cap-hit did not keep the state")
    chain_s = chain_f32[:bs].contiguous()
    rep_s = rep[:bs, :1].clone()
    rep_s[:, :, 0] = 1e4
    out_c = sig.sigma_sweep(chol_r[:bs, :ns, :ns].contiguous(), u_s, chain_s,
                            rep_s, y_s, mask_s, "logistic", 8, None, 1)
    if not (torch.equal(out_c[0], chain_s[:, 2])
            and torch.equal(out_c[1], chain_s[:, 0])
            and torch.equal(out_c[2], chain_s[:, 1])
            and bool((out_c[3] == 32).all()) and bool((out_c[4] == 0).all())):
        failures.append("sigma_sweep: cap-hit did not keep the point")
    torch.cuda.synchronize()
    emit({"phase": "kernels", "shape": {"B": B, "S": S, "n": N},
          "kernels": list(kernels.values()),
          "small_shape": {"B": bs, "S": ss, "n": ns, "max_abs_err": edge,
                          "cap_hit_keeps_state": not failures}})
    end_phase()

    # ------------------------------------------------------------ main path
    log("main path:", " ".join(CLI_ARGS))
    modules = {"fused_estimator": fe, "chol_panel": chol_hopper,
               "ess_sweep": ess, "sigma_sweep": sig}
    for m in modules.values():
        m.launches = 0
    result = {}
    with contextlib.redirect_stdout(sys.stderr):   # its summary line
        rc = port_run.main(CLI_ARGS, result=result)
    torch.cuda.synchronize()
    counts = {name: m.launches for name, m in modules.items()}
    if rc != 0:
        raise AssertionError(f"run.main returned {rc}")
    for name, c in counts.items():
        kernels[name]["launches"] = c
        if c <= 0:
            raise AssertionError(f"main path never launched {name}")
    states, tgt, params = result["states"], result["target"], result["params"]
    summary = result["summary"]
    if states.u.shape != (B, S, N) or not states.u.is_cuda:
        raise AssertionError("main path did not run at full width on the GPU")
    if not np.isfinite(result["theta"]).all() or \
            not bool(torch.isfinite(states.log_lik_hat).all()):
        raise AssertionError("main path: non-finite theta or log L-hat")
    health = _sampler_health(result)
    cache_err = max_err(states.extras["target_cache"]["chol_r"],
                        tgt.cache_init(states.theta)["chol_r"])
    if not cache_err <= CHOL_TOL:
        raise AssertionError(f"carried factor off by {cache_err:.3e}")
    emit({"phase": "main_path", "card": smi, "args": CLI_ARGS,
          "launches": counts, "summary": summary,
          "chain_steps_per_sec": summary["chain_steps_per_sec"],
          "cache_max_abs_err": cache_err, **health})
    end_phase()

    # ---------------------------------------------------------- path parity
    log("path parity")
    step = port_run_step(tgt)
    ess_t, sl_t = step.stages["ess_u"], step.stages["slice_theta"]
    rows_e = ess_t.draw(states.generator, states)

    def one_step(state):
        mid, info_e = ess_t.apply(state, rows_e, params["ess_u"])
        out, info_s = sl_t.apply(mid, rows_s, params["slice_theta"])
        return out, {**info_e, **info_s}

    rows_s = sl_t.draw(states.generator, states)
    s_k, i_k = one_step(states)
    with contextlib.ExitStack() as stack:
        for mod, cuda_fn, plain_fn in (
                (fe, "_cuda_estimate", fe._ref_estimate),
                (ess, "_cuda_ess_sweep", ess._ref_ess_sweep),
                (sig, "_cuda_sigma_sweep", sig._ref_sigma_sweep),
                (chol_hopper, "_cuda_chol_panel", chol_hopper._ref_chol_panel)):
            stack.enter_context(mock.patch.object(mod, cuda_fn, plain_fn))
        before = {name: m.launches for name, m in modules.items()}
        s_p, i_p = one_step(states)
        if {name: m.launches for name, m in modules.items()} != before:
            raise AssertionError("plain path launched a kernel")
    torch.cuda.synchronize()
    agree = torch.ones(B, dtype=torch.bool, device=dev)
    for k in i_k:
        agree &= i_k[k] == i_p[k]
    n_disagree = int((~agree).sum())
    if n_disagree > MAX_AMBIGUOUS:
        raise AssertionError(f"path parity: decisions differ on {n_disagree} "
                             "chains")
    # theta and u do not pass through a factorisation and keep the kernels'
    # bars.  The carried factor does: the two paths factor the accepted
    # Gram (condition number up to ~1e7) with different panel routines, two
    # valid f32 factors that differ elementwise by up to ~1e-3, and log L-hat
    # off them differs accordingly, so these two get their own stated bars;
    # the kernel path's log L-hat is then held, at the kernels' bar, to the
    # plain estimator on the kernel path's OWN final state.
    parity = {
        "theta": check_close("path_parity", "theta", s_k.theta, s_p.theta,
                             SIGMA_TOL, agree),
        "u": check_close("path_parity", "u", s_k.u, s_p.u, U_TOL, agree),
        "chol_r": check_close("path_parity", "chol_r",
                              s_k.extras["target_cache"]["chol_r"],
                              s_p.extras["target_cache"]["chol_r"],
                              PATH_CHOL_TOL, agree),
        "ll": check_close("path_parity", "ll", s_k.log_lik_hat,
                          s_p.log_lik_hat, PATH_LL_TOL, agree),
        "ll_vs_plain_estimate_of_own_state": check_close(
            "path_parity", "ll of own state", s_k.log_lik_hat,
            fe._ref_estimate(
                tgt.prepare_c(s_k.theta, s_k.extras["target_cache"]), s_k.u,
                y, mask, "logistic", 8), LL_TOL, None, LL_RTOL),
    }
    emit({"phase": "path_parity", "chains_with_a_differing_decision":
          n_disagree, "max_abs_err": parity,
          "probes": {k: float(v.sum()) for k, v in i_k.items()}})
    end_phase()

    # ---------------------------------------------------------------- result
    emit({"kernels": [
        {key: k[key] for key in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "tol", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        | {"kernel_ms": k["ms"]}
        for k in kernels.values()]})
    print(smi, flush=True)
    log(f"chip_smoke: {time.time() - t_start:.1f} s in all")
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def _pima_sqdist(np, x, n):
    """The target's padded squared distances (host f64, pad 1e30, diag 0)."""
    x64 = np.asarray(x, np.float64)
    sq = ((x64[:, None, :] - x64[None, :, :]) ** 2).sum(-1).astype(np.float32)
    big = np.full((n, n), np.float32(1e30))
    big[: len(x), : len(x)] = sq
    np.fill_diagonal(big, 0.0)
    return big


def _sampler_health(result):
    """The sampled chains must move u and probe theta (means over the
    chains and steps of the last sampling window)."""
    window = result["windows"][-1]
    moved, n_probe = window["ess_u/moved"], window["slice_theta/n_probe"]
    if not moved > 0.5:
        raise AssertionError(f"ess_u/moved = {moved}")
    if not n_probe > 0:
        raise AssertionError(f"slice_theta/n_probe = {n_probe}")
    if not math.isfinite(result["summary"]["chain_steps_per_sec"]):
        raise AssertionError("chain_steps_per_sec is not finite")
    return {"ess_u/moved": moved, "slice_theta/n_probe": n_probe,
            "ess_u/n_shrink": window["ess_u/n_shrink"],
            "slice_theta/n_probe_chol": window["slice_theta/n_probe_chol"]}


def port_run_step(target):
    from auxpm_tpu_torch.samplers.composite import SAMPLERS

    return SAMPLERS["aux_slice"](target, n_ess=N_ESS,
                                 n_sigma_extra=N_SIGMA - 1)


if __name__ == "__main__":
    sys.exit(main())
