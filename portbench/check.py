"""Whether the timed path's output is correct: the program's chains judged
by the plain reference (``reference/``).

The reference follows the program step by step from the program's own
state: at one step of each block of the window, chains drawn from the seed
are kept (theta, u, key, log L-hat and carried factor before and after the
step; the factor each of their log_ell probes made; the margin of each of
their slice decisions as the program logged it), and after the window the
kept steps (the last one and others drawn from the seed) are replayed
(``reference/step.replay``) and compared.  The start is checked by itself:
the initial chains against the reference's own draws from the seed, and
the slice widths that warm-up adapted against the reference's rule applied
to the warm-up's last window.  Numbers, each with its limit from the cell's
workload file:

- ``key_gap``: chain-steps (and initial chains) whose key differs from the
  reference's (an exact comparison);
- ``state_gap``: the widest gap of theta or u after a step from the
  replay's (the replay that matches best, over the decisions the rounding
  leaves open; infinite where no replay probes log_ell as often as the
  program did), of the initial theta and u, and the relative gap of the
  widths;
- ``ll_gap``: the widest gap, in nats, of a carried log L-hat from the
  float64 estimate at that state's own factor and u, and of a slice
  decision's margin as the program logged it from the replay's;
- ``factor_resid``: the widest relative residual max |L L^T - K| / max |K|
  of a program's factor L (carried, or made by a log_ell probe) against
  R(ell) + jitter I in float64 at its log_ell.

Why the replay takes the program's factors: on these Grams (R(ell) nearly
singular at long lengthscales) a float32 and a float64 factor of one matrix
differ in its near-null directions, and the estimate at one u with them.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench.reference import threefry as tf
from portbench.reference.gp import GPProblem
from portbench.reference.step import replay

NUMBERS = ("key_gap", "state_gap", "ll_gap", "factor_resid")


def _f64(t, device):
    return t.detach().to(device=device, dtype=torch.float64)


def ref_widths(warm_theta, scale, lo=1e-3, hi=1e3):
    """The adaptation rule: ``scale`` x the per-coordinate std over every
    chain and step of the window, clamped."""
    flat = warm_theta.reshape(-1, warm_theta.shape[-1]).double()
    return torch.clamp(scale * flat.std(0, unbiased=False), lo, hi)


def ref_init(prob, chain_seed, n_chains, idx, jitter_scale, d=2):
    """The reference's initial chains ``idx`` (indices into the set of the
    key ``chain_seed``): ``(theta, u, key)``."""
    keys = tf.split(tf.key(chain_seed).to(prob.device), n_chains)[idx]
    k = tf.split(keys, 3)
    theta = (torch.zeros((), dtype=torch.float32, device=prob.device)
             + np.float32(jitter_scale) * tf.normal(k[:, 1], (d,)))
    u = tf.normal(k[:, 0], (prob.s, prob.n_pad))
    return theta, u, k[:, 2]


def judge_step(prob, pre, post, params, sampler, chk):
    """Replay one chain-step and compare it with the program's ``post``
    (``post["ell"]``: the program's log_ell probe factors; ``post[
    "margins"]``: its logged decision margins).  Returns ``(state gap, key
    equal, margin gap, factor residual, replays)``."""
    dev = prob.device
    n = prob.n
    given = {"pre": _f64(pre["chol"], dev)[:n, :n],
             "post": _f64(post["chol"], dev)[:n, :n],
             "ell": [_f64(l, dev)[:n, :n] for l in post["ell"]]}
    start = {"theta": pre["theta"], "u": pre["u"], "key": pre["key"]}
    th_p, u_p = _f64(post["theta"], dev), _f64(post["u"], dev)
    key_p = post["key"].to(dev)
    queue, best, count = [{}], None, 0
    while queue and count < chk["max_replays"]:
        ov = queue.pop(0)
        count += 1
        out, dec = replay(prob, start, params, sampler, given, ov,
                          chk["delta_given"])
        gap = max(float((out["theta"] - th_p).abs().max()),
                  float((out["u"].double() - u_p).abs().max()))
        if len(out["ell"]) != len(given["ell"]):
            gap = math.inf
        if best is None or gap < best[0]:
            best = (gap, out, dec)
        if gap <= chk["match_tol"]:
            break
        last = max(ov) if ov else -1
        queue += [{**ov, i: not (m > 0)} for i, m in dec.open if i > last]
    gap, out, dec = best
    # the program logs the margins of its per-probe decisions, log_ell's
    # first: the replay's come in the same order
    logged = list(post["margins"])
    mine = dec.margins[out["slice_from"]:]
    m_gap = max([abs(a - b) for a, b in zip(logged, mine)], default=0.0)
    resid = max([prob.factor_resid(l, x) for (x, _), l in
                 zip(out["ell"], post["ell"])], default=0.0)
    return gap, bool(torch.equal(out["key"], key_p)), m_gap, resid, count


def select(kept, max_items):
    """Chain-steps to replay: the kept steps' chains, the last kept step
    first, ``max_items`` at most."""
    items = [(c, j) for c in reversed(range(len(kept)))
             for j in range(len(kept[c][1]["idx"]))]
    return items[:max_items]


def _row(rows, j):
    return {k: v[j] for k, v in rows.items()}


def judge(out, conf, wl, seed, device):
    """The check of one run: ``(numbers, details)``."""
    t0 = time.perf_counter()
    chk = wl["check"]
    t, s = conf["target"], conf["sampler"]
    prob = GPProblem(out["x"], out["y"], t, device)
    if prob.n_pad != out["n_pad"]:
        raise RuntimeError(f"the program padded n={prob.n} to "
                           f"{out['n_pad']}, the reference to {prob.n_pad}")
    nums = {k: 0.0 for k in NUMBERS}

    def see_state(theta, ll, chol, u):
        th = _f64(theta, device)
        nums["factor_resid"] = max(nums["factor_resid"],
                                   prob.factor_resid(chol, float(th[0])))
        ll_ref = prob.log_lik(th, _f64(chol, device)[:prob.n, :prob.n],
                              _f64(u, device))
        nums["ll_gap"] = max(nums["ll_gap"], abs(float(ll) - ll_ref))

    # the start: initial chains and adapted widths
    init = out["init"]
    from portbench.harness import chain_order

    order = torch.as_tensor(chain_order(seed, wl["chains"]), device=device)
    theta0, u0, key0 = ref_init(prob, wl["chain_seed"], wl["chains"],
                                order[init["idx"].to(device)],
                                s["jitter_scale"])
    st = init["state"]
    nums["state_gap"] = max(
        float((_f64(st["theta"], device) - theta0.double()).abs().max()),
        float((_f64(st["u"], device) - u0.double()).abs().max()))
    nums["key_gap"] += int((st["key"].to(device) != key0).any(-1).sum())
    for j in range(len(init["idx"])):
        see_state(st["theta"][j], st["ll"][j], st["chol"][j], st["u"][j])
    w_ref = ref_widths(_f64(out["warm_theta"], device), s["width_scale"])
    w_gap = float(((_f64(out["widths"], device) - w_ref).abs()
                   / w_ref).max())
    nums["state_gap"] = max(nums["state_gap"], w_gap)

    # the steps: replayed from the program's state before each, with the
    # program's float32 widths (judged above), so that bracket and shrink
    # positions come out as the program's
    params = {"widths": out["widths"].float().cpu().tolist(),
              "max_step_out": s["max_step_out"],
              "max_shrink_chol": s["max_shrink_chol"]}
    items = select(out["kept"], chk["max_chain_steps"])
    replays, probes, m_gap, p_resid = 0, 0, 0.0, 0.0
    for c, j in items:
        kept = out["kept"][c][1]
        pre, post = _row(kept["pre"], j), _row(kept["post"], j)
        post.update(ell=kept["ell"][j], margins=kept["margins"][j])
        see_state(pre["theta"], pre["ll"], pre["chol"], pre["u"])
        see_state(post["theta"], post["ll"], post["chol"], post["u"])
        gap, key_ok, mg, res, n = judge_step(prob, pre, post, params, s, chk)
        nums["state_gap"] = max(nums["state_gap"], gap)
        nums["key_gap"] += 0 if key_ok else 1
        m_gap, p_resid = max(m_gap, mg), max(p_resid, res)
        replays += n
        probes += len(post["ell"])
    nums["ll_gap"] = max(nums["ll_gap"], m_gap)
    nums["factor_resid"] = max(nums["factor_resid"], p_resid)
    details = {"chain_steps": len(items), "replays": replays,
               "ell_probes": probes, "margin_gap": m_gap,
               "probe_factor_resid": p_resid, "widths_gap": w_gap,
               "seconds": time.perf_counter() - t0}
    return nums, details


def limits_of(wl):
    return {k: float(wl["check"]["limits"][k]) for k in NUMBERS}


def verdict(nums, limits):
    return all(nums[k] <= limits[k] for k in NUMBERS) and all(
        math.isfinite(nums[k]) for k in NUMBERS)
