"""Windowed global adaptation of sampler hyperparameters.

Counterpart of ``auxpm_tpu/samplers/adaptation.py``.  Slice widths are set to
``width_scale`` x the global per-coordinate posterior std of the window's
samples over ALL chains, clamped to a sane range (the ``slice_theta`` and
``slice_theta_rd`` groups per coordinate; ``joint_slice``'s scalar
``width`` from the mean std).  A random-walk step size
(``pm_mh``'s un-namespaced ``step_size``, ``mh_theta``'s group) is scaled
by ``exp(lr (acceptance - target_accept))`` with the window's global mean
acceptance.  Warm-up only: params are frozen afterwards, so the main chain
is a fixed valid kernel.

HMC / NUTS groups (``nuts``, ``hmc``) get Nesterov dual averaging of log eps
toward a target mean Metropolis statistic (0.8; Hoffman & Gelman 2014
Alg. 5 with Stan's gamma = 0.05, t0 = 10, kappa = 0.75), updated once per
transition: ``wrap_dual_averaging`` keeps a per-chain DA state in
``state.extras`` (``(B,)`` tensors) and hands the transition each chain's own
step size, and the Python step loop of ``samplers/chain.run_chains`` applies
it step by step.  Each window also sets the group's diagonal ``inv_mass`` to
the regularised per-coordinate sample variance of its draws (Stan's diag_e:
var n/(n+5) + 1e-3 * 5/(n+5)) and re-anchors the schedule at each chain's
current step size; warm-up ends by freezing each group's step size at the
cross-chain geometric mean of the averaged iterate eps_bar
(``finalize_dual_averaging``).

On a mesh with several chain shards a rank sees only its own chains: the
window's moments and acceptance (and the means of the infos, for the log)
are averaged over the chain group with ``parallel/collectives.pmean_tree``,
mean first and the squared deviations from the GLOBAL mean second, so every
rank arrives at the same widths and step sizes; the mass matrix's window
variance and the geometric mean of eps_bar are reduced the same way, so
every rank freezes the same step size and mass.
"""

from __future__ import annotations

import math

import torch


def _chain_shards(mesh):
    return 1 if mesh is None else mesh.n_chain_shards


_DA_GROUPS = ("nuts", "hmc")  # groups that report accept_prob for DA
_DA_FIELDS = ("log_eps", "log_eps_bar", "h_bar", "t", "mu")
# dual averaging's target mean accept_prob and Stan's schedule constants
_DA_TARGET_ACCEPT, _DA_GAMMA, _DA_T0, _DA_KAPPA = 0.8, 0.05, 10.0, 0.75


def _global_var(theta, mesh):
    """Per-coordinate variance of ``theta (chains, steps, d)`` over the
    chains of ALL chain shards (equal shares), in ``theta``'s dtype."""
    flat = theta.reshape(-1, theta.shape[-1])
    if _chain_shards(mesh) == 1:
        return flat.var(dim=0, unbiased=False)
    from auxpm_tpu_torch.parallel.collectives import pmean_tree

    c, group = mesh.n_chain_shards, mesh.chain_group
    mean = pmean_tree({"m": flat.mean(0)}, group, c)["m"]
    return pmean_tree({"v": ((flat - mean) ** 2).mean(0)}, group, c)["v"]


def _global_std(theta, mesh):
    """Per-coordinate std of ``theta (chains, steps, d)`` over the chains of
    ALL chain shards (equal shares)."""
    return torch.sqrt(_global_var(theta, mesh))


def _global_mean(x, mesh):
    """Mean of ``x`` over the chains of ALL chain shards, as a float."""
    m = x.mean()
    if _chain_shards(mesh) > 1:
        from auxpm_tpu_torch.parallel.collectives import pmean_tree

        m = pmean_tree({"m": m}, mesh.chain_group, mesh.n_chain_shards)["m"]
    return float(m)


def _scaled_step(old, acc, lr, target_accept):
    """``old * exp(lr (acc - target_accept))``, as a float."""
    return float(old) * math.exp(lr * (acc - target_accept))


def adapt_params(params, recs, infos, target_accept=0.234, lr=1.0,
                 width_scale=2.0, width_bounds=(1e-3, 1e3), mesh=None):
    """One window update; returns a new params dict.  ``mesh``: this rank's
    ``parallel.mesh.Mesh`` when ``recs`` hold one chain shard's chains."""
    new = {k: dict(v) if isinstance(v, dict) else v for k, v in params.items()}
    if "accept" in infos:   # pm_mh's un-namespaced info
        new["step_size"] = _scaled_step(
            params.get("step_size", 0.5), _global_mean(infos["accept"], mesh),
            lr, target_accept)
    if "mh_theta/accept" in infos:
        g = dict(new.get("mh_theta", {}))
        g["step_size"] = _scaled_step(
            g.get("step_size", 0.5),
            _global_mean(infos["mh_theta/accept"], mesh), lr, target_accept)
        new["mh_theta"] = g
    stds = None
    for group, key in (("slice_theta", "widths"),
                       ("slice_theta_rd", "widths"), ("joint_slice", "width")):
        if not any(k.startswith(f"{group}/") for k in infos):
            continue
        if stds is None:
            stds = _global_std(recs["theta"], mesh)
        g = dict(new.get(group, {}))
        if key == "width":   # a scalar bracket along a random direction
            g[key] = float(torch.clamp(width_scale * stds.mean(),
                                       *width_bounds))
        else:
            g[key] = torch.clamp(width_scale * stds, *width_bounds).to(
                torch.float32)
        new[group] = g
    return new


def regularized_inv_mass(theta_rec, mesh=None):
    """Stan-style diagonal inverse metric from window samples: the
    regularised per-coordinate variance over (chains, steps) of all chain
    shards, computed in float64 and returned as float32 ``(d,)``."""
    n = theta_rec.shape[0] * theta_rec.shape[1] * _chain_shards(mesh)
    var = _global_var(theta_rec.to(torch.float64), mesh)
    return ((n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))).to(
        torch.float32)


# ---------------------------------------------------------------------------
# Per-chain dual averaging (Hoffman & Gelman 2014 Alg. 5)
# ---------------------------------------------------------------------------


def _da_key(group, field):
    return f"da_{group}_{field}"


def wrap_dual_averaging(transition, groups):
    """Wrap a batched transition so each listed group's ``step_size`` is
    each chain's ``exp(log_eps)`` from ``state.extras`` and its DA state is
    updated once per application from ``info[f"{group}/accept_prob"]``.

    Warm-up only: the wrapped kernel is not a fixed Markov kernel (eps
    changes every step), which is why warm-up ends with
    ``finalize_dual_averaging``."""
    groups = tuple(groups)

    def wrapped(state, params):
        p = dict(params)
        for g in groups:
            p[g] = {**p.get(g, {}),
                    "step_size": torch.exp(state.extras[_da_key(g, "log_eps")])}
        state, info = transition(state, p)
        ex = dict(state.extras)
        for g in groups:
            acc = info[f"{g}/accept_prob"]
            t = ex[_da_key(g, "t")] + 1.0
            eta = 1.0 / (t + _DA_T0)
            h_bar = (1.0 - eta) * ex[_da_key(g, "h_bar")] + eta * (
                _DA_TARGET_ACCEPT - acc)
            log_eps = ex[_da_key(g, "mu")] - torch.sqrt(t) / _DA_GAMMA * h_bar
            w = t ** (-_DA_KAPPA)
            log_eps_bar = w * log_eps + (1.0 - w) * ex[_da_key(g, "log_eps_bar")]
            ex.update({_da_key(g, "t"): t, _da_key(g, "h_bar"): h_bar,
                       _da_key(g, "log_eps"): log_eps,
                       _da_key(g, "log_eps_bar"): log_eps_bar})
        return state.replace(extras=ex), info

    wrapped.stage_names = getattr(transition, "stage_names", ())
    return wrapped


def init_dual_averaging(states, params, groups):
    """Add per-chain DA fields to a batched state, the schedule anchored at
    each group's current ``step_size`` (Stan's mu = log(10 eps0))."""
    n = states.theta.shape[0]
    kw = {"dtype": states.theta.dtype, "device": states.theta.device}
    ex = dict(states.extras)
    for g in groups:
        log_eps0 = math.log(float(params.get(g, {}).get("step_size", 0.5)))
        ex[_da_key(g, "log_eps")] = torch.full((n,), log_eps0, **kw)
        ex[_da_key(g, "log_eps_bar")] = torch.full((n,), log_eps0, **kw)
        ex[_da_key(g, "h_bar")] = torch.zeros((n,), **kw)
        ex[_da_key(g, "t")] = torch.zeros((n,), **kw)
        ex[_da_key(g, "mu")] = torch.full((n,), log_eps0 + math.log(10.0),
                                          **kw)
    return states.replace(extras=ex)


def restart_dual_averaging(states, groups):
    """Re-anchor each chain's schedule at its CURRENT eps (after a mass
    update: the optimal step size moved with the metric)."""
    ex = dict(states.extras)
    for g in groups:
        log_eps = ex[_da_key(g, "log_eps")]
        ex[_da_key(g, "mu")] = log_eps + math.log(10.0)
        ex[_da_key(g, "log_eps_bar")] = log_eps
        ex[_da_key(g, "h_bar")] = torch.zeros_like(log_eps)
        ex[_da_key(g, "t")] = torch.zeros_like(log_eps)
    return states.replace(extras=ex)


def finalize_dual_averaging(states, params, groups, mesh=None):
    """Freeze each group's step size at the geometric mean of eps_bar over
    the chains of all chain shards and strip the DA fields."""
    new = {k: dict(v) if isinstance(v, dict) else v for k, v in params.items()}
    ex = dict(states.extras)
    for g in groups:
        log_eps_bar = ex[_da_key(g, "log_eps_bar")].to(torch.float64)
        new[g] = {**new.get(g, {}),
                  "step_size": math.exp(_global_mean(log_eps_bar, mesh))}
        for f in _DA_FIELDS:
            ex.pop(_da_key(g, f), None)
    return states.replace(extras=ex), new


def warmup(run_fn, states, params, n_windows, window_size, step, mesh=None,
           **adapt_kw):
    """Run ``n_windows`` adaptation windows; returns (states, params, log).

    ``run_fn(transition, states, params, n_steps) -> (states, recs, infos)``
    is the chain runner, given the transition to run (warm-up substitutes a
    dual-averaging wrap for the ``nuts`` / ``hmc`` stages of ``step``);
    ``step`` is the transition; ``mesh`` as in ``adapt_params`` (the log then
    holds the means over all chain shards)."""
    da_groups = tuple(g for g in getattr(step, "stage_names", ())
                      if g in _DA_GROUPS)
    transition = step
    if da_groups:
        transition = wrap_dual_averaging(step, da_groups)
        states = init_dual_averaging(states, params, da_groups)
    history = []
    for w in range(n_windows):
        states, recs, infos = run_fn(transition, states, params, window_size)
        params = adapt_params(params, recs, infos, mesh=mesh, **adapt_kw)
        if da_groups:
            inv_mass = regularized_inv_mass(recs["theta"], mesh)
            for g in da_groups:
                params[g] = {**params.get(g, {}), "inv_mass": inv_mass}
            states = restart_dual_averaging(states, da_groups)
        means = {k: v.mean() for k, v in infos.items()}
        if _chain_shards(mesh) > 1:
            from auxpm_tpu_torch.parallel.collectives import pmean_tree

            means = pmean_tree(means, mesh.chain_group, mesh.n_chain_shards)
        history.append({"window": w, **{k: float(v) for k, v in means.items()}})
    if da_groups:
        states, params = finalize_dual_averaging(states, params, da_groups,
                                                 mesh)
    return states, params, history
