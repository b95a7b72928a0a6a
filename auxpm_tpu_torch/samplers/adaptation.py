"""Windowed global adaptation of sampler hyperparameters.

Counterpart of ``auxpm_tpu/samplers/adaptation.py`` (the slice-width rule,
the random-walk step-size rule and the warm-up loop; the dual averaging of
HMC/NUTS comes with those samplers).  Slice widths are set to
``width_scale`` x the global per-coordinate posterior std of the window's
samples over ALL chains, clamped to a sane range (the ``slice_theta`` and
``slice_theta_rd`` groups per coordinate; ``joint_slice``'s scalar
``width`` from the mean std).  A random-walk step size
(``pm_mh``'s un-namespaced ``step_size``, ``mh_theta``'s group) is scaled
by ``exp(lr (acceptance - target_accept))`` with the window's global mean
acceptance.  Warm-up only: params are frozen afterwards, so the main chain
is a fixed valid kernel.

On a mesh with several chain shards a rank sees only its own chains: the
window's moments and acceptance (and the means of the infos, for the log)
are averaged over the chain group with ``parallel/collectives.pmean_tree``,
mean first and the squared deviations from the GLOBAL mean second, so every
rank arrives at the same widths and step sizes.
"""

from __future__ import annotations

import math

import torch


def _chain_shards(mesh):
    return 1 if mesh is None else mesh.n_chain_shards


def _global_std(theta, mesh):
    """Per-coordinate std of ``theta (chains, steps, d)`` over the chains of
    ALL chain shards (equal shares)."""
    flat = theta.reshape(-1, theta.shape[-1])
    if _chain_shards(mesh) == 1:
        return flat.std(dim=0, unbiased=False)
    from auxpm_tpu_torch.parallel.collectives import pmean_tree

    c, group = mesh.n_chain_shards, mesh.chain_group
    mean = pmean_tree({"m": flat.mean(0)}, group, c)["m"]
    var = pmean_tree({"v": ((flat - mean) ** 2).mean(0)}, group, c)["v"]
    return torch.sqrt(var)


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


def warmup(run_fn, states, params, n_windows, window_size, step, mesh=None,
           **adapt_kw):
    """Run ``n_windows`` adaptation windows; returns (states, params, log).

    ``run_fn(transition, states, params, n_steps) -> (states, recs, infos)``
    is the chain runner; ``step`` is the transition; ``mesh`` as in
    ``adapt_params`` (the log then holds the means over all chain shards)."""
    history = []
    for w in range(n_windows):
        states, recs, infos = run_fn(step, states, params, window_size)
        params = adapt_params(params, recs, infos, mesh=mesh, **adapt_kw)
        means = {k: v.mean() for k, v in infos.items()}
        if _chain_shards(mesh) > 1:
            from auxpm_tpu_torch.parallel.collectives import pmean_tree

            means = pmean_tree(means, mesh.chain_group, mesh.n_chain_shards)
        history.append({"window": w, **{k: float(v) for k, v in means.items()}})
    return states, params, history
