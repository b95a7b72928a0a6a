"""Whole jobs for one rank of a sharded run, from NumPy in to NumPy out.

Each function here is what ONE rank does: it joins the world its launcher
described (``parallel/mesh.distributed_init``), builds its share of the target
and the state from arrays every rank was given whole, runs, and returns plain
NumPy.  They are module-level so that ``parallel/launch.spawn`` can start them
in fresh processes:

    results = spawn(rank_jobs.run_all, 4,
                    [("step", target_spec, state, rows, params)], 2, "cpu")
                                               # a 2 x 2 mesh on the CPU

``chip_smoke.py`` drives the sharded path on the card through them and the
CPU tests hold it to the reference through them: the estimate, its gradient
(``grad``), one ``aux_slice`` step, one HMC or NUTS ``apply``, one keyed
step of any sampler (``keyed_step``), whole CLI runs and the chain-scaling
measurement (``scaling``), on one spawned world.

``target_spec``: ``("gp", x, y, kwargs)`` for ``make_gp_classification`` or
``("gaussian_toy", kwargs)`` for ``make_gaussian_toy``.
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch


def _build_target(target_spec, device):
    if target_spec[0] == "gp":
        from auxpm_tpu_torch.models.gp_classification import (
            make_gp_classification,
        )

        _, x, y, kwargs = target_spec
        return make_gp_classification(x, y, device=device, **kwargs)
    if target_spec[0] == "gaussian_toy":
        from auxpm_tpu_torch.models.gaussian_toy import make_gaussian_toy

        return make_gaussian_toy(device=device, **target_spec[1])
    raise ValueError(f"unknown target spec {target_spec[0]!r}")


def _join(n_particle_shards, device):
    """``(device, mesh)`` of this rank (the world is joined once)."""
    from auxpm_tpu_torch.parallel.mesh import distributed_init, make_mesh

    return distributed_init(device), make_mesh(n_particle_shards)


def _sharded_target(target_spec, mesh, dev):
    from auxpm_tpu_torch.parallel.particle_shard import shard_target_particles

    target = _build_target(target_spec, str(dev))
    if mesh.n_particle_shards > 1:
        target, _ = shard_target_particles(target, mesh)
    return target


def _np(t):
    return t.detach().cpu().numpy()


def counts():
    """Launches of the estimator kernels, collectives entered (and their
    ms), plain threefry calls and threefry kernel launches, and the host
    reads that HMC / NUTS (step counts, the chains still going) and
    ``robust_cholesky`` (its retry flag) count, so far on this rank."""
    from auxpm_tpu_torch.ops import (
        chol_hopper,
        cholesky,
        ess_sweep,
        sigma_sweep,
        threefry,
    )
    from auxpm_tpu_torch.ops import fused_estimator as fe
    from auxpm_tpu_torch.parallel import collectives
    from auxpm_tpu_torch.samplers import hmc

    return {"fused_weights": fe.launches_w,
            "fused_rot_weights": fe.launches_rot_w,
            "fused_estimator": fe.launches,
            "fused_estimator_rot": fe.launches_rot,
            "ess_sweep": ess_sweep.launches,
            "sigma_sweep": sigma_sweep.launches,
            "chol_panel": chol_hopper.launches,
            "collectives": collectives.calls,
            "collective_ms": 1e3 * collectives.seconds,
            "threefry_calls": threefry.plain_calls,
            "threefry_launches": threefry.launches,
            "host_reads": hmc.host_syncs + cholesky.host_syncs}


def run_all(jobs, n_particle_shards, device="cuda"):
    """Several jobs on one world: ``jobs`` is a list of ``("estimate",
    target_spec, theta, u)``, ``("grad", target_spec, theta, u)``,
    ``("step", target_spec, state, rows, params [, sampler_kwargs,
    log_probes, return_cache])``, ``("apply", target_spec, kernel, state,
    rows, params [, kernel_kwargs])`` and ``("keyed_step", target_spec,
    sampler, state, params [, sampler_kwargs])`` tuples (the arguments of
    the functions below), ``("cli", argv)`` (``cli``) and ``("scaling",
    argv)`` (``scaling``); returns their results in order."""
    dev, mesh = _join(n_particle_shards, device)
    kinds = {"estimate": _estimate, "grad": _grad, "step": _step,
             "apply": _apply, "keyed_step": _keyed_step}
    return [cli(*job[1:]) if job[0] == "cli"
            else scaling(*job[1:]) if job[0] == "scaling"
            else kinds[job[0]](dev, mesh, *job[1:]) for job in jobs]


def _estimate(dev, mesh, target_spec, theta, u):
    """The collective estimate ``log_lik_est(theta, u)`` on this rank's share
    of ``theta (B, d)`` and ``u (B, S, n)``; every rank of a particle group
    returns the same ``(B_local,)``."""
    from auxpm_tpu_torch.convert import shard_numpy_state

    target = _sharded_target(target_spec, mesh, dev)
    share = shard_numpy_state({"theta": theta, "u": u}, mesh.n_chain_shards,
                              mesh.n_particle_shards)[mesh.rank]
    est = target.log_lik_est(
        torch.as_tensor(share["theta"], dtype=torch.float32, device=dev),
        torch.as_tensor(share["u"], dtype=torch.float32, device=dev))
    return {"rank": mesh.rank, "chain_index": mesh.chain_index,
            "particle_index": mesh.particle_index, "target": target.name,
            "estimate": _np(est), "counts": counts()}


def _grad(dev, mesh, target_spec, theta, u):
    """The collective estimate ``log_lik_est(theta, u)`` and its gradient in
    theta, and the gradient of ``log_prior + log_lik_est`` (the prior's part
    is never summed over ranks), on this rank's share of ``theta (B, d)``
    and ``u (B, S, n)``; every rank of a particle group returns bitwise the
    same ``(B_local,)`` and ``(B_local, d)``.  ``counts``: the kernel
    launches and collectives of the two gradient calls; ``seconds``: their
    host time, the card waited for."""
    import time

    from auxpm_tpu_torch.convert import shard_numpy_state

    target = _sharded_target(target_spec, mesh, dev)
    share = shard_numpy_state({"theta": theta, "u": u}, mesh.n_chain_shards,
                              mesh.n_particle_shards)[mesh.rank]
    u_t = torch.as_tensor(share["u"], dtype=torch.float32, device=dev)
    th = torch.as_tensor(share["theta"], dtype=torch.float32, device=dev)
    before = counts()
    t0 = time.perf_counter()
    with torch.enable_grad():
        z = th.clone().requires_grad_(True)
        est = target.log_lik_est(z, u_t)
        (g,) = torch.autograd.grad(est.sum(), z)
        z = th.clone().requires_grad_(True)
        post = target.log_prior(z) + target.log_lik_est(z, u_t)
        (g_post,) = torch.autograd.grad(post.sum(), z)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    after = counts()
    return {"rank": mesh.rank, "chain_index": mesh.chain_index,
            "particle_index": mesh.particle_index, "target": target.name,
            "estimate": _np(est), "grad": _np(g), "grad_post": _np(g_post),
            "counts": {k: after[k] - before[k] for k in after},
            "seconds": seconds}


def _apply(dev, mesh, target_spec, kernel, state, rows, params,
           kernel_kwargs=None):
    """One HMC or NUTS ``apply`` (``kernel`` "hmc" or "nuts") on this rank's
    share of a whole state, fed the caller's draws ``rows`` (whole, cut on
    the chains axis; int64 arrays stay int64); ``params``: the kernel's own
    group (``{"step_size": ..}``), as NumPy or numbers.  Returns the rank's
    new theta and log L-hat, the infos, and the gradient calls and
    collectives it made."""
    from auxpm_tpu_torch import convert
    from auxpm_tpu_torch.parallel.sharded_chain import chain_slice
    from auxpm_tpu_torch.samplers import hmc
    from auxpm_tpu_torch.samplers.nuts import make_nuts

    target = _sharded_target(target_spec, mesh, dev)
    share = convert.shard_numpy_state(state, mesh.n_chain_shards,
                                      mesh.n_particle_shards)[mesh.rank]
    st = convert.chain_states_from_numpy(share, device=str(dev))
    make = {"hmc": hmc.make_hmc, "nuts": make_nuts}[kernel]
    step = make(target, **(kernel_kwargs or {}))
    cs = chain_slice(np.asarray(state["theta"]).shape[0], mesh)
    rows_t = {k: torch.as_tensor(np.asarray(v)[cs], device=dev)
              for k, v in rows.items()}
    par = {k: (torch.as_tensor(np.asarray(v, np.float32), device=dev)
               if isinstance(v, np.ndarray) else v)
           for k, v in params.items()}
    calls0, coll0 = hmc.grad_calls, hmc.grad_collectives
    out, info = step.apply(st, rows_t, par)
    return {"rank": mesh.rank, "theta": _np(out.theta),
            "log_lik_hat": _np(out.log_lik_hat),
            "info": {k: _np(v) for k, v in info.items()},
            "grad_calls": hmc.grad_calls - calls0,
            "grad_collectives": hmc.grad_collectives - coll0}


def _keyed_step(dev, mesh, target_spec, sampler, state, params,
                sampler_kwargs=None):
    """One step of ``SAMPLERS[sampler]`` on this rank's share of a whole
    state (keys included), its rows drawn from each chain's key as the
    unsharded step draws them (the rank's rows of every u-shaped draw).
    Returns the rank's new theta and log L-hat, the per-chain infos and the
    kernel launches and collectives of the step."""
    from auxpm_tpu_torch import convert
    from auxpm_tpu_torch.samplers.composite import SAMPLERS

    target = _sharded_target(target_spec, mesh, dev)
    k = mesh.n_particle_shards
    share = convert.shard_numpy_state(state, mesh.n_chain_shards,
                                      k)[mesh.rank]
    st = convert.chain_states_from_numpy(share, device=str(dev))
    par = convert.params_from_numpy(params, device=str(dev))
    step = SAMPLERS[sampler](target, particle_axis=mesh if k > 1 else None,
                             **(sampler_kwargs or {}))
    before = counts()
    out, info = step(st, par)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    after = counts()
    return {"rank": mesh.rank, "theta": _np(out.theta),
            "log_lik_hat": _np(out.log_lik_hat),
            "info": {k_: _np(v) for k_, v in info.items()},
            "counts": {k_: after[k_] - before[k_] for k_ in after}}


def _step(dev, mesh, target_spec, state, rows, params, sampler_kwargs=None,
          log_probes=False, return_cache=True):
    """One ``aux_slice`` step on this rank's share of a whole state, fed the
    caller's random rows.

    ``state``: the dict of ``convert.chain_states_from_numpy`` (whole);
    ``rows``: ``{"scal": (B, R, 35), "v": (B, R, S, n), "reps": tuple of
    (B, reps_i, 34)}`` (whole); ``params``: the sampler params as NumPy.
    Returns the rank's new theta, log L-hat, u rows, carried factor and
    per-chain infos; with ``log_probes`` also every decision's ``(counted,
    margin)`` pair stacked as two ``(n_decisions, B_local)`` arrays;
    ``return_cache=False`` leaves the factor (B n^2 floats) out."""
    from auxpm_tpu_torch import convert
    from auxpm_tpu_torch.parallel.sharded_chain import chain_slice
    from auxpm_tpu_torch.samplers.composite import make_aux_slice

    target = _sharded_target(target_spec, mesh, dev)
    k = mesh.n_particle_shards
    share = convert.shard_numpy_state(state, mesh.n_chain_shards,
                                      k)[mesh.rank]
    st = convert.chain_states_from_numpy(share, device=str(dev))
    par = convert.params_from_numpy(params, device=str(dev))
    step = make_aux_slice(target, mesh if k > 1 else None,
                          **(sampler_kwargs or {}))
    cs = chain_slice(np.asarray(state["theta"]).shape[0], mesh)
    s_local = st.u.shape[-2]
    r0 = mesh.particle_index * s_local

    def t(a):
        return torch.as_tensor(np.array(a, dtype=np.float32), device=dev)

    rows_e = {"scal": t(rows["scal"][cs]),
              "v": t(rows["v"][cs, :, r0:r0 + s_local])}
    rows_s = tuple(t(r[cs]) for r in rows["reps"])
    probe_log = [] if log_probes else None
    extra = {} if probe_log is None else {"probe_log": probe_log}
    before = counts()
    mid, info_e = step.stages["ess_u"].apply(
        st, rows_e, {**par.get("ess_u", {}), **extra})
    out, info_s = step.stages["slice_theta"].apply(
        mid, rows_s, {**par.get("slice_theta", {}), **extra})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    after = counts()
    result = {
        "rank": mesh.rank, "chain_index": mesh.chain_index,
        "particle_index": mesh.particle_index,
        "theta": _np(out.theta), "log_lik_hat": _np(out.log_lik_hat),
        "u": _np(out.u),
        "info": {**{f"ess_u/{k_}": _np(v) for k_, v in info_e.items()},
                 **{f"slice_theta/{k_}": _np(v) for k_, v in info_s.items()}},
        "counts": {k_: after[k_] - before[k_] for k_ in after},
    }
    cache = out.extras.get("target_cache")
    if cache is not None and return_cache:
        result["chol_r"] = _np(cache["chol_r"])
    if probe_log:
        result["probe_counted"] = np.stack([_np(c) for c, _ in probe_log])
        result["probe_margin"] = np.stack([_np(m) for _, m in probe_log])
    return result


def cli(argv, profile_steps=0):
    """``auxpm_tpu_torch.run.main(argv)`` on this rank (``argv`` must ask for
    ``--sharded true``); returns the rank's final state, the recorded theta
    of all chains, the summary, the kernel launches and collectives of the
    run, and the mean share of active chains per rotated-weights launch.
    ``profile_steps > 0``: then that many more steps under
    ``utils/profiling.profile_run`` (every rank runs them, each reports its
    own view of the card).  A ``--sampler smc`` run returns ``_smc_out``."""
    import torch.distributed as dist

    from auxpm_tpu_torch import run as port_run
    from auxpm_tpu_torch.core import prng
    from auxpm_tpu_torch.ops import fused_estimator as fe
    from auxpm_tpu_torch.samplers import hmc

    stages = []

    def on_stage(stage, beta):
        """Launches, collectives and threefry time of the init (stage -1)
        and of each stage, on this rank."""
        now = counts()
        prev = stages[-1]["_at"] if stages else before
        stages.append({"stage": stage, "beta": beta,
                       "threefry_ms": prng.stop_timing(),
                       **{k: now[k] - prev[k] for k in now}, "_at": now})
        prng.start_timing()

    result = {"on_stage": on_stage}
    before = counts()
    grad0 = (hmc.grad_calls, hmc.grad_collectives)
    prng.start_timing()
    for count in fe.active_counts.values():
        count.reset()
    with contextlib.redirect_stdout(sys.stderr):   # rank 0's summary line
        rc = port_run.main(list(argv), result=result)
    prng.stop_timing()
    if rc != 0:
        raise RuntimeError(f"run.main returned {rc}")
    if "diag" in result:
        return _smc_out(result, stages, before, dist.get_backend())
    states, mesh = result["states"], result["mesh"]
    if states.u.is_cuda:
        torch.cuda.synchronize(states.u.device)
    after = counts()
    active_share = fe.active_counts["rot_weights"].share()
    out = {
        "rank": mesh.rank, "chain_index": mesh.chain_index,
        "particle_index": mesh.particle_index,
        "target": result["target"].name,
        "device": str(states.u.device), "backend": dist.get_backend(),
        "u_shape": tuple(states.u.shape),
        "theta": _np(states.theta), "log_lik_hat": _np(states.log_lik_hat),
        "recorded_theta": result["theta"], "summary": result["summary"],
        "windows": result["windows"],
        # the adapted slice widths (None for a sampler without that stage)
        "widths": (_np(result["params"]["slice_theta"]["widths"])
                   if "slice_theta" in result["params"] else None),
        "counts": {k: after[k] - before[k] for k in after},
        # mean share of active chains per rotated-weights launch (None if
        # the kernel never launched: the CPU takes the plain version)
        "rot_weights_active_share": active_share,
        "peak_mem_gb": (torch.cuda.max_memory_allocated(states.u.device)
                        / 2**30 if states.u.is_cuda else None),
        # the frozen step sizes of the gradient samplers' groups
        "step_sizes": {g: result["params"][g]["step_size"]
                       for g in ("hmc", "nuts") if g in result["params"]},
        "grad_calls": hmc.grad_calls - grad0[0],
        "grad_collectives": hmc.grad_collectives - grad0[1],
    }
    cache = states.extras.get("target_cache")
    if cache is not None:
        fresh = result["target"].cache_init(states.theta)["chol_r"]
        out["cache_max_abs_err"] = float((cache["chol_r"] - fresh).abs().max())
    if profile_steps:
        from auxpm_tpu_torch.utils.profiling import profile_run

        out["profile"] = profile_run(result, profile_steps)
    return out


def scaling(argv):
    """``utils/scaling`` on this world (``argv``: its flags): rank 0 returns
    the JSON line as a dict, the other ranks None."""
    from auxpm_tpu_torch.utils import scaling as scaling_bench

    return scaling_bench.rank_run(scaling_bench.parse_args(list(argv)))


def _smc_out(result, stages, before, backend):
    """What ``cli`` returns for a sharded SMC run: the rank's final
    population (u as key words, or its shape where u is carried), the
    summary and diag, per-stage accounting (``stages``: init first), the
    totals and the rank's peak card memory; for the key-as-u mode also the largest |log L-hat - log_lik_est
    (theta, u of the keys)| over the rank's first 8 particles."""
    from auxpm_tpu_torch.samplers.smc_sharded import u_of_keys

    states, mesh, target = result["states"], result["mesh"], result["target"]
    if states.u.is_cuda:
        torch.cuda.synchronize(states.u.device)
    after = counts()
    out = {
        "rank": mesh.rank, "target": target.name,
        "device": str(states.u.device), "backend": backend,
        "u_shape": tuple(states.u.shape), "theta": _np(states.theta),
        "log_lik_hat": _np(states.log_lik_hat),
        "summary": result["summary"], "diag": result["diag"],
        "stages": [{k: v for k, v in st.items() if k != "_at"}
                   for st in stages],
        "counts": {k: after[k] - before[k] for k in after},
        "peak_mem_gb": (torch.cuda.max_memory_allocated(states.u.device)
                        / 2**30 if states.u.is_cuda else None),
    }
    if states.u.dtype == torch.int64:   # key-as-u
        out["u_keys"] = _np(states.u)
        n_check = min(8, states.u.shape[0])
        ub = states.u.shape[1] if states.u.dim() == 3 else 1
        with torch.no_grad():
            ll = target.log_lik_est(
                states.theta[:n_check],
                u_of_keys(states.u[:n_check], target.u_shape, ub))
        out["key_u_invariant_max_abs_err"] = float(
            (ll - states.log_lik_hat[:n_check]).abs().max())
    return out
