"""Rank jobs of ``tests/test_torch_smc_sharded.py`` (imports the port only).

``run_jobs(jobs)`` is what one spawned gloo rank on the CPU does: join the
world, build a mesh of one particle shard, run each ``(name, kwargs)`` job and
return the list of NumPy results.  A job that raises ``ValueError`` with
``expect_error`` set returns ``{"error": message}`` instead, so one spawn can
hold the refusals too.
"""

from __future__ import annotations

import torch


def _target(spec):
    if spec[0] == "toy":
        from auxpm_tpu_torch.models.gaussian_toy import make_gaussian_toy

        return make_gaussian_toy(device="cpu", **spec[1])
    from auxpm_tpu_torch.models.gp_classification import make_gp_classification

    _, x, y, kw = spec
    return make_gp_classification(x, y, device="cpu", **kw)


def _np(t):
    return t.detach().cpu().numpy()


def _smc(mesh, target, rejuvenation, n_particles, seed, stop_after=None,
         **kwargs):
    """A sharded SMC run; ``rejuvenation`` a ``THETA_ONLY`` name or a
    ``SAMPLERS`` name (``carry_u=True``)."""
    from auxpm_tpu_torch.samplers.composite import SAMPLERS, THETA_ONLY
    from auxpm_tpu_torch.samplers.smc_sharded import make_smc_sharded

    make = THETA_ONLY.get(rejuvenation) or SAMPLERS[rejuvenation]
    run = make_smc_sharded(_target(target), make, n_particles, mesh, **kwargs)
    states, diag = run(seed, stop_after=stop_after)
    return {"theta": _np(states.theta), "u": _np(states.u),
            "log_lik_hat": _np(states.log_lik_hat),
            "key": _np(states.key), "diag": diag}


def _resample(mesh, log_w, u01, payload):
    """This rank's block of the global ``log_w``: the distributed indices,
    the gathered payload rows, and the population reductions."""
    from auxpm_tpu_torch.parallel import collectives
    from auxpm_tpu_torch.parallel.resampling import (
        distributed_systematic_resample_indices,
        gather_resampled,
    )

    n_local = len(log_w) // mesh.n_chain_shards
    sl = slice(mesh.chain_index * n_local, (mesh.chain_index + 1) * n_local)
    lw = torch.as_tensor(log_w[sl])
    idx = distributed_systematic_resample_indices(
        lw, torch.tensor(u01, dtype=torch.float32), mesh)
    got = gather_resampled({"a": torch.as_tensor(payload[sl]),
                            "b": {"c": torch.arange(sl.start, sl.stop)}},
                           idx, mesh)
    return {"idx": _np(idx), "a": _np(got["a"]), "c": _np(got["b"]["c"]),
            "lse": float(collectives.population_logsumexp(lw, mesh)),
            "ess": float(collectives.population_ess(lw, mesh)),
            "pmax": float(collectives.pmax(lw.max(), mesh)),
            "pmean": _np(collectives.pmean(lw[:3], mesh))}


def _cli(mesh, argv):
    from auxpm_tpu_torch.parallel import rank_jobs

    del mesh   # run.main joins the same world and builds its own mesh
    out = rank_jobs.cli(argv)
    return {k: out[k] for k in ("summary", "diag", "u_shape", "theta",
                                "key_u_invariant_max_abs_err")}


JOBS = {"smc": _smc, "resample": _resample, "cli": _cli}


def run_jobs(jobs):
    from auxpm_tpu_torch.parallel.mesh import distributed_init, make_mesh

    distributed_init("cpu")
    mesh = make_mesh(1)
    out = []
    for name, kwargs in jobs:
        kwargs = dict(kwargs)
        expect_error = kwargs.pop("expect_error", False)
        try:
            out.append(JOBS[name](mesh, **kwargs))
        except ValueError as e:
            if not expect_error:
                raise
            out.append({"error": str(e)})
    return out

