"""What sets a key-as-u SMC run's first beta: its init population's tail.

    python -m auxpm_tpu_torch.utils.smc_init --target gp --subsample 32 \
        --particles 1048576 --rejuv-batch 16384
    python -m auxpm_tpu_torch.utils.smc_init --target toy --particles 4096 \
        --device cpu

Takes ``utils/smc_scale``'s flags, builds the same target and runner
(``make_smc_sharded(carry_u=False)``) on a one-rank world and draws the
stage-0 population from ``--seed`` without running a stage.  The first beta
is a function of this population alone: the largest beta whose ESS of
``beta log L-hat`` keeps ``--ess-frac`` of the particles.  Prints one JSON
line: quantiles of log L-hat, the ``TOP`` highest particles (global slot,
log L-hat, theta) with the copies each can expect from the first resample
(N times its weight), and the first beta (the runner's own bisection) of
the population with and without its highest particle.
"""

from __future__ import annotations

import json

import numpy as np

from auxpm_tpu_torch.utils import smc_scale

TOP = 10


def rank_report(args):
    """The report on this rank of a one-rank world."""
    import torch

    from auxpm_tpu_torch.parallel.mesh import distributed_init, make_mesh
    from auxpm_tpu_torch.samplers.composite import THETA_ONLY
    from auxpm_tpu_torch.samplers.smc_sharded import (
        make_smc_sharded,
        next_beta_global,
    )

    dev = distributed_init(args.device)
    smc_scale.check_args(args)
    mesh = make_mesh(1)
    if mesh.world != 1:
        raise RuntimeError("smc_init reads one rank's whole population")
    target = smc_scale.build_target(args, dev)
    run = make_smc_sharded(
        target, THETA_ONLY[smc_scale.REJUV_KERNELS[args.rejuv]],
        args.particles, mesh, n_mcmc=args.n_mcmc, ess_frac=args.ess_frac,
        carry_u=False, n_u_mh=args.n_u_mh, rejuv_batch=args.rejuv_batch,
        u_blocks=args.u_blocks)
    states, _ = run.init_states(args.seed)
    ll_t = states.log_lik_hat
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def first_beta(ll):
        return float(next_beta_global(ll, zero, args.ess_frac, ll.shape[0],
                                      mesh))

    beta = first_beta(ll_t)
    ll = ll_t.double().cpu().numpy()
    theta = states.theta.cpu().numpy()
    order = np.argsort(-ll)[:TOP]
    lw = beta * ll
    w = np.exp(lw - lw.max())
    copies = len(ll) * w / w.sum()
    keep = torch.ones_like(ll_t, dtype=torch.bool)
    keep[int(order[0])] = False
    return {
        "target": target.name, "particles": args.particles,
        "seed": args.seed, "device": str(dev),
        "log_lik_quantiles": {
            str(q): float(np.quantile(ll, q))
            for q in (0.5, 0.99, 0.999, 0.9999, 1.0)},
        "top": [{"slot": int(i), "log_lik": float(ll[i]),
                 "theta": theta[i].tolist(),
                 "expected_copies_at_first_beta": float(copies[i])}
                for i in order],
        "first_beta": beta,
        "first_beta_without_the_top_particle": first_beta(ll_t[keep]),
    }


def main(argv=None):
    """Print the report of ``smc_scale``'s flags ``argv``; returns 0."""
    args = smc_scale.parse_args(argv)
    from auxpm_tpu_torch._device import resolve_device

    device = resolve_device(args.device)    # no GPU: raises, never the CPU
    smc_scale.check_args(args)
    from auxpm_tpu_torch.parallel.launch import on_world

    out = on_world(rank_report, 1, args,
                   threads=0 if device.type == "cuda" else 1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
