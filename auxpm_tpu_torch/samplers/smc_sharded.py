"""Mesh-sharded SMC: particles distributed, resampling by collectives.

Counterpart of ``auxpm_tpu/samplers/smc_sharded.py``.  The population is
sharded over the mesh's CHAIN group (rank r holds the global particles
``[r N_local, (r + 1) N_local)``; the mesh has one particle shard).  Per stage
(a host loop; every rank runs it in lockstep):

- the head: ``k_res, k_rej = split(fold_in(k_loop, s))``, one shared uniform
  ``uniform(k_res)``; the next beta by 30-step bisection on the GLOBAL ESS of
  the incremental weights (two collectives per ESS); the logZ increment (a
  global log-sum-exp); the distributed systematic resample and the payload
  gather (``parallel/resampling.py``); fresh keys ``fold_in(k_rej, global
  slot)``; the population std through ``pmean``;
- the rejuvenation, in one of two layouts (``carry_u``).

``carry_u=True``: u is materialised and travels with its particle through
the gather (a payload of O(N S n)).  The rejuvenation is ``n_mcmc`` steps of
``make_rejuvenation(tempered_target(target, beta'))`` (``aux_slice``,
``aux_hmc`` or ``aux_nuts``) drawing from each particle's fresh key, as the
reference's does, and the tempered target drops the sweeps (ROADMAP known
difference 6).

``carry_u=False`` (key-as-u): a particle stores the threefry key that
generated its u, ``u == normal(u_key, u_shape)`` (``core/prng.py``), so the
gather moves O(N (d + 5)) words.  Per particle, ``k_imh, k_theta =
split(key)``; then ``n_u_mh`` independence-MH refreshes u' ~ N(0, I)
accepted with ``beta' (ll' - ll)``, through the UNtempered target's
``prepare`` / ``log_lik_est_u`` (one factorisation per particle for all
proposals); with ``u_blocks > 1`` the key is one per row block and the
refresh is a systematic scan of ``n_u_mh u_blocks`` blocked proposals, each
recomputing one block's per-sample weights (``target.log_weights_u``) and
re-reducing the cached (S,) column through ``blocked_logsumexp`` over
``target.n_weight_blocks``; then ``n_mcmc`` steps of the theta-only kernel
(``composite.THETA_ONLY``) with u materialised from its key(s), drawn from
``k_theta`` (``draw_keyed``).  Every particle's work is a function of its
key, so the per-particle passes run in chunks of the largest divisor of
``N_local`` at most ``rejuv_batch``, inside ``rejuv_dispatches`` contiguous
groups, and neither setting changes a bit of the result.

``run(seed)`` starts from ``prng.key(seed)`` = ``jax.random.key(seed)``, so a
seed means what it means to the reference's CLI.  Per-stage checkpoints
(``utils/checkpoint.py``, one file per rank) let a fresh runner resume bit
for bit.
"""

from __future__ import annotations

import os
import time

import torch

from auxpm_tpu_torch.core import prng
from auxpm_tpu_torch.core.state import ChainState
from auxpm_tpu_torch.ops.logsumexp import blocked_logsumexp
from auxpm_tpu_torch.parallel import collectives
from auxpm_tpu_torch.parallel.resampling import (
    check_particles,
    distributed_systematic_resample_indices,
    gather_resampled,
)
from auxpm_tpu_torch.samplers.smc import (
    default_rejuvenation_params,
    tempered_target,
)

_MAX_STAGES = 100   # the reference's cap on the number of tempering stages
_N_BISECT = 30      # bisection steps for the next beta, as in the reference


def next_beta_global(ll_local, beta, ess_frac, n_global, mesh):
    """Largest beta' in (beta, 1] whose GLOBAL ESS of ``(beta' - beta) ll``
    is at least ``ess_frac N``, by bisection; the same 0-d tensor on every
    rank."""
    target = ess_frac * n_global
    one = torch.ones((), dtype=ll_local.dtype, device=ll_local.device)
    full = collectives.population_ess((one - beta) * ll_local, mesh)
    lo, hi = beta, one
    for _ in range(_N_BISECT):
        mid = 0.5 * (lo + hi)
        ok = collectives.population_ess((mid - beta) * ll_local, mesh) >= target
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return torch.where(full >= target, one, lo)


def chunk_size(n_local, rejuv_batch):
    """Largest divisor of ``n_local`` that is at most ``rejuv_batch``."""
    chunk = max(1, min(int(rejuv_batch), n_local))
    while n_local % chunk:
        chunk -= 1
    return chunk


def make_smc_sharded(target, make_rejuvenation, n_particles, mesh, n_mcmc=2,
                     ess_frac=0.5, carry_u=True, n_u_mh=2, rejuv_batch=256,
                     rejuv_dispatches=1, u_blocks=1, checkpoint_dir=None,
                     checkpoint_every=1):
    """Build the sharded SMC runner on this rank's ``mesh``
    (``parallel.mesh.make_mesh(1)``) for at most ``2^24`` particles (the
    resampling counts its positions in float32).

    Args:
      make_rejuvenation: ``(tempered_target) -> transition``; with
        ``carry_u=False`` a ``composite.THETA_ONLY`` kernel (a u-updating
        kernel would break the key-u invariant).
      carry_u, n_u_mh, rejuv_batch, rejuv_dispatches, u_blocks: see the
        module note.
      checkpoint_dir: save every ``checkpoint_every``-th stage (and the
        last); a run with the same seed and config resumes from it.

    Returns ``run(seed, stop_after=None, on_stage=None) -> (states, diag)``
    (with ``run.init_states(seed)`` and ``run.stage``, its pieces) with
    this rank's share of the final population; ``diag`` holds
    ``log_z``, ``betas``, ``n_stages``, ``stage_seconds`` and, with
    ``carry_u=False``, ``u_mh_accept`` per stage.  ``stop_after``: end after
    that many completed stages (what a killed run leaves);
    ``on_stage(stage, beta)`` is called after the init (stage -1, beta 0)
    and after each stage."""
    if mesh.n_particle_shards != 1:
        raise ValueError("smc_sharded uses a flat mesh: particles axis must be 1")
    n_shards = mesh.n_chain_shards
    if n_particles % n_shards:
        raise ValueError(f"{n_particles} particles not divisible by {n_shards}")
    check_particles(n_particles)      # before an init of that many
    n_local = n_particles // n_shards
    g0 = mesh.chain_index * n_local          # this rank's first global slot
    if u_blocks > 1:
        if carry_u:
            raise ValueError("u_blocks > 1 requires carry_u=False")
        if target.log_weights_u is None:
            raise ValueError(
                "u_blocks > 1 needs target.log_weights_u (per-sample "
                "log-weights) for the blocked refresh")
        if target.u_shape[0] % u_blocks:
            raise ValueError(
                f"S={target.u_shape[0]} not divisible by u_blocks={u_blocks}")
    if target.sample_prior_key is None:
        raise ValueError(f"SMC needs target.sample_prior_key ({target.name})")
    u_shape = tuple(target.u_shape)
    block_shape = (u_shape[0] // u_blocks,) + u_shape[1:]   # of a u block
    rejuvenation_params = default_rejuvenation_params(target)
    dev = target.device
    log_n = torch.log(torch.tensor(float(n_particles), dtype=torch.float32,
                                   device=dev))
    log_s = torch.log(torch.tensor(float(u_shape[0]), dtype=torch.float32,
                                   device=dev))
    # contiguous groups (the reference's dispatches), each run in chunks
    g_size = chunk_size(n_local, max(1, n_local // max(1, int(rejuv_dispatches))))
    chunk = chunk_size(g_size, rejuv_batch)

    def chunks():
        for start in range(0, n_local, chunk):
            yield slice(start, start + chunk)

    def materialize(ukd):
        return u_of_keys(ukd, u_shape, u_blocks)

    def head(states, beta, k_stage):
        """Adaptive beta, logZ increment, resample and gather, fresh keys,
        population std."""
        k = prng.split(k_stage, 2)
        u01 = prng.uniform(k[0])
        ll = states.log_lik_hat
        beta_new = next_beta_global(ll, beta, ess_frac, n_particles, mesh)
        log_w = (beta_new - beta) * ll
        log_z_inc = collectives.population_logsumexp(log_w, mesh) - log_n
        idx = distributed_systematic_resample_indices(log_w, u01, mesh)
        # theta and log L-hat in one buffer, u (values or key words) in one
        got = gather_resampled(
            {"tl": torch.cat([states.theta, ll[:, None]], dim=1),
             "u": states.u}, idx, mesh)
        theta, ll = got["tl"][:, :-1].contiguous(), got["tl"][:, -1].contiguous()
        keys = prng.fold_in(k[1], torch.arange(g0, g0 + n_local, device=dev))
        mean = collectives.pmean(theta.mean(0), mesh)
        var = collectives.pmean(((theta - mean) ** 2).mean(0), mesh)
        std = torch.sqrt(var) + 1e-6
        states = states.replace(theta=theta, u=got["u"], log_lik_hat=ll,
                                key=keys)
        return states, beta_new, log_z_inc, std, idx

    def rejuvenation(beta_new, std, probe_log=None):
        transition = make_rejuvenation(tempered_target(target, beta_new))
        names = getattr(transition, "stage_names", ())
        extra = {} if probe_log is None else {"probe_log": probe_log}
        params = {k: {**v, **extra} for k, v in
                  rejuvenation_params(std).items() if k in names}
        return transition, params

    def rejuvenate_carry_u(states, beta_new, std):
        transition, params = rejuvenation(beta_new, std)
        s = states.replace(log_lik_hat=beta_new * states.log_lik_hat)
        info = {}
        for _ in range(n_mcmc):
            s, info = transition(s, params)
        return s.replace(log_lik_hat=s.log_lik_hat / beta_new), None, info

    def refresh_u(theta, ll, ukd, k_imh, beta_new):
        """The independence-MH u refresh of a chunk; returns ``(ukd, ll,
        accepts, margins)``, the last two ``(c, proposals)``: each
        proposal's accept bit and ``log a - log U``."""
        have_u = target.prepare is not None and target.log_lik_est_u is not None
        prepared = target.prepare(theta) if have_u else None
        accs, margins = [], []

        def decide(kk, ll_new, ll_cur):
            log_a = beta_new * (ll_new - ll_cur)
            margin = log_a - torch.log(prng.uniform(kk[:, 1]))
            accs.append(margin > 0)
            margins.append(margin)
            return accs[-1]

        if u_blocks > 1:
            lw_arg = prepared if target.prepare is not None else theta

            def lw_block(kd):
                return target.log_weights_u(lw_arg, prng.normal(kd, block_shape))

            def reduce_lw(lw):
                return blocked_logsumexp(lw.reshape(lw.shape[0], -1),
                                         target.n_weight_blocks) - log_s

            lw = torch.stack([lw_block(ukd[:, b]) for b in range(u_blocks)],
                             dim=1)
            ll = reduce_lw(lw)
            ukd = ukd.clone()
            for j in range(n_u_mh * u_blocks):
                b = j % u_blocks
                kk = prng.split(prng.fold_in(k_imh, j), 2)
                lw_new = lw.clone()
                lw_new[:, b] = lw_block(kk[:, 0])
                ll_new = reduce_lw(lw_new)
                acc = decide(kk, ll_new, ll)
                ukd[:, b] = torch.where(acc[:, None], kk[:, 0], ukd[:, b])
                lw = torch.where(acc[:, None, None], lw_new, lw)
                ll = torch.where(acc, ll_new, ll)
        else:
            for j in range(n_u_mh):
                kk = prng.split(prng.fold_in(k_imh, j), 2)
                u_prop = materialize(kk[:, 0])
                ll_prop = (target.log_lik_est_u(prepared, u_prop) if have_u
                           else target.log_lik_est(theta, u_prop))
                acc = decide(kk, ll_prop, ll)
                ukd = torch.where(acc[:, None], kk[:, 0], ukd)
                ll = torch.where(acc, ll_prop, ll)
        return ukd, ll, torch.stack(accs, 1), torch.stack(margins, 1)

    def rejuvenate_keyed(states, beta_new, std, probe_log=None):
        transition, params = rejuvenation(beta_new, std, probe_log)
        theta, ll, ukd = states.theta.clone(), states.log_lik_hat.clone(), \
            states.u.clone()
        keys = states.key.clone()
        accs, margins, infos = [], [], []
        for sl in chunks():
            k = prng.split(keys[sl], 2)
            u_c, ll_c, acc, margin = refresh_u(theta[sl], ll[sl], ukd[sl],
                                               k[:, 0], beta_new)
            s = ChainState(theta=theta[sl], u=materialize(u_c),
                           log_lik_hat=beta_new * ll_c, key=k[:, 1])
            info = {}
            for _ in range(n_mcmc):
                s, info = transition(s, params)
            theta[sl], ll[sl], ukd[sl] = s.theta, s.log_lik_hat / beta_new, u_c
            keys[sl] = s.key
            accs.append(acc)
            margins.append(margin)
            infos.append(info)
        states = states.replace(theta=theta, u=ukd, log_lik_hat=ll, key=keys)
        acc = torch.cat(accs)
        u_acc = collectives.pmean(acc.to(torch.float32).mean(), mesh)
        info = {k: torch.cat([i[k] for i in infos]) for k in infos[0]}
        return states, u_acc, {"imh_accept": acc,
                               "imh_margin": torch.cat(margins), **info}

    def stage(states, beta, k_loop, s, probe_log=None):
        """Tempering stage ``s`` from ``states`` at ``beta``: returns
        ``(states, beta', log_z_inc, u_acc, detail)``.  ``detail``: the
        resampling indices (``idx``), the rejuvenation's info of its last
        MCMC step per particle and, key-as-u, each refresh proposal's accept
        bit and margin (``imh_accept``, ``imh_margin``, ``(N_local,
        proposals)``); ``probe_log``, key-as-u only, goes to the theta
        kernel's params.  ``u_acc`` is None with ``carry_u``."""
        states, beta, log_z_inc, std, idx = head(
            states, beta, prng.fold_in(k_loop, s))
        if carry_u:
            states, u_acc, info = rejuvenate_carry_u(states, beta, std)
        else:
            states, u_acc, info = rejuvenate_keyed(states, beta, std,
                                                   probe_log)
        return states, beta, log_z_inc, u_acc, {"idx": idx, **info}

    def init(k_init):
        """Particle g from ``fold_in(k_init, g)`` (key-as-u) or from
        ``split(k_init, N)[g]`` (carry_u), then ``k_t, k_u, k_carry =
        split(., 3)``: theta = sample_prior_key(k_t), u from k_u."""
        if carry_u:
            pk = prng.split(k_init.to(dev), n_particles)[g0:g0 + n_local]
        else:
            pk = prng.fold_in(k_init.to(dev),
                              torch.arange(g0, g0 + n_local, device=dev))
        k = prng.split(pk, 3)
        theta = target.sample_prior_key(k[:, 0])
        if carry_u:
            u = torch.empty((n_local, *u_shape), dtype=torch.float32, device=dev)
        elif u_blocks == 1:
            u = k[:, 1].clone()
        else:
            u = prng.fold_in(k[:, 1, None],
                             torch.arange(u_blocks, device=dev))
        ll = torch.empty(n_local, dtype=torch.float32, device=dev)
        for sl in chunks():
            u_c = (prng.normal(k[sl, 1], u_shape) if carry_u
                   else materialize(u[sl]))
            if carry_u:
                u[sl] = u_c
            ll[sl] = target.log_lik_est(theta[sl], u_c)
        return theta, u, ll, k[:, 2].clone()

    def init_states(seed):
        """``(stage-0 population, k_loop)`` of ``run(seed)``."""
        k = prng.split(prng.key(seed), 2)
        theta, u, ll, keys = init(k[0])
        return (ChainState(theta=theta, u=u, log_lik_hat=ll, key=keys),
                k[1].to(dev))

    def run(seed, stop_after=None, on_stage=None):
        run_key = prng.key(seed)
        states, k_loop = init_states(seed)
        beta = torch.zeros((), dtype=torch.float32, device=dev)
        if on_stage is not None:
            on_stage(-1, 0.0)
        log_z, betas, u_accs, seconds = 0.0, [0.0], [], []
        start = 0
        ckpt_config = None
        if checkpoint_dir is not None:
            from auxpm_tpu_torch.utils.checkpoint import load_checkpoint

            # every knob that changes the trajectory, the run key and
            # u_blocks included; NOT rejuv_batch and rejuv_dispatches, which
            # re-chunk the same computation bit for bit
            ckpt_config = {
                "smc": target.name, "n_particles": n_particles,
                "carry_u": carry_u, "n_u_mh": n_u_mh, "ess_frac": ess_frac,
                "n_mcmc": n_mcmc, "u_blocks": u_blocks,
                "key": run_key.tolist(),
            }
            if os.path.exists(os.path.join(checkpoint_dir,
                                           f"shard_{mesh.rank}.npz")):
                states, start, meta = load_checkpoint(
                    checkpoint_dir, states, config=ckpt_config, mesh=mesh)
                beta = torch.tensor(meta["beta"], dtype=torch.float32,
                                    device=dev)
                log_z = float(meta["log_z"])
                betas = [float(b) for b in meta["betas"]]
                u_accs = [float(a) for a in meta["u_accs"]]
        for s in range(start, _MAX_STAGES):
            if betas[-1] >= 1.0:
                break
            t0 = time.perf_counter()
            states, beta, log_z_inc, u_acc, _ = stage(states, beta, k_loop, s)
            if u_acc is not None:
                u_accs.append(float(u_acc))
            log_z += float(log_z_inc)          # host reads: each stage's end
            betas.append(float(beta))
            seconds.append(time.perf_counter() - t0)
            if on_stage is not None:
                on_stage(s, betas[-1])
            done = betas[-1] >= 1.0
            if checkpoint_dir is not None and (
                    done or (s + 1) % checkpoint_every == 0):
                from auxpm_tpu_torch.utils.checkpoint import save_checkpoint

                save_checkpoint(checkpoint_dir, states, step=s + 1,
                                config=ckpt_config, mesh=mesh,
                                params={"beta": betas[-1], "log_z": log_z,
                                        "betas": betas, "u_accs": u_accs})
            if done or (stop_after is not None and s + 1 >= stop_after):
                break
        diag = {"log_z": log_z, "betas": betas, "n_stages": len(betas) - 1,
                "stage_seconds": seconds}
        if not carry_u:
            diag["u_mh_accept"] = u_accs
        return states, diag

    # the pieces of a run, for a caller that holds one stage to another path
    run.init_states = init_states
    run.stage = stage
    return run


def u_of_keys(ukd, u_shape, u_blocks=1):
    """The u ``(c, S, n)`` that key-as-u keys generate: ``ukd (c, 2)`` gives
    ``normal(key, u_shape)``; ``(c, u_blocks, 2)`` gives row block b as
    ``normal(key_b, (S / u_blocks, n))``."""
    if u_blocks == 1:
        return prng.normal(ukd, tuple(u_shape))
    block_shape = (u_shape[0] // u_blocks,) + tuple(u_shape[1:])
    return prng.normal(ukd, block_shape).reshape(-1, *u_shape)
