"""Adaptive-tempering SMC sampler with MCMC rejuvenation, single device.

Counterpart of ``auxpm_tpu/samplers/smc.py``.  Particles live on the
auxiliary joint; the stage-beta distribution is

    pi_beta(theta, u) ∝ p(theta) N(u; 0, I) exp(beta log L̂(theta, u))

whose theta-marginal at beta = 1 is the exact pseudo-marginal posterior.
Incremental weights between stages are (beta' - beta) log L̂_i with each
particle's STORED estimate: no estimator call for weighting.  Per stage (the
stage loop runs on the host: the number of stages depends on the data):

1. beta' by bisection (30 steps) so that the effective sample size of the
   incremental weights is ``ess_frac * N`` (clipped at 1);
2. logZ += logmeanexp((beta' - beta) ll);
3. systematic resampling with one uniform (``parallel/resampling.py``);
4. rejuvenation: ``n_mcmc`` steps of a composite built against the
   tempered target (``aux_slice``, ``aux_hmc`` or ``aux_nuts``), the state
   carrying beta' ll while it runs.

Width and step adaptation per stage comes from the population's std, as in
the reference.

Known differences from the reference:

- ``tempered_target`` drops every closure that computes an estimate and is
  not tempered: besides the reference's ``log_weights_u``,
  ``coord_estimators`` and ``log_lik_est_rot``, also the two sweep factories,
  ``coord_estimators_c``, ``prepare_c`` and ``cache_init``.  The reference
  keeps ``ess_sweep_factory`` (``auxpm_tpu/samplers/smc.py:76-87``), which
  its ESS takes whenever it is there (``samplers/ess_u.py:80-86``; the GP
  target builds it whenever ``pad_to_tiles`` is on): the sweep then compares
  UNtempered estimates with the tempered level and writes an untempered
  estimate back.  Here every closure left returns beta x the untempered
  estimate, or is None, so rejuvenation takes the per-probe paths.

Keys follow the reference's: ``k_init, k_loop = split(key(seed))``; particle
i starts from ``split(k_init, N)[i]`` (``k_t, k_u, k_carry = split(., 3)``:
theta ``sample_prior_key(k_t)``, u ``normal(k_u)``); stage s takes ``k_res,
k_rej = split(fold_in(k_loop, s))``, resamples with ``uniform(k_res)`` and
gives every particle a fresh key ``split(k_rej, N)``, so duplicated copies
decorrelate.
"""

from __future__ import annotations

import dataclasses
import math
import time

import torch

from auxpm_tpu_torch.core import prng
from auxpm_tpu_torch.core.state import ChainState
from auxpm_tpu_torch.ops.logsumexp import logsumexp
from auxpm_tpu_torch.parallel.resampling import systematic_resample_indices

_MAX_STAGES = 100   # the reference's cap on the number of tempering stages
_N_BISECT = 30      # bisection steps for the next beta, as in the reference


def ess_of_logw(log_w):
    """Kish effective sample size of unnormalised log-weights ``(n,)``."""
    return torch.exp(2.0 * logsumexp(log_w) - logsumexp(2.0 * log_w))


def next_beta(ll, beta, ess_frac):
    """Largest beta' in (beta, 1] with ESS((beta' - beta) ll) >= ess_frac N,
    by bisection (the ESS does not increase with the increment); ``beta`` a
    0-d tensor, the result one too (no host sync)."""
    target = ess_frac * ll.shape[0]
    one = torch.ones((), dtype=ll.dtype, device=ll.device)
    full = ess_of_logw((one - beta) * ll)
    lo, hi = beta, one
    for _ in range(_N_BISECT):
        mid = 0.5 * (lo + hi)
        ok = ess_of_logw((mid - beta) * ll) >= target
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return torch.where(full >= target, one, lo)


def tempered_target(target, beta):
    """The target with its likelihood raised to the power ``beta``: every
    estimator closure left returns ``beta`` x the untempered estimate; the
    ones that cannot be tempered by scaling their result are None (see the
    module note)."""

    def scale(f):
        return lambda *a, **kw: beta * f(*a, **kw)

    return dataclasses.replace(
        target,
        log_lik_est=scale(target.log_lik_est),
        log_lik_est_u=(scale(target.log_lik_est_u)
                       if target.log_lik_est_u is not None else None),
        log_weights_u=None,        # tempering breaks the lse decomposition
        log_lik_est_rot=None,
        coord_estimators=None,     # closures over the untempered estimator
        coord_estimators_c=None,
        ess_sweep_factory=None,    # the sweeps fold untempered estimates
        sigma_sweep_factory=None,
        cache_init=None,
        prepare_c=None,
        make_sharded=None,
    )


def default_rejuvenation_params(target):
    """``std (d,) -> params``: the population-adaptive kernel params of the
    reference (slice widths 2 std, the MH step 2.38 mean(std) / sqrt(d),
    HMC / NUTS step 0.5 with the population variance as inverse mass)."""

    def params(std):
        var = std * std
        return {
            "slice_theta": {"widths": 2.0 * std},
            "mh_theta": {"step_size": 2.38 * std.mean() / math.sqrt(target.d)},
            "nuts": {"step_size": 0.5, "inv_mass": var},
            "hmc": {"step_size": 0.5, "inv_mass": var},
        }

    return params


def _take(states, idx):
    """The particles ``idx`` of every batched leaf of ``states``."""

    def take(tree):
        if isinstance(tree, dict):
            return {k: take(v) for k, v in tree.items()}
        return tree[idx]

    extras = take(states.extras)
    return states.replace(theta=states.theta[idx], u=states.u[idx],
                          log_lik_hat=states.log_lik_hat[idx],
                          key=states.key[idx], extras=extras)


def make_smc(target, make_rejuvenation, n_particles, n_mcmc=2, ess_frac=0.5):
    """Build an SMC runner.

    Args:
      make_rejuvenation: ``(tempered_target) -> transition``, e.g.
        ``composite.make_aux_slice`` or ``composite.make_aux_nuts``.

    Returns ``run(seed, on_stage=None) -> (states, diag)``; ``diag`` holds
    ``log_z``, ``betas``, ``n_stages`` and ``stage_seconds``.
    ``on_stage(stage, beta, states, infos)`` is called after each stage."""
    rejuvenation_params = default_rejuvenation_params(target)
    log_n = math.log(float(n_particles))

    def stage(states, beta, k_stage):
        ll = states.log_lik_hat        # untempered log L̂ per particle
        beta_new = next_beta(ll, beta, ess_frac)
        log_w = (beta_new - beta) * ll
        log_z_inc = logsumexp(log_w) - log_n
        k = prng.split(k_stage, 2)
        states = _take(states, systematic_resample_indices(
            log_w, prng.uniform(k[0])))
        # fresh keys after resampling: the copies must decorrelate
        states = states.replace(key=prng.split(k[1], n_particles))
        std = states.theta.std(0, unbiased=False) + 1e-6
        params = rejuvenation_params(std)
        transition = make_rejuvenation(tempered_target(target, beta_new))
        names = getattr(transition, "stage_names", ())
        params = {k: v for k, v in params.items() if k in names}
        # the state carries the tempered estimate for the kernel
        s = states.replace(log_lik_hat=beta_new * states.log_lik_hat)
        infos = {}
        for _ in range(n_mcmc):
            s, infos = transition(s, params)
        return (s.replace(log_lik_hat=s.log_lik_hat / beta_new), beta_new,
                log_z_inc, infos)

    def init_prior(k_init):
        if target.sample_prior_key is None:
            raise ValueError(
                f"SMC needs target.sample_prior_key (target {target.name}): "
                "the stage-0 population must be exact prior draws for logZ")
        k = prng.split(prng.split(k_init, n_particles), 3)
        theta = target.sample_prior_key(k[:, 0])
        u = prng.normal(k[:, 1], tuple(target.u_shape))
        return ChainState(theta=theta, u=u,
                          log_lik_hat=target.log_lik_est(theta, u),
                          key=k[:, 2].contiguous())

    def run(seed, on_stage=None):
        k_init, k_loop = prng.split(prng.key(seed).to(target.device), 2)
        states = init_prior(k_init)
        beta = torch.zeros((), dtype=states.theta.dtype,
                           device=states.theta.device)
        log_z, betas, seconds = 0.0, [0.0], []
        for s in range(_MAX_STAGES):
            t0 = time.perf_counter()
            states, beta, log_z_inc, infos = stage(
                states, beta, prng.fold_in(k_loop, s))
            log_z += float(log_z_inc)    # host reads: two per stage
            b = float(beta)
            seconds.append(time.perf_counter() - t0)
            betas.append(b)
            if on_stage is not None:
                on_stage(s, b, states, infos)
            if b >= 1.0:
                break
        return states, {"log_z": log_z, "betas": betas,
                        "n_stages": len(betas) - 1, "stage_seconds": seconds}

    return run
