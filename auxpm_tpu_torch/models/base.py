"""Target protocol: log-prior + deterministic likelihood estimator.

Counterpart of ``auxpm_tpu/models/base.py``, with chains as the leading
tensor axis: every callable takes and returns BATCHED tensors
(``theta (B, d)``, ``u (B, S, n)``, scalars as ``(B,)``).  The
auxiliary-variable contract (Murray & Graham 2016 section 3):

    u ~ N(0, I) over ``u_shape``;  log_lik_est(theta, u) is a deterministic
    function whose exponential is an unbiased estimate of p(y | theta).

The joint target the samplers leave invariant is

    p(theta, u)  ∝  exp(log_prior(theta) + log_lik_est(theta, u)) N(u; 0, I).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Target:
    """A pseudo-marginal target (fields named as in the JAX package).

    Attributes:
      d: parameter dimension.
      u_shape: per-chain shape of the auxiliary block, ``(S, n)``.
      log_prior: ``theta (B, d) -> (B,)``.
      log_lik_est: ``(theta (B, d), u (B, S, n)) -> (B,)``.
      theta_init: default initial parameters ``(d,)``.
      device: where the target's constant tensors live.
      prepare / log_lik_est_u: the estimator split into a theta-only part
        (Gram + Cholesky) and a cheap per-u part;
        ``log_lik_est(theta, u) == log_lik_est_u(prepare(theta), u)``.
      log_lik_est_rot: ``(prepared, u, v, angle (B,), active=None) -> (B,)``,
        the estimate at ``u cos a + v sin a`` with the rotation fused into
        the estimator (``ops/fused_estimator.fused_estimate_rot``); the
        per-probe elliptical-slice loop prefers it.
      ess_sweep_factory: ``n_repeats -> sweep(prepared, u, scal, v)``, the
        whole elliptical-slice sweep in one call (``ops/ess_sweep.py``).
      coord_estimators: per-coordinate probe factories without a carried
        factor: ``coord_estimators[i](theta, u) -> (f, f2)`` with
        ``f(x (B,)) -> (log_post (B,), log_lik (B,))`` the probe function of
        coordinate i and ``f2(xs (2, B)) -> ((2, B), (2, B))`` the same at
        two points per chain in ONE batch of 2B (the stepping-out probes).
      n_weight_blocks: width of the estimator's blocked reduction tree.
      cache_init / prepare_c / coord_estimators_c: the carried-factor cache.
        ``cache_init(theta) -> {"chol_r": (B, n, n)}``;
        ``prepare_c(theta, cache)`` equals ``prepare(theta)`` whenever
        ``cache == cache_init(theta)``; ``coord_estimators_c[i](theta, u,
        cache) -> (f, f2)``, as ``coord_estimators`` but off the cache where
        the coordinate allows it.  The cache lives in
        ``ChainState.extras["target_cache"]`` and the samplers keep
        ``extras["target_cache"] == cache_init(state.theta)`` at every step
        boundary.
      sigma_sweep_factory: ``n_reps -> fn(theta, u, cache, ll0, lp0, width,
        rep) -> (sigma', ll', lp', n_shrink, moved)``, all log_sigma slice
        updates in one call (``ops/sigma_sweep.py``).
      log_weights_u: ``(prepared, u (B, S', n)) -> (B, S')`` per-sample
        log-weights of any subset of rows; what the generic particle-sharded
        wrap (``parallel/particle_shard.py``) reduces with a collective.
      make_sharded: ``mesh -> Target``, the target rebuilt with a
        collective-aware estimator over the mesh's particle group (u then
        holds this rank's ``S / K`` rows); None on a target that is already
        sharded or has no such rebuild.
      sample_prior_key: ``keys (N, 2) -> theta (N, d)``, the exact prior
        draw of each key by the reference's own formula (``core/prng.py``,
        the reference's ``sample_prior``), so that a keyed run draws the
        reference's population.
      exact_log_post / posterior_mean / posterior_cov: closed forms, for
        targets that have them (the Gaussian toy).
    """

    d: int
    u_shape: tuple
    log_prior: Callable
    log_lik_est: Callable
    theta_init: torch.Tensor
    device: torch.device
    name: str = "target"
    prepare: Optional[Callable] = None
    log_lik_est_u: Optional[Callable] = None
    log_lik_est_rot: Optional[Callable] = None
    ess_sweep_factory: Optional[Callable] = None
    coord_estimators: Optional[tuple] = None
    sample_prior_key: Optional[Callable] = None
    n_weight_blocks: int = 1
    cache_init: Optional[Callable] = None
    prepare_c: Optional[Callable] = None
    coord_estimators_c: Optional[tuple] = None
    sigma_sweep_factory: Optional[Callable] = None
    log_weights_u: Optional[Callable] = None
    make_sharded: Optional[Callable] = None
    exact_log_post: Optional[Callable] = None
    posterior_mean: Optional[torch.Tensor] = None
    posterior_cov: Optional[torch.Tensor] = None

    def log_joint(self, theta, u):
        """Unnormalised joint log density minus the N(u; 0, I) factor."""
        return self.log_prior(theta) + self.log_lik_est(theta, u)


def set_coord(theta, i, x):
    """``theta (B, d)`` with column i replaced by ``x (B,)``."""
    return torch.cat([theta[:, :i], x[:, None], theta[:, i + 1:]], dim=1)


# chains of one estimator call in a 2-point probe: above it the two points
# go as two calls (the Grams of one call at n = 640 are 6.7 GB at 4096).  A
# chain's Gram, factor and estimate do not depend on the batch it is in, so
# either way gives it the same numbers.
MAX_PROBE_BATCH = 4096


def two_calls(f, xs):
    """``f2``'s result from one call of ``f`` per point: ``((2, B), (2,
    B))``."""
    return tuple(torch.stack(v) for v in zip(f(xs[0]), f(xs[1])))


def full_coord_probes(log_prior, log_lik_est, theta, u, i):
    """Probe functions ``(f, f2)`` of coordinate i through the whole
    estimator (every probe pays ``log_lik_est`` at its own candidate).

    ``f(x (B,)) -> (log_post (B,), log_lik (B,))``; ``f2(xs (2, B)) ->
    ((2, B), (2, B))`` evaluates two points per chain as ONE batch of 2B
    chains (u twice along the chains axis, made when first needed), or as
    two past ``MAX_PROBE_BATCH``."""

    def f(x):
        th = set_coord(theta, i, x)
        ll = log_lik_est(th, u)
        return log_prior(th) + ll, ll

    u2 = []

    def f2(xs):
        if xs.numel() > MAX_PROBE_BATCH:
            return two_calls(f, xs)
        if not u2:
            u2.append(torch.cat([u, u]))
        th = set_coord(theta.repeat(2, 1), i, xs.reshape(-1))
        ll = log_lik_est(th, u2[0])
        return (log_prior(th) + ll).view(2, -1), ll.view(2, -1)

    return f, f2
