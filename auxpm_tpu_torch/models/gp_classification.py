"""Latent-GP binary classification posterior over kernel hyperparameters.

Counterpart of ``auxpm_tpu/models/gp_classification.py`` (isotropic and ARD
kernels, the prior and the Laplace proposal).  Binary labels y_i in {-1, +1}, latent
f ~ GP(0, K_theta) with a squared-exponential kernel, Bernoulli likelihood
(logistic or probit), and a pseudo-marginal target over theta =
``[log_ell, log_sigma]`` (isotropic) or ``[log_ell_1..log_ell_d, log_sigma]``
(ARD) with the marginal likelihood estimated by importance sampling from the
GP prior:

    u ~ N(0, I_{S x n})           (auxiliary state, S importance samples)
    f_s = C_theta u_s             (whitening; C = chol(K))
    log w_s = sum_i log lik(y_i f_si)
    log L̂(theta, u) = blocked-lse_s log w_s - log S

The estimator is split into

    prepare(theta) -> C          Gram + O(n^3) Cholesky
    estimate(C, u) -> log L̂     O(S n^2) whiten + likelihood + lse

Jitter is RELATIVE, K = sigma^2 (R(ell) + jitter I), so the factor separates:
chol(K) = sigma chol(R + jitter I).  The log_sigma coordinate therefore never
pays a Cholesky, and the sigma-independent factor ``chol_r`` can be carried in
the chain state (``cache_init`` / ``prepare_c``).

All shapes are padded to a multiple of 128 (n=532 -> 640 for Pima); the
padding is EXACT: padded labels are +1 with mask 0 and padded u components
never reach the likelihood.  Isotropic: padded squared distances are 1e30
(zero covariance) and the padded diagonal is 0 (unit variance + jitter).
ARD: padded rows of x are zero and the Gram is masked after the jitter,
``r * mask_i * mask_j + diag(1 - mask)``, so the pad diagonal is exactly 1.

Each coordinate has a probe factory returning ``(f, f2)``: the 1-point probe
and the 2-point probe of the stepping-out loop, which evaluates both bracket
ends of every chain as ONE batch of 2B chains (as two batches of B past
``models/base.MAX_PROBE_BATCH`` chains, to bound the memory of a call).  An ell probe pays Gram +
factorisation + estimate; a log_sigma probe rescales a factor (the carried
one, or one factored once per sweep) and pays only the estimate.

Particle sharding (``particle_axis``, a ``parallel.mesh.Mesh``): u holds this
rank's ``S / K`` rows, the per-sample weights kernels
(``ops/fused_estimator.fused_weights`` / ``fused_rot_weights``) score them
against the factor, which every rank of the group computes for itself
(replicated), and a collective folds the blocked partials of all ranks in
global block order (``parallel/collectives.allgather_blocked_logsumexp``), so
every rank holds bitwise the same estimate.  Every estimator call of such a
target (the coordinate factories included) goes through that one function;
the Laplace proposal's log-weights too.  It has no whole-sweep factories: a
sweep kernel folds each estimate inside its launch, where no collective can
reach.

``proposal="laplace"`` draws the importance samples from the Laplace
approximation N(f̂, Σ_q) fitted per theta by Newton (``models/laplace.py``):
``prepare`` returns ``(chol_k, f_hat, chol_q, half_logdet_q)`` and the
log-weights add log N(f; 0, K) - log N(f; f̂, Σ_q) to the likelihood (plain
PyTorch; no estimator kernel takes a tuple).  The mode depends on sigma, so
there is no carried factor, no sigma-separable probe and no sweep: every
sampler takes its generic path, each probe paying ``1 + newton_iters + 2``
factorisations.  On a particle axis the Newton fit runs replicated on every
rank and the local log-weights fold through the same collective as the
prior's, as in the reference.

``log_lik_est(theta, u)`` and ``log_prior`` are differentiable in theta on
both devices, isotropic and ARD, with either proposal, sharded or not (what
HMC and NUTS need): ``prepare`` -> ``robust_cholesky`` -> the estimator go
through the ``torch.autograd.Function``s of ``ops/`` (``SeGramArd``,
``RobustCholesky``, ``FusedEstimate``, ``FusedWeights``), whose forwards are
the kernels on the card and whose backwards are plain PyTorch; the Laplace
fit differentiates through its unrolled Newton loop (``models/laplace.py``).
On a particle axis the fold's backward reaches this rank's rows only, and
``log_lik_est`` passes theta through ``parallel/collectives.
particle_grad_sum`` before ``prepare``, whose backward adds the ranks'
shares of the theta cotangent: every rank of the group holds bitwise the
same gradient.

Every callable of the returned ``Target`` is batched over a leading chains
axis.  The reference's memory gates on its sweeps belong to the TPU; the
port's factories return None where the sweep body refuses the shapes
(``ops/fused_estimator.fits_sweep_body``: S past 4096, or a reduction tree
of more than 32 blocks), and on an unpadded target (``pad_to_tiles=False``,
or n not a multiple of 128), exactly where the reference's ``use_fused`` is
False; the step then takes the per-probe path, whose estimates go through
the estimator kernels for any S and n, as do the factorisation (identity
padding, ``ops/cholesky``) and the ARD Gram.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from auxpm_tpu_torch._device import resolve_device
from auxpm_tpu_torch.core import prng
from auxpm_tpu_torch.models.base import (
    MAX_PROBE_BATCH,
    Target,
    full_coord_probes,
    set_coord,
    two_calls,
)
from auxpm_tpu_torch.models.likelihoods import LIKELIHOODS
from auxpm_tpu_torch.ops.cholesky import robust_cholesky
from auxpm_tpu_torch.ops.ess_sweep import make_fused_ess_sweep
from auxpm_tpu_torch.ops.fused_estimator import (
    WHITEN_DTYPES,
    fits_sweep_body,
    make_fused_estimator,
    make_fused_rot_estimator,
    make_fused_rot_weights,
    make_fused_weights,
)
from auxpm_tpu_torch.ops.gram import SeGramArd, se_gram_iso
from auxpm_tpu_torch.ops.logsumexp import blocked_logsumexp
from auxpm_tpu_torch.ops.sigma_sweep import make_fused_sigma_sweep

_TILE = 128
_N_WEIGHT_BLOCKS = 8  # canonical reduction-tree width


def make_gp_classification(
    x,
    y,
    n_importance=64,
    likelihood="logistic",
    ard=False,
    jitter=1e-5,
    prior_mean=0.0,
    prior_std=1.5,
    name=None,
    pad_to_tiles=True,
    proposal="prior",
    particle_axis=None,
    whiten_dtype="float32",
    device="cuda",
    newton_iters=6,
):
    """Build the GP-classification pseudo-marginal ``Target``.

    Args:
      x: (n, d) standardised features (NumPy).
      y: (n,) labels in {-1, +1} (NumPy).
      n_importance: S, importance samples per estimate.
      likelihood: "logistic" or "probit".
      ard: per-dimension lengthscales if True (theta is (d+1)-dimensional;
        every ell probe builds its Gram with ``ops/gram.se_gram_ard_hopper``,
        through ``SeGramArd``).
      jitter: relative diagonal nugget (see the module docstring).
      pad_to_tiles: pad the dataset axis to a multiple of 128.  An unpadded
        target runs on the card too, without the sweep factories (the
        reference's ``use_fused``).
      whiten_dtype: "float32" (exact) or "bfloat16" (both operands of the
        whiten product rounded to bf16, f32 accumulate).  Part of the
        estimator's definition.
      device: where the target lives; "cuda" (default) raises without a GPU.
      particle_axis: this rank's ``parallel.mesh.Mesh`` for a target whose
        u is split over the mesh's particle group (see the module note);
        ``Target.make_sharded`` is the usual way to get one.
      proposal: "prior" (the density ratio cancels) or "laplace" (see the
        module note).
      newton_iters: the Laplace fit's fixed Newton iteration count.
    """
    if proposal not in ("prior", "laplace"):
        raise ValueError(f"unknown proposal {proposal!r}")
    if proposal == "laplace" and whiten_dtype != "float32":
        raise ValueError(
            "whiten_dtype != float32 needs the fused tile-aligned path "
            "(pad_to_tiles=True) with the prior proposal"
        )
    if particle_axis is not None:
        from auxpm_tpu_torch.parallel.mesh import require_mesh

        require_mesh(particle_axis)
    if likelihood not in ("logistic", "probit"):
        raise ValueError(f"unknown likelihood {likelihood!r}")
    if whiten_dtype not in WHITEN_DTYPES:
        raise ValueError(f"unknown whiten_dtype {whiten_dtype!r}")
    device = resolve_device(device)
    dtype = torch.float32

    x = np.asarray(x)
    y = np.asarray(y)
    n_raw, d = x.shape
    n = -(-n_raw // _TILE) * _TILE if pad_to_tiles else n_raw
    pad = n - n_raw

    y_dev = torch.as_tensor(
        np.concatenate([y, np.ones(pad, y.dtype)]), dtype=dtype, device=device
    )
    mask = torch.as_tensor(
        np.concatenate([np.ones(n_raw), np.zeros(pad)]), dtype=dtype,
        device=device,
    )

    # dataset sqdist: computed ONCE on the host in f64
    x64 = np.asarray(x, np.float64)
    sq_raw = ((x64[:, None, :] - x64[None, :, :]) ** 2).sum(-1).astype(np.float32)
    if pad:
        big = np.full((n, n), np.float32(1e30))
        big[:n_raw, :n_raw] = sq_raw
        np.fill_diagonal(big, 0.0)  # pad diagonal -> exp(0) + jitter
        sq_raw = big
    sqdist = torch.as_tensor(sq_raw, dtype=dtype, device=device)
    x_pad = torch.as_tensor(
        np.concatenate([x, np.zeros((pad, d), x.dtype)]), dtype=dtype,
        device=device,
    ).contiguous()

    n_theta = (d + 1) if ard else 2
    nb_global = _N_WEIGHT_BLOCKS if n_importance % _N_WEIGHT_BLOCKS == 0 else 1

    def split_theta(theta):
        """``theta (B, n_theta) -> (log_ell (B, d) or (B,), log_sigma (B,))``."""
        return (theta[:, :-1] if ard else theta[:, 0]), theta[:, -1]

    def r_matrix(log_ell):
        """R(ell) + jitter I: the sigma-independent correlation matrix."""
        if ard:
            # zero covariance to/from pad rows, pad diagonal exactly 1
            return SeGramArd.apply(x_pad, log_ell, jitter,
                                   mask if pad else None)
        # sqdist padding already zeroes the off-diagonal pad entries
        return se_gram_iso(sqdist, log_ell, 0.0, jitter)

    def chol_r(log_ell):
        """chol(R(ell) + jitter I) for a batch of lengthscales: the
        sigma-independent factor, through the escalating factorisation."""
        return robust_cholesky(r_matrix(log_ell), jitter0=jitter)

    def _scale(log_sigma, factor):
        return torch.exp(log_sigma)[:, None, None] * factor

    def prepare(theta):
        log_ell, log_sigma = split_theta(theta)
        return _scale(log_sigma, chol_r(log_ell))

    log_weights_u = make_fused_weights(y_dev, mask, likelihood,
                                       whiten_dtype=whiten_dtype)
    log_s_fac = float(np.log(np.float32(n_importance)))

    def _combine_local_lw(lw, u_rows):
        """Blocked lse of this rank's log-weights ``(B, u_rows)`` over the
        particle group, minus log S (global S)."""
        from auxpm_tpu_torch.parallel.collectives import (
            allgather_blocked_logsumexp,
            psum_logsumexp,
        )

        k_shards = n_importance // u_rows
        if k_shards != particle_axis.n_particle_shards \
                or k_shards * u_rows != n_importance:
            raise ValueError(
                f"u holds {u_rows} of S={n_importance} rows on a particle "
                f"group of {particle_axis.n_particle_shards}")
        if nb_global % k_shards or u_rows % (nb_global // k_shards):
            # S does not fit the fixed blocked tree (e.g. S % 8 != 0 gives
            # nb_global == 1): the generic collective log-sum-exp, still the
            # exact global estimate and the same on every rank, but not the
            # unsharded tree
            return psum_logsumexp(lw, particle_axis) - log_s_fac
        return allgather_blocked_logsumexp(
            lw, nb_global // k_shards, particle_axis) - log_s_fac

    if particle_axis is None:
        log_lik_est_u = make_fused_estimator(
            y_dev, mask, likelihood, n_blocks=nb_global,
            whiten_dtype=whiten_dtype)
        log_lik_est_rot = make_fused_rot_estimator(
            y_dev, mask, likelihood, n_blocks=nb_global,
            whiten_dtype=whiten_dtype)
    else:
        _lw_rot = make_fused_rot_weights(y_dev, mask, likelihood,
                                         whiten_dtype=whiten_dtype)

        def log_lik_est_u(chol, u):
            return _combine_local_lw(log_weights_u(chol, u), u.shape[-2])

        def log_lik_est_rot(chol, u, v, angle, active=None):
            est = _combine_local_lw(_lw_rot(chol, u, v, angle, active),
                                    u.shape[-2])
            if active is not None:
                est = torch.where(active != 0, est, torch.zeros_like(est))
            return est

    def _theta_in(theta):
        """theta as the estimate's path sees it: on a particle axis through
        the theta-cotangent sum of the group (identity forward)."""
        if particle_axis is None:
            return theta
        from auxpm_tpu_torch.parallel.collectives import particle_grad_sum

        return particle_grad_sum(theta, particle_axis)

    def log_lik_est(theta, u):
        return log_lik_est_u(prepare(_theta_in(theta)), u)

    log_norm = n_theta * (0.5 * math.log(2.0 * math.pi) + math.log(prior_std))

    def log_prior(theta):
        r = (theta - prior_mean) / prior_std
        return -0.5 * (r * r).sum(-1) - log_norm

    # the sweeps run on a padded target (the reference's use_fused) where
    # the sweep body takes the shapes; elsewhere the factories return None
    # and the step takes the per-probe path, as the reference's factories do
    # past their gates
    use_fused = pad_to_tiles and n % _TILE == 0
    sweep_fits = use_fused and fits_sweep_body(n_importance, n, nb_global)

    def _ess_sweep_factory(n_repeats):
        if not sweep_fits:
            return None
        return make_fused_ess_sweep(
            y_dev, mask, likelihood, n_blocks=nb_global,
            whiten_dtype=whiten_dtype, n_repeats=n_repeats,
        )

    hiv = 0.5 / float(prior_std) ** 2

    def _sigma_sweep_factory(n_reps):
        if not sweep_fits:
            return None
        sweep = make_fused_sigma_sweep(
            y_dev, mask, likelihood, n_blocks=nb_global,
            whiten_dtype=whiten_dtype, n_reps=n_reps,
        )

        def run(theta, u, cache, ll0, lp0, width, rep):
            sigma0 = theta[:, n_theta - 1]
            d0 = sigma0 - prior_mean
            # lp(x) = lp_rest - hiv (x - mu)^2 + ll(x) reproduces
            # log_prior(theta with sigma = x) + ll to ~1 ulp
            lp_rest = log_prior(theta) + hiv * d0 * d0
            chain = torch.stack(
                [
                    ll0,
                    lp0,
                    sigma0,
                    width.expand_as(ll0),
                    torch.full_like(ll0, prior_mean),
                    torch.full_like(ll0, hiv),
                    lp_rest,
                    torch.zeros_like(ll0),
                ],
                dim=1,
            ).to(dtype)
            return sweep(cache["chol_r"], u, chain, rep.to(dtype))

        return run

    # ---- per-coordinate probe factories ----------------------------------
    def _full_coord_factory(i):
        """Coordinate i through the full estimator: every probe factors the
        Gram of its own candidate."""
        return lambda theta, u: full_coord_probes(log_prior, log_lik_est,
                                                  theta, u, i)

    def _sigma_probes(theta, u, chol0):
        """log_sigma probes off the factor ``chol0 (B, n, n)`` of R(ell):
        rescale per probe, never factor.  Probes go through the same
        ``log_lik_est_u`` as every other estimator call."""
        last = n_theta - 1

        def f(x):
            th = set_coord(theta, last, x)
            ll = log_lik_est_u(_scale(x, chol0), u)
            return log_prior(th) + ll, ll

        u2 = []

        def f2(xs):
            if xs.numel() > MAX_PROBE_BATCH:
                return two_calls(f, xs)
            if not u2:
                u2.append(torch.cat([u, u]))
            th = set_coord(theta.repeat(2, 1), last, xs.reshape(-1))
            scaled = (torch.exp(xs)[:, :, None, None] * chol0[None]).reshape(
                -1, *chol0.shape[1:])
            ll = log_lik_est_u(scaled, u2[0])
            return (log_prior(th) + ll).view(2, -1), ll.view(2, -1)

        return f, f2

    def _sigma_coord_factory(theta, u):
        """Factor once with chol(R) per sweep, rescale per probe."""
        return _sigma_probes(theta, u, chol_r(split_theta(theta)[0]))

    coord_estimators = tuple(
        [_full_coord_factory(i) for i in range(n_theta - 1)]
        + [_sigma_coord_factory]
    )

    # ---- carried chol_r cache -------------------------------------------
    def cache_init(theta):
        return {"chol_r": chol_r(split_theta(theta)[0])}

    def prepare_c(theta, cache):
        return _scale(split_theta(theta)[1], cache["chol_r"])

    def _full_coord_factory_c(i):
        base = _full_coord_factory(i)

        def factory(theta, u, cache):
            del cache  # an ell probe must refactorise at its own candidate
            return base(theta, u)

        return factory

    def _sigma_coord_factory_c(theta, u, cache):
        """log_sigma probes off the CARRIED factor: no factorisation."""
        return _sigma_probes(theta, u, cache["chol_r"])

    coord_estimators_c = tuple(
        [_full_coord_factory_c(i) for i in range(n_theta - 1)]
        + [_sigma_coord_factory_c]
    )

    def make_sharded(mesh):
        """Particle-sharded rebuild of this target: the same arguments, the
        collective estimator over ``mesh``'s particle group."""
        return make_gp_classification(
            x, y, n_importance=n_importance, likelihood=likelihood, ard=ard,
            jitter=jitter, prior_mean=prior_mean, prior_std=prior_std,
            name=name, pad_to_tiles=pad_to_tiles, proposal=proposal,
            particle_axis=mesh, whiten_dtype=whiten_dtype, device=device,
            newton_iters=newton_iters)

    sharded = particle_axis is not None
    fast_paths = {
        "log_lik_est_rot": log_lik_est_rot,
        # a sweep kernel reduces over S inside its block: unsharded only
        "ess_sweep_factory": None if sharded else _ess_sweep_factory,
        "sigma_sweep_factory": None if sharded else _sigma_sweep_factory,
        "coord_estimators": coord_estimators,
        "cache_init": cache_init,
        "prepare_c": prepare_c,
        "coord_estimators_c": coord_estimators_c,
    }
    if proposal == "laplace":
        from auxpm_tpu_torch.models.laplace import (
            laplace_fit,
            laplace_log_weight_terms,
        )

        log_lik_fn = LIKELIHOODS[likelihood]

        def prepare(theta):
            log_ell, log_sigma = split_theta(theta)
            r = r_matrix(log_ell)
            chol_k = _scale(log_sigma, robust_cholesky(r, jitter0=jitter))
            k = torch.exp(2.0 * log_sigma)[:, None, None] * r
            f_hat, chol_q, half_logdet_q = laplace_fit(
                k, y_dev, mask, likelihood, newton_iters)
            return (chol_k, f_hat, chol_q, half_logdet_q)

        def log_weights_u(prepared, u):
            f, extra = laplace_log_weight_terms(*prepared, u)
            return log_lik_fn(f, y_dev, mask) + extra

        def log_lik_est_u(prepared, u):
            lw = log_weights_u(prepared, u)
            if sharded:   # the Newton fit replicated, the rows folded
                return _combine_local_lw(lw, u.shape[-2])
            return blocked_logsumexp(lw, nb_global) - log_s_fac

        def log_lik_est(theta, u):
            return log_lik_est_u(prepare(_theta_in(theta)), u)

        # the mode depends on both coordinates: no sigma-separable factor,
        # no structure-aware probes, no kernel that takes the tuple
        fast_paths = dict.fromkeys(fast_paths)
    return Target(
        d=n_theta,
        u_shape=(n_importance, n),
        log_prior=log_prior,
        log_lik_est=log_lik_est,
        theta_init=torch.zeros((n_theta,), dtype=dtype, device=device),
        device=device,
        name=name or f"gp_{likelihood}_n{n_raw}"
        + ("_laplace" if proposal == "laplace" else "")
        + (f"@{particle_axis.name}" if sharded else ""),
        prepare=prepare,
        log_lik_est_u=log_lik_est_u,
        log_weights_u=log_weights_u,
        make_sharded=None if sharded else make_sharded,
        sample_prior_key=lambda keys: prng.fma32(
            prng.normal(keys, (n_theta,)),
            torch.tensor(prior_std, dtype=dtype, device=keys.device),
            torch.tensor(prior_mean, dtype=dtype, device=keys.device)),
        n_weight_blocks=nb_global,
        **fast_paths,
    )
