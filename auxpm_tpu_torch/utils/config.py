"""Typed run configuration + registered presets.

Counterpart of ``auxpm_tpu/utils/config.py``: the same ``RunConfig`` fields
(plus ``device``), so a command line written for the JAX package reads the
same here.  Every combination the reference runs is ported, the gradient
samplers on particle-sharded and Laplace targets and the Laplace proposal on
a particle-sharded target included; ``unsupported`` keeps the reference's own
refusals (``ValueError``) and the port's checks that a flag is not ignored.
``PRESETS`` holds the reference's presets, each field for field the
reference's preset of the same name; ``smc_gp_nuts`` is the sharded SMC with
u kept as keys (``samplers/smc_sharded.py``), run under ``torchrun``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class RunConfig:
    preset: str = "pima_aux_slice"
    device: str = "cuda"  # "cuda" raises without a GPU; tests pass "cpu"
    # target
    target: str = "gp"  # gp | gaussian_toy
    dataset: str = "pima"  # pima | breast_cancer | abalone
    n_importance: int = 16
    likelihood: str = "logistic"
    proposal: str = "prior"  # importance proposal: prior | laplace
    whiten_dtype: str = "float32"  # whiten product precision: float32 | bfloat16
    ard: bool = False
    subsample: Optional[int] = None
    noise_frac: float = 0.3  # toy only
    # sampler
    sampler: str = "aux_slice"  # key into samplers.composite.SAMPLERS, or "smc"
    chains: int = 4
    steps: int = 1000
    thin: int = 1
    warmup_windows: int = 3
    window_steps: int = 100
    step_size: float = 0.5
    widths: float = 1.0
    max_step_out: int = 8  # slice stepping-out cap; 0 = shrinkage-only
    n_ess: int = 1  # ESS u-update repeats per step
    n_sigma_extra: int = 0  # extra Cholesky-free log_sigma slice updates
    chol_cache: bool = True  # carry chol_r in state.extras (False: uncached)
    max_shrink_chol: int = 32  # shrink cap of the Cholesky-paying coordinate
    nuts_step_size: float = 0.3
    # SMC
    particles: int = 4096
    smc_rejuvenation: str = "aux_slice"  # aux_slice | aux_hmc | aux_nuts
    smc_n_mcmc: int = 2
    smc_ess_frac: float = 0.5
    smc_carry_u: bool = True
    smc_n_u_mh: int = 2
    smc_rejuv_batch: int = 256
    smc_rejuv_dispatches: int = 1
    smc_u_blocks: int = 1
    smc_checkpoint_dir: str = ""
    # parallel
    sharded: bool = False
    particle_shards: int = 1
    multihost: bool = False
    profile_dir: Optional[str] = None  # torch.profiler Chrome trace of the run
    # misc
    seed: int = 0
    jitter_scale: float = 0.3
    metrics_path: Optional[str] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0  # windows; 0 = off
    out: Optional[str] = None
    plots: Optional[str] = None  # prefix for trace/density/autocorr figures

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


PRESETS = {
    # BASELINE config 1: 2-D Gaussian target, PM-MH with 16 importance
    # samples, 4 chains
    "toy_pm_mh": RunConfig(
        preset="toy_pm_mh",
        target="gaussian_toy",
        n_importance=16,
        sampler="pm_mh",
        chains=4,
        steps=5000,
        step_size=0.6,
    ),
    # BASELINE config 2: GP classification on Pima (532 points), auxiliary PM
    # slice sampling, 64 importance samples per step
    "pima_aux_slice": RunConfig(
        preset="pima_aux_slice",
        target="gp",
        dataset="pima",
        n_importance=64,
        sampler="aux_slice",
        chains=128,
        steps=1000,
        widths=1.0,
    ),
    # BASELINE config 3: GP classification on Breast-Cancer (569 points ->
    # 640; real data through scikit-learn) and Abalone (a synthetic
    # stand-in of 4177 x 8 unless data/abalone.csv exists)
    "breast_cancer_aux": RunConfig(
        preset="breast_cancer_aux",
        target="gp",
        dataset="breast_cancer",
        n_importance=64,
        sampler="aux_slice",
        chains=64,
        steps=1000,
    ),
    "abalone_aux": RunConfig(
        preset="abalone_aux",
        target="gp",
        dataset="abalone",
        n_importance=64,
        sampler="aux_slice",
        chains=32,
        steps=500,
        subsample=1024,  # full 4177-pt abalone (n -> 4224): --subsample 0
    ),
    # config 2 variant: ARD kernel (per-dimension lengthscales, theta is
    # (d+1)-dimensional); every ell probe builds its Gram with the ARD Gram
    # kernel (ops/gram.se_gram_ard_hopper)
    "pima_ard_aux": RunConfig(
        preset="pima_ard_aux",
        target="gp",
        dataset="pima",
        n_importance=64,
        sampler="aux_slice",
        chains=64,
        steps=1000,
        ard=True,
    ),
    # BASELINE config 4: "4096 vectorized chains on GP posterior, chains
    # sharded across hosts, global step-size/bracket adaptation via psum";
    # every chain draws from its own key, so the records are the same on any
    # number of chain shards (torchrun --nproc-per-node, or --nnodes with
    # --multihost)
    "gp_4096_sharded": RunConfig(
        preset="gp_4096_sharded",
        target="gp",
        dataset="pima",
        n_importance=64,
        sampler="aux_slice",
        chains=4096,
        steps=500,
        sharded=True,
    ),
    # BASELINE config 5: SMC with distributed resampling and NUTS
    # rejuvenation, u kept as its generating key (samplers/smc_sharded.py)
    "smc_gp_nuts": RunConfig(
        preset="smc_gp_nuts",
        target="gp",
        dataset="pima",
        n_importance=32,
        sampler="smc",
        smc_rejuvenation="aux_nuts",
        particles=4096,
        sharded=True,
        smc_carry_u=False,
    ),
    # single-device SMC on the Gaussian toy (closed-form evidence)
    "smc_toy": RunConfig(
        preset="smc_toy",
        target="gaussian_toy",
        n_importance=16,
        sampler="smc",
        smc_rejuvenation="aux_slice",
        particles=2048,
    ),
}

SMC_REJUVENATION = ("aux_slice", "aux_hmc", "aux_nuts")
# the key-as-u mode (smc_carry_u=False) rejuvenates with the theta-only
# kernel of the named composite, as the reference's run.py maps it; the
# THETA_ONLY names themselves are accepted too
KEYED_REJUVENATION = {"aux_nuts": "nuts", "aux_hmc": "hmc", "aux_mh": "mh_theta",
                      "aux_slice": "slice_theta", "aux_slice_rd": "slice_theta",
                      "nuts": "nuts", "hmc": "hmc", "mh_theta": "mh_theta",
                      "slice_theta": "slice_theta"}


def unsupported(cfg: RunConfig):
    """Raise ``ValueError`` if ``cfg`` asks for a combination that the
    reference refuses, or sets a flag that the run would ignore."""
    from auxpm_tpu_torch.samplers.composite import SAMPLERS

    if cfg.target not in ("gp", "gaussian_toy"):
        raise ValueError(f"unknown target {cfg.target!r}")
    smc = cfg.sampler == "smc"
    if not smc and cfg.sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {cfg.sampler!r}")
    if smc and cfg.particle_shards > 1:
        # the sharded SMC spreads the particles over every rank already
        raise ValueError(
            "--particle-shards > 1 is not supported with --sampler smc: "
            "the sharded SMC distributes particles over the full device "
            "mesh already (use --sharded alone)")
    keyed = smc and not cfg.smc_carry_u
    if keyed and not cfg.sharded:
        raise ValueError("smc_carry_u=False (u kept as keys) is the sharded "
                         "SMC's mode: add --sharded true")
    names = tuple(KEYED_REJUVENATION) if keyed else SMC_REJUVENATION
    if smc and cfg.smc_rejuvenation not in names:
        raise ValueError(f"smc_rejuvenation must be one of {names}"
                         f", got {cfg.smc_rejuvenation!r}")
    if cfg.multihost and not cfg.sharded:
        raise ValueError("--multihost runs the sharded path over a world that "
                         "spans several nodes: add --sharded true")
    if cfg.particle_shards > 1 and not cfg.sharded:
        raise ValueError("--particle-shards > 1 needs --sharded true")


def build_target(cfg: RunConfig):
    unsupported(cfg)
    if cfg.target == "gaussian_toy":
        from auxpm_tpu_torch.models.gaussian_toy import make_gaussian_toy

        return make_gaussian_toy(
            n_importance=cfg.n_importance, noise_frac=cfg.noise_frac,
            device=cfg.device,
        )
    from auxpm_tpu_torch.models.datasets import load
    from auxpm_tpu_torch.models.gp_classification import make_gp_classification

    x, y = load(cfg.dataset, subsample=cfg.subsample or None, seed=cfg.seed)
    return make_gp_classification(
        x,
        y,
        n_importance=cfg.n_importance,
        likelihood=cfg.likelihood,
        proposal=cfg.proposal,
        ard=cfg.ard,
        whiten_dtype=cfg.whiten_dtype,
        device=cfg.device,
    )


def initial_params(cfg: RunConfig, target):
    """Initial sampler params of the composite, from the config: each group
    the reference's ``initial_params`` builds, with the same knobs."""
    import torch

    if cfg.sampler == "pm_mh":
        return {"step_size": cfg.step_size}
    slice_g = {"widths": torch.full((target.d,), cfg.widths,
                                    dtype=torch.float32, device=target.device),
               "max_step_out": cfg.max_step_out,
               "max_shrink_chol": cfg.max_shrink_chol}
    params = {}
    if cfg.sampler.startswith("aux_slice"):
        params["slice_theta"] = dict(slice_g)
        params["ess_u"] = {}
    if cfg.sampler == "aux_slice_pcrd":
        params["slice_theta_rd"] = dict(slice_g)
    if cfg.sampler in ("aux_slice_joint", "joint_slice"):
        params["joint_slice"] = {"width": cfg.widths,
                                 "max_step_out": cfg.max_step_out}
    if cfg.sampler == "joint_mh":
        params["joint_mh"] = {"step_size": cfg.step_size}
    if cfg.sampler == "aux_mh":
        params["mh_theta"] = {"step_size": cfg.step_size}
    if cfg.sampler == "aux_hmc":
        params["hmc"] = {"step_size": cfg.nuts_step_size}
    if cfg.sampler == "aux_nuts":
        params["nuts"] = {"step_size": cfg.nuts_step_size}
    return params
