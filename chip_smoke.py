#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the port's main paths through ``auxpm_tpu_torch.run.main`` (BASELINE
config 2 with the bench settings: ``aux_slice`` on the GP classification
posterior, Pima n=532 padded to 640, S=64, 128 chains; the preset
``pima_ard_aux`` as the CLI runs it: ARD kernel, theta of 8, 64 chains,
stepping-out slices, once with the whole-sweep elliptical-slice kernel and
once with ``AUXPM_ESS_SWEEP=0``, the per-probe loop; config 2 again with
``--sharded true --particle-shards 2``: two ranks on the one card, each
holding 32 of every chain's 64 importance samples; config 3's
``abalone_aux`` at n=1024 and one step at full n=4224; PM-MH and ``aux_mh``
on config 2's target and the config-1 preset ``toy_pm_mh``; a checkpointed
resume; config 4's preset ``gp_4096_sharded``; HMC and NUTS on two
particle-sharded ranks and on the Laplace proposal, and the Laplace proposal
on two ranks; the stepping-out theta slices, Laplace on the ARD target, the
joint samplers on particle shards, ``utils/scaling``, ``utils/dryrun`` and
config 5 at 2^20 key-as-u particles through ``utils/smc_scale``; config 2
at 128 importance samples and the unpadded GP targets of ``--no-pad``; the
counterparts of the reference's ``scripts/tau_sweep.py``, ``theta_bench.py``
and ``ess_sweep_bench.py``) and
holds each of its
eleven hand-written CUDA kernels (the ten TPU kernels' and the threefry
PRNG's) against its plain PyTorch version on the card.
Phases, one JSON line each; any failure raises and the script exits non-zero:

1. ``device``     the card (name and power limit from ``nvidia-smi``) and the
                  build of ``auxpm_tpu_torch/csrc/*.cu`` with ``nvcc``;
2. ``kernels``    each kernel vs its plain version at the main paths' shapes
                  (B=128 and 64, S=64 and S_local=32, n=640, d=7; 128 tiles),
                  timed with CUDA events between L2 flushes, beside the least
                  time the card could take; the weights kernels' rows must
                  not depend on the rows that share their call (bitwise);
                  the estimator (one round of the sweep body), the ESS and
                  the sigma sweep (one cooperative launch each that advances
                  in rounds) and the v3 panel also at B=1, B=3 and more than
                  the sweeps' grid of blocks, bitwise equal to B=128, the
                  estimator also at n=1024, the sweeps with their rounds
                  against their chains' largest probe count and at the
                  32-shrink cap at full width; the three panel modes with
                  NaN on the diagonal from a failing column on, v1's and
                  v2's L and v1's inv(L) bitwise v3's L and inv(L)^T
                  transposed (one factor code); a cooperative grid one
                  block larger than the card holds must be refused; both
                  sweeps also at n=1024 (8 chains) against their plain
                  versions with the n=640 bars, and at B=2051 (the wrappers
                  split a call into launches of at most 2048 chains), each
                  chain bitwise its B=128 result; the rotated estimate and
                  the rotated weights (one round of the sweep body over the
                  active chains each) also at n=1024 and B=2051, and timed
                  with 100, 25 and 3 % of the chains active; the plain
                  weights also at n=1024, and equal bit for bit to the
                  rotated weights at angle 0; the ARD Gram (each tile pair
                  computed once, written with its mirror) exactly
                  symmetric;
3. ``main_path``  the config-2 CLI run; every kernel's launch count must rise,
                  the chains must be finite and moving, and the carried factor
                  must equal ``cache_init(theta)`` on the final state;
4. ``path_parity`` one step from the final state with the same random rows,
                  kernels vs plain versions: decisions equal, values within
                  the bars stated where they are checked;
   ``main_path_4096`` one config-2 step at 4096 chains (each sweep in two
                  launches), its wall time and peak memory;
5. ``main_path_ard`` the ``pima_ard_aux`` CLI run, twice (sweep, loop), with
                  the same checks and the launches each run must and must not
                  make; then launches and host synchronisations per step from
                  a short profiled window;
6. ``path_parity_ard`` one step from the loop run's final state, the new
                  kernels and the estimator vs their plain versions;
   ``loop_ess_n1024`` one step with ``AUXPM_ESS_SWEEP=0`` on a synthetic GP
                  target at n=1024 (8 chains): the loop's probes must go
                  through the rotated-estimate kernel;
7. ``main_path_sharded`` the sharded CLI run on two spawned ranks: both must
                  launch the two weights kernels and no estimator or sweep
                  kernel, and end with bitwise the same theta and log L-hat;
                  the mean share of chains active per rotated-weights
                  launch; then a short profiled window on rank 0;
8. ``path_parity_sharded`` (its two ranks' step in phase 7's spawn since
                  phases 27-32) one step from phase 3's final state on the
                  same rows, two ranks against the unsharded per-probe path:
                  equal counts, values within 1e-4, the two ranks bitwise
                  equal;
9. ``chol_variants`` ``utils/chol_bench.bench`` (``torch.linalg.cholesky`` and
                  the v1, v2, v3 routes at B=128, n=640) and ``cholesky_fast``
                  at n=532: each backward error below 1e-5 relative, each
                  panel inverse residual below 1e-4;
10. ``main_path_config3`` the preset ``abalone_aux`` (n=1024, 32 chains,
                  stepping out) through the CLI under ``--profile-dir``: the
                  estimator, the v3 panel and the ESS sweep must launch and
                  be named in the trace, the sigma sweep and the side paths'
                  kernels must not; wall and busy time per step from a
                  profiled window;
11. ``path_parity_config3`` one step from that state on the same rows, the
                  estimator and the ESS sweep vs their plain versions (the
                  panel kernel shared, as in ``path_parity_ard``): decisions
                  equal, u' and log L-hat after the ESS sweep at the kernels'
                  bars, the step's values at the path bars, log L-hat of the
                  kernel's state at the estimator's bar against the plain
                  estimate; the factor at n=1024 through the blocked loop vs
                  the plain panel, all but four chains on the same jitter;
12. ``abalone_full_n_step`` one step of ``abalone_aux --subsample 0`` (n=4224,
                  32 chains): finite, the carried factor equal to a fresh
                  ``cache_init``, the same launches as phase 10; wall and
                  busy time of the step, peak memory; then one more step on
                  the same rows through the kernels and the plain versions,
                  held as in phase 11;
13. ``main_path_pm_mh`` ``--sampler pm_mh`` (the estimator and the v3 panel,
                  nothing else) and ``--sampler aux_mh`` (plus the ESS sweep)
                  on config 2's target and width, and the preset
                  ``toy_pm_mh``: finite, acceptance strictly between 0 and 1,
                  no carried factor; wall and busy time per step;
14. ``resume_bitwise`` config 2 at 128 chains: 2K steps against K, a
                  checkpoint (``utils/checkpoint``) saved and loaded, and K
                  more: theta, u, log L-hat and the carried factor bitwise
                  equal;
15. ``main_path_theta_samplers``, ``path_parity_theta_samplers``,
                  ``main_path_laplace`` the samplers of the tenth slice and
                  the Laplace proposal on config 2's target;
16. ``grad_parity`` the gradient of log L-hat at a state's theta (B=128
                  isotropic, B=64 ARD) through the kernel forwards under the
                  autograd Functions against the same Functions over the
                  plain forwards (5 % of max(|g|, 1)), the reference's
                  finite-difference check on the kernel path, and the
                  forward and backward ms of each Function;
17. ``main_path_hmc_nuts`` ``--sampler aux_hmc`` and ``aux_nuts`` (128
                  chains, dual averaging and the mass over 2 x 5 warm-up
                  steps, 5 steps; 2 x 10 + 10 until phase 36, 2 x 10 + 20
                  until phases 27-32);
                  ``path_parity_hmc_nuts`` one theta move
                  of each on the same draws through the estimator kernel and
                  its plain version: accept bits (HMC), depth, n_leapfrog
                  and the chosen point (NUTS) equal outside the margins;
18. ``main_path_smc`` ``--sampler smc`` with ``aux_slice`` rejuvenation at
                  512 particles (1024 until phases 27-32) and ``aux_nuts`` at
                  256, one rejuvenation
                  step per stage (cut from 2 to keep the script under ten
                  minutes): logZ finite, the
                  last beta 1, no sweep kernel on the tempered target, the
                  launches of kernels 1 and 2 per stage;
19. ``prng_card`` ``core/prng.py`` on the card against the golden
                  ``jax.random`` values of ``core/prng_golden.json`` (words,
                  bits, uniforms, bernoulli, randint bitwise, normals within
                  4 ulp) and against the CPU (bitwise on words and
                  uniforms), and the normals per second of one key-as-u
                  chunk's u, (256, 32, 640);
20. ``main_path_smc_sharded`` the sharded SMC on two spawned ranks sharing
                  the card (gloo) through ``rank_jobs.cli``, the three runs
                  in one spawn: (a) ``--preset smc_gp_nuts`` at 256
                  particles (the preset's 4096 cut to fit the time; 1024
                  until phases 24-26, 512 until phases 27-32), (b) the
                  blocked refresh (``--smc-u-blocks 8``, S = 64, ``aux_mh``
                  -> ``mh_theta``, one proposal per block) at 512, (c)
                  ``--smc-carry-u true`` with ``aux_slice`` at 128 (512
                  until phases 24-26, 256 until phases 27-32): logZ
                  finite, the last beta 1,
                  kernels 1 and 2 launched in (a) and (c), 6 in (b), run
                  (b)'s last-stage refresh acceptance at least the
                  reference's floor of 0.2; per stage the launches of
                  kernels 1, 2 and 6, the collectives and their ms, and the
                  threefry ms;
21. ``path_parity_smc_sharded`` one key-as-u stage of (a)'s configuration at
                  256 particles on a world of one rank, through the kernels
                  and through the plain estimator (the panel kernel shared):
                  resampling indices equal, refresh accepts and NUTS depth
                  and n_leapfrog equal outside the decision margins, theta
                  and log L-hat within the bars; then two stages of (b)'s
                  configuration with ``rejuv_dispatches`` 1 and 2 at
                  ``rejuv_batch`` 512 (chunks of 512 against 256): bitwise
                  equal;
22. ``threefry_card`` (run right after ``kernels``) the port-only kernel
                  ``csrc/threefry.cu`` against its plain version
                  ``ops/threefry.draw_plain`` on the card: words, bits,
                  uniforms (two ranges) and fold_in's words bitwise over 5
                  seeds, 4 shapes and 2 counter offsets, normals within 3 ulp,
                  the golden normals bitwise through the kernel; one
                  (256, 32, 640) normal draw and the ESS v of a config-2
                  step (128 x 4 blocked draws of (64, 640)) timed beside
                  their bounds (int32 operations or bytes); the main path
                  must launch it and reports the keyed draws' ms and
                  launches per step;
23. ``main_path_config4`` the preset ``gp_4096_sharded`` (config 4) on one
                  spawned rank at 4096 chains, 2 steps (no warm-up; 4 until
                  phases 24-26): wall per step, peak memory, launches; then
                  at 256 chains x 5 steps on that rank against two ranks
                  sharing the card (gloo; in phase 7's spawn since phases
                  27-32): records and log L-hat bitwise equal;
24. ``main_path_sharded_grad`` ``--sharded true --particle-shards 2`` with
                  ``aux_hmc`` (128 chains) and ``aux_nuts`` (64), one
                  warm-up window each, on two spawned ranks sharing the card:
                  theta, log L-hat and the step sizes bitwise equal on both
                  ranks, the two weights kernels launched and no estimator
                  or sweep kernel, 2 collectives per gradient call; then the
                  gradient at a fixed (theta, u) of 128 chains on the two
                  ranks against one process's on the card (reported; the
                  chains over 1e-4 of max(|g|, 1) counted) and against the
                  float64 gradient: on every chain no further from it than
                  one process's, plus 1e-4 of max(|g|, 1); gradient calls,
                  collectives and weights launches per step, a profiled
                  window per run;
25. ``main_path_laplace_grad`` ``--proposal laplace --n-importance 16`` with
                  ``aux_hmc`` (64 chains, 3 steps) and ``aux_nuts`` (16, 2):
                  no non-finite gradient row; ms, panel launches, jitter
                  escalations and peak memory of a gradient call; on 8
                  chains the gradient against float64 central differences
                  (step 1e-4, the plain path on the CPU) within 5 % at
                  jitter 1e-3, reported at the CLI's 1e-5;
26. ``main_path_laplace_sharded`` ``aux_slice --proposal laplace`` on two
                  spawned ranks (64 chains, 3 steps): the ranks bitwise
                  equal, only the panel and threefry kernels launched; the
                  estimate at a fixed (theta, u) within 1e-4 of one
                  process's;
27. ``main_path_stepout_theta`` ``aux_slice_rd``, ``aux_slice_joint`` and
                  ``joint_slice`` with ``--max-step-out 8`` (128 chains,
                  1 x 3 warm-up + 3): finite, moving; each estimator launch
                  recorded by its batch: the step-out probe one launch of
                  2B = 256 chains, never more; peak memory; then one step
                  from each final state on the same rows, kernels against
                  the plain estimator, ESS and sigma sweeps (panel shared):
                  decisions equal outside 2e-3 of their levels (at most 16
                  chains inside), values at ``path_parity_theta_samplers``'
                  bars;
28. ``main_path_laplace_ard`` ``--preset pima_ard_aux --proposal laplace
                  --n-importance 16`` at 32 chains, 2 steps: the ARD Gram and
                  panel kernels launched and no other of the package but
                  threefry, no non-finite estimate; the estimate at the
                  final (theta, u), jitter 1e-3, through the ARD Gram kernel
                  against the plain Gram (panel shared) within 1e-2 (half
                  log|Sigma_q|'s bar in ``main_path_laplace``) on the chains
                  whose every factorisation took the same jitter (known
                  difference 3), at least half of them; where that gap comes
                  from: the two Grams' largest entrywise gap against float32
                  rounding (a larger one fails: a fault of the kernel) and
                  each one's Laplace estimate in float64;
29. ``main_path_joint_sharded`` ``joint_mh`` and ``aux_slice_joint`` with
                  ``--sharded true --particle-shards 2`` on two spawned ranks
                  (1 x 3 + 6 steps): ranks bitwise equal, the weights
                  kernels launched (the rotated one with the ESS), no
                  estimator or sweep kernel; one keyed step of 128 chains
                  from a fixed state on the two ranks against the unsharded
                  per-probe path on the same rows: counts equal outside 1e-4
                  of the levels (at most 2 chains inside), theta and log
                  L-hat within 1e-4;
30. ``scaling_path`` ``utils/scaling`` (32 chains per rank, 2 + 5 steps) on
                  the same two ranks: the reference's keys plus
                  ``ranks_per_card`` (2: the ranks share the card, so the
                  ratio checks the code path and is not scaling
                  efficiency), both throughputs positive;
31. ``dryrun_mesh`` ``utils/dryrun.dryrun_mesh(4)`` on four spawned ranks
                  sharing the card: one ``aux_slice`` step on a 2 x 2 mesh
                  of chains by particles with finite theta, then the key-as-u
                  sharded SMC on the toy (256 particles) with the last beta
                  1, finite logZ, theta and log L-hat, u as int64 key words;
                  the ranks agree on the betas and logZ;
32. ``main_path_smc_scale`` ``utils/smc_scale`` on a world of one rank:
                  (i) the toy at 2^20 particles, ``aux_slice``, |logZ -
                  closed form| at most 0.02, beside ``SMC_1M_toy.json``;
                  (ii) config 5's GP path (Pima subsample 32, S = 32,
                  ``aux_nuts``, padded) at ``SMC_SCALE_GP_PARTICLES``: the
                  last beta 1, logZ finite, the last stage's refresh
                  acceptance at least 0.2, the estimator, panel and threefry
                  kernels launched in every stage; stage walls, peak memory,
                  the chunk; then one stage of a one-chunk population
                  profiled: its launches and host syncs;
33. ``kernels_any_shape`` the six kernels of the sweep body against their
                  plain versions at S = 72, 100 (n_blocks 1), 128 and 256
                  (B = 128, n = 640) and at n = 32, 531, 532 and 4177 (S =
                  64), the two sweeps at S = 128 and 512, at the bars
                  below; rows 64-127 of both weights kernels at S_local =
                  128 bitwise a call on those rows alone, the estimate at
                  S = 128 bitwise the weights plus the blocked fold; the
                  identity-padded factorisation at n = 532 and 4177 against
                  ``torch.linalg.cholesky_ex`` (|L L^T - K|) and the ARD Gram
                  at n = 531 and 4177 against its plain version; each with
                  its ms and bound;
34. ``main_path_s128`` config 2 with ``--n-importance 128`` (128 chains, the
                  bench settings, 1 x 3 + 6 steps): both sweeps launched,
                  no plain estimator, sweep or factorisation called on the
                  card; steps/s, peak memory; one keyed step from the final
                  state against the plain path on the same rows;
35. ``main_path_unpadded`` ``utils/smc_scale --target gp --no-pad`` at
                  n = 32 (2^14 particles, one chunk) and at the full n = 532
                  (``UNPADDED_FULL_N_PARTICLES``): the estimator, panel and
                  threefry kernels in every stage, no sweep, no plain call
                  on the card, the last beta 1, logZ finite; the unpadded
                  full-n estimate at fixed (theta, u) against the padded
                  target's at u padded with zeros;
36. ``bench_scripts`` the counterparts of the reference's measuring scripts
                  at full width and cut depth: ``utils/tau_sweep`` (its three
                  variants, 1 warm-up window and 100 steps), ``utils/
                  theta_bench`` and ``utils/ess_sweep_bench`` (10 steps a
                  run), their lines printed: no variant ``FAILED``, tau and
                  ESS finite, theta_bench's (a)/(b) parity bitwise,
                  ess_sweep_bench's shrink counts equal and its values within
                  ``ESS_SWEEP_VS_LOOP``, kernels 1-5 and T launched and no
                  plain version called on the card.

Then one line ``{"kernels": [...]}``, the ``nvidia-smi`` line, and the last
line ``{"ok": true, "device": {...}}``.  Exits non-zero without a GPU.

Tolerances (kernel vs plain version, both float32 on the card): the estimate
is a sum of n=640 O(1) terms per sample, ~-350 in total (thousands at large
sigma), taken in another order (one ulp at 350 is 3e-5): 2e-4 + 2e-6 |ll|.  The factor of a 128-tile: 5e-4, the
bar of the reference's Cholesky tests.  u' after a sweep: 1e-5.  Shrink and
moved counts must be EQUAL on every chain whose decisions all sat further
than the value tolerance from their slice level (the plain version records
the margins); a chain with a decision inside the tolerance may fall either
way and is reported, and more than two such chains fail the run.

The ARD Gram: kernel and plain version both evaluate exp(-0.5 d2) with d2
from the expansion sq_i + sq_j - 2 xs_i.xs_j in float32; d2 carries a few ulp
of its largest term, so the bar is 8 eps max(sq), computed from the inputs.
The ARD step as a whole (``path_parity_ard``): both sides build every probe's
Gram with the ARD Gram kernel (held to its plain version above) and factor it
with the panel kernel, so they see the same factor bit for bit, and the plain
side differs only in the estimator and the rotated estimator.  R(ell) at the
sampled lengthscales (ell ~5 on standardised features) is close to singular:
two builds of one Gram that differ by ~1e-6 move log L-hat by ~2e-2 through
the factor, more than the decisions' margins, which is why the Gram is shared
and not compared here.  A step is ~130 decisions per chain; a chain with a
decision inside ``ARD_DECISION_TOL`` (ten times the estimator's bar) is
excused and counted, at most ``ARD_MAX_AMBIGUOUS`` of the 64 chains; the
others must agree in every count, and log L-hat of the chains that agree
within ``ARD_PATH_LL_TOL``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
import types
from unittest import mock

B, S, N, N_ESS, N_SIGMA = 128, 64, 640, 4, 2
LL_TOL, LL_RTOL, U_TOL, CHOL_TOL, SIGMA_TOL = 2e-4, 2e-6, 1e-5, 5e-4, 1e-5
BF16_SCALED_TOL = 2e-2
PATH_CHOL_TOL, PATH_LL_TOL = 1e-2, 5e-2   # through a refactorisation
MAX_AMBIGUOUS = 2
B_ARD, D_ARD = 64, 7
K_SHARDS, S_LOCAL = 2, 32          # the particle-sharded path: two ranks
B_SPLIT = 2051      # more chains than one launch's active list (2048) holds
B_BIG, N_BIG = 8, 1024   # n above the old left-operand limit (~880)
B_WIDE = 4096       # one config-2 step at this many chains
COMBINE_RTOL = 2e-6                # weights + combine vs the fused estimate
SHARDED_LL_TOL = 1e-4              # sharded step vs the unsharded loop path
CHOL_BACK_RTOL, CHOL_INV_TOL = 1e-5, 1e-4
ARD_PATH_LL_TOL, ARD_DECISION_TOL, ARD_MAX_AMBIGUOUS = 1e-2, 2e-3, 8
TRI = N * (N + 1) // 2      # floats of a factor's lower triangle: what the
                            # estimator family must read of C
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
FP32_FLOPS = 67e12          # H100 SXM, float32 outside the tensor cores
CLI_ARGS = [
    "--preset", "pima_aux_slice", "--chains", str(B), "--max-step-out", "0",
    "--n-ess", str(N_ESS), "--n-sigma-extra", str(N_SIGMA - 1),
    "--max-shrink-chol", "3", "--warmup-windows", "2", "--window-steps", "10",
    "--steps", "20",
]
SHARDED_CLI_ARGS = [
    "--sharded", "true", "--particle-shards", str(K_SHARDS),
    "--preset", "pima_aux_slice", "--chains", str(B), "--max-step-out", "0",
    "--n-ess", str(N_ESS), "--n-sigma-extra", str(N_SIGMA - 1),
    "--max-shrink-chol", "3", "--warmup-windows", "1", "--window-steps", "3",
    "--steps", "6",
]
ARD_CLI_ARGS = [              # 1 x 5 + 10 until phases 27-32 (time)
    "--preset", "pima_ard_aux", "--warmup-windows", "1", "--window-steps", "3",
    "--steps", "6",
]
B3, N3 = 32, 1024              # config 3: abalone_aux (subsample 1024)
N_FULL = 4224                  # abalone_aux --subsample 0: 4177 -> 4224
CONFIG3_CLI_ARGS = [          # 1 x 5 + 10 until phases 27-32 (time)
    "--preset", "abalone_aux", "--warmup-windows", "1", "--window-steps", "3",
    "--steps", "6",
]
CONFIG3_MAX_AMBIGUOUS = 4      # of 32 chains, ARD_MAX_AMBIGUOUS's share
TRACE_KERNELS = ("fused_estimate_kernel", "chol_panel_kernel", "threefry_kernel",
                 "ess_sweep_kernel")
MH_CLI_ARGS = [                # pm_mh / aux_mh on config 2's target
    "--preset", "pima_aux_slice", "--chains", str(B), "--warmup-windows", "1",
    "--window-steps", "10", "--steps", "20",
]
TOY_CLI_ARGS = [
    "--preset", "toy_pm_mh", "--warmup-windows", "1", "--window-steps", "50",
    "--steps", "200",
]
K_RESUME = 3                   # resume_bitwise: 2K steps vs K + load + K
THETA_SAMPLERS = {             # sampler -> the info key of its theta move
    "aux_slice_rd": "slice_theta/moved",
    "aux_slice_pcrd": "slice_theta_rd/moved",
    "aux_slice_joint": "joint_slice/moved",
    "joint_slice": "joint_slice/moved",
    "joint_mh": "joint_mh/accept",
}
THETA_CLI_ARGS = CLI_ARGS[:-6] + [
    "--warmup-windows", "1", "--window-steps", "5", "--steps", "10"]
THETA_MAX_AMBIGUOUS = 16       # of 128 chains, CONFIG3_MAX_AMBIGUOUS's share
S_LAPLACE, LAPLACE_JITTER = 16, 1e-3
LAPLACE_CLI_ARGS = [
    "--preset", "pima_aux_slice", "--proposal", "laplace", "--n-importance",
    str(S_LAPLACE), "--chains", str(B), "--warmup-windows", "1",
    "--window-steps", "2", "--steps", "2",   # 1 x 3 + 6 before 27-32
]
LAPLACE_F_TOL, LAPLACE_CHOL_TOL, LAPLACE_LOGDET_TOL = 1e-3, 5e-3, 1e-2
GRAD_RTOL = 5e-2               # kernel vs plain forwards, of max(|g|, 1)
FD_STEP, FD_RTOL = 1e-2, 5e-2  # the reference's finite-difference check
FD_N, FD_S = 32, 8             # ... at the reference's size (n=32 -> 128)
FD_STEP_F64, FD_F64_RTOL = 1e-4, 1e-3  # float64 differences at full width
HMC_WINDOW = 5                 # 10 before phase 36 (time)
HMC_CLI_ARGS = [               # aux_hmc / aux_nuts on config 2's target
    "--preset", "pima_aux_slice", "--chains", str(B), "--warmup-windows", "2",
    "--window-steps", str(HMC_WINDOW), "--steps", str(HMC_WINDOW),
]                              # 2 x HMC_WINDOW sampled steps before
                               # phases 27-32
HMC_DECISION_TOL = 5e-3        # accept margin |delta H - log u|, and the
                               # takes' |u - p|: twice the estimator's bar
UTURN_DECISION_TOL = 1e-6      # U-turn dot over its norms
GRAD_PATH_THETA_TOL = 1e-6     # theta after a trajectory, same gradients
SMC_RUNS = (("aux_slice", 512), ("aux_nuts", 256))   # rejuvenation, particles
                                # (aux_slice at 1024 before 27-32)
SMC_CLI_ARGS = ["--preset", "pima_aux_slice", "--sampler", "smc",
                "--smc-n-mcmc", "1"]   # depth cut from 2 (script time)
PRNG_CHUNK = (256, 32, 640)    # one key-as-u chunk's u: particles, S, n
PRNG_ULP = 4                   # normals vs jax.random
THREEFRY_SEEDS = (0, 7, 42, 2**31 + 5, 123456789)
THREEFRY_ULP = 3               # kernel vs plain normals (two log1pf)
# int32 operations of one cipher call as csrc/threefry.cu writes it: x1's
# first add (x0 starts at 0, so its add is a move), 20 rounds of add, rotate
# (one funnel shift) and xor (60), five key injections of one add to x0 and
# one three-input add to x1 (10); then per word y0 ^ y1 (bits) and the
# mantissa's shift and or (uniform, normal).  The float32 work of a normal
# (~35 instructions of log1pf, Horner and scale) goes to the float pipe,
# twice as wide, and takes under a quarter of the int32 time.
THREEFRY_INT_OPS = 71
THREEFRY_OUT_OPS = {"words": 0, "bits": 1, "uniform": 3, "normal": 3}
INT32_OPS = 132 * 64 * 1.98e9  # H100 SXM: SMs x INT32 lanes x boost clock
SMC_SHARDED_RUNS = {           # run -> (args, kernels that must launch);
    # particles of (a) and (c) halved for phases 24-26 and again for 27-32
    "a_smc_gp_nuts": (["--preset", "smc_gp_nuts", "--particles", "256"],
                      ("fused_estimator", "chol_panel")),
    "b_u_blocks": (["--preset", "smc_gp_nuts", "--smc-u-blocks", "8",
                    "--n-importance", "64", "--smc-rejuvenation", "aux_mh",
                    "--smc-n-u-mh", "1", "--particles", "512"],
                   ("fused_weights",)),
    "c_carry_u": (["--sharded", "true", "--sampler", "smc",
                   "--smc-rejuvenation", "aux_slice", "--particles", "128"],
                  ("fused_estimator", "chol_panel")),
}
U_BLOCKS_ACCEPT_FLOOR = 0.2    # the reference's floor (tests/test_smc.py)
SMC_PARITY_PARTICLES, SMC_PARITY_S = 256, 32
CONFIG4_CHAINS, CONFIG4_STEPS = 4096, 2
CONFIG4_CLI_ARGS = [           # the preset; depth cut: no warm-up, 2 steps
                               # (4 until the gradient phases took the time;
                               # the summary's split R-hat needs 2)
    "--preset", "gp_4096_sharded", "--warmup-windows", "0",
    "--window-steps", "2", "--steps", str(CONFIG4_STEPS)]
CONFIG4_SMALL_CHAINS, CONFIG4_SMALL_STEPS = 256, 5
CONFIG4_SMALL_ARGS = [         # 1 rank against 2 sharing the card
    "--preset", "gp_4096_sharded", "--chains", str(CONFIG4_SMALL_CHAINS),
    "--warmup-windows", "0", "--window-steps", str(CONFIG4_SMALL_STEPS),
    "--steps", str(CONFIG4_SMALL_STEPS)]
SMC_MAX_AMBIGUOUS = 64         # of 256 particles: each takes two refresh
                               # decisions and two NUTS trees, ~4x the
                               # decisions of a chain in path_parity_hmc_nuts
SHARDED_GRAD_RUNS = {          # sampler -> chains, window steps, steps,
    "aux_hmc": (B, 3, 6, 1),   # profiled steps: one warm-up window (the
    "aux_nuts": (64, 3, 3, 1),  # CLI's window length is shared by warm-up
}                              # and sampling; aux_hmc profiled 2 steps
                               # before phases 27-32)
SHARDED_GRAD_RTOL = 1e-4       # 2 ranks vs 1, of max(|g|, 1)
LAPLACE_GRAD_RUNS = {"aux_hmc": (64, 3), "aux_nuts": (16, 2)}   # no warm-up
LAPLACE_GRAD_STEP = 0.05       # of the order dual averaging finds (0.064)
LAPLACE_FD_CHAINS = 8          # float64 differences on the CPU
LAPLACE_SHARDED_CHAINS, LAPLACE_SHARDED_STEPS = 64, 3
STEPOUT_SAMPLERS = ("aux_slice_rd", "aux_slice_joint", "joint_slice")
STEPOUT_STEPS = 3 + 3          # 1 x 3 warm-up + 3
STEPOUT_CLI_ARGS = [           # THETA_CLI_ARGS with stepping out on
    "--preset", "pima_aux_slice", "--chains", str(B), "--max-step-out", "8",
    "--n-ess", str(N_ESS), "--n-sigma-extra", str(N_SIGMA - 1),
    "--max-shrink-chol", "3", "--warmup-windows", "1", "--window-steps", "3",
    "--steps", "3"]
LAPLACE_ARD_CHAINS, LAPLACE_ARD_STEPS = 32, 2   # no warm-up
LAPLACE_ARD_CLI_ARGS = [
    "--preset", "pima_ard_aux", "--proposal", "laplace", "--n-importance",
    str(S_LAPLACE), "--chains", str(LAPLACE_ARD_CHAINS), "--warmup-windows",
    "0", "--window-steps", str(LAPLACE_ARD_STEPS), "--steps",
    str(LAPLACE_ARD_STEPS)]
JOINT_SHARDED_SAMPLERS = ("joint_mh", "aux_slice_joint")
DRYRUN_RANKS = 4
SCALING_ARGS = ["--chains-per-device", "32", "--warm", "2", "--steps", "5"]
SMC_SCALE_TOY_BATCH = 2**16    # the toy's u is 128 B: 16 chunks of 2^20
SMC_SCALE_GP_PARTICLES = 2**17   # 16.6 s in 8 chunks of 2^14 (2^18:
                                 # 34.6 s until phases 33-35; 2^20: 0.61-
                                 # 0.73 s a chunk)
SMC_SCALE_GP_BATCH = 2**14
SMC_SCALE_RUNS = {             # utils/smc_scale argv
    "toy": ["--target", "toy", "--particles", str(2**20), "--rejuv",
            "aux_slice", "--rejuv-batch", str(SMC_SCALE_TOY_BATCH)],
    "gp": ["--target", "gp", "--subsample", "32", "--n-importance", "32",
           "--rejuv", "aux_nuts", "--particles", str(SMC_SCALE_GP_PARTICLES),
           "--rejuv-batch", str(SMC_SCALE_GP_BATCH)],
}
# every shape the reference runs (phases 33-35)
ANY_S = (72, 100, 128, 256)    # importance samples past one 64-row block
                               # (100: n_blocks 1), B = 128, n = 640
ANY_N_CHAINS = {32: 128, 531: 128, 532: 128, 4177: 8}   # n off the tiles
SWEEP_ANY_S = (128, 512)       # both sweeps, B = 128, n = 640
CHOL_ANY_N = {532: 128, 4177: 8}   # n: chains, identity-padded v3 route
GRAM_ANY_N = {531: 64, 4177: 8}    # n: chains, the ARD Gram off 4
S128_CHAINS, S128_STEPS = B, 3 + 6
S128_CLI_ARGS = [              # config 2 at S = 128 with the bench settings
    "--preset", "pima_aux_slice", "--n-importance", "128", "--chains",
    str(S128_CHAINS), "--max-step-out", "0", "--n-ess", str(N_ESS),
    "--n-sigma-extra", str(N_SIGMA - 1), "--max-shrink-chol", "3",
    "--warmup-windows", "1", "--window-steps", "3", "--steps", "6"]
UNPADDED_FULL_N_PARTICLES = 2**12   # the largest power of two within ~30 s
UNPADDED_RUNS = {              # utils/smc_scale argv, --no-pad
    "n32": ["--target", "gp", "--no-pad", "--subsample", "32",
            "--particles", str(2**14), "--rejuv-batch", str(2**14)],
    "full_n": ["--target", "gp", "--no-pad", "--subsample", "0",
               "--particles", str(UNPADDED_FULL_N_PARTICLES),
               "--rejuv-batch", str(UNPADDED_FULL_N_PARTICLES)],
}
SMC_SCALE_TOY_LOGZ_TOL = 0.02  # |logZ - closed form| at 2^20 particles
BENCH_TAU = {"chains": 128, "steps": 100, "warm_windows": 1}  # tau_sweep cut
BENCH_AB_STEPS = 10            # theta_bench's and ess_sweep_bench's AB_STEPS
# ess_sweep_bench's sweep against its per-probe path: the bars of every
# sweep-against-plain check above (u' U_TOL, log L-hat LL_TOL + LL_RTOL
# |ll|); the two paths differ by about an ulp (ROADMAP known difference 5)
ESS_SWEEP_VS_LOOP = {"u": U_TOL, "ll": LL_TOL, "ll_rtol": LL_RTOL}
BENCH_KERNELS = ("fused_estimator", "chol_panel", "ess_sweep", "sigma_sweep",
                 "fused_estimator_rot", "threefry")   # kernels 1-5 and T
SMC_1M_TOY_RECORD = {          # the reference's SMC_1M_toy.json
    "log_z": -3.5603, "log_z_true": -3.5588, "log_z_abs_err": 0.0015,
    "betas": [0.0, 0.2144, 1.0], "u_mh_accept": [0.8402, 0.67]}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


_T0 = time.time()


def emit(obj):
    """One JSON line; a phase's line also gets its seconds since start."""
    if "phase" in obj:
        obj = {**obj, "at_s": round(time.time() - _T0, 1)}
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def bound(bytes_moved, flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def main():
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this script "
            "needs one NVIDIA GPU")
        return 1

    import numpy as np

    from auxpm_tpu_torch import run as port_run
    from auxpm_tpu_torch.models.datasets import load
    from auxpm_tpu_torch.models.gp_classification import make_gp_classification
    from auxpm_tpu_torch.ops import _build, chol_hopper, cholesky
    from auxpm_tpu_torch.ops import ess_sweep as ess
    from auxpm_tpu_torch.ops import fused_estimator as fe
    from auxpm_tpu_torch.ops import gram as gr
    from auxpm_tpu_torch.ops import sigma_sweep as sig
    from auxpm_tpu_torch.ops.gram import se_gram_iso
    from auxpm_tpu_torch.samplers.chain import run_chains
    from auxpm_tpu_torch.samplers.composite import SAMPLERS
    from auxpm_tpu_torch.utils.profiling import launch_counters, profile_steps

    dev = torch.device("cuda")
    t_start = time.time()

    # ---------------------------------------------------------------- device
    smi = nvidia_smi_line()
    t0 = time.time()
    lib_path = _build.build(force=True)
    _build.load_library()
    build_s = time.time() - t0
    emit({"phase": "device", "card": smi, "kind": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "library": str(lib_path.relative_to(lib_path.parents[1])),
          "build_seconds": round(build_s, 2)})

    flush_buf = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)

    def time_ms(fn, reps=5):
        """Median milliseconds of ``fn`` over ``reps`` launches, each after a
        256 MB write that evicts the 50 MB L2."""
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            flush_buf.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    def t(a):
        return torch.as_tensor(np.array(a, dtype=np.float32), device=dev)

    def max_err(a, b):
        return float((a - b).abs().max())

    # ---------------------------------------------------------------- inputs
    rng = np.random.default_rng(2026)
    x, y_np = load("pima")
    target = make_gp_classification(x, y_np, n_importance=S, device="cuda")
    assert target.u_shape == (S, N)
    y = t(np.concatenate([y_np, np.ones(N - len(y_np))]))
    mask = t(np.concatenate([np.ones(len(y_np)), np.zeros(N - len(y_np))]))
    theta = t(rng.normal(size=(B, 2)) * 0.5)
    sqdist = t(_pima_sqdist(np, x, N))
    gram = se_gram_iso(sqdist, theta[:, 0], 0.0, 1e-5)        # (B, n, n)
    chol_r = torch.linalg.cholesky(gram).contiguous()          # inputs only
    assert torch.isfinite(chol_r).all()
    chol = torch.exp(theta[:, 1])[:, None, None] * chol_r
    u = t(rng.standard_normal((B, S, N)))

    def ambiguous_chains(probe_log, tol):
        amb = torch.zeros_like(probe_log[0][0], dtype=torch.bool)
        for active, margin in probe_log:
            amb |= active & (margin.abs() <= tol)
        return amb

    def check_counts(name, pairs, amb):
        n_amb = int(amb.sum())
        if n_amb > MAX_AMBIGUOUS:
            failures.append(f"{name}: {n_amb} chains had a decision within "
                            "tolerance of its slice level")
        for what, k, p in pairs:
            if not torch.equal(k[~amb], p[~amb]):
                bad = int((k[~amb] != p[~amb]).sum())
                failures.append(f"{name}: {what} differs on {bad} chains")
        return n_amb

    failures = []   # checked after each phase's line is printed

    def check_close(name, what, k, p, tol, keep=None, rtol=0.0):
        """Record a failure unless |k - p| <= tol + rtol |p| everywhere;
        returns the largest absolute difference."""
        if keep is not None:
            k, p = k[keep], p[keep]
        err = max_err(k, p)
        within = bool(((k - p).abs() <= tol + rtol * p.abs()).all())
        if not within or not bool(torch.isfinite(k).all()):
            failures.append(f"{name}: {what} max abs err {err:.3e} exceeds "
                            f"{tol} + {rtol} |ref|")
        return err

    def end_phase():
        if failures:
            raise AssertionError("; ".join(failures))

    kernels = {}

    # ------------------------------------------------------- fused estimator
    log("kernels: fused estimator")
    variants = {}
    for lik, wd in (("logistic", "float32"), ("probit", "float32"),
                    ("logistic", "bfloat16")):
        k_out = fe.fused_estimate(chol, u, y, mask, lik, 8, None, wd)
        p_out = fe._ref_estimate(chol, u, y, mask, lik, 8, None, wd)
        torch.cuda.synchronize()
        variants[f"{lik}/{wd}"] = check_close("fused_estimator", f"{lik}/{wd}",
                                              k_out, p_out, LL_TOL, rtol=LL_RTOL)
        if lik == "logistic" and wd == "float32":
            est_full = k_out
    # the same chains at B=1, B=3 and more chains than the grid has blocks
    # (the 128 repeated): one round of the sweep body, each chain's fold in
    # a fixed order, so bitwise the B=128 result
    grid = ess.sweep_grid()
    est_batches = {}
    for nb_ in (1, 3, grid + 8):
        idx = torch.arange(nb_, device=dev) % B
        est_batches[f"B={nb_}"] = bool(torch.equal(fe.fused_estimate(
            chol[idx].contiguous(), u[idx].contiguous(), y, mask, "logistic",
            8), est_full[idx]))
    if not all(est_batches.values()):
        failures.append(f"fused_estimator: batches differ {est_batches}")
    # n above the old shared-memory limit of the left operand (~880)
    n_big = 1024
    chol_big = t(np.tril(rng.standard_normal((8, n_big, n_big)) * 0.03)
                 + np.eye(n_big))
    u_big = t(rng.standard_normal((8, S, n_big)))
    y_big = t(rng.choice([-1.0, 1.0], n_big))
    mask_big = t((np.arange(n_big) < n_big - 37).astype(np.float32))
    variants[f"B=8 n={n_big}"] = check_close(
        "fused_estimator", f"n={n_big}",
        fe.fused_estimate(chol_big, u_big, y_big, mask_big, "logistic", 8),
        fe._ref_estimate(chol_big, u_big, y_big, mask_big, "logistic", 8),
        LL_TOL, rtol=LL_RTOL)
    del chol_big, u_big
    est64 = [a[:B_ARD].contiguous() for a in (chol, u)]
    b_ms, b_by = bound(4 * (B * (TRI + S * N) + 2 * N + B),
                       B * fe.probe_flops(S, N))
    kernels["fused_estimator"] = {
        "name": "fused_estimator", "route": "cuda",
        "source": "auxpm_tpu_torch/csrc/fused_estimator.cu",
        "replaces": "auxpm_tpu/ops/fused_estimator.py:265",
        "max_abs_err": variants["logistic/float32"], "tol": LL_TOL,
        "variants_max_abs_err": variants,
        "batches_bitwise_equal": est_batches, "grid_blocks": grid,
        "ms": time_ms(lambda: fe.fused_estimate(chol, u, y, mask, "logistic", 8)),
        "plain_ms": time_ms(lambda: fe._ref_estimate(chol, u, y, mask,
                                                     "logistic", 8)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "ms_B64": time_ms(lambda: fe.fused_estimate(*est64, y, mask,
                                                     "logistic", 8)),
        "bound_ms_B64": bound(4 * (B_ARD * (TRI + S * N) + 2 * N + B_ARD),
                              B_ARD * fe.probe_flops(S, N))[0],
    }

    # ------------------------------------------------------- Cholesky panel
    log("kernels: Cholesky panel")
    tiles = gram[:, :128, :128].contiguous()
    l_k, xt_k = chol_hopper.chol_panel_batched3(tiles)
    l_p, xt_p = chol_hopper._ref_chol_panel(tiles)
    torch.cuda.synchronize()
    err_l = check_close("chol_panel", "L", l_k, l_p, CHOL_TOL)
    eye = torch.eye(128, device=dev)
    resid = max_err(torch.bmm(xt_k.mT, l_k), eye.expand(B, 128, 128))
    resid_plain = max_err(torch.bmm(xt_p.mT, l_p), eye.expand(B, 128, 128))
    inv_scale = float(xt_p.abs().max())
    # inv(L) L = I to the reference test's 2e-4, scaled by the size of the
    # inverse's entries on these tiles
    if not resid <= 2e-4 * max(1.0, inv_scale):
        raise AssertionError(f"chol_panel: |inv(L) L - I| = {resid:.3e}")
    if float(torch.triu(l_k, 1).abs().max()) != 0.0 or \
            float(torch.tril(xt_k, -1).abs().max()) != 0.0:
        raise AssertionError("chol_panel: L not lower or inv(L)^T not upper")
    # NaN contract: an indefinite tile fails alone, as NaN on L's diagonal
    sick = tiles.clone()
    sick[5] -= 0.5 * eye
    # ... and from the failing column on: a tile whose pivot at column c is
    # made -0.5 has a finite diagonal before c and NaN from c on
    l64 = torch.linalg.cholesky(tiles[7].double())
    bad_at = {}
    for c_ in (40, 100):
        bad_at[c_] = tiles[7:8].clone()
        bad_at[c_][0, c_, c_] = float((l64[c_, :c_] ** 2).sum() - 0.5)

    def nan_contract_holds(panel_l):
        """``panel_l``: tiles -> L, one of the three panel modes."""
        d_s = torch.diagonal(panel_l(sick), dim1=-2, dim2=-1)
        if not bool(torch.isnan(d_s[5]).any()) or \
                not bool(torch.isfinite(torch.cat([d_s[:5], d_s[6:]])).all()):
            return False
        for c_, bad in bad_at.items():
            d_b = torch.diagonal(panel_l(bad)[0])
            if not (bool(torch.isfinite(d_b[:c_]).all())
                    and bool(torch.isnan(d_b[c_:]).all())):
                return False
        return True

    if not nan_contract_holds(lambda a: chol_hopper.chol_panel_batched3(a)[0]):
        raise AssertionError("chol_panel: NaN contract broken")
    # the same tiles at B=1, B=3 and more tiles than the sweep's cooperative
    # grid has blocks (the 128 repeated): bitwise the B=128 result
    panel_batches = {}
    for nb_ in (1, 3, 2 * B + 17):
        idx = torch.arange(nb_, device=dev) % B
        l_b, xt_b = chol_hopper.chol_panel_batched3(tiles[idx].contiguous())
        panel_batches[f"B={nb_}"] = bool(torch.equal(l_b, l_k[idx])
                                         and torch.equal(xt_b, xt_k[idx]))
    if not all(panel_batches.values()):
        failures.append(f"chol_panel: batches differ {panel_batches}")
    # the blocked factorisation at the main path's shape.  Two f32 factorisations of
    # a Gram with condition number up to ~1e7 differ elementwise by far more
    # than any fixed bar, so it is held to the backward error
    # |L L^T - K| (entries of K are <= 1) on the matrices it factors, and a
    # matrix it fails on (NaN) must be one robust_cholesky repairs.
    l_drv = chol_hopper.cholesky_batched3(gram)
    ok_drv = torch.isfinite(torch.diagonal(l_drv, dim1=-2, dim2=-1)).all(-1)
    n_failed = int((~ok_drv).sum())
    if n_failed > B // 4:
        raise AssertionError(f"cholesky_batched3 failed on {n_failed} of {B}")
    back_drv = max_err(torch.bmm(l_drv[ok_drv], l_drv[ok_drv].mT), gram[ok_drv])
    back_lib = max_err(torch.bmm(chol_r, chol_r.mT), gram)
    if not back_drv <= 1e-4:
        raise AssertionError(f"cholesky_batched3: |L L^T - K| = {back_drv:.3e}")
    diff_drv = max_err(l_drv[ok_drv], chol_r[ok_drv])
    l_r, extra = cholesky._robust_cholesky_impl(gram, jitter0=1e-5)
    if not bool(torch.isfinite(l_r).all()) or \
            not torch.equal(extra > 0, ~ok_drv):
        raise AssertionError("robust_cholesky: did not repair exactly the "
                             "matrices the blocked factorisation failed on")
    # escalation is per matrix: make one healthy matrix indefinite
    h = int(torch.nonzero(extra == 0)[0])
    sick_gram = gram.clone()
    lam = float(torch.linalg.eigvalsh(gram[h].double())[0])
    sick_gram[h] -= (lam + 3e-4) * torch.eye(N, device=dev)
    l_s2, extra_s = cholesky._robust_cholesky_impl(sick_gram, jitter0=1e-5)
    others = torch.arange(B, device=dev) != h
    if not bool(torch.isfinite(l_s2).all()) or float(extra_s[h]) <= 0 or \
            not torch.equal(extra_s[others], extra[others]):
        raise AssertionError("robust_cholesky: escalation not per matrix")
    b_ms, b_by = bound(4 * 3 * B * 128 * 128, B * 2 * 128**3 / 3.0)
    kernels["chol_panel"] = {
        "name": "chol_panel_v3", "route": "cuda",
        "source": "auxpm_tpu_torch/csrc/chol_panel.cu",
        "replaces": "auxpm_tpu/ops/chol_pallas.py:451",
        "max_abs_err": err_l, "tol": CHOL_TOL,
        "inverse_residual": resid, "plain_inverse_residual": resid_plain,
        "blocked_backward_err": back_drv, "library_backward_err": back_lib,
        "blocked_vs_library_max_abs_diff": diff_drv,
        "blocked_failed_before_escalation": n_failed,
        "batches_bitwise_equal": panel_batches,
        "ms": time_ms(lambda: chol_hopper.chol_panel_batched3(tiles)),
        "plain_ms": time_ms(lambda: chol_hopper._ref_chol_panel(tiles)),
        "bound_ms": b_ms, "bound_by": b_by,
        # one PyTorch call for the same tiles (the factor only, no inverse)
        "library_ms": time_ms(lambda: torch.linalg.cholesky(tiles)),
        "blocked_ms": time_ms(lambda: chol_hopper.cholesky_batched3(gram), 3),
        "blocked_library_ms": time_ms(lambda: torch.linalg.cholesky(gram), 3),
    }

    # ------------------------------------------------------------ ESS sweep
    log("kernels: ESS sweep")
    v = t(rng.standard_normal((B, N_ESS, S, N)))
    scal_np = np.zeros((B, N_ESS, 3 + 32), np.float32)
    scal_np[:, :, 1] = np.log(rng.uniform(size=(B, N_ESS)))
    scal_np[:, :, 2] = rng.uniform(size=(B, N_ESS)) * 2.0 * np.pi
    scal_np[:, :, 3:] = rng.uniform(size=(B, N_ESS, 32))
    ess_err = {}
    for lik in ("logistic", "probit"):
        scal = t(scal_np)
        scal[:, 0, 0] = fe._ref_estimate(chol, u, y, mask, lik, 8)
        probe_log = []
        u_k, ll_k, ns_k, mv_k = ess.ess_sweep(chol, u, scal, v, y, mask, lik,
                                              8, None, N_ESS)
        u_p, ll_p, ns_p, mv_p = ess._ref_ess_sweep(
            chol, u, scal, v, y, mask, lik, 8, None, N_ESS, "float32",
            probe_log=probe_log)
        torch.cuda.synchronize()
        amb = ambiguous_chains(probe_log, LL_TOL)
        n_amb = check_counts("ess_sweep", [("n_shrink", ns_k, ns_p),
                                           ("moved", mv_k, mv_p)], amb)
        if lik == "logistic":
            ambig_full = amb
        ess_err[lik] = {
            "u": check_close("ess_sweep", "u'", u_k, u_p, U_TOL, ~amb),
            "ll": check_close("ess_sweep", f"ll ({lik})", ll_k, ll_p, LL_TOL,
                              ~amb, LL_RTOL),
            "ambiguous_chains": n_amb,
            "probes": float(ns_p.sum()) + B * N_ESS,
            "moved": float(mv_p.sum()),
        }
        if lik == "logistic":
            scal_logistic = scal
            sweep_full = (u_k, ll_k, ns_k, mv_k)
            rounds = int(ess.last_rounds.item())
            chain_probes = ns_k + N_ESS
            if rounds != int(chain_probes.max()):
                failures.append(f"ess_sweep: {rounds} rounds, but the most "
                                f"probes of a chain is {chain_probes.max()}")
    probes = ess_err["logistic"]["probes"]
    # the same chains at other batch sizes: B=1, B=3 and more chains than the
    # cooperative grid has blocks (the 128 chains repeated).  A chain's result
    # does not depend on the others in its launch (each work item has one
    # fixed order), so it must equal the B=128 result bitwise.
    odd = {}
    for nb_ in (1, 3, grid + 8):
        idx = torch.arange(nb_, device=dev) % B
        args_ = [a[idx].contiguous() for a in (chol, u, scal_logistic, v)]
        out_k = ess.ess_sweep(*args_[:2], args_[2], args_[3], y, mask,
                              "logistic", 8, None, N_ESS)
        out_p = ess._ref_ess_sweep(*args_, y, mask, "logistic", 8, None,
                                   N_ESS, "float32")
        torch.cuda.synchronize()
        same = all(torch.equal(k_, f_[idx]) for k_, f_ in zip(out_k,
                                                               sweep_full))
        # the chains excused at B=128 are the ones excused here
        amb = ambig_full[idx]
        check_counts(f"ess_sweep B={nb_}", [
            ("n_shrink", out_k[2], out_p[2]), ("moved", out_k[3], out_p[3])],
            amb)
        odd[f"B={nb_}"] = {
            "bitwise_equal_to_B128": same,
            "u": check_close("ess_sweep", f"u' B={nb_}", out_k[0], out_p[0],
                             U_TOL, ~amb),
            "ll": check_close("ess_sweep", f"ll B={nb_}", out_k[1], out_p[1],
                              LL_TOL, ~amb, LL_RTOL),
            "rounds": int(ess.last_rounds.item())}
        if not same:
            failures.append(f"ess_sweep: B={nb_} differs from the same "
                            "chains at B=128")
    # more chains than one launch's active list holds: the wrapper splits
    # the call into slices of at most MAX_CHAINS, each chain bitwise its
    # B=128 result
    idx_split = torch.arange(B_SPLIT, device=dev) % B
    ess.launches = 0
    out_split = ess.ess_sweep(*(a[idx_split].contiguous() for a in (
        chol, u, scal_logistic, v)), y, mask, "logistic", 8, None, N_ESS)
    split_launches = ess.launches
    torch.cuda.synchronize()
    ess_split = {"B": B_SPLIT, "bitwise_equal_to_B128": all(
        torch.equal(k_, f_[idx_split]) for k_, f_ in zip(out_split,
                                                         sweep_full)),
        "rounds": int(ess.last_rounds.item())}
    del out_split
    if not ess_split["bitwise_equal_to_B128"]:
        failures.append(f"ess_sweep: B={B_SPLIT} differs from the same "
                        "chains at B=128")
    # n above the old shared-memory limit of the left operand (~880)
    big = _big_inputs(np, t, N_BIG)
    scal_big = t(np.concatenate([
        np.zeros((B_BIG, N_ESS, 1), np.float32),
        np.log(big["rng"].uniform(size=(B_BIG, N_ESS, 1))),
        big["rng"].uniform(size=(B_BIG, N_ESS, 1)) * 2.0 * np.pi,
        big["rng"].uniform(size=(B_BIG, N_ESS, 32))], axis=2))
    scal_big[:, 0, 0] = fe._ref_estimate(big["chol"], big["u"], big["y"],
                                         big["mask"], "logistic", 8)
    probe_log = []
    out_k = ess.ess_sweep(big["chol"], big["u"], scal_big, big["v"],
                          big["y"], big["mask"], "logistic", 8, None, N_ESS)
    out_p = ess._ref_ess_sweep(big["chol"], big["u"], scal_big, big["v"],
                               big["y"], big["mask"], "logistic", 8, None,
                               N_ESS, "float32", probe_log=probe_log)
    torch.cuda.synchronize()
    amb = ambiguous_chains(probe_log, LL_TOL)
    ess_big = {
        "B": B_BIG, "S": S, "n": N_BIG,
        "ambiguous_chains": check_counts(
            f"ess_sweep n={N_BIG}", [("n_shrink", out_k[2], out_p[2]),
                                     ("moved", out_k[3], out_p[3])], amb),
        "u": check_close("ess_sweep", f"u' n={N_BIG}", out_k[0], out_p[0],
                         U_TOL, ~amb),
        "ll": check_close("ess_sweep", f"ll n={N_BIG}", out_k[1], out_p[1],
                          LL_TOL, ~amb, LL_RTOL),
        "moved": float(out_p[3].sum()), "shrinks": float(out_p[2].sum())}
    # every chain to the 32-shrink cap at full width: the state is kept
    # bitwise, 33 probes per chain, 33 rounds
    scal_cap = scal_logistic.clone()
    scal_cap[:, :, 1] = 1e4
    u_c, ll_c, ns_c, mv_c = ess.ess_sweep(chol, u, scal_cap[:, :1].contiguous(),
                                          v[:, :1].contiguous(), y, mask,
                                          "logistic", 8, None, 1)
    torch.cuda.synchronize()
    cap_rounds = int(ess.last_rounds.item())
    if not (torch.equal(u_c, u) and torch.equal(ll_c, scal_cap[:, 0, 0])
            and bool((ns_c == 32).all()) and bool((mv_c == 0).all())
            and cap_rounds == 33):
        failures.append("ess_sweep: cap-hit at B=128 did not keep the state")
    b_ms, b_by = bound(
        4 * B * (TRI + (2 + N_ESS) * S * N + N_ESS * 35 + 4),
        probes * fe.probe_flops(S, N))
    half = slice(0, B_ARD)
    sweep64 = [a[half].contiguous() for a in (chol, u, scal_logistic, v)]
    kernels["ess_sweep"] = {
        "name": "ess_sweep", "route": "cuda",
        "source": "auxpm_tpu_torch/csrc/ess_sweep.cu",
        "replaces": "auxpm_tpu/ops/ess_sweep.py:156",
        "max_abs_err": ess_err["logistic"]["ll"], "tol": LL_TOL,
        "u_max_abs_err": ess_err["logistic"]["u"], "u_tol": U_TOL,
        "variants": ess_err, "probes": probes,
        "probes_max_chain": int(chain_probes.max()),
        "probes_mean_chain": float(chain_probes.mean()),
        "rounds": rounds, "grid_blocks": grid, "batches": odd,
        "split": ess_split, "launches_split": split_launches, "n1024": ess_big,
        "cap_hit_rounds_B128": cap_rounds,
        "ms": time_ms(lambda: ess.ess_sweep(chol, u, scal_logistic, v, y, mask,
                                            "logistic", 8, None, N_ESS), 3),
        "plain_ms": time_ms(lambda: ess._ref_ess_sweep(
            chol, u, scal_logistic, v, y, mask, "logistic", 8, None, N_ESS,
            "float32"), 3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "ms_B64": time_ms(lambda: ess.ess_sweep(*sweep64, y, mask, "logistic",
                                                8, None, N_ESS), 3),
        # all 128 chains active in every round (the cap-hit rows: 33 rounds,
        # no u' rewrite)
        "ms_cap_hit_B128_R1": time_ms(lambda: ess.ess_sweep(
            chol, u, scal_cap[:, :1].contiguous(), v[:, :1].contiguous(), y,
            mask, "logistic", 8, None, 1), 3),
        "bound_ms_B64": bound(
            4 * B_ARD * (TRI + (2 + N_ESS) * S * N + N_ESS * 35 + 4),
            (float(chain_probes[half].sum())) * fe.probe_flops(S, N))[0],
        "probes_B64": float(chain_probes[half].sum()),
    }

    # ---------------------------------------------------------- sigma sweep
    log("kernels: sigma sweep")
    rep = t(rng.uniform(size=(B, N_SIGMA, 2 + 32)))
    rep[:, :, 0] = torch.log(rep[:, :, 0])
    hiv = 0.5 / 1.5**2
    sig_err = {}
    for wd in ("float32", "bfloat16"):
        ll0 = fe._ref_estimate(chol, u, y, mask, "logistic", 8, None, wd)
        d0 = theta[:, 1]
        lp_rest = target.log_prior(theta) + hiv * d0 * d0
        chain = torch.stack(
            [ll0, target.log_prior(theta) + ll0, theta[:, 1],
             torch.full_like(ll0, 1.2), torch.zeros_like(ll0),
             torch.full_like(ll0, hiv), lp_rest, torch.zeros_like(ll0)],
            dim=1).contiguous()
        probe_log = []
        out_k = sig.sigma_sweep(chol_r, u, chain, rep, y, mask, "logistic", 8,
                                None, N_SIGMA, wd)
        out_p = sig._ref_sigma_sweep(chol_r, u, chain, rep, y, mask,
                                     "logistic", 8, None, N_SIGMA, wd,
                                     probe_log=probe_log)
        torch.cuda.synchronize()
        # bfloat16: exp(x) from expf and from torch.exp may differ by an ulp,
        # which moves a few of the n*n scaled elements across a bf16 rounding
        # boundary (a 2^-8 relative step each): a looser bar, stated
        ll_tol = LL_TOL if wd == "float32" else BF16_SCALED_TOL
        amb = ambiguous_chains(probe_log, ll_tol)
        n_amb = check_counts("sigma_sweep", [("n_shrink", out_k[3], out_p[3]),
                                             ("moved", out_k[4], out_p[4])],
                             amb)
        sig_err[wd] = {
            "sigma": check_close("sigma_sweep", "sigma'", out_k[0], out_p[0],
                                 SIGMA_TOL, ~amb),
            "ll": check_close("sigma_sweep", f"ll ({wd})", out_k[1], out_p[1],
                              ll_tol, ~amb, LL_RTOL),
            "lp": check_close("sigma_sweep", f"lp ({wd})", out_k[2], out_p[2],
                              ll_tol, ~amb, LL_RTOL),
            "ambiguous_chains": n_amb,
            "probes": float(out_p[3].sum()), "moved": float(out_p[4].sum()),
        }
        if wd == "float32":
            chain_f32, sig_full = chain, out_k
            # one probe per active chain per round: the rounds are the
            # largest probe count of a chain
            sig_rounds = int(sig.last_rounds.item())
            sig_chain_probes = out_k[3]
            if sig_rounds != int(sig_chain_probes.max()):
                failures.append(f"sigma_sweep: {sig_rounds} rounds, but the "
                                "most probes of a chain is "
                                f"{sig_chain_probes.max()}")
    probes = sig_err["float32"]["probes"]
    # the same chains at B=1, B=3 and more chains than the cooperative grid
    # has blocks: bitwise the B=128 result
    sig_batches = {}
    for nb_ in (1, 3, grid + 8):
        idx = torch.arange(nb_, device=dev) % B
        out_b = sig.sigma_sweep(
            *(a[idx].contiguous() for a in (chol_r, u, chain_f32, rep)), y,
            mask, "logistic", 8, None, N_SIGMA)
        sig_batches[f"B={nb_}"] = all(
            torch.equal(k_, f_[idx]) for k_, f_ in zip(out_b, sig_full))
    if not all(sig_batches.values()):
        failures.append(f"sigma_sweep: batches differ {sig_batches}")
    sig.launches = 0
    out_split = sig.sigma_sweep(*(a[idx_split].contiguous() for a in (
        chol_r, u, chain_f32, rep)), y, mask, "logistic", 8, None, N_SIGMA)
    torch.cuda.synchronize()
    sig_split = {"B": B_SPLIT, "launches": sig.launches,
                 "bitwise_equal_to_B128": all(
                     torch.equal(k_, f_[idx_split])
                     for k_, f_ in zip(out_split, sig_full)),
                 "rounds": int(sig.last_rounds.item())}
    if not sig_split["bitwise_equal_to_B128"]:
        failures.append(f"sigma_sweep: B={B_SPLIT} differs from the same "
                        "chains at B=128")
    # n above the old shared-memory limit, the n=640 bars
    theta_big = t(big["rng"].normal(size=(B_BIG, 2)) * 0.5)
    ll0 = fe._ref_estimate(torch.exp(theta_big[:, 1])[:, None, None]
                           * big["chol"], big["u"], big["y"], big["mask"],
                           "logistic", 8)
    lp_rest = target.log_prior(theta_big) + hiv * theta_big[:, 1] ** 2
    chain_big = torch.stack(
        [ll0, target.log_prior(theta_big) + ll0, theta_big[:, 1],
         torch.full_like(ll0, 1.2), torch.zeros_like(ll0),
         torch.full_like(ll0, hiv), lp_rest, torch.zeros_like(ll0)],
        dim=1).contiguous()
    rep_big = t(big["rng"].uniform(size=(B_BIG, N_SIGMA, 2 + 32)))
    rep_big[:, :, 0] = torch.log(rep_big[:, :, 0])
    probe_log = []
    out_k = sig.sigma_sweep(big["chol"], big["u"], chain_big, rep_big,
                            big["y"], big["mask"], "logistic", 8, None,
                            N_SIGMA)
    out_p = sig._ref_sigma_sweep(big["chol"], big["u"], chain_big, rep_big,
                                 big["y"], big["mask"], "logistic", 8, None,
                                 N_SIGMA, "float32", probe_log=probe_log)
    torch.cuda.synchronize()
    amb = ambiguous_chains(probe_log, LL_TOL)
    sig_big = {
        "B": B_BIG, "S": S, "n": N_BIG,
        "ambiguous_chains": check_counts(
            f"sigma_sweep n={N_BIG}", [("n_shrink", out_k[3], out_p[3]),
                                       ("moved", out_k[4], out_p[4])], amb),
        "sigma": check_close("sigma_sweep", f"sigma' n={N_BIG}", out_k[0],
                             out_p[0], SIGMA_TOL, ~amb),
        "ll": check_close("sigma_sweep", f"ll n={N_BIG}", out_k[1], out_p[1],
                          LL_TOL, ~amb, LL_RTOL),
        "lp": check_close("sigma_sweep", f"lp n={N_BIG}", out_k[2], out_p[2],
                          LL_TOL, ~amb, LL_RTOL),
        "moved": float(out_p[4].sum()), "shrinks": float(out_p[3].sum())}
    # every chain to the 32-probe cap in both repeats at full width: the
    # point is kept bitwise, 64 probes per chain, 64 rounds
    rep_cap = rep.clone()
    rep_cap[:, :, 0] = 1e4
    out_c = sig.sigma_sweep(chol_r, u, chain_f32, rep_cap, y, mask,
                            "logistic", 8, None, N_SIGMA)
    torch.cuda.synchronize()
    sig_cap_rounds = int(sig.last_rounds.item())
    if not (torch.equal(out_c[0], chain_f32[:, 2])
            and torch.equal(out_c[1], chain_f32[:, 0])
            and torch.equal(out_c[2], chain_f32[:, 1])
            and bool((out_c[3] == 32 * N_SIGMA).all())
            and bool((out_c[4] == 0).all())
            and sig_cap_rounds == 32 * N_SIGMA):
        failures.append("sigma_sweep: cap-hit at B=128 did not keep the point")
    # a cooperative grid the card cannot hold resident is refused, and the
    # wrappers raise on the refusal: such a run fails, it does not fall back
    coop = [ess.cooperative_launch_error(0), ess.cooperative_launch_error(1)]
    try:
        _build.check_launch(coop[1], "an oversized cooperative grid")
        coop_raises = False
    except RuntimeError:
        coop_raises = True
    if not (coop[0] == 0 and coop[1] != 0 and coop_raises):
        failures.append(f"cooperative launch: resident grid gave error "
                        f"{coop[0]}, one block more gave {coop[1]}")
    b_ms, b_by = bound(4 * B * (TRI + S * N + 8 + N_SIGMA * 34 + 8),
                       probes * fe.probe_flops(S, N))
    kernels["sigma_sweep"] = {
        "name": "sigma_sweep", "route": "cuda",
        "source": "auxpm_tpu_torch/csrc/sigma_sweep.cu",
        "replaces": "auxpm_tpu/ops/sigma_sweep.py:157",
        "max_abs_err": sig_err["float32"]["ll"], "tol": LL_TOL,
        "sigma_max_abs_err": sig_err["float32"]["sigma"],
        "sigma_tol": SIGMA_TOL, "variants": sig_err, "probes": probes,
        "probes_max_chain": int(sig_chain_probes.max()),
        "probes_mean_chain": float(sig_chain_probes.mean()),
        "rounds": sig_rounds, "grid_blocks": grid,
        "batches_bitwise_equal": sig_batches, "split": sig_split,
        "n1024": sig_big, "cap_hit_rounds_B128": sig_cap_rounds,
        "cooperative_launch_errors": {"resident_grid": coop[0],
                                      "one_block_more": coop[1]},
        "ms": time_ms(lambda: sig.sigma_sweep(chol_r, u, chain_f32, rep, y,
                                              mask, "logistic", 8, None,
                                              N_SIGMA), 3),
        "plain_ms": time_ms(lambda: sig._ref_sigma_sweep(
            chol_r, u, chain_f32, rep, y, mask, "logistic", 8, None, N_SIGMA,
            "float32"), 3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        # all 128 chains active in every round
        "ms_cap_hit_B128": time_ms(lambda: sig.sigma_sweep(
            chol_r, u, chain_f32, rep_cap, y, mask, "logistic", 8, None,
            N_SIGMA), 3),
    }

    # ------------------------------------------------- rotated estimator
    log("kernels: rotated estimator")
    v0 = v[:, 0].contiguous()
    angle = t(scal_np[:, 0, 2] - np.pi)          # both signs
    rot_err = {}
    for lik, wd in (("logistic", "float32"), ("probit", "float32"),
                    ("logistic", "bfloat16")):
        k_out = fe.fused_estimate_rot(chol, u, v0, angle, y, mask, lik, 8,
                                      None, wd)
        p_out = fe._ref_estimate_rot(chol, u, v0, angle, y, mask, lik, 8,
                                     None, wd)
        torch.cuda.synchronize()
        # bfloat16: u' is rounded to bf16 after the rotation; an ulp of
        # difference in u' moves an element across a bf16 boundary (a 2^-8
        # relative step): the looser bar of the scaled sigma sweep
        rot_err[f"{lik}/{wd}"] = check_close(
            "fused_estimator_rot", f"{lik}/{wd}", k_out, p_out,
            LL_TOL if wd == "float32" else BF16_SCALED_TOL, rtol=LL_RTOL)
    # finished chains cost nothing and give 0; the others are untouched
    active = (torch.arange(B, device=dev) % 3 != 0).to(torch.float32)
    k_act = fe.fused_estimate_rot(chol, u, v0, angle, y, mask, "logistic", 8,
                                  None, "float32", active)
    k_all = fe.fused_estimate_rot(chol, u, v0, angle, y, mask, "logistic", 8)
    if not (torch.equal(k_act[active != 0], k_all[active != 0])
            and bool((k_act[active == 0] == 0).all())):
        failures.append("fused_estimator_rot: the active mask changed a "
                        "wanted chain or did not zero an unwanted one")
    half = slice(0, B_ARD)
    rot_args = [a[half].contiguous() for a in (chol, u, v0, angle)]
    rot_err["B=64"] = check_close(
        "fused_estimator_rot", "B=64",
        fe.fused_estimate_rot(*rot_args, y, mask, "logistic", 8),
        fe._ref_estimate_rot(*rot_args, y, mask, "logistic", 8), LL_TOL,
        rtol=LL_RTOL)
    # n above the old left-operand limit (~880), and more chains than one
    # launch's active list holds (split, each chain bitwise its B=128 result)
    v_big0 = big["v"][:, 0].contiguous()
    rot_err[f"B={B_BIG} n={N_BIG}"] = check_close(
        "fused_estimator_rot", f"n={N_BIG}",
        fe.fused_estimate_rot(big["chol"], big["u"], v_big0,
                              angle[:B_BIG].contiguous(), big["y"],
                              big["mask"], "logistic", 8),
        fe._ref_estimate_rot(big["chol"], big["u"], v_big0, angle[:B_BIG],
                             big["y"], big["mask"], "logistic", 8), LL_TOL,
        rtol=LL_RTOL)
    del v_big0
    fe.launches_rot = 0
    k_split = fe.fused_estimate_rot(
        *(a[idx_split].contiguous() for a in (chol, u, v0, angle)), y, mask,
        "logistic", 8)
    rot_split = {"B": B_SPLIT, "launches": fe.launches_rot,
                 "bitwise_equal_to_B128": bool(torch.equal(
                     k_split, k_all[idx_split]))}
    del k_split
    if not rot_split["bitwise_equal_to_B128"]:
        failures.append(f"fused_estimator_rot: B={B_SPLIT} differs from the "
                        "same chains at B=128")
    # a call costs what its active chains cost: every chain, one in 4, and
    # 2 of 64 (the bracket loop's tail)
    rot_active_ms = {}
    for share, every in (("1.0", 1), ("0.25", 4), ("0.03", 32)):
        act = (torch.arange(B_ARD, device=dev) % every == 0).to(torch.float32)
        rot_active_ms[share] = time_ms(lambda: fe.fused_estimate_rot(
            *rot_args, y, mask, "logistic", 8, None, "float32", act))
    b_ms, b_by = bound(4 * (B_ARD * (TRI + 2 * S * N + 2) + 2 * N),
                       B_ARD * fe.probe_flops(S, N))
    kernels["fused_estimator_rot"] = {
        "name": "fused_estimator_rot", "route": "cuda",
        "source": "auxpm_tpu_torch/csrc/fused_estimator.cu",
        "replaces": "auxpm_tpu/ops/fused_estimator.py:294",
        "max_abs_err": rot_err["B=64"], "tol": LL_TOL,
        "variants_max_abs_err": rot_err, "shape": {"B": B_ARD, "S": S, "n": N},
        "split": rot_split,
        "ms": time_ms(lambda: fe.fused_estimate_rot(*rot_args, y, mask,
                                                    "logistic", 8)),
        "plain_ms": time_ms(lambda: fe._ref_estimate_rot(*rot_args, y, mask,
                                                         "logistic", 8)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "ms_by_active_share": rot_active_ms,
        # the least time with 2 of 64 chains active
        "bound_ms_active_0.03": bound(
            4 * (2 * (TRI + 2 * S * N + 1) + 2 * N + 2 * B_ARD),
            2 * fe.probe_flops(S, N))[0],
        "ms_B128": time_ms(lambda: fe.fused_estimate_rot(
            chol, u, v0, angle, y, mask, "logistic", 8)),
        "plain_estimator_ms_B64": time_ms(lambda: fe.fused_estimate(
            rot_args[0], rot_args[1], y, mask, "logistic", 8)),
    }

    # ------------------------------------------------------------ ARD Gram
    log("kernels: ARD Gram")
    x_pad = t(np.concatenate([x, np.zeros((N - len(x), D_ARD), x.dtype)]))
    assert x.shape[1] == D_ARD
    log_ells = t(rng.normal(size=(B, D_ARD)) * 0.5)
    eps = float(np.finfo(np.float32).eps)
    gram_err, gram_ms = {}, {}
    for bb in (B_ARD, B):
        le = log_ells[:bb].contiguous()
        sq_max = float(((x_pad[None] * torch.exp(-le)[:, None, :]) ** 2)
                       .sum(-1).max())
        gram_tol = 8.0 * eps * max(sq_max, 1.0)
        g_k = gr.se_gram_ard_hopper(x_pad, le, 1e-5, mask)
        g_p = gr.se_gram_ard_masked(x_pad, le, 1e-5, mask)
        torch.cuda.synchronize()
        gram_err[f"B={bb}"] = check_close("se_gram_ard", f"B={bb}", g_k, g_p,
                                          gram_tol)
        diag = torch.diagonal(g_k, dim1=-2, dim2=-1)
        n_real = len(x)
        if not (bool((diag[:, n_real:] == 1.0).all())
                and bool((g_k[:, n_real:, :n_real] == 0).all())
                and bool((g_k[:, :n_real, n_real:] == 0).all())
                and float((diag[:, :n_real] - (1.0 + 1e-5)).abs().max())
                <= 2e-7):
            failures.append(f"se_gram_ard: pad fix-up or diagonal wrong at "
                            f"B={bb}")
        gram_ms[bb] = (
            time_ms(lambda: gr.se_gram_ard_hopper(x_pad, le, 1e-5, mask)),
            time_ms(lambda: gr.se_gram_ard_masked(x_pad, le, 1e-5, mask)))
        if bb == B_ARD:
            gram_tol_main, gram_sym = gram_tol, torch.equal(g_k, g_k.mT)
            # what the path does with it: the escalating factorisation
            l_g, extra_g = cholesky._robust_cholesky_impl(g_k, jitter0=1e-5)
            if not bool(torch.isfinite(l_g).all()):
                failures.append("se_gram_ard: its Gram does not factor")
            gram_back = max_err(torch.bmm(l_g, l_g.mT),
                                g_k + extra_g[:, None, None]
                                * torch.eye(N, device=dev))
            gram_escalated = int((extra_g > 0).sum())
    # without a mask (an unpadded target) the plain Gram
    gram_err["no_mask"] = check_close(
        "se_gram_ard", "no mask",
        gr.se_gram_ard_hopper(x_pad, log_ells[:4].contiguous(), 1e-5),
        gr.se_gram_ard(x_pad, log_ells[:4].contiguous(), 0.0, 1e-5),
        gram_tol)
    # the kernel reads x (n, d), log_ells (B, d) and the mask once and
    # writes B n^2 floats
    b_ms, b_by = bound(4 * (B_ARD * (N * N + D_ARD) + N * D_ARD + N),
                       B_ARD * N * N * (2.0 * D_ARD + 8.0))
    kernels["se_gram_ard"] = {
        "name": "se_gram_ard", "route": "cuda",
        "source": "auxpm_tpu_torch/csrc/se_gram.cu",
        "replaces": "auxpm_tpu/ops/gram.py:112",
        "max_abs_err": gram_err[f"B={B_ARD}"], "tol": gram_tol_main,
        "variants_max_abs_err": gram_err, "symmetric": gram_sym,
        "factor_backward_err": gram_back, "escalated": gram_escalated,
        "shape": {"B": B_ARD, "n": N, "d": D_ARD},
        "ms": gram_ms[B_ARD][0], "plain_ms": gram_ms[B_ARD][1],
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "ms_B128": gram_ms[B][0], "plain_ms_B128": gram_ms[B][1],
        "bound_ms_B128": bound(4 * (B * (N * N + D_ARD) + N * D_ARD + N),
                               0)[0],
    }

    # ------------------------------------------- per-sample weights kernels
    log("kernels: per-sample weights (plain and rotated)")
    u_loc = u[:, :S_LOCAL].contiguous()
    v_loc = v0[:, :S_LOCAL].contiguous()
    w_err, wr_err = {}, {}
    for lik, wd in (("logistic", "float32"), ("probit", "float32"),
                    ("logistic", "bfloat16")):
        tol = LL_TOL if wd == "float32" else BF16_SCALED_TOL
        w_err[f"{lik}/{wd}"] = check_close(
            "fused_weights", f"{lik}/{wd}",
            fe.fused_weights(chol, u_loc, y, mask, lik, wd),
            fe._ref_weights(chol, u_loc, y, mask, lik, wd), tol, rtol=LL_RTOL)
        wr_err[f"{lik}/{wd}"] = check_close(
            "fused_rot_weights", f"{lik}/{wd}",
            fe.fused_rot_weights(chol, u_loc, v_loc, angle, y, mask, lik, wd),
            fe._ref_rot_weights(chol, u_loc, v_loc, angle, y, mask, lik, wd),
            tol, rtol=LL_RTOL)
    # a row's weight must not depend on which rows share its call: the
    # particle-sharded estimator rests on it
    lw_full = fe.fused_weights(chol, u, y, mask)
    lwr_full = fe.fused_rot_weights(chol, u, v0, angle, y, mask)
    rows_bitwise = True
    for s_loc in (8, 16, 32):
        for r0 in range(0, S, s_loc):
            sl = slice(r0, r0 + s_loc)
            rows_bitwise &= torch.equal(
                fe.fused_weights(chol, u[:, sl].contiguous(), y, mask),
                lw_full[:, sl])
            rows_bitwise &= torch.equal(
                fe.fused_rot_weights(chol, u[:, sl].contiguous(),
                                     v0[:, sl].contiguous(), angle, y, mask),
                lwr_full[:, sl])
    if not rows_bitwise:
        failures.append("fused_weights: a row's weight depends on the rows "
                        "that share its call")
    # weights + the fold of the block partials against the fused estimate
    from auxpm_tpu_torch.ops.logsumexp import blocked_logsumexp
    est_full = fe.fused_estimate(chol, u, y, mask, "logistic", 8)
    comb = blocked_logsumexp(lw_full, 8) - float(np.log(np.float32(S)))
    combine_rel = float(((comb - est_full) / est_full).abs().max())
    if not combine_rel <= COMBINE_RTOL:
        failures.append(f"fused_weights + combine vs fused_estimate: "
                        f"{combine_rel:.3e} relative")
    k_act = fe.fused_rot_weights(chol, u_loc, v_loc, angle, y, mask,
                                 "logistic", "float32", active)
    k_all = fe.fused_rot_weights(chol, u_loc, v_loc, angle, y, mask)
    if not (torch.equal(k_act[active != 0], k_all[active != 0])
            and bool((k_act[active == 0] == 0).all())):
        failures.append("fused_rot_weights: the active mask changed a wanted "
                        "chain or did not zero an unwanted one")
    # at angle 0 the rotated weights are the plain weights, bit for bit
    rot0_bitwise = torch.equal(
        fe.fused_rot_weights(chol, u_loc, v_loc, torch.zeros_like(angle), y,
                             mask),
        fe.fused_weights(chol, u_loc, y, mask))
    if not rot0_bitwise:
        failures.append("fused_rot_weights at angle 0 differs from "
                        "fused_weights")
    w_extra = {"rows_bitwise_independent": rows_bitwise,
               "rot_weights_at_angle_0_bitwise": rot0_bitwise,
               "combine_vs_estimate_bitwise": torch.equal(comb, est_full),
               "combine_vs_estimate_max_rel": combine_rel,
               "shape": {"B": B, "S_local": S_LOCAL, "n": N},
               # the consumers take 2 rows each at S_local <= 32: no
               # products on the pad rows of a 64-row stage
               "rows_per_consumer_thread": 2 if S_LOCAL <= 32 else 4}
    b_ms, b_by = bound(4 * (B * (TRI + S_LOCAL * N + S_LOCAL) + 2 * N),
                       B * fe.probe_flops(S_LOCAL, N))
    kernels["fused_weights"] = {
        "name": "fused_weights", "route": "cuda",
        "source": "auxpm_tpu_torch/csrc/fused_estimator.cu",
        "replaces": "auxpm_tpu/ops/fused_estimator.py:437",
        "max_abs_err": w_err["logistic/float32"], "tol": LL_TOL,
        "variants_max_abs_err": w_err, **w_extra,
        "ms": time_ms(lambda: fe.fused_weights(chol, u_loc, y, mask)),
        "plain_ms": time_ms(lambda: fe._ref_weights(chol, u_loc, y, mask,
                                                    "logistic")),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "ms_S64": time_ms(lambda: fe.fused_weights(chol, u, y, mask)),
    }
    # both weights kernels at n above the old left-operand limit; the
    # rotated weights also at more chains than one launch's active list
    # holds (split, each chain bitwise its B=128 result)
    w_err[f"B={B_BIG} n={N_BIG}"] = check_close(
        "fused_weights", f"n={N_BIG}",
        fe.fused_weights(big["chol"], big["u"][:, :S_LOCAL].contiguous(),
                         big["y"], big["mask"]),
        fe._ref_weights(big["chol"], big["u"][:, :S_LOCAL], big["y"],
                        big["mask"], "logistic"), LL_TOL, rtol=LL_RTOL)
    wr_err[f"B={B_BIG} n={N_BIG}"] = check_close(
        "fused_rot_weights", f"n={N_BIG}",
        fe.fused_rot_weights(big["chol"], big["u"][:, :S_LOCAL].contiguous(),
                             big["v"][:, 0, :S_LOCAL].contiguous(),
                             angle[:B_BIG].contiguous(), big["y"],
                             big["mask"]),
        fe._ref_rot_weights(big["chol"], big["u"][:, :S_LOCAL],
                            big["v"][:, 0, :S_LOCAL],
                            angle[:B_BIG], big["y"], big["mask"],
                            "logistic"), LL_TOL, rtol=LL_RTOL)
    del big
    lwr_loc = fe.fused_rot_weights(chol, u_loc, v_loc, angle, y, mask)
    fe.launches_rot_w = 0
    lwr_split = fe.fused_rot_weights(
        *(a[idx_split].contiguous() for a in (chol, u_loc, v_loc, angle)), y,
        mask)
    rw_split = {"B": B_SPLIT, "launches": fe.launches_rot_w,
                "bitwise_equal_to_B128": bool(torch.equal(
                    lwr_split, lwr_loc[idx_split]))}
    del lwr_split
    if not rw_split["bitwise_equal_to_B128"]:
        failures.append(f"fused_rot_weights: B={B_SPLIT} differs from the "
                        "same chains at B=128")
    # a call costs what its active chains cost: every chain, one in 4, and
    # 4 of 128 (the bracket loop's tail)
    rw_active_ms = {}
    for share, every in (("1.0", 1), ("0.25", 4), ("0.03", 32)):
        act = (torch.arange(B, device=dev) % every == 0).to(torch.float32)
        rw_active_ms[share] = time_ms(lambda: fe.fused_rot_weights(
            chol, u_loc, v_loc, angle, y, mask, "logistic", "float32", act))
    b_ms, b_by = bound(4 * (B * (TRI + 2 * S_LOCAL * N + S_LOCAL + 2)
                            + 2 * N), B * fe.probe_flops(S_LOCAL, N))
    kernels["fused_rot_weights"] = {
        "name": "fused_rot_weights", "route": "cuda",
        "source": "auxpm_tpu_torch/csrc/fused_estimator.cu",
        "replaces": "auxpm_tpu/ops/fused_estimator.py:461",
        "max_abs_err": wr_err["logistic/float32"], "tol": LL_TOL,
        "variants_max_abs_err": wr_err, "split": rw_split,
        "shape": {"B": B, "S_local": S_LOCAL, "n": N},
        "ms": time_ms(lambda: fe.fused_rot_weights(chol, u_loc, v_loc, angle,
                                                   y, mask)),
        "plain_ms": time_ms(lambda: fe._ref_rot_weights(
            chol, u_loc, v_loc, angle, y, mask, "logistic")),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "ms_by_active_share": rw_active_ms,
        # the least time with 4 of 128 chains active
        "bound_ms_active_0.03": bound(
            4 * (4 * (TRI + 2 * S_LOCAL * N + S_LOCAL + 2) + 2 * N + B),
            4 * fe.probe_flops(S_LOCAL, N))[0],
    }

    # ------------------------------------------- Cholesky panels v1 and v2
    log("kernels: Cholesky panels v1 and v2")
    l1_k, x1_k = chol_hopper.chol_panel_batched(tiles)
    l1_p, x1_p = chol_hopper._ref_chol_panel_v1(tiles)
    l2_k = chol_hopper.chol_panel_batched2(tiles)
    l2_p = chol_hopper._ref_chol_panel_v2(tiles)
    torch.cuda.synchronize()
    err_l1 = check_close("chol_panel_v1", "L", l1_k, l1_p, CHOL_TOL)
    err_l2 = check_close("chol_panel_v2", "L", l2_k, l2_p, CHOL_TOL)
    resid1 = max_err(torch.bmm(x1_k, l1_k), eye.expand(B, 128, 128))
    resid2 = max_err(torch.bmm(chol_hopper.tri_inv_newton(l2_k), l2_k),
                     eye.expand(B, 128, 128))
    for name, r in (("v1", resid1), ("v2 + Newton", resid2)):
        if not r <= 2e-4 * max(1.0, inv_scale):
            failures.append(f"chol_panel {name}: |inv(L) L - I| = {r:.3e}")
    if max(float(torch.triu(l1_k, 1).abs().max()),
           float(torch.triu(x1_k, 1).abs().max()),
           float(torch.triu(l2_k, 1).abs().max())) != 0.0:
        failures.append("chol_panel v1/v2: an output is not lower triangular")
    for name, fn in (("v1", lambda a: chol_hopper.chol_panel_batched(a)[0]),
                     ("v2", chol_hopper.chol_panel_batched2)):
        if not nan_contract_holds(fn):
            failures.append(f"chol_panel {name}: NaN contract broken")
    # one factor code under the three output modes: v1 and v2 give v3's bits
    v1_same = {"l_equals_v3_l": bool(torch.equal(l1_k, l_k)),
               "inv_equals_v3_xt_transposed": bool(torch.equal(x1_k,
                                                               xt_k.mT))}
    v2_same = {"l_equals_v3_l": bool(torch.equal(l2_k, l_k))}
    for name, same in (("v1", v1_same), ("v2", v2_same)):
        for key, ok in same.items():
            if not ok:
                failures.append(f"chol_panel {name}: {key} is false")
    # a small odd batch (one block, three blocks) gives the same tiles
    for nb_ in (1, 3):
        if not (torch.equal(chol_hopper.chol_panel_batched(
                    tiles[:nb_].contiguous())[1], x1_k[:nb_])
                and torch.equal(chol_hopper.chol_panel_batched2(
                    tiles[:nb_].contiguous()), l2_k[:nb_])):
            failures.append(f"chol_panel v1/v2: a batch of {nb_} differs")

    def _lib_v1():
        l_ = torch.linalg.cholesky(tiles)
        return torch.linalg.solve_triangular(l_, eye.expand_as(l_),
                                             upper=False)

    b_ms, b_by = bound(4 * 3 * B * 128 * 128, B * 2 * 128**3 / 3.0)
    kernels["chol_panel_v1"] = {
        "name": "chol_panel_v1", "route": "cuda",
        "source": "auxpm_tpu_torch/csrc/chol_panel.cu",
        "replaces": "auxpm_tpu/ops/chol_pallas.py:108",
        "max_abs_err": err_l1, "tol": CHOL_TOL, "inverse_residual": resid1,
        **v1_same,
        "ms": time_ms(lambda: chol_hopper.chol_panel_batched(tiles)),
        "plain_ms": time_ms(lambda: chol_hopper._ref_chol_panel_v1(tiles)),
        "bound_ms": b_ms, "bound_by": b_by,
        # two PyTorch calls: the factor, then the triangular solve
        "library_ms": time_ms(_lib_v1), "library_calls": 2,
    }
    b_ms, b_by = bound(4 * 2 * B * 128 * 128, B * 128**3 / 3.0)
    kernels["chol_panel_v2"] = {
        "name": "chol_panel_v2", "route": "cuda",
        "source": "auxpm_tpu_torch/csrc/chol_panel.cu",
        "replaces": "auxpm_tpu/ops/chol_pallas.py:262",
        "max_abs_err": err_l2, "tol": CHOL_TOL, **v2_same,
        "newton_inverse_residual": resid2,
        "ms": time_ms(lambda: chol_hopper.chol_panel_batched2(tiles)),
        "plain_ms": time_ms(lambda: chol_hopper._ref_chol_panel_v2(tiles)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: torch.linalg.cholesky(tiles)),
    }

    # ------------------------------------------- a small shape, the shrink cap
    log("kernels: a small shape and the shrink cap")
    bs, ss, ns = 5, 16, 256
    chol_s = chol[:bs, :ns, :ns].contiguous()
    u_s = u[:bs, :ss, :ns].contiguous()
    y_s, mask_s = y[:ns], mask[:ns]
    edge = {}
    for nb in (1, 8):
        edge[f"estimate_n_blocks_{nb}"] = check_close(
            "fused_estimator", f"S={ss} n={ns} n_blocks={nb}",
            fe.fused_estimate(chol_s, u_s, y_s, mask_s, "logistic", nb),
            fe._ref_estimate(chol_s, u_s, y_s, mask_s, "logistic", nb),
            LL_TOL, rtol=LL_RTOL)
    # a slice level no probe can reach: 32 shrinks, then the state is kept
    # exactly (bitwise)
    scal_s = t(scal_np[:bs, :1])
    scal_s[:, 0, 0] = fe._ref_estimate(chol_s, u_s, y_s, mask_s, "logistic", 8)
    scal_s[:, 0, 1] = 1e4
    u_c, ll_c, ns_c, mv_c = ess.ess_sweep(
        chol_s, u_s, scal_s, v[:bs, :1, :ss, :ns].contiguous(), y_s, mask_s,
        "logistic", 8, None, 1)
    if not (torch.equal(u_c, u_s) and torch.equal(ll_c, scal_s[:, 0, 0])
            and bool((ns_c == 32).all()) and bool((mv_c == 0).all())):
        failures.append("ess_sweep: cap-hit did not keep the state")
    chain_s = chain_f32[:bs].contiguous()
    rep_s = rep[:bs, :1].clone()
    rep_s[:, :, 0] = 1e4
    out_c = sig.sigma_sweep(chol_r[:bs, :ns, :ns].contiguous(), u_s, chain_s,
                            rep_s, y_s, mask_s, "logistic", 8, None, 1)
    if not (torch.equal(out_c[0], chain_s[:, 2])
            and torch.equal(out_c[1], chain_s[:, 0])
            and torch.equal(out_c[2], chain_s[:, 1])
            and bool((out_c[3] == 32).all()) and bool((out_c[4] == 0).all())):
        failures.append("sigma_sweep: cap-hit did not keep the point")
    for nb in (1, 8):
        edge[f"estimate_rot_n_blocks_{nb}"] = check_close(
            "fused_estimator_rot", f"S={ss} n={ns} n_blocks={nb}",
            fe.fused_estimate_rot(chol_s, u_s, v[:bs, 0, :ss, :ns].contiguous(),
                                  angle[:bs].contiguous(), y_s, mask_s,
                                  "logistic", nb),
            fe._ref_estimate_rot(chol_s, u_s, v[:bs, 0, :ss, :ns].contiguous(),
                                 angle[:bs].contiguous(), y_s, mask_s,
                                 "logistic", nb),
            LL_TOL, rtol=LL_RTOL)
    # the weights kernels on 5 rows (a block's rows need no multiple)
    u_5, v_5 = u_s[:, :5].contiguous(), v[:bs, 0, :5, :ns].contiguous()
    edge["weights_S5"] = check_close(
        "fused_weights", f"S=5 n={ns}",
        fe.fused_weights(chol_s, u_5, y_s, mask_s),
        fe._ref_weights(chol_s, u_5, y_s, mask_s, "logistic"), LL_TOL,
        rtol=LL_RTOL)
    edge["rot_weights_S5"] = check_close(
        "fused_rot_weights", f"S=5 n={ns}",
        fe.fused_rot_weights(chol_s, u_5, v_5, angle[:bs].contiguous(), y_s,
                             mask_s),
        fe._ref_rot_weights(chol_s, u_5, v_5, angle[:bs].contiguous(), y_s,
                            mask_s, "logistic"), LL_TOL, rtol=LL_RTOL)
    # an odd Gram shape: n not a multiple of the 64-tile, d = 3
    x_odd = t(rng.standard_normal((100, 3)))
    le_odd = t(rng.normal(size=(bs, 3)) * 0.5)
    m_odd = (torch.arange(100, device=dev) < 90).to(torch.float32)
    sq_odd = float(((x_odd[None] * torch.exp(-le_odd)[:, None, :]) ** 2)
                   .sum(-1).max())
    for name, m in (("mask", m_odd), ("no_mask", None)):
        edge[f"se_gram_ard_n100_d3_{name}"] = check_close(
            "se_gram_ard", f"n=100 d=3 {name}",
            gr.se_gram_ard_hopper(x_odd, le_odd, 1e-5, m),
            gr.se_gram_ard_masked(x_odd, le_odd, 1e-5, m),
            8.0 * eps * max(sq_odd, 1.0))
    torch.cuda.synchronize()
    emit({"phase": "kernels", "shape": {"B": B, "S": S, "n": N},
          "kernels": list(kernels.values()),
          "small_shape": {"B": bs, "S": ss, "n": ns, "max_abs_err": edge,
                          "cap_hit_keeps_state": not failures}})
    end_phase()

    # ------------------------------------------------------ threefry kernel
    # csrc/threefry.cu against its plain version ops/threefry.draw_plain on
    # the card: words, bits and uniforms bitwise, normals within THREEFRY_ULP
    # (the two log1pf may differ), the golden jax.random normals bitwise.
    log("kernels: threefry")
    from auxpm_tpu_torch.core import prng
    from auxpm_tpu_torch.ops import threefry as tfk

    tf_cases, tf_bad, tf_ulp = 0, [], 0
    for seed in THREEFRY_SEEDS:
        keys_ = prng.split(prng.key(seed).to(dev), (3, 5))
        for shape_ in ((), (7,), (4, 33), (2, 3, N)):
            for mode, lo_, hi_ in (("words", 0.0, 1.0), ("bits", 0.0, 1.0),
                                   ("uniform", 0.0, 1.0),
                                   ("uniform", -2.5, 3.7),
                                   ("normal", 0.0, 1.0)):
                for off in (0, 11):
                    k_out = tfk.threefry(keys_, shape_, mode, lo_, hi_, off)
                    p_out = tfk.draw_plain(keys_, shape_, mode, lo_, hi_,
                                            off)
                    tf_cases += 1
                    if mode == "normal":
                        tf_ulp = max(tf_ulp, _ulps(torch, k_out, p_out))
                    elif not torch.equal(k_out, p_out):
                        tf_bad.append(f"{seed}/{shape_}/{mode}/{lo_}/{off}")
        data_ = torch.arange(100, device=dev) * 7919 + seed  # fold_in's data
        tf_cases += 1
        if not torch.equal(tfk.threefry(keys_[..., None, :], (), "words",
                                        data=data_),
                           tfk.draw_plain(keys_[..., None, :], (), "words",
                                           data=data_)):
            tf_bad.append(f"{seed}/fold_in")
    if tf_bad:
        failures.append(f"threefry: kernel differs from the plain version "
                        f"on {tf_bad}")
    if tf_ulp > THREEFRY_ULP:
        failures.append(f"threefry: normals {tf_ulp} ulp off the plain "
                        "version")
    golden_ = prng.load_golden()
    golden_normals = all(
        prng.golden_cases(seed, dev)["normal"]
        == golden_["cases"][str(seed)]["normal"] for seed in golden_["seeds"])
    if not golden_normals:
        failures.append("threefry: golden normals differ from jax.random")

    def threefry_bound(words_by_mode, out_bytes, key_bytes):
        """Integer operations (THREEFRY_INT_OPS a cipher call, plus the
        output's, at the card's int32 rate) against the bytes written and
        the keys read; ``words_by_mode``: cipher calls of each mode."""
        n_ops = sum(n_ * (THREEFRY_INT_OPS + THREEFRY_OUT_OPS[m_])
                    for m_, n_ in words_by_mode.items())
        t_ops = n_ops / INT32_OPS * 1e3
        t_bytes = (out_bytes + key_bytes) / HBM_BYTES_PER_S * 1e3
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                     else "bytes")

    # one key-as-u chunk's u and the ESS v of one config-2 step (4 repeats
    # of the blocked draw: fold_in of 8 block keys, then the normals)
    keys_c = prng.split(prng.key(2026).to(dev), PRNG_CHUNK[0])
    z_k = tfk.threefry(keys_c, PRNG_CHUNK[1:], "normal")
    z_p = tfk.draw_plain(keys_c, PRNG_CHUNK[1:], "normal")
    chunk_err = max_err(z_k, z_p)
    chunk_ulp_kp = _ulps(torch, z_k, z_p)
    if chunk_ulp_kp > THREEFRY_ULP:
        failures.append(f"threefry: chunk normals {chunk_ulp_kp} ulp off")
    del z_k, z_p
    n_chunk = math.prod(PRNG_CHUNK)
    chunk_ms = time_ms(lambda: tfk.threefry(keys_c, PRNG_CHUNK[1:], "normal"))
    chunk_plain_ms = time_ms(
        lambda: tfk.draw_plain(keys_c, PRNG_CHUNK[1:], "normal"), reps=3)
    chunk_b_ms, chunk_b_by = threefry_bound(
        {"normal": n_chunk}, 4 * n_chunk, 16 * PRNG_CHUNK[0])
    keys_v = prng.split(prng.key(7).to(dev), (B, N_ESS))
    gids = torch.arange(8, device=dev)

    def v_kernel():
        return prng.blocked_normal(keys_v, (S, N), 8, S)

    def v_plain():
        kb = tfk.draw_plain(keys_v[..., None, :], (), "words", data=gids)
        return tfk.draw_plain(kb, (S // 8, N), "normal").reshape(
            B, N_ESS, S, N)

    v_ulp = _ulps(torch, v_kernel(), v_plain())
    if v_ulp > THREEFRY_ULP:
        failures.append(f"threefry: ESS v {v_ulp} ulp off the plain version")
    n_v = B * N_ESS * S * N
    v_ms = time_ms(v_kernel)
    v_plain_ms = time_ms(v_plain, reps=3)
    v_b_ms, v_b_by = threefry_bound(
        {"normal": n_v, "words": B * N_ESS * 8}, 4 * n_v, 16 * B * N_ESS * 9)
    kernels["threefry"] = {
        "name": "threefry", "route": "cuda",
        "source": "auxpm_tpu_torch/csrc/threefry.cu",
        "replaces": "none: jax.random (XLA), auxpm_tpu/core/state.py:10-12",
        "max_abs_err": chunk_err, "tol": f"{THREEFRY_ULP} ulp",
        "max_ulp": max(tf_ulp, chunk_ulp_kp, v_ulp),
        "shape": {"keys": PRNG_CHUNK[0], "normals_per_key":
                  PRNG_CHUNK[1] * PRNG_CHUNK[2]},
        "ms": chunk_ms, "plain_ms": chunk_plain_ms, "bound_ms": chunk_b_ms,
        "bound_by": chunk_b_by, "library_ms": None,
        "ess_v_ms": v_ms, "ess_v_plain_ms": v_plain_ms,
        "ess_v_bound_ms": v_b_ms, "ess_v_bound_by": v_b_by,
    }
    emit({"phase": "threefry_card", "card": smi, "cases": tf_cases,
          "words_bits_uniforms_bitwise": not tf_bad,
          "normal_max_ulp": max(tf_ulp, chunk_ulp_kp, v_ulp),
          "golden_normals_bitwise": golden_normals,
          "chunk": {"shape": list(PRNG_CHUNK), "ms": chunk_ms,
                    "plain_ms": chunk_plain_ms, "bound_ms": chunk_b_ms,
                    "bound_by": chunk_b_by,
                    "normals_per_s": n_chunk / (chunk_ms / 1e3)},
          "ess_v_config2_step": {"shape": [B, N_ESS, S, N], "ms": v_ms,
                                 "plain_ms": v_plain_ms, "bound_ms": v_b_ms,
                                 "bound_by": v_b_by, "launches": 2}})
    del keys_c, keys_v
    end_phase()

    # ------------------------------------------------------------ main path
    log("main path:", " ".join(CLI_ARGS))
    counters = launch_counters()   # kernel -> (wrapper module, counter)
    only_sharded = ("fused_weights", "fused_rot_weights")
    only_bench = ("chol_panel_v1", "chol_panel_v2")

    def read_counts():
        return {name: getattr(m, attr) for name, (m, attr) in counters.items()}

    def run_cli(args, must, must_not):
        """Counts to 0, the CLI run, counts read; ``must`` kernels have to
        have launched, ``must_not`` kernels must not."""
        for m, attr in counters.values():
            setattr(m, attr, 0)
        result = {}
        with contextlib.redirect_stdout(sys.stderr):   # its summary line
            rc = port_run.main(args, result=result)
        torch.cuda.synchronize()
        counts = read_counts()
        if rc != 0:
            raise AssertionError(f"run.main returned {rc}")
        for name in must:
            if counts[name] <= 0:
                raise AssertionError(f"{args[1]}: never launched {name}")
        for name in must_not:
            if counts[name] != 0:
                raise AssertionError(f"{args[1]}: launched {name}")
        return result, counts

    first_path = ("fused_estimator", "chol_panel", "ess_sweep", "sigma_sweep",
                  "threefry")
    result, counts = run_cli(CLI_ARGS, first_path,
                             ("fused_estimator_rot", "se_gram_ard",
                              *only_sharded, *only_bench))
    n_steps_main = 40   # 2 x 10 warm-up + 20
    for name in first_path:
        kernels[name]["launches"] = counts[name]
    states, tgt, params = result["states"], result["target"], result["params"]
    summary = result["summary"]
    if states.u.shape != (B, S, N) or not states.u.is_cuda:
        raise AssertionError("main path did not run at full width on the GPU")
    if not np.isfinite(result["theta"]).all() or \
            not bool(torch.isfinite(states.log_lik_hat).all()):
        raise AssertionError("main path: non-finite theta or log L-hat")
    health = _sampler_health(result)
    cache_err = max_err(states.extras["target_cache"]["chol_r"],
                        tgt.cache_init(states.theta)["chol_r"])
    if not cache_err <= CHOL_TOL:
        raise AssertionError(f"carried factor off by {cache_err:.3e}")
    # the keyed draws' device time from a profiled window of the same step
    # on the final state (not during the run: timing every draw would slow
    # the host loop it measures)
    _, prof_main = profile_steps(port_run_step(tgt), states, params, 5)
    keyed_ms = sum(v_ for k_, v_ in
                   prof_main["device_ms_per_step_by_kernel"].items()
                   if "threefry_kernel" in k_)
    emit({"phase": "main_path", "card": smi, "args": CLI_ARGS,
          "launches": counts, "summary": summary,
          "chain_steps_per_sec": summary["chain_steps_per_sec"],
          "keyed_draws_device_ms_per_step": keyed_ms,
          "threefry_launches_per_step": counts["threefry"] / n_steps_main,
          "profile": {k_: prof_main[k_] for k_ in (
              "wall_ms_per_step", "device_busy_ms_per_step",
              "device_idle_share", "kernel_launches_per_step",
              "host_syncs_per_step")},
          "cache_max_abs_err": cache_err, **health})
    end_phase()

    # ---------------------------------------------------------- path parity
    log("path parity")
    step = port_run_step(tgt)
    ess_t, sl_t = step.stages["ess_u"], step.stages["slice_theta"]
    rows_e, _ = ess_t.draw(states)

    def one_step(state):
        mid, info_e = ess_t.apply(state, rows_e, params["ess_u"])
        out, info_s = sl_t.apply(mid, rows_s, params["slice_theta"])
        return out, {**info_e, **info_s}

    rows_s, _ = sl_t.draw(states)
    s_k, i_k = one_step(states)
    with contextlib.ExitStack() as stack:
        for mod, cuda_fn, plain_fn in (
                (fe, "_cuda_estimate", fe._ref_estimate),
                (ess, "_cuda_ess_sweep", ess._ref_ess_sweep),
                (sig, "_cuda_sigma_sweep", sig._ref_sigma_sweep),
                (chol_hopper, "_cuda_chol_panel", chol_hopper._ref_chol_panel)):
            stack.enter_context(mock.patch.object(mod, cuda_fn, plain_fn))
        before = read_counts()
        s_p, i_p = one_step(states)
        if read_counts() != before:
            raise AssertionError("plain path launched a kernel")
    torch.cuda.synchronize()
    agree = torch.ones(B, dtype=torch.bool, device=dev)
    for k in i_k:
        agree &= i_k[k] == i_p[k]
    n_disagree = int((~agree).sum())
    if n_disagree > MAX_AMBIGUOUS:
        raise AssertionError(f"path parity: decisions differ on {n_disagree} "
                             "chains")
    # theta and u do not pass through a factorisation and keep the kernels'
    # bars.  The carried factor does: the two paths factor the accepted
    # Gram (condition number up to ~1e7) with different panel routines, two
    # valid f32 factors that differ elementwise by up to ~1e-3, and log L-hat
    # off them differs accordingly, so these two get their own stated bars;
    # the kernel path's log L-hat is then held, at the kernels' bar, to the
    # plain estimator on the kernel path's OWN final state.
    parity = {
        "theta": check_close("path_parity", "theta", s_k.theta, s_p.theta,
                             SIGMA_TOL, agree),
        "u": check_close("path_parity", "u", s_k.u, s_p.u, U_TOL, agree),
        "chol_r": check_close("path_parity", "chol_r",
                              s_k.extras["target_cache"]["chol_r"],
                              s_p.extras["target_cache"]["chol_r"],
                              PATH_CHOL_TOL, agree),
        "ll": check_close("path_parity", "ll", s_k.log_lik_hat,
                          s_p.log_lik_hat, PATH_LL_TOL, agree),
        "ll_vs_plain_estimate_of_own_state": check_close(
            "path_parity", "ll of own state", s_k.log_lik_hat,
            fe._ref_estimate(
                tgt.prepare_c(s_k.theta, s_k.extras["target_cache"]), s_k.u,
                y, mask, "logistic", 8), LL_TOL, None, LL_RTOL),
    }
    emit({"phase": "path_parity", "chains_with_a_differing_decision":
          n_disagree, "max_abs_err": parity,
          "probes": {k: float(v.sum()) for k, v in i_k.items()}})
    end_phase()

    # ------------------------------------------------ config 2 at 4096 chains
    # One unsharded step at more chains than a sweep launch's active list
    # holds: each sweep's wrapper splits its call in two launches.
    log(f"one config-2 step at {B_WIDE} chains")
    from auxpm_tpu_torch.core.state import init_chain_states

    torch.cuda.reset_peak_memory_stats()
    wide = init_chain_states(7, tgt, B_WIDE, jitter_scale=0.3,
                             with_cache=True)
    for m, attr in counters.values():
        setattr(m, attr, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wide, info_w = step(wide, params)
    torch.cuda.synchronize()
    wide_ms = (time.perf_counter() - t0) * 1e3
    counts_w = read_counts()
    if counts_w["ess_sweep"] != 2 or counts_w["sigma_sweep"] != 2:
        failures.append(f"{B_WIDE} chains: expected two launches of each "
                        f"sweep, got {counts_w}")
    if not (bool(torch.isfinite(wide.theta).all())
            and bool(torch.isfinite(wide.log_lik_hat).all())
            and wide.u.shape == (B_WIDE, S, N)):
        failures.append(f"{B_WIDE} chains: non-finite or wrong-shaped state")
    emit({"phase": "main_path_4096", "card": smi, "chains": B_WIDE,
          "step_wall_ms": wide_ms, "launches": counts_w,
          "ess_u/moved": float(info_w["ess_u/moved"].mean()),
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    del wide, info_w
    torch.cuda.empty_cache()
    end_phase()

    # -------------------------------------------------------- ARD main path
    ard = {}
    for mode, env, must, must_not in (
            ("sweep", None,
             ("se_gram_ard", "chol_panel", "fused_estimator", "ess_sweep",
              "threefry"),
             ("fused_estimator_rot", "sigma_sweep", *only_sharded,
              *only_bench)),
            ("loop", "0",
             ("se_gram_ard", "chol_panel", "fused_estimator",
              "fused_estimator_rot", "threefry"),
             ("ess_sweep", "sigma_sweep", *only_sharded, *only_bench))):
        log(f"main path (ARD, {mode}):", " ".join(ARD_CLI_ARGS))
        saved = os.environ.pop("AUXPM_ESS_SWEEP", None)
        if env is not None:
            os.environ["AUXPM_ESS_SWEEP"] = env   # read when the step is built
        try:
            fe.active_counts["estimate_rot"].reset()
            res, cnt = run_cli(ARD_CLI_ARGS, must, must_not)
            rot_share = fe.active_counts["estimate_rot"].share()
            st_a, tgt_a, par_a = res["states"], res["target"], res["params"]
            step_a = SAMPLERS["aux_slice"](tgt_a)
        finally:
            os.environ.pop("AUXPM_ESS_SWEEP", None)
            if saved is not None:
                os.environ["AUXPM_ESS_SWEEP"] = saved
        if step_a.stages["ess_u"].uses_sweep != (mode == "sweep"):
            raise AssertionError(f"ARD {mode}: wrong elliptical-slice path")
        if st_a.u.shape != (B_ARD, S, N) or not st_a.u.is_cuda or \
                st_a.theta.shape != (B_ARD, D_ARD + 1):
            raise AssertionError("ARD path did not run at full width on the "
                                 "GPU")
        if not np.isfinite(res["theta"]).all() or \
                not bool(torch.isfinite(st_a.log_lik_hat).all()):
            raise AssertionError("ARD path: non-finite theta or log L-hat")
        health_a = _sampler_health(res)
        # the carried factor against a fresh factorisation of the same theta:
        # the same routine on the same input, so the PR-1 bar holds
        cache_err_a = max_err(st_a.extras["target_cache"]["chol_r"],
                              tgt_a.cache_init(st_a.theta)["chol_r"])
        if not cache_err_a <= CHOL_TOL:
            raise AssertionError(f"ARD carried factor off by {cache_err_a:.3e}")
        # launches and host synchronisations per step, from a profiled window
        # (one step, three before phases 27-32: the traced steps took ~18 s
        # a mode)
        _, prof = profile_steps(step_a, st_a, par_a, 1)
        n_steps = 9                       # 1 x 3 warm-up + 6 sampled
        ard[mode] = {
            "launches": cnt, "summary": res["summary"],
            "chain_steps_per_sec": res["summary"]["chain_steps_per_sec"],
            "cache_max_abs_err": cache_err_a, **health_a,
            "own_kernel_launches_per_step": {
                k: round(c / n_steps, 2) for k, c in cnt.items()},
            "all_kernel_launches_per_step": prof["kernel_launches_per_step"],
            "host_syncs_per_step": prof["host_syncs_per_step"],
            "wall_ms_per_step": prof["wall_ms_per_step"],
            "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
            "device_idle_share": prof["device_idle_share"],
            # mean share of the chains active per rotated-estimate launch
            "rot_estimate_mean_active_share_per_call": rot_share,
        }
        if mode == "sweep":
            kernels["se_gram_ard"]["launches"] = cnt["se_gram_ard"]
        else:
            kernels["fused_estimator_rot"]["launches"] = \
                cnt["fused_estimator_rot"]
    emit({"phase": "main_path_ard", "card": smi, "args": ARD_CLI_ARGS,
          "sweep": ard["sweep"], "loop": ard["loop"]})
    end_phase()

    # ------------------------------------------------------ ARD path parity
    log("path parity (ARD, loop)")
    ess_a, sl_a = step_a.stages["ess_u"], step_a.stages["slice_theta"]
    rows_ea, _ = ess_a.draw(st_a)
    rows_sa, _ = sl_a.draw(st_a)

    def one_step_ard(state, probe_log=None):
        extra = {} if probe_log is None else {"probe_log": probe_log}
        mid, info_e = ess_a.apply(state, rows_ea, {**par_a["ess_u"], **extra})
        out, info_s = sl_a.apply(mid, rows_sa,
                                 {**par_a["slice_theta"], **extra})
        return out, {**info_e, **info_s}

    sa_k, ia_k = one_step_ard(st_a)
    probe_log = []
    with contextlib.ExitStack() as stack:
        for mod, cuda_fn, plain_fn in (
                (fe, "_cuda_estimate", fe._ref_estimate),
                (fe, "_cuda_estimate_rot", fe._ref_estimate_rot)):
            stack.enter_context(mock.patch.object(mod, cuda_fn, plain_fn))
        before = read_counts()
        sa_p, ia_p = one_step_ard(st_a, probe_log)
        after = read_counts()
        if any(after[k] != before[k] for k in after
               if k not in ("chol_panel", "se_gram_ard")):
            raise AssertionError("plain ARD path launched a patched kernel")
    torch.cuda.synchronize()
    amb_a = torch.zeros(B_ARD, dtype=torch.bool, device=dev)
    for counted, margin in probe_log:
        amb_a |= counted & (margin.abs() <= ARD_DECISION_TOL)
    agree_a = torch.ones(B_ARD, dtype=torch.bool, device=dev)
    for k in ia_k:
        agree_a &= ia_k[k] == ia_p[k]
    n_amb_a = int(amb_a.sum())
    n_bad_a = int((~agree_a & ~amb_a).sum())
    if n_amb_a > ARD_MAX_AMBIGUOUS:
        failures.append(f"path_parity_ard: {n_amb_a} of {B_ARD} chains had a "
                        "decision inside the tolerance")
    if n_bad_a:
        failures.append(f"path_parity_ard: decisions differ on {n_bad_a} "
                        "chains whose margins were all outside the tolerance")
    keep_a = agree_a
    parity_a = {
        "theta": check_close("path_parity_ard", "theta", sa_k.theta,
                             sa_p.theta, SIGMA_TOL, keep_a),
        "u": check_close("path_parity_ard", "u", sa_k.u, sa_p.u, U_TOL,
                         keep_a),
        "chol_r": check_close("path_parity_ard", "chol_r",
                              sa_k.extras["target_cache"]["chol_r"],
                              sa_p.extras["target_cache"]["chol_r"],
                              PATH_CHOL_TOL, keep_a),
        "ll": check_close("path_parity_ard", "ll", sa_k.log_lik_hat,
                          sa_p.log_lik_hat, ARD_PATH_LL_TOL, keep_a),
        "ll_vs_plain_estimate_of_own_state": check_close(
            "path_parity_ard", "ll of own state", sa_k.log_lik_hat,
            fe._ref_estimate(
                tgt_a.prepare_c(sa_k.theta, sa_k.extras["target_cache"]),
                sa_k.u, y, mask, "logistic", 8), LL_TOL, None, LL_RTOL),
    }
    emit({"phase": "path_parity_ard", "decisions_logged": len(probe_log),
          "chains_with_a_decision_inside_tolerance": n_amb_a,
          "excused_share": n_amb_a / B_ARD, "decision_tol": ARD_DECISION_TOL,
          "chains_with_a_differing_decision": int((~agree_a).sum()),
          "of_those_outside_tolerance": n_bad_a,
          "max_abs_err": parity_a,
          "probes": {k: float(v.sum()) for k, v in ia_k.items()}})
    end_phase()

    # ------------------------------------------------- loop ESS at n=1024
    # One aux_slice step with the per-probe elliptical-slice loop
    # (AUXPM_ESS_SWEEP=0, read when the step is built) on a synthetic GP
    # target at n = 1024, past the left operand that bounded the earlier
    # rotated-estimate kernel: the loop's probes go through that kernel.
    log(f"loop ESS at n={N_BIG}")
    from auxpm_tpu_torch.core.state import init_chain_states
    from auxpm_tpu_torch.utils.config import PRESETS, initial_params

    rng_1024 = np.random.default_rng(N_BIG)
    x_1024 = rng_1024.standard_normal((N_BIG - 37, D_ARD))
    y_1024 = rng_1024.choice([-1.0, 1.0], N_BIG - 37)
    tgt_1024 = make_gp_classification(x_1024, y_1024, n_importance=S,
                                      device="cuda")
    # the target's padded labels and mask, for the plain estimate below
    y_1024 = t(np.concatenate([y_1024, np.ones(37)]))
    mask_1024 = t(np.arange(N_BIG) < N_BIG - 37)
    if tgt_1024.u_shape != (S, N_BIG):
        raise AssertionError(f"loop ESS n={N_BIG}: u {tgt_1024.u_shape}")
    with mock.patch.dict(os.environ, {"AUXPM_ESS_SWEEP": "0"}):
        step_1024 = port_run_step(tgt_1024)
    if step_1024.stages["ess_u"].uses_sweep:
        raise AssertionError(f"loop ESS n={N_BIG}: the step took the sweep")
    st_1024 = init_chain_states(N_BIG, tgt_1024, B_BIG, with_cache=True)
    par_1024 = initial_params(PRESETS["pima_aux_slice"], tgt_1024)
    for m, attr in counters.values():
        setattr(m, attr, 0)
    t0 = time.time()
    out_1024, info_1024 = step_1024(st_1024, par_1024)
    torch.cuda.synchronize()
    step_1024_s = time.time() - t0
    cnt_1024 = read_counts()
    if cnt_1024["fused_estimator_rot"] <= 0:
        raise AssertionError(f"loop ESS n={N_BIG}: the rotated estimate "
                             f"never launched: {cnt_1024}")
    if not (bool(torch.isfinite(out_1024.theta).all())
            and bool(torch.isfinite(out_1024.log_lik_hat).all())
            and out_1024.u.shape == (B_BIG, S, N_BIG)):
        raise AssertionError(f"loop ESS n={N_BIG}: non-finite or misshapen "
                             "state")
    emit({"phase": "loop_ess_n1024", "B": B_BIG, "S": S, "n": N_BIG,
          "launches": cnt_1024, "step_seconds": step_1024_s,
          "ll_vs_plain_estimate_of_own_state": check_close(
              "loop_ess_n1024", "ll of own state", out_1024.log_lik_hat,
              fe._ref_estimate(
                  tgt_1024.prepare_c(out_1024.theta,
                                     out_1024.extras["target_cache"]),
                  out_1024.u, y_1024, mask_1024, "logistic", 8),
              LL_TOL, None, LL_RTOL),
          "probes": {k: float(v.sum()) for k, v in info_1024.items()}})
    del tgt_1024, st_1024, out_1024, y_1024, mask_1024
    end_phase()

    # -------------------------------------------------- sharded main path
    # Two ranks, each holding S / 2 rows of every chain's u: on the one card
    # of a one-card host over gloo (NCCL refuses ranks that share a card), on
    # a card each over NCCL where the host has more; the line reports which.
    # The ranks are fresh processes: they load the library built above and
    # count their own launches, which come back with their results.
    log("main path (sharded):", " ".join(SHARDED_CLI_ARGS))
    from auxpm_tpu_torch.parallel import rank_jobs
    from auxpm_tpu_torch.parallel.launch import spawn

    # The same spawn then runs path_parity_sharded's step: one step from
    # the first path's final state, on the same random rows, the sharded
    # path (two ranks) against the unsharded per-probe path (loop
    # elliptical-slice update, per-probe log_sigma: the same algorithm with
    # the estimator kernel where the sharded path has the weights kernel and
    # the collective), computed here first.
    import dataclasses

    tgt_loop = dataclasses.replace(tgt, ess_sweep_factory=None,
                                   sigma_sweep_factory=None)
    step_l = port_run_step(tgt_loop)
    ess_l, sl_l = step_l.stages["ess_u"], step_l.stages["slice_theta"]
    if ess_l.uses_sweep:
        raise AssertionError("sharded parity: the unsharded side took the "
                             "sweep")
    rows_el, _ = ess_l.draw(states)
    rows_sl, _ = sl_l.draw(states)
    probe_log = []
    mid_l, info_el = ess_l.apply(states, rows_el,
                                 {**params["ess_u"], "probe_log": probe_log})
    out_l, info_sl = sl_l.apply(mid_l, rows_sl, {**params["slice_theta"],
                                                 "probe_log": probe_log})
    torch.cuda.synchronize()
    info_l = {**{f"ess_u/{k_}": v_ for k_, v_ in info_el.items()},
              **{f"slice_theta/{k_}": v_ for k_, v_ in info_sl.items()}}
    amb_sh = torch.zeros(B, dtype=torch.bool, device=dev)
    for counted, margin in probe_log:
        amb_sh |= counted & (margin.abs() <= SHARDED_LL_TOL)

    def to_np(a):
        return a.detach().cpu().numpy()

    state_np = {"theta": to_np(states.theta), "u": to_np(states.u),
                "log_lik_hat": to_np(states.log_lik_hat),
                "chol_r": to_np(states.extras["target_cache"]["chol_r"])}
    rows_np = {"scal": to_np(rows_el["scal"]), "v": to_np(rows_el["v"]),
               "reps": tuple(to_np(r) for r in rows_sl)}
    params_np = {g: {k_: (to_np(v_) if torch.is_tensor(v_) else v_)
                     for k_, v_ in sub.items()} for g, sub in params.items()}
    t0 = time.time()
    per_rank_sh = spawn(       # 1 profiled step (3 before phases 27-32)
        rank_jobs.run_all, K_SHARDS,
        [("cli", SHARDED_CLI_ARGS, 1),
         ("step", ("gp", x, y_np, {"n_importance": S}), state_np, rows_np,
          params_np, {"n_ess": N_ESS, "n_sigma_extra": N_SIGMA - 1}, False,
          False),                       # no probe log, no factor back
         ("cli", CONFIG4_SMALL_ARGS)],  # main_path_config4's two ranks
        K_SHARDS, "cuda", timeout_s=600, threads=0)
    spawn_s = time.time() - t0
    del state_np, rows_np
    ranks = [r[0] for r in per_rank_sh]
    sh = [r[1] for r in per_rank_sh]
    config4_two_ranks = [r[2] for r in per_rank_sh]
    del per_rank_sh
    n_steps_sh = 3 + 6                    # 1 x 3 warm-up + 6 sampled
    r0 = ranks[0]
    shares = torch.cuda.device_count() < K_SHARDS    # one card for both
    for r in ranks:
        c = r["counts"]
        if r["u_shape"] != (B, S_LOCAL, N) or \
                (r["device"], r["backend"]) != (
                    ("cuda:0", "gloo") if shares
                    else (f"cuda:{r['rank']}", "nccl")):
            raise AssertionError(f"sharded rank {r['rank']}: u {r['u_shape']} "
                                 f"on {r['device']} over {r['backend']}")
        if c["fused_weights"] <= 0 or c["fused_rot_weights"] <= 0:
            raise AssertionError(f"sharded rank {r['rank']} never launched a "
                                 f"weights kernel: {c}")
        if any(c[k_] for k_ in ("fused_estimator", "fused_estimator_rot",
                                "ess_sweep", "sigma_sweep")):
            raise AssertionError(f"sharded rank {r['rank']} launched an "
                                 f"estimator or sweep kernel: {c}")
        if not (np.isfinite(r["recorded_theta"]).all()
                and np.isfinite(r["log_lik_hat"]).all()):
            raise AssertionError("sharded path: non-finite theta or log L-hat")
        if not r["cache_max_abs_err"] <= CHOL_TOL:
            raise AssertionError("sharded path: carried factor off by "
                                 f"{r['cache_max_abs_err']:.3e}")
    ranks_bitwise = all(
        np.array_equal(r["theta"], r0["theta"])
        and np.array_equal(r["log_lik_hat"], r0["log_lik_hat"])
        and np.array_equal(r["recorded_theta"], r0["recorded_theta"])
        for r in ranks)
    if not ranks_bitwise:
        raise AssertionError("sharded path: the ranks of the particle group "
                             "do not hold bitwise the same theta / log L-hat")
    health_sh = _sampler_health(r0)
    prof_sh = r0["profile"]
    for name in only_sharded:
        kernels[name]["launches"] = r0["counts"][name]
    emit({"phase": "main_path_sharded", "card": smi, "args": SHARDED_CLI_ARGS,
          "ranks": K_SHARDS, "backend": r0["backend"],
          "devices": [r["device"] for r in ranks], "target": r0["target"],
          "u_shape_per_rank": list(r0["u_shape"]),
          "summary": r0["summary"],
          "chain_steps_per_sec": r0["summary"]["chain_steps_per_sec"],
          "ranks_bitwise_equal": ranks_bitwise,
          "launches": [r["counts"] for r in ranks],
          "launches_per_step": {
              k_: round(r0["counts"][k_] / n_steps_sh, 2)
              for k_ in ("fused_weights", "fused_rot_weights", "chol_panel",
                         "collectives")},
          "rot_weights_mean_active_share_per_call":
              r0["rot_weights_active_share"],
          "cache_max_abs_err": r0["cache_max_abs_err"], **health_sh,
          "profile_rank0": {k_: prof_sh[k_] for k_ in (
              "wall_ms_per_step", "device_busy_ms_per_step",
              "device_idle_share", "kernel_launches_per_step",
              "host_syncs_per_step", "collectives_per_step",
              "collective_ms")},
          "device_ms_per_step_by_kernel":
              prof_sh["device_ms_per_step_by_kernel"],
          "seconds_with_start_up": round(spawn_s, 1)})
    end_phase()

    # ------------------------------------------------ sharded path parity
    # (the two ranks' step ran in phase 7's spawn, above)
    log("path parity (sharded)")
    group_bitwise = all(np.array_equal(r["theta"], sh[0]["theta"])
                        and np.array_equal(r["log_lik_hat"],
                                           sh[0]["log_lik_hat"]) for r in sh)
    if not group_bitwise:
        failures.append("path_parity_sharded: the two ranks differ in theta "
                        "or log L-hat")
    agree_sh = torch.ones(B, dtype=torch.bool, device=dev)
    for k_, v_ in info_l.items():
        agree_sh &= v_ == t(sh[0]["info"][k_])
    n_amb_sh = int(amb_sh.sum())
    n_bad_sh = int((~agree_sh & ~amb_sh).sum())
    if n_bad_sh:
        failures.append(f"path_parity_sharded: counts differ on {n_bad_sh} "
                        "chains whose margins were all outside the tolerance")
    if n_amb_sh > MAX_AMBIGUOUS:
        failures.append(f"path_parity_sharded: {n_amb_sh} chains had a "
                        "decision inside the tolerance")
    u_sh = torch.cat([t(r["u"]) for r in sh], dim=1)     # rows in rank order
    parity_sh = {
        "theta": check_close("path_parity_sharded", "theta",
                             t(sh[0]["theta"]), out_l.theta, SHARDED_LL_TOL,
                             agree_sh),
        "ll": check_close("path_parity_sharded", "ll",
                          t(sh[0]["log_lik_hat"]), out_l.log_lik_hat,
                          SHARDED_LL_TOL, agree_sh),
        "u": check_close("path_parity_sharded", "u", u_sh, out_l.u, U_TOL,
                         agree_sh),
    }
    emit({"phase": "path_parity_sharded", "ranks": K_SHARDS,
          "ranks_bitwise_equal": group_bitwise,
          "decisions_logged": len(probe_log),
          "chains_with_a_decision_inside_tolerance": n_amb_sh,
          "chains_with_a_differing_count": int((~agree_sh).sum()),
          "of_those_outside_tolerance": n_bad_sh,
          "bitwise_equal_to_unsharded": {
              "theta": bool(torch.equal(t(sh[0]["theta"]), out_l.theta)),
              "ll": bool(torch.equal(t(sh[0]["log_lik_hat"]),
                                     out_l.log_lik_hat)),
              "u": bool(torch.equal(u_sh, out_l.u))},
          "max_abs_err": parity_sh, "tol": SHARDED_LL_TOL,
          "launches_rank0": sh[0]["counts"],
          "probes": {k_: float(v_.sum()) for k_, v_ in info_l.items()}})
    end_phase()

    # ------------------------------------------------------ Cholesky routes
    # The v1 and v2 panel kernels' own path: the factorisation bench, which
    # runs every route at the bench's shape, and cholesky_fast on a size
    # that needs identity padding.
    log("chol variants")
    from auxpm_tpu_torch.utils import chol_bench

    for m, attr in counters.values():
        setattr(m, attr, 0)
    bench = chol_bench.bench(batch=B, n=N, reps=5)
    k532 = t(chol_bench.make_batch(B, 532, seed=1))
    l532 = chol_hopper.cholesky_fast(k532)
    torch.cuda.synchronize()
    counts_b = read_counts()
    for name in only_bench:
        if counts_b[name] <= 0:
            raise AssertionError(f"chol_variants: never launched {name}")
        kernels[name]["launches"] = counts_b[name]
    back532 = max_err(torch.bmm(l532, l532.mT), k532) / float(k532.abs().max())
    if l532.shape != k532.shape or not back532 <= CHOL_BACK_RTOL:
        failures.append(f"cholesky_fast n=532: backward error {back532:.3e}")
    for name, r in bench["routes"].items():
        if not (r["finite"] and r["lower"]
                and r["backward_err_rel"] <= CHOL_BACK_RTOL):
            failures.append(f"chol_variants: route {name}: {r}")
    for name, r in bench["panel_inverse_residual"].items():
        if not r <= CHOL_INV_TOL:
            failures.append(f"chol_variants: {name} inverse residual {r:.3e}")
    emit({"phase": "chol_variants", "card": smi, **bench,
          "cholesky_fast_n532_backward_err_rel": back532,
          "launches": {k_: counts_b[k_] for k_ in (*only_bench, "chol_panel")}})
    end_phase()

    # ------------------------------------------------ config 3 main path
    # abalone_aux as the CLI runs it (n = 1024, 32 chains, S = 64, stepping
    # out with max_step_out = 8, max_shrink_chol = 32), its main run under
    # --profile-dir: the ESS sweep, the ell probes' factorisations and
    # estimates; log_sigma per probe (the sigma sweep is for shrinkage-only
    # slices), so the sigma sweep must not launch.
    log("main path (config 3):", " ".join(CONFIG3_CLI_ARGS))
    import tempfile

    path3 = ("fused_estimator", "chol_panel", "ess_sweep", "threefry")
    not_path3 = ("sigma_sweep", "fused_estimator_rot", "se_gram_ard",
                 *only_sharded, *only_bench)
    with tempfile.TemporaryDirectory() as prof_dir:
        res3, cnt3 = run_cli(CONFIG3_CLI_ARGS + ["--profile-dir", prof_dir],
                             path3, not_path3)
        trace_file = os.path.join(prof_dir, "trace_rank0.json")
        trace_mb = os.path.getsize(trace_file) / 2**20
        with open(trace_file) as fh:
            trace_names = {e.get("name", "")
                           for e in json.load(fh)["traceEvents"]}
    traced = {k_: any(f"auxpm::{k_}" in nm for nm in trace_names)
              for k_ in TRACE_KERNELS}
    if not all(traced.values()):
        raise AssertionError(f"config 3: the trace lacks kernels: {traced}")
    st3, tgt3, par3 = res3["states"], res3["target"], res3["params"]
    if st3.u.shape != (B3, S, N3) or not st3.u.is_cuda:
        raise AssertionError(f"config 3 did not run at full width on the "
                             f"GPU: u {tuple(st3.u.shape)}")
    if not np.isfinite(res3["theta"]).all() or \
            not bool(torch.isfinite(st3.log_lik_hat).all()):
        raise AssertionError("config 3: non-finite theta or log L-hat")
    health3 = _sampler_health(res3)
    cache_err3 = max_err(st3.extras["target_cache"]["chol_r"],
                         tgt3.cache_init(st3.theta)["chol_r"])
    if not cache_err3 <= CHOL_TOL:
        raise AssertionError(f"config 3 carried factor off by "
                             f"{cache_err3:.3e}")
    step3 = SAMPLERS["aux_slice"](tgt3)
    if not step3.stages["ess_u"].uses_sweep:
        raise AssertionError("config 3: the step did not take the ESS sweep")
    _, prof3 = profile_steps(step3, st3, par3, 1)   # 3 before 27-32
    emit({"phase": "main_path_config3", "card": smi, "args": CONFIG3_CLI_ARGS,
          "B": B3, "S": S, "n": N3, "launches": cnt3,
          "summary": res3["summary"],
          # the main run is traced (--profile-dir): the host loop runs
          # slower than untraced, see "profile" for the untraced wall
          "chain_steps_per_sec": res3["summary"]["chain_steps_per_sec"],
          "chain_steps_per_sec_is_under_trace": True,
          "cache_max_abs_err": cache_err3, **health3,
          "trace_mb": trace_mb, "trace_names_kernels": traced,
          "profile": {k_: prof3[k_] for k_ in (
              "wall_ms_per_step", "device_busy_ms_per_step",
              "device_idle_share", "kernel_launches_per_step",
              "host_syncs_per_step")},
          "device_ms_per_step_by_kernel":
              prof3["device_ms_per_step_by_kernel"]})
    end_phase()

    # ---------------------------------------------- config 3 path parity
    # One step from the config-3 state on the same rows, the estimator and
    # the ESS sweep through their kernels and through their plain versions.
    # As in path_parity_ard, both sides factor every probe's Gram with the
    # panel kernel (the same factor bit for bit, so the comparison sees the
    # estimator and the sweep); the factor itself is held to the plain
    # panel below, at n = 1024 through the blocked factorisation.
    def step_parity(phase, step_, tgt_, state, par_, y_, mask_,
                    plain_sigma=False, max_ambiguous=CONFIG3_MAX_AMBIGUOUS):
        """One step of a composite from ``state`` on the same rows (every
        stage's, drawn up front) through the kernels and through the plain
        estimator and ESS sweep (and the plain sigma sweep with
        ``plain_sigma``); records failures and returns the comparison.  The
        ESS stage's u' and log L-hat (same theta, same factor on both sides;
        where there is an ESS stage) are held at the kernels' bars, the
        whole step's at the path bars (the carried factor where there is
        one), and the kernel step's log L-hat at the plain estimate of its
        own state at the estimator's bar."""
        b_ = state.theta.shape[0]
        stages = list(step_.stages.items())
        rows_ = {name: st_.draw(state)[0] for name, st_ in stages}

        def one_step(probe_log=None):
            extra = {} if probe_log is None else {"probe_log": probe_log}
            s_, mid, info = state, None, {}
            for name, st_ in stages:
                s_, i_ = st_.apply(s_, rows_[name], {**par_[name], **extra})
                mid = s_ if name == "ess_u" else mid
                info.update({f"{name}/{k_}": v_ for k_, v_ in i_.items()})
            return mid, s_, info

        mid_k, out_k, i_k = one_step()
        probe_log, ess_log = [], []

        def ref_ess_logged(*args):
            """The plain sweep, logging its decisions' margins: the ESS
            decisions follow the same rule as the slice's."""
            return ess._ref_ess_sweep(*args, probe_log=ess_log)

        patches = [(fe, "_cuda_estimate", fe._ref_estimate),
                   (ess, "_cuda_ess_sweep", ref_ess_logged)]
        if plain_sigma:
            patches.append((sig, "_cuda_sigma_sweep", sig._ref_sigma_sweep))
        with contextlib.ExitStack() as stack:
            for mod, cuda_fn, plain_fn in patches:
                stack.enter_context(mock.patch.object(mod, cuda_fn, plain_fn))
            before = read_counts()
            mid_p, out_p, i_p = one_step(probe_log)
            after = read_counts()
            if any(after[k_] != before[k_] for k_ in after
                   if k_ != "chol_panel"):
                raise AssertionError(f"{phase}: the plain path launched a "
                                     "patched kernel")
        torch.cuda.synchronize()
        amb_ = torch.zeros(b_, dtype=torch.bool, device=dev)
        for counted, margin in probe_log + ess_log:
            amb_ |= counted & (margin.abs() <= ARD_DECISION_TOL)
        amb_ess = torch.zeros(b_, dtype=torch.bool, device=dev)
        for counted, margin in ess_log:
            amb_ess |= counted & (margin.abs() <= ARD_DECISION_TOL)
        agree = torch.ones(b_, dtype=torch.bool, device=dev)
        for k_ in i_k:
            agree &= i_k[k_] == i_p[k_]
        n_amb_, n_bad = int(amb_.sum()), int((~agree & ~amb_).sum())
        if n_amb_ > max_ambiguous:
            failures.append(f"{phase}: {n_amb_} of {b_} chains had a decision "
                            "inside the tolerance")
        if n_bad:
            failures.append(f"{phase}: decisions differ on {n_bad} chains "
                            "whose margins were all outside the tolerance")
        if not bool(agree.any()):
            raise AssertionError(f"{phase}: no chain's decisions agree")
        parity = {}
        if mid_k is not None:     # a composite with an ESS stage
            parity["ess_u"] = check_close(phase, "u after the ESS sweep",
                                          mid_k.u, mid_p.u, U_TOL, agree)
            parity["ess_ll"] = check_close(phase, "ll after the ESS sweep",
                                           mid_k.log_lik_hat,
                                           mid_p.log_lik_hat, LL_TOL, agree,
                                           LL_RTOL)
        parity["theta"] = check_close(phase, "theta", out_k.theta,
                                      out_p.theta, SIGMA_TOL, agree)
        parity["u"] = check_close(phase, "u", out_k.u, out_p.u, U_TOL, agree)
        cache_k = out_k.extras.get("target_cache")
        if cache_k is not None:   # the carried factor of the aux_slice family
            parity["chol_r"] = check_close(
                phase, "chol_r", cache_k["chol_r"],
                out_p.extras["target_cache"]["chol_r"], PATH_CHOL_TOL, agree)
        parity["ll"] = check_close(phase, "ll", out_k.log_lik_hat,
                                   out_p.log_lik_hat, ARD_PATH_LL_TOL, agree)
        own = (tgt_.prepare(out_k.theta) if cache_k is None
               else tgt_.prepare_c(out_k.theta, cache_k))
        parity["ll_vs_plain_estimate_of_own_state"] = check_close(
            phase, "ll of own state", out_k.log_lik_hat,
            fe._ref_estimate(own, out_k.u, y_, mask_, "logistic", 8),
            LL_TOL, None, LL_RTOL)
        stats = {"decisions_logged": len(probe_log),
                 "ess_decisions_logged": len(ess_log),
                 "chains_with_a_decision_inside_tolerance": n_amb_,
                 "of_those_in_the_ess": int(amb_ess.sum()),
                 "decision_tol": ARD_DECISION_TOL,
                 "chains_with_a_differing_decision": int((~agree).sum()),
                 "of_those_outside_tolerance": n_bad,
                 "chains_compared": int(agree.sum()),
                 "probes": {k_: float(v_.sum()) for k_, v_ in i_k.items()}}
        return parity, stats

    def padded_labels(y_np, n_pad):
        return (t(np.concatenate([y_np, np.ones(n_pad - len(y_np))])),
                t(np.arange(n_pad) < len(y_np)))

    log("path parity (config 3)")
    # the target's data, padded labels and mask, for the plain estimate and
    # the factor below
    x3, y3_np = load("abalone", subsample=1024, seed=0)
    y3, mask3 = padded_labels(y3_np, N3)
    parity3, stats3 = step_parity("path_parity_config3", step3, tgt3, st3,
                                  par3, y3, mask3)
    # the factor at n = 1024 as the target computes it (robust_cholesky of
    # R(ell) + 1e-5 I at the chains' lengthscales: the blocked loop, the
    # jitter raised per matrix where a factorisation fails) over the panel
    # kernel and over the plain panel; held where both sides settled on the
    # same jitter (near-singular Grams may fail on one side only), which
    # must be all but CONFIG3_MAX_AMBIGUOUS chains, and the kernel may not
    # raise the jitter on more chains than the plain panel by more than that
    gram3 = se_gram_iso(t(_pima_sqdist(np, x3, N3)), st3.theta[:, 0], 0.0,
                        1e-5)
    l3_k, boost_k = cholesky._robust_cholesky_impl(gram3, jitter0=1e-5)
    with mock.patch.object(chol_hopper, "_cuda_chol_panel",
                           chol_hopper._ref_chol_panel):
        l3_p, boost_p = cholesky._robust_cholesky_impl(gram3, jitter0=1e-5)
    same_boost3 = boost_k == boost_p
    chains_boosted3 = {"kernel": int((boost_k > 0).sum()),
                       "plain": int((boost_p > 0).sum())}
    if int(same_boost3.sum()) < B3 - CONFIG3_MAX_AMBIGUOUS:
        raise AssertionError(f"path_parity_config3: only "
                             f"{int(same_boost3.sum())} of {B3} chains "
                             "settled on the same jitter")
    if (chains_boosted3["kernel"] - chains_boosted3["plain"]
            > CONFIG3_MAX_AMBIGUOUS):
        failures.append(f"path_parity_config3: the panel kernel raised the "
                        f"jitter on more chains: {chains_boosted3}")
    parity3["chol_n1024_kernel_vs_plain_panel"] = check_close(
        "path_parity_config3", "factor n=1024", l3_k, l3_p, PATH_CHOL_TOL,
        same_boost3)
    del gram3, l3_k, l3_p
    emit({"phase": "path_parity_config3", "B": B3, "n": N3, **stats3,
          "chains_with_a_raised_jitter": chains_boosted3,
          "chains_with_the_same_jitter": int(same_boost3.sum()),
          "max_abs_err": parity3})
    end_phase()

    # --------------------------------------------- full-n Abalone, one step
    # abalone_aux with --subsample 0: 4177 points padded to 4224, C of 71 MB
    # per chain (B n^2 4 bytes = 2.3 GB, past 2^31: every offset the kernels
    # form must be 64-bit, and the ESS sweep's item list holds 66 tiles);
    # one profiled step for its wall and busy time, the carried factor
    # against a fresh factorisation, then one more step from there through
    # the kernels and through the plain estimator and ESS sweep on the same
    # rows, held as path_parity_config3 holds n = 1024.
    log(f"one abalone_aux step at n={N_FULL}")
    from auxpm_tpu_torch.utils.config import (
        PRESETS,
        build_target,
        initial_params,
    )

    cfg_full = PRESETS["abalone_aux"].replace(subsample=0)
    t0 = time.time()
    tgt_full = build_target(cfg_full)
    if tgt_full.u_shape != (S, N_FULL):
        raise AssertionError(f"full-n Abalone: u {tgt_full.u_shape}")
    torch.cuda.reset_peak_memory_stats()
    st_full = init_chain_states(cfg_full.seed, tgt_full, cfg_full.chains,
                                jitter_scale=cfg_full.jitter_scale,
                                with_cache=True)
    torch.cuda.synchronize()
    setup_full_s = time.time() - t0
    step_full = SAMPLERS["aux_slice"](tgt_full)
    par_full = initial_params(cfg_full, tgt_full)
    for m, attr in counters.values():
        setattr(m, attr, 0)
    out_full, prof_full = profile_steps(step_full, st_full, par_full, 1)
    torch.cuda.synchronize()
    cnt_full = read_counts()
    for name in path3:
        if cnt_full[name] <= 0:
            failures.append(f"full-n Abalone: never launched {name}")
    for name in not_path3:
        if cnt_full[name] != 0:
            failures.append(f"full-n Abalone: launched {name}")
    if not (bool(torch.isfinite(out_full.theta).all())
            and bool(torch.isfinite(out_full.log_lik_hat).all())
            and out_full.u.shape == (cfg_full.chains, S, N_FULL)):
        failures.append("full-n Abalone: non-finite or misshapen state")
    cache_full = max_err(out_full.extras["target_cache"]["chol_r"],
                         tgt_full.cache_init(out_full.theta)["chol_r"])
    if not cache_full <= CHOL_TOL:
        failures.append(f"full-n Abalone: carried factor off by "
                        f"{cache_full:.3e}")
    y_full, mask_full = padded_labels(
        load("abalone", subsample=None, seed=cfg_full.seed)[1], N_FULL)
    parity_full, stats_full = step_parity(
        "abalone_full_n_step", step_full, tgt_full, out_full, par_full,
        y_full, mask_full)
    emit({"phase": "abalone_full_n_step", "card": smi,
          "B": cfg_full.chains, "S": S, "n": N_FULL,
          "setup_seconds": setup_full_s,
          "step_wall_ms": prof_full["wall_ms_per_step"],
          "step_device_busy_ms": prof_full["device_busy_ms_per_step"],
          "device_idle_share": prof_full["device_idle_share"],
          "kernel_launches_per_step": prof_full["kernel_launches_per_step"],
          "host_syncs_per_step": prof_full["host_syncs_per_step"],
          "launches_in_two_steps": cnt_full,
          "cache_max_abs_err": cache_full,
          "parity": stats_full, "max_abs_err": parity_full,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "device_ms_per_step_by_kernel":
              prof_full["device_ms_per_step_by_kernel"]})
    del tgt_full, st_full, out_full
    torch.cuda.empty_cache()
    end_phase()

    # ----------------------------------------------- PM-MH and aux_mh paths
    # The GP target at config 2's width with --sampler pm_mh (the proposal's
    # estimate at a fresh theta' and u': one factorisation and one estimate
    # per step, no carried factor), then --sampler aux_mh (adds the ESS
    # sweep), then the preset toy_pm_mh (the toy has no kernel).
    mh = {}
    for sampler, must in (("pm_mh", ("fused_estimator", "chol_panel",
                                     "threefry")),
                          ("aux_mh", ("fused_estimator", "chol_panel",
                                      "ess_sweep", "threefry"))):
        args = MH_CLI_ARGS + ["--sampler", sampler]
        log(f"main path ({sampler}):", " ".join(args))
        res_m, cnt_m = run_cli(args, must,
                               [k_ for k_ in counters if k_ not in must])
        st_m = res_m["states"]
        if st_m.u.shape != (B, S, N) or not st_m.u.is_cuda:
            raise AssertionError(f"{sampler} did not run at full width on "
                                 "the GPU")
        if "target_cache" in st_m.extras:
            raise AssertionError(f"{sampler} carried a factor")
        if not np.isfinite(res_m["theta"]).all() or \
                not bool(torch.isfinite(st_m.log_lik_hat).all()):
            raise AssertionError(f"{sampler}: non-finite theta or log L-hat")
        acc_key = "accept" if sampler == "pm_mh" else "mh_theta/accept"
        acc = [w_[acc_key] for w_ in res_m["windows"]]
        if not 0 < float(np.mean(acc)) < 1:
            raise AssertionError(f"{sampler}: acceptance {acc}")
        _, prof_m = profile_steps(res_m["step"], st_m, res_m["params"], 3)
        mh[sampler] = {
            "launches": cnt_m, "summary": res_m["summary"],
            "chain_steps_per_sec": res_m["summary"]["chain_steps_per_sec"],
            "acceptance_per_window": acc, "params": {
                k_: (v_ if not isinstance(v_, dict) else
                     {kk: float(vv) for kk, vv in v_.items()})
                for k_, v_ in res_m["params"].items()},
            **{k_: prof_m[k_] for k_ in (
                "wall_ms_per_step", "device_busy_ms_per_step",
                "device_idle_share", "kernel_launches_per_step",
                "host_syncs_per_step")}}
    log("main path (toy_pm_mh):", " ".join(TOY_CLI_ARGS))
    res_toy, _ = run_cli(TOY_CLI_ARGS, ("threefry",),
                         tuple(k_ for k_ in counters if k_ != "threefry"))
    acc_toy = [w_["accept"] for w_ in res_toy["windows"]]
    if not (res_toy["states"].theta.is_cuda
            and np.isfinite(res_toy["theta"]).all()
            and 0 < float(np.mean(acc_toy)) < 1):
        raise AssertionError(f"toy_pm_mh: {res_toy['summary']}, acceptance "
                             f"{acc_toy}")
    mh["toy_pm_mh"] = {
        "summary": res_toy["summary"],
        "chain_steps_per_sec": res_toy["summary"]["chain_steps_per_sec"],
        "acceptance_per_window": acc_toy,
        "posterior_mean_exact":
            res_toy["target"].posterior_mean.cpu().tolist()}
    emit({"phase": "main_path_pm_mh", "card": smi, "args": MH_CLI_ARGS,
          "toy_args": TOY_CLI_ARGS, **mh})
    end_phase()

    # ----------------------------------------------- bitwise resume, config 2
    # 2K steps without a break against K steps, a checkpoint saved and
    # loaded into a fresh state, and K more: theta, u, log L-hat and the
    # carried factor bitwise equal.  The same kernels on the same inputs
    # must give the same bits on every repeat for this to hold.
    log("resume bitwise (config 2)")
    from auxpm_tpu_torch.utils.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )

    def fresh2():
        return init_chain_states(11, tgt, B, jitter_scale=0.3,
                                 with_cache=True)

    whole, _, _ = run_chains(step, fresh2(), params, 2 * K_RESUME)
    half, _, _ = run_chains(step, fresh2(), params, K_RESUME)
    ckpt_cfg = {"phase": "resume_bitwise", "args": CLI_ARGS}
    with tempfile.TemporaryDirectory() as ckpt_dir:
        t0 = time.time()
        save_checkpoint(ckpt_dir, half, step=K_RESUME, config=ckpt_cfg,
                        params=params)
        save_s = time.time() - t0
        ckpt_mb = sum(os.path.getsize(os.path.join(ckpt_dir, f_))
                      for f_ in os.listdir(ckpt_dir)) / 2**20
        del half
        t0 = time.time()
        loaded, at, params_l = load_checkpoint(ckpt_dir, fresh2(),
                                               config=ckpt_cfg)
        load_s = time.time() - t0
    rest, _, _ = run_chains(step, loaded, params_l, K_RESUME)
    torch.cuda.synchronize()
    bitwise = {
        "theta": bool(torch.equal(rest.theta, whole.theta)),
        "u": bool(torch.equal(rest.u, whole.u)),
        "log_lik_hat": bool(torch.equal(rest.log_lik_hat,
                                        whole.log_lik_hat)),
        "chol_r": bool(torch.equal(rest.extras["target_cache"]["chol_r"],
                                   whole.extras["target_cache"]["chol_r"])),
    }
    moved = not bool(torch.equal(whole.theta, fresh2().theta))
    if not all(bitwise.values()) or not moved or at != K_RESUME:
        failures.append(f"resume_bitwise: {bitwise}, moved {moved}, step "
                        f"{at}")
    emit({"phase": "resume_bitwise", "B": B, "steps": 2 * K_RESUME,
          "bitwise_equal": bitwise, "checkpoint_mb": ckpt_mb,
          "save_seconds": save_s, "load_seconds": load_s})
    del whole, rest, loaded
    end_phase()

    # -------------------------------------------- the remaining theta samplers
    # Each new sampler through the CLI on config 2's target at full width
    # (CLI_ARGS: 128 chains, shrinkage-only slices, four ESS repeats, one
    # extra log_sigma update, max_shrink_chol 3; 1 x 5 warm-up + 10 steps),
    # then an n_prof-step profile from its final state: wall and busy time,
    # and the launches of each kernel per step (profile_steps runs its steps
    # twice, untraced for the wall time, then traced).
    n_prof = 1                     # 3 before phases 27-32 (script time)
    theta_runs, finals = {}, {}
    for sampler, move_key in THETA_SAMPLERS.items():
        aux = sampler.startswith("aux_slice")
        must = (("fused_estimator", "chol_panel", "threefry")
                + (("ess_sweep",) if aux else ())
                + (("sigma_sweep",) if aux and sampler != "aux_slice_rd"
                   else ()))
        args = THETA_CLI_ARGS + ["--sampler", sampler]
        log(f"main path ({sampler}):", " ".join(args))
        res_s, cnt_s = run_cli(args, must,
                               [k_ for k_ in counters if k_ not in must])
        st_s = res_s["states"]
        if st_s.u.shape != (B, S, N) or not st_s.u.is_cuda:
            raise AssertionError(f"{sampler} did not run at full width on "
                                 "the GPU")
        if ("target_cache" in st_s.extras) != aux:
            raise AssertionError(f"{sampler}: carried factor "
                                 f"{'missing' if aux else 'carried'}")
        if not np.isfinite(res_s["theta"]).all() or \
                not bool(torch.isfinite(st_s.log_lik_hat).all()):
            raise AssertionError(f"{sampler}: non-finite theta or log L-hat")
        moved = [w_[move_key] for w_ in res_s["windows"]]
        if not max(moved) > 0:
            raise AssertionError(f"{sampler} never moved: {move_key} "
                                 f"{moved}")
        for m, attr in counters.values():
            setattr(m, attr, 0)
        st_p, prof_s = profile_steps(res_s["step"], st_s, res_s["params"],
                                     n_prof)
        torch.cuda.synchronize()
        per_step = {k_: v_ / (2 * n_prof) for k_, v_ in read_counts().items()
                    if k_ in first_path}
        theta_runs[sampler] = {
            "launches": cnt_s,
            "chain_steps_per_sec": res_s["summary"]["chain_steps_per_sec"],
            f"{move_key}_per_window": moved,
            **({"ess_u/moved": res_s["windows"][-1]["ess_u/moved"]}
               if aux else {}),
            "theta_finite": True,
            "kernel_launches_per_step_by_kernel": per_step,
            **{k_: prof_s[k_] for k_ in (
                "wall_ms_per_step", "device_busy_ms_per_step",
                "device_idle_share", "kernel_launches_per_step",
                "host_syncs_per_step", "device_ms_per_step_by_kernel")}}
        if sampler in ("aux_slice_pcrd", "aux_slice_joint"):
            finals[sampler] = (st_p, res_s["step"], res_s["target"],
                               res_s["params"])
        del res_s, st_s
    emit({"phase": "main_path_theta_samplers", "card": smi,
          "args": THETA_CLI_ARGS, **theta_runs})
    end_phase()

    # ------------------------------------- theta samplers: path parity
    # One step of aux_slice_pcrd and of aux_slice_joint from the phase's
    # final states on the same rows, through the kernels and through the
    # plain estimator, ESS sweep and sigma sweep (the panel kernel shared, as
    # in path_parity_config3); then the factor at each state's theta through
    # robust_cholesky over the panel kernel and over the plain panel, held
    # where both sides settled on the same jitter.
    log("path parity (theta samplers)")
    parity_theta = {}
    for sampler, (st_, step_, tgt_, par_) in finals.items():
        phase_ = f"path_parity_theta_samplers/{sampler}"
        parity_, stats_ = step_parity(phase_, step_, tgt_, st_, par_, y, mask,
                                      plain_sigma=True,
                                      max_ambiguous=THETA_MAX_AMBIGUOUS)
        gram_ = se_gram_iso(sqdist, st_.theta[:, 0], 0.0, 1e-5)
        l_k, boost_k = cholesky._robust_cholesky_impl(gram_, jitter0=1e-5)
        with mock.patch.object(chol_hopper, "_cuda_chol_panel",
                               chol_hopper._ref_chol_panel):
            l_p, boost_p = cholesky._robust_cholesky_impl(gram_,
                                                          jitter0=1e-5)
        same_ = boost_k == boost_p
        if int(same_.sum()) < B - THETA_MAX_AMBIGUOUS:
            raise AssertionError(f"{phase_}: only {int(same_.sum())} of {B} "
                                 "chains settled on the same jitter")
        parity_["chol_kernel_vs_plain_panel"] = check_close(
            phase_, "factor", l_k, l_p, PATH_CHOL_TOL, same_)
        parity_theta[sampler] = {
            **stats_, "chains_with_the_same_jitter": int(same_.sum()),
            "max_abs_err": parity_}
        del gram_, l_k, l_p
    del finals
    emit({"phase": "path_parity_theta_samplers", "B": B, **parity_theta})
    end_phase()

    # ------------------------------------------------ the Laplace proposal
    # aux_slice on config 2's target with the Laplace proposal (S = 16): every
    # probe's prepare is 1 + 6 + 2 factorisations through the panel kernel
    # and two cholesky_solve calls; the log-weights are plain PyTorch (no
    # estimator kernel takes the proposal's tuple), so the panel is the one
    # kernel this path launches.  Then one prepare at the fixed theta batch
    # of the kernels phase, jitter 1e-3, with the panel kernel and with the
    # plain panel: f-hat, chol_q and half log|Sigma_q| held on the chains
    # where every factorisation of both sides settled on the same jitter.
    log("main path (laplace):", " ".join(LAPLACE_CLI_ARGS))
    torch.cuda.reset_peak_memory_stats()
    res_l, cnt_l = run_cli(LAPLACE_CLI_ARGS, ("chol_panel", "threefry"),
                           [k_ for k_ in counters
                            if k_ not in ("chol_panel", "threefry")])
    st_l = res_l["states"]
    if st_l.u.shape != (B, S_LAPLACE, N) or not st_l.u.is_cuda:
        raise AssertionError("laplace did not run at full width on the GPU")
    if not res_l["target"].name.endswith("_laplace") or st_l.extras:
        raise AssertionError(f"laplace: target {res_l['target'].name}, "
                             f"extras {sorted(st_l.extras)}")
    if not np.isfinite(res_l["theta"]).all() or \
            not bool(torch.isfinite(st_l.log_lik_hat).all()):
        raise AssertionError("laplace: non-finite theta or log L-hat")
    win_l = res_l["windows"][-1]
    if not (win_l["ess_u/moved"] > 0.5 and win_l["slice_theta/n_probe"] > 0):
        raise AssertionError(f"laplace: sampler health {win_l}")
    n_prof_l = 1                   # 2 before phases 27-32 (script time)
    for m, attr in counters.values():
        setattr(m, attr, 0)
    _, prof_l = profile_steps(res_l["step"], st_l, res_l["params"], n_prof_l)
    torch.cuda.synchronize()
    panel_per_step_l = read_counts()["chol_panel"] / (2 * n_prof_l)
    peak_l = torch.cuda.max_memory_allocated() / 1e9
    summary_l = res_l["summary"]
    del res_l, st_l
    tgt_l3 = make_gp_classification(x, y_np, n_importance=S_LAPLACE,
                                    proposal="laplace",
                                    jitter=LAPLACE_JITTER, device="cuda")
    impl = cholesky._robust_cholesky_impl
    boosts = []

    def recording_impl(gram_, *a_, **kw_):
        l_, extra_ = impl(gram_, *a_, **kw_)
        boosts.append(extra_)
        return l_, extra_

    with mock.patch.object(cholesky, "_robust_cholesky_impl",
                           recording_impl):
        prep_k = tgt_l3.prepare(theta)
        boosts_k, boosts[:] = list(boosts), []
        with mock.patch.object(chol_hopper, "_cuda_chol_panel",
                               chol_hopper._ref_chol_panel):
            before = read_counts()
            prep_p = tgt_l3.prepare(theta)
            if read_counts() != before:
                raise AssertionError("laplace prepare: the plain path "
                                     "launched a kernel")
        boosts_p = list(boosts)
    torch.cuda.synchronize()
    if len(boosts_k) != 9 or len(boosts_p) != 9:
        raise AssertionError(f"laplace prepare: {len(boosts_k)} and "
                             f"{len(boosts_p)} factorisations, not 1 + 6 + 2")
    same_l = torch.ones(B, dtype=torch.bool, device=dev)
    for bk, bp in zip(boosts_k, boosts_p):
        same_l &= bk == bp
    if int(same_l.sum()) < B - THETA_MAX_AMBIGUOUS:
        raise AssertionError(f"laplace prepare: only {int(same_l.sum())} of "
                             f"{B} chains settled on the same jitters")
    prep_parity = {
        "f_hat": check_close("laplace prepare", "f_hat", prep_k[1],
                             prep_p[1], LAPLACE_F_TOL, same_l),
        "chol_q": check_close("laplace prepare", "chol_q", prep_k[2],
                              prep_p[2], LAPLACE_CHOL_TOL, same_l),
        "half_logdet_q": check_close("laplace prepare", "half_logdet_q",
                                     prep_k[3], prep_p[3],
                                     LAPLACE_LOGDET_TOL, same_l),
        "chol_k": check_close("laplace prepare", "chol_k", prep_k[0],
                              prep_p[0], PATH_CHOL_TOL, same_l),
    }
    emit({"phase": "main_path_laplace", "card": smi, "args": LAPLACE_CLI_ARGS,
          "launches": cnt_l,
          "chain_steps_per_sec": summary_l["chain_steps_per_sec"],
          "ess_u/moved": win_l["ess_u/moved"],
          "slice_theta/n_probe": win_l["slice_theta/n_probe"],
          "chol_panel_launches_per_step": panel_per_step_l,
          "peak_memory_gb": peak_l,
          **{k_: prof_l[k_] for k_ in (
              "wall_ms_per_step", "device_busy_ms_per_step",
              "device_idle_share", "kernel_launches_per_step",
              "host_syncs_per_step", "device_ms_per_step_by_kernel")},
          "prepare_parity": {
              "jitter": LAPLACE_JITTER,
              "chains_with_the_same_jitters": int(same_l.sum()),
              "chains_with_a_raised_jitter": {
                  "kernel": int(sum((b_ > 0) for b_ in boosts_k).gt(0).sum()),
                  "plain": int(sum((b_ > 0) for b_ in boosts_p).gt(0).sum())},
              "tol": {"f_hat": LAPLACE_F_TOL, "chol_q": LAPLACE_CHOL_TOL,
                      "half_logdet_q": LAPLACE_LOGDET_TOL,
                      "chol_k": PATH_CHOL_TOL},
              "max_abs_err": prep_parity}})
    del prep_k, prep_p, tgt_l3
    torch.cuda.empty_cache()
    end_phase()

    # ------------------------------------------------------- gradient parity
    # grad of log L-hat at a state's theta (B = 128 isotropic, 64 ARD at the
    # pima_ard_aux widths) through the kernel forwards of the estimator, the
    # panel and the ARD Gram, against the same autograd Functions with their
    # plain forwards, on the card; held on the chains where both sides chose
    # the same jitter; then against the float64 gradient of the plain path
    # and against its float64 central differences at step 1e-4 (5 % of
    # max(|fd|, 1)); then the reference's finite-difference check (step
    # 1e-2, 5 %) on the kernel path at the reference's size; then the
    # forward and backward ms of each Function.
    log("gradient parity")
    from auxpm_tpu_torch.core.state import init_chain_states as init_states
    from auxpm_tpu_torch.samplers import hmc as hmc_mod

    def plain_forwards():
        stack = contextlib.ExitStack()
        for mod, cuda_fn, plain_fn in (
                (fe, "_cuda_estimate", fe._ref_estimate),
                (chol_hopper, "_cuda_chol_panel", chol_hopper._ref_chol_panel),
                (gr, "_cuda_se_gram_ard", gr.se_gram_ard_masked)):
            stack.enter_context(mock.patch.object(mod, cuda_fn, plain_fn))
        return stack

    impl_rc = cholesky._robust_cholesky_impl

    def ll_grad(tgt_, theta_, u_, grad=True):
        """log L-hat, its gradient (or None) and the jitter each chain's
        factor settled on."""
        boosts_ = []

        def recording(gram_, *a_, **kw_):
            l_, e_ = impl_rc(gram_, *a_, **kw_)
            boosts_.append(e_)
            return l_, e_

        with mock.patch.object(cholesky, "_robust_cholesky_impl", recording):
            th_ = theta_.detach().clone().requires_grad_(grad)
            with torch.set_grad_enabled(grad):
                ll_ = tgt_.log_lik_est(th_, u_)
            g_ = torch.autograd.grad(ll_.sum(), th_)[0] if grad else None
        torch.cuda.synchronize()
        return ll_.detach(), g_, boosts_[0]

    tgt_ard = make_gp_classification(x, y_np, n_importance=S, ard=True,
                                     device="cuda")
    x_pad64 = torch.as_tensor(np.concatenate(
        [x, np.zeros((N - len(x), D_ARD), x.dtype)]), dtype=torch.float64,
        device=dev)
    sq64 = np.full((N, N), 1e30)
    sq64[:len(x), :len(x)] = ((np.asarray(x, np.float64)[:, None]
                               - np.asarray(x, np.float64)[None]) ** 2).sum(-1)
    np.fill_diagonal(sq64, 0.0)
    sq64 = torch.as_tensor(sq64, device=dev)
    y64, mask64 = y.double(), mask.double()

    def ll_f64(gram_fn):
        """log L-hat in float64 through the plain path (no jitter raise)."""
        def f(th_, u_):
            l_, info_ = torch.linalg.cholesky_ex(gram_fn(th_))
            l_ = torch.where((info_ > 0)[:, None, None],
                             torch.full_like(l_, float("nan")), l_)
            chol_ = torch.exp(th_[:, -1])[:, None, None] * l_
            return fe._ref_estimate(chol_, u_, y64, mask64, "logistic", 8)
        return f

    gram_f64 = {
        "iso": ll_f64(lambda th_: se_gram_iso(sq64, th_[:, 0], 0.0, 1e-5)),
        "ard": ll_f64(lambda th_: gr.se_gram_ard_masked(
            x_pad64, th_[:, :-1], 1e-5, mask64)),
    }
    grad_parity = {}
    for label, tgt_, b_ in (("iso", target, B), ("ard", tgt_ard, B_ARD)):
        st_g = init_states(21, tgt_, b_, jitter_scale=0.3)
        for m, attr in counters.values():
            setattr(m, attr, 0)
        ll_k, g_k, boost_k = ll_grad(tgt_, st_g.theta, st_g.u)
        cnt_g = read_counts()
        must = ("fused_estimator", "chol_panel") + (
            ("se_gram_ard",) if label == "ard" else ())
        for name in must:
            if cnt_g[name] <= 0:
                raise AssertionError(f"grad_parity/{label}: the gradient "
                                     f"never launched {name}")
        with plain_forwards():
            before = read_counts()
            ll_p, g_p, boost_p = ll_grad(tgt_, st_g.theta, st_g.u)
            if read_counts() != before:
                raise AssertionError(f"grad_parity/{label}: the plain "
                                     "forwards launched a kernel")
        same = boost_k == boost_p
        if int(same.sum()) < b_ - THETA_MAX_AMBIGUOUS:
            raise AssertionError(f"grad_parity/{label}: only "
                                 f"{int(same.sum())} of {b_} chains settled "
                                 "on the same jitter")
        scale = torch.clamp(g_p.abs(), min=1.0)
        rel_k = ((g_k - g_p).abs() / scale)[same]
        if not bool(torch.isfinite(g_k).all()) or float(rel_k.max()) > \
                GRAD_RTOL:
            failures.append(f"grad_parity/{label}: |g_kernel - g_plain| / "
                            f"max(|g|, 1) = {float(rel_k.max()):.3e} > "
                            f"{GRAD_RTOL}")
        # the same gradient in float64 through the plain path (the Gram, the
        # library's factor and the plain estimate, autograd), held to its own
        # central differences at FD_STEP_F64 (converged: second order); the
        # kernel path's gradient is held to that float64 gradient and to
        # those differences at the reference's 5 % bar, on the chains whose
        # factor took no extra jitter.  Central differences at the
        # reference's step 1e-2 are too coarse at this width, in float64 too
        # (tests/test_torch_grad.py::
        # test_fd_step_of_the_reference_is_too_coarse_at_full_width), and on
        # the kernel path f32 noise of log L-hat (up to ~1e-2 where the Gram
        # is near singular) is ~1 in a difference over 2e-2: both reported,
        # not held; the step-1e-2 check is held at the reference's size.
        f64 = gram_f64[label]

        def ll64(th_):
            return f64(th_, st_g.u.double())

        th64 = st_g.theta.double().requires_grad_(True)
        (g64,) = torch.autograd.grad(ll64(th64).sum(), th64)
        keep64 = (boost_k == 0) & torch.isfinite(g64).all(-1)
        rel64 = ((g_k.double() - g64).abs()
                 / torch.clamp(g64.abs(), min=1.0))[keep64]
        if int(keep64.sum()) < b_ // 2 or float(rel64.max()) > GRAD_RTOL:
            failures.append(f"grad_parity/{label}: kernel vs float64 "
                            f"gradient {float(rel64.max()):.3e} on "
                            f"{int(keep64.sum())} of {b_} chains")

        def fd_rel(fd_, g_):
            return (fd_ - g_).abs() / torch.clamp(fd_.abs(), min=1.0)

        err = {k_: torch.zeros_like(g64) for k_ in (
            "f64_fine", "kernel_fine", "f64_coarse", "kernel_coarse",
            "kernel_f32_coarse")}
        with torch.no_grad():
            for i_ in range(tgt_.d):
                for h_, tag in ((FD_STEP_F64, "fine"), (FD_STEP, "coarse")):
                    step_ = torch.zeros_like(g64)
                    step_[:, i_] = h_
                    th0 = st_g.theta.double()
                    fd64 = (ll64(th0 + step_) - ll64(th0 - step_)) / (2 * h_)
                    err[f"f64_{tag}"][:, i_] = fd_rel(fd64, g64[:, i_])
                    err[f"kernel_{tag}"][:, i_] = fd_rel(
                        fd64, g_k[:, i_].double())
                step_ = torch.zeros_like(st_g.theta)
                step_[:, i_] = FD_STEP
                fd32 = (ll_grad(tgt_, st_g.theta + step_, st_g.u, False)[0]
                        - ll_grad(tgt_, st_g.theta - step_, st_g.u, False)[0]
                        ) / (2 * FD_STEP)
                err["kernel_f32_coarse"][:, i_] = fd_rel(
                    fd32.double(), g_k[:, i_].double())
        fd_max = {k_: float(v_[keep64].max()) for k_, v_ in err.items()}
        if not fd_max["f64_fine"] < FD_F64_RTOL:
            failures.append(f"grad_parity/{label}: float64 gradient vs its "
                            f"differences at {FD_STEP_F64}: "
                            f"{fd_max['f64_fine']:.3e}")
        if not fd_max["kernel_fine"] < FD_RTOL:
            failures.append(f"grad_parity/{label}: kernel gradient vs "
                            f"float64 differences at {FD_STEP_F64}: "
                            f"{fd_max['kernel_fine']:.3e}")
        grad_parity[label] = {
            "B": b_, "d": tgt_.d, "launches_under_the_gradient": cnt_g,
            "chains_with_the_same_jitter": int(same.sum()),
            "chains_with_a_raised_jitter": {
                "kernel": int((boost_k > 0).sum()),
                "plain": int((boost_p > 0).sum())},
            "grad_max_rel_err": float(rel_k.max()), "grad_rtol": GRAD_RTOL,
            "ll_max_abs_err": max_err(ll_k[same], ll_p[same]),
            "grad_abs_max": float(g_k.abs().max()),
            "chains_vs_float64": int(keep64.sum()),
            "grad_vs_float64_max_rel_err": float(rel64.max()),
            "grad_vs_float64_median_rel_err": float(rel64.median()),
            "fd_max_rel_err": fd_max,
            "fd_chains_over_5_percent": {
                k_: int((v_[keep64] >= FD_RTOL).any(-1).sum())
                for k_, v_ in err.items()},
            "fd_steps": {"fine": FD_STEP_F64, "coarse": FD_STEP},
            "fd_rtol": FD_RTOL, "fd_f64_rtol": FD_F64_RTOL}
        del st_g
    # the reference's own check (tests/test_hmc_nuts.py:
    # test_gp_estimator_gradient_matches_fd) on the kernel path: Pima
    # subsampled to 32 points (padded to 128), S = 8, theta = [0.2, -0.1],
    # step 1e-2, |fd - g| < 5 % of max(|fd|, 1) in each coordinate
    x32, y32 = load("pima", subsample=FD_N)
    tgt32 = make_gp_classification(x32, y32, n_importance=FD_S,
                                   device="cuda")
    u32 = t(np.random.default_rng(4).standard_normal((1, *tgt32.u_shape)))
    th32 = t([[0.2, -0.1]])
    for m, attr in counters.values():
        setattr(m, attr, 0)
    _, g32, _ = ll_grad(tgt32, th32, u32)
    if read_counts()["fused_estimator"] <= 0:
        raise AssertionError("grad_parity: the reference's check did not "
                             "launch the estimator")
    fd_ref = []
    for i_ in range(2):
        step_ = torch.zeros_like(th32)
        step_[0, i_] = FD_STEP
        fd_ = float((ll_grad(tgt32, th32 + step_, u32, False)[0]
                     - ll_grad(tgt32, th32 - step_, u32, False)[0])
                    / (2 * FD_STEP))
        fd_ref.append({"fd": fd_, "grad": float(g32[0, i_]),
                       "rel_err": abs(fd_ - float(g32[0, i_]))
                       / max(abs(fd_), 1.0)})
        if not fd_ref[-1]["rel_err"] < FD_RTOL:
            failures.append(f"grad_parity: the reference's finite-difference "
                            f"check, coordinate {i_}: {fd_ref[-1]}")
    grad_parity["reference_fd_check"] = {
        "n": FD_N, "n_padded": tgt32.u_shape[1], "S": FD_S,
        "theta": [0.2, -0.1], "step": FD_STEP, "rtol": FD_RTOL,
        "coordinates": fd_ref}
    # forward and backward ms of each Function at the main paths' shapes
    th_t = init_states(21, target, B, jitter_scale=0.3).theta
    gram_t = se_gram_iso(sqdist, th_t[:, 0], 0.0, 1e-5).requires_grad_(True)
    l_t, _ = cholesky.RobustCholesky.apply(gram_t, 1e-5, 10.0, 3)
    lbar_t = torch.randn_like(l_t)
    chol_g = chol.detach().clone().requires_grad_(True)
    u_g = u.detach().clone().requires_grad_(True)
    est_t = fe.FusedEstimate.apply(chol_g, u_g, y, mask, "logistic", 8, None,
                                   "float32")
    u_w = u[:, :S_LOCAL].contiguous().requires_grad_(True)
    w_t = fe.FusedWeights.apply(chol_g, u_w, y, mask, "logistic", "float32")
    x_pad_g = t(np.concatenate([x, np.zeros((N - len(x), D_ARD), x.dtype)]))
    le_g = t(rng.normal(size=(B_ARD, D_ARD)) * 0.3 + 1.5).requires_grad_(
        True)
    r_t = gr.SeGramArd.apply(x_pad_g, le_g, 1e-5, mask)
    rbar_t = torch.randn_like(r_t)
    g_est, g_w = torch.randn_like(est_t), torch.randn_like(w_t)
    function_ms = {
        "robust_cholesky": {
            "forward_ms": time_ms(lambda: cholesky.RobustCholesky.apply(
                gram_t.detach(), 1e-5, 10.0, 3)),
            "backward_ms": time_ms(lambda: torch.autograd.grad(
                l_t, gram_t, lbar_t, retain_graph=True))},
        "fused_estimator": {
            "forward_ms": time_ms(lambda: fe.FusedEstimate.apply(
                chol, u, y, mask, "logistic", 8, None, "float32")),
            "backward_ms": time_ms(lambda: torch.autograd.grad(
                est_t, (chol_g, u_g), g_est, retain_graph=True))},
        "fused_weights": {
            "forward_ms": time_ms(lambda: fe.FusedWeights.apply(
                chol, u_w.detach(), y, mask, "logistic", "float32")),
            "backward_ms": time_ms(lambda: torch.autograd.grad(
                w_t, (chol_g, u_w), g_w, retain_graph=True))},
        "se_gram_ard": {
            "forward_ms": time_ms(lambda: gr.SeGramArd.apply(
                x_pad_g, le_g.detach(), 1e-5, mask)),
            "backward_ms": time_ms(lambda: torch.autograd.grad(
                r_t, le_g, rbar_t, retain_graph=True))},
    }
    shapes = {"robust_cholesky": [B, N, N], "fused_estimator": [B, S, N],
              "fused_weights": [B, S_LOCAL, N], "se_gram_ard": [B_ARD, N, D_ARD]}
    for k_, v_ in function_ms.items():
        v_["shape"] = shapes[k_]
    del gram_t, l_t, lbar_t, chol_g, u_g, est_t, u_w, w_t, r_t, rbar_t
    torch.cuda.empty_cache()
    emit({"phase": "grad_parity", "card": smi, **grad_parity,
          "function_ms": function_ms})
    end_phase()

    # ---------------------------------------------- HMC and NUTS, main path
    # --sampler aux_hmc, then aux_nuts, through the CLI on config 2's target
    # at 128 chains (2 warm-up windows of HMC_WINDOW steps with dual
    # averaging and the mass, then HMC_WINDOW steps): the estimator, the
    # panel and the ESS sweep
    # must launch, no other kernel; then a one-step profile from the final
    # state (profile_steps runs its steps twice; 3 steps before phases
    # 27-32: a NUTS step traced takes ~20 s, more where the state asks for
    # deeper trees).
    n_prof_h = 1
    hmc_runs, finals_h = {}, {}
    for sampler, group in (("aux_hmc", "hmc"), ("aux_nuts", "nuts")):
        args = HMC_CLI_ARGS + ["--sampler", sampler]
        log(f"main path ({sampler}):", " ".join(args))
        must = ("fused_estimator", "chol_panel", "ess_sweep", "threefry")
        res_h, cnt_h = run_cli(args, must,
                               [k_ for k_ in counters if k_ not in must])
        st_h = res_h["states"]
        if st_h.u.shape != (B, S, N) or not st_h.u.is_cuda:
            raise AssertionError(f"{sampler} did not run at full width on "
                                 "the GPU")
        if not np.isfinite(res_h["theta"]).all() or \
                not bool(torch.isfinite(st_h.log_lik_hat).all()):
            raise AssertionError(f"{sampler}: non-finite theta or log L-hat")
        par_h = res_h["params"][group]
        inv_mass = par_h["inv_mass"]
        if not (isinstance(par_h["step_size"], float)
                and 0 < par_h["step_size"] < 10
                and bool(torch.isfinite(inv_mass).all())
                and bool((inv_mass > 0).all())):
            raise AssertionError(f"{sampler}: frozen params {par_h}")
        if any(k_.startswith("da_") for k_ in st_h.extras):
            raise AssertionError(f"{sampler}: dual averaging left in extras")
        win = res_h["windows"]
        stats = {k_: float(np.mean([w_[f"{group}/{k_}"] for w_ in win]))
                 for k_ in (("accept", "accept_prob", "diverged")
                            if group == "hmc" else
                            ("depth", "n_leapfrog", "accept_prob",
                             "diverged"))}
        if not stats["accept_prob"] > 0.2:
            raise AssertionError(f"{sampler}: mean accept statistic "
                                 f"{stats['accept_prob']}")
        for m, attr in counters.values():
            setattr(m, attr, 0)
        hmc_mod.grad_calls = hmc_mod.grad_rows = hmc_mod.host_syncs = 0
        syncs0 = cholesky.host_syncs
        st_p, prof_h = profile_steps(res_h["step"], st_h, res_h["params"],
                                     n_prof_h)
        torch.cuda.synchronize()
        n_run = 2 * n_prof_h
        cnt_p = read_counts()
        hmc_runs[sampler] = {
            "launches": cnt_h,
            "chain_steps_per_sec": res_h["summary"]["chain_steps_per_sec"],
            "frozen_step_size": par_h["step_size"],
            "frozen_inv_mass": inv_mass.tolist(),
            "warmup": [{k_: v_ for k_, v_ in h_.items()
                        if k_.startswith(group)} for h_ in res_h["history"]],
            "main_run_means": stats,
            "divergences_in_main_run": round(float(np.sum(
                [w_[f"{group}/diverged"] for w_ in win])) * B * HMC_WINDOW),
            "gradient_calls_per_step": hmc_mod.grad_calls / n_run,
            "chain_gradients_per_chain_step":
                hmc_mod.grad_rows / (n_run * B),
            "chol_panel_launches_per_step": cnt_p["chol_panel"] / n_run,
            "fused_estimator_launches_per_step":
                cnt_p["fused_estimator"] / n_run,
            "robust_cholesky_host_syncs_per_step":
                (cholesky.host_syncs - syncs0) / n_run,
            "sampler_host_syncs_per_step": hmc_mod.host_syncs / n_run,
            **{k_: prof_h[k_] for k_ in (
                "wall_ms_per_step", "device_busy_ms_per_step",
                "device_idle_share", "kernel_launches_per_step",
                "host_syncs_per_step", "device_ms_per_step_by_kernel")}}
        finals_h[group] = (st_p, res_h["step"].stages[group],
                           res_h["params"][group])
        del res_h, st_h
    emit({"phase": "main_path_hmc_nuts", "card": smi, "args": HMC_CLI_ARGS,
          **hmc_runs})
    end_phase()

    # ---------------------------------------------- HMC and NUTS, path parity
    # One theta move of each from its run's final state on the same draws,
    # through the estimator kernel and through its plain version (the panel
    # kernel shared, as in path_parity_theta_samplers).  Both sides then
    # compute bitwise the same gradients (the same factor, the same plain
    # backward), so theta follows the same trajectory; the energies differ
    # by the estimator's rounding, and a decision whose margin sat inside
    # HMC_DECISION_TOL may fall either way: such chains are excused and
    # counted.  HMC: the accept bits equal; NUTS: depth, n_leapfrog and the
    # chosen point equal; theta within GRAD_PATH_THETA_TOL and log L-hat
    # within the estimator's bar on the others.
    log("path parity (HMC, NUTS)")
    path_h = {}
    for group, (st_, stage_, par_) in finals_h.items():
        rows_, _ = stage_.draw(st_, par_)
        for m, attr in counters.values():
            setattr(m, attr, 0)
        out_k, i_k = stage_.apply(st_, rows_, par_)
        if read_counts()["fused_estimator"] <= 0:
            raise AssertionError(f"path_parity_hmc_nuts/{group}: the kernel "
                                 "path never launched the estimator")
        plog = []
        with mock.patch.object(fe, "_cuda_estimate", fe._ref_estimate):
            before = read_counts()
            out_p, i_p = stage_.apply(st_, rows_, {**par_, "probe_log": plog})
            if read_counts()["fused_estimator"] != before["fused_estimator"]:
                raise AssertionError(f"path_parity_hmc_nuts/{group}: the "
                                     "plain path launched the estimator")
        torch.cuda.synchronize()
        amb = torch.zeros(B, dtype=torch.bool, device=dev)
        for kind, counted, margin in plog:
            tol_ = UTURN_DECISION_TOL if kind == "uturn" else HMC_DECISION_TOL
            amb |= counted & (margin.abs() <= tol_)
        keys = ("accept", "diverged") if group == "hmc" else (
            "depth", "n_leapfrog", "diverged")
        agree = torch.ones(B, dtype=torch.bool, device=dev)
        for k_ in keys:
            agree &= i_k[k_] == i_p[k_]
        point = (out_k.theta - out_p.theta).abs().max(-1).values \
            <= GRAD_PATH_THETA_TOL
        n_amb, n_bad = int(amb.sum()), int((~(agree & point) & ~amb).sum())
        if n_amb > THETA_MAX_AMBIGUOUS:
            failures.append(f"path_parity_hmc_nuts/{group}: {n_amb} chains "
                            "had a decision inside the tolerance")
        if n_bad:
            failures.append(f"path_parity_hmc_nuts/{group}: decisions or the "
                            f"chosen point differ on {n_bad} chains whose "
                            "margins were all outside the tolerance")
        keep = agree & point
        path_h[group] = {
            "decisions_logged": len(plog),
            "chains_with_a_decision_inside_tolerance": n_amb,
            "decision_tol": HMC_DECISION_TOL,
            "chains_with_a_differing_decision": int((~agree).sum()),
            "of_those_outside_tolerance": n_bad,
            "chains_compared": int(keep.sum()),
            "max_abs_err": {
                "theta": check_close(f"path_parity_hmc_nuts/{group}",
                                     "theta", out_k.theta, out_p.theta,
                                     GRAD_PATH_THETA_TOL, keep),
                "ll": check_close(f"path_parity_hmc_nuts/{group}", "ll",
                                  out_k.log_lik_hat, out_p.log_lik_hat,
                                  LL_TOL, keep, LL_RTOL)},
            "means": {k_: float(v_.mean()) for k_, v_ in i_k.items()}}
    del finals_h
    emit({"phase": "path_parity_hmc_nuts", "B": B, **path_h})
    end_phase()

    # --------------------------------------------------------- SMC, one card
    # --sampler smc on config 2's target: aux_slice rejuvenation at 1024
    # particles, then aux_nuts at 256, two MCMC steps per stage.  The
    # tempered target has no sweep factory, so neither sweep kernel may
    # launch; the estimator and the panel must.  A stage hook counts the
    # launches of kernels 1 and 2 in each stage.
    from auxpm_tpu_torch.samplers import smc as smc_mod

    make_smc_real = smc_mod.make_smc
    smc_runs = {}
    for rejuv, n_part in SMC_RUNS:
        args = SMC_CLI_ARGS + ["--smc-rejuvenation", rejuv, "--particles",
                               str(n_part)]
        log(f"main path (smc, {rejuv}):", " ".join(args))
        per_stage = []

        def make_smc_counting(*a_, **kw_):
            run_ = make_smc_real(*a_, **kw_)

            def run_counting(seed, **kw2):
                last = [read_counts()]

                def on_stage(s_, b_, st_, info_):
                    now = read_counts()
                    per_stage.append({k_: now[k_] - last[0][k_] for k_ in
                                      ("fused_estimator", "chol_panel")})
                    last[0] = now

                return run_(seed, on_stage=on_stage, **kw2)

            return run_counting

        must = ("fused_estimator", "chol_panel", "threefry")
        with mock.patch.object(smc_mod, "make_smc", make_smc_counting):
            res_s, cnt_s = run_cli(args, must,
                                   [k_ for k_ in counters if k_ not in must])
        diag = res_s["diag"]
        st_s = res_s["states"]
        if st_s.u.shape != (n_part, S, N) or not st_s.u.is_cuda:
            raise AssertionError(f"smc/{rejuv} did not run at full width on "
                                 "the GPU")
        if not math.isfinite(diag["log_z"]) or diag["betas"][-1] < 1.0:
            raise AssertionError(f"smc/{rejuv}: logZ {diag['log_z']}, final "
                                 f"beta {diag['betas'][-1]}")
        if not bool(torch.isfinite(st_s.theta).all()):
            raise AssertionError(f"smc/{rejuv}: non-finite particles")
        smc_runs[rejuv] = {
            "particles": n_part, "n_stages": diag["n_stages"],
            "betas": diag["betas"], "log_z": diag["log_z"],
            "stage_seconds": diag["stage_seconds"],
            "wall_s": res_s["summary"]["wall"],
            "launches_per_stage": per_stage, "launches": cnt_s,
            "sweep_kernel_launches": cnt_s["ess_sweep"] + cnt_s["sigma_sweep"],
            "posterior_mean": res_s["summary"]["posterior_mean"],
            "posterior_std": res_s["summary"]["posterior_std"]}
        del res_s, st_s
        torch.cuda.empty_cache()
    emit({"phase": "main_path_smc", "card": smi, "args": SMC_CLI_ARGS,
          **smc_runs})
    end_phase()

    # ------------------------------------------------------ PRNG on the card
    # core/prng.py against jax.random's values (written once with JAX into
    # core/prng_golden.json; the card has no JAX) and against the CPU.
    log("prng on the card")

    def ulps(a, b):
        return _ulps(torch, a, b)

    golden = prng.load_golden()
    worst_ulp, n_values = 0, 0
    for seed in golden["seeds"]:
        want = golden["cases"][str(seed)]
        got_card = prng.golden_cases(seed, dev)
        got_cpu = prng.golden_cases(seed, "cpu")
        for name, w in want.items():
            n_values += len(w)
            g = torch.tensor(got_card[name], dtype=torch.int64)
            w = torch.tensor(w, dtype=torch.int64)
            if name == "normal":
                worst_ulp = max(worst_ulp, ulps(g, w))
            elif not torch.equal(g, w):
                failures.append(f"prng_card: seed {seed} {name} differs "
                                "from jax.random")
            if name != "normal" and got_card[name] != got_cpu[name]:
                failures.append(f"prng_card: seed {seed} {name}: card and "
                                "CPU differ")
    if worst_ulp > PRNG_ULP:
        failures.append(f"prng_card: normals {worst_ulp} ulp from jax.random")
    # a chunk-shaped draw, card vs CPU (8 particles of it)
    keys_c = prng.split(prng.key(2026).to(dev), PRNG_CHUNK[0])
    small = keys_c[:8]
    u_card = prng.uniform(small, PRNG_CHUNK[1:]).cpu()
    u_cpu = prng.uniform(small.cpu(), PRNG_CHUNK[1:])
    z_card = prng.normal(small, PRNG_CHUNK[1:]).cpu()
    z_cpu = prng.normal(small.cpu(), PRNG_CHUNK[1:])
    if not torch.equal(u_card, u_cpu):
        failures.append("prng_card: chunk uniforms, card and CPU differ")
    chunk_ulp = ulps(z_card.view(torch.int32), z_cpu.view(torch.int32))
    if chunk_ulp > PRNG_ULP:
        failures.append(f"prng_card: chunk normals {chunk_ulp} ulp off the "
                        "CPU")
    normal_ms = time_ms(lambda: prng.normal(keys_c, PRNG_CHUNK[1:]))
    n_normals = math.prod(PRNG_CHUNK)
    emit({"phase": "prng_card", "card": smi, "golden_values": n_values,
          "golden_jax_version": golden["jax_version"],
          "normal_max_ulp_vs_jax": worst_ulp,
          "chunk_normal_max_ulp_card_vs_cpu": chunk_ulp,
          "chunk_shape": list(PRNG_CHUNK), "chunk_normal_ms": normal_ms,
          "normals_per_s": n_normals / (normal_ms / 1e3)})
    del keys_c, small
    end_phase()

    # ------------------------------------------------- sharded SMC, two ranks
    # The three runs through rank_jobs.cli on two ranks sharing the card
    # (gloo), one spawn for all three (one start-up); the ranks count their
    # own launches per stage (stage -1 is the init).
    smc_sh = {}
    log("main path (sharded smc):", "; ".join(
        " ".join(args) for args, _ in SMC_SHARDED_RUNS.values()))
    t0 = time.time()
    per_rank_s = spawn(rank_jobs.run_all, K_SHARDS,
                       [("cli", args) for args, _ in
                        SMC_SHARDED_RUNS.values()], 1, "cuda",
                       timeout_s=900, threads=0)
    wall_spawn = time.time() - t0
    for i_run, (run_name, (args, must)) in enumerate(
            SMC_SHARDED_RUNS.items()):
        ranks_s = [r[i_run] for r in per_rank_s]
        r0 = ranks_s[0]
        diag = r0["diag"]
        for r in ranks_s:
            if r["diag"]["betas"] != diag["betas"] or \
                    r["diag"]["log_z"] != diag["log_z"]:
                raise AssertionError(f"{run_name}: the ranks disagree on the "
                                     "betas or logZ")
            if not (np.isfinite(r["theta"]).all()
                    and np.isfinite(r["log_lik_hat"]).all()):
                raise AssertionError(f"{run_name}: non-finite particles")
            for name in must:
                if r["counts"][name] <= 0:
                    raise AssertionError(f"{run_name}: rank {r['rank']} "
                                         f"never launched {name}")
            if r["device"] != "cuda:0" and torch.cuda.device_count() == 1:
                raise AssertionError(f"{run_name}: ran on {r['device']}")
            err = r.get("key_u_invariant_max_abs_err")
            if err is not None and not err <= LL_TOL + LL_RTOL * float(
                    np.abs(r["log_lik_hat"]).max()):
                failures.append(f"{run_name}: log L-hat off the estimate "
                                f"at the keys' u by {err:.3e}")
        if not math.isfinite(diag["log_z"]) or diag["betas"][-1] < 1.0:
            raise AssertionError(f"{run_name}: logZ {diag['log_z']}, final "
                                 f"beta {diag['betas'][-1]}")
        acc = diag.get("u_mh_accept")
        if run_name == "b_u_blocks" and not acc[-1] >= U_BLOCKS_ACCEPT_FLOOR:
            failures.append(f"{run_name}: last-stage refresh acceptance "
                            f"{acc[-1]} below {U_BLOCKS_ACCEPT_FLOOR}")
        per_stage = [{k_: (round(v_, 3) if isinstance(v_, float) else v_)
                      for k_, v_ in st.items() if k_ in (
                          "stage", "beta", "fused_estimator", "chol_panel",
                          "fused_weights", "collectives", "collective_ms",
                          "threefry_ms", "threefry_calls")}
                     for st in r0["stages"]]
        smc_sh[run_name] = {
            "args": args, "n_stages": diag["n_stages"],
            "betas": diag["betas"], "log_z": diag["log_z"],
            "u_mh_accept": acc, "stage_seconds": diag["stage_seconds"],
            "wall_s": r0["summary"]["wall"],
            "u_shape_per_rank": list(r0["u_shape"]),
            "backend": r0["backend"],
            "peak_mem_gb_per_rank": [r["peak_mem_gb"] for r in ranks_s],
            "key_u_invariant_max_abs_err": [
                r.get("key_u_invariant_max_abs_err") for r in ranks_s],
            "per_stage_rank0": per_stage,
            "launches": [r["counts"] for r in ranks_s],
            "posterior_mean": r0["summary"]["posterior_mean"],
            "posterior_std": r0["summary"]["posterior_std"]}
    emit({"phase": "main_path_smc_sharded", "card": smi, "ranks": K_SHARDS,
          **smc_sh, "spawn_wall_s_all_runs": wall_spawn})
    del per_rank_s
    end_phase()

    # ----------------------------------------- sharded SMC, path parity
    # A world of one rank in this process.  One key-as-u stage of run (a)'s
    # configuration from the same population, through the estimator kernel
    # and through its plain version (the panel kernel shared: both sides
    # factor every Gram with the same jitter); then run (b)'s configuration
    # twice, rejuv_dispatches 1 and 2.
    log("path parity (sharded smc)")
    import tempfile

    import torch.distributed as dist

    from auxpm_tpu_torch.parallel.mesh import (
        INIT_METHOD_ENV,
        distributed_init,
        make_mesh,
    )
    from auxpm_tpu_torch.samplers.composite import THETA_ONLY
    from auxpm_tpu_torch.samplers.smc_sharded import make_smc_sharded

    world_dir = tempfile.mkdtemp(prefix="auxpm_world_")
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "LOCAL_WORLD_SIZE": "1",
           INIT_METHOD_ENV: f"file://{world_dir}/rendezvous"}
    with mock.patch.dict(os.environ, env):
        distributed_init("cuda")
        mesh1 = make_mesh(1)
    try:
        tgt_a = make_gp_classification(x, y_np, n_importance=SMC_PARITY_S,
                                       device="cuda")
        run_a = make_smc_sharded(tgt_a, THETA_ONLY["nuts"],
                                 SMC_PARITY_PARTICLES, mesh1, n_mcmc=2,
                                 carry_u=False, n_u_mh=2, rejuv_batch=256)
        st0, k_loop = run_a.init_states(0)
        beta0 = torch.zeros((), dtype=torch.float32, device=dev)
        for m, attr in counters.values():
            setattr(m, attr, 0)
        plog_k = []
        torch.cuda.synchronize()
        t0 = time.time()
        prng.start_timing()          # one process alone on the card
        out_k = run_a.stage(st0, beta0, k_loop, 0, probe_log=plog_k)
        threefry_ms_a = prng.stop_timing()
        stage_s_a = time.time() - t0
        if read_counts()["fused_estimator"] <= 0:
            raise AssertionError("path_parity_smc_sharded: the kernel path "
                                 "never launched the estimator")
        plog_p = []
        with mock.patch.object(fe, "_cuda_estimate", fe._ref_estimate):
            before = read_counts()
            out_p = run_a.stage(st0, beta0, k_loop, 0, probe_log=plog_p)
            if read_counts()["fused_estimator"] != before["fused_estimator"]:
                raise AssertionError("path_parity_smc_sharded: the plain "
                                     "path launched the estimator")
        torch.cuda.synchronize()
        (sk, bk, zk, ak, dk), (sp, bp, zp, ap, dp) = out_k, out_p
        npart = SMC_PARITY_PARTICLES
        if not torch.equal(dk["idx"], dp["idx"]) or float(bk) != float(bp):
            failures.append("path_parity_smc_sharded: resampling or beta "
                            "differ")
        amb = torch.zeros(npart, dtype=torch.bool, device=dev)
        amb |= ((dk["imh_margin"].abs() <= HMC_DECISION_TOL)
                | (dp["imh_margin"].abs() <= HMC_DECISION_TOL)).any(1)
        for kind, counted, margin in plog_p:
            tol_ = UTURN_DECISION_TOL if kind == "uturn" else HMC_DECISION_TOL
            amb |= counted & (margin.abs() <= tol_)
        agree = (dk["imh_accept"] == dp["imh_accept"]).all(1)
        for k_ in ("depth", "n_leapfrog", "diverged"):
            agree &= dk[f"nuts/{k_}"] == dp[f"nuts/{k_}"]
        point = (sk.theta - sp.theta).abs().max(-1).values \
            <= GRAD_PATH_THETA_TOL
        n_amb, n_bad = int(amb.sum()), int((~(agree & point) & ~amb).sum())
        if n_amb > SMC_MAX_AMBIGUOUS:
            failures.append(f"path_parity_smc_sharded: {n_amb} particles "
                            "had a decision inside the tolerance")
        if n_bad:
            failures.append(f"path_parity_smc_sharded: decisions or theta "
                            f"differ on {n_bad} particles whose margins were "
                            "all outside the tolerance")
        keep = agree & point
        parity_a = {
            "particles": npart, "S": SMC_PARITY_S,
            "beta": float(bk), "idx_equal": bool(torch.equal(dk["idx"],
                                                             dp["idx"])),
            "imh_accept_rate": float(dk["imh_accept"].float().mean()),
            "stage_seconds_kernel_path": stage_s_a,
            "threefry_ms_of_the_stage": threefry_ms_a,
            "nuts_depth_mean": float(dk["nuts/depth"].mean()),
            "decisions_logged": len(plog_p),
            "particles_with_a_decision_inside_tolerance": n_amb,
            "particles_with_a_differing_decision": int((~agree).sum()),
            "of_those_outside_tolerance": n_bad,
            "particles_compared": int(keep.sum()),
            "max_abs_err": {
                "theta": check_close("path_parity_smc_sharded", "theta",
                                     sk.theta, sp.theta, GRAD_PATH_THETA_TOL,
                                     keep),
                "ll": check_close("path_parity_smc_sharded", "ll",
                                  sk.log_lik_hat, sp.log_lik_hat, LL_TOL,
                                  keep, LL_RTOL),
                "log_z_inc": abs(float(zk) - float(zp))}}
        del run_a, st0, out_k, out_p, sk, sp, dk, dp

        # run (b)'s configuration, two stages, one or two groups
        tgt_b = make_gp_classification(x, y_np, n_importance=S,
                                       device="cuda")
        outs_b = []
        for k_disp in (1, 2):
            run_b = make_smc_sharded(
                tgt_b, THETA_ONLY["mh_theta"], 512, mesh1, n_mcmc=2,
                carry_u=False, n_u_mh=1, u_blocks=8, rejuv_batch=512,
                rejuv_dispatches=k_disp)
            outs_b.append(run_b(0, stop_after=2))
        (sb1, db1), (sb2, db2) = outs_b
        bitwise_b = (db1["betas"] == db2["betas"]
                     and db1["log_z"] == db2["log_z"]
                     and db1["u_mh_accept"] == db2["u_mh_accept"]
                     and all(torch.equal(getattr(sb1, f), getattr(sb2, f))
                             for f in ("theta", "u", "log_lik_hat"))
                     and torch.equal(sb1.key, sb2.key))
        if not bitwise_b:
            failures.append("path_parity_smc_sharded: rejuv_dispatches 1 "
                            "and 2 differ")
        del outs_b, sb1, sb2
    finally:
        dist.destroy_process_group()
    emit({"phase": "path_parity_smc_sharded", "stage_a": parity_a,
          "dispatches_1_vs_2": {"particles": 512, "stages": 2,
                                "rejuv_batch": 512, "bitwise_equal":
                                bitwise_b, "betas": db1["betas"],
                                "u_mh_accept": db1["u_mh_accept"]}})
    end_phase()

    # ------------------------------------------- config 4: gp_4096_sharded
    # The preset on one rank at its 4096 chains for a few steps (its depth
    # cut), then at 256 chains on one rank against two ranks sharing the
    # card (gloo): every chain draws from its own key, so the records must
    # be bitwise equal.  Fixed params (no warm-up): the adaptation averages
    # over chain shards in another order.  Each rank counts its own
    # launches around its run.
    log("config 4:", " ".join(CONFIG4_CLI_ARGS))
    from auxpm_tpu_torch.parallel import rank_jobs
    from auxpm_tpu_torch.parallel.launch import spawn

    torch.cuda.empty_cache()    # the child needs the card's memory
    # one rank runs the preset at 4096 chains, then 256 chains for the
    # layout check (one start-up); two ranks ran the 256 chains in phase 7's
    # spawn (one start-up fewer)
    ((c4, small1),) = spawn(rank_jobs.run_all, 1,
                            [("cli", CONFIG4_CLI_ARGS),
                             ("cli", CONFIG4_SMALL_ARGS)], 1, "cuda",
                            timeout_s=900)
    for name in ("fused_estimator", "chol_panel", "ess_sweep",
                 "threefry_launches"):
        if c4["counts"][name] <= 0:
            failures.append(f"main_path_config4: never launched {name}")
    rec4 = c4["recorded_theta"]
    if rec4.shape != (CONFIG4_CHAINS, CONFIG4_STEPS, 2) or \
            not np.isfinite(rec4).all():
        failures.append(f"main_path_config4: records {rec4.shape}, finite "
                        f"{bool(np.isfinite(rec4).all())}")
    layouts = {1: [small1], 2: config4_two_ranks}   # (phase 7's spawn)
    rec1 = layouts[1][0]["recorded_theta"]
    invariance = {
        "records_1_vs_2_ranks_bitwise": bool(
            np.array_equal(rec1, layouts[2][0]["recorded_theta"])
            and np.array_equal(rec1, layouts[2][1]["recorded_theta"])),
        "log_lik_1_vs_2_ranks_bitwise": bool(np.array_equal(
            layouts[1][0]["log_lik_hat"],
            np.concatenate([r["log_lik_hat"] for r in layouts[2]]))),
        "backends": [layouts[1][0]["backend"], layouts[2][0]["backend"]],
        "chains": CONFIG4_SMALL_CHAINS, "steps": CONFIG4_SMALL_STEPS,
        "records_shape": list(rec1.shape),
    }
    if not (invariance["records_1_vs_2_ranks_bitwise"]
            and invariance["log_lik_1_vs_2_ranks_bitwise"]):
        failures.append("main_path_config4: 1 and 2 ranks differ")
    emit({"phase": "main_path_config4", "card": smi,
          "args": CONFIG4_CLI_ARGS, "chains": CONFIG4_CHAINS,
          "step_wall_ms": 1e3 * c4["summary"]["wall"] / CONFIG4_STEPS,
          "chain_steps_per_sec": c4["summary"]["chain_steps_per_sec"],
          "windows_wall_s": [w_["wall"] for w_ in c4["windows"]],
          "peak_memory_gb": c4["peak_mem_gb"], "launches": c4["counts"],
          "threefry_launches_per_step":
              c4["counts"]["threefry_launches"] / CONFIG4_STEPS,
          "ess_u/moved": c4["windows"][-1]["ess_u/moved"],
          "layout_invariance": invariance})
    del layouts, c4
    end_phase()

    # ------------------- the fourteenth slice: gradients through the fold
    # (its two-rank spawn also runs the fifteenth slice's two-rank jobs)
    ctx = types.SimpleNamespace(
        torch=torch, np=np, smi=smi, x=x, y_np=y_np, y=y, mask=mask, t=t,
        dev=dev,
        run_cli=run_cli, counters=counters, read_counts=read_counts,
        step_parity=step_parity, check_close=check_close, failures=failures,
        end_phase=end_phase)
    jobs15, local15 = joint_sharded_jobs(ctx)
    per_rank15, spawn_s15 = gradient_phases(
        torch, np, smi, x, y_np, run_cli, counters, read_counts, check_close,
        failures, end_phase, extra_jobs=jobs15)

    # ---------- the fifteenth slice: paths the card had not run, config 5
    scale_phases(ctx, local15, per_rank15, spawn_s15)

    # ---------------------------- every shape the reference runs (33-35)
    any_shape_phases(types.SimpleNamespace(
        **vars(ctx), time_ms=time_ms, kernels=kernels,
        chol=chol, chol_r=chol_r, theta=theta, log_prior=target.log_prior,
        ambiguous_chains=ambiguous_chains, check_counts=check_counts))

    # ------------------------- the reference's measuring scripts (phase 36)
    bench_scripts_phase(ctx)

    # ---------------------------------------------------------------- result
    emit({"kernels": [
        {key: k[key] for key in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "tol", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        | {"kernel_ms": k["ms"]}
        for k in kernels.values()]})
    print(smi, flush=True)
    log(f"chip_smoke: {time.time() - t_start:.1f} s in all")
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0



def gradient_phases(torch, np, smi, x, y_np, run_cli, counters, read_counts,
                    check_close, failures, end_phase, extra_jobs=()):
    """main_path_laplace_grad, main_path_sharded_grad and
    main_path_laplace_sharded (phases 24-26 of the module note), with
    ``main``'s helpers: the launch counters and the CLI runner, the failure
    list and the closing check of a phase.  The two sharded phases share one
    spawn of two ranks (one start-up), which also runs ``extra_jobs`` (of
    later phases) after theirs; returns their results per rank and the
    spawn's seconds."""
    import dataclasses

    from auxpm_tpu_torch.core.state import init_chain_states
    from auxpm_tpu_torch.models.gp_classification import make_gp_classification
    from auxpm_tpu_torch.ops import fused_estimator as fe
    from auxpm_tpu_torch.ops.gram import se_gram_iso
    from auxpm_tpu_torch.ops.logsumexp import blocked_logsumexp
    from auxpm_tpu_torch.parallel import rank_jobs
    from auxpm_tpu_torch.parallel.launch import spawn

    laplace_grad_phase(torch, np, smi, x, y_np, run_cli, counters,
                       read_counts, failures, end_phase)

    # ---------------------------- HMC, NUTS and Laplace on two ranks
    # --sharded true --particle-shards 2 on two spawned ranks sharing the
    # card: aux_hmc at 128 chains, aux_nuts at 64, each after one warm-up
    # window with dual averaging and then profiled on each rank; the
    # gradient of log L-hat at a fixed (theta, u) of 128 chains; aux_slice
    # with the Laplace proposal at 64 chains; the Laplace estimate at a
    # fixed (theta, u).  The one-process references are computed first, on
    # the card: the gradient through the target's estimator kernel and
    # through the weights kernel and the blocked fold (the forward the
    # ranks run, on all S rows), and the Laplace estimate.
    log("main path (sharded gradients, sharded laplace)")
    tgt = make_gp_classification(x, y_np, n_importance=S, device="cuda")
    st = init_chain_states(21, tgt, B, jitter_scale=0.3)
    log_s = math.log(S)
    via_weights = dataclasses.replace(tgt, log_lik_est=lambda th_, u_: (
        blocked_logsumexp(tgt.log_weights_u(tgt.prepare(th_), u_),
                          tgt.n_weight_blocks) - log_s))
    g1 = {}
    for label, tg in (("estimator", tgt), ("weights", via_weights)):
        with torch.enable_grad():
            th = st.theta.clone().requires_grad_(True)
            (g1[label],) = torch.autograd.grad(tg.log_lik_est(th, st.u).sum(),
                                               th)
    # the same gradient in float64 through the plain path (the library's
    # factor, no jitter raise), as grad_parity computes it
    dev = st.u.device
    n_pad = N - len(x)
    x64 = np.asarray(x, np.float64)
    sq = np.full((N, N), 1e30)
    sq[:len(x), :len(x)] = ((x64[:, None] - x64[None]) ** 2).sum(-1)
    np.fill_diagonal(sq, 0.0)
    sq64 = torch.as_tensor(sq, device=dev)
    y64 = torch.as_tensor(np.concatenate([y_np, np.ones(n_pad)]), device=dev)
    mask64 = torch.as_tensor(np.concatenate([np.ones(len(x)),
                                             np.zeros(n_pad)]), device=dev)
    with torch.enable_grad():
        th64 = st.theta.double().requires_grad_(True)
        l64, info64 = torch.linalg.cholesky_ex(se_gram_iso(
            sq64, th64[:, 0], 0.0, 1e-5))
        ll64 = fe._ref_estimate(torch.exp(th64[:, 1])[:, None, None] * l64,
                                st.u.double(), y64, mask64, "logistic",
                                tgt.n_weight_blocks)
        (g64,) = torch.autograd.grad(ll64.sum(), th64)
    ok64 = (info64 == 0) & torch.isfinite(g64).all(-1)
    del l64, ll64, sq64
    theta_np, u_np = st.theta.cpu().numpy(), st.u.cpu().numpy()
    tgt_l = make_gp_classification(x, y_np, n_importance=S_LAPLACE,
                                   proposal="laplace", device="cuda")
    st_l = init_chain_states(22, tgt_l, LAPLACE_SHARDED_CHAINS,
                             jitter_scale=0.3)
    with torch.no_grad():
        est1 = tgt_l.log_lik_est(st_l.theta, st_l.u)
    theta_l, u_l = st_l.theta.cpu().numpy(), st_l.u.cpu().numpy()
    torch.cuda.synchronize()
    del st, tgt, via_weights, th, st_l, tgt_l
    torch.cuda.empty_cache()
    args = {sampler: [
        "--sharded", "true", "--particle-shards", str(K_SHARDS), "--preset",
        "pima_aux_slice", "--sampler", sampler, "--chains", str(chains),
        "--warmup-windows", "1", "--window-steps", str(window), "--steps",
        str(steps)] for sampler, (chains, window, steps, _)
        in SHARDED_GRAD_RUNS.items()}
    args_l = ["--sharded", "true", "--particle-shards", str(K_SHARDS),
              "--preset", "pima_aux_slice", "--proposal", "laplace",
              "--n-importance", str(S_LAPLACE), "--chains",
              str(LAPLACE_SHARDED_CHAINS), "--warmup-windows", "0",
              "--window-steps", str(LAPLACE_SHARDED_STEPS), "--steps",
              str(LAPLACE_SHARDED_STEPS)]
    jobs = [("cli", args[k_], prof_) for k_, (*_, prof_)
            in SHARDED_GRAD_RUNS.items()]
    jobs += [("grad", ("gp", x, y_np, {"n_importance": S}), theta_np, u_np),
             ("cli", args_l),
             ("estimate", ("gp", x, y_np, {"n_importance": S_LAPLACE,
                                           "proposal": "laplace"}),
              theta_l, u_l)]
    n_own = len(jobs)
    t0 = time.time()
    per_rank = spawn(rank_jobs.run_all, K_SHARDS, jobs + list(extra_jobs),
                     K_SHARDS, "cuda", timeout_s=900, threads=0)
    spawn_s = time.time() - t0
    extra = [r[n_own:] for r in per_rank]
    del u_np, u_l
    shares = torch.cuda.device_count() < K_SHARDS    # one card for both
    done = {}

    def job(i):
        """The ranks' results of job ``i``, in rank order."""
        return [r[i] for r in per_rank]

    def check_ranks(phase, ranks, must, must_not):
        """Each rank's backend and launches; the ranks bitwise equal."""
        for r in ranks:
            c = r["counts"]
            if shares and r["backend"] != "gloo":
                failures.append(f"{phase}: rank {r['rank']} on "
                                f"{r['backend']}")
            for name in must:
                if c[name] <= 0:
                    failures.append(f"{phase}: rank {r['rank']} never "
                                    f"launched {name}")
            for name in must_not:
                if c[name] != 0:
                    failures.append(f"{phase}: rank {r['rank']} launched "
                                    f"{name}")
            if not (np.isfinite(r["recorded_theta"]).all()
                    and np.isfinite(r["log_lik_hat"]).all()):
                failures.append(f"{phase}: non-finite theta or log L-hat")
        bitwise = all(
            np.array_equal(r[k_], ranks[0][k_]) for r in ranks[1:]
            for k_ in ("theta", "log_lik_hat", "recorded_theta"))
        bitwise &= all(r["step_sizes"] == ranks[0]["step_sizes"]
                       for r in ranks)
        if not bitwise:
            failures.append(f"{phase}: the ranks of the particle group do "
                            "not hold bitwise the same theta, log L-hat and "
                            "step sizes")
        return bitwise

    estimators = ("fused_estimator", "fused_estimator_rot", "ess_sweep",
                  "sigma_sweep")
    for i, (sampler, (chains, window, steps, prof_steps)) in enumerate(
            SHARDED_GRAD_RUNS.items()):
        ranks = job(i)
        r0 = ranks[0]
        bitwise = check_ranks(f"main_path_sharded_grad/{sampler}", ranks,
                              ("fused_weights", "fused_rot_weights"),
                              estimators)
        n_steps = window + steps
        c0, prof = r0["counts"], r0["profile"]
        if r0["u_shape"] != (chains, S_LOCAL, N):
            failures.append(f"main_path_sharded_grad/{sampler}: u "
                            f"{r0['u_shape']}")
        if r0["grad_collectives"] != 2 * r0["grad_calls"]:
            failures.append(f"main_path_sharded_grad/{sampler}: "
                            f"{r0['grad_collectives']} collectives in "
                            f"{r0['grad_calls']} gradient calls, not 2 each")
        done[sampler] = {
            "args": args[sampler], "chains": chains,
            "steps": f"1 x {window} warm-up + {steps}",
            "target": r0["target"], "backend": r0["backend"],
            "ranks_bitwise_equal": bitwise,
            "step_sizes": r0["step_sizes"],
            "chain_steps_per_sec": r0["summary"]["chain_steps_per_sec"],
            "gradient_calls_per_step": r0["grad_calls"] / n_steps,
            "collectives_per_gradient_call":
                r0["grad_collectives"] / max(r0["grad_calls"], 1),
            "collectives_per_step": c0["collectives"] / n_steps,
            "collective_ms_per_step": c0["collective_ms"] / n_steps,
            "fused_weights_launches_per_step": c0["fused_weights"] / n_steps,
            "fused_rot_weights_launches_per_step":
                c0["fused_rot_weights"] / n_steps,
            "chol_panel_launches_per_step": c0["chol_panel"] / n_steps,
            "peak_memory_gb_rank0": r0["peak_mem_gb"],
            "launches": [r["counts"] for r in ranks],
            "profile_rank0": {"steps": prof_steps, **{k_: prof[k_] for k_ in (
                "wall_ms_per_step", "device_busy_ms_per_step",
                "device_idle_share", "kernel_launches_per_step",
                "host_syncs_per_step", "collectives_per_step",
                "collective_ms")}},
            "device_ms_per_step_by_kernel":
                prof["device_ms_per_step_by_kernel"]}
    # the fixed-(theta, u) gradient against one process's, through the
    # target's estimator kernel and through the weights kernel and the fold
    # (the ranks' forward on all S rows): reported, with the chains over
    # SHARDED_GRAD_RTOL.  Two f32 gradients of one function differ by their
    # rounding, which the Cholesky pullback amplifies where R(ell) is near
    # singular: there the one-process gradient is itself further than that
    # from the float64 one.  Held: on every chain the 2-rank gradient is no
    # further from the float64 gradient than the one-process gradient is,
    # plus SHARDED_GRAD_RTOL of max(|g|, 1) (sharding loses at most that)
    grads = job(len(SHARDED_GRAD_RUNS))
    g2 = torch.as_tensor(grads[0]["grad"], device=g64.device)
    grad_bitwise = all(np.array_equal(r["grad"], grads[0]["grad"])
                       for r in grads)
    if not grad_bitwise:
        failures.append("main_path_sharded_grad: the ranks' gradients differ")
    fixed = {"chains": B, "ranks_bitwise_equal": grad_bitwise,
             "grad_abs_max": float(g1["weights"].abs().max()),
             "two_calls_seconds_rank0": grads[0]["seconds"],
             "launches_rank0": grads[0]["counts"],
             "chains_with_a_float64_factor": int(ok64.sum())}

    def rel(a_, b_):
        return ((a_ - b_).abs() / torch.clamp(b_.abs(), min=1.0)).max(-1)[0]

    for label in ("weights", "estimator"):
        r_ = rel(g2, g1[label])
        fixed[f"vs_1_rank_via_{label}"] = {
            "max_rel_err": float(r_.max()), "median_rel_err":
                float(r_.median()),
            "chains_over_rtol": int((r_ > SHARDED_GRAD_RTOL).sum()),
            "worst_chain": int(r_.argmax()),
            "that_chain_1_rank_vs_float64": float(rel(
                g1[label].double(), g64)[r_.argmax()])}
    g1e = g1["estimator"].double()
    slack = ((g2.double() - g64).abs() - (g1e - g64).abs()
             - SHARDED_GRAD_RTOL * torch.clamp(g64.abs(), min=1.0))
    fixed["vs_float64"] = {
        "max_rel_err_2_ranks": float(rel(g2.double(), g64)[ok64].max()),
        "max_rel_err_1_rank": float(rel(g1e, g64)[ok64].max()),
        "median_rel_err_2_ranks": float(rel(g2.double(), g64)[ok64].median()),
        "median_rel_err_1_rank": float(rel(g1e, g64)[ok64].median()),
        "chains_held": int(ok64.sum()), "rtol": SHARDED_GRAD_RTOL,
        "held_within": bool((slack[ok64] <= 0).all())}
    if not bool(torch.isfinite(g2).all()) or int(ok64.sum()) < B // 2 or \
            not fixed["vs_float64"]["held_within"]:
        failures.append(f"main_path_sharded_grad: the 2-rank gradient is "
                        f"further from the float64 one than one process's "
                        f"plus {SHARDED_GRAD_RTOL} of max(|g|, 1): {fixed}")
    emit({"phase": "main_path_sharded_grad", "card": smi,
          "ranks": K_SHARDS, **done, "fixed_theta_u_gradient": fixed,
          "spawn_seconds_with_the_laplace_phase": round(spawn_s, 1)})
    end_phase()

    # aux_slice with the Laplace proposal on the two ranks (the Newton fit
    # replicated, the log-weights folded by the collective)
    i_l = len(SHARDED_GRAD_RUNS) + 1
    ranks, ests = job(i_l), job(i_l + 1)
    bitwise = check_ranks("main_path_laplace_sharded", ranks,
                          ("chol_panel", "threefry_launches"),
                          estimators + ("fused_weights", "fused_rot_weights"))
    est_bitwise = all(np.array_equal(e_["estimate"], ests[0]["estimate"])
                      for e_ in ests)
    if not est_bitwise:
        failures.append("main_path_laplace_sharded: the ranks' estimates "
                        "differ")
    est2 = torch.as_tensor(ests[0]["estimate"], device=est1.device)
    err = check_close("main_path_laplace_sharded", "2-rank estimate", est2,
                      est1, SHARDED_LL_TOL)
    r0 = ranks[0]
    n_steps = LAPLACE_SHARDED_STEPS
    emit({"phase": "main_path_laplace_sharded", "card": smi, "args": args_l,
          "ranks": K_SHARDS, "backend": r0["backend"], "target": r0["target"],
          "u_shape_per_rank": list(r0["u_shape"]),
          "ranks_bitwise_equal": bitwise,
          "chain_steps_per_sec": r0["summary"]["chain_steps_per_sec"],
          "wall_s": r0["summary"]["wall"],
          "chol_panel_launches_per_step": r0["counts"]["chol_panel"] / n_steps,
          "collectives_per_step": r0["counts"]["collectives"] / n_steps,
          "collective_ms_per_step": r0["counts"]["collective_ms"] / n_steps,
          "peak_memory_gb_rank0": r0["peak_mem_gb"],
          "ess_u/moved": r0["windows"][-1]["ess_u/moved"],
          "slice_theta/n_probe": r0["windows"][-1]["slice_theta/n_probe"],
          "launches": [r["counts"] for r in ranks],
          "fixed_theta_u_estimate": {
              "chains": LAPLACE_SHARDED_CHAINS,
              "ranks_bitwise_equal": est_bitwise,
              "max_abs_err_vs_1_rank": err, "tol": SHARDED_LL_TOL,
              "bitwise_equal_to_1_rank": bool(torch.equal(est2, est1))}})
    del per_rank, grads, g1, g2, g64
    torch.cuda.empty_cache()
    end_phase()
    return extra, spawn_s


def laplace_grad_phase(torch, np, smi, x, y_np, run_cli, counters,
                       read_counts, failures, end_phase):
    """main_path_laplace_grad (see ``gradient_phases``)."""
    from auxpm_tpu_torch.models.gp_classification import make_gp_classification
    from auxpm_tpu_torch.models.laplace import (
        laplace_fit,
        laplace_log_weight_terms,
    )
    from auxpm_tpu_torch.models.likelihoods import LIKELIHOODS
    from auxpm_tpu_torch.ops import cholesky
    from auxpm_tpu_torch.ops.gram import se_gram_iso
    from auxpm_tpu_torch.ops.logsumexp import blocked_logsumexp
    from auxpm_tpu_torch.samplers import hmc as hmc_mod
    from auxpm_tpu_torch.samplers import nuts as nuts_mod

    # ------------------------------------- HMC and NUTS on a Laplace target
    # --proposal laplace --n-importance 16 on one card: aux_hmc at 64
    # chains, aux_nuts at 16, no warm-up, at a step size of the order that
    # dual averaging finds on config 2's target (at the default 0.3 most
    # trajectories diverge, to theta where the f32 fit overflows); no
    # gradient row may be non-finite (the padded rows' w = 0 is where the
    # reference's gradient is NaN at every theta).  Then at the aux_hmc
    # run's final (theta, u): ms, panel launches, jitter escalations and
    # peak memory of a gradient call, and on 8 chains the gradient against
    # float64 central differences at step 1e-4 of the plain path on the CPU
    # (as grad_parity), on the chains whose factorisations took no extra
    # jitter.
    log("main path (laplace gradients)")
    real_vg = hmc_mod.value_and_grad
    nonfinite = []

    def counting_vg(target_, u_):
        vg_ = real_vg(target_, u_)

        def vg(theta_, rows=None):
            pe_, g_ = vg_(theta_, rows)
            bad_ = ~torch.isfinite(g_).all(-1)
            nonfinite.append(torch.stack([bad_.sum(),
                                          (bad_ & torch.isfinite(pe_)).sum()]))
            return pe_, g_

        return vg

    impl = cholesky._robust_cholesky_impl
    extras = []

    def recording_impl(gram_, *a_, **kw_):
        l_, extra_ = impl(gram_, *a_, **kw_)
        extras.append(extra_)
        return l_, extra_

    lap_runs, final = {}, None
    for sampler, (chains, steps) in LAPLACE_GRAD_RUNS.items():
        args = ["--preset", "pima_aux_slice", "--proposal", "laplace",
                "--n-importance", str(S_LAPLACE), "--sampler", sampler,
                "--chains", str(chains), "--nuts-step-size",
                str(LAPLACE_GRAD_STEP), "--warmup-windows", "0",
                "--window-steps", str(steps), "--steps", str(steps)]
        log(f"main path (laplace, {sampler}):", " ".join(args))
        nonfinite.clear()
        calls0 = hmc_mod.grad_calls
        torch.cuda.reset_peak_memory_stats()
        held_gb = torch.cuda.memory_allocated() / 1e9   # by earlier phases
        t0 = time.time()
        with mock.patch.object(hmc_mod, "value_and_grad", counting_vg), \
                mock.patch.object(nuts_mod, "value_and_grad", counting_vg):
            res, cnt = run_cli(args, ("chol_panel", "threefry"),
                               [k_ for k_ in counters
                                if k_ not in ("chol_panel", "threefry")])
        run_s = time.time() - t0
        st = res["states"]
        n_bad, n_bad_finite_u = (int(v_) for v_ in
                                 torch.stack(nonfinite).sum(0))
        n_calls = hmc_mod.grad_calls - calls0
        if n_bad:
            failures.append(f"main_path_laplace_grad/{sampler}: {n_bad} "
                            f"non-finite gradient rows ({n_bad_finite_u} "
                            "with a finite potential)")
        if not (res["target"].name.endswith("_laplace")
                and st.u.shape == (chains, S_LAPLACE, N)
                and np.isfinite(res["theta"]).all()
                and bool(torch.isfinite(st.log_lik_hat).all())):
            failures.append(f"main_path_laplace_grad/{sampler}: target "
                            f"{res['target'].name}, u {tuple(st.u.shape)}, "
                            "or non-finite theta / log L-hat")
        group = sampler[4:]
        win = res["windows"][-1]
        lap_runs[sampler] = {
            "args": args, "chains": chains, "steps": steps,
            "launches": cnt, "nonfinite_gradient_rows": n_bad,
            "nonfinite_gradient_rows_with_a_finite_potential":
                n_bad_finite_u,
            "gradient_calls": n_calls,
            "gradient_calls_per_step": n_calls / steps,
            "chol_panel_launches_per_step": cnt["chol_panel"] / steps,
            "chain_steps_per_sec": res["summary"]["chain_steps_per_sec"],
            "wall_s": run_s,
            "peak_memory_gb_above_the_start":
                torch.cuda.max_memory_allocated() / 1e9 - held_gb,
            **{k_: win[k_] for k_ in win if k_.startswith(group + "/")}}
        if sampler == "aux_hmc":
            final = (res["target"], st)
        del res
    tgt, st = final
    vg = real_vg(tgt, st.u)
    vg(st.theta)
    torch.cuda.synchronize()
    n_time = 3
    t0 = time.time()
    for _ in range(n_time):
        vg(st.theta)
    torch.cuda.synchronize()
    grad_ms = (time.time() - t0) * 1e3 / n_time
    for m, attr in counters.values():
        setattr(m, attr, 0)
    extras.clear()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    with mock.patch.object(cholesky, "_robust_cholesky_impl",
                           recording_impl):
        vg(st.theta)
    torch.cuda.synchronize()
    peak_grad = torch.cuda.max_memory_allocated() / 1e9 - held_gb
    panels = read_counts()["chol_panel"]
    escalated = [int((e_ > 0).sum()) for e_ in extras]
    call = {"chains": st.theta.shape[0], "ms_per_gradient_call": grad_ms,
            "chol_panel_launches_per_gradient_call": panels,
            "factorisations_per_gradient_call": panels / (N // 128),
            "robust_cholesky_calls_per_gradient_call": len(extras),
            "calls_with_an_escalated_jitter": sum(e_ > 0 for e_ in escalated),
            "matrices_with_an_escalated_jitter": sum(escalated),
            "peak_memory_gb_above_the_start": peak_grad}
    # float64 central differences of the plain path, on the CPU, at the
    # final state's first chains: held at LAPLACE_JITTER (as the prepare
    # parity of main_path_laplace), reported at the CLI's 1e-5, where the
    # f32 Laplace fit of a near-singular K is off the float64 one by up to a
    # nat (the estimate, not only its gradient)
    b8 = LAPLACE_FD_CHAINS
    theta8, u8 = st.theta[:b8].clone(), st.u[:b8].clone()
    n_pad = N - len(x)
    x64 = np.asarray(x, np.float64)
    sq = np.full((N, N), 1e30)
    sq[:len(x), :len(x)] = ((x64[:, None] - x64[None]) ** 2).sum(-1)
    np.fill_diagonal(sq, 0.0)
    sq64 = torch.as_tensor(sq)
    y64 = torch.as_tensor(np.concatenate([y_np, np.ones(n_pad)]))
    mask64 = torch.as_tensor(np.concatenate([np.ones(len(x)),
                                             np.zeros(n_pad)]))
    u64 = u8.double().cpu()
    fd_check = {}
    for jitter in (LAPLACE_JITTER, 1e-5):
        tgt_j = make_gp_classification(x, y_np, n_importance=S_LAPLACE,
                                       proposal="laplace", jitter=jitter,
                                       device="cuda")
        extras.clear()
        with mock.patch.object(cholesky, "_robust_cholesky_impl",
                               recording_impl), torch.enable_grad():
            th = theta8.clone().requires_grad_(True)
            (g_k,) = torch.autograd.grad(tgt_j.log_lik_est(th, u8).sum(), th)
        clean = torch.ones(b8, dtype=torch.bool, device=g_k.device)
        for e_ in extras:
            clean &= e_ == 0

        def ll64(th_):
            r_ = se_gram_iso(sq64, th_[:, 0], 0.0, jitter)
            k_ = torch.exp(2.0 * th_[:, 1])[:, None, None] * r_
            chol_k = torch.exp(th_[:, 1])[:, None, None] * \
                cholesky.robust_cholesky(r_, jitter0=jitter)
            f_hat, chol_q, hl = laplace_fit(k_, y64, mask64, "logistic", 6)
            f_, extra = laplace_log_weight_terms(chol_k, f_hat, chol_q, hl,
                                                 u64)
            lw = LIKELIHOODS["logistic"](f_, y64, mask64) + extra
            return blocked_logsumexp(lw, 8) - math.log(S_LAPLACE)

        th64 = theta8.double().cpu().requires_grad_(True)
        with torch.enable_grad():
            (g64,) = torch.autograd.grad(ll64(th64).sum(), th64)
        fd = torch.zeros_like(g64)
        with torch.no_grad():
            for i_ in range(2):
                step_ = torch.zeros_like(fd)
                step_[:, i_] = FD_STEP_F64
                fd[:, i_] = (ll64(th64.detach() + step_)
                             - ll64(th64.detach() - step_)) / (2 * FD_STEP_F64)
        keep = clean.cpu() & torch.isfinite(g64).all(-1)
        scale = torch.clamp(fd.abs(), min=1.0)
        rel_k = ((g_k.double().cpu() - fd).abs() / scale).max(-1).values
        rel_64 = ((g64 - fd).abs() / scale).max(-1).values
        held = jitter == LAPLACE_JITTER
        fd_check[f"jitter_{jitter:g}"] = {
            "held": held, "chains": b8, "chains_held": int(keep.sum()),
            "step": FD_STEP_F64,
            "kernel_vs_f64_fd_rel_err_per_chain": rel_k.tolist(),
            "f64_grad_vs_f64_fd_max_rel_err": float(rel_64.max()),
            "rtol": FD_RTOL, "f64_rtol": FD_F64_RTOL,
            "grad_abs_max": float(g_k.abs().max())}
        if held and (int(keep.sum()) < b8 // 2
                     or not float(rel_k[keep].max()) < FD_RTOL
                     or not float(rel_64[keep].max()) < FD_F64_RTOL):
            failures.append(f"main_path_laplace_grad: finite differences "
                            f"{fd_check}")
        del tgt_j
    emit({"phase": "main_path_laplace_grad", "card": smi, **lap_runs,
          "gradient_call": call, "fd_check": fd_check})
    del vg, final, tgt, st, theta8, u8
    torch.cuda.empty_cache()
    end_phase()


def scale_phases(c, local, per_rank, spawn_s):
    """Phases 27-32 of the module note (the fifteenth slice), with ``main``'s
    helpers in the namespace ``c``: the launch counters and the CLI runner,
    the step parity of the theta samplers, the failure list and the closing
    check of a phase; ``local``, ``per_rank`` and ``spawn_s``: this
    process's side and the ranks' results of ``joint_sharded_jobs``."""
    stepout_theta_phase(c)
    laplace_ard_phase(c)
    scaling_phase(c, joint_sharded_phase(c, local, per_rank, spawn_s))
    dryrun_phase(c)
    smc_scale_phase(c)


def stepout_theta_phase(c):
    """main_path_stepout_theta: ``aux_slice_rd``, ``aux_slice_joint`` and
    ``joint_slice`` with stepping out on (``--max-step-out 8``) at 128 chains
    through the CLI (1 x 3 warm-up + 3 steps): finite, moving; every
    estimator launch recorded by its batch, the step-out probe (both ends of
    every chain, two different u's each for the joint slice) one launch of
    2B chains, never more (two calls only past ``MAX_PROBE_BATCH``, far
    above 2B = 256); peak memory of each run.  Then one step from each
    final state on the same rows through the kernels and through the plain
    estimator, ESS and sigma sweeps (the panel kernel shared), held as in
    ``path_parity_theta_samplers``."""
    torch, np = c.torch, c.np
    from auxpm_tpu_torch.models.base import MAX_PROBE_BATCH
    from auxpm_tpu_torch.ops import fused_estimator as fe

    if 2 * B > MAX_PROBE_BATCH:
        raise AssertionError("the step-out probe would be two calls")
    runs, parity = {}, {}
    for sampler in STEPOUT_SAMPLERS:
        move_key = THETA_SAMPLERS[sampler]
        aux = sampler.startswith("aux_slice")
        # the sigma sweep serves shrinkage-only slices: not launched here
        must = (("fused_estimator", "chol_panel", "threefry")
                + (("ess_sweep",) if aux else ()))
        args = STEPOUT_CLI_ARGS + ["--sampler", sampler]
        log(f"main path (stepping out, {sampler}):", " ".join(args))
        batches = []
        real = fe._cuda_estimate

        def recording(chol, u, *a, **kw):
            batches.append(int(u.shape[0]))
            return real(chol, u, *a, **kw)

        torch.cuda.reset_peak_memory_stats()
        with mock.patch.object(fe, "_cuda_estimate", recording):
            res, cnt = c.run_cli(args, must,
                                 [k_ for k_ in c.counters if k_ not in must])
        peak = torch.cuda.max_memory_allocated() / 1e9
        st = res["states"]
        if st.u.shape != (B, S, N) or not st.u.is_cuda:
            raise AssertionError(f"{sampler} did not run at full width on "
                                 "the GPU")
        if not np.isfinite(res["theta"]).all() or \
                not bool(torch.isfinite(st.log_lik_hat).all()):
            raise AssertionError(f"{sampler}: non-finite theta or log L-hat")
        moved = [w_[move_key] for w_ in res["windows"]]
        if not max(moved) > 0:
            raise AssertionError(f"{sampler} never moved: {move_key} {moved}")
        by_batch = {str(b_): batches.count(b_) for b_ in sorted(set(batches))}
        n_probe_2b = batches.count(2 * B)
        if n_probe_2b == 0 or max(batches) > 2 * B:
            c.failures.append(f"main_path_stepout_theta/{sampler}: estimator "
                              f"launches by batch {by_batch}: the step-out "
                              f"probe is not one launch of {2 * B} chains")
        win = res["windows"][-1]
        runs[sampler] = {
            "launches": cnt, "estimator_launches_by_batch": by_batch,
            "step_out_probe_launches": n_probe_2b,
            "step_out_probe_launches_per_step": n_probe_2b / STEPOUT_STEPS,
            "peak_memory_gb": peak,
            "chain_steps_per_sec": res["summary"]["chain_steps_per_sec"],
            f"{move_key}_per_window": moved,
            **{k_: win[k_] for k_ in win if k_.endswith("n_probe")}}
        phase = f"main_path_stepout_theta/{sampler}"
        par, stats = c.step_parity(phase, res["step"], res["target"], st,
                                   res["params"], c.y, c.mask,
                                   plain_sigma=True,
                                   max_ambiguous=THETA_MAX_AMBIGUOUS)
        parity[sampler] = {**stats, "max_abs_err": par}
        del res, st
    emit({"phase": "main_path_stepout_theta", "card": c.smi,
          "args": STEPOUT_CLI_ARGS, **runs, "step_parity": parity})
    c.end_phase()


def laplace_ard_phase(c):
    """main_path_laplace_ard: ``--preset pima_ard_aux --proposal laplace
    --n-importance 16`` (stepping out, theta of 8) through the CLI: the ARD
    Gram kernel and the panel launch, nothing else of the package but the
    threefry kernel; no non-finite estimate.  Then the estimate at the final
    (theta, u) through the kernels against the plain ARD Gram (the panel
    shared), both at jitter 1e-3: held on the chains whose every
    factorisation settled on the same jitter on both sides (known
    difference 3), at ``main_path_laplace``'s widest bar, half
    log|Sigma_q|'s, which the estimate carries; and where that gap comes
    from (``ard_gram_fault_check``)."""
    torch, np = c.torch, c.np
    from auxpm_tpu_torch.models.gp_classification import make_gp_classification
    from auxpm_tpu_torch.ops import cholesky
    from auxpm_tpu_torch.ops import gram as gr

    must = ("se_gram_ard", "chol_panel", "threefry")
    log("main path (laplace, ARD):", " ".join(LAPLACE_ARD_CLI_ARGS))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res, cnt = c.run_cli(LAPLACE_ARD_CLI_ARGS, must,
                         [k_ for k_ in c.counters if k_ not in must])
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    st = res["states"]
    if st.u.shape != (LAPLACE_ARD_CHAINS, S_LAPLACE, N) or \
            not res["target"].name.endswith("_laplace"):
        raise AssertionError(f"laplace ARD: u {tuple(st.u.shape)}, target "
                             f"{res['target'].name}")
    if not np.isfinite(res["theta"]).all() or \
            not bool(torch.isfinite(st.log_lik_hat).all()):
        raise AssertionError("laplace ARD: non-finite theta or estimate")
    tgt = make_gp_classification(c.x, c.y_np, n_importance=S_LAPLACE,
                                 ard=True, proposal="laplace",
                                 jitter=LAPLACE_JITTER, device="cuda")
    impl = cholesky._robust_cholesky_impl
    boosts = []

    def recording_impl(gram_, *a_, **kw_):
        l_, extra_ = impl(gram_, *a_, **kw_)
        boosts.append(extra_)
        return l_, extra_

    with torch.no_grad(), mock.patch.object(
            cholesky, "_robust_cholesky_impl", recording_impl):
        before = c.read_counts()["se_gram_ard"]
        est_k = tgt.log_lik_est(st.theta, st.u)
        if c.read_counts()["se_gram_ard"] == before:
            raise AssertionError("laplace ARD: the estimate never launched "
                                 "the ARD Gram kernel")
        boosts_k, boosts[:] = list(boosts), []
        with mock.patch.object(gr, "_cuda_se_gram_ard",
                               gr.se_gram_ard_masked):
            before = c.read_counts()["se_gram_ard"]
            est_p = tgt.log_lik_est(st.theta, st.u)
            if c.read_counts()["se_gram_ard"] != before:
                raise AssertionError("laplace ARD: the plain side launched "
                                     "the ARD Gram kernel")
        boosts_p = list(boosts)
    torch.cuda.synchronize()
    if len(boosts_k) != len(boosts_p) or len(boosts_k) < 9:
        raise AssertionError(f"laplace ARD: {len(boosts_k)} and "
                             f"{len(boosts_p)} factorisations")
    same = torch.ones(LAPLACE_ARD_CHAINS, dtype=torch.bool, device=st.u.device)
    for bk, bp in zip(boosts_k, boosts_p):
        same &= bk == bp
    if int(same.sum()) < LAPLACE_ARD_CHAINS // 2:
        raise AssertionError(f"laplace ARD: only {int(same.sum())} chains "
                             "settled on the same jitters")
    if not bool(torch.isfinite(est_k).all()):
        c.failures.append("laplace ARD: non-finite estimate at the fixed "
                          "(theta, u)")
    err = c.check_close("main_path_laplace_ard", "estimate", est_k, est_p,
                        LAPLACE_LOGDET_TOL, same)
    gram_check = ard_gram_fault_check(c, st, same)
    summary = res["summary"]
    emit({"phase": "main_path_laplace_ard", "card": c.smi,
          "args": LAPLACE_ARD_CLI_ARGS, "chains": LAPLACE_ARD_CHAINS,
          "launches": cnt, "wall_s_with_set_up": wall,
          "chain_steps_per_sec": summary["chain_steps_per_sec"],
          "run_wall_s": summary["wall"],
          "ard_gram_launches_per_step": cnt["se_gram_ard"]
          / LAPLACE_ARD_STEPS,
          "chol_panel_launches_per_step": cnt["chol_panel"]
          / LAPLACE_ARD_STEPS,
          "peak_memory_gb": peak,
          "slice_theta/n_probe": res["windows"][-1]["slice_theta/n_probe"],
          "fixed_theta_u_estimate": {
              "jitter": LAPLACE_JITTER,
              "factorisations": len(boosts_k),
              "chains_with_the_same_jitters": int(same.sum()),
              "max_abs_err_kernel_vs_plain_gram": err,
              "tol": LAPLACE_LOGDET_TOL},
          "gram_kernel_vs_plain_at_the_final_theta": gram_check})
    del res, st, tgt
    torch.cuda.empty_cache()
    c.end_phase()


def ard_gram_fault_check(c, st, same):
    """Where the ARD estimate's kernel-vs-plain gap comes from, at the
    final (theta, u) of main_path_laplace_ard: the largest entrywise gap
    between the ARD Gram kernel's R(ell) + jitter I and the plain
    ``se_gram_ard_masked``'s, against 8 eps max(sq) (float32 rounding of
    the reference's expression: the kernels phase's bar) and each against
    the float64 Gram; then the Laplace estimate of each float32 Gram (and of
    the float64 one) in float64 on the CPU (the target's prepare: jitter
    1e-3, 6 Newton steps, the 8-block fold), on the chains whose
    factorisations took the same jitters.  Grams within rounding whose
    float64 estimates still differ as the float32 ones do mean the gap is
    conditioning (known difference 3), not the kernel."""
    torch, np = c.torch, c.np
    from auxpm_tpu_torch.models.laplace import (
        laplace_fit,
        laplace_log_weight_terms,
    )
    from auxpm_tpu_torch.models.likelihoods import LIKELIHOODS
    from auxpm_tpu_torch.ops import gram as gr
    from auxpm_tpu_torch.ops.cholesky import robust_cholesky
    from auxpm_tpu_torch.ops.logsumexp import blocked_logsumexp

    n_raw = len(c.x)
    x_pad = c.t(np.concatenate([c.x, np.zeros((N - n_raw, c.x.shape[1]))]))
    log_ells = st.theta[:, :-1].contiguous()
    g_k = gr.se_gram_ard_hopper(x_pad, log_ells, LAPLACE_JITTER, c.mask)
    g_p = gr.se_gram_ard_masked(x_pad, log_ells, LAPLACE_JITTER, c.mask)
    cpu64 = {k_: v_.double().cpu() for k_, v_ in dict(
        x=x_pad, le=log_ells, mask=c.mask, y=c.y, theta=st.theta,
        u=st.u).items()}
    g_64 = gr.se_gram_ard_masked(cpu64["x"], cpu64["le"], LAPLACE_JITTER,
                                 cpu64["mask"])
    sq_max = float(((x_pad[None] * torch.exp(-log_ells)[:, None, :]) ** 2)
                   .sum(-1).max())
    rounding = 8.0 * float(np.finfo(np.float32).eps) * max(sq_max, 1.0)

    def estimate64(r):
        log_sigma = cpu64["theta"][:, -1]
        chol_k = torch.exp(log_sigma)[:, None, None] * robust_cholesky(
            r, jitter0=LAPLACE_JITTER)
        k = torch.exp(2.0 * log_sigma)[:, None, None] * r
        f_hat, chol_q, half_q = laplace_fit(k, cpu64["y"], cpu64["mask"],
                                            "logistic", 6)
        f, extra = laplace_log_weight_terms(chol_k, f_hat, chol_q, half_q,
                                            cpu64["u"])
        lw = LIKELIHOODS["logistic"](f, cpu64["y"], cpu64["mask"]) + extra
        return blocked_logsumexp(lw, 8) - math.log(S_LAPLACE)

    keep = same.cpu()
    est = {"kernel_gram": estimate64(g_k.double().cpu()),
           "plain_gram": estimate64(g_p.double().cpu()),
           "float64_gram": estimate64(g_64)}
    gap_k_p = float((g_k - g_p).abs().max())
    out = {
        "gram_max_abs_gap_kernel_vs_plain": gap_k_p,
        "float32_rounding_bar": rounding,
        "kernel_gram_vs_float64": float((g_k.double().cpu() - g_64)
                                        .abs().max()),
        "plain_gram_vs_float64": float((g_p.double().cpu() - g_64)
                                       .abs().max()),
        "estimate64_kernel_vs_plain_gram": float(
            (est["kernel_gram"] - est["plain_gram"])[keep].abs().max()),
        "estimate64_kernel_vs_float64_gram": float(
            (est["kernel_gram"] - est["float64_gram"])[keep].abs().max()),
        "estimate64_plain_vs_float64_gram": float(
            (est["plain_gram"] - est["float64_gram"])[keep].abs().max()),
        "chains": int(keep.sum())}
    out["kernel_at_fault"] = not gap_k_p <= rounding
    if out["kernel_at_fault"]:
        c.failures.append(f"laplace ARD: the Gram kernel is {gap_k_p:.3e} "
                          f"from the plain Gram, past rounding {rounding:.3e}")
    return out


def joint_sharded_jobs(c):
    """The two-rank jobs of main_path_joint_sharded and scaling_path, and
    this process's side of the joint samplers' keyed step: ``joint_mh`` and
    ``aux_slice_joint`` through the CLI with ``--sharded true
    --particle-shards 2``; one keyed step of each from a fixed state of 128
    chains (``rank_jobs`` job ``keyed_step``: each rank draws its rows from
    the chains' keys), whose reference, the unsharded per-probe path (the
    loop ESS and the per-probe log_sigma) on the same rows, runs here now;
    then ``utils/scaling`` (job ``scaling``).  They run in the spawn of
    phases 24-26 (one start-up).  Returns ``(jobs, local)``."""
    torch = c.torch
    import dataclasses

    from auxpm_tpu_torch.core.state import init_chain_states
    from auxpm_tpu_torch.models.gp_classification import make_gp_classification
    from auxpm_tpu_torch.samplers.composite import SAMPLERS
    from auxpm_tpu_torch.utils.config import PRESETS, initial_params

    tgt = make_gp_classification(c.x, c.y_np, n_importance=S, device="cuda")
    tgt_loop = dataclasses.replace(tgt, ess_sweep_factory=None,
                                   sigma_sweep_factory=None)
    spec = ("gp", c.x, c.y_np, {"n_importance": S})
    local, jobs = {}, []
    for i, sampler in enumerate(JOINT_SHARDED_SAMPLERS):
        kw = ({"n_ess": N_ESS, "n_sigma_extra": N_SIGMA - 1}
              if sampler.startswith("aux_slice") else {})
        cfg = PRESETS["pima_aux_slice"].replace(
            sampler=sampler, max_step_out=0, max_shrink_chol=3)
        st = init_chain_states(41 + i, tgt, B, jitter_scale=0.3,
                               with_cache=sampler.startswith("aux_slice"))
        par = initial_params(cfg, tgt)
        # the unsharded per-probe step on the rows the chains' keys give
        step = SAMPLERS[sampler](tgt_loop, **kw)
        probe_log, info = [], {}
        s_ = st
        for name, stage in step.stages.items():
            rows, key = stage.draw(s_)
            s_, i_ = stage.apply(s_, rows, {**par[name],
                                            "probe_log": probe_log})
            s_ = s_.replace(key=key)
            info.update({f"{name}/{k_}": v_ for k_, v_ in i_.items()})
        local[sampler] = (s_, info, probe_log)
        state_np = {"theta": st.theta.cpu().numpy(), "u": st.u.cpu().numpy(),
                    "log_lik_hat": st.log_lik_hat.cpu().numpy(),
                    "key": st.key.cpu().numpy()}
        if "target_cache" in st.extras:
            state_np["chol_r"] = \
                st.extras["target_cache"]["chol_r"].cpu().numpy()
        par_np = {g: {k_: (v_.cpu().numpy() if torch.is_tensor(v_) else v_)
                      for k_, v_ in sub.items()} for g, sub in par.items()}
        jobs.append(("cli", SHARDED_CLI_ARGS + ["--sampler", sampler]))
        jobs.append(("keyed_step", spec, sampler, state_np, par_np, kw))
        del st
    jobs.append(("scaling", SCALING_ARGS))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return jobs, local


def joint_sharded_phase(c, local, per_rank, spawn_s):
    """main_path_joint_sharded: the ranks' results ``per_rank`` of
    ``joint_sharded_jobs``' jobs: theta and log L-hat bitwise equal on both
    ranks, the weights kernels launched (the rotated one where an ESS runs)
    and no estimator or sweep kernel; each keyed step against this
    process's ``local`` one: equal counts on the chains whose decisions all
    sat further than 1e-4 from their levels, theta and log L-hat within
    1e-4.  Returns the scaling job's line for ``scaling_phase``."""
    torch, np = c.torch, c.np
    shares = torch.cuda.device_count() < K_SHARDS
    estimators = ("fused_estimator", "fused_estimator_rot", "ess_sweep",
                  "sigma_sweep")
    out = {}
    n_steps = 3 + 6                       # 1 x 3 warm-up + 6, as phase 7
    for i, sampler in enumerate(JOINT_SHARDED_SAMPLERS):
        phase = f"main_path_joint_sharded/{sampler}"
        ranks = [r[2 * i] for r in per_rank]
        steps = [r[2 * i + 1] for r in per_rank]
        must = ("fused_weights",) + (("fused_rot_weights",)
                                     if sampler.startswith("aux_slice")
                                     else ())
        for r in ranks + steps:
            cnt = r["counts"]
            for name in must:
                if cnt[name] <= 0:
                    c.failures.append(f"{phase}: rank {r['rank']} never "
                                      f"launched {name}")
            for name in estimators:
                if cnt[name] != 0:
                    c.failures.append(f"{phase}: rank {r['rank']} launched "
                                      f"{name}")
        for r in ranks:
            if r["u_shape"] != (B, S_LOCAL, N) or \
                    (shares and r["backend"] != "gloo"):
                c.failures.append(f"{phase}: rank {r['rank']} u "
                                  f"{r['u_shape']} over {r['backend']}")
            if not (np.isfinite(r["recorded_theta"]).all()
                    and np.isfinite(r["log_lik_hat"]).all()):
                c.failures.append(f"{phase}: non-finite theta or log L-hat")
        bitwise = all(np.array_equal(r[k_], ranks[0][k_]) for r in ranks
                      for k_ in ("theta", "log_lik_hat", "recorded_theta"))
        step_bitwise = all(np.array_equal(r[k_], steps[0][k_]) for r in steps
                           for k_ in ("theta", "log_lik_hat"))
        if not (bitwise and step_bitwise):
            c.failures.append(f"{phase}: the two ranks differ in theta or "
                              "log L-hat")
        s_, info, probe_log = local[sampler]
        amb = torch.zeros(B, dtype=torch.bool, device=s_.u.device)
        for counted, margin in probe_log:
            amb |= counted & (margin.abs() <= SHARDED_LL_TOL)
        agree = torch.ones_like(amb)
        for k_, v_ in info.items():
            agree &= v_ == torch.as_tensor(steps[0]["info"][k_],
                                           device=v_.device)
        n_amb, n_bad = int(amb.sum()), int((~agree & ~amb).sum())
        if n_bad:
            c.failures.append(f"{phase}: counts differ on {n_bad} chains "
                              "whose margins were all outside the tolerance")
        if n_amb > MAX_AMBIGUOUS:
            c.failures.append(f"{phase}: {n_amb} chains had a decision "
                              "inside the tolerance")
        th2 = torch.as_tensor(steps[0]["theta"], device=s_.u.device)
        ll2 = torch.as_tensor(steps[0]["log_lik_hat"], device=s_.u.device)
        r0 = ranks[0]
        out[sampler] = {
            "args": SHARDED_CLI_ARGS + ["--sampler", sampler],
            "backend": r0["backend"], "target": r0["target"],
            "ranks_bitwise_equal": bitwise,
            "chain_steps_per_sec": r0["summary"]["chain_steps_per_sec"],
            "launches": [r["counts"] for r in ranks],
            "launches_per_step": {
                k_: round(r0["counts"][k_] / n_steps, 2)
                for k_ in ("fused_weights", "fused_rot_weights",
                           "chol_panel", "collectives")},
            "peak_memory_gb_rank0": r0["peak_mem_gb"],
            "keyed_step_vs_unsharded": {
                "chains": B, "ranks_bitwise_equal": step_bitwise,
                "decisions_logged": len(probe_log),
                "chains_with_a_decision_inside_tolerance": n_amb,
                "chains_with_a_differing_count": int((~agree).sum()),
                "of_those_outside_tolerance": n_bad,
                "max_abs_err": {
                    "theta": c.check_close(phase, "theta", th2, s_.theta,
                                           SHARDED_LL_TOL, agree),
                    "ll": c.check_close(phase, "ll", ll2, s_.log_lik_hat,
                                        SHARDED_LL_TOL, agree)},
                "tol": SHARDED_LL_TOL,
                "launches_rank0": steps[0]["counts"]}}
    emit({"phase": "main_path_joint_sharded", "card": c.smi,
          "ranks": K_SHARDS, **out,
          "spawn_seconds_with_phases_24_to_26_and_scaling_path":
              round(spawn_s, 1)})
    c.end_phase()
    return per_rank[0][-1]


def dryrun_phase(c):
    """dryrun_mesh: ``utils/dryrun.dryrun_mesh(4)`` on four spawned ranks
    sharing the card (gloo): one ``aux_slice`` step on a 2 x 2 mesh of
    chains by particles, then the key-as-u sharded SMC on the toy over a
    chain-only mesh of the four ranks; each rank raises where the
    reference's dry run asserts; the ranks agree on the betas and logZ."""
    from auxpm_tpu_torch.parallel.launch import spawn
    from auxpm_tpu_torch.utils import dryrun

    log("dryrun_mesh: 4 ranks")
    t0 = time.time()
    ranks = spawn(dryrun.dryrun_mesh, DRYRUN_RANKS, DRYRUN_RANKS, "cuda",
                  timeout_s=300, threads=0)
    spawn_s = time.time() - t0
    r0 = ranks[0]
    for r in ranks:
        if r["mesh"] != [DRYRUN_RANKS // 2, 2] or \
                r["smc"]["betas"] != r0["smc"]["betas"] or \
                r["smc"]["log_z"] != r0["smc"]["log_z"]:
            c.failures.append(f"dryrun_mesh: rank {r['rank']}: {r}")
        if c.torch.cuda.device_count() < DRYRUN_RANKS and \
                r["backend"] != "gloo":
            c.failures.append(f"dryrun_mesh: rank {r['rank']} on "
                              f"{r['backend']}")
    emit({"phase": "dryrun_mesh", "card": c.smi, "ranks": DRYRUN_RANKS,
          "mesh": r0["mesh"], "backend": r0["backend"],
          "devices": [r["device"] for r in ranks],
          "step_theta_shape": r0["step_theta_shape"], "smc": r0["smc"],
          "spawn_seconds": round(spawn_s, 1)})
    c.end_phase()


def scaling_phase(c, out):
    """scaling_path: ``utils/scaling`` on the two ranks of phases 24-26's
    spawn, sharing the card (32 chains per rank, 2 + 5 steps): rank 0's
    line ``out`` has the reference's JSON keys plus
    ``ranks_per_card`` (2 here), both throughputs positive.  Ranks that
    share a card check the code path; the ratio is not scaling
    efficiency."""
    want = K_SHARDS / c.torch.cuda.device_count()
    if not (out["tput_1dev"] > 0 and out["tput_ndev"] > 0
            and out["n_devices"] == K_SHARDS and out["platform"] == "gpu"
            and out["ranks_per_card"] == max(want, 1.0)):
        c.failures.append(f"scaling_path: {out}")
    emit({"phase": "scaling_path", "card": c.smi, "args": SCALING_ARGS,
          "line": out,
          "note": "ranks sharing one card: a check of the code path, not "
                  "scaling efficiency"})
    c.end_phase()


def smc_scale_phase(c):
    """main_path_smc_scale: ``utils/smc_scale.main`` on a world of one rank
    in this process: (i) the toy at 2^20 particles with ``aux_slice`` (the
    reference's ``SMC_1M_toy.json`` run), |logZ - closed form| at most
    0.02; (ii) config 5's GP path (Pima subsample 32, S = 32, ``aux_nuts``,
    padded) at ``SMC_SCALE_GP_PARTICLES``: the last beta 1, logZ finite,
    the last stage's refresh acceptance at least the reference's floor of
    0.2, and the estimator, panel and threefry kernels launched in every
    stage; stage walls, peak memory, the chunk used.  Then one stage of a
    one-chunk population under ``torch.profiler``: its kernel launches and
    host syncs, what a chunk of (ii) costs."""
    torch, np = c.torch, c.np
    import tempfile

    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from auxpm_tpu_torch.models.datasets import load
    from auxpm_tpu_torch.models.gp_classification import make_gp_classification
    from auxpm_tpu_torch.parallel.mesh import (
        INIT_METHOD_ENV,
        distributed_init,
        make_mesh,
    )
    from auxpm_tpu_torch.samplers.composite import THETA_ONLY
    from auxpm_tpu_torch.samplers.smc_sharded import make_smc_sharded
    from auxpm_tpu_torch.utils import smc_scale

    world_dir = tempfile.mkdtemp(prefix="auxpm_world_")
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "LOCAL_WORLD_SIZE": "1",
           INIT_METHOD_ENV: f"file://{world_dir}/rendezvous"}
    torch.cuda.empty_cache()
    runs = {}
    try:
        with mock.patch.dict(os.environ, env):
            for name, argv in SMC_SCALE_RUNS.items():
                log(f"main path (smc_scale, {name}):", " ".join(argv))
                result = {}
                with contextlib.redirect_stdout(sys.stderr):   # its line
                    rc = smc_scale.main(argv, result=result)
                if rc != 0:
                    raise AssertionError(f"smc_scale returned {rc}")
                runs[name] = result
                torch.cuda.empty_cache()
            mesh1 = make_mesh(1)
        toy, gp = runs["toy"], runs["gp"]
        err = abs(toy["diag"]["log_z"] - smc_scale.toy_log_evidence())
        for name, r in runs.items():
            if r["out"]["betas"][-1] != 1.0 or \
                    not math.isfinite(r["diag"]["log_z"]):
                c.failures.append(f"main_path_smc_scale/{name}: betas "
                                  f"{r['out']['betas']}, logZ "
                                  f"{r['diag']['log_z']}")
        if not err <= SMC_SCALE_TOY_LOGZ_TOL:
            c.failures.append(f"main_path_smc_scale/toy: |logZ - closed "
                              f"form| = {err:.4f} > {SMC_SCALE_TOY_LOGZ_TOL}")
        if not gp["diag"]["u_mh_accept"][-1] >= U_BLOCKS_ACCEPT_FLOOR:
            c.failures.append(f"main_path_smc_scale/gp: last-stage refresh "
                              f"acceptance {gp['diag']['u_mh_accept'][-1]}")
        for st in gp["out"]["per_stage"][1:]:
            for k_ in ("fused_estimator", "chol_panel", "threefry_launches"):
                if st[k_] <= 0:
                    c.failures.append(f"main_path_smc_scale/gp: stage "
                                      f"{st['stage']} never launched {k_}")
        # one stage of a one-chunk population, profiled
        x32, y32 = load("pima", subsample=32, seed=0)
        tgt = make_gp_classification(x32, y32, n_importance=32,
                                     device="cuda")
        chunk = gp["out"]["rejuv_batch"]
        run1 = make_smc_sharded(tgt, THETA_ONLY["nuts"], chunk, mesh1,
                                n_mcmc=1, carry_u=False, n_u_mh=2,
                                rejuv_batch=chunk)
        st0, k_loop = run1.init_states(1)
        beta0 = torch.zeros((), dtype=torch.float32, device="cuda")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run1.stage(st0, beta0, k_loop, 0)
            torch.cuda.synchronize()
        launches = syncs = 0
        busy_ms = 0.0
        for evt in prof.key_averages():
            if evt.key == "aten::_local_scalar_dense":
                syncs += evt.count
            if evt.device_type == DeviceType.CUDA:
                launches += evt.count
                busy_ms += evt.self_device_time_total / 1e3
        del run1, st0
    finally:
        dist.destroy_process_group()
    line = {name: {k_: r["out"][k_] for k_ in (
        "target", "particles", "n_stages", "wall_total", "init_wall",
        "stage_wall", "log_z", "betas", "u_mh_accept", "posterior_mean",
        "posterior_std", "rejuv_batch", "chunks_per_stage", "peak_memory_gb",
        "per_stage")} for name, r in runs.items()}
    line["toy"].update(log_z_true=toy["out"]["log_z_true"],
                       log_z_abs_err=err, tol=SMC_SCALE_TOY_LOGZ_TOL,
                       record=SMC_1M_TOY_RECORD)
    emit({"phase": "main_path_smc_scale", "card": c.smi,
          "args": SMC_SCALE_RUNS, **line,
          "one_chunk_stage_profiled": {
              "particles": chunk, "kernel_launches": launches,
              "host_syncs": syncs, "device_busy_ms": busy_ms}})
    c.end_phase()


def any_shape_phases(c):
    """Phases 33-35 of the module note (every shape the reference runs),
    with ``main``'s helpers and inputs in the namespace ``c``."""
    any_shape_kernel_phase(c)
    main_path_s128_phase(c)
    main_path_unpadded_phase(c)


@contextlib.contextmanager
def plain_calls_on_the_card(c, backward=None):
    """Counts, per name, the calls of a plain estimator, sweep or
    factorisation that are given a CUDA tensor while the block runs (each
    plain function of ``ops/`` wherever it was imported, and the library's
    ``torch.linalg.cholesky_ex``); yields the dict of counts.  The calls
    made inside the estimator's backward (``FusedEstimate`` and
    ``FusedWeights`` differentiate their plain versions, as the reference
    has no backward kernel) are counted in the dict ``backward`` instead,
    where one is given."""
    torch = c.torch
    from auxpm_tpu_torch.ops import chol_hopper, cholesky
    from auxpm_tpu_torch.ops import ess_sweep as ess
    from auxpm_tpu_torch.ops import fused_estimator as fe
    from auxpm_tpu_torch.ops import sigma_sweep as sig

    calls, inside = {}, []

    def counting(name, fn):
        def wrapped(*a, **kw):
            if any(isinstance(x_, torch.Tensor) and x_.is_cuda
                   for x_ in (*a, *kw.values())):
                into = backward if inside and backward is not None else calls
                into[name] = into.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapped

    plain_vjp = fe._plain_vjp

    def marked_vjp(*a, **kw):
        inside.append(1)
        try:
            return plain_vjp(*a, **kw)
        finally:
            inside.pop()

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(fe, "_plain_vjp", marked_vjp))
        for mod in (fe, ess, sig, chol_hopper):
            for name in dir(mod):
                if name.startswith("_ref_"):
                    stack.enter_context(mock.patch.object(
                        mod, name, counting(name, getattr(mod, name))))
        stack.enter_context(mock.patch.object(
            cholesky.torch.linalg, "cholesky_ex",
            counting("cholesky_ex", torch.linalg.cholesky_ex)))
        yield calls


def _seq_bound(fe, b, s, n, rot=False, rows_out=False):
    """Bytes and FLOPs of one estimator entry: the factor's lower triangle,
    u (and v and the angle), y and the mask read once, one float (or S
    floats) written per chain; S n (n + 1) FLOPs per chain."""
    tri = n * (n + 1) // 2
    per_chain = tri + (2 if rot else 1) * s * n + (1 if rot else 0) \
        + (s if rows_out else 1)
    return bound(4 * (b * per_chain + 2 * n), b * fe.probe_flops(s, n))


def any_shape_kernel_phase(c):
    """kernels_any_shape: the six kernels of the sweep body against their
    plain versions at S past one block of 64 rows (``ANY_S`` at B = 128,
    n = 640 on config 2's factors; the sweeps at ``SWEEP_ANY_S``) and at n
    off the column tiles (``ANY_N_CHAINS`` at S = 64, unit-diagonal
    factors, every point real), at the kernels phase's bars; the sweeps'
    decisions equal outside them.  Bitwise: rows 64-127 of both weights
    kernels at S_local = 128 against a call on those 64 rows alone, and
    the estimate at S = 128 against the weights plus the blocked fold.  The
    factorisation through the identity-padded panel route at n = 532 and
    4177 against ``torch.linalg.cholesky_ex`` by max |L L^T - K| (the
    chol_variants batch: lengthscales in [0.5, 3], jitter 1e-2), the ARD
    Gram at n = 531 and 4177 against its plain version (8 eps max(sq)).
    Each with its ms and bound."""
    torch, np, t, dev = c.torch, c.np, c.t, c.dev
    from auxpm_tpu_torch.models.datasets import load
    from auxpm_tpu_torch.ops import cholesky
    from auxpm_tpu_torch.ops import ess_sweep as ess
    from auxpm_tpu_torch.ops import fused_estimator as fe
    from auxpm_tpu_torch.ops import gram as gr
    from auxpm_tpu_torch.ops import sigma_sweep as sig
    from auxpm_tpu_torch.ops.logsumexp import blocked_logsumexp
    from auxpm_tpu_torch.utils.chol_bench import make_batch

    log("kernels: every shape the reference runs")
    rng = np.random.default_rng(2016)
    chk, fails = c.check_close, c.failures
    y, mask, chol = c.y, c.mask, c.chol
    entries = {}

    def four_entries(tag, chol_, u_, v_, ang_, y_, mask_, nb):
        """The four entries against their plain versions; their errors."""
        b_, s_, n_ = u_.shape
        pairs = {
            "fused_estimator": (
                fe.fused_estimate(chol_, u_, y_, mask_, "logistic", nb),
                fe._ref_estimate(chol_, u_, y_, mask_, "logistic", nb)),
            "fused_estimator_rot": (
                fe.fused_estimate_rot(chol_, u_, v_, ang_, y_, mask_,
                                      "logistic", nb),
                fe._ref_estimate_rot(chol_, u_, v_, ang_, y_, mask_,
                                     "logistic", nb)),
            "fused_weights": (
                fe.fused_weights(chol_, u_, y_, mask_),
                fe._ref_weights(chol_, u_, y_, mask_, "logistic")),
            "fused_rot_weights": (
                fe.fused_rot_weights(chol_, u_, v_, ang_, y_, mask_),
                fe._ref_rot_weights(chol_, u_, v_, ang_, y_, mask_,
                                    "logistic")),
        }
        torch.cuda.synchronize()
        for name, (k_, p_) in pairs.items():
            entries.setdefault(name, {})[tag] = {
                "B": b_, "S": s_, "n": n_, "n_blocks": nb,
                "max_abs_err": chk(f"kernels_any_shape/{name}", tag, k_, p_,
                                   LL_TOL, None, LL_RTOL)}
        return pairs

    def time_entries(tag, chol_, u_, v_, ang_, y_, mask_, nb):
        b_, s_, n_ = u_.shape
        calls = {
            "fused_estimator": (lambda: fe.fused_estimate(
                chol_, u_, y_, mask_, "logistic", nb), {}),
            "fused_estimator_rot": (lambda: fe.fused_estimate_rot(
                chol_, u_, v_, ang_, y_, mask_, "logistic", nb),
                {"rot": True}),
            "fused_weights": (lambda: fe.fused_weights(chol_, u_, y_, mask_),
                              {"rows_out": True}),
            "fused_rot_weights": (lambda: fe.fused_rot_weights(
                chol_, u_, v_, ang_, y_, mask_),
                {"rot": True, "rows_out": True}),
        }
        for name, (fn, kw) in calls.items():
            b_ms, b_by = _seq_bound(fe, b_, s_, n_, **kw)
            entries[name][tag].update(ms=c.time_ms(fn, 3), bound_ms=b_ms,
                                      bound_by=b_by)

    # ---- S past one row block, at config 2's width
    bitwise = {}
    for s_ in ANY_S:
        u_ = t(rng.standard_normal((B, s_, N)))
        v_ = t(rng.standard_normal((B, s_, N)))
        ang_ = t(rng.uniform(-np.pi, np.pi, B))
        nb = 8 if s_ % 8 == 0 else 1
        tag = f"S={s_}"
        four_entries(tag, chol, u_, v_, ang_, y, mask, nb)
        time_entries(tag, chol, u_, v_, ang_, y, mask, nb)
        if s_ == 128:
            for name, fn in (("fused_weights", lambda a_, b_: fe.fused_weights(
                    chol, a_, y, mask)),
                    ("fused_rot_weights", lambda a_, b_: fe.fused_rot_weights(
                        chol, a_, b_, ang_, y, mask))):
                whole = fn(u_, v_)
                tail = fn(u_[:, 64:].contiguous(), v_[:, 64:].contiguous())
                bitwise[f"{name}_rows_64_127"] = torch.equal(whole[:, 64:],
                                                             tail)
            est = fe.fused_estimate(chol, u_, y, mask, "logistic", 8)
            fold = blocked_logsumexp(fe.fused_weights(chol, u_, y, mask), 8) \
                - float(np.log(np.float32(s_)))
            bitwise["estimate_vs_weights_plus_fold_S128"] = torch.equal(
                est, fold)
            bitwise["estimate_vs_weights_plus_fold_max_abs"] = float(
                (est - fold).abs().max())
            plain = {
                "fused_estimator": lambda: fe._ref_estimate(
                    chol, u_, y, mask, "logistic", 8),
                "fused_estimator_rot": lambda: fe._ref_estimate_rot(
                    chol, u_, v_, ang_, y, mask, "logistic", 8),
                "fused_weights": lambda: fe._ref_weights(
                    chol, u_, y, mask, "logistic"),
                "fused_rot_weights": lambda: fe._ref_rot_weights(
                    chol, u_, v_, ang_, y, mask, "logistic")}
            for name, f_ in plain.items():
                entries[name][tag]["plain_ms"] = c.time_ms(f_, 3)
        del u_, v_
    for key in ("fused_weights_rows_64_127", "fused_rot_weights_rows_64_127",
                "estimate_vs_weights_plus_fold_S128"):
        if not bitwise[key]:
            fails.append(f"kernels_any_shape: {key} not bitwise")

    # ---- n off the column tiles: every point real, S = 64
    for n_, b_ in ANY_N_CHAINS.items():
        chol_ = t(np.tril(rng.standard_normal((b_, n_, n_)) * 0.03)
                  + np.eye(n_))
        u_ = t(rng.standard_normal((b_, S, n_)))
        v_ = t(rng.standard_normal((b_, S, n_)))
        ang_ = t(rng.uniform(-np.pi, np.pi, b_))
        y_ = t(rng.choice([-1.0, 1.0], n_))
        mask_ = torch.ones(n_, device=dev)
        tag = f"n={n_}"
        four_entries(tag, chol_, u_, v_, ang_, y_, mask_, 8)
        time_entries(tag, chol_, u_, v_, ang_, y_, mask_, 8)
        del chol_, u_, v_

    # ---- both sweeps at S = 128 and 512, config 2's factors
    sweeps = {}
    hiv = 0.5 / 1.5**2
    theta = c.theta
    for s_ in SWEEP_ANY_S:
        u_ = t(rng.standard_normal((B, s_, N)))
        v_ = t(rng.standard_normal((B, N_ESS, s_, N)))
        scal = t(np.concatenate([
            np.zeros((B, N_ESS, 1)), np.log(rng.uniform(size=(B, N_ESS, 1))),
            rng.uniform(size=(B, N_ESS, 1)) * 2.0 * np.pi,
            rng.uniform(size=(B, N_ESS, 32))], axis=2))
        scal[:, 0, 0] = fe._ref_estimate(chol, u_, y, mask, "logistic", 8)
        probe_log = []
        out_k = ess.ess_sweep(chol, u_, scal, v_, y, mask, "logistic", 8,
                              None, N_ESS)
        out_p = ess._ref_ess_sweep(chol, u_, scal, v_, y, mask, "logistic",
                                   8, None, N_ESS, "float32",
                                   probe_log=probe_log)
        torch.cuda.synchronize()
        amb = c.ambiguous_chains(probe_log, LL_TOL)
        probes = float(out_k[2].sum()) + B * N_ESS
        b_ms, b_by = bound(4 * B * (TRI + (2 + N_ESS) * s_ * N
                                    + N_ESS * 35 + 4),
                           probes * fe.probe_flops(s_, N))
        sweeps[f"ess_sweep S={s_}"] = {
            "ambiguous_chains": c.check_counts(
                f"ess_sweep S={s_}", [("n_shrink", out_k[2], out_p[2]),
                                      ("moved", out_k[3], out_p[3])], amb),
            "u": chk("kernels_any_shape/ess_sweep", f"u' S={s_}", out_k[0],
                     out_p[0], U_TOL, ~amb),
            "ll": chk("kernels_any_shape/ess_sweep", f"ll S={s_}", out_k[1],
                      out_p[1], LL_TOL, ~amb, LL_RTOL),
            "probes": probes, "rounds": int(ess.last_rounds.item()),
            "ms": c.time_ms(lambda: ess.ess_sweep(
                chol, u_, scal, v_, y, mask, "logistic", 8, None, N_ESS), 3),
            "bound_ms": b_ms, "bound_by": b_by}
        del v_, out_k, out_p
        rep = t(rng.uniform(size=(B, N_SIGMA, 2 + 32)))
        rep[:, :, 0] = torch.log(rep[:, :, 0])
        ll0 = fe._ref_estimate(c.chol, u_, y, mask, "logistic", 8)
        d0 = theta[:, 1]
        lp0 = c.log_prior(theta)
        chain = torch.stack(
            [ll0, lp0 + ll0, theta[:, 1], torch.full_like(ll0, 1.2),
             torch.zeros_like(ll0), torch.full_like(ll0, hiv),
             lp0 + hiv * d0 * d0, torch.zeros_like(ll0)], dim=1).contiguous()
        probe_log = []
        out_k = sig.sigma_sweep(c.chol_r, u_, chain, rep, y, mask,
                                "logistic", 8, None, N_SIGMA)
        out_p = sig._ref_sigma_sweep(c.chol_r, u_, chain, rep, y, mask,
                                     "logistic", 8, None, N_SIGMA, "float32",
                                     probe_log=probe_log)
        torch.cuda.synchronize()
        amb = c.ambiguous_chains(probe_log, LL_TOL)
        probes = float(out_k[3].sum())
        b_ms, b_by = bound(4 * B * (TRI + s_ * N + 8 + N_SIGMA * 34 + 8),
                           probes * fe.probe_flops(s_, N))
        sweeps[f"sigma_sweep S={s_}"] = {
            "ambiguous_chains": c.check_counts(
                f"sigma_sweep S={s_}", [("n_shrink", out_k[3], out_p[3]),
                                        ("moved", out_k[4], out_p[4])], amb),
            "sigma": chk("kernels_any_shape/sigma_sweep", f"sigma' S={s_}",
                         out_k[0], out_p[0], SIGMA_TOL, ~amb),
            "ll": chk("kernels_any_shape/sigma_sweep", f"ll S={s_}",
                      out_k[1], out_p[1], LL_TOL, ~amb, LL_RTOL),
            "probes": probes, "rounds": int(sig.last_rounds.item()),
            "ms": c.time_ms(lambda: sig.sigma_sweep(
                c.chol_r, u_, chain, rep, y, mask, "logistic", 8, None,
                N_SIGMA), 3),
            "bound_ms": b_ms, "bound_by": b_by}
        del u_, out_k, out_p
        torch.cuda.empty_cache()

    # ---- the factorisation at n off 128, identity-padded panel route
    chols = {}
    for n_, b_ in CHOL_ANY_N.items():
        k_ = t(make_batch(b_, n_, seed=n_))
        scale = float(k_.abs().max())
        l_k = cholesky._chol_dispatch(k_)
        l_lib, info = torch.linalg.cholesky_ex(k_)
        torch.cuda.synchronize()
        back_k = float((torch.bmm(l_k, l_k.mT) - k_).abs().max()) / scale
        back_lib = float((torch.bmm(l_lib, l_lib.mT) - k_).abs().max()) / scale
        # the library's own error sets the bar where it exceeds the
        # chol_variants bar (float32 at n = 4177)
        bar = max(CHOL_BACK_RTOL, 2.0 * back_lib)
        if not (back_k <= bar and bool(torch.isfinite(l_k).all())
                and int(info.max()) == 0):
            fails.append(f"kernels_any_shape/chol n={n_}: |L L^T - K| "
                         f"{back_k:.3e} relative, bar {bar:.3e}")
        n_pad = -(-n_ // 128) * 128
        tri_pad = n_pad * (n_pad + 1) // 2
        b_ms, b_by = bound(4 * b_ * 2 * (n_ * (n_ + 1) // 2),
                           b_ * n_**3 / 3.0)
        chols[f"n={n_}"] = {
            "B": b_, "n_padded": n_pad, "backward_err_rel": back_k,
            "library_backward_err_rel": back_lib, "bar": bar,
            "ms": c.time_ms(lambda: cholesky._chol_dispatch(k_), 3),
            "library_ms": c.time_ms(lambda: torch.linalg.cholesky_ex(k_), 3),
            "bound_ms": b_ms, "bound_by": b_by,
            "padded_work_share": b_ * tri_pad / (b_ * n_ * (n_ + 1) / 2)}
        del k_, l_k, l_lib
        torch.cuda.empty_cache()

    # ---- the ARD Gram off a multiple of 4
    grams = {}
    eps = float(np.finfo(np.float32).eps)
    for n_, b_ in GRAM_ANY_N.items():
        if n_ == 4177:
            x_np, _ = load("abalone")
        else:
            x_np = c.x[:n_]
        x_ = t(x_np)
        d_ = x_.shape[1]
        le = t(rng.normal(size=(b_, d_)) * 0.5)
        sq_max = float(((x_[None] * torch.exp(-le)[:, None, :]) ** 2)
                       .sum(-1).max())
        tol = 8.0 * eps * max(sq_max, 1.0)
        g_k = gr.se_gram_ard_hopper(x_, le, 1e-5)
        g_p = gr.se_gram_ard_masked(x_, le, 1e-5)
        torch.cuda.synchronize()
        b_ms, b_by = bound(4 * (b_ * (n_ * n_ + d_) + n_ * d_),
                           b_ * n_ * n_ * (2.0 * d_ + 8.0))
        grams[f"n={n_}"] = {
            "B": b_, "d": d_, "tol": tol,
            "max_abs_err": chk("kernels_any_shape/se_gram_ard", f"n={n_}",
                               g_k, g_p, tol),
            "symmetric": bool(torch.equal(g_k, g_k.mT)),
            "ms": c.time_ms(lambda: gr.se_gram_ard_hopper(x_, le, 1e-5), 3),
            "plain_ms": c.time_ms(lambda: gr.se_gram_ard_masked(x_, le,
                                                                1e-5), 3),
            "bound_ms": b_ms, "bound_by": b_by}
        if not grams[f"n={n_}"]["symmetric"]:
            fails.append(f"kernels_any_shape/se_gram_ard n={n_}: not "
                         "symmetric")
        del g_k, g_p
    torch.cuda.empty_cache()
    for name, row in entries.items():
        c.kernels[name]["any_shape"] = row
    emit({"phase": "kernels_any_shape", "card": c.smi, "entries": entries,
          "bitwise": bitwise, "sweeps": sweeps, "factorisation": chols,
          "se_gram_ard": grams, "tol": LL_TOL, "rtol": LL_RTOL})
    c.end_phase()


def main_path_s128_phase(c):
    """main_path_s128: config 2 with S = 128 through the CLI
    (``S128_CLI_ARGS``): the estimator, panel, both sweeps and threefry
    launched, no other kernel, and no plain estimator, sweep or
    factorisation called on the card; steps/s and peak memory; then one
    keyed step from the final state against the plain path on the same
    rows (``step_parity``, the sigma sweep plain too)."""
    torch = c.torch
    must = ("fused_estimator", "chol_panel", "ess_sweep", "sigma_sweep",
            "threefry")
    log("main path (S = 128):", " ".join(S128_CLI_ARGS))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with plain_calls_on_the_card(c) as plain:
        res, cnt = c.run_cli(S128_CLI_ARGS, must,
                             [k_ for k_ in c.counters if k_ not in must])
    peak = torch.cuda.max_memory_allocated() / 1e9
    st = res["states"]
    if st.u.shape != (S128_CHAINS, 128, N) or not st.u.is_cuda:
        raise AssertionError(f"main_path_s128: u {tuple(st.u.shape)}")
    if plain:
        c.failures.append(f"main_path_s128: plain calls on the card {plain}")
    if not bool(torch.isfinite(st.log_lik_hat).all()):
        c.failures.append("main_path_s128: non-finite log L-hat")
    health = _sampler_health(res)
    tgt, par = res["target"], res["params"]
    parity, stats = c.step_parity("main_path_s128", port_run_step(tgt), tgt,
                                  st, par, c.y, c.mask, plain_sigma=True,
                                  max_ambiguous=THETA_MAX_AMBIGUOUS)
    emit({"phase": "main_path_s128", "card": c.smi, "args": S128_CLI_ARGS,
          "launches": cnt, "plain_calls_on_the_card": plain,
          "launches_per_step": {k_: v_ / S128_STEPS for k_, v_ in cnt.items()},
          "chain_steps_per_sec": res["summary"]["chain_steps_per_sec"],
          "steps_per_sec": res["summary"]["chain_steps_per_sec"]
          / S128_CHAINS,
          "run_wall_s": res["summary"]["wall"], "peak_memory_gb": peak,
          "n_blocks": tgt.n_weight_blocks, **health,
          "step_parity": parity, "step_parity_stats": stats})
    del res, st, tgt
    torch.cuda.empty_cache()
    c.end_phase()


def main_path_unpadded_phase(c):
    """main_path_unpadded: ``utils/smc_scale --target gp --no-pad`` on a
    world of one rank in this process (``UNPADDED_RUNS``): n = 32 at 2^14
    particles in one chunk (beside phase 32's padded one-chunk stage), and
    the full n = 532 at ``UNPADDED_FULL_N_PARTICLES``.  In each: the
    estimator, panel and threefry kernels launched in every stage, no sweep,
    no plain estimator or factorisation on the card outside the NUTS
    gradient's backward (reported), the last beta 1, logZ finite.  Then at
    fixed (theta, u) the unpadded full-n target's estimate against the
    padded target's at u padded with zeros, at the estimator's bar (and
    whether it is bitwise), with the two factors compared."""
    torch, np, t = c.torch, c.np, c.t
    import tempfile

    import torch.distributed as dist

    from auxpm_tpu_torch.models.gp_classification import make_gp_classification
    from auxpm_tpu_torch.parallel.mesh import INIT_METHOD_ENV
    from auxpm_tpu_torch.utils import smc_scale

    world_dir = tempfile.mkdtemp(prefix="auxpm_world_")
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "LOCAL_WORLD_SIZE": "1",
           INIT_METHOD_ENV: f"file://{world_dir}/rendezvous"}
    torch.cuda.empty_cache()
    runs = {}
    try:
        with mock.patch.dict(os.environ, env):
            for name, argv in UNPADDED_RUNS.items():
                log(f"main path (smc_scale --no-pad, {name}):",
                    " ".join(argv))
                result = {}
                for m_, attr in c.counters.values():
                    setattr(m_, attr, 0)
                t0 = time.time()
                in_backward = {}
                with plain_calls_on_the_card(c, in_backward) as plain, \
                        contextlib.redirect_stdout(sys.stderr):
                    rc = smc_scale.main(argv, result=result)
                torch.cuda.synchronize()
                if rc != 0:
                    raise AssertionError(f"smc_scale returned {rc}")
                runs[name] = {"result": result, "plain": dict(plain),
                              "in_backward": in_backward,
                              "counts": c.read_counts(),
                              "wall_s": time.time() - t0}
                torch.cuda.empty_cache()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    line = {}
    for name, r in runs.items():
        out, diag = r["result"]["out"], r["result"]["diag"]
        if out["padded"] is not False:
            c.failures.append(f"main_path_unpadded/{name}: padded target")
        if out["betas"][-1] != 1.0 or not math.isfinite(diag["log_z"]):
            c.failures.append(f"main_path_unpadded/{name}: betas "
                              f"{out['betas']}, logZ {diag['log_z']}")
        if r["plain"]:
            c.failures.append(f"main_path_unpadded/{name}: plain calls on "
                              f"the card {r['plain']}")
        for k_ in ("ess_sweep", "sigma_sweep"):
            if r["counts"][k_]:
                c.failures.append(f"main_path_unpadded/{name}: launched {k_}")
        for st_ in out["per_stage"][1:]:
            for k_ in ("fused_estimator", "chol_panel", "threefry_launches"):
                if st_[k_] <= 0:
                    c.failures.append(f"main_path_unpadded/{name}: stage "
                                      f"{st_['stage']} never launched {k_}")
        line[name] = {k_: out[k_] for k_ in (
            "target", "particles", "n_stages", "wall_total", "init_wall",
            "stage_wall", "log_z", "betas", "u_mh_accept", "rejuv_batch",
            "chunks_per_stage", "peak_memory_gb", "per_stage", "padded")}
        line[name].update(
            launches=r["counts"], wall_s_with_set_up=r["wall_s"],
            plain_calls_on_the_card=r["plain"],
            plain_recomputes_in_the_gradients_backward=r["in_backward"])
    # the full-n estimate at fixed (theta, u), unpadded against padded
    rng = np.random.default_rng(532)
    from auxpm_tpu_torch.models.datasets import load

    x_, y_ = load("pima")
    t_raw = make_gp_classification(x_, y_, n_importance=32, pad_to_tiles=False,
                                   device="cuda")
    t_pad = make_gp_classification(x_, y_, n_importance=32, device="cuda")
    n_raw, n_pad = t_raw.u_shape[1], t_pad.u_shape[1]
    theta = t(rng.normal(size=(B, 2)) * 0.5)
    u_raw = t(rng.standard_normal((B, 32, n_raw)))
    u_pad = torch.nn.functional.pad(u_raw, (0, n_pad - n_raw))
    with plain_calls_on_the_card(c) as plain_fixed:
        ll_raw = t_raw.log_lik_est(theta, u_raw)
        ll_pad = t_pad.log_lik_est(theta, u_pad)
        c_raw, c_pad = t_raw.prepare(theta), t_pad.prepare(theta)
    torch.cuda.synchronize()
    fixed = {
        "n": n_raw, "n_padded": n_pad, "chains": B,
        "max_abs_err": c.check_close("main_path_unpadded", "estimate "
                                     "unpadded vs padded", ll_raw, ll_pad,
                                     LL_TOL, None, LL_RTOL),
        "bitwise": bool(torch.equal(ll_raw, ll_pad)),
        "factor_max_abs_diff": float((c_raw - c_pad[:, :n_raw, :n_raw])
                                     .abs().max()),
        "factor_bitwise": bool(torch.equal(c_raw, c_pad[:, :n_raw, :n_raw])),
        "plain_calls_on_the_card": plain_fixed}
    if plain_fixed:
        c.failures.append(f"main_path_unpadded: plain calls {plain_fixed}")
    emit({"phase": "main_path_unpadded", "card": c.smi,
          "args": UNPADDED_RUNS, **line, "fixed_theta_u": fixed})
    del t_raw, t_pad, c_raw, c_pad
    torch.cuda.empty_cache()
    c.end_phase()


def bench_scripts_phase(c):
    """bench_scripts: the counterparts of the reference's three measuring
    scripts, called on the card at full width (Pima n=532 padded to 640,
    S=64, 128 chains) and cut depth: ``utils/tau_sweep.sweep`` over its
    three variants (``BENCH_TAU``), ``utils/theta_bench.bench`` and
    ``utils/ess_sweep_bench.bench`` at ``AB_STEPS = BENCH_AB_STEPS``.  Their
    lines are printed as the modules print them.  Checks: no variant
    ``FAILED``, finite tau and ESS; theta_bench's (a)/(b) parity bitwise;
    ess_sweep_bench's shrink counts equal and its values within
    ``ESS_SWEEP_VS_LOOP``; kernels 1-5 and T launched across the phase, and
    no plain estimator, sweep or factorisation called on the card."""
    torch, np = c.torch, c.np
    from auxpm_tpu_torch.utils import ess_sweep_bench, tau_sweep, theta_bench

    log("bench scripts: tau_sweep, theta_bench, ess_sweep_bench")
    torch.cuda.empty_cache()
    for m, attr in c.counters.values():
        setattr(m, attr, 0)
    t0 = time.time()
    with plain_calls_on_the_card(c) as plain:
        taus, failed = tau_sweep.sweep(tau_sweep.VARIANTS.split(","), c.x,
                                       c.y_np, device="cuda", **BENCH_TAU)
        tau_s = time.time() - t0
        th = theta_bench.bench(c.x, c.y_np, steps=BENCH_AB_STEPS,
                               device="cuda")
        print(theta_bench.result_line(th), flush=True)
        es = ess_sweep_bench.bench(c.x, c.y_np, steps=BENCH_AB_STEPS,
                                   device="cuda")
        print(ess_sweep_bench.result_line(es), flush=True)
    torch.cuda.synchronize()
    counts = c.read_counts()
    if failed:
        c.failures.append(f"bench_scripts: tau_sweep FAILED {failed}")
    for r in taus:
        if not (np.isfinite(r["tau"]).all() and np.isfinite(r["ess"]).all()):
            c.failures.append(f"bench_scripts: {r['name']} tau {r['tau']} "
                              f"ESS {r['ess']}")
    if not (th["parity_dth"] == 0.0 and th["parity_dll"] == 0.0):
        c.failures.append(f"bench_scripts: theta_bench (a)/(b) parity "
                          f"dth {th['parity_dth']:.3e} dll "
                          f"{th['parity_dll']:.3e}, not bitwise")
    bar = ESS_SWEEP_VS_LOOP
    if es["max_dns"] != 0.0:
        c.failures.append(f"bench_scripts: ess_sweep_bench shrink counts "
                          f"differ by {es['max_dns']}")
    if not (es["max_du"] <= bar["u"] and es["max_dll"] <= bar["ll"]
            + bar["ll_rtol"] * es["max_abs_ll"]):
        c.failures.append(f"bench_scripts: ess_sweep_bench max_du "
                          f"{es['max_du']:.3e} max_dll {es['max_dll']:.3e} "
                          f"past {bar}")
    for name in BENCH_KERNELS:
        if counts[name] <= 0:
            c.failures.append(f"bench_scripts: never launched {name}")
    if plain:
        c.failures.append(f"bench_scripts: plain calls on the card {plain}")
    emit({"phase": "bench_scripts", "card": c.smi,
          "tau_sweep": {"cut": BENCH_TAU, "seconds": tau_s,
                        "failed": failed, "variants": taus},
          "theta_bench": {"steps": BENCH_AB_STEPS, **th},
          "ess_sweep_bench": {"steps": BENCH_AB_STEPS, **es,
                              "bar": ESS_SWEEP_VS_LOOP},
          "launches": counts, "plain_calls_on_the_card": plain,
          "seconds": time.time() - t0})
    torch.cuda.empty_cache()
    c.end_phase()


def _ulps(torch, a, b):
    """Largest distance in units in the last place between two float32
    tensors (or int tensors of their bit patterns)."""
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    a = a.to(torch.int64) & 0xFFFFFFFF
    b = b.to(torch.int64) & 0xFFFFFFFF
    a = torch.where(a >= 2**31, 2**31 - a, a)   # sign-magnitude order
    b = torch.where(b >= 2**31, 2**31 - b, b)
    return int((a - b).abs().max())


def _big_inputs(np, t, n):
    """Inputs of the sweeps and the rotated weights at ``B_BIG`` chains and
    ``n``, from their own seed: a unit-diagonal lower-triangular factor, u,
    v (``N_ESS`` repeats), labels and a mask with a padded tail."""
    rng = np.random.default_rng(n)
    return {
        "rng": rng,
        "chol": t(np.tril(rng.standard_normal((B_BIG, n, n)) * 0.03)
                  + np.eye(n)),
        "u": t(rng.standard_normal((B_BIG, S, n))),
        "v": t(rng.standard_normal((B_BIG, N_ESS, S, n))),
        "y": t(rng.choice([-1.0, 1.0], n)),
        "mask": t((np.arange(n) < n - 37).astype(np.float32)),
    }


def _pima_sqdist(np, x, n):
    """The target's padded squared distances (host f64, pad 1e30, diag 0)."""
    x64 = np.asarray(x, np.float64)
    sq = ((x64[:, None, :] - x64[None, :, :]) ** 2).sum(-1).astype(np.float32)
    big = np.full((n, n), np.float32(1e30))
    big[: len(x), : len(x)] = sq
    np.fill_diagonal(big, 0.0)
    return big


def _sampler_health(result):
    """The sampled chains must move u and probe theta (means over the
    chains and steps of the last sampling window)."""
    window = result["windows"][-1]
    moved, n_probe = window["ess_u/moved"], window["slice_theta/n_probe"]
    if not moved > 0.5:
        raise AssertionError(f"ess_u/moved = {moved}")
    if not n_probe > 0:
        raise AssertionError(f"slice_theta/n_probe = {n_probe}")
    if not math.isfinite(result["summary"]["chain_steps_per_sec"]):
        raise AssertionError("chain_steps_per_sec is not finite")
    return {"ess_u/moved": moved, "slice_theta/n_probe": n_probe,
            "ess_u/n_shrink": window["ess_u/n_shrink"],
            "slice_theta/n_probe_chol": window["slice_theta/n_probe_chol"]}


def port_run_step(target):
    from auxpm_tpu_torch.samplers.composite import SAMPLERS

    return SAMPLERS["aux_slice"](target, n_ess=N_ESS,
                                 n_sigma_extra=N_SIGMA - 1)


if __name__ == "__main__":
    sys.exit(main())
