"""Preset composite transitions.

Counterpart of ``auxpm_tpu/samplers/composite.py``.  "Auxiliary
pseudo-marginal slice sampling" is the composition (ESS on u | theta) then
(slice on theta | u).  ``SAMPLERS`` holds the transitions the port can run:

- ``aux_slice``: ESS(u) then per-coordinate slice(theta)   [the method]
- ``aux_mh``:    ESS(u) then random-walk MH(theta)
- ``pm_mh``:     plain pseudo-marginal MH baseline

The others of the reference (``aux_slice_rd``, ``aux_slice_pcrd``,
``aux_slice_joint``, ``aux_hmc``, ``aux_nuts``, the joint kernels, the
theta-only factories and SMC) are listed in ROADMAP.md.
"""

from __future__ import annotations

from auxpm_tpu_torch.core.transition import compose
from auxpm_tpu_torch.samplers.ess_u import make_ess_u
from auxpm_tpu_torch.samplers.mh_theta import make_mh_theta
from auxpm_tpu_torch.samplers.pm_mh import make_pm_mh
from auxpm_tpu_torch.samplers.slice_theta import make_slice_theta


def make_aux_slice(target, particle_axis=None, n_ess=1, n_sigma_extra=0):
    """The paper's method: ESS(u) then per-coordinate slice(theta).

    ``n_ess`` repeats the elliptical-slice u-update per iteration (the
    repeats are Cholesky-free: theta is fixed); ``n_sigma_extra`` repeats the
    Cholesky-free log_sigma slice update per sweep.  ``particle_axis``: this
    rank's ``parallel.mesh.Mesh`` when ``target`` is particle sharded (only
    the u-update draws u-shaped rows and needs to know)."""
    return compose(
        [
            ("ess_u", make_ess_u(target, particle_axis, n_repeats=n_ess)),
            ("slice_theta", make_slice_theta(target, n_sigma_extra)),
        ]
    )


def make_aux_mh(target, particle_axis=None):
    """ESS(u) then random-walk MH(theta), one elliptical-slice update per
    step as in the reference."""
    return compose(
        [
            ("ess_u", make_ess_u(target, particle_axis)),
            ("mh_theta", make_mh_theta(target)),
        ]
    )


SAMPLERS = {
    "aux_slice": make_aux_slice,
    "aux_mh": make_aux_mh,
    "pm_mh": make_pm_mh,
}
