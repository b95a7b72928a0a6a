"""Preset composite transitions.

Counterpart of ``auxpm_tpu/samplers/composite.py``.  "Auxiliary
pseudo-marginal slice sampling" is the composition (ESS on u | theta) then
(slice on theta | u).  ``SAMPLERS`` holds the transitions the port can run:

- ``aux_slice``:       ESS(u) then per-coordinate slice(theta)   [the method]
- ``aux_slice_rd``:    ESS(u) then random-direction slice(theta)
- ``aux_slice_pcrd``:  ``aux_slice`` then a random-direction slice(theta)
- ``aux_slice_joint``: ``aux_slice`` then a joint (theta, u) slice
- ``aux_mh``:          ESS(u) then random-walk MH(theta)
- ``pm_mh``:           plain pseudo-marginal MH baseline
- ``joint_slice``:     joint (theta, u) slice updates alone
- ``joint_mh``:        joint random-walk MH on theta with a pCN move on u
- ``aux_hmc``:         ESS(u) then HMC(theta)
- ``aux_nuts``:        ESS(u) then NUTS(theta)

``THETA_ONLY`` holds the theta | u kernels without a u-update (the
rejuvenation kernels of the reference's sharded SMC): ``slice_theta``,
``mh_theta``, ``nuts`` and ``hmc``.  Every stage draws from and advances
``state.key`` itself, as in the reference, so each chain's step is a
function of its own key.
"""

from __future__ import annotations

from auxpm_tpu_torch.core.transition import compose
from auxpm_tpu_torch.samplers.ess_u import make_ess_u
from auxpm_tpu_torch.samplers.hmc import make_hmc
from auxpm_tpu_torch.samplers.joint_slice import make_joint_mh, make_joint_slice
from auxpm_tpu_torch.samplers.mh_theta import make_mh_theta
from auxpm_tpu_torch.samplers.nuts import make_nuts
from auxpm_tpu_torch.samplers.pm_mh import make_pm_mh
from auxpm_tpu_torch.samplers.slice_theta import (
    make_slice_theta,
    make_slice_theta_rd,
)


def make_aux_slice(target, particle_axis=None, n_ess=1, n_sigma_extra=0):
    """The paper's method: ESS(u) then per-coordinate slice(theta).

    ``n_ess`` repeats the elliptical-slice u-update per iteration (the
    repeats are Cholesky-free: theta is fixed); ``n_sigma_extra`` repeats the
    Cholesky-free log_sigma slice update per sweep.  ``particle_axis``: this
    rank's ``parallel.mesh.Mesh`` when ``target`` is particle sharded (only
    the stages that draw u-shaped rows need to know)."""
    return compose(
        [
            ("ess_u", make_ess_u(target, particle_axis, n_repeats=n_ess)),
            ("slice_theta", make_slice_theta(target, n_sigma_extra)),
        ]
    )


def make_aux_slice_rd(target, particle_axis=None, n_ess=1):
    """ESS(u) then ONE random-direction slice update of theta; the rd stage
    is named ``slice_theta`` (its group's ``widths`` give the bracket)."""
    return compose(
        [
            ("ess_u", make_ess_u(target, particle_axis, n_repeats=n_ess)),
            ("slice_theta", make_slice_theta_rd(target)),
        ]
    )


def make_aux_slice_pcrd(target, particle_axis=None, n_ess=1,
                        n_sigma_extra=0):
    """``aux_slice`` with a random-direction theta slice appended after the
    per-coordinate sweep, against the (log_ell, log_sigma) correlation that
    axis-aligned moves cross in small steps.  The rd stage reads
    ``params["slice_theta_rd"]["widths"]`` (their mean is its bracket)."""
    return compose(
        [
            ("ess_u", make_ess_u(target, particle_axis, n_repeats=n_ess)),
            ("slice_theta", make_slice_theta(target, n_sigma_extra)),
            ("slice_theta_rd", make_slice_theta_rd(target)),
        ]
    )


def make_aux_slice_joint(target, particle_axis=None, n_ess=1,
                         n_sigma_extra=0):
    """``aux_slice`` with a joint (theta, u) random-direction slice appended:
    one more probe sequence per step against both the cross-coordinate
    correlation and the theta-log L̂ coupling."""
    return compose(
        [
            ("ess_u", make_ess_u(target, particle_axis, n_repeats=n_ess)),
            ("slice_theta", make_slice_theta(target, n_sigma_extra)),
            ("joint_slice", make_joint_slice(target, particle_axis)),
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


def make_joint_slice_kernel(target, particle_axis=None):
    """Joint (theta, u) slice updates alone."""
    return compose([("joint_slice", make_joint_slice(target, particle_axis))])


def make_joint_mh_kernel(target, particle_axis=None):
    """Joint RW-MH on theta with a pCN rotation of u (correlated
    pseudo-marginal MH; rho = pi/2 is PM-MH)."""
    return compose([("joint_mh", make_joint_mh(target, particle_axis))])


def make_aux_hmc(target, particle_axis=None):
    """ESS(u) then HMC(theta), one elliptical-slice update per step."""
    return compose([("ess_u", make_ess_u(target, particle_axis)),
                    ("hmc", make_hmc(target))])


def make_aux_nuts(target, particle_axis=None):
    """ESS(u) then NUTS(theta), one elliptical-slice update per step."""
    return compose([("ess_u", make_ess_u(target, particle_axis)),
                    ("nuts", make_nuts(target))])


def _make_theta_only(kind):
    """theta | u kernels with NO u-update; ``particle_axis`` is accepted and
    unused (a theta probe pays the whole estimator either way)."""
    makers = {"slice_theta": make_slice_theta, "mh_theta": make_mh_theta,
              "nuts": make_nuts, "hmc": make_hmc}

    def factory(target, particle_axis=None):
        del particle_axis
        return compose([(kind, makers[kind](target))])

    return factory


THETA_ONLY = {
    k: _make_theta_only(k) for k in ("slice_theta", "mh_theta", "nuts", "hmc")
}

SAMPLERS = {
    "pm_mh": make_pm_mh,
    "aux_slice": make_aux_slice,
    "aux_slice_rd": make_aux_slice_rd,
    "aux_slice_pcrd": make_aux_slice_pcrd,
    "aux_slice_joint": make_aux_slice_joint,
    "aux_mh": make_aux_mh,
    "aux_hmc": make_aux_hmc,
    "aux_nuts": make_aux_nuts,
    "joint_slice": make_joint_slice_kernel,
    "joint_mh": make_joint_mh_kernel,
}
