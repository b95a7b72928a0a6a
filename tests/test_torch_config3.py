"""PyTorch port vs the JAX package: config 3 (CPU): the Breast-Cancer and
Abalone loaders, every preset, and one ``aux_slice`` step on each dataset.

The loaders must be bitwise the reference's (the port keeps its own NumPy
copy: real Breast-Cancer data through scikit-learn, the synthetic Abalone
stand-in, the same subsample rule).  The presets must equal the
reference's field for field, ``device`` aside.

The step tests run the reference's ``make_aux_slice`` with the config-3
settings (carried factor, stepping out with ``max_step_out=8``,
``max_shrink_chol=32``, one elliptical-slice update, S=64) for one step on 4
chains of each dataset subsampled to 256 points (n=256), recompute its rows
with ``jax.random`` and feed state and rows to the port's ``apply``, as
``tests/test_torch_stepout.py`` does.  Off the TPU the reference takes its
whole-sweep ESS in its jnp version and the per-probe log_sigma path (the
sigma sweep is for shrinkage-only slices); the port takes its ESS sweep (the
plain version on the CPU) and the per-probe log_sigma path too.

Tolerances: shrink, probe and moved counts EQUAL; theta and u 1e-5.  The
sampled lengthscales (log ell ~2 to 7 on standardised features) make R(ell)
+ 1e-5 I nearly singular, so the two packages' f32 factors of one Gram
differ by up to ~7e-4 and log L̂ off them by up to ~2e-2 (largest seen in
these runs): the carried factor and log L̂ go through a refactorisation and
are held to the bars of ``chip_smoke.py``'s path parity, 1e-2 and 5e-2; the
port's log L̂ is then held at the estimator's bar, 2e-4, to the reference's
estimator evaluated on the port's OWN final theta, u and factor (largest
seen 1.5e-5).
"""

import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auxpm_tpu.models import datasets as jdatasets
from auxpm_tpu.models.gp_classification import (
    make_gp_classification as jmake,
)
from auxpm_tpu.utils.config import PRESETS as J_PRESETS
from auxpm_tpu_torch.models import datasets as tdatasets
from auxpm_tpu_torch.models.gp_classification import (
    make_gp_classification as tmake,
)
from auxpm_tpu_torch.utils.config import PRESETS, build_target
from tests.test_torch_stepout import (
    INFO_KEYS,
    _apply_step,
    _reference_run,
    _to_port,
)

N_SUB = 256
SUBSAMPLE_SEED = 0
LL_TOL, PATH_CHOL_TOL, PATH_LL_TOL = 2e-4, 1e-2, 5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs several workers
    on the same cores, where multi-threaded small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def datasets():
    """Each dataset as both packages load it: whole, and subsampled to
    ``N_SUB`` points.  Each package's raw loader runs once per dataset (its
    entry in ``DATASETS`` is memoised while this module's tests run);
    ``load`` and its subsample rule run as they are."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jdatasets, tdatasets):
            for name in ("breast_cancer", "abalone"):
                mp.setitem(mod.DATASETS, name,
                           functools.cache(mod.DATASETS[name]))
        for name in ("breast_cancer", "abalone"):
            for sub in (None, N_SUB):
                out[name, sub] = (
                    jdatasets.load(name, subsample=sub, seed=SUBSAMPLE_SEED),
                    tdatasets.load(name, subsample=sub, seed=SUBSAMPLE_SEED))
        yield out


@pytest.mark.parametrize("name,sub,shape", [
    ("breast_cancer", None, (569, 30)), ("breast_cancer", N_SUB, (N_SUB, 30)),
    ("abalone", None, (4177, 8)), ("abalone", N_SUB, (N_SUB, 8)),
])
def test_loaders_are_bitwise_the_reference(datasets, name, sub, shape):
    (xj, yj), (xt, yt) = datasets[name, sub]
    assert xt.shape == shape and xt.dtype == yt.dtype == np.float32
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(yt, yj)
    assert set(np.unique(yt)) == {-1.0, 1.0}


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_presets_equal_the_reference_field_for_field(preset):
    port = dataclasses.asdict(PRESETS[preset])
    assert port.pop("device") == "cuda"
    assert port == dataclasses.asdict(J_PRESETS[preset])


def test_full_n_abalone_target(datasets):
    """``--subsample 0`` is full-n Abalone, 4177 points padded to 4224, with
    the sweeps on (every n that is a multiple of 64 fits the sweep body)."""
    cfg = PRESETS["abalone_aux"].replace(device="cpu", subsample=0)
    tt = build_target(cfg)
    assert tt.u_shape == (64, 4224) and tt.n_weight_blocks == 8
    assert tt.ess_sweep_factory(1) is not None
    assert tt.name == "gp_logistic_n4177"
    sub = build_target(PRESETS["abalone_aux"].replace(device="cpu"))
    assert sub.u_shape == (64, 1024)


@pytest.fixture(scope="module")
def config3_runs(datasets):
    """One reference step per dataset at the config-3 settings."""
    runs = {}
    for name in ("breast_cancer", "abalone"):
        cfg = J_PRESETS[f"{name}_aux"]
        (x, y), _ = datasets[name, N_SUB]
        tj = jmake(x, y, n_importance=cfg.n_importance)
        tt = tmake(x, y, n_importance=cfg.n_importance, device="cpu")
        params_j = {"ess_u": {}, "slice_theta": {
            "widths": jnp.full((2,), cfg.widths, jnp.float32),
            "max_step_out": cfg.max_step_out,
            "max_shrink_chol": cfg.max_shrink_chol}}
        runs[name] = _reference_run(tj, tt, cfg.n_ess, cfg.n_sigma_extra,
                                    params_j, 1, cfg.chol_cache,
                                    seed=9) + (tj,)
    return runs


@pytest.mark.parametrize("name", ["breast_cancer", "abalone"])
def test_config3_step_matches_jax(config3_runs, name):
    states, infos, rows, params_t, step_t, tj = config3_runs[name]
    assert step_t.stages["ess_u"].uses_sweep
    state_t, info_t = _apply_step(step_t, _to_port(states[0]), rows[0],
                                  params_t)
    want = states[1]
    for k in INFO_KEYS:
        np.testing.assert_array_equal(info_t[k].numpy(), infos[0][k],
                                      err_msg=k)
    for what, tol in (("theta", 1e-5), ("u", 1e-5),
                      ("log_lik_hat", PATH_LL_TOL)):
        np.testing.assert_allclose(getattr(state_t, what).numpy(),
                                   np.asarray(getattr(want, what)), rtol=0,
                                   atol=tol, err_msg=what)
    chol_t = state_t.extras["target_cache"]["chol_r"].numpy()
    np.testing.assert_allclose(
        chol_t, np.asarray(want.extras["target_cache"]["chol_r"]), rtol=0,
        atol=PATH_CHOL_TOL)
    own = jax.vmap(lambda th, c, u: tj.log_lik_est_u(
        tj.prepare_c(th, {"chol_r": c}), u))(
            jnp.asarray(state_t.theta.numpy()), jnp.asarray(chol_t),
            jnp.asarray(state_t.u.numpy()))
    np.testing.assert_allclose(state_t.log_lik_hat.numpy(), np.asarray(own),
                               rtol=0, atol=LL_TOL)
    # stepping out ran: every chain probed each coordinate's two ends
    assert (info_t["slice_theta/n_probe"].numpy() >= 2 * (2 + 1)).all()


def test_breast_cancer_without_scikit_learn(monkeypatch):
    """Where scikit-learn is missing, the loader and the preset raise an
    ImportError that names it (and the preset)."""
    monkeypatch.setitem(tdatasets.DATASETS, "breast_cancer",
                        tdatasets.load_breast_cancer)   # not the memo
    for mod in [m for m in sys.modules if m.split(".")[0] == "sklearn"]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    with pytest.raises(ImportError, match="breast_cancer_aux.*scikit-learn"):
        tdatasets.load("breast_cancer")
    with pytest.raises(ImportError, match="scikit-learn"):
        build_target(PRESETS["breast_cancer_aux"].replace(device="cpu"))
    # the other datasets need nothing of it
    assert tdatasets.load("pima")[0].shape == (532, 7)
