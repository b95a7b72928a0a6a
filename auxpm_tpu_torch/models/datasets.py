"""Dataset loaders (NumPy only): Pima (532 points), Breast-Cancer (569),
Abalone (4177).

The port's own copy of ``auxpm_tpu/models/datasets.py`` (that package pulls
JAX in on import, so nothing of it is imported here).  The raw UCI files are
not shipped; ``pima`` and ``abalone`` are deterministic synthetic stand-ins
with the reference shapes (532 x 7, 4177 x 8) drawn from a latent-GP
classification process at fixed seeds, bit-identical to the JAX package's
stand-ins.  If a real CSV is placed at ``data/<name>.csv`` (rows:
features..., label) it is used instead.  ``breast_cancer`` is the real
Wisconsin data through scikit-learn, an optional dependency imported inside
its loader; without it the loader raises ``ImportError``.

Labels are returned in {-1, +1}; features are standardised to zero mean and
unit variance.  ``load(name)`` returns ``(x, y)`` float32/float32 arrays.
"""

from __future__ import annotations

import os

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "data")


def _standardize(x):
    x = np.asarray(x, np.float64)
    mu = x.mean(0)
    sd = x.std(0)
    sd[sd == 0] = 1.0
    return (x - mu) / sd


def _synthetic_gp_classification(n, d, seed, lengthscale=1.2, noise=0.3):
    """Deterministic latent-GP binary data: y = sign(f + eps), f ~ GP(0, SE)."""
    rng = np.random.default_rng(seed)
    # correlated features, like real tabular data
    a = rng.standard_normal((d, d)) / np.sqrt(d)
    x = rng.standard_normal((n, d)) @ (np.eye(d) + 0.5 * a)
    x = _standardize(x)
    # squared distances in row blocks (the same per-element arithmetic as
    # the whole (n, n, d) difference, without holding it)
    sq = np.empty((n, n))
    for i in range(0, n, 512):
        sq[i:i + 512] = ((x[i:i + 512, None, :] - x[None, :, :]) ** 2).sum(-1)
    k = np.exp(-0.5 * sq / lengthscale**2) + 1e-6 * np.eye(n)
    f = np.linalg.cholesky(k) @ rng.standard_normal(n)
    y = np.sign(f + noise * rng.standard_normal(n))
    y[y == 0] = 1.0
    return x, y


def _maybe_csv(name):
    path = os.path.join(_DATA_DIR, f"{name}.csv")
    if os.path.exists(path):
        raw = np.loadtxt(path, delimiter=",")
        x = _standardize(raw[:, :-1])
        y = raw[:, -1]
        y = np.where(y > np.median(y), 1.0, -1.0) if set(np.unique(y)) - {-1.0, 1.0, 0.0} else np.where(y > 0, 1.0, -1.0)
        return x, y
    return None


def load_pima():
    """Pima Indians diabetes, 532-pt version (7 features).  Synthetic
    stand-in unless data/pima.csv exists (see module docstring)."""
    got = _maybe_csv("pima")
    if got is None:
        got = _synthetic_gp_classification(532, 7, seed=1532)
    return np.float32(got[0]), np.float32(got[1])


def load_breast_cancer():
    """Wisconsin diagnostic breast cancer (real data, via scikit-learn)."""
    try:
        from sklearn.datasets import load_breast_cancer as _load
    except ImportError as e:
        raise ImportError(
            "dataset 'breast_cancer' (preset breast_cancer_aux) needs "
            "scikit-learn, which is not installed; install scikit-learn or "
            "run another preset") from e

    ds = _load()
    x = _standardize(ds.data)
    y = np.where(ds.target > 0, 1.0, -1.0)
    return np.float32(x), np.float32(y)


def load_abalone():
    """Abalone binarised at median rings (8 features).  Synthetic stand-in
    unless data/abalone.csv exists (see module docstring)."""
    got = _maybe_csv("abalone")
    if got is None:
        got = _synthetic_gp_classification(4177, 8, seed=4177)
    return np.float32(got[0]), np.float32(got[1])


DATASETS = {
    "pima": load_pima,
    "breast_cancer": load_breast_cancer,
    "abalone": load_abalone,
}


def load(name, subsample=None, seed=0):
    if name not in DATASETS:
        raise ValueError(f"unknown dataset {name!r}; available: "
                         f"{sorted(DATASETS)}")
    x, y = DATASETS[name]()
    if subsample is not None and subsample < x.shape[0]:
        idx = np.random.default_rng(seed).choice(x.shape[0], subsample, replace=False)
        x, y = x[idx], y[idx]
    return x, y
