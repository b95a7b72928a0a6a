"""The configurations' data: the deterministic stand-ins of Pima and Abalone.

Frozen copy of ``auxpm_tpu_torch/models/datasets.py``
(``_standardize``, ``_synthetic_gp_classification``, ``load`` with a
subsample): latent-GP binary data at the reference shapes (Pima 532 x 7 at
seed 1532, Abalone 4177 x 8 at seed 4177), standardised features, labels in
{-1, +1}, both float32.  A configuration file names the generator's
arguments and the subsample; the benchmark hands the same arrays to the
program and to the reference.
"""

from __future__ import annotations

import numpy as np


def _standardize(x):
    x = np.asarray(x, np.float64)
    mu = x.mean(0)
    sd = x.std(0)
    sd[sd == 0] = 1.0
    return (x - mu) / sd


def latent_gp_standin(n, d, seed, lengthscale=1.2, noise=0.3):
    """Deterministic latent-GP binary data: y = sign(f + eps), f ~ GP(0, SE)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, d)) / np.sqrt(d)
    x = rng.standard_normal((n, d)) @ (np.eye(d) + 0.5 * a)
    x = _standardize(x)
    sq = np.empty((n, n))
    for i in range(0, n, 512):
        sq[i:i + 512] = ((x[i:i + 512, None, :] - x[None, :, :]) ** 2).sum(-1)
    k = np.exp(-0.5 * sq / lengthscale**2) + 1e-6 * np.eye(n)
    f = np.linalg.cholesky(k) @ rng.standard_normal(n)
    y = np.sign(f + noise * rng.standard_normal(n))
    y[y == 0] = 1.0
    return x, y


def make_data(spec):
    """``(x, y)`` float32 of a configuration's ``data`` entry: the stand-in
    (``n``, ``d``, ``seed``, ``lengthscale``, ``noise``), then, where
    ``subsample`` is below n, that many rows drawn without replacement by
    ``numpy.random.default_rng(subsample_seed)``."""
    x, y = latent_gp_standin(spec["n"], spec["d"], spec["seed"],
                             spec.get("lengthscale", 1.2),
                             spec.get("noise", 0.3))
    x, y = np.float32(x), np.float32(y)
    sub = spec.get("subsample")
    if sub is not None and sub < x.shape[0]:
        idx = np.random.default_rng(spec.get("subsample_seed", 0)).choice(
            x.shape[0], sub, replace=False)
        x, y = x[idx], y[idx]
    return x, y
