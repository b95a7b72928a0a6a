"""Plain reference of the GP-classification target: Gram, factor, estimator.

Written from the model's definition (``auxpm_tpu_torch/models/
gp_classification.py`` states it; nothing of it is imported):

    R(ell) = exp(-0.5 sqdist / ell^2) + jitter I        (sigma-free)
    L = chol(R), escalating the diagonal by jitter x 10^k on failure
    f_s = sigma L u_s;  log w_s = sum_i log sigmoid(y_i f_si)
    log L-hat = logsumexp_s(log w_s) - log S
    theta = [log ell, log sigma] ~ N(prior_mean, prior_std^2) each

Two precisions: ``float64`` (the reference) and ``tf32`` (float32 whose
matrix products take operands rounded to TF32's 10-bit mantissa, on any
device: the control of ``control.py``).  The data axis is padded as the
program pads it (to a multiple of 128, the pad block diagonal), so that u
and a factor compare element for element; the likelihood reads the real
rows only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TILE = 128


def tf32_round(x):
    """Round float32 ``x`` to TF32 (10 mantissa bits, to nearest)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


class Num:
    """The arithmetic of one precision: dtype and matrix product."""

    def __init__(self, prec):
        if prec not in ("float64", "tf32"):
            raise ValueError(f"unknown precision {prec!r}")
        self.prec = prec
        self.dtype = torch.float64 if prec == "float64" else torch.float32

    def mm(self, a, b):
        if self.prec == "tf32":
            return tf32_round(a) @ tf32_round(b)
        return a @ b


class GPProblem:
    """The target of one configuration on ``(x, y)``, in precision ``prec``."""

    def __init__(self, x, y, target, device, prec="float64"):
        if target.get("likelihood", "logistic") != "logistic":
            raise ValueError("the reference implements the logistic "
                             "likelihood only")
        if target.get("ard", False):
            raise ValueError("the reference implements the isotropic kernel")
        self.num = Num(prec)
        self.device = torch.device(device)
        dt = self.num.dtype
        x64 = np.asarray(x, np.float64)
        self.n = x64.shape[0]
        self.n_pad = -(-self.n // TILE) * TILE
        sq = ((x64[:, None, :] - x64[None, :, :]) ** 2).sum(-1)
        self.sq = torch.as_tensor(sq, dtype=dt, device=self.device)
        self.y = torch.as_tensor(np.asarray(y, np.float64), dtype=dt,
                                 device=self.device)
        self.s = int(target["n_importance"])
        self.jitter = float(target["jitter"])
        self.prior_mean = float(target["prior_mean"])
        self.prior_std = float(target["prior_std"])
        # the program's reduction tree: 8 blocks where they divide S
        self.n_blocks = 8 if self.s % 8 == 0 else 1

    def log_prior(self, theta):
        r = (theta - self.prior_mean) / self.prior_std
        log_norm = theta.shape[-1] * (0.5 * math.log(2 * math.pi)
                                      + math.log(self.prior_std))
        return -0.5 * float((r * r).sum()) - log_norm

    def gram(self, log_ell):
        """R(ell) + jitter I on the real rows."""
        r = torch.exp(-0.5 * self.sq * math.exp(-2.0 * float(log_ell)))
        return r + self.jitter * torch.eye(self.n, dtype=r.dtype,
                                           device=self.device)

    def gram_padded64(self, log_ell):
        """R(ell) + jitter I in float64 at the padded width (pad block
        diagonal 1 + jitter)."""
        out = torch.eye(self.n_pad, dtype=torch.float64, device=self.device)
        out *= 1.0 + self.jitter
        r = torch.exp(-0.5 * self.sq.double() * math.exp(-2.0 * float(log_ell)))
        out[:self.n, :self.n] = r + self.jitter * torch.eye(
            self.n, dtype=torch.float64, device=self.device)
        return out

    def _blocked_chol(self, a):
        """Right-looking blocked Cholesky (128-wide panels, products in
        this precision); None where a panel is not positive definite."""
        a = a.clone()
        n = a.shape[-1]
        for j in range(0, n, TILE):
            sl, tr = slice(j, j + TILE), slice(j + TILE, n)
            ljj, info = torch.linalg.cholesky_ex(a[sl, sl])
            if int(info) > 0:
                return None
            a[sl, sl] = ljj
            if j + TILE < n:
                lij = torch.linalg.solve_triangular(
                    ljj, a[tr, sl].mT, upper=False).mT
                a[tr, sl] = lij
                a[tr, tr] -= self.num.mm(lij, lij.mT)
        return torch.tril(a)

    def chol(self, log_ell):
        """The factor of R(ell) with the escalation rule: retry with the
        diagonal raised by jitter, then x 10 twice more."""
        r = self.gram(log_ell)
        eye = torch.eye(self.n, dtype=r.dtype, device=self.device)
        extra = 0.0
        for k in range(4):
            l = self._blocked_chol(r + extra * eye)
            if l is not None and bool(torch.isfinite(l.diagonal()).all()):
                return l
            extra = self.jitter if k == 0 else extra * 10.0
        return l if l is not None else torch.full_like(r, float("nan"))

    def estimate(self, chol_scaled, u):
        """log L-hat of ``u (S, n_pad)`` under ``chol_scaled (n, n)``."""
        f = self.num.mm(u[:, :self.n], chol_scaled.mT)
        z = self.y * f
        lw = -(torch.clamp(-z, min=0.0) + torch.log1p(torch.exp(-z.abs())))
        return float(torch.logsumexp(lw.sum(-1), 0)) - math.log(self.s)

    def log_lik(self, theta, chol, u):
        return self.estimate(math.exp(float(theta[1])) * chol, u)

    def factor_resid(self, chol_pad, log_ell):
        """How far ``chol_pad (n_pad, n_pad)``, a program's factor, is from
        factoring R(ell) + jitter I (float64): max |L L^T - K| / max |K|,
        the least over the escalation's diagonals."""
        l = chol_pad.to(device=self.device, dtype=torch.float64)
        k = self.gram_padded64(log_ell)
        llt = l @ l.mT
        eye = torch.eye(self.n_pad, dtype=torch.float64, device=self.device)
        scale = float(k.abs().max())
        best = math.inf
        for extra in (0.0, self.jitter, 10 * self.jitter, 100 * self.jitter):
            best = min(best, float((llt - k - extra * eye).abs().max()) / scale)
        return best
