"""Microbench: the batched Cholesky routes on the card.

    python -m auxpm_tpu_torch.utils.chol_bench [--batch 128] [--n 640]

Counterpart of ``scripts/chol_bench.py``: the same SE-Gram batch from the same
seed (B matrices of size n, lengthscales uniform in [0.5, 3], jitter 1e-2)
through ``torch.linalg.cholesky`` and the three blocked routes of
``ops/chol_hopper.py`` (v1 through ``cholesky_fast``, v2, v3).  For each: the
median time of ``--reps`` calls closed by ``torch.cuda.synchronize`` and the
backward error max |L L^T - K| (two float32 factors of one matrix differ
elementwise by more than either differs from the matrix it reproduces, so the
factor is held to what it must reproduce).  Then the residual
max |inv(L) L - I| of each panel route's inverse on the leading 128-tiles.
Prints one JSON line.  Needs a GPU (it raises without one) unless
``--device cpu``, which runs the plain versions and reports no times.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def make_batch(batch, n, seed=0):
    """The bench's SPD batch ``(batch, n, n)`` float32, as NumPy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 3))
    sq = ((x[:, None] - x[None]) ** 2).sum(-1)
    ells = rng.uniform(0.5, 3.0, batch)
    k = np.exp(-0.5 * sq[None] / ells[:, None, None] ** 2) + 1e-2 * np.eye(n)
    return k.astype(np.float32)


def bench(batch=128, n=640, reps=10, device="cuda", seed=0):
    """Returns the report dict (see the module note)."""
    import torch

    from auxpm_tpu_torch._device import resolve_device
    from auxpm_tpu_torch.ops import chol_hopper as ch

    dev = resolve_device(device)
    on_gpu = dev.type == "cuda"
    k = torch.as_tensor(make_batch(batch, n, seed), device=dev)
    n_pad = -(-n // ch.BLK) * ch.BLK
    k_pad = ch.pad_gram(k, n_pad)

    def timed_ms(fn):
        if not on_gpu:
            return None
        fn()
        torch.cuda.synchronize(dev)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    routes = {
        "library": lambda: torch.linalg.cholesky(k),
        "v1": lambda: ch.cholesky_fast(k),
        "v2": lambda: ch.cholesky_batched2(k_pad)[:, :n, :n],
        "v3": lambda: ch.cholesky_batched3(k_pad)[:, :n, :n],
    }
    report = {"batch": batch, "n": n, "n_padded": n_pad,
              "device": torch.cuda.get_device_name(dev) if on_gpu else "cpu",
              "flops": batch * n**3 / 3.0, "routes": {}}
    scale = float(k.abs().max())
    for name, fn in routes.items():
        l = fn()
        back = float((torch.bmm(l, l.mT) - k).abs().max())
        report["routes"][name] = {
            "ms": timed_ms(fn),
            "backward_err": back, "backward_err_rel": back / scale,
            "finite": bool(torch.isfinite(l).all()),
            "lower": float(torch.triu(l, 1).abs().max()) == 0.0,
        }
    tiles = k_pad[:, :ch.BLK, :ch.BLK].contiguous()
    eye = torch.eye(ch.BLK, device=dev)
    l1, x1 = ch.chol_panel_batched(tiles)
    l2 = ch.chol_panel_batched2(tiles)
    l3, xt3 = ch.chol_panel_batched3(tiles)
    report["panel_inverse_residual"] = {
        "v1": float((torch.bmm(x1, l1) - eye).abs().max()),
        "v2_newton": float((torch.bmm(ch.tri_inv_newton(l2), l2) - eye)
                           .abs().max()),
        "v3": float((torch.bmm(xt3.mT, l3) - eye).abs().max()),
    }
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--n", type=int, default=640)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    print(json.dumps(bench(args.batch, args.n, args.reps, args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
