"""threefry2x32 draws as ``jax.random`` makes them (partitionable mode).

Frozen copy of ``auxpm_tpu_torch/ops/threefry.py`` (``_rounds``,
``_threefry_i32``, ``erf_inv``, ``draw_plain``) and of the key functions of
``auxpm_tpu_torch/core/prng.py`` (``key``, ``split``, ``fold_in``,
``uniform``, ``normal``, ``blocked_normal``), plain PyTorch on any device.
A key is an int64 tensor ``(..., 2)`` of the two uint32 words.
"""

from __future__ import annotations

import math

import torch

_M = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
NEXT_M1 = -1.0 + 2.0**-24                      # nextafter(-1, 0) in float32
SQRT2 = torch.tensor(math.sqrt(2.0), dtype=torch.float32).item()
# XLA's ErfInv32: coefficients of the two branches, highest degree first
_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
           0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
           1.50140941)
_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
           0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
           2.83297682)


def _i32(x, device):
    return torch.as_tensor(x, dtype=torch.int64, device=device).to(torch.int32)


def _cipher(k1, k2, x0, x1):
    """20 rounds of threefry2x32 on int32 tensors holding the words' bits
    (an int32 sum wraps as a uint32 one)."""
    dev = k1.device
    ks = [_i32(k1, dev), _i32(k2, dev)]
    ks.append(ks[0] ^ ks[1] ^ _PARITY)
    x0, x1 = torch.broadcast_tensors(_i32(x0, dev) + ks[0],
                                     _i32(x1, dev) + ks[1])
    x0, x1 = x0.contiguous(), x1.contiguous()
    t = torch.empty_like(x1)
    for i in range(5):
        for r in _ROT[i % 2]:
            x0.add_(x1)
            torch.bitwise_right_shift(x1, 32 - r, out=t)
            t.bitwise_and_((1 << r) - 1)
            x1.bitwise_left_shift_(r).bitwise_or_(t).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3])
        x1.add_(ks[(i + 2) % 3]).add_(i + 1)
    return x0, x1


def _fma32(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def erf_inv(x):
    """XLA's float32 ``erf_inv`` (Giles' two branches, split at w = 5)."""
    x = x.to(torch.float32)
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    lo = torch.tensor(_W_LT_5, dtype=torch.float32, device=x.device).double()
    hi = torch.tensor(_W_GE_5, dtype=torch.float32, device=x.device).double()
    w64 = w.double()
    p = torch.where(lt, lo[0], hi[0])
    for i in range(1, len(_W_LT_5)):
        p = (p * w64 + torch.where(lt, lo[i], hi[i])).float()
        if i + 1 < len(_W_LT_5):
            p = p.double()
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       p * x)


def _draw(keys, shape=(), mode="bits", data=None):
    """``threefry2x32`` of each key with counters ``iota(shape)`` (or with
    ``data``), as ``words``, ``uniform`` on [0, 1) or ``normal``."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    if data is not None:
        y0, y1 = _cipher(keys[..., 0], keys[..., 1], 0, data)
    else:
        exp = (...,) + (None,) * len(shape)
        c = torch.arange(math.prod(shape), dtype=torch.int64,
                         device=keys.device).reshape(
                             (1,) * (keys.dim() - 1) + shape)
        y0, y1 = _cipher(keys[..., 0][exp], keys[..., 1][exp], 0, c)
    if mode == "words":
        return torch.stack([y0, y1], dim=-1).to(torch.int64) & _M
    b = y0.bitwise_xor_(y1)
    f = (b.bitwise_right_shift_(9).bitwise_and_(0x7FFFFF)
         .bitwise_or_(0x3F800000).view(torch.float32) - 1.0)
    if mode == "uniform":
        return f
    lo = torch.tensor(NEXT_M1, dtype=torch.float32, device=f.device)
    hi = torch.tensor(1.0, dtype=torch.float32, device=f.device)
    u = torch.maximum(lo, _fma32(f, hi - lo, lo))
    return torch.tensor(SQRT2, dtype=torch.float32, device=u.device) \
        * erf_inv(u)


def key(seed):
    """``jax.random.key(seed)`` in 32-bit mode: words ``[0, seed mod 2^32]``."""
    return torch.tensor([0, int(seed) % 2**32], dtype=torch.int64)


def split(keys, num):
    return _draw(keys, num, "words")


def fold_in(keys, data):
    d = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & _M
    return _draw(keys, (), "words", data=d)


def uniform(keys, shape=()):
    return _draw(keys, shape, "uniform")


def normal(keys, shape=()):
    return _draw(keys, shape, "normal")


def blocked_normal(keys, shape, n_blocks):
    """u-shaped normals block by block: row block b is
    ``normal(fold_in(key, b), (rows / n_blocks, cols))``."""
    rows, cols = shape
    kb = fold_in(keys[..., None, :],
                 torch.arange(n_blocks, device=keys.device))
    out = normal(kb, (rows // n_blocks, cols))
    return out.reshape(*keys.shape[:-1], rows, cols)
