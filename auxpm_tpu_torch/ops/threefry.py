"""threefry2x32 draws: their plain version, and the wrapper of the kernel
``csrc/threefry.cu``.

Replaces no TPU kernel: the reference's random numbers come from
``jax.random``, which XLA compiles.  Every public draw of ``core/prng.py``
(``split``, ``fold_in``, ``bits``, ``uniform``, ``normal`` and what is built
on them) comes to ``threefry`` here: on CUDA keys one launch of the kernel (or
an error), on CPU keys ``draw_plain``, the kernel's plain version.

``draw_plain`` is PyTorch on the keys' device: the cipher in place on int32
tensors of the words' bits (PyTorch has no usable uint32 arithmetic, and an
int32 sum wraps like a uint32 one), then XLA's float32 ``erf_inv`` polynomial
for normals (Giles' two branches of degree 8 in ``w = -log1p(-x^2)``, split at
w = 5, the one ``chlo.erf_inv`` lowers to), not ``torch.erfinv``, which misses
XLA's by up to ~800 ulp in the tails.

``threefry(keys, shape, mode, ...)`` flattens the keys' batch axes, hands the
kernel N keys and M = prod(shape) counters per key from ``offset`` on (or, for
``fold_in``, one counter per key from ``data``, broadcast against the keys),
and reshapes the output.  ``launches`` counts the kernel's launches,
``plain_calls`` the plain cipher's calls.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from auxpm_tpu_torch.ops import _build

_M = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
MODES = ("words", "bits", "uniform", "normal")
_MODE_IDS = {m: i for i, m in enumerate(MODES)}
NEXT_M1 = -1.0 + 2.0**-24                     # nextafter(-1, 0) in float32
SQRT2 = torch.tensor(math.sqrt(2.0), dtype=torch.float32).item()
# XLA's ErfInv32: coefficients of the two branches, highest degree first
_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
           0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
           1.50140941)
_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
           0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
           2.83297682)

launches = 0     # kernel launches made by this module's wrapper
plain_calls = 0  # calls of the plain cipher


def _i32(x, device=None):
    """uint32 words (int64 or Python ints, taken modulo 2^32) as the int32
    of the same bits (the narrowing conversion wraps)."""
    return torch.as_tensor(x, dtype=torch.int64, device=device).to(
        torch.int32)


def _rounds(ks, x0, x1):
    """The 20 rounds in place on int32 tensors of the words' bits (an int32
    sum wraps like a uint32 one; the rotation masks the arithmetic right
    shift), a few passes per round over half the bytes of int64."""
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


def _threefry_i32(k1, k2, x0, x1):
    """``threefry2x32`` with its two words as int32 of the same bits."""
    global plain_calls
    plain_calls += 1
    dev = torch.as_tensor(k1).device
    ks = [_i32(k1, dev), _i32(k2, dev)]
    ks.append(ks[0] ^ ks[1] ^ _PARITY)
    x0, x1 = torch.broadcast_tensors(_i32(x0, dev) + ks[0],
                                     _i32(x1, dev) + ks[1])
    return _rounds(ks, x0.contiguous(), x1.contiguous())


def threefry2x32(k1, k2, x0, x1):
    """The threefry2x32 block cipher (20 rounds) on uint32 words held in
    int64 tensors; all four arguments broadcast.  Returns ``(y0, y1)``."""
    y0, y1 = _threefry_i32(k1, k2, x0, x1)
    return y0.to(torch.int64) & _M, y1.to(torch.int64) & _M


def fma32(a, b, c):
    """``a b + c`` of float32 tensors rounded once, as XLA contracts it: the
    product of two float32 is exact in float64."""
    return (a.double() * b.double() + c.double()).float()


def erf_inv(x):
    """XLA's float32 ``erf_inv``: ``p(w) x`` with w = -log1p(-x^2) and p of
    degree 8 in ``w - 2.5`` (w < 5) or ``sqrt(w) - 3``; +-inf at +-1."""
    x = x.to(torch.float32)
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    # the coefficients rounded to float32, held (exactly) in float64; each
    # Horner step is fma32 with w converted once
    lo = torch.tensor(_W_LT_5, dtype=torch.float32,
                      device=x.device).double()
    hi = torch.tensor(_W_GE_5, dtype=torch.float32,
                      device=x.device).double()
    w64 = w.double()
    p = torch.where(lt, lo[0], hi[0])
    for i in range(1, len(_W_LT_5)):
        p = (p * w64 + torch.where(lt, lo[i], hi[i])).float()
        if i + 1 < len(_W_LT_5):
            p = p.double()
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       p * x)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def draw_plain(keys, shape=(), mode="bits", minval=0.0, maxval=1.0, offset=0,
               data=None):
    """The plain version of every draw (and of the kernel):
    ``threefry2x32`` of each key ``(..., 2)`` with the counters ``offset +
    iota(shape)`` (the low words of ``iota_2x32_shape``; the high words are 0
    below 2^32 draws), or with ``data`` (broadcast against the keys' batch
    axes; ``shape`` must then be ``()``), turned into ``mode``: ``words``
    ``(..., *shape, 2)``, ``bits`` (int64), ``uniform`` on [minval, maxval)
    or ``normal`` (float32), each ``(..., *shape)``."""
    shape = _shape(shape)
    if data is not None:
        if shape:
            raise ValueError("data and shape exclude each other")
        y0, y1 = _threefry_i32(keys[..., 0], keys[..., 1], 0, data)
    else:
        n = math.prod(shape)
        if offset + n > 2**32:
            raise ValueError(f"{offset + n} draws from one key: at most 2^32 "
                             "supported")
        exp = (...,) + (None,) * len(shape)
        c = torch.arange(offset, offset + n, dtype=torch.int64,
                         device=keys.device).reshape(
                             (1,) * (keys.dim() - 1) + shape)
        y0, y1 = _threefry_i32(keys[..., 0][exp], keys[..., 1][exp], 0, c)
    if mode == "words":
        return torch.stack([y0, y1], dim=-1).to(torch.int64) & _M
    b = y0.bitwise_xor_(y1)
    if mode == "bits":
        return b.to(torch.int64) & _M
    if mode == "normal":
        minval, maxval = NEXT_M1, 1.0
    # the 23 high bits as the mantissa of a float in [1, 2), minus 1
    f = (b.bitwise_right_shift_(9).bitwise_and_(0x7FFFFF)
         .bitwise_or_(0x3F800000).view(torch.float32) - 1.0)
    if (minval, maxval) == (0.0, 1.0):
        u = f          # max(0, f * 1 + 0) is f, to the bit
    else:
        lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
        hi = torch.tensor(maxval, dtype=torch.float32, device=f.device)
        u = torch.maximum(lo, fma32(f, hi - lo, lo))
    if mode == "uniform":
        return u
    if mode != "normal":
        raise ValueError(f"mode {mode!r} not one of {MODES}")
    return torch.tensor(SQRT2, dtype=torch.float32, device=u.device) \
        * erf_inv(u)


def threefry(keys, shape=(), mode="bits", minval=0.0, maxval=1.0, offset=0,
             data=None):
    """``draw_plain``'s function: on CPU keys that plain version, on CUDA
    keys one launch of the kernel (or an error)."""
    global launches
    if not keys.is_cuda:
        return draw_plain(keys, shape, mode, minval, maxval, offset, data)
    if keys.dtype != torch.int64 or keys.shape[-1:] != (2,):
        raise ValueError(f"keys must be int64 (..., 2), got {keys.dtype} "
                         f"{tuple(keys.shape)}")
    if mode not in _MODE_IDS:
        raise ValueError(f"mode {mode!r} not one of {MODES}")
    shape = _shape(shape)
    if data is not None:
        if shape:
            raise ValueError("data and shape exclude each other")
        d = torch.as_tensor(data, dtype=torch.int64, device=keys.device)
        batch = torch.broadcast_shapes(keys.shape[:-1], d.shape)
        k = keys.expand(*batch, 2).contiguous()
        d = (d.expand(batch) & _M).contiguous()
        m, c0 = 1, 0
    else:
        batch = keys.shape[:-1]
        k = keys.contiguous()
        d = None
        m, c0 = math.prod(shape), int(offset)
        if c0 < 0 or c0 + m > 2**32:
            raise ValueError(f"counters {c0}..{c0 + m}: at most 2^32 per key")
    n = math.prod(batch)
    if mode == "normal":
        minval, maxval = NEXT_M1, 1.0
    words = mode == "words"
    out = torch.empty((*batch, *shape, *((2,) if words else ())),
                      dtype=torch.int64 if mode in ("words", "bits")
                      else torch.float32, device=keys.device)
    if out.numel() == 0:
        return out
    # float32 bounds, as the plain version rounds them
    lo, hi = float(np.float32(minval)), float(np.float32(maxval))
    lib = _build.load_library()
    err = lib.auxpm_threefry(
        k.data_ptr(), 0 if d is None else d.data_ptr(), n, m, c0,
        _MODE_IDS[mode], lo, hi, SQRT2, out.data_ptr(),
        torch.cuda.current_stream(keys.device).cuda_stream)
    _build.check_launch(err, "threefry_kernel")
    launches += 1
    return out
