"""Counter-based threefry2x32 PRNG, bit for bit ``jax.random``'s default.

Counterpart of what the reference takes from ``jax.random`` with
``jax_threefry_partitionable=True`` (JAX's default): ``key``, ``split``,
``fold_in``, ``bits``, ``uniform``, ``normal``, ``bernoulli``, ``randint``,
plus ``blocked_normal`` of ``auxpm_tpu/core/state.py``.  A draw is a pure
function of its key, so a particle that stores the 2-word key that generated
its u can regenerate u anywhere (the key-as-u mode of
``samplers/smc_sharded.py``), and re-chunking a batch changes no draw.

Representation: a key is an int64 tensor ``(..., 2)`` holding the two uint32
words of ``jax.random.key_data``.  Every function takes a batch of keys on
the leading axes (where the reference ``vmap``s) and computes on the device
of the key tensor.  The words live in int64 with 32-bit masks because
PyTorch has no usable uint32 shifts; an int64 product or left shift that
overflows wraps in two's complement, so its low 32 bits are still right.

Normals: ``jax.random.normal`` is ``sqrt(2) erf_inv(u)`` with u uniform on
(nextafter(-1, 0), 1).  ``erf_inv`` here is XLA's float32 polynomial (Giles'
two branches of degree 8 in ``w = -log1p(-x^2)``, split at w = 5, the one
``chlo.erf_inv`` lowers to), not ``torch.erfinv``, which misses XLA's by up
to ~800 ulp in the tails.  With it the normals match ``jax.random`` to a few
ulp (bitwise for most draws: the two frameworks' ``log1p`` differ by an ulp
at times); words, bits, uniforms, bernoulli and randint are bitwise.

``draws`` counts the calls that generated random words (``threefry2x32``);
between ``start_timing()`` and ``stop_timing()`` every outermost call of a
public function on CUDA keys is bracketed by two CUDA events, and
``stop_timing`` returns their summed milliseconds (the per-stage accounting
of ``chip_smoke.py``).
"""

from __future__ import annotations

import functools
import json
import math
from pathlib import Path

import torch

_M = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

draws = 0   # calls of threefry2x32
_events = None   # (start, end) CUDA event pairs while timing is on
_depth = 0


def _timed(fn):
    """Bracket the outermost call of ``fn(keys, ...)`` on CUDA keys by CUDA
    events while timing is on."""

    @functools.wraps(fn)
    def wrapper(keys, *args, **kwargs):
        global _depth
        timed = _events is not None and _depth == 0 and keys.is_cuda
        if timed:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        _depth += 1
        try:
            out = fn(keys, *args, **kwargs)
        finally:
            _depth -= 1
        if timed:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            _events.append((start, end))
        return out

    return wrapper


def start_timing():
    global _events
    _events = []


def stop_timing():
    """Milliseconds of the calls timed since ``start_timing`` (waits for the
    card); timing is off afterwards."""
    global _events
    events, _events = _events or [], None
    if events:
        events[-1][1].synchronize()
    return sum(a.elapsed_time(b) for a, b in events)


def _rotl(x, r):
    return ((x << r) & _M) | (x >> (32 - r))


def threefry2x32(k1, k2, x0, x1):
    """The threefry2x32 block cipher (20 rounds) on uint32 words held in
    int64 tensors; all four arguments broadcast.  Returns ``(y0, y1)``."""
    global draws
    draws += 1
    k1 = torch.as_tensor(k1, dtype=torch.int64)
    k2 = torch.as_tensor(k2, dtype=torch.int64, device=k1.device)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (torch.as_tensor(x0, dtype=torch.int64, device=k1.device) + ks[0]) & _M
    x1 = (torch.as_tensor(x1, dtype=torch.int64, device=k1.device) + ks[1]) & _M
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M
    return x0, x1


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def key(seed, width=32):
    """The key of an integer seed: ``jax.random.key(seed)``.  ``width=32`` is
    JAX's default mode, where the seed is taken modulo 2^32 (first word 0);
    ``width=64`` is the x64 mode, where the seed's two's-complement 64 bits
    give both words.  Returns an int64 ``(2,)`` on the CPU."""
    s = int(seed) % 2**64
    hi = (s >> 32) & _M if width == 64 else 0
    return torch.tensor([hi, s & _M], dtype=torch.int64)


def _counters(batch_ndim, shape, device):
    """The low words of ``iota_2x32_shape(shape)`` (the high words are 0
    below 2^32 draws), shaped to broadcast after ``batch_ndim`` key axes."""
    n = math.prod(shape)
    if n >= 2**32:
        raise ValueError(f"{n} draws from one key: at most 2^32 supported")
    return torch.arange(n, dtype=torch.int64, device=device).reshape(
        (1,) * batch_ndim + shape)


def _block(keys, shape):
    """``threefry2x32(key, 0, iota)`` of every key: two ``(*batch, *shape)``
    word tensors."""
    shape = _shape(shape)
    nb = keys.dim() - 1
    exp = (...,) + (None,) * len(shape)
    c = _counters(nb, shape, keys.device)
    return threefry2x32(keys[..., 0][exp], keys[..., 1][exp], 0, c)


@_timed
def split(keys, num=2):
    """``jax.random.split``: ``(..., 2) -> (..., *num, 2)``; ``num`` an int
    or a shape."""
    y0, y1 = _block(keys, num)
    return torch.stack([y0, y1], dim=-1)


@_timed
def fold_in(keys, data):
    """``jax.random.fold_in``: ``threefry2x32(key, 0, data)``.  ``data`` (an
    int or an integer tensor, taken modulo 2^32) broadcasts against the
    keys' batch axes."""
    d = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & _M
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], 0, d)
    return torch.stack([y0, y1], dim=-1)


@_timed
def bits(keys, shape=()):
    """``jax.random.bits`` (uint32 words, in int64): ``(*batch, *shape)``."""
    y0, y1 = _block(keys, shape)
    return y0 ^ y1


def fma32(a, b, c):
    """``a b + c`` of float32 tensors rounded once, as XLA contracts it: the
    product of two float32 is exact in float64."""
    return (a.double() * b.double() + c.double()).float()


def _unit(keys, shape):
    """Floats in [0, 1): the 23 high bits of each word as the mantissa of a
    float in [1, 2), minus 1 (bitwise ``jax.random.uniform``)."""
    b = (bits(keys, shape) >> 9) | 0x3F800000
    return b.to(torch.int32).view(torch.float32) - 1.0


@_timed
def uniform(keys, shape=(), minval=0.0, maxval=1.0):
    """``jax.random.uniform`` in float32: ``max(minval, f (maxval - minval) +
    minval)`` with the difference and the bounds rounded to float32."""
    f = _unit(keys, shape)
    lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=f.device)
    return torch.maximum(lo, fma32(f, hi - lo, lo))


# XLA's ErfInv32: coefficients of the two branches, highest degree first
_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
           0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
           1.50140941)
_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
           0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
           2.83297682)


def erf_inv(x):
    """XLA's float32 ``erf_inv``: ``p(w) x`` with w = -log1p(-x^2) and p of
    degree 8 in ``w - 2.5`` (w < 5) or ``sqrt(w) - 3``; +-inf at +-1."""
    x = x.to(torch.float32)
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    lo = torch.tensor(_W_LT_5, dtype=torch.float32, device=x.device)
    hi = torch.tensor(_W_GE_5, dtype=torch.float32, device=x.device)
    p = torch.where(lt, lo[0], hi[0])
    for i in range(1, len(_W_LT_5)):
        p = fma32(p, w, torch.where(lt, lo[i], hi[i]))
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       p * x)


_NEXT_M1 = -1.0 + 2.0**-24                     # nextafter(-1, 0) in float32
_SQRT2 = torch.tensor(math.sqrt(2.0), dtype=torch.float32).item()


@_timed
def normal(keys, shape=()):
    """``jax.random.normal`` in float32: ``sqrt(2) erf_inv(u)``, u uniform on
    (nextafter(-1, 0), 1) in float32."""
    u = uniform(keys, shape, _NEXT_M1, 1.0)
    return torch.tensor(_SQRT2, dtype=torch.float32, device=u.device) \
        * erf_inv(u)


@_timed
def bernoulli(keys, p=0.5, shape=()):
    """``jax.random.bernoulli``: ``uniform(key, shape) < p`` (float32 p)."""
    u = uniform(keys, shape)
    return u < torch.tensor(p, dtype=torch.float32, device=u.device)


@_timed
def randint(keys, shape, minval, maxval):
    """``jax.random.randint`` of int32 in [minval, maxval) (as int64): two
    words per value from ``split(key)``, reduced modulo the span as the
    reference reduces them (uint32 arithmetic)."""
    shape = _shape(shape)
    k = split(keys, 2)
    hi, lo = bits(k[..., 0, :], shape), bits(k[..., 1, :], shape)
    span = int(maxval) - int(minval)
    span = 1 if span <= 0 else span & _M
    mult = ((2**16 % span) ** 2 & _M) % span     # uint32 products wrap

    def mul32(a, b):   # (a * b) mod 2^32 for a, b < 2^32, no int64 overflow
        return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & _M

    off = (mul32(hi % span, torch.full_like(hi, mult)) + lo % span) & _M
    return int(minval) + off % span


@_timed
def blocked_normal(keys, local_shape, n_blocks_global, s_global, block0=0):
    """u-shaped normals drawn block by block: global row block b is
    ``normal(fold_in(key, b), block_shape)`` (``auxpm_tpu/core/state.py``
    ``blocked_normal``).  ``local_shape``: this shard's rows and columns
    (``s_global / k`` rows), ``block0``: its first global block.  Keys
    ``(..., 2)`` give ``(..., *local_shape)``."""
    rows_local = local_shape[0]
    k_shards = s_global // rows_local
    nb_local = n_blocks_global // k_shards
    if nb_local * k_shards != n_blocks_global or rows_local % nb_local:
        raise ValueError(
            f"shard rows {rows_local} of {s_global} incompatible with "
            f"{n_blocks_global} global blocks")
    block_shape = (rows_local // nb_local,) + tuple(local_shape[1:])
    gids = block0 + torch.arange(nb_local, device=keys.device)
    kb = fold_in(keys[..., None, :], gids)            # (..., nb_local, 2)
    draws_ = normal(kb, block_shape)                  # (..., nb_local, *bs)
    return draws_.reshape(*keys.shape[:-1], *local_shape)


# ----------------------------------------------------------------- golden

GOLDEN_PATH = Path(__file__).with_name("prng_golden.json")
GOLDEN_SEEDS = (0, 7, 42, 2**31 + 5, 123456789)


def golden_cases(seed, device="cpu"):
    """The draws of one seed that ``prng_golden.json`` holds (the same
    recipe written with ``jax.random`` in ``tests/test_torch_prng.py``):
    words as ints, floats as their float32 bit patterns."""
    k = key(seed).to(device)

    def f32_bits(x):
        w = x.contiguous().view(torch.int32).to(torch.int64) & _M
        return w.reshape(-1).tolist()

    return {
        "key": k.tolist(),
        "split4": split(k, 4).reshape(-1).tolist(),
        "split2x3": split(k, (2, 3)).reshape(-1).tolist(),
        "fold_in_3": fold_in(k, 3).tolist(),
        "bits": bits(k, (16,)).tolist(),
        "uniform": f32_bits(uniform(k, (16,))),
        "uniform_mm": f32_bits(uniform(fold_in(k, 1), (8,), -2.5, 3.7)),
        "normal": f32_bits(normal(k, (32,))),
        "bernoulli": bernoulli(fold_in(k, 2), 0.3, (16,)).to(torch.int64)
        .tolist(),
        "randint": randint(fold_in(k, 4), (16,), 1, 9).tolist(),
    }


def load_golden(path=GOLDEN_PATH):
    with open(path) as fh:
        return json.load(fh)
