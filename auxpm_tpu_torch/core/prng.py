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
of the key tensor through ``ops/threefry.threefry``: on CUDA keys every draw
is ONE launch of the kernel ``csrc/threefry.cu``, on CPU keys its plain
version ``ops/threefry.draw_plain`` (PyTorch).  Words come out as int64
holding uint32 values.  An element's draw depends on its counter alone, so a
draw may start at any ``offset`` of the flattened draw.

Normals: ``jax.random.normal`` is ``sqrt(2) erf_inv(u)`` with u uniform on
(nextafter(-1, 0), 1), ``erf_inv`` being XLA's float32 polynomial
(``ops/threefry.erf_inv``).  With it the normals match ``jax.random`` to a few
ulp (bitwise for most draws: the two frameworks' ``log1p`` differ by an ulp
at times); words, bits, uniforms, bernoulli and randint are bitwise.

Between ``start_timing()`` and ``stop_timing()`` every outermost call of a
public function on CUDA keys is bracketed by two CUDA events, and
``stop_timing`` returns their summed milliseconds (the per-stage accounting
of ``chip_smoke.py``).
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

import torch

from auxpm_tpu_torch.ops import threefry as _tf
from auxpm_tpu_torch.ops.threefry import fma32, threefry2x32  # noqa: F401

_M = 0xFFFFFFFF
_NEXT_M1 = _tf.NEXT_M1                         # nextafter(-1, 0) in float32
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


@_timed
def split(keys, num=2):
    """``jax.random.split``: ``(..., 2) -> (..., *num, 2)``; ``num`` an int
    or a shape."""
    return _tf.threefry(keys, num, "words")


@_timed
def fold_in(keys, data):
    """``jax.random.fold_in``: ``threefry2x32(key, 0, data)``.  ``data`` (an
    int or an integer tensor, taken modulo 2^32) broadcasts against the
    keys' batch axes."""
    return _tf.threefry(keys, (), "words", data=data)


@_timed
def bits(keys, shape=(), offset=0):
    """``jax.random.bits`` (uint32 words, in int64): ``(*batch, *shape)``;
    ``offset``: start at that element of the flattened draw (a slice of a
    larger draw, element i depending on counter i alone)."""
    return _tf.threefry(keys, shape, "bits", offset=offset)


@_timed
def uniform(keys, shape=(), minval=0.0, maxval=1.0, offset=0):
    """``jax.random.uniform`` in float32: ``max(minval, f (maxval - minval) +
    minval)`` with the difference and the bounds rounded to float32, f in
    [0, 1) from the 23 high bits of each word; ``offset`` as in ``bits``."""
    return _tf.threefry(keys, shape, "uniform", minval, maxval, offset)


@_timed
def normal(keys, shape=(), offset=0):
    """``jax.random.normal`` in float32: ``sqrt(2) erf_inv(u)``, u uniform on
    (nextafter(-1, 0), 1) in float32; ``offset`` as in ``bits``."""
    return _tf.threefry(keys, shape, "normal", offset=offset)


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
