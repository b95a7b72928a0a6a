"""PyTorch port vs the JAX package: the counter-based threefry PRNG (CPU).

``auxpm_tpu_torch/core/prng.py`` against ``jax.random`` (partitionable
threefry, JAX's default) on the same keys: the cipher, keys of 32- and
64-bit seeds, ``split``, ``fold_in``, ``bits``, ``uniform`` (with bounds),
``bernoulli`` and ``randint`` bitwise; batched keys against ``jax.vmap``;
``normal`` within 4 ulp over 2e5 draws; ``blocked_normal`` against the
reference's; and the golden file that ``chip_smoke.py`` holds the card to,
against ``jax.random`` (so that it cannot drift).  Regenerate the file with
``python tests/test_torch_prng.py`` (it must then still pass here).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auxpm_tpu.core.state import blocked_normal as j_blocked_normal
from auxpm_tpu_torch.core import prng

ULP_BAR = 4   # normals: XLA's erf_inv polynomial, log1p may differ by an ulp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(x):
    return np.asarray(x).astype(np.int64)


def _kd(k):
    return _words(jax.random.key_data(k))


def _tk(k):
    return torch.from_numpy(_kd(k))


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def test_threefry2x32_matches_jax():
    from jax._src.prng import threefry_2x32

    rng = np.random.default_rng(0)
    for m in (1, 5, 64):
        key = rng.integers(0, 2**32, 2, dtype=np.uint32)
        count = rng.integers(0, 2**32, 2 * m, dtype=np.uint32)
        want = _words(threefry_2x32(jnp.asarray(key), jnp.asarray(count)))
        y0, y1 = prng.threefry2x32(int(key[0]), int(key[1]),
                                   torch.from_numpy(count[:m].astype(np.int64)),
                                   torch.from_numpy(count[m:].astype(np.int64)))
        np.testing.assert_array_equal(torch.cat([y0, y1]).numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, -1, 7, 2**31 - 1, 2**31 + 5,
                                  2**33 + 9, -2**35 + 3])
def test_key_of_32_and_64_bit_seeds(seed):
    from jax._src.prng import threefry_seed

    np.testing.assert_array_equal(prng.key(seed).numpy(),
                                  _kd(jax.random.key(seed)))
    with jax.enable_x64(True):
        want = _words(threefry_seed(jnp.asarray(seed, jnp.int64)))
    np.testing.assert_array_equal(prng.key(seed, width=64).numpy(), want)


def test_split_and_fold_in():
    for seed in (0, 42, 2**31 + 5):
        k, kt = jax.random.key(seed), prng.key(seed)
        for num in (2, 3, 7, (2, 3), (4, 1, 5)):
            np.testing.assert_array_equal(prng.split(kt, num).numpy(),
                                          _kd(jax.random.split(k, num)))
        for data in (0, 1, 12345, 2**31 + 3, 2**32 - 1):
            np.testing.assert_array_equal(prng.fold_in(kt, data).numpy(),
                                          _kd(jax.random.fold_in(k, data)))


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (64, 640)])
def test_bits_and_uniform(shape):
    for seed in (3, 2**31 + 5):
        k, kt = jax.random.key(seed), prng.key(seed)
        np.testing.assert_array_equal(prng.bits(kt, shape).numpy(),
                                      _words(jax.random.bits(k, shape)))
        np.testing.assert_array_equal(prng.uniform(kt, shape).numpy(),
                                      np.asarray(jax.random.uniform(k, shape)))
        for lo, hi in ((-2.5, 3.7), (0.1, 0.2), (np.nextafter(np.float32(-1),
                                                               np.float32(0)),
                                                  1.0)):
            np.testing.assert_array_equal(
                prng.uniform(kt, shape, float(lo), hi).numpy(),
                np.asarray(jax.random.uniform(k, shape, minval=lo,
                                              maxval=hi)))


def test_bernoulli_and_randint():
    k, kt = jax.random.key(11), prng.key(11)
    for p in (0.5, 0.3, 0.999):
        np.testing.assert_array_equal(
            prng.bernoulli(kt, p, (1000,)).numpy(),
            np.asarray(jax.random.bernoulli(k, p, (1000,))))
    np.testing.assert_array_equal(prng.bernoulli(kt).numpy(),
                                  np.asarray(jax.random.bernoulli(k)))
    for lo, hi in ((1, 9), (0, 1000), (-5, 70005), (0, 2**31 - 1), (3, 3)):
        np.testing.assert_array_equal(
            prng.randint(kt, (500,), lo, hi).numpy(),
            _words(jax.random.randint(k, (500,), lo, hi)))
    np.testing.assert_array_equal(           # HMC's n_steps: a 0-d draw
        prng.randint(kt, (), 1, 9).numpy(),
        _words(jax.random.randint(k, (), 1, jnp.asarray(8, jnp.int32) + 1)))


def test_batched_keys_match_vmap():
    ks = jax.random.split(jax.random.key(5), (3, 4))
    kt = _tk(ks)
    cases = {
        "split": (lambda k: jax.random.key_data(jax.random.split(k, 3)),
                  lambda k: prng.split(k, 3)),
        "fold_in": (lambda k: jax.random.key_data(jax.random.fold_in(k, 9)),
                    lambda k: prng.fold_in(k, 9)),
        "bits": (lambda k: jax.random.bits(k, (2, 5)),
                 lambda k: prng.bits(k, (2, 5))),
        "uniform": (lambda k: jax.random.uniform(k, (6,)),
                    lambda k: prng.uniform(k, (6,))),
        "bernoulli": (lambda k: jax.random.bernoulli(k, 0.4, (6,)),
                      lambda k: prng.bernoulli(k, 0.4, (6,))),
        "randint": (lambda k: jax.random.randint(k, (6,), 1, 9),
                    lambda k: prng.randint(k, (6,), 1, 9)),
    }
    for name, (fj, ft) in cases.items():
        want = np.asarray(jax.vmap(jax.vmap(fj))(ks))
        got = ft(kt).numpy()
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=name)
    # per-key data folded in: fold_in(keys (N, 2), data (N,))
    data = jnp.arange(12).reshape(3, 4) * 977
    want = _kd(jax.vmap(jax.vmap(jax.random.fold_in))(ks, data))
    np.testing.assert_array_equal(
        prng.fold_in(kt, torch.from_numpy(np.array(data))).numpy(), want)
    want = np.asarray(jax.vmap(jax.vmap(lambda k: jax.random.normal(k, (3,))))(ks))
    assert _ulps(prng.normal(kt, (3,)).numpy(), want).max() <= ULP_BAR


def test_normal_within_4_ulp():
    k, kt = jax.random.key(2024), prng.key(2024)
    want = np.asarray(jax.random.normal(k, (200_000,)))
    got = prng.normal(kt, (200_000,)).numpy()
    ulps = _ulps(got, want)
    assert ulps.max() <= ULP_BAR, ulps.max()
    assert np.mean(ulps == 0) > 0.9          # mostly bitwise
    assert np.abs(got - want).max() < 1e-6
    # the tails reach the w >= 5 branch of erf_inv
    assert np.abs(want).max() > 4.0
    # torch.erfinv is not XLA's polynomial: it misses by far more
    u = prng.uniform(kt, (200_000,), prng._NEXT_M1, 1.0)
    loose = (np.float32(np.sqrt(2)) * torch.erfinv(u)).numpy()
    assert _ulps(loose, want).max() > 10 * ULP_BAR


def test_blocked_normal_matches_the_reference():
    k = jax.random.key(13)
    kt = prng.key(13)
    for local, nb, s, pi in (((64, 40), 8, 64, 0), ((32, 40), 8, 64, 1),
                             ((16, 24), 4, 32, 1)):
        nb_local = nb // (s // local[0])
        want = np.asarray(jax.jit(
            lambda kk, pi=pi, local=local, nb=nb, s=s:
            j_blocked_normal(kk, local, jnp.float32, nb, s),
        )(k)) if pi == 0 else np.asarray(jnp.concatenate([
            jax.random.normal(jax.random.fold_in(k, pi * nb_local + b),
                              (local[0] // nb_local, local[1]), jnp.float32)
            for b in range(nb_local)]))
        got = prng.blocked_normal(kt, local, nb, s,
                                  block0=pi * nb_local).numpy()
        assert _ulps(got, want).max() <= ULP_BAR
    with pytest.raises(ValueError, match="incompatible"):
        prng.blocked_normal(kt, (20, 8), 8, 64)
    # batched keys: each row its own draw
    ks = prng.split(kt, 3)
    got = prng.blocked_normal(ks, (64, 8), 8, 64)
    assert got.shape == (3, 64, 8)
    torch.testing.assert_close(got[1], prng.blocked_normal(ks[1], (64, 8),
                                                           8, 64),
                               rtol=0, atol=0)


def _golden_jax(seed):
    """``prng.golden_cases`` written with jax.random."""
    k = jax.random.key(seed)

    def f32_bits(x):
        return np.asarray(x, np.float32).view(np.uint32).astype(
            np.int64).reshape(-1).tolist()

    return {
        "key": _kd(k).tolist(),
        "split4": _kd(jax.random.split(k, 4)).reshape(-1).tolist(),
        "split2x3": _kd(jax.random.split(k, (2, 3))).reshape(-1).tolist(),
        "fold_in_3": _kd(jax.random.fold_in(k, 3)).tolist(),
        "bits": _words(jax.random.bits(k, (16,))).tolist(),
        "uniform": f32_bits(jax.random.uniform(k, (16,))),
        "uniform_mm": f32_bits(jax.random.uniform(jax.random.fold_in(k, 1),
                                                  (8,), minval=-2.5,
                                                  maxval=3.7)),
        "normal": f32_bits(jax.random.normal(k, (32,))),
        "bernoulli": np.asarray(jax.random.bernoulli(
            jax.random.fold_in(k, 2), 0.3, (16,))).astype(np.int64).tolist(),
        "randint": _words(jax.random.randint(jax.random.fold_in(k, 4), (16,),
                                             1, 9)).tolist(),
    }


def _golden_file_contents():
    return {"jax_version": jax.__version__,
            "threefry_partitionable": bool(
                jax.config.jax_threefry_partitionable),
            "seeds": list(prng.GOLDEN_SEEDS),
            "cases": {str(s): _golden_jax(s) for s in prng.GOLDEN_SEEDS}}


def _check_against_golden(got, want, label):
    for name, w in want.items():
        g = np.asarray(got[name], np.int64)
        w = np.asarray(w, np.int64)
        if name == "normal":
            d = _ulps(g.astype(np.uint32).view(np.float32),
                      w.astype(np.uint32).view(np.float32))
            assert d.max() <= ULP_BAR, (label, name, d.max())
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{label} {name}")


def test_golden_file_matches_jax_and_the_port():
    golden = prng.load_golden()
    fresh = _golden_file_contents()
    assert golden["seeds"] == fresh["seeds"]
    assert golden["threefry_partitionable"]
    for s in golden["seeds"]:
        # the file is jax.random's (normals to the last bit on this host)
        _check_against_golden(fresh["cases"][str(s)], golden["cases"][str(s)],
                              f"jax seed {s}")
        _check_against_golden(prng.golden_cases(s), golden["cases"][str(s)],
                              f"port seed {s}")
    n = sum(len(v) for c in golden["cases"].values() for v in c.values())
    assert 300 <= n <= 1000, n


if __name__ == "__main__":
    with open(prng.GOLDEN_PATH, "w") as fh:
        json.dump(_golden_file_contents(), fh)
        fh.write("\n")
    print(f"wrote {prng.GOLDEN_PATH}")
