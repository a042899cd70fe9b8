"""Record sorts behind the chunk matcher (ops/sortnet.py): ``lax.sort``
over key planes, including the merge of two sorted halves, against numpy
``lexsort`` on the CPU backend."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from smallz4_tpu.ops import sortnet


def test_sort_records_multikey():
    rng = np.random.default_rng(0)
    n = 1024
    k1 = rng.integers(0, 8, n).astype(np.uint32)
    k2 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    pos = np.arange(n, dtype=np.int32)
    rng.shuffle(pos)
    pay = rng.integers(-1000, 1000, n).astype(np.int32)
    s1, s2, sp, spay = sortnet.sort_records(
        jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(pos), jnp.asarray(pay),
        n_keys=2)
    order = np.lexsort((pos, k2, k1))
    np.testing.assert_array_equal(np.asarray(s1), k1[order])
    np.testing.assert_array_equal(np.asarray(s2), k2[order])
    np.testing.assert_array_equal(np.asarray(sp), pos[order])
    np.testing.assert_array_equal(np.asarray(spay), pay[order])


def test_merge_sorted_halves():
    rng = np.random.default_rng(5)
    n = 2048
    h = n // 2
    k1 = rng.integers(0, 6, n).astype(np.uint32)
    pos = np.arange(n, dtype=np.int32)
    pay = rng.integers(0, 1 << 30, n).astype(np.int32)
    # sort each half independently (ground truth by lexsort)
    for lo, hi in ((0, h), (h, n)):
        order = np.lexsort((pos[lo:hi], k1[lo:hi])) + lo
        k1[lo:hi], pos[lo:hi], pay[lo:hi] = k1[order], pos[order], pay[order]
    s1, sp, spay = sortnet.sort_records(
        jnp.asarray(k1), jnp.asarray(pos), jnp.asarray(pay), n_keys=1)
    order = np.lexsort((pos, k1))
    np.testing.assert_array_equal(np.asarray(s1), k1[order])
    np.testing.assert_array_equal(np.asarray(sp), pos[order])
    np.testing.assert_array_equal(np.asarray(spay), pay[order])


def test_sort_records_compact_variant():
    """A single distinct unsigned key (int32 plane with the sign bit set
    on some records, as the chunk matcher's combo plane) with a payload."""
    rng = np.random.default_rng(9)
    n = 2048
    key = rng.permutation(n).astype(np.int32)
    key[rng.random(n) < 0.3] |= np.int32(-0x80000000)
    pay = rng.integers(-1000, 1000, n).astype(np.int32)
    sk, spay = sortnet.sort_records(jnp.asarray(key), jnp.asarray(pay),
                                    n_keys=1, unique=True)
    order = np.argsort(key.view(np.uint32), kind="stable")
    np.testing.assert_array_equal(np.asarray(sk), key[order])
    np.testing.assert_array_equal(np.asarray(spay), pay[order])
